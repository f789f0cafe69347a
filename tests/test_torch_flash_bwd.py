"""The flash-attention backward: the kernels' plain PyTorch version against the
reference Pallas backward (interpret mode, as tests/test_attention_grad.py runs
it), the autograd Function against ``jax.grad`` through the reference's
``flash_attention``, what the stated tolerance catches, and — on a CUDA card
only — the dq and dk/dv kernels against their plain version. The module imports
JAX only inside the tests that hold the port to the reference, so the card's
tests also run on the GPU machine, which has none:
``PYTHONPATH=src python -m pytest tests/test_torch_flash_bwd.py -m cuda``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tf
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

# tests/test_attention_grad.py::GRAD_CASES, then a fully masked row case:
# (b, hq, hkv, s, t, hd, causal, window, softcap, q_offset)
GRAD_CASES = [
    (1, 4, 2, 64, 64, 32, True, 0, 0.0, 0),        # GQA
    (2, 2, 2, 48, 48, 32, True, 0, 0.0, 0),        # unaligned seq len
    (1, 2, 1, 64, 64, 32, True, 12, 0.0, 0),       # sliding window + GQA
    (1, 2, 2, 64, 64, 32, True, 0, 15.0, 0),       # logit softcap
    (1, 2, 2, 64, 64, 32, False, 0, 0.0, 0),       # bidirectional
    (1, 2, 2, 32, 96, 32, True, 0, 0.0, 64),       # chunked-prefill q_offset
    (1, 4, 1, 40, 72, 32, True, 16, 30.0, 32),     # everything, unaligned
]
MASKED_CASE = (1, 2, 1, 64, 16, 32, True, 8, 0.0, 64)   # rows 24.. see no key
CASES = GRAD_CASES + [MASKED_CASE]

# dq/dk/dv, each judged against the largest |value| of the plain version's
# tensor (gradients have no fixed scale): fp32 within 1e-5 of it (the kernels and
# the plain version sum the same fp32 products in another order, ~1e-7); bf16
# within 2 bf16 ulps of each value, |value| floored at 2^-10 of the largest (both
# sides round one fp32 result; a value near zero is not judged in ulps of zero).
# chip_smoke.py holds the kernels to the same.
GRAD_REL_F32, GRAD_ULPS_BF16 = 1e-5, 2.0


def _grad_error(x, ref):
    """(error, its limit) of one gradient tensor against the plain version's."""
    ref = ref.float()
    err = (x.float() - ref).abs()
    big = ref.abs().max().clamp(min=1e-30)
    if x.dtype == torch.bfloat16:
        e = torch.frexp(torch.maximum(ref.abs(), big * 2 ** -10)).exponent
        return (err / torch.ldexp(torch.ones_like(err), e - 8)).max().item(), GRAD_ULPS_BF16
    return (err.max() / big).item(), GRAD_REL_F32


def _assert_grads_match(ours, ref):
    for name, x, r in zip(("dq", "dk", "dv"), ours, ref):
        assert x.dtype == r.dtype and x.shape == r.shape, name
        err, limit = _grad_error(x, r)
        assert err <= limit, (name, err, limit)


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8], q_offset=case[9])


def _inputs(case, seed, t_stats=None):
    """fp32 numpy q, k, v, do (head-major) and the softmax stats of attention
    over the first ``t_stats`` keys (default all): lse and delta = rowsum(dO*O)."""
    b, hq, hkv, s, t, hd = case[:6]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, hq, s, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, t, hd)).astype(np.float32) for _ in range(2))
    tt = t if t_stats is None else t_stats
    o, lse = tf.flash_attention_lse_plain(*(torch.from_numpy(a) for a in (q, k[:, :, :tt],
                                                                          v[:, :, :tt])),
                                          **_kw(case))
    delta = (torch.from_numpy(do) * o).sum(-1)
    return q, k, v, do, lse.numpy(), delta.numpy()


def _reference_bwd(arrs, case):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_bwd as jflash_bwd
    ref = jflash_bwd(*(jnp.asarray(a) for a in arrs), scale=case[5] ** -0.5,
                     block_q=32, block_k=32, interpret=True, **_kw(case))
    return [torch.from_numpy(np.asarray(r, np.float32)) for r in ref]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_backward(case):
    arrs = _inputs(case, seed=sum(case[:6]))
    ours = tf.flash_attention_bwd(*(torch.from_numpy(a) for a in arrs), **_kw(case))
    _assert_grads_match(ours, _reference_bwd(arrs, case))
    assert all(torch.isfinite(g).all() for g in ours)
    if case == MASKED_CASE:
        dead = arrs[4] < -1e29
        assert dead.any() and torch.all(ours[0][torch.from_numpy(dead)] == 0)


def test_plain_version_with_merged_stats_matches_pallas_backward():
    """The chunk entry: lse/delta from attention over all T keys, gradients for
    the first half of the KV only; the two halves' dq add up to the whole."""
    case = (1, 4, 2, 48, 96, 32, True, 0, 0.0, 48)
    q, k, v, do, lse, delta = _inputs(case, seed=7)
    half = case[4] // 2
    parts = []
    for sl in (slice(None, half), slice(half, None)):
        arrs = (q, k[:, :, sl], v[:, :, sl], do, lse, delta)
        # the second chunk's keys start at `half`: shift the queries instead
        kw = dict(_kw(case), q_offset=case[9] - (0 if sl.start is None else half))
        ours = tf.flash_attention_bwd(*(torch.from_numpy(a) for a in arrs), **kw)
        _assert_grads_match(ours, _reference_bwd(arrs, case[:9] + (kw["q_offset"],)))
        parts.append(ours)
    whole = tf.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, do, lse, delta)),
                                   **_kw(case))
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([parts[0][1], parts[1][1]], 2), whole[1],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [GRAD_CASES[0], GRAD_CASES[6]])
def test_attention_chunk_grads_matches_reference(case):
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    q, k, v, do, lse, delta = _inputs(case, seed=11)
    bm = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))   # noqa: E731
    arrs = (bm(q), bm(k), bm(v), bm(do), bm(lse), bm(delta))
    ref = jlayers.attention_chunk_grads(*(jnp.asarray(a) for a in arrs), **_kw(case))
    ours = tlayers.attention_chunk_grads(*(torch.from_numpy(a) for a in arrs), **_kw(case))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [GRAD_CASES[3], GRAD_CASES[6]])
def test_autograd_function_matches_jax_grad(case):
    """grads of sum(flash_attention(q, k, v) * w) through the Function (CPU
    tensors: the plain versions) against jax.grad through the Pallas kernels."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as jflash
    q, k, v, w = _inputs(case, seed=13)[:4]

    def fused(q, k, v):
        return jnp.sum(jflash(q, k, v, block_q=32, block_k=32, interpret=True,
                              **_kw(case)) * w)

    ref = jax.grad(fused, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    loss = (tf.flash_attention(qt, kt, vt, **_kw(case)) * torch.from_numpy(w)).sum()
    ours = torch.autograd.grad(loss, (qt, kt, vt))
    _assert_grads_match(ours, [torch.from_numpy(np.asarray(r)) for r in ref])


def _wrong_grads(change, q, k, v, do, lse, delta):
    """The plain backward with one 64-wide tile dropped or counted twice: a KV
    tile in the dq sweep, or a query tile in the dk/dv sweep."""
    keys, rows = torch.arange(k.shape[2]), torch.arange(q.shape[2])
    pick = {"drop": lambda i: torch.cat([i[:64], i[128:]]),
            "double": lambda i: torch.cat([i, i[64:128]])}
    if change.endswith("kv_tile"):
        keys = pick[change.split("_")[0]](keys)
        return tf.flash_attention_bwd_plain(q, k[:, :, keys], v[:, :, keys], do, lse,
                                            delta, causal=False)[0]
    rows = pick[change.split("_")[0]](rows)
    return tf.flash_attention_bwd_plain(q[:, :, rows], k, v, do[:, :, rows],
                                        lse[:, :, rows], delta[:, :, rows],
                                        causal=False)[1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("change", ["drop_kv_tile", "double_kv_tile",
                                    "drop_q_tile", "double_q_tile"])
def test_tolerance_catches_a_wrong_tile(change, dtype):
    """What the tolerance is for: a dq sweep that skips or doubles one KV tile,
    or a dk/dv sweep that skips or doubles one query tile, misses the limit by
    more than 4x in either dtype."""
    case = (1, 8, 2, 256, 256, 128, False, 0, 0.0, 0)
    arrs = _inputs(case, seed=4)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in arrs[:4])
    lse, delta = (torch.from_numpy(a) for a in arrs[4:])
    right = tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal=False)
    wrong = _wrong_grads(change, q, k, v, do, lse, delta)
    pairs = [(wrong, right[0])] if change.endswith("kv_tile") else \
        list(zip(wrong, right[1:]))
    for x, r in pairs:
        err, limit = _grad_error(x, r)
        assert err > 4 * limit, (err, limit)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    arrs = [torch.from_numpy(a) for a in _inputs(GRAD_CASES[0], seed=2)]
    before = (tf.flash_attention_bwd.dq_launches, tf.flash_attention_bwd.dkv_launches)
    ours = tf.flash_attention_bwd(*arrs)
    for o, r in zip(ours, tf.flash_attention_bwd_plain(*arrs)):
        assert torch.equal(o, r)
    assert (tf.flash_attention_bwd.dq_launches,
            tf.flash_attention_bwd.dkv_launches) == before


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "lse_shape", "window"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    q = do = torch.zeros(1, 4, 8, 32)
    k = v = torch.zeros(1, 2, 8, 32)
    lse = delta = torch.zeros(1, 4, 8)
    kw = {}
    if bad == "do_shape":
        do = torch.zeros(1, 4, 9, 32)
    elif bad == "do_dtype":
        do = do.to(torch.bfloat16)
    elif bad == "lse_shape":
        lse = torch.zeros(1, 8, 4)
    else:
        kw = {"window": -1}
    with pytest.raises(ValueError):
        tf.flash_attention_bwd(q, k, v, do, lse, delta, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain_version_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    arrs = _inputs(case, seed=3)
    dt = getattr(torch, dtype)
    # batch-major storage, head-major views: the layout the model passes
    q, k, v, do = (torch.from_numpy(a).to(dt).transpose(1, 2).contiguous().cuda()
                   .transpose(1, 2) for a in arrs[:4])
    lse, delta = (torch.from_numpy(a).cuda() for a in arrs[4:])
    before = (tf.flash_attention_bwd.dq_launches, tf.flash_attention_bwd.dkv_launches)
    ours = tf.flash_attention_bwd(q, k, v, do, lse, delta, **_kw(case))
    torch.cuda.synchronize()
    assert (tf.flash_attention_bwd.dq_launches,
            tf.flash_attention_bwd.dkv_launches) == (before[0] + 1, before[1] + 1)
    _assert_grads_match(ours, tf.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                           **_kw(case)))
    assert all(torch.isfinite(g).all() for g in ours)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [GRAD_CASES[0], GRAD_CASES[6], MASKED_CASE])
def test_autograd_function_on_card_matches_plain_autograd(case):
    """fp32: grads of sum(flash_attention(q, k, v) * w) through B1-B3 against
    autograd through the plain forward. (In bf16 the Function takes delta from
    the bf16-rounded O, as the reference does; autograd through the plain
    forward uses the unrounded one.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, w = (torch.from_numpy(a).cuda().requires_grad_()
                  for a in _inputs(case, seed=5)[:4])
    grads = torch.autograd.grad((tf.flash_attention(q, k, v, **_kw(case)) * w).sum(),
                                (q, k, v))
    ref = torch.autograd.grad((tf.flash_attention_lse_plain(q, k, v, **_kw(case))[0]
                               * w).sum(), (q, k, v))
    _assert_grads_match(grads, ref)
