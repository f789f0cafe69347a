"""B1-B3 at every head dim the reference's kernel takes: a multiple of 8 up to
256 (``repro.kernels.dispatch.select_impl`` under ``auto`` on a TPU backend).

- The port's rule (``flash_attention.HEAD_DIMS`` and the check in
  ``dispatch.select_impl``) against the reference's for every head dim from 1
  to 264, with static windows and query offsets. The reference reads its
  backend from ``jax.default_backend``; the test makes it read "tpu".
- The plain forward and backward against the reference's Pallas kernels
  (interpret mode) at head dims the kernels' bodies are not built at (16, 40,
  8, 72): the bodies run those at the next built head dim with the columns
  past hd masked, and the plain versions are what the card holds them to.
- On a CUDA card only: the kernels against their plain versions on
  chip_smoke.py's ``HD_CASES`` in fp32 and bf16 (the forward's body counted),
  at the forward's and backward's stated tolerances:
  ``PYTHONPATH=src python -m pytest tests/test_torch_flash_hd.py -m cuda``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as tf

torch.set_num_threads(1)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()
CARD_CASES = SMOKE.HD_CASES

# (b, hq, hkv, s, t, hd, causal, window, softcap, q_offset), small for the
# reference's interpret mode; the last has fully masked rows
CASES = [
    (1, 2, 1, 32, 32, 16, True, 0, 0.0, 0),
    (1, 4, 2, 40, 40, 40, True, 12, 20.0, 0),
    (2, 2, 2, 24, 48, 8, False, 0, 0.0, 0),
    (1, 2, 1, 32, 40, 72, True, 0, 0.0, 8),
    (1, 2, 1, 64, 16, 16, True, 8, 0.0, 64),
]


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8], q_offset=case[9])


@pytest.mark.parametrize("window,q_offset", [(0, 0), (64, 0), (0, 32), (17, 5)])
def test_head_dim_rule_matches_the_reference(monkeypatch, window, q_offset):
    """hd 1..264: the port's kernels take exactly the head dims that the
    reference's ``auto`` sends to its kernel on a TPU backend."""
    import repro.kernels.dispatch as jdispatch
    monkeypatch.setattr(jdispatch.jax, "default_backend", lambda: "tpu")
    ref, ours = set(), set()
    for hd in range(1, 265):
        if jdispatch.select_impl("auto", head_dim=hd, window=window,
                                 q_offset=q_offset) == "pallas":
            ref.add(hd)
        try:
            if dispatch.select_impl("auto", head_dim=hd, device="cuda") == "cuda":
                ours.add(hd)
        except ValueError:
            pass
    assert ours == ref == set(tf.HEAD_DIMS)
    assert {16, 40, 72, 256} <= ours and not {1, 12, 100, 264} & ours


def test_the_reference_rule_needs_its_accelerator(monkeypatch):
    """Off its accelerator the reference takes XLA whatever the head dim, so
    the rule above is the one it applies where its kernel runs."""
    import repro.kernels.dispatch as jdispatch
    monkeypatch.setattr(jdispatch.jax, "default_backend", lambda: "cpu")
    assert jdispatch.select_impl("auto", head_dim=64, window=0, q_offset=0) == "xla"


def _inputs(case, seed):
    b, hq, hkv, s, t, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, hd), (b, hkv, t, hd), (b, hkv, t, hd), (b, hq, s, hd))]


@pytest.mark.parametrize("case", CASES)
def test_plain_forward_matches_pallas_at_new_head_dims(case):
    """o to 3e-5 and lse to 1e-5 relative (chip_smoke.py's fp32 limits)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_lse
    q, k, v, _ = _inputs(case, seed=sum(case[:6]))
    ro, rlse = flash_attention_lse(*(jnp.asarray(a) for a in (q, k, v)), interpret=True,
                                   **_kw(case))
    o, lse = tf.flash_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)), **_kw(case))
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=0, atol=SMOKE.O_ABS_F32)
    rlse = np.asarray(rlse)
    assert np.max(np.abs(lse.numpy() - rlse) / np.maximum(np.abs(rlse), 1.0)) <= SMOKE.LSE_REL
    if case == CASES[-1]:
        dead = lse.numpy() < -1e29
        assert dead.any() and np.all(o.numpy()[dead] == 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas_at_new_head_dims(case):
    """dq, dk, dv within 1e-5 of each tensor's max |value| (the fp32 rule)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_bwd as jbwd
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=sum(case[:6]) + 1))
    o, lse = tf.flash_attention_lse_plain(q, k, v, **_kw(case))
    delta = (do * o).sum(-1)
    arrs = [x.numpy() for x in (q, k, v, do, lse, delta)]
    ref = jbwd(*(jnp.asarray(a) for a in arrs), scale=case[5] ** -0.5, block_q=16,
               block_k=16, interpret=True, **_kw(case))
    ours = tf.flash_attention_bwd(q, k, v, do, lse, delta, **_kw(case))
    for name, x, r in zip(("dq", "dk", "dv"), ours, ref):
        r = torch.from_numpy(np.asarray(r, np.float32))
        err = SMOKE.grad_error(x, r)[1]
        assert err <= SMOKE.GRAD_REL_F32, (name, err)


def test_card_cases_hold_each_edge_class():
    """chip_smoke.py's HD_CASES, the card's list for the new head dims: hd 16
    (the examples') and odd multiples of 8 inside each built body, bf16 at a
    head dim padded to 128 that the Hopper body must not take, ragged rows,
    windows, softcap, q_offset and fully masked rows."""
    hds = {c[5] for c in CARD_CASES}
    assert {8, 16, 40, 72, 96, 200} <= hds and not hds & {32, 64, 128, 256}
    assert all(hd in tf.HEAD_DIMS for hd in hds)
    for hd in (16, 40):
        cases = [c for c in CARD_CASES if c[5] == hd]
        assert any(c[7] for c in cases), "a window"
        assert any(c[9] >= c[4] + c[7] for c in cases if c[7]), "fully masked rows"
    assert any(c[3] % 64 and c[4] % 64 for c in CARD_CASES), "ragged S and T"
    assert any(c[8] for c in CARD_CASES), "softcap"
    assert any(not c[6] for c in CARD_CASES), "non-causal"


@pytest.mark.parametrize("dtype,hd,body", [("bfloat16", 16, "mma"), ("bfloat16", 96, "mma"),
                                           ("bfloat16", 200, "mma"), ("float32", 40, "f32")])
def test_new_head_dims_take_the_masked_bodies(dtype, hd, body):
    """The Hopper body keeps bf16 hd 64 and 128; every other head dim runs
    the first-version bf16 body or the fp32 body."""
    assert tf.fwd_body(torch.zeros(1, 2, 8, hd, dtype=getattr(torch, dtype))) == body


def _card_inputs(case, dtype, seed):
    """q, k, v, do on the card as head-major views of batch-major storage."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, hq, hkv, s, t, hd = case[:6]
    return [SMOKE.batch_major(gen, b, h, n, hd, getattr(torch, dtype))
            for h, n in ((hq, s), (hkv, t), (hkv, t), (hq, s))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_forward_matches_plain_version_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    SMOKE.flash_case_check(case, getattr(torch, dtype),
                           torch.Generator(device="cuda").manual_seed(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_backward_matches_plain_version_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, do = _card_inputs(case, dtype, seed=4)
    o, lse = tf.flash_attention_lse_plain(q, k, v, **_kw(case))
    delta = (do.float() * o.float()).sum(-1)
    grads = tf.flash_attention_bwd(q, k, v, do, lse, delta, **_kw(case))
    ref = tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, **_kw(case))
    errs = [SMOKE.grad_error(g, r) for g, r in zip(grads, ref)]
    assert SMOKE.grads_within(q.dtype, errs), errs
    dead = lse < -1e29
    assert (grads[0].float()[dead] == 0).all()
