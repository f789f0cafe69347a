"""The flash-attention forward: the kernel's plain PyTorch version against the
reference Pallas kernel (interpret mode, as tests/test_kernels.py runs it), the
wrapper's input checks and body rule, and — on a CUDA card only — the kernel
against its plain version on chip_smoke.py's FLASH_CASES. The module imports JAX
only inside the tests that hold the port to the reference, so the card's tests
also run on the GPU machine, which has none:
``PYTHONPATH=src python -m pytest tests/test_torch_flash.py -m cuda``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tf
from repro_torch.kernels.ref import flash_attention_ref

torch.set_num_threads(1)

# shrunk copies of tests/test_kernels.py::FLASH_CASES, plus q_offset, small
# copies of the Hopper body's edges at hd 64 and 128, and a case with fully
# masked rows last: (b, hq, hkv, s, t, hd, causal, window, softcap, q_offset)
CASES = [
    (1, 4, 2, 64, 64, 32, True, 0, 0.0, 0),
    (1, 2, 2, 64, 64, 32, True, 16, 0.0, 0),
    (1, 2, 1, 50, 50, 32, True, 0, 30.0, 0),          # non-divisible seq
    (1, 4, 2, 64, 64, 64, False, 0, 0.0, 0),
    (1, 2, 2, 32, 96, 32, True, 0, 0.0, 0),           # cross lengths
    (1, 2, 1, 32, 32, 256, True, 4096, 50.0, 0),      # gemma2-like head dim
    (1, 4, 2, 40, 90, 32, True, 0, 0.0, 50),          # q_offset
    (1, 2, 2, 130, 130, 128, True, 0, 0.0, 0),        # ragged past a 128-query tile
    (1, 2, 1, 100, 40, 64, False, 0, 0.0, 0),         # T shorter than one key tile
    (1, 5, 1, 64, 64, 64, True, 0, 0.0, 0),           # GQA group 5
    (1, 2, 1, 96, 64, 128, True, 16, 0.0, 48),        # q_offset: rows 31.. see no key
    (1, 2, 2, 192, 192, 128, True, 127, 0.0, 0),      # window 64 m - 1, on a tile edge
    (1, 2, 2, 96, 96, 64, True, 40, 20.0, 0),         # window and softcap
    (2, 2, 2, 40, 75, 64, False, 0, 0.0, 0),          # cross lengths, ragged T (whisper)
    (2, 2, 2, 1, 75, 64, False, 0, 0.0, 0),           # S = 1 (whisper's decode step)
    (1, 2, 1, 64, 16, 32, True, 8, 0.0, 64),          # fully masked rows
]


def _smoke():
    """chip_smoke.py, whose FLASH_CASES is the one list of B1's card cases."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# Card only: chip_smoke.py's FLASH_CASES. In bf16 at hd 64 and 128 they run the
# Hopper body (128-query blocks, 64-key streamed tiles): ragged S and T, T
# shorter than one tile, GQA groups 1, 2 and 5, q_offset with fully masked rows,
# windows on the tile edge with and without softcap, interior tiles only,
# zamba2's serving shape cut in S, and the serving path's shape.
CARD_CASES = _smoke().FLASH_CASES

# o in fp32 to 3e-5; o in bf16 to 2 bf16 ulps of the reference (both sides round
# an fp32 result once); lse, fp32 math on the same inputs in both dtypes, to 1e-5
# relative. A KV tile dropped or counted twice moves o by tens of ulps.
O_ABS_F32, O_ULPS_BF16, LSE_REL = 3e-5, 2.0, 1e-5


def _ulps(err, ref):
    """|err| in bf16 ulps of |ref|, with |ref| floored at 2^-10 so that the fp32
    noise (~1e-6) on an output near zero is not counted in ulps of zero."""
    e = torch.frexp(ref.float().abs().clamp(min=2 ** -10)).exponent
    return err.abs() / torch.ldexp(torch.ones_like(err), e - 8)


def _errors(o, lse, ro, rlse):
    """(o error, its tolerance, lse relative error): o in bf16 ulps for bf16,
    absolute for fp32."""
    ro, rlse = ro.float(), rlse.float()
    err = o.float() - ro
    lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
    if o.dtype == torch.bfloat16:
        return _ulps(err, ro).max().item(), O_ULPS_BF16, lse_err
    return err.abs().max().item(), O_ABS_F32, lse_err


def _assert_matches(o, lse, ro, rlse):
    o_err, o_tol, lse_err = _errors(o, lse, ro, rlse)
    assert o_err <= o_tol and lse_err <= LSE_REL, (o_err, lse_err)


def _inputs(case, dtype, seed):
    """fp32 numpy arrays and the same values as torch tensors of ``dtype``."""
    b, hq, hkv, s, t, hd = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, hd), (b, hkv, t, hd), (b, hkv, t, hd))]
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8], q_offset=case[9])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_kernel(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_lse
    arrs, (qt, kt, vt) = _inputs(case, dtype, seed=sum(case[:6]))
    qj, kj, vj = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    ro, rlse = flash_attention_lse(qj, kj, vj, interpret=True, **_kw(case))
    o, lse = tf.flash_attention_lse(qt, kt, vt, **_kw(case))   # CPU: plain version
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    _assert_matches(o, lse, torch.from_numpy(np.asarray(ro, np.float32)),
                    torch.from_numpy(np.asarray(rlse)))
    dead = lse.numpy() < -1e29
    if case == CASES[-1]:
        assert dead.any() and np.all(o.float().numpy()[dead] == 0)
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()


@pytest.mark.parametrize("change", ["drop_tile", "double_tile", "drop_key"])
def test_tolerance_catches_a_wrong_kv_tile(change):
    """What the bf16 tolerance is for: attention that skips one 64-key tile,
    counts it twice, or skips one key fails it on o and on lse alike."""
    _, (q, k, v) = _inputs((1, 8, 2, 128, 256, 128), "bfloat16", seed=4)
    po, plse = tf.flash_attention_lse_plain(q, k, v, causal=False)
    keys = torch.arange(256)
    keys = {"drop_tile": torch.cat([keys[:64], keys[128:]]),
            "double_tile": torch.cat([keys, keys[64:128]]),
            "drop_key": torch.cat([keys[:100], keys[101:]])}[change]
    o, lse = tf.flash_attention_lse_plain(q, k[:, :, keys], v[:, :, keys], causal=False)
    o_err, o_tol, lse_err = _errors(o, lse, po, plse)
    assert o_err > 4 * o_tol and lse_err > 4 * LSE_REL, (o_err, lse_err)


def test_plain_version_matches_oracle():
    case = (2, 4, 2, 24, 24, 32, True, 6, 20.0, 0)
    _, (q, k, v) = _inputs(case, "float32", seed=1)
    kw = _kw(case)
    del kw["q_offset"]
    np.testing.assert_allclose(tf.flash_attention(q, k, v, **kw).numpy(),
                               flash_attention_ref(q, k, v, **kw).numpy(),
                               rtol=3e-5, atol=3e-5)


def _counts():
    f = tf.flash_attention_lse
    return f.launches, f.sm90_launches, f.mma_launches, f.f32_launches


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    _, (q, k, v) = _inputs(CASES[0], "float32", seed=2)
    before = _counts()
    o, lse = tf.flash_attention_lse(q, k, v)
    po, plse = tf.flash_attention_lse_plain(q, k, v)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert _counts() == before


@pytest.mark.parametrize("dtype,hd,body", [("bfloat16", 64, "sm90"), ("bfloat16", 128, "sm90"),
                                           ("bfloat16", 32, "mma"), ("bfloat16", 256, "mma"),
                                           ("float32", 128, "f32"), ("float32", 64, "f32")])
def test_body_rule(dtype, hd, body):
    """Every path's head dim runs the Hopper body in bf16; no input chooses
    between bodies at run time."""
    assert tf.fwd_body(torch.zeros(1, 2, 8, hd, dtype=getattr(torch, dtype))) == body


def _attended(case):
    """The (S, T) mask of a case, as the kernel applies it."""
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = case
    rows = q_offset + np.arange(s)[:, None]
    cols = np.arange(t)[None, :]
    m = np.ones((s, t), bool)
    if causal:
        m &= cols <= rows
    if window > 0:
        m &= (rows - cols) < window
    return m


def test_card_cases_hold_each_edge_class():
    """chip_smoke.py's FLASH_CASES, the card tests' list, reaches every edge of
    the Hopper body at both of its head dims, and ends with the serving path."""
    smoke = _smoke()
    assert CARD_CASES[-1] == (smoke.BATCH, 40, 8, smoke.PROMPT, smoke.PROMPT, 128, True, 0,
                              0.0, 0)
    for hd in tf.SM90_HEAD_DIMS:
        cases = [c for c in CARD_CASES if c[5] == hd]
        assert any(c[3] % 128 and c[4] % 64 for c in cases), "ragged S and T"
        assert any(c[4] < 64 for c in cases), "T shorter than one key tile"
        assert {1, 2, 5} <= {c[1] // c[2] for c in cases}, "GQA groups"
        assert any(c[9] and not _attended(c).any(axis=1).all() for c in cases), \
            "q_offset with fully masked rows"
        assert any(c[7] and c[8] for c in cases), "a window with softcap"
        assert any(not c[6] for c in cases), "interior tiles only"
    windows = {(c[5], c[7]) for c in CARD_CASES if c[7] and not c[8]}
    assert {(128, 191), (64, 255)} <= windows, "windows on the tile edge, no softcap"
    assert any(c[:3] == (4, 32, 32) and c[5] == 64 and c[3] < 8000 for c in CARD_CASES), \
        "zamba2's serving shape, cut in S"
    whisper = [c for c in CARD_CASES if c[:3] == (4, 12, 12) and c[5] == 64 and not c[6]]
    assert {c[3] for c in whisper} >= {1, 1500, 4096} and all(c[4] == 1500 for c in whisper), \
        "whisper's encoder, decode cross-attention (S = 1) and training cross-attention"


@pytest.mark.parametrize("bad", ["kv_shape", "heads", "dtype", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 8, 32)
    k = v = torch.zeros(1, 2, 8, 32)
    kw = {}
    if bad == "kv_shape":
        v = torch.zeros(1, 2, 9, 32)
    elif bad == "heads":
        k = v = torch.zeros(1, 3, 8, 32)
    elif bad == "dtype":
        k = v = k.to(torch.bfloat16)
    else:
        kw = {"window": -1}
    with pytest.raises(ValueError):
        tf.flash_attention_lse(q, k, v, **kw)


def _card_inputs(case, dtype, seed):
    """_inputs on the card, as head-major views of batch-major storage (the
    layout the model passes)."""
    _, inputs = _inputs(case, dtype, seed=seed)
    return [x.transpose(1, 2).contiguous().cuda().transpose(1, 2) for x in inputs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + CARD_CASES)
def test_kernel_matches_plain_version_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _card_inputs(case, dtype, seed=3)
    body = tf.fwd_body(q)
    before = getattr(tf.flash_attention_lse, f"{body}_launches")
    o, lse = tf.flash_attention_lse(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    assert getattr(tf.flash_attention_lse, f"{body}_launches") == before + 1
    po, plse = tf.flash_attention_lse_plain(q, k, v, **_kw(case))
    _assert_matches(o, lse, po, plse)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    dead = plse < -1e29                          # fully masked rows
    assert (o.float()[dead] == 0).all() and (lse[dead] < -1e29).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_kernel_is_deterministic_on_card(hd):
    """bf16 through the Hopper body: two launches give bit-identical o and lse
    (each row is written once by one warpgroup; no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    case = (1, 4, 2, 1000, 1000, hd, True, 0, 0.0, 0)
    q, k, v = _card_inputs(case, "bfloat16", seed=8)
    first = tf.flash_attention_lse(q, k, v)
    second = tf.flash_attention_lse(q, k, v)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
