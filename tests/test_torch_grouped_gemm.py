"""The grouped expert GEMM: the kernel's plain PyTorch version and the plain
dispatch against the reference Pallas kernel (interpret mode, with the small
blocks tests/test_kernels_grad.py uses) and ``expert_gemm_ref``, the autograd
Function's dx and dw against ``jax.grad``, the wrapper's checks and layouts, what
the stated tolerance catches, the body rule, and — on a CUDA card only — the
kernel against its plain version in all three uses (forward and dx in rows mode,
dw in contract mode through a transposed view) on chip_smoke.py's GEMM_CASES.
The module imports JAX only inside the tests that hold the port to the
reference, so the card's tests also run on the GPU machine, which has none:
``PYTHONPATH=src python -m pytest tests/test_torch_grouped_gemm.py -m cuda``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels import grouped_gemm as tg
from repro_torch.kernels.ref import expert_gemm_ref

torch.set_num_threads(1)

# tests/test_kernels.py::GEMM_CASES: (e, c, d, f), the second ragged everywhere;
# then rows off a 128-row tile with a contraction shorter than one 64-deep tile
GEMM_CASES = [
    (4, 64, 128, 256),
    (2, 100, 130, 70),
    (8, 128, 256, 512),
    (1, 32, 512, 64),
    (3, 150, 40, 72),
]
# tests/test_kernels_grad.py::GEMM_GRAD_CASES: (e, c, d, f, group_sizes) with
# empty experts, full experts and loads that straddle a row tile; then an expert
# whose row tiles past the first (of 16) are all padding
GRAD_CASES = [
    (2, 32, 16, 24, None),
    (3, 33, 20, 17, (33, 7, 0)),
    (2, 64, 32, 32, (40, 64)),
    (4, 16, 48, 16, (5, 0, 16, 11)),
    (4, 40, 24, 16, (40, 0, 21, 5)),
]
# The reference's measure, |ours - ref| / max(|ref|, 1): fp32 within 5e-5, as
# there. For bf16 both sides round one fp32 sum to bf16, so they differ by at
# most one bf16 ulp (where the two sums straddle a rounding boundary), which is
# at most 2^-7 of the value: 8e-3 (the reference allows 3e-2).
REL_F32, REL_BF16 = 5e-5, 8e-3
# The card's check (and chip_smoke.py's): fp32 within 5e-5 of the tensor's largest
# |value|; bf16 within 2 bf16 ulps of each value, |value| floored at 2^-10 of the
# largest. A dropped 32-deep contraction tile or one row of the wrong expert misses
# by far more (test_tolerance_catches_a_dropped_tile).
CARD_REL_F32, CARD_ULPS_BF16 = 5e-5, 2.0


def _np_inputs(shape_x, shape_w, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_x).astype(np.float32),
            rng.standard_normal(shape_w).astype(np.float32))


def _rel(ours, ref):
    ref = np.asarray(ref, np.float32)
    return float((np.abs(ours.float().numpy() - ref) / np.maximum(np.abs(ref), 1.0)).max())


def _card_error(x, ref):
    """(error, limit) in the card check's measure (see CARD_*)."""
    ref = ref.float()
    err = (x.float() - ref).abs()
    big = ref.abs().max().clamp(min=1e-30)
    if x.dtype == torch.bfloat16:
        e = torch.frexp(torch.maximum(ref.abs(), big * 2 ** -10)).exponent
        return (err / torch.ldexp(torch.ones_like(err), e - 8)).max().item(), CARD_ULPS_BF16
    return (err.max() / big).item(), CARD_REL_F32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMM_CASES)
def test_plain_versions_match_pallas_kernel(case, dtype):
    import jax.numpy as jnp
    from repro.kernels import expert_gemm
    from repro.kernels.ref import expert_gemm_ref as jax_ref
    e, c, d, f = case
    xa, wa = _np_inputs((e, c, d), (e, d, f), seed=sum(case))
    xj, wj = jnp.asarray(xa, getattr(jnp, dtype)), jnp.asarray(wa, getattr(jnp, dtype))
    ref = expert_gemm(xj, wj, block_c=64, block_f=64, block_d=64, interpret=True)
    x, w = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (xa, wa))
    limit = REL_F32 if dtype == "float32" else REL_BF16
    for ours in (tg.grouped_gemm(x, w),                                # CPU: plain version
                 dispatch.dispatch_expert_gemm(x, w, impl="plain"),
                 expert_gemm_ref(x, w)):
        assert ours.dtype == x.dtype and ours.shape == (e, c, f)
        assert _rel(ours, ref) < limit
    assert _rel(expert_gemm_ref(x, w), jax_ref(xj, wj)) < limit


@pytest.mark.parametrize("case", GRAD_CASES)
def test_autograd_matches_jax_grad(case):
    """Forward, dx (rows mode) and dw (contract mode) of ``expert_gemm`` on the
    CPU — the Function running the plain versions — and of the plain dispatch,
    against ``jax.grad`` through the reference kernel in interpret mode."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import expert_gemm
    e, c, d, f, gs_t = case
    rng = np.random.default_rng(abs(hash(case)) % 2 ** 32)
    xa, wa, cota = (rng.standard_normal(s).astype(np.float32)
                    for s in ((e, c, d), (e, d, f), (e, c, f)))
    gsa = None if gs_t is None else np.asarray(gs_t, np.int32)
    gsj = None if gsa is None else jnp.asarray(gsa)

    def fused(x, w):
        return jnp.sum(expert_gemm(x, w, gsj, block_c=16, block_f=16, block_d=16,
                                   interpret=True) * cota)

    ref_loss = float(fused(xa, wa))
    ref_dx, ref_dw = jax.grad(fused, argnums=(0, 1))(jnp.asarray(xa), jnp.asarray(wa))
    gs = None if gsa is None else torch.from_numpy(gsa)
    for fn in (tg.expert_gemm, lambda x, w, g: dispatch.dispatch_expert_gemm(x, w, g)):
        x, w = (torch.from_numpy(a).requires_grad_() for a in (xa, wa))
        loss = (fn(x, w, gs) * torch.from_numpy(cota)).sum()
        dx, dw = torch.autograd.grad(loss, (x, w))
        np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), rtol=1e-4, atol=1e-4)


def test_ref_matches_reference_ref_with_group_sizes():
    import jax.numpy as jnp
    from repro.kernels.ref import expert_gemm_ref as jax_ref
    xa, wa = _np_inputs((4, 24, 16), (4, 16, 8), seed=3)
    gsa = np.asarray([24, 0, 9, 17], np.int32)
    ours = expert_gemm_ref(torch.from_numpy(xa), torch.from_numpy(wa), torch.from_numpy(gsa))
    ref = jax_ref(jnp.asarray(xa), jnp.asarray(wa), jnp.asarray(gsa))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert np.all(ours.numpy()[1] == 0) and np.all(ours.numpy()[2, 9:] == 0)


def test_zero_load_expert_gives_zero_output_and_grads():
    """tests/test_kernels_grad.py::test_expert_gemm_group_sizes_zero_expert."""
    xa, wa = _np_inputs((2, 16, 8), (2, 8, 8), seed=0)
    x, w = (torch.from_numpy(a).requires_grad_() for a in (xa, wa))
    gs = torch.tensor([0, 16], dtype=torch.int32)
    out = tg.expert_gemm(x, w, gs)
    assert float(out[0].abs().max()) == 0.0
    dx, dw = torch.autograd.grad(out.sum(), (x, w))
    assert float(dx[0].abs().max()) == 0.0 and float(dw[0].abs().max()) == 0.0
    assert float(dx[1].abs().max()) > 0.0


def test_contract_mode_is_the_weight_gradient():
    """Contract mode over x^T reads only the real rows: it equals x's first gs
    rows transposed times g's first gs rows, per expert."""
    xa, ga = _np_inputs((3, 12, 5), (3, 12, 7), seed=5)
    gs = [12, 0, 7]
    x, g = torch.from_numpy(xa), torch.from_numpy(ga)
    dw = tg.grouped_gemm(x.transpose(1, 2), g, torch.tensor(gs, dtype=torch.int32),
                         mask="contract")
    for i, n in enumerate(gs):
        np.testing.assert_allclose(dw[i].numpy(), xa[i, :n].T @ ga[i, :n], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("change", ["drop_tile", "wrong_row"])
def test_tolerance_catches_a_dropped_tile(change):
    """What the card's bf16 tolerance is for: a product that skips one 32-deep
    contraction tile, or takes one row from another expert, fails it."""
    xa, wa = _np_inputs((4, 64, 256), (4, 256, 128), seed=6)
    x, w = torch.from_numpy(xa).bfloat16(), torch.from_numpy(wa).bfloat16()
    ref = tg.grouped_gemm_plain(x, w)
    if change == "drop_tile":
        x = x.clone()
        x[:, :, 64:96] = 0
    else:
        x = x.clone()
        x[0, 5] = x[1, 5]
    err, limit = _card_error(tg.grouped_gemm_plain(x, w), ref)
    assert err > 4 * limit, err


def _counts():
    f = tg.grouped_gemm
    return (f.rows_launches, f.contract_launches, f.sm90_launches, f.mma_launches,
            f.f32_launches)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    xa, wa = _np_inputs((2, 9, 8), (2, 8, 5), seed=2)
    x, w = torch.from_numpy(xa), torch.from_numpy(wa)
    gs = torch.tensor([3, 9], dtype=torch.int32)
    before = _counts()
    for mask in tg.MASK_MODES:
        assert torch.equal(tg.grouped_gemm(x, w, gs, mask=mask),
                           tg.grouped_gemm_plain(x, w, gs, mask=mask))
    assert _counts() == before


def test_plain_version_ignores_nan_padding():
    """Padding rows (at or past each expert's load) may hold anything, NaN from
    torch.empty included: the plain version gives the same result as with
    zeros there, in both modes (rows mode: x's padding; contract mode: both
    operands'), and that result is the Pallas kernel's on the zero-padded
    inputs. (The reference's contract mode zeroes only the weight tile, so NaN
    in x's padding would reach its dw; the port zeroes both.)"""
    import jax.numpy as jnp
    from repro.kernels.grouped_gemm import _grouped_gemm
    rng = np.random.default_rng(9)
    gsa = np.asarray([70, 0, 33, 5], np.int32)
    xa, ga = (rng.standard_normal((4, 70, n)).astype(np.float32) for n in (40, 24))
    wa = rng.standard_normal((4, 40, 24)).astype(np.float32)
    pad = np.arange(70)[None, :, None] >= gsa[:, None, None]
    xa, ga = (np.where(pad, 0.0, a).astype(np.float32) for a in (xa, ga))
    gs = torch.from_numpy(gsa)
    x, w, g = (torch.from_numpy(a) for a in (xa, wa, ga))
    xn, gn = (t.masked_fill(torch.from_numpy(pad), float("nan")) for t in (x, g))
    for a, b, an, bn, mask in ((x, w, xn, w, "rows"),
                               (x.transpose(1, 2), g, xn.transpose(1, 2), gn, "contract")):
        ours = tg.grouped_gemm(an, bn, gs, mask=mask)            # CPU: plain version
        assert torch.isfinite(ours).all()
        assert torch.equal(ours, tg.grouped_gemm_plain(a, b, gs, mask=mask))
        ref = _grouped_gemm(jnp.asarray(a.contiguous().numpy()), jnp.asarray(b.numpy()),
                            jnp.asarray(gsa), mask=mask, block_r=32, block_co=32,
                            block_k=32, interpret=True)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,shape_x,shape_w,transpose,body", [
    ("bfloat16", (64, 468, 2048), (64, 2048, 1408), False, "sm90"),   # prefill
    ("bfloat16", (64, 1, 2048), (64, 2048, 1408), False, "sm90"),     # decode
    ("bfloat16", (64, 480, 1408), (64, 2048, 1408), True, "sm90"),    # dx: w^T view
    ("bfloat16", (3, 33, 20), (3, 20, 17), False, "mma"),             # off the 16-byte rule
    ("float32", (64, 468, 2048), (64, 2048, 1408), False, "f32"),
])
def test_body_rule(dtype, shape_x, shape_w, transpose, body):
    """The static rule: bf16 with both operands within the 16-byte rule runs
    the Hopper body at any row count; other bf16 calls the mma.sync body; fp32
    the FMA body. Shapes only: meta tensors hold no data."""
    dt = getattr(torch, dtype)
    x = torch.empty(shape_x, dtype=dt, device="meta")
    w = torch.empty(shape_w, dtype=dt, device="meta")
    if transpose:
        w = w.transpose(1, 2)
    assert tg.gemm_body(x, w) == body


def test_strides_of_unit_dims_suit_tma():
    """A size-1 dim's stride is never stepped; the kernel is handed the
    tensor's extent rounded up to a multiple of 8 elements there, and the real
    strides elsewhere."""
    x = torch.zeros(1, 5, 63, dtype=torch.bfloat16).transpose(1, 2)      # (1, 63, 5)
    assert tg._strides(x) == [320, 1, 63]
    assert tg._strides(torch.zeros(4, 5, 64)) == [320, 64, 1]


@pytest.mark.parametrize("bad", ["shape", "dtype", "gs_dtype", "gs_shape", "mask"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w, gs, kw = torch.zeros(2, 4, 8), torch.zeros(2, 8, 3), None, {}
    if bad == "shape":
        w = torch.zeros(2, 7, 3)
    elif bad == "dtype":
        w = w.bfloat16()
    elif bad == "gs_dtype":
        gs = torch.zeros(2, dtype=torch.int64)
    elif bad == "gs_shape":
        gs = torch.zeros(3, dtype=torch.int32)
    else:
        kw = {"mask": "cols"}
    with pytest.raises(ValueError):
        tg.grouped_gemm(x, w, gs, **kw)


def test_layouts_of_the_three_uses():
    """The forward reads x k-contiguous and w n-contiguous; dx reads g and the
    w^T view k-contiguous; dw reads the x^T view m-contiguous and g n-contiguous:
    all with 16-byte copies at the path's widths, no copy made. A ragged stride
    takes the element-wise loads."""
    x = torch.zeros(4, 5, 64, dtype=torch.bfloat16)
    w = torch.zeros(4, 64, 24, dtype=torch.bfloat16)
    g = torch.zeros(4, 5, 24, dtype=torch.bfloat16)
    assert tg._layout(x, 2, 1) == (1, 1) and tg._layout(w, 1, 2) == (0, 1)
    assert tg._layout(g, 2, 1) == (1, 1) and tg._layout(w.transpose(1, 2), 1, 2) == (1, 1)
    assert tg._layout(x.transpose(1, 2), 2, 1) == (0, 1) and tg._layout(g, 1, 2) == (0, 1)
    assert tg._layout(torch.zeros(4, 5, 63, dtype=torch.bfloat16), 2, 1) == (1, 0)
    assert tg._layout(x.float(), 2, 1) == (1, 0)          # fp32: element-wise loads


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _smoke():
    """chip_smoke.py, whose GEMM_CASES is the one list of B4's card cases."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# chip_smoke.py's GEMM_CASES, (e, c, d, f, group sizes, NaN padding): the MoE
# paths' shapes (group sizes "random"), then the edges of both bodies — ragged
# everywhere, strides off the 16-byte rule (the mma.sync body), empty experts,
# straddling loads, one row per expert (decode's rows, the Hopper body), a
# contraction longer than the ring, M off 128 with a
# straddling contract-mode tile over NaN padding and all-padding row tiles, K
# shorter than one tile
CARD_CASES = _smoke().GEMM_CASES
EDGE_CASES = [c for c in CARD_CASES if c[4] != "random"]


def test_card_cases_hold_each_edge_class():
    assert all(c[4] == "random" or c[4] is None or len(c[4]) == c[0] for c in CARD_CASES)
    for shape in ((64, 468, 2048, 1408), (64, 1, 2048, 1408), (64, 480, 2048, 1408)):
        assert any(c[:4] == shape for c in CARD_CASES), shape
    for shape in ((32, 240, 2048, 1408), (32, 480, 2048, 1408)):     # the EP chunks
        assert any(c[:4] == shape and c[4] is None for c in CARD_CASES), shape
    assert any(c[1] % 128 and c[1] > 128 for c in EDGE_CASES), "M not a multiple of 128"
    assert any(c[2] < 64 for c in EDGE_CASES), "K shorter than one tile"
    assert any(c[1] == 1 for c in EDGE_CASES), "one row per expert (decode)"
    assert any(c[2] % 8 or c[3] % 8 for c in EDGE_CASES), \
        "strides off the 16-byte rule (the mma.sync body)"
    assert any(0 in c[4] for c in EDGE_CASES if c[4]), "a zero-load expert"
    nan = [c for c in EDGE_CASES if c[5]]
    assert any(any(g % 64 and g < c[1] for g in c[4]) for c in nan), \
        "a contract-mode tile straddling gs over NaN padding"
    assert any(any(0 < g <= c[1] - 128 for g in c[4]) for c in EDGE_CASES if c[4]), \
        "a row tile that is all padding"


def _card_gs(case, rng):
    """A GEMM_CASES row's group sizes on the card ("random": drawn with 0, C and
    loads that straddle a 64- and a 128-row tile)."""
    e, c, gs_spec = case[0], case[1], case[4]
    if gs_spec is None:
        return None
    if gs_spec == "random":
        gs = rng.integers(0, c + 1, e).astype(np.int32)
        gs[:4] = (0, c, min(c, 67), min(c, 131))
    else:
        gs = np.asarray(gs_spec, np.int32)
    return torch.from_numpy(gs).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_version_on_card(case, dtype):
    _card()
    e, c, d, f, _, nan_pad = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(case[:4]))
    x, w, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt).cuda()
               for s in ((e, c, d), (e, d, f), (e, c, f)))
    gs = _card_gs(case, rng)
    if nan_pad:
        pad = torch.arange(c, device="cuda")[None, :, None] >= gs[:, None, None]
        x, g = (t.masked_fill(pad, float("nan")) for t in (x, g))
    uses = [(x, w, "rows"),                          # forward
            (g, w.transpose(1, 2), "rows"),          # dx = g . w^T, a strided view
            (x.transpose(1, 2), g, "contract")]      # dw = x^T . g, a strided view
    for a, b, mask in uses:
        before = _counts()
        out = tg.grouped_gemm(a, b, gs, mask=mask)
        torch.cuda.synchronize()
        body = tg.gemm_body(a, b)
        grew = [x1 - x0 for x0, x1 in zip(before, _counts())]
        assert grew == [mask == "rows", mask == "contract", body == "sm90", body == "mma",
                        body == "f32"], (mask, body, grew)
        ref = tg.grouped_gemm_plain(a, b, gs, mask=mask)
        err, limit = _card_error(out, ref)
        assert err <= limit, (mask, body, err)
        assert torch.isfinite(out).all()
        if gs is not None:
            assert (out.float()[gs == 0] == 0).all()
            if mask == "rows":
                rows = torch.arange(a.shape[1], device="cuda")[None, :, None]
                assert (out.float()[(rows >= gs[:, None, None]).expand_as(out)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES[:2])
def test_autograd_function_matches_plain_autograd_on_card(case):
    _card()
    e, c, d, f, gs_t, _ = case
    rng = np.random.default_rng(7)
    x, w, cot = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
                 for s in ((e, c, d), (e, d, f), (e, c, f)))
    gs = None if gs_t is None else torch.tensor(gs_t, dtype=torch.int32, device="cuda")
    grads = []
    for fn in (tg.expert_gemm, lambda x, w, g: dispatch.dispatch_expert_gemm(
            x, w, g, impl="plain")):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad((fn(xl, wl, gs) * cot).sum(), (xl, wl)))
    for ours, ref in zip(*grads):
        err, limit = _card_error(ours, ref)
        assert err <= limit, err


@pytest.mark.cuda
@pytest.mark.parametrize("mask", tg.MASK_MODES)
def test_kernel_is_deterministic_on_card(mask):
    """bf16 through the Hopper body at the prefill's widths: two launches give
    bit-identical results (no split-K, no atomics)."""
    _card()
    rng = np.random.default_rng(8)
    x, w, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16().cuda()
               for s in ((16, 468, 2048), (16, 2048, 1408), (16, 468, 1408)))
    gs = torch.from_numpy(rng.integers(0, 469, 16).astype(np.int32)).cuda()
    a, b = (x, w) if mask == "rows" else (x.transpose(1, 2), g)      # forward; dw
    assert tg.gemm_body(a, b) == "sm90"
    assert torch.equal(tg.grouped_gemm(a, b, gs, mask=mask), tg.grouped_gemm(a, b, gs, mask=mask))


@pytest.mark.cuda
def test_kernel_rejects_other_dtypes_on_card():
    _card()
    x = torch.zeros(2, 4, 8, dtype=torch.float16, device="cuda")
    w = torch.zeros(2, 8, 8, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="float16"):
        tg.grouped_gemm(x, w)
    with pytest.raises(ValueError):
        dispatch.dispatch_expert_gemm(x, w, impl="auto")
