"""The SSD chunk scan: the port's ``ssd_chunk_scan`` (its plain versions on the
CPU) against the reference's Pallas kernel run in interpret mode, as
tests/test_kernels.py and tests/test_kernels_grad.py run it, on their cases: y,
the final state, the entering states and all five gradients; the wrapper's
rules and the ragged-length path; what the card's tolerance catches; and — on a
CUDA card only — the forward (B5) and backward (B6) kernels against their plain
versions: both paths' shapes, a ragged length, chunks 1, 16 and 24, G = 2, a
non-zero final-state cotangent, and through the autograd Function. The module
imports JAX only inside the tests that hold the port to the reference, so the
card's tests also run on the GPU machine, which has none:
``PYTHONPATH=src python -m pytest tests/test_torch_ssd.py -m cuda``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels import ssd_scan as ts
from repro_torch.models.layers import pad_seq
from repro_torch.models.ssm import ssd_scan

torch.set_num_threads(1)

# tests/test_kernels.py::SSD_CASES and tests/test_kernels_grad.py::SSD_GRAD_CASES:
# (b, l, h, p, g, n, chunk)
SSD_CASES = [
    (2, 64, 4, 8, 2, 16, 16),
    (1, 128, 2, 16, 1, 32, 32),
    (1, 96, 4, 8, 4, 8, 24),       # chunk not a power of two
    (2, 32, 8, 4, 2, 8, 32),       # single chunk
]
SSD_GRAD_CASES = [
    (1, 32, 2, 4, 1, 4, 8),
    (2, 48, 4, 8, 2, 8, 16),       # g < h
    (1, 24, 4, 4, 2, 4, 24),       # single chunk, g < h
]
# The reference's limits: y and states within 2e-4 (rtol and atol,
# tests/test_kernels.py), gradients within 1e-4 (tests/test_kernels_grad.py).
Y_TOL, GRAD_TOL = 2e-4, 1e-4


def _inputs(case, seed, layout="head"):
    """numpy fp32 inputs from a seed, as the reference's tests draw them; head-
    major (x (b,h,l,p), dt (b,h,l), B/C (b,g,l,n)) or model layout."""
    b, l, h, p, g, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, (h,))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    if layout == "head":
        x, dt, B, C = x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), \
            B.transpose(0, 2, 1, 3), C.transpose(0, 2, 1, 3)
    return [np.ascontiguousarray(a) for a in (x, dt, A, B, C)]


def _torch(arrays, device="cpu", requires_grad=False):
    return [torch.from_numpy(a).to(device).requires_grad_(requires_grad) for a in arrays]


def _close(ours, ref, tol):
    np.testing.assert_allclose(ours.detach().float().cpu().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# -- against the reference (CPU) -------------------------------------------

@pytest.mark.parametrize("case", SSD_CASES)
def test_forward_matches_reference_kernel(case):
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import _ssd_forward, ssd_chunk_scan as jscan
    chunk = case[-1]
    arrays = _inputs(case, seed=sum(case))
    y_ref, s_ref = jscan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    y, s = ts.ssd_chunk_scan(*_torch(arrays), chunk=chunk)
    _close(y, y_ref, Y_TOL)
    _close(s, s_ref, Y_TOL)
    _, enters_ref, _ = _ssd_forward(*map(jnp.asarray, arrays), chunk, True, save_enters=True)
    _, enters, _ = ts.ssd_chunk_scan_fwd(*_torch(arrays), chunk=chunk, save_enters=True)
    _close(enters, enters_ref, Y_TOL)


@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_grads_match_reference_kernel(case):
    """All five gradients of sum(y cy) + sum(state cst) (a non-zero final-state
    cotangent), through the autograd Function, against jax.grad through the
    reference's custom VJP."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_chunk_scan as jscan
    b, l, h, p, g, n, chunk = case
    arrays = _inputs(case, seed=3 * sum(case))
    rng = np.random.default_rng(7)
    cy = rng.standard_normal((b, h, l, p)).astype(np.float32)
    cst = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def loss(*a):
        y, st = jscan(*a, chunk=chunk, interpret=True)
        return jnp.sum(y * cy) + jnp.sum(st * cst)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    ins = _torch(arrays, requires_grad=True)
    before = ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches
    y, st = ts.ssd_chunk_scan(*ins, chunk=chunk)
    ours = torch.autograd.grad((y * torch.from_numpy(cy)).sum()
                               + (st * torch.from_numpy(cst)).sum(), ins)
    assert (ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches) == before
    for name, o, r in zip(("dx", "ddt", "dA", "dB", "dC"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_plain_forward_pads_a_ragged_length():
    """The plain version of a length that is no multiple of the chunk equals the
    scan of the input padded with dt = 0 steps, cut back; the entering states
    count the ragged chunk."""
    case = (2, 40, 2, 4, 1, 4, 16)
    x, dt, A, B, C = _torch(_inputs(case, seed=4))
    y, enters, final = ts.ssd_chunk_scan_fwd_plain(x, dt, A, B, C, chunk=16)
    assert y.shape == x.shape and enters.shape == (2, 2, 3, 4, 4)
    pad = lambda t: pad_seq(t.transpose(1, 2), 1, 48)  # noqa: E731 (model layout)
    y_ref, s_ref = ssd_scan(pad(x), pad(dt), A, pad(B), pad(C), chunk=16)
    torch.testing.assert_close(y, y_ref[:, :40].transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(final, s_ref, rtol=0, atol=0)


@pytest.mark.parametrize("l,chunk", [(40, 16), (24, 16), (10, 128)])
def test_dispatch_pads_unaligned_lengths(l, chunk):
    """Padded to the chunk (never collapsed) and cut back, as the reference's
    dispatcher does; chunk = min(chunk, L). Against the reference's XLA path."""
    import jax.numpy as jnp
    from repro.kernels.dispatch import dispatch_ssd_scan as jdispatch
    arrays = _inputs((1, l, 2, 4, 1, 4, chunk), seed=l, layout="model")
    y_ref, s_ref = jdispatch(*map(jnp.asarray, arrays), chunk=chunk, impl="xla")
    y, s = dispatch.dispatch_ssd_scan(*_torch(arrays), chunk=chunk, impl="auto")
    assert y.shape == arrays[0].shape
    _close(y, y_ref, Y_TOL)
    _close(s, s_ref, Y_TOL)


def test_plain_dispatch_honours_an_initial_state():
    import jax.numpy as jnp
    from repro.kernels.dispatch import dispatch_ssd_scan as jdispatch
    arrays = _inputs((2, 32, 4, 4, 2, 4, 8), seed=11, layout="model")
    s0 = np.random.default_rng(12).standard_normal((2, 4, 4, 4)).astype(np.float32)
    y_ref, s_ref = jdispatch(*map(jnp.asarray, arrays), chunk=8, impl="xla",
                             initial_state=jnp.asarray(s0))
    for impl in ("auto", "plain"):
        y, s = dispatch.dispatch_ssd_scan(*_torch(arrays), chunk=8, impl=impl,
                                          initial_state=torch.from_numpy(s0))
        _close(y, y_ref, Y_TOL)
        _close(s, s_ref, Y_TOL)


# -- the wrapper's rules (CPU) ------------------------------------------------

@pytest.mark.parametrize("impl,device,initial,expected", [
    ("plain", "cuda", False, "plain"),
    ("plain", "cuda", True, "plain"),
    ("plain", "cpu", False, "plain"),
    ("auto", "cuda", False, "cuda"),
    ("auto", "cpu", True, "plain"),
    ("cuda", "cuda", False, "cuda"),
    ("auto", "cuda", True, NotImplementedError),   # no silent twin on a CUDA tensor
    ("cuda", "cuda", True, NotImplementedError),
    ("cuda", "cpu", False, ValueError),            # "cuda" forces the kernel
    ("xla", "cpu", False, ValueError),
])
def test_select_ssd_impl_rules(impl, device, initial, expected):
    if isinstance(expected, type):
        with pytest.raises(expected, match="ssm_impl"):
            dispatch.select_ssd_impl(impl, device=device, has_initial_state=initial)
    else:
        assert dispatch.select_ssd_impl(impl, device=device,
                                        has_initial_state=initial) == expected


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    case = (1, 24, 2, 4, 1, 4, 8)
    x, dt, A, B, C = _torch(_inputs(case, seed=1))
    before = ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches
    y, enters, final = ts.ssd_chunk_scan_fwd(x, dt, A, B, C, chunk=8)
    assert enters is None                        # only under save_enters
    py, penters, pfinal = ts.ssd_chunk_scan_fwd_plain(x, dt, A, B, C, chunk=8)
    assert torch.equal(y, py) and torch.equal(final, pfinal)
    dy, df = torch.ones_like(y), torch.ones_like(final)
    grads = ts.ssd_chunk_scan_bwd(x, dt, A, B, C, penters, dy, df, chunk=8)
    ref = ts.ssd_chunk_scan_bwd_plain(x, dt, A, B, C, dy, df, chunk=8)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert (ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches) == before


def test_wrapper_checks_shapes():
    x, dt, A, B, C = _torch(_inputs((1, 16, 4, 4, 2, 4, 8), seed=2))
    with pytest.raises(ValueError, match="shape mismatch"):
        ts.ssd_chunk_scan_fwd(x, dt[:, :3], A, B, C, chunk=8)
    with pytest.raises(ValueError, match="shape mismatch"):
        ts.ssd_chunk_scan_fwd(x, dt, A, B[:, :, :8], C, chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        ts.ssd_chunk_scan_fwd(x, dt, A, B, C, chunk=0)
    with pytest.raises(ValueError, match="SSD scan wants"):
        ts.ssd_chunk_scan_fwd(x[0], dt, A, B, C, chunk=8)


# -- what the card's tolerance catches ------------------------------------------

def _card_error(ours, ref):
    """The card's measure: max |ours - ref| / max(1, max |ref|) (the reference's
    rtol = atol limit read against the tensor's largest value)."""
    ref = ref.float()
    return ((ours.float() - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()


def _bf16_ulps(ours, ref):
    """For a bf16 result (the gradients of bf16 x, B and C): the error in bf16
    ulps of |ref|, |ref| floored at 2^-10 of the largest. Both sides round an
    fp32 value that agrees to ~1e-6, so they differ by at most one ulp where the
    two straddle a rounding boundary; the limit is 2, as for B2-B4."""
    ref = ref.float()
    err = (ours.float() - ref).abs()
    e = torch.frexp(torch.maximum(ref.abs(), ref.abs().max() * 2 ** -10)).exponent
    return (err / torch.ldexp(torch.ones_like(err), e - 8)).max().item()


def _grad_ok(ours, ref):
    if ours.dtype == torch.bfloat16:
        return _bf16_ulps(ours, ref) <= 2.0
    return _card_error(ours, ref) <= GRAD_TOL


def test_tolerance_catches_a_dropped_state_and_a_wrong_decay():
    """A kernel that dropped one chunk's carried state misses the forward limit
    by three orders of magnitude (0.77 of the largest |y|); one whose decay
    rates were 0.1% off misses it by 3x (6.3e-4 on y, 6.1e-4 on the state)."""
    case = (1, 256, 2, 64, 1, 128, 64)
    x, dt, A, B, C = _torch(_inputs(case, seed=9))
    y, _, final = ts.ssd_chunk_scan_fwd_plain(x, dt, A, B, C, chunk=64)
    assert _card_error(y, y) == 0.0
    # the third chunk started from a zero state
    y2, _, _ = ts.ssd_chunk_scan_fwd_plain(x[:, :, 128:192], dt[:, :, 128:192], A,
                                           B[:, :, 128:192], C[:, :, 128:192], chunk=64)
    assert _card_error(y2, y[:, :, 128:192]) > 1000 * Y_TOL
    y3, _, f3 = ts.ssd_chunk_scan_fwd_plain(x, dt, A * 1.001, B, C, chunk=64)
    assert _card_error(y3, y) > 2 * Y_TOL and _card_error(f3, final) > 2 * Y_TOL


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


# (b, l, h, p, g, n, chunk): both paths' head shapes at a few heads, a ragged length
# (the serving prompt's 62 x 128 + 64 pattern), chunks 1, 16 and 24, G = 2
CARD_CASES = [
    (2, 320, 4, 64, 1, 128, 128),     # mamba2: P 64, N 128, ragged last chunk
    (2, 256, 4, 64, 1, 64, 128),      # zamba2: P 64, N 64
    (1, 16, 4, 64, 1, 128, 16),       # a 16-token prompt: the chunk is its length
    (1, 96, 4, 8, 4, 8, 24),          # chunk 24
    (2, 100, 4, 32, 2, 16, 16),       # G = 2, ragged
    (1, 7, 2, 4, 1, 4, 1),            # chunk 1
]


def _card_inputs(case, dtype, seed):
    """Model-layout inputs on the card (head-major views, as the dispatcher
    hands them to the kernels), x/B/C in ``dtype``, dt and A fp32."""
    x, dt, A, B, C = _inputs(case, seed, layout="model")
    t = lambda a, d=torch.float32: torch.from_numpy(a).cuda().to(d)  # noqa: E731
    return (t(x, dtype).transpose(1, 2), t(dt).transpose(1, 2), t(A),
            t(B, dtype).transpose(1, 2), t(C, dtype).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_forward_kernel_matches_plain_version_on_card(case, dtype):
    _card()
    ins = _card_inputs(case, getattr(torch, dtype), seed=sum(case))
    before = ts.ssd_chunk_scan_fwd.launches
    y, enters, final = ts.ssd_chunk_scan_fwd(*ins, chunk=case[-1], save_enters=True)
    torch.cuda.synchronize()
    assert ts.ssd_chunk_scan_fwd.launches == before + 1
    py, penters, pfinal = ts.ssd_chunk_scan_fwd_plain(*ins, chunk=case[-1])
    for ours, ref in ((y, py), (enters, penters), (final, pfinal)):
        assert torch.isfinite(ours).all()
        assert _card_error(ours, ref) <= Y_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_backward_kernel_matches_plain_version_on_card(case, dtype):
    """B6 against autograd through the plain forward, with non-zero cotangents
    of both y and the final state."""
    _card()
    ins = _card_inputs(case, getattr(torch, dtype), seed=2 * sum(case))
    b, l, h, p, g, n, chunk = case
    gen = torch.Generator(device="cuda").manual_seed(5)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").transpose(1, 2)
    dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
    _, enters, _ = ts.ssd_chunk_scan_fwd(*ins, chunk=chunk, save_enters=True)
    before = ts.ssd_chunk_scan_bwd.launches
    grads = ts.ssd_chunk_scan_bwd(*ins, enters, dy, dfinal, chunk=chunk)
    torch.cuda.synchronize()
    assert ts.ssd_chunk_scan_bwd.launches == before + 1
    ref = ts.ssd_chunk_scan_bwd_plain(*ins, dy, dfinal, chunk=chunk)
    for name, ours, r in zip(("dx", "ddt", "dA", "dB", "dC"), grads, ref):
        assert ours.dtype == r.dtype and ours.shape == r.shape, name
        assert torch.isfinite(ours).all(), name
        assert _grad_ok(ours, r), (name, _card_error(ours, r))


@pytest.mark.cuda
def test_autograd_function_on_card():
    """Grads through the dispatcher on the card (B5 with entering states, then
    B6) against autograd through the plain dispatch, G = 2, a ragged length and
    a loss on the final state too; a forward without grad skips the states."""
    _card()
    case = (2, 200, 4, 64, 2, 128, 128)
    arrays = _inputs(case, seed=21, layout="model")
    ours_in = _torch(arrays, "cuda", requires_grad=True)
    ref_in = _torch(arrays, "cuda", requires_grad=True)
    w = torch.randn(case[0], case[1], case[2], case[3], device="cuda")
    before = ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches
    y, st = dispatch.dispatch_ssd_scan(*ours_in, chunk=128, impl="cuda")
    grads = torch.autograd.grad((y * w).sum() + st.square().sum(), ours_in)
    assert (ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ry, rst = dispatch.dispatch_ssd_scan(*ref_in, chunk=128, impl="plain")
    ref = torch.autograd.grad((ry * w).sum() + rst.square().sum(), ref_in)
    for name, o, r in zip(("dx", "ddt", "dA", "dB", "dC"), grads, ref):
        assert _grad_ok(o, r), (name, _card_error(o, r))
    with torch.no_grad():
        y2, _ = dispatch.dispatch_ssd_scan(*ours_in, chunk=128, impl="auto")
    assert _card_error(y2, y) == 0.0


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _card()
    ins = _card_inputs((1, 16, 2, 128, 1, 16, 16), torch.float32, seed=0)
    with pytest.raises(ValueError, match="P up to"):
        ts.ssd_chunk_scan_fwd(*ins, chunk=16)
    ins = _card_inputs((1, 300, 2, 8, 1, 8, 16), torch.float32, seed=0)
    with pytest.raises(ValueError, match="chunks up to"):
        ts.ssd_chunk_scan_fwd(*ins, chunk=256)
    half = [t.half() if t.dim() == 4 else t for t in ins]
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        ts.ssd_chunk_scan_fwd(*half, chunk=16)
    with pytest.raises(NotImplementedError, match="A13.3"):
        dispatch.dispatch_ssd_scan(*(t.transpose(1, 2) if t.dim() > 1 else t for t in ins),
                                   chunk=16, impl="auto",
                                   initial_state=torch.zeros(1, 2, 8, 8, device="cuda"))
