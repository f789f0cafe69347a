"""The SSD chunk scan: the port's ``ssd_chunk_scan`` (its plain versions on the
CPU) against the reference's Pallas kernel run in interpret mode, as
tests/test_kernels.py and tests/test_kernels_grad.py run it, on their cases: y,
the final state, the entering states and all five gradients; the plain versions
of the Hopper bodies' passes, composed, against the same; the wrapper's rules,
the body rule and the ragged-length path; what the card's tolerance catches;
and — on a CUDA card only — the forward (B5) and backward (B6) kernels against
their plain versions on chip_smoke.py's SSD_CASES (both bodies: the paths'
shapes, a ragged length, chunks 1, 16 and 24, G = 2 and 4, the Hopper body's
edges), a strong-decay draw, each Hopper pass alone, two launches
bit-identical, and through the autograd Function. The module imports JAX only
inside the tests that hold the port to the reference, so the card's tests also
run on the GPU machine, which has none:
``PYTHONPATH=src python -m pytest tests/test_torch_ssd.py -m cuda``."""

import importlib.util
from pathlib import Path

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


def _composed_forward(x, dt, A, B, C, chunk):
    """The Hopper forward body's passes, composed from their plain versions."""
    inc, decay = ts.ssd_fwd_increments_plain(x, dt, A, B, chunk=chunk)
    enters, final = ts.ssd_state_pass_plain(inc, decay)
    return ts.ssd_fwd_output_plain(x, dt, A, B, C, enters, chunk=chunk), enters, final


def _composed_backward(x, dt, A, B, C, dy, dfinal, chunk, seed=None):
    """The Hopper backward body's passes, composed from their plain versions,
    then the reductions outside the kernel: (dx, ddt, dA, dB, dC). ``seed``
    replaces dfinal as the reverse state pass's seed."""
    _, enters, _ = _composed_forward(x, dt, A, B, C, chunk)
    inc, decay = ts.ssd_bwd_increments_plain(dy, dt, A, C, chunk=chunk)
    dstate = ts.ssd_dstate_pass_plain(inc, decay, dfinal if seed is None else seed)
    per_head = ts.ssd_bwd_grads_plain(x, dt, A, B, C, enters, dstate, dy, chunk=chunk)
    return ts._reduce_grads(*per_head, x, dt, A, B, C)


@pytest.mark.parametrize("case", SSD_CASES)
def test_passes_compose_to_reference_forward(case):
    """Increments, state pass and output, composed: y, the entering states and
    the final state of the reference's forward kernel."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import _ssd_forward
    chunk = case[-1]
    arrays = _inputs(case, seed=sum(case) + 1)
    y_ref, enters_ref, s_ref = _ssd_forward(*map(jnp.asarray, arrays), chunk, True,
                                            save_enters=True)
    y, enters, final = _composed_forward(*_torch(arrays), chunk)
    _close(y, y_ref, Y_TOL)
    _close(enters, enters_ref, Y_TOL)
    _close(final, s_ref, Y_TOL)


def _reference_grads(case, seed):
    """(inputs, cotangents of y and the final state, the reference's five
    gradients through jax.vjp of its custom-VJP kernel, interpret mode)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_chunk_scan as jscan
    b, l, h, p, g, n, chunk = case
    arrays = _inputs(case, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cy = rng.standard_normal((b, h, l, p)).astype(np.float32)
    cst = rng.standard_normal((b, h, p, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jscan(*a, chunk=chunk, interpret=True),
                     *map(jnp.asarray, arrays))
    return arrays, cy, cst, vjp((jnp.asarray(cy), jnp.asarray(cst)))


@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_passes_compose_to_reference_grads(case):
    """Increments, reverse state pass and gradient pass (from the explicit
    formulas), then the reductions outside the kernel: all five gradients of
    jax.vjp through the reference's kernel, with a non-zero final-state
    cotangent."""
    arrays, cy, cst, ref = _reference_grads(case, seed=5 * sum(case))
    ours = _composed_backward(*_torch(arrays), torch.from_numpy(cy), torch.from_numpy(cst),
                              case[-1])
    for name, o, r in zip(("dx", "ddt", "dA", "dB", "dC"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_dropped_last_or_zero_seed_misses(monkeypatch):
    """The limit catches a gradient pass that drops the dda fold's `last` term
    (the two cs[-1] terms) or a reverse state pass seeded with zero in place of
    the final state's cotangent."""
    case = SSD_GRAD_CASES[1]
    arrays, cy, cst, ref = _reference_grads(case, seed=17)
    ins = _torch(arrays)
    dy, dfinal = torch.from_numpy(cy), torch.from_numpy(cst)

    def worst(grads):
        return max(float(np.max(np.abs(o.numpy() - np.asarray(r)) /
                                (GRAD_TOL * (1 + np.abs(np.asarray(r))))))
                   for o, r in zip(grads, ref))
    assert worst(_composed_backward(*ins, dy, dfinal, case[-1])) <= 1.0
    assert worst(_composed_backward(*ins, dy, dfinal, case[-1],
                                    seed=torch.zeros_like(dfinal))) > 100
    fold = ts._dda_fold
    monkeypatch.setattr(ts, "_dda_fold", lambda dcs, last: fold(dcs, torch.zeros_like(last)))
    assert worst(_composed_backward(*ins, dy, dfinal, case[-1])) > 100


@pytest.mark.parametrize("l,chunk", [(40, 16), (100, 32), (7, 8)])
def test_plain_passes_match_the_plain_wrappers_on_ragged_lengths(l, chunk):
    """The passes pad a ragged last chunk as the plain wrappers do: the
    composition equals ssd_chunk_scan_fwd_plain and autograd through it."""
    case = (2, l, 4, 8, 2, 4, chunk)
    x, dt, A, B, C = _torch(_inputs(case, seed=l))
    rng = np.random.default_rng(l)
    dy = torch.from_numpy(rng.standard_normal((2, 4, l, 8)).astype(np.float32))
    dfinal = torch.from_numpy(rng.standard_normal((2, 4, 8, 4)).astype(np.float32))
    y, enters, final = _composed_forward(x, dt, A, B, C, chunk)
    py, penters, pfinal = ts.ssd_chunk_scan_fwd_plain(x, dt, A, B, C, chunk=chunk)
    for ours, ref in ((y, py), (enters, penters), (final, pfinal)):
        torch.testing.assert_close(ours, ref, rtol=Y_TOL, atol=Y_TOL)
    grads = _composed_backward(x, dt, A, B, C, dy, dfinal, chunk)
    ref = ts.ssd_chunk_scan_bwd_plain(x, dt, A, B, C, dy, dfinal, chunk=chunk)
    for ours, r in zip(grads, ref):
        torch.testing.assert_close(ours, r, rtol=GRAD_TOL, atol=GRAD_TOL)


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


def _body_inputs(dtype=torch.bfloat16, p=64, n=128, g=1, l=300, layout="model"):
    """CPU tensors shaped as the kernels take them (head-major; model layout:
    transposed views of (b, l, h, p) and (b, l, g, n), as the dispatcher hands
    them over)."""
    b, h = 2, 4
    if layout == "model":
        x = torch.zeros(b, l, h, p, dtype=dtype).transpose(1, 2)
        bm = torch.zeros(b, l, g, n, dtype=dtype).transpose(1, 2)
    else:
        x = torch.zeros(b, h, l, p, dtype=dtype)
        bm = torch.zeros(b, g, l, n, dtype=dtype)
    return x, bm, bm.clone()


@pytest.mark.parametrize("kw,chunk,body", [
    ({}, 128, "sm90"),                                  # mamba2's shape, model layout
    ({"n": 64}, 128, "sm90"),                           # zamba2's
    ({"g": 2}, 128, "sm90"),                            # G = 2
    ({"l": 100}, 128, "sm90"),                          # one ragged chunk
    ({"layout": "head"}, 128, "sm90"),                  # contiguous head-major
    ({"dtype": torch.float32}, 128, "simt"),            # fp32: the first version
    ({}, 16, "simt"),                                   # chunk 16 (the 16-token prompt)
    ({}, 64, "simt"),
    ({"p": 32}, 128, "simt"),                           # P other than 64
    ({"n": 16}, 128, "simt"),                           # N other than 64 / 128
    ({"g": 4, "n": 64}, 128, "sm90"),                   # G = 4 at N 64
])
def test_body_rule(kw, chunk, body):
    """Which dtype and shape go to which body: bf16 x, B and C at chunk 128,
    P 64 and N 64 or 128 (every SSM path's) to the Hopper body, the rest to the
    first version."""
    assert ts.ssd_body(*_body_inputs(**kw), chunk) == body


def test_body_rule_needs_aligned_rows_and_one_dtype():
    """The Hopper body loads 16-byte pieces of each row: a row stride off the
    16-byte rule (64 of 68 channels: rows 136 bytes apart) takes the first
    version, and so do B and C in another dtype than x."""
    x, bm, cm = _body_inputs()
    assert ts.ssd_body(x, bm, cm, 128) == "sm90"
    wide = torch.zeros(2, 4, 300, 68, dtype=torch.bfloat16)[..., :64]
    assert wide.stride(-1) == 1 and ts.ssd_body(wide, bm, cm, 128) == "simt"
    assert ts.ssd_body(x, bm, cm.float(), 128) == "simt"


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


def _smoke():
    """chip_smoke.py, whose SSD_CASES is the one list of B5's and B6's card cases."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# (b, l, h, p, g, n, chunk): chip_smoke.py's SSD_CASES — the four path shapes;
# the first version's chunks 16, 24 and 1, G = 2 and 4; the Hopper body's edges (a
# ragged 64-row last chunk, N 64, a single chunk, L = 8000 at a few heads, G 2 and
# 4 at N 128) — and its strong-decay draw (dt scaled so exp(cs) underflows)
_SMOKE = _smoke()
CARD_CASES = _SMOKE.SSD_CASES
DECAY_CASE, DECAY_SCALE = _SMOKE.SSD_DECAY_CASE, _SMOKE.SSD_DECAY_SCALE
SM90_CARD_CASES = [c for c in CARD_CASES if c[-1] == 128]


def _card_inputs(case, dtype, seed, dt_scale=1.0):
    """Model-layout inputs on the card (head-major views, as the dispatcher
    hands them to the kernels), x/B/C in ``dtype``, dt (times ``dt_scale``) and
    A fp32."""
    x, dt, A, B, C = _inputs(case, seed, layout="model")
    t = lambda a, d=torch.float32: torch.from_numpy(a).cuda().to(d)  # noqa: E731
    return (t(x, dtype).transpose(1, 2), (t(dt) * dt_scale).transpose(1, 2), t(A),
            t(B, dtype).transpose(1, 2), t(C, dtype).transpose(1, 2))


def _card_body(ins, dtype, chunk):
    body = ts.ssd_body(ins[0], ins[3], ins[4], chunk)
    assert body == ("sm90" if dtype == torch.bfloat16 and chunk == 128 else "simt")
    return body


def _counts(fn):
    return fn.launches, fn.sm90_launches, fn.simt_launches


def _after(before, body):
    return (before[0] + 1, before[1] + (body == "sm90"), before[2] + (body == "simt"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_forward_kernel_matches_plain_version_on_card(case, dtype):
    _card()
    ins = _card_inputs(case, getattr(torch, dtype), seed=sum(case))
    body = _card_body(ins, getattr(torch, dtype), case[-1])
    before = _counts(ts.ssd_chunk_scan_fwd)
    y, enters, final = ts.ssd_chunk_scan_fwd(*ins, chunk=case[-1], save_enters=True)
    torch.cuda.synchronize()
    assert _counts(ts.ssd_chunk_scan_fwd) == _after(before, body)
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
    body = _card_body(ins, getattr(torch, dtype), case[-1])
    b, l, h, p, g, n, chunk = case
    gen = torch.Generator(device="cuda").manual_seed(5)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").transpose(1, 2)
    dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
    _, enters, _ = ts.ssd_chunk_scan_fwd(*ins, chunk=chunk, save_enters=True)
    before = _counts(ts.ssd_chunk_scan_bwd)
    grads = ts.ssd_chunk_scan_bwd(*ins, enters, dy, dfinal, chunk=chunk)
    torch.cuda.synchronize()
    assert _counts(ts.ssd_chunk_scan_bwd) == _after(before, body)
    ref = ts.ssd_chunk_scan_bwd_plain(*ins, dy, dfinal, chunk=chunk)
    for name, ours, r in zip(("dx", "ddt", "dA", "dB", "dC"), grads, ref):
        assert ours.dtype == r.dtype and ours.shape == r.shape, name
        assert torch.isfinite(ours).all(), name
        assert _grad_ok(ours, r), (name, _card_error(ours, r))


@pytest.mark.cuda
def test_strong_decay_on_card():
    """The Hopper body where dt |A| makes exp(cs) underflow across a chunk: B5
    and B6 against their plain versions, to the same limits."""
    _card()
    ins = _card_inputs(DECAY_CASE, torch.bfloat16, seed=3, dt_scale=DECAY_SCALE)
    b, l, h, p, g, n, chunk = DECAY_CASE
    assert _card_body(ins, torch.bfloat16, chunk) == "sm90"
    out = ts.ssd_chunk_scan_fwd(*ins, chunk=chunk, save_enters=True)
    ref = ts.ssd_chunk_scan_fwd_plain(*ins, chunk=chunk)
    for ours, r in zip(out, ref):
        assert torch.isfinite(ours).all() and _card_error(ours, r) <= Y_TOL
    gen = torch.Generator(device="cuda").manual_seed(6)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").transpose(1, 2)
    dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
    grads = ts.ssd_chunk_scan_bwd(*ins, out[1], dy, dfinal, chunk=chunk)
    ref = ts.ssd_chunk_scan_bwd_plain(*ins, dy, dfinal, chunk=chunk)
    for name, ours, r in zip(("dx", "ddt", "dA", "dB", "dC"), grads, ref):
        assert torch.isfinite(ours).all() and _grad_ok(ours, r), (name, _card_error(ours, r))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SM90_CARD_CASES)
def test_hopper_passes_match_their_plain_versions_on_card(case):
    """Each pass of the Hopper bodies launched alone on its plain version's
    inputs: the forward and reverse states passes (against the plain increments
    then the plain state pass), the output and the gradient pass, each within
    the kernel's limit of its plain version."""
    _card()
    x, dt, A, B, C = _card_inputs(case, torch.bfloat16, seed=7 * sum(case))
    b, l, h, p, g, n, chunk = case
    y, states, final = ts._fwd_buffers(x, B, chunk, states=True)
    enters, fin = ts.ssd_state_pass_plain(*ts.ssd_fwd_increments_plain(x, dt, A, B, chunk=chunk))
    ts._fwd_sm90(x, dt, A, B, C, y, states, final, passes=1)
    assert _card_error(states, enters) <= Y_TOL and _card_error(final, fin) <= Y_TOL
    states.copy_(enters)
    ts._fwd_sm90(x, dt, A, B, C, y, states, final, passes=2)
    assert _card_error(y, ts.ssd_fwd_output_plain(x, dt, A, B, C, enters, chunk=chunk)) <= Y_TOL
    gen = torch.Generator(device="cuda").manual_seed(8)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").transpose(1, 2)
    dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
    outs, scratch = ts._bwd_outputs(x, B), ts._bwd_scratch(x, B)
    dstate = ts.ssd_dstate_pass_plain(*ts.ssd_bwd_increments_plain(dy, dt, A, C, chunk=chunk),
                                      dfinal)
    ts._bwd_sm90(x, dt, A, B, C, enters, dy, dfinal, outs, scratch, passes=1)
    assert _card_error(scratch[0], dstate) <= GRAD_TOL
    scratch[0].copy_(dstate)
    ts._bwd_sm90(x, dt, A, B, C, enters, dy, dfinal, outs, scratch, passes=6)
    ref = ts.ssd_bwd_grads_plain(x, dt, A, B, C, enters, dstate, dy, chunk=chunk)
    for name, ours, r in zip(("dx", "ddt", "dda", "db", "dc"), outs, ref):
        assert _card_error(ours, r) <= GRAD_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SMOKE.SSD_PATH_CASES.values()))
def test_two_launches_are_bit_identical_on_card(case):
    """No atomics: two launches of each body at the paths' shapes give the same
    bits."""
    _card()
    ins = _card_inputs(case, torch.bfloat16, seed=9)
    b, l, h, p, g, n, chunk = case
    gen = torch.Generator(device="cuda").manual_seed(10)
    dy = torch.randn(b, l, h, p, generator=gen, device="cuda").transpose(1, 2)
    dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
    runs = []
    for _ in range(2):
        out = ts.ssd_chunk_scan_fwd(*ins, chunk=chunk, save_enters=True)
        runs.append((*out, *ts.ssd_chunk_scan_bwd(*ins, out[1], dy, dfinal, chunk=chunk)))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


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
