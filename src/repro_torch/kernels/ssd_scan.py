"""Mamba2 SSD chunk scan: the hand-written Hopper kernels and their plain twins.

Counterpart of ``repro/kernels/ssd_scan.py``: the forward (``_fwd_kernel``
through ``_ssd_forward``), the backward (``_bwd_kernel`` through
``_ssd_backward``) and the custom VJP that ties them (``_ssd``). The kernels are
``csrc/ssd_fwd.cu`` and ``csrc/ssd_bwd.cu``, CUDA C++ for ``sm_90a``, bound with
ctypes; their source notes say how they map the TPU kernels onto Hopper and what
bounds them.

Layouts are head-major as in the reference: x (B, H, L, P), dt (B, H, L), A (H,),
B/C (B, G, L, N) per group (head h reads group h // (H // G)). The kernels read x,
dt, B and C through their batch/head/sequence strides (the last dim contiguous),
so a transposed view of a model-layout tensor is taken without a copy; y and dx
come back in x's memory layout. A length that is not a multiple of the chunk is
read with a masked load of the ragged last chunk (dt = 0 and x = B = C = 0 past
L, the reference's padding); the plain twins pad explicitly.

Each kernel has two bodies, chosen by a static rule (:func:`ssd_body`): bf16 x,
B and C at the paths' shapes (chunk 128, P 64, N 64 or 128, rows 16-byte
aligned) run the Hopper body ("sm90": a states pass per (batch, head), then
passes parallel over chunks, every product on the tensor cores), everything
else the first version ("simt": one block per (batch, head) walking its chunks,
fp32 FMAs). The Hopper body's passes each
have a plain version here: the chunk-local increments
(:func:`ssd_fwd_increments_plain`, :func:`ssd_bwd_increments_plain`) and the
forward and reverse state passes (:func:`ssd_state_pass_plain`,
:func:`ssd_dstate_pass_plain`), which the kernels' states pass fuses; and the
per-chunk output and gradient passes (:func:`ssd_fwd_output_plain`,
:func:`ssd_bwd_grads_plain`, the backward from its explicit formulas).

:func:`ssd_chunk_scan_fwd` and :func:`ssd_chunk_scan_bwd` are the wrappers: a CUDA
tensor launches the body the rule names (or the call raises), a CPU tensor takes
:func:`ssd_chunk_scan_fwd_plain` / :func:`ssd_chunk_scan_bwd_plain`. There is no
fall-back from one to the other. :func:`ssd_chunk_scan` is differentiable through
:class:`SSDChunkScan`; it asks the forward for the entering states only while
autograd records (the reference's ``save_enters``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.models.layers import pad_seq
from repro_torch.models.ssm import ssd_scan_states
from . import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128      # what the kernels take
SM90_CHUNK, SM90_P, SM90_N = 128, 64, (64, 128)   # what the Hopper bodies take


def _check(x, dt, A, Bm, Cm, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("the SSD scan wants x (B,H,L,P), dt (B,H,L), A (H,), "
                         "B/C (B,G,L,N)")
    b, h, l, _ = x.shape
    g = Bm.shape[1]
    if dt.shape != (b, h, l) or A.shape != (h,) or Bm.shape != Cm.shape \
            or Bm.shape[0] != b or Bm.shape[2] != l or h % g:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if int(chunk) < 1:
        raise ValueError(f"chunk {chunk} must be >= 1")
    devs = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devs) != 1:
        raise ValueError(f"devices differ: {sorted(map(str, devs))}")


def ssd_chunk_scan_fwd_plain(x, dt, A, Bm, Cm, *, chunk: int):
    """Plain PyTorch version of the forward kernel: the chunked algorithm in fp32
    (``models.ssm.ssd_scan_states``), the length padded to the chunk with dt = 0
    steps. Returns (y (B, H, L, P) fp32, entering states (B, H, nc, P, N) fp32,
    final state (B, H, P, N) fp32)."""
    l = x.shape[2]
    chunk = int(chunk)
    lp = -(-l // chunk) * chunk
    xm, dtm, Bmm, Cmm = (pad_seq(t.transpose(1, 2), 1, lp) for t in (x, dt, Bm, Cm))
    y, final, enters = ssd_scan_states(xm, dtm, A, Bmm, Cmm, chunk)
    return y[:, :l].transpose(1, 2), enters.transpose(1, 2), final


def _cuda_args(x, dt, A, Bm, Cm, chunk):
    """What the kernels take beyond :func:`_check`."""
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernels run on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"the kernels take x, B and C in one of float32 and bfloat16, "
                         f"not {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    p, n = x.shape[3], Bm.shape[3]
    if not (1 <= chunk <= MAX_CHUNK and p <= MAX_P and n <= MAX_N):
        raise ValueError(f"the SSD kernels take chunks up to {MAX_CHUNK}, P up to {MAX_P} "
                         f"and N up to {MAX_N}, not chunk {chunk}, P {p}, N {n}")


def _inner_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()   # an explicit copy, never the twin


def _rows_aligned(t) -> bool:
    """The last dim contiguous and every row 16-byte aligned (what the Hopper
    bodies' 16-byte loads need)."""
    esz = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and
            all(size == 1 or st * esz % 16 == 0
                for size, st in zip(t.shape[:-1], t.stride()[:-1])))


def ssd_body(x, Bm, Cm, chunk) -> str:
    """The body for these inputs on the card: "sm90" (the Hopper body) for bf16
    x, B and C at chunk 128, P 64 and N 64 or 128 (every SSM path's shape: both
    families' serving and training, any G dividing H, any length, a ragged last
    chunk masked) with rows 16-byte aligned; "simt" (the first version) for
    everything else: fp32 inputs, other chunks (1, 16, 24, ...), P or N."""
    if (x.dtype == torch.bfloat16 and Bm.dtype == torch.bfloat16 and Cm.dtype == torch.bfloat16
            and int(chunk) == SM90_CHUNK and x.shape[3] == SM90_P and Bm.shape[3] in SM90_N
            and all(_rows_aligned(t) for t in (x, Bm, Cm))):
        return "sm90"
    return "simt"


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _fwd_kernel():
    lib = build.load("ssd_fwd")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    simt, sm90 = lib.ssd_fwd, lib.ssd_fwd_sm90
    simt.argtypes = [ptr] * 8 + [i64] * 15 + [i32] * 8 + [ptr]
    sm90.argtypes = [ptr] * 8 + [i64] * 15 + [i32] * 6 + [ptr]
    simt.restype = sm90.restype = ctypes.c_int
    return simt, sm90


def _fwd_simt(x, dt, A, Bm, Cm, y, enters, final, chunk):
    """One launch of the first-version forward body on checked inputs (fp32 dt and
    A); ``enters`` may be None. Not counted."""
    b, h, l, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    err = _fwd_kernel()[0](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), None if enters is None else enters.data_ptr(), final.data_ptr(),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *y.stride()[:3], b, h, g, l, p, n, chunk, _DTYPE_CODE[x.dtype], _stream(x))
    if err:
        raise RuntimeError(f"ssd_fwd launch failed: {build.launch_error(err)}")


def _fwd_sm90(x, dt, A, Bm, Cm, y, states, final, passes=3):
    """The Hopper forward body's passes on checked inputs (fp32 dt and A): bit 1
    the states pass (the entering states into ``states``, and ``final``), bit 2
    the output ``y``. Not counted."""
    b, h, l, _ = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    err = _fwd_kernel()[1](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), states.data_ptr(), final.data_ptr(),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *y.stride()[:3], b, h, g, l, n, passes, _stream(x))
    if err:
        raise RuntimeError(f"ssd_fwd_sm90 launch failed: {build.launch_error(err)}")


def _fwd_buffers(x, Bm, chunk, states: bool):
    """(y, entering states or None, final) for a forward on x, fp32: y in x's
    memory layout."""
    b, h, l, p = x.shape
    n = Bm.shape[3]
    nc = -(-l // chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty_like(x, dtype=torch.float32),
            torch.empty((b, h, nc, p, n), **f32) if states else None,
            torch.empty((b, h, p, n), **f32))


def ssd_chunk_scan_fwd(x, dt, A, Bm, Cm, *, chunk: int = 128, save_enters: bool = False):
    """The forward. Returns (y (B, H, L, P) fp32, entering states (B, H, nc, P, N)
    fp32 or None, final state (B, H, P, N) fp32); the entering states only with
    ``save_enters`` (the backward's residual).

    CUDA tensors launch the body :func:`ssd_body` names; ``ssd_chunk_scan_fwd.launches``
    counts the launches and ``.sm90_launches`` / ``.simt_launches`` each body's.
    CPU tensors take :func:`ssd_chunk_scan_fwd_plain`.
    """
    _check(x, dt, A, Bm, Cm, chunk)
    chunk = int(chunk)
    if x.device.type == "cpu":
        y, enters, final = ssd_chunk_scan_fwd_plain(x, dt, A, Bm, Cm, chunk=chunk)
        return y, (enters if save_enters else None), final
    _cuda_args(x, dt, A, Bm, Cm, chunk)
    x, Bm, Cm = (_inner_contiguous(t) for t in (x, Bm, Cm))
    dt = dt.float()
    A = A.float().contiguous()
    sm90 = ssd_body(x, Bm, Cm, chunk) == "sm90"
    # the Hopper body writes the entering states either way: its output pass reads them
    y, states, final = _fwd_buffers(x, Bm, chunk, states=sm90 or save_enters)
    if sm90:
        _fwd_sm90(x, dt, A, Bm, Cm, y, states, final)
        ssd_chunk_scan_fwd.sm90_launches += 1
    else:
        _fwd_simt(x, dt, A, Bm, Cm, y, states, final, chunk)
        ssd_chunk_scan_fwd.simt_launches += 1
    ssd_chunk_scan_fwd.launches += 1
    return y, (states if save_enters else None), final


ssd_chunk_scan_fwd.launches = 0
ssd_chunk_scan_fwd.sm90_launches = 0       # the Hopper body
ssd_chunk_scan_fwd.simt_launches = 0       # the first version


def _reduce_grads(dx, ddt, dda, db, dc, x, dt, A, Bm, Cm):
    """The two reductions the reference leaves outside its kernel: per-head dB/dC
    summed onto the groups, and dA = sum(dda dt). Casts to the inputs' dtypes."""
    b, h, l, _ = dx.shape
    g, n = Bm.shape[1], Bm.shape[3]
    dB = db.reshape(b, g, h // g, l, n).sum(dim=2).to(Bm.dtype)
    dC = dc.reshape(b, g, h // g, l, n).sum(dim=2).to(Cm.dtype)
    dA = torch.einsum("bhl,bhl->h", dda, dt.float()).to(A.dtype)
    return dx.to(x.dtype), ddt.to(dt.dtype), dA, dB, dC


def ssd_chunk_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dfinal, *, chunk: int):
    """Plain PyTorch version of the backward: autograd through
    :func:`ssd_chunk_scan_fwd_plain`. Returns (dx, ddt, dA, dB, dC) in the
    inputs' dtypes."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, _, final = ssd_chunk_scan_fwd_plain(*ins, chunk=chunk)
        return torch.autograd.grad((y, final), ins, (dy.float(), dfinal.float()))


@functools.cache
def _bwd_kernel():
    lib = build.load("ssd_bwd")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    simt, sm90 = lib.ssd_bwd, lib.ssd_bwd_sm90
    simt.argtypes = [ptr] * 13 + [i64] * 18 + [i32] * 8 + [ptr]
    sm90.argtypes = [ptr] * 15 + [i64] * 18 + [i32] * 6 + [ptr]
    simt.restype = sm90.restype = ctypes.c_int
    return simt, sm90


def ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, enters, dy, dfinal, *, chunk: int = 128):
    """The backward from the forward's inputs, its entering states and the
    cotangents of y (B, H, L, P) and the final state (B, H, P, N). Returns (dx,
    ddt, dA, dB, dC) in the inputs' dtypes.

    CUDA tensors launch the body :func:`ssd_body` names, once
    (``ssd_chunk_scan_bwd.launches`` counts it, ``.sm90_launches`` /
    ``.simt_launches`` by body) and reduce dB/dC onto the groups and dA outside
    it, as the reference does. CPU tensors take :func:`ssd_chunk_scan_bwd_plain`
    (``enters`` unused).
    """
    _check(x, dt, A, Bm, Cm, chunk)
    chunk = int(chunk)
    b, h, l, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    nc = -(-l // chunk)
    if dy.shape != x.shape or dfinal.shape != (b, h, p, n):
        raise ValueError(f"dy {tuple(dy.shape)} must match x {tuple(x.shape)} and "
                         f"dfinal {tuple(dfinal.shape)} be {(b, h, p, n)}")
    if x.device.type == "cpu":
        return ssd_chunk_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk)
    _cuda_args(x, dt, A, Bm, Cm, chunk)
    if enters is None or enters.shape != (b, h, nc, p, n):
        raise ValueError(f"the backward kernel needs the entering states {(b, h, nc, p, n)}")
    xk, Bk, Ck = (_inner_contiguous(t) for t in (x, Bm, Cm))
    body = ssd_body(xk, Bk, Ck, chunk)
    per_head = _bwd_launch(body, xk, dt.float(), A.float().contiguous(), Bk, Ck,
                           enters.float().contiguous(), dy.float(),
                           dfinal.float().contiguous(), chunk)
    return _reduce_grads(*per_head, x, dt, A, Bm, Cm)


def _bwd_outputs(x, Bm):
    """The per-head fp32 (dx, ddt, dda, db, dc) of a backward on x."""
    b, h, l, _ = x.shape
    n = Bm.shape[3]
    ddt = torch.empty((b, h, l), dtype=torch.float32, device=x.device)
    db = torch.empty((b, h, l, n), dtype=torch.float32, device=x.device)
    return (torch.empty_like(x, dtype=torch.float32), ddt, torch.empty_like(ddt), db,
            torch.empty_like(db))


def _bwd_simt(x, dt, A, Bm, Cm, enters, dy, dfinal, outs, chunk):
    """One launch of the first-version backward body into ``outs`` (dx, ddt, dda,
    db, dc) on checked inputs (fp32 dt, A, enters, dy and dfinal; the last dims
    contiguous). Not counted."""
    b, h, l, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    dx, ddt, dda, db, dc = outs
    err = _bwd_kernel()[0](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        enters.data_ptr(), dy.data_ptr(), dfinal.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dda.data_ptr(), db.data_ptr(), dc.data_ptr(),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *dy.stride()[:3], *dx.stride()[:3], b, h, g, l, p, n, chunk,
        _DTYPE_CODE[x.dtype], _stream(x))
    if err:
        raise RuntimeError(f"ssd_bwd launch failed: {build.launch_error(err)}")


def _bwd_scratch(x, Bm):
    """(dstate (B, H, nc, P, N), rowv (B, H, L)) for the Hopper backward body,
    fp32."""
    b, h, l, p = x.shape
    n = Bm.shape[3]
    nc = -(-l // SM90_CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    return torch.empty((b, h, nc, p, n), **f32), torch.empty((b, h, l), **f32)


def _bwd_sm90(x, dt, A, Bm, Cm, enters, dy, dfinal, outs, scratch, passes=7):
    """The Hopper backward body's passes into ``outs`` (dx, ddt, dda, db, dc) on
    checked inputs (fp32 dt, A, enters, dfinal and dy, dy's rows 16-byte aligned):
    bit 1 the reverse states pass (dS_out of each chunk into ``scratch``'s
    dstate), bit 2 the rows (dC and rowv), bit 4 the columns (dx, dB, ddt, dda).
    Not counted."""
    b, h, l, _ = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    dx, ddt, dda, db, dc = outs
    dstate, rowv = scratch
    err = _bwd_kernel()[1](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        enters.data_ptr(), dy.data_ptr(), dfinal.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dda.data_ptr(), db.data_ptr(), dc.data_ptr(), dstate.data_ptr(),
        rowv.data_ptr(),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *dy.stride()[:3], *dx.stride()[:3], b, h, g, l, n, passes, _stream(x))
    if err:
        raise RuntimeError(f"ssd_bwd_sm90 launch failed: {build.launch_error(err)}")


def _bwd_launch(body, x, dt, A, Bm, Cm, enters, dy, dfinal, chunk):
    """Launch the backward body ``body`` on checked inputs (fp32 dt, A, enters, dy
    and dfinal; enters and dfinal contiguous) and count the launch. Returns the
    kernel's per-head fp32 (dx, ddt, dda, db, dc)."""
    outs = _bwd_outputs(x, Bm)
    if body == "sm90":
        dy = dy if _rows_aligned(dy) else dy.contiguous()
        _bwd_sm90(x, dt, A, Bm, Cm, enters, dy, dfinal, outs, _bwd_scratch(x, Bm))
        ssd_chunk_scan_bwd.sm90_launches += 1
    else:
        _bwd_simt(x, dt, A, Bm, Cm, enters, _inner_contiguous(dy), dfinal, outs, chunk)
        ssd_chunk_scan_bwd.simt_launches += 1
    ssd_chunk_scan_bwd.launches += 1
    return outs


ssd_chunk_scan_bwd.launches = 0
ssd_chunk_scan_bwd.sm90_launches = 0       # the Hopper body
ssd_chunk_scan_bwd.simt_launches = 0       # the first version


# ---------------------------------------------------------------------------
# Plain versions of the Hopper bodies' passes, fp32, on head-major inputs. The
# length is padded to whole chunks with dt = 0 steps (x = B = C = dy = 0), as the
# kernels' masked loads read it; per-position outputs are cut back to L.


def _chunked(t, chunk):
    """(B, X, L, ...) -> (B, X, nc, chunk, ...) fp32, zero-padded to whole chunks."""
    l = t.shape[2]
    nc = -(-l // chunk)
    t = torch.nn.functional.pad(t.float(), [0, 0] * (t.dim() - 3) + [0, nc * chunk - l])
    return t.reshape(*t.shape[:2], nc, chunk, *t.shape[3:])


def _heads(t, h):
    """Per-group (B, G, ...) -> per-head (B, H, ...): head h reads group h // (H // G)."""
    return t.repeat_interleave(h // t.shape[1], dim=1)


def _chunk_cs(dt, A, chunk):
    """(dt (B, H, nc, q), cs = cumsum(dt A) within each chunk (B, H, nc, q))."""
    dtc = _chunked(dt, chunk)
    return dtc, torch.cumsum(dtc * A.float()[None, :, None, None], dim=-1)


def _decay_matrix(cs):
    """L[i, j] = exp(cs_i - cs_j) for j <= i, else 0; the mask before the exp."""
    q = cs.shape[-1]
    tri = torch.ones(q, q, dtype=torch.bool, device=cs.device).tril()
    return torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :], float("-inf")))


def _unchunk(t, l):
    """(B, H, nc, q, ...) -> (B, H, L, ...)."""
    return t.reshape(t.shape[0], t.shape[1], -1, *t.shape[4:])[:, :, :l]


def ssd_fwd_increments_plain(x, dt, A, Bm, *, chunk: int):
    """The forward's chunk-local increments (the states pass's products): each
    chunk's own state increment
    ((x dt) o exp(cs[-1] - cs))^T B and its decay exp(cs[-1]). Returns
    (increments (B, H, nc, P, N), decay (B, H, nc))."""
    dtc, cs = _chunk_cs(dt, A, chunk)
    w = dtc * torch.exp(cs[..., -1:] - cs)
    inc = torch.einsum("bhcjp,bhcj,bhcjn->bhcpn", _chunked(x, chunk), w,
                       _heads(_chunked(Bm, chunk), x.shape[1]))
    return inc, torch.exp(cs[..., -1])


def ssd_state_pass_plain(inc, decay):
    """The forward state pass (the states pass's recurrence): S_0 = 0,
    S_{c+1} = decay_c S_c + inc_c. Returns
    (entering states (B, H, nc, P, N), final state (B, H, P, N))."""
    s = torch.zeros_like(inc[:, :, 0])
    enters = []
    for c in range(inc.shape[2]):
        enters.append(s)
        s = s * decay[:, :, c, None, None] + inc[:, :, c]
    return torch.stack(enters, dim=2), s


def ssd_fwd_output_plain(x, dt, A, Bm, Cm, enters, *, chunk: int):
    """The forward's output pass: y = (C B^T o L o dt_j) x + exp(cs) o (C S_c^T)
    per chunk, from the entering states. Returns y (B, H, L, P) fp32."""
    h, l = x.shape[1], x.shape[2]
    dtc, cs = _chunk_cs(dt, A, chunk)
    cc = _heads(_chunked(Cm, chunk), h)
    scores = (torch.einsum("bhcin,bhcjn->bhcij", cc, _heads(_chunked(Bm, chunk), h))
              * _decay_matrix(cs) * dtc[..., None, :])
    y = (torch.einsum("bhcij,bhcjp->bhcip", scores, _chunked(x, chunk))
         + torch.exp(cs)[..., None] * torch.einsum("bhcin,bhcpn->bhcip", cc, enters))
    return _unchunk(y, l)


def ssd_bwd_increments_plain(dy, dt, A, Cm, *, chunk: int):
    """The backward's chunk-local increments (the reverse states pass's
    products): each chunk's own state-cotangent increment
    (dy o exp(cs))^T C and its decay exp(cs[-1]). Returns (increments
    (B, H, nc, P, N), decay (B, H, nc))."""
    _, cs = _chunk_cs(dt, A, chunk)
    inc = torch.einsum("bhcip,bhci,bhcin->bhcpn", _chunked(dy, chunk), torch.exp(cs),
                       _heads(_chunked(Cm, chunk), dy.shape[1]))
    return inc, torch.exp(cs[..., -1])


def ssd_dstate_pass_plain(inc, decay, dfinal):
    """The backward's reverse state pass: the cotangent of the state leaving
    the last chunk is dfinal, dS_{c-1} = decay_c dS_c + inc_c. Returns dS_out of
    each chunk (B, H, nc, P, N)."""
    s = dfinal.float()
    out = [None] * inc.shape[2]
    for c in reversed(range(inc.shape[2])):
        out[c] = s
        s = s * decay[:, :, c, None, None] + inc[:, :, c]
    return torch.stack(out, dim=2)


def _dda_fold(dcs, last):
    """dda_i = sum_{j >= i} dcs_j + last: the reverse cumsum of cs's cotangent,
    with the two cs[-1] terms (``last``) landing on every position."""
    return (dcs.sum(dim=-1, keepdim=True) + last[..., None]) - torch.cumsum(dcs, dim=-1) + dcs


def ssd_bwd_grads_plain(x, dt, A, Bm, Cm, enters, dstate, dy, *, chunk: int):
    """The backward's gradient pass (the rows and columns kernels), per chunk from
    its entering state S_in and the
    cotangent dS of the state leaving it, by the explicit formulas (w =
    exp(cs[-1] - cs), scores = C B^T o L, dscores = dy (x dt)^T):
      dxd = scores^T dy + w o (B dS^T), dx = dxd dt
      dC  = (dy o exp(cs)) S_in + (dscores o L) B
      dB  = w o ((x dt) dS) + (dscores o L)^T C
      dcs = rowsum(G) - colsum(G) + rowsum(dy o y_off) - t, G = dscores o scores,
            y_off = exp(cs) o (C S_in^T), t = w o rowsum(((x dt) dS) o B)
      dda = the reverse cumsum of dcs + last, last = sum(t) + exp(cs[-1]) <dS, S_in>
      ddt = dda A + rowsum(dxd o x)
    Returns the per-head fp32 (dx, ddt, dda, db, dc), as the kernels write them."""
    h, l = x.shape[1], x.shape[2]
    dtc, cs = _chunk_cs(dt, A, chunk)
    xc, dyc = _chunked(x, chunk), _chunked(dy, chunk)
    bc, cc = _heads(_chunked(Bm, chunk), h), _heads(_chunked(Cm, chunk), h)
    ec, w = torch.exp(cs), torch.exp(cs[..., -1:] - cs)
    xd = xc * dtc[..., None]
    lmat = _decay_matrix(cs)
    scores = torch.einsum("bhcin,bhcjn->bhcij", cc, bc) * lmat
    dscores = torch.einsum("bhcip,bhcjp->bhcij", dyc, xd)
    dcb = dscores * lmat
    dxd = (torch.einsum("bhcij,bhcip->bhcjp", scores, dyc)
           + w[..., None] * torch.einsum("bhcjn,bhcpn->bhcjp", bc, dstate))
    y_off = ec[..., None] * torch.einsum("bhcin,bhcpn->bhcip", cc, enters)
    dc = (torch.einsum("bhcip,bhcpn->bhcin", dyc * ec[..., None], enters)
          + torch.einsum("bhcij,bhcjn->bhcin", dcb, bc))
    xd_ds = torch.einsum("bhcjp,bhcpn->bhcjn", xd, dstate)
    db = w[..., None] * xd_ds + torch.einsum("bhcij,bhcin->bhcjn", dcb, cc)
    g = dscores * scores
    t = w * (xd_ds * bc).sum(dim=-1)
    dcs = g.sum(dim=-1) - g.sum(dim=-2) + (dyc * y_off).sum(dim=-1) - t
    last = t.sum(dim=-1) + torch.exp(cs[..., -1]) * (dstate * enters).sum(dim=(-2, -1))
    dda = _dda_fold(dcs, last)
    ddt = dda * A.float()[None, :, None, None] + (dxd * xc).sum(dim=-1)
    return (_unchunk(dxd * dtc[..., None], l), _unchunk(ddt, l), _unchunk(dda, l),
            _unchunk(db, l), _unchunk(dc, l))


class SSDChunkScan(torch.autograd.Function):
    """The reference's ``_ssd`` custom VJP: the forward runs
    :func:`ssd_chunk_scan_fwd` with the entering states and saves (x, dt, A, B,
    C, entering states); the backward runs :func:`ssd_chunk_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, enters, final = ssd_chunk_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk,
                                              save_enters=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, enters)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, enters = ctx.saved_tensors
        grads = ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, enters, dy, dfinal, chunk=ctx.chunk)
        return (*grads, None)


def ssd_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Fused differentiable SSD, head-major. Returns (y (B, H, L, P) fp32,
    final state (B, H, P, N) fp32). Forward-only calls (no input needs a grad,
    or grad mode is off) skip the entering states."""
    chunk = int(chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SSDChunkScan.apply(x, dt, A, Bm, Cm, chunk)
    y, _, final = ssd_chunk_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    return y, final
