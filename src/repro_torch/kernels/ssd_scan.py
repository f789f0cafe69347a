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

:func:`ssd_chunk_scan_fwd` and :func:`ssd_chunk_scan_bwd` are the wrappers: a CUDA
tensor launches the kernel (or the call raises), a CPU tensor takes
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


@functools.cache
def _fwd_kernel():
    lib = build.load("ssd_fwd")
    fn = lib.ssd_fwd
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i64] * 15 + [i32] * 8 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def ssd_chunk_scan_fwd(x, dt, A, Bm, Cm, *, chunk: int = 128, save_enters: bool = False):
    """The forward. Returns (y (B, H, L, P) fp32, entering states (B, H, nc, P, N)
    fp32 or None, final state (B, H, P, N) fp32); the entering states only with
    ``save_enters`` (the backward's residual).

    CUDA tensors launch the kernel; ``ssd_chunk_scan_fwd.launches`` counts the
    launches. CPU tensors take :func:`ssd_chunk_scan_fwd_plain`.
    """
    _check(x, dt, A, Bm, Cm, chunk)
    chunk = int(chunk)
    if x.device.type == "cpu":
        y, enters, final = ssd_chunk_scan_fwd_plain(x, dt, A, Bm, Cm, chunk=chunk)
        return y, (enters if save_enters else None), final
    _cuda_args(x, dt, A, Bm, Cm, chunk)
    b, h, l, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    x, Bm, Cm = (_inner_contiguous(t) for t in (x, Bm, Cm))
    dt = dt.float()
    A = A.float().contiguous()
    nc = -(-l // chunk)
    y = torch.empty_like(x, dtype=torch.float32)        # x's memory layout
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    enters = (torch.empty((b, h, nc, p, n), dtype=torch.float32, device=x.device)
              if save_enters else None)
    err = _fwd_kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), enters.data_ptr() if save_enters else None, final.data_ptr(),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *y.stride()[:3], b, h, g, l, p, n, chunk, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_fwd launch failed: cudaError {err}")
    ssd_chunk_scan_fwd.launches += 1
    return y, enters, final


ssd_chunk_scan_fwd.launches = 0


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
    fn = lib.ssd_bwd
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr] * 13 + [i64] * 18 + [i32] * 8 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, enters, dy, dfinal, *, chunk: int = 128):
    """The backward from the forward's inputs, its entering states and the
    cotangents of y (B, H, L, P) and the final state (B, H, P, N). Returns (dx,
    ddt, dA, dB, dC) in the inputs' dtypes.

    CUDA tensors launch the kernel once (``ssd_chunk_scan_bwd.launches`` counts
    it) and reduce dB/dC onto the groups and dA outside it, as the reference
    does. CPU tensors take :func:`ssd_chunk_scan_bwd_plain` (``enters`` unused).
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
    per_head = _bwd_launch(xk, dt.float(), A.float().contiguous(), Bk, Ck,
                           enters.float().contiguous(), _inner_contiguous(dy.float()),
                           dfinal.float().contiguous(), chunk)
    return _reduce_grads(*per_head, x, dt, A, Bm, Cm)


def _bwd_launch(x, dt, A, Bm, Cm, enters, dy, dfinal, chunk):
    """Launch the backward kernel on checked inputs (fp32 dt, A, enters, dy and
    dfinal; the last dims contiguous) and count the launch. Returns the kernel's
    per-head fp32 (dx, ddt, dda, db, dc)."""
    b, h, l, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    dx = torch.empty_like(x, dtype=torch.float32)
    ddt = torch.empty((b, h, l), dtype=torch.float32, device=x.device)
    dda = torch.empty_like(ddt)
    db = torch.empty((b, h, l, n), dtype=torch.float32, device=x.device)
    dc = torch.empty_like(db)
    err = _bwd_kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        enters.data_ptr(), dy.data_ptr(), dfinal.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dda.data_ptr(), db.data_ptr(), dc.data_ptr(),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *dy.stride()[:3], *dx.stride()[:3], b, h, g, l, p, n, chunk,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_bwd launch failed: cudaError {err}")
    ssd_chunk_scan_bwd.launches += 1
    return dx, ddt, dda, db, dc


ssd_chunk_scan_bwd.launches = 0


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
