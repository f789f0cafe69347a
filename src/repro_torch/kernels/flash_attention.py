"""FlashAttention: the hand-written Hopper kernels and their plain twins.

Counterpart of ``repro/kernels/flash_attention.py``: the forward (``_fwd_kernel``
through ``_flash_attention_lse``, ``flash_attention_lse``), the backward
(``_dq_kernel`` and ``_dkv_kernel`` through ``flash_attention_bwd``) and the
custom VJP that ties them (``_flash``). The kernels are ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, CUDA C++ for ``sm_90a``, bound with ctypes; their source
notes say how they map the TPU kernels onto Hopper and what bounds them.

Layouts are head-major as in the reference: q/do (B, Hq, S, hd), k/v
(B, Hkv, T, hd), lse/delta (B, Hq, S) fp32. The kernels read and write through
batch/head/sequence strides, so a transposed view of a batch-major tensor is
taken without a copy, and each output comes back in its input's memory layout.

:func:`flash_attention_lse` and :func:`flash_attention_bwd` are the wrappers:
a CUDA tensor launches the kernel (or the call raises), a CPU tensor takes
:func:`flash_attention_lse_plain` / :func:`flash_attention_bwd_plain`, the plain
PyTorch versions of the same functions. There is no fall-back from one to the
other. On the card, the forward's body is a static rule (:func:`fwd_body`):
bf16 at the head dims in ``SM90_HEAD_DIMS`` (every path's) runs the Hopper body,
other bf16 head dims the first-version ``mma.sync`` body, fp32 the FMA body. The
kernels take every head dim in ``HEAD_DIMS`` (a multiple of 8 up to 256, as the
reference's kernel does) and raise for any other on a CUDA tensor.
:func:`flash_attention` is differentiable through :class:`FlashAttention`,
whose forward runs :func:`flash_attention_lse` and whose backward runs
:func:`flash_attention_bwd`. Tiles are the kernels' own choice, so the
reference's ``block_q``/``block_k``/``interpret`` arguments have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.models.layers import NEG_INF, attention_chunk_grads, attn_mask
from . import build

# the reference's rule for its kernel (``select_impl``: a multiple of 8 up to 256);
# the fp32 and first-version bodies run at the least of 32, 64, 128, 256 that holds
# the head dim, its columns past hd masked (csrc/flash_fwd.cu ``body_hd``)
HEAD_DIMS = tuple(range(8, 257, 8))
SM90_HEAD_DIMS = (64, 128)        # bf16 head dims of the forward's Hopper body
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_BODIES = {"f32": 0, "mma": 1, "sm90": 2}     # csrc/flash_fwd.cu's body codes


def flash_attention_lse_plain(q, k, v, *, causal: bool = True, window: int = 0,
                              softcap: float = 0.0, scale: Optional[float] = None,
                              q_offset: int = 0):
    """Plain PyTorch version of the kernel: the same (o, lse), fp32 math.

    Materialises the (B, Hkv, G, S, T) score tensor. Masked scores are the
    finite ``NEG_INF`` and the row sum is clamped to 1e-30, so a fully masked
    row gives o = 0 and lse ~ NEG_INF, as the kernel does.
    """
    b, hq, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale) if scale is not None else hd ** -0.5
    qg = q.reshape(b, hkv, g, s, hd).float()
    sc = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    mask = attn_mask(q_offset + torch.arange(s, device=q.device),
                     torch.arange(t, device=q.device), causal=causal, window=window)
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None]) * mask
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / l[..., None]
    lse = m + torch.log(l)
    return o.reshape(b, hq, s, hd).to(q.dtype), lse.reshape(b, hq, s)


@functools.cache
def _fwd_kernel():
    fn = build.load("flash_fwd").flash_fwd
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 5 + [i64] * 12 + [i32] * 10 + [f32, f32, ptr])
    fn.restype = ctypes.c_int
    return fn


def fwd_body(q) -> str:
    """The forward's body for q's dtype and head dim on the card: "sm90" (the
    Hopper body) for bf16 at ``SM90_HEAD_DIMS``, "mma" (the first version) for
    bf16 at the other head dims, "f32" for fp32."""
    if q.dtype == torch.float32:
        return "f32"
    return "sm90" if q.shape[-1] in SM90_HEAD_DIMS else "mma"


def _check(q, k, v):
    """Shapes, dtypes and devices the kernels and their twins take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("the flash kernels want q (B,Hq,S,hd), k/v (B,Hkv,T,hd)")
    b, hq, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")


def _aligned(x) -> bool:
    """The kernels move 16-byte chunks: contiguous head dim, batch/head/sequence
    strides that are multiples of 16 bytes, a 16-byte aligned base."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and not any(st % vec for st in x.stride()[:3])
            and build.base_aligned(x))


def _cuda_args(q, k, v):
    """What the kernels take beyond :func:`_check`: a CUDA device, their dtypes
    and head dims, and layouts that meet the 16-byte rule of :func:`_aligned`."""
    if not build.on_card(q):
        raise ValueError(f"the flash kernels run on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernels take float32 or bfloat16, not {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernels take head dims that are multiples of 8 up to "
                         f"256, not {q.shape[-1]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _aligned(x):
            raise ValueError(f"{name} needs a contiguous head dim, strides that are "
                             f"multiples of 16 bytes and a 16-byte aligned base")


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: Optional[float] = None,
                        q_offset: int = 0):
    """Forward that also returns the per-row logsumexp (the lse-merging entry
    of chunked softmax). Returns (o (B, Hq, S, hd), lse (B, Hq, S) fp32).

    CUDA tensors launch the kernel's body that :func:`fwd_body` names;
    ``flash_attention_lse.launches`` counts the launches and ``.sm90_launches``,
    ``.mma_launches`` and ``.f32_launches`` each body's. CPU tensors take
    :func:`flash_attention_lse_plain`.
    """
    _check(q, k, v)
    window, q_offset = int(window), int(q_offset)
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be >= 0")
    hd = q.shape[-1]
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal, window=window,
                                         softcap=softcap, scale=scale,
                                         q_offset=q_offset)
    _cuda_args(q, k, v)
    b, hq, s, _ = q.shape
    o = torch.empty_like(q)           # q's memory layout (see module docstring)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _fwd_launch(fwd_body(q), q, k, v, o, lse, causal=causal, window=window,
                softcap=softcap, scale=scale, q_offset=q_offset)
    return o, lse


def _fwd_launch(body, q, k, v, o, lse, *, causal, window, softcap, scale, q_offset):
    """Launch the forward's ``body`` on checked inputs and allocated outputs.
    Counts the launch, in all and per body. A tensor without data returns first
    (``build.traced``)."""
    if build.traced(q):
        return
    b, hq, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    err = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        b, hq, hkv, s, t, hd, _FWD_BODIES[body],
        int(bool(causal)), window, q_offset, float(softcap), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd ({body} body) launch failed: "
                           f"{build.launch_error(err)}")
    flash_attention_lse.launches += 1
    if body == "sm90":
        flash_attention_lse.sm90_launches += 1
    elif body == "mma":
        flash_attention_lse.mma_launches += 1
    else:
        flash_attention_lse.f32_launches += 1


flash_attention_lse.launches = 0
flash_attention_lse.sm90_launches = 0      # the Hopper body
flash_attention_lse.mma_launches = 0       # the first-version bf16 body
flash_attention_lse.f32_launches = 0


def flash_attention_bwd_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              scale: Optional[float] = None, q_offset: int = 0):
    """Plain PyTorch version of the backward kernels: ``attention_chunk_grads``
    in the head-major layout. Materialises the (B, Hkv, G, S, T) scores."""
    hm = lambda x: x.transpose(1, 2)           # noqa: E731 (head- <-> batch-major)
    dq, dk, dv = attention_chunk_grads(
        hm(q), hm(k), hm(v), hm(do), lse.transpose(1, 2), delta.transpose(1, 2),
        causal=causal, window=window, softcap=softcap, q_offset=q_offset, scale=scale)
    return hm(dq), hm(dk), hm(dv)


@functools.cache
def _bwd_kernel():
    fn = build.load("flash_bwd").flash_bwd
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 9 + [i64] * 21 + [i32] * 10 + [f32, f32, i32, ptr])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: Optional[float] = None, q_offset: int = 0):
    """Backward against a given softmax statistic (the reference's chunk entry):
    ``lse``/``delta`` (B, Hq, S) may come from a softmax over more keys than
    (k, v), and (dq, dk, dv) are then this chunk's share. Returns dq
    (B, Hq, S, hd) in q's dtype and dk/dv (B, Hkv, T, hd) on the KV heads.

    CUDA tensors launch the dq kernel and the dk/dv kernel once each
    (``flash_attention_bwd.dq_launches`` / ``.dkv_launches`` count them); ``do``
    must have q's dtype and is copied only if its layout breaks the kernels'
    16-byte rule. CPU tensors take :func:`flash_attention_bwd_plain`.
    """
    _check(q, k, v)
    b, hq, s, hd = q.shape
    if do.shape != q.shape or lse.shape != (b, hq, s) or delta.shape != (b, hq, s):
        raise ValueError(f"do {tuple(do.shape)} must match q {tuple(q.shape)}, "
                         f"lse {tuple(lse.shape)} and delta {tuple(delta.shape)} "
                         f"must be {(b, hq, s)}")
    if do.dtype != q.dtype:
        raise ValueError(f"do is {do.dtype}, q is {q.dtype}")
    window, q_offset = int(window), int(q_offset)
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be >= 0")
    scale = float(scale) if scale is not None else hd ** -0.5
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
    _cuda_args(q, k, v)
    if not _aligned(do):
        do = do.contiguous()                  # an explicit copy, never the twin
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    for which in (0, 1):                      # 0: the dq kernel, 1: the dk/dv kernel
        _bwd_launch(which, q, k, v, do, lse, delta, dq, dk, dv, **kw)
    return dq, dk, dv


def _bwd_launch(which, q, k, v, do, lse, delta, dq, dk, dv, *, causal, window,
                softcap, scale, q_offset):
    """Launch one backward kernel on checked inputs and allocated outputs:
    ``which`` 0 writes dq, 1 writes dk and dv. Counts the launch. A tensor
    without data returns first (``build.traced``)."""
    if build.traced(q):
        return
    b, hq, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        b, hq, hkv, s, t, hd, _DTYPE_CODE[q.dtype],
        int(bool(causal)), window, q_offset, float(softcap), scale,
        which, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd {('dq', 'dk/dv')[which]} launch failed: "
                           f"{build.launch_error(err)}")
    if which == 0:
        flash_attention_bwd.dq_launches += 1
    else:
        flash_attention_bwd.dkv_launches += 1


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


class FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP. The forward runs
    :func:`flash_attention_lse` and saves (q, k, v, o, lse); the backward takes
    delta = rowsum(dO * O) in fp32 outside the kernels, as the reference does,
    and runs :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                      q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, do.to(q.dtype), lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0):
    """Fused differentiable attention, head-major. Returns o (B, Hq, S, hd)."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), int(window), float(softcap),
                                scale, int(q_offset))
