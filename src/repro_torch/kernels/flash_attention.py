"""FlashAttention forward: the hand-written Hopper kernel and its plain twin.

Counterpart of ``repro/kernels/flash_attention.py`` (forward only: ``_fwd_kernel``
through ``_flash_attention_lse``, ``flash_attention`` and ``flash_attention_lse``). The
kernel is ``csrc/flash_fwd.cu``, CUDA C++ for ``sm_90a``, bound with ctypes; its
source note says how it maps the TPU kernel onto Hopper and what bounds it.

Layouts are head-major as in the reference: q (B, Hq, S, hd), k/v (B, Hkv, T, hd)
-> o (B, Hq, S, hd) in the input dtype and lse (B, Hq, S) fp32. The kernel reads
q/k/v and writes o through batch/head/sequence strides, so a transposed view of a
batch-major tensor is taken without a copy, and o comes back in q's memory layout.

:func:`flash_attention_lse` is the wrapper: a CUDA tensor launches the kernel
(or the call raises), a CPU tensor takes :func:`flash_attention_lse_plain`, the
plain PyTorch version of the same function. There is no fall-back from one to the other.
Tiles are the kernel's own choice, so the reference's ``block_q``/``block_k``/
``interpret`` arguments have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.models.layers import NEG_INF, attn_mask
from . import build

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
def _kernel():
    lib = build.load("flash_fwd")
    fn = lib.flash_fwd
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 5 + [i64] * 12 + [i32] * 10 + [f32, f32, ptr])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_lse wants q (B,Hq,S,hd), k/v (B,Hkv,T,hd)")
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


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: Optional[float] = None,
                        q_offset: int = 0):
    """Forward that also returns the per-row logsumexp (the lse-merging entry
    of chunked softmax). Returns (o (B, Hq, S, hd), lse (B, Hq, S) fp32).

    CUDA tensors launch the kernel; ``flash_attention_lse.launches`` counts the
    launches. CPU tensors take :func:`flash_attention_lse_plain`.
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
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_lse runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {hd}")
    vec = 16 // q.element_size()      # the kernel moves 16-byte chunks
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(st % vec for st in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head dim, strides that are "
                             f"multiples of {vec} elements and a 16-byte aligned base")
    b, hq, s, _ = q.shape
    hkv, t = k.shape[1], k.shape[2]
    o = torch.empty_like(q)           # q's memory layout (see module docstring)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        b, hq, hkv, s, t, hd, _DTYPE_CODE[q.dtype],
        int(bool(causal)), window, q_offset, float(softcap), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention_lse.launches += 1
    return o, lse


flash_attention_lse.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0):
    """Fused attention forward, head-major. Returns o (B, Hq, S, hd)."""
    return flash_attention_lse(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale, q_offset=q_offset)[0]

