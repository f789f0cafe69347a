"""Kernel dispatch — pick an implementation per call site (attention part of
``repro/kernels/dispatch.py``).

Model code calls :func:`dispatch_attention` (via ``repro_torch.models.layers``)
with ``ParallelPlan.attn_impl``, resolved by :func:`select_impl`:

- ``"plain"`` — always the plain PyTorch twin (``attention_direct``, or
  ``attention_blockwise`` for long KV).
- ``"cuda"``  — always the hand-written CUDA kernels; a CPU tensor raises.
- ``"auto"``  — the kernels on a CUDA tensor, the plain twin on a CPU tensor.

The kernel path is differentiable: ``flash_attention`` is the autograd
Function over the forward kernel (B1) and the two backward kernels (B2, B3),
and the plain twin differentiates through autograd. The reference's
``dispatch_attention_lse`` and ``dispatch_attention_chunk_bwd`` come with the
context-parallel slice.

On CUDA the kernel takes the head dims it has bodies for
(``flash_attention.HEAD_DIMS``) and the call raises for any other; it never
falls back to the twin.

In the reference, gemma2's local/global alternation makes the window a traced
scan value, so the reference falls back to XLA there. The port runs its layers
as a Python loop, so the window is a per-layer ``int`` and the kernel serves
gemma2 too: the dispatch choice differs, the numbers do not.

Layout contract: model code is batch-major (B, S, H, hd), the kernel
head-major. The dispatcher owns the transposes (views: the kernel reads and
writes through strides) and, for the plain twin, the KV padding to the block
boundary — never a silent fall-back to the quadratic path on unaligned lengths.
The fault-injection seam of the reference (``_tainted``) comes with the
fault-tolerance slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.config import ATTN_IMPLS
from repro_torch.models import layers as _layers
from .flash_attention import HEAD_DIMS, flash_attention


def select_impl(impl: str, *, head_dim: int, device) -> str:
    """Resolve the attention impl for a call on ``device`` -> "plain" | "cuda"."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")
    on_cuda = torch.device(device).type == "cuda"
    if impl == "plain" or (impl == "auto" and not on_cuda):
        return "plain"
    if not on_cuda:
        raise ValueError(f"attn_impl='cuda' forces the CUDA kernel; the tensor is "
                         f"on {device}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attn_impl={impl!r}: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, not {head_dim}; use attn_impl='plain'")
    return "cuda"


def _pad_seq(x, axis: int, target: int):
    if x.shape[axis] == target:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, target - x.shape[axis]]
    return F.pad(x, pads)


def dispatch_attention(q, k, v, *, impl: str = "auto", causal: bool = True,
                       window: int = 0, softcap: float = 0.0, q_offset: int = 0,
                       block_size: int = 1024, scale: Optional[float] = None):
    """q: (B, S, Hq, hd), k/v: (B, T, Hkv, hd) -> (B, S, Hq, hd)."""
    choice = select_impl(impl, head_dim=q.shape[-1], device=q.device)
    if choice == "cuda":
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=int(window), softcap=softcap, scale=scale,
            q_offset=int(q_offset))
        return out.transpose(1, 2)

    t = k.shape[1]
    if t <= 2 * block_size:
        return _layers.attention_direct(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, scale=scale)
    if t % block_size:
        # pad KV to the block boundary and mask the tail — never drop to the
        # O(S·T) direct path just because the context length is unaligned
        t_pad = -(-t // block_size) * block_size
        return _layers.attention_blockwise(
            q, _pad_seq(k, 1, t_pad), _pad_seq(v, 1, t_pad), causal=causal,
            window=window, softcap=softcap, q_offset=q_offset,
            block_size=block_size, scale=scale, kv_len=t)
    return _layers.attention_blockwise(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_offset=q_offset, block_size=block_size, scale=scale)
