"""Kernel dispatch — pick an implementation per call site (attention, MoE
expert-GEMM and SSD parts of ``repro/kernels/dispatch.py``).

Model code calls :func:`dispatch_attention` (via ``repro_torch.models.layers``)
with ``ParallelPlan.attn_impl``, resolved by :func:`select_impl`, and
:func:`dispatch_expert_gemm` (via ``repro_torch.models.moe``) with
``ParallelPlan.moe_gemm_impl``, resolved by :func:`select_gemm_impl`, and
:func:`dispatch_ssd_scan` (via ``repro_torch.models.ssm``) with
``ParallelPlan.ssm_impl``, resolved by :func:`select_ssd_impl`, under the same
three rules:

- ``"plain"`` — always the plain PyTorch twin (``attention_direct``, or
  ``attention_blockwise`` for long KV).
- ``"cuda"``  — always the hand-written CUDA kernels; a CPU tensor raises.
- ``"auto"``  — the kernels on a CUDA tensor, the plain twin on a CPU tensor.

The kernel paths are differentiable: ``flash_attention`` is the autograd
Function over the forward kernel (B1) and the two backward kernels (B2, B3),
``expert_gemm`` the one over the grouped GEMM (B4: forward and dx in rows
mode, dw in contract mode), ``ssd_chunk_scan`` the one over the SSD forward
(B5) and backward (B6), and the plain twins differentiate through autograd.
The reference's
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

Fault seams: each dispatcher's output passes a named fault point
(``kernel.attention``, ``kernel.expert_gemm``, ``kernel.ssd``; ``_tainted``,
``repro_torch.ft.inject``). Unarmed it costs one attribute read, launches
nothing and copies nothing; armed, it corrupts what the chosen body returned
and never changes which body runs.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.config import ATTN_IMPLS
from repro_torch.ft import inject as _inject
from repro_torch.models import layers as _layers
from repro_torch.models.ssm import ssd_scan
from .flash_attention import HEAD_DIMS, flash_attention
from .grouped_gemm import expert_gemm
from .ssd_scan import ssd_chunk_scan


def _tainted(point: str):
    """Route a dispatcher's primary output through the fault point ``point``
    (a tuple return taints its first element): the identity while nothing is
    armed, as the reference's seam is outside an armed trace."""
    if point not in _inject.FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if not _inject.CONTROLLER._specs:
                return out
            if isinstance(out, tuple):
                return (_inject.taint(point, out[0]),) + out[1:]
            return _inject.taint(point, out)
        return wrapper
    return deco


def _resolve(impl: str, knob: str, device) -> str:
    """The three rules of the module docstring -> "plain" | "cuda"."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"{knob} must be one of {ATTN_IMPLS}, got {impl!r}")
    on_cuda = torch.device(device).type == "cuda"
    if impl == "plain" or (impl == "auto" and not on_cuda):
        return "plain"
    if not on_cuda:
        raise ValueError(f"{knob}='cuda' forces the CUDA kernel; the tensor is "
                         f"on {device}")
    return "cuda"


def select_impl(impl: str, *, head_dim: int, device) -> str:
    """Resolve the attention impl for a call on ``device`` -> "plain" | "cuda"."""
    if _resolve(impl, "attn_impl", device) == "plain":
        return "plain"
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attn_impl={impl!r}: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, not {head_dim}; use attn_impl='plain'")
    return "cuda"


@_tainted("kernel.attention")
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
            q, _layers.pad_seq(k, 1, t_pad), _layers.pad_seq(v, 1, t_pad), causal=causal,
            window=window, softcap=softcap, q_offset=q_offset,
            block_size=block_size, scale=scale, kv_len=t)
    return _layers.attention_blockwise(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_offset=q_offset, block_size=block_size, scale=scale)


# ---------------------------------------------------------------------------
# MoE expert GEMM


def select_gemm_impl(impl: str, *, device) -> str:
    """Resolve the expert-GEMM impl for a call on ``device`` -> "plain" | "cuda".
    The kernel masks every ragged dim itself, so "cuda" takes any shape."""
    return _resolve(impl, "moe_gemm_impl", device)


@_tainted("kernel.expert_gemm")
def dispatch_expert_gemm(x, w, group_sizes=None, *, impl: str = "auto"):
    """x: (E, C, d) x w: (E, d, f) -> (E, C, f); ``group_sizes`` (E,) marks the
    real rows per expert (padding rows are masked out of outputs and grads).
    The plain twin is the reference's masked einsum in the input dtype."""
    if select_gemm_impl(impl, device=x.device) == "cuda":
        return expert_gemm(x, w, group_sizes)
    if group_sizes is not None:
        rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
        x = torch.where(rows < group_sizes.detach()[:, None, None], x, 0)
    return torch.einsum("ecd,edf->ecf", x, w)


# ---------------------------------------------------------------------------
# Mamba2 SSD chunk scan


def select_ssd_impl(impl: str, *, device, has_initial_state: bool = False) -> str:
    """Resolve the SSD impl for a call on ``device`` -> "plain" | "cuda".

    The kernels start from a zero state. Where the reference silently takes its
    XLA twin for a caller's initial state, the port raises on a CUDA tensor under
    "auto" and "cuda": the context-parallel slice (ROADMAP A13.3) must give the
    kernel an initial state first. The plain twin honours one."""
    choice = _resolve(impl, "ssm_impl", device)
    if choice == "cuda" and has_initial_state:
        raise NotImplementedError(
            f"ssm_impl={impl!r}: the SSD kernels start from a zero state; an initial "
            f"state comes with the context-parallel slice (ROADMAP A13.3), or use "
            f"ssm_impl='plain'")
    return choice


@_tainted("kernel.ssd")
def dispatch_ssd_scan(x, dt, A, B, C, *, chunk: int, impl: str = "auto",
                      initial_state=None):
    """Model layout: x (B, L, H, P), dt (B, L, H), A (H,), B/C (B, L, G, N).
    Returns (y (B, L, H, P) fp32, final_state (B, H, P, N) fp32).

    ``chunk = min(chunk, L)``. An unaligned length is padded to the chunk boundary
    with dt = 0 steps (decay exp(0) = 1, zero input: the state rides through
    unchanged) and y is cut back to L, never collapsed into one whole-sequence
    chunk with an O(L^2) decay matrix. The kernel does that padding as a masked
    load of the ragged last chunk; the plain twin pads. The kernel reads the
    head-major views through strides.
    """
    l = x.shape[1]
    chunk = min(int(chunk), l)
    choice = select_ssd_impl(impl, device=x.device,
                             has_initial_state=initial_state is not None)
    if choice == "cuda":
        y, state = ssd_chunk_scan(x.transpose(1, 2), dt.transpose(1, 2), A,
                                  B.transpose(1, 2), C.transpose(1, 2), chunk=chunk)
        return y.transpose(1, 2), state
    l_pad = -(-l // chunk) * chunk
    y, state = ssd_scan(_layers.pad_seq(x, 1, l_pad), _layers.pad_seq(dt, 1, l_pad), A,
                        _layers.pad_seq(B, 1, l_pad), _layers.pad_seq(C, 1, l_pad), chunk=chunk,
                        initial_state=initial_state)
    return y[:, :l], state
