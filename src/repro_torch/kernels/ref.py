"""Plain PyTorch oracles for the kernels (the allclose reference)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import attention_direct


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale: Optional[float] = None):
    """(B, Hq, S, hd) layout oracle (kernels use head-major layout)."""
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    out = attention_direct(qt, kt, vt, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    return out.transpose(1, 2).to(q.dtype)


def expert_gemm_ref(x, w, group_sizes=None):
    """x: (E, C, d), w: (E, d, f) -> (E, C, f) batched per-expert GEMM.
    ``group_sizes`` (E,) zeroes each expert's padding rows (same semantics as
    the kernel's row masking)."""
    if group_sizes is not None:
        rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
        x = torch.where(rows < group_sizes[:, None, None], x, 0)
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
