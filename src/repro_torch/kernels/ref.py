"""Plain PyTorch oracles for the kernels (the allclose reference)."""

from __future__ import annotations

from typing import Optional

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
