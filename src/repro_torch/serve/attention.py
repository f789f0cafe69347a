"""Decode attention against a KV cache (local branch of ``repro/serve/attention.py``).

The reference computes this in XLA, not Pallas, so it stays plain PyTorch. KV
cache layout per layer: (B, T, Hkv, hd). The reference rebuilds the cache
functionally; the port writes the current token's K/V into it in place. The
sequence-sharded (mesh) branch comes with the distributed slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import NEG_INF, _softcap


def _local_decode_attn(q, k, v, *, valid_mask, softcap, scale):
    """q: (B, Hkv, G, hd); k/v: (B, T, Hkv, hd); valid_mask: (B, T) bool.

    Returns un-normalized (o (B,Hkv,G,hd) fp32, m (B,Hkv,G), l (B,Hkv,G)).
    """
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float())
    s = _softcap(s * scale, softcap)
    mask = valid_mask[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return o, m, l


def combine_lse(parts):
    """Merge [(o, m, l), ...] partial attention results exactly."""
    m = torch.stack([mp for _, mp, _ in parts]).amax(dim=0)
    o = sum(op * torch.exp(mp - m)[..., None] for op, mp, _ in parts)
    l = sum(lp * torch.exp(mp - m) for _, mp, lp in parts)
    return o, m, l


def decode_attention(q, k_cache, v_cache, k_new, v_new, pos: int, *,
                     window: int = 0, softcap: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out (B, 1, Hq, hd), k_cache, v_cache).

    q: (B, 1, Hq, hd); caches (B, T, Hkv, hd); k_new/v_new (B, 1, Hkv, hd).
    Positions 0..pos-1 of the cache are valid history; the current token's K/V
    are written at ``pos`` (in place) and attended to. With ``window > 0`` only
    keys with pos - j < window participate.
    """
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    qg = q.reshape(b, hkv, g, hd)
    k_cache[:, pos] = k_new[:, 0]
    v_cache[:, pos] = v_new[:, 0]
    t = k_cache.shape[1]
    jpos = torch.arange(t, device=q.device)
    valid = jpos <= pos
    if window > 0:
        valid &= (pos - jpos) < window
    valid = valid.expand(b, t)
    o, _, l = _local_decode_attn(qg, k_cache, v_cache, valid_mask=valid,
                                 softcap=softcap, scale=scale)
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(b, 1, hq, hd), k_cache, v_cache
