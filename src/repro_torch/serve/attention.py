"""Decode attention against a KV cache (port of ``repro/serve/attention.py``).

The reference computes this in XLA, not Pallas, so it stays plain PyTorch. KV
cache layout per layer: (B, T, Hkv, hd). The reference rebuilds the cache
functionally; the port writes the current token's K/V into it in place.

The sequence-sharded branch (``mesh`` a grid whose model axis is 2 or more;
survey §4.1.4): the cache passed in is this rank's block of positions,
``[r T_loc, (r + 1) T_loc)`` (``core.sharding.seq_block``). Only the rank that
owns ``pos`` writes the new K/V, at ``pos - r T_loc``; each rank attends its
block with the causal and window masks and returns un-normalised partials
(o, m, l); one MAX all-reduce of m and one SUM all-reduce of the rescaled o
and l (together in one buffer) over the model ring merge them exactly, the
reference's logsumexp combine. Every rank runs both collectives at every
call, whatever its block holds: a rank with no valid key (a sliding window
that lies in another block) has m = ``NEG_INF``, finite, so its correction
``exp(m - m_g)`` is 0 and no NaN appears.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sharding import seq_block
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


def combine_ring(ring, o, m, l):
    """The exact combine of every model rank's partial (o, m, l) over
    ``ring`` (module docstring): (o, l) summed after rescaling to the max."""
    m_g = ring.all_reduce_max(m)
    corr = torch.exp(m - m_g)
    ol = torch.cat([(o * corr[..., None]).reshape(-1), (l * corr).reshape(-1)])
    ol = ring.all_reduce_sum(ol)
    return ol[:o.numel()].view_as(o), m_g, ol[o.numel():].view_as(l)


def decode_attention(q, k_cache, v_cache, k_new, v_new, pos: int, *,
                     window: int = 0, softcap: float = 0.0, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out (B, 1, Hq, hd), k_cache, v_cache).

    q: (B, 1, Hq, hd); caches (B, T, Hkv, hd); k_new/v_new (B, 1, Hkv, hd).
    Positions 0..pos-1 of the cache are valid history; the current token's K/V
    are written at ``pos`` (in place) and attended to. With ``window > 0`` only
    keys with pos - j < window participate.

    With ``mesh`` a grid whose model axis is 2 or more the caches are this
    rank's block of T_loc positions (module docstring). The rows are this
    rank's already: the reference's ``batch_axes`` (the axes its shard_map
    splits the batch over) has no counterpart here.
    """
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    qg = q.reshape(b, hkv, g, hd)
    ring = mesh.model if mesh is not None and mesh.shape.get("model", 1) > 1 else None
    t = k_cache.shape[1]
    start = seq_block(t, ring.rank)[0] if ring is not None else 0
    if start <= pos < start + t:
        # only the owner writes: the others' blocks do not hold pos
        k_cache[:, pos - start] = k_new[:, 0]
        v_cache[:, pos - start] = v_new[:, 0]
    jpos = start + torch.arange(t, device=q.device)
    valid = jpos <= pos
    if window > 0:
        valid &= (pos - jpos) < window
    valid = valid.expand(b, t)
    o, m, l = _local_decode_attn(qg, k_cache, v_cache, valid_mask=valid,
                                 softcap=softcap, scale=scale)
    if ring is not None:
        o, m, l = combine_ring(ring, o, m, l)
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(b, 1, hq, hd), k_cache, v_cache
