"""Mixture-of-Experts layer (port of ``repro/models/moe.py``, survey §4.1.5).

The routing machinery — router with the Switch-Transformer aux loss,
capacity-bounded top-k dispatch in one-hot-einsum (GShard) and index-scatter
(MegaBlocks-style) form — and the dense-dispatch path that runs the experts on
one device. All three SwiGLU GEMMs of the experts go through
``kernels.dispatch.dispatch_expert_gemm`` (``plan.moe_gemm_impl``) with the
per-expert group sizes, so padding rows stay out of the compute and the
gradients. DeepSeek-MoE's always-on shared experts are ``num_shared_experts``.

What differs from the reference, and why the numbers do not:

- Top-k is a stable descending sort cut to k, so ties go to the lower expert
  index as in ``jax.lax.top_k`` (``torch.topk`` promises no order among ties).
- One-hot tensors are comparisons against an ``arange``: an index outside the
  range gives a zero row (as ``jax.nn.one_hot``), and nothing waits on the
  device — the group sizes and the routing never reach the host.
- Slots are int64 (PyTorch's index type), where the reference keeps int32.
- The reference's ``batch_axes``/``n_dp`` aux reduction is ``router_probs``'s
  ``reduce``/``n_rep``, which the sharded placements pass
  (``train.executor.ParallelContext.aux_sum``).

Capacity is per call, ``max(int(n * k / E * capacity_factor), 1)`` with n the
call's tokens, so a decode step of batch 4 has capacity 1 and drops colliding
tokens, as the reference does. Drops follow the flattened (token, slot) order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from .layers import dense_init


def _one_hot(idx, n: int, dtype):
    """One-hot along a new last axis; an index outside [0, n) gives zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    e = cfg.moe
    d, de = cfg.d_model, e.d_expert
    p = {
        "router": dense_init(gen, (d, e.num_experts)),
        "experts": {
            "gate": dense_init(gen, (e.num_experts, d, de), in_axis=-2),
            "up": dense_init(gen, (e.num_experts, d, de), in_axis=-2),
            "down": dense_init(gen, (e.num_experts, de, d), in_axis=-2),
        },
    }
    if e.num_shared_experts:
        ds = de * e.num_shared_experts
        p["shared"] = {
            "gate": dense_init(gen, (d, ds)),
            "up": dense_init(gen, (d, ds)),
            "down": dense_init(gen, (ds, d)),
        }
    return p


# ---------------------------------------------------------------------------
# routing

def router_probs(p, x, cfg: ModelConfig, dtype, reduce=None, n_rep: int = 1):
    """x: (N, d) -> (probs (N, E) fp32, aux_loss scalar).

    The Switch-Transformer load-balancing aux takes its density statistics as
    sums over the tokens divided by their count. Where the batch's tokens are
    split over ranks (the context-parallel sequence chunks, the data rows),
    ``reduce`` sums a statistic over those ranks (``train.executor``'s
    ``ParallelContext.aux_sum``) and ``n_rep`` is their number, so every rank
    computes the aux of the whole batch, as the reference's ``batch_axes`` /
    ``n_dp`` psum does."""
    e = cfg.moe
    logits = (x @ p["router"].to(dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    density_sum = probs.sum(dim=0)                          # (E,)
    proxy_sum = _one_hot(probs.argmax(dim=-1), e.num_experts, torch.float32).sum(dim=0)
    if reduce is not None:
        density_sum, proxy_sum = reduce(density_sum), reduce(proxy_sum)
    n_tot = probs.shape[0] * n_rep
    aux = (e.num_experts
           * torch.sum((density_sum / n_tot) * (proxy_sum / n_tot))
           * e.aux_loss_coef)
    return probs, aux


def _top_k(probs, k: int):
    """The k largest probabilities per token, renormalized, and their experts;
    ties go to the lower index (a stable sort keeps equal values in order)."""
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[:, :k], top_idx[:, :k]
    return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), top_idx


def _queue_positions(top_idx, num_experts: int):
    """Position of each (token, slot) in its expert's queue, in the flattened
    (token, slot) order."""
    n, k = top_idx.shape
    onehot = _one_hot(top_idx, num_experts, torch.int64)    # (N, k, E)
    flat = onehot.reshape(n * k, num_experts)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(n, k, num_experts)
    return (pos_in_expert * onehot).sum(-1)                 # (N, k)


def topk_dispatch(probs, cfg: ModelConfig, capacity: int):
    """Capacity-bounded top-k dispatch tensors.

    Returns (dispatch (N, E, C) fp32 0/1, combine (N, E, C) fp32). Tokens
    overflowing an expert's capacity are dropped (GShard policy).
    """
    e = cfg.moe
    top_p, top_idx = _top_k(probs, e.top_k)
    pos = _queue_positions(top_idx, probs.shape[1])
    keep = pos < capacity
    eo = _one_hot(top_idx, probs.shape[1], torch.float32)   # (N, k, E)
    co = _one_hot(torch.where(keep, pos, capacity), capacity,
                  torch.float32)                            # (N, k, C), zeros if dropped
    dispatch = torch.einsum("nke,nkc->nec", eo, co)
    # the reference's einsum("nke,nkc,nk->nec"): one nonzero term per entry, so
    # folding top_p into eo first gives the same values without a (N, k, E, C)
    # intermediate
    combine = torch.einsum("nke,nkc->nec", eo * top_p[..., None], co)
    return dispatch, combine


def topk_scatter_dispatch(probs, cfg: ModelConfig, capacity: int):
    """Index-based dispatch: each (token, slot)'s capacity-buffer index, the
    same routing and drops as :func:`topk_dispatch`.

    Returns (slot (N, k) int64 in [0, E*C] where E*C = dropped, weights (N, k)).
    """
    e = cfg.moe
    n_exp = probs.shape[1]
    top_p, top_idx = _top_k(probs, e.top_k)
    pos = _queue_positions(top_idx, n_exp)
    keep = pos < capacity
    slot = torch.where(keep, top_idx * capacity + pos, n_exp * capacity)
    return slot, top_p


def _scatter_to_buffers(xf, slot, cfg: ModelConfig, capacity: int):
    """(N, d) tokens -> (E, C, d) expert buffers via scatter (trash row E*C:
    every dropped slot writes it, and it is discarded)."""
    e = cfg.moe
    n, d = xf.shape
    buf = xf.new_zeros((e.num_experts * capacity + 1, d))
    buf = buf.index_put((slot.reshape(-1),), xf.repeat_interleave(e.top_k, dim=0))
    return buf[:-1].reshape(e.num_experts, capacity, d)


def _gather_from_buffers(h, slot, weights, dtype):
    """(E, C, d) expert outputs -> (N, d) combined by routing weights (the
    dropped slots read a zero row)."""
    e_c, d = h.shape[0] * h.shape[1], h.shape[2]
    flat = torch.cat([h.reshape(e_c, d), h.new_zeros((1, d))], dim=0)
    n, k = slot.shape
    out = flat[slot.reshape(-1)].reshape(n, k, d)
    return (out * weights[..., None].to(dtype)).sum(dim=1)


def _group_sizes_from_dispatch(dispatch):
    """(N, E, C) dispatch tensor -> (E,) int32 real-row count per expert."""
    return dispatch.detach().sum(dim=(0, 2)).to(torch.int32)


def _group_sizes_from_slots(slot, num_experts: int, capacity: int):
    """(N, k) capacity-buffer indices -> (E,) int32 real-row count per expert.
    Valid because the dispatch assigns positions compactly per expert (rows
    [0, count) are exactly the filled ones)."""
    kept = slot < num_experts * capacity
    eo = _one_hot(torch.where(kept, slot // capacity, num_experts), num_experts + 1,
                  torch.int32)
    return eo.sum(dim=(0, 1))[:num_experts].to(torch.int32)


def _expert_ffn(w, h, dtype, impl: str = "auto", group_sizes=None):
    """h: (E, C, d) -> (E, C, d) through per-expert SwiGLU; all three GEMMs go
    through :func:`dispatch_expert_gemm` with ``group_sizes``."""
    from repro_torch.kernels.dispatch import dispatch_expert_gemm  # noqa: PLC0415 (import cycle)

    g = dispatch_expert_gemm(h, w["gate"].to(dtype), group_sizes, impl=impl)
    u = dispatch_expert_gemm(h, w["up"].to(dtype), group_sizes, impl=impl)
    return dispatch_expert_gemm(F.silu(g) * u, w["down"].to(dtype), group_sizes,
                                impl=impl)


def ep_chunk_ffn(w, h, *, dtype, impl: str = "auto"):
    """This rank's experts on one chunk of the expert-parallel exchange
    (``kernels.dispatch.dispatch_ep_a2a``): ``h`` (E_loc, C', d) ->
    (E_loc, C', d), :func:`_expert_ffn` without group sizes. Row-wise and
    shape-polymorphic in C', as the overlap ring needs; rows arrive blocked
    per source peer, so no prefix mask applies, and the zero padding rows
    drop out of the GEMMs numerically. Pass it as ``functools.partial(
    ep_chunk_ffn, dtype=..., impl=...)``."""
    return _expert_ffn(w, h, dtype, impl, None)


# ---------------------------------------------------------------------------
# dense-dispatch path

def moe_dense(p, x, cfg: ModelConfig, dtype, dispatch_mode: str = "einsum",
              gemm_impl: str = "auto", reduce=None, n_rep: int = 1):
    """x: (B, S, d) -> (out, aux_loss), all experts on this device, routing
    these tokens; ``reduce`` and ``n_rep`` complete the aux's statistics over
    the ranks holding the rest of the batch (:func:`router_probs`)."""
    e = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    n = b * s
    capacity = max(int(n * e.top_k / e.num_experts * e.capacity_factor), 1)

    probs, aux = router_probs(p, xf, cfg, dtype, reduce, n_rep)
    if dispatch_mode == "scatter":
        slot, wts = topk_scatter_dispatch(probs, cfg, capacity)
        gs = _group_sizes_from_slots(slot, e.num_experts, capacity)
        h = _scatter_to_buffers(xf, slot, cfg, capacity)
        h = _expert_ffn(p["experts"], h, dtype, gemm_impl, gs)
        out = _gather_from_buffers(h, slot, wts, dtype)
    else:
        dispatch, combine = topk_dispatch(probs, cfg, capacity)
        gs = _group_sizes_from_dispatch(dispatch)
        h = torch.einsum("nec,nd->ecd", dispatch.to(dtype), xf)
        h = _expert_ffn(p["experts"], h, dtype, gemm_impl, gs)
        out = torch.einsum("nec,ecd->nd", combine.to(dtype), h)

    if e.num_shared_experts:
        sh = F.silu(xf @ p["shared"]["gate"].to(dtype)) * (xf @ p["shared"]["up"].to(dtype))
        out = out + sh @ p["shared"]["down"].to(dtype)
    return out.reshape(b, s, d), aux


def moe_block(p, x, cfg: ModelConfig, dtype, plan=None, reduce=None, n_rep: int = 1):
    """The MoE sublayer on one device: :func:`moe_dense` under
    ``plan.moe_dispatch`` and ``plan.moe_gemm_impl``."""
    mode = plan.moe_dispatch if plan is not None else "einsum"
    gemm_impl = plan.moe_gemm_impl if plan is not None else "auto"
    return moe_dense(p, x, cfg, dtype, mode, gemm_impl, reduce, n_rep)
