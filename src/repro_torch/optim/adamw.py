"""AdamW over the port's param trees (port of ``repro/optim/adamw.py``).

Moments are fp32 whatever the param dtype. :func:`adamw_update` updates the
params and the moments **in place** under ``torch.no_grad()`` (the reference
returns new trees): at full width the params, grads and both moments are
already 63 GB in fp32, and a second copy of any of them would not fit on one
card.

:func:`adamw_update_sharded` is ZeRO-1 (survey §6.2.1): the same math on this
data rank's slice of the grads, the moments and the params, then an
all-gather of the updated slices into the full params every rank holds. Under
a mesh the moments are held per leaf **as the reference stacks it**: one
tensor per name (a ``layers`` list as (L, ...)) holding this rank's slice
(``core/sharding.py``), so a moment split on the layer dim is one tensor too.
Those trees flatten to the same names as the per-layer ones, so a checkpoint
reads the same either way.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.sharding import (LeafSpec, dim_first, local_shape, rank_stack,
                                       rank_views)
from repro_torch.core.tree import from_names, leaves, map_tree, named_leaves


class AdamWState(NamedTuple):
    step: int                # updates taken so far
    mu: Any                  # first moment: the params' tree, or by name under a mesh
    nu: Any                  # second moment


def adamw_init(params: Any, *, mesh=None,
               specs: Optional[Dict[str, LeafSpec]] = None) -> AdamWState:
    """Zero fp32 moments. With ``mesh`` and ``specs``
    (``core.sharding.opt_state_specs``) they are born on the ZeRO-1 layout:
    by name, each this rank's slice of the stacked leaf."""
    if mesh is None:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamWState(step=0, mu=map_tree(zeros, params), nu=map_tree(zeros, params))
    device = leaves(params)[0].device

    def moments():
        return from_names({n: torch.zeros(local_shape(s, mesh.size), dtype=torch.float32,
                                          device=device) for n, s in specs.items()})
    return AdamWState(step=0, mu=moments(), nu=moments())


def _update(g, m, v, p, lr, c1, c2, b1, b2, eps, weight_decay):
    """One leaf's (or one slice's) AdamW update, in place. No weight decay on
    params with ndim <= 1 (norm scales, biases), judged on the per-layer
    tensor. At most two fp32 temporaries of its size are live."""
    g = g.float()
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    delta = (m / c1).div_((v / c2).sqrt_().add_(eps))
    if p.dim() > 1:
        delta.add_(p.float(), alpha=weight_decay)
    if p.dtype == torch.float32:
        p.add_(delta, alpha=-lr)
    else:
        p.copy_(p.float() - lr * delta)


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One decoupled-decay AdamW step, in place: writes ``params``, ``state.mu``
    and ``state.nu`` and returns (params, the state with ``step + 1``).
    ``lr`` is a Python float."""
    step = state.step + 1
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    for g, m, v, p in zip(leaves(grads), leaves(state.mu), leaves(state.nu),
                          leaves(params)):
        _update(g, m, v, p, lr, c1, c2, b1, b2, eps, weight_decay)
    return params, AdamWState(step, state.mu, state.nu)


@torch.no_grad()
def adamw_update_sharded(grads: Any, state: AdamWState, params: Any, lr, *, mesh,
                         specs: Dict[str, LeafSpec], b1: float = 0.9, b2: float = 0.95,
                         eps: float = 1e-8, weight_decay: float = 0.1,
                         sharded_params: bool = False):
    """ZeRO-1 AdamW (the reference's ``adamw_update_sharded``). ``grads`` and
    the moments are by name, this rank's slices (``train.step`` reduce-scatters
    the grads onto them); ``params`` is the full per-layer tree every rank
    holds. Each rank updates its slice of each param in place, then the slices
    are all-gathered back into the full params, in place. A leaf the layout
    keeps whole (``spec.dim`` None) has its full grad on every rank and is
    updated whole, the same on each. Returns (params, the state with
    ``step + 1``).

    ``sharded_params`` is ZeRO-3: ``params`` holds this rank's parts of the
    split leaves (``core.sharding.fsdp_cut``), which are updated in place as
    they are, with no all-gather."""
    step = state.step + 1
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    g_by, m_by, v_by = (dict(named_leaves(t)) for t in (grads, state.mu, state.nu))
    n, r = mesh.size, mesh.rank
    for name, leaf in named_leaves(params):
        spec = specs[name]
        g, m, v = g_by[name], m_by[name], v_by[name]
        if tuple(m.shape) != local_shape(spec, n):
            raise ValueError(f"{name}: moment {tuple(m.shape)} is not this rank's slice "
                             f"{local_shape(spec, n)} of {spec.shape}")
        if sharded_params and spec.dim is not None:
            held = rank_stack(leaf, spec, r, n)
            views = ([(p, i) for i, p in enumerate(held)] if isinstance(leaf, list)
                     else [(leaf, None)])
        else:
            views = rank_views(leaf, spec, r, n)
        for p, i in views:
            _update(*(t if i is None else t[i] for t in (g, m, v)), p, lr, c1, c2, b1, b2,
                    eps, weight_decay)
        if spec.dim is not None and not sharded_params:
            _gather_params(leaf, views, spec, mesh)
    return params, AdamWState(step, state.mu, state.nu)


def _gather_params(leaf, views, spec: LeafSpec, mesh) -> None:
    """Every rank's updated slice of ``leaf`` gathered into the full tensors:
    this rank's slices copied into a buffer with the split dim first, one
    all-gather, and the result copied back into each layer's tensor."""
    first = views[0][0]
    buf, nat = dim_first(local_shape(spec, mesh.size), spec.dim, first.dtype, first.device)
    for p, i in views:
        (nat if i is None else nat[i]).copy_(p)
    full = mesh.all_gather(buf).movedim(0, spec.dim)
    if isinstance(leaf, list):
        for i, p in enumerate(leaf):
            p.copy_(full[i])
    else:
        leaf.copy_(full)
