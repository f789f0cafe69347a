"""AdamW over the port's param trees (port of ``repro/optim/adamw.py``).

Moments are fp32 whatever the param dtype. :func:`adamw_update` updates the
params and the moments **in place** under ``torch.no_grad()`` (the reference
returns new trees): at full width the params, grads and both moments are
already 63 GB in fp32, and a second copy of any of them would not fit on one
card. The ZeRO-1 ``adamw_update_sharded`` comes with the data-parallel slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import leaves, map_tree


class AdamWState(NamedTuple):
    step: int                # updates taken so far
    mu: Any                  # first moment, same tree as params
    nu: Any                  # second moment


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(step=0, mu=map_tree(zeros, params), nu=map_tree(zeros, params))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One decoupled-decay AdamW step, in place: writes ``params``, ``state.mu``
    and ``state.nu`` and returns (params, the state with ``step + 1``). No
    weight decay on params with ndim <= 1 (norm scales, biases). ``lr`` is a
    Python float. At most two fp32 temporaries of one leaf's size are live."""
    step = state.step + 1
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    for g, m, v, p in zip(leaves(grads), leaves(state.mu), leaves(state.nu),
                          leaves(params)):
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
    return params, AdamWState(step, state.mu, state.nu)
