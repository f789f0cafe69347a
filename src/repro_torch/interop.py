"""Parameter exchange with the JAX reference package, through numpy.

The reference's params are a pytree of nested dicts whose ``layers`` leaves
carry a leading L dim (stacked for ``lax.scan``). The port keeps the same leaf
names and the same (in, out) orientation, with ``layers`` as a list of
per-layer dicts, so a conversion is renames-free: unstack (or stack) the
layers and move the arrays. No transposes.

The caller turns a JAX tree into numpy itself
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device, resolve_dtype


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _is_norm_scale(path) -> bool:
    return len(path) >= 2 and path[-1] == "scale" and "norm" in path[-2]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *, device=None,
                      dtype="float32") -> Dict[str, Any]:
    """Reference params (nested dicts of numpy arrays) -> the port's params.

    Matrices, biases and embeddings go to ``dtype`` (the model's compute
    dtype: the reference casts its fp32 masters to it at every use, so
    holding them cast gives the same bits); norm scales stay fp32.
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def leaf(path, a):
        t = torch.tensor(np.asarray(a))    # a copy: the numpy array may be read-only
        return t.to(device=device,
                    dtype=torch.float32 if _is_norm_scale(path) else dtype)

    stacked = tree["layers"]
    n = {a.shape[0] for a in _flatten(stacked)}
    if n != {cfg.n_layers}:
        raise ValueError(f"stacked layer dims {sorted(n)} != n_layers {cfg.n_layers}")
    out = {k: _map(v, leaf, (k,)) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(stacked, lambda p, a, i=i: leaf(p, a[i]), ("layers",))
                     for i in range(cfg.n_layers)]
    return out


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's params -> the reference layout (layers stacked on a leading
    L dim). Arrays come back as fp32 numpy (numpy has no bfloat16)."""
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params['layers'])} layers != n_layers {cfg.n_layers}")

    def leaf(path, t):
        return t.detach().to("cpu", torch.float32).numpy()

    out = {k: _map(v, leaf) for k, v in params.items() if k != "layers"}
    per_layer = [_map(lp, leaf) for lp in params["layers"]]
    out["layers"] = _map(per_layer[0], lambda path, _: np.stack(
        [_get(lp, path) for lp in per_layer]))
    return out


def _flatten(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _flatten(v)]
    return [tree]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
