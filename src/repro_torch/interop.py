"""Parameter exchange with the JAX reference package, through numpy.

The reference's params are a pytree of nested dicts whose ``layers`` leaves
(and, for the encoder-decoder, ``encoder.layers``) carry a leading L dim
(stacked for ``lax.scan``). The port keeps the same leaf
names and the same (in, out) orientation, with ``layers`` as a list of
per-layer dicts, so a conversion is renames-free: unstack (or stack) the
layers and move the arrays. No transposes.

The caller turns a JAX tree into numpy itself
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
:func:`tp_params_from_numpy` carries a whole JAX tree onto one model rank of a
tensor-parallel grid: its TP shards (``core.sharding.shard_params``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device, resolve_dtype
from repro_torch.core.sharding import shard_params
from repro_torch.models.ssm import FP32_LEAVES


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _keeps_fp32(path) -> bool:
    """Norm scales, and the SSM leaves read in fp32 (``models.ssm.FP32_LEAVES``:
    ``dt_bias``, ``A_log``, ``D`` and the gated-norm ``scale``)."""
    if len(path) < 2:
        return False
    if path[-2] == "ssm":
        return path[-1] in FP32_LEAVES
    return path[-1] == "scale" and "norm" in path[-2]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *, device=None,
                      dtype="float32") -> Dict[str, Any]:
    """Reference params (nested dicts of numpy arrays) -> the port's params.

    Matrices, biases, embeddings and conv taps go to ``dtype`` (the model's
    compute dtype: the reference casts its fp32 masters to it at every use, so
    holding them cast gives the same bits); norm scales and the SSM leaves the
    reference reads in fp32 stay fp32.
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def leaf(path, a):
        t = torch.tensor(np.asarray(a))    # a copy: the numpy array may be read-only
        return t.to(device=device,
                    dtype=torch.float32 if _keeps_fp32(path) else dtype)

    return _unstack_layers(tree, {(): cfg.n_layers, ("encoder",): cfg.enc_layers}, leaf)


def tp_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, rank: int, tp: int, *,
                         device=None, dtype="float32") -> Dict[str, Any]:
    """Reference params (whole, as numpy) -> model rank ``rank``'s TP shards of
    the port's params over ``tp`` model ranks: :func:`params_from_numpy`,
    then the reference's overlap layout cut (``core.sharding.shard_params``)."""
    return shard_params(params_from_numpy(tree, cfg, device=device, dtype=dtype), rank, tp)


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's params -> the reference layout (layers stacked on a leading
    L dim). Arrays come back as fp32 numpy (numpy has no bfloat16)."""
    def leaf(path, t):
        return t.detach().to("cpu", torch.float32).numpy()

    return _stack_layers(params, {(): cfg.n_layers, ("encoder",): cfg.enc_layers}, leaf)


def _unstack_layers(tree, counts, leaf, path=()):
    """``tree`` with each stacked ``layers`` subtree (at the paths of
    ``counts``, with the layer count each must have) turned into a list of
    per-layer dicts, and ``leaf(path, array)`` applied to every array."""
    out = {}
    for k, v in tree.items():
        if k == "layers" and path in counts:
            n = {a.shape[0] for a in _flatten(v)}
            if n != {counts[path]}:
                raise ValueError(f"stacked layer dims {sorted(n)} at {path + (k,)} != "
                                 f"{counts[path]} ({'n_layers' if not path else 'enc_layers'})")
            out[k] = [_map(v, lambda p, a, i=i: leaf(p, a[i]), path + (k,))
                      for i in range(counts[path])]
        elif isinstance(v, dict):
            out[k] = _unstack_layers(v, counts, leaf, path + (k,))
        else:
            out[k] = leaf(path + (k,), v)
    return out


def _stack_layers(params, counts, leaf, path=()):
    """The inverse of :func:`_unstack_layers`: per-layer lists stacked on a
    leading L dim after ``leaf(path, tensor)``."""
    out = {}
    for k, v in params.items():
        if k == "layers" and path in counts:
            if len(v) != counts[path]:
                raise ValueError(f"{len(v)} layers at {path + (k,)} != {counts[path]} "
                                 f"({'n_layers' if not path else 'enc_layers'})")
            per_layer = [_map(lp, leaf) for lp in v]
            out[k] = _map(per_layer[0], lambda p, _: np.stack(
                [_get(lp, p) for lp in per_layer]))
        elif isinstance(v, dict):
            out[k] = _stack_layers(v, counts, leaf, path + (k,))
        else:
            out[k] = leaf(path + (k,), v)
    return out


def _flatten(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _flatten(v)]
    return [tree]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
