"""The port's ZeRO-1 layout rule (``repro_torch.core.sharding``) against the
reference's ``opt_state_specs`` on every leaf of the ten registered configs,
at full and smoke size, on a data mesh of 2, 4 and 8, shape only: the
reference's params as ``jax.eval_shape`` gives them (stacked layers) and the
shape-only mesh of ``tests/test_sharding.py``."""

import jax
import pytest
import torch

from repro.core import ARCH_IDS, ParallelPlan, get_config, get_smoke_config
from repro.core.sharding import opt_state_specs as ref_opt_state_specs
from repro.core.sharding import param_specs
from repro.models import build_model
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.core.sharding import (LeafSpec, bytes_per_device, local_index, local_shape,
                                       opt_state_specs, rank_views, train_state_specs)
from repro_torch.core.tree import named_leaves, stacked_shape
from repro_torch.models import build_model as torch_build_model
from repro_torch.train import init_train_state

torch.set_num_threads(1)

DATA = (2, 4, 8)


class FakeMesh:
    """Shape-only stand-in (rules consult mesh.shape only)."""
    def __init__(self, **shape):
        self.shape = shape


def _ref_shapes(arch, size):
    cfg = (get_config if size == "full" else get_smoke_config)(arch)
    model = build_model(cfg, ParallelPlan())
    return cfg, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _ref_dims(cfg, shapes, n):
    """{name: the dim the reference's rule puts "data" on, or None}."""
    mesh = FakeMesh(data=n)
    plan = ParallelPlan()
    specs = ref_opt_state_specs(param_specs(shapes, cfg, plan, mesh), shapes, plan, mesh)
    flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    names = [n for n, _ in named_leaves(shapes)]
    return {name: next((i for i, ax in enumerate(spec) if ax == "data"), None)
            for name, spec in zip(names, flat)}


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_dims_match_the_reference(arch, size):
    cfg, shapes = _ref_shapes(arch, size)
    for n in DATA:
        ours = opt_state_specs(shapes, FakeMesh(data=n), TorchPlan())
        assert {k: s.dim for k, s in ours.items()} == _ref_dims(cfg, shapes, n), n
        assert {k: s.shape for k, s in ours.items()} == {
            k: tuple(x.shape) for k, x in named_leaves(shapes)}
        assert all(s.dim is None for s in opt_state_specs(
            shapes, FakeMesh(data=n), TorchPlan(zero_stage=0)).values())


def test_whole_layers_split_only_for_mamba2_at_full_size():
    """The rule picks the stacked layer dim (whole layers to ranks) only where
    the layer count is the largest dim the data axis divides: mamba2-370m's
    (48, 32) A_log, D and dt_bias at dp 2, 4 and 8; no smoke config
    (the module docstring of repro_torch/core/sharding.py)."""
    found = set()
    for arch in ARCH_IDS:
        for size in ("full", "smoke"):
            _, shapes = _ref_shapes(arch, size)
            for n in DATA:
                for name, s in opt_state_specs(shapes, FakeMesh(data=n), TorchPlan()).items():
                    if s.dim == 0 and "layers" in name.split("/"):
                        found.add((arch, size, n, name))
    assert found == {("mamba2-370m", "full", n, f"layers/ssm/{k}")
                     for n in DATA for k in ("A_log", "D", "dt_bias")}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "whisper-small", "zamba2-1.2b"])
def test_port_tree_stacks_to_the_reference_shapes(arch):
    """The port's per-layer tree, stacked, has the reference's names and
    shapes, so the rule sees the same leaves in both packages."""
    _, shapes = _ref_shapes(arch, "smoke")
    model = torch_build_model(torch_smoke_config(arch), TorchPlan(), device="cpu")
    ours = {n: stacked_shape(x) for n, x in named_leaves(model.init(torch.Generator()))}
    assert ours == {n: tuple(x.shape) for n, x in named_leaves(shapes)}


def test_rank_slices_tile_each_leaf():
    """Every rank's views and moment slice, over the ranks, cover each leaf
    once: a stacked leaf split inside its layers, one split on the layer dim,
    one kept whole, and a leaf that is not a layer list."""
    n = 4
    layers = [torch.arange(24.).reshape(4, 6) + 100 * i for i in range(8)]
    for spec, leaf in ((LeafSpec((8, 4, 6), 1, torch.float32), layers),
                       (LeafSpec((8, 4, 6), 0, torch.float32), layers),
                       (LeafSpec((8, 4, 6), None, torch.float32), layers),
                       (LeafSpec((4, 6), 0, torch.float32), layers[0])):
        whole = torch.stack(leaf) if isinstance(leaf, list) else leaf
        seen = torch.zeros_like(whole)
        for r in range(n):
            index = tuple(slice(lo, hi) for lo, hi in local_index(spec, r, n))
            assert tuple(whole[index].shape) == local_shape(spec, n)
            moment = torch.empty(local_shape(spec, n))
            for view, i in rank_views(leaf, spec, r, n):
                (moment if i is None else moment[i]).copy_(view)
            assert torch.equal(moment, whole[index])
            seen[index] += 1
        assert bool((seen == (n if spec.dim is None else 1)).all())


def test_bytes_per_device_halves_the_moments():
    cfg = torch_smoke_config("whisper-small")
    model = torch_build_model(cfg, TorchPlan(), device="cpu")
    mesh = type("RankMesh", (), {"shape": {"data": 2}, "size": 2, "rank": 1})()
    state = init_train_state(model, torch.Generator().manual_seed(0), mesh, TorchPlan())
    specs = train_state_specs(state, mesh, TorchPlan())
    moments = {k: s for k, s in specs.items() if k.startswith("opt/mu/")}
    held = sum(t.numel() * 4 for _, t in named_leaves(state.opt.mu))
    assert bytes_per_device(moments, mesh) == held == bytes_per_device(moments, None) // 2
    assert all(tuple(t.shape) == local_shape(specs[f"opt/mu/{k}"], 2)
               for k, t in named_leaves(state.opt.mu))
