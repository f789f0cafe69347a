"""ZeRO-3 / FSDP and the dp_over_model remap, in one process: the port's
placement (``repro_torch.core.sharding.fsdp_specs``) against the reference's
``param_specs`` under ``dp_shard`` > 1 on every leaf of the ten registered
configs at full size, on a data mesh of 2, 4 and 8 and under
``dp_over_model`` (shape only: the reference's params as ``jax.eval_shape``
gives them and the shape-only mesh of ``tests/test_sharding.py``); the
moments on the params' slices; the plan's fields and validation against the
reference's; ``batch_axes_for`` against the reference's rule; and each
rank's parts tiling every leaf. The steps themselves run on gloo ranks in
``tests/test_torch_fsdp_ranks.py``."""

import dataclasses
import types

import jax
import pytest
import torch

from repro.core import ARCH_IDS, ParallelPlan, get_config, get_smoke_config
from repro.core.sharding import opt_state_specs as ref_opt_state_specs
from repro.core.sharding import param_specs
from repro.launch.mesh import batch_axes_for as ref_batch_axes_for
from repro.models import build_model
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.core.sharding import (bytes_per_device, fsdp_cut, fsdp_part, fsdp_specs,
                                       local_index, opt_state_specs, rank_stack,
                                       train_state_specs)
from repro_torch.core.tree import named_leaves
from repro_torch.launch import batch_axes_for
from repro_torch.models import build_model as torch_build_model
from repro_torch.train import Hyper, init_train_state, make_train_step

torch.set_num_threads(1)

DATA = (2, 4, 8)
REMAP = ((1, 2), (2, 2), (2, 4))          # (data, model) grids under dp_over_model


class FakeMesh:
    """Shape-only stand-in (rules consult mesh.shape only)."""
    def __init__(self, **shape):
        self.shape = shape


def _ref_shapes(arch):
    cfg = get_config(arch)
    return cfg, jax.eval_shape(build_model(cfg, ParallelPlan()).init, jax.random.PRNGKey(0))


def _flat(specs, shapes):
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return dict(zip([n for n, _ in named_leaves(shapes)], leaves))


def _data_dim(spec, axes):
    """The dim a reference spec puts the data domain ``axes`` on (None)."""
    want = axes[0] if len(axes) == 1 else tuple(axes)
    for i, ax in enumerate(spec):
        if ax == want or (isinstance(ax, tuple) and tuple(ax) == tuple(axes)):
            return i
    return None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_dims_match_the_reference(arch):
    """Every leaf's ZeRO-3 dim at dp 2/4/8 and under the remap on (data,
    model) grids is the reference's; under the remap no leaf splits on
    ``model`` alone; the moments follow the params whatever the ZeRO stage
    (the reference's "already data-sharded" case)."""
    cfg, shapes = _ref_shapes(arch)
    cases = [(FakeMesh(data=n), ("data",), n, False) for n in DATA]
    cases += [(FakeMesh(data=d, model=m), ("data", "model"), d * m, True) for d, m in REMAP]
    for mesh, axes, n, remap in cases:
        plan = ParallelPlan(dp_shard=2, dp_over_model=remap)
        ref = _flat(param_specs(shapes, cfg, plan, mesh), shapes)
        ours = fsdp_specs(shapes, n)
        assert {k: s.dim for k, s in ours.items()} == {
            k: _data_dim(sp, axes) for k, sp in ref.items()}, (arch, mesh.shape)
        assert all("model" not in [a for a in sp if isinstance(a, str)] for sp in ref.values())
        for stage in (0, 1):
            ref_o = _flat(ref_opt_state_specs(param_specs(shapes, cfg, dataclasses.replace(
                plan, zero_stage=stage), mesh), shapes, plan, mesh), shapes)
            got = opt_state_specs(shapes, types.SimpleNamespace(shape={"data": n}),
                                  TorchPlan(dp_shard=2, zero_stage=stage))
            assert {k: s.dim for k, s in got.items()} == {
                k: _data_dim(sp, axes) for k, sp in ref_o.items()}, (arch, stage)


def test_parallel_plan_fields_match_the_reference():
    """The port's plan names the reference's fields, field for field, and the
    four that A13.6 and A13.7 added take the reference's defaults."""
    ours = {f.name: f.default for f in dataclasses.fields(TorchPlan)}
    ref = {f.name: f.default for f in dataclasses.fields(ParallelPlan)}
    assert set(ours) == set(ref)
    for name in ("seq_shard_decode", "seq_shard_attn", "dp_shard", "dp_over_model"):
        assert ours[name] == ref[name], name


@pytest.mark.parametrize("kw, match", [
    (dict(cp=2, dp_over_model=True), "dp_over_model"),
    (dict(ep=2, dp_over_model=True), "dp_over_model"),
    (dict(dp_shard=2, tp=2), "dp_shard"),
    (dict(dp_shard=2, cp=2), "dp_shard"),
    (dict(dp_shard=2, ep=2), "dp_shard"),
    (dict(dp_shard=2, pp=2, microbatches=2), "dp_shard"),
    (dict(dp_shard=0), "dp_shard"),
])
def test_validation_refuses(kw, match):
    """The reference's refusals (cp or ep with the remap, which its own
    validate raises too) and the port's ZeRO-3 scope: data parallelism
    alone, as the reference's executor loss requires."""
    cfg = torch_smoke_config("olmoe-1b-7b")
    with pytest.raises(ValueError, match=match):
        TorchPlan(**kw).validate(cfg)
    if "dp_over_model" in kw:
        with pytest.raises(ValueError, match="dp_over_model"):
            ParallelPlan(**kw).validate(get_smoke_config("olmoe-1b-7b"))


def test_validation_accepts_data_parallel_zero3():
    cfg = torch_smoke_config("qwen1.5-4b")
    for kw in (dict(dp_shard=2), dict(dp_shard=4, zero_stage=0),
               dict(dp_shard=2, dp_over_model=True), dict(dp_over_model=True)):
        TorchPlan(**kw).validate(cfg)


@pytest.mark.parametrize("shape", [{"data": 2}, {"data": 4}, {"data": 2, "model": 2},
                                   {"pod": 2, "data": 2, "model": 2}, {"data": 8, "model": 2}])
def test_batch_axes_follow_the_reference(shape):
    mesh = FakeMesh(**shape)
    for rows in (1, 2, 3, 4, 6, 8, 16, 32):
        for pp in (1, 2):
            for remap in (False, True):
                assert batch_axes_for(mesh, rows, pp, remap) == \
                    ref_batch_axes_for(mesh, rows, pp, remap), (rows, pp, remap)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "whisper-small", "mamba2-370m-1head"])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_parts_tile_each_leaf(arch, n):
    """Every rank's ZeRO-3 parts (``fsdp_cut``), placed at their global
    index, rebuild each whole leaf once; a leaf split on the layer dim gives
    its owner the layer whole and the others an empty placeholder; the state
    specs and ``bytes_per_device`` count the parts a rank holds."""
    cfg = torch_smoke_config(arch.removesuffix("-1head"))
    if arch.endswith("-1head"):
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=cfg.ssm.expand * cfg.d_model))
    whole = torch_build_model(cfg, TorchPlan(), device="cpu").init(
        torch.Generator().manual_seed(0))
    specs = fsdp_specs(whole, n)
    owner_split = set()
    seen = {name: torch.zeros(s.shape) for name, s in specs.items()}
    for r in range(n):
        parts = dict(named_leaves(fsdp_cut(whole, r, n)))
        for name, leaf in named_leaves(whole):
            spec = specs[name]
            ref = torch.stack(leaf) if isinstance(leaf, list) else leaf
            held = rank_stack(parts[name], spec, r, n)
            got = torch.stack(held) if isinstance(leaf, list) else held[0]
            box = tuple(slice(lo, hi) for lo, hi in local_index(spec, r, n))
            assert torch.equal(got, ref[box]), name
            seen[name][box] += 1
            if spec.dim == 0 and isinstance(leaf, list):
                owner_split.add(name)
                assert all(fsdp_part(t).owner == i // (len(leaf) // n)
                           for i, t in enumerate(parts[name]))
                assert sum(t.numel() for t in parts[name]) == ref.numel() // n
    for name, s in specs.items():
        assert bool((seen[name] == (n if s.dim is None else 1)).all()), name
    assert bool(owner_split) == (arch == "mamba2-370m-1head" and n == 2)
    mesh = types.SimpleNamespace(shape={"data": n}, size=n, rank=n - 1)
    plan = TorchPlan(dp_shard=2)
    model = torch_build_model(cfg, plan, device="cpu", mesh=mesh)
    state = init_train_state(model, torch.Generator().manual_seed(0), mesh, plan)
    st = train_state_specs(state, mesh, plan)
    params = {k[7:]: v for k, v in st.items() if k.startswith("params/")}
    assert params == fsdp_specs(whole, n)
    held = sum(t.numel() * t.element_size() for _, leaf in named_leaves(state.params)
               for t in (leaf if isinstance(leaf, list) else [leaf]))
    assert bytes_per_device(params, mesh) == held
    assert bytes_per_device(params, None) == sum(
        t.numel() * t.element_size() for _, leaf in named_leaves(whole)
        for t in (leaf if isinstance(leaf, list) else [leaf]))


def test_train_step_needs_the_model_on_the_mesh():
    """ZeRO-3's gather lives in the model's forward: a model built without
    the step's mesh is refused, not run on parts it cannot gather."""
    cfg = torch_smoke_config("qwen1.5-4b")
    plan = TorchPlan(dp_shard=2)
    mesh = types.SimpleNamespace(shape={"data": 2}, size=2, rank=0)
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(torch_build_model(cfg, plan, device="cpu"), plan, Hyper(), mesh=mesh)
    make_train_step(torch_build_model(cfg, plan, device="cpu", mesh=mesh), plan, Hyper(),
                    mesh=mesh)
