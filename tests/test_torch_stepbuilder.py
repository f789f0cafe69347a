"""The step builder and the data feed (``repro_torch.launch.stepbuilder``,
``repro_torch.configs.input_specs``, ``repro_torch.data.Prefetcher``)
against the reference's, in one process:

- ``resolve_config`` and ``skip_reason`` case for case over the ten arches
  and four shapes;
- ``input_specs`` (train, prefill, decode) on the ten full configs: shapes
  and dtypes of the reference's ``ShapeDtypeStruct``s, every tensor on the
  meta device;
- ``build_step``'s placements on shape-only meshes against the reference's
  rule for each leaf: ``param_specs`` under ``dp_shard``,
  ``overlap_param_specs`` under tp, ``ep_spec_for_param`` under ep,
  ``opt_state_specs`` (ZeRO-1 and ZeRO-3) and ``cache_specs`` under
  ``seq_shard_decode`` (the SSM state and conv tails kept whole, queue C);
- the train, prefill and decode fns on smoke configs against the reference's
  ``build_step`` fns on a one-device mesh of Auto axes (the reference's fns
  refuse an Explicit-axis mesh at ``with_sharding_constraint``), with the
  same converted weights and batch: loss, grad norm and logits to 1e-5
  relative in fp32;
- the ``Prefetcher``'s batches bit-identical to the reference's dataset,
  with a jump back, and its thread gone after ``close()``."""

import dataclasses
import enum
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import input_specs as ref_input_specs
from repro.core import ARCH_IDS, SHAPES_BY_NAME, InputShape, ParallelPlan
from repro.core.sharding import ep_spec_for_param, overlap_param_specs, param_specs
from repro.core.sharding import cache_specs as ref_cache_specs
from repro.core.sharding import opt_state_specs as ref_opt_state_specs
from repro.data import SyntheticDataset
from repro.launch.stepbuilder import build_step as ref_build_step
from repro.launch.stepbuilder import resolve_config as ref_resolve_config
from repro.launch.stepbuilder import skip_reason as ref_skip_reason
from repro.models import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.train import TrainState as RefTrainState
from repro_torch.configs import input_specs
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core.sharding import opt_shard_dim
from repro_torch.core.tree import leaves, named_leaves
from repro_torch.data import Prefetcher
from repro_torch.data import SyntheticDataset as TorchDataset
from repro_torch.interop import params_from_numpy
from repro_torch.launch import build_step, resolve_config, skip_reason, stepbuilder
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState

torch.set_num_threads(1)

REL = 1e-5                       # fp32 on both sides: the frameworks sum in other orders
SMOKE_ARCHS = {"dense": "qwen1.5-4b", "moe": "deepseek-moe-16b", "ssm": "mamba2-370m",
               "encdec": "whisper-small"}
SMOKE_SHAPE = InputShape("t", 16, 4, "train")
DECODE_STEPS, MAX_SEQ = 2, 8
SSM_TAILS = {"state", "conv_x", "conv_B", "conv_C"}


class FakeMesh:
    """Shape-only stand-in (rules consult mesh.shape; build_step reads rank)."""
    def __init__(self, **shape):
        self.shape = shape
        self.rank = 0


@pytest.fixture(autouse=True, scope="module")
def _one_meta_init_per_config():
    """The placement tests build many steps of the same configs; a full
    config's meta init takes ~1 s here, and its result depends only on the
    config and the plan's param dtype and vocab padding. Each such
    combination is drawn once, by the real ``meta_params``."""
    real, seen = stepbuilder.meta_params, {}

    def once(model):
        key = (model.cfg, model.plan.param_dtype, model.plan.pad_vocab_to_multiple)
        if key not in seen:
            seen[key] = real(model)
        return seen[key]
    stepbuilder.meta_params = once
    yield
    stepbuilder.meta_params = real


def _fields(cfg):
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_config_and_skip_reason_match_the_reference(arch):
    for shape in SHAPES_BY_NAME.values():
        for smoke in (False, True):
            ref = ref_resolve_config(arch, shape.name, smoke)
            ours = resolve_config(arch, shape.name, smoke)
            assert _fields(ours) == _fields(ref), (shape.name, smoke)
            assert skip_reason(ours, shape) == ref_skip_reason(ref, shape), shape.name
            if skip_reason(ours, shape):
                with pytest.raises(ValueError, match="long_500k"):
                    build_step(arch, shape.name, FakeMesh(data=1), TorchPlan(), smoke)


def _same_spec(t, sds):
    return (tuple(t.shape) == tuple(sds.shape)
            and str(t.dtype).removeprefix("torch.") == np.dtype(sds.dtype).name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference_and_allocate_nothing(arch):
    """Train, prefill and decode specs of every shape the arch runs: the
    reference's shapes and dtypes, the decode cache leaf for leaf; every
    tensor on the meta device."""
    ref_model = ref_build_model(ref_resolve_config(arch, "train_4k"), ParallelPlan())
    for shape in SHAPES_BY_NAME.values():
        ref_cfg, cfg = ref_resolve_config(arch, shape.name), resolve_config(arch, shape.name)
        if skip_reason(cfg, shape):
            continue
        model = build_model(cfg, TorchPlan(), device="meta")
        ref_model = ref_build_model(ref_cfg, ParallelPlan())
        ours = input_specs(cfg, shape, model)
        ref = jax.eval_shape(lambda: ref_input_specs(ref_cfg, shape, ref_model)) \
            if shape.kind == "decode" else ref_input_specs(ref_cfg, shape)
        assert set(ours) == set(ref), shape.name
        ours_l, ref_l = named_leaves(ours), named_leaves(ref)
        assert [n for n, _ in ours_l] == [n for n, _ in ref_l], shape.name
        for (name, t), (_, sds) in zip(ours_l, ref_l):
            assert t.device.type == "meta", name
            assert _same_spec(t, sds), (shape.name, name, tuple(t.shape), t.dtype, sds)


# ---------------------------------------------------------------------------
# placements on shape-only meshes


def _ref_shapes(arch, shape_name="train_4k", plan=None):
    cfg = ref_resolve_config(arch, shape_name)
    model = ref_build_model(cfg, plan or ParallelPlan())
    return cfg, model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _flat(specs, shapes):
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return dict(zip([n for n, _ in named_leaves(shapes)], flat))


def _norm(spec):
    """A spec's entries with a one-axis tuple written as its axis, and no
    trailing Nones (as ``PartitionSpec`` normalises them)."""
    out = [(e[0] if len(e) == 1 else tuple(e)) if isinstance(e, (tuple, list)) else e
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _data_dim(spec):
    return next((i for i, ax in enumerate(spec) if ax == "data"), None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_data_placements_match_the_reference(arch):
    """On a data mesh of 4: under ZeRO-1 every param whole and each moment on
    the reference's ``opt_state_specs`` dim; under ``dp_shard`` each param on
    the reference's ``param_specs`` data dim, the moments on the same."""
    cfg, _, shapes = _ref_shapes(arch)
    mesh = FakeMesh(data=4)
    for dp_shard in (1, 2):
        plan = ParallelPlan(dp_shard=dp_shard)
        _, args, placement, meta = build_step(arch, "train_4k", mesh, TorchPlan(
            dp_shard=dp_shard))
        state, batch = placement
        pspecs = _flat(param_specs(shapes, cfg, plan, mesh), shapes)
        ospecs = _flat(ref_opt_state_specs(param_specs(shapes, cfg, plan, mesh), shapes, plan,
                                           mesh), shapes)
        assert set(state.params) == set(pspecs) == set(state.opt.mu)
        for name, ref in pspecs.items():
            if dp_shard == 1:
                assert _norm(state.params[name]) == _norm(tuple(ref)) == (), name
            else:
                assert state.params[name].dim == _data_dim(ref), name
            assert state.opt.mu[name].dim == state.opt.nu[name].dim == _data_dim(
                ospecs[name]), (name, dp_shard)
        assert meta["batch_axes"] == ("data",)
        assert all(_norm(s) == ("data",) for s in batch.values())
        with pytest.raises(RuntimeError, match="stand-in"):
            build_step(arch, "train_4k", mesh, TorchPlan())[0](*args)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_placement_matches_the_reference(arch):
    """On a (data 2, model 2) mesh under tp 2: every param on the reference's
    ``overlap_param_specs``. The moments: ``opt_state_specs`` on each rank's
    TP shard over its data group, what the port's step runs. The reference's
    ``opt_state_specs`` takes the largest dim the model axis leaves free,
    judged on the whole leaf; the port's rule judges the shard and may take
    the dim the model axis splits (ROADMAP queue C): every leaf is on the
    reference's dim or on that one."""
    cfg, _, shapes = _ref_shapes(arch)
    mesh, plan = FakeMesh(data=2, model=2), ParallelPlan(tp=2)
    _, _, (state, _), _ = build_step(arch, "train_4k", mesh, TorchPlan(tp=2))
    ref = _flat(overlap_param_specs(shapes, cfg, plan, mesh), shapes)
    ref_opt = _flat(ref_opt_state_specs(overlap_param_specs(shapes, cfg, plan, mesh), shapes,
                                        plan, mesh), shapes)
    assert set(state.params) == set(ref) == set(state.opt.mu)
    split_again = 0
    for name, leaf in named_leaves(shapes):
        spec = state.params[name]
        assert _norm(spec) == _norm(tuple(ref[name])), name
        tp = spec.index("model") if "model" in spec else None
        shard = tuple(n // 2 if d == tp else n for d, n in enumerate(leaf.shape))
        mu = state.opt.mu[name]
        assert mu.shape == shard and mu.dim == opt_shard_dim(shard, 2), name
        if mu.dim != _data_dim(ref_opt[name]):
            assert mu.dim == tp, name
            split_again += 1
    assert split_again > 0        # the difference is real on every registered config


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b"])
@pytest.mark.parametrize("grid, kw", [({"data": 1, "model": 2}, dict(ep=2)),
                                      ({"data": 1, "cp": 2, "model": 2},
                                       dict(ep=4, cp=2, tp=2))])
def test_ep_placement_matches_the_reference(arch, grid, kw):
    """Under ep (the ep-only placement, and ep folded over cp x model with
    tp): the routed experts on the reference's ``ep_spec_for_param``, the
    shared experts and the router whole, every other leaf on the overlap
    layout where tp is on and whole where it is not."""
    cfg, _, shapes = _ref_shapes(arch)
    plan, mesh = ParallelPlan(**kw), FakeMesh(**grid)
    _, _, (state, _), _ = build_step(arch, "train_4k", mesh, TorchPlan(**kw))
    overlap = _flat(overlap_param_specs(shapes, cfg, plan, mesh), shapes)
    for name, leaf in named_leaves(shapes):
        ep = ep_spec_for_param(tuple(name.split("/")), tuple(leaf.shape), plan)
        want = ep if ep is not None else (overlap[name] if plan.tp > 1
                                          else (None,) * len(leaf.shape))
        assert _norm(state.params[name]) == _norm(tuple(want)), name


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma2-9b", "whisper-small", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_cache_placement_matches_the_reference(arch):
    """decode_32k on a (data 2, model 2) mesh under ``seq_shard_decode``: the
    K/V and cross caches on the reference's ``cache_specs``; the SSM
    ``state`` and ``conv_*`` tails, which the reference splits over the model
    axis, whole on every model rank (the port serves the SSM step whole
    there: ROADMAP queue C), their batch dim as the reference's."""
    plan, mesh = ParallelPlan(seq_shard_decode=True), FakeMesh(data=2, model=2)
    _, args, placement, meta = build_step(arch, "decode_32k", mesh,
                                          TorchPlan(seq_shard_decode=True))
    ref_model = ref_build_model(ref_resolve_config(arch, "decode_32k"), plan)
    shape = SHAPES_BY_NAME["decode_32k"]
    cache = jax.eval_shape(lambda: ref_model.init_cache(shape.global_batch, shape.seq_len))
    ref = _flat(ref_cache_specs(cache, plan, mesh, meta["batch_axes"]), cache)
    cspecs = placement[1]
    assert set(cspecs) == set(ref)
    tails = 0
    for name, spec in cspecs.items():
        if name.split("/")[-1] in SSM_TAILS:
            tails += 1
            assert "model" in tuple(ref[name]) and "model" not in spec, name
            assert _norm(spec[:2]) == _norm(tuple(ref[name])[:2]), name
        else:
            assert _norm(spec) == _norm(tuple(ref[name])), name
    assert tails == (0 if arch in ("qwen1.5-4b", "gemma2-9b", "whisper-small") else 4)
    assert _norm(placement[2]) == ("data",) and placement[3] == ()
    assert all(t.device.type == "meta" for t in leaves(args[:2]))


def test_build_step_refuses_pp():
    with pytest.raises(ValueError, match="pipeline"):
        build_step("qwen1.5-4b", "train_4k", FakeMesh(pod=2, data=1),
                   TorchPlan(pp=2, microbatches=2), smoke=True)


# ---------------------------------------------------------------------------
# the fns against the reference's build_step fns


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours.detach().double().numpy() if torch.is_tensor(ours) else ours,
                      np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _setup(arch, shape_name):
    """Both builders' (fn, meta) for ``shape_name`` at the smoke config, fp32,
    the reference's params (seed 0) and the port's converted copy."""
    plan = dict(compute_dtype="float32", remat="none")
    rfn, _, _, rmeta = ref_build_step(arch, shape_name, _auto_mesh(), ParallelPlan(**plan),
                                      smoke=True)
    fn, _, _, meta = build_step(arch, shape_name, None, TorchPlan(**plan), smoke=True,
                                device="cpu")
    rparams = rmeta["model"].init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), meta["cfg"], device="cpu")
    batch = SyntheticDataset(rmeta["cfg"], SMOKE_SHAPE).batch(0)
    return rfn, rmeta, rparams, fn, meta, params, batch


@pytest.mark.parametrize("family", list(SMOKE_ARCHS))
def test_train_fn_matches_the_reference(family):
    rfn, _, rparams, fn, _, params, batch = _setup(SMOKE_ARCHS[family], "train_4k")
    _, rm = jax.jit(rfn)(RefTrainState(rparams, ref_adamw_init(rparams)),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    for p in leaves(params):
        p.requires_grad_(True)
    _, m = fn(TrainState(params, adamw_init(params)),
              {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert _rel(m[key], rm[key]) <= REL, (key, float(m[key]), float(rm[key]))


@pytest.mark.parametrize("family", list(SMOKE_ARCHS))
def test_prefill_fn_matches_the_reference(family):
    rfn, _, rparams, fn, _, params, batch = _setup(SMOKE_ARCHS[family], "prefill_32k")
    del batch["labels"]
    ref = jax.jit(rfn)(rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    ours = fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert ours.shape == ref.shape and not ours.requires_grad
    assert _rel(ours, ref) <= REL


@pytest.mark.parametrize("family", list(SMOKE_ARCHS))
def test_decode_fn_matches_the_reference(family):
    """DECODE_STEPS steps from an empty cache (whisper's cross keys and
    values filled from the same frames by both models first)."""
    rfn, rmeta, rparams, fn, meta, params, batch = _setup(SMOKE_ARCHS[family], "decode_32k")
    b = SMOKE_SHAPE.global_batch
    rcache = rmeta["model"].init_cache(b, MAX_SEQ)
    cache = meta["model"].init_cache(b, MAX_SEQ)
    if family == "encdec":
        rcache = rmeta["model"].extras["fill_cross"](rparams, rcache, jnp.asarray(batch["frames"]))
        cache = meta["model"].fill_cross(params, cache, torch.from_numpy(batch["frames"]))
    rstep = jax.jit(rfn)
    for pos in range(DECODE_STEPS):
        tokens = batch["tokens"][:, pos]
        ref, rcache = rstep(rparams, rcache, jnp.asarray(tokens), jnp.int32(pos))
        ours, cache = fn(params, cache, torch.from_numpy(tokens), torch.tensor(pos))
        assert _rel(ours, ref) <= REL, pos


# ---------------------------------------------------------------------------
# the data feed


def test_prefetcher_batches_match_the_reference_and_its_thread_ends():
    """Steps 0-5, then a rollback to 2 and on to 4: every batch bit-identical
    to the reference dataset's for its step; the prefetch thread is gone
    after ``close()`` (and after the context manager's exit)."""
    arch = "whisper-small"
    shape = InputShape("t", 24, 3, "train")
    ref = SyntheticDataset(ref_resolve_config(arch, "train_4k", True), shape, seed=5)
    ds = TorchDataset(resolve_config(arch, "train_4k", True), shape, seed=5)

    def threads():
        return {t for t in threading.enumerate() if t.name.startswith("data-prefetch")}
    before = threads()
    steps = [0, 1, 2, 3, 4, 5, 2, 3, 4]
    pf = Prefetcher(ds, lookahead=2)
    for s in steps:
        got, want = pf.batch(s), ref.batch(s)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (s, k)
    assert threads() - before
    pf.close()
    assert not threads() - before
    with Prefetcher(ds) as pf:
        for s in (7, 8, 7):
            assert np.array_equal(pf.batch(s)["tokens"], ref.batch(s)["tokens"])
    assert not threads() - before
