"""Expert parallelism in one process: the ``ep`` knobs, the exchange's
dispatcher, the folded layout, ``ep_chunk_ffn`` and the placement, each held
to the reference (``tests/test_expert_parallel.py``'s units) on the same
inputs. The ranks themselves run in ``tests/test_torch_ep_ranks.py``."""

import functools
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import Family, ModelConfig, MoEConfig, ParallelPlan
from repro_torch.core.sharding import (ep_fold_axes, ep_spec_for_param, gather_layout,
                                       layout_part, param_spec, shard_layout)
from repro_torch.core.tree import named_leaves
from repro_torch.kernels.dispatch import EP_IMPLS, dispatch_ep_a2a, select_ep_impl
from repro_torch.launch.mesh import DataMesh, GridMesh
from repro_torch.models import moe as moe_lib
from repro_torch.train.executor import resolve_context


def _moe_cfg(e=4, k=2, cap=2.0, shared=0, layers=2):
    return ModelConfig("tmoe", Family.MOE, n_layers=layers, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=0, vocab=128,
                       moe=MoEConfig(num_experts=e, top_k=k, d_expert=64,
                                     num_shared_experts=shared, capacity_factor=cap))


# ---------------------------------------------------------------------------
# the knobs


def test_ep_knob_validation():
    """The reference test's cases (``test_ep_knob_validation``) but its GSPMD
    and ``dp_over_model`` ones, which the port has no knob for (its
    ``tp_impl="gspmd"`` raises whatever ``ep`` is)."""
    cfg = _moe_cfg()
    with pytest.raises(ValueError, match="ep_impl"):
        ParallelPlan(ep_impl="ring").validate(cfg)
    for legacy in (True, False):
        with pytest.raises(ValueError, match="use ep=<degree>"):
            ParallelPlan(ep=legacy).validate(cfg)
    with pytest.raises(ValueError, match="ep must be"):
        ParallelPlan(ep=0).validate(cfg)
    with pytest.raises(ValueError, match="MoE"):
        ParallelPlan(ep=2).validate(ModelConfig("t", Family.DENSE, 2, 64, 4, 2, 128, 128))
    with pytest.raises(NotImplementedError, match="gspmd"):
        ParallelPlan(ep=2, tp=2, tp_impl="gspmd").validate(cfg)
    with pytest.raises(ValueError, match="must equal cp×tp"):
        ParallelPlan(ep=2, cp=2, tp=2, tp_impl="overlap").validate(cfg)
    ParallelPlan(ep=4, cp=2, tp=2, tp_impl="overlap").validate(cfg)
    ParallelPlan(ep=2, cp=2).validate(cfg)
    ParallelPlan(ep=2, tp=2).validate(cfg)
    with pytest.raises(ValueError, match="must divide num_experts"):
        ParallelPlan(ep=3).validate(_moe_cfg(e=4))
    ParallelPlan(ep=2).validate(cfg)
    for impl in EP_IMPLS:
        ParallelPlan(ep=2, ep_impl=impl).validate(cfg)


def test_ep_knobs_take_the_reference_names_and_defaults():
    from repro.core import ParallelPlan as RefPlan
    for knob in ("ep", "ep_impl"):
        assert getattr(ParallelPlan(), knob) == getattr(RefPlan(), knob)


def test_ep_token_dropping_divergence_is_flagged():
    """Shard-local routing under a token-dropping capacity warns at
    validation; a no-drop capacity (>= E / top_k) does not."""
    with pytest.warns(UserWarning, match="token-dropping"):
        ParallelPlan(ep=2).validate(_moe_cfg(cap=1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ParallelPlan(ep=2).validate(_moe_cfg(cap=2.0))


# ---------------------------------------------------------------------------
# the dispatcher


@pytest.mark.parametrize("impl", ["auto", "blocking", "overlap", "bogus"])
def test_select_ep_impl_matches_the_reference(impl):
    from repro.kernels.dispatch import select_ep_impl as ref
    assert EP_IMPLS == ("auto", "blocking", "overlap")
    if impl == "bogus":
        for fn in (ref, select_ep_impl):
            with pytest.raises(ValueError, match="ep_impl"):
                fn(impl)
        return
    assert select_ep_impl(impl) == ref(impl)


def test_dispatch_ep_a2a_degenerate_cases():
    """One rank runs ``fn`` on the whole buffer; an expert dim the ring does
    not divide and an unknown mode raise before any collective."""
    w = {"w": torch.ones(4, 8, 8)}
    h = torch.ones(4, 3, 8)
    fn = lambda w_, h_: h_ + 1.0                        # noqa: E731
    for ring in (None, types.SimpleNamespace(size=1, rank=0)):
        assert torch.equal(dispatch_ep_a2a(fn, w, h, ring=ring), h + 1.0)
    with pytest.raises(ValueError, match="divide"):
        dispatch_ep_a2a(fn, w, h, ring=types.SimpleNamespace(size=3, rank=0))
    with pytest.raises(ValueError, match="ep_impl"):
        dispatch_ep_a2a(fn, w, h, ring=types.SimpleNamespace(size=2, rank=0), impl="nope")


# ---------------------------------------------------------------------------
# the folded layout


PLANS = [ParallelPlan(), ParallelPlan(ep=2), ParallelPlan(ep=2, cp=2),
         ParallelPlan(ep=4, cp=2, tp=2), ParallelPlan(ep=2, tp=2)]
PATHS = [(("layers", "moe", "experts", "gate"), (2, 4, 64, 64)),
         (("moe", "experts", "down"), (4, 64, 64)),
         (("layers", "moe", "shared", "gate"), (2, 64, 64)),
         (("layers", "moe", "router"), (2, 64, 4)),
         (("layers", "attn", "wq"), (2, 64, 64)),
         (("embed", "tok"), (128, 64))]


def _ref_plan(plan):
    from repro.core import ParallelPlan as RefPlan
    return RefPlan(ep=plan.ep, cp=plan.cp, tp=plan.tp,
                   tp_impl="overlap" if plan.tp > 1 else "auto")


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: f"ep{p.ep}cp{p.cp}tp{p.tp}")
def test_ep_fold_layout_matches_the_reference(plan):
    """``ep_fold_axes`` and ``ep_spec_for_param`` against the reference's on
    every leaf kind (its PartitionSpec as a tuple of names)."""
    from repro.core.sharding import ep_fold_axes as ref_axes, ep_spec_for_param as ref_spec
    assert ep_fold_axes(plan) == ref_axes(_ref_plan(plan))
    for path, shape in PATHS:
        want = ref_spec(path, shape, _ref_plan(plan))
        got = ep_spec_for_param(path, shape, plan)
        assert got == (None if want is None else tuple(want)), (path, got, want)


@pytest.mark.parametrize("plan,sizes", [
    (ParallelPlan(ep=2), {"model": 2, "cp": 1}),
    (ParallelPlan(ep=4, cp=2, tp=2), {"model": 2, "cp": 2}),
    (ParallelPlan(ep=2, cp=2), {"model": 1, "cp": 2}),
    (ParallelPlan(tp=2), {"model": 2, "cp": 1})], ids=["ep-only", "folded", "cp-fold", "tp"])
def test_shard_and_gather_layout_round_trip(plan, sizes):
    """Every rank's parts (``shard_layout``) put back together
    (``gather_layout``) are the whole tree bit for bit; a routed expert leaf
    is cut into ep contiguous blocks at full d_expert width in the fold's
    (cp, model) row-major order, the shared experts and the router whole."""
    from repro_torch.models import build_model
    cfg = _moe_cfg(shared=1)
    params = build_model(cfg, ParallelPlan(compute_dtype="float32"), device="cpu").init(
        torch.Generator().manual_seed(0))
    places = [{"model": m, "cp": c} for c in range(sizes["cp"]) for m in range(sizes["model"])]
    shards = [shard_layout(params, plan, p, sizes) for p in places]
    back = gather_layout(shards, plan, sizes)
    whole = dict(named_leaves(params))
    for name, leaf in named_leaves(back):
        ref = whole[name]
        for a, b in zip(leaf if isinstance(leaf, list) else [leaf],
                        ref if isinstance(ref, list) else [ref]):
            assert torch.equal(a, b), name
    gate = torch.stack(whole["layers/moe/experts/gate"])
    n_ep = max(plan.ep, 1)
    for i, (p, s) in enumerate(zip(places, shards)):
        got = torch.stack(dict(named_leaves(s))["layers/moe/experts/gate"])
        if plan.ep > 1:
            k = cfg.moe.num_experts // n_ep
            assert torch.equal(got, gate[:, i * k:(i + 1) * k])
            shared = dict(named_leaves(s))["layers/moe/shared/gate"]
            assert torch.equal(torch.stack(shared), torch.stack(whole["layers/moe/shared/gate"]))
        assert torch.equal(got, layout_part("layers/moe/experts/gate", gate, plan, p, sizes))


def test_param_spec_overrides_the_tp_cut_of_the_experts():
    """Under a folded tp the EP spec replaces the overlap layout's d_expert
    cut; the attention keeps its TP cut; ep-only leaves it whole."""
    folded = ParallelPlan(ep=4, cp=2, tp=2)
    assert param_spec("layers/moe/experts/up", (2, 4, 64, 64), folded) == \
        (None, ("cp", "model"), None, None)
    assert param_spec("layers/moe/experts/up", (2, 4, 64, 64), ParallelPlan(tp=2)) == \
        (None, None, None, "model")
    assert param_spec("layers/moe/shared/up", (2, 64, 64), folded) == (None, None, None)
    assert param_spec("layers/attn/wq", (2, 64, 64), folded) == (None, None, "model")
    assert param_spec("layers/attn/wq", (2, 64, 64), ParallelPlan(ep=2)) == (None, None, None)


# ---------------------------------------------------------------------------
# ep_chunk_ffn


def test_ep_chunk_ffn_matches_the_reference():
    """One chunk of a rank's experts, and its grads, against the reference's
    ``ep_chunk_ffn`` (plain GEMMs on both sides) on the same weights and
    rows, zero padding rows included."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import ep_chunk_ffn as ref_fn
    rng = np.random.default_rng(0)
    w = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
         for k, s in (("gate", (2, 64, 32)), ("up", (2, 64, 32)), ("down", (2, 32, 64)))}
    h = rng.standard_normal((2, 10, 64)).astype(np.float32)
    h[:, 7:] = 0.0
    dy = rng.standard_normal((2, 10, 64)).astype(np.float32)
    fn = functools.partial(ref_fn, dtype=jnp.float32, impl="xla")
    want, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, w), jnp.asarray(h))
    dw_want, dh_want = vjp(jnp.asarray(dy))
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    th = torch.from_numpy(h).requires_grad_()
    got = moe_lib.ep_chunk_ffn(tw, th, dtype=torch.float32, impl="plain")
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_want), rtol=1e-5, atol=1e-6)
    for k in w:
        np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(dw_want[k]),
                                   rtol=1e-5, atol=1e-6)
    assert np.all(got.detach().numpy()[:, 7:] == 0.0)


# ---------------------------------------------------------------------------
# the placement


def _ring(size, axis):
    return types.SimpleNamespace(size=size, rank=0, axis=axis)


def _grid(model, cp=1):
    m, c = _ring(model, "model"), (_ring(cp, "cp") if cp > 1 else None)
    fold = _ring(model * cp, ("cp", "model")) if cp > 1 and model > 1 else None
    return GridMesh(DataMesh(), m, "cpu", cp=c, ep=fold)


class _RefMesh:
    def __init__(self, shape):
        self.shape = shape


def test_ep_dispatch_routing_matches_the_reference():
    """``resolve_context`` folds the expert ring onto the resolved placement
    as the reference's does (``test_ep_dispatch_routing``): ep-only rides
    the model axis with attention as a cp ring over it; folded, the grid's
    expert ring over cp × model; a fold-size mismatch and an ep-only plan
    on a model axis of another size raise."""
    from repro import core as jcore
    from repro.train.executor import resolve_context as ref_resolve
    cfg = _moe_cfg(cap=2.0)
    RefPlan = jcore.ParallelPlan
    ref_cfg = jcore.ModelConfig("tmoe", jcore.Family.MOE, n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=0, vocab=128,
                                moe=jcore.MoEConfig(num_experts=4, top_k=2, d_expert=64,
                                                    capacity_factor=2.0))
    cases = [(ParallelPlan(ep=2), RefPlan(ep=2), _grid(2), {"data": 1, "model": 2}),
             (ParallelPlan(ep=4, cp=2, tp=2, ep_impl="blocking"),
              RefPlan(ep=4, cp=2, tp=2, tp_impl="overlap", ep_impl="blocking"),
              _grid(2, 2), {"data": 1, "cp": 2, "model": 2})]
    for plan, ref_plan, grid, shape in cases:
        ctx = resolve_context(cfg, plan, grid)
        ref = ref_resolve(ref_cfg, ref_plan, _RefMesh(shape), ("data",))
        assert (ctx.ep.size, ctx.ep.axis, ctx.ep_impl, ctx.n_rep) == \
            (ref.ep.size, ref.ep.axis, ref.ep_impl, ref.n_rep)
        assert (ctx.n_tp, ctx.n_cp, ctx.cp.axis) == (ref.n_tp, ref.n_cp, ref.cp.axis)
        assert ctx.ep is grid.ep
    assert resolve_context(cfg, ParallelPlan(ep=2), _grid(2)).cp is not None
    with pytest.raises(ValueError, match="folded"):
        resolve_context(cfg, ParallelPlan(ep=2, cp=2, tp=2), _grid(2, 2))
    with pytest.raises(ValueError, match="model"):
        resolve_context(cfg, ParallelPlan(ep=4), _grid(2))


def test_train_step_routes_ep():
    """An ep plan with no grid to fold onto raises (the reference's
    ``test_train_step_routes_ep``), as does a plan with tp 1 on a model axis
    that does not ask for the ep ring."""
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_train_step
    cfg = _moe_cfg()
    plan = ParallelPlan(ep=2, compute_dtype="float32")
    model = build_model(cfg, plan, device="cpu")
    with pytest.raises(ValueError, match="ep"):
        make_train_step(model, plan, Hyper(), mesh=None)
    with pytest.raises(ValueError, match="plan.tp"):
        resolve_context(cfg, ParallelPlan(), _grid(2))


def test_executor_takes_moe_under_a_data_mesh():
    """MoE under a data axis alone routes each rank's rows: the context holds
    the data group, whose aux sum completes the statistics (n_rep the data
    ranks); a dense model keeps its single-device placement there."""
    mesh = types.SimpleNamespace(shape={"data": 2}, size=2, rank=0)
    ctx = resolve_context(_moe_cfg(), ParallelPlan(), mesh)
    assert ctx.data is mesh and ctx.n_rep == 2 and not ctx.is_local
    dense = ModelConfig("t", Family.DENSE, 2, 64, 4, 2, 128, 128)
    assert resolve_context(dense, ParallelPlan(), mesh).is_local
