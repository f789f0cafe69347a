"""Pipeline parallelism's single-process pieces (``repro_torch.train.pipeline``,
``core.sharding``'s stage layout, ``ParallelPlan``'s pp knobs), on the CPU.

- ``ParallelPlan`` pp / pp_layout / pp_schedule validation, case for case with
  the reference's (``tests/test_straggler.py:189-206``,
  ``tests/test_train_memory.py:110-116``), each case also run on the
  reference's plan;
- the tick bookkeeping of ``PipeSchedule``: which microbatch each stage
  forwards and back-propagates at each tick, and no slot of the 2P - 1 ring
  rewritten while its stage input waits, for P in {2, 3, 4} and M in {P, 2P,
  2P + 1};
- the stage layout's split and gather, even and uneven, with and without the
  TP cut, bit for bit;
- ``effective_layout`` on the port's plan; ``check_plan`` routing a
  ``pp_layout`` change as a reshard (``tests/test_straggler.py:372-393``);
- ``make_train_step`` refusing pp > 1, ``check_pp_support`` refusing the SSM,
  hybrid and encoder-decoder families, ``pipelined_loss_fn`` refusing ep-only
  x pp.
"""

import dataclasses
import types

import pytest
import torch

from repro_torch.core import Family, ModelConfig, ParallelPlan, get_smoke_config
from repro_torch.core.sharding import (gather_layout, layout_part, param_spec, pp_offsets,
                                       shard_layout)
from repro_torch.core.tree import named_leaves
from repro_torch.ft.straggler import effective_layout
from repro_torch.models import build_model
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.executor import check_pp_support
from repro_torch.train.pipeline import PipeSchedule, pipelined_loss_fn


def _cfg(n_layers=4):
    return ModelConfig("t", Family.DENSE, n_layers=n_layers, d_model=32, n_heads=2,
                       n_kv_heads=2, d_ff=64, vocab=64)


# ---------------------------------------------------------------------------
# the plan's validation, beside the reference's


# (plan kwargs, n_layers, the error's match or None for a valid plan)
PLAN_CASES = {
    "uneven": (dict(pp=2, microbatches=2, pp_layout=(3, 1)), 4, None),
    "even": (dict(pp=2, microbatches=2), 4, None),
    "layout-needs-pp": (dict(pp_layout=(4,)), 4, "pp_layout"),
    "layout-length": (dict(pp=2, microbatches=2, pp_layout=(4,)), 4, "pp_layout"),
    "layout-empty-stage": (dict(pp=2, microbatches=2, pp_layout=(4, 0)), 4, "pp_layout"),
    "layout-sum": (dict(pp=2, microbatches=2, pp_layout=(2, 3)), 4, "pp_layout"),
    "odd-split": (dict(pp=2, microbatches=2), 5, "pp_layout"),
    "schedule": (dict(pp_schedule="interleaved"), 4, "pp_schedule"),
    "gpipe": (dict(pp=2, microbatches=2, pp_schedule="gpipe"), 4, None),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_validation_matches_the_reference(case):
    from repro.core import Family as JFamily
    from repro.core import ModelConfig as JConfig
    from repro.core import ParallelPlan as JPlan
    kw, n_layers, match = PLAN_CASES[case]
    cfg = _cfg(n_layers)
    jcfg = JConfig("t", JFamily.DENSE, n_layers=n_layers, d_model=32, n_heads=2,
                   n_kv_heads=2, d_ff=64, vocab=64)
    for plan_cls, c in ((ParallelPlan, cfg), (JPlan, jcfg)):
        if match is None:
            plan_cls(**kw).validate(c)
        else:
            with pytest.raises(ValueError, match=match):
                plan_cls(**kw).validate(c)


def test_layout_normalises_to_a_tuple_and_microbatches_cover_the_stages():
    """A list layout is a tuple (hashable, JSON round trips compare equal);
    fewer microbatches than stages is refused (the reference's
    ``pipelined_loss_fn`` asserts it)."""
    assert ParallelPlan(pp=2, microbatches=2, pp_layout=[3, 1]).pp_layout == (3, 1)
    assert hash(ParallelPlan(pp=2, microbatches=2, pp_layout=[3, 1]))
    with pytest.raises(ValueError, match="microbatches"):
        ParallelPlan(pp=4, microbatches=2).validate(_cfg())


# ---------------------------------------------------------------------------
# the schedule's bookkeeping


SCHEDULES = [(p, m) for p in (2, 3, 4) for m in (p, 2 * p, 2 * p + 1)]


@pytest.mark.parametrize("pp,m", SCHEDULES, ids=lambda v: str(v))
def test_every_stage_forwards_and_backwards_each_microbatch_once(pp, m):
    """Stage p forwards microbatch t - p at tick t of the fill-drain (M + P - 1
    ticks) and back-propagates microbatch t - 2(P - 1) + p at tick t of the
    1F1B backward (M + 2(P - 1) ticks), each microbatch exactly once, in
    order; the last stage's backward of m comes the tick its recompute
    reaches it, and stage p's one tick after stage p + 1's."""
    s = PipeSchedule(pp, m)
    assert (s.fill_ticks, s.ticks, s.ring) == (m + pp - 1, m + 2 * (pp - 1), 2 * pp - 1)
    for stage in range(pp):
        fwd = [s.forward_mb(t, stage) for t in range(s.fill_ticks)]
        assert [x for x in fwd if x is not None] == list(range(m))
        assert fwd[stage:stage + m] == list(range(m))
        bwd = [s.backward_mb(t, stage) for t in range(s.ticks)]
        assert [x for x in bwd if x is not None] == list(range(m))
        for mb in range(m):
            t_b = bwd.index(mb)
            assert t_b == mb + 2 * (pp - 1) - stage
            if stage < pp - 1:
                # the cotangent comes from the next stage's tick before
                assert [s.backward_mb(t, stage + 1) for t in range(s.ticks)].index(mb) == t_b - 1
            else:
                assert t_b == mb + stage + (pp - 1 - stage) * 2


@pytest.mark.parametrize("pp,m", SCHEDULES, ids=lambda v: str(v))
def test_no_ring_slot_is_overwritten_while_live(pp, m):
    """The 1F1B backward stashes every tick's stage input in slot t mod (2P -
    1); the input of microbatch mb at stage p, stashed at tick mb + p, is
    still in its slot when its backward reads it at tick mb + 2(P - 1) - p."""
    s = PipeSchedule(pp, m)
    for stage in range(pp):
        ring = [None] * s.ring
        for t in range(s.ticks):
            ring[s.slot(t)] = ("stashed", t)
            mb = s.backward_mb(t, stage)
            if mb is not None:
                t_f = mb + stage
                assert s.forward_mb(t_f, stage) == mb
                assert ring[s.slot(t_f)] == ("stashed", t_f), (stage, t, mb)


# ---------------------------------------------------------------------------
# the stage layout


def _params(cfg):
    model = build_model(cfg, ParallelPlan(compute_dtype="float32"), device="cpu")
    return model.init(torch.Generator().manual_seed(0))


LAYOUTS = {"even": (None, 1), "uneven-3-1": ((3, 1), 1), "uneven-1-3": ((1, 3), 1),
           "even-tp2": (None, 2), "uneven-tp2": ((3, 1), 2)}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_stage_layout_split_and_gather_round_trip(case):
    """Every rank's part (``shard_layout``): its stage's layers, in order,
    cut to its TP shard; put back together (``gather_layout``) they are the
    whole tree bit for bit."""
    layout, tp = LAYOUTS[case]
    cfg = get_smoke_config("qwen1.5-4b")
    cfg = dataclasses.replace(cfg, n_layers=4)
    params = _params(cfg)
    plan = ParallelPlan(pp=2, microbatches=2, pp_layout=layout, tp=tp)
    sizes = {"model": tp, "cp": 1, "pod": 2}
    places = [{"model": m, "cp": 0, "pod": p} for p in range(2) for m in range(tp)]
    shards = [shard_layout(params, plan, place, sizes) for place in places]
    lay = layout or (2, 2)
    for place, shard in zip(places, shards):
        p = place["pod"]
        assert len(shard["layers"]) == lay[p]
        off = pp_offsets(lay)[p]
        for i, lp in enumerate(shard["layers"]):
            assert torch.equal(lp["norm1"]["scale"], params["layers"][off + i]["norm1"]["scale"])
        assert torch.equal(shard["final_norm"]["scale"], params["final_norm"]["scale"])
    back = gather_layout(shards, plan, sizes)
    want, got = dict(named_leaves(params)), dict(named_leaves(back))
    assert sorted(want) == sorted(got)
    for n, x in want.items():
        xs, ys = (x, got[n]) if isinstance(x, list) else ([x], [got[n]])
        assert len(xs) == len(ys) and all(torch.equal(a, b) for a, b in zip(xs, ys)), n


def test_param_spec_splits_the_layer_dim_over_pod():
    """The reference's ``P("pod")`` on the stacked layer dim, composed with the
    TP cut; the embedding and head stay whole over pod; an uneven layout's
    part of a stacked leaf is the stage's rows."""
    plan = ParallelPlan(pp=2, microbatches=2, tp=2)
    assert param_spec("layers/attn/wq", (4, 64, 64), plan) == ("pod", None, "model")
    assert param_spec("layers/norm1/scale", (4, 64), plan) == ("pod", None)
    assert param_spec("embed/tok", (128, 64), plan) == ("model", None)
    assert param_spec("final_norm/scale", (64,), ParallelPlan(pp=2, microbatches=2)) == (None,)
    uneven = ParallelPlan(pp=2, microbatches=2, pp_layout=(3, 1))
    rows = torch.arange(4.0)[:, None].expand(4, 3)
    sizes = {"model": 1, "cp": 1, "pod": 2}
    assert layout_part("layers/norm1/scale", rows, uneven, {"pod": 1}, sizes)[:, 0].tolist() == [3.0]
    assert layout_part("layers/norm1/scale", rows, uneven, {"pod": 0}, sizes)[:, 0].tolist() == \
        [0.0, 1.0, 2.0]


def test_effective_layout_on_the_port_plan():
    cfg = _cfg()
    assert effective_layout(ParallelPlan(), cfg) is None
    assert effective_layout(ParallelPlan(pp=2, microbatches=2), cfg) == (2, 2)
    assert effective_layout(ParallelPlan(pp=2, microbatches=2, pp_layout=(3, 1))) == (3, 1)
    assert effective_layout(None) is None


# ---------------------------------------------------------------------------
# checkpoint routing, refusals


def test_check_plan_routes_pp_layout_change_as_reshard(tmp_path):
    """The reference's case: a checkpoint saved under (2, 2) replays onto
    (2, 2), reshards onto (3, 1) (refused without elastic) and onto the
    implicit even layout; a schedule change replays."""
    from repro_torch.checkpoint import CheckpointManager
    cfg = _cfg()
    plan0 = ParallelPlan(remat="none", compute_dtype="float32")
    state = init_train_state(build_model(cfg, plan0, device="cpu"),
                             torch.Generator().manual_seed(0))
    even = ParallelPlan(pp=2, microbatches=2, pp_layout=(2, 2))
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(0, state, blocking=True, plan=even)
    man = ckpt.manifest(0)["plan"]
    assert (man["pp"], man["pp_layout"], man["pp_schedule"]) == (2, [2, 2], "1f1b")
    assert ckpt.check_plan(ParallelPlan(pp=2, microbatches=2, pp_layout=(2, 2)), step=0) == "replay"
    assert ckpt.check_plan(dataclasses.replace(even, pp_schedule="gpipe"), step=0) == "replay"
    skew = ParallelPlan(pp=2, microbatches=2, pp_layout=(3, 1))
    assert ckpt.check_plan(skew, step=0, elastic=True) == "reshard"
    with pytest.raises(ValueError, match="pp_layout"):
        ckpt.check_plan(skew, step=0, elastic=False)
    assert ckpt.check_plan(ParallelPlan(pp=2, microbatches=2), step=0, elastic=True) == "reshard"


def test_make_train_step_refuses_a_pipeline():
    cfg = _cfg()
    plan = ParallelPlan(pp=2, microbatches=2)
    model = build_model(cfg, ParallelPlan(), device="cpu")
    with pytest.raises(ValueError, match="pipelined_loss_fn"):
        make_train_step(model, plan)


@pytest.mark.parametrize("arch,ok", [("qwen1.5-4b", True), ("olmoe-1b-7b", True),
                                     ("pixtral-12b", True), ("mamba2-370m", False),
                                     ("zamba2-1.2b", False), ("whisper-small", False)])
def test_check_pp_support(arch, ok):
    """The decoder-only dense, VLM and MoE families pipeline; the SSM, hybrid
    and encoder-decoder families are refused."""
    cfg = get_smoke_config(arch)
    if ok:
        check_pp_support(cfg, 2)
    else:
        with pytest.raises(ValueError, match="pp=2"):
            check_pp_support(cfg, 2)


def test_ep_only_under_a_pipeline_is_refused():
    """ep with neither cp nor tp has no ring to fold onto inside a stage."""
    cfg = get_smoke_config("olmoe-1b-7b")
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 1, "model": 2})
    plan = ParallelPlan(pp=2, microbatches=2, ep=2)
    with pytest.raises(ValueError, match="ep-only"):
        pipelined_loss_fn(cfg, plan, mesh)
