"""Expert parallelism and MoE under data parallelism on spawned ranks: gloo
CPU processes on (data, cp, model) grids (``launch.mesh.init_grid_mesh``),
each grid's group on a ``file://`` store under ``tmp_path``, as in
``tests/test_torch_cp_ranks.py``.

- The port's EP loss and grads against the reference's
  ``make_executor_loss_fn`` on the same weights and batch (the reference
  test's tiny configs, ``z_loss=1e-4``, 8 x 16 tokens, capacity factor 2.0:
  no drops): olmoe-like routed experts, deepseek-like with a shared expert,
  and the latter in the scatter dispatch, ep-only on (1, 2) and (2, 2) and
  folded (ep 4 = cp 2 x tp 2) on (1, 2, 2), each in the blocking and the
  overlap mode, at the reference test's tolerances
  (``tests/test_expert_parallel.py:210-240``: loss 2e-6, grads rtol 1e-4 /
  atol 1e-6, 3e-6 folded). MoE under data parallelism on (2, 1) against the
  reference's one-device loss, which it equals when nothing drops. The
  reference runs in a forced-host-device subprocess
  (``tests/conftest.py::run_multidevice``).
- The same runs against the port's own single process, by chip_smoke.py's
  grads rule (``grid_grad_failures``), the loss to 1e-6; the overlap ring's
  grads against the blocking path's.
- A control that must fail the rule: each chunk's expert output rounded to
  bf16 before the combine (``chip_smoke.ep_bf16_rounding``).
- ``make_train_step``: ep-only on (1, 2) in both modes and MoE under data
  parallelism on (2, 1) with 1 and 2 microbatches, one step against one
  process by ``GRID_TOLERANCE``.
- A checkpoint saved at ep 2, restored at ep 2 (replay), at ep 1 and at ep 4
  folded (reshard), bit for bit; ``check_plan`` refuses an ep change and
  takes an ``ep_impl`` change.
- The ``ep.a2a.tick`` fault seam armed with nan reaches the loss.
"""

import contextlib
import dataclasses
import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
Z_LOSS = 1e-4
REL = 1e-6
# world size -> its grids (data, cp, model), run one after another
WORLD_GRIDS = {2: [(1, 1, 2), (2, 1, 1)], 4: [(2, 1, 2), (1, 2, 2)]}
EP_GRIDS = [(1, 1, 2), (2, 1, 2), (1, 2, 2)]
IMPLS = ("blocking", "overlap")
# loss case -> (reference family, dispatch mode)
LOSS_CASES = {"olmoe": ("olmoe", "einsum"), "deepseek": ("deepseek", "einsum"),
              "deepseek-scatter": ("deepseek", "scatter")}
DP_GRID = (2, 1, 1)

# the reference's one-device loss and grads, and its executor's under ep on
# every grid of EP_GRIDS, on its weights and batch, pickled to argv[1]
REF_SCRIPT = """
import sys, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.core import Family, InputShape, ModelConfig, MoEConfig, ParallelPlan
from repro.checkpoint.store import _flatten_with_names
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.train import Hyper, make_loss_fn
from repro.train.executor import make_executor_loss_fn
CASES = %r
GRIDS = %r
Z = %r
CFGS = {
 "olmoe": 'ModelConfig("tmoe", Family.MOE, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, '
          'd_ff=0, vocab=128, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, '
          'capacity_factor=2.0))',
 "deepseek": 'ModelConfig("tmoe", Family.MOE, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, '
             'd_ff=0, vocab=128, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, '
             'num_shared_experts=1, capacity_factor=2.0))',
}
named = lambda g: {n: np.asarray(a) for n, a in _flatten_with_names(g)}
res = {}
for fam, cfg_s in CFGS.items():
    cfg = eval(cfg_s)
    batch = {k: np.asarray(v) for k, v in
             SyntheticDataset(cfg, InputShape("t", 16, 8, "train")).batch(0).items()}
    plan0 = ParallelPlan(remat="none", compute_dtype="float32")
    params = build_model(cfg, plan0).init(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lf = make_loss_fn(build_model(cfg, plan0), Hyper(z_loss=Z))
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: lf(p, b)[0]))(params, jb)
    res[fam] = {"cfg": cfg_s, "params": jax.tree.map(np.asarray, params), "batch": batch,
                "one": {"loss": float(loss), "grads": named(grads)}}
    for case, (f, mode) in CASES.items():
        if f != fam:
            continue
        for d, c, m in GRIDS:
            ms = (d, m) if c == 1 else (d, c, m)
            mesh = jax.make_mesh(ms, ("data", "model") if c == 1 else ("data", "cp", "model"))
            plan = ParallelPlan(remat="none", compute_dtype="float32", ep=c * m,
                                moe_dispatch=mode, cp=c, tp=m if c > 1 else 1,
                                tp_impl="overlap" if c > 1 else "auto", cp_impl="ring")
            elf = make_executor_loss_fn(cfg, plan, mesh, ("data",), z_loss=Z)
            loss, grads = jax.jit(jax.value_and_grad(lambda p, b: elf(p, b)[0]))(params, jb)
            res[case, (d, c, m)] = {"loss": float(loss), "grads": named(grads)}
pickle.dump(res, open(sys.argv[1], "wb"))
""" % ({k: v for k, v in LOSS_CASES.items()}, EP_GRIDS, Z_LOSS)


def _smoke():
    """chip_smoke.py, whose grid checks these tests share."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def _cfg(cfg_s):
    from repro_torch.core import Family, ModelConfig, MoEConfig  # noqa: F401
    return eval(cfg_s)


def _stacked(tree):
    from repro_torch.core.tree import named_leaves
    return {n: (torch.stack([t.detach() for t in x]) if isinstance(x, list) else x.detach())
            .numpy().copy() for n, x in named_leaves(tree)}


def _plan(grid, impl="overlap", mode="einsum", **kw):
    """The plan a grid (data, cp, model) runs: ep-only where cp is 1, folded
    (ep = cp x tp) otherwise; MoE under data parallelism (ep 1) where model
    is 1."""
    from repro_torch.core import ParallelPlan
    d, c, m = grid
    ep = c * m
    return ParallelPlan(remat=kw.pop("remat", "none"), compute_dtype="float32", ep=ep,
                        ep_impl=impl, moe_dispatch=mode, cp=c, tp=m if c > 1 else 1,
                        cp_impl="ring", **kw)


def _places(grid):
    """Every rank's ``grid_place`` index of one data index, in rank order."""
    _, c, m = grid
    return [{"model": j, "cp": i} for i in range(c) for j in range(m)]


def _sizes(grid):
    return {"model": grid[2], "cp": grid[1]}


# ---------------------------------------------------------------------------
# what each rank runs


def _loss(grid, ref, plan, faults=None):
    """The port's executor loss on this rank's part of the reference's
    weights (``shard_layout``) and its rows of the batch, backward, the grads
    finished as the step finishes them (``sum_grid_grads``), every grad and
    the loss meaned over the data ranks. Returns the loss and this rank's
    grads (stacked)."""
    from repro_torch.core.sharding import grid_place, shard_layout
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.ft import inject
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import rank_microbatches
    from repro_torch.train.executor import make_executor_loss_fn, resolve_context
    from repro_torch.train.step import sum_grid_grads
    cfg = _cfg(ref["cfg"])
    params = shard_layout(params_from_numpy(ref["params"], cfg, device="cpu"), plan,
                          *grid_place(grid))
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    mb = rank_microbatches(batch, grid.data, 1)[0]
    with inject.armed(faults or []):
        total, _ = make_executor_loss_fn(cfg, plan, grid, z_loss=Z_LOSS)(params, mb)
        total.backward()
    sum_grid_grads(params, plan, resolve_context(cfg, plan, grid))
    for p in leaves(params):
        grid.data.all_reduce_mean(p.grad)
    loss = grid.data.all_reduce_mean(total.detach().clone())
    return {"loss": float(loss), "grads": _stacked(map_tree(lambda p: p.grad, params))}


def _step_setup(grid, impl="overlap", microbatches=1):
    """deepseek-moe-16b's smoke config at a no-drop capacity (2.0 = E /
    top_k), remat "full", and the grid's plan."""
    from repro_torch.core import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))
    plan = _plan(grid, impl, remat="full", microbatches=microbatches)
    return plan, build_model(cfg, plan, device="cpu")


def _step_batches(n=2):
    from repro_torch.core import InputShape, get_smoke_config
    from repro_torch.data import SyntheticDataset
    ds = SyntheticDataset(get_smoke_config("deepseek-moe-16b"), InputShape("t", 16, 4, "train"))
    return [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(n)]


def _hyper():
    from repro_torch import train as ttrain
    return ttrain.Hyper(peak_lr=1e-3, warmup_steps=2)


def _step(grid, impl="overlap", microbatches=1):
    """chip_smoke's ``zero1_run`` on the grid: one step from seed 0, watched
    (the ZeRO-1 update held to adamw_update on the same grads)."""
    g = (grid.shape["data"], grid.shape.get("cp", 1), grid.shape["model"])
    plan, model = _step_setup(g, impl, microbatches)
    watch = SMOKE.ZeroWatch(steps=1, shadow=True)
    _, _, out = SMOKE.zero1_run(model, plan, _step_batches()[:1], grid, watch=watch,
                                hyper=_hyper())
    return {**out, "shadow_err": watch.shadow_err}


def _ckpt(grid, out_dir):
    """A train state after one step saved at ep 2 (ep-only), routed and
    restored at ep 2 into a fresh state, and the step after it from both; the
    routes of an ep_impl change and an ep change."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import init_train_state, make_train_step
    plan, model = _step_setup((1, 1, 2))
    batches = _step_batches()
    state = init_train_state(model, torch.Generator().manual_seed(0), grid, plan)
    step = make_train_step(model, plan, _hyper(), mesh=grid)
    state, _ = step(state, batches[0])
    mgr = CheckpointManager(Path(out_dir) / "ckpt", keep=2)
    mgr.save(1, state, plan=plan, mesh=grid)
    mgr.wait()
    saved = SMOKE.host_named(state)
    routes = {"same": mgr.check_plan(plan, mesh=grid),
              "ep_impl": mgr.check_plan(dataclasses.replace(plan, ep_impl="blocking"),
                                        mesh=grid)}
    try:
        mgr.check_plan(dataclasses.replace(plan, ep=4, cp=2, tp=2))
        routes["ep4"] = "replay"
    except ValueError as e:
        routes["ep4"] = str(e)
    fresh = init_train_state(model, torch.Generator().manual_seed(7), grid, plan)
    _, fresh = mgr.restore(fresh, mesh=grid, plan=plan)
    got = SMOKE.host_named(fresh)
    _, m_saved = step(state, batches[1])
    _, m_fresh = step(fresh, batches[1])
    return {"saved": saved, "routes": routes,
            "bit_exact": all(np.array_equal(got[n], a) for n, a in saved.items()),
            "resumed": (float(m_saved["loss"]), float(m_fresh["loss"]))}


def _ckpt_at_ep4(grid, ckpt_dir):
    """The ep 2 checkpoint restored onto the folded ep 4 layout of this
    (1, 2, 2) grid (``restore_resharded``); this rank's restored state."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    plan, _ = _step_setup((1, 2, 2))
    _, model2 = _step_setup((1, 1, 2))
    model = build_model(model2.cfg, plan, device="cpu")
    mgr = CheckpointManager(Path(ckpt_dir), keep=2)
    route = mgr.check_plan(plan, mesh=grid, elastic=True)
    state = init_train_state(model, torch.Generator().manual_seed(7), grid, plan)
    _, state = mgr.restore_resharded(state, mesh=grid, plan=plan)
    return {"route": route, "restored": SMOKE.host_named(state)}


def _grid_jobs(grid, ref, out_dir):
    from repro_torch.ft.inject import FaultSpec
    g = (grid.shape["data"], grid.shape.get("cp", 1), grid.shape["model"])
    cp_rank = grid.cp.rank if grid.cp is not None else 0
    out = {"index": (grid.data.rank, cp_rank, grid.model.rank)}
    if g == DP_GRID:
        for case in ("olmoe", "deepseek"):
            out[f"loss/{case}"] = _loss(grid, ref[case], _plan(g))
        for n in (1, 2):
            out[f"step/mb{n}"] = _step(grid, microbatches=n)
        return out
    for case, (fam, mode) in LOSS_CASES.items():
        for impl in IMPLS:
            out[f"loss/{case}/{impl}"] = _loss(grid, ref[fam], _plan(g, impl, mode))
    if g == (1, 1, 2):
        with SMOKE.ep_bf16_rounding():
            out["control"] = _loss(grid, ref["deepseek"], _plan(g))
        for impl in IMPLS:
            out[f"fault/{impl}"] = _loss(grid, ref["olmoe"], _plan(g, impl),
                                         [FaultSpec("ep.a2a.tick", "nan", tick=0)])["loss"]
            out[f"step/{impl}"] = _step(grid, impl)
        out["ckpt"] = _ckpt(grid, out_dir)
    if g == (1, 2, 2):
        out["ckpt_ep4"] = _ckpt_at_ep4(grid, (Path(out_dir) / "ep2_ckpt").read_text())
    return out


def _rank_main(rank, world, out_dir):
    """One rank: every grid of its world in turn, each on a fresh process
    group, results saved."""
    from repro_torch.launch import init_grid_mesh
    torch.set_num_threads(1)
    with open(Path(out_dir) / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    out = {}
    for d, c, m in WORLD_GRIDS[world]:
        grid = init_grid_mesh(d, m, "cpu", cp=c, init_method=f"file://{out_dir}/store_{d}{c}{m}",
                              rank=rank)
        out[(d, c, m)] = _grid_jobs(grid, ref, out_dir)
        grid.close()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_ep_ranks as t; "
         "t._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])")


def _run_ranks(n, out_dir, timeout):
    """``n`` rank processes of ``_rank_main``; fail with their output if any
    exits non-zero or outlives ``timeout`` seconds."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(REPO / "src"), str(REPO / "tests"),
                               str(r), str(n), str(out_dir)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def reference(multidevice, tmp_path_factory):
    path = tmp_path_factory.mktemp("ep_ref") / "reference.pkl"
    multidevice(REF_SCRIPT.replace("sys.argv[1]", repr(str(path))), n_devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(reference, tmp_path_factory):
    """Each world's ranks run once, the 2-rank world first (its ep 2
    checkpoint is the 4-rank world's to restore): {grid: [rank results]},
    and the 2-rank world's directory under "dir2"."""
    out = {}
    for n in WORLD_GRIDS:
        d = tmp_path_factory.mktemp(f"ep{n}")
        with open(d / "reference.pkl", "wb") as f:
            pickle.dump(reference, f)
        if n == 4:
            (d / "ep2_ckpt").write_text(str(out["dir2"] / "ckpt"))
        _run_ranks(n, d, timeout=240)
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
        for g in WORLD_GRIDS[n]:
            out[g] = [r[g] for r in ranks]
        out[f"dir{n}"] = d
    return out


# ---------------------------------------------------------------------------
# loss and grads against the reference and against one process


def _ids(v):
    return v if isinstance(v, str) else "x".join(map(str, v))


def _part(grid):
    from repro_torch.core.sharding import layout_part
    plan = _plan(grid)
    return lambda name, a, index: layout_part(
        name, a, plan, {"model": index[2], "cp": index[1]}, _sizes(grid))


def _check_grads(ranks, ref_grads, grid, atol):
    """Every rank's grads against its part of the reference's (rtol 1e-4,
    ``atol``); raises AssertionError naming the first leaf that misses."""
    part = _part(grid)
    for r in ranks:
        got = r["grads"]
        assert sorted(got) == sorted(ref_grads)
        for name, a in ref_grads.items():
            np.testing.assert_allclose(got[name], part(name, a, r["index"]), rtol=1e-4,
                                       atol=atol, err_msg=name)


LOSS_RUNS = [(c, i, g) for c in LOSS_CASES for i in IMPLS for g in EP_GRIDS]


@pytest.mark.parametrize("case,impl,grid", LOSS_RUNS, ids=_ids)
def test_ep_loss_matches_the_reference(results, reference, case, impl, grid):
    ref = reference[case, grid]
    ranks = [{**r[f"loss/{case}/{impl}"], "index": r["index"]} for r in results[grid]]
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) < 2e-6, (r["loss"], ref["loss"])
    _check_grads(ranks, ref["grads"], grid, 3e-6 if grid[1] > 1 else 1e-6)


_ONE = {}


def _one_process(reference, fam, mode="einsum"):
    """The port's single-process loss and grads on the reference's weights and
    batch (``mode`` dispatch), and the grads evaluated in fp64 (chip_smoke's
    ``fp64_eval``), by name (stacked)."""
    if (fam, mode) in _ONE:
        return _ONE[fam, mode]
    from repro_torch.core import ParallelPlan
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_loss_fn
    ref = reference[fam]
    cfg = _cfg(ref["cfg"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    out = {}
    for name, ctx in (("one", None), ("fp64", SMOKE.fp64_eval)):
        with ctx() if ctx else contextlib.nullcontext():
            model = build_model(cfg, ParallelPlan(remat="none", compute_dtype="float32",
                                                  moe_dispatch=mode), device="cpu")
            params = params_from_numpy(ref["params"], cfg, device="cpu")
            if ctx:
                params = map_tree(lambda t: t.double(), params)
            for p in leaves(params):
                p.requires_grad_(True)
            loss, _ = make_loss_fn(model, Hyper(z_loss=Z_LOSS))(params, batch)
            loss.backward()
        out[name] = {"loss": loss.item(),
                     "grads": {n: a.astype(np.float64) if ctx else a for n, a in
                               _stacked(map_tree(lambda p: p.grad, params)).items()}}
    _ONE[fam, mode] = out
    return out


def _rule_failures(ranks, one, grid):
    """chip_smoke's grads rule over every data index's ranks (their parts in
    the fold's order)."""
    from repro_torch.core.sharding import layout_part
    plan, places, sizes = _plan(grid), _places(grid), _sizes(grid)
    bad = []
    for d in range(grid[0]):
        shards = [r["grads"] for r in sorted(ranks, key=lambda r: r["index"]) if r["index"][0] == d]
        part = (SMOKE.whole_part if grid[1] * grid[2] == 1 else
                lambda name, a, r, n: layout_part(name, a, plan, places[r], sizes))
        bad += SMOKE.grid_grad_failures(shards, one["one"]["grads"], one["fp64"]["grads"],
                                        part)[0]
    return bad


@pytest.mark.parametrize("case,impl,grid", LOSS_RUNS, ids=_ids)
def test_ep_loss_matches_one_process(results, reference, case, impl, grid):
    """The EP loss against the port's own single-process loss to 1e-6, and
    every rank's grads by chip_smoke's grads rule (fp64 evaluation and all)."""
    fam, mode = LOSS_CASES[case]
    one = _one_process(reference, fam, mode)
    ranks = [{**r[f"loss/{case}/{impl}"], "index": r["index"]} for r in results[grid]]
    for r in ranks:
        assert abs(r["loss"] - one["one"]["loss"]) <= REL, (r["loss"], one["one"]["loss"])
    assert _rule_failures(ranks, one, grid) == []


@pytest.mark.parametrize("case,grid", [(c, g) for c in LOSS_CASES for g in EP_GRIDS], ids=_ids)
def test_overlap_ring_grads_match_the_blocking_path(results, case, grid):
    """The overlap ring's custom backward against the blocking path's
    autograd (the reference's gradient oracle): the same loss, and every
    grad within 1e-6 of its leaf's max (they differ only in the order of the
    expert weights' sum over the ticks)."""
    for r in results[grid]:
        ring, blocking = r[f"loss/{case}/overlap"], r[f"loss/{case}/blocking"]
        assert abs(ring["loss"] - blocking["loss"]) <= REL * abs(blocking["loss"])
        for name, g in blocking["grads"].items():
            assert SMOKE.rel_err(ring["grads"][name], g) <= REL, name


@pytest.mark.parametrize("case", ["olmoe", "deepseek"])
def test_moe_under_data_parallelism_matches_one_device(results, reference, case):
    """Each data rank routes its own rows and the aux statistics are summed
    over the data group: at a no-drop capacity the loss and grads are one
    device's, the reference's (its loss to 2e-6, grads rtol 1e-4 / atol
    1e-6) and the port's (loss 1e-6, the grads rule)."""
    ref = reference[case]["one"]
    ranks = [{**r[f"loss/{case}"], "index": r["index"]} for r in results[DP_GRID]]
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) < 2e-6
        for name, a in ref["grads"].items():
            np.testing.assert_allclose(r["grads"][name], a, rtol=1e-4, atol=1e-6, err_msg=name)
    one = _one_process(reference, case)
    assert all(abs(r["loss"] - one["one"]["loss"]) <= REL for r in ranks)
    assert _rule_failures(ranks, one, DP_GRID) == []


def test_the_control_fails(results, reference):
    """Each chunk's expert output rounded to bf16 before the combine: the
    grads rule against one process must fail."""
    ranks = [{**r["control"], "index": r["index"]} for r in results[(1, 1, 2)]]
    assert _rule_failures(ranks, _one_process(reference, "deepseek"), (1, 1, 2)) != []


@pytest.mark.parametrize("impl", IMPLS)
def test_fault_seam_reaches_the_loss(results, impl):
    """``ep.a2a.tick`` armed with nan at tick 0: the NaN lands on a
    dispatched payload and the loss every rank reports is NaN."""
    ranks = results[(1, 1, 2)]
    assert all(np.isnan(r[f"fault/{impl}"]) for r in ranks)
    assert all(np.isfinite(r["loss/olmoe/overlap"]["loss"]) for r in ranks)


# ---------------------------------------------------------------------------
# the train step and the checkpoint


def _one_step(grid, microbatches=1):
    """One process's step on the same weights and batch, and the fp64
    evaluation of its grads."""
    from repro_torch.core.tree import map_tree
    plan, model = _step_setup(grid, microbatches=microbatches)
    one_plan = dataclasses.replace(plan, ep=1, cp=1, tp=1)
    from repro_torch.models import build_model
    model = build_model(model.cfg, one_plan, device="cpu")
    start = []
    batches = _step_batches()[:1]
    _, _, one = SMOKE.zero1_run(model, one_plan, batches, watch=SMOKE.ZeroWatch(steps=1),
                                prepare=lambda p: start.append(
                                    map_tree(lambda t: t.detach().clone(), p)),
                                hyper=_hyper())
    truth = SMOKE.fp64_first_grads(model.cfg, start[0], batches[0], microbatches, _hyper())
    return one, truth


STEP_CASES = {"ep-blocking": ((1, 1, 2), "step/blocking", 1),
              "ep-overlap": ((1, 1, 2), "step/overlap", 1),
              "dp-mb1": (DP_GRID, "step/mb1", 1), "dp-mb2": (DP_GRID, "step/mb2", 2)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_one_process(results, case):
    """One step against one process by chip_smoke.py's GRID_TOLERANCE
    (DP_TOLERANCE on the loss, grad norm and ZeRO-1 update; each rank's
    clipped grads, its expert blocks under ep, by the grads rule against one
    process's and an fp64 evaluation of its step); the ranks report the same
    loss and grad norm."""
    grid, key, mb = STEP_CASES[case]
    runs = [r[key] for r in results[grid]]
    assert all((r["loss"], r["grad_norm"]) == (runs[0]["loss"], runs[0]["grad_norm"])
               for r in runs)
    one, truth = _one_step(grid, mb)
    plan, places, sizes = _plan(grid), _places(grid), _sizes(grid)
    part = (SMOKE.whole_part if grid == DP_GRID else SMOKE.ep_part(plan, places, sizes))
    shards = [r["grads"] for r in runs][:len(places)]
    agree = SMOKE.grid_agreement(runs[0], one, shards, part)
    bad, explained = SMOKE.grid_failures(agree, runs[0]["shadow_err"], shards, one["grads"],
                                         truth, part)
    assert bad == [], (agree, explained)
    assert agree["loss_rel_step0"] <= REL and agree["grad_norm_rel_step0"] <= REL, agree


def test_checkpoint_restores_at_ep2_bit_for_bit(results):
    """Saved and restored on the (1, 2) grid: a replay, bit for bit, the
    resumed step equal; an ep_impl change replays, an ep change is a layout
    mismatch."""
    for r in results[(1, 1, 2)]:
        ck = r["ckpt"]
        assert ck["routes"]["same"] == "replay" and ck["routes"]["ep_impl"] == "replay"
        assert "layout mismatch" in ck["routes"]["ep4"] and "'ep': (2, 4)" in ck["routes"]["ep4"]
        assert ck["bit_exact"] and ck["resumed"][0] == ck["resumed"][1]


def _whole_saved(results):
    """The ep 2 state restored onto one process (ep 1, ``restore_resharded``,
    routed "reshard" and refused without ``elastic``): by name."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ParallelPlan
    from repro_torch.train import init_train_state
    from repro_torch.models import build_model
    plan, model = _step_setup((1, 1, 2))
    one_plan = ParallelPlan(compute_dtype="float32")
    model = build_model(model.cfg, one_plan, device="cpu")
    mgr = CheckpointManager(results["dir2"] / "ckpt", keep=2)
    assert mgr.manifest()["plan"]["ep"] == 2
    with pytest.raises(ValueError, match="ep"):
        mgr.check_plan(one_plan)
    assert mgr.check_plan(one_plan, elastic=True) == "reshard"
    single = init_train_state(model, torch.Generator().manual_seed(7))
    _, single = mgr.restore_resharded(single, plan=one_plan)
    return SMOKE.host_named(single)


def test_checkpoint_restores_at_ep1_bit_for_bit(results):
    """The file holds whole leaves: one process restores it, and each ep 2
    rank's saved expert blocks are its cut of them, bit for bit."""
    from repro_torch.core.sharding import layout_part
    whole = _whole_saved(results)
    plan = _plan((1, 1, 2))
    for r in results[(1, 1, 2)]:
        saved = r["ckpt"]["saved"]
        assert sorted(saved) == sorted(whole)
        place = {"model": r["index"][2], "cp": 0}
        for n, a in saved.items():
            assert np.array_equal(layout_part(n, whole[n], plan, place, _sizes((1, 1, 2))), a), n


def test_checkpoint_restores_at_ep4_bit_for_bit(results):
    """The ep 2 file restored onto the folded ep 4 layout of a (1, 2, 2)
    grid (routed "reshard"): every rank holds its cut of the whole state
    (its expert block of E / 4, its TP shards), bit for bit."""
    from repro_torch.core.sharding import layout_part
    whole = _whole_saved(results)
    grid = (1, 2, 2)
    plan = _plan(grid)
    for r in results[grid]:
        ck = r["ckpt_ep4"]
        assert ck["route"] == "reshard"
        place = {"model": r["index"][2], "cp": r["index"][1]}
        for n, a in ck["restored"].items():
            assert np.array_equal(layout_part(n, whole[n], plan, place, _sizes(grid)), a), n
