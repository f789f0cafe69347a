"""Pipeline parallelism on spawned ranks: gloo CPU processes on (pod, data,
cp, model) grids (``launch.mesh.init_grid_mesh(pod=)``), each grid's group
on a ``file://`` store under ``tmp_path``, as in ``tests/test_torch_ep_ranks.py``.

- ``pipelined_loss_fn`` against the reference's on the same weights and batch
  (the reference tests' tiny configs, initialised in JAX and carried over by
  ``interop``; the reference runs once in a forced-host-device subprocess,
  ``tests/conftest.py::run_multidevice``), at the reference tests' own
  tolerances: (pod 2, data 2) under both schedules
  (``tests/test_train_memory.py:21-67``: loss 2e-4, grads rtol 2e-3 / atol
  2e-5); TP x PP on (2, 2, ., 2) and the MoE aux on (2, 1, ., 2)
  (``tests/test_tensor_parallel.py:245-327``: loss 2e-6 and grads rtol 1e-4 /
  atol 1e-6; the MoE loss 5e-5 against the mean of per-microbatch losses);
  CP x PP on (2, 2, 2, .) under both schedules and CP x TP x PP on (2, 1, 2,
  2) under 1F1B (``tests/test_context_parallel.py:357-410``, atol 3e-6 for the
  last).
- Each case also against the port's own single process: the loss to 1e-6
  and every rank's grads by chip_smoke.py's grads rule
  (``grid_grad_failures``, with an fp64 evaluation); GPipe against 1F1B to
  1e-6 of each leaf's max.
- Uneven layouts (3, 1) and (1, 3) against the even layout and one process,
  on the port alone (the reference's own test of them fails in the CPU test run).
- EP x PP on (2, 1, 2, .), the expert ring folded onto cp (ep = cp = 2),
  against one process.
- A checkpoint written after one pipelined step at layout (2, 2) on (2, 2),
  restored at (3, 1) on the same grid, at pp 1 in one process and at dp 2
  on (1, 2, 1, 1), bit for bit.
- The bytes the forward saves for the backward (``saved_tensors_hooks``) at
  M = 2P: 1F1B's below GPipe's.
- The straggler ladder end to end, case for case with
  ``tests/test_straggler.py:437-505`` (which fails in the CPU test run): a
  ``slow`` fault on ``pp.stage.tick`` at stage 1 from step 6 is confirmed
  within the confirm window, rebalanced to (3, 1) exactly once through a
  reshard restore, and the run completes. The fault sleeps 0.5 s a layer
  where the reference's sleeps 0.05 s: every rank's detector must confirm
  at the same step on a loaded host, so the slowdown stays far above the
  factor 2 whatever the step's own time.
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
REL = 1e-6
SCHEDS = ("gpipe", "1f1b")
M = 4
Z = {"dense": 1e-4, "moe": 0.0}
CFGS = {
    "dense": 'ModelConfig("tiny", Family.DENSE, n_layers=4, d_model=64, n_heads=4, '
             'n_kv_heads=4, d_ff=128, vocab=128)',
    "moe": 'ModelConfig("tmoe", Family.MOE, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, '
           'd_ff=0, vocab=128, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, '
           'capacity_factor=2.0))',
}
# the reference's runs: (family, grid (pod, data, cp, model), schedule)
REF_RUNS = ([("dense", (2, 2, 1, 1), s) for s in SCHEDS]
            + [("dense", (2, 2, 1, 2), s) for s in SCHEDS]
            + [("moe", (2, 1, 1, 2), s) for s in SCHEDS]
            + [("dense", (2, 2, 2, 1), s) for s in SCHEDS]
            + [("dense", (2, 1, 2, 2), "1f1b")])
# (loss, grads rtol, grads atol) of the reference test each run comes from
REF_TOL = {(2, 2, 1, 1): (2e-4, 2e-3, 2e-5), (2, 2, 1, 2): (2e-6, 1e-4, 1e-6),
           (2, 1, 1, 2): (5e-5, None, None), (2, 2, 2, 1): (2e-6, 1e-4, 1e-6),
           (2, 1, 2, 2): (2e-6, 1e-4, 3e-6)}
LAYOUTS = [(3, 1), (1, 3)]
EP_GRID = (2, 1, 2, 1)
DP_GRID = (1, 2, 1, 1)
# world size -> its grids, run one after another
WORLD_GRIDS = {4: [(2, 2, 1, 1), (2, 1, 1, 2), EP_GRID],
               8: [(2, 2, 1, 2), (2, 2, 2, 1), (2, 1, 2, 2)],
               2: [DP_GRID]}

REF_SCRIPT = """
import sys, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.core import Family, InputShape, ModelConfig, MoEConfig, ParallelPlan
from repro.checkpoint.store import _flatten_with_names
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.train import Hyper, make_loss_fn
from repro.train.pipeline import pipelined_loss_fn
CFGS, RUNS, Z, M = %r, %r, %r, %r
named = lambda g: {n: np.asarray(a) for n, a in _flatten_with_names(g)}
res = {}
for fam, cfg_s in CFGS.items():
    cfg = eval(cfg_s)
    batch = {k: np.asarray(v) for k, v in
             SyntheticDataset(cfg, InputShape("t", 16, 8, "train")).batch(0).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    plan0 = ParallelPlan(remat="none", compute_dtype="float32")
    model = build_model(cfg, plan0)
    params = model.init(jax.random.PRNGKey(0))
    lf = make_loss_fn(model, Hyper(z_loss=Z[fam]))
    res[fam] = {"cfg": cfg_s, "params": jax.tree.map(np.asarray, params), "batch": batch}
    for (f, (p, d, c, m), sched) in RUNS:
        if f != fam:
            continue
        names = ("pod", "data") + (("cp",) if c > 1 else ()) + (("model",) if m > 1 else ())
        shape = (p, d) + ((c,) if c > 1 else ()) + ((m,) if m > 1 else ())
        mesh = jax.make_mesh(shape, names)
        plan = ParallelPlan(remat="none", compute_dtype="float32", pp=p, microbatches=M,
                            pp_schedule=sched, tp=m, cp=c,
                            tp_impl="overlap" if m > 1 else "auto", cp_impl="ring")
        plf = pipelined_loss_fn(cfg, plan, mesh, ("data",) if d > 1 else (), z_loss=Z[fam])
        loss, grads = jax.jit(jax.value_and_grad(lambda q, b: plf(q, b)[0]))(params, jb)
        res[fam, (p, d, c, m), sched] = {"loss": float(loss), "grads": named(grads)}
pickle.dump(res, open(sys.argv[1], "wb"))
""" % (CFGS, REF_RUNS, Z, M)


def _smoke():
    """chip_smoke.py, whose grid checks and pipelined step these tests share."""
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


def _plan(grid, sched="1f1b", layout=None, **kw):
    from repro_torch.core import ParallelPlan
    p, _, c, m = grid
    return ParallelPlan(remat=kw.pop("remat", "none"), compute_dtype="float32", pp=p,
                        microbatches=M, pp_schedule=sched, pp_layout=layout, tp=m, cp=c,
                        cp_impl="ring", **kw)


def _sizes(grid):
    return {"pod": grid[0], "cp": grid[2], "model": grid[3]}


def _batch(ref):
    return {k: torch.from_numpy(v) for k, v in ref["batch"].items()}


# ---------------------------------------------------------------------------
# what each rank runs


def _loss(grid, ref, fam, plan):
    """The pipelined loss on this rank's part of the reference's weights,
    backward: the loss and this rank's grads (stacked)."""
    from repro_torch.core.sharding import grid_place, shard_layout
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.interop import params_from_numpy
    from repro_torch.train.pipeline import pipelined_loss_fn
    cfg = _cfg(ref["cfg"])
    params = shard_layout(params_from_numpy(ref["params"], cfg, device="cpu"), plan,
                          *grid_place(grid))
    for p in leaves(params):
        p.requires_grad_(True)
    axes = ("data",) if grid.shape["data"] > 1 else ()
    total, parts = pipelined_loss_fn(cfg, plan, grid, axes, z_loss=Z[fam])(params, _batch(ref))
    total.backward()
    return {"loss": float(total.detach()), "moe_aux": float(parts["moe_aux"].detach()),
            "grads": _stacked(map_tree(lambda p: p.grad, params))}


def _saved_bytes(grid, ref, sched):
    """The bytes the forward saves for the backward, params' storage aside
    (``saved_tensors_hooks`` around the loss call)."""
    from repro_torch.core.sharding import grid_place, shard_layout
    from repro_torch.core.tree import leaves
    from repro_torch.interop import params_from_numpy
    from repro_torch.train.pipeline import pipelined_loss_fn
    cfg = _cfg(ref["cfg"])
    plan = _plan((2, 2, 1, 1), sched)
    params = shard_layout(params_from_numpy(ref["params"], cfg, device="cpu"), plan,
                          *grid_place(grid))
    for p in leaves(params):
        p.requires_grad_(True)
    own = {p.untyped_storage().data_ptr() for p in leaves(params)}
    seen, total = set(), [0]

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in own and ptr not in seen:
            seen.add(ptr)
            total[0] += t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = pipelined_loss_fn(cfg, plan, grid, ("data",), z_loss=Z["dense"])(
            params, _batch(ref))
    loss.backward()
    return total[0]


def _hyper():
    from repro_torch.train import Hyper
    return Hyper(peak_lr=1e-3, warmup_steps=2)


def _ckpt(grid, ref, out_dir):
    """One pipelined step from seed 0 at layout (2, 2), saved; the same
    checkpoint restored at (3, 1) on this grid (``restore_resharded``,
    routed "reshard") and saved again from there (the stages' parts then
    differ in size)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    from repro_torch.train.pipeline import pipelined_loss_fn
    cfg = _cfg(ref["cfg"])
    plan = _plan((2, 2, 1, 1), layout=(2, 2))
    model = build_model(cfg, plan, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), grid, plan)
    step = SMOKE.pp_train_step(pipelined_loss_fn(cfg, plan, grid, ("data",)), plan, grid,
                               _hyper())
    state, metrics = step(state, _batch(ref))
    mgr = CheckpointManager(Path(out_dir) / "ckpt", keep=2)
    mgr.save(1, state, plan=plan, mesh=grid)
    mgr.wait()
    plan31 = dataclasses.replace(plan, pp_layout=(3, 1))
    route = mgr.check_plan(plan31, mesh=grid, elastic=True)
    fresh = init_train_state(model, torch.Generator().manual_seed(7), grid, plan31)
    _, fresh = mgr.restore_resharded(fresh, mesh=grid, plan=plan31)
    mgr.save(2, fresh, plan=plan31, mesh=grid)
    mgr.wait()
    return {"saved": SMOKE.host_named(state), "route": route,
            "restored": SMOKE.host_named(fresh), "loss": float(metrics["loss"])}


def _ckpt_at_dp2(grid, ckpt_dir, ref):
    """The (2, 2) checkpoint restored at pp 1 onto this (1, 2, 1, 1) grid."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ParallelPlan
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    plan = ParallelPlan(remat="none", compute_dtype="float32")
    model = build_model(_cfg(ref["cfg"]), plan, device="cpu")
    mgr = CheckpointManager(Path(ckpt_dir), keep=2)
    route = mgr.check_plan(plan, mesh=grid, elastic=True)
    state = init_train_state(model, torch.Generator().manual_seed(7), grid, plan)
    _, state = mgr.restore_resharded(state, mesh=grid, plan=plan)
    return {"route": route, "restored": SMOKE.host_named(state)}


def _rebalance(grid, ref, out_dir):
    """The straggler ladder (module docstring) on this (2, 2) grid."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import RecoveryPolicy
    from repro_torch.data import SyntheticDataset
    from repro_torch.core import InputShape
    from repro_torch.ft import (Monitor, RemeshSpec, StragglerDetector, StragglerTimer,
                                run_with_recovery)
    from repro_torch.ft.inject import FaultSpec, armed
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    from repro_torch.train.pipeline import pipelined_loss_fn
    cfg = _cfg(ref["cfg"])
    plan = _plan((2, 2, 1, 1))
    model = build_model(cfg, plan, device="cpu")
    ds = SyntheticDataset(cfg, InputShape("t", 16, 8, "train"))

    def get_batch(s):
        return {k: torch.from_numpy(v) for k, v in ds.batch(s).items()}

    def make_step(pl):
        return SMOKE.pp_train_step(pipelined_loss_fn(cfg, pl, grid, ("data",)), pl, grid,
                                   _hyper())

    def state_for(pl):
        return init_train_state(model, torch.Generator().manual_seed(0), grid, pl)

    n = 16
    detector = StragglerDetector(window=8, factor=2.0, confirm=3, min_seconds=1e-3)
    timer = StragglerTimer(cfg=cfg, plan=plan, detector=detector)
    policy = RecoveryPolicy(straggler="rebalance", max_restores=4, straggler_confirm=3)
    monitor = Monitor(hang_min_seconds=60.0)
    applied = []

    def rebalance(layout):
        applied.append(tuple(layout))
        pl2 = dataclasses.replace(plan, pp_layout=tuple(layout))
        return RemeshSpec(train_step=make_step(pl2), state_template=state_for(pl2), plan=pl2,
                          mesh=grid)

    ckpt = CheckpointManager(Path(out_dir) / "rebalance", keep=4)
    with armed([FaultSpec("pp.stage.tick", "slow", step=6, span=999, rank=1, sleep_s=0.5)]):
        _, report = run_with_recovery(state_for(plan), make_step(plan), get_batch, n, ckpt,
                                      monitor, ckpt_every=3, plan=plan, mesh=grid,
                                      policy=policy, straggler=timer, rebalance=rebalance)
    strag = [(a.step, a.detail) for a in report.anomalies if a.kind == "straggler"]
    return {"steps_done": report.steps_done, "rebalances": report.rebalances,
            "restores": report.restores, "applied": applied, "stragglers": strag,
            "actions": report.actions, "losses": report.losses}


def _grid_jobs(grid, ref, out_dir):
    g = (grid.shape.get("pod", 1), grid.shape["data"], grid.shape.get("cp", 1),
         grid.shape["model"])
    idx = {"pod": grid.pod.rank if grid.pod is not None else 0, "data": grid.data.rank,
           "cp": grid.cp.rank if grid.cp is not None else 0, "model": grid.model.rank}
    out = {"index": idx}
    fam = "moe" if g in ((2, 1, 1, 2), EP_GRID) else "dense"
    if g == DP_GRID:
        out["ckpt_dp2"] = _ckpt_at_dp2(grid, (Path(out_dir) / "pp_ckpt").read_text(),
                                       ref["dense"])
        return out
    for sched in SCHEDS:
        if g == (2, 1, 2, 2) and sched == "gpipe":
            continue
        plan = _plan(g, sched, ep=2 if g == EP_GRID else 1)
        out[f"loss/{sched}"] = _loss(grid, ref[fam], fam, plan)
    if g == (2, 2, 1, 1):
        for layout in LAYOUTS:
            for sched in SCHEDS:
                out[f"loss/{sched}/{layout}"] = _loss(grid, ref[fam], fam,
                                                      _plan(g, sched, layout))
        out["saved_bytes"] = {s: _saved_bytes(grid, ref[fam], s) for s in SCHEDS}
        out["ckpt"] = _ckpt(grid, ref[fam], out_dir)
        out["rebalance"] = _rebalance(grid, ref[fam], out_dir)
    return out


def _rank_main(rank, world, out_dir):
    """One rank: every grid of its world in turn, each on a fresh process
    group, results saved."""
    from repro_torch.launch import init_grid_mesh
    torch.set_num_threads(1)
    with open(Path(out_dir) / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    out = {}
    for p, d, c, m in WORLD_GRIDS[world]:
        grid = init_grid_mesh(d, m, "cpu", cp=c, pod=p,
                              init_method=f"file://{out_dir}/store_{p}{d}{c}{m}", rank=rank)
        out[(p, d, c, m)] = _grid_jobs(grid, ref, out_dir)
        grid.close()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_pp_ranks as t; "
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
    path = tmp_path_factory.mktemp("pp_ref") / "reference.pkl"
    multidevice(REF_SCRIPT.replace("sys.argv[1]", repr(str(path))), n_devices=8)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(reference, tmp_path_factory):
    """Each world's ranks run once, the 4-rank world first (its checkpoint is
    the 2-rank world's to restore): {grid: [rank results]}, and the 4-rank
    world's directory under "dir4"."""
    out = {}
    for n in (4, 8, 2):
        d = tmp_path_factory.mktemp(f"pp{n}")
        with open(d / "reference.pkl", "wb") as f:
            pickle.dump(reference, f)
        if n == 2:
            (d / "pp_ckpt").write_text(str(out["dir4"] / "ckpt"))
        _run_ranks(n, d, timeout=420)
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
        for g in WORLD_GRIDS[n]:
            out[g] = [r[g] for r in ranks]
        out[f"dir{n}"] = d
    return out


# ---------------------------------------------------------------------------
# loss and grads against the reference and against one process


def _ids(v):
    return v if isinstance(v, str) else "x".join(map(str, v))


def _part(grid, plan):
    """Rank ``index``'s part of one device's whole leaf under ``plan``."""
    from repro_torch.core.sharding import layout_part
    return lambda name, a, index: layout_part(name, a, plan, index, _sizes(grid))


@pytest.mark.parametrize("fam,grid,sched", REF_RUNS, ids=_ids)
def test_pipeline_matches_the_reference(results, reference, fam, grid, sched):
    """Every rank's loss and its part of the grads against the reference's
    ``pipelined_loss_fn`` on the same weights and batch, at the reference
    test's tolerances (the MoE run: the loss, every stage's aux counted)."""
    ref = reference[fam, grid, sched]
    loss_tol, rtol, atol = REF_TOL[grid]
    part = _part(grid, _plan(grid, sched))
    for r in results[grid]:
        got = r[f"loss/{sched}"]
        assert abs(got["loss"] - ref["loss"]) < loss_tol, (got["loss"], ref["loss"])
        if fam == "moe":
            assert got["moe_aux"] > 0.0
        if rtol is None:
            continue
        assert sorted(got["grads"]) == sorted(ref["grads"])
        for name, a in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][name], part(name, a, r["index"]),
                                       rtol=rtol, atol=atol, err_msg=name)


_ONE = {}


def _one_process(reference, fam):
    """The port's single-process loss and grads on the reference's weights and
    batch (the MoE family: the mean of the M microbatches' losses, as the
    pipeline routes each microbatch alone), and the grads in fp64, by name."""
    if fam in _ONE:
        return _ONE[fam]
    from repro_torch.core import ParallelPlan
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_loss_fn
    ref = reference[fam]
    cfg = _cfg(ref["cfg"])
    batch = _batch(ref)
    n_mb = M if fam == "moe" else 1
    rows = batch["tokens"].shape[0] // n_mb
    out = {}
    for name, ctx in (("one", None), ("fp64", SMOKE.fp64_eval)):
        with ctx() if ctx else contextlib.nullcontext():
            model = build_model(cfg, ParallelPlan(remat="none", compute_dtype="float32"),
                                device="cpu")
            params = params_from_numpy(ref["params"], cfg, device="cpu")
            if ctx:
                params = map_tree(lambda t: t.double(), params)
            for p in leaves(params):
                p.requires_grad_(True)
            loss = 0.0
            for i in range(n_mb):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                li, _ = make_loss_fn(model, Hyper(z_loss=Z[fam]))(params, mb)
                (li / n_mb).backward()
                loss += li.item() / n_mb
        out[name] = {"loss": loss,
                     "grads": {n: a.astype(np.float64) if ctx else a for n, a in
                               _stacked(map_tree(lambda p: p.grad, params)).items()}}
    _ONE[fam] = out
    return out


def _rule_failures(ranks, one, grid, plan):
    """chip_smoke's grads rule on every rank's grads (its part of one
    process's), rank by rank."""
    from repro_torch.core.sharding import layout_part
    bad = []
    for r in ranks:
        def part(name, a, _r, _n, index=r["index"]):
            return layout_part(name, a, plan, index, _sizes(grid))
        bad += SMOKE.grid_grad_failures([r["grads"]], one["one"]["grads"],
                                        one["fp64"]["grads"], part)[0]
    return bad


ONE_RUNS = ([(fam, g, s) for fam, g, s in REF_RUNS]
            + [("dense", (2, 2, 1, 1), f"{s}/{lay}") for lay in LAYOUTS for s in SCHEDS]
            + [("moe", EP_GRID, s) for s in SCHEDS])


@pytest.mark.parametrize("fam,grid,key", ONE_RUNS, ids=_ids)
def test_pipeline_matches_one_process(results, reference, fam, grid, key):
    """The loss to 1e-6 of the port's own single process, and every rank's
    grads by chip_smoke.py's grads rule (fp64 evaluation and all): the
    reference's cases, the uneven layouts and EP x PP."""
    sched, _, layout = key.partition("/")
    plan = _plan(grid, sched, eval(layout) if layout else None, ep=2 if grid == EP_GRID else 1)
    one = _one_process(reference, fam)
    ranks = [{**r[f"loss/{key}"], "index": r["index"]} for r in results[grid]]
    for r in ranks:
        assert abs(r["loss"] - one["one"]["loss"]) <= REL, (r["loss"], one["one"]["loss"])
    assert _rule_failures(ranks, one, grid, plan) == []


GPIPE_RUNS = ([(g, "") for g in ((2, 2, 1, 1), (2, 2, 1, 2), (2, 1, 1, 2), (2, 2, 2, 1), EP_GRID)]
              + [((2, 2, 1, 1), f"/{lay}") for lay in LAYOUTS])


@pytest.mark.parametrize("grid,layout", GPIPE_RUNS, ids=_ids)
def test_gpipe_matches_1f1b(results, grid, layout):
    """The two schedules on each rank: the same loss to 1e-6 and every grad
    within 1e-6 of its leaf's max (they differ only in the order the
    microbatches' grads are summed)."""
    for r in results[grid]:
        a, b = r[f"loss/gpipe{layout}"], r[f"loss/1f1b{layout}"]
        assert abs(a["loss"] - b["loss"]) <= REL * abs(b["loss"])
        for name, g in b["grads"].items():
            assert SMOKE.rel_err(a["grads"][name], g) <= REL, name


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_uneven_layout_matches_the_even_one(results, layout):
    """(3, 1) and (1, 3) against the even (2, 2): each rank's stage holds
    other layers, so the grads are compared whole (the stages' layer rows in
    order, at data index 0), each leaf within 1e-6 of its max."""
    ranks = results[(2, 2, 1, 1)]

    def whole(key):
        by_pod = {r["index"]["pod"]: r[key]["grads"] for r in ranks if r["index"]["data"] == 0}
        return {n: np.concatenate([by_pod[0][n], by_pod[1][n]]) if n.startswith("layers/")
                else by_pod[0][n] for n in by_pod[0]}
    for sched in SCHEDS:
        even, got = whole(f"loss/{sched}"), whole(f"loss/{sched}/{layout}")
        for name, g in even.items():
            assert SMOKE.rel_err(got[name], g) <= REL, (sched, name)


def test_1f1b_saves_less_than_gpipe(results):
    """At M = 2P the 1F1B forward saves nothing beyond the params; GPipe's
    autograd keeps every tick's activations."""
    for r in results[(2, 2, 1, 1)]:
        b = r["saved_bytes"]
        assert b["1f1b"] < b["gpipe"], b


# ---------------------------------------------------------------------------
# checkpoint and the straggler ladder


def _whole_saved(results, step=1):
    """The checkpoint of ``step`` (1: saved at (2, 2); 2: saved again at (3,
    1)) restored onto one process at pp 1 (``restore_resharded``): by
    name."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ParallelPlan
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    plan = ParallelPlan(remat="none", compute_dtype="float32")
    cfg = _cfg(CFGS["dense"])
    mgr = CheckpointManager(results["dir4"] / "ckpt", keep=2)
    man = mgr.manifest(step)
    assert (man["plan"]["pp"], man["plan"]["pp_layout"]) == (2, [[2, 2], [3, 1]][step - 1])
    assert mgr.check_plan(plan, step=step, elastic=True) == "reshard"
    single = init_train_state(build_model(cfg, plan, device="cpu"),
                              torch.Generator().manual_seed(7))
    _, single = mgr.restore_resharded(single, step=step, plan=plan)
    return SMOKE.host_named(single)


def _rank_cut(name, whole, plan, index, sizes, n_data):
    """A rank's part of a whole state leaf: its stage's rows, then its ZeRO-1
    slice of a moment over the data ranks."""
    from repro_torch.core.sharding import layout_part, opt_shard_dim
    part = layout_part(name, whole, plan, index, sizes)
    if name.startswith(("opt/mu/", "opt/nu/")) and plan.zero_stage >= 1:
        dim = opt_shard_dim(part.shape, n_data)
        if dim is not None:
            k = part.shape[dim] // n_data
            part = np.take(part, range(index["data"] * k, (index["data"] + 1) * k), axis=dim)
    return part


def test_checkpoint_restores_across_layouts_bit_for_bit(results):
    """Saved at (2, 2) on (2, 2): one process restores the whole state, each
    rank's saved state is its cut of it, and the restores at (3, 1) on the
    same grid and at pp 1 on (1, 2, 1, 1) are their cuts, bit for bit; the
    state saved again at (3, 1) is the same whole state."""
    whole = _whole_saved(results)
    again = _whole_saved(results, step=2)
    assert sorted(again) == sorted(whole)
    assert all(np.array_equal(again[n], a) for n, a in whole.items())
    grid = (2, 2, 1, 1)
    plan = _plan(grid, layout=(2, 2))
    plan31 = dataclasses.replace(plan, pp_layout=(3, 1))
    for r in results[grid]:
        ck = r["ckpt"]
        assert ck["route"] == "reshard" and np.isfinite(ck["loss"])
        assert sorted(ck["saved"]) == sorted(whole)
        for n, a in whole.items():
            assert np.array_equal(_rank_cut(n, a, plan, r["index"], _sizes(grid), 2),
                                  ck["saved"][n]), n
            assert np.array_equal(_rank_cut(n, a, plan31, r["index"], _sizes(grid), 2),
                                  ck["restored"][n]), n
    from repro_torch.core import ParallelPlan
    plan1 = ParallelPlan(remat="none", compute_dtype="float32")
    for r in results[DP_GRID]:
        ck = r["ckpt_dp2"]
        assert ck["route"] == "reshard"
        for n, a in whole.items():
            assert np.array_equal(_rank_cut(n, a, plan1, r["index"], _sizes(DP_GRID), 2),
                                  ck["restored"][n]), n


def test_straggler_rebalance_end_to_end(results):
    """Stage 1 slowed from step 6: detected within the confirm window,
    attributed (rank=1, compute), rebalanced to (3, 1) once through a
    reshard restore, and the run completes; every rank took the same
    actions."""
    runs = [r["rebalance"] for r in results[(2, 2, 1, 1)]]
    for rep in runs:
        assert rep["steps_done"] == 16, rep
        assert rep["rebalances"] == 1, rep
        assert rep["applied"] == [(3, 1)], rep
        assert rep["stragglers"] and rep["stragglers"][0][0] <= 6 + 3, rep["stragglers"]
        assert "rank=1" in rep["stragglers"][0][1] and "class=compute" in rep["stragglers"][0][1]
        assert any(k == "straggler" and act == "rebalance" for _, k, act in rep["actions"])
        assert all(np.isfinite(x) for x in rep["losses"])
        assert (rep["actions"], rep["restores"]) == (runs[0]["actions"], runs[0]["restores"])
