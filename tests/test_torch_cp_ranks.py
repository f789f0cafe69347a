"""Context parallelism on spawned ranks: gloo CPU processes on (data, cp) and
(data, cp, model) grids (``launch.mesh.init_grid_mesh(cp=)``), each grid's
group on a ``file://`` store under ``tmp_path``, as in
``tests/test_torch_tp_ranks.py``.

- The port's CP loss and grads against the reference's
  ``make_executor_loss_fn`` on the same weights and batch (the reference
  test's tiny configs, ``z_loss=1e-4``, 8 x 16 tokens): dense in the ring and
  the gather modes, MoE (capacity_factor 2.0: no drops) and Mamba2 on the
  grids (1, 2), (2, 2) and (1, 4), dense cp x tp on (1, 2, 2), the ring under
  remat "full" and Mamba2 under "selective" on (1, 2); at the reference test's
  tolerances (``tests/test_context_parallel.py:240-350``: loss 2e-6, grads
  rtol 1e-4 / atol 1e-6, 3e-6 for cp x tp). The reference runs in a
  forced-host-device subprocess (``tests/conftest.py::run_multidevice``).
- The same runs against the port's own single process, by chip_smoke.py's
  grads rule (``grid_grad_failures``: a leaf past 1e-6 of its max no further
  from an fp64 evaluation than twice one process's distance plus 1e-6), and
  the loss to 1e-6.
- A control at cp = 4 that must fail: the reversed ring without the dk/dv
  accumulators' last hop.
- ``make_train_step`` on a (1, 2) grid, one step against one process by
  ``GRID_TOLERANCE`` (dense in both modes, Mamba2).
- A checkpoint saved at cp 2, restored at cp 2 and at cp 1, bit for bit.
- The ``cp.ring.kv`` and ``cp.ring.state`` fault seams armed with nan reach
  the loss.
"""

import contextlib
import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.sharding import tp_shard_of

REPO = Path(__file__).resolve().parent.parent
Z_LOSS = 1e-4
REL = 1e-6
# world size -> its grids (data, cp, model), run one after another
WORLD_GRIDS = {2: [(1, 2, 1)], 4: [(2, 2, 1), (1, 4, 1), (1, 2, 2)]}
BASE_GRIDS = [(1, 2, 1), (2, 2, 1), (1, 4, 1)]
# loss case -> (reference family, cp_impl, grids, remat)
LOSS_CASES = {
    "dense-ring": ("dense", "ring", BASE_GRIDS, "none"),
    "dense-gather": ("dense", "gather", BASE_GRIDS, "none"),
    "moe": ("moe", "ring", BASE_GRIDS, "none"),
    "ssm": ("ssm", "ring", BASE_GRIDS, "none"),
    "dense-ring-remat-full": ("dense", "ring", [(1, 2, 1)], "full"),
    "ssm-remat-selective": ("ssm", "ring", [(1, 2, 1)], "selective"),
    "dense-cp-tp": ("dense", "ring", [(1, 2, 2)], "none"),
}
# train-step case -> (smoke arch, cp_impl)
STEP_CASES = {"qwen1.5-4b-ring": ("qwen1.5-4b", "ring"),
              "qwen1.5-4b-gather": ("qwen1.5-4b", "gather"),
              "mamba2-370m": ("mamba2-370m", "ring")}

# the reference's executor loss and grads on every grid of LOSS_CASES, its
# weights (the SSM's conv taps and gated-norm scale drawn at random, so the
# scan does real work) and batch, pickled to the path in argv[1]
REF_SCRIPT = """
import sys, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.core import (Family, InputShape, ModelConfig, MoEConfig, SSMConfig, ParallelPlan)
from repro.checkpoint.store import _flatten_with_names
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.train.executor import make_executor_loss_fn
RUNS = %r
CFGS = {
 "dense": 'ModelConfig("tiny", Family.DENSE, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, '
          'd_ff=128, vocab=128)',
 "moe": 'ModelConfig("tmoe", Family.MOE, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, '
        'd_ff=0, vocab=128, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, '
        'num_shared_experts=1, capacity_factor=2.0))',
 "ssm": 'ModelConfig("tssm", Family.SSM, n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, '
        'd_ff=0, vocab=128, ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8))',
}
res = {}
for name, cfg_s in CFGS.items():
    cfg = eval(cfg_s)
    batch = {k: np.asarray(v) for k, v in
             SyntheticDataset(cfg, InputShape("t", 16, 8, "train")).batch(0).items()}
    params = jax.tree.map(np.asarray, build_model(
        cfg, ParallelPlan(remat="none", compute_dtype="float32")).init(jax.random.PRNGKey(0)))
    if cfg.family == Family.SSM:
        rng = np.random.default_rng(3)
        for k in ("conv_x", "conv_B", "conv_C", "scale"):
            a = params["layers"]["ssm"][k]
            params["layers"]["ssm"][k] = (0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    res[name] = {"cfg": cfg_s, "params": params, "batch": batch}
    for fam, impl, (d, c, m) in RUNS:
        if fam != name:
            continue
        ms = (d, c) if m == 1 else (d, c, m)
        mesh = jax.make_mesh(ms, ("data", "cp", "model")[:len(ms)])
        plan = ParallelPlan(remat="none", compute_dtype="float32", cp=c, cp_impl=impl, tp=m,
                            tp_impl="overlap" if m > 1 else "auto")
        lf = make_executor_loss_fn(cfg, plan, mesh, ("data",), z_loss=%r)
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: lf(p, b)[0]))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        res[name][(impl, (d, c, m))] = {
            "loss": float(loss), "grads": {n: np.asarray(a) for n, a in _flatten_with_names(grads)}}
pickle.dump(res, open(sys.argv[1], "wb"))
""" % (sorted({(fam, impl, g) for fam, impl, grids, _ in LOSS_CASES.values() for g in grids}),
       Z_LOSS)


def _smoke():
    """chip_smoke.py, whose grid checks these tests share."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def _cfg(cfg_s):
    from repro_torch.core import Family, ModelConfig, MoEConfig, SSMConfig  # noqa: F401
    return eval(cfg_s)


def _stacked(tree):
    from repro_torch.core.tree import named_leaves
    return {n: (torch.stack([t.detach() for t in x]) if isinstance(x, list) else x.detach())
            .numpy().copy() for n, x in named_leaves(tree)}


def _random_taps(params):
    """The SSM families zero their conv taps and gated-norm scale at init; draw
    them (the same on every rank: those leaves are whole on each)."""
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for lp in params["layers"]:
            for k in ("conv_x", "conv_B", "conv_C", "scale") if "ssm" in lp else ():
                lp["ssm"][k].copy_(0.3 * torch.randn(lp["ssm"][k].shape, generator=g))


# ---------------------------------------------------------------------------
# what each rank runs


def _loss(grid, ref, impl, remat, faults=None):
    """The port's CP loss on this rank's part of the reference's weights (its
    TP shards under cp x tp) and its rows of the batch, backward, the grads
    summed over the cp ring (and the replicated leaves' over the model ring),
    every grad and the loss meaned over the data ranks. Returns the loss and
    this rank's grads (stacked)."""
    from repro_torch.core import ParallelPlan
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.ft import inject
    from repro_torch.interop import params_from_numpy, tp_params_from_numpy
    from repro_torch.launch import rank_microbatches
    from repro_torch.train.executor import make_executor_loss_fn, resolve_context
    from repro_torch.train.step import sum_grid_grads
    cfg = _cfg(ref["cfg"])
    cp, tp = grid.shape["cp"], grid.shape["model"]
    plan = ParallelPlan(remat=remat, compute_dtype="float32", cp=cp, cp_impl=impl, tp=tp)
    params = (tp_params_from_numpy(ref["params"], cfg, grid.model.rank, tp, device="cpu")
              if tp > 1 else params_from_numpy(ref["params"], cfg, device="cpu"))
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


def _no_last_hop():
    """The control: the reversed ring's dk/dv accumulators skip their last hop
    (every backward makes cp hops, so each cp-th), so each rank keeps its left
    neighbour's sums as its own."""
    from repro_torch.train import executor
    real = executor._accumulators_hop
    hops = [0]

    def hop(ring, dk, dv):
        hops[0] += 1
        return (dk, dv) if hops[0] % ring.size == 0 else real(ring, dk, dv)
    executor._accumulators_hop = hop
    return real


def _step_setup(arch, impl, cp):
    from repro_torch.core import ParallelPlan, get_smoke_config
    from repro_torch.models import build_model
    plan = ParallelPlan(compute_dtype="float32", remat="full", microbatches=1, cp=cp,
                        cp_impl=impl)
    return plan, build_model(get_smoke_config(arch), plan, device="cpu")


def _step_batches(arch, n=2):
    from repro_torch.core import InputShape, get_smoke_config
    from repro_torch.data import SyntheticDataset
    ds = SyntheticDataset(get_smoke_config(arch), InputShape("t", 16, 4, "train"))
    return [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(n)]


def _hyper():
    from repro_torch import train as ttrain
    return ttrain.Hyper(peak_lr=1e-3, warmup_steps=2)


def _step(grid, arch, impl):
    """chip_smoke's ``zero1_run`` on the grid: one step of ``arch``'s smoke
    config from seed 0, watched (the ZeRO-1 update held to adamw_update on the
    same grads)."""
    plan, model = _step_setup(arch, impl, grid.shape["cp"])
    watch = SMOKE.ZeroWatch(steps=1, shadow=True)
    _, _, out = SMOKE.zero1_run(model, plan, _step_batches(arch)[:1], grid, watch=watch,
                                prepare=_random_taps, hyper=_hyper())
    return {**out, "shadow_err": watch.shadow_err}


def _ckpt(grid, out_dir):
    """A train state after one step saved at cp 2, routed and restored at cp
    2 into a fresh state, and the step after it from both states."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import init_train_state, make_train_step
    plan, model = _step_setup("qwen1.5-4b", "ring", 2)
    batches = _step_batches("qwen1.5-4b")
    state = init_train_state(model, torch.Generator().manual_seed(0), grid, plan)
    step = make_train_step(model, plan, _hyper(), mesh=grid)
    state, _ = step(state, batches[0])
    mgr = CheckpointManager(Path(out_dir) / "ckpt", keep=2)
    mgr.save(1, state, plan=plan, mesh=grid)
    mgr.wait()
    saved = SMOKE.host_named(state)
    route = mgr.check_plan(plan, mesh=grid)
    fresh = init_train_state(model, torch.Generator().manual_seed(7), grid, plan)
    _, fresh = mgr.restore(fresh, mesh=grid)
    got = SMOKE.host_named(fresh)
    _, m_saved = step(state, batches[1])
    _, m_fresh = step(fresh, batches[1])
    return {"saved": saved, "route": route,
            "bit_exact": all(np.array_equal(got[n], a) for n, a in saved.items()),
            "resumed": (float(m_saved["loss"]), float(m_fresh["loss"]))}


def _grid_jobs(grid, ref, out_dir):
    from repro_torch.ft.inject import FaultSpec
    g = (grid.shape["data"], grid.shape["cp"], grid.shape["model"])
    out = {"index": (grid.data.rank, grid.cp.rank, grid.model.rank)}
    for case, (fam, impl, grids, remat) in LOSS_CASES.items():
        if g in grids:
            out[f"loss/{case}"] = _loss(grid, ref[fam], impl, remat)
    if g == (1, 4, 1):
        real = _no_last_hop()
        try:
            out["control"] = _loss(grid, ref["dense"], "ring", "none")
        finally:
            from repro_torch.train import executor
            executor._accumulators_hop = real
    if g == (1, 2, 1):
        out["fault/kv"] = _loss(grid, ref["dense"], "ring", "none",
                                [FaultSpec("cp.ring.kv", "nan", tick=0)])["loss"]
        out["fault/state"] = _loss(grid, ref["ssm"], "ring", "none",
                                   [FaultSpec("cp.ring.state", "nan", tick=0)])["loss"]
        for case, (arch, impl) in STEP_CASES.items():
            out[f"step/{case}"] = _step(grid, arch, impl)
        out["ckpt"] = _ckpt(grid, out_dir)
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


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_cp_ranks as t; "
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
    path = tmp_path_factory.mktemp("cp_ref") / "reference.pkl"
    multidevice(REF_SCRIPT.replace("sys.argv[1]", repr(str(path))), n_devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(reference, tmp_path_factory):
    """Each world's ranks run once: {grid: [rank results]}, and the 2-rank
    world's directory (its checkpoint) under "dir2"."""
    out = {}
    for n in WORLD_GRIDS:
        d = tmp_path_factory.mktemp(f"cp{n}")
        with open(d / "reference.pkl", "wb") as f:
            pickle.dump(reference, f)
        _run_ranks(n, d, timeout=240)
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
        for g in WORLD_GRIDS[n]:
            out[g] = [r[g] for r in ranks]
        out[f"dir{n}"] = d
    return out


# ---------------------------------------------------------------------------
# loss and grads against the reference and against one process


def _loss_cases():
    return [(c, g) for c, (_, _, grids, _) in LOSS_CASES.items() for g in grids]


def _ids(v):
    return v if isinstance(v, str) else "x".join(map(str, v))


def _check_grads(ranks, ref_grads, tp, atol):
    """Every rank's grads against its part of the reference's (its TP shard
    under tp; rtol 1e-4, ``atol``); raises AssertionError naming the first
    leaf that misses."""
    for r in ranks:
        got = r["grads"]
        assert sorted(got) == sorted(ref_grads)
        for name, a in ref_grads.items():
            np.testing.assert_allclose(got[name], tp_shard_of(name, a, r["index"][2], tp),
                                       rtol=1e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("case,grid", _loss_cases(), ids=_ids)
def test_cp_loss_matches_the_reference(results, reference, case, grid):
    fam, impl, _, _ = LOSS_CASES[case]
    ref = reference[fam][(impl, grid)] if (impl, grid) in reference[fam] else \
        reference[fam][("ring", grid)]                  # remat cases: the same math
    ranks = [{**r[f"loss/{case}"], "index": r["index"]} for r in results[grid]]
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) < 2e-6, (r["loss"], ref["loss"])
    _check_grads(ranks, ref["grads"], grid[2], 3e-6 if grid[2] > 1 else 1e-6)


_ONE = {}


def _one_process(reference, fam):
    """The port's single-process loss and grads on the reference's weights and
    batch, and the grads evaluated in fp64 (chip_smoke's ``fp64_eval``), by
    name (stacked)."""
    if fam in _ONE:
        return _ONE[fam]
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
            model = build_model(cfg, ParallelPlan(remat="none", compute_dtype="float32"),
                                device="cpu")
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
    _ONE[fam] = out
    return out


@pytest.mark.parametrize("case,grid", _loss_cases(), ids=_ids)
def test_cp_loss_matches_one_process(results, reference, case, grid):
    """The CP loss against the port's own single-process loss on the same
    weights and batch to 1e-6, and every rank's grads against one process's
    by chip_smoke's grads rule (``grid_grad_failures``, fp64 evaluation and
    all)."""
    fam = LOSS_CASES[case][0]
    one = _one_process(reference, fam)
    ranks = results[grid]
    tp = grid[2]
    for r in ranks:
        assert abs(r[f"loss/{case}"]["loss"] - one["one"]["loss"]) <= REL, one["one"]["loss"]
    for c in range(grid[1]):
        for d in range(grid[0]):
            shards = [r[f"loss/{case}"]["grads"] for r in sorted(ranks, key=lambda r: r["index"][2])
                      if r["index"][:2] == (d, c)]
            bad, _ = SMOKE.grid_grad_failures(
                shards, one["one"]["grads"], one["fp64"]["grads"],
                SMOKE.tp_part if tp > 1 else SMOKE.whole_part)
            assert bad == [], bad


def test_the_control_fails_at_cp4(results, reference):
    """Without the accumulators' last hop every rank returns its left
    neighbour's dk/dv: the loss is unchanged, the grads miss the reference's
    (at cp = 4 the forward and reversed rings are different hops)."""
    ref = reference["dense"][("ring", (1, 4, 1))]
    ranks = [{**r["control"], "index": r["index"]} for r in results[(1, 4, 1)]]
    assert all(abs(r["loss"] - ref["loss"]) < 2e-6 for r in ranks)
    with pytest.raises(AssertionError):
        _check_grads(ranks, ref["grads"], 1, 1e-6)
    for r in ranks:
        for name in ("layers/attn/wk", "layers/attn/wv"):
            assert not np.allclose(r["grads"][name], ref["grads"][name], rtol=1e-4, atol=1e-6)


def test_fault_seams_reach_the_loss(results):
    """``cp.ring.kv`` (dense, ring) and ``cp.ring.state`` (Mamba2) armed with
    nan at tick 0: the NaN lands on a KV chunk or a chain message, and the
    loss every rank reports is NaN."""
    ranks = results[(1, 2, 1)]
    assert all(np.isnan(r["fault/kv"]) and np.isnan(r["fault/state"]) for r in ranks)
    assert all(np.isfinite(r["loss/dense-ring"]["loss"]) for r in ranks)


# ---------------------------------------------------------------------------
# the train step and the checkpoint


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_one_process(results, case):
    """One step on the (1, 2) grid against one process by chip_smoke.py's
    GRID_TOLERANCE (DP_TOLERANCE on the loss, grad norm and ZeRO-1 update;
    each rank's clipped grads, whole leaves, by the grads rule against one
    process's and an fp64 evaluation of its step); both ranks report the same
    and hold the same params bit for bit."""
    arch, impl = STEP_CASES[case]
    runs = [r[f"step/{case}"] for r in results[(1, 2, 1)]]
    assert (runs[1]["loss"], runs[1]["grad_norm"]) == (runs[0]["loss"], runs[0]["grad_norm"])
    assert all(np.array_equal(runs[1]["params"][n], a) for n, a in runs[0]["params"].items())
    from repro_torch.core.tree import map_tree
    plan, model = _step_setup(arch, impl, 1)
    start = []

    def prepare(params):
        _random_taps(params)
        start.append(map_tree(lambda p: p.detach().clone(), params))
    batches = _step_batches(arch)[:1]
    _, _, one = SMOKE.zero1_run(model, plan, batches, watch=SMOKE.ZeroWatch(steps=1),
                                prepare=prepare, hyper=_hyper())
    truth = SMOKE.fp64_first_grads(model.cfg, start[0], batches[0], 1, _hyper())
    agree = SMOKE.dp_agreement(runs[0], one)
    bad, explained = SMOKE.grid_failures(agree, runs[0]["shadow_err"],
                                         [r["grads"] for r in runs], one["grads"], truth,
                                         SMOKE.whole_part)
    assert bad == [], (agree, explained)
    assert agree["loss_rel"] <= REL and agree["grad_norm_rel"] <= REL, agree


def test_checkpoint_restores_at_cp2_bit_for_bit(results):
    for r in results[(1, 2, 1)]:
        ck = r["ckpt"]
        assert ck["route"] == "replay" and ck["bit_exact"], ck["route"]
        assert ck["resumed"][0] == ck["resumed"][1]


def test_checkpoint_restores_at_cp1_bit_for_bit(results):
    """The file holds whole leaves, written by cp index 0 alone: one process
    restores it (``restore_resharded``, routed "reshard" and refused without
    ``elastic``), every leaf equal to both ranks' saved state."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ParallelPlan
    from repro_torch.train import init_train_state
    plan, model = _step_setup("qwen1.5-4b", "ring", 1)
    mgr = CheckpointManager(results["dir2"] / "ckpt", keep=2)
    assert mgr.manifest()["plan"]["cp"] == 2
    assert mgr.manifest()["mesh_axes"] == {"data": 1, "cp": 2, "model": 1}
    with pytest.raises(ValueError, match="cp"):
        mgr.check_plan(plan)
    assert mgr.check_plan(plan, elastic=True) == "reshard"
    single = init_train_state(model, torch.Generator().manual_seed(7))
    _, single = mgr.restore_resharded(single, plan=ParallelPlan(compute_dtype="float32"))
    got = SMOKE.host_named(single)
    for r in results[(1, 2, 1)]:
        saved = r["ckpt"]["saved"]
        assert sorted(saved) == sorted(got)
        assert all(np.array_equal(got[n], a) for n, a in saved.items())
