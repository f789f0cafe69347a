"""Tensor parallelism on spawned ranks: gloo CPU processes on a (data, model)
grid (``launch.mesh.init_grid_mesh``) with a ``file://`` store under
``tmp_path``, as in ``tests/test_torch_dp.py``.

- The four rings (``train/tensor_parallel.py``) at tp 2 and 4, forward and
  backward, against single-process math at the reference test's tolerances
  (``tests/test_tensor_parallel.py:99-152``: rtol 1e-5 / 1e-4, atol 1e-6).
- The port's TP loss and grads against the reference's ``make_tp_loss_fn`` on
  the same weights and batch (the reference test's tiny configs; dense and
  Mamba2 on grids (1, 2) and (2, 2), MoE with the einsum and the scatter
  dispatch on (1, 2); ``z_loss=1e-4``), at its tolerances (loss 2e-6
  absolute, grads rtol 1e-4 / atol 1e-6), and the loss against the port's own
  single-process loss to 1e-6. The reference runs in a forced-host-device
  subprocess (``tests/conftest.py::run_multidevice``) and its weights are
  carried across (``interop.tp_params_from_numpy``). Leaving the replicated
  leaves' grads unsummed over the model ring must fail the same check.
- ``make_train_step`` on a grid for 3 steps against one process, by
  chip_smoke.py's ``GRID_TOLERANCE`` (the DP checks, ``dp_agreement`` and
  ``dp_failures``, with a leaf past 1e-6 of its max held to an fp64
  evaluation: no further from it than twice one process's distance plus
  1e-6), the data replicas' params bit-equal; the rule fails a moved leaf and
  the control, a bf16 partial sum in every row GEMM's ring.
- The ``tp.ring.tick`` fault seam armed with nan: the NaN reaches the loss.
- A checkpoint saved at tp 2, restored at tp 2 and at tp 1, bit for bit.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.sharding import leaf_tp_dim, tp_shard_of

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
Z_LOSS = 1e-4
REL = 1e-6
GRID_CASES = {2: (1, 2), 4: (2, 2)}           # world size -> (data, model)
# loss case -> (reference case, grids it runs on, remat)
LOSS_CASES = {
    "dense": ("dense", [(1, 2), (2, 2)], "none"),
    "dense-remat-full": ("dense", [(1, 2)], "full"),
    "dense-remat-selective": ("dense", [(1, 2)], "selective"),
    "moe": ("moe", [(1, 2)], "none"),
    "moe_scatter": ("moe_scatter", [(1, 2)], "none"),
    "ssm": ("ssm", [(1, 2), (2, 2)], "none"),
    "ssm-remat-selective": ("ssm", [(1, 2)], "selective"),
}
# train-step case -> (smoke arch, grid)
STEP_CASES = {
    "qwen1.5-4b-1x2": ("qwen1.5-4b", (1, 2)),
    "deepseek-moe-16b-1x2": ("deepseek-moe-16b", (1, 2)),
    "qwen1.5-4b-2x2": ("qwen1.5-4b", (2, 2)),
    "mamba2-370m-2x2": ("mamba2-370m", (2, 2)),
}

# the reference's overlap loss and grads (its test's tiny configs, z_loss 1e-4),
# its weights (conv taps and gated-norm scale of the SSM drawn at random, so
# the scan does real work) and batch, pickled to the path in argv[1]
REF_SCRIPT = """
import sys, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.core import (Family, InputShape, ModelConfig, MoEConfig, SSMConfig, ParallelPlan)
from repro.checkpoint.store import _flatten_with_names
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.train.tensor_parallel import make_tp_loss_fn
MOE = ('ModelConfig("tmoe", Family.MOE, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, '
       'd_ff=0, vocab=128, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, '
       'num_shared_experts=1, capacity_factor=2.0))')
CASES = {
 "dense": ('ModelConfig("tiny", Family.DENSE, n_layers=2, d_model=64, n_heads=4, '
           'n_kv_heads=2, d_ff=128, vocab=128)', "einsum", [(1, 2), (2, 2)]),
 "moe": (MOE, "einsum", [(1, 2)]),
 "moe_scatter": (MOE, "scatter", [(1, 2)]),
 "ssm": ('ModelConfig("tssm", Family.SSM, n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, '
         'd_ff=0, vocab=128, ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8))',
         "einsum", [(1, 2), (2, 2)]),
}
res = {}
for name, (cfg_s, dispatch, meshes) in CASES.items():
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
    res[name] = {"cfg": cfg_s, "dispatch": dispatch, "params": params, "batch": batch}
    for ms in meshes:
        mesh = jax.make_mesh(ms, ("data", "model"))
        plan = ParallelPlan(remat="none", compute_dtype="float32", tp=2, tp_impl="overlap",
                            moe_dispatch=dispatch)
        lf = make_tp_loss_fn(cfg, plan, mesh, ("data",), z_loss=%r)
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: lf(p, b)[0]))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        res[name][ms] = {"loss": float(loss),
                         "grads": {n: np.asarray(a) for n, a in _flatten_with_names(grads)}}
pickle.dump(res, open(sys.argv[1], "wb"))
""" % Z_LOSS


def _smoke():
    """chip_smoke.py, whose DP checks the train-step case shares."""
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


def _rings(ring):
    """The four rings on ``ring`` against single-process math on the same
    seeded inputs: (ours, reference) pairs of this rank's parts."""
    from repro_torch.train.tensor_parallel import (all_gather_matmul, matmul_reduce_scatter,
                                                   ring_all_gather, ring_reduce_scatter)
    t, idx = ring.size, ring.rank
    b, s, d, f = 2, 8, 6, 12
    g = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(*sh, generator=g) for sh in ((b, s, d), (d, f), (f, d)))
    cs = [torch.randn(b, s, d, generator=g) for _ in range(t)]
    ys = [torch.randn(b, s, d, generator=g) for _ in range(t)]
    sl, fl = slice(idx * s // t, (idx + 1) * s // t), slice(idx * f // t, (idx + 1) * f // t)
    leaf = lambda a: a.detach().clone().requires_grad_(True)          # noqa: E731

    xl, w1l, w2l = leaf(x[:, sl]), leaf(w1[:, fl]), leaf(w2[fl])
    (o1,), xg = all_gather_matmul(ring, xl, (w1l,))
    o2 = matmul_reduce_scatter(ring, o1, w2l)
    rs = ring_reduce_scatter(ring, xg.detach())        # the sum of t identical copies
    torch.sin(o2).sum().backward()
    xr, w1r, w2r = leaf(x), leaf(w1), leaf(w2)
    torch.sin((xr @ w1r) @ w2r).sum().backward()

    xa = leaf(x[:, sl])
    (torch.sin(ring_all_gather(ring, xa)) * cs[idx]).sum().backward()
    xf = leaf(x)
    sum((torch.sin(xf) * c).sum() for c in cs).backward()

    yl = leaf(ys[idx])
    (torch.sin(ring_reduce_scatter(ring, yl)) * cs[idx][:, sl]).sum().backward()
    yf = [leaf(y) for y in ys]
    tot = sum(yf)
    sum((torch.sin(tot[:, slice(r * s // t, (r + 1) * s // t)])
         * cs[r][:, slice(r * s // t, (r + 1) * s // t)]).sum() for r in range(t)).backward()

    np_ = lambda a: a.detach().numpy().copy()           # noqa: E731
    return {
        "exact": {"o1": (np_(o1), np_(x @ w1)[..., fl]), "xg": (np_(xg), np_(x)),
                  "rs": (np_(rs), np_(t * x[:, sl]) if t == 2 else np_(rs))},
        "fwd": {"o2": (np_(o2), np_((x @ w1) @ w2)[:, sl]),
                "rs_sum": (np_(ring_reduce_scatter(ring, xg.detach())), np_(t * x[:, sl]))},
        "grad": {"x": (np_(xl.grad), np_(xr.grad)[:, sl]), "w1": (np_(w1l.grad), np_(w1r.grad)[:, fl]),
                 "w2": (np_(w2l.grad), np_(w2r.grad)[fl]),
                 "all_gather_x": (np_(xa.grad), np_(xf.grad)[:, sl]),
                 "reduce_scatter_y": (np_(yl.grad), np_(yf[idx].grad))},
    }


def _loss(grid, ref, remat, sum_replicated=True, faults=None):
    """The port's TP loss on this rank's shards of the reference's weights and
    its rows of the batch, backward, the replicated leaves' grads summed over
    the model ring (unless told not to), every grad and the loss meaned over
    the data ranks. Returns the loss and this rank's grads (stacked)."""
    from repro_torch.core import ParallelPlan
    from repro_torch.core.tree import leaves
    from repro_torch.ft import inject
    from repro_torch.interop import tp_params_from_numpy
    from repro_torch.launch import rank_microbatches
    from repro_torch.train.step import sum_grid_grads
    from repro_torch.train.executor import make_executor_loss_fn, resolve_context
    cfg = _cfg(ref["cfg"])
    plan = ParallelPlan(remat=remat, compute_dtype="float32", tp=2, tp_impl="overlap",
                        moe_dispatch=ref["dispatch"])
    params = tp_params_from_numpy(ref["params"], cfg, grid.model.rank, 2, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    mb = rank_microbatches(batch, grid.data, 1)[0]
    with inject.armed(faults or []):
        total, _ = make_executor_loss_fn(cfg, plan, grid, z_loss=Z_LOSS)(params, mb)
        total.backward()
    if sum_replicated:
        sum_grid_grads(params, plan, resolve_context(cfg, plan, grid))
    for p in leaves(params):
        grid.data.all_reduce_mean(p.grad)
    loss = grid.data.all_reduce_mean(total.detach().clone())
    return {"loss": float(loss), "grads": _stacked({"g": _grads(params)})}


def _grads(params):
    from repro_torch.core.tree import map_tree
    return map_tree(lambda p: p.grad, params)


def _step(grid, arch):
    """chip_smoke's ``zero1_run`` on the grid at ``arch``'s smoke config, STEPS
    steps from seed 0, every step watched (the ZeRO-1 update held to
    adamw_update on the same whole grads)."""
    plan, model = _step_setup(arch, grid.shape["model"], 2)
    watch = SMOKE.ZeroWatch(steps=STEPS, shadow=True)
    _, _, out = SMOKE.zero1_run(model, plan, _step_batches(arch), grid, watch=watch,
                                prepare=_random_taps, hyper=_hyper())
    return {**out, "shadow_err": watch.shadow_err}


def _control(grid):
    """The dense smoke config's first step on the grid with chip_smoke's
    ``bf16_partial_sum`` control in place: this rank's clipped grads."""
    plan, model = _step_setup("qwen1.5-4b", grid.shape["model"], 2)
    watch = SMOKE.ZeroWatch(steps=1)
    with SMOKE.bf16_partial_sum():
        SMOKE.zero1_run(model, plan, _step_batches("qwen1.5-4b")[:1], grid, watch=watch,
                        prepare=_random_taps, hyper=_hyper())
    return watch.grads


def _hyper():
    from repro_torch import train as ttrain
    return ttrain.Hyper(peak_lr=1e-3, warmup_steps=2)


def _step_setup(arch, tp, microbatches):
    from repro_torch.core import ParallelPlan, get_smoke_config
    from repro_torch.models import build_model
    plan = ParallelPlan(compute_dtype="float32", remat="none", microbatches=microbatches, tp=tp)
    return plan, build_model(get_smoke_config(arch), plan, device="cpu")


def _step_batches(arch):
    from repro_torch.core import InputShape, get_smoke_config
    from repro_torch.data import SyntheticDataset
    ds = SyntheticDataset(get_smoke_config(arch), InputShape("t", 16, 8, "train"))
    return [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(STEPS + 1)]


def _ckpt(grid, out_dir):
    """A train state after one step saved at tp 2, routed and restored at tp
    2 into a fresh state, and the step after it from both states."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import init_train_state, make_train_step
    plan, model = _step_setup("qwen1.5-4b", 2, 1)
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


def _rank_main(rank, world, store, out_dir):
    """One rank: every job of its grid in turn, results saved."""
    import torch.distributed as dist
    from repro_torch.ft.inject import FaultSpec
    from repro_torch.launch import ModelRing, init_grid_mesh
    torch.set_num_threads(1)
    data, model = GRID_CASES[world]
    grid = init_grid_mesh(data, model, "cpu", init_method=f"file://{store}", rank=rank)
    with open(Path(out_dir) / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    out = {"model_index": grid.model.rank, "data_index": grid.data.rank,
           "rings": _rings(grid.model)}
    if world == 4:
        ranks = tuple(range(world))
        out["rings4"] = _rings(ModelRing(dist.new_group(list(ranks)), ranks, "cpu"))
    for case, (ref_case, grids, remat) in LOSS_CASES.items():
        if (data, model) in grids:
            out[f"loss/{case}"] = _loss(grid, ref[ref_case], remat)
    if (data, model) == (1, 2):
        out["loss/dense-unsummed"] = _loss(grid, ref["dense"], "none", sum_replicated=False)
        out["fault"] = _loss(grid, ref["dense"], "none", faults=[
            FaultSpec("tp.ring.tick", "nan", tick=0)])["loss"]
        out["ckpt"] = _ckpt(grid, out_dir)
        out["control"] = _control(grid)
    for case, (arch, g) in STEP_CASES.items():
        if g == (data, model):
            out[f"step/{case}"] = _step(grid, arch)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    grid.close()


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_tp_ranks as t; "
         "t._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])")


def _run_ranks(n, out_dir, timeout):
    """``n`` rank processes of ``_rank_main``; fail with their output if any
    exits non-zero or outlives ``timeout`` seconds."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(REPO / "src"), str(REPO / "tests"),
                               str(r), str(n), str(out_dir / "store"), str(out_dir)],
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
    path = tmp_path_factory.mktemp("tp_ref") / "reference.pkl"
    multidevice(REF_SCRIPT.replace("sys.argv[1]", repr(str(path))), n_devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(reference, tmp_path_factory):
    """Each grid's ranks run once: {world size: [rank results]}."""
    out = {}
    for n in GRID_CASES:
        d = tmp_path_factory.mktemp(f"tp{n}")
        with open(d / "reference.pkl", "wb") as f:
            pickle.dump(reference, f)
        _run_ranks(n, d, timeout=240)
        out[n] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
        out[f"dir{n}"] = d
    return out


def _ranks_of(results, grid):
    return results[grid[0] * grid[1]]


# ---------------------------------------------------------------------------
# the rings


@pytest.mark.parametrize("tp", [2, 4])
def test_rings_against_single_process_math(results, tp):
    """Forward: the column GEMM tiles and the gathered copy exact, the row
    GEMM's ring sum to rtol 1e-5 / atol 1e-6; backward (the mirrored rings):
    rtol 1e-4 / atol 1e-6, as the reference's own ring test."""
    ranks = results[2] if tp == 2 else results[4]
    key = "rings" if tp == 2 else "rings4"
    for r in ranks:
        rings = r[key]
        for name, (ours, ref) in rings["exact"].items():
            np.testing.assert_array_equal(ours, ref, err_msg=name)
        for name, (ours, ref) in rings["fwd"].items():
            np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6, err_msg=name)
        for name, (ours, ref) in rings["grad"].items():
            np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# loss and grads against the reference and against one process


def _loss_cases():
    return [(c, g) for c, (_, grids, _) in LOSS_CASES.items() for g in grids]


def _check_grads(ranks, ref_grads):
    """Every rank's grads against its TP shard of the reference's (rtol 1e-4,
    atol 1e-6); raises AssertionError naming the first leaf that misses."""
    for r in ranks:
        got = r["grads"]
        assert sorted(got) == sorted(f"g/{n}" for n in ref_grads)
        for name, a in ref_grads.items():
            np.testing.assert_allclose(got[f"g/{name}"], tp_shard_of(name, a, r["model_index"], 2),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case,grid", _loss_cases(), ids=lambda v: (
    v if isinstance(v, str) else f"{v[0]}x{v[1]}"))
def test_tp_loss_matches_the_reference(results, reference, case, grid):
    ref_case, _, _ = LOSS_CASES[case]
    ref = reference[ref_case][grid]
    ranks = [{**r[f"loss/{case}"], "model_index": r["model_index"]}
             for r in _ranks_of(results, grid)]
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) < 2e-6, (r["loss"], ref["loss"])
    _check_grads(ranks, ref["grads"])


@pytest.mark.parametrize("case,grid", _loss_cases(), ids=lambda v: (
    v if isinstance(v, str) else f"{v[0]}x{v[1]}"))
def test_tp_loss_matches_one_process(results, reference, case, grid):
    """The TP loss against the port's own single-process loss on the same
    weights and batch, to 1e-6."""
    from repro_torch.core import ParallelPlan
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_loss_fn
    ref_case, _, _ = LOSS_CASES[case]
    ref = reference[ref_case]
    cfg = _cfg(ref["cfg"])
    model = build_model(cfg, ParallelPlan(remat="none", compute_dtype="float32",
                                          moe_dispatch=ref["dispatch"]), device="cpu")
    params = params_from_numpy(ref["params"], cfg, device="cpu")
    with torch.no_grad():
        one, _ = make_loss_fn(model, Hyper(z_loss=Z_LOSS))(
            params, {k: torch.from_numpy(v) for k, v in ref["batch"].items()})
    for r in _ranks_of(results, grid):
        assert abs(r[f"loss/{case}"]["loss"] - float(one)) <= REL, (case, float(one))


def test_unsummed_replicated_grads_fail(results, reference):
    """The negative case: the replicated leaves' grads left as each rank's
    share fail the reference comparison (the loss itself is unaffected)."""
    ref = reference["dense"][(1, 2)]
    ranks = [{**r["loss/dense-unsummed"], "model_index": r["model_index"]} for r in results[2]]
    assert all(abs(r["loss"] - ref["loss"]) < 2e-6 for r in ranks)
    with pytest.raises(AssertionError, match="scale|bq|bk|bv"):
        _check_grads(ranks, ref["grads"])


def test_fault_seam_reaches_the_loss(results):
    """``tp.ring.tick`` armed with nan at tick 0: one element of the first
    landed ring payload is NaN, and the loss every rank reports is NaN."""
    assert all(np.isnan(r["fault"]) for r in results[2])
    assert all(np.isfinite(r["loss/dense"]["loss"]) for r in results[2])


# ---------------------------------------------------------------------------
# the train step


def _single_step(arch, data):
    """One process's run of the same batches: ``data`` times the microbatches,
    so each microbatch holds the rows one data rank's does; also the first
    step's clipped grads evaluated in fp64 from the same weights
    (``fp64_first_grads``)."""
    from repro_torch.core.tree import map_tree
    plan, model = _step_setup(arch, 1, 2 * data)
    start = []

    def prepare(params):
        _random_taps(params)
        start.append(map_tree(lambda p: p.detach().clone(), params))
    batches = _step_batches(arch)
    _, _, out = SMOKE.zero1_run(model, plan, batches, watch=SMOKE.ZeroWatch(steps=STEPS),
                                prepare=prepare, hyper=_hyper())
    truth = SMOKE.fp64_first_grads(model.cfg, start[0], batches[0], 2 * data, _hyper())
    return out, truth


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_one_process(results, case):
    """STEPS steps on the grid against one process by chip_smoke.py's
    GRID_TOLERANCE: DP_TOLERANCE (the first step's loss and grad norm to 1e-6
    relative, every watched ZeRO-1 update against adamw_update on the same
    grads, and each leaf's clipped grads to 1e-6 of its max against its shard
    of one process's), where a leaf past 1e-6 must be no further from an fp64
    evaluation of the step than twice one process's distance plus 1e-6; the
    later steps' loss and grad norm (fp32) to 1e-6 as well. Every rank
    reports the same, and the ranks of one model index (the data replicas)
    hold the same params bit for bit."""
    arch, grid = STEP_CASES[case]
    ranks = _ranks_of(results, grid)
    runs = [r[f"step/{case}"] for r in ranks]
    for run in runs[1:]:
        assert (run["loss"], run["grad_norm"]) == (runs[0]["loss"], runs[0]["grad_norm"])
    for r, run in zip(ranks, runs):
        for r2, run2 in zip(ranks, runs):
            if r2["model_index"] == r["model_index"]:
                assert all(np.array_equal(run2["params"][n], a) for n, a in run["params"].items())
    one, truth = _single_step(arch, grid[0])
    shards = [run["grads"] for r, run in sorted(zip(ranks, runs), key=lambda p: p[0]["model_index"])
              if r["data_index"] == 0]
    for r, run in zip(ranks, runs):
        m = r["model_index"]
        cut = {k: {n: tp_shard_of(n, a, m, grid[1]) for n, a in one[k].items()}
               for k in ("grads", "params")}
        agree = SMOKE.dp_agreement(run, {**one, **cut})
        bad, explained = SMOKE.grid_failures(agree, run["shadow_err"], shards, one["grads"], truth)
        assert bad == [], (agree, explained)
        assert agree["loss_rel"] <= REL and agree["grad_norm_rel"] <= REL, agree


def test_the_grads_rule_fails_a_wrong_grad(results):
    """GRID_TOLERANCE's grads rule is no free pass: one process's own grads
    pass it, and one leaf of a rank's grads moved by 1e-3 of its max fails
    it."""
    arch, grid = STEP_CASES["qwen1.5-4b-1x2"]
    runs = [r["step/qwen1.5-4b-1x2"] for r in sorted(results[2], key=lambda r: r["model_index"])]
    one, truth = _single_step(arch, grid[0])
    ok = [{n: tp_shard_of(n, a, m, 2) for n, a in one["grads"].items()} for m in range(2)]
    assert SMOKE.grid_grad_failures(ok, one["grads"], truth) == ([], {})
    shards = [dict(run["grads"]) for run in runs]
    name = "layers/mlp/down"
    shards[1][name] = shards[1][name] + 1e-3 * np.abs(shards[1][name]).max()
    bad, _ = SMOKE.grid_grad_failures(shards, one["grads"], truth)
    assert any(b.startswith(name) for b in bad), bad


def test_the_grads_rule_fails_a_bf16_partial_sum(results):
    """The rule's control (chip_smoke's ``bf16_partial_sum``): the first step
    with each row GEMM's ring adding the rank's own partial product rounded
    to bf16 fails the grads rule against one process, fp64 evaluation and
    all."""
    arch, grid = STEP_CASES["qwen1.5-4b-1x2"]
    one, truth = _single_step(arch, grid[0])
    shards = [r["control"] for r in sorted(results[2], key=lambda r: r["model_index"])]
    bad, _ = SMOKE.grid_grad_failures(shards, one["grads"], truth)
    assert bad, "the control passes the grads rule"


# ---------------------------------------------------------------------------
# the checkpoint


def test_checkpoint_restores_at_tp2_bit_for_bit(results):
    for r in results[2]:
        ck = r["ckpt"]
        assert ck["route"] == "replay" and ck["bit_exact"], ck["route"]
        assert ck["resumed"][0] == ck["resumed"][1]


def test_checkpoint_restores_at_tp1_bit_for_bit(results):
    """The file holds whole leaves: one process restores it
    (``restore_resharded``, routed "reshard" and refused without
    ``elastic``), and every leaf is the ranks' TP shards put together."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import ParallelPlan
    from repro_torch.train import init_train_state
    _, model = _step_setup("qwen1.5-4b", 1, 1)
    plan1 = ParallelPlan(compute_dtype="float32", remat="none", microbatches=1)
    mgr = CheckpointManager(results["dir2"] / "ckpt", keep=2)
    with pytest.raises(ValueError, match="tp"):
        mgr.check_plan(plan1)
    assert mgr.check_plan(plan1, elastic=True) == "reshard"
    single = init_train_state(model, torch.Generator().manual_seed(7))
    _, single = mgr.restore_resharded(single, plan=plan1)
    got = SMOKE.host_named(single)
    parts = [r["ckpt"]["saved"] for r in results[2]]
    for name, a in got.items():
        d = leaf_tp_dim(name, np.shape(parts[0][name]))
        want = parts[0][name] if d is None else np.concatenate([p[name] for p in parts], axis=d)
        if d is None:
            assert np.array_equal(parts[1][name], want), name
        assert np.array_equal(a, want), name
