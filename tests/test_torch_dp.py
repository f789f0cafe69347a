"""Data parallelism with ZeRO-1 on ``torch.distributed``: the port's step on 2
and 4 gloo ranks (CPU subprocesses) against its own single-process step on
the same global batch and weights, 3 steps each, by chip_smoke.py's DP checks
(``DP_TOLERANCE``, ROADMAP's 1e-6 rule for parallel against one device): the
first step's loss and grad norm to 1e-6 relative and its grads to 1e-6 of each
leaf's largest value, every ZeRO-1 update to 1e-6 of each leaf's largest value
against ``adamw_update`` on the same whole grads; here in fp32 also the loss and
grad norm of every step to 1e-6; and the replicas' params equal bit for bit.

The single-process step runs n times the microbatches, so every microbatch
holds the same rows in both runs (``launch.mesh.rank_microbatches``) and only
the order of the fp32 sums differs. The params after 3 steps are not held to
1e-6 of each leaf's largest value: AdamW divides each grad by its own running
size, so an element whose grad sits at its sum-order error moves by up to lr
either way in any two sum orders; two single-process runs that differ only in
their microbatch count differ by 6e-3 of a leaf's max on qwen1.5-4b's smoke
config (``test_params_drift_between_two_sum_orders_of_one_device``). The
reference's own ZeRO-1 cannot run as an oracle on this host's jax (ROADMAP
queue C), but its single-device step can: the first ZeRO-1 step at dp 2 is
held to it directly on the same weights and global batch
(``test_first_zero1_step_matches_the_reference``, at
``tests/test_torch_train.py``'s bounds)."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import train as ttrain
from repro_torch.core import InputShape, ParallelPlan, get_smoke_config
from repro_torch.data import SyntheticDataset
from repro_torch.core.sharding import opt_state_specs
from repro_torch.core.tree import leaves, named_leaves
from repro_torch.launch import DataMesh, init_data_mesh, rank_microbatches
from repro_torch.models import build_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
REL = 1e-6
HYPER = ttrain.Hyper(peak_lr=1e-3, warmup_steps=2)

# case id -> (arch, data ranks, global batch, microbatches, zero_stage, wrong reduction)
CASES = {
    "qwen1.5-4b-dp2": ("qwen1.5-4b", 2, 8, 2, 1, False),
    "whisper-small-dp2": ("whisper-small", 2, 8, 2, 1, False),
    "mamba2-370m-dp2": ("mamba2-370m", 2, 8, 2, 1, False),
    "qwen1.5-4b-dp2-zero0": ("qwen1.5-4b", 2, 8, 2, 0, False),
    # 6 rows in one microbatch shard over dp 2: 3 rows a rank
    "qwen1.5-4b-dp2-rows6": ("qwen1.5-4b", 2, 6, 1, 1, False),
    # the negative case: the reduce-scatter's sum left undivided by the size
    "qwen1.5-4b-dp2-no-mean": ("qwen1.5-4b", 2, 8, 2, 1, True),
    "qwen1.5-4b-dp4": ("qwen1.5-4b", 4, 8, 2, 1, False),
    "whisper-small-dp4": ("whisper-small", 4, 8, 2, 1, False),
    "mamba2-370m-dp4": ("mamba2-370m", 4, 8, 2, 1, False),
    # 6 rows do not divide by 4: the reference replicates the batch, and every
    # rank takes all of them
    "qwen1.5-4b-dp4-rows6": ("qwen1.5-4b", 4, 6, 2, 1, False),
    # one SSM head: A_log, D and dt_bias are (2 layers, 1), split whole layers
    # a rank at dp 2 (as mamba2-370m's (48, 32) at full size) and stay whole on
    # every rank at dp 4, beside leaves split on other dims
    "mamba2-370m-1head-dp2": ("mamba2-370m-1head", 2, 8, 2, 1, False),
    "mamba2-370m-1head-dp4": ("mamba2-370m-1head", 4, 8, 2, 1, False),
}
# one step of qwen1.5-4b's smoke config at dp 2 from the reference's weights,
# held to the reference's single-device step on the same global batch
REF_CASE, REF_ARCH, REF_ROWS = "qwen1.5-4b-dp2-reference", "qwen1.5-4b", 8
GROUPS = {n: [c for c, v in CASES.items() if v[1] == n] for n in (2, 4)}
GROUPS[2].append(REF_CASE)


def _config(arch):
    """The smoke config; "<arch>-1head" with its SSM heads merged into one."""
    cfg = get_smoke_config(arch.removesuffix("-1head"))
    if arch.endswith("-1head"):
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=cfg.ssm.expand * cfg.d_model))
    return cfg


def _setup(arch, microbatches, zero_stage=1):
    plan = ParallelPlan(compute_dtype="float32", remat="none", microbatches=microbatches,
                        zero_stage=zero_stage)
    return plan, build_model(_config(arch), plan, device="cpu")


def _batches(arch, rows):
    ds = SyntheticDataset(_config(arch), InputShape("t", 16, rows, "train"))
    return [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(STEPS)]


def _random_taps(params):
    """The SSM families zero their conv taps and gated-norm scale at init, which
    zeroes every scan input; draw them so the scan does real work."""
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for lp in params["layers"]:
            for k in ("conv_x", "conv_B", "conv_C", "scale") if "ssm" in lp else ():
                lp["ssm"][k].copy_(0.3 * torch.randn(lp["ssm"][k].shape, generator=g))


def _smoke():
    """chip_smoke.py, whose DP phase's checks these tests share."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def _run(arch, microbatches, rows, mesh=None, zero_stage=1):
    """chip_smoke's ``zero1_run`` at the smoke config, STEPS steps from seed 0
    (every step watched; the ZeRO-1 update held to adamw_update under a mesh):
    its results and the watch's ``shadow_err``."""
    plan, model = _setup(arch, microbatches, zero_stage)
    watch = SMOKE.ZeroWatch(steps=STEPS, shadow=True)
    _, _, out = SMOKE.zero1_run(model, plan, _batches(arch, rows), mesh, watch=watch,
                                prepare=_random_taps, hyper=HYPER)
    return {**out, "shadow_err": watch.shadow_err}


def _first_step(mesh, params_path):
    """REF_CASE on this rank: one ZeRO-1 step from the weights saved at
    ``params_path`` (the reference's, converted); ``zero1_run``'s results
    with the moments after the step gathered whole, by name."""
    src = dict(named_leaves(torch.load(params_path, weights_only=False)))

    def load(params):
        with torch.no_grad():
            for name, p in named_leaves(params):
                for t, s in zip(leaves(p), leaves(src[name])):
                    t.copy_(s)
    plan, model = _setup(REF_ARCH, 2)
    state, _, out = SMOKE.zero1_run(model, plan, _batches(REF_ARCH, REF_ROWS)[:1], mesh,
                                    watch=SMOKE.ZeroWatch(), prepare=load, hyper=HYPER)
    specs = opt_state_specs(state.params, mesh, plan)
    for which in ("mu", "nu"):
        out[which] = {}
        for name, m in named_leaves(getattr(state.opt, which)):
            d = specs[name].dim
            out[which][name] = (m if d is None else mesh.all_gather(
                m.movedim(d, 0).contiguous()).movedim(0, d)).numpy()
    return out


def _rank_main(rank, n, store_path, out_dir, cases):
    """One rank of a group: every case of ``cases`` in turn, results saved."""
    torch.set_num_threads(1)
    mesh = init_data_mesh("cpu", init_method=f"file://{store_path}", rank=rank,
                          world_size=n)
    for case in cases:
        if case == REF_CASE:
            result = _first_step(mesh, Path(out_dir) / "reference_params.pt")
            torch.save(result, Path(out_dir) / f"{case}.rank{rank}.pt")
            continue
        arch, _, rows, mb, zero_stage, no_mean = CASES[case]
        if no_mean:
            mesh.reduce_scatter_mean = lambda inp: DataMesh.reduce_scatter_mean(
                mesh, inp) * mesh.size
        result = _run(arch, mb, rows, mesh, zero_stage)
        mesh.__dict__.pop("reduce_scatter_mean", None)
        torch.save(result, Path(out_dir) / f"{case}.rank{rank}.pt")
    mesh.close()


CHILD = ("import sys, json; sys.path[:0] = sys.argv[1:3]; import test_torch_dp as t; "
         "t._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6], "
         "json.loads(sys.argv[7]))")


def run_ranks(n, out_dir, child, args, timeout):
    """Start ``n`` rank processes running ``child`` (``python -c``) with
    (src, tests, rank, n, store file, out_dir, *args) as argv; fail with their
    output if any exits non-zero or outlives ``timeout`` seconds."""
    out_dir = Path(out_dir)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    argv = [str(REPO / "src"), str(REPO / "tests")]
    procs = [subprocess.Popen([sys.executable, "-c", child, *argv, str(r), str(n),
                               str(out_dir / "store"), str(out_dir), *args],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device step (``repro.train.make_train_step``,
    2 microbatches) on REF_ARCH's smoke config from its own seed-0 weights and
    the first global batch of REF_ROWS rows: those weights in the port's
    layout, the step's loss, grad norm and lr, and its params and moments
    after the step by name (stacked)."""
    import jax
    import jax.numpy as jnp
    from repro import core as jcore
    from repro.checkpoint.store import _flatten_with_names
    from repro.data import SyntheticDataset as JaxDataset
    from repro.models import build_model as jax_build_model
    from repro.train import Hyper, init_train_state, make_train_step
    from repro_torch.interop import params_from_numpy
    cfg = jcore.get_smoke_config(REF_ARCH)
    plan = jcore.ParallelPlan(remat="none", compute_dtype="float32", microbatches=2)
    model = jax_build_model(cfg, plan)
    state = init_train_state(model, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, state.params), _config(REF_ARCH),
                               device="cpu")
    batch = JaxDataset(cfg, jcore.InputShape("t", 16, REF_ROWS, "train")).batch(0)
    state, metrics = make_train_step(model, plan, Hyper(*HYPER))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    named = lambda tree: {n: np.asarray(a) for n, a in _flatten_with_names(tree)}  # noqa: E731
    return {"params": params, **{k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")},
            "new_params": named(state.params), "mu": named(state.opt.mu),
            "nu": named(state.opt.nu)}


@pytest.fixture(scope="module")
def results(tmp_path_factory, reference):
    """Every group's ranks run once; {case: [rank results]}."""
    out = {}
    for n, cases in GROUPS.items():
        d = tmp_path_factory.mktemp(f"dp{n}")
        if REF_CASE in cases:
            torch.save(reference["params"], d / "reference_params.pt")
        run_ranks(n, d, CHILD, [json.dumps(cases)], timeout=300)
        for c in cases:
            out[c] = [torch.load(d / f"{c}.rank{r}.pt", weights_only=False) for r in range(n)]
    return out


def _single(case):
    arch, n, rows, mb, _, _ = CASES[case]
    split = rows % n == 0
    return _run(arch, mb * n if split else mb, rows)


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if not v[5]])
def test_zero1_step_matches_single_process(results, case):
    ranks = results[case]
    for r in ranks[1:]:                       # every rank reports the same, replicas agree
        assert (r["loss"], r["grad_norm"]) == (ranks[0]["loss"], ranks[0]["grad_norm"])
        assert all(np.array_equal(r["params"][n], a) for n, a in ranks[0]["params"].items())
        assert all(np.array_equal(r["grads"][n], a) for n, a in ranks[0]["grads"].items())
    assert len(ranks[0]["shadow_err"]) == STEPS
    agree = SMOKE.dp_agreement(ranks[0], _single(case))
    assert SMOKE.dp_failures(agree, ranks[0]["shadow_err"]) == [], agree
    # in fp32 at this size the later steps hold to the same bound as well
    assert agree["loss_rel"] <= SMOKE.DP_REL and agree["grad_norm_rel"] <= SMOKE.DP_REL, agree


def test_first_zero1_step_matches_the_reference(results, reference):
    """The first ZeRO-1 step at dp 2 against the reference's single-device
    step on the same weights and global batch, by tests/test_torch_train.py's
    bounds: loss and grad norm to 1e-5 relative; the clipped grads (the
    reference's as mu / (1 - b1) at step 0) and both moments to GRAD_REL of
    each leaf's largest value; the params within the first step's bound
    (``_step_within_bound``)."""
    from test_torch_train import B1, GRAD_REL, _step_within_bound
    dp = results[REF_CASE][0]
    assert dp["loss"][0] == pytest.approx(reference["loss"], rel=1e-5)
    assert dp["grad_norm"][0] == pytest.approx(reference["grad_norm"], rel=1e-5)
    names = list(reference["mu"])
    assert sorted(dp["grads"]) == sorted(dp["mu"]) == sorted(names)
    for name in names:
        m, v = reference["mu"][name], reference["nu"][name]
        for ours, ref in ((dp["grads"][name], m / (1 - B1)), (dp["mu"][name], m),
                          (dp["nu"][name], v)):
            err = float(np.abs(ours - ref).max())
            assert err <= GRAD_REL * max(float(np.abs(ref).max()), 1e-30), (name, err)
    as_torch = lambda d: {n: torch.from_numpy(np.array(d[n], np.float32)) for n in names}  # noqa: E731
    assert _step_within_bound(as_torch(dp["params"]), as_torch(reference["new_params"]),
                              as_torch(dp["mu"]), as_torch(reference["mu"]), reference["lr"])


def test_the_bound_fails_an_undivided_reduction(results):
    """The same checks fail a reduce-scatter that sums the ranks' grads and
    leaves out the division by the size (n times the mean): the grad norm
    doubles. (The clip then divides every grad by that norm, so the clipped
    grads, and the updates, come out the same here: every leaf of this config
    is split, so all scale alike.)"""
    dp = results["qwen1.5-4b-dp2-no-mean"][0]
    bad = SMOKE.dp_failures(SMOKE.dp_agreement(dp, _single("qwen1.5-4b-dp2-no-mean")),
                            dp["shadow_err"])
    assert any(b.startswith("grad_norm_rel") for b in bad), bad


def test_params_drift_between_two_sum_orders_of_one_device():
    """Why the params after 3 steps are a reading, not a check: one device's
    step at 2 and at 4 microbatches (the same rows, another sum order) passes
    every check and still moves some param elements apart by far more than
    1e-6 of their leaf's max (qwen1.5-4b's key bias, whose grad is near 0)."""
    a, b = _run("qwen1.5-4b", 2, 8), _run("qwen1.5-4b", 4, 8)
    agree = SMOKE.dp_agreement(a, b)
    assert SMOKE.dp_failures(agree, []) == [], agree
    assert agree["loss_rel"] <= SMOKE.DP_REL and agree["params_rel"] > 1e-4, agree


def test_rank_microbatches_split_each_microbatch():
    """Rank r's microbatch i is microbatch i n + r of one device's step with n
    times the microbatches; a batch whose rows do not divide goes whole to
    every rank, and one that divides into microbatches that do not raises."""
    batch = {"tokens": torch.arange(16).reshape(8, 2), "labels": torch.arange(8)}
    one = ttrain.step._split_microbatches(batch, 4)
    for r in range(2):
        mesh = types.SimpleNamespace(shape={"data": 2}, size=2, rank=r)
        mbs = rank_microbatches(batch, mesh, 2)
        for i, mb in enumerate(mbs):
            assert all(torch.equal(mb[k], one[i * 2 + r][k]) for k in batch)
    six = {k: v[:6] for k, v in batch.items()}
    mesh = types.SimpleNamespace(shape={"data": 4}, size=4, rank=3)
    whole = rank_microbatches(six, mesh, 2)
    assert [mb["labels"].tolist() for mb in whole] == [[0, 1, 2], [3, 4, 5]]
    # 6 rows shard over dp 2 in the reference; 3 rows a microbatch cannot
    mesh = types.SimpleNamespace(shape={"data": 2}, size=2, rank=1)
    with pytest.raises(ValueError, match="microbatch"):
        rank_microbatches(six, mesh, 2)


def test_moe_raises_under_data_parallelism():
    """MoE under data parallelism routes each rank's own rows, its aux
    statistics summed over the data group (the reference executor's
    ``batch_axes`` rule): the step builds on 2 and 4 ranks with that
    placement; it raises only where a plan asks for an expert ring the mesh
    cannot hold (ep > 1 needs a model axis); one rank is the single-process
    step. The step itself is held to one device in test_torch_ep_ranks.py."""
    from repro_torch.core import ParallelPlan
    from repro_torch.train.executor import resolve_context
    plan, model = _setup("olmoe-1b-7b", 2)
    for n in (2, 4):
        mesh = types.SimpleNamespace(shape={"data": n}, size=n, rank=0)
        ttrain.make_train_step(model, plan, HYPER, mesh=mesh)
        ctx = resolve_context(model.cfg, plan, mesh)
        assert ctx.data is mesh and ctx.n_rep == n and ctx.tp is ctx.cp is ctx.ep is None
        with pytest.raises(ValueError, match="model"):
            ttrain.make_train_step(model, ParallelPlan(ep=2, compute_dtype="float32"),
                                   HYPER, mesh=mesh)
    ttrain.make_train_step(model, plan, HYPER, mesh=DataMesh())


def test_mesh_of_one_process_is_the_single_process_step():
    """A mesh with no process group (its collectives identities) runs the
    ZeRO-1 code on one rank; it agrees with the step without a mesh."""
    dp = _run("whisper-small", 2, 4, DataMesh())
    agree = SMOKE.dp_agreement(dp, _run("whisper-small", 2, 4))
    assert SMOKE.dp_failures(agree, dp["shadow_err"]) == [], agree

