"""ZeRO-3 / FSDP on ``torch.distributed``: 2 and 4 gloo ranks as CPU
subprocesses (a ``file://`` store under ``tmp_path``, as
``tests/test_torch_dp.py``), smoke configs in fp32.

- The ZeRO-3 step (``plan.dp_shard`` 2, the params split over the data
  ranks and gathered per layer) against the port's single-process step on
  the same global batch and weights, 3 steps, by chip_smoke.py's DP checks
  (``DP_TOLERANCE``: the first step's loss and grad norm to 1e-6 relative and
  its grads to 1e-6 of each leaf's max, every update to 1e-6 of each leaf's
  max against ``adamw_update`` on the same whole grads), and here in fp32
  every step's loss and grad norm to 1e-6: dense (microbatches 1 and 2,
  remat none, full and selective, ZeRO stages 0 and 1), MoE (a no-drop
  capacity: routing is per rank), Mamba2 (also with one SSM head, whose
  A_log, D and dt_bias split whole layers over the ranks: the gather is a
  broadcast from the owner), the zamba2 hybrid (its shared block gathered
  at each application), the VLM backbone and whisper.
- The first ZeRO-3 step at dp 2 from the reference's weights against the
  reference's single-device step (``tests/test_torch_train.py``'s bounds).
- A ``dp_over_model`` (1, 2) grid, whose model axis is the data domain,
  against a 2-rank data mesh: bit for bit.
- A ZeRO-3 checkpoint written at dp_shard 2, restored at dp_shard 2
  ("replay"), onto one process (``restore_resharded``, "reshard"), and from
  there, saved again, at dp_shard 4: bit for bit; the reference's
  ``CheckpointManager`` restores the dp_shard 2 file.
- The integrity audit under ZeRO-3: 0.0, and the checksum of the whole
  params and grads.
- A remesh under dp_shard 2: a hang under ``policy.hang="remesh"``, rank 1
  leaving as a lost host, rank 0 reshard-restoring onto one process, the run
  ending equal to a single-process run restored from the same checkpoint."""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, store
from repro_torch.core import InputShape, ParallelPlan, RecoveryPolicy, get_smoke_config
from repro_torch.core.sharding import fsdp_part, opt_state_specs
from repro_torch.core.tree import leaves, named_leaves
from repro_torch.data import SyntheticDataset
from repro_torch.ft import Monitor, RemeshSpec, run_with_recovery
from repro_torch.ft.inject import FaultSpec, make_injector
from repro_torch.ft.integrity import tree_checksum
from repro_torch.launch import DataMesh, data_mesh, init_data_mesh, init_grid_mesh
from repro_torch.models import build_model
from repro_torch.train import Hyper, init_train_state, make_train_step
from repro_torch.train.fsdp import gather_fsdp

from test_torch_dp import SMOKE, run_ranks

torch.set_num_threads(1)

STEPS = 3
HYPER = Hyper(peak_lr=1e-3, warmup_steps=2)
ROWS = 8
# case id -> (arch, data ranks, microbatches, remat, zero_stage)
CASES = {
    "qwen1.5-4b-dp2-mb1-none": ("qwen1.5-4b", 2, 1, "none", 1),
    "qwen1.5-4b-dp2-mb2-full": ("qwen1.5-4b", 2, 2, "full", 1),
    "qwen1.5-4b-dp2-mb2-selective-zero0": ("qwen1.5-4b", 2, 2, "selective", 0),
    "olmoe-1b-7b-dp2": ("olmoe-1b-7b", 2, 2, "full", 1),
    "mamba2-370m-dp2": ("mamba2-370m", 2, 2, "full", 1),
    "mamba2-370m-1head-dp2": ("mamba2-370m-1head", 2, 2, "selective", 1),
    "whisper-small-dp2": ("whisper-small", 2, 2, "selective", 1),
    "zamba2-1.2b-dp2": ("zamba2-1.2b", 2, 2, "full", 1),
    "pixtral-12b-dp2": ("pixtral-12b", 2, 1, "none", 1),
    "qwen1.5-4b-dp4": ("qwen1.5-4b", 4, 2, "full", 1),
    "olmoe-1b-7b-dp4": ("olmoe-1b-7b", 4, 1, "none", 0),
    "mamba2-370m-dp4": ("mamba2-370m", 4, 2, "full", 1),
    "whisper-small-dp4": ("whisper-small", 4, 2, "none", 1),
}
REMAP_CASE = "qwen1.5-4b-dp2-mb2-full"           # rerun on a (1, 2) grid under the remap
REF_CASE = "qwen1.5-4b-dp2-reference"
CKPT_ARCH = "qwen1.5-4b"
REMESH_STEPS, HANG_AT = 10, 6


def _config(arch):
    """The smoke config; MoE at a capacity that drops nothing; "-1head" with
    its SSM heads merged into one."""
    cfg = get_smoke_config(arch.removesuffix("-1head"))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    if arch.endswith("-1head"):
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=cfg.ssm.expand * cfg.d_model))
    return cfg


def _plan(microbatches, remat="none", zero_stage=1, dp_shard=2, **kw):
    return ParallelPlan(compute_dtype="float32", remat=remat, microbatches=microbatches,
                        zero_stage=zero_stage, dp_shard=dp_shard, **kw)


def _batches(arch, n=STEPS):
    ds = SyntheticDataset(_config(arch), InputShape("t", 16, ROWS, "train"))
    return [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(n)]


def _random_taps(params):
    """The SSM families zero their conv taps and gated-norm scale at init;
    draw them whole (the same draws on every rank and in one process), and
    keep each rank's part of a ZeRO-3 leaf."""
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for lp in params["layers"]:
            for k in ("conv_x", "conv_B", "conv_C", "scale") if "ssm" in lp else ():
                t = lp["ssm"][k]
                part = fsdp_part(t)
                full = 0.3 * torch.randn(part.whole if part is not None else t.shape,
                                         generator=g)
                if part is not None and part.dim is not None:
                    full = full.narrow(part.dim, t.shape[part.dim] * _RANK[0],
                                       t.shape[part.dim])
                if t.numel():
                    t.copy_(full)


_RANK = [0]                                    # the data rank _random_taps cuts for


def _run(arch, microbatches, mesh=None, remat="none", zero_stage=1, batches=None, **kw):
    """chip_smoke's ``zero1_run`` at the smoke config, from seed 0, every
    step watched (under a mesh each update held to adamw_update on the same
    whole grads): its results and the watch's ``shadow_err``."""
    plan = _plan(microbatches, remat, zero_stage, **kw)
    model = build_model(_config(arch), plan, device="cpu", mesh=mesh)
    watch = SMOKE.ZeroWatch(steps=STEPS, shadow=True)
    _RANK[0] = data_mesh(mesh).rank if mesh is not None else 0
    _, _, out = SMOKE.zero1_run(model, plan, batches or _batches(arch), mesh, watch=watch,
                                prepare=_random_taps, hyper=HYPER)
    return {**out, "shadow_err": watch.shadow_err}


def _whole_state(state, mesh, plan=None):
    """A state's params and moments (ZeRO-3 by default, else on ``plan``'s
    layout) whole, by name, on the host."""
    params = gather_fsdp(state.params, mesh)
    specs = opt_state_specs(state.params, mesh, plan or _plan(2))
    out = {f"params/{n}": store._host(x)[0] for n, x in named_leaves(params)}
    for which in ("mu", "nu"):
        for name, m in named_leaves(getattr(state.opt, which)):
            d = specs[name].dim
            full = m if d is None else mesh.all_gather(m.movedim(d, 0).contiguous()).movedim(0, d)
            out[f"opt/{which}/{name}"] = full.numpy().copy()
    out["opt/step"] = np.asarray(state.opt.step, np.int32)
    return out


def _ckpt_state(mesh, plan, seed):
    model = build_model(_config(CKPT_ARCH), plan, device="cpu", mesh=mesh)
    return model, init_train_state(model, torch.Generator().manual_seed(seed), mesh, plan)


def _checkpoint_dp2(mesh, out_dir):
    """One ZeRO-3 step at dp_shard 2, saved; the whole state kept for the
    test process; a restore at dp_shard 2 into fresh params, bit for bit."""
    plan = _plan(2)
    model, state = _ckpt_state(mesh, plan, 0)
    state, _ = make_train_step(model, plan, HYPER, mesh=mesh)(state, _batches(CKPT_ARCH)[0])
    mgr = CheckpointManager(Path(out_dir) / "ck_dp2", keep=2)
    mgr.save(1, state, plan=plan, mesh=mesh)
    mgr.wait()
    whole = _whole_state(state, mesh)
    if mesh.rank == 0:
        np.savez(Path(out_dir) / "ck_dp2_whole.npz", **{k.replace("/", "|"): v
                                                        for k, v in whole.items()})
    _, fresh = _ckpt_state(mesh, plan, 7)
    _, fresh = mgr.restore(fresh, mesh=mesh, plan=plan)
    got = _whole_state(fresh, mesh)
    return {"route": mgr.check_plan(plan, mesh=mesh),
            "manifest_dp_shard": mgr.manifest()["plan"]["dp_shard"],
            "bit_exact": sorted(got) == sorted(whole)
            and all(np.array_equal(got[k], whole[k]) for k in whole)}


def _restore_dp4(mesh, out_dir):
    """On 4 ranks: the dp_shard 1 checkpoint (written by the test process)
    restored at dp_shard 4, and the dp_shard 2 one onto ZeRO stages 1 and 0
    with whole params: each rank's parts, gathered, equal the saved state."""
    saved = {k.replace("|", "/"): v for k, v in np.load(Path(out_dir) / "ck_dp2_whole.npz").items()}
    out = {}
    for case, ck, plan in (("dp_shard4", "ck_dp1", _plan(2, dp_shard=4)),
                           ("zero1", "ck_dp2", _plan(2, dp_shard=1, zero_stage=1)),
                           ("zero0", "ck_dp2", _plan(2, dp_shard=1, zero_stage=0))):
        mgr = CheckpointManager(Path(out_dir) / ck)
        _, fresh = _ckpt_state(mesh, plan, 7)
        route = mgr.check_plan(plan, mesh=mesh, elastic=True)
        _, fresh = mgr.restore_resharded(fresh, mesh=mesh, plan=plan)
        got = _whole_state(fresh, mesh, plan)
        out[case] = {"route": route, "bit_exact": sorted(got) == sorted(saved)
                     and all(np.array_equal(got[k], saved[k]) for k in saved)}
    return out


def _first_step(mesh, params_path):
    """REF_CASE on this rank: one ZeRO-3 step from the reference's weights
    (converted, saved at ``params_path``); the first step's loss, grad norm,
    clipped grads and whole params and moments after it."""
    src = dict(named_leaves(torch.load(params_path, weights_only=False)))
    plan = _plan(2)
    model = build_model(_config("qwen1.5-4b"), plan, device="cpu", mesh=mesh)

    def load(params):
        with torch.no_grad():
            for name, p in named_leaves(params):
                for t, s in zip(leaves(p), leaves(src[name])):
                    part = fsdp_part(t)
                    if part is not None and part.dim is not None:
                        s = s.narrow(part.dim, mesh.rank * t.shape[part.dim], t.shape[part.dim])
                    t.copy_(s)
    state, _, out = SMOKE.zero1_run(model, plan, _batches("qwen1.5-4b")[:1], mesh,
                                    watch=SMOKE.ZeroWatch(), prepare=load, hyper=HYPER)
    whole = _whole_state(state, mesh)
    out["mu"] = {k[7:]: v for k, v in whole.items() if k.startswith("opt/mu/")}
    out["nu"] = {k[7:]: v for k, v in whole.items() if k.startswith("opt/nu/")}
    return out


AUDIT_ARCH = "mamba2-370m-1head"        # parts split in layers, on layers, and whole


def _audit(mesh):
    """One ZeRO-3 step under ``integrity="audit"``: its divergence and
    checksum, and the checksum of the whole params after it and the whole
    clipped grads (what the parts must sum to over the ranks)."""
    plan = _plan(2, integrity="audit")
    model = build_model(_config(AUDIT_ARCH), plan, device="cpu", mesh=mesh)
    _RANK[0] = mesh.rank
    _, _, out = SMOKE.zero1_run(model, plan, _batches(AUDIT_ARCH)[:1], mesh,
                                watch=SMOKE.ZeroWatch(), prepare=_random_taps, hyper=HYPER)
    whole = [torch.from_numpy(a) for d in (out["params"], out["grads"]) for a in d.values()]
    return {"div": out["integrity_div"][0], "checksum": out["integrity_checksum"][0],
            "want": int(tree_checksum(whole))}


class InlineCheckpointManager(CheckpointManager):
    """Persists inside ``save``, so a persist failure raises at its save."""

    def save(self, step, tree, blocking=False, **kw):
        return super().save(step, tree, blocking=True, **kw)


def _remesh(mesh, out_dir, out_path):
    """REMESH_STEPS ZeRO-3 steps with a hang at HANG_AT under
    policy.hang="remesh": rank 1 ends inside its hook (a lost host), rank 0
    continues on one process from the last checkpoint."""
    plan = _plan(2)
    batches = _batches(CKPT_ARCH, REMESH_STEPS)
    ckdir = Path(out_dir) / "remesh"
    model, state = _ckpt_state(mesh, plan, 0)
    single_model = build_model(_config(CKPT_ARCH), plan, device="cpu")
    single_step = make_train_step(single_model, plan, HYPER)

    def fresh_single():
        return init_train_state(single_model, torch.Generator().manual_seed(0), None, plan)

    def remesh():
        if mesh.rank != 0:
            out_path.write_text(json.dumps({"left_at_hook": True}))
            os._exit(0)                          # a lost host: no cleanup, no collective
        return RemeshSpec(train_step=single_step, state_template=fresh_single(), plan=plan,
                          mesh=DataMesh())

    final, report = run_with_recovery(
        state, make_train_step(model, plan, HYPER, mesh=mesh), lambda s: batches[s],
        REMESH_STEPS, InlineCheckpointManager(ckdir, keep=3),
        Monitor(min_history=4, hang_min_seconds=0.3), ckpt_every=4, plan=plan, mesh=mesh,
        fault_injector=make_injector([FaultSpec("train.step", "hang", step=HANG_AT,
                                                sleep_s=4.0)]),
        policy=RecoveryPolicy(hang="remesh"), remesh=remesh)
    restored_from = max(s for s in range(0, HANG_AT, 4))
    _, ref = CheckpointManager(ckdir).restore_resharded(fresh_single(), step=restored_from,
                                                        mesh=DataMesh(), plan=plan)
    for s in range(restored_from, REMESH_STEPS):
        ref, _ = single_step(ref, batches[s])
    a, b = SMOKE.host_named(final), SMOKE.host_named(ref)
    return {"actions": report.actions, "remeshes": report.remeshes,
            "restores": report.restores, "steps_done": report.steps_done,
            "equal": sorted(a) == sorted(b) and all(np.array_equal(a[n], b[n]) for n in b)}


def _rank_main(rank, n, store_path, out_dir):
    """One rank of a group of ``n``: its cases, then (dp 2) the reference's
    first step, the remap on a (1, 2) grid, the checkpoint at dp_shard 2 and
    the remesh, or (dp 4) the restore at dp_shard 4."""
    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    mesh = init_data_mesh("cpu", init_method=f"file://{store_path}", rank=rank, world_size=n)
    res = {}
    for case, (arch, ranks, mb, remat, stage) in CASES.items():
        if ranks == n:
            res[case] = _run(arch, mb, mesh, remat, stage)
    if n == 4:
        res["restore_dp4"] = _restore_dp4(mesh, out_dir)
        torch.save(res, out_dir / f"rank{rank}.pt")
        mesh.close()
        return
    res[REF_CASE] = _first_step(mesh, out_dir / "reference_params.pt")
    res["audit"] = _audit(mesh)
    res["checkpoint"] = _checkpoint_dp2(mesh, out_dir)
    mesh.close()
    grid = init_grid_mesh(1, 2, "cpu", init_method=f"file://{store_path}_grid", rank=rank,
                          dp_over_model=True)
    arch, _, mb, remat, stage = CASES[REMAP_CASE]
    res["remap"] = _run(arch, mb, grid, remat, stage, dp_over_model=True)
    res["remap_mesh"] = repr(grid)
    grid.close()
    torch.save(res, out_dir / f"rank{rank}.pt")
    mesh = init_data_mesh("cpu", init_method=f"file://{store_path}_remesh", rank=rank,
                          world_size=n)
    path = out_dir / f"remesh{rank}.json"
    path.write_text(json.dumps(_remesh(mesh, out_dir, path)))
    os._exit(0)                                  # the old group lost rank 1: no teardown


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_fsdp_ranks as t; "
         "t._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])")


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device step (``repro.train.make_train_step``,
    2 microbatches) on qwen1.5-4b's smoke config from its own seed-0 weights
    and the first global batch: those weights in the port's layout, the
    step's loss, grad norm and lr, and its params and moments after the step
    by name (stacked)."""
    import jax
    import jax.numpy as jnp
    from repro import core as jcore
    from repro.checkpoint.store import _flatten_with_names
    from repro.data import SyntheticDataset as JaxDataset
    from repro.models import build_model as jax_build_model
    from repro.train import Hyper as JaxHyper
    from repro.train import init_train_state as jax_init, make_train_step as jax_step
    from repro_torch.interop import params_from_numpy
    cfg = jcore.get_smoke_config("qwen1.5-4b")
    plan = jcore.ParallelPlan(remat="none", compute_dtype="float32", microbatches=2)
    model = jax_build_model(cfg, plan)
    state = jax_init(model, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, state.params), _config("qwen1.5-4b"),
                               device="cpu")
    batch = JaxDataset(cfg, jcore.InputShape("t", 16, ROWS, "train")).batch(0)
    state, metrics = jax_step(model, plan, JaxHyper(*HYPER))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    named = lambda tree: {n: np.asarray(a) for n, a in _flatten_with_names(tree)}  # noqa: E731
    return {"params": params, **{k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")},
            "new_params": named(state.params), "mu": named(state.opt.mu),
            "nu": named(state.opt.nu)}


@pytest.fixture(scope="module")
def results(tmp_path_factory, reference):
    """The 2-rank group, the dp_shard 1 step of the checkpoint in this
    process, then the 4-rank group: {"dp2": [rank results], "dp4": [...],
    "remesh": [...], "dp1": the one-process restore, "dir": the directory}."""
    d = tmp_path_factory.mktemp("fsdp")
    torch.save(reference["params"], d / "reference_params.pt")
    run_ranks(2, d, CHILD, [], timeout=400)
    out = {"dir": d, "dp2": [torch.load(d / f"rank{r}.pt", weights_only=False)
                             for r in range(2)],
           "remesh": [json.loads((d / f"remesh{r}.json").read_text()) for r in range(2)]}
    plan = _plan(2, dp_shard=1)
    mgr = CheckpointManager(d / "ck_dp2")
    _, one = _ckpt_state(None, plan, 7)
    route = mgr.check_plan(plan, elastic=True)
    _, one = mgr.restore_resharded(one, plan=plan)
    got = SMOKE.host_named(one)
    saved = {k.replace("|", "/"): v for k, v in np.load(d / "ck_dp2_whole.npz").items()}
    out["dp1"] = {"route": route, "bit_exact": sorted(got) == sorted(saved)
                  and all(np.array_equal(got[k], saved[k]) for k in saved)}
    d4 = tmp_path_factory.mktemp("fsdp4")                 # a store of its own
    CheckpointManager(d4 / "ck_dp1").save(1, one, plan=plan, blocking=True)
    shutil.copy(d / "ck_dp2_whole.npz", d4)
    shutil.copytree(d / "ck_dp2", d4 / "ck_dp2")
    run_ranks(4, d4, CHILD, [], timeout=400)
    out["dp4"] = [torch.load(d4 / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return out


def _ranks(results, case):
    return results["dp2" if CASES[case][1] == 2 else "dp4"]


@pytest.mark.parametrize("case", list(CASES))
def test_zero3_step_matches_single_process(results, case):
    arch, n, mb, remat, stage = CASES[case]
    ranks = _ranks(results, case)
    for r in ranks[1:]:                       # every rank reports the same
        assert (r[case]["loss"], r[case]["grad_norm"]) == \
            (ranks[0][case]["loss"], ranks[0][case]["grad_norm"])
        assert all(np.array_equal(r[case]["params"][k], a)
                   for k, a in ranks[0][case]["params"].items())
    got = ranks[0][case]
    assert len(got["shadow_err"]) == STEPS
    # MoE under DP sums its aux statistics over the ranks' rows, so one
    # process runs the same microbatches whole (tests/test_torch_ep_ranks.py)
    one = _run(arch, mb if _config(arch).moe is not None else mb * n, None, remat, stage)
    agree = SMOKE.dp_agreement(got, one)
    assert SMOKE.dp_failures(agree, got["shadow_err"]) == [], agree
    assert agree["loss_rel"] <= SMOKE.DP_REL and agree["grad_norm_rel"] <= SMOKE.DP_REL, agree


def test_first_zero3_step_matches_the_reference(results, reference):
    """The first ZeRO-3 step at dp 2 against the reference's single-device
    step on the same weights and global batch, at tests/test_torch_train.py's
    bounds (as tests/test_torch_dp.py holds the ZeRO-1 step)."""
    from test_torch_train import B1, GRAD_REL, _step_within_bound
    dp = results["dp2"][0][REF_CASE]
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


def test_dp_over_model_grid_equals_a_data_mesh(results):
    """The remap's (1, 2) grid runs the model axis as the data domain: its
    steps equal the 2-rank data mesh's bit for bit."""
    for r in results["dp2"]:
        assert "data=1" in r["remap_mesh"] and "model=2" in r["remap_mesh"]
        got, want = r["remap"], r[REMAP_CASE]
        assert got["loss"] == want["loss"] and got["grad_norm"] == want["grad_norm"]
        assert all(np.array_equal(got["params"][k], a) for k, a in want["params"].items())


def test_checkpoint_reshards_across_dp_shard_bit_for_bit(results):
    """dp_shard 2 -> 2 ("replay"), 2 -> 1 and 1 -> 4 ("reshard"), and the
    ZeRO-3 file onto ZeRO stages 1 and 0 at dp 4: every restore equals the
    saved state bit for bit; the manifest records the plan's dp_shard."""
    for r in results["dp2"]:
        ck = r["checkpoint"]
        assert ck == {"route": "replay", "manifest_dp_shard": 2, "bit_exact": True}
    assert results["dp1"] == {"route": "reshard", "bit_exact": True}
    for r in results["dp4"]:
        assert r["restore_dp4"] == {case: {"route": "reshard", "bit_exact": True}
                                    for case in ("dp_shard4", "zero1", "zero0")}


def test_check_plan_refuses_a_dp_shard_change_unless_elastic(results):
    mgr = CheckpointManager(results["dir"] / "ck_dp2")
    with pytest.raises(ValueError, match="dp_shard"):
        mgr.check_plan(_plan(2, dp_shard=1))
    assert mgr.check_plan(_plan(2, dp_shard=1), elastic=True) == "reshard"


def test_zero3_checkpoint_restores_in_the_reference(results):
    """The reference's CheckpointManager reassembles the ranks' param and
    moment slices into its single-device TrainState, bit for bit."""
    import jax
    from repro.checkpoint import CheckpointManager as RefManager
    from repro.checkpoint import store as ref_store
    from repro.core import ParallelPlan as RefPlan
    from repro.core import get_smoke_config as ref_smoke
    from repro.models import build_model as ref_build
    from repro.train import init_train_state as ref_init
    model = ref_build(ref_smoke(CKPT_ARCH), RefPlan(remat="none", compute_dtype="float32"))
    like = ref_init(model, jax.random.PRNGKey(1))
    step, restored = RefManager(results["dir"] / "ck_dp2").restore(like)
    assert step == 1
    theirs = {n: np.asarray(x) for n, x in ref_store._flatten_with_names(restored)}
    saved = {k.replace("|", "/"): v
             for k, v in np.load(results["dir"] / "ck_dp2_whole.npz").items()}
    assert sorted(theirs) == sorted(saved)
    for name, a in saved.items():
        assert a.dtype == theirs[name].dtype and np.array_equal(a, theirs[name]), name


def test_audit_counts_the_param_parts(results):
    """The integrity audit under ZeRO-3 reads 0.0, and its checksum is the
    whole state's: each rank's param parts (its layers of a leaf split on
    the layer dim, its slices, the whole leaves once) summed over the ranks
    as the grad slices are."""
    for r in results["dp2"]:
        a = r["audit"]
        assert a["div"] == 0.0 and a["checksum"] == a["want"], a


def test_remesh_under_dp_shard(results):
    assert results["remesh"][1] == {"left_at_hook": True}
    rm = results["remesh"][0]
    assert rm["actions"] == [[HANG_AT, "hang", "remesh"]]
    assert (rm["remeshes"], rm["restores"], rm["steps_done"]) == (1, 1, REMESH_STEPS)
    assert rm["equal"]
