"""Fault tolerance under data parallelism with ZeRO-1: 2 gloo ranks as CPU
subprocesses (a ``file://`` store under ``tmp_path``, a timeout per spawn, as
``tests/test_torch_dp.py``).

- The integrity audit reads 0.0 on every step, and its checksum equals
  ``tree_checksum`` of the params and of the grads reassembled whole: each rank
  holds only its grad slices, so the checksum of the slices is summed over the
  ranks before the replicated part is added (``ft/integrity.py``).
- A rank-masked bitflip at ``integrity.checksum`` (rank 1 only) is an ``sdc``
  rollback on both ranks, served by each rank's RAM tier, and the run ends
  equal to the fault-free one bit for bit.
- Remesh: a ``train.step`` hang under ``policy.hang="remesh"``. Rank 1's hook
  leaves as a lost host would (the process ends); rank 0's returns a
  single-process ``RemeshSpec``, the driver reshard-restores dp 2 -> 1, no
  collective runs on the old group after the hook, and the run ends equal to
  a single-process run restored from the same checkpoint.

The model is a 3-layer dense config with d_model 33 and vocab 63, so at dp 2
the norm scales, the embedding and the LM head stay whole on every rank
beside the split projections: the audit counts both kinds."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, MemoryCheckpointTier
from repro_torch.core import (Family, InputShape, ModelConfig, ParallelPlan, RecoveryPolicy)
from repro_torch.core.sharding import opt_state_specs
from repro_torch.core.tree import leaves, named_leaves
from repro_torch.data import SyntheticDataset
from repro_torch.ft import Monitor, RemeshSpec, run_with_recovery
from repro_torch.ft.inject import FaultSpec, make_injector, trace_with_faults
from repro_torch.ft.integrity import tree_checksum
from repro_torch.launch import DataMesh, init_data_mesh
from repro_torch.models import build_model
from repro_torch.train import Hyper, init_train_state, make_train_step
from repro_torch.train import step as step_mod

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
CFG = ModelConfig("tiny-odd", Family.DENSE, n_layers=3, d_model=33, n_heads=1, n_kv_heads=1,
                  head_dim=12, d_ff=66, vocab=63)
PLAN = ParallelPlan(compute_dtype="float32", remat="none", microbatches=2, integrity="audit")
HYPER = Hyper(peak_lr=1e-3, warmup_steps=2)
AUDIT_STEPS, SDC_STEPS, SDC_AT = 3, 4, 2
REMESH_STEPS, HANG_AT = 10, 6


class InlineCheckpointManager(CheckpointManager):
    """Persists inside ``save``, so a persist failure raises at the save that
    failed (the reference tests' ``async_persist=False``)."""

    def save(self, step, tree, blocking=False, **kw):
        return super().save(step, tree, blocking=True, **kw)


def _model():
    return build_model(CFG, PLAN, device="cpu")


def _batches(n):
    ds = SyntheticDataset(CFG, InputShape("t", 16, 8, "train"))
    return [{k: torch.from_numpy(v) for k, v in ds.batch(i).items()} for i in range(n)]


def _state(model, mesh):
    return init_train_state(model, torch.Generator().manual_seed(0), mesh, PLAN)


def _host(tree):
    from repro_torch.checkpoint import store
    return {n: store._host(x)[0] for n, x in named_leaves(tree)}


def _audit(mesh, model):
    """AUDIT_STEPS audited steps; per step the metrics and the checksum of
    the params and the whole grads (gathered from the slices the sharded
    update receives)."""
    specs = opt_state_specs(model.init(torch.Generator().manual_seed(0)), mesh, PLAN)
    whole_grads = []
    real = step_mod.adamw_update_sharded

    def watch(grads, *a, **kw):
        whole = {}
        for name, g in named_leaves(grads):
            d = specs[name].dim
            whole[name] = g.clone() if d is None else mesh.all_gather(
                g.movedim(d, 0).contiguous()).movedim(0, d)
        whole_grads.append(whole)
        return real(grads, *a, **kw)

    step_mod.adamw_update_sharded = watch
    try:
        state = _state(model, mesh)
        step = make_train_step(model, PLAN, HYPER, mesh=mesh)
        out = []
        for i, batch in enumerate(_batches(AUDIT_STEPS)):
            state, m = step(state, batch)
            want = (int(tree_checksum(state.params)) + int(tree_checksum(whole_grads[i]))) \
                & 0xFFFFFFFF
            out.append({"div": float(m["integrity_div"]),
                        "checksum": int(m["integrity_checksum"]), "want": want})
    finally:
        step_mod.adamw_update_sharded = real
    split = sorted(n for n, s in specs.items() if s.dim is not None)
    kept = sorted(n for n, s in specs.items() if s.dim is None)
    return {"steps": out, "split": split, "kept": kept}


def _sdc(mesh, model, tmp):
    """SDC_STEPS steps under run_with_recovery with a rank-1 bitflip of the
    checksum at SDC_AT, against the same steps without it."""
    batches = _batches(SDC_STEPS)
    step = make_train_step(model, PLAN, HYPER, mesh=mesh)
    twin = trace_with_faults(step, specs=[FaultSpec(
        "integrity.checksum", "bitflip", step=SDC_AT, tick=None, rank=1, axis="data")])
    used = []

    def fault_step_fn(s):
        if s == SDC_AT and not used:
            used.append(s)
            return twin
        return None

    final, report = run_with_recovery(
        _state(model, mesh), step, lambda s: batches[s], SDC_STEPS,
        InlineCheckpointManager(Path(tmp) / "sdc", keep=3),
        Monitor(min_history=1000, hang_min_seconds=60.0), ckpt_every=2, plan=PLAN, mesh=mesh,
        fault_step_fn=fault_step_fn, mem_ckpt=MemoryCheckpointTier(keep=2, groups=2))
    clean = _state(model, mesh)
    losses = []
    for b in batches:
        clean, m = step(clean, b)
        losses.append(float(m["loss"]))
    a, b = _host(final), _host(clean)
    return {"actions": report.actions, "restores": report.restores,
            "mem_restores": report.mem_restores, "losses": report.losses,
            "agreements": report.agreements, "clean_losses": losses, "equal": all(np.array_equal(a[n], b[n]) for n in b)}


class _Collectives:
    """Counts the collectives this process calls on any group once ``armed``."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor", "gather",
             "barrier", "broadcast")

    def __init__(self):
        self.armed, self.after = False, []
        for name in self.NAMES:
            real = getattr(dist, name)
            setattr(dist, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def call(*a, **kw):
            if self.armed:
                self.after.append(name)
            return real(*a, **kw)
        return call


def _remesh(mesh, model, tmp, out_path):
    """REMESH_STEPS steps with a hang at HANG_AT under policy.hang="remesh"
    (module docstring). Rank 1 ends inside its hook."""
    counter = _Collectives()
    batches = _batches(REMESH_STEPS)
    ckdir = Path(tmp) / "remesh"
    single_step = make_train_step(model, PLAN, HYPER)

    def remesh():
        if mesh.rank != 0:
            out_path.write_text(json.dumps({"left_at_hook": True}))
            os._exit(0)                          # a lost host: no cleanup, no collective
        counter.armed = True
        return RemeshSpec(train_step=single_step, state_template=_state(model, None),
                          plan=PLAN, mesh=DataMesh())

    final, report = run_with_recovery(
        _state(model, mesh), make_train_step(model, PLAN, HYPER, mesh=mesh),
        lambda s: batches[s], REMESH_STEPS, InlineCheckpointManager(ckdir, keep=3),
        Monitor(min_history=4, hang_min_seconds=0.3), ckpt_every=4, plan=PLAN, mesh=mesh,
        fault_injector=make_injector([FaultSpec("train.step", "hang", step=HANG_AT,
                                                sleep_s=1.0)]),
        policy=RecoveryPolicy(hang="remesh"), remesh=remesh)
    restored_from = max(s for s in range(0, HANG_AT, 4))
    ref = _state(model, None)
    _, ref = CheckpointManager(ckdir).restore_resharded(ref, step=restored_from,
                                                        mesh=DataMesh(), plan=PLAN)
    for s in range(restored_from, REMESH_STEPS):
        ref, _ = single_step(ref, batches[s])
    a, b = _host(final), _host(ref)
    return {"actions": report.actions, "remeshes": report.remeshes,
            "restores": report.restores, "steps_done": report.steps_done,
            "collectives_after_hook": counter.after, "restored_from": restored_from,
            "equal": sorted(a) == sorted(b) and all(np.array_equal(a[n], b[n]) for n in b)}


def _rank_main(rank, n, store_path, out_dir):
    torch.set_num_threads(1)
    mesh = init_data_mesh("cpu", init_method=f"file://{store_path}", rank=rank, world_size=n)
    model = _model()
    out = {"audit": _audit(mesh, model), "sdc": _sdc(mesh, model, out_dir)}
    path = Path(out_dir) / f"rank{rank}.json"
    path.write_text(json.dumps(out))
    remesh_path = Path(out_dir) / f"remesh{rank}.json"
    remesh_path.write_text(json.dumps(_remesh(mesh, model, out_dir, remesh_path)))
    os._exit(0)                                  # the old group lost rank 1: no teardown


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_ft_dp as t; "
         "t._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_dp import run_ranks
    d = tmp_path_factory.mktemp("ftdp")
    run_ranks(RANKS, d, CHILD, [], timeout=240)
    return [{**json.loads((d / f"rank{r}.json").read_text()),
             "remesh": json.loads((d / f"remesh{r}.json").read_text())} for r in range(RANKS)]


def test_audit_reads_zero_and_checks_the_whole_state(ranks):
    for r in ranks:
        assert r["audit"]["split"] and r["audit"]["kept"]     # both kinds of leaf
        for s in r["audit"]["steps"]:
            assert s["div"] == 0.0 and s["checksum"] == s["want"]
    assert [s["checksum"] for s in ranks[0]["audit"]["steps"]] == \
        [s["checksum"] for s in ranks[1]["audit"]["steps"]]


def test_rank_masked_bitflip_is_an_sdc_rollback(ranks):
    for r in ranks:
        sdc = r["sdc"]
        assert sdc["actions"] == [[SDC_AT, "sdc", "rollback"]]
        assert sdc["restores"] == sdc["mem_restores"] == 1
        # the ranks agreed on every step run: the rolled-back one and its replay
        assert sdc["agreements"] == SDC_STEPS + 1
        assert sdc["losses"] == sdc["clean_losses"] and sdc["equal"]


def test_remesh_two_ranks_to_one(ranks):
    assert ranks[1]["remesh"] == {"left_at_hook": True}
    rm = ranks[0]["remesh"]
    assert rm["actions"] == [[HANG_AT, "hang", "remesh"]]
    assert (rm["remeshes"], rm["restores"], rm["steps_done"]) == (1, 1, REMESH_STEPS)
    assert rm["collectives_after_hook"] == []
    assert rm["equal"]
