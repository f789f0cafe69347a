"""Fail-slow defense walkthrough: detect, attribute, rebalance.

    PYTHONPATH=src python -m repro_torch.examples.straggler_rebalance              # on the card
    PYTHONPATH=src python -m repro_torch.examples.straggler_rebalance --device cpu

The reference's recipe (``examples/straggler_rebalance.py``) on a (pod 2,
data 2) grid, four rank processes: the ``slow-demo`` config (4 layers, d_model
64, 4 heads, 2 KV heads, d_ff 128, vocab 256; head dim 16), ``pp=2``,
``microbatches=4``, seq 32, batch 8, SGD at 1e-3 over ``pipelined_loss_fn``, 18
steps, ``ckpt_every=3``. A ``slow`` fault on ``pp.stage.tick`` pins a host
delay of ``sleep_s`` a layer to stage 1 from step 6 on;
``StragglerDetector(window=8, factor=2.0, confirm=3, min_seconds=1e-3)`` and
the ``StragglerTimer`` attribute it to (rank=1, pp.stage, compute), and
``RecoveryPolicy(straggler="rebalance", max_restores=4)`` calls the
``rebalance`` hook, which returns a ``RemeshSpec`` at the new ``pp_layout``:
(2, 2) -> (3, 1), restored through the elastic reshard path. The run asserts
exactly one rebalance and prints each action.

The ranks agree on each step's straggler event (``ft.recovery.agree``), so
every rank takes the same action. ``sleep_s`` is the reference's 0.04 s; on a
loaded host a step's own time can come near the factor 2, so the CPU tests
raise it.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time

import torch

from repro_torch.examples import ranks as _ranks

STEPS = 18
CKPT_EVERY = 3
LR = 1e-3
SLEEP_S = 0.04
GRID = {"pod": 2, "data": 2}


def demo_config():
    from repro_torch.core import Family, ModelConfig
    return ModelConfig("slow-demo", Family.DENSE, n_layers=4, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab=256)


def grad_norm(params, plan, grid):
    """The global grad norm of a rank's pipelined params: each group of
    leaves split over rings (``pipeline_splits``) summed over them, a leaf
    every rank holds whole counted once."""
    from repro_torch.core.tree import named_leaves
    from repro_torch.train.pipeline import pipeline_splits
    grads = {n: (torch.stack([p.grad for p in x]) if isinstance(x, list) else x.grad)
             for n, x in named_leaves(params)}
    sq = lambda names: sum(grads[n].float().square().sum() for n in names)  # noqa: E731
    split, total = set(), None
    for rings, names in pipeline_splits(params, plan, grid):
        part = sq(names).reshape(1)
        for ring in rings:
            part = ring.all_reduce_sum(part)
        total = part if total is None else total + part
        split |= names
    whole = sq([n for n in grads if n not in split])
    return torch.sqrt((total[0] if total is not None else 0.0) + whole)


def sgd_step(cfg, plan, grid):
    """SGD at LR over the pipelined loss (the reference's ``make_step``):
    the step updates this rank's params in place; the moments of the
    ``TrainState`` it carries are not touched."""
    from repro_torch.core.tree import leaves
    from repro_torch.train.pipeline import pipelined_loss_fn
    loss_fn = pipelined_loss_fn(cfg, plan, grid, ("data",))

    def step(state, batch):
        params = state.params
        for p in leaves(params):
            p.grad = None
        loss, _ = loss_fn(params, batch)
        loss.backward()
        gn = grad_norm(params, plan, grid)
        with torch.no_grad():
            for p in leaves(params):
                p.sub_(p.grad, alpha=LR)
                p.grad = None
        return state, {"loss": loss.detach(), "grad_norm": gn}
    return step


def rank_job(rank, init_method, device, sleep_s=SLEEP_S, check_plain=False):
    """One rank of the walkthrough (module docstring). Returns the run's
    report readings and its B1-B4 launches; with ``check_plain`` also
    ``checks["first"]``: the first step's loss and its backward through the
    kernels against the plain versions (``ranks.route_check``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import InputShape, ParallelPlan, RecoveryPolicy
    from repro_torch.data import SyntheticDataset
    from repro_torch.ft import (Monitor, RemeshSpec, StragglerDetector, StragglerTimer,
                                run_with_recovery)
    from repro_torch.ft.inject import FaultSpec, armed
    from repro_torch.launch import init_grid_mesh
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    from repro_torch.train.pipeline import pipelined_loss_fn
    dev = _ranks.rank_device(rank, device)
    grid = init_grid_mesh(GRID["data"], 1, dev, pod=GRID["pod"], backend="gloo",
                          init_method=init_method, rank=rank)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = demo_config()
    plan = ParallelPlan(remat="none", compute_dtype="float32", pp=2, microbatches=4)
    model = build_model(cfg, plan, device=dev)
    ds = SyntheticDataset(cfg, InputShape("demo", 32, 8, "train"))

    def get_batch(s):
        return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(s).items()}

    def state_for(pl):
        return init_train_state(model, torch.Generator(device=dev).manual_seed(0), grid, pl)

    out = {"checks": {}}
    if check_plain:
        out["checks"]["first"] = _ranks.route_check(
            lambda impl: pipelined_loss_fn(cfg, _ranks.routed(plan, impl), grid, ("data",)),
            state_for(plan).params, get_batch(0))
    before = _ranks.launches()
    _ranks.reset_peak(dev)
    detector = StragglerDetector(window=8, factor=2.0, confirm=3, min_seconds=1e-3)
    timer = StragglerTimer(cfg=cfg, plan=plan, detector=detector)
    policy = RecoveryPolicy(straggler="rebalance", max_restores=4)
    monitor = Monitor(hang_min_seconds=60.0)       # the straggler ladder owns this
    applied = []

    def rebalance(layout):
        say(f"[demo] rebalance hook: measured stage times "
            f"{ {r: f'{t * 1e3:.1f}ms' for r, t in timer.stage_times().items()} } "
            f"-> pp_layout {layout}", flush=True)
        applied.append(tuple(layout))
        pl2 = dataclasses.replace(plan, pp_layout=tuple(layout))
        return RemeshSpec(train_step=sgd_step(cfg, pl2, grid), state_template=state_for(pl2),
                          plan=pl2, mesh=grid)

    fault = FaultSpec("pp.stage.tick", "slow", step=6, span=999, rank=1, sleep_s=sleep_s)
    say("[demo] injecting fail-slow on pipeline stage 1 from step 6; "
        "policy.straggler = rebalance", flush=True)
    # one directory for every rank: a save on a grid is collective
    path = [tempfile.mkdtemp(prefix="straggler_") if rank == 0 else None]
    torch.distributed.broadcast_object_list(path, src=0)
    ckpt = CheckpointManager(path[0], keep=4)
    t0 = time.perf_counter()
    try:
        with armed([fault]):
            _, report = run_with_recovery(
                state_for(plan), sgd_step(cfg, plan, grid),
                get_batch, STEPS, ckpt, monitor,
                ckpt_every=CKPT_EVERY, plan=plan, mesh=grid, policy=policy, straggler=timer,
                rebalance=rebalance)
        dt = time.perf_counter() - t0
        ckpt.wait()
        torch.distributed.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(path[0], ignore_errors=True)
    grid.close()
    strag = [(a.step, a.detail) for a in report.anomalies if a.kind == "straggler"]
    assert strag and report.rebalances == 1, (strag, report.rebalances)
    say(f"[demo] first attribution at step {strag[0][0]}: {strag[0][1]}")
    for s, kind, action in report.actions:
        say(f"[demo]   step {s}: {kind} -> {action}")
    say(f"[demo] {report.steps_done} steps in {dt:.1f}s, rebalances={report.rebalances}, "
        f"restores={report.restores}, final loss {report.losses[-1]:.4f}")
    say("[demo] straggler rebalance walkthrough OK", flush=True)
    out.update({"steps_done": report.steps_done, "rebalances": report.rebalances,
                "restores": report.restores, "applied": applied, "stragglers": strag,
                "actions": report.actions, "losses": report.losses, "seconds": dt,
                "peak_bytes": _ranks.peak_bytes(dev), "launches": _ranks.launches_since(before)})
    return out


RANKS = GRID["pod"] * GRID["data"]
TIMEOUT = 900.0       # seconds, the whole spawn


def run(device=None, sleep_s: float = SLEEP_S):
    """The walkthrough on its four ranks; returns each rank's readings."""
    return _ranks.spawn([(rank_job, {"sleep_s": sleep_s})], RANKS, device, TIMEOUT)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--sleep-s", type=float, default=SLEEP_S,
                    help="the injected delay a layer on stage 1 (seconds)")
    args = ap.parse_args()
    run(args.device, args.sleep_s)


if __name__ == "__main__":
    main()
