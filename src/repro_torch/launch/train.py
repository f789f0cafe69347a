"""End-to-end training driver (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen1.5-4b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --full --arch whisper-small \\
        --batch 2 --seq 448 --ckpt-dir /path/to/ckpt          # on the card
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen1.5-4b ...

The reference's flags, names, defaults and choices, and one more:
``--device`` (default the CUDA card; ``cpu`` runs the plain path). It drives
the port's whole substrate as the reference's driver drives its own: the
synthetic data (``--prefetch``: one batch ahead on a background thread),
the train step with remat and microbatches, the disk checkpoint tier (async
persist; ``--async-snapshot`` the double buffer on a side stream), the
host-RAM tier (``--ckpt-memory-keep K`` snapshots, each member mirrored on its
neighbour group unless ``--no-peer-redundancy``), anomaly-driven recovery
(the ``--on-*`` table), straggler attribution, the preemption guard and the
flight recorder. ``--resume`` continues from the latest checkpoint in
``--ckpt-dir``, one written on another layout included (reshard-restore).

Preemption: a SIGTERM or SIGUSR1 is caught between steps; the driver takes a
just-in-time snapshot within ``--preempt-grace`` seconds, writes the
``PREEMPTED`` marker and the flight log, prints the preemption line and exits
0. Rerun with ``--resume`` to continue bit-identically. Ctrl-C (SIGINT) dumps
the flight log and exits 130.

Ranks come from the environment, as ``torchrun`` sets it: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. With no
world size, or 1, one process trains alone, with no mesh. With ``n`` > 1 the
ranks form a (data 1, model n) grid (``init_grid_mesh``; gloo on the CPU,
NCCL on ``cuda:LOCAL_RANK``), as the reference's local mesh puts every device
on its model axis: an MoE model whose expert count ``n`` divides rides it as
an expert ring (``ep = n``; attention a cp ring over it), any other model as
the tensor-parallel rings (``tp = n``). Every rank takes the same global
batch, prints nothing but rank 0, and keeps its own shards in its RAM tier
(``groups = max(2, n)``). A family the port's rings cannot run on the model
axis (the encoder-decoder, VLM and hybrid families) is refused, never run as
replicated copies (ROADMAP queue C).

``main(argv)`` parses, then :func:`build` (config, plan, model, hyper, train
state, step fns, batch source) and :func:`run` (the recovery driver; returns
``(state, report)``). Tests and ``chip_smoke.py`` call ``build`` and ``run``
in process. ``--log-every`` is parsed and not read, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, MemoryCheckpointTier
from repro_torch.core import (ARCH_IDS, RECOVERY_ACTIONS, Family, InputShape, ParallelPlan,
                              RecoveryPolicy, resolve_device)
from repro_torch.core.sharding import grid_place, whole_shape
from repro_torch.core.tree import named_leaves, stacked_shape
from repro_torch.data import Prefetcher, SyntheticDataset
from repro_torch.ft import FlightRecorder, Monitor, StragglerTimer, run_with_recovery
from repro_torch.ft.preempt import PreemptionGuard
from repro_torch.models import build_model
from repro_torch.train import Hyper, init_train_state, make_train_step
from repro_torch.train.executor import check_cp_support
from repro_torch.train.tensor_parallel import check_overlap_support
from .mesh import batch_axes_for, init_grid_mesh
from .stepbuilder import resolve_config


def parser() -> argparse.ArgumentParser:
    """The reference's flags (``repro/launch/train.py:50-144``) and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the arch's published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="selective", choices=["none", "selective", "full"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir instead of "
                         "starting fresh; one written on another layout is reshard-restored")
    ap.add_argument("--async-snapshot", action="store_true",
                    help="double-buffer the device -> host checkpoint snapshot on a side "
                         "stream (one extra state copy on the card at most)")
    ap.add_argument("--on-nan", default="rollback", choices=RECOVERY_ACTIONS,
                    help="recovery action for a non-finite loss or grad norm")
    ap.add_argument("--on-spike", default="rollback", choices=RECOVERY_ACTIONS,
                    help="recovery action for a first loss spike at a step")
    ap.add_argument("--on-repeated-spike", default="lr_rescue", choices=RECOVERY_ACTIONS,
                    help="action when the same step spikes again after a rollback")
    ap.add_argument("--on-hang", default="ignore", choices=RECOVERY_ACTIONS,
                    help="action for a hung or straggling step; 'ignore' logs only")
    ap.add_argument("--on-straggler", default="ignore", choices=RECOVERY_ACTIONS,
                    help="action for a confirmed fail-slow attribution")
    ap.add_argument("--straggler-factor", type=float, default=2.0,
                    help="relative slowdown that counts as slow")
    ap.add_argument("--straggler-window", type=int, default=16,
                    help="sliding-window length of the straggler detector")
    ap.add_argument("--straggler-confirm", type=int, default=3,
                    help="consecutive slow observations before an attribution")
    ap.add_argument("--prefetch", action="store_true",
                    help="build the next batch on a background thread during the step")
    ap.add_argument("--rescue-lr-scale", type=float, default=0.1,
                    help="LR multiplier of the lr_rescue step")
    ap.add_argument("--max-restores", type=int, default=3,
                    help="give up after this many checkpoint restores")
    ap.add_argument("--simulate-hang-at", type=int, default=-1,
                    help="fault injection: sleep 2 s before this step (-1 = off)")
    ap.add_argument("--integrity", default="off", choices=["off", "audit"],
                    help="'audit': an exact param/grad checksum every step, "
                         "cross-checked over the data ranks (routed through --on-sdc)")
    ap.add_argument("--on-sdc", default="rollback", choices=RECOVERY_ACTIONS,
                    help="recovery action for a checksum divergence")
    ap.add_argument("--ckpt-memory-keep", type=int, default=2,
                    help="host-RAM ring of the last K snapshots, restored before any "
                         "disk walk; 0 disables the tier")
    ap.add_argument("--no-peer-redundancy", dest="peer_redundancy", action="store_false",
                    default=True,
                    help="no mirror of each group's RAM members on its neighbour (half "
                         "the RAM; a lost group is then served from disk)")
    ap.add_argument("--preempt-grace", type=float, default=30.0,
                    help="seconds between a preemption notice (SIGTERM/SIGUSR1) and the "
                         "kill; the just-in-time snapshot's tier is chosen to fit them")
    ap.add_argument("--flight-len", type=int, default=256,
                    help="flight recorder ring capacity (events)")
    ap.add_argument("--flight-path", default=None,
                    help="where the flight recorder dumps its JSON (default: "
                         "<ckpt-dir>/flight.json)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cuda:LOCAL_RANK in a world of more "
                         "than one); 'cpu' runs the plain path")
    return ap


def parse(argv=None) -> argparse.Namespace:
    return parser().parse_args(argv)


@dataclasses.dataclass
class Built:
    """What :func:`build` makes and :func:`run` drives."""
    cfg: Any
    plan: ParallelPlan
    model: Any
    hyper: Hyper
    state: Any
    step_fn: Callable
    rescue_fn: Optional[Callable]
    dataset: SyntheticDataset               # the global batch of a step, as numpy arrays
    device: torch.device
    mesh: Any = None                        # the (1, n) grid, or None
    rank: int = 0
    world: int = 1


def env_ranks():
    """(rank, world size, local rank) from the environment (torchrun's names)."""
    world = int(os.environ.get("WORLD_SIZE") or 1)
    rank = int(os.environ.get("RANK") or 0)
    local = int(os.environ.get("LOCAL_RANK") or rank)
    return rank, world, local


def model_axis_plan(cfg, n: int):
    """(tp, ep) on a model axis of ``n`` ranks, the reference's fold
    (``repro/launch/train.py:152-154``): an MoE model whose expert count
    ``n`` divides takes the expert ring, any other the tp rings. Raises
    ValueError for a family the port's rings cannot run there."""
    ep = n if cfg.family == Family.MOE and cfg.moe.num_experts % n == 0 else 1
    tp = 1 if ep > 1 else n
    try:
        if ep > 1:
            check_cp_support(cfg, n)
        else:
            check_overlap_support(cfg, ParallelPlan(tp=n), n)
    except ValueError as e:
        raise ValueError(f"--arch {cfg.arch_id} on a model axis of {n} ranks: {e}; the CLI "
                         "runs no replicated copies (ROADMAP queue C, the CLI on the "
                         "model axis)") from e
    return tp, ep


def _mesh(device: torch.device, rank: int, world: int):
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not (addr and port):
        raise RuntimeError(f"WORLD_SIZE={world} needs MASTER_ADDR and MASTER_PORT")
    return init_grid_mesh(data=1, model=world, device=device,
                          init_method=f"tcp://{addr}:{port}", rank=rank)


def _param_count(params, plan, mesh) -> int:
    """The whole model's parameters (a rank's shards counted as their whole
    leaves)."""
    sizes = grid_place(mesh)[1] if mesh is not None else {}
    return sum(math.prod(whole_shape(name, stacked_shape(x), plan, sizes))
               for name, x in named_leaves(params))


def build(args: argparse.Namespace) -> Built:
    """Config, plan, model, hyper, the train state from seed 0, the step fns
    and the batch source, as ``repro/launch/train.py:146-200`` builds them."""
    rank, world, local = env_ranks()
    device = resolve_device(args.device)
    if world > 1 and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    cfg = resolve_config(args.arch, "train_4k", smoke=args.smoke)
    shape = InputShape("cli", args.seq, args.batch, "train")
    tp, ep = model_axis_plan(cfg, world) if world > 1 else (1, 1)
    mesh = _mesh(device, rank, world) if world > 1 else None
    baxes = batch_axes_for(mesh, args.batch) if mesh is not None else ()
    plan = ParallelPlan(tp=tp, ep=ep, remat=args.remat, microbatches=args.microbatches,
                        compute_dtype="float32" if args.smoke else "bfloat16",
                        integrity=args.integrity)
    model = build_model(cfg, plan, device=device, mesh=mesh, batch_axes=baxes)
    hyper = Hyper(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                  total_steps=args.steps)
    state = init_train_state(model, torch.Generator(device=device).manual_seed(0),
                             mesh=mesh, plan=plan)
    if rank == 0:
        print(f"[train] arch={cfg.arch_id} params={_param_count(state.params, plan, mesh) / 1e6:.1f}M "
              f"devices={world} batch={args.batch} seq={args.seq}", flush=True)
    step_fn = make_train_step(model, plan, hyper, mesh=mesh)
    rescue_fn = None
    if "lr_rescue" in (args.on_spike, args.on_repeated_spike, args.on_nan, args.on_hang):
        rescue_fn = make_train_step(
            model, plan, hyper._replace(peak_lr=args.lr * args.rescue_lr_scale), mesh=mesh)
    ds = SyntheticDataset(cfg, shape)
    return Built(cfg, plan, model, hyper, state, step_fn, rescue_fn, ds, device, mesh, rank,
                 world)


def run(args: argparse.Namespace, built: Built):
    """The recovery driver over ``args.steps`` steps (``repro/launch/train.py:
    201-254``); returns ``(state, report)``. A preempted run returns after the
    preemption line; Ctrl-C raises SystemExit(130) after the flight dump."""
    say = (lambda msg: print(msg, flush=True)) if built.rank == 0 else (lambda msg: None)
    device, plan, mesh = built.device, built.plan, built.mesh
    flight = FlightRecorder(maxlen=args.flight_len,
                            path=args.flight_path or f"{args.ckpt_dir}/flight.json")
    ckpt = CheckpointManager(args.ckpt_dir, keep=2, async_snapshot=args.async_snapshot,
                             flight=flight)
    monitor = Monitor(flight=flight)
    policy = RecoveryPolicy(
        nan=args.on_nan, spike=args.on_spike, repeated_spike=args.on_repeated_spike,
        hang=args.on_hang, sdc=args.on_sdc, straggler=args.on_straggler,
        max_restores=args.max_restores, rescue_lr_scale=args.rescue_lr_scale,
        ckpt_memory_keep=args.ckpt_memory_keep, peer_redundancy=args.peer_redundancy,
        preempt_grace=args.preempt_grace, flight_len=args.flight_len,
        straggler_factor=args.straggler_factor, straggler_window=args.straggler_window,
        straggler_confirm=args.straggler_confirm)
    mem_ckpt = None
    if policy.ckpt_memory_keep > 0:
        mem_ckpt = MemoryCheckpointTier(keep=policy.ckpt_memory_keep,
                                        peer_redundancy=policy.peer_redundancy,
                                        groups=max(2, built.world), flight=flight)
    straggler = StragglerTimer(cfg=built.cfg, plan=plan, policy=policy, flight=flight)

    t_start = time.time()
    prefetch = Prefetcher(built.dataset) if args.prefetch else None
    source = prefetch.batch if prefetch is not None else built.dataset.batch

    def get_batch(step: int):
        return {k: torch.from_numpy(v).to(device) for k, v in source(step).items()}

    def injector(step, st):
        if step == args.simulate_hang_at:
            time.sleep(2.0)
        return st

    try:
        with PreemptionGuard(grace=policy.preempt_grace) as guard:
            state, report = run_with_recovery(
                built.state, built.step_fn, get_batch, args.steps, ckpt, monitor,
                ckpt_every=args.ckpt_every, plan=plan, mesh=mesh, policy=policy,
                rescue_step=built.rescue_fn, resume=args.resume,
                fault_injector=injector if args.simulate_hang_at >= 0 else None,
                mem_ckpt=mem_ckpt, preempt=guard, flight=flight, straggler=straggler)
    except KeyboardInterrupt as e:
        # an exit, not a crash, but it leaves a black box: the driver dumped
        # the ring on the way out (any BaseException does)
        fp = getattr(e, "flight_path", None) or flight.dump("KeyboardInterrupt")
        say(f"[train] interrupted; flight log at {fp}")
        raise SystemExit(130)
    finally:
        if prefetch is not None:
            prefetch.close()

    dt = time.time() - t_start
    if report.preempted:
        say(f"[train] preempted at step {report.preempt_step} (signal {guard.signum}): "
            f"just-in-time snapshot taken, PREEMPTED marker written, flight log at "
            f"{report.flight_path}; rerun with --resume to continue")
        return state, report
    tokens = args.steps * args.batch * args.seq
    say(f"[train] {args.steps} steps in {dt:.1f}s ({tokens / dt:.0f} tok/s), loss "
        f"{report.losses[0]:.4f} -> {report.losses[-1]:.4f}, "
        f"anomalies={len(report.anomalies)}, restores={report.restores} (memory-tier "
        f"{report.mem_restores}), remeshes={report.remeshes}, "
        f"rebalances={report.rebalances}")
    for step, kind, action in report.actions:
        say(f"[train]   step {step}: {kind} -> {action}")
    say(f"[train] ckpt snapshot {ckpt.snapshot_seconds * 1e3:.1f}ms persist "
        f"{ckpt.persist_seconds * 1e3:.1f}ms "
        f"({'double-buffered' if args.async_snapshot else 'blocking'} snapshot, async persist)")
    return state, report


def main(argv=None) -> None:
    args = parse(argv)
    built = build(args)
    try:
        run(args, built)
    finally:
        if built.mesh is not None:
            built.mesh.close()


if __name__ == "__main__":
    main()
