"""Surviving preemption: graceful exit on a notice, bit-identical resume.

    PYTHONPATH=src python -m repro_torch.examples.preempt_resume              # on the card
    PYTHONPATH=src python -m repro_torch.examples.preempt_resume --device cpu

The reference's recipe (``examples/preempt_resume.py``): the reduced
qwen1.5-4b config, ``remat="selective"``, fp32, seq 32, batch 4, 40 steps under
``Hyper(peak_lr=5e-3, warmup_steps=5, total_steps=40)``, ``ckpt_every=10``.
The recovery driver runs the same schedule three times:

1. an uninterrupted run, the ground truth;
2. a run whose preemption notice lands before step 23
   (``PreemptionGuard(grace=30.0, signals=())``, ``guard.trigger()`` standing
   in for the cloud's SIGTERM): the driver flushes the in-flight checkpoint,
   takes a just-in-time snapshot on the tier the grace budget allows, writes
   the ``PREEMPTED`` marker and returns; a RAM tier
   (``MemoryCheckpointTier(keep=2, peer_redundancy=True, groups=2)``) and a
   flight recorder ride along;
3. a ``resume=True`` run that consumes the marker, restores the snapshot and
   finishes the schedule on params bit-identical to the first run's.

It reports the reference's preemption step (24) and marker tier ("disk"). The
monitor is the reference's quiet one (``Monitor(min_history=1000,
hang_min_seconds=60.0)``) on the card too: the first step there loads the
kernels, and no hang is injected. On the CPU, PyTorch's parallel accumulate of
the embedding's backward (``index_put_``) adds in a run-dependent order, so
``run`` asks for PyTorch's deterministic algorithms there; on the card that
accumulate sorts its indices and the step repeats bit for bit as it is.
"""

from __future__ import annotations

import argparse
import contextlib
import shutil
import tempfile

import torch

N_STEPS = 40
PREEMPT_AT = 23      # the "cloud" sends its notice before this step
CKPT_EVERY = 10


def hyper():
    from repro_torch.train import Hyper
    return Hyper(peak_lr=5e-3, warmup_steps=5, total_steps=N_STEPS)


def _setup(device, impl="auto", init_params=None):
    """Model, step, batch fetch and a fresh-state maker for the recipe
    (``init_params``: a numpy param tree in the reference's layout, else seed 0)."""
    from repro_torch.core import InputShape, ParallelPlan, get_smoke_config
    from repro_torch.core.tree import leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, init_train_state, make_train_step
    cfg = get_smoke_config("qwen1.5-4b")
    plan = ParallelPlan(remat="selective", compute_dtype="float32", attn_impl=impl)
    shape = InputShape("preempt", seq_len=32, global_batch=4, kind="train")
    model = build_model(cfg, plan, device=device)
    step_fn = make_train_step(model, plan, hyper())
    ds = SyntheticDataset(cfg, shape)

    def get_batch(i):
        return {k: torch.from_numpy(v).to(model.device) for k, v in ds.batch(i).items()}

    def fresh_state():
        if init_params is None:
            return init_train_state(model, torch.Generator(device=model.device).manual_seed(0))
        params = params_from_numpy(init_params, cfg, device=model.device)
        for p in leaves(params):
            p.requires_grad_(True)
        return TrainState(params, adamw_init(params))

    return model, step_fn, get_batch, fresh_state


@contextlib.contextmanager
def _repeatable(device):
    """PyTorch's deterministic algorithms on the CPU (module docstring)."""
    was = torch.are_deterministic_algorithms_enabled()
    if device.type == "cpu":
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def first_check(device=None, init_params=None):
    """The recipe's first loss and its backward from its initial state
    through the kernels against the plain versions (``ranks.route_check``)."""
    from repro_torch.examples.ranks import route_check
    from repro_torch.train import make_loss_fn
    setups = {impl: _setup(device, impl, init_params) for impl in ("auto", "plain")}
    model, _, get_batch, fresh_state = setups["auto"]
    with _repeatable(model.device):
        return route_check(lambda impl: make_loss_fn(setups[impl][0], hyper()),
                           fresh_state().params, get_batch(0))


def run(device=None, init_params=None, log=True):
    """The three runs; returns their readings: the preemption step, the
    marker's tier, whether the resumed params are bit-identical to the
    uninterrupted run's and each run's losses."""
    say = print if log else (lambda *a, **k: None)
    model, step_fn, get_batch, fresh_state = _setup(device, init_params=init_params)
    with _repeatable(model.device):
        return _three_runs(step_fn, get_batch, fresh_state, say)


def _three_runs(step_fn, get_batch, fresh_state, say):
    from repro_torch.checkpoint import CheckpointManager, MemoryCheckpointTier
    from repro_torch.core.tree import leaves
    from repro_torch.ft import FlightRecorder, Monitor, run_with_recovery
    from repro_torch.ft.preempt import PreemptionGuard, read_marker

    def quiet():
        return Monitor(min_history=1000, hang_min_seconds=60.0)

    ref_dir = tempfile.mkdtemp(prefix="preempt_ref_")
    run_dir = tempfile.mkdtemp(prefix="preempt_run_")
    try:
        # 1) uninterrupted reference
        ref_state, ref_report = run_with_recovery(
            fresh_state(), step_fn, get_batch, N_STEPS,
            CheckpointManager(ref_dir, keep=3), quiet(), ckpt_every=CKPT_EVERY)
        say(f"reference run: {N_STEPS} steps, no interruptions", flush=True)

        # 2) preempted run: guard.trigger() stands in for the cloud's SIGTERM
        flight = FlightRecorder(maxlen=256, path=f"{run_dir}/flight.json")
        guard = PreemptionGuard(grace=30.0, signals=())
        mem = MemoryCheckpointTier(keep=2, peer_redundancy=True, groups=2, flight=flight)

        def notice(step, state):
            if step == PREEMPT_AT:
                guard.trigger()
            return state

        _, report = run_with_recovery(
            fresh_state(), step_fn, get_batch, N_STEPS,
            CheckpointManager(run_dir, keep=3, flight=flight), quiet(),
            ckpt_every=CKPT_EVERY, fault_injector=notice, mem_ckpt=mem, preempt=guard,
            flight=flight)
        marker = read_marker(run_dir)
        say(f"preempted at step {report.preempt_step}: marker={marker['tier']} "
            f"snapshot, flight log -> {report.flight_path}", flush=True)

        # 3) resume: consumes the marker, restores the snapshot, finishes
        resumed, report2 = run_with_recovery(
            fresh_state(), step_fn, get_batch, N_STEPS, CheckpointManager(run_dir, keep=3),
            quiet(), ckpt_every=CKPT_EVERY, resume=True)
        consumed = read_marker(run_dir) is None
        assert consumed, "the PREEMPTED marker outlived the resume"
        same = all(torch.equal(a, b) for a, b in zip(leaves(ref_state.params),
                                                     leaves(resumed.params)))
        say(f"resumed {report2.steps_done - report.preempt_step} remaining steps; "
            f"params bit-identical to uninterrupted run: {same}", flush=True)
        assert same
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
        shutil.rmtree(run_dir, ignore_errors=True)
    return {"preempt_step": report.preempt_step, "marker_tier": marker["tier"],
            "marker_consumed": consumed, "bit_identical": same,
            "losses": list(ref_report.losses), "preempted_losses": list(report.losses),
            "resumed_losses": list(report2.losses), "steps_done": report2.steps_done}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args()
    run(args.device)


if __name__ == "__main__":
    main()
