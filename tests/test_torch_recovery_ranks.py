"""The recovery driver's one decision for every rank, on two gloo ranks: CPU
processes that read their ranks from the environment as ``torchrun`` sets it
and run ``repro_torch.launch.train``'s ``build`` and ``run`` in process on a
(1, 2) grid (qwen1.5-4b smoke, the tp rings), each with its own faults. The
driver agrees on each step's verdict and on a preemption notice over the
mesh's host group (``repro_torch.ft.recovery``, "One decision"), so:

- a hang that only rank 1's watchdog sees (rank 1 sleeps 2 s before step 10
  under a 1.5 s floor; rank 0's floor is above any step) makes both ranks
  roll back at step 10 (rank 0 noting the hang as adopted from rank 1), and
  both end with a clean run's params, bit for bit;
- a straggler seen by one rank (rank 1's kernel-dispatch section slowed by
  0.3 s from step 5: a sleep after its step's collectives, which rank 0
  waits out in the agreement itself and never in its own timed sections) is
  attributed identically on both, at the same steps, rank 0 noting it as
  adopted from rank 1;
- a SIGTERM that reaches rank 1 only (rank 1 signals itself while fetching
  step 4's batch) stops both ranks before step 5 with a just-in-time disk
  snapshot, and a ``--resume`` of both ends bit-equal to the clean run;
- a pipeline-stage straggler that rank 1 attributes, where each rank's own
  stage times would choose another layout ((3, 1) on rank 1; (2, 2), no
  change, on rank 0), hands both ranks' ``rebalance`` hooks rank 1's layout
  at the same step (the driver alone, with stand-ins for the timer, the
  step and the checkpoint manager on a two-rank data mesh).

The clean run, the faulted runs and the resume each spawn two processes with
a timeout per spawn: a rank that waited forever on a collective its peer
never joins fails the spawn. The hang-floor and straggler-floor settings are
the tests', not flags of the CLI (``tests/test_torch_cli_ranks.py`` sets them
alike)."""

import contextlib
import functools
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.tree import named_leaves
from repro_torch.launch import train as ptrain

REPO = Path(__file__).resolve().parent.parent
STEPS, HANG_AT, FLOOR = 12, 10, 1.5
SLOW_FROM, SLOW_S, STRAGGLER_FLOOR = 5, 0.3, 0.1
SIGTERM_AT = 4                       # rank 1 signals itself fetching this step's batch
TIMEOUT = 240

torch.set_num_threads(1)

CHILD = ("import sys, json; sys.path[:0] = sys.argv[1:3]; import test_torch_recovery_ranks as t; "
         "t.{}(sys.argv[3], json.loads(sys.argv[4]))")
REBALANCE_AT, LAYOUT = 3, (2, 2)


def _argv(ckpt_dir, *extra):
    return ["--device", "cpu", "--arch", "qwen1.5-4b", "--steps", str(STEPS), "--batch", "2",
            "--seq", "32", "--ckpt-every", "6", "--ckpt-dir", str(ckpt_dir), *extra]


def _stacked(x):
    return (torch.stack([t.detach() for t in x]) if isinstance(x, list)
            else torch.as_tensor(x).detach()).clone()


def _rank_main(out_dir, spec):
    """One rank: ``spec`` holds the argv and, by rank, the hang floor, an
    armed slow data fetch and the step whose batch fetch sends this process
    a SIGTERM."""
    from repro_torch.ft.inject import FaultSpec, armed
    rank = int(os.environ["RANK"])
    own = spec["ranks"][str(rank)]
    torch.set_num_threads(1)
    ptrain.Monitor = functools.partial(ptrain.Monitor, hang_min_seconds=own["hang_floor"])
    ptrain.RecoveryPolicy = functools.partial(ptrain.RecoveryPolicy,
                                              straggler_min_seconds=spec["straggler_floor"])
    args = ptrain.parse(spec["argv"] + own.get("argv", []))
    built = ptrain.build(args)
    if own.get("sigterm_at") is not None:
        fetch, sent = built.dataset.batch, []

        def batch(step):
            if step == own["sigterm_at"] and not sent:
                sent.append(step)
                os.kill(os.getpid(), signal.SIGTERM)
            return fetch(step)
        built.dataset.batch = batch
    slow = ([FaultSpec("kernel.attention", "slow", step=SLOW_FROM, span=10 ** 6,
                       sleep_s=SLOW_S)]
            if own.get("slow") else [])
    try:
        with armed(slow):
            state, rep = ptrain.run(args, built)
        marker = Path(args.ckpt_dir) / "PREEMPTED"
        out = {"losses": rep.losses, "actions": rep.actions, "restores": rep.restores,
               "mem_restores": rep.mem_restores, "preempted": rep.preempted,
               "preempt_step": rep.preempt_step, "agreements": rep.agreements,
               "agree_seconds": rep.agree_seconds,
               "anomalies": [(a.kind, a.step, a.detail) for a in rep.anomalies],
               "marker": json.loads(marker.read_text()) if marker.exists() else None,
               "params": {n: _stacked(x).numpy() for n, x in named_leaves(state.params)}}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        built.mesh.close()


class _Relayout(Exception):
    """Raised by the rebalance hook once it has recorded its layout."""


class _StageTimer:
    """A straggler timer's stand-in: rank 1 attributes its pipeline stage at
    REBALANCE_AT, and each rank reports its own stage times, stage 1 three
    times slower a layer on rank 1 only."""
    cfg = detector = plan = None

    def __init__(self, rank):
        self.rank = rank

    def section(self, name, step):
        return contextlib.nullcontext()

    def after_step(self, step, seconds, plan=None):
        from repro_torch.ft.straggler import Straggler
        if self.rank == 1 and step == REBALANCE_AT:
            return Straggler(rank=1, section="pp.stage", cls="compute", step=step,
                             slowdown=3.0)
        return None

    def stage_times(self):
        return {0: 1.0, 1: 3.0 if self.rank == 1 else 1.0}

    def reset(self):
        pass


class _NoCheckpoints:
    """A checkpoint manager's stand-in: the run never restores."""

    def save(self, *args, **kwargs):
        pass

    def wait(self):
        pass


def _rebalance_main(out_dir, spec):
    """One rank of the rebalance test: the driver on a two-rank data mesh
    until its ``rebalance`` hook is called, which records the layout it was
    handed and the step and ends the run."""
    from repro_torch.core import ParallelPlan, RecoveryPolicy
    from repro_torch.ft import Monitor, run_with_recovery
    from repro_torch.launch import init_data_mesh
    rank = int(os.environ["RANK"])
    mesh = init_data_mesh("cpu", rank=rank, world_size=2)
    plan = ParallelPlan(pp=2, microbatches=2, pp_layout=LAYOUT)
    seen = {"step": None}

    def step_fn(state, batch):
        seen["step"] = batch["step"]
        return state, {"loss": torch.tensor(2.0 - 0.01 * batch["step"])}

    def rebalance(layout):
        seen["layout"] = tuple(layout)
        raise _Relayout()
    try:
        run_with_recovery({"w": torch.zeros(2)}, step_fn, lambda s: {"step": s}, spec["steps"],
                          _NoCheckpoints(), Monitor(hang_min_seconds=1e3), ckpt_every=10 ** 6,
                          plan=plan, mesh=mesh,
                          policy=RecoveryPolicy(straggler="rebalance", max_restores=4),
                          straggler=_StageTimer(rank), rebalance=rebalance)
    except _Relayout:
        pass
    finally:
        mesh.close()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(seen, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(out_dir, spec, main="_rank_main"):
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD.format(main), str(REPO / "src"),
                               str(REPO / "tests"), str(out_dir), json.dumps(spec)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes()) for r in range(2)]


def _spec(ckpt_dir, floors=(FLOOR, FLOOR), extra=({}, {}), *argv):
    return {"argv": _argv(ckpt_dir, *argv), "straggler_floor": FLOOR,
            "ranks": {str(r): {"hang_floor": floors[r], **extra[r]} for r in range(2)}}


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The clean two-rank run: no fault, no action."""
    tmp = tmp_path_factory.mktemp("clean")
    ranks = _run_ranks(tmp / "out", _spec(tmp / "ckpt"))
    for got in ranks:
        assert got["actions"] == [] and got["agreements"] == STEPS
    return ranks


def _bit_equal(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[n], b[n]) for n in b)


def test_hang_seen_by_one_rank_is_acted_on_by_both(tmp_path, clean):
    spec = _spec(tmp_path / "ckpt", (1e3, FLOOR),
                 ({}, {"argv": ["--simulate-hang-at", str(HANG_AT)]}), "--on-hang", "rollback")
    ranks = _run_ranks(tmp_path / "out", spec)
    for r, got in enumerate(ranks):
        assert got["actions"] == [(HANG_AT, "hang", "rollback")], (r, got["actions"])
        assert got["restores"] == got["mem_restores"] == 1
        assert got["losses"] == clean[r]["losses"]
        assert _bit_equal(got["params"], clean[r]["params"]), r
    hangs = [a for a in ranks[0]["anomalies"] if a[0] == "hang"]
    assert hangs == [("hang", HANG_AT, "adopted from rank 1")]
    own = [a for a in ranks[1]["anomalies"] if a[0] == "hang"]
    assert len(own) == 1 and "adopted" not in own[0][2]


def test_straggler_seen_by_one_rank_is_attributed_alike(tmp_path):
    spec = _spec(tmp_path / "ckpt", extra=({}, {"slow": True}))
    spec["straggler_floor"] = STRAGGLER_FLOOR
    ranks = _run_ranks(tmp_path / "out", spec)

    def events(got):
        return [(s, d.split(" (adopted")[0]) for k, s, d in got["anomalies"]
                if k == "straggler"]
    assert events(ranks[0]), ranks[0]["anomalies"]
    assert events(ranks[0]) == events(ranks[1])
    assert ranks[0]["actions"] == ranks[1]["actions"] != []
    assert all(a[1:] == ("straggler", "ignore") for a in ranks[0]["actions"])
    # the slowed section's events: rank 1's own, adopted on rank 0 (an event
    # that host jitter adds in another section, as the whole suite's load
    # can, is held above only to be the same on both ranks)
    mine = [(s, d) for k, s, d in ranks[1]["anomalies"]
            if k == "straggler" and "section=kernel.dispatch" in d]
    adopted = [(s, d) for k, s, d in ranks[0]["anomalies"]
               if k == "straggler" and "section=kernel.dispatch" in d]
    assert mine and all("adopted" not in d for _, d in mine), ranks[1]["anomalies"]
    assert [s for s, _ in adopted] == [s for s, _ in mine]
    assert all(d.endswith("(adopted from rank 1)") for _, d in adopted), ranks[0]["anomalies"]


def test_sigterm_on_one_rank_stops_both_and_resumes_bit_equal(tmp_path, clean):
    ckpt = tmp_path / "ckpt"
    ranks = _run_ranks(tmp_path / "out", _spec(ckpt, extra=({}, {"sigterm_at": SIGTERM_AT})))
    for got in ranks:
        assert got["preempted"] and got["preempt_step"] == SIGTERM_AT + 1, got
        assert got["marker"]["step"] == SIGTERM_AT + 1 and got["marker"]["tier"] == "disk"
        assert got["marker"]["signum"] == int(signal.SIGTERM)
        assert got["actions"] == []
    resumed = _run_ranks(tmp_path / "resumed", _spec(ckpt, (FLOOR, FLOOR), ({}, {}),
                                                      "--resume"))
    for r, got in enumerate(resumed):
        assert not got["preempted"]
        assert got["losses"][SIGTERM_AT + 1:] == clean[r]["losses"][SIGTERM_AT + 1:]
        assert _bit_equal(got["params"], clean[r]["params"]), r


def test_rebalance_takes_the_attributing_ranks_layout(tmp_path):
    from repro_torch.ft.straggler import choose_pp_layout
    # each rank alone would choose another layout from its own stage times
    assert choose_pp_layout(_StageTimer(1).stage_times(), LAYOUT) == (3, 1)
    assert choose_pp_layout(_StageTimer(0).stage_times(), LAYOUT) == LAYOUT
    ranks = _run_ranks(tmp_path / "out", {"steps": 8}, main="_rebalance_main")
    for got in ranks:
        assert got == {"step": REBALANCE_AT, "layout": (3, 1)}, ranks
