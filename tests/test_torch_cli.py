"""The port's training CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``) and against the port's own loop, on the
CPU at the smoke configs (``--device cpu``).

- The flags: every action of the reference's parser (captured from its
  ``main`` by patching ``ArgumentParser.parse_args``) has the port's twin, with
  the same option strings, ``dest``, default and choices; the port adds
  ``--device`` only.
- The trajectory: qwen1.5-4b and whisper-small, one process, the same argv
  (6 steps, batch 2, seq 32, a checkpoint every 3). The reference's ``main``
  runs with its ``run_with_recovery`` wrapped to capture its report; the port's
  CLI starts from the reference's ``PRNGKey(0)`` params (``interop``), the two
  packages' generators being different. Losses to 1e-4 relative, as
  ``tests/test_torch_train.py`` holds the quickstart's trajectory; the actions,
  restores, remeshes and rebalances equal.
- The CLI against ``make_train_step`` in a plain loop on the same batches:
  losses and final params bit-equal.
- A real SIGTERM from this process to a child CLI once step 0's manifest is on
  disk: exit 0, the preemption line, the ``PREEMPTED`` marker (step k, 1 <= k
  < steps, SIGTERM, tier disk) and the flight JSON; a second child with
  ``--resume`` reaches the end, and its final checkpoint's members (the
  manifest's digests) equal a clean child's. SIGINT: exit 130 and a flight
  dump.
- The model axis at world size 2, arch by arch: the reference's MoE fold, and
  the families the port's rings cannot run there refused.
- The RAM tier with ``peer_redundancy=False`` against the reference's tier on
  the same state: no mirror buffers, the same flight fields, and ``restore``
  after ``lose_group`` raising ``CorruptCheckpointError`` in both.

A child is signalled SIGNAL_DELAY s after its step-0 manifest lands (after
the save, the child frees its host buffers before its first preemption
check), and sleeps 2 s before step 1 (``--simulate-hang-at 1``), so the
signal lands inside the driver before step 1 or during that sleep.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CorruptCheckpointError, MemoryCheckpointTier
from repro_torch.core import ARCH_IDS, get_smoke_config
from repro_torch.core.tree import leaves, named_leaves
from repro_torch.ft import FlightRecorder
from repro_torch.ft.preempt import read_marker
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as ptrain
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState

REPO = Path(__file__).resolve().parent.parent
ARGV = ["--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "3"]
LOSS_REL = 1e-4
CHILD_TIMEOUT = 120
SIGNAL_DELAY = 0.5


def _reference_parser():
    """The ``ArgumentParser`` the reference's ``main`` builds (captured when it
    parses, before it builds anything)."""
    from repro.launch import train as jtrain

    class Captured(Exception):
        pass
    got = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        got["parser"] = self
        raise Captured
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Captured):
            jtrain.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    return got["parser"]


def _actions(ap, skip=("help",)):
    """Every action's (option strings, dest, default, choices), sorted."""
    return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                   repr(tuple(a.choices)) if a.choices is not None else None)
                  for a in ap._actions if a.dest not in skip)


def test_flags_equal_the_reference():
    ours = ptrain.parser()
    assert _actions(ours, skip=("help",)) != _actions(ours, skip=("help", "device"))
    assert _actions(ours, skip=("help", "device")) == _actions(_reference_parser())
    assert [a.default for a in ours._actions if a.dest == "device"] == [None]


def test_cli_refuses_to_run_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.build(ptrain.parse(["--steps", "1"]))


def _run_reference(monkeypatch, argv):
    """The reference's ``main`` on ``argv``: (its initial params as numpy, its
    report)."""
    import jax
    from repro.launch import train as jtrain
    got = {}
    real_init, real_run = jtrain.init_train_state, jtrain.run_with_recovery

    def init(*a, **kw):
        st = real_init(*a, **kw)
        got["params"] = jax.tree.map(lambda x: np.array(x), st.params)
        return st

    def run(*a, **kw):
        got["state"], got["report"] = real_run(*a, **kw)
        return got["state"], got["report"]
    monkeypatch.setattr(jtrain, "init_train_state", init)
    monkeypatch.setattr(jtrain, "run_with_recovery", run)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    return got["params"], got["report"]


def _report_fields(rep):
    return rep.actions, rep.restores, rep.remeshes, rep.rebalances, rep.steps_done


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "whisper-small"])
def test_trajectory_matches_the_reference_cli(tmp_path, monkeypatch, arch):
    argv = ["--arch", arch] + ARGV
    jparams, jrep = _run_reference(monkeypatch, argv + ["--ckpt-dir", str(tmp_path / "ref")])
    args = ptrain.parse(argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    built = ptrain.build(args)
    start = params_from_numpy(jparams, get_smoke_config(arch), device="cpu")
    for p in leaves(start):
        p.requires_grad_(True)
    built.state = TrainState(start, adamw_init(start))
    _, rep = ptrain.run(args, built)
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=LOSS_REL)
    assert [tuple(a) for a in rep.actions] == [tuple(a) for a in jrep.actions]
    assert _report_fields(rep)[1:] == _report_fields(jrep)[1:]
    assert rep.mem_restores == jrep.mem_restores and rep.losses[-1] < rep.losses[0]


def test_cli_is_bit_equal_to_the_plain_loop(tmp_path):
    args = ptrain.parse(["--arch", "qwen1.5-4b"] + ARGV
                        + ["--ckpt-dir", str(tmp_path), "--device", "cpu"])
    state, rep = ptrain.run(args, ptrain.build(args))
    built = ptrain.build(args)
    plain, losses = built.state, []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v) for k, v in built.dataset.batch(i).items()}
        plain, m = built.step_fn(plain, batch)
        losses.append(float(m["loss"]))
    assert rep.losses == losses
    assert state.opt.step == plain.opt.step == args.steps
    for (name, a), (_, b) in zip(named_leaves(state), named_leaves(plain)):
        assert torch.equal(_stacked(a), _stacked(b)), name


def _stacked(x):
    return (torch.stack([t.detach() for t in x]) if isinstance(x, list)
            else torch.as_tensor(x).detach())


def _child(ckpt_dir, steps, *extra):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    argv = ["--device", "cpu", "--arch", "qwen1.5-4b", "--steps", str(steps), "--batch", "2",
            "--seq", "32", "--ckpt-every", str(steps), "--ckpt-memory-keep", "0",
            "--ckpt-dir", str(ckpt_dir), "--flight-path", str(Path(ckpt_dir) / "flight.json"),
            *extra]
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _signal_after_step0(targets):
    """Send each (process, checkpoint directory, signal) its signal
    SIGNAL_DELAY s after its step-0 manifest is on disk; returns each child's
    (exit code, output)."""
    deadline = time.time() + CHILD_TIMEOUT
    due = {}                                   # target index -> when to signal
    while len(due) < len(targets) or any(t is not None for t in due.values()):
        for i, (proc, ckpt_dir, signum) in enumerate(targets):
            if i not in due:
                if (Path(ckpt_dir) / "ckpt_00000000.json").exists():
                    due[i] = time.time() + SIGNAL_DELAY
                else:
                    assert proc.poll() is None, proc.communicate()[0][-4000:]
            elif due[i] is not None and time.time() >= due[i]:
                os.kill(proc.pid, signum)
                due[i] = None
        assert time.time() < deadline, "no step-0 checkpoint"
        time.sleep(0.02)
    outs = [proc.communicate(timeout=CHILD_TIMEOUT)[0] for proc, _, _ in targets]
    return [(proc.returncode, out) for (proc, _, _), out in zip(targets, outs)]


def _final_digests(ckpt_dir, step):
    man = json.loads((Path(ckpt_dir) / f"ckpt_{step:08d}.json").read_text())
    return man["names"], [[m["checksum"] for m in ms] for ms in man["shards"]]


def test_sigterm_from_another_process_then_resume(tmp_path):
    steps = 8
    pre, clean, intr = tmp_path / "preempted", tmp_path / "clean", tmp_path / "interrupted"
    children = [_child(pre, steps, "--simulate-hang-at", "1"), _child(clean, steps),
                _child(intr, steps, "--simulate-hang-at", "1")]
    try:
        (rc, out), (rc_int, out_int) = _signal_after_step0(
            [(children[0], pre, signal.SIGTERM), (children[2], intr, signal.SIGINT)])
        assert rc == 0, out[-4000:]
        marker = read_marker(pre)
        assert marker is not None and 1 <= marker["step"] < steps, marker
        assert marker["signum"] == signal.SIGTERM and marker["tier"] == "disk"
        assert f"[train] preempted at step {marker['step']} (signal {int(signal.SIGTERM)})" in out
        assert json.loads((pre / "flight.json").read_text())["reason"] == "preempt"

        assert rc_int == 130, out_int[-4000:]
        assert "[train] interrupted; flight log at" in out_int
        assert json.loads((intr / "flight.json").read_text())["reason"] == "KeyboardInterrupt"

        resumed = _child(pre, steps, "--resume")
        out_res = resumed.communicate(timeout=CHILD_TIMEOUT)[0]
        assert resumed.returncode == 0, out_res[-4000:]
        assert f"[train] {steps} steps in" in out_res and read_marker(pre) is None
        out_clean = children[1].communicate(timeout=CHILD_TIMEOUT)[0]
        assert children[1].returncode == 0, out_clean[-4000:]
        assert _final_digests(pre, steps) == _final_digests(clean, steps)
    finally:
        for p in children:
            p.kill()


def _ram_tiers(flight_t, flight_j):
    """The port's and the reference's RAM tiers without mirrors, each holding
    the same qwen1.5-4b smoke train state (the reference's from the port's
    weights)."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import MemoryCheckpointTier as JTier
    from repro.optim import adamw_init as jadamw_init
    from repro.train import TrainState as JState
    from repro_torch.interop import params_to_numpy
    args = ptrain.parse(["--arch", "qwen1.5-4b", "--device", "cpu"] + ARGV)
    built = ptrain.build(args)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(built.state.params, built.cfg))
    jstate = JState(jparams, jadamw_init(jparams))
    ours = MemoryCheckpointTier(keep=2, peer_redundancy=False, groups=2, flight=flight_t)
    ref = JTier(keep=2, peer_redundancy=False, groups=2, flight=flight_j)
    ours.save(0, built.state)
    ref.save(0, jstate)
    return (ours, built.state), (ref, jstate)


def test_ram_tier_without_mirrors_matches_the_reference():
    ft_, fj = FlightRecorder(maxlen=16), FlightRecorder(maxlen=16)
    (ours, state), (ref, jstate) = _ram_tiers(ft_, fj)
    for tier in (ours, ref):
        entry = tier._ring[-1]
        assert not any(entry["mirror"].values())
        assert sum(len(v) for v in entry["primary"].values()) == len(entry["manifest"]["names"])
    assert ours._ring[-1]["manifest"]["names"] == ref._ring[-1]["manifest"]["names"]
    assert ours.lose_group(0) == ref.lose_group(0) > 0
    with pytest.raises(CorruptCheckpointError):
        ours.restore(state)
    from repro.checkpoint.store import CorruptCheckpointError as JCorrupt
    with pytest.raises(JCorrupt):
        ref.restore(jstate)

    def fields(fr):
        return [{k: v for k, v in e.items() if k not in ("t", "seconds")} for e in fr.events]
    assert fields(ft_) == fields(fj)
    assert fields(ft_)[0] == {"kind": "ckpt.persist", "step": 0, "tier": "memory",
                              "groups": 2, "mirrored": False}


REFUSED_ON_THE_MODEL_AXIS = ("pixtral-12b", "zamba2-1.2b", "whisper-small")


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_model_axis_fold_as_the_reference(arch):
    """World size 2: the reference's fold (``repro/launch/train.py:152-154``),
    an MoE model whose expert count 2 divides on the expert ring, any other
    on the tp rings; the families the port's rings cannot run there are
    refused, naming the ROADMAP item, never run replicated."""
    cfg = get_smoke_config(arch)
    if arch in REFUSED_ON_THE_MODEL_AXIS:
        with pytest.raises(ValueError, match="ROADMAP queue C"):
            ptrain.model_axis_plan(cfg, 2)
        return
    moe = cfg.moe is not None and cfg.moe.num_experts % 2 == 0
    assert ptrain.model_axis_plan(cfg, 2) == ((1, 2) if moe else (2, 1))
