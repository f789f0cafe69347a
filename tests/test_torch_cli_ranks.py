"""The training CLI on two ranks: gloo CPU processes that read their ranks
from the environment as ``torchrun`` sets it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT``), each
running ``repro_torch.launch.train``'s ``build`` and ``run`` in process on a
(1, 2) grid, with the RAM tier on at its default (2 snapshots, mirrored).

- qwen1.5-4b smoke on the tp rings (tp 2) and deepseek-moe-16b smoke on the
  expert ring (ep 2: its 4 experts over the model axis, attention a cp ring
  over it), 12 steps with ``--simulate-hang-at 10 --on-hang rollback``: every
  step's loss within 1e-6 relative of the one-process CLI's on the same argv,
  the rollback served by the RAM tier on the model axis
  (``report.mem_restores``) on both ranks and in one process, and the final
  params against the rank's part of the one-process params, each leaf within
  1e-2 of its max. The repo's DP and grid rules hold a step's grads and
  losses, and the params after it only as readings (``chip_smoke.
  dp_failures``): AdamW's first step moves each element by lr x g / (|g| +
  eps), so an element whose grad sits near eps or at its sum-order noise
  moves by up to lr either way. After one step the tp ranks' ``wo`` sits
  8.2e-4 of its max from one process's (one process at 2 microbatches:
  5.0e-5), 7.3e-4 after 12, and most leaves miss the ring bounds (rtol 1e-5
  / atol 1e-6, ``tests/test_torch_tp_ranks.py``) after one step already. The
  attention's k bias is left out: its grad is zero but for rounding (softmax
  ignores a shift shared by every key), so its params are the sum-order
  noise's walk in either run.
- Before the run, on the CLI's own state, grid and plan: each rank's RAM-tier
  entry holds its shard bytes at the global indices where the disk tier
  places them (the whole leaves the disk tier writes from the same state),
  ``lose_group`` and ``restore`` rebuild the state from the mirrors bit for
  bit, and a restore onto another layout is refused.

Two things are set alike in the ranks and in the one-process run, and neither
is a flag of the CLI: the MoE config takes a capacity that drops nothing
(``E / top_k``), since shard-local and global routing drop different tokens
at the smoke capacity (``core.config.warn_shard_local_routing``); and the
floors of the hang watchdog and of the straggler detector are 1.5 s, under
the injected 2 s sleep, so that only that sleep trips the watchdog and no
host jitter adds an action to the expected list (the ranks agree on each
step's decision: ``tests/test_torch_recovery_ranks.py``).
"""

import dataclasses
import functools
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ParallelPlan
from repro_torch.core.sharding import shard_layout
from repro_torch.core.tree import named_leaves
from repro_torch.launch import train as ptrain

REPO = Path(__file__).resolve().parent.parent
STEPS, HANG_AT, HANG_FLOOR = 12, 10, 1.5
REL = 1e-6
# the final params: each leaf within PARAMS_REL of its max, but the k bias,
# whose grad is zero but for rounding (module docstring)
PARAMS_REL, NOISE_LEAVES = 1e-2, ("layers/attn/bk",)
CASES = {"qwen1.5-4b-tp2": ("qwen1.5-4b", (2, 1)), "deepseek-moe-16b-ep2": ("deepseek-moe-16b", (1, 2))}
TIMEOUT = 240

torch.set_num_threads(1)

CHILD = ("import sys, json; sys.path[:0] = sys.argv[1:3]; import test_torch_cli_ranks as t; "
         "t._rank_main(sys.argv[3], json.loads(sys.argv[4]))")


def _argv(arch, ckpt_dir):
    return ["--device", "cpu", "--arch", arch, "--steps", str(STEPS), "--batch", "2",
            "--seq", "32", "--ckpt-every", "6", "--ckpt-dir", str(ckpt_dir),
            "--simulate-hang-at", str(HANG_AT), "--on-hang", "rollback"]


def _patch(mod, setattr_):
    """The two settings of the module docstring, on ``mod``
    (``repro_torch.launch.train``) through ``setattr_``."""
    real = mod.resolve_config

    def resolve(arch, shape_name, smoke=False):
        cfg = real(arch, shape_name, smoke)
        if cfg.moe is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    setattr_(mod, "resolve_config", resolve)
    setattr_(mod, "Monitor", functools.partial(mod.Monitor, hang_min_seconds=HANG_FLOOR))
    setattr_(mod, "RecoveryPolicy",
             functools.partial(mod.RecoveryPolicy, straggler_min_seconds=HANG_FLOOR))


def _stacked(x):
    return (torch.stack([t.detach() for t in x]) if isinstance(x, list)
            else torch.as_tensor(x).detach()).clone()


def _tier_checks(built, out_dir):
    """The RAM tier on the CLI's grid (module docstring): {check: bool}."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager, MemoryCheckpointTier
    state, plan, mesh = built.state, built.plan, built.mesh
    tier = MemoryCheckpointTier(keep=2, groups=2)
    tier.save(0, state, plan=plan, mesh=mesh)
    disk = CheckpointManager(Path(out_dir) / "disk", keep=1)
    disk.save(0, state, blocking=True, plan=plan, mesh=mesh)
    dist.barrier(group=mesh.host_group)
    dman, whole = disk._read_full(0, verify=True)
    entry = tier._ring[-1]
    man = entry["manifest"]
    placed = man["names"] == dman["names"] and man["shapes"] == dman["shapes"]
    split = 0
    for i, metas in enumerate(man["shards"]):
        m = metas[0]
        box = tuple(slice(lo, hi) for lo, hi in m["index"])
        placed &= np.array_equal(whole[i][box], tier._fetch(entry, m, True))
        split += list(whole[i][box].shape) != list(whole[i].shape)
    before = [_stacked(x) for _, x in named_leaves(state)]
    with torch.no_grad():
        for _, x in named_leaves(state):
            for t in (x if isinstance(x, list) else [x] if isinstance(x, torch.Tensor) else []):
                t.zero_()
    lost = tier.lose_group(0)
    step, state = tier.restore(state, plan=plan, mesh=mesh)
    rebuilt = (all(torch.equal(a, _stacked(x)) for a, (_, x) in zip(before, named_leaves(state)))
               and step == 0 and 0 < tier.last_rebuild < lost)
    try:
        tier.restore(state, plan=dataclasses.replace(plan, tp=1, ep=1), mesh=mesh)
        refused = False
    except ValueError:
        refused = True
    built.state = state
    return {"placed_as_on_disk": bool(placed), "split_members": split, "lost": lost,
            "rebuilt_bit_equal": rebuilt,
            "other_layout_refused": refused}


def _rank_main(out_dir, argv):
    _patch(ptrain, setattr)
    torch.set_num_threads(1)
    args = ptrain.parse(argv)
    built = ptrain.build(args)
    try:
        tier = _tier_checks(built, out_dir)
        state, rep = ptrain.run(args, built)
        out = {"losses": rep.losses, "actions": rep.actions, "restores": rep.restores,
               "mem_restores": rep.mem_restores, "plan": dataclasses.asdict(built.plan),
               "tier": tier,
               "params": {n: _stacked(x).numpy() for n, x in named_leaves(state.params)}}
        with open(Path(out_dir) / f"rank{built.rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        built.mesh.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(n, out_dir, argv):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(n)}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(REPO / "src"),
                               str(REPO / "tests"), str(out_dir), json.dumps(argv)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{out[-4000:]}"
    return outs, [pickle.loads((Path(out_dir) / f"rank{r}.pkl").read_bytes()) for r in range(n)]


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process(tmp_path, monkeypatch, case):
    arch, (tp, ep) = CASES[case]
    outs, ranks = _run_ranks(2, tmp_path, _argv(arch, tmp_path / "ckpt"))
    assert "devices=2" in outs[0] and "[train]" not in outs[1]

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    _patch(ptrain, monkeypatch.setattr)
    args = ptrain.parse(_argv(arch, tmp_path / "one"))
    state, rep = ptrain.run(args, ptrain.build(args))
    assert rep.actions == [(HANG_AT, "hang", "rollback")] and rep.mem_restores == 1
    sizes = {"model": 2, "cp": 1, "pod": 1}
    for r, got in enumerate(ranks):
        assert (got["plan"]["tp"], got["plan"]["ep"]) == (tp, ep)
        assert got["tier"] == {"placed_as_on_disk": True, "split_members": got["tier"]["split_members"],
                               "lost": got["tier"]["lost"], "rebuilt_bit_equal": True,
                               "other_layout_refused": True}, got["tier"]
        assert got["tier"]["split_members"] > 0 and got["tier"]["lost"] > 0
        assert got["actions"] == rep.actions and got["mem_restores"] == 1
        assert got["restores"] == rep.restores == 1
        np.testing.assert_allclose(got["losses"], rep.losses, rtol=REL)
        want = shard_layout(state.params, ParallelPlan(tp=tp, ep=ep),
                            {"model": r, "cp": 0, "pod": 0}, sizes)
        dist = {name: _rel(got["params"][name], _stacked(x).numpy())
                for name, x in named_leaves(want) if name not in NOISE_LEAVES}
        assert max(dist.values()) <= PARAMS_REL, dist


def _rel(a, b):
    """max |a - b| in units of b's max |value|."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
