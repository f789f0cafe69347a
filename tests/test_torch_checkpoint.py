"""The port's checkpointing against the JAX reference's: one on-disk format both
packages read (a port-written train state restores in the reference's
``CheckpointManager`` and the reverse, bit-exact), bf16 leaves, the integrity
digests, the atomic persist, keep-K GC, the retry budget and the host-RAM tier."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import CorruptCheckpointError as RefCorrupt
from repro.checkpoint import store as ref_store
from repro.core import InputShape, ParallelPlan, get_smoke_config
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.train import Hyper, init_train_state, make_train_step
from repro_torch import train as ttrain
from repro_torch.checkpoint import (CheckpointManager, CorruptCheckpointError,
                                    MemoryCheckpointTier)
from repro_torch.checkpoint import store
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.core.tree import leaves
from repro_torch.models import build_model as torch_build_model

torch.set_num_threads(1)

ARCH = "whisper-small"
SHAPE = ("t", 8, 2, "train")


def _port_state(seed=0, steps=2, param_dtype="float32"):
    """The port's whisper smoke train state after ``steps`` steps (moments
    and step non-zero), on the CPU."""
    cfg = torch_smoke_config(ARCH)
    plan = TorchPlan(compute_dtype="float32", param_dtype=param_dtype, remat="none")
    model = torch_build_model(cfg, plan, device="cpu")
    state = ttrain.init_train_state(model, torch.Generator().manual_seed(seed))
    step = ttrain.make_train_step(model, plan, ttrain.Hyper(peak_lr=1e-3, warmup_steps=2))
    ds = SyntheticDataset(get_smoke_config(ARCH), InputShape(*SHAPE))
    for i in range(steps):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
    return state


def _ref_state(steps=1):
    """The reference's whisper smoke train state after ``steps`` steps."""
    cfg = get_smoke_config(ARCH)
    plan = ParallelPlan(remat="none", compute_dtype="float32")
    model = build_model(cfg, plan)
    state = init_train_state(model, jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(model, plan, Hyper(peak_lr=1e-3, warmup_steps=2)))
    ds = SyntheticDataset(cfg, InputShape(*SHAPE))
    for i in range(steps):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in ds.batch(i).items()})
    return state


def _port_named(state):
    """The port's state as the reference lays it out: {name: numpy array}."""
    out = {}
    for name, leaf in store._flatten_with_names(state):
        if isinstance(leaf, int):
            out[name] = np.asarray(leaf, np.int32)
        else:
            out[name] = store._stack(leaf).numpy().copy()
    return out


def _tensors(state):
    return leaves((state.params, state.opt.mu, state.opt.nu))


def _saved(tmp_path, state=None, **kw):
    mgr = CheckpointManager(tmp_path, **kw)
    state = state if state is not None else _port_state(steps=1)
    path = mgr.save(3, state, blocking=True)
    return mgr, state, path


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _port_state()
    CheckpointManager(tmp_path).save(5, state, blocking=True)
    step, restored = RefManager(tmp_path).restore(_ref_state(steps=0))
    assert step == 5
    ours = _port_named(state)
    theirs = dict(ref_store._flatten_with_names(restored))
    assert list(ours) == list(theirs)
    assert int(theirs["opt/step"]) == state.opt.step == 2
    for name, a in ours.items():
        b = np.asarray(theirs[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _ref_state(steps=1)
    RefManager(tmp_path, async_persist=False).save(4, ref, blocking=True)
    like = _port_state(seed=1, steps=0)
    live = leaves(like.params)
    step, state = CheckpointManager(tmp_path).restore(like)
    assert step == 4 and state.opt.step == 1
    assert all(a is b and b.requires_grad and b.is_leaf
               for a, b in zip(live, leaves(state.params)))     # refilled in place
    theirs = {n: np.asarray(x) for n, x in ref_store._flatten_with_names(ref)}
    ours = _port_named(state)
    assert list(ours) == list(theirs)
    for name, a in ours.items():
        assert np.array_equal(a, theirs[name]), name


def test_bf16_leaves_round_trip(tmp_path):
    """bf16 params are stored as their uint16 bits under dtype "bfloat16" and
    come back bit for bit; the fp32 moments beside them too."""
    state = _port_state(steps=1, param_dtype="bfloat16")
    mgr, _, path = _saved(tmp_path, state)
    man = mgr.manifest(3)
    i = man["names"].index("params/layers/xattn/wk")
    assert man["dtypes"][i] == "bfloat16"
    assert np.load(str(path) + ".npz")[f"a{i}"].dtype == np.uint16
    fresh = _port_state(seed=1, steps=0, param_dtype="bfloat16")
    _, back = mgr.restore(fresh)
    assert back.opt.step == 1
    for a, b in zip(_tensors(state), _tensors(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reads_a_reference_written_bf16_member(tmp_path):
    """The reference's np.savez writes an ml_dtypes bf16 array as raw |V2, and
    its own restore then fails its dtype digest (ROADMAP queue C's caveat); the
    port reads the member as bf16 bits."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((4, 8)), jnp.bfloat16)
    tree = {"w": w, "x": jnp.asarray(rng.standard_normal(3), jnp.float32)}
    path = RefManager(tmp_path, async_persist=False).save(1, tree, blocking=True)
    assert np.load(str(path) + ".npz")["a0"].dtype == np.dtype("V2")
    with pytest.raises(RefCorrupt, match="dtype"):
        RefManager(tmp_path).restore(tree)
    like = {"w": torch.zeros(4, 8, dtype=torch.bfloat16), "x": torch.zeros(3)}
    _, back = CheckpointManager(tmp_path).restore(like)
    bits = np.asarray(w).view(np.uint16)
    assert np.array_equal(back["w"].view(torch.int16).numpy().view(np.uint16), bits)
    assert np.array_equal(back["x"].numpy(), np.asarray(tree["x"]))


def _flip(path):
    data = dict(np.load(str(path) + ".npz"))
    raw = data["a0"].view(np.uint8).copy()
    raw.reshape(-1)[7] ^= 0x10
    data["a0"] = raw.view(data["a0"].dtype).reshape(data["a0"].shape)
    np.savez(str(path) + ".npz", **data)


def _truncate(path):
    npz = path.parent / (path.name + ".npz")
    raw = npz.read_bytes()
    npz.write_bytes(raw[:len(raw) // 2])


def _retype(path):
    """The same bytes under another 4-byte dtype: only the dtype digest sees it."""
    data = dict(np.load(str(path) + ".npz"))
    data["a0"] = data["a0"].view(np.int32)
    np.savez(str(path) + ".npz", **data)


@pytest.mark.parametrize("damage,match", [(_flip, "checksum"), (_truncate, "unreadable"),
                                          (_retype, "dtype")])
def test_damage_raises_corrupt_checkpoint(tmp_path, damage, match):
    mgr, state, path = _saved(tmp_path)
    damage(path)
    with pytest.raises(CorruptCheckpointError, match=match):
        mgr.restore(state)


def test_crash_between_npz_and_manifest_leaves_the_step_unlisted(tmp_path, monkeypatch):
    mgr, state, _ = _saved(tmp_path, io_retries=1)
    real = store.os.replace

    def crash_on_manifest(src, dst):
        if str(dst).endswith(".json"):
            raise OSError("crash before the manifest lands")
        real(src, dst)
    monkeypatch.setattr(store.os, "replace", crash_on_manifest)
    with pytest.raises(OSError, match="crash"):
        mgr.save(9, state, blocking=True)
    assert (tmp_path / "ckpt_00000009.npz").exists()
    assert mgr.steps() == [3] and mgr.latest_step() == 3


def _drop_writes(monkeypatch, bad_steps):
    """Persists of ``bad_steps`` look successful but lose their npz."""
    real = CheckpointManager._persist_once

    def persist(self, step, path, arrays, manifest):
        real(self, step, path, arrays, manifest)
        if step in bad_steps:
            (path.parent / (path.name + ".npz")).unlink()
    monkeypatch.setattr(CheckpointManager, "_persist_once", persist)


@pytest.mark.parametrize("saves,bad,kept", [((5, 15, 20), (15, 20), [5, 15, 20]),
                                            ((5, 10, 15, 20), (15,), [15, 20])])
def test_gc_spares_the_newest_intact_checkpoint(tmp_path, monkeypatch, saves, bad, kept):
    """keep=2: when both kept checkpoints lost their npz, the newest intact
    one (5) is spared; when the newest is intact, GC trims as usual."""
    state = _port_state(steps=0)
    _drop_writes(monkeypatch, set(bad))
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in saves:
        mgr.save(s, state, blocking=True)
    assert mgr.steps() == kept
    newest_intact = max(s for s in kept if s not in bad)
    _, back = mgr.restore(_port_state(seed=1, steps=0), step=newest_intact)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), _tensors(back)))


@pytest.mark.parametrize("failures,retries,timeout,calls,ok", [
    (2, 3, 30.0, 3, True),     # two transient failures, the third attempt lands
    (3, 3, 30.0, 3, False),    # the budget is spent
    (1, 3, 0.01, 1, False),    # the deadline comes before the first backoff ends
])
def test_retry_budget_is_honoured(tmp_path, monkeypatch, failures, retries, timeout,
                                  calls, ok):
    state = _port_state(steps=0)
    made = []
    real = store.np.savez

    def flaky(*a, **kw):
        made.append(1)
        if len(made) <= failures:
            raise OSError("transient write error")
        return real(*a, **kw)
    monkeypatch.setattr(store.np, "savez", flaky)
    mgr = CheckpointManager(tmp_path, io_retries=retries, io_backoff=0.02, io_timeout=timeout)
    if ok:
        mgr.save(1, state, blocking=True)
    else:
        with pytest.raises(OSError, match="transient"):
            mgr.save(1, state, blocking=True)
    assert len(made) == calls
    assert mgr.steps() == ([1] if ok else [])


def test_background_failure_surfaces_at_the_next_wait(tmp_path, monkeypatch):
    state = _port_state(steps=0)
    mgr = CheckpointManager(tmp_path, io_retries=1)
    mgr.save(1, state)
    mgr.wait()
    assert mgr.steps() == [1]

    def fail(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(store.np, "savez", fail)
    mgr.save(2, state)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    mgr.wait()                                    # raised once, then clear


def test_async_save_snapshots_before_the_state_moves(tmp_path):
    """A background persist writes the state as it was at save(), though the
    live tensors change right after (the port's AdamW writes in place)."""
    state = _port_state(steps=1)
    want = _port_named(state)
    mgr = CheckpointManager(tmp_path, async_snapshot=True)
    mgr.save(1, state)
    with torch.no_grad():
        for t in _tensors(state):
            t.add_(1.0)
    mgr.wait()
    _, back = mgr.restore(_port_state(seed=1, steps=0))
    got = _port_named(back)
    assert all(np.array_equal(got[n], want[n]) for n in want)
    assert mgr.bytes_written > 0 and mgr.persist_seconds > 0


@pytest.mark.parametrize("sizes,budget,want", [
    ((4, 0, 8, 2), 100, [True, False, True, True]),   # all fit; a scalar never stages
    ((4, 8, 2), 6, [True, False, True]),              # a leaf too big goes to the host
    ((4, 8), 0, [False, False]),                      # no room: every leaf does
    ((4, 8), -5, [False, False]),                     # less free memory than the headroom
])
def test_staging_takes_leaves_while_they_fit(sizes, budget, want):
    """The double buffer's staging on the card is bounded: leaves take it in
    order while they fit, and the rest are copied straight to the host."""
    assert store._staged(list(sizes), budget) == want


def test_structure_mismatch_and_resharded_restore_raise(tmp_path):
    mgr, state, _ = _saved(tmp_path)
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(state.params)
    with pytest.raises(NotImplementedError, match="A13.1"):
        mgr.restore_resharded(state)
    assert mgr.check_plan(TorchPlan()) == "replay"


def test_memory_tier_matches_the_disk_tier_bytes(tmp_path):
    """A memory-tier entry holds the bytes (digests) a disk persist writes."""
    mgr, state, _ = _saved(tmp_path)
    mem = MemoryCheckpointTier(keep=2, groups=3)
    mem.save(3, state)
    disk = mgr.manifest(3)
    entry = mem._entry(3)["manifest"]
    assert entry["names"] == disk["names"] and entry["dtypes"] == disk["dtypes"]
    assert [m[0]["checksum"] for m in entry["shards"]] == disk["checksums"]


@pytest.mark.parametrize("lost,ok", [((), True), ((1,), True), ((0, 1), False)])
def test_memory_tier_survives_lose_group(lost, ok):
    """One lost group is rebuilt from its neighbour's mirrors (each verified);
    two neighbouring groups lost is beyond repair."""
    state = _port_state(steps=1)
    want = _port_named(state)
    mem = MemoryCheckpointTier(keep=2, groups=3)
    mem.save(1, state)
    mem.save(2, state)
    for g in lost:
        assert mem.lose_group(g) > 0
    if not ok:
        with pytest.raises(CorruptCheckpointError, match="lost"):
            mem.restore(_port_state(seed=1, steps=0))
        return
    step, back = mem.restore(_port_state(seed=1, steps=0))
    assert step == 2 and (mem.last_rebuild > 0) == bool(lost)
    got = _port_named(back)
    assert all(np.array_equal(got[n], want[n]) for n in want)


def test_memory_tier_verifies_a_mirror():
    state = _port_state(steps=0)
    mem = MemoryCheckpointTier(keep=1, groups=2)
    mem.save(1, state)
    mem.lose_group(0)
    entry = mem._entry(1)
    next(iter(entry["mirror"][1].values()))[...] = 0          # the surviving copy
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        mem.restore(_port_state(seed=1, steps=0))
