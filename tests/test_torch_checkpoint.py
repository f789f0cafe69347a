"""The port's checkpointing against the JAX reference's: one on-disk format both
packages read (a port-written train state restores in the reference's
``CheckpointManager`` and the reverse, bit-exact), bf16 leaves, the integrity
digests, the atomic persist, keep-K GC, the retry budget and the host-RAM tier;
and under ZeRO-1: a checkpoint written by 2 gloo ranks (CPU subprocesses)
whose manifest holds the layout rule's slices and which the reference restores,
the elastic ``restore_resharded`` between dp 1, 2 and 4 bit for bit, and the
``check_plan``/RAM-tier routes on real layout mismatches. Ranks of another
layout are played in this process by a mesh stand-in with a rank
(``_RankMesh``): a restore runs no collective."""

import dataclasses
import functools
from pathlib import Path

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
from repro_torch.core.sharding import local_index, opt_state_specs
from repro_torch.core.tree import leaves, named_leaves
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
    for name, leaf in named_leaves(state):
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
    """A tree of other names raises; so does ``restore_resharded`` onto a tree
    that is not laid out for the requested plan and mesh (a one-process state
    asked for dp 2). A checkpoint saved with no plan replays onto any plan."""
    mgr, state, _ = _saved(tmp_path)
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(state.params)
    with pytest.raises(ValueError, match="layout"):
        mgr.restore_resharded(state, mesh=_RankMesh(2, 0), plan=TorchPlan())
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


# -- ZeRO-1: checkpoints across data-parallel layouts --------------------------

# one microbatch: SHAPE's 2 rows shard over dp 2, one row a rank
DP_PLAN = TorchPlan(compute_dtype="float32", remat="none", microbatches=1)


class _RankMesh:
    """One rank of a data mesh of ``n``, without a process group: enough for
    the layout rules, ``init_train_state`` and a restore, which run no
    collective."""

    def __init__(self, n, rank):
        self.shape, self.size, self.rank = {"data": n}, n, rank


def _dp_model():
    return torch_build_model(torch_smoke_config(ARCH), DP_PLAN, device="cpu")


def _dp_like(mesh, seed=1):
    """A fresh ZeRO-1 state of ``mesh``'s rank (no mesh: one process)."""
    return ttrain.init_train_state(_dp_model(), torch.Generator().manual_seed(seed), mesh,
                                   DP_PLAN)


def _ckpt_rank_main(rank, n, store_path, out_dir):
    """A rank of the writer group: 2 ZeRO-1 steps of the whisper smoke config
    at dp ``n``, a save of step 2, the rank's own state dumped beside it."""
    from repro_torch.launch import init_data_mesh
    torch.set_num_threads(1)
    mesh = init_data_mesh("cpu", init_method=f"file://{store_path}", rank=rank, world_size=n)
    model = _dp_model()
    state = ttrain.init_train_state(model, torch.Generator().manual_seed(0), mesh, DP_PLAN)
    step = ttrain.make_train_step(model, DP_PLAN, ttrain.Hyper(peak_lr=1e-3, warmup_steps=2),
                                  mesh=mesh)
    ds = SyntheticDataset(get_smoke_config(ARCH), InputShape(*SHAPE))
    for i in range(2):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(i).items()})
    mgr = CheckpointManager(Path(out_dir) / "ckpt")
    mgr.save(2, state, plan=DP_PLAN, mesh=mesh)
    mgr.wait()
    torch.save(_port_named(state), Path(out_dir) / f"rank{rank}.pt")
    mesh.close()


@pytest.fixture(scope="module")
def zero1_ckpt(tmp_path_factory):
    """(directory, {name: the whole leaf}, [each rank's own state by name]) of a
    checkpoint written by 2 gloo ranks."""
    from test_torch_dp import run_ranks
    out = tmp_path_factory.mktemp("zero1")
    child = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_checkpoint as t; "
             "t._ckpt_rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])")
    run_ranks(2, out, child, [], timeout=300)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return out / "ckpt", _whole(ranks, 2), ranks


@functools.lru_cache(maxsize=None)
def _moment_specs(n):
    return opt_state_specs(_dp_like(None).params, _RankMesh(n, 0), DP_PLAN)


def _moment_spec(name, n=2):
    """The layout rule's LeafSpec at dp ``n`` of a moment leaf ``opt/mu/...``."""
    return _moment_specs(n)[name.split("/", 2)[2]]


def _slice(name, n, r):
    return tuple(slice(lo, hi) for lo, hi in local_index(_moment_spec(name, n), r, n))


def _whole(ranks, n):
    """The whole state from each rank's own (params and step from rank 0, the
    moments assembled from their slices)."""
    whole = {}
    for name, a in ranks[0].items():
        if name.startswith(("opt/mu/", "opt/nu/")):
            full = np.zeros(_moment_spec(name).shape, a.dtype)
            for r in range(n):
                full[_slice(name, n, r)] = ranks[r][name]
            whole[name] = full
        else:
            whole[name] = a
    return whole


def _rank_view(whole, n, r):
    """Rank r of n's share of a whole state."""
    return {k: a[_slice(k, n, r)] if k.startswith(("opt/mu/", "opt/nu/")) else a
            for k, a in whole.items()}


def test_zero1_manifest_holds_the_layout_rules_slices(zero1_ckpt):
    """Params and the step once, each moment as one member per rank at the
    rule's global index; the plan's layout axes and the mesh recorded."""
    ckdir, whole, _ = zero1_ckpt
    man = CheckpointManager(ckdir).manifest()
    assert man["mesh_axes"] == {"data": 2} and man["plan"]["zero_stage"] == 1
    assert man["plan"]["tp"] == man["plan"]["ep"] == 1
    for name, shape, metas in zip(man["names"], man["shapes"], man["shards"]):
        assert list(whole[name].shape) == shape
        if name.startswith(("opt/mu/", "opt/nu/")):
            spec = _moment_spec(name)
            assert [m["index"] for m in metas] == [local_index(spec, r, 2) for r in range(2)]
            assert spec.dim is not None
        else:
            assert len(metas) == 1 and metas[0]["index"] == [[0, d] for d in shape]


def test_zero1_checkpoint_restores_in_the_reference(zero1_ckpt):
    """The reference's CheckpointManager reassembles the ranks' slices into its
    single-device TrainState, bit for bit."""
    ckdir, whole, _ = zero1_ckpt
    step, restored = RefManager(ckdir).restore(_ref_state(steps=0))
    assert step == 2
    theirs = dict(ref_store._flatten_with_names(restored))
    assert list(theirs) == list(whole)
    for name, a in whole.items():
        b = np.asarray(theirs[name])
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("src,dst,stage", [(2, 1, 1), (2, 2, 1), (2, 4, 1), (1, 2, 1),
                                           (2, 2, 0)])
def test_restore_resharded_is_bit_exact(zero1_ckpt, tmp_path, src, dst, stage):
    """A ZeRO-1 checkpoint of dp ``src`` onto dp ``dst`` at ZeRO stage
    ``stage`` (0: every rank holds the whole moments): every rank's state
    equals its share of the saved one bit for bit; ``check_plan`` says
    "replay" on the recorded layout and "reshard" elsewhere."""
    ckdir, whole, _ = zero1_ckpt
    plan = dataclasses.replace(DP_PLAN, zero_stage=stage)
    mgr = CheckpointManager(ckdir)
    if src == 1:                          # a one-process checkpoint of the same state
        from repro_torch.launch import DataMesh
        mgr = CheckpointManager(tmp_path)
        _, state = CheckpointManager(ckdir).restore_resharded(_dp_like(None), plan=DP_PLAN)
        mgr.save(2, state, blocking=True, plan=DP_PLAN, mesh=DataMesh())
    for r in range(dst):
        mesh = _RankMesh(dst, r) if dst > 1 else None
        route = mgr.check_plan(plan, mesh=mesh or _RankMesh(1, 0), elastic=True)
        assert route == ("replay" if (src, 1) == (dst, stage) else "reshard")
        like = ttrain.init_train_state(_dp_model(), torch.Generator().manual_seed(1), mesh, plan)
        _, back = mgr.restore_resharded(like, mesh=mesh, plan=plan)
        got = _port_named(back)
        want = _rank_view(whole, dst, r) if dst > 1 and stage else whole
        assert list(got) == list(want)
        for name, a in want.items():
            assert got[name].dtype == a.dtype and np.array_equal(got[name], a), (name, r)


@pytest.mark.parametrize("plan,mesh,axis", [
    (dataclasses.replace(DP_PLAN, zero_stage=0), _RankMesh(2, 0), "zero_stage"),
    (DP_PLAN, _RankMesh(4, 0), "mesh_axes"),
])
def test_check_plan_routes_a_layout_mismatch(zero1_ckpt, plan, mesh, axis):
    """The reference's rule on a real mismatch with the recorded layout (ZeRO-1
    at dp 2): refused without ``elastic``, "reshard" with it."""
    mgr = CheckpointManager(zero1_ckpt[0])
    assert mgr.check_plan(DP_PLAN, mesh=_RankMesh(2, 1)) == "replay"
    with pytest.raises(ValueError, match=axis):
        mgr.check_plan(plan, mesh=mesh)
    assert mgr.check_plan(plan, mesh=mesh, elastic=True) == "reshard"
    assert store.layout_diffs({"plan": {"ep": True}}, DP_PLAN) == {
        "ep": ("legacy-gspmd-ep", 1)}
    assert store.layout_diffs({"plan": {"ep": False}}, DP_PLAN) == {}


def test_memory_tier_routes_by_the_recorded_layout(zero1_ckpt):
    """The RAM tier holds a rank's own ZeRO-1 state and gives it back on the
    same layout; another plan or mesh is refused (a remesh restores through
    the disk tier)."""
    ckdir, whole, ranks = zero1_ckpt
    mesh = _RankMesh(2, 1)
    _, state = CheckpointManager(ckdir).restore(_dp_like(mesh), mesh=mesh)
    mem = MemoryCheckpointTier(keep=1, groups=2)
    mem.save(2, state, plan=DP_PLAN, mesh=mesh)
    entry = mem._entry(2)["manifest"]
    assert entry["shards"][entry["names"].index("opt/nu/embed/tok")][0]["index"] == \
        local_index(_moment_spec("opt/nu/embed/tok"), 1, 2)
    _, back = mem.restore(_dp_like(mesh, seed=5), plan=DP_PLAN, mesh=mesh)
    got = _port_named(back)
    assert all(np.array_equal(got[n], a) for n, a in ranks[1].items())
    for plan, other in ((DP_PLAN, _RankMesh(4, 1)),
                        (dataclasses.replace(DP_PLAN, zero_stage=0), mesh)):
        with pytest.raises(ValueError, match="layout mismatch"):
            mem.restore(_dp_like(mesh), plan=plan, mesh=other)
