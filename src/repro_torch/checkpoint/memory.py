"""Hot in-memory checkpoint tier with peer redundancy (port of
``repro/checkpoint/memory.py``).

:class:`MemoryCheckpointTier` keeps a host-RAM ring of the last ``keep``
snapshots with the disk tier's schema and digests (``checkpoint/store.py``:
the same names, per-member sha256 prefix, CRC32 and dtype/shape digests, bf16
as uint16 bits), so an entry holds the bytes a disk persist would have
written. Its snapshot is the store's blocking device -> host copy.

Peer redundancy: each member gets a home group ``g`` (round-robin over
``groups``) and is mirrored onto its ring neighbour ``(g + 1) % groups`` as a
separate host buffer. :meth:`lose_group` (a simulated host loss) drops a
group's primaries and the mirrors it held; every member is then still served,
from its home or from its neighbour's mirror. :meth:`restore` serves primaries
unverified (digested at save, RAM is trusted between save and restore) and
verifies every member served from a mirror. On a fleet the mirror exchange is
a ring of sends across hosts; in one process it is a host-side copy, which
keeps the semantics: the mirror is a distinct buffer that survives
``lose_group``.

Under a data mesh each rank's tier holds that rank's own state (params whole,
its ZeRO-1 moment slices, each member with its global index) and restores onto
the layout it was saved on only: :meth:`restore` refuses a plan or mesh that
``store.layout_diffs`` finds different (a remesh restores through the disk
tier's ``restore_resharded``), as the reference's tier does.

``flight=`` (a ``FlightRecorder``) logs ``ckpt.persist`` with
``tier="memory"``, ``mem.lost_group`` and ``mem.restore``, as the reference's
tier does.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sharding import local_index, train_state_specs
from repro_torch.core.tree import named_leaves, stacked_shape
from .store import (CorruptCheckpointError, _held, _host, _plan_meta, _shard_meta, _verify,
                    fill_tree, layout_diffs)


class MemoryCheckpointTier:
    """Host-RAM ring of the last ``keep`` snapshots, each member mirrored onto
    the next of ``groups`` logical host groups."""

    def __init__(self, keep: int = 2, groups: int = 2, flight=None):
        self.keep = max(1, int(keep))
        self.groups = max(1, int(groups))
        self.flight = flight          # a FlightRecorder, or None
        self._ring: deque = deque(maxlen=self.keep)
        self.snapshot_seconds = 0.0   # last save() wall time
        self.restore_seconds = 0.0    # last restore() wall time
        self.last_rebuild = 0         # members served from mirrors by the last restore

    def save(self, step: int, tree: Any, *, plan=None, mesh=None) -> None:
        """Snapshot ``tree`` into the ring (a blocking host copy); the oldest
        entry leaves when the ring is full. ``plan`` and ``mesh`` are recorded
        as the disk tier records them; under a data mesh of more than one rank
        ``tree`` is this rank's ZeRO-1 ``TrainState``. A tensor-parallel grid
        is not served here yet (ROADMAP A13.2): it raises."""
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            raise NotImplementedError("the RAM tier under a tensor-parallel grid "
                                      "(ROADMAP A13.2); save to the disk tier")
        t0 = time.perf_counter()
        named = named_leaves(tree)
        specs = (train_state_specs(tree, mesh, plan) if mesh is not None and mesh.size > 1
                 else None)
        primary: Dict[int, Dict[str, np.ndarray]] = {g: {} for g in range(self.groups)}
        shards: List[List[Dict[str, Any]]] = []
        for i, (name, x) in enumerate(named):
            a, dtype = _host(_held(x, specs[name], mesh.rank, mesh.size)
                             if specs is not None else x)
            home = i % self.groups
            primary[home][f"a{i}"] = a
            index = (local_index(specs[name], mesh.rank, mesh.size) if specs is not None
                     else None)
            shards.append([dict(_shard_meta(f"a{i}", a, dtype, index), home=home)])
        manifest = {
            "step": int(step),
            "names": [n for n, _ in named],
            "shapes": [list(specs[n].shape if specs is not None else stacked_shape(x))
                       for n, x in named],
            "dtypes": [m[0]["dtype"] for m in shards],
            "shards": shards,
            "plan": _plan_meta(plan),
            "mesh_axes": dict(mesh.shape) if mesh is not None else None,
            "time": time.time(),
        }
        mirror: Dict[int, Dict[str, np.ndarray]] = {g: {} for g in range(self.groups)}
        if self.groups > 1:
            for g in range(self.groups):
                mirror[(g + 1) % self.groups].update(
                    {k: np.array(a, copy=True) for k, a in primary[g].items()})
        self._ring.append({"manifest": manifest, "primary": primary, "mirror": mirror})
        self.snapshot_seconds = time.perf_counter() - t0
        if self.flight is not None:
            self.flight.record("ckpt.persist", step, tier="memory",
                               seconds=self.snapshot_seconds, groups=self.groups,
                               mirrored=self.groups > 1)

    def steps(self, newest_first: bool = False) -> List[int]:
        out = sorted(e["manifest"]["step"] for e in self._ring)
        return out[::-1] if newest_first else out

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def clear(self) -> None:
        """Drop every entry (after a layout change, or when the process ends)."""
        self._ring.clear()

    def _entry(self, step: Optional[int]) -> Dict[str, Any]:
        if not self._ring:
            raise CorruptCheckpointError("memory tier is empty")
        if step is None:
            return self._ring[-1]
        for e in self._ring:
            if e["manifest"]["step"] == step:
                return e
        raise CorruptCheckpointError(f"step {step} not in memory tier (have {self.steps()})")

    def lose_group(self, g: int) -> int:
        """Simulate losing host group ``g``: its primaries and the mirrors it
        held, in every entry. Returns the number of buffers destroyed."""
        lost = 0
        for e in self._ring:
            lost += len(e["primary"].get(g, {})) + len(e["mirror"].get(g, {}))
            e["primary"][g] = {}
            e["mirror"][g] = {}
        if self.flight is not None:
            self.flight.record("mem.lost_group", self.latest_step() or -1, group=int(g),
                               shards_lost=lost)
        return lost

    def _fetch(self, e: Dict[str, Any], m: Dict[str, Any], verify: bool) -> np.ndarray:
        """One member: from its home group, else from the neighbour's mirror,
        which is always verified."""
        home = m.get("home", 0)
        a = e["primary"].get(home, {}).get(m["key"])
        from_mirror = a is None
        if from_mirror:
            a = e["mirror"].get((home + 1) % self.groups, {}).get(m["key"])
            if a is None:
                raise CorruptCheckpointError(
                    f"shard {m['key']} lost from memory tier (home group {home} and its "
                    f"mirror both gone)")
            self.last_rebuild += 1
        if verify or from_mirror:
            _verify(a, m, f"memory-tier shard {m['key']}")
        return a

    def restore(self, tree_like: Any, step: Optional[int] = None, *, plan=None, mesh=None,
                verify: bool = False) -> Tuple[int, Any]:
        """Restore into ``tree_like`` as the disk tier does (tensors refilled in
        place); returns (step, tree). Raises CorruptCheckpointError when the tier
        cannot serve, and ValueError when ``plan``/``mesh`` differ from the
        recorded layout (``layout_diffs``): a remesh goes through the disk
        tier."""
        t0 = time.perf_counter()
        self.last_rebuild = 0
        e = self._entry(step)
        man = e["manifest"]
        diffs = layout_diffs(man, plan, mesh)
        if diffs:
            raise ValueError(f"memory-tier layout mismatch (recorded != requested): {diffs}; "
                             f"a remesh restores through the disk tier")
        arrays = [self._fetch(e, metas[0], verify) for metas in man["shards"]]
        tree = fill_tree(tree_like, man, arrays, mesh, plan)
        self.restore_seconds = time.perf_counter() - t0
        if self.flight is not None:
            self.flight.record("mem.restore", man["step"], rebuilt_shards=self.last_rebuild,
                               seconds=self.restore_seconds)
        return man["step"], tree
