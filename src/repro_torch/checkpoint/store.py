"""Checkpointing (port of ``repro/checkpoint/store.py``).

A checkpoint is the reference's: one ``.npz`` per step holding one member per
leaf (``a{i}``), plus a JSON manifest with the step, the leaf names, their
dtypes and shapes, and per member a sha256 prefix, a CRC32 and dtype/shape
digests. Leaves are named and ordered as ``jax.tree_util`` flattens the
reference's tree: dict keys sorted, NamedTuple fields in order (``params``,
``opt/step``, ``opt/mu``, ``opt/nu`` for a ``TrainState``), and the per-layer
dicts of a ``layers`` list stacked on a leading L dim, as the reference keeps
them. The optimizer step is an int32 scalar. A checkpoint of the port's
``TrainState`` is therefore one the reference's ``CheckpointManager.restore``
reads, and the reverse, with no converter.

bf16 leaves are stored as their uint16 bits under the manifest dtype
``"bfloat16"`` (numpy has no bfloat16). The reader takes a 2-byte member whose
manifest says ``bfloat16`` whether it is ``uint16`` (the port's) or ``|V2``
(what the reference's ``np.savez`` writes for an ``ml_dtypes`` array); the
digests are over bytes, so they match either way.

Snapshot and persist are split as in the reference: the snapshot copies the
state to the host (the only part that can stall training) and the persist
writes it on a background thread. The persist is atomic (the npz, then the
manifest, each through a temporary file and ``os.replace``, so a crash between
the two leaves the step unlisted), retried with exponential backoff under a
deadline, and ``wait()`` is the completion fence that re-raises a background
failure. GC keeps the newest ``keep`` steps and never evicts the newest intact
one while only wreckage would be kept.

``async_snapshot=True`` is the double buffer, designed for the card. The port's
AdamW updates params and moments in place (the reference instead clones the
state under buffer donation), so ``save`` dispatches on a side CUDA stream a
device-side copy of the state that is also its layout change (each ``layers``
list stacked in one pass) into staging buffers on the card, then the copy of
those into pinned host buffers, ``non_blocking``. Staging is bounded: leaves
take it in order while they fit in the card's free memory less ``HEADROOM``,
read when the buffers are made (after training has reached its peak, a save
takes what the steps leave free), and a leaf that does not fit is copied from the live tensors straight into its pinned buffer
before the fence. The main stream waits on the fence only: every read of the
live state, so the next step's in-place update comes after it. The staged
leaves' copy to the host overlaps the next steps, and the background thread
waits on its event before digesting and persisting. Cost: the staging buffers
(up to one copy of the state) stay on the card while the tree's layout stays
the same, and each leaf that did not fit holds the main stream for its copy
over PCIe. Without ``async_snapshot`` (or for a state not on the card)
``save`` copies to the host inline.

``restore`` verifies every digest and copies each leaf into the live tensors
of ``tree_like`` (``copy_``, onto their device and dtype), so autograd leaves
stay leaves.

Under a data mesh with ZeRO-1 (``repro_torch.launch.mesh``,
``core/sharding.py``) the format is the reference's for a state sharded over a
data axis: rank 0 writes params once and each moment leaf as one member per
rank, each with its global ``index`` in stacked coordinates, and the manifest
records the plan's layout axes (``PLAN_LAYOUT_AXES``) and ``mesh_axes``
(``{"data": n}``). Each rank's snapshot is the blocking host copy, and the
other ranks send their moment slices to rank 0 inside ``save``, over the
mesh's own gloo group: a synchronous gather, measured as ``gather_seconds``;
the persist stays on rank 0's background thread. Every rank restores by
reading whole leaves and taking its slices, so a restore onto another layout
(``restore_resharded``: dp n to m, ZeRO stage 0 to 1 and back) is the same
read. ``check_plan`` routes by the reference's rule: replay
when the recorded layout is the requested one, else reshard when elastic,
else an error.

Under ZeRO-3 (``plan.dp_shard`` > 1) the params are split as the moments
are (``core.sharding.fsdp_specs``): each param leaf is written as one member
per rank with its global ``index``, gathered to rank 0 with the moment
slices, and the manifest records the plan's ``dp_shard``; a restore takes
each rank's part of the whole leaf (its own layers of a leaf split on the
layer dim), so dp_shard 1, 2 and 4 and ZeRO stages 0 and 1 read the same
file, and the reference's ``CheckpointManager`` reassembles it by the
indices. A grid under ``dp_over_model`` saves and restores over its flat
data group (``launch.mesh.data_mesh``).

Under a (data, model) grid with tensor parallelism (``launch.mesh.GridMesh``)
each rank holds its TP shards of the params and moments, the moments also cut
to its ZeRO-1 slice over its data group. ``save`` gathers every rank's parts
to global rank 0 over the grid's gloo ``host_group`` and rank 0 writes whole
leaves, one member each, as the reference's file holds them; the manifest
records the plan's ``tp`` and ``mesh_axes`` ``{"data": D, "model": M}``.
``restore`` under the grid cuts each whole leaf to the rank's TP shard
(``core.sharding.overlap_spec_for_param``) and then to its ZeRO-1 slice, so
a restore at tp 1 (``restore_resharded`` onto one process) and at the saved
grid read the same file. Under context parallelism the params and moments
are the same on every cp rank, so only the ranks at cp index 0 (the grid's
``save_group``) take part in the gather; the manifest records the plan's
``cp`` and the grid's ``{"data": D, "cp": C, "model": M}``, and a restore at
another cp (1 included) routes "reshard", as the reference's does. Under
expert parallelism each rank of the fold holds its own block of the routed
experts (``core.sharding.ep_spec_for_param``), so every rank of the grid takes
part in the gather (``host_group``), rank 0 places each block into the whole
leaf, and the manifest records the plan's ``ep``; a restore cuts each whole
leaf to the rank's part under the requested plan (``plan=``), so ep 1, 2 and
4 read the same file, and ``check_plan`` refuses an ep change as a layout
mismatch while ``ep_impl``, which moves nothing, is free to change. Under
pipeline parallelism (a grid with a pod axis) each stage holds its own
layers: the ranks that hold distinct state (every stage's ranks at cp index
0, every rank under ep) send their parts to global rank 0 (a gather of
objects, since the stages' parts differ in size under an uneven layout),
which writes whole canonical leaves with every layer in order; the manifest
records ``pp``, ``pp_layout`` and ``pp_schedule``. A restore cuts each whole
leaf to the rank's stage under the requested plan, so any pp and pp_layout
(pp 1 included) read the same file, and ``check_plan`` routes a
``pp_layout`` change as a reshard (a rebalance is one), while a
``pp_schedule`` change replays.

Fault seams (``repro_torch.ft.inject``): ``ckpt.persist`` fires per persist
attempt (``hang``, ``persist_exc``), and ``ckpt.shard_write`` after the
manifest lands (``drop_write`` deletes the npz, ``truncate_write`` cuts it in
half: silent corruption the writer never sees). ``flight=`` (a
``FlightRecorder``) logs ``ckpt.persist``, ``ckpt.persist_fail`` and
``ckpt.gc_spared`` under the reference's event names.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.sharding import (LeafSpec, data_size, fsdp_part, grid_place,
                                       layout_box, layout_part, local_index, local_shape,
                                       opt_shard_dim, rank_stack, train_state_specs,
                                       whole_box, whole_shape)
from repro_torch.core.tree import named_leaves, stacked_shape
from repro_torch.launch.mesh import GridMesh, cp_size, data_mesh, model_size, pod_size


class CorruptCheckpointError(IOError):
    """A checkpoint failed integrity verification (checksum/CRC32 mismatch,
    a dtype or shape digest that disagrees, an unreadable manifest, a missing
    or truncated member)."""


def _inject():
    """The fault-injection module, imported lazily: ``repro_torch.ft``'s
    ``__init__`` imports ``ft.recovery``, which imports this module, so a
    top-level import here would cycle (as in the reference)."""
    from repro_torch.ft import inject  # noqa: PLC0415
    return inject


# ---------------------------------------------------------------------------
# the layout axes a manifest records (the reference's store.py:95-145)

# The reference's ParallelPlan layout axes, with each one's value on a plan
# that lacks it (the port's plan has every one): the manifest records the
# plan's values and either package compares them. The reference's PLAN_AXES
# also records impl and schedule knobs for forensics; of those the port
# records pp_schedule, never compared (a schedule moves no state).
PLAN_LAYOUT_AXES = {"tp": 1, "cp": 1, "dp_shard": 1, "zero_stage": 1, "ep": 1, "pp": 1,
                    "pp_layout": None}
PLAN_RECORDED = {"pp_schedule": "1f1b"}


def _plan_meta(plan) -> Optional[Dict[str, Any]]:
    if plan is None:
        return None
    meta = {k: getattr(plan, k, d) for k, d in {**PLAN_LAYOUT_AXES, **PLAN_RECORDED}.items()}
    # tuples (pp_layout) JSON-round-trip as lists; normalised here so the
    # comparison in layout_diffs stays type-stable
    return {k: list(v) if isinstance(v, tuple) else v for k, v in meta.items()}


def layout_diffs(manifest: Dict[str, Any], plan, mesh=None) -> Dict[str, Tuple[Any, Any]]:
    """The layout axes on which a manifest and a requested plan/mesh differ:
    {axis: (recorded, requested)}, empty when a replay is safe. Shared by
    :meth:`CheckpointManager.check_plan` and ``MemoryCheckpointTier.restore``,
    so both tiers route by the same rule (the reference's)."""
    recorded = manifest.get("plan")
    diffs: Dict[str, Tuple[Any, Any]] = {}
    if recorded is not None and plan is not None:
        want = _plan_meta(plan)
        rec = dict(recorded)
        # manifests written before ep became an integer degree recorded a bool:
        # False is degree 1; True (GSPMD expert sharding) has no degree and never
        # replays (Python would otherwise equate True == 1)
        if isinstance(rec.get("ep"), bool):
            rec["ep"] = 1 if rec["ep"] is False else "legacy-gspmd-ep"
        diffs = {k: (rec[k], want[k]) for k in PLAN_LAYOUT_AXES
                 if k in rec and k in want and rec[k] != want[k]}
    rec_mesh = manifest.get("mesh_axes")
    if mesh is not None and rec_mesh is not None:
        want_mesh = {k: int(v) for k, v in dict(mesh.shape).items()}
        if {k: int(v) for k, v in rec_mesh.items()} != want_mesh:
            diffs["mesh_axes"] = (rec_mesh, want_mesh)
    return diffs


# ---------------------------------------------------------------------------
# the tree <-> named leaves, in the reference's layout (core.tree.named_leaves)


def _refill(tree, get, prefix: str = "", rank: Tuple[int, int] = (0, 1)):
    """``tree`` with every tensor overwritten in place (``copy_``) by
    ``get(name)`` and every scalar replaced by it; containers are rebuilt
    around the same tensors, so autograd leaves stay leaves. A tensor that is
    one data rank's slice of the leaf takes that slice (``_rank_slice``;
    ``rank`` is (this rank, the data ranks))."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_refill(getattr(tree, f), get, f"{prefix}{f}/", rank)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _refill(v, get, f"{prefix}{k}/", rank) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_refill(lp, lambda n, i=i, L=len(tree): _layer(get(n), i, L, rank[0]),
                        prefix, rank) for i, lp in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        part = fsdp_part(tree)
        if part is not None and part.owner is not None and part.owner != rank[0]:
            return tree                    # another data rank's layer: a placeholder
    value = get(prefix[:-1])
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            tree.copy_(_rank_slice(value, tuple(tree.shape), *rank, prefix[:-1]))
        return tree
    return type(tree)(value.item())


def _layer(value, i: int, n_layers: int, rank: int):
    """Layer ``i`` of a layer list's stacked ``value``: the whole list's, or
    (its layer dim shorter: a ZeRO-3 rank's own layers) this rank's."""
    if value.shape[0] == n_layers:
        return value[i]
    return value[i - rank * value.shape[0]]


def _rank_slice(value: torch.Tensor, shape: Tuple[int, ...], rank: int, n: int,
                name: str) -> torch.Tensor:
    """``value`` (a whole leaf) cut to rank ``rank``'s slice of ``n`` when
    ``shape`` is such a slice: equal to ``value``'s shape but on one dim, which
    is 1/n of it (``core.sharding.local_index``)."""
    have = tuple(value.shape)
    if have == shape:
        return value
    diff = [d for d, (h, w) in enumerate(zip(have, shape)) if h != w]
    if len(have) != len(shape) or len(diff) != 1 or have[diff[0]] != shape[diff[0]] * n:
        raise ValueError(f"{name}: checkpoint shape {have} != {shape}")
    k = shape[diff[0]]
    return value.narrow(diff[0], rank * k, k)


def _stack(leaf) -> torch.Tensor:
    return torch.stack([t.detach() for t in leaf]) if isinstance(leaf, list) else leaf.detach()


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host tensor as (numpy array, manifest dtype): bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A blocking, owned host copy of one leaf (the stacked copy of a layer
    list): (numpy array, manifest dtype). Python scalars become int32 (the
    optimizer step, as the reference's) or their numpy type."""
    if not isinstance(leaf, (torch.Tensor, list)):
        a = np.asarray(leaf, np.int32 if isinstance(leaf, int) else None)
        return a, str(a.dtype)
    t = _stack(leaf)
    if t.is_cuda:
        t = t.to("cpu")
    elif not isinstance(leaf, list):
        t = t.clone()                      # the live tensor changes in place
    return _to_numpy(t)


def _stored(a: np.ndarray, dtype: str) -> np.ndarray:
    """A member as stored: a bf16 one (uint16 or |V2) read as uint16 bits."""
    return a.view(np.uint16) if dtype == "bfloat16" and a.dtype.itemsize == 2 else a


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _dtype_ok(a: np.ndarray, dtype: str) -> bool:
    if dtype == "bfloat16":
        return a.dtype.itemsize == 2 and a.dtype.kind in "uV"
    return str(a.dtype) == dtype


def _verify(a: np.ndarray, m: Dict[str, Any], what: str) -> None:
    """One member against its manifest digests; raises CorruptCheckpointError."""
    if _checksum(a) != m["checksum"] or ("crc32" in m and _crc32(a) != m["crc32"]):
        raise CorruptCheckpointError(f"checksum mismatch for {what}")
    if "dtype" in m and not _dtype_ok(a, m["dtype"]):
        raise CorruptCheckpointError(f"dtype digest mismatch for {what}: "
                                     f"{a.dtype} != {m['dtype']}")
    if "shape" in m and list(a.shape) != list(m["shape"]):
        raise CorruptCheckpointError(f"shape digest mismatch for {what}: "
                                     f"{list(a.shape)} != {m['shape']}")


def _shard_meta(key: str, a: np.ndarray, dtype: str,
                index: Optional[List[List[int]]] = None) -> Dict[str, Any]:
    """A member's manifest entry; ``index`` is its slice of the leaf (the whole
    of ``a`` by default)."""
    return {"key": key, "index": index or [[0, int(d)] for d in a.shape],
            "checksum": _checksum(a), "crc32": _crc32(a), "dtype": dtype,
            "shape": [int(d) for d in a.shape]}


# the card's memory the double buffer leaves free when it sizes its staging
HEADROOM = 2 << 30


def _staged(sizes: List[int], budget: int) -> List[bool]:
    """Which leaves of ``sizes`` bytes take device staging: each in order while
    it fits in what is left of ``budget``."""
    out = []
    for n in sizes:
        out.append(0 < n <= budget)
        budget -= n if out[-1] else 0
    return out


def _copy_leaf(dst: torch.Tensor, leaf) -> None:
    """``dst`` (a staging or pinned buffer) <- one leaf, a layer list stacked."""
    if not isinstance(leaf, list):
        dst.copy_(leaf.detach(), non_blocking=True)
    elif dst.is_cuda:
        torch.stack([t.detach() for t in leaf], out=dst)
    else:
        for i, t in enumerate(leaf):
            dst[i].copy_(t.detach(), non_blocking=True)


class _DeviceSnapshot:
    """The double buffer: on ``stream``, after the main stream's work so far,
    each leaf with a staging buffer is copied into it and every other tensor
    leaf straight into its pinned buffer; the main stream waits on that much
    (the fence). Then the staged leaves go to their pinned buffers.
    :meth:`host` (on the persist thread) waits for the host copy and returns
    the buffers as numpy arrays."""

    def __init__(self, leaves, pinned, stage, stream):
        main = torch.cuda.current_stream()
        stream.wait_stream(main)
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.cuda.stream(stream):
            self.events[0].record()
            for x, b, s in zip(leaves, pinned, stage):
                if b is not None:
                    _copy_leaf(s if s is not None else b, x)
            self.events[1].record()
            for b, s in zip(pinned, stage):
                if s is not None:
                    b.copy_(s, non_blocking=True)
            self.events[2].record()
        main.wait_event(self.events[1])
        self.pinned = pinned
        self.scalars = {i: _host(x) for i, (x, b) in enumerate(zip(leaves, pinned))
                        if b is None}

    def host(self) -> List[Tuple[np.ndarray, str]]:
        self.events[2].synchronize()
        self.fence_seconds = self.events[0].elapsed_time(self.events[1]) / 1e3
        self.d2h_seconds = self.events[1].elapsed_time(self.events[2]) / 1e3
        return [self.scalars[i] if b is None else _to_numpy(b)
                for i, b in enumerate(self.pinned)]


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_snapshot: bool = False,
                 io_retries: int = 3, io_backoff: float = 0.05, io_timeout: float = 30.0,
                 flight=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_snapshot = async_snapshot
        self.flight = flight                  # a FlightRecorder, or None
        # io_retries attempts with backoff io_backoff * 2^k, abandoned once the
        # cumulative wait would pass io_timeout; the last failure surfaces
        # through save()/wait()
        self.io_retries = max(1, int(io_retries))
        self.io_backoff = io_backoff
        self.io_timeout = io_timeout
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._fence = None                    # the mesh of a save not yet fenced
        self._stream = None                   # the side stream of the double buffer
        self._buffers: Tuple[Any, list, list] = (None, [], [])
        self.snapshot_seconds = 0.0           # main-thread stall of the last save
        self.fence_seconds = 0.0              # device time the main stream waits on (async)
        self.d2h_seconds = 0.0                # device -> host copy after the fence
        self.staged_bytes = 0                 # the state's bytes that take staging (async)
        self.gather_seconds = 0.0             # moment slices to rank 0 (a data mesh)
        self.persist_seconds = 0.0
        self.bytes_written = 0                # the last checkpoint's npz

    # -- save ---------------------------------------------------------------

    def _snapshot_buffers(self, leaves):
        """(pinned host buffers, device staging buffers) for the leaves: None
        for a scalar, and no staging for a leaf that does not fit (module
        docstring). Kept while the tree's layout stays the same."""
        key = tuple((stacked_shape(x), _stack_dtype(x)) if isinstance(x, (torch.Tensor, list))
                    else None for x in leaves)
        if self._buffers[0] != key:
            self._buffers = (None, [], [])                # free the old ones first
            budget = torch.cuda.mem_get_info()[0] - HEADROOM
            sizes = [0 if k is None else int(np.prod(k[0])) * k[1].itemsize for k in key]
            device = next(t for x in leaves if isinstance(x, (torch.Tensor, list))
                          for t in (x if isinstance(x, list) else [x])).device
            pinned = [None if k is None else torch.empty(k[0], dtype=k[1], pin_memory=True)
                      for k in key]
            stage = [torch.empty(k[0], dtype=k[1], device=device) if s else None
                     for k, s in zip(key, _staged(sizes, budget))]
            self._buffers = (key, pinned, stage)
            self.staged_bytes = sum(n for n, s in zip(sizes, stage) if s is not None)
        return self._buffers[1], self._buffers[2]

    def save(self, step: int, tree: Any, blocking: bool = False, *, plan=None,
             mesh=None) -> Path:
        """Snapshot, then persist on a background thread; returns the
        checkpoint path (sans suffix). With ``async_snapshot`` and a state on
        the card, the main thread only dispatches the double buffer (module
        docstring); otherwise the host copy is the stall. ``blocking=True``
        does everything inline. ``plan`` and ``mesh`` are recorded in the
        manifest: the layout ``check_plan`` routes by. Raises any failure of
        the previous save's background work.

        Under a data ``mesh`` of more than one rank every rank calls ``save``
        with its ZeRO-1 ``TrainState`` (params whole, moments this rank's
        slices): each copies its state to the host, the moment slices go to
        rank 0 over ``mesh.host_group`` (both inline: the stall), and rank 0
        alone persists, params once and each moment as its slices with their
        global index, as the reference writes a leaf sharded over a data
        mesh. ``wait`` is then a barrier of the ranks."""
        self.wait()
        t0 = time.perf_counter()
        named = named_leaves(tree)
        names = [n for n, _ in named]
        leaves = [x for _, x in named]
        shapes = [list(stacked_shape(x)) for x in leaves]
        layout = {"plan": _plan_meta(plan),
                  "mesh_axes": dict(mesh.shape) if mesh is not None else None}
        path = self.dir / f"ckpt_{step:08d}"
        device = host = None
        if isinstance(mesh, GridMesh) and mesh.flat is None and (
                model_size(mesh) > 1 or cp_size(mesh) > 1 or pod_size(mesh) > 1):
            shapes, host = self._gather_grid(tree, named, plan, mesh)
            self._fence = mesh
            if mesh.rank != 0:
                return path
        elif mesh is not None and data_size(mesh) > 1:
            dmesh = data_mesh(mesh)
            shapes, host = self._gather_slices(tree, named, plan, dmesh)
            self._fence = dmesh
            if dmesh.rank != 0:
                return path
        elif self.async_snapshot and not blocking and _on_card(leaves):
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            device = _DeviceSnapshot(leaves, *self._snapshot_buffers(leaves), self._stream)
        else:
            host = [[(*_host(x), None)] for x in leaves]
            self.fence_seconds, self.d2h_seconds = 0.0, time.perf_counter() - t0
        self.snapshot_seconds = time.perf_counter() - t0

        def snapshot_and_persist():
            nonlocal host
            if host is None:
                host = [[(a, dt, None)] for a, dt in device.host()]
                self.fence_seconds, self.d2h_seconds = device.fence_seconds, device.d2h_seconds
            t1 = time.perf_counter()
            arrays, shards = {}, []
            for i, parts in enumerate(host):
                metas = []
                for j, (a, dt, index) in enumerate(parts):
                    key = f"a{i}" if len(parts) == 1 else f"a{i}_s{j}"
                    arrays[key] = a
                    metas.append(_shard_meta(key, a, dt, index))
                shards.append(metas)
            manifest = {
                "step": step,
                "names": names,
                "checksums": [m[0]["checksum"] for m in shards],
                "dtypes": [parts[0][1] for parts in host],
                "shapes": shapes,
                "shards": shards,
                **layout,
                "time": time.time(),
            }
            self._persist_with_retry(step, path, arrays, manifest)
            self.persist_seconds = time.perf_counter() - t1
            if self.flight is not None:
                self.flight.record("ckpt.persist", step, tier="disk",
                                   seconds=self.persist_seconds)
            self._gc()

        def background():
            try:
                snapshot_and_persist()
            except BaseException as e:      # surfaced at the next save()/wait()
                self._error = e

        if not blocking:
            self._pending = threading.Thread(target=background, daemon=True)
            self._pending.start()
        else:
            snapshot_and_persist()
        return path

    def _gather_slices(self, state, named, plan, mesh):
        """The ZeRO-1 save's snapshot (``save``): this rank's leaves copied to
        the host, checked against ``plan``'s layout, and on rank 0 every
        rank's moment slices beside its own. Returns (the leaves' full shapes,
        per leaf a list of (array, manifest dtype, global index or None))."""
        if not hasattr(state, "params"):
            raise ValueError("a save under a data mesh takes a TrainState")
        specs = train_state_specs(state, mesh, plan)
        n = mesh.size
        t0 = time.perf_counter()
        host, split = [], []
        for name, x in named:
            spec = specs[name]
            x = _held(x, spec, mesh.rank, n)
            if stacked_shape(x) != local_shape(spec, n):
                raise ValueError(f"{name}: {stacked_shape(x)} is not a rank's slice "
                                 f"{local_shape(spec, n)} of {spec.shape} under {mesh}")
            a, dt = _host(x)
            index = None if spec.dim is None else local_index(spec, mesh.rank, n)
            host.append([(a, dt, index)])
            if spec.dim is not None:
                split.append(len(host) - 1)
        self.fence_seconds, self.d2h_seconds = 0.0, time.perf_counter() - t0
        t1 = time.perf_counter()
        if split:
            flat = torch.from_numpy(np.concatenate(
                [host[i][0][0].reshape(-1).view(np.uint8) for i in split]))
            got = [torch.empty_like(flat) for _ in range(n)] if mesh.rank == 0 else None
            dist.gather(flat, got, dst=0, group=mesh.host_group)
            if mesh.rank == 0:
                off = 0
                for i in split:
                    a, dt, _ = host[i][0]
                    spec = specs[named[i][0]]
                    for r in range(1, n):
                        b = got[r][off:off + a.nbytes].numpy().view(a.dtype).reshape(a.shape)
                        host[i].append((b, dt, local_index(spec, r, n)))
                    off += a.nbytes
        self.gather_seconds = time.perf_counter() - t1
        self.snapshot_seconds = time.perf_counter() - t0
        return [list(specs[name].shape) for name, _ in named], host

    def _gather_grid(self, state, named, plan, mesh):
        """The save's snapshot under a grid (module docstring): the leaves of
        each rank at cp index 0 (every rank under ep, whose expert blocks
        differ over the cp ranks too) copied to the host and sent to global
        rank 0 over the grid's ``save_group`` (``host_group``) in one flat
        gather (:func:`gather_flat`), and placed there into whole leaves; the
        other cp ranks hold the same and send nothing. Returns (the whole
        shapes, per leaf [(array, manifest dtype, None)] on rank 0, None
        elsewhere)."""
        if not hasattr(state, "params"):
            raise ValueError("a save under a grid takes a TrainState")
        specs = train_state_specs(state, mesh, plan)
        n_data, n_cp, n_model = mesh.shape["data"], mesh.shape.get("cp", 1), mesh.shape["model"]
        n_pod = pod_size(mesh)
        place, sizes = grid_place(mesh)
        ep = getattr(plan, "ep", 1) > 1
        members = [(p, d, c, m) for p in range(n_pod) for d in range(n_data)
                   for c in range(n_cp if ep else 1)
                   for m in range(n_model)]          # the gather group's order
        shapes = [list(whole_shape(name, specs[name].shape, plan, sizes)) for name, _ in named]
        t0 = time.perf_counter()
        self.fence_seconds = self.d2h_seconds = self.gather_seconds = 0.0
        if not ep and mesh.cp is not None and mesh.cp.rank != 0:
            self.snapshot_seconds = 0.0
            return shapes, None
        host = [_host(x) for _, x in named]
        self.d2h_seconds = time.perf_counter() - t0
        t1 = time.perf_counter()
        group = mesh.host_group if ep else mesh.save_group
        got = (gather_objects([a for a, _ in host], group) if n_pod > 1
               else gather_flat([a for a, _ in host], group))
        out = None
        if got is not None:
            out = [[(np.zeros(shape, dtype=a.dtype), dt, None)]
                   for (a, dt), shape in zip(host, shapes)]
            for (p, d, c, m), arrays in zip(members, got):
                at = {"model": m, "cp": c, "pod": p}
                for (name, _), b, parts, shape in zip(named, arrays, out, shapes):
                    spec = (_member_spec(name, shape, specs[name], plan, at, sizes, n_data)
                            if n_pod > 1 else specs[name])
                    box = _grid_index(name, spec, plan, d, n_data, at, sizes)
                    parts[0][0][tuple(slice(lo, hi) for lo, hi in box)] = b
        self.gather_seconds = time.perf_counter() - t1
        self.snapshot_seconds = time.perf_counter() - t0
        return shapes, out

    def _persist_once(self, step: int, path: Path, arrays, manifest) -> None:
        """One atomic attempt: the npz, then the manifest, each written to a
        temporary path and ``os.replace``d into place. A crash between the two
        leaves no manifest, so the step is never listed."""
        inj = _inject()
        inj.io_fault("ckpt.persist", step)
        tmp_npz = str(path) + ".tmp.npz"          # savez appends .npz itself
        np.savez(tmp_npz[:-4], **arrays)
        self.bytes_written = os.path.getsize(tmp_npz)
        os.replace(tmp_npz, str(path) + ".npz")
        tmp_json = Path(str(path) + ".json.tmp")
        tmp_json.write_text(json.dumps(manifest))
        os.replace(tmp_json, path.with_suffix(".json"))
        sp = inj.io_spec_for("ckpt.shard_write", step, ("drop_write", "truncate_write"))
        if sp is not None:
            npz = Path(str(path) + ".npz")
            if sp.kind == "drop_write":
                npz.unlink(missing_ok=True)
            else:
                data = npz.read_bytes()
                npz.write_bytes(data[:max(len(data) // 2, 1)])

    def _persist_with_retry(self, step: int, path: Path, arrays, manifest) -> None:
        """Up to ``io_retries`` attempts, delays ``io_backoff * 2^k``, within
        the ``io_timeout`` deadline; the last failure propagates."""
        deadline = time.time() + self.io_timeout
        delay = self.io_backoff
        for attempt in range(1, self.io_retries + 1):
            try:
                return self._persist_once(step, path, arrays, manifest)
            except Exception as e:
                if attempt >= self.io_retries or time.time() + delay > deadline:
                    if self.flight is not None:
                        self.flight.record("ckpt.persist_fail", step, attempts=attempt,
                                           error=repr(e))
                    raise
                time.sleep(delay)
                delay *= 2

    def wait(self):
        """Completion fence: join the in-flight snapshot/persist and raise any
        failure it hit. After a save under a data mesh it is a barrier of the
        ranks (each calls it) that raises on every rank if rank 0's persist
        failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        err, self._error = self._error, None
        mesh, self._fence = self._fence, None
        if mesh is not None and mesh.barrier_error(err is not None) and err is None:
            raise RuntimeError("background checkpoint persist failed on data rank 0")
        if err is not None:
            raise RuntimeError(f"background checkpoint persist failed: {err!r}") from err

    def leave_mesh(self) -> None:
        """Forget the data mesh of a save not yet fenced, after that mesh's
        group lost ranks (a remesh): the next :meth:`wait` joins this
        process's own persist and runs no barrier on the old group."""
        self._fence = None

    def _is_intact(self, step: int) -> bool:
        """The manifest parses, the npz opens and holds every recorded member
        (dropped and truncated writes); bit flips are left to the verify at
        restore. No fence: the persist thread calls it from ``_gc``."""
        path = self.dir / f"ckpt_{step:08d}"
        try:
            man = self._read_manifest(step)
            with zipfile.ZipFile(str(path) + ".npz") as zf:
                members = set(zf.namelist())
            shard_meta = man.get("shards") or [[{"key": f"a{i}"}]
                                               for i in range(len(man["checksums"]))]
            return all(m["key"] + ".npy" in members for ms in shard_meta for m in ms)
        except (CorruptCheckpointError, OSError, zipfile.BadZipFile, KeyError, ValueError):
            return False

    def _gc(self):
        """Evict beyond ``keep``, verify-before-evict: if none of the kept
        checkpoints is intact, the newest intact evictee is spared."""
        steps = self._disk_steps()
        doomed = steps[:-self.keep] if self.keep > 0 else list(steps)
        if not doomed:
            return
        spare = None
        if not any(self._is_intact(s) for s in steps[len(doomed):]):
            spare = next((s for s in reversed(doomed) if self._is_intact(s)), None)
        for s in doomed:
            if s == spare:
                if self.flight is not None:
                    self.flight.record("ckpt.gc_spared", s,
                                       reason="newest_intact_keep_floor")
                continue
            old = self.dir / f"ckpt_{s:08d}.json"
            old.unlink(missing_ok=True)
            old.with_suffix(".npz").unlink(missing_ok=True)

    # -- restore ------------------------------------------------------------

    def _disk_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("ckpt_*.json"):
            try:
                out.append(int(p.stem.split("_", 1)[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def steps(self, newest_first: bool = False) -> List[int]:
        """Every checkpoint's step, from the file names (a corrupt manifest
        still lists)."""
        self.wait()
        out = self._disk_steps()
        return out[::-1] if newest_first else out

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _read_manifest(self, step: int) -> Dict[str, Any]:
        path = self.dir / f"ckpt_{step:08d}"
        try:
            return json.loads(path.with_suffix(".json").read_text())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CorruptCheckpointError(
                f"unreadable manifest for step {step} in {self.dir}: {e!r}") from e

    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return self._read_manifest(step)

    def check_plan(self, plan, step: Optional[int] = None, *, mesh=None,
                   elastic: bool = False) -> str:
        """Route a restore of ``step`` onto ``plan`` (and ``mesh``, when
        given): ``"replay"`` when the recorded layout axes and mesh sizes are
        the requested ones (``layout_diffs``); when they differ,
        ``"reshard"`` with ``elastic`` (take :meth:`restore_resharded`) and a
        ``ValueError`` without, since replaying a checkpoint onto another
        layout unasked is the failure this check exists to refuse."""
        diffs = layout_diffs(self.manifest(step), plan, mesh)
        if not diffs:
            return "replay"
        if elastic:
            return "reshard"
        raise ValueError(f"checkpoint layout mismatch (recorded != requested): {diffs}")

    def _read_full(self, step: int, verify: bool) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        """Every leaf as a full host array (uint16 bits for bf16), each member
        verified against its digests; members written as shards (by the
        reference on a mesh) are reassembled by their index slices."""
        path = self.dir / f"ckpt_{step:08d}"
        manifest = self._read_manifest(step)
        try:
            data = np.load(str(path) + ".npz")
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            raise CorruptCheckpointError(f"unreadable shard file {path}.npz: {e!r}") from e
        shard_meta = manifest.get("shards") or [
            [{"key": f"a{i}", "index": None, "checksum": c}]
            for i, c in enumerate(manifest["checksums"])]
        arrays = []
        for metas, shape, dt, n in zip(shard_meta, manifest["shapes"], manifest["dtypes"],
                                       manifest["names"]):
            parts = []
            for m in metas:
                try:
                    a = data[m["key"]]
                except Exception as e:              # truncated or dropped member
                    raise CorruptCheckpointError(
                        f"unreadable shard {m['key']} for {n} in {path}: {e!r}") from e
                if verify:
                    _verify(a, m, f"{n} in {path}")
                parts.append((m, _stored(a, dt)))
            if len(parts) == 1:
                arrays.append(parts[0][1])
                continue
            full = np.zeros(shape, dtype=parts[0][1].dtype)
            for m, a in parts:
                full[tuple(slice(lo, hi) for lo, hi in m["index"])] = a
            arrays.append(full)
        return manifest, arrays

    def restore(self, tree_like: Any, step: Optional[int] = None, verify: bool = True, *,
                mesh=None, plan=None) -> Tuple[int, Any]:
        """Restore into ``tree_like``: every tensor overwritten in place on its
        device and in its dtype, the optimizer step replaced; returns (step,
        tree). Every leaf is read whole (its shards reassembled); under a data
        ``mesh`` a tensor that is this rank's ZeRO-1 slice takes its slice,
        and under a grid the rank's part by ``plan``'s layout first (None: the
        TP layout). Raises CorruptCheckpointError on a failed digest."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        manifest, arrays = self._read_full(step, verify)
        return step, fill_tree(tree_like, manifest, arrays, mesh, plan)

    def restore_resharded(self, tree_like: Any, step: Optional[int] = None,
                          verify: bool = True, *, mesh=None, plan=None) -> Tuple[int, Any]:
        """Elastic restore (survey §8.3.2) of a ``TrainState`` onto the layout
        of ``plan`` over ``mesh`` (no mesh: one process), whatever layout the
        checkpoint was written on: dp n to m (1 included), ZeRO stage 0 to
        1 and back, and a grid's tp, cp or ep to another (1 included: the
        file holds whole leaves). ``tree_like`` must already be laid out so
        (``init_train_state(model, gen, mesh, plan)``); every leaf is read
        whole and each rank takes its slices, as :meth:`restore` does."""
        specs = train_state_specs(tree_like, mesh, plan)
        n = data_size(mesh)
        rank = data_mesh(mesh).rank if mesh is not None else 0
        for name, x in named_leaves(tree_like):
            if isinstance(x, (torch.Tensor, list)):
                x = _held(x, specs[name], rank, n)
                if stacked_shape(x) != local_shape(specs[name], n):
                    raise ValueError(f"{name}: {stacked_shape(x)} is not the layout of the "
                                     f"requested plan and mesh, {local_shape(specs[name], n)}")
        return self.restore(tree_like, step, verify, mesh=mesh, plan=plan)


def gather_flat(arrays: List[np.ndarray], group) -> Optional[List[List[np.ndarray]]]:
    """Every rank of ``group``'s host ``arrays`` (the same shapes and dtypes on
    each) on global rank 0, in one flat gather of their bytes: per rank of
    the group, in its order, the list of arrays there; None elsewhere."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    flat = torch.from_numpy(np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays]))
    me = dist.get_rank()
    got = ([torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
           if me == 0 else None)
    dist.gather(flat, got, dst=0, group=group)
    if me != 0:
        return None
    out = []
    for buf in got:
        parts, off = [], 0
        for a in arrays:
            parts.append(buf[off:off + a.nbytes].numpy().view(a.dtype).reshape(a.shape))
            off += a.nbytes
        out.append(parts)
    return out


def gather_objects(arrays: List[np.ndarray], group) -> Optional[List[List[np.ndarray]]]:
    """:func:`gather_flat` for arrays whose shapes differ over the ranks (a
    pipeline's stages under an uneven layout): one ``gather_object``."""
    me = dist.get_rank()
    got = [None] * dist.get_world_size(group) if me == 0 else None
    dist.gather_object([np.ascontiguousarray(a) for a in arrays], got, dst=0, group=group)
    return got


def _member_spec(name: str, whole, spec: LeafSpec, plan, place, sizes, n_data: int) -> LeafSpec:
    """The layout of the leaf ``name`` (whole stacked shape ``whole``) on the
    grid rank at ``place``: its part's shape, and for a moment its ZeRO-1
    split over ``n_data`` ranks as on that part (a stage's layer count, and
    so the split, may differ from this rank's, ``spec``)."""
    shape = tuple(hi - lo for lo, hi in whole_box(name, whole, plan, place, sizes))
    dim = spec.dim
    if name.startswith(("opt/mu/", "opt/nu/")):
        dim = opt_shard_dim(shape, n_data if getattr(plan, "zero_stage", 1) >= 1 else 1)
    return LeafSpec(shape, dim, spec.dtype)


def _by_name(tree_like, manifest: Dict[str, Any], arrays: List[np.ndarray]):
    """{leaf name: (array, manifest dtype)}, after checking that
    ``tree_like``'s names are the manifest's."""
    names = [n for n, _ in named_leaves(tree_like)]
    if names != manifest["names"]:
        raise ValueError("checkpoint tree structure mismatch: "
                         f"{sorted(set(names) ^ set(manifest['names']))[:5]}")
    return dict(zip(names, zip(arrays, manifest["dtypes"])))


def fill_tree(tree_like, manifest: Dict[str, Any], arrays: List[np.ndarray], mesh=None,
              plan=None):
    """``tree_like`` refilled from a manifest's leaves (``_refill``; under a
    data ``mesh`` this rank's slices; under a grid its parts by ``plan``'s
    layout, TP shards and expert blocks (None: the TP layout), then their
    slices over its data group), after checking that its names are the
    manifest's."""
    by_name = _by_name(tree_like, manifest, arrays)
    if isinstance(mesh, GridMesh):
        place = grid_place(mesh)
        dmesh = data_mesh(mesh)
        return _refill(tree_like, lambda n: layout_part(n, _to_torch(*by_name[n]), plan, *place),
                       rank=(dmesh.rank, dmesh.size))
    rank = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    return _refill(tree_like, lambda n: _to_torch(*by_name[n]), rank=rank)


def fill_held(tree_like, manifest: Dict[str, Any], arrays: List[np.ndarray], mesh=None):
    """``tree_like`` refilled from a manifest's members that are what this
    rank holds of each leaf (the RAM tier's entries: under a mesh, its slices,
    TP shards or expert blocks), after checking that its names are the
    manifest's."""
    by_name = _by_name(tree_like, manifest, arrays)
    dmesh = data_mesh(mesh) if mesh is not None else None
    rank = (dmesh.rank, dmesh.size) if dmesh is not None else (0, 1)
    return _refill(tree_like, lambda n: _to_torch(*by_name[n]), rank=rank)


def _grid_index(name: str, spec, plan, d_idx: int, n_data: int, place,
                sizes) -> List[List[int]]:
    """The box of the whole leaf that the grid rank at data index ``d_idx``
    and ``place`` holds, as [[start, stop], ...] per stacked dim: its part by
    ``plan``'s layout, then its ZeRO-1 slice of that (``spec`` is the leaf's
    layout on the rank's part)."""
    part = layout_box(name, spec.shape, plan, place, sizes)
    return [[base + lo, base + hi] for (base, _), (lo, hi)
            in zip(part, local_index(spec, d_idx, n_data))]


def _held(x, spec: LeafSpec, rank: int, n: int):
    """What this data rank holds of the leaf ``x`` in stacked order: under
    ZeRO-3 a layer list split on its layer dim is its own layers
    (``core.sharding.rank_stack``), every other leaf itself."""
    return rank_stack(x, spec, rank, n) if isinstance(x, list) else x


def _stack_dtype(leaf) -> torch.dtype:
    return (leaf[0] if isinstance(leaf, list) else leaf).dtype


def _on_card(leaves) -> bool:
    tensors = [t for x in leaves if isinstance(x, (torch.Tensor, list))
               for t in (x if isinstance(x, list) else [x])]
    return bool(tensors) and all(t.is_cuda for t in tensors)
