"""Deterministic fault injection (survey §8.1/§8.2; port of
``repro/ft/inject.py``): scheduled, seeded, replayable faults at **named fault
points** threaded through the real hot paths, so a failure seen once replays
bit for bit.

===================  ========================================================
fault point          where it fires
===================  ========================================================
``ckpt.persist``     ``CheckpointManager``'s persist write, per attempt (host)
``ckpt.shard_write`` the npz on disk after a successful-looking write
                     (``drop_write`` / ``truncate_write``)
``train.step``       the recovery driver's loop, via :func:`make_injector`
``tp.ring.tick``     overlap-TP ring payloads as each all-gather tick lands
                     (``train/tensor_parallel.py``)
``cp.ring.kv``       ring-attention KV chunks (A13.3)
``cp.ring.state``    the SSD entering-state chain (A13.3)
``ep.a2a.tick``      the EP all-to-all ring payloads (A13.4)
``kernel.attention`` / ``kernel.expert_gemm`` / ``kernel.ssd``
                     the dispatchers' outputs (``kernels/dispatch.py``)
``integrity.checksum``  the integrity checksum input (``ft/integrity.py``)
``pp.stage.tick``    per-stage pipeline tick timing (``slow`` only; the
                     straggler timer's per-stage shares under ``plan.pp``)
``data.fetch``       the driver's batch fetch (``slow`` only)
===================  ========================================================

All thirteen names are the reference's, so a :class:`FaultSpec` validates the
same in both packages.

**Eager semantics.** The reference bakes a corruption into a traced function:
:func:`taint` fires while the *trace* runs inside an armed block, and the
compiled twin carries it. Here every call is the real call, so:

- :func:`taint` fires on the calls made while a spec is armed, and is the
  identity (one attribute read) otherwise;
- :func:`trace_with_faults` builds no trace and does not run ``fn``: the port's
  train step updates params and moments in place, so a run at build time would
  advance the state. Its twin arms the specs with fresh counters on every call,
  runs ``fn`` and disarms in a ``finally``;
- ``tick`` counts *calls*, not traces: tick n is the n-th call of the point in
  the armed window (the n-th dispatcher call of the forward). Under the
  reference's layer ``lax.scan`` one trace of the body serves every layer, so
  tick 0 there corrupts every layer and tick n > 0 may never fire.
  ``tick=None`` fires on every call in both packages;
- ``remat="full"`` recomputes each layer in the backward, which calls the
  dispatcher again. :func:`remat_context` (the executor's ``context_fn`` for
  ``torch.utils.checkpoint``) replays the forward's decisions there: the
  recompute sees the specs and per-point counters the forward saw, so it
  applies exactly the forward's corruption and its gradients belong to that
  forward.

Rank masking: eager code has no ``axis_index``. :func:`taint` takes the
caller's rank (the ``DataMesh`` rank) and a spec with ``rank`` set corrupts
only there; a rank-masked spec reaching a seam that passes no rank raises.

Determinism: indices and bits derive from ``zlib.crc32`` of
``(point, step, seed)`` over the tensor's *logical* row-major order, so a
view (the dispatchers return transposed views of head-major buffers) is
corrupted where the reference corrupts the same logical element.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.tree import leaves

FAULT_KINDS = ("bitflip", "nan", "spike", "hang",
               "drop_write", "truncate_write", "persist_exc", "slow")

# name -> one-line doc: taint()/io_fault() refuse unknown names, so a typo'd
# fault point fails loudly instead of silently never firing
FAULT_POINTS: Dict[str, str] = {}


def register_fault_point(name: str, doc: str) -> str:
    FAULT_POINTS[name] = doc
    return name


for _n, _d in (
    ("ckpt.persist", "checkpoint persist write, per attempt (host)"),
    ("ckpt.shard_write", "final shard file on disk (drop/truncate)"),
    ("train.step", "recovery-driver loop, state-level (make_injector)"),
    ("tp.ring.tick", "overlap-TP ring ppermute payload"),
    ("cp.ring.kv", "ring-attention KV chunk between cp ticks"),
    ("cp.ring.state", "SSD entering-state chain message"),
    ("ep.a2a.tick", "EP dispatch/combine all-to-all ring payload"),
    ("kernel.attention", "attention dispatcher output"),
    ("kernel.expert_gemm", "expert-GEMM dispatcher output"),
    ("kernel.ssd", "SSD-scan dispatcher output"),
    ("integrity.checksum", "device-side integrity checksum input"),
    ("pp.stage.tick", "per-stage pipeline tick (straggler timer, host)"),
    ("data.fetch", "recovery-driver batch fetch (straggler timer, host)"),
):
    register_fault_point(_n, _d)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: (step, point, seed) -> a deterministic failure.

    ``step`` schedules host-side (``io_fault``) and driver-level
    (``make_injector``) faults and seeds a payload corruption. ``tick`` picks
    the call of a point that fires (module docstring; None = every call);
    ``times`` bounds host-side firings; ``rank`` restricts a payload
    corruption to one data rank (``axis`` names the mesh axis, as in the
    reference). For ``slow`` faults ``rank`` pins the delay to one rank of the
    timed section and ``span`` keeps it active for that many steps.
    """
    point: str
    kind: str
    step: int = 0
    seed: int = 0
    scale: float = 1e4        # "spike" multiplier
    sleep_s: float = 1.0      # "hang" duration / "slow" per-work-unit delay
    tick: Optional[int] = 0   # which call fires (None = all)
    times: int = 1            # host-side max firings
    rank: Optional[int] = None
    axis: Optional[str] = None
    span: int = 1             # "slow": active for steps [step, step + span)

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; registered: "
                f"{sorted(FAULT_POINTS)}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.span < 1:
            raise ValueError(f"span must be >= 1, got {self.span}")

    def key(self) -> int:
        """The deterministic corruption key (crc32, never salted hash())."""
        return zlib.crc32(f"{self.point}:{self.step}:{self.seed}".encode())


class FaultController:
    """Process-wide armed-fault state (thread-safe: the checkpoint persist
    thread and the autograd engine's device threads consult it too)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: List[FaultSpec] = []
        self._trace_counts: Dict[str, int] = {}
        self._io_counts: Dict[Tuple[str, str, int], int] = {}
        self._replaying = 0                           # remat recomputes in flight
        self.fired: List[Tuple[str, str, int]] = []   # (point, kind, step)

    def install(self, specs) -> None:
        with self._lock:
            self._specs = list(specs)
            self._trace_counts = {}
            self._io_counts = {}

    def clear(self) -> None:
        self.install(())

    def trace_spec(self, point: str) -> Optional[FaultSpec]:
        """The armed spec for a payload point at this call, honoring ``tick``
        against a per-point call counter; marks it fired (not while a remat
        recompute replays the forward's decision)."""
        with self._lock:
            n = self._trace_counts.get(point, 0)
            self._trace_counts[point] = n + 1
            for sp in self._specs:
                if sp.kind == "slow":
                    continue    # host-side delay (slow_spec_for)
                if sp.point == point and (sp.tick is None or sp.tick == n):
                    if not self._replaying:
                        self.fired.append((point, sp.kind, sp.step))
                    return sp
        return None

    def io_spec(self, point: str, step: int) -> Optional[FaultSpec]:
        """The armed spec for a host-side point at ``step`` (``times``-
        bounded); marks it fired."""
        with self._lock:
            for sp in self._specs:
                if sp.point != point or sp.step != step:
                    continue
                if sp.kind == "slow":
                    continue    # executed by the straggler timer's section
                k = (point, sp.kind, sp.step)
                if self._io_counts.get(k, 0) >= sp.times:
                    continue
                self._io_counts[k] = self._io_counts.get(k, 0) + 1
                self.fired.append(k)
                return sp
        return None


CONTROLLER = FaultController()


@contextmanager
def armed(specs):
    """Arm ``specs`` for the duration of the block (and disarm after)."""
    CONTROLLER.install(specs)
    try:
        yield CONTROLLER
    finally:
        CONTROLLER.clear()


def corrupt_array(x: torch.Tensor, spec: FaultSpec, rank: Optional[int] = None):
    """``x`` corrupted per ``spec`` (a new tensor; ``x`` is untouched).

    ``bitflip`` xors bit ``nbits - 2`` (the highest exponent bit) of one
    element through an int16/int32 view (bf16/fp16, fp32), ``nan`` poisons one
    element, ``spike`` scales the whole payload by ``scale`` in ``x``'s dtype;
    a tensor with no such view takes the reference's ``x * scale``. The
    element is ``spec.key() % numel`` in ``x``'s logical row-major order
    (``reshape``, never the storage), so the bits are the reference's. So are
    the gradients: ``spike`` scales them, ``nan`` zeroes the corrupted
    element's (the reference's ``.at[].set``), and ``bitflip`` passes none at
    all (the reference's result comes through a bitcast, whose derivative is
    zero). With ``spec.rank`` set only ``rank`` is corrupted.
    """
    if spec.rank is not None:
        if rank is None:
            raise ValueError(f"{spec.point}: a rank-masked spec needs the caller's rank")
        if rank != spec.rank:
            return x
    idx = spec.key() % max(x.numel(), 1)
    if spec.kind == "spike":
        return x * _scalar(spec.scale, x)
    if spec.kind not in ("nan", "bitflip"):
        raise ValueError(f"{spec.kind!r} is not a payload-corruption kind")
    ints = {2: torch.int16, 4: torch.int32}.get(x.element_size())
    if spec.kind == "bitflip" and (ints is None or not x.is_floating_point()):
        return x * _scalar(spec.scale, x)          # the reference's non-float fallback
    if spec.kind == "bitflip":
        return _Bitflip.apply(x, idx, ints)
    flat = x.reshape(-1).clone()
    flat[idx] = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return flat.reshape(x.shape)


class _Bitflip(torch.autograd.Function):
    """``x`` with bit ``nbits - 2`` of logical element ``idx`` flipped through
    an ``ints`` view; a zero gradient, as the reference's bitcast has."""

    @staticmethod
    def forward(ctx, x, idx, ints):
        flat = x.detach().reshape(-1).clone()
        bits = flat.view(ints)
        bits[idx] ^= 1 << (8 * x.element_size() - 2)
        return flat.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None, None


def _scalar(value: float, x: torch.Tensor) -> torch.Tensor:
    """``value`` in ``x``'s dtype (as ``jnp.asarray(value, x.dtype)``)."""
    return torch.tensor(value, device=x.device).to(x.dtype)


def taint(point: str, x, rank: Optional[int] = None):
    """Payload fault seam: identity unless a spec for ``point`` is armed for
    this call (module docstring), then :func:`corrupt_array`. Place it on the
    payload after it is produced (the dispatcher's return)."""
    if point not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}")
    if not CONTROLLER._specs:
        return x
    sp = CONTROLLER.trace_spec(point)
    if sp is None:
        return x
    return corrupt_array(x, sp, rank)


def remat_context():
    """``context_fn`` for ``torch.utils.checkpoint``: a forward context that
    records the armed specs and the per-point call counters where the
    checkpointed piece starts, and a recompute context that runs the backward's
    recompute under exactly those, so every :func:`taint` in it repeats the
    forward's decision; the live state is restored after. Unarmed, two
    ``nullcontext``."""
    if not CONTROLLER._specs:
        return nullcontext(), nullcontext()
    seen = {}

    @contextmanager
    def forward():
        with CONTROLLER._lock:
            seen.update(specs=list(CONTROLLER._specs),
                        counts=dict(CONTROLLER._trace_counts))
        yield

    @contextmanager
    def recompute():
        with CONTROLLER._lock:
            live = CONTROLLER._specs, CONTROLLER._trace_counts
            CONTROLLER._specs = seen["specs"]
            CONTROLLER._trace_counts = dict(seen["counts"])
            CONTROLLER._replaying += 1
        try:
            yield
        finally:
            with CONTROLLER._lock:
                CONTROLLER._specs, CONTROLLER._trace_counts = live
                CONTROLLER._replaying -= 1

    return forward(), recompute()


def io_fault(point: str, step: int) -> None:
    """Host-side fault seam: raise/sleep per the armed spec (``drop_write`` /
    ``truncate_write`` are applied by the caller via :func:`io_spec_for`)."""
    sp = CONTROLLER.io_spec(point, step)
    if sp is None:
        return
    if sp.kind == "hang":
        time.sleep(sp.sleep_s)
    elif sp.kind == "persist_exc":
        raise InjectedFault(f"injected persist exception at step {step}")
    else:
        raise ValueError(
            f"{sp.kind!r} must be applied by the caller (io_spec_for)")


def io_spec_for(point: str, step: int, kinds) -> Optional[FaultSpec]:
    """Caller-applied host faults (file drop/truncate): the armed spec for
    ``point``/``step`` if its kind is in ``kinds``, else None."""
    with CONTROLLER._lock:
        for sp in CONTROLLER._specs:
            if sp.point == point and sp.step == step and sp.kind in kinds:
                k = (point, sp.kind, sp.step)
                if CONTROLLER._io_counts.get(k, 0) >= sp.times:
                    continue
                CONTROLLER._io_counts[k] = CONTROLLER._io_counts.get(k, 0) + 1
                CONTROLLER.fired.append(k)
                return sp
    return None


def slow_spec_for(point: str, step: int,
                  rank: Optional[int] = None) -> Optional[FaultSpec]:
    """The armed ``slow`` spec covering ``(point, step, rank)``, or None: it
    matches every step in ``[spec.step, spec.step + spec.span)`` and, with
    ``spec.rank`` set, only that rank. Each match is marked fired."""
    if point not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}")
    with CONTROLLER._lock:
        for sp in CONTROLLER._specs:
            if sp.kind != "slow" or sp.point != point:
                continue
            if not sp.step <= step < sp.step + sp.span:
                continue
            if sp.rank is not None and sp.rank != rank:
                continue
            CONTROLLER.fired.append((point, "slow", step))
            return sp
    return None


class InjectedFault(RuntimeError):
    """An exception raised by an armed ``persist_exc`` fault."""


def trace_with_faults(fn, *, specs):
    """The faulty twin of ``fn``: each call arms ``specs`` (with fresh
    per-point counters, beside whatever is armed already), runs ``fn`` and
    restores the controller in a ``finally``. ``fn`` does not run here, so the
    reference's example inputs for its compile are not taken (module
    docstring)."""
    specs = list(specs)

    def twin(*a, **kw):
        with CONTROLLER._lock:
            outer = CONTROLLER._specs, CONTROLLER._trace_counts
            CONTROLLER._specs = outer[0] + specs
            CONTROLLER._trace_counts = {}
        try:
            return fn(*a, **kw)
        finally:
            with CONTROLLER._lock:
                CONTROLLER._specs, CONTROLLER._trace_counts = outer

    return twin


def make_injector(specs):
    """A ``run_with_recovery`` ``fault_injector(step, state)`` for
    ``train.step`` faults: bitflip/nan/spike applied to the params **in
    place** under ``no_grad`` (they stay the step's autograd leaves) and host
    hangs, scheduled by ``spec.step`` and bounded by ``spec.times``. Returns
    the same state."""
    specs = [s for s in specs if s.point == "train.step"]
    counts: Dict[int, int] = {}

    def injector(step: int, state):
        for i, sp in enumerate(specs):
            if sp.step != step or counts.get(i, 0) >= sp.times:
                continue
            counts[i] = counts.get(i, 0) + 1
            CONTROLLER.fired.append((sp.point, sp.kind, sp.step))
            if sp.kind == "hang":
                time.sleep(sp.sleep_s)
            else:
                with torch.no_grad():
                    for p in leaves(state.params):
                        p.copy_(corrupt_array(p, sp))
        return state

    return injector
