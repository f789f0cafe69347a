"""Preemption-aware graceful shutdown (survey §8 / cloud-native spot
fleets, arXiv 2604.17227; a copy of ``repro/ft/preempt.py``, standard
library only).

Spot and preemptible capacity is only usable for training if a preemption
notice turns into a *resumable* run instead of a killed one. The cloud
delivers the notice as a signal (SIGTERM, or SIGUSR1 from a scheduler)
with a grace window before the host is reclaimed; this module turns that
into a clean between-steps exit:

- :class:`PreemptionGuard` installs signal handlers (context manager —
  previous handlers restored on exit) that do nothing but set a flag and
  timestamp; all real work happens on the training thread, because a
  signal handler interrupting a kernel launch must not touch the runtime.
- :func:`repro_torch.ft.recovery.run_with_recovery` checks the flag between
  steps. On preemption it flushes the in-flight async snapshot
  (``ckpt.wait()``), takes a just-in-time blocking snapshot, writes a
  ``PREEMPTED`` marker (:func:`write_marker`), dumps the flight recorder,
  and returns a report with ``preempted=True`` — so ``--resume`` continues
  bit-identically from the JIT snapshot.
- Tier choice is budget-driven: the guard's remaining grace
  (:meth:`PreemptionGuard.remaining`) is compared against the checkpoint
  manager's *measured* snapshot+persist seconds (with headroom). Disk wins
  whenever it fits — it survives the process. The memory tier is the
  fallback when the grace window is too short for disk I/O: on a real
  fleet the peer-mirrored RAM copy survives on neighbor hosts
  (:mod:`repro_torch.checkpoint.memory`), so a sub-second RAM snapshot is still
  a recoverable checkpoint; in this single-process reproduction that path
  is exercised for timing but durability comes from disk.

The marker file makes the exit legible to the relauncher: ``--resume``
reads it (:func:`read_marker`), logs the preemption step, and clears it
(:func:`clear_marker`) once the run is re-established.
"""

from __future__ import annotations

import json
import os
import signal
import time
from pathlib import Path
from typing import Any, Dict, Optional

MARKER_NAME = "PREEMPTED"


class PreemptionGuard:
    """Flag-setting SIGTERM/SIGUSR1 handler with a grace-deadline clock.

    Use as a context manager around the training loop::

        with PreemptionGuard(grace=30.0) as guard:
            run_with_recovery(..., preempt=guard)

    ``requested`` flips True in the handler (async-signal-safe: assignment
    only); ``remaining()`` counts down the grace budget from the moment the
    signal landed. ``signals=()`` (or installing in a non-main thread,
    where CPython forbids ``signal.signal``) degrades to a manually
    triggerable flag — :meth:`trigger` — which tests use for deterministic
    in-process preemption.
    """

    def __init__(self, grace: float = 30.0,
                 signals=(signal.SIGTERM, signal.SIGUSR1)):
        self.grace = float(grace)
        self.signals = tuple(signals)
        self.requested = False
        self.signum: Optional[int] = None
        self.at_time: Optional[float] = None
        self._prev: Dict[int, Any] = {}

    def _handler(self, signum, frame):  # noqa: ARG002 - signal signature
        if not self.requested:          # first notice starts the clock
            self.requested = True
            self.signum = signum
            self.at_time = time.time()

    def trigger(self, signum: int = signal.SIGTERM) -> None:
        """Set the flag without a real signal (deterministic tests)."""
        self._handler(signum, None)

    def install(self) -> "PreemptionGuard":
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):   # non-main thread / exotic signum
                continue
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                continue
        self._prev.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def remaining(self) -> float:
        """Seconds of grace left (``grace`` when no signal has landed)."""
        if self.at_time is None:
            return self.grace
        return max(0.0, self.grace - (time.time() - self.at_time))


def choose_tier(guard: PreemptionGuard, ckpt, mem=None,
                headroom: float = 0.8) -> str:
    """``"disk"`` or ``"memory"`` for the just-in-time snapshot.

    Disk whenever the manager's measured snapshot+persist time fits inside
    ``headroom`` × the remaining grace (durability beats speed), or when no
    memory tier exists, or when nothing has been measured yet (first
    checkpoint — no basis to distrust disk). Memory only when measurements
    say disk will blow the deadline.
    """
    if mem is None:
        return "disk"
    est = ckpt.snapshot_seconds + ckpt.d2h_seconds + ckpt.persist_seconds
    if est <= 0.0 or est <= headroom * guard.remaining():
        return "disk"
    return "memory"


def marker_path(directory) -> Path:
    return Path(directory) / MARKER_NAME


def write_marker(directory, step: int, tier: str,
                 signum: Optional[int] = None,
                 flight_path: Optional[str] = None) -> Path:
    """Atomically drop the ``PREEMPTED`` marker next to the checkpoints."""
    p = marker_path(directory)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {"step": int(step), "tier": tier, "signum": signum,
               "flight": flight_path, "time": time.time()}
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, p)
    return p


def read_marker(directory) -> Optional[Dict[str, Any]]:
    """The marker's payload, or None when absent/unreadable."""
    p = marker_path(directory)
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None


def clear_marker(directory) -> None:
    marker_path(directory).unlink(missing_ok=True)
