"""Crash flight recorder (survey §8.1/§8.2, MegaScale-style; a copy of
``repro/ft/flight.py``, standard library only) — a bounded
ring buffer of structured per-step events dumped to JSON for post-mortem
attribution.

At cluster scale the expensive half of a failure is rarely the restart — it
is the hours spent reconstructing *which* rank/step broke and what the run
did about it. The flight recorder is the always-on answer: every component
of the fault-tolerance stack logs into one bounded ring
(:class:`FlightRecorder`), and the ring is dumped to a parseable JSON file
the moment something goes wrong:

- :class:`repro_torch.ft.anomaly.Monitor` logs a ``"step"`` event per recorded
  step (loss, grad-norm, wall-time) and an ``"anomaly"`` event per
  detection (statistical or externally noted);
- :func:`repro_torch.ft.recovery.run_with_recovery` logs ``"policy"`` decisions
  (anomaly kind → action), ``"restore"`` events (which tier served it:
  memory / memory-rebuild / disk), ``"fault"`` events for every injected
  fault that fired (:mod:`repro_torch.ft.inject`), and ``"preempt"`` events;
- :class:`repro_torch.checkpoint.store.CheckpointManager` and
  :class:`repro_torch.checkpoint.memory.MemoryCheckpointTier` log checkpoint/tier
  events (saves, persist failures, GC evictions, verify-before-evict skips).

The ring is bounded (``maxlen``, knob ``RecoveryPolicy.flight_len``) so a
month-long run carries a constant-size black box. ``dump()`` writes
atomically (tmp + ``os.replace``) and sanitizes values, so it is safe to
call from an exception handler mid-crash; the dump path is carried on
:class:`repro_torch.ft.recovery.RunReport` (and on ``RecoveryExhausted``) so the
autopsy artifact is one attribute away from the failure it describes.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Optional


def _jsonable(v: Any) -> Any:
    """Best-effort JSON sanitization — a crash dump must never crash."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        # json rejects nothing here (nan/inf serialize as tokens some
        # parsers refuse) — stringify non-finite floats for portability
        return v if v == v and v not in (float("inf"), float("-inf")) \
            else repr(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if getattr(v, "ndim", None) == 0 and callable(getattr(v, "item", None)):
        return _jsonable(v.item())   # numpy scalars, 0-d arrays and tensors
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class FlightRecorder:
    """Bounded ring of structured events + atomic JSON dump.

    ``record(kind, step, **data)`` appends one event (cheap: a dict into a
    deque; safe from the checkpoint persist thread — deque appends are
    atomic under the GIL). ``dump(reason=...)`` writes the whole ring plus
    run-level context to ``path`` (constructor default, overridable per
    call) and returns the path written.
    """

    def __init__(self, maxlen: int = 256, path: Optional[str] = None):
        self.maxlen = int(maxlen)
        self.path = str(path) if path is not None else None
        self.events: deque = deque(maxlen=self.maxlen)
        self.dumped_path: Optional[str] = None
        self._t0 = time.time()

    def record(self, kind: str, step: int, **data: Any) -> None:
        self.events.append({"t": time.time() - self._t0, "kind": kind,
                            "step": int(step), **data})

    def dump(self, reason: str, path: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Atomically write the ring to JSON; returns the path (None when no
        path is configured anywhere). Never raises — a failing black-box
        write must not mask the crash being recorded."""
        out = path or self.path
        if out is None:
            return None
        payload = {
            "reason": reason,
            "wall_time": time.time(),
            "run_seconds": time.time() - self._t0,
            "n_events": len(self.events),
            "maxlen": self.maxlen,
            "extra": _jsonable(extra or {}),
            "events": [_jsonable(e) for e in self.events],
        }
        try:
            out_p = Path(out)
            out_p.parent.mkdir(parents=True, exist_ok=True)
            tmp = out_p.with_name(out_p.name + ".tmp")
            tmp.write_text(json.dumps(payload, indent=1))
            os.replace(tmp, out_p)
        except OSError:
            return self.dumped_path
        self.dumped_path = str(out)
        return self.dumped_path
