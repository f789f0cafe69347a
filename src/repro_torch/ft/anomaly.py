"""Anomaly detection (survey §8.2) — statistical monitoring of a training run
(a copy of ``repro/ft/anomaly.py``, standard library only).

Three detectors feed a :class:`Monitor`:

- **NaN/Inf** in loss or grad-norm (model instability / numerical failure);
- **loss spike**: loss > running-median + k·MAD over a trailing window
  (the classic loss-spike symptom of data corruption or bad restarts);
- **straggler / hang**: a heartbeat watchdog — step wall-times exceeding
  ``hang_factor ×`` the trailing median flag a slow/hung worker (survey §8.1:
  stragglers silently degrade MFU long before anything crashes).

The monitor only *detects*; recovery policy lives in ``repro_torch.ft.recovery``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, List, Optional


@dataclasses.dataclass
class Anomaly:
    kind: str          # "nan" | "spike" | "hang" | "sdc" | "ckpt_io"
                       # | "straggler" (noted by the ft/straggler attribution)
    step: int
    detail: str


class Monitor:
    def __init__(self, window: int = 32, spike_mads: float = 10.0,
                 hang_factor: float = 5.0, min_history: int = 8,
                 hang_min_seconds: float = 1e-3, flight=None):
        self.window = window
        self.spike_mads = spike_mads
        self.hang_factor = hang_factor
        self.min_history = min_history
        # absolute floor below which a slow step is never a "hang" — with
        # sub-ms steps the relative test alone would flag scheduler jitter
        self.hang_min_seconds = hang_min_seconds
        # optional repro_torch.ft.flight.FlightRecorder: every recorded step and
        # every anomaly (statistical or noted) lands in the crash black box
        self.flight = flight
        self.losses: Deque[float] = deque(maxlen=window)
        self.times: Deque[float] = deque(maxlen=window)
        self.anomalies: List[Anomaly] = []
        self._last_beat: Optional[float] = None
        # the first interval after start / restore / remesh includes JIT
        # compile (or restore replay) wall-time; letting it into the window
        # would inflate the trailing median and mask real slowdowns until it
        # scrolls out — it is discarded, not just exempted from the hang test
        self._skip_next_interval = True

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def record(self, step: int, loss: float, grad_norm: float,
               now: Optional[float] = None) -> Optional[Anomaly]:
        """Feed one step's metrics; returns an Anomaly if detected."""
        now = time.time() if now is None else now
        out: Optional[Anomaly] = None

        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            out = Anomaly("nan", step,
                          f"loss={loss} grad_norm={grad_norm}")
        elif len(self.losses) >= self.min_history:
            med = self._median(self.losses)
            mad = self._median([abs(l - med) for l in self.losses]) + 1e-12
            if loss > med + self.spike_mads * mad and loss > med * 1.5:
                out = Anomaly("spike", step,
                              f"loss={loss:.4f} median={med:.4f} mad={mad:.4f}")

        if self._last_beat is not None:
            dt = now - self._last_beat
            if self._skip_next_interval:
                # compile/restore wall-time, not a step time: discard
                self._skip_next_interval = False
            else:
                hung = False
                if len(self.times) >= self.min_history:
                    med_t = self._median(self.times)
                    if dt > self.hang_factor * med_t \
                            and dt > self.hang_min_seconds:
                        hung = True
                        out = out or Anomaly(
                            "hang", step,
                            f"step_time={dt:.3f}s median={med_t:.3f}s")
                if not hung:
                    self.times.append(dt)  # only healthy wall-times enter the
                                           # window, mirroring the loss window
        self._last_beat = now

        if out is None and math.isfinite(loss):
            self.losses.append(loss)     # only healthy points enter the window
        if out:
            self.anomalies.append(out)
        if self.flight is not None:
            self.flight.record("step", step, loss=loss, grad_norm=grad_norm)
            if out:
                self.flight.record("anomaly", step, anomaly=out.kind,
                                   detail=out.detail)
        return out

    def note(self, kind: str, step: int, detail: str = "") -> Anomaly:
        """Record an externally-detected anomaly (integrity-checksum
        divergence -> "sdc", exhausted persist retries -> "ckpt_io"): the
        statistical detectors above can't see these, but they belong in the
        same audit trail and policy routing."""
        a = Anomaly(kind, step, detail)
        self.anomalies.append(a)
        if self.flight is not None:
            self.flight.record("anomaly", step, anomaly=kind, detail=detail)
        return a

    def reset_heartbeat(self, now: Optional[float] = None) -> None:
        """Restart the hang watchdog clock (call after a checkpoint restore —
        restore wall-time is not a step time and must not trip a hang).

        The *next* interval is discarded too: after a remesh/rebalance the
        first step re-JITs, and after any restore the first beat straddles
        replay bookkeeping — compile spikes must never enter ``times``."""
        self._last_beat = time.time() if now is None else now
        self._skip_next_interval = True
