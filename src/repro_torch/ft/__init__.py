"""Fault tolerance (survey §8; port of ``repro/ft``): detection, recovery and
chaos testing.

- :mod:`repro_torch.ft.anomaly` — statistical detectors (nan/inf, spike, hang)
  plus externally-noted kinds (sdc, ckpt_io);
- :mod:`repro_torch.ft.recovery` — the policy-table recovery driver,
  restoring memory-tier-first (``checkpoint/memory.py``) with a verified disk
  walk as the fallback;
- :mod:`repro_torch.ft.preempt` — SIGTERM/SIGUSR1 preemption guard:
  just-in-time snapshot within a grace budget, ``PREEMPTED`` marker, clean
  resumable exit;
- :mod:`repro_torch.ft.flight` — the crash flight recorder: a bounded ring of
  per-step events dumped to JSON on preemption/crash/RecoveryExhausted;
- :mod:`repro_torch.ft.inject` — deterministic seeded fault injection at
  named fault points (``inject.FAULT_POINTS``), with the eager semantics its
  docstring sets out;
- :mod:`repro_torch.ft.integrity` — exact checksums cross-checked across the
  data ranks (``plan.integrity = "audit"``);
- :mod:`repro_torch.ft.straggler` — fail-slow attribution from host-side
  timing, and the uneven pipeline re-partition (:func:`choose_pp_layout`)
  that ``run_with_recovery``'s ``"rebalance"`` applies.

``anomaly``, ``flight`` and ``preempt`` use only the standard library.
"""

from repro_torch.core.config import RecoveryPolicy
from .anomaly import Anomaly, Monitor
from .flight import FlightRecorder
from .preempt import (PreemptionGuard, clear_marker, read_marker,
                      write_marker)
from .recovery import (RecoveryExhausted, RemeshSpec, RunReport,
                       run_with_recovery)
from .straggler import (Straggler, StragglerDetector, StragglerTimer,
                        choose_pp_layout, effective_layout)

__all__ = ["Anomaly", "FlightRecorder", "Monitor", "PreemptionGuard",
           "RecoveryExhausted", "RecoveryPolicy", "RemeshSpec", "RunReport",
           "Straggler", "StragglerDetector", "StragglerTimer",
           "choose_pp_layout", "clear_marker", "effective_layout",
           "read_marker", "run_with_recovery", "write_marker"]
