"""Fail-slow defense (survey §8.1; a copy of ``repro/ft/straggler.py`` on the
port's config): per-rank straggler attribution and Malleus-style pipeline
rebalancing.

- :class:`StragglerTimer` — host-side timing around the step and named
  sections (pipeline stage ticks, TP/CP ring segments, kernel dispatch, data
  fetch, checkpoint persist), each mapped to a component class in
  :data:`SECTION_CLASSES`;
- :class:`StragglerDetector` — a sliding-window relative-slowdown detector:
  rank-resolved sections against the median of their peers at the same step
  (normalised by expected work share), global sections against their own
  trailing median; ``confirm`` consecutive slow observations raise a
  :class:`Straggler` ``(rank, component, class)`` event, logged to the flight
  recorder;
- :func:`choose_pp_layout` — the mitigation: layers per pipeline stage
  re-partitioned from measured per-stage times.

The port's ``ParallelPlan`` has no ``pp``, ``tp`` or ``cp`` yet (ROADMAP
A13.2-A13.5): :func:`effective_layout` returns None on it and the timer models
no stage or ring shares, so ``run_with_recovery``'s ``"rebalance"`` degrades to
``"remesh"`` (with a hook) or ``"ignore"``, exactly as the reference's does on
a plan without a pipeline. A plan-like object that carries ``pp`` (or ``tp``,
``cp``) is read as the reference reads it, which is how the tests hold these
paths to the reference.

Measurement model (the reference's): host-measurable sections (data fetch,
checkpoint persist, the step itself) are timed for real; per-stage and
per-ring-rank shares are modeled from the measured step time and the plan's
partition, and an armed ``slow`` fault (``inject.slow_spec_for``) sleeps
inside the matching section for its rank, so injected fail-slow is real wall
time. A large slowdown can also trip the Monitor's hang test; the driver gives
statistical anomalies priority.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.config import ParallelPlan, RecoveryPolicy
from . import inject as _inject

# section -> component class of the attribution triple
SECTION_CLASSES: Dict[str, str] = {
    "step.compute": "compute",     # the step's own wall time
    "pp.stage": "compute",         # per-pipeline-stage tick share
    "kernel.dispatch": "compute",  # fused-kernel dispatch seam
    "tp.ring": "comm",             # overlap-TP collective-matmul ring
    "cp.ring": "comm",             # context-parallel KV / SSD-state ring
    "ep.a2a": "comm",              # expert-parallel dispatch/combine a2a ring
    "data.fetch": "host-io",       # host batch synthesis / loading
    "ckpt.persist": "host-io",     # checkpoint snapshot + persist
}

# section -> the ft/inject fault points whose armed `slow` specs the timer
# polls (and sleeps for) inside that section
SECTION_POINTS: Dict[str, Tuple[str, ...]] = {
    "step.compute": ("train.step",),
    "pp.stage": ("pp.stage.tick",),
    "kernel.dispatch": ("kernel.attention", "kernel.expert_gemm",
                        "kernel.ssd"),
    "tp.ring": ("tp.ring.tick",),
    "cp.ring": ("cp.ring.kv", "cp.ring.state"),
    "ep.a2a": ("ep.a2a.tick",),
    "data.fetch": ("data.fetch",),
    "ckpt.persist": ("ckpt.persist",),
}


@dataclasses.dataclass
class Straggler:
    """One confirmed fail-slow attribution: *who* (rank), *where* (section),
    *what kind* (compute | comm | host-io), and *how bad* (slowdown ratio
    vs the peer/trailing baseline, per unit of expected work)."""
    rank: Optional[int]    # section rank (pipeline stage / ring position);
                           # None for global sections (step, data, ckpt)
    section: str
    cls: str               # "compute" | "comm" | "host-io"
    step: int
    slowdown: float        # dt / baseline, work-normalized
    detail: str = ""


def effective_layout(plan: Optional[ParallelPlan],
                     cfg=None) -> Optional[Tuple[int, ...]]:
    """The layers-per-stage tuple a plan implies, or None without a pipeline.

    ``plan.pp_layout`` when set; else the even ``n_layers / pp`` split (needs
    ``cfg``); None when ``pp <= 1`` or the split is unknowable.
    """
    if plan is None or getattr(plan, "pp", 1) <= 1:
        return None
    if getattr(plan, "pp_layout", None):
        return tuple(plan.pp_layout)
    if cfg is None or cfg.n_layers % plan.pp != 0:
        return None
    return (cfg.n_layers // plan.pp,) * plan.pp


def choose_pp_layout(stage_seconds: Dict[int, float],
                     layout: Tuple[int, ...]) -> Tuple[int, ...]:
    """Malleus-style uneven re-partition from measured per-stage times.

    ``stage_seconds[r]`` is stage ``r``'s measured tick time under
    ``layout``; its per-layer cost is ``t_r / layout[r]`` (a degraded stage
    is slow *per unit of work*, so shedding layers genuinely shortens its
    tick). Layers are then re-assigned greedily — each next layer goes to the
    stage whose resulting load is smallest — which minimizes the bottleneck
    stage time (the pipeline's steady-state period) under the one-layer-per-
    stage floor. Deterministic: ties break on the lowest stage index.
    """
    pp = len(layout)
    n_layers = sum(layout)
    if pp < 2 or not stage_seconds:
        return tuple(layout)
    fallback = sum(stage_seconds.values()) / len(stage_seconds)
    cost = [max(stage_seconds.get(r, fallback), 1e-12) / max(layout[r], 1)
            for r in range(pp)]
    new = [1] * pp
    for _ in range(n_layers - pp):
        r = min(range(pp), key=lambda i: ((new[i] + 1) * cost[i], i))
        new[r] += 1
    return tuple(new)


class StragglerDetector:
    """Sliding-window relative-slowdown detector with per-rank attribution.

    Two observation modes:

    - :meth:`observe_group` — rank-resolved sections (pipeline stages, ring
      positions): each rank's time is normalized by its expected work share
      (``weights``) and compared against the *median of its peers at the
      same step*. Robust to global noise (compile, host jitter hits every
      rank equally) and to intentionally uneven layouts.
    - :meth:`observe` — global single-series sections (the step itself, data
      fetch, checkpoint persist): compared against the series' own
      trailing-window median, with the first post-:meth:`reset` step
      discarded (compile/restore time must not poison the baseline — the
      same hygiene as ``Monitor``'s heartbeat).

    A rank/section must be slow ``confirm`` times *in a row* before an event
    is emitted (detection latency = ``confirm`` steps, measured by
    ``bench_straggler``); the streak then restarts, so a persistent straggler
    re-fires every ``confirm`` steps and the recovery ladder gets repeated
    escalation chances. Raw (un-normalized) times are kept per
    ``(section, rank)`` for :meth:`recent` — the rebalancer wants the
    *degraded* stage times, so history is recorded slow or not.
    """

    def __init__(self, window: int = 16, factor: float = 2.0,
                 confirm: int = 3, min_seconds: float = 5e-3,
                 min_history: int = 4, flight=None):
        self.window = window
        self.factor = factor
        self.confirm = confirm
        self.min_seconds = min_seconds
        self.min_history = min_history
        self.flight = flight
        self.events: List[Straggler] = []
        self._hist: Dict[Tuple[str, Optional[int]], Deque[float]] = {}
        self._streak: Dict[Tuple[str, Optional[int]], int] = {}
        # first observed step after construction/reset is discarded for the
        # own-history series (first-call warm-up / restore wall time)
        self._grace_pending = True
        self._grace_step: Optional[int] = None

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def _record(self, section: str, rank: Optional[int], dt: float) -> None:
        key = (section, rank)
        if key not in self._hist:
            self._hist[key] = deque(maxlen=self.window)
        self._hist[key].append(dt)

    def _emit(self, section: str, rank: Optional[int], step: int,
              dt: float, baseline: float) -> Optional[Straggler]:
        """Streak bookkeeping for one slow observation; event on confirm."""
        key = (section, rank)
        self._streak[key] = self._streak.get(key, 0) + 1
        if self._streak[key] < self.confirm:
            return None
        self._streak[key] = 0
        slowdown = dt / max(baseline, 1e-12)
        ev = Straggler(
            rank=rank, section=section, cls=SECTION_CLASSES[section],
            step=step, slowdown=slowdown,
            detail=f"{dt * 1e3:.1f}ms vs baseline {baseline * 1e3:.1f}ms")
        self.events.append(ev)
        if self.flight is not None:
            self.flight.record("straggler", step, rank=rank, section=section,
                               component_class=ev.cls,
                               slowdown=round(slowdown, 3))
        return ev

    def observe_group(self, section: str, step: int,
                      rank_seconds: Dict[int, float],
                      weights: Optional[Dict[int, float]] = None
                      ) -> Optional[Straggler]:
        """Feed one step's rank-resolved section times; cross-rank detection.

        ``weights[r]`` is rank r's expected work share (layers on the stage,
        1.0 for symmetric rings): detection compares *work-normalized* times,
        so an uneven-by-design ``pp_layout`` stays quiet while a degraded
        rank — slow per unit of work — stands out whatever the layout.
        """
        out: Optional[Straggler] = None
        norm = {r: dt / max((weights or {}).get(r, 1.0), 1e-12)
                for r, dt in rank_seconds.items()}
        for rank in sorted(rank_seconds):
            self._record(section, rank, rank_seconds[rank])
            peers = [v for r, v in norm.items() if r != rank]
            if not peers:
                continue
            base = self._median(peers)
            dt = norm[rank]
            if base > 0.0 and dt > self.factor * base \
                    and dt - base > self.min_seconds:
                ev = self._emit(section, rank, step, dt, base)
                out = out or ev
            else:
                self._streak[(section, rank)] = 0
        return out

    def observe(self, section: str, rank: Optional[int], seconds: float,
                step: int) -> Optional[Straggler]:
        """Feed one observation of a single-series section; own-history
        detection against the trailing-window median."""
        if self._grace_pending:
            self._grace_pending = False
            self._grace_step = step
        if step == self._grace_step:
            return None     # compile/restore step: not a baseline sample
        key = (section, rank)
        hist = self._hist.get(key)
        if hist is None or len(hist) < self.min_history:
            self._record(section, rank, seconds)
            return None
        base = self._median(hist)
        if base > 0.0 and seconds > self.factor * base \
                and seconds - base > self.min_seconds:
            return self._emit(section, rank, step, seconds, base)
        self._streak[key] = 0
        self._record(section, rank, seconds)  # only healthy samples enter
        return None                           # the own-history baseline

    def recent(self, section: str, k: Optional[int] = None
               ) -> Dict[Optional[int], float]:
        """Median of the trailing ``k`` (default ``confirm``) raw times per
        rank of ``section`` — the *current-regime* times (for a just-
        confirmed straggler these are the degraded values, which is what the
        rebalancer must plan against; a full-window median would still be
        dominated by healthy pre-fault samples)."""
        k = k if k is not None else self.confirm
        out: Dict[Optional[int], float] = {}
        for (sec, rank), hist in self._hist.items():
            if sec == section and hist:
                out[rank] = self._median(list(hist)[-k:])
        return out

    def reset(self) -> None:
        """Forget all baselines and streaks (call after a restore, rebalance,
        or remesh — the old regime's times are stale) and re-arm the first-
        step grace (the next step is a warm-up)."""
        self._hist.clear()
        self._streak.clear()
        self._grace_pending = True
        self._grace_step = None


class StragglerTimer:
    """Host-side telemetry feeding a :class:`StragglerDetector`.

    Usage (the recovery driver wires this up):

    - wrap host-I/O work in :meth:`section` (``data.fetch`` around the batch
      fetch, ``ckpt.persist`` around saves);
    - call :meth:`after_step` once per accepted step with the step's
      measured wall time — it fans the step out into per-stage and per-ring
      shares (modeled from the plan's partition in this single-process
      container; real per-host timers in a fleet), executes any armed
      ``slow`` fault's delay inside the matching section (so injected
      fail-slow is real wall time, work-proportional: a slow *stage* sleeps
      ``sleep_s`` per layer it currently holds — shedding layers via
      rebalance genuinely shortens its tick), feeds the detector, and
      returns the highest-priority confirmed :class:`Straggler` (stage >
      rings > host-I/O > whole-step), if any;
    - :meth:`stage_times` hands the rebalancer the current-regime per-stage
      times; :meth:`reset` clears baselines after any restore/relayout.
    """

    def __init__(self, cfg=None, plan: Optional[ParallelPlan] = None,
                 detector: Optional[StragglerDetector] = None,
                 policy: Optional[RecoveryPolicy] = None, flight=None):
        if detector is None:
            pol = policy or RecoveryPolicy()
            detector = StragglerDetector(
                window=pol.straggler_window, factor=pol.straggler_factor,
                confirm=pol.straggler_confirm,
                min_seconds=pol.straggler_min_seconds, flight=flight)
        elif flight is not None and detector.flight is None:
            detector.flight = flight
        self.cfg = cfg
        self.plan = plan
        self.detector = detector
        self._pending: List[Straggler] = []

    def _slow_sleep(self, section: str, step: int, rank: Optional[int],
                    units: float = 1.0) -> float:
        """Execute (and return) the armed ``slow`` delay for this section's
        rank at this step: ``sleep_s`` per unit of work."""
        for point in SECTION_POINTS[section]:
            sp = _inject.slow_spec_for(point, step, rank)
            if sp is not None:
                delay = sp.sleep_s * units
                time.sleep(delay)
                return delay
        return 0.0

    @contextmanager
    def section(self, name: str, step: int, rank: Optional[int] = None):
        """Time a host-side section (``data.fetch`` / ``ckpt.persist``),
        executing any armed ``slow`` delay inside it; a confirmed event is
        queued and surfaced by the next :meth:`after_step`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._slow_sleep(name, step, rank)
            dt = time.perf_counter() - t0
            ev = self.detector.observe(name, rank, dt, step)
            if ev is not None:
                self._pending.append(ev)

    def after_step(self, step: int, step_seconds: float,
                   plan: Optional[ParallelPlan] = None
                   ) -> Optional[Straggler]:
        """Per-step telemetry fan-out; returns the top confirmed event."""
        plan = plan if plan is not None else self.plan
        events: List[Optional[Straggler]] = []

        layout = effective_layout(plan, self.cfg)
        if layout is not None:
            total = sum(layout)
            shares: Dict[int, float] = {}
            for r, n_l in enumerate(layout):
                extra = self._slow_sleep("pp.stage", step, r, units=n_l)
                shares[r] = step_seconds * (n_l / total) + extra
            events.append(self.detector.observe_group(
                "pp.stage", step, shares,
                weights={r: float(n_l) for r, n_l in enumerate(layout)}))

        for section, size in (("tp.ring", getattr(plan, "tp", 1) or 1),
                              ("cp.ring", getattr(plan, "cp", 1) or 1)):
            if plan is not None and size > 1:
                shares = {}
                for r in range(size):
                    extra = self._slow_sleep(section, step, r)
                    shares[r] = step_seconds / size + extra
                events.append(
                    self.detector.observe_group(section, step, shares))

        events.extend(self._pending)
        self._pending = []

        step_ev = self.detector.observe("step.compute", None, step_seconds,
                                        step)
        events.append(step_ev)
        k_extra = self._slow_sleep("kernel.dispatch", step, None)
        k_ev = self.detector.observe("kernel.dispatch", None,
                                     step_seconds + k_extra, step)
        if step_ev is None:
            # only attribute to the dispatch seam when the step series itself
            # stayed quiet (a whole-step slowdown is not a kernel's fault)
            events.append(k_ev)

        for ev in events:
            if ev is not None:
                return ev
        return None

    def stage_times(self) -> Dict[int, float]:
        """Current-regime per-stage tick times for :func:`choose_pp_layout`."""
        return {r: t for r, t in self.detector.recent("pp.stage").items()
                if r is not None}

    def reset(self) -> None:
        self.detector.reset()
        self._pending = []
