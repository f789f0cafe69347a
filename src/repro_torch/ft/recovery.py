"""Anomaly-driven recovery driver (survey §8.3; port of
``repro/ft/recovery.py``, its state machine line for line): wraps a training
loop with a detect -> policy -> recover state machine.

Where the port differs from the reference, and why:

- The port's train step updates params and moments **in place**, so the
  state a fault injector corrupts, and a rejected step's update, are the live
  tensors; every restore refills those tensors in place
  (``CheckpointManager.restore`` and the RAM tier), so a rollback discards
  them all the same.
- ``float(metrics["loss"])`` is the device sync that makes ``step_seconds`` a
  real step time, as in the reference.
- A restore under a data mesh passes the mesh, so each rank takes its ZeRO-1
  slices, and a reshard goes through ``restore_resharded(plan=, mesh=)``: the
  template's tensors already carry the target layout, so :class:`RemeshSpec`
  has no ``shardings``.
- A remesh tells the checkpoint manager to leave the old mesh
  (``CheckpointManager.leave_mesh``) before it restores: the old group has
  lost ranks, so no collective may run on it after the hook.
- A rebalance keeps the mesh (the same process group), so, unlike a
  remesh, it leaves no mesh behind: the restore onto the new ``pp_layout``
  runs on the same grid through ``restore_resharded``.

Each anomaly kind from :class:`repro_torch.ft.anomaly.Monitor` maps through a
:class:`repro_torch.core.RecoveryPolicy` table to an action:

- **rollback** — restore the latest *intact* checkpoint and replay. The
  deterministic data pipeline (batch = f(arch, step)) makes replay
  bit-faithful; the property test asserts a recovered run matches an
  uninterrupted one. A checkpoint that fails integrity verification
  (:class:`repro_torch.checkpoint.store.CorruptCheckpointError` — flipped bits,
  dropped or truncated shard file, unreadable manifest) is *skipped* and the
  restore falls back to the next-newest checkpoint instead of crashing,
  which is what the keep-last-K GC budget exists for.
- **lr_rescue** — a spike that *recurs at the same step* after a rollback
  means replay alone loops; roll back and damp the optimizer through the bad
  step instead (PaLM-style spike handling): the driver's ``rescue_step`` (a
  twin train step with LR × ``rescue_lr_scale``) when provided, else the
  offending batch is skipped outright (its loss slot records ``nan``).
  The decision is sticky — every later replay over that step takes the same
  path, keeping the run deterministic across rollbacks.
- **remesh** — elastic recovery from host loss / hang (survey §8.3.2): the
  ``remesh`` hook rebuilds the world at reduced size (new mesh, new
  step, state template on the new layout) and the driver reshard-restores
  the latest checkpoint onto it — params and ZeRO-1 optimizer moments are
  reassembled from the old mesh's shard slices and re-scattered over the
  new data axis — then continues on the shrunken cluster.
- **rebalance** — the fail-slow mitigation (survey §8.1, Malleus-style): a
  confirmed ``straggler`` attribution on a pipeline stage relayouts the
  pipeline's layers: :func:`repro_torch.ft.straggler.choose_pp_layout` on the
  timer's ``stage_times()`` picks the new ``pp_layout``, the ``rebalance``
  hook returns the step and state template for it, and the driver
  reshard-restores the latest checkpoint onto it. A stage already
  rebalanced that is attributed again escalates instead of looping (its
  per-layer cost will not change). Without a pipeline, a hook or a stage
  attribution it degrades to ``remesh`` when that hook is wired, else to
  ``ignore``.
- **ignore** — log and continue (the hang watchdog's default, so slow-step
  jitter never rolls back a healthy run unless asked to).

Two anomaly kinds originate outside the Monitor's statistical detectors
(they enter via :meth:`Monitor.note`):

- **sdc** — with ``plan.integrity = "audit"`` the train step emits
  ``metrics["integrity_div"]``, the cross-replica spread of an exact
  param/grad checksum (:mod:`repro_torch.ft.integrity`); any nonzero value means a
  device produced different bits and routes through ``policy.sdc``
  (default rollback — the state cannot be trusted).
- **ckpt_io** — a checkpoint persist that failed even after the store's
  retry/backoff loop. The run itself is healthy, so ``policy.ckpt_io``
  defaults to ignore (training continues on the older checkpoint cadence);
  ``"rollback"`` forces an immediate restore instead.
- **straggler** — a confirmed fail-slow attribution from the attached
  :class:`repro_torch.ft.straggler.StragglerTimer`: the driver times the batch
  fetch, the step, and checkpoint persists, feeds the timer every
  step, and notes the top confirmed ``(rank, section, class)`` event when
  the statistical detectors stayed quiet. Routed through
  ``policy.straggler`` (default ignore — attribution is always logged; the
  ladder is ignore → rebalance → remesh).

Fault injection for tests rides two hooks: ``fault_injector(step, state)``
(state-level corruption, see :func:`repro_torch.ft.inject.make_injector`) and
``fault_step_fn(step)`` — returning a *faulty twin* of the train step
(built by :func:`repro_torch.ft.inject.trace_with_faults`) to run at that
step, which is how payload corruption (kernel outputs, checksum inputs) is
scheduled without touching the clean step.

After every restore the Monitor's heartbeat is reset: restore wall-time is
not a step time and must not trip a false hang.

**Tiered restore order** (survey §8.3.1, Gemini/CheckFreq): every restore —
rollback, lr_rescue, resume — tries the hot in-memory tier first when one is
attached (``mem_ckpt``): (1) RAM primary shards (no verification — digested
at save, RAM trusted between save and restore), (2) RAM peer rebuild from
ring-neighbor mirrors (always digest-verified), and only then (3) the disk
walk, newest-intact first with full integrity verification, taking
``restore_resharded`` when the layout changed (remesh). The memory tier is
cleared on remesh (its recorded layouts are stale) and is not consulted for
cross-layout restores — elasticity is the disk tier's job.

**Exit discipline**: the checkpoint manager is flushed (``ckpt.wait()``) in
a ``finally`` on *every* exit path, and when a
:class:`repro_torch.ft.flight.FlightRecorder` is attached its ring is dumped to
JSON on preemption and on any exception exit (``RecoveryExhausted`` carries
``flight_path``), so no failure leaves silently and every failure leaves a
black box.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.checkpoint.store import CheckpointManager, CorruptCheckpointError
from repro_torch.core.config import RecoveryPolicy
from . import inject as _inject
from .anomaly import Anomaly, Monitor
from .preempt import choose_tier, clear_marker, read_marker, write_marker
from .straggler import choose_pp_layout, effective_layout


class RecoveryExhausted(RuntimeError):
    """max_restores spent without clearing the fault; carries the anomaly
    that forced the final (refused) restore."""

    def __init__(self, restores: int, anomaly: Optional[Anomaly]):
        super().__init__(f"giving up after {restores} restores: {anomaly}")
        self.restores = restores
        self.anomaly = anomaly
        # set by run_with_recovery when a flight recorder is attached: the
        # JSON black box dumped on the way out (the autopsy artifact)
        self.flight_path: Optional[str] = None


@dataclasses.dataclass
class RemeshSpec:
    """The post-shrink world a ``remesh`` hook hands back to the driver.

    ``state_template`` must match the checkpoint's tree structure and be laid
    out for ``plan`` over ``mesh`` (``init_train_state(model, gen, mesh,
    plan)``; a ``DataMesh()`` of one process for dp 1), so the reshard
    restore fills it with this rank's slices.
    """
    train_step: Callable[[Any, Dict], Tuple[Any, Dict]]
    state_template: Any
    plan: Any = None
    mesh: Any = None
    rescue_step: Optional[Callable[[Any, Dict], Tuple[Any, Dict]]] = None


@dataclasses.dataclass
class RunReport:
    steps_done: int
    anomalies: List[Anomaly]
    restores: int
    losses: List[float]
    remeshes: int = 0
    # pp_layout relayouts applied by the straggler ladder (each is also a
    # restore — the reshard rides the checkpoint machinery)
    rebalances: int = 0
    # (step, anomaly kind, action taken) — the policy audit trail
    actions: List[Tuple[int, str, str]] = dataclasses.field(default_factory=list)
    # corrupt checkpoints skipped by fallback restores
    ckpt_fallbacks: int = 0
    # restores served by the hot in-memory tier (subset of ``restores``);
    # the remainder walked the disk tier
    mem_restores: int = 0
    # graceful preemption exit: the run stopped early at ``preempt_step``
    # after a just-in-time snapshot (resume with ``resume=True``)
    preempted: bool = False
    preempt_step: Optional[int] = None
    # where the flight recorder dumped its JSON (preemption/crash), if at all
    flight_path: Optional[str] = None


def run_with_recovery(
    state: Any,
    train_step: Callable[[Any, Dict], Tuple[Any, Dict]],
    get_batch: Callable[[int], Dict],
    n_steps: int,
    ckpt: CheckpointManager,
    monitor: Optional[Monitor] = None,
    ckpt_every: int = 10,
    max_restores: int = 3,
    fault_injector: Optional[Callable[[int, Any], Any]] = None,
    plan=None,
    mesh=None,
    policy: Optional[RecoveryPolicy] = None,
    rescue_step: Optional[Callable[[Any, Dict], Tuple[Any, Dict]]] = None,
    remesh: Optional[Callable[[], RemeshSpec]] = None,
    straggler=None,
    rebalance: Optional[Callable[[Tuple[int, ...]], RemeshSpec]] = None,
    resume: bool = False,
    fault_step_fn: Optional[Callable[[int], Optional[Callable]]] = None,
    mem_ckpt=None,
    mem_every: int = 1,
    preempt=None,
    flight=None,
) -> Tuple[Any, RunReport]:
    """Run ``n_steps`` with periodic checkpointing and anomaly-driven recovery.

    ``fault_injector(step, state) -> state`` lets tests corrupt the run;
    ``fault_step_fn(step) -> step_fn | None`` swaps in a faulty twin
    of the train step for that step (payload corruption).
    ``plan``/``mesh`` stamp the layout axes into every checkpoint manifest;
    each restore routes through :meth:`CheckpointManager.check_plan` —
    same-layout checkpoints replay shard-to-shard, and with
    ``policy.elastic`` a layout change takes the reshard path instead of
    refusing. Restores skip corrupt checkpoints (newest-intact fallback).
    ``remesh()`` is the elastic hook: called on a hang when
    ``policy.hang == "remesh"``, it returns the shrunken-cluster
    :class:`RemeshSpec` the run continues under.

    ``straggler`` (a :class:`repro_torch.ft.straggler.StragglerTimer`) turns on
    fail-slow attribution: the driver times the batch fetch
    (``data.fetch``), each checkpoint persist (``ckpt.persist``), and the
    step, and calls ``straggler.after_step`` every step — which also
    executes any armed ``slow`` fault's real delay, so injected fail-slow
    costs wall clock. A confirmed attribution is noted as a ``straggler``
    anomaly and routed through ``policy.straggler``. ``rebalance(layout)``
    is the mitigation hook: given the :func:`choose_pp_layout` target it
    returns a :class:`RemeshSpec` for the same mesh with ``plan.pp_layout =
    layout`` (its ``state_template`` laid out for it); the driver
    reshard-restores onto it exactly like a remesh. Without the hook (or for
    non-stage attributions) ``"rebalance"`` degrades to ``"remesh"`` when
    that hook exists, else to ``"ignore"``. ``resume=True`` picks up
    from the latest checkpoint already in ``ckpt`` (resharding onto
    ``state``'s layout if it was written on a different one) instead of
    saving a fresh step-0 checkpoint; a ``PREEMPTED`` marker left by a
    prior graceful preemption is consumed (logged + cleared) on resume.

    Fast-recovery tier (survey §8.3.1): ``mem_ckpt`` (a
    :class:`repro_torch.checkpoint.memory.MemoryCheckpointTier`) snapshots the
    state into host RAM every ``mem_every`` accepted steps, and every
    restore tries it *first* — rollbacks land on the newest RAM snapshot
    (at most ``mem_every - 1`` steps of replay instead of up to
    ``ckpt_every - 1``) and fall back to the verified disk walk when the
    tier can't serve (empty, layout mismatch after remesh, shards lost
    beyond the peer mirrors). A remesh clears it (recorded layouts are
    stale on the new mesh).

    ``preempt`` (a :class:`repro_torch.ft.preempt.PreemptionGuard`) is checked
    between steps: on a preemption notice the driver flushes the in-flight
    async persist, takes a just-in-time blocking snapshot on the tier
    :func:`repro_torch.ft.preempt.choose_tier` picks from the grace budget vs
    measured persist time, writes the ``PREEMPTED`` marker, dumps the
    flight recorder, and returns ``RunReport(preempted=True, ...)``.

    ``flight`` (a :class:`repro_torch.ft.flight.FlightRecorder`) collects the
    per-step black box: the driver logs policy decisions, restores (with
    the serving tier), injected faults that fired, and preemption; it is
    dumped to JSON on preemption and on *any* exception exit — including
    :class:`RecoveryExhausted`, which carries ``flight_path`` — and the
    path lands on the report. The checkpoint manager's background persist
    is flushed (``ckpt.wait()``) in a ``finally`` on every exit path, so a
    failed persist always surfaces as a ``ckpt_io`` anomaly instead of
    dying silently with its thread.
    """
    monitor = monitor or Monitor()
    policy = policy or RecoveryPolicy(max_restores=max_restores)
    policy.validate()
    if flight is not None:
        # one black box for the whole stack: detector, store, and hot tier
        # all log into the driver's recorder unless wired to their own
        if getattr(monitor, "flight", None) is None:
            monitor.flight = flight
        if getattr(ckpt, "flight", None) is None:
            ckpt.flight = flight
        if mem_ckpt is not None and getattr(mem_ckpt, "flight", None) is None:
            mem_ckpt.flight = flight
    if straggler is not None and flight is not None \
            and getattr(straggler.detector, "flight", None) is None:
        straggler.detector.flight = flight
    losses: List[float] = []
    actions: List[Tuple[int, str, str]] = []
    restores = 0
    remeshes = 0
    rebalances = 0
    fallbacks = 0
    mem_restores = 0
    # stages already relayouted by the straggler ladder: a re-attribution of
    # the same rank (its per-layer cost is unchanged) escalates, not loops
    rebalanced_ranks: Set[int] = set()
    spike_counts: Dict[int, int] = {}
    rescue_mode: Dict[int, str] = {}   # step -> "rescue" | "skip", sticky
    step = 0

    def _restore(template, the_plan=None, the_mesh=None):
        """Tiered restore — memory first, then the verified disk walk.

        Tier 1/2: the hot RAM ring (primary shards, then peer rebuild from
        neighbor mirrors — both inside ``mem_ckpt.restore``). Tier 3: walk
        disk checkpoints newest-first, skipping any that fail integrity
        verification (the keep-last-K fallback)."""
        nonlocal fallbacks, mem_restores
        if mem_ckpt is not None:
            try:
                got, tree = mem_ckpt.restore(template, plan=the_plan,
                                             mesh=the_mesh)
            except (CorruptCheckpointError, ValueError, AssertionError) as e:
                # can't serve (empty / lost shards / layout change) — disk
                if flight is not None:
                    flight.record("restore_miss", step, tier="memory",
                                  error=repr(e))
            else:
                mem_restores += 1
                monitor.reset_heartbeat()
                if flight is not None:
                    flight.record("restore", got,
                                  tier=("memory-rebuild"
                                        if mem_ckpt.last_rebuild else "memory"),
                                  rebuilt_shards=mem_ckpt.last_rebuild)
                return got, tree
        candidates = ckpt.steps(newest_first=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {ckpt.dir}")
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                route = "replay"
                if the_plan is not None or the_mesh is not None:
                    route = ckpt.check_plan(the_plan, step=s, mesh=the_mesh,
                                            elastic=policy.elastic)
                if route == "reshard":
                    got, tree = ckpt.restore_resharded(
                        template, step=s, mesh=the_mesh, plan=the_plan)
                else:
                    got, tree = ckpt.restore(template, step=s, mesh=the_mesh,
                                             plan=the_plan)
            except CorruptCheckpointError as e:
                fallbacks += 1
                monitor.note("ckpt_corrupt", s, repr(e))
                last_err = e
                continue
            monitor.reset_heartbeat()  # restore wall-time is not a step time
            if flight is not None:
                flight.record("restore", got, tier="disk", route=route)
            return got, tree
        raise last_err                 # every checkpoint on disk is corrupt

    def _sect(name, s):
        """The straggler timer's section context (times + executes armed
        ``slow`` delays), or a no-op when no timer is attached."""
        return (straggler.section(name, s) if straggler is not None
                else nullcontext())

    def _try_save(s, st, blocking=False) -> Optional[Anomaly]:
        """Save, converting an (already retried) persist failure into a
        ``ckpt_io`` anomaly routed through ``policy.ckpt_io``. With async
        persist the failure of save N surfaces at save N+1's fence — the
        anomaly is stamped with the step the failure *surfaced* at."""
        try:
            with _sect("ckpt.persist", s):
                ckpt.save(s, st, blocking=blocking, plan=plan, mesh=mesh)
            return None
        except (OSError, RuntimeError) as e:
            a = monitor.note("ckpt_io", s, repr(e))
            actions.append((s, "ckpt_io", policy.ckpt_io))
            return a

    def _mem_save(s, st):
        if mem_ckpt is not None and s % max(1, mem_every) == 0:
            mem_ckpt.save(s, st, plan=plan, mesh=mesh)

    def _report(**over) -> RunReport:
        base = dict(steps_done=step, anomalies=monitor.anomalies,
                    restores=restores, losses=losses, remeshes=remeshes,
                    rebalances=rebalances, actions=actions,
                    ckpt_fallbacks=fallbacks, mem_restores=mem_restores)
        base.update(over)
        return RunReport(**base)

    if resume and ckpt.latest_step() is not None:
        marker = read_marker(ckpt.dir)
        if marker is not None:
            # consume the graceful-preemption marker: log the handoff and
            # clear it so a later crash isn't misread as another preemption
            if flight is not None:
                flight.record("resume_after_preempt",
                              int(marker.get("step", -1)),
                              tier=marker.get("tier"))
            clear_marker(ckpt.dir)
        step, state = _restore(state, the_plan=plan, the_mesh=mesh)
        losses = [float("nan")] * step     # pre-resume slots are unknown
    else:
        _try_save(step, state, blocking=True)
    _mem_save(step, state)

    try:
        while step < n_steps:
            if preempt is not None and preempt.requested:
                # graceful preemption: flush the in-flight persist first (a
                # background failure must not pass for a durable
                # checkpoint), then a just-in-time blocking snapshot on
                # whichever tier fits the remaining grace budget
                try:
                    ckpt.wait()
                except (OSError, RuntimeError) as e:
                    monitor.note("ckpt_io", step, repr(e))
                    actions.append((step, "ckpt_io", policy.ckpt_io))
                tier = choose_tier(preempt, ckpt, mem_ckpt)
                if tier == "memory":
                    mem_ckpt.save(step, state, plan=plan, mesh=mesh)
                else:
                    _try_save(step, state, blocking=True)
                if flight is not None:
                    flight.record("preempt", step, tier=tier,
                                  signum=preempt.signum,
                                  grace_left=preempt.remaining())
                fp = flight.dump("preempt") if flight is not None else None
                write_marker(ckpt.dir, step, tier, preempt.signum, fp)
                return state, _report(preempted=True, preempt_step=step,
                                      flight_path=fp)

            mode = rescue_mode.get(step)
            if mode == "skip":
                losses.append(float("nan"))  # batch dropped by lr_rescue
                step += 1
                if step % ckpt_every == 0:
                    _try_save(step, state)
                _mem_save(step, state)
                continue

            cur = state
            n_fired = len(_inject.CONTROLLER.fired)
            if fault_injector is not None:
                cur = fault_injector(step, cur)
            fn = (rescue_step if (mode == "rescue" and rescue_step)
                  else train_step)
            if fault_step_fn is not None:
                faulty = fault_step_fn(step)
                if faulty is not None:
                    fn = faulty
            with _sect("data.fetch", step):
                batch = get_batch(step)
            t0 = time.perf_counter()
            new_state, metrics = fn(cur, batch)
            loss = float(metrics["loss"])    # blocks on the device, so the
            gnorm = float(metrics.get("grad_norm", 0.0))  # timing below is
            step_seconds = time.perf_counter() - t0       # real step time
            div = float(metrics.get("integrity_div", 0.0))
            if flight is not None:
                for point, kind, fstep in \
                        _inject.CONTROLLER.fired[n_fired:]:
                    flight.record("fault", step, point=point,
                                  fault_kind=kind, armed_step=fstep)
            anomaly = monitor.record(step, loss, gnorm)
            if div != 0.0:
                # replica checksum divergence outranks the statistical
                # detectors: the step's own outputs cannot be trusted,
                # whatever they look like
                anomaly = monitor.note("sdc", step, f"integrity_div={div}")
            if anomaly is not None and mode == "rescue" \
                    and anomaly.kind == "spike":
                anomaly = None             # the rescue step owns this spike

            # per-step straggler telemetry: ALWAYS fed (armed `slow` faults
            # execute their real delays inside after_step — skipping it would
            # un-inject the fault), but only *noted* as the step's anomaly
            # when the statistical detectors stayed quiet (a nan/spike/hang
            # outranks an attribution of the same symptom)
            ev = None
            if straggler is not None:
                ev = straggler.after_step(step, step_seconds, plan=plan)
            if ev is not None and anomaly is None:
                anomaly = monitor.note(
                    "straggler", step,
                    f"rank={ev.rank} section={ev.section} class={ev.cls} "
                    f"slowdown={ev.slowdown:.2f}x")

            if anomaly is not None:
                if anomaly.kind == "spike":
                    spike_counts[step] = spike_counts.get(step, 0) + 1
                    action = (policy.spike if spike_counts[step] == 1
                              else policy.repeated_spike)
                else:
                    action = getattr(policy, anomaly.kind)
                new_layout = None
                if action == "rebalance":
                    # applicable only to a pipeline-stage attribution with a
                    # hook, a known layout, and a rank not already relayouted
                    # (its per-layer cost won't change — escalate instead)
                    lay = effective_layout(plan, getattr(straggler, "cfg", None))
                    ok = (rebalance is not None and ev is not None
                          and ev.section == "pp.stage" and lay is not None
                          and ev.rank is not None
                          and ev.rank not in rebalanced_ranks)
                    if ok:
                        new_layout = choose_pp_layout(straggler.stage_times(), lay)
                        if new_layout == tuple(lay):
                            action = "ignore"   # measurement says: balanced
                    else:
                        action = "remesh" if remesh is not None else "ignore"
                if action == "remesh" and (anomaly.kind not in
                                           ("hang", "straggler")
                                           or remesh is None):
                    action = "ignore"      # no hook / not escalable: advisory
                actions.append((step, anomaly.kind, action))
                if flight is not None:
                    flight.record("policy", step, anomaly=anomaly.kind,
                                  action=action, detail=anomaly.detail)

                if action in ("rollback", "lr_rescue"):
                    if restores >= policy.max_restores:
                        raise RecoveryExhausted(restores, anomaly)
                    if action == "lr_rescue":
                        rescue_mode[step] = ("rescue" if rescue_step
                                             else "skip")
                    step, state = _restore(state, the_plan=plan,
                                           the_mesh=mesh)
                    restores += 1
                    del losses[step:]
                    continue
                if action == "remesh":
                    if restores >= policy.max_restores:
                        raise RecoveryExhausted(restores, anomaly)
                    spec = remesh()
                    # the old group lost ranks: a save still fenced on it
                    # must not run its barrier there
                    ckpt.leave_mesh()
                    if mem_ckpt is not None:
                        # the world was rebuilt: RAM snapshots recorded on
                        # the old layout are gone with their hosts
                        mem_ckpt.clear()
                    step, state = _restore(spec.state_template,
                                           spec.plan, spec.mesh)
                    train_step = spec.train_step
                    plan, mesh = spec.plan, spec.mesh
                    if spec.rescue_step is not None:
                        rescue_step = spec.rescue_step
                    restores += 1
                    remeshes += 1
                    if straggler is not None:
                        straggler.plan = plan
                        straggler.reset()  # old-mesh baselines are stale
                    del losses[step:]
                    continue
                if action == "rebalance":
                    if restores >= policy.max_restores:
                        raise RecoveryExhausted(restores, anomaly)
                    spec = rebalance(new_layout)
                    if mem_ckpt is not None:
                        # RAM snapshots record the old pp_layout; the hot
                        # tier cannot reshard, so don't keep failing on them
                        mem_ckpt.clear()
                    # the saved manifests record the old pp_layout, so
                    # check_plan routes this restore "reshard": the relayout
                    # is an elastic reshard, not a refusal
                    step, state = _restore(spec.state_template, spec.plan, spec.mesh)
                    train_step = spec.train_step
                    if spec.plan is not None:
                        plan = spec.plan
                    if spec.mesh is not None:
                        mesh = spec.mesh
                    if spec.rescue_step is not None:
                        rescue_step = spec.rescue_step
                    restores += 1
                    rebalances += 1
                    rebalanced_ranks.add(ev.rank)
                    straggler.plan = plan
                    straggler.reset()      # new regime: re-learn baselines
                    if flight is not None:
                        flight.record("rebalance", step, rank=ev.rank,
                                      layout=list(new_layout))
                    del losses[step:]
                    continue
                # "ignore": fall through and accept the step

            state = new_state
            losses.append(loss)
            step += 1
            if step % ckpt_every == 0:
                a = _try_save(step, state)
                if a is not None and policy.ckpt_io == "rollback":
                    if restores >= policy.max_restores:
                        raise RecoveryExhausted(restores, a)
                    step, state = _restore(state, the_plan=plan,
                                           the_mesh=mesh)
                    restores += 1
                    del losses[step:]
                    continue
            _mem_save(step, state)
    except BaseException as e:
        if flight is not None:
            # the autopsy artifact: dump the black box and pin its path on
            # the exception so the caller can find it without a report
            fp = flight.dump(reason=type(e).__name__,
                             extra={"step": step, "error": repr(e)})
            try:
                e.flight_path = fp
            except Exception:       # exotic exception types w/ slots
                pass
        raise
    finally:
        # flush the background persist on EVERY exit path — normal return,
        # preemption, crash, RecoveryExhausted — so a failed persist
        # surfaces as a ckpt_io anomaly instead of dying with its thread
        try:
            ckpt.wait()
        except (OSError, RuntimeError) as e:
            monitor.note("ckpt_io", step, repr(e))
            actions.append((step, "ckpt_io", policy.ckpt_io))
    return state, _report()
