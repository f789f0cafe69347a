"""The port's recovery driver (``repro_torch.ft.run_with_recovery``) against the
reference's, on the CPU at the smoke sizes of ``tests/test_elastic.py``.

The fault matrix {nan, spike, repeated_spike, hang} x {dense, moe, ssm} runs
the same schedule through both drivers from the same weights: the port's
``RunReport`` (actions, restores, steps done, the NaN slots of the losses) must
equal the reference's, the port's final params and moments must equal the
port's own clean run bit for bit, and the port's losses must be the
reference's to 1e-4. Its first step, and its first step after each restore,
are held element by element to the reference's step from the same state and
batch (``_hold_to_reference``). Then the reference's
single-process chaos schedule (``tests/test_chaos.py:425-467`` without its
rank-masked sdc entry, which needs two ranks: ``tests/test_torch_ft_dp.py``)
with each family's kernel fault point as the payload, and one test for each
of the reference's single-process recovery tests (lr_rescue, exhaustion,
resume, the RAM tier, GC's keep floor, persist failures, corrupt checkpoints,
preemption, fail-slow, rebalance).

The port's train step updates params and moments in place, so every run here
starts from its own copy of the weights (``World.state``). The fail-slow
tests' detector takes a 30 ms floor under the injected 50 ms delay, so a
loaded host's slower steps are not attributed."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core import Family as JFamily
from repro.core import InputShape as JShape
from repro.core import ModelConfig as JConfig
from repro.core import MoEConfig as JMoE
from repro.core import ParallelPlan as JPlan
from repro.core import RecoveryPolicy as JPolicy
from repro.core import SSMConfig as JSSM
from repro.data import SyntheticDataset as JaxDataset
from repro.ft import inject as jinject
from repro.models import build_model as jax_build_model
from repro.optim import AdamWState as JAdamWState
from repro.train import Hyper as JHyper
from repro.train import TrainState as JTrainState
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (CheckpointManager, CorruptCheckpointError,
                                    MemoryCheckpointTier)
from repro_torch.core import (Family, InputShape, ModelConfig, MoEConfig, ParallelPlan,
                              RecoveryPolicy, SSMConfig)
from repro_torch import ft as tft
from repro_torch.core.tree import leaves
from repro_torch.data import SyntheticDataset
from repro_torch.ft import inject as tinject
from repro_torch.ft import (FlightRecorder, Monitor, PreemptionGuard, RecoveryExhausted,
                            RemeshSpec, StragglerDetector, StragglerTimer, run_with_recovery)
from repro_torch.ft.inject import FaultSpec, armed, make_injector, trace_with_faults
from repro_torch.ft.preempt import read_marker
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import DataMesh
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.train import Hyper, TrainState, make_train_step

torch.set_num_threads(1)

FAULT_STEP, N_STEPS, CKPT_EVERY = 13, 20, 5
# The losses of a recovered run against the reference's, as the 20-step
# quickstart trajectory (tests/test_torch_train.py).
LOSS_REL = 1e-4
B1, B2, EPS = 0.9, 0.95, 1e-8        # AdamW's defaults (both packages)


class InlineCheckpointManager(CheckpointManager):
    """Persists inside ``save``, so a persist failure raises at the save that
    failed (the reference tests' ``async_persist=False``)."""

    def save(self, step, tree, blocking=False, **kw):
        return super().save(step, tree, blocking=True, **kw)


def _configs(family):
    """The reference's and the port's config of ``tests/test_elastic.py``."""
    kw = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64)
    if family == "dense":
        return (JConfig("tiny-d", JFamily.DENSE, **kw), ModelConfig("tiny-d", Family.DENSE, **kw))
    if family == "moe":
        kw["d_ff"] = 0
        return (JConfig("tiny-m", JFamily.MOE, **kw, moe=JMoE(num_experts=4, top_k=2, d_expert=32,
                                                              capacity_factor=2.0)),
                ModelConfig("tiny-m", Family.MOE, **kw,
                            moe=MoEConfig(num_experts=4, top_k=2, d_expert=32,
                                          capacity_factor=2.0)))
    kw.update(n_heads=0, n_kv_heads=0, d_ff=0)
    return (JConfig("tiny-s", JFamily.SSM, **kw, ssm=JSSM(d_state=8, head_dim=16, expand=2,
                                                          chunk=8)),
            ModelConfig("tiny-s", Family.SSM, **kw,
                        ssm=SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8)))


_INIT = {}


def _init_params(family):
    """The reference's seed-0 params as numpy (cached per family)."""
    if family not in _INIT:
        jcfg, _ = _configs(family)
        model = jax_build_model(jcfg, JPlan(remat="none", compute_dtype="float32"))
        _INIT[family] = jax.tree.map(np.asarray, jax_init_train_state(
            model, jax.random.PRNGKey(0)).params)
    return _INIT[family]


class World:
    """The port's side of one run: model, step, batches and a fresh state
    from the reference's seed-0 weights."""

    def __init__(self, family="dense", integrity="off", hyper=Hyper(total_steps=30)):
        _, self.cfg = _configs(family)
        self.family = family
        self.plan = ParallelPlan(remat="none", compute_dtype="float32", integrity=integrity)
        self.model = build_model(self.cfg, self.plan, device="cpu")
        self.hyper = hyper
        self.step_fn = make_train_step(self.model, self.plan, hyper)
        ds = SyntheticDataset(self.cfg, InputShape("t", 16, 4, "train"))
        self._batches = {}
        self.get_batch = lambda s: self._batches.setdefault(
            s, {k: torch.from_numpy(v) for k, v in ds.batch(s).items()})

    def state(self):
        params = params_from_numpy(_init_params(self.family), self.cfg, device="cpu")
        for p in leaves(params):
            p.requires_grad_(True)
        return TrainState(params, adamw_init(params))

    def clean(self, n=N_STEPS, skip=(), step_for=None):
        """The fault-free schedule: n steps (``skip``ped batches not trained,
        ``step_for(s)`` the step function of step s)."""
        st, losses = self.state(), []
        for s in range(n):
            if s in skip:
                losses.append(float("nan"))
                continue
            st, m = (step_for(s) if step_for else self.step_fn)(st, self.get_batch(s))
            losses.append(float(m["loss"]))
        return st, losses


_JAX = {}


def _jax_world(family):
    """The reference's side: plan, jitted step (built once per family),
    batches and a fresh seed-0 state."""
    if family not in _JAX:
        jcfg, _ = _configs(family)
        plan = JPlan(remat="none", compute_dtype="float32")
        model = jax_build_model(jcfg, plan)
        ds = JaxDataset(jcfg, JShape("t", 16, 4, "train"))
        get_batch = lambda s: {k: jnp.asarray(v) for k, v in ds.batch(s).items()}  # noqa: E731
        _JAX[family] = (model, plan, jax.jit(jax_make_train_step(model, plan,
                                                                 JHyper(total_steps=30))),
                        get_batch)
    model, plan, step_fn, get_batch = _JAX[family]
    state = jax_init_train_state(model, jax.random.PRNGKey(0))
    return plan, step_fn, get_batch, state


def assert_bits_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _nan_slots(losses):
    return [i for i, v in enumerate(losses) if v != v]


def _quiet():
    return Monitor(min_history=1000, hang_min_seconds=60.0)


# ---------------------------------------------------------------------------
# the fault matrix


def _matrix_injector(fault, corrupt):
    """``tests/test_elastic.py``'s injector; ``corrupt(state, factor)``
    scales the params (the reference returns a new state, the port's scales
    its live params in place)."""
    fired = {"n": 0}

    def injector(step, st):
        if step != FAULT_STEP:
            return st
        fired["n"] += 1
        if fault == "nan" and fired["n"] == 1:
            return corrupt(st, float("nan"))
        if fault == "spike" and fired["n"] == 1:
            return corrupt(st, 8.0)
        if fault == "repeated_spike":   # persistent: fires on every replay
            return corrupt(st, 8.0)
        if fault == "hang" and fired["n"] == 1:
            import time
            time.sleep(1.0)
        return st
    return injector


def _scale_in_place(st, factor):
    with torch.no_grad():
        for p in leaves(st.params):
            p.mul_(factor)
    return st


def _scale_jax(st, factor):
    return st._replace(params=jax.tree.map(lambda x: x * jnp.float32(factor), st.params))


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
@pytest.mark.parametrize("fault", ["nan", "spike", "repeated_spike", "hang"])
def test_fault_matrix_matches_reference(tmp_path, family, fault):
    floor = 0.3 if fault == "hang" else 30.0
    plan, jstep, jbatch, jstate = _jax_world(family)
    _, jreport = jft.run_with_recovery(
        jstate, jstep, jbatch, N_STEPS,
        JaxCheckpointManager(tmp_path / "ref", keep=3, async_persist=False),
        jft.Monitor(min_history=4, hang_min_seconds=floor), ckpt_every=CKPT_EVERY,
        plan=plan, fault_injector=_matrix_injector(fault, _scale_jax), policy=JPolicy())

    w = World(family)
    spy = _FirstSteps(w)
    final, report = run_with_recovery(
        w.state(), spy.step_fn, spy.get_batch, N_STEPS,
        InlineCheckpointManager(tmp_path / "port", keep=3),
        Monitor(min_history=4, hang_min_seconds=floor), ckpt_every=CKPT_EVERY,
        plan=w.plan, fault_injector=_matrix_injector(fault, _scale_in_place),
        policy=RecoveryPolicy())

    assert report.actions == jreport.actions
    assert (report.restores, report.steps_done) == (jreport.restores, jreport.steps_done)
    assert _nan_slots(report.losses) == _nan_slots(jreport.losses)
    assert len(report.losses) == N_STEPS
    if fault != "hang":
        assert report.restores >= 1
    skip = (FAULT_STEP,) if fault == "repeated_spike" else ()
    clean, clean_losses = w.clean(skip=skip)
    np.testing.assert_array_equal(report.losses, clean_losses)
    assert_bits_equal(final.params, clean.params)
    assert_bits_equal(final.opt.mu, clean.opt.mu)
    assert_bits_equal(final.opt.nu, clean.opt.nu)
    np.testing.assert_allclose(report.losses, jreport.losses, rtol=LOSS_REL)
    assert len(spy.steps) == 1 + report.restores
    _hold_to_reference(family, spy.steps, w.hyper.weight_decay)


def _numpy_state(st, cfg):
    """Copies of the port's params and moments in the reference's layout, and
    its step count."""
    copy = lambda tree: jax.tree.map(np.array, params_to_numpy(tree, cfg))  # noqa: E731
    return copy(st.params), copy(st.opt.mu), copy(st.opt.nu), st.opt.step


class _FirstSteps:
    """The port's step and batch fetch as the driver calls them, keeping the
    state before and after the first step and the first step after each
    restore (the first whose batch index is not past the one before)."""

    def __init__(self, w):
        self.w, self.s, self.seen, self.steps = w, None, [], []

    def get_batch(self, s):
        self.s = s
        return self.w.get_batch(s)

    def step_fn(self, st, batch):
        first = not self.seen or self.s <= self.seen[-1]
        self.seen.append(self.s)
        before = _numpy_state(st, self.w.cfg) if first else None
        st, metrics = self.w.step_fn(st, batch)
        if first:
            self.steps.append((self.s, before, _numpy_state(st, self.w.cfg)))
        return st, metrics


def _adam_direction(m, v, t):
    """The reference's update direction from a step's new moments, in fp64."""
    m, v = np.float64(m), np.float64(v)
    return (m / (1 - B1 ** (t + 1))) / (np.sqrt(v / (1 - B2 ** (t + 1))) + EPS)


def _hold_to_reference(family, steps, weight_decay):
    """Each kept step of the port against the reference's jitted step from
    the same state (the port's, before it) and batch. The new moments agree
    to ``GRAD_REL`` of each leaf's largest value, as the first step of
    ``tests/test_torch_train.py``. Each new param agrees to lr * (1e-4 + the
    change of the update direction between the two sides' new moments) plus
    one rounding of the result: ``_step_within_bound``'s slack, with the
    direction's sensitivity to the frameworks' gradient difference evaluated
    exactly rather than through its derivative at step 0.

    The reference also decays the per-layer 1-D leaves that it stacks (its
    ``p.ndim > 1`` sees the layer dim) and the port does not (ROADMAP queue
    C): that decay, lr * weight_decay * p, is applied to the port's side of
    those leaves (the SSM's A_log, D and dt_bias do not start at 0)."""
    from test_torch_train import GRAD_REL
    _, jstep, jbatch, _ = _jax_world(family)
    for s, (p, mu, nu, t), (p1, mu1, nu1, _) in steps:
        stacked_1d = [a.ndim == 2 and "['layers']" in jax.tree_util.keystr(k)
                      for k, a in jax.tree_util.tree_flatten_with_path(p)[0]]
        new, metrics = jstep(JTrainState(jax.tree.map(jnp.asarray, p), JAdamWState(
            jnp.asarray(t, jnp.int32), jax.tree.map(jnp.asarray, mu),
            jax.tree.map(jnp.asarray, nu))), jbatch(s))
        lr = float(metrics["lr"])
        ref = [jax.tree.leaves(jax.tree.map(np.asarray, x))
               for x in (new.params, new.opt.mu, new.opt.nu)]
        ours = [jax.tree.leaves(x) for x in (p1, mu1, nu1)]
        for o, r in zip(ours[1] + ours[2], ref[1] + ref[2]):
            assert np.abs(o - r).max() <= GRAD_REL * max(np.abs(r).max(), 1e-30), (s, t)
        for o, r, p0, extra, om, rm, ov, rv in zip(ours[0], ref[0], jax.tree.leaves(p),
                                                   stacked_1d, ours[1], ref[1], ours[2], ref[2]):
            o = np.float64(o) - (lr * weight_decay * np.float64(p0) if extra else 0.0)
            du = np.abs(_adam_direction(om, ov, t) - _adam_direction(rm, rv, t))
            tol = lr * (1e-4 + du) + np.spacing(np.abs(r))
            assert (np.abs(o - r) <= tol).all(), (s, t)


# ---------------------------------------------------------------------------
# the chaos schedule (single process)

CHAOS_POINTS = {"dense": "kernel.attention", "moe": "kernel.expert_gemm", "ssm": "kernel.ssd"}
# tests/test_chaos.py:461-467 without the sdc entry (two ranks: test_torch_ft_dp.py)
CHAOS_ACTIONS = [(8, "spike", "rollback"), (12, "nan", "rollback"),
                 (17, "nan", "rollback"), (18, "hang", "ignore")]


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
def test_chaos_schedule(tmp_path, family):
    """A state spike at 8, the family's kernel output NaN'd at 12 and 17, the
    step-15 shard write silently dropped (so the step-17 restore skips it and
    falls back to 10), a host hang at 18: the reference's actions, and a
    bit-match with the fault-free schedule, losses included."""
    w = World(family, hyper=Hyper(peak_lr=1e-3, total_steps=40, z_loss=0.0))
    nan_twin = trace_with_faults(w.step_fn, specs=[
        FaultSpec(CHAOS_POINTS[family], "nan", step=12, tick=None)])
    used = {12: 0, 17: 0}

    def fault_step_fn(step):
        if step in used and used[step] < 1:
            used[step] += 1
            return nan_twin
        return None

    injector = make_injector([FaultSpec("train.step", "spike", step=8, scale=8.0),
                              FaultSpec("train.step", "hang", step=18, sleep_s=1.0)])
    ckpt = InlineCheckpointManager(tmp_path, keep=3)
    with armed([FaultSpec("ckpt.shard_write", "drop_write", step=15)]):
        final, report = run_with_recovery(
            w.state(), w.step_fn, w.get_batch, N_STEPS, ckpt,
            Monitor(min_history=4, hang_min_seconds=0.3), ckpt_every=CKPT_EVERY,
            plan=w.plan, policy=RecoveryPolicy(max_restores=8), fault_injector=injector,
            fault_step_fn=fault_step_fn)
    assert report.actions == CHAOS_ACTIONS, report.actions
    assert report.restores == 3 and report.ckpt_fallbacks == 1, report
    assert any(a.kind == "ckpt_corrupt" for a in report.anomalies)
    assert report.steps_done == N_STEPS and len(report.losses) == N_STEPS
    clean, clean_losses = w.clean()
    np.testing.assert_array_equal(report.losses, clean_losses)
    assert_bits_equal(final.params, clean.params)
    assert_bits_equal(final.opt.mu, clean.opt.mu)


# ---------------------------------------------------------------------------
# the reference's single-process recovery tests, one each


def test_lr_rescue_uses_rescue_step(tmp_path):
    """test_elastic.py::test_lr_rescue_uses_rescue_step: the second spike at a
    step rolls back and replays it with the damped-LR twin."""
    w = World()
    rescue = make_train_step(w.model, w.plan, Hyper(peak_lr=3e-4 * 0.1, total_steps=30))
    fired = {"n": 0}

    def injector(step, st):   # a transient bad host: the first two attempts
        if step == FAULT_STEP and fired["n"] < 2:
            fired["n"] += 1
            return _scale_in_place(st, 8.0)
        return st

    final, report = run_with_recovery(
        w.state(), w.step_fn, w.get_batch, N_STEPS,
        InlineCheckpointManager(tmp_path, keep=3),
        Monitor(min_history=4, hang_min_seconds=30.0), ckpt_every=CKPT_EVERY, plan=w.plan,
        fault_injector=injector, policy=RecoveryPolicy(), rescue_step=rescue)
    assert report.actions == [(FAULT_STEP, "spike", "rollback"),
                              (FAULT_STEP, "spike", "lr_rescue")]
    assert report.restores == 2
    clean, _ = w.clean(step_for=lambda s: rescue if s == FAULT_STEP else w.step_fn)
    assert_bits_equal(final.params, clean.params)


def test_recovery_exhausted_leaves_parseable_flight_json(tmp_path):
    """test_fastrecovery.py: a persistent NaN exhausts max_restores; the
    exception carries the flight JSON's path, which names the anomaly, the
    step, the action, the fault and the serving tier."""
    w = World()
    fl = FlightRecorder(maxlen=128, path=str(tmp_path / "flight.json"))
    injector = make_injector([FaultSpec("train.step", "nan", step=13, times=99)])
    with pytest.raises(RecoveryExhausted, match="giving up after 2") as ei:
        run_with_recovery(
            w.state(), w.step_fn, w.get_batch, N_STEPS,
            InlineCheckpointManager(tmp_path / "ck", keep=3), _quiet(),
            ckpt_every=CKPT_EVERY, plan=w.plan, fault_injector=injector,
            policy=RecoveryPolicy(max_restores=2), flight=fl)
    assert ei.value.restores == 2 and ei.value.anomaly.kind == "nan"
    assert ei.value.anomaly.step == 13
    assert ei.value.flight_path == str(tmp_path / "flight.json")
    d = json.loads((tmp_path / "flight.json").read_text())
    assert d["reason"] == "RecoveryExhausted" and d["extra"]["step"] == 13
    kinds = lambda k: [e for e in d["events"] if e["kind"] == k]  # noqa: E731
    assert kinds("anomaly")[0]["anomaly"] == "nan" and kinds("anomaly")[0]["step"] == 13
    assert kinds("policy")[0]["action"] == "rollback"
    assert kinds("fault")[0]["fault_kind"] == "nan"
    assert kinds("restore")[0]["tier"] == "disk"
    assert kinds("ckpt.persist") and all(e["tier"] == "disk" for e in kinds("ckpt.persist"))


def test_resume_continues_from_latest(tmp_path):
    """test_elastic.py::test_resume_continues_from_latest."""
    w = World()
    ckpt = InlineCheckpointManager(tmp_path, keep=3)
    run_with_recovery(w.state(), w.step_fn, w.get_batch, 10, ckpt,
                      Monitor(hang_min_seconds=30.0), ckpt_every=5, plan=w.plan)
    assert ckpt.latest_step() == 10
    final, report = run_with_recovery(
        w.state(), w.step_fn, w.get_batch, N_STEPS, ckpt, Monitor(hang_min_seconds=30.0),
        ckpt_every=5, plan=w.plan, resume=True)
    assert report.steps_done == N_STEPS
    assert _nan_slots(report.losses) == list(range(10))
    clean, _ = w.clean()
    assert_bits_equal(final.params, clean.params)


def test_rollback_served_by_memory_tier(tmp_path):
    """test_fastrecovery.py: a NaN rollback restores from RAM."""
    w = World()
    mem = MemoryCheckpointTier(keep=2, groups=2)
    final, report = run_with_recovery(
        w.state(), w.step_fn, w.get_batch, N_STEPS,
        InlineCheckpointManager(tmp_path, keep=3), _quiet(),
        ckpt_every=CKPT_EVERY, plan=w.plan,
        fault_injector=make_injector([FaultSpec("train.step", "nan", step=13)]),
        policy=RecoveryPolicy(), mem_ckpt=mem)
    assert report.restores == 1 and report.mem_restores == 1
    assert (13, "nan", "rollback") in report.actions
    clean, _ = w.clean()
    assert_bits_equal(final.params, clean.params)
    assert_bits_equal(final.opt.mu, clean.opt.mu)


def test_lost_memory_tier_falls_back_to_disk(tmp_path):
    """test_fastrecovery.py: both host groups lost before the NaN: the disk
    walk serves the restore."""
    w = World()
    mem = MemoryCheckpointTier(keep=2, groups=2)
    nan_inj = make_injector([FaultSpec("train.step", "nan", step=13)])

    def injector(step, st):
        if step == 12:
            mem.lose_group(0)
            mem.lose_group(1)
        return nan_inj(step, st)

    final, report = run_with_recovery(
        w.state(), w.step_fn, w.get_batch, N_STEPS,
        InlineCheckpointManager(tmp_path, keep=3), _quiet(),
        ckpt_every=CKPT_EVERY, plan=w.plan, fault_injector=injector,
        policy=RecoveryPolicy(), mem_ckpt=mem, mem_every=CKPT_EVERY)
    assert report.restores == 1 and report.mem_restores == 0
    clean, _ = w.clean()
    assert_bits_equal(final.params, clean.params)


def test_recovery_survives_drop_write_burst_via_keep_floor(tmp_path):
    """test_fastrecovery.py: the 10 and 15 shard writes dropped with keep=2;
    GC spares the intact 5 and the NaN at 17 restores it; the flight recorder
    logs the spared checkpoint."""
    w = World()
    fl = FlightRecorder(maxlen=256)
    ckpt = InlineCheckpointManager(tmp_path, keep=2, flight=fl)
    with armed([FaultSpec("ckpt.shard_write", "drop_write", step=10),
                FaultSpec("ckpt.shard_write", "drop_write", step=15)]):
        final, report = run_with_recovery(
            w.state(), w.step_fn, w.get_batch, N_STEPS, ckpt, _quiet(),
            ckpt_every=CKPT_EVERY, plan=w.plan,
            fault_injector=make_injector([FaultSpec("train.step", "nan", step=17)]),
            policy=RecoveryPolicy())
    assert report.restores == 1 and report.ckpt_fallbacks == 2
    assert any(e["kind"] == "ckpt.gc_spared" and e["step"] == 5 for e in fl.events)
    clean, _ = w.clean()
    assert_bits_equal(final.params, clean.params)


def test_persist_failure_surfaces_on_exception_exit(tmp_path):
    """test_fastrecovery.py: a background persist failure is fenced in the
    driver's ``finally`` and noted as ckpt_io even when the loop dies of
    something else."""
    w = World()
    ckpt = CheckpointManager(tmp_path, keep=3, io_retries=1, io_backoff=0.01)
    monitor = _quiet()

    def bomb(step, st):
        if step == 7:
            raise RuntimeError("unrelated crash")
        return st

    with armed([FaultSpec("ckpt.persist", "persist_exc", step=5, times=99)]):
        with pytest.raises(RuntimeError, match="unrelated crash"):
            run_with_recovery(w.state(), w.step_fn, w.get_batch, N_STEPS, ckpt, monitor,
                              ckpt_every=CKPT_EVERY, plan=w.plan, fault_injector=bomb,
                              policy=RecoveryPolicy())
    assert any(a.kind == "ckpt_io" for a in monitor.anomalies)


def test_ckpt_io_anomaly_ignored_by_default(tmp_path):
    """test_chaos.py: exhausted persist retries at step 5 are a ckpt_io
    anomaly; the default policy trains on, bit-identically."""
    w = World()
    ckpt = InlineCheckpointManager(tmp_path, keep=3, io_retries=2,
                             io_backoff=0.01)
    with armed([FaultSpec("ckpt.persist", "persist_exc", step=5, times=99)]):
        final, report = run_with_recovery(
            w.state(), w.step_fn, w.get_batch, N_STEPS, ckpt,
            Monitor(min_history=4, hang_min_seconds=30.0), ckpt_every=CKPT_EVERY,
            plan=w.plan, policy=RecoveryPolicy())
    assert (5, "ckpt_io", "ignore") in report.actions and report.restores == 0
    clean, _ = w.clean()
    assert_bits_equal(final.params, clean.params)


def test_all_checkpoints_corrupt_raises(tmp_path):
    """test_chaos.py: the 0 and 5 shard writes dropped, a NaN at 7: no
    intact checkpoint, so the restore raises."""
    w = World()
    with armed([FaultSpec("ckpt.shard_write", "drop_write", step=0),
                FaultSpec("ckpt.shard_write", "drop_write", step=5)]):
        with pytest.raises(CorruptCheckpointError):
            run_with_recovery(
                w.state(), w.step_fn, w.get_batch, N_STEPS,
                InlineCheckpointManager(tmp_path, keep=3),
                Monitor(min_history=4, hang_min_seconds=30.0), ckpt_every=CKPT_EVERY,
                plan=w.plan, fault_injector=make_injector([FaultSpec("train.step", "nan",
                                                                     step=7)]),
                policy=RecoveryPolicy())


def test_sigterm_mid_run_resumes_bit_identical(tmp_path):
    """test_preempt.py: a real SIGTERM mid-step 13 stops the run at 14 with a
    disk snapshot, the PREEMPTED marker and a flight dump; a resume in a fresh
    manager consumes the marker and lands on the clean run bit for bit."""
    w = World()
    flight = FlightRecorder(maxlen=128, path=str(tmp_path / "flight.json"))
    ckpt = CheckpointManager(tmp_path, keep=3, flight=flight)
    mem = MemoryCheckpointTier(keep=2, groups=2, flight=flight)

    def deliver(step, st):
        if step == FAULT_STEP:
            os.kill(os.getpid(), signal.SIGTERM)
        return st

    with PreemptionGuard(grace=60.0) as guard:
        _, report = run_with_recovery(
            w.state(), w.step_fn, w.get_batch, N_STEPS, ckpt, _quiet(),
            ckpt_every=CKPT_EVERY, plan=w.plan, fault_injector=deliver, mem_ckpt=mem,
            preempt=guard, flight=flight)
    assert report.preempted and report.preempt_step == FAULT_STEP + 1
    assert report.steps_done == report.preempt_step
    mk = read_marker(tmp_path)
    assert mk["step"] == report.preempt_step and mk["tier"] == "disk"
    assert mk["signum"] == signal.SIGTERM
    fj = json.loads((tmp_path / "flight.json").read_text())
    assert fj["reason"] == "preempt"
    assert [e["step"] for e in fj["events"] if e["kind"] == "preempt"] == [FAULT_STEP + 1]
    assert any(e["kind"] == "ckpt.persist" and e["tier"] == "memory" for e in fj["events"])

    resumed, report2 = run_with_recovery(
        w.state(), w.step_fn, w.get_batch, N_STEPS, CheckpointManager(tmp_path, keep=3),
        _quiet(), ckpt_every=CKPT_EVERY, plan=w.plan, resume=True)
    assert read_marker(tmp_path) is None
    assert report2.steps_done == N_STEPS and not report2.preempted
    clean, _ = w.clean()
    assert_bits_equal(resumed.params, clean.params)
    assert_bits_equal(resumed.opt.mu, clean.opt.mu)


def test_preempt_short_grace_takes_memory_tier(tmp_path):
    """test_preempt.py: a grace shorter than the measured persist routes the
    just-in-time snapshot to the RAM tier."""
    w = World()
    mem = MemoryCheckpointTier(keep=2, groups=2)
    guard = PreemptionGuard(grace=1e-9, signals=())

    def deliver(step, st):
        if step == FAULT_STEP:
            guard.trigger()
        return st

    _, report = run_with_recovery(
        w.state(), w.step_fn, w.get_batch, N_STEPS, CheckpointManager(tmp_path, keep=3),
        _quiet(), ckpt_every=CKPT_EVERY, plan=w.plan, fault_injector=deliver, mem_ckpt=mem,
        preempt=guard)
    assert report.preempted
    assert read_marker(tmp_path)["tier"] == "memory"
    assert mem.latest_step() == report.preempt_step


def test_slow_data_fetch_is_a_host_io_straggler(tmp_path):
    """A ``slow`` fault at ``data.fetch`` from step 6: the timer's section
    confirms it and the driver notes a ``straggler`` anomaly of class host-io,
    ignored by default; the run still bit-matches (delays corrupt nothing)."""
    w = World()
    det = StragglerDetector(factor=2.0, confirm=2, min_seconds=0.03, min_history=3)
    timer = StragglerTimer(cfg=w.cfg, plan=w.plan, detector=det)
    with armed([FaultSpec("data.fetch", "slow", step=6, span=3, sleep_s=0.05)]):
        final, report = run_with_recovery(
            w.state(), w.step_fn, w.get_batch, 12,
            InlineCheckpointManager(tmp_path, keep=3), _quiet(),
            ckpt_every=CKPT_EVERY, plan=w.plan, straggler=timer, policy=RecoveryPolicy())
    stragglers = [a for a in report.anomalies if a.kind == "straggler"]
    # (a loaded host may also slow a step past the detector's 2x: only the
    # injected fetch is asserted)
    assert any(6 <= a.step < 9 and "section=data.fetch class=host-io" in a.detail
               for a in stragglers), stragglers
    assert all(act == "ignore" for _, kind, act in report.actions if kind == "straggler")
    clean, _ = w.clean(12)
    assert_bits_equal(final.params, clean.params)


def _rebalance_run(ft, inject, policy_cls, world, ckpt, remesh):
    """A slow ``data.fetch`` under ``policy.straggler="rebalance"`` through
    ``ft.run_with_recovery`` (``ft``, ``inject``, ``policy_cls``: either
    package's)."""
    plan, step_fn, get_batch, state = world
    det = ft.StragglerDetector(factor=2.0, confirm=2, min_seconds=0.03, min_history=3)
    with inject.armed([inject.FaultSpec("data.fetch", "slow", step=6, span=3,
                                        sleep_s=0.05)]):
        return ft.run_with_recovery(
            state, step_fn, get_batch, 12, ckpt,
            ft.Monitor(min_history=1000, hang_min_seconds=60.0), ckpt_every=CKPT_EVERY,
            plan=plan, straggler=ft.StragglerTimer(plan=plan, detector=det),
            policy=policy_cls(straggler="rebalance", max_restores=4), remesh=remesh)


@pytest.mark.parametrize("with_remesh", [False, True])
def test_rebalance_degrades_as_the_reference_without_a_pipeline(tmp_path, with_remesh):
    """``"rebalance"`` on a host-io straggler of a plan without a pipeline:
    both drivers degrade it to ``"remesh"`` when a remesh hook is wired (the
    hook then runs) and to ``"ignore"`` without one, with the same actions."""
    jw = _jax_world("dense")
    jremesh = w_remesh = None
    if with_remesh:
        jremesh = lambda: jft.RemeshSpec(train_step=jw[1], state_template=jw[3],  # noqa: E731
                                         plan=jw[0])
    _, jrep = _rebalance_run(jft, jinject, JPolicy, jw, JaxCheckpointManager(
        tmp_path / "ref", async_persist=False), jremesh)
    w = World()
    if with_remesh:
        w_remesh = lambda: RemeshSpec(train_step=w.step_fn, state_template=w.state(),  # noqa: E731
                                      plan=w.plan, mesh=DataMesh())
    final, rep = _rebalance_run(tft, tinject, RecoveryPolicy,
                                (w.plan, w.step_fn, w.get_batch, w.state()),
                                InlineCheckpointManager(tmp_path / "port"),
                                w_remesh)
    assert rep.actions == jrep.actions and rep.actions
    want = "remesh" if with_remesh else "ignore"
    assert {act for _, kind, act in rep.actions if kind == "straggler"} == {want}
    assert (rep.remeshes, rep.restores) == (jrep.remeshes, jrep.restores)
    assert jrep.rebalances == 0
    clean, _ = w.clean(12)
    assert_bits_equal(final.params, clean.params)
