"""The port's fault-tolerance units (``repro_torch.ft``) against the reference's
(``repro.ft``) on the same numpy inputs: the fault-point registry, the policy
table, ``FaultSpec.key``, ``corrupt_array``'s bits, the eager seams (``taint``,
``trace_with_faults``, the dispatchers, the remat replay), the integrity
checksum and the step's audit, and the detectors, recorder, preemption guard
and straggler pieces fed the reference tests' sequences."""

import dataclasses
import json
import os
import signal
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.core import RecoveryPolicy as JPolicy
from repro.core import config as jconfig
from repro.ft import inject as jinject
from repro.ft import integrity as jintegrity
from repro.ft import preempt as jpreempt
from repro.ft import straggler as jstraggler
from repro_torch import ft as tft
from repro_torch.core import ParallelPlan, RecoveryPolicy, get_smoke_config
from repro_torch.core import config as tconfig
from repro_torch.core.tree import leaves, map_tree
from repro_torch.ft import inject as tinject
from repro_torch.ft import integrity as tintegrity
from repro_torch.ft import preempt as tpreempt
from repro_torch.ft import straggler as tstraggler
from repro_torch.kernels import dispatch

torch.set_num_threads(1)

REPO_FT = ("__init__", "inject", "anomaly", "flight", "preempt", "integrity", "straggler",
           "recovery")


def _bits(x):
    """Raw bits of a jax/numpy or torch array, logical row-major order."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view({4: np.uint32, 8: np.uint64}[x.element_size()])
    a = np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# registry, policy, keys


def test_the_package_has_the_reference_modules_and_the_scan_sees_them():
    from test_torch_isolation import PORT_FILES
    root = tft.__file__.rsplit("/", 1)[0]
    for name in REPO_FT:
        assert f"{root}/{name}.py" in {str(p) for p in PORT_FILES}
    assert tft.__all__ == jft.__all__


def test_fault_points_kinds_and_policy_equal_the_reference():
    assert tinject.FAULT_POINTS == jinject.FAULT_POINTS
    assert len(tinject.FAULT_POINTS) == 13
    assert tinject.FAULT_KINDS == jinject.FAULT_KINDS
    assert tconfig.RECOVERY_ACTIONS == jconfig.RECOVERY_ACTIONS
    ours = {f.name: f.default for f in dataclasses.fields(RecoveryPolicy)}
    ref = {f.name: f.default for f in dataclasses.fields(JPolicy)}
    assert ours == ref
    ref_spec = {f.name: f.default for f in dataclasses.fields(jinject.FaultSpec)}
    assert {f.name: f.default for f in dataclasses.fields(tinject.FaultSpec)} == ref_spec


@pytest.mark.parametrize("bad", [dict(nan="reboot"), dict(max_restores=-1),
                                 dict(rescue_lr_scale=0.0), dict(ckpt_memory_keep=-1),
                                 dict(preempt_grace=0.0), dict(flight_len=0),
                                 dict(straggler_factor=1.0), dict(straggler_window=3),
                                 dict(straggler_confirm=0), dict(straggler_min_seconds=-1.0)])
def test_policy_validate_refuses_as_the_reference(bad):
    RecoveryPolicy().validate()
    for cls in (RecoveryPolicy, JPolicy):
        with pytest.raises(ValueError):
            cls(**bad).validate()


def test_policy_refuses_an_unmirrored_ram_tier():
    """The reference's RAM tier can skip its peer mirrors; the port's always
    writes them, so the policy refuses to say otherwise."""
    JPolicy(peer_redundancy=False).validate()
    with pytest.raises(ValueError, match="peer_redundancy"):
        RecoveryPolicy(peer_redundancy=False).validate()


def test_plan_integrity_knob_validated():
    cfg = get_smoke_config("qwen1.5-4b")
    assert ParallelPlan().integrity == "off"
    ParallelPlan(integrity="audit").validate(cfg)
    with pytest.raises(ValueError, match="integrity"):
        ParallelPlan(integrity="paranoid").validate(cfg)


def test_fault_spec_key_and_validation_equal_the_reference():
    for point in ("train.step", "kernel.attention", "integrity.checksum"):
        for step, seed in ((0, 0), (7, 3), (12, 1)):
            assert (tinject.FaultSpec(point, "nan", step=step, seed=seed).key()
                    == jinject.FaultSpec(point, "nan", step=step, seed=seed).key())
    for mod in (tinject, jinject):
        with pytest.raises(ValueError, match="unknown fault point"):
            mod.FaultSpec("no.such.point", "nan")
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultSpec("train.step", "gremlin")
        with pytest.raises(ValueError, match="span"):
            mod.FaultSpec("train.step", "slow", span=0)


# ---------------------------------------------------------------------------
# corrupt_array


@pytest.mark.parametrize("kind", ["bitflip", "nan", "spike"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("view", ["contiguous", "transposed"])
def test_corrupt_array_gives_the_reference_bits(kind, dtype, view):
    """The same spec on the same logical array: the same bits. A transposed
    view (the dispatchers return one) is corrupted at the logical element."""
    base = np.random.default_rng(0).standard_normal((6, 10)).astype(np.float32)
    logical = base.T if view == "transposed" else base
    x = torch.from_numpy(base).to(getattr(torch, dtype))
    x = x.t() if view == "transposed" else x
    for step, seed in ((5, 1), (12, 0)):
        ours = tinject.corrupt_array(x, tinject.FaultSpec("kernel.attention", kind, step=step,
                                                          seed=seed))
        ref = jinject.corrupt_array(jnp.asarray(np.ascontiguousarray(logical)).astype(dtype),
                                    jinject.FaultSpec("kernel.attention", kind, step=step,
                                                      seed=seed))
        assert np.array_equal(_bits(ours), _bits(ref))
        changed = int((_bits(ours) != _bits(x)).sum())
        assert changed == (60 if kind == "spike" else 1)


def test_corrupt_array_non_float_and_rank_mask():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    ref = jinject.corrupt_array(jnp.arange(12, dtype=jnp.int32).reshape(3, 4),
                                jinject.FaultSpec("train.step", "bitflip", step=1))
    ours = tinject.corrupt_array(x, tinject.FaultSpec("train.step", "bitflip", step=1))
    assert np.array_equal(ours.numpy(), np.asarray(ref))     # the x * scale fallback
    masked = tinject.FaultSpec("integrity.checksum", "nan", rank=1, axis="data")
    y = torch.ones(4)
    assert tinject.corrupt_array(y, masked, rank=0) is y
    assert torch.isnan(tinject.corrupt_array(y, masked, rank=1)).sum() == 1
    with pytest.raises(ValueError, match="rank"):
        tinject.corrupt_array(y, masked)


def test_corrupt_array_gradients():
    """The reference's gradients: spike scales them, nan zeroes its element's
    (.at[].set), bitflip passes none (a bitcast)."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    for kind in ("spike", "nan", "bitflip"):
        sp = tinject.FaultSpec("train.step", kind, step=2, scale=8.0)
        out = tinject.corrupt_array(x, sp)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(out), out, 0).sum(), x)
        ref = jax.grad(lambda a: jnp.where(jnp.isfinite(c := jinject.corrupt_array(
            a, jinject.FaultSpec("train.step", kind, step=2, scale=8.0))), c, 0).sum())(
            jnp.asarray(x.detach().numpy()))
        assert np.array_equal(g.numpy(), np.asarray(ref))
        assert int((g == 0).sum()) == {"spike": 0, "nan": 1, "bitflip": 15}[kind]


# ---------------------------------------------------------------------------
# taint, trace_with_faults, the dispatchers


def test_taint_is_identity_unarmed_and_refuses_unknown_points():
    x = torch.ones(3)
    assert tinject.taint("tp.ring.tick", x) is x
    with pytest.raises(ValueError, match="unknown fault point"):
        tinject.taint("not.registered", x)


def test_trace_with_faults_twin_is_built_without_running_fn():
    calls = []

    def fn(x):
        calls.append(1)
        return tinject.taint("tp.ring.tick", x) * 2.0

    spec = tinject.FaultSpec("tp.ring.tick", "nan", step=0, tick=None)
    outer = tinject.FaultSpec("ckpt.shard_write", "drop_write", step=3)
    twin = tinject.trace_with_faults(fn, specs=[spec])
    assert calls == []                            # not run at build time
    with tinject.armed([outer]):
        for _ in range(2):                        # fires on every call
            assert torch.isnan(twin(torch.ones(4))).sum() == 1
        assert tinject.CONTROLLER._specs == [outer]   # an outer arming survives
    assert not tinject.CONTROLLER._specs and calls == [1, 1]
    assert not torch.isnan(fn(torch.ones(4))).any()   # the clean function is clean


def _dispatch_cases():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 8, generator=g)
    x, w = torch.randn(2, 4, 8, generator=g), torch.randn(2, 8, 8, generator=g)
    xs, B = torch.randn(1, 8, 2, 4, generator=g), torch.randn(1, 8, 1, 4, generator=g)
    dt, A = torch.full((1, 8, 2), 0.1), -torch.ones(2)
    return {
        "attention": ("kernel.attention", dispatch.dispatch_attention, (q, q, q),
                      dict(impl="plain"), jinject, "dispatch_attention"),
        "expert_gemm": ("kernel.expert_gemm", dispatch.dispatch_expert_gemm, (x, w),
                        dict(impl="plain"), None, "dispatch_expert_gemm"),
        "ssd": ("kernel.ssd", dispatch.dispatch_ssd_scan, (xs, dt, A, B, B),
                dict(chunk=4, impl="plain"), None, "dispatch_ssd_scan"),
    }


@pytest.mark.parametrize("which", ["attention", "expert_gemm", "ssd"])
def test_dispatcher_fault_points(which):
    """Unarmed, each dispatcher returns the undecorated call's bits; armed
    with nan, exactly one element of its output (the first of a tuple) is NaN,
    where the reference's twin puts it on the same inputs."""
    point, fn, args, kw, _, name = _dispatch_cases()[which]
    clean = fn(*args, **kw)
    raw = fn.__wrapped__(*args, **kw)
    first = lambda o: o[0] if isinstance(o, tuple) else o        # noqa: E731
    assert torch.equal(first(clean), first(raw))
    twin = tinject.trace_with_faults(lambda: fn(*args, **kw), specs=[
        tinject.FaultSpec(point, "nan", step=0, tick=None)])
    bad = first(twin())
    assert int(torch.isnan(bad).sum()) == 1
    from repro.kernels import dispatch as jdispatch
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jkw = {**kw, "impl": "xla"}
    jtwin = jinject.trace_with_faults(lambda: getattr(jdispatch, name)(*jargs, **jkw),
                                      specs=[jinject.FaultSpec(point, "nan", step=0,
                                                               tick=None)])
    jbad = np.asarray(first(jtwin()))
    assert np.array_equal(torch.isnan(bad).numpy(), np.isnan(jbad))


def _smoke_world(remat):
    """The port's qwen1.5-4b smoke model under ``remat`` from the reference's
    seed-0 weights, and the reference model, with the first batch."""
    from repro.core import InputShape, ParallelPlan as JPlan, get_smoke_config as jsmoke
    from repro.data import SyntheticDataset
    from repro.models import build_model as jbuild
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    jcfg, tcfg = jsmoke("qwen1.5-4b"), get_smoke_config("qwen1.5-4b")
    jmodel = jbuild(jcfg, JPlan(remat="none", compute_dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for p in leaves(tparams):
        p.requires_grad_(True)
    tmodel = build_model(tcfg, ParallelPlan(compute_dtype="float32", remat=remat),
                         device="cpu")
    batch = SyntheticDataset(jcfg, InputShape("t", 16, 4, "train")).batch(0)
    return (jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, tmodel, tparams,
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_tainted_forward_matches_the_reference_twin():
    """kernel.attention spiked on every call (tick=None) through a smoke
    model's loss: the port's eager twin against the reference's traced twin,
    to the loss's existing 1e-6 (tests/test_torch_train.py)."""
    from repro.train import Hyper as JHyper, make_loss_fn as jloss
    from repro_torch.train import Hyper, make_loss_fn
    jmodel, jparams, jb, tmodel, tparams, tb = _smoke_world("none")
    spec = dict(point="kernel.attention", kind="spike", step=3, scale=8.0, tick=None)
    jtwin = jinject.trace_with_faults(lambda p, b: jloss(jmodel, JHyper())(p, b)[0],
                                      jparams, jb, specs=[jinject.FaultSpec(**spec)])
    twin = tinject.trace_with_faults(lambda p, b: make_loss_fn(tmodel, Hyper())(p, b)[0],
                                     specs=[tinject.FaultSpec(**spec)])
    ref, ours = float(jtwin(jparams, jb)), twin(tparams, tb).item()
    clean = make_loss_fn(tmodel, Hyper())(tparams, tb)[0].item()
    assert ours == pytest.approx(ref, rel=1e-6)
    assert abs(ours - clean) > 1e-3                # the fault changed the loss


def _tainted_grads(remat, spec):
    """Loss, grads and fired faults of one tainted forward and its backward
    on the smoke model under ``remat``. The twin arms the forward only; the
    backward (whose recompute calls the dispatcher again under "full") runs
    after it has disarmed."""
    from repro_torch.train import Hyper, make_loss_fn
    *_, tmodel, tparams, tb = _smoke_world(remat)
    loss_fn = make_loss_fn(tmodel, Hyper())
    twin = tinject.trace_with_faults(lambda: loss_fn(tparams, tb)[0], specs=[spec])
    n = len(tinject.CONTROLLER.fired)
    loss = twin()
    assert not tinject.CONTROLLER._specs
    loss.backward()
    grads = [p.grad.clone() for p in leaves(tparams)]
    return loss.item(), grads, tinject.CONTROLLER.fired[n:], loss_fn(tparams, tb)[0].item()


def _grads_close(a, b, rel=1e-6):
    return all(float((x - y).abs().max()) <= rel * max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


@pytest.mark.parametrize("kind", ["bitflip", "spike"])
def test_remat_full_replays_the_forward_corruption(kind):
    """The same tainted step (the second attention call: one element
    bit-flipped, or the whole output spiked x8) under remat "full" and
    "none": equal loss and grads to 1e-6. The full recompute must corrupt the
    same call the same way, or its grads belong to another forward (the
    bitflip's huge element has ~0 gradient through the next norm, so the
    spike is the case that shows it: test_remat_full_without_the_replay)."""
    spec = tinject.FaultSpec("kernel.attention", kind, step=4, seed=2, tick=1, scale=8.0)
    none, full = _tainted_grads("none", spec), _tainted_grads("full", spec)
    assert none[0] != none[3]                        # the fault changed the loss
    assert full[0] == pytest.approx(none[0], rel=1e-6)
    assert _grads_close(full[1], none[1])
    assert full[2] == none[2] == [("kernel.attention", kind, 4)]


def test_remat_full_without_the_replay(monkeypatch):
    """Without the replay (the executor's context_fn made a no-op) the
    recompute of the spiked call runs clean: it saves one tensor fewer than
    the forward did, and torch's checkpoint refuses the backward. (A
    corruption that saves as many tensors, the bitflip's, passes that check
    silently with the clean recompute's grads.)"""
    from contextlib import nullcontext
    from repro_torch.train import executor
    spec = tinject.FaultSpec("kernel.attention", "spike", step=4, tick=1, scale=8.0)
    monkeypatch.setattr(executor, "remat_context", lambda: (nullcontext(), nullcontext()))
    with pytest.raises(torch.utils.checkpoint.CheckpointError, match="number of tensors"):
        _tainted_grads("full", spec)


def test_make_injector_corrupts_the_live_params_once():
    params = {"w": torch.ones(4, 4, requires_grad=True)}
    state = types.SimpleNamespace(params=params)
    inj = tinject.make_injector([tinject.FaultSpec("train.step", "nan", step=3, times=1)])
    assert inj(3, state) is state
    assert params["w"].is_leaf and torch.isnan(params["w"]).sum() == 1
    params["w"].data.fill_(1.0)
    inj(3, state)                                  # times=1: the second pass is clean
    assert not torch.isnan(params["w"]).any()


# ---------------------------------------------------------------------------
# integrity


def test_tree_checksum_equals_the_reference_on_each_leaf_type():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((7, 5)).astype(np.float32)
    bf = f32.astype(jnp.bfloat16)
    i32 = rng.integers(-2**31, 2**31 - 1, (9,), dtype=np.int64).astype(np.int32)
    f64 = rng.standard_normal(6)
    i64 = rng.integers(-2**31, 2**31 - 1, (5,), dtype=np.int64)
    i8 = rng.integers(-128, 127, (11,), dtype=np.int8)
    trees = [
        ({"a": jnp.asarray(f32)}, {"a": torch.from_numpy(f32)}),
        ({"b": jnp.asarray(bf)}, {"b": torch.from_numpy(f32).bfloat16()}),
        ({"c": jnp.asarray(i32)}, {"c": torch.from_numpy(i32)}),
        ({"d": jnp.asarray(f64)}, {"d": torch.from_numpy(f64)}),
        ({"e": jnp.asarray(i64)}, {"e": torch.from_numpy(i64)}),
        ({"f": jnp.asarray(i8), "g": 7, "h": 2.5},
         {"f": torch.from_numpy(i8), "g": 7, "h": 2.5}),
    ]
    for jt, tt in trees:
        assert int(tintegrity.tree_checksum(tt)) == int(jintegrity.tree_checksum(jt))
    flipped = f32.copy()
    flipped.reshape(-1).view(np.uint32)[17] ^= 1    # the lowest mantissa bit shows
    assert int(tintegrity.tree_checksum({"a": torch.from_numpy(flipped)})) != \
        int(tintegrity.tree_checksum({"a": torch.from_numpy(f32)}))


def test_tree_checksum_of_a_converted_param_tree():
    """The reference's stacked smoke params and the port's per-layer tree of
    the same weights: one checksum (the sum does not see the layout)."""
    jmodel, jparams, _, _, tparams, _ = _smoke_world("none")
    assert int(tintegrity.tree_checksum(tparams)) == int(jintegrity.tree_checksum(jparams))


def test_replica_divergence_without_a_mesh_is_zero():
    tree = {"w": torch.ones(8)}
    cs, div = tintegrity.replica_divergence(tree)
    jcs, jdiv = jintegrity.replica_divergence({"w": jnp.ones((8,))})
    assert float(div) == float(jdiv) == 0.0 and int(cs) == int(jcs)


def test_audit_metrics_single_process():
    """plan.integrity = "audit" on one process: divergence 0.0 and the
    checksum of the new params and the clipped grads."""
    from repro_torch.train import Hyper, TrainState, make_train_step
    from repro_torch.optim import adamw_init
    *_, tmodel, tparams, tb = _smoke_world("none")
    plan = ParallelPlan(compute_dtype="float32", remat="none", integrity="audit")
    state, m = make_train_step(tmodel, plan, Hyper())(TrainState(tparams, adamw_init(tparams)),
                                                     tb)
    assert float(m["integrity_div"]) == 0.0
    grads = map_tree(lambda p: p.grad, state.params)
    want = tintegrity.tree_checksum({"params": state.params, "grads": grads})
    assert int(m["integrity_checksum"]) == int(want)
    jcs = jintegrity.tree_checksum({"params": jax.tree.map(lambda p: jnp.asarray(
        p.detach().numpy()), state.params), "grads": jax.tree.map(lambda g: jnp.asarray(
            g.numpy()), grads)})
    assert int(m["integrity_checksum"]) == int(jcs)


# ---------------------------------------------------------------------------
# Monitor, FlightRecorder, preemption, stragglers: the reference tests'
# sequences through both packages


def _monitor_trace(ft):
    """The reference tests' Monitor sequences (test_checkpoint_ft, test_chaos,
    test_elastic, test_straggler): every record's anomaly and the windows."""
    out = []
    m = ft.Monitor(min_history=4)
    for s in range(8):
        out.append(m.record(s, 2.0 + 0.01 * s, 1.0, now=float(s)))
    out += [m.record(8, float("nan"), 1.0, now=8.0), m.record(9, 50.0, 1.0, now=9.0),
            m.record(10, 2.1, 1.0, now=10.0)]
    m = ft.Monitor(min_history=4, hang_factor=5.0)
    t = 0.0
    for s in range(8):
        m.record(s, 2.0, 1.0, now=t)
        t += 1.0
    out += [m.record(8, 2.0, 1.0, now=t + 30.0), m.record(9, 2.0, 1.0, now=t + 61.0)]
    out.append(sorted(m.times))
    m.reset_heartbeat(now=t + 120.0)
    out.append(m.record(10, 2.0, 1.0, now=t + 121.0))
    m = ft.Monitor()
    out += [m.record(0, float("inf"), 1.0, now=0.0), m.record(1, 2.0, float("-inf"), now=0.0),
            len(m.losses)]
    m = ft.Monitor(min_history=2, hang_min_seconds=10.0)
    t = 0.0
    for s in range(6):
        out.append(m.record(s, 2.0, 1.0, now=t))
        t += 0.01
    out.append(m.record(6, 2.0, 1.0, now=t + 1.0))
    m = ft.Monitor(min_history=2, hang_factor=4.0, hang_min_seconds=1e-3)
    for s, now in enumerate((100.0, 110.0, 110.1, 110.2, 110.7)):
        out.append(m.record(s, 1.0, 1.0, now=now))
    out.append(m.note("sdc", 5, "integrity_div=3.0"))
    return [dataclasses.astuple(a) if dataclasses.is_dataclass(a) else a for a in out]


def test_monitor_matches_the_reference():
    ours, ref = _monitor_trace(tft), _monitor_trace(jft)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a == pytest.approx(b) if isinstance(a, list) else a == b


def test_flight_recorder_matches_the_reference(tmp_path):
    dumps = []
    for ft in (tft, jft):
        fl = ft.FlightRecorder(maxlen=8, path=str(tmp_path / f"{ft.__name__}.json"))
        for i in range(20):
            fl.record("step", i, loss=float(i))
        fl.record("step", 20, loss=float("nan"), grad_norm=float("inf"),
                  arr=np.float32(2.5), n=np.int64(3))
        d = json.loads(open(fl.dump("test", extra={"step": 20})).read())
        for k in ("wall_time", "run_seconds"):
            d.pop(k)
        for e in d["events"]:
            e.pop("t")
        dumps.append(d)
        assert ft.FlightRecorder(maxlen=2).dump("x") is None
    assert dumps[0] == dumps[1]
    assert dumps[0]["n_events"] == 8 and dumps[0]["events"][-1]["loss"] == "nan"
    fl = tft.FlightRecorder(maxlen=4, path=str(tmp_path / "t.json"))
    fl.record("step", 0, loss=torch.tensor(float("inf")), k=torch.tensor(3))
    e = json.loads(open(fl.dump("tensor")).read())["events"][0]
    assert e["loss"] == "inf" and e["k"] == 3       # 0-d tensors sanitised


class _FakeCkpt:
    def __init__(self, snap, d2h, persist):
        self.snapshot_seconds, self.d2h_seconds, self.persist_seconds = snap, d2h, persist


def test_preemption_units_match_the_reference(tmp_path):
    for pre in (tpreempt, jpreempt):
        before = signal.getsignal(signal.SIGTERM)
        with pre.PreemptionGuard(grace=5.0) as g:
            assert signal.getsignal(signal.SIGTERM) == g._handler and not g.requested
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.time() + 2.0
            while not g.requested and time.time() < deadline:
                time.sleep(0.01)
            assert g.requested and g.signum == signal.SIGUSR1 and 0.0 < g.remaining() <= 5.0
        assert signal.getsignal(signal.SIGTERM) == before
        g = pre.PreemptionGuard(grace=30.0, signals=())
        assert g.remaining() == 30.0
        g.trigger()
        tiers = [pre.choose_tier(g, _FakeCkpt(*c), m) for c, m in (
            ((0.1, 0.1, 0.5), object()), ((10.0, 10.0, 50.0), object()),
            ((10.0, 10.0, 50.0), None), ((0.0, 0.0, 0.0), object()))]
        assert tiers == ["disk", "memory", "disk", "disk"]
        d = tmp_path / pre.__name__
        assert pre.read_marker(d) is None
        pre.write_marker(d, step=17, tier="disk", signum=15, flight_path="f.json")
        mk = pre.read_marker(d)
        assert (mk["step"], mk["tier"], mk["signum"], mk["flight"]) == (17, "disk", 15, "f.json")
        pre.clear_marker(d)
        assert pre.read_marker(d) is None
        pre.marker_path(d).write_text("{ not json")
        assert pre.read_marker(d) is None


def _straggler_trace(st, inject, plan_cls):
    """The reference tests' detector, timer, layout and slow-spec sequences
    (test_straggler.py) through one package's modules."""
    out = []
    sp = inject.FaultSpec("pp.stage.tick", "slow", step=5, span=3, rank=1, sleep_s=0.01)
    with inject.armed([sp]):
        out.append([inject.slow_spec_for("pp.stage.tick", s, rank=r) is sp
                    for s, r in ((4, 1), (5, 1), (7, 1), (8, 1), (6, 0))])
        out.append(inject.slow_spec_for("data.fetch", 6, rank=1))
    sp = inject.FaultSpec("cp.ring.kv", "slow", step=0, span=1000, sleep_s=0.01)
    with inject.armed([sp]):
        out.append([inject.slow_spec_for("cp.ring.kv", 3, rank=r) is sp for r in (0, 7, None)])
    det = st.StragglerDetector(factor=2.0, confirm=3, min_seconds=1e-3)
    out.append([det.observe_group("pp.stage", s, {0: 0.01, 1: 0.01, 2: 0.01, 3: 0.05})
                for s in range(5)])
    det = st.StragglerDetector(factor=2.0, confirm=3, min_seconds=1e-3)
    slow, ok = {0: 0.01, 1: 0.05}, {0: 0.01, 1: 0.01}
    out.append([det.observe_group("tp.ring", s, x)
                for s, x in enumerate((slow, slow, ok, slow, slow, slow))])
    det = st.StragglerDetector(factor=2.0, confirm=1, min_seconds=1e-3)
    out.append([det.observe_group("pp.stage", s, {0: 0.03, 1: 0.01}, weights={0: 3.0, 1: 1.0})
                for s in range(6)])
    out.append(det.observe_group("pp.stage", 9, {0: 0.03, 1: 0.025}, weights={0: 3.0, 1: 1.0}))
    det = st.StragglerDetector(factor=2.0, confirm=1, min_seconds=1e-3, min_history=3)
    out.append([det.observe("step.compute", None, t, s)
                for s, t in enumerate((10.0, 0.01, 0.01, 0.01, 0.01, 0.05))])
    det.reset()
    out.append(det.observe("step.compute", None, 10.0, 6))
    det = st.StragglerDetector(window=16, confirm=3)
    for s in range(13):
        det.observe_group("pp.stage", s, {0: 0.01, 1: 0.07 if s >= 10 else 0.01})
    out.append(det.recent("pp.stage"))
    out += [st.choose_pp_layout(t, lay) for t, lay in (
        ({0: 1.0, 1: 2.0}, (2, 2)), ({0: 2.0, 1: 1.0}, (2, 2)), ({0: 1.0, 1: 1.0}, (2, 2)),
        ({0: 3.0, 1: 3.0}, (3, 1)), ({0: 3.0, 1: 1.0}, (3, 1)), ({}, (2, 2)),
        ({0: 1.0, 1: 1000.0}, (4, 4)))]
    cfg = types.SimpleNamespace(n_layers=4)
    out += [st.effective_layout(p, c) for p, c in (
        (plan_cls(), cfg), (types.SimpleNamespace(pp=2, pp_layout=None), cfg),
        (types.SimpleNamespace(pp=2, pp_layout=(3, 1)), None), (None, None))]
    det = st.StragglerDetector(factor=2.0, confirm=1, min_seconds=1e-3, min_history=2)
    timer = st.StragglerTimer(detector=det)
    for s in range(4):
        with timer.section("data.fetch", s):
            pass
    with inject.armed([inject.FaultSpec("data.fetch", "slow", step=4, span=2, sleep_s=0.02)]):
        with timer.section("data.fetch", 4):
            pass
    out.append(timer.after_step(4, 0.001))
    timer = st.StragglerTimer(cfg=cfg, plan=types.SimpleNamespace(pp=2, pp_layout=None),
                              detector=st.StragglerDetector(factor=2.0, confirm=2,
                                                            min_seconds=1e-3))
    with inject.armed([inject.FaultSpec("pp.stage.tick", "slow", step=0, span=100, rank=1,
                                        sleep_s=0.01)]):
        out += [timer.after_step(0, 0.004), timer.after_step(1, 0.004)]
    out.append(st.choose_pp_layout(timer.stage_times(), (2, 2)))
    timer = st.StragglerTimer(plan=types.SimpleNamespace(cp=2), detector=st.StragglerDetector(
        factor=2.0, confirm=2, min_seconds=1e-3))
    with inject.armed([inject.FaultSpec("cp.ring.kv", "slow", step=0, span=100, rank=1,
                                        sleep_s=0.02)]):
        out += [timer.after_step(0, 0.004), timer.after_step(1, 0.004)]
    return out


def _shape(x):
    """A comparable form: a Straggler event as its attribution (slowdowns are
    measured wall time), tuples of floats approximately."""
    if isinstance(x, list):
        return [_shape(v) for v in x]
    if isinstance(x, dict):
        return {k: round(v, 3) for k, v in x.items()}
    if hasattr(x, "section") and hasattr(x, "cls"):
        return (x.rank, x.section, x.cls, x.step, x.slowdown > 2.0)
    return x


def test_straggler_pieces_match_the_reference():
    ours = _shape(_straggler_trace(tstraggler, tinject, ParallelPlan))
    ref = _shape(_straggler_trace(jstraggler, jinject, jconfig.ParallelPlan))
    assert ours == ref
    assert tstraggler.SECTION_CLASSES == jstraggler.SECTION_CLASSES
    assert tstraggler.SECTION_POINTS == jstraggler.SECTION_POINTS
    assert tstraggler.effective_layout(ParallelPlan(), get_smoke_config("qwen1.5-4b")) is None
