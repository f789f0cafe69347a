"""The port's multi-rank examples on gloo CPU ranks, each spawned once in a
module fixture on the reference's weights carried over by ``interop``: the
three 8-rank examples one after another in one set of rank processes, as
``chip_smoke.py`` runs them, and ``straggler_rebalance.run`` on its 4.

- ``pipeline_multipod`` (8 ranks) against the reference's ``make_loss_fn`` and
  ``pipelined_loss_fn`` on the same weights and batches, run once in an
  8-device subprocess (as ``tests/conftest.py::run_multidevice`` runs one), at the
  example's limits: the non-pipelined loss and both schedules' within 2e-4,
  the 10 training steps' losses within 2e-4 of the reference's (its step is
  AdamW on whole grads, the port's ZeRO-1 over the data ranks: the same
  math), TP x PP and CP x TP x PP within 2e-5 of the pp-only loss on the
  trained params, and the MoE twin's two exchanges within 1e-6 of each other
  and 2e-5 of the reference's. 1F1B's forward saves fewer bytes than
  GPipe's.
- ``train_moe_ep`` (8 ranks, 3 of the recipe's 100 steps): the ep-only first
  step against the port's one process at 1e-6 (loss and grad norm), its loss
  against the reference's single-device loss at 1e-5, and the fold's
  blocking and overlap exchanges within 1e-6.
- ``serve_longcontext`` (8 ranks): every rank's greedy tokens and each decode
  step's logits against the reference's single-device ``prefill`` /
  ``decode_step`` on its rows, within 1e-5 of each logits tensor's max
  (``tests/test_torch_decode_grid.py``'s limit).
- ``straggler_rebalance`` (4 ranks): exactly one rebalance, to (3, 1), and the
  run completes, on every rank. The injected delay is 0.5 s a layer (the
  recipe's 0.04 s on the card): on a loaded host a step's own time must stay
  far below the factor 2, as in ``tests/test_torch_pp_ranks.py``.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from repro_torch.examples import (pipeline_multipod, serve_longcontext, straggler_rebalance,
                                  train_moe_ep)

torch.set_num_threads(1)

MOE_STEPS = 3
PP_LIMIT, TP_LIMIT, EP_LIMIT = (pipeline_multipod.PP_LIMIT, pipeline_multipod.TP_LIMIT,
                                pipeline_multipod.EP_LIMIT)
ONE_REL, REF_REL, LOGITS_REL = 1e-6, 1e-5, 1e-5
SLEEP_S = 0.5

PIPE_REF = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import Family, InputShape, ModelConfig, MoEConfig, ParallelPlan
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.optim import adamw_init, adamw_update, clip_by_global_norm
from repro.train import Hyper, make_loss_fn
from repro.train.pipeline import pipelined_loss_fn
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = ModelConfig("pipe-demo", Family.DENSE, n_layers=4, d_model=128, n_heads=4,
                  n_kv_heads=2, d_ff=256, vocab=512)
plan = ParallelPlan(remat="none", compute_dtype="float32", pp=2, microbatches=4,
                    tp_impl="gspmd")
ds = SyntheticDataset(cfg, InputShape("pipe", 64, 8, "train"))
model = build_model(cfg, ParallelPlan(remat="none", compute_dtype="float32"))
params = model.init(jax.random.PRNGKey(0))
out = {"dense": jax.tree.map(np.asarray, params)}
batch = {k: jnp.asarray(v) for k, v in ds.batch(0).items()}
out["ref_loss"] = float(make_loss_fn(model, Hyper(z_loss=0.0))(params, batch)[0])
for sched in ("gpipe", "1f1b"):
    lf = pipelined_loss_fn(cfg, dataclasses.replace(plan, pp_schedule=sched), mesh, ("data",))
    out[sched] = float(jax.jit(lf)(params, batch)[0])
pipe_loss_fn = pipelined_loss_fn(cfg, plan, mesh, ("data",))
grad_fn = jax.jit(jax.value_and_grad(lambda p, b: pipe_loss_fn(p, b)[0]))
opt, out["train"] = adamw_init(params), []
for i in range(10):
    batch = {k: jnp.asarray(v) for k, v in ds.batch(i).items()}
    loss, grads = grad_fn(params, batch)
    grads, _ = clip_by_global_norm(grads, 1.0)
    params, opt = adamw_update(grads, opt, params, 1e-3)
    out["train"].append(float(loss))
out["base_loss"] = float(jax.jit(pipe_loss_fn)(params, batch)[0])
moe_cfg = dataclasses.replace(cfg, family=Family.MOE, d_ff=0, moe=MoEConfig(
    num_experts=4, top_k=2, d_expert=128, num_shared_experts=1, capacity_factor=2.0))
moe_params = build_model(moe_cfg, ParallelPlan(remat="none", compute_dtype="float32")).init(
    jax.random.PRNGKey(1))
out["moe"] = jax.tree.map(np.asarray, moe_params)
cp_mesh = jax.make_mesh((2, 2, 2), ("pod", "cp", "model"))
cp_plan = dataclasses.replace(plan, tp=2, tp_impl="overlap", cp=2, cp_impl="ring")
for impl in ("blocking", "overlap"):
    ep_plan = dataclasses.replace(cp_plan, ep=4, ep_impl=impl)
    out["ep_" + impl] = float(jax.jit(pipelined_loss_fn(moe_cfg, ep_plan, cp_mesh, ()))(
        moe_params, batch)[0])
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _pipe_init():
    """The reference's seed-0 dense and seed-1 MoE-twin params, drawn in this
    process (one device) as the reference's subprocess draws them."""
    import jax
    from repro.core import Family, ModelConfig, MoEConfig
    from repro.core import ParallelPlan as RefPlan
    from repro.models import build_model as ref_build
    cfg = ModelConfig("pipe-demo", Family.DENSE, n_layers=4, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab=512)
    moe_cfg = dataclasses.replace(cfg, family=Family.MOE, d_ff=0, moe=MoEConfig(
        num_experts=4, top_k=2, d_expert=128, num_shared_experts=1, capacity_factor=2.0))
    plan = RefPlan(remat="none", compute_dtype="float32")
    return {name: jax.tree.map(np.asarray, ref_build(c, plan).init(jax.random.PRNGKey(seed)))
            for name, c, seed in (("dense", cfg, 0), ("moe", moe_cfg, 1))}


def _reference_subprocess(path):
    """The pipeline's reference in an 8-device subprocess (as
    ``tests/conftest.py::run_multidevice`` runs one), started, not waited for."""
    import os
    import subprocess
    import sys
    from conftest import SRC
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen([sys.executable, "-c", PIPE_REF, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything once, overlapped to keep the file short: the pipeline's
    reference subprocess and, in one spawn of 8 gloo ranks, the pipeline, MoE
    and serving examples one after another (as ``chip_smoke.py`` runs them),
    while this process computes the reference's and the port's one-process
    sides; then the straggler walkthrough's 4 ranks alone (its detector reads
    host time)."""
    import threading
    from repro_torch.examples import ranks as spawner
    path = tmp_path_factory.mktemp("pipe_ref") / "reference.pkl"
    proc = _reference_subprocess(path)
    try:
        pipe_init = _pipe_init()
        moe_params = _moe_params()
        serve_params = {arch: _serve_params(arch) for arch in serve_longcontext.ARCHS}
        jobs = [(pipeline_multipod.rank_job, {"init_params": pipe_init}),
                (train_moe_ep.rank_job, {"steps": MOE_STEPS, "init_params": moe_params}),
                (serve_longcontext.rank_job, {"init_params": serve_params})]
        box = {}

        def spawn():
            try:
                box["ranks"] = spawner.spawn(jobs, 8, "cpu", timeout=600)
            except BaseException as e:      # re-raised in the test process below
                box["error"] = e
        th = threading.Thread(target=spawn)
        th.start()
        moe_ref = _moe_one_sides(moe_params)
        serve_ref = {arch: _ref_serve(arch, serve_params[arch])
                     for arch in serve_longcontext.ARCHS}
        th.join()
        if "error" in box:
            raise box["error"]
        log = proc.communicate(timeout=600)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, f"the reference's subprocess failed:\n{log[-4000:]}"
    with open(path, "rb") as f:
        pipe_ref = pickle.load(f)
    for name in ("dense", "moe"):
        a, b = (jax_leaves(x[name]) for x in (pipe_ref, pipe_init))
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), name
    pipe, moe, serve = box["ranks"]
    return {"pipeline": (pipe_ref, pipe), "moe": (*moe_ref, moe), "serving": (serve_ref, serve),
            "straggler": straggler_rebalance.run(device="cpu", sleep_s=SLEEP_S)}


def jax_leaves(tree):
    import jax
    return jax.tree.leaves(tree)


@pytest.fixture(scope="module")
def pipeline(runs):
    return runs["pipeline"]


@pytest.fixture(scope="module")
def moe(runs):
    return runs["moe"]


@pytest.fixture(scope="module")
def serving(runs):
    return runs["serving"]


@pytest.fixture(scope="module")
def straggler(runs):
    return runs["straggler"]


def test_pipeline_losses_match_the_reference(pipeline):
    ref, ranks = pipeline
    for r in ranks:
        assert abs(r["ref_loss"] - ref["ref_loss"]) < PP_LIMIT
        for sched in ("gpipe", "1f1b"):
            assert abs(r["sched"][sched]["loss"] - ref[sched]) < PP_LIMIT, sched
        np.testing.assert_allclose(r["train"]["loss"], ref["train"], rtol=0, atol=PP_LIMIT)
        assert abs(r["base_loss"] - ref["base_loss"]) < PP_LIMIT


def test_pipeline_tp_cp_and_ep_inside_the_ticks(pipeline):
    ref, ranks = pipeline
    for r in ranks:
        assert abs(r["tp_loss"] - r["base_loss"]) < TP_LIMIT
        assert abs(r["cp_loss"] - r["base_loss"]) < TP_LIMIT
        assert abs(r["ep_loss"]["overlap"] - r["ep_loss"]["blocking"]) < EP_LIMIT
        for impl in ("blocking", "overlap"):
            assert abs(r["ep_loss"][impl] - ref["ep_" + impl]) < TP_LIMIT, impl


def test_pipeline_1f1b_saves_less_than_gpipe(pipeline):
    for r in pipeline[1]:
        assert r["sched"]["1f1b"]["saved_bytes"] < r["sched"]["gpipe"]["saved_bytes"]


def _moe_params():
    """The reference's seed-0 olmoe params (capacity 2.0), as numpy."""
    import jax
    from repro.core import ParallelPlan as RefPlan
    from repro.models import build_model as ref_build
    from repro.train import init_train_state as ref_init
    return jax.tree.map(np.asarray, ref_init(ref_build(_ref_moe_config(), RefPlan(
        remat="selective", compute_dtype="float32")), jax.random.PRNGKey(0)).params)


def _ref_moe_config():
    from repro.core import get_smoke_config as ref_smoke
    cfg = ref_smoke("olmoe-1b-7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))


def _moe_one_sides(params):
    """On batch 0 from ``params``: the reference's single-device loss, and the
    port's one process's first step (the recipe's plan at ep 1)."""
    import jax
    import jax.numpy as jnp
    from repro.core import ParallelPlan as RefPlan
    from repro.models import build_model as ref_build
    from repro.train import Hyper as RefHyper
    from repro.train import make_loss_fn as ref_loss_fn
    from repro_torch.core import InputShape
    from repro_torch.core.tree import leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, make_train_step
    cfg = train_moe_ep.moe_config()
    rmodel = ref_build(_ref_moe_config(), RefPlan(remat="selective", compute_dtype="float32"))
    batch = SyntheticDataset(cfg, InputShape("moe-ep", 64, 8, "train")).batch(0)
    ref_loss = float(ref_loss_fn(rmodel, RefHyper())(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})[0])
    plan = dataclasses.replace(train_moe_ep.ep_plan(), ep=1)
    model = build_model(cfg, plan, device="cpu")
    p = params_from_numpy(params, cfg, device="cpu")
    for x in leaves(p):
        x.requires_grad_(True)
    _, m = make_train_step(model, plan, train_moe_ep.hyper())(
        TrainState(p, adamw_init(p)), {k: torch.from_numpy(v) for k, v in batch.items()})
    return ref_loss, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def test_moe_ep_first_step_matches_one_process(moe):
    _, one, ranks = moe
    for r in ranks:
        for k in ("loss", "grad_norm"):
            assert abs(r[k][0] - one[k]) <= ONE_REL * abs(one[k]), (k, r[k][0], one[k])
        assert len(r["loss"]) == MOE_STEPS


def test_moe_ep_loss_matches_the_reference(moe):
    ref_loss, _, ranks = moe
    for r in ranks:
        assert abs(r["loss"][0] - ref_loss) <= REF_REL * abs(ref_loss), (r["loss"][0], ref_loss)
        assert r["moe_aux"][0] > 0


def test_moe_fold_exchanges_agree(moe):
    for r in moe[2]:
        assert abs(r["fold"]["overlap"] - r["fold"]["blocking"]) < train_moe_ep.FOLD_LIMIT
        assert np.isfinite(r["fold"]["overlap"])


def _ref_serve_model(arch):
    from repro.core import ParallelPlan as RefPlan
    from repro.core import get_smoke_config as ref_smoke
    from repro.models import build_model as ref_build
    cfg = ref_smoke(arch)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=64, long_context=True)
    return ref_build(cfg, RefPlan(remat="none", compute_dtype="float32"))


def _serve_params(arch):
    import jax
    return jax.tree.map(np.asarray, _ref_serve_model(arch).init(jax.random.PRNGKey(0)))


def _ref_serve(arch, params):
    """The reference's single-device serving of the recipe on ``params``:
    greedy tokens and each decode step's logits, the whole batch."""
    import jax
    import jax.numpy as jnp
    model = _ref_serve_model(arch)
    params = jax.tree.map(jnp.asarray, params)
    b, ctx = serve_longcontext.BATCH, serve_longcontext.MAX_CTX
    prompt = jnp.asarray(serve_longcontext.prompt_tokens(model.cfg), jnp.int32)
    step = jax.jit(model.decode_step)
    if "prefill" in model.extras:
        logits, cache = jax.jit(model.extras["prefill"], static_argnums=2)(
            params, {"tokens": prompt}, ctx)
        logits = logits[:, -1]
    else:
        cache = model.init_cache(b, ctx)
        for pos in range(serve_longcontext.PROMPT):
            logits, cache = step(params, cache, prompt[:, pos], jnp.int32(pos))
    tokens, steps = [], []
    pos = serve_longcontext.PROMPT
    for _ in range(serve_longcontext.GEN):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, jnp.int32(pos))
        steps.append(np.asarray(logits))
        pos += 1
    return np.stack(tokens, 1), steps


@pytest.mark.parametrize("arch", serve_longcontext.ARCHS)
def test_serving_matches_the_reference(serving, arch):
    ref, ranks = serving
    tokens, steps = ref[arch]
    for r in ranks:
        lo, hi = r[arch]["rows"]
        np.testing.assert_array_equal(r[arch]["tokens"], tokens[lo:hi])
        assert len(r[arch]["logits"]) == len(steps) == serve_longcontext.GEN
        for got, want in zip(r[arch]["logits"], steps):
            want = want[lo:hi]
            assert np.abs(got - want).max() <= LOGITS_REL * np.abs(want).max()


def test_serving_cache_is_sequence_sharded(serving):
    """gemma2's K/V cache: a rank's part is its data rows and its 1/4 of the
    positions; mamba2 holds no K/V cache."""
    for r in serving[1]:
        assert r["mamba2-370m"]["placement"] == {}
        for name in ("k", "v"):
            shape, spec = r["gemma2-9b"]["placement"][name]
            assert shape[1:3] == (serve_longcontext.BATCH // 2, serve_longcontext.MAX_CTX // 4)
            assert spec[2] == "model"


def test_straggler_rebalances_once(straggler):
    for rep in straggler:
        assert rep["steps_done"] == straggler_rebalance.STEPS
        assert rep["rebalances"] == 1 and rep["applied"] == [(3, 1)], rep
        assert rep["stragglers"] and "rank=1" in rep["stragglers"][0][1]
        assert any(k == "straggler" and a == "rebalance" for _, k, a in rep["actions"])
        assert all(np.isfinite(x) for x in rep["losses"])
        assert rep["actions"] == straggler[0]["actions"]
