"""The port's single-device training step against the JAX reference: the loss,
clipping, schedule and AdamW pieces, the loss gradients of three smoke configs
from converted weights, one whole step, microbatching and remat, the synthetic
data, and a 20-step loss trajectory of the quickstart recipe."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import InputShape, ParallelPlan, get_smoke_config
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro.train import Hyper, cross_entropy, init_train_state, make_loss_fn, make_train_step
from repro_torch import optim as topt
from repro_torch.core import InputShape as TorchShape
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.data import SyntheticDataset as TorchDataset
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as torch_build_model
from repro_torch.core.tree import leaves
from repro_torch import train as ttrain

torch.set_num_threads(1)

SHAPE = ("t", 16, 4, "train")      # seq 16, batch 4


def _np(x):
    return np.asarray(x, np.float32)


def _configs(arch):
    cfgs = [get_smoke_config(arch), torch_smoke_config(arch)]
    if cfgs[0].sliding_window:
        cfgs = [dataclasses.replace(c, sliding_window=4) for c in cfgs]
    return cfgs


def _setup(arch, remat="none", microbatches=1, shape=SHAPE, seed=0):
    """The reference model and params, the port's model and the same params
    converted (fp32, autograd leaves), and the first batch in both forms."""
    jcfg, tcfg = _configs(arch)
    model = build_model(jcfg, ParallelPlan(remat="none", compute_dtype="float32"))
    params = model.init(jax.random.PRNGKey(seed))
    plan = TorchPlan(compute_dtype="float32", remat=remat, microbatches=microbatches)
    tmodel = torch_build_model(tcfg, plan, device="cpu")
    tparams = _to_torch(params, tcfg)
    batch = SyntheticDataset(jcfg, InputShape(*shape)).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, tcfg, model, params, tmodel, tparams, plan, jb, tb


def _to_torch(tree, cfg):
    out = params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device="cpu")
    for p in leaves(out):
        p.requires_grad_(True)
    return out


def _assert_trees_close(ours, ref, rel):
    """Each leaf within ``rel`` of its own largest |value|."""
    for o, r in zip(leaves(ours), leaves(ref)):
        r = r.detach().float()
        err = (o.detach().float() - r).abs().max().item()
        assert err <= rel * max(r.abs().max().item(), 1e-30), (err, tuple(r.shape))


def _port_grads(tmodel, tparams, tb, hyper=Hyper()):
    loss, _ = ttrain.make_loss_fn(tmodel, ttrain.Hyper(*hyper))(tparams, tb)
    return loss, torch.autograd.grad(loss, leaves(tparams))


# -- pieces -----------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_cross_entropy_matches_reference(reduction):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    kw = dict(z_loss=1e-3, reduction=reduction)
    ref = cross_entropy(jnp.asarray(logits), jnp.asarray(labels), **kw)
    lt = torch.from_numpy(logits).requires_grad_()
    ours = ttrain.cross_entropy(lt, torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(ours.detach().numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    gref = jax.grad(lambda x: cross_entropy(x, jnp.asarray(labels), **kw).sum())(
        jnp.asarray(logits))
    (g,) = torch.autograd.grad(ours.sum(), lt)
    np.testing.assert_allclose(g.numpy(), _np(gref), rtol=1e-6, atol=1e-6)
    acc = ttrain.top1_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert acc.item() == pytest.approx(float((logits.argmax(-1) == labels).mean()))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])       # clipped / untouched
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32)]}
    ref, rnorm = clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    ours, norm = topt.clip_by_global_norm(
        {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])]},
        max_norm)
    assert norm.item() == pytest.approx(float(rnorm), rel=1e-6)
    np.testing.assert_allclose(ours["a"].numpy(), _np(ref["a"]), rtol=1e-6)
    np.testing.assert_allclose(ours["b"][0].numpy(), _np(ref["b"][0]), rtol=1e-6)


def test_cosine_schedule_matches_reference():
    for step in range(251):
        ref = float(cosine_schedule(jnp.int32(step), 5e-3, 20, 200))
        assert topt.cosine_schedule(step, 5e-3, 20, 200) == pytest.approx(ref, rel=1e-6)


def test_adamw_update_matches_reference():
    """Two steps from nonzero moments; the 1-D leaf takes no decay."""
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 4), "bias": (4,)}
    p, g1, g2 = ({k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
                 for _ in range(3))
    jp = jax.tree.map(jnp.asarray, p)
    js = adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = topt.adamw_init(tp)
    for g, lr in ((g1, 1e-2), (g2, 3e-3)):
        jp, js = adamw_update(jax.tree.map(jnp.asarray, g), js, jp, lr, weight_decay=0.1)
        tp, ts = topt.adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                                   tp, lr, weight_decay=0.1)
    assert ts.step == int(js.step) == 2
    for k in shapes:
        for ours, ref in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            np.testing.assert_allclose(ours.numpy(), _np(ref), rtol=1e-6, atol=1e-7)


def test_synthetic_dataset_is_bit_identical():
    for arch, shape in (("qwen1.5-4b", ("q", 64, 8, "train")),
                        ("pixtral-12b", ("p", 40, 2, "train"))):
        ref = SyntheticDataset(get_smoke_config(arch), InputShape(*shape), seed=3)
        ours = TorchDataset(torch_smoke_config(arch), TorchShape(*shape), seed=3)
        for step in (0, 5):
            rb, ob = ref.batch(step), ours.batch(step)
            assert rb.keys() == ob.keys()
            for k in rb:
                assert rb[k].dtype == ob[k].dtype and np.array_equal(rb[k], ob[k]), k


# -- the model's gradients and the step ---------------------------------------

# fp32 through two layers, fp32 logits and the loss: the frameworks sum in other
# orders, so each grad leaf agrees to ~2e-6 of its largest value (measured
# 2.4e-6 at worst); 1e-5 is the limit.
GRAD_REL = 1e-5


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2.5-14b", "gemma2-9b", "pixtral-12b",
                                  "codeqwen1.5-7b"])
def test_loss_grads_match_reference(arch):
    jcfg, tcfg, model, params, tmodel, tparams, _, jb, tb = _setup(arch)
    loss_fn = make_loss_fn(model, Hyper())
    ref_loss, ref = jax.value_and_grad(lambda p: loss_fn(p, jb)[0])(params)
    loss, grads = _port_grads(tmodel, tparams, tb)
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-6)
    _assert_trees_close(grads, leaves(_to_torch(ref, tcfg)), GRAD_REL)


B1 = 0.9                           # AdamW's first-moment decay (both packages)


def _step_within_bound(new, ref_new, mu, ref_mu, lr, eps=1e-8):
    """Whether each param after the first AdamW step agrees with the
    reference's to lr * (1e-4 + the update's sensitivity to the frameworks'
    gradient difference). At step 0, u = g / (|g| + eps) and du/dg =
    eps / (|g| + eps)^2, largest at the smaller |g|; each element's real
    gradient difference is known, since mu = (1 - b1) g at step 0: it is
    |mu - mu_ref| / (1 - b1). Where the two signs differ, u passes through
    g = 0, so the sensitivity is taken there."""
    for o, r, m, rm in zip(leaves(new), leaves(ref_new), leaves(mu), leaves(ref_mu)):
        g, rg = m / (1.0 - B1), rm / (1.0 - B1)
        diff = (g - rg).abs()
        small = torch.where(torch.sign(g) == torch.sign(rg),
                            torch.minimum(g.abs(), rg.abs()), torch.zeros_like(g))
        tol = lr * (1e-4 + eps * diff / (small + eps) ** 2)
        if not ((o.detach() - r.detach()).abs() <= tol).all():
            return False
    return True


def _first_steps():
    """One whole step (clip + AdamW at step 0) in both packages from the same
    weights and batch: the port's state and metrics, the reference's."""
    jcfg, tcfg, model, params, tmodel, tparams, plan, jb, tb = _setup("qwen1.5-4b")
    hyper = Hyper(peak_lr=1e-3, warmup_steps=2)
    state, metrics = make_train_step(model, ParallelPlan(remat="none",
                                                         compute_dtype="float32"),
                                     hyper)(init_train_state(model, jax.random.PRNGKey(0)), jb)
    tstate, tmetrics = ttrain.make_train_step(tmodel, plan, ttrain.Hyper(*hyper))(
        ttrain.TrainState(tparams, topt.adamw_init(tparams)), tb)
    return tcfg, tstate, tmetrics, state, metrics


def test_train_step_matches_reference():
    """One whole step (clip + AdamW at step 0): params, moments and metrics."""
    tcfg, tstate, tmetrics, state, metrics = _first_steps()
    for name in ("loss", "grad_norm", "lr"):
        assert float(tmetrics[name]) == pytest.approx(float(metrics[name]), rel=1e-5)
    # On this first step AdamW moves each param by lr * u, u = g / (|g| + eps):
    # lr * sign(g), except where |g| is within a few hundred eps of 0, where the
    # frameworks' fp32 gradient difference moves u by far more than its own
    # relative size (_step_within_bound).
    ref_mu = _to_torch(state.opt.mu, tcfg)
    assert _step_within_bound(tstate.params, _to_torch(state.params, tcfg),
                              tstate.opt.mu, ref_mu, float(metrics["lr"]))
    _assert_trees_close(tstate.opt.mu, leaves(ref_mu), GRAD_REL)


def test_step_bound_fails_a_wrong_update():
    """The bound of test_train_step_matches_reference fails an update that
    drops AdamW's bias correction (m / (sqrt(v) + eps) instead of
    m_hat / (sqrt(v_hat) + eps): ~3.2x the step at b1 0.9, b2 0.95)."""
    tcfg, tstate, _, state, metrics = _first_steps()
    lr = float(metrics["lr"])
    ref_new, ref_mu = _to_torch(state.params, tcfg), _to_torch(state.opt.mu, tcfg)
    assert _step_within_bound(tstate.params, ref_new, tstate.opt.mu, ref_mu, lr)
    wrong = []
    with torch.no_grad():
        for p, m, v in zip(leaves(tstate.params), leaves(tstate.opt.mu),
                           leaves(tstate.opt.nu)):
            right = (m / (1 - B1)) / ((v / (1 - 0.95)).sqrt() + 1e-8)
            wrong.append(p - lr * (m / (v.sqrt() + 1e-8) - right))
    assert not _step_within_bound(wrong, ref_new, tstate.opt.mu, ref_mu, lr)


def test_microbatches_match_one_batch():
    _, _, _, _, tmodel, tparams, plan, _, tb = _setup("qwen2.5-14b")
    results = []
    for n in (1, 2):
        params = topt.adamw.map_tree(lambda p: p.detach().clone().requires_grad_(), tparams)
        step = ttrain.make_train_step(tmodel, dataclasses.replace(plan, microbatches=n),
                                      ttrain.Hyper(peak_lr=1e-3, warmup_steps=2))
        state, metrics = step(ttrain.TrainState(params, topt.adamw_init(params)), tb)
        results.append((state, metrics, [p.grad for p in leaves(state.params)]))
    (s1, m1, g1), (s2, m2, g2) = results
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-6)
    _assert_trees_close(g2, g1, 1e-6)
    _assert_trees_close(s2.opt.nu, leaves(s1.opt.nu), 1e-5)


def test_remat_modes_give_equal_grads():
    _, tcfg, _, _, _, tparams, _, _, tb = _setup("gemma2-9b")
    grads = {}
    for mode in ("none", "full", "selective"):
        tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="float32", remat=mode),
                                   device="cpu")
        grads[mode] = _port_grads(tmodel, tparams, tb)[1]
    for mode in ("full", "selective"):
        _assert_trees_close(grads[mode], grads["none"], 1e-6)


def test_quickstart_trajectory_matches_reference():
    """20 steps of the quickstart recipe from the same weights and batches.
    AdamW divides by sqrt(v): each step's update is ~lr * sign(g) and its
    rounding noise (~1e-7 of the grads) compounds through the params over the
    steps, so the losses agree to 1e-4 relative (measured 3.3e-6), not to 1e-6."""
    arch, shape = "qwen1.5-4b", ("quickstart", 64, 8, "train")
    jcfg, tcfg, model, params, tmodel, tparams, _, _, _ = _setup(arch, shape=shape)
    hyper = Hyper(peak_lr=5e-3, warmup_steps=20, total_steps=200)
    jplan = ParallelPlan(remat="selective", compute_dtype="float32")
    tplan = TorchPlan(remat="selective", compute_dtype="float32")
    tmodel = torch_build_model(tcfg, tplan, device="cpu")
    jstep = jax.jit(make_train_step(build_model(jcfg, jplan), jplan, hyper))
    tstep = ttrain.make_train_step(tmodel, tplan, ttrain.Hyper(*hyper))
    jstate = init_train_state(model, jax.random.PRNGKey(0))
    tstate = ttrain.TrainState(tparams, topt.adamw_init(tparams))
    ds = SyntheticDataset(jcfg, InputShape(*shape))
    ref, ours = [], []
    for i in range(20):
        batch = ds.batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        ref.append(float(jm["loss"]))
        ours.append(float(tm["loss"]))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    assert ours[-1] < ours[0] - 1.0            # it learns
