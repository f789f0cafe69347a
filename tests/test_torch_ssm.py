"""The port's Mamba2 layer and the two SSM-family models against the JAX
reference, on numpy inputs from a seed: the causal conv, the chunked scan (with
an initial state), the block and its decode step, the step form against the
block form, the mamba2 and zamba2 smoke models from converted weights (forward,
decode, loss gradients, one train step) and the three remat modes.

The reference initialises the conv taps and the gated-norm scale to zero, which
makes every SSM block's output exactly zero at init; the tests draw those
leaves at random (the same numbers for both packages), so the comparisons see
real work."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Family, InputShape, ModelConfig, ParallelPlan, SSMConfig
from repro.core import get_smoke_config
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.models import ssm as jssm
from repro.train import Hyper, init_train_state, make_loss_fn, make_train_step
from repro_torch import optim as topt
from repro_torch import train as ttrain
from repro_torch.core import Family as TFamily
from repro_torch.core import ModelConfig as TModelConfig
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import SSMConfig as TSSMConfig
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.core.tree import leaves
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import build_model as torch_build_model
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
# fp32 through a few layers: the frameworks sum in other orders, so values agree
# to ~1e-6 of their largest; the limits below are the reference's own where it
# states one (5e-4 step vs block, tests/test_ssm.py) and 1e-5 relative otherwise.
REL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _cfgs(d_state=8, head_dim=16, chunk=16, g=1):
    kw = dict(n_layers=1, d_model=32, n_heads=0, n_kv_heads=0, d_ff=0, vocab=64)
    return (ModelConfig("t", Family.SSM, **kw, ssm=SSMConfig(
                d_state=d_state, head_dim=head_dim, expand=2, n_groups=g, chunk=chunk)),
            TModelConfig("t", TFamily.SSM, **kw, ssm=TSSMConfig(
                d_state=d_state, head_dim=head_dim, expand=2, n_groups=g, chunk=chunk)))


def _randomize(tree, rng):
    """Draw the leaves the reference initialises to zero (conv taps, gated-norm
    scale) at random, in place, in a numpy block tree."""
    for k in ("conv_x", "conv_B", "conv_C"):
        tree[k] = (rng.standard_normal(tree[k].shape) * 0.5).astype(np.float32)
    tree["scale"] = (rng.standard_normal(tree["scale"].shape) * 0.1).astype(np.float32)
    return tree


def _block_params(cfg, seed=0):
    p = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.PRNGKey(seed), cfg))
    return _randomize(dict(p), np.random.default_rng(seed))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# -- the layer's pieces -------------------------------------------------------

@pytest.mark.parametrize("with_left", [False, True])
def test_causal_conv_matches_reference(with_left):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    left = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_left else None
    ref = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.float32,
                            None if left is None else jnp.asarray(left))
    ours = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.float32,
                             None if left is None else torch.from_numpy(left))
    np.testing.assert_allclose(ours.numpy(), _np(ref), rtol=1e-6, atol=1e-6)


def test_segsum_matches_reference():
    x = np.random.default_rng(2).standard_normal((3, 7)).astype(np.float32)
    ref = _np(jssm._segsum(jnp.asarray(x)))
    ours = tssm._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(ours), np.isinf(ref))
    np.testing.assert_allclose(ours[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_matches_reference(g, initial):
    rng = np.random.default_rng(10 * g + initial)
    b, l, h, p, n, chunk = 2, 48, 4, 8, 6, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, l, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, (h,))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if initial else None
    args = (x, dt, A, B, C)
    y_ref, s_ref = jssm.ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                                 initial_state=None if s0 is None else jnp.asarray(s0))
    y, s = tssm.ssd_scan(*map(torch.from_numpy, args), chunk=chunk,
                         initial_state=None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), _np(y_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s.numpy(), _np(s_ref), rtol=2e-5, atol=2e-5)


def test_init_ssm_draws_the_reference_distributions():
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, d_model=256)
    p = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg)
    a = torch.exp(p["A_log"])
    assert a.min() >= 1.0 and a.max() < 16.0 and a.std() > 3.0
    dt0 = torch.nn.functional.softplus(p["dt_bias"])
    assert dt0.min() >= 1e-3 * (1 - 1e-5) and dt0.max() <= 1e-1 * (1 + 1e-5)
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    for k in ("conv_x", "conv_B", "conv_C", "scale"):
        assert not p[k].any()
    ref = jax.tree.map(np.asarray, jssm.init_ssm(
        jax.random.PRNGKey(0), dataclasses.replace(_cfgs()[0], d_model=256)))
    assert {k: v.shape for k, v in ref.items()} == {k: tuple(v.shape) for k, v in p.items()}
    assert all(v.dtype == torch.float32 for v in p.values())


@pytest.mark.parametrize("l", [12, 24, 32])       # one chunk, unaligned, aligned
def test_ssm_block_matches_reference(l):
    jcfg, tcfg = _cfgs()
    p = _block_params(jcfg)
    x = np.random.default_rng(l).standard_normal((2, l, 32)).astype(np.float32)
    ref = jssm.ssm_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, jnp.float32)
    ours = tssm.ssm_block(_t(p), torch.from_numpy(x), tcfg, torch.float32)
    np.testing.assert_allclose(ours.numpy(), _np(ref), rtol=REL, atol=REL * np.abs(ref).max())


def test_ssm_block_keeps_the_configured_chunk(monkeypatch):
    """An unaligned length is padded to the configured chunk, never run as one
    whole-sequence chunk (tests/test_kernels_grad.py's rule)."""
    jcfg, tcfg = _cfgs()
    seen = {}
    real = dispatch.ssd_scan

    def spy(x, dt, A, B, C, chunk, initial_state=None):
        seen.update(chunk=chunk, l=x.shape[1])
        return real(x, dt, A, B, C, chunk, initial_state)

    monkeypatch.setattr(dispatch, "ssd_scan", spy)
    x = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(0))
    out = tssm.ssm_block(_t(_block_params(jcfg)), x, tcfg, torch.float32,
                         plan=TorchPlan(ssm_impl="plain"))
    assert out.shape == (2, 24, 32) and seen == {"chunk": 16, "l": 32}


def test_ssm_step_matches_reference():
    jcfg, tcfg = _cfgs(g=2)
    p = _block_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    jp, tp = jax.tree.map(jnp.asarray, p), _t(p)
    jc = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_ssm_cache(tcfg, 2, torch.float32)
    for _ in range(5):
        x = rng.standard_normal((2, 32)).astype(np.float32)
        yr, jc = jssm.ssm_step(jp, jnp.asarray(x), jc, jcfg, jnp.float32)
        y, tc = tssm.ssm_step(tp, torch.from_numpy(x), tc, tcfg, torch.float32)
        np.testing.assert_allclose(y.numpy(), _np(yr), rtol=REL, atol=REL * np.abs(yr).max())
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), rtol=REL, atol=REL)


def test_step_form_matches_block_form():
    """Token-by-token ssm_step == the chunked ssm_block (tests/test_ssm.py's
    5e-4), over two chunks and a ragged tail."""
    jcfg, tcfg = _cfgs(chunk=8)
    tp = _t(_block_params(jcfg, seed=5))
    x = torch.randn(2, 20, 32, generator=torch.Generator().manual_seed(6))
    full = tssm.ssm_block(tp, x, tcfg, torch.float32)
    cache = tssm.init_ssm_cache(tcfg, 2, torch.float32)
    steps = []
    for t in range(20):
        y, cache = tssm.ssm_step(tp, x[:, t], cache, tcfg, torch.float32)
        steps.append(y)
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=5e-4, atol=5e-4)


# -- the models -----------------------------------------------------------------

def _models(arch, dtype="float32", remat="none", seed=0, chunk=None):
    jcfg, tcfg = get_smoke_config(arch), torch_smoke_config(arch)
    if chunk is not None:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=chunk))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=chunk))
    model = build_model(jcfg, ParallelPlan(remat="none", compute_dtype=dtype))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    params["layers"]["ssm"] = _randomize(dict(params["layers"]["ssm"]),
                                         np.random.default_rng(seed))
    tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype=dtype, remat=remat),
                               device="cpu")
    return jcfg, tcfg, model, params, tmodel


def _tparams(params, tcfg, grad=False, dtype="float32"):
    out = params_from_numpy(params, tcfg, device="cpu", dtype=dtype)
    for p in leaves(out):
        p.requires_grad_(grad)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_reference(arch):
    """forward over a 40-token prompt (chunk cut to 16: two chunks and a ragged
    tail), then the prompt through decode_step (the reference's serving flow for
    these families), each step's logits against the reference's and against
    forward's at that position."""
    jcfg, tcfg, model, params, tmodel = _models(arch, chunk=16)
    tparams = _tparams(params, tcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    ref, _ = model.forward(jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(tokens)})
    ours, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    ref = _np(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=REL, atol=REL * np.abs(ref).max())
    jc, tc = model.init_cache(2, 48), tmodel.init_cache(2, 48)
    jp = jax.tree.map(jnp.asarray, params)
    for t in range(6):
        lj, jc = model.decode_step(jp, jc, jnp.asarray(tokens[:, t]), jnp.int32(t))
        lt, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tokens[:, t]), t)
        np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=REL, atol=REL * np.abs(ref).max())
        np.testing.assert_allclose(lt.numpy(), ours[:, t].numpy(), rtol=5e-4, atol=5e-4)
    assert not hasattr(tmodel, "prefill")       # the reference's SSM models have none


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    """bf16 compute with bf16-held params (the serving setting): the two
    frameworks round bf16 at different places, so logits agree to 3e-2 of the
    largest, as the dense serving test allows."""
    jcfg, tcfg, model, params, _ = _models(arch, dtype="bfloat16")
    tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="bfloat16",
                                               param_dtype="bfloat16"), device="cpu")
    tparams = _tparams(params, tcfg, dtype="bfloat16")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    ref = _np(model.forward(jax.tree.map(jnp.asarray, params),
                            {"tokens": jnp.asarray(tokens)})[0])
    ours = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})[0]
    assert np.abs(ours.numpy() - ref).max() / np.abs(ref).max() < 3e-2


def _batch(jcfg, seq=32, batch=4):
    b = SyntheticDataset(jcfg, InputShape("t", seq, batch, "train")).batch(0)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _assert_trees_close(ours, ref, rel):
    for o, r in zip(leaves(ours), leaves(ref)):
        r = r.detach().float()
        err = (o.detach().float() - r).abs().max().item()
        assert err <= rel * max(r.abs().max().item(), 1e-30), (err, tuple(r.shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_reference(arch):
    jcfg, tcfg, model, params, tmodel = _models(arch)
    jb, tb = _batch(jcfg)
    loss_fn = make_loss_fn(model, Hyper())
    ref_loss, ref = jax.value_and_grad(lambda p: loss_fn(p, jb)[0])(
        jax.tree.map(jnp.asarray, params))
    tparams = _tparams(params, tcfg, grad=True)
    loss, _ = ttrain.make_loss_fn(tmodel, ttrain.Hyper())(tparams, tb)
    grads = torch.autograd.grad(loss, leaves(tparams))
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-6)
    _assert_trees_close(grads, leaves(_tparams(jax.tree.map(np.asarray, ref), tcfg)), REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One whole step (clip + AdamW at step 0): metrics and the first moments."""
    jcfg, tcfg, model, params, tmodel = _models(arch)
    jb, tb = _batch(jcfg)
    hyper = Hyper(peak_lr=1e-3, warmup_steps=2)
    jstate = init_train_state(model, jax.random.PRNGKey(0))
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, params))
    state, metrics = make_train_step(model, ParallelPlan(remat="none", compute_dtype="float32"),
                                     hyper)(jstate, jb)
    tparams = _tparams(params, tcfg, grad=True)
    plan = TorchPlan(compute_dtype="float32", remat="none")
    tstate, tmetrics = ttrain.make_train_step(tmodel, plan, ttrain.Hyper(*hyper))(
        ttrain.TrainState(tparams, topt.adamw_init(tparams)), tb)
    for name in ("loss", "grad_norm", "lr"):
        assert float(tmetrics[name]) == pytest.approx(float(metrics[name]), rel=1e-5)
    _assert_trees_close(tstate.opt.mu, leaves(_tparams(jax.tree.map(np.asarray, state.opt.mu),
                                                       tcfg)), REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_grads(arch):
    jcfg, tcfg, _, params, _ = _models(arch)
    _, tb = _batch(jcfg)
    grads = {}
    for mode in ("none", "full", "selective"):
        tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="float32", remat=mode),
                                   device="cpu")
        tparams = _tparams(params, tcfg, grad=True)
        loss, _ = ttrain.make_loss_fn(tmodel, ttrain.Hyper())(tparams, tb)
        grads[mode] = torch.autograd.grad(loss, leaves(tparams))
    for mode in ("full", "selective"):
        _assert_trees_close(grads[mode], grads["none"], 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_holds_the_fp32_leaves(arch):
    """Under a bf16 param dtype, matrices, conv taps and embeddings are bf16;
    dt_bias, A_log, D and every scale stay fp32 (read in fp32 by the block)."""
    tcfg = torch_smoke_config(arch)
    model = torch_build_model(tcfg, TorchPlan(param_dtype="bfloat16"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == tcfg.n_layers
    for lp in params["layers"]:
        s = lp["ssm"]
        for k in tssm.FP32_LEAVES:
            assert s[k].dtype == torch.float32, k
        for k in ("wz", "wx", "wB", "wC", "wdt", "out_proj", "conv_x"):
            assert s[k].dtype == torch.bfloat16, k
        assert lp["norm1"]["scale"].dtype == torch.float32
    assert params["embed"]["tok"].dtype == torch.bfloat16
    assert ("lm_head" in params) == (arch == "zamba2-1.2b")
    if arch == "zamba2-1.2b":
        assert params["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
        cache = model.init_cache(2, 10)
        n_apps = tcfg.n_layers // tcfg.shared_attn_every
        assert cache["attn_k"].shape == (n_apps, 2, 10, tcfg.n_kv_heads, tcfg.head_dim)
        assert cache["ssm"]["state"].shape[0] == tcfg.n_layers
