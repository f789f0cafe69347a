"""The port's whisper encoder-decoder against the JAX reference at the smoke
config (2 encoder + 2 decoder layers, d_model 128, 4 heads, 16 frames): weights
from the reference's ``init`` converted, inputs from numpy. The encoder, the
forward logits, ``fill_cross`` followed by decode steps, the loss grads (the
encoder's included), a whole train step, and the three remat modes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import InputShape, ParallelPlan, get_smoke_config
from repro.data import SyntheticDataset
from repro.models import build_model
from repro.train import Hyper, init_train_state, make_loss_fn, make_train_step
from repro_torch import optim as topt
from repro_torch import train as ttrain
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.core.tree import leaves
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import EncDecModel
from repro_torch.models import build_model as torch_build_model

torch.set_num_threads(1)

ARCH = "whisper-small"
SHAPE = ("t", 12, 4, "train")      # 12 decoder tokens, batch 4, 16 frames
# fp32 on both sides; the frameworks sum in other orders, so logits and each
# grad leaf agree to a few 1e-7 of their largest value (1e-5 is the limit, as
# tests/test_torch_train.py's GRAD_REL)
REL = 1e-5


def _rel_err(ours, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(ours.detach().float().numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)


def _setup(remat="none", microbatches=1, dtype="float32"):
    """The reference model and params, the port's model and the same params
    converted (autograd leaves), and one synthetic batch in both forms."""
    jcfg, tcfg = get_smoke_config(ARCH), torch_smoke_config(ARCH)
    model = build_model(jcfg, ParallelPlan(remat="none", compute_dtype=dtype))
    params = model.init(jax.random.PRNGKey(0))
    plan = TorchPlan(compute_dtype=dtype, remat=remat, microbatches=microbatches)
    tmodel = torch_build_model(tcfg, plan, device="cpu")
    tparams = _to_torch(params, tcfg, dtype)
    batch = SyntheticDataset(jcfg, InputShape(*SHAPE)).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return tcfg, model, params, tmodel, tparams, plan, jb, tb


def _to_torch(tree, cfg, dtype="float32"):
    out = params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device="cpu", dtype=dtype)
    for p in leaves(out):
        p.requires_grad_(True)
    return out


def _grads(tmodel, tparams, tb):
    loss, _ = ttrain.make_loss_fn(tmodel, ttrain.Hyper())(tparams, tb)
    return loss, torch.autograd.grad(loss, leaves(tparams))


def test_build_model_returns_the_encoder_decoder():
    model = torch_build_model(torch_smoke_config(ARCH), device="cpu")
    assert isinstance(model, EncDecModel)
    assert not hasattr(model, "prefill")        # the reference has none either


def test_init_has_the_reference_tree():
    """Leaf names, shapes and the stacked layout of the reference's init;
    matrices in ``param_dtype``, norm scales fp32 zeros; the analytic
    ``param_count`` plus the two final norms."""
    tcfg = torch_smoke_config(ARCH)
    ref = jax.tree.map(np.asarray, build_model(get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0)))
    model = torch_build_model(tcfg, TorchPlan(param_dtype="bfloat16"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ours = params_to_numpy(params, tcfg)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape
    assert params["encoder"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert params["layers"][1]["xattn"]["wk"].dtype == torch.bfloat16
    for lp in params["layers"]:
        assert lp["norm3"]["scale"].dtype == torch.float32
        assert not lp["norm3"]["scale"].any()
    assert params["encoder"]["final_norm"]["scale"].dtype == torch.float32
    # the analytic count leaves out the final norms (in every family): here the
    # decoder's and the encoder's
    assert sum(p.numel() for p in leaves(params)) == tcfg.param_count() + 2 * tcfg.d_model


def test_encode_matches_reference():
    _, model, params, tmodel, tparams, _, jb, tb = _setup()
    ref = jax.jit(model.extras["encode"])(params, jb["frames"])
    with torch.no_grad():
        ours = tmodel.encode(tparams, tb["frames"])
    assert ours.shape == ref.shape
    assert _rel_err(ours, ref) <= REL


def test_forward_matches_reference():
    _, model, params, tmodel, tparams, _, jb, tb = _setup()
    ref, _ = jax.jit(model.forward)(params, jb)
    with torch.no_grad():
        logits, aux = tmodel.forward(tparams, tb)
    assert logits.shape == ref.shape and float(aux) == 0.0
    assert _rel_err(logits, ref) <= REL


def test_fill_cross_then_decode_match_reference():
    """``fill_cross`` (the encoder, every layer's cross K/V) then 8 decode
    steps from position 0: the cross caches and every step's logits and
    self-attention cache."""
    tcfg, model, params, tmodel, tparams, _, jb, tb = _setup()
    b, steps = 4, 8
    cache = model.init_cache(b, steps)
    cache = jax.jit(model.extras["fill_cross"])(params, cache, jb["frames"])
    with torch.no_grad():
        tcache = tmodel.fill_cross(tparams, tmodel.init_cache(b, steps), tb["frames"])
    for name in ("cross_k", "cross_v"):
        assert tcache[name].shape == cache[name].shape
        assert _rel_err(tcache[name], cache[name]) <= REL
    step = jax.jit(model.decode_step)
    with torch.no_grad():
        for t in range(steps):
            ref, cache = step(params, cache, jb["tokens"][:, t], jnp.int32(t))
            lg, tcache = tmodel.decode_step(tparams, tcache, tb["tokens"][:, t], t)
            assert _rel_err(lg, ref) <= REL, t
    for name in ("k", "v"):
        assert _rel_err(tcache[name], cache[name]) <= REL


def test_decode_logits_follow_the_forward():
    """Decode steps over a prompt give the parallel forward's logits (the
    cross caches filled from the same frames)."""
    _, _, _, tmodel, tparams, _, _, tb = _setup()
    with torch.no_grad():
        full, _ = tmodel.forward(tparams, tb)
        cache = tmodel.fill_cross(tparams, tmodel.init_cache(4, 12), tb["frames"])
        for t in range(12):
            lg, cache = tmodel.decode_step(tparams, cache, tb["tokens"][:, t], t)
            torch.testing.assert_close(lg, full[:, t], rtol=0, atol=1e-5 * full.abs().max())


def test_fill_cross_rejects_a_frame_count_the_cache_does_not_hold():
    _, _, _, tmodel, tparams, _, _, tb = _setup()
    with pytest.raises(ValueError, match="frames"):
        tmodel.fill_cross(tparams, tmodel.init_cache(4, 4), tb["frames"][:, :8])


def test_loss_grads_match_reference():
    """The loss and every grad leaf, the encoder's included (their gradient
    reaches the encoder only through the decoder layers' xattn.wk/wv)."""
    tcfg, model, params, tmodel, tparams, _, jb, tb = _setup()
    loss_fn = make_loss_fn(model, Hyper())
    ref_loss, ref = jax.value_and_grad(lambda p: loss_fn(p, jb)[0])(params)
    loss, grads = _grads(tmodel, tparams, tb)
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-6)
    ref_t = _to_torch(ref, tcfg)
    for g, r in zip(grads, leaves(ref_t)):
        assert _rel_err(g, r.detach().numpy()) <= REL, tuple(r.shape)
    enc = leaves(ref_t["encoder"])
    assert all(r.abs().max() > 0 for r in enc if r.dim() > 1)


@pytest.mark.parametrize("mode", ["full", "selective"])
def test_remat_modes_give_equal_grads(mode):
    tcfg, _, _, _, tparams, _, _, tb = _setup()
    grads = {}
    for m in ("none", mode):
        tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="float32", remat=m),
                                   device="cpu")
        grads[m] = _grads(tmodel, tparams, tb)[1]
    for a, b in zip(grads[mode], grads["none"]):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max().clamp(min=1e-30)


def test_train_step_matches_reference():
    """One whole step in two microbatches: loss, grad norm and lr, and the
    first moments (the mean of the microbatch grads)."""
    tcfg, model, params, tmodel, tparams, plan, jb, tb = _setup(microbatches=2)
    hyper = Hyper(peak_lr=1e-3, warmup_steps=2)
    state, metrics = make_train_step(
        model, ParallelPlan(remat="none", compute_dtype="float32", microbatches=2),
        hyper)(init_train_state(model, jax.random.PRNGKey(0)), jb)
    tstate, tmetrics = ttrain.make_train_step(tmodel, plan, ttrain.Hyper(*hyper))(
        ttrain.TrainState(tparams, topt.adamw_init(tparams)), tb)
    for name in ("loss", "grad_norm", "lr"):
        assert float(tmetrics[name]) == pytest.approx(float(metrics[name]), rel=1e-5)
    for m, r in zip(leaves(tstate.opt.mu), leaves(_to_torch(state.opt.mu, tcfg))):
        assert _rel_err(m, r.detach().numpy()) <= REL


def test_bf16_forward_matches_reference():
    """bf16 compute: the frameworks round to bf16 at other places, so the
    bound is the repo's bf16 tolerance, 3e-2 of the largest logit
    (tests/test_torch_serve.py's test_bf16_forward_matches_reference)."""
    _, model, params, tmodel, tparams, _, jb, tb = _setup(dtype="bfloat16")
    ref, _ = jax.jit(model.forward)(params, jb)
    with torch.no_grad():
        ours, _ = tmodel.forward(tparams, tb)
    assert ours.dtype == torch.float32
    assert _rel_err(ours, ref) < 3e-2


def test_cuda_impl_raises_on_a_cpu_tensor():
    """attn_impl="cuda" forces the kernels; on CPU tensors the encoder's first
    attention call raises instead of taking the plain path."""
    tcfg, _, _, _, tparams, _, _, tb = _setup()
    model = torch_build_model(tcfg, dataclasses.replace(TorchPlan(compute_dtype="float32"),
                                                        attn_impl="cuda"), device="cpu")
    with pytest.raises(ValueError, match="cuda"), torch.no_grad():
        model.encode(tparams, tb["frames"])
