"""The port's MoE layer and MoE models against the JAX reference: the router and
its aux loss, both dispatch forms (the same slots, weights and drops), the
scatter/gather and group-size helpers, ``moe_dense`` and its gradients in both
dispatch modes (with a capacity that drops tokens and with shared experts), the
expert SwiGLU in bf16 on a fixed routing, and the olmoe and deepseek smoke
models: forward, prefill and decode on converted weights, the train-step loss
with aux and its gradients, and the three remat modes.

Model-level parity is held in fp32: under bf16 the two frameworks round at
other places, and a router logit that moves by one bf16 ulp can flip a top-k
choice, which changes that token's output entirely. bf16 is held on a routing
both sides are given (``test_expert_ffn_bf16_on_fixed_routing``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParallelPlan, get_smoke_config
from repro.models import build_model
from repro.models import moe as jmoe
from repro.train import Hyper, make_loss_fn
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import REMAT_MODES, get_smoke_config as torch_smoke_config
from repro_torch.core.tree import leaves, map_tree
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import build_model as torch_build_model
from repro_torch.models import moe as tmoe
from repro_torch import train as ttrain

torch.set_num_threads(1)

ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b"]      # deepseek: 1 shared expert
MODES = ["einsum", "scatter"]
TOL = 1e-5          # fp32 functions: the frameworks sum in other orders (~1e-7)
GRAD_REL = 1e-5     # each grad leaf against its own largest |value|


def _np(x):
    return np.asarray(x, np.float32)


def _cfgs(arch, capacity_factor=None):
    cfgs = [get_smoke_config(arch), torch_smoke_config(arch)]
    if capacity_factor is not None:
        cfgs = [dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in cfgs]
    return cfgs


def _layer_params(jcfg, seed=0):
    """One MoE layer's reference params and the same values as torch tensors."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, map_tree(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))


def _tokens(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(), _np(ref), rtol=tol, atol=tol)


# -- routing -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_and_aux_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _layer_params(jcfg)
    x = _tokens(24, jcfg.d_model)
    probs, aux = jmoe.router_probs(jp, jnp.asarray(x), jcfg, jnp.float32)
    tprobs, taux = tmoe.router_probs(tp, torch.from_numpy(x), tcfg, torch.float32)
    _close(tprobs, probs)
    assert taux.item() == pytest.approx(float(aux), rel=TOL)


def _routing_cases():
    """(probs, capacity) pairs: random routing at the layer's capacity and at
    one that drops, and probabilities with exact ties."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((40, 4)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ties = np.round(probs * 4) / 4 + 1e-3               # many exact ties per row
    ties /= ties.sum(-1, keepdims=True)
    return [(probs, 25), (probs, 7), (ties, 9), (np.full((6, 4), 0.25, np.float32), 2)]


@pytest.mark.parametrize("case", range(4))
def test_dispatch_forms_match_reference(case):
    """Both dispatch forms give the reference's experts, slots, weights and drops
    (ties to the lower index, as ``jax.lax.top_k``), and agree with each other."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    probs, cap = _routing_cases()[case]
    pj, pt = jnp.asarray(probs), torch.from_numpy(probs)
    dispatch, combine = jmoe.topk_dispatch(pj, jcfg, cap)
    tdispatch, tcombine = tmoe.topk_dispatch(pt, tcfg, cap)
    assert np.array_equal(tdispatch.numpy(), _np(dispatch))
    _close(tcombine, combine, 1e-6)
    slot, wts = jmoe.topk_scatter_dispatch(pj, jcfg, cap)
    tslot, twts = tmoe.topk_scatter_dispatch(pt, tcfg, cap)
    assert np.array_equal(tslot.numpy(), np.asarray(slot))
    _close(twts, wts, 1e-6)
    # the scatter slots name exactly the dispatch tensor's kept entries
    e = probs.shape[1]
    kept = tslot < e * cap
    n_idx = torch.arange(probs.shape[0])[:, None].expand_as(tslot)[kept]
    rebuilt = torch.zeros_like(tdispatch)
    rebuilt[n_idx, tslot[kept] // cap, tslot[kept] % cap] = 1.0
    assert torch.equal(rebuilt, tdispatch)
    if cap < probs.shape[0] * jcfg.moe.top_k / e:
        assert not kept.all()                          # this capacity drops tokens


@pytest.mark.parametrize("case", range(4))
def test_buffers_and_group_sizes_match_reference(case):
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    probs, cap = _routing_cases()[case]
    x = _tokens(probs.shape[0], 8, seed=case)
    e = probs.shape[1]
    slot, wts = jmoe.topk_scatter_dispatch(jnp.asarray(probs), jcfg, cap)
    tslot, twts = tmoe.topk_scatter_dispatch(torch.from_numpy(probs), tcfg, cap)
    buf = jmoe._scatter_to_buffers(jnp.asarray(x), slot, jcfg, cap)
    tbuf = tmoe._scatter_to_buffers(torch.from_numpy(x), tslot, tcfg, cap)
    assert np.array_equal(tbuf.numpy(), _np(buf))
    h = _tokens(e * cap, 8, seed=10 + case).reshape(e, cap, 8)
    out = jmoe._gather_from_buffers(jnp.asarray(h), slot, wts, jnp.float32)
    tout = tmoe._gather_from_buffers(torch.from_numpy(h), tslot, twts, torch.float32)
    _close(tout, out)
    gs = jmoe._group_sizes_from_slots(slot, e, cap)
    tgs = tmoe._group_sizes_from_slots(tslot, e, cap)
    dispatch, _ = tmoe.topk_dispatch(torch.from_numpy(probs), tcfg, cap)
    tgs_d = tmoe._group_sizes_from_dispatch(dispatch)
    assert tgs.dtype == tgs_d.dtype == torch.int32
    assert np.array_equal(tgs.numpy(), np.asarray(gs))
    assert np.array_equal(tgs_d.numpy(), np.asarray(jmoe._group_sizes_from_dispatch(
        jnp.asarray(dispatch.numpy()))))
    assert torch.equal(tgs, tgs_d)


# -- the layer ---------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 0.5])               # 0.5 drops tokens
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_and_grads_match_reference(arch, mode, cf):
    jcfg, tcfg = _cfgs(arch, cf)
    jp, tp = _layer_params(jcfg, seed=1)
    x = _tokens(2 * 12, jcfg.d_model, seed=2).reshape(2, 12, -1)
    cot = _tokens(2 * 12, jcfg.d_model, seed=3).reshape(2, 12, -1)

    def ref_fn(p, x):
        out, aux = jmoe.moe_dense(p, x, jcfg, jnp.float32, mode, "xla")
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    for t in leaves(tp):
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    tout, taux = tmoe.moe_dense(tp, xt, tcfg, torch.float32, mode, "plain")
    _close(tout, out)
    assert taux.item() == pytest.approx(float(aux), rel=TOL)
    grads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum() + taux,
                                [xt] + leaves(tp))
    ref = [gx] + leaves(map_tree(lambda a: torch.from_numpy(np.array(a)),
                                 jax.tree.map(np.asarray, gp)))
    for g, r in zip(grads, ref):
        r = torch.from_numpy(np.array(r))
        assert (g - r).abs().max().item() <= GRAD_REL * max(r.abs().max().item(), 1e-30)


def test_expert_ffn_bf16_on_fixed_routing():
    """bf16 expert SwiGLU on the same buffers and group sizes: each GEMM
    accumulates in fp32 and rounds to bf16 on both sides, and the SwiGLU
    between them rounds after each op here where XLA fuses it in fp32, so
    values agree to a few bf16 ulps: 2e-2 of the tensor's largest |value|."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    jp, tp = _layer_params(jcfg, seed=5)
    e, cap, d = jcfg.moe.num_experts, 16, jcfg.d_model
    h = _tokens(e * cap, d, seed=6).reshape(e, cap, d)
    gs = np.asarray([16, 0, 9, 3], np.int32)
    ref = jmoe._expert_ffn(jp["experts"], jnp.asarray(h, jnp.bfloat16), jnp.bfloat16,
                           "xla", jnp.asarray(gs))
    ours = tmoe._expert_ffn(tp["experts"], torch.from_numpy(h).bfloat16(), torch.bfloat16,
                            "plain", torch.from_numpy(gs))
    assert ours.dtype == torch.bfloat16
    ref = _np(ref.astype(jnp.float32))
    err = np.abs(ours.float().numpy() - ref).max() / np.abs(ref).max()
    assert err < 2e-2, err
    assert np.all(ours.float().numpy()[1] == 0) and np.all(ours.float().numpy()[2, 9:] == 0)


# -- the models --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_layout_and_scale(arch):
    """``Model.init`` gives the reference's tree, shapes and init scales (fan-in
    on the right axis of each expert stack), with the router and experts in
    ``plan.param_dtype`` and norm scales fp32."""
    jcfg, tcfg = _cfgs(arch)
    ref = jax.tree.map(np.asarray, build_model(jcfg, ParallelPlan(remat="none")).init(
        jax.random.PRNGKey(0)))
    params = torch_build_model(tcfg, TorchPlan(param_dtype="bfloat16"), device="cpu").init(
        torch.Generator().manual_seed(0))
    flat_ref, tree_ref = jax.tree.flatten(ref)
    flat, tree = jax.tree.flatten(params_to_numpy(params, tcfg))
    assert tree == tree_ref
    for a, r in zip(flat, flat_ref):
        assert a.shape == r.shape
        if r.size > 1000:
            assert 0.9 < a.std() / r.std() < 1.1
    moe = params["layers"][0]["moe"]
    assert all(t.dtype == torch.bfloat16 for t in leaves(moe))
    assert ("shared" in moe) == bool(tcfg.moe.num_shared_experts)
    assert params["layers"][0]["norm2"]["scale"].dtype == torch.float32

def _models(arch, mode, remat="none"):
    jcfg, tcfg = _cfgs(arch)
    model = build_model(jcfg, ParallelPlan(remat="none", compute_dtype="float32",
                                           moe_dispatch=mode))
    params = model.init(jax.random.PRNGKey(0))
    tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="float32", moe_dispatch=mode,
                                               remat=remat), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, model, params, tmodel, tparams


def _batch(cfg, b, s, seed=0):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return tokens


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, mode):
    cfg, model, params, tmodel, tparams = _models(arch, mode)
    b, s_prompt, s_total = 2, 5, 9
    tokens = _batch(cfg, b, s_total)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)

    ref_logits, ref_aux = jax.jit(model.forward)(params, {"tokens": jt})
    logits, aux = tmodel.forward(tparams, {"tokens": tt})
    _close(logits, ref_logits, 1e-4)
    assert aux.item() == pytest.approx(float(ref_aux), rel=1e-5)

    prefill = jax.jit(model.extras["prefill"], static_argnums=2)
    ref_pl, ref_cache = prefill(params, {"tokens": jt[:, :s_prompt]}, s_total)
    pl, cache = tmodel.prefill(tparams, {"tokens": tt[:, :s_prompt]}, max_seq=s_total)
    _close(pl, ref_pl, 1e-4)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name], 1e-4)

    step = jax.jit(model.decode_step)
    for t in range(s_prompt, s_total):       # batch 2: capacity 1, collisions drop
        ref_lg, ref_cache = step(params, ref_cache, jt[:, t], jnp.int32(t))
        lg, cache = tmodel.decode_step(tparams, cache, tt[:, t], t)
        _close(lg, ref_lg, 1e-3)
    _close(cache["k"], ref_cache["k"], 1e-3)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, mode):
    """The train-step loss (cross-entropy, z-loss and the MoE aux summed over
    layers) and its gradients."""
    cfg, model, params, tmodel, tparams = _models(arch, mode)
    tokens = _batch(cfg, 4, 16, seed=1)
    labels = np.roll(tokens, -1, axis=1)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels.copy())}
    loss_fn = make_loss_fn(model, Hyper())
    (ref_loss, ref_parts), ref = jax.value_and_grad(loss_fn, has_aux=True)(params, jb)
    for p in leaves(tparams):
        p.requires_grad_(True)
    loss, parts = ttrain.make_loss_fn(tmodel, ttrain.Hyper())(tparams, tb)
    assert float(ref_parts["moe_aux"]) > 0
    assert parts["moe_aux"].item() == pytest.approx(float(ref_parts["moe_aux"]), rel=1e-5)
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-6)
    grads = torch.autograd.grad(loss, leaves(tparams))
    ref = leaves(params_from_numpy(jax.tree.map(np.asarray, ref), tmodel.cfg, device="cpu"))
    for g, r in zip(grads, ref):
        assert (g - r).abs().max().item() <= GRAD_REL * max(r.abs().max().item(), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_grads(arch):
    cfg, _, _, _, tparams = _models(arch, "einsum")
    for p in leaves(tparams):
        p.requires_grad_(True)
    tokens = torch.from_numpy(_batch(cfg, 2, 12, seed=2))
    grads = {}
    for mode in REMAT_MODES:
        tmodel = torch_build_model(cfg, TorchPlan(compute_dtype="float32", remat=mode),
                                   device="cpu")
        loss, _ = ttrain.make_loss_fn(tmodel, ttrain.Hyper())(
            tparams, {"tokens": tokens, "labels": tokens})
        grads[mode] = torch.autograd.grad(loss, leaves(tparams))
    for mode in ("full", "selective"):
        for a, b in zip(grads[mode], grads["none"]):
            assert (a - b).abs().max().item() <= 1e-6 * max(b.abs().max().item(), 1e-30)
