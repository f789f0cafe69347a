"""The port's dense/VLM serving path against the JAX reference: weights from the
reference's ``init`` converted, then forward, prefill (logits and KV cache) and
the decode steps that follow, as in tests/test_prefill.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ParallelPlan, get_smoke_config
from repro.models import build_model
from repro_torch.core import ParallelPlan as TorchPlan
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as torch_build_model

torch.set_num_threads(1)

ARCHS = ["qwen1.5-4b", "qwen2.5-14b", "codeqwen1.5-7b", "gemma2-9b", "pixtral-12b"]


def _configs(arch):
    cfgs = [get_smoke_config(arch), torch_smoke_config(arch)]
    if cfgs[0].sliding_window:
        cfgs = [dataclasses.replace(c, sliding_window=4) for c in cfgs]
    return cfgs


def _models(arch, dtype):
    jcfg, tcfg = _configs(arch)
    model = build_model(jcfg, ParallelPlan(remat="none", compute_dtype=dtype))
    params = model.init(jax.random.PRNGKey(0))
    tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype=dtype), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu", dtype=dtype)
    return jcfg, model, params, tmodel, tparams


def _batches(cfg, b, s):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if cfg.family == "vlm":
        ve = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        vp = np.tile(np.arange(cfg.vision_tokens, dtype=np.int32)[None], (b, 1))
        jb.update(vision_embeds=jnp.asarray(ve), vision_pos=jnp.asarray(vp))
        tb.update(vision_embeds=torch.from_numpy(ve), vision_pos=torch.from_numpy(vp))
    return jb, tb


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    cfg, model, params, tmodel, tparams = _models(arch, "float32")
    b, s_prompt, s_total = 2, 5, 9
    jb, tb = _batches(cfg, b, s_total)

    ref_logits, _ = jax.jit(model.forward)(params, jb)
    logits, aux = tmodel.forward(tparams, tb)
    _close(logits, ref_logits, 1e-4)
    assert float(aux) == 0.0

    prefill = jax.jit(model.extras["prefill"], static_argnums=2)
    ref_pl, ref_cache = prefill(params, dict(jb, tokens=jb["tokens"][:, :s_prompt]),
                                s_total)
    pl, cache = tmodel.prefill(tparams, dict(tb, tokens=tb["tokens"][:, :s_prompt]),
                               max_seq=s_total)
    _close(pl, ref_pl, 1e-4)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name], 1e-4)

    step = jax.jit(model.decode_step)
    for t in range(s_prompt, s_total):
        ref_lg, ref_cache = step(params, ref_cache, jb["tokens"][:, t], jnp.int32(t))
        lg, cache = tmodel.decode_step(tparams, cache, tb["tokens"][:, t], t)
        _close(lg, ref_lg, 1e-3)
    _close(cache["k"], ref_cache["k"], 1e-3)


def test_bf16_forward_matches_reference():
    """bf16 compute: the two frameworks round to bf16 at different places (XLA
    fuses elementwise chains in fp32 between bf16 matmuls, PyTorch rounds after
    each op), so each layer output may differ by a few bf16 ulps (2^-8
    relative). Over two layers that reaches about 1e-2 of the largest logit
    (8.6e-3 measured), so the bound is the repo's bf16 tolerance, 3e-2 of the
    largest logit magnitude, not an fp32 one."""
    cfg, model, params, tmodel, tparams = _models("qwen2.5-14b", "bfloat16")
    jb, tb = _batches(cfg, 2, 9)
    ref, _ = jax.jit(model.forward)(params, jb)
    ours, _ = tmodel.forward(tparams, tb)
    ref = np.asarray(ref, np.float32)
    assert ours.dtype == torch.float32
    err = np.abs(ours.numpy() - ref).max() / np.abs(ref).max()
    assert err < 3e-2, err


def test_layer_windows_match_reference():
    from repro.configs import gemma2_9b as jgemma
    from repro.models import families as jfam
    from repro_torch.configs import gemma2_9b as tgemma
    from repro_torch.models import families as tfam
    pairs = [(get_smoke_config(a), torch_smoke_config(a)) for a in ARCHS]
    pairs += [(jgemma.FULL, tgemma.FULL), (jgemma.LONG_CONTEXT, tgemma.LONG_CONTEXT)]
    for jcfg, tcfg in pairs:
        assert tfam._layer_windows(tcfg) == jfam._layer_windows(jcfg).tolist()


def test_padded_vocab_logits_match_reference():
    jcfg, tcfg = _configs("qwen2.5-14b")
    pad = 96                                   # 512 -> 576: a masked tail of 64
    model = build_model(jcfg, ParallelPlan(remat="none", compute_dtype="float32",
                                           pad_vocab_to_multiple=pad))
    params = model.init(jax.random.PRNGKey(3))
    tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="float32",
                                               pad_vocab_to_multiple=pad), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jb, tb = _batches(jcfg, 2, 6)
    ref, _ = jax.jit(model.forward)(params, jb)
    ours, _ = tmodel.forward(tparams, tb)
    assert ours.shape[-1] == 576
    _close(ours, ref, 1e-4)
    assert torch.all(ours[..., jcfg.vocab:] == -1e9)


@pytest.mark.parametrize("window", [0, 3])
def test_decode_attention_and_combine_lse_match_reference(window):
    from repro.serve import attention as jsa
    from repro_torch.serve import attention as tsa
    rng = np.random.default_rng(9)
    b, t, hq, hkv, hd, pos = 2, 12, 4, 2, 16, 7
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, 1, hq, hd), (b, t, hkv, hd), (b, t, hkv, hd), (b, 1, hkv, hd),
             (b, 1, hkv, hd))]
    ref = jsa.decode_attention(*map(jnp.asarray, arrs), jnp.int32(pos),
                               window=window, softcap=20.0)
    ours = tsa.decode_attention(*(torch.from_numpy(a.copy()) for a in arrs), pos,
                                window=window, softcap=20.0)
    for o, r in zip(ours, ref):
        _close(o, r, 1e-5)
    q = arrs[0].reshape(b, hkv, hq // hkv, hd)
    parts = [(arrs[1][:, :6], arrs[2][:, :6]), (arrs[1][:, 6:], arrs[2][:, 6:])]
    valid = np.ones((b, 6), bool)
    jparts = [jsa._local_decode_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     valid_mask=jnp.asarray(valid), softcap=0.0,
                                     scale=0.25) for k, v in parts]
    tparts = [tsa._local_decode_attn(torch.from_numpy(q), torch.from_numpy(k.copy()),
                                     torch.from_numpy(v.copy()),
                                     valid_mask=torch.from_numpy(valid), softcap=0.0,
                                     scale=0.25) for k, v in parts]
    for o, r in zip(tsa.combine_lse(tparts), jsa.combine_lse(jparts)):
        _close(o, r, 1e-5)


def test_prefill_rejects_prompt_longer_than_cache():
    _, tcfg = _configs("qwen2.5-14b")
    tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="float32"), device="cpu")
    params = tmodel.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_seq"):
        tmodel.prefill(params, {"tokens": torch.zeros((1, 6), dtype=torch.long)},
                       max_seq=5)


def test_init_holds_matrices_in_compute_dtype():
    """Matrices, biases and embeddings in ``plan.param_dtype``: fp32 masters by
    default, bf16 when a serving run asks for it; norm scales fp32 either way."""
    _, tcfg = _configs("gemma2-9b")
    for kw, want in (({}, torch.float32), ({"param_dtype": "bfloat16"}, torch.bfloat16)):
        tmodel = torch_build_model(tcfg, TorchPlan(compute_dtype="bfloat16", **kw),
                                   device="cpu")
        params = tmodel.init(torch.Generator().manual_seed(0))
        lp = params["layers"][0]
        assert len(params["layers"]) == tcfg.n_layers
        assert lp["attn"]["wq"].dtype == want and lp["mlp"]["down"].dtype == want
        assert params["embed"]["tok"].dtype == want
        for norm in ("norm1", "norm2", "norm1_post", "norm2_post"):
            assert lp[norm]["scale"].dtype == torch.float32
        assert params["final_norm"]["scale"].dtype == torch.float32
        assert "lm_head" not in params          # gemma2 ties its embeddings
