"""The port's layer functions against the JAX reference, fp32, on shared numpy
inputs (repro_torch.models.layers vs repro.models.layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_smoke_config
from repro.models import layers as jl
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.models import layers as tl

torch.set_num_threads(1)
TOL = 1e-5


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_dense_init_matches_reference_distribution():
    shape = (256, 512)
    ref = np.asarray(jl.dense_init(jax.random.PRNGKey(0), shape))
    ours = tl.dense_init(torch.Generator().manual_seed(0), shape).numpy()
    assert ours.dtype == np.float32 and ours.shape == shape
    bound = 2.0 / np.sqrt(shape[0])
    assert np.abs(ours).max() <= bound * (1 + 1e-6)
    # truncated standard normal on [-2, 2]: std 0.8796 before the 1/sqrt(fan_in)
    assert abs(ours.std() - ref.std()) < 0.02 * ref.std()
    assert abs(ours.mean()) < 0.02 * ref.std()
    fan_out = tl.dense_init(torch.Generator().manual_seed(0), (64, 32), in_axis=-1)
    assert fan_out.abs().max() <= 2.0 / np.sqrt(32) * (1 + 1e-6)


def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 64), 3.0)
    sj, st = _pair(rng, (64,), 0.1)
    _close(tl.rms_norm(xt, st, 1e-6), jl.rms_norm(xj, sj, 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (2, 7, 3, 32))
    pos = np.arange(3, 10)
    _close(tl.rope(xt, torch.from_numpy(pos), theta),
           jl.rope(xj, jnp.asarray(pos), theta))


def test_sinusoidal_pos_emb():
    pos = np.arange(0, 40, 3)
    _close(tl.sinusoidal_pos_emb(torch.from_numpy(pos), 64),
           jl.sinusoidal_pos_emb(jnp.asarray(pos), 64))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3),
                                           (False, 5)])
def test_attn_mask(causal, window):
    q_pos, k_pos = np.arange(4, 12), np.arange(14)
    ours = tl.attn_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                        causal=causal, window=window)
    ref = jl.attn_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), causal=causal,
                       window=window)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    rng = np.random.default_rng(2)
    sj, st = _pair(rng, (3, 9), 40.0)
    _close(tl._softcap(st, cap), jl._softcap(sj, cap))


def test_group_q():
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (2, 5, 8, 16))
    _close(tl._group_q(qt, 2), jl._group_q(qj, 2), 0.0)


ATTN_CASES = [
    # (b, s, t, hq, hkv, hd, causal, window, softcap, q_offset); two shapes only,
    # so the reference's eagerly compiled ops are reused across cases
    (2, 8, 8, 4, 2, 16, True, 0, 0.0, 0),
    (2, 8, 8, 4, 2, 16, True, 3, 0.0, 0),
    (2, 8, 8, 4, 2, 16, True, 0, 30.0, 0),
    (2, 8, 16, 4, 2, 16, False, 0, 0.0, 0),
    (2, 8, 16, 4, 2, 16, True, 0, 0.0, 8),
    (2, 8, 16, 4, 2, 16, True, 3, 0.0, 12),      # rows 18, 19 fully masked
]


def _qkv(case, seed=4):
    b, s, t, hq, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (_pair(rng, (b, s, hq, hd)), _pair(rng, (b, t, hkv, hd)),
            _pair(rng, (b, t, hkv, hd)))


def _mask_kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8], q_offset=case[9])


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_direct(case):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case)
    _close(tl.attention_direct(qt, kt, vt, **_mask_kw(case)),
           jl.attention_direct(qj, kj, vj, **_mask_kw(case)))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_direct_lse(case):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case)
    o, lse = tl.attention_direct_lse(qt, kt, vt, **_mask_kw(case))
    ro, rlse = jl.attention_direct_lse(qj, kj, vj, **_mask_kw(case))
    _close(o, ro)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv_len,return_lse", [(None, False), (13, False),
                                                (None, True), (13, True)])
def test_attention_blockwise(kv_len, return_lse):
    case = (2, 8, 16, 4, 2, 16, True, 0, 0.0, 6)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, seed=5)
    kw = dict(_mask_kw(case), block_size=4, kv_len=kv_len, return_lse=return_lse)
    ours, ref = tl.attention_blockwise(qt, kt, vt, **kw), \
        jl.attention_blockwise(qj, kj, vj, **kw)
    if return_lse:
        _close(ours[1], ref[1])
        ours, ref = ours[0], ref[0]
    _close(ours, ref)


def test_attention_plain_matches_reference_xla():
    case = (2, 8, 16, 4, 2, 16, True, 4, 20.0, 0)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, seed=6)
    kw = _mask_kw(case)
    del kw["q_offset"]
    _close(tl.attention(qt, kt, vt, impl="plain", **kw),
           jl.attention(qj, kj, vj, impl="xla", **kw))


def _cfg(arch, bias):
    cfg = get_smoke_config(arch)
    return (dataclasses.replace(cfg, qkv_bias=bias),
            dataclasses.replace(torch_smoke_config(arch), qkv_bias=bias))


@pytest.mark.parametrize("bias", [False, True])
def test_init_attn_and_mlp_structure(bias):
    jcfg, tcfg = _cfg("qwen2.5-14b", bias)
    ref = jl.init_attn(jax.random.PRNGKey(0), jcfg)
    ours = tl.init_attn(torch.Generator().manual_seed(0), tcfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape and ours[k].dtype == torch.float32
    ref_m = jl.init_mlp(jax.random.PRNGKey(0), 64, 96)
    ours_m = tl.init_mlp(torch.Generator().manual_seed(0), 64, 96)
    assert {k: tuple(v.shape) for k, v in ours_m.items()} == \
        {k: v.shape for k, v in ref_m.items()}


@pytest.mark.parametrize("bias", [False, True])
def test_qkv_proj_and_attn_block(bias):
    jcfg, tcfg = _cfg("qwen2.5-14b", bias)
    rng = np.random.default_rng(7)
    p = {k: np.asarray(v) for k, v in
         jl.init_attn(jax.random.PRNGKey(1), jcfg).items()}
    if bias:
        p.update({k: rng.standard_normal(p[k].shape).astype(np.float32)
                  for k in ("bq", "bk", "bv")})
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    xj, xt = _pair(rng, (2, 6, jcfg.d_model))
    for o, r in zip(tl.qkv_proj(pt, xt, tcfg, torch.float32),
                    jl.qkv_proj(pj, xj, jcfg, jnp.float32)):
        _close(o, r)
    pos = np.arange(6)
    _close(tl.attn_block(pt, xt, tcfg, positions=torch.from_numpy(pos),
                         dtype=torch.float32, impl="plain"),
           jl.attn_block(pj, xj, jcfg, positions=jnp.asarray(pos),
                         dtype=jnp.float32, impl="xla"))


def test_mlp_block():
    rng = np.random.default_rng(8)
    p = {k: np.asarray(v) for k, v in
         jl.init_mlp(jax.random.PRNGKey(2), 32, 80).items()}
    xj, xt = _pair(rng, (2, 5, 32))
    _close(tl.mlp_block({k: torch.from_numpy(v.copy()) for k, v in p.items()}, xt,
                        torch.float32),
           jl.mlp_block({k: jnp.asarray(v) for k, v in p.items()}, xj, jnp.float32))
