"""Parameter exchange with the JAX reference: numpy -> port -> numpy is
bit-exact, and the converted tree has the port's layout and dtypes."""

import jax
import numpy as np
import pytest
import torch

from repro.core import ParallelPlan, get_smoke_config
from repro.models import build_model
from repro_torch.core import get_smoke_config as torch_smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

ARCHS = ["qwen1.5-4b", "qwen2.5-14b", "codeqwen1.5-7b", "gemma2-9b", "pixtral-12b",
         "olmoe-1b-7b", "deepseek-moe-16b", "mamba2-370m", "zamba2-1.2b"]


def _reference_params(arch):
    model = build_model(get_smoke_config(arch), ParallelPlan(remat="none"))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_is_bit_exact(arch):
    ref = _reference_params(arch)
    cfg = torch_smoke_config(arch)
    back = params_to_numpy(params_from_numpy(ref, cfg, device="cpu"), cfg)
    flat_ref, tree_ref = jax.tree.flatten(ref)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_layout_and_dtypes():
    arch = "gemma2-9b"
    ref = _reference_params(arch)
    cfg = torch_smoke_config(arch)
    params = params_from_numpy(ref, cfg, device="cpu", dtype="bfloat16")
    assert len(params["layers"]) == cfg.n_layers
    lp = params["layers"][1]
    np.testing.assert_array_equal(lp["attn"]["wq"].float().numpy(),
                                  ref["layers"]["attn"]["wq"][1].astype(
                                      np.float32).astype(jax.numpy.bfloat16)
                                  .astype(np.float32))
    assert lp["mlp"]["down"].dtype == torch.bfloat16
    assert lp["norm2_post"]["scale"].dtype == torch.float32
    assert params["final_norm"]["scale"].dtype == torch.float32


def test_bf16_conversion_keeps_the_ssm_fp32_leaves():
    """dt_bias, A_log, D and the SSM's gated-norm scale are read in fp32 by the
    block, so a bf16 conversion keeps them fp32 (and bit-exact); the matrices
    and conv taps go to bf16."""
    arch = "zamba2-1.2b"
    ref = _reference_params(arch)
    cfg = torch_smoke_config(arch)
    params = params_from_numpy(ref, cfg, device="cpu", dtype="bfloat16")
    for i, lp in enumerate(params["layers"]):
        for k in ("dt_bias", "A_log", "D", "scale"):
            assert lp["ssm"][k].dtype == torch.float32, k
            assert np.array_equal(lp["ssm"][k].numpy(), ref["layers"]["ssm"][k][i])
        for k in ("wz", "wx", "wdt", "conv_x", "out_proj"):
            assert lp["ssm"][k].dtype == torch.bfloat16, k
        assert lp["norm1"]["scale"].dtype == torch.float32
    assert params["shared_attn"]["norm2"]["scale"].dtype == torch.float32
    assert params["shared_attn"]["mlp"]["gate"].dtype == torch.bfloat16


def test_layer_count_mismatch_raises():
    ref = _reference_params("qwen2.5-14b")
    cfg = torch_smoke_config("qwen1.5-4b")
    bad = cfg.__class__(**{**cfg.__dict__, "n_layers": cfg.n_layers + 1})
    with pytest.raises(ValueError, match="n_layers"):
        params_from_numpy(ref, bad, device="cpu")
