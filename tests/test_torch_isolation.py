"""The port stands alone: no JAX and nothing of the reference package in its
modules or in chip_smoke.py; entry points default to the CUDA card and raise
without it; the dispatcher takes the plain path for CPU tensors."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core import ParallelPlan, get_smoke_config, resolve_device
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_lse
from repro_torch.models import build_model, layers

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_the_port():
    assert len(PORT_FILES) > 20
    assert "torch" in _imported_roots(REPO / "src/repro_torch/kernels/flash_attention.py")


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    cfg = get_smoke_config("qwen2.5-14b")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"layers": {}}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, device="cuda")


def test_dispatch_takes_plain_attention_on_cpu():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 12, 4, 32, generator=g)
    k = torch.randn(1, 12, 2, 32, generator=g)
    v = torch.randn(1, 12, 2, 32, generator=g)
    assert dispatch.select_impl("auto", head_dim=32, device="cpu") == "plain"
    before = flash_attention_lse.launches
    out = dispatch.dispatch_attention(q, k, v, impl="auto", window=5)
    assert flash_attention_lse.launches == before
    assert torch.equal(out, layers.attention_direct(q, k, v, window=5))


@pytest.mark.parametrize("impl,head_dim,device,expected", [
    ("plain", 128, "cuda", "plain"),
    ("plain", 96, "cpu", "plain"),
    ("auto", 128, "cuda", "cuda"),
    ("auto", 64, "cpu", "plain"),
    ("cuda", 256, "cuda", "cuda"),
    ("cuda", 64, "cpu", ValueError),      # "cuda" forces the kernel: no CPU mode
    ("auto", 96, "cuda", ValueError),     # no kernel body for hd 96
    ("auto", 100, "cuda", ValueError),    # no fall-back to the twin
    ("cuda", 512, "cuda", ValueError),
    ("pallas", 64, "cpu", ValueError),
])
def test_select_impl_rules(impl, head_dim, device, expected):
    if expected is ValueError:
        with pytest.raises(ValueError):
            dispatch.select_impl(impl, head_dim=head_dim, device=device)
    else:
        assert dispatch.select_impl(impl, head_dim=head_dim, device=device) == expected


def test_select_impl_reads_the_kernels_head_dims():
    for hd in range(8, 513, 8):
        ok = hd in HEAD_DIMS
        try:
            assert dispatch.select_impl("auto", head_dim=hd, device="cuda") == "cuda"
        except ValueError:
            ok = not ok
        assert ok, hd


def test_plan_validates_attn_impl():
    cfg = get_smoke_config("qwen2.5-14b")
    ParallelPlan(attn_impl="cuda").validate(cfg)
    with pytest.raises(ValueError, match="attn_impl"):
        ParallelPlan(attn_impl="xla").validate(cfg)


@pytest.mark.parametrize("knob", ["tp", "cp", "pp", "ep", "zero_stage",
                                  "moe_gemm_impl"])
def test_plan_has_no_knob_the_port_does_not_implement(knob):
    with pytest.raises(TypeError, match=knob):
        ParallelPlan(**{knob: 2})


@pytest.mark.parametrize("plan", [ParallelPlan(compute_dtype="float16"),
                                  ParallelPlan(pad_vocab_to_multiple=-1),
                                  ParallelPlan(remat="partial"),
                                  ParallelPlan(microbatches=0),
                                  ParallelPlan(param_dtype="float16")])
def test_plan_validate_rejects_bad_values(plan):
    with pytest.raises(ValueError):
        plan.validate(get_smoke_config("qwen2.5-14b"))


def test_dispatch_pads_long_unaligned_kv_for_the_plain_path():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 4, 2, 16, generator=g)
    k = torch.randn(1, 11, 2, 16, generator=g)
    v = torch.randn(1, 11, 2, 16, generator=g)
    out = dispatch.dispatch_attention(q, k, v, impl="plain", q_offset=7, block_size=4)
    ref = layers.attention_direct(q, k, v, q_offset=7)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
