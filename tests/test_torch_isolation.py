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


@pytest.mark.parametrize("impl,device,expected", [
    ("plain", "cuda", "plain"),
    ("plain", "cpu", "plain"),
    ("auto", "cuda", "cuda"),
    ("auto", "cpu", "plain"),
    ("cuda", "cuda", "cuda"),
    ("cuda", "cpu", ValueError),          # "cuda" forces the kernel: no CPU mode
    ("xla", "cpu", ValueError),
])
def test_select_gemm_impl_rules(impl, device, expected):
    if expected is ValueError:
        with pytest.raises(ValueError):
            dispatch.select_gemm_impl(impl, device=device)
    else:
        assert dispatch.select_gemm_impl(impl, device=device) == expected


def test_dispatch_takes_the_plain_expert_gemm_on_cpu():
    from repro_torch.kernels import grouped_gemm as tg
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 6, 8, generator=g)
    w = torch.randn(3, 8, 5, generator=g)
    gs = torch.tensor([6, 0, 2], dtype=torch.int32)
    before = (tg.grouped_gemm.rows_launches, tg.grouped_gemm.contract_launches)
    out = dispatch.dispatch_expert_gemm(x, w, gs, impl="auto")
    assert (tg.grouped_gemm.rows_launches, tg.grouped_gemm.contract_launches) == before
    rows = torch.arange(6)[None, :, None] < gs[:, None, None]
    assert torch.equal(out, torch.einsum("ecd,edf->ecf", torch.where(rows, x, 0), w))


def test_plan_validates_attn_impl():
    cfg = get_smoke_config("qwen2.5-14b")
    ParallelPlan(attn_impl="cuda").validate(cfg)
    with pytest.raises(ValueError, match="attn_impl"):
        ParallelPlan(attn_impl="xla").validate(cfg)


@pytest.mark.parametrize("knob", ["tp", "cp", "pp", "ep", "zero_stage", "dp_shard"])
def test_plan_has_no_knob_the_port_does_not_implement(knob):
    """A plan cannot ask for a placement the port would ignore: the axes of
    later slices are not fields, ``zero_stage`` (the data-parallel slice)
    takes only the stages the port implements, 0 and 1, ``tp`` (the
    tensor-parallel slice) runs only the rings: ``tp_impl="gspmd"`` raises,
    ``cp`` (the context-parallel slice) takes its three modes, ``ep``
    (the expert-parallel slice) takes an integer degree on the MoE family
    and its three exchange modes, ``pp`` (the pipeline slice) its two
    schedules, and ``dp_shard`` (the ZeRO-3 slice) runs with data
    parallelism alone."""
    if knob == "ep":
        cfg = get_smoke_config("olmoe-1b-7b")
        for impl in ("auto", "blocking", "overlap"):
            ParallelPlan(ep=2, ep_impl=impl).validate(cfg)
        with pytest.raises(ValueError, match=knob):
            ParallelPlan(ep=0).validate(cfg)
        with pytest.raises(ValueError, match="ep_impl"):
            ParallelPlan(ep=2, ep_impl="ring").validate(cfg)
        with pytest.raises(ValueError, match="MoE"):
            ParallelPlan(ep=2).validate(get_smoke_config("qwen2.5-14b"))
        return
    if knob == "cp":
        cfg = get_smoke_config("qwen2.5-14b")
        for impl in ("auto", "ring", "gather"):
            ParallelPlan(cp=2, cp_impl=impl).validate(cfg)
        with pytest.raises(ValueError, match=knob):
            ParallelPlan(cp=0).validate(cfg)
        with pytest.raises(ValueError, match="cp_impl"):
            ParallelPlan(cp=2, cp_impl="pallas").validate(cfg)
        return
    if knob == "tp":
        cfg = get_smoke_config("qwen2.5-14b")
        for impl in ("auto", "overlap"):
            ParallelPlan(tp=2, tp_impl=impl).validate(cfg)
        with pytest.raises(NotImplementedError, match="gspmd"):
            ParallelPlan(tp=2, tp_impl="gspmd").validate(cfg)
        with pytest.raises(ValueError, match=knob):
            ParallelPlan(tp=0).validate(cfg)
        return
    if knob == "zero_stage":
        cfg = get_smoke_config("qwen2.5-14b")
        for stage in (0, 1):
            ParallelPlan(zero_stage=stage).validate(cfg)
        with pytest.raises(ValueError, match=knob):
            ParallelPlan(zero_stage=2).validate(cfg)
        return
    if knob == "pp":
        cfg = get_smoke_config("qwen2.5-14b")
        for sched in ("gpipe", "1f1b"):
            ParallelPlan(pp=2, microbatches=2, pp_schedule=sched).validate(cfg)
        with pytest.raises(ValueError, match=knob):
            ParallelPlan(pp=0).validate(cfg)
        with pytest.raises(ValueError, match="pp_schedule"):
            ParallelPlan(pp=2, microbatches=2, pp_schedule="interleaved").validate(cfg)
        return
    if knob == "dp_shard":
        cfg = get_smoke_config("qwen2.5-14b")
        for kw in ({}, {"dp_over_model": True}, {"zero_stage": 0}):
            ParallelPlan(dp_shard=2, **kw).validate(cfg)
        with pytest.raises(ValueError, match=knob):
            ParallelPlan(dp_shard=0).validate(cfg)
        with pytest.raises(ValueError, match=knob):
            ParallelPlan(dp_shard=2, tp=2).validate(cfg)
        return
    with pytest.raises(TypeError, match=knob):
        ParallelPlan(**{knob: 2})


@pytest.mark.parametrize("impl", ["auto", "plain", "cuda", "xla", "pallas"])
def test_plan_validates_ssm_impl(impl):
    cfg = get_smoke_config("mamba2-370m")
    if impl in ("auto", "plain", "cuda"):
        ParallelPlan(ssm_impl=impl).validate(cfg)
    else:
        with pytest.raises(ValueError, match="ssm_impl"):
            ParallelPlan(ssm_impl=impl).validate(cfg)


def test_dispatch_takes_the_plain_ssd_scan_on_cpu():
    from repro_torch.kernels import ssd_scan as ts
    from repro_torch.models.ssm import ssd_scan
    g = torch.Generator().manual_seed(3)
    x, B, C = (torch.randn(1, 16, *s, generator=g) for s in ((2, 4), (1, 4), (1, 4)))
    dt = torch.rand(1, 16, 2, generator=g) * 0.1
    A = -torch.rand(2, generator=g)
    before = (ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches)
    y, s = dispatch.dispatch_ssd_scan(x, dt, A, B, C, chunk=8, impl="auto")
    assert (ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches) == before
    ry, rs = ssd_scan(x, dt, A, B, C, chunk=8)
    assert torch.equal(y, ry) and torch.equal(s, rs)


@pytest.mark.parametrize("plan", [ParallelPlan(compute_dtype="float16"),
                                  ParallelPlan(pad_vocab_to_multiple=-1),
                                  ParallelPlan(remat="partial"),
                                  ParallelPlan(microbatches=0),
                                  ParallelPlan(param_dtype="float16"),
                                  ParallelPlan(moe_gemm_impl="pallas"),
                                  ParallelPlan(moe_dispatch="sparse")])
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
