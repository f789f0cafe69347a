"""Tensor parallelism in one process: the rings' preconditions, the overlap
layout against the reference's, cutting a param tree into TP shards and
gathering it back, and the plan's ``tp`` / ``tp_impl`` knobs. The rings
themselves run on spawned ranks (``tests/test_torch_tp_ranks.py``)."""

import types

import numpy as np
import pytest
import torch

from repro_torch.core import Family, ModelConfig, MoEConfig, ParallelPlan, SSMConfig
from repro_torch.core import get_smoke_config
from repro_torch.core.sharding import (gather_params, overlap_param_specs,
                                       overlap_spec_for_param, shard_params, tp_dim)
from repro_torch.core.tree import named_leaves, stacked_shape
from repro_torch.kernels.dispatch import dispatch_tp_matmul, select_tp_impl
from repro_torch.models import build_model
from repro_torch.train.executor import ParallelContext, local_context, resolve_context
from repro_torch.train.tensor_parallel import check_overlap_support

# the reference test's tiny configs (tests/test_tensor_parallel.py:205-216)
DENSE = ModelConfig("tiny", Family.DENSE, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab=128)
MOE = ModelConfig("tmoe", Family.MOE, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=0, vocab=128, moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                                                   num_shared_experts=1, capacity_factor=2.0))
SSM = ModelConfig("tssm", Family.SSM, n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
                  d_ff=0, vocab=128, ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8))
ARCHS = ["qwen1.5-4b", "deepseek-moe-16b", "mamba2-370m", "olmoe-1b-7b", "gemma2-9b"]


def _params(cfg, plan=None):
    model = build_model(cfg, plan or ParallelPlan(compute_dtype="float32"), device="cpu")
    return model.init(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# preconditions (the reference test's own cases, test_tensor_parallel.py:45-67)


def test_overlap_support_accepts_the_reference_case():
    check_overlap_support(ModelConfig("t", Family.DENSE, 2, 64, 4, 2, 128, 128),
                          ParallelPlan(tp_impl="overlap"), 2)


@pytest.mark.parametrize("case", ["heads", "vocab", "family", "n_groups"])
def test_overlap_support_refuses(case):
    cfg = {
        "heads": ModelConfig("t", Family.DENSE, 2, 64, 4, 1, 128, 128),
        "vocab": ModelConfig("t", Family.DENSE, 2, 64, 4, 2, 128, 129),
        "family": ModelConfig("t", Family.HYBRID, 2, 64, 4, 2, 128, 128,
                              ssm=SSMConfig(d_state=16), shared_attn_every=2),
        "n_groups": ModelConfig("t", Family.SSM, 2, 64, 0, 0, 0, 128,
                                ssm=SSMConfig(d_state=16, head_dim=16, n_groups=2)),
    }[case]
    with pytest.raises(ValueError, match=case):
        check_overlap_support(cfg, ParallelPlan(), 2)


def test_overlap_support_takes_a_padded_vocab():
    cfg = ModelConfig("t", Family.DENSE, 2, 64, 4, 2, 128, 129)
    check_overlap_support(cfg, ParallelPlan(pad_vocab_to_multiple=2), 2)


@pytest.mark.parametrize("arch", ["whisper-small", "zamba2-1.2b", "pixtral-12b"])
def test_overlap_support_refuses_what_the_reference_refuses(arch):
    """Encoder-decoders, hybrids and VLMs stay off the rings, as in the
    reference (``decoder_only_support_errors``)."""
    with pytest.raises(ValueError, match="family"):
        check_overlap_support(get_smoke_config(arch), ParallelPlan(), 2)


# ---------------------------------------------------------------------------
# the overlap layout against the reference's


def _reference_specs(cfg):
    """The reference's ``overlap_param_specs`` on its own params of ``cfg``
    (the same fields), by flattened name, as tuples padded to each leaf's
    rank; and those params as numpy."""
    import jax
    from repro import core as jcore
    from repro.checkpoint.store import _flatten_with_names
    from repro.core.sharding import overlap_param_specs as ref_specs
    from repro.models import build_model as jax_build_model
    jcfg = getattr(jcore, "ModelConfig")(**{
        f: (getattr(jcore, type(v).__name__)(**v.__dict__)
            if isinstance(v, (MoEConfig, SSMConfig)) else v)
        for f, v in cfg.__dict__.items()})
    plan = jcore.ParallelPlan(compute_dtype="float32")
    params = jax_build_model(jcfg, plan).init(jax.random.PRNGKey(0))
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    specs = ref_specs(params, jcfg, plan, mesh)
    flat = dict(_flatten_with_names(params))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_spec)[0]:
        name = "/".join(str(p.key) for p in path)
        out[name] = tuple(spec) + (None,) * (len(flat[name].shape) - len(tuple(spec)))
    return out, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("which", ["dense", "moe", "ssm"])
def test_overlap_specs_match_the_reference(which):
    """Every leaf's spec, on the reference test's tiny configs and on the
    port's smoke configs of the three families."""
    from repro_torch.interop import params_from_numpy
    for cfg in ({"dense": DENSE, "moe": MOE, "ssm": SSM}[which],
                get_smoke_config({"dense": "qwen1.5-4b", "moe": "deepseek-moe-16b",
                                  "ssm": "mamba2-370m"}[which])):
        ref, ref_params = _reference_specs(cfg)
        ours = overlap_param_specs(params_from_numpy(ref_params, cfg, device="cpu"), cfg)
        assert ours == ref
        assert any("model" in s for s in ours.values())


def test_overlap_spec_for_param_classification():
    """The reference's unit cases (test_tensor_parallel.py:70-94)."""
    spec = overlap_spec_for_param
    assert spec(("layers", "attn", "wq"), (2, 64, 64)) == (None, None, "model")
    assert spec(("layers", "attn", "wo"), (2, 64, 64)) == (None, "model", None)
    assert spec(("embed", "tok"), (128, 64)) == ("model", None)
    assert spec(("lm_head", "w"), (64, 128)) == (None, "model")
    assert spec(("layers", "moe", "experts", "gate"), (2, 4, 64, 64)) == \
        (None, None, None, "model")
    assert spec(("layers", "moe", "experts", "down"), (2, 4, 64, 64)) == \
        (None, None, "model", None)
    assert spec(("layers", "norm1", "scale"), (2, 64)) == (None, None)
    assert spec(("layers", "ssm", "A_log"), (2, 8)) == (None, None)
    assert spec(("opt", "mu", "layers", "attn", "wq"), (2, 64, 64)) == (None, None, "model")
    assert tp_dim((None, "model")) == 1 and tp_dim((None, None)) is None


# ---------------------------------------------------------------------------
# cutting a tree into TP shards and back


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_and_gather_round_trip(arch, tp):
    """Every model rank's shards gathered back give the whole tree bit for
    bit; each shard has the layout's local shape, and a leaf kept whole is
    the same on every rank."""
    cfg = get_smoke_config(arch)
    params = _params(cfg)
    shards = [shard_params(params, r, tp) for r in range(tp)]
    back = gather_params(shards)
    specs = overlap_param_specs(params)
    whole = dict(named_leaves(params))
    for name, leaf in named_leaves(back):
        a, b = whole[name], leaf
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert torch.equal(x, y), name
        d = tp_dim(specs[name])
        for r, s in enumerate(shards):
            got = stacked_shape(dict(named_leaves(s))[name])
            want = list(stacked_shape(a))
            if d is not None:
                want[d] //= tp
            assert got == tuple(want), (name, r)
            if d is None:
                assert all(torch.equal(x, y) for x, y in zip(
                    leaves_of(dict(named_leaves(s))[name]), leaves_of(a))), name


def leaves_of(leaf):
    return leaf if isinstance(leaf, list) else [leaf]


def test_shards_are_their_own_leaves():
    """A rank's shards own their storage: writing one leaves the whole tree
    and the other rank's shards alone."""
    params = _params(get_smoke_config("qwen1.5-4b"))
    s0, s1 = shard_params(params, 0, 2), shard_params(params, 1, 2)
    before = params["layers"][0]["attn"]["wq"].clone()
    s0["layers"][0]["attn"]["wq"].zero_()
    assert torch.equal(params["layers"][0]["attn"]["wq"], before)
    assert not torch.equal(s1["layers"][0]["attn"]["wq"], s0["layers"][0]["attn"]["wq"])
    assert s0["layers"][0]["attn"]["wq"].is_contiguous()


def test_tp_params_from_numpy_is_the_cut_of_the_whole():
    from repro_torch.interop import params_from_numpy, params_to_numpy, tp_params_from_numpy
    cfg = get_smoke_config("mamba2-370m")
    tree = params_to_numpy(_params(cfg), cfg)
    whole = params_from_numpy(tree, cfg, device="cpu")
    for r in range(2):
        got = dict(named_leaves(tp_params_from_numpy(tree, cfg, r, 2, device="cpu")))
        for name, leaf in named_leaves(shard_params(whole, r, 2)):
            assert all(torch.equal(x, y) for x, y in zip(leaves_of(got[name]),
                                                         leaves_of(leaf))), name


# ---------------------------------------------------------------------------
# the plan's knobs and the placement


def test_tp_impl_gspmd_raises():
    cfg = get_smoke_config("qwen1.5-4b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParallelPlan(tp=2, tp_impl="gspmd").validate(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_tp_impl("gspmd")
    with pytest.raises(ValueError, match="tp_impl"):
        ParallelPlan(tp_impl="bogus").validate(cfg)


@pytest.mark.parametrize("impl", ["auto", "overlap"])
def test_tp_impl_auto_and_overlap_run_the_rings(impl):
    """The reference resolves "auto" to its GSPMD twin off the TPU; the port
    has none, and runs the rings (ROADMAP queue C)."""
    assert select_tp_impl(impl) == "overlap"
    ParallelPlan(tp=2, tp_impl=impl).validate(get_smoke_config("qwen1.5-4b"))


def _grid(model, data=1):
    ring = types.SimpleNamespace(size=model, rank=0)
    return types.SimpleNamespace(shape={"data": data, "model": model}, model=ring)


def test_resolve_context():
    """``plan.tp`` must be the model axis's size (1 without one): a plan that
    does not ask for tensor parallelism is refused on a model axis rather
    than run the whole model on every model rank."""
    cfg = get_smoke_config("qwen1.5-4b")
    assert resolve_context(cfg, ParallelPlan(), None) == local_context()
    assert resolve_context(cfg, ParallelPlan(tp_impl="overlap"), _grid(1)) == local_context()
    ctx = resolve_context(cfg, ParallelPlan(tp=2), _grid(2))
    assert isinstance(ctx, ParallelContext) and ctx.n_tp == 2
    for plan, grid in ((ParallelPlan(), _grid(2)), (ParallelPlan(tp_impl="overlap"), _grid(2)),
                       (ParallelPlan(tp=4), _grid(2)), (ParallelPlan(tp=2), None)):
        with pytest.raises(ValueError, match="plan.tp"):
            resolve_context(cfg, plan, grid)
    with pytest.raises(NotImplementedError, match="ROADMAP"):   # refused by the plan alone
        ParallelPlan(tp=2, tp_impl="gspmd").validate(cfg)
    with pytest.raises(ValueError, match="heads"):
        resolve_context(cfg, ParallelPlan(tp=8), _grid(8))


def test_dispatch_tp_matmul_is_the_plain_gemm():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 5, 6, generator=g), torch.randn(6, 3, generator=g)
    assert torch.equal(dispatch_tp_matmul(x, w), x @ w)


def test_executor_loss_needs_the_rings():
    """The TP loss refuses a placement without a model ring: no grid, or a
    grid whose plan does not ask for tensor parallelism."""
    from repro_torch.train.executor import make_executor_loss_fn
    cfg = get_smoke_config("qwen1.5-4b")
    for mesh in (None, _grid(2)):
        with pytest.raises(ValueError, match="model"):
            make_executor_loss_fn(cfg, ParallelPlan(), mesh)
