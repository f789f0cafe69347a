"""Context parallelism, in one process: the units of the cp slice against the
reference on numpy inputs, and — on a CUDA card only — B1 on the ring's tiles
and B2/B3 against a merged lse, each against its plain version.

- ``zigzag_permutation``, ``zigzag_pair_counts`` and ``select_cp_impl`` equal
  to the reference's on a grid of inputs; ``_merge_lse`` against the
  reference's on the same partials (fully masked ones included);
- ``dispatch_attention_lse`` and ``dispatch_attention_chunk_bwd`` against the
  reference's XLA twins (diagonal, full and ``q_offset`` tiles; the backward
  against statistics merged over more keys than the tile holds), 1e-5;
- ``ParallelPlan`` validation and the shard-local-routing warning as the
  reference's, ``resolve_context``'s routing, ``cp_local_positions``;
- ``ring_attention`` on a ring of one rank against ``dispatch_attention``,
  forward and grads (the multi-rank rings run in ``test_torch_cp_ranks.py``).

The module imports JAX only inside the tests that hold the port to the
reference, so the card's tests also run on the GPU machine, which has none:
``PYTHONPATH=src python -m pytest tests/test_torch_cp.py -m cuda``.
"""

import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import Family, ModelConfig, MoEConfig, ParallelPlan, SSMConfig
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import flash_attention as tf
from repro_torch.launch import ModelRing
from repro_torch.train import executor as tex

torch.set_num_threads(1)

DENSE = ModelConfig("t", Family.DENSE, 2, 64, 4, 4, 128, 128)
HYBRID = ModelConfig("t", Family.HYBRID, 2, 64, 4, 2, 128, 128, ssm=SSMConfig(d_state=16),
                     shared_attn_every=2)
TOL = 1e-5

# the tiles of the lse entries: (b, hq, hkv, s, t, hd, causal, q_offset): the
# ring's diagonal (causal) and full tiles, and the gather mode's causal
# q_offset over a longer KV (rank 3 of 4)
TILES = {"diagonal": (1, 4, 2, 16, 16, 16, True, 0),
         "full": (2, 4, 2, 16, 16, 16, False, 0),
         "q_offset": (1, 4, 2, 8, 32, 16, True, 24)}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the layout and the rules, against the reference


@pytest.mark.parametrize("seq,cp", [(16, 2), (32, 4), (48, 2), (24, 3), (64, 8), (4, 2)])
def test_zigzag_layout_matches_the_reference(seq, cp):
    from repro.train import executor as ref
    np.testing.assert_array_equal(tex.zigzag_permutation(seq, cp),
                                  ref.zigzag_permutation(seq, cp))
    counts = tex.zigzag_pair_counts(seq, cp)
    np.testing.assert_array_equal(counts, ref.zigzag_pair_counts(seq, cp))
    assert counts.min() == counts.max()            # the point of the zigzag


def test_zigzag_refuses_a_sequence_that_does_not_split():
    with pytest.raises(ValueError, match="2 cp"):
        tex.zigzag_permutation(18, 2)


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("raises", "ring" in str(e), "cp_impl" in str(e))


@pytest.mark.parametrize("impl", ["auto", "ring", "gather", "pallas"])
def test_select_cp_impl_matches_the_reference(impl):
    from repro.kernels.dispatch import select_cp_impl as ref_select
    for family in (Family.DENSE, Family.MOE, Family.SSM):
        for window in (0, 128):
            for alternating in (False, True):
                kw = dict(family=family, window=window, local_global_alternating=alternating)
                assert _outcome(tdispatch.select_cp_impl, impl, **kw) == \
                    _outcome(ref_select, impl, **kw), kw


def test_merge_lse_matches_the_reference():
    import jax.numpy as jnp
    from repro.train.executor import _merge_lse as ref_merge
    o, o_c = _draw((2, 8, 4, 16), 0), _draw((2, 8, 4, 16), 1)
    lse, lse_c = 3 * _draw((2, 8, 4), 2), 3 * _draw((2, 8, 4), 3)
    lse[:, :2] = -1e30                          # rows no tile has reached yet
    lse_c[:, 1:3] = -1e30                       # fully masked rows of the tile
    o[:, :2] = 0.0
    o_c[:, 1:3] = 0.0
    ours = tex._merge_lse(*(torch.from_numpy(a) for a in (o, lse, o_c, lse_c)))
    ref = ref_merge(*(jnp.asarray(a) for a in (o, lse, o_c, lse_c)))
    for a, b in zip(ours, ref):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _tile_inputs(case, seed=0):
    b, hq, hkv, s, t, hd, _, _ = case
    return (_draw((b, s, hq, hd), seed), _draw((b, t, hkv, hd), seed + 1),
            _draw((b, t, hkv, hd), seed + 2), _draw((b, s, hq, hd), seed + 3))


@pytest.mark.parametrize("name", list(TILES))
def test_attention_lse_matches_the_reference(name):
    import jax.numpy as jnp
    from repro.kernels.dispatch import dispatch_attention_lse as ref_lse
    case = TILES[name]
    q, k, v, _ = _tile_inputs(case)
    kw = dict(causal=case[6], q_offset=case[7])
    o, lse = tdispatch.dispatch_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    ro, rlse = ref_lse(*(jnp.asarray(a) for a in (q, k, v)), impl="xla", **kw)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(TILES))
def test_chunk_bwd_against_merged_stats_matches_the_reference(name):
    """The tile's (dq, dk, dv) against (lse, Δ) of attention over the tile's
    keys and as many more before them (the merged statistics of a ring row)."""
    import jax.numpy as jnp
    from repro.kernels.dispatch import dispatch_attention_chunk_bwd as ref_bwd
    from repro.models.layers import attention_direct_lse
    case = TILES[name]
    q, k, v, do = _tile_inputs(case, seed=4)
    k0, v0 = _draw(k.shape, 10), _draw(v.shape, 11)
    causal, q_offset = case[6], case[7]
    # the row's statistics over [k0, k]: the earlier keys fully visible
    o_all, lse_all = attention_direct_lse(
        jnp.asarray(q), jnp.concatenate([jnp.asarray(k0), jnp.asarray(k)], 1),
        jnp.concatenate([jnp.asarray(v0), jnp.asarray(v)], 1), causal=causal,
        q_offset=q_offset + k.shape[1])
    delta = np.array(jnp.sum(jnp.asarray(do) * o_all, axis=-1))
    lse = np.array(lse_all)
    kw = dict(causal=causal, q_offset=q_offset)
    ours = tdispatch.dispatch_attention_chunk_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, do, lse, delta)), **kw)
    ref = ref_bwd(*(jnp.asarray(a) for a in (q, k, v, do, lse, delta)), impl="xla", **kw)
    for a, b, what in zip(ours, ref, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32 and a.shape == b.shape, what
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL, err_msg=what)


def test_chunk_entries_take_the_plain_versions_on_the_cpu():
    """On a CPU tensor the entries reach the kernels' plain versions and
    launch nothing; "cuda" on a CPU tensor raises."""
    q, k, v, do = (torch.from_numpy(a) for a in _tile_inputs(TILES["diagonal"]))
    before = (tf.flash_attention_lse.launches, tf.flash_attention_bwd.dq_launches)
    o, lse = tdispatch.dispatch_attention_lse(q, k, v)
    delta = (do * o).sum(-1)
    tdispatch.dispatch_attention_chunk_bwd(q, k, v, do, lse, delta)
    assert (tf.flash_attention_lse.launches, tf.flash_attention_bwd.dq_launches) == before
    with pytest.raises(ValueError, match="cuda"):
        tdispatch.dispatch_attention_lse(q, k, v, impl="cuda")


# ---------------------------------------------------------------------------
# the plan, the placement and the layout


def test_cp_knob_validation_matches_the_reference():
    """The reference's ``test_cp_knob_validation``, on the port's plan."""
    with pytest.raises(ValueError, match="cp_impl"):
        ParallelPlan(cp_impl="bogus").validate(DENSE)
    with pytest.raises(ValueError, match="cp must be"):
        ParallelPlan(cp=0).validate(DENSE)
    ParallelPlan(cp=2, cp_impl="ring").validate(DENSE)
    with pytest.raises(ValueError, match="overlap"):
        ParallelPlan(cp=2, tp=2, tp_impl="gspmd").validate(DENSE)
    ParallelPlan(cp=2, tp=2, tp_impl="overlap").validate(DENSE)
    with pytest.raises(ValueError, match="dense/moe/ssm"):
        ParallelPlan(cp=2).validate(HYBRID)


def test_shard_local_routing_warning_matches_the_reference():
    """The reference's ``test_cp_token_dropping_divergence_is_flagged``: a
    dropping capacity warns under cp and tp, a no-drop one does not, and one
    device never does."""
    def moe(cf):
        return ModelConfig("t", Family.MOE, 2, 64, 4, 2, 0, 128,
                           moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, capacity_factor=cf))
    with pytest.warns(UserWarning, match="token-dropping"):
        ParallelPlan(cp=2).validate(moe(1.0))
    with pytest.warns(UserWarning, match="token-dropping"):
        ParallelPlan(tp=2, tp_impl="overlap").validate(moe(1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ParallelPlan(cp=2).validate(moe(2.0))
        ParallelPlan(tp=2, tp_impl="overlap").validate(moe(2.0))
        ParallelPlan().validate(moe(1.0))


class _Mesh:
    """A stand-in for a grid: its shape and rings (of one process)."""

    def __init__(self, **shape):
        self.shape = shape
        self.model = ModelRing()
        self.cp = ModelRing() if "cp" in shape else None
        self.size = 1


def test_resolve_context_routes_the_cp_axis():
    """The reference's ``test_executor_dispatch_routing`` on the port's
    placement, and the port's own refusals."""
    ctx = tex.resolve_context(DENSE, ParallelPlan(cp=2), _Mesh(data=1, cp=2))
    assert ctx.tp is None and ctx.cp is not None and ctx.cp_impl == "ring"
    assert ctx.data is None and ctx.n_rep == ctx.n_cp          # the aux sum's ranks: cp alone
    t = torch.tensor([3.0])
    assert torch.equal(ctx.aux_sum(t), t)                     # a ring of one process
    ctx = tex.resolve_context(DENSE, ParallelPlan(cp=2, cp_impl="gather"), _Mesh(data=1, cp=2))
    assert ctx.cp_impl == "gather"
    windowed = ModelConfig("t", Family.DENSE, 2, 64, 4, 4, 128, 128, sliding_window=8)
    assert tex.resolve_context(windowed, ParallelPlan(cp=2),
                               _Mesh(data=1, cp=2)).cp_impl == "gather"
    ctx = tex.resolve_context(DENSE, ParallelPlan(cp=2, tp=2), _Mesh(data=1, cp=2, model=2))
    assert ctx.tp is not None and ctx.cp is not None
    with pytest.raises(ValueError, match="cp"):
        tex.resolve_context(DENSE, ParallelPlan(cp=2), _Mesh(data=2))
    with pytest.raises(ValueError, match="cp"):
        tex.resolve_context(DENSE, ParallelPlan(), _Mesh(data=1, cp=2))
    with pytest.raises(ValueError, match="tp"):        # cp-only plan on a model axis (A13.4)
        tex.resolve_context(DENSE, ParallelPlan(cp=2), _Mesh(data=1, cp=2, model=2))
    with pytest.raises(ValueError, match="family"):
        tex.resolve_context(HYBRID, ParallelPlan(cp=2), _Mesh(data=1, cp=2))
    lc = tex.local_context()
    assert lc.tp is None and lc.cp is None and lc.n_tp == lc.n_cp == lc.n_rep == 1


def test_train_step_refuses_cp_without_a_cp_axis():
    """The reference's ``test_train_step_routes_cp``."""
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_train_step
    plan = ParallelPlan(cp=2, compute_dtype="float32")
    with pytest.raises(ValueError, match="cp"):
        make_train_step(build_model(DENSE, plan, device="cpu"), plan, Hyper(), mesh=None)


@pytest.mark.parametrize("impl", ["ring", "gather"])
def test_cp_local_positions_match_the_layout(impl):
    """Rank r's positions are its chunk of the (zigzag-permuted for the ring)
    sequence."""
    seq, cp = 24, 3
    perm = tex.zigzag_permutation(seq, cp) if impl == "ring" else np.arange(seq)
    for r in range(cp):
        ring = ModelRing()
        ring.rank, ring.size = r, cp
        ctx = tex.ParallelContext(cp=ring, cp_impl=impl)
        np.testing.assert_array_equal(tex.cp_local_positions(ctx, seq // cp,
                                                             impl == "ring").numpy(),
                                      perm[r * seq // cp:(r + 1) * seq // cp])


def test_straggler_monitor_times_the_cp_ring():
    """A plan with cp > 1 fans each step into per-rank ``cp.ring`` shares."""
    from repro_torch.ft.straggler import StragglerTimer
    mon = StragglerTimer(plan=ParallelPlan(cp=2))
    for step in range(3):
        mon.after_step(step, 0.1)
    assert set(mon.detector.recent("cp.ring")) == {0, 1}
    assert not mon.detector.recent("tp.ring")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_of_one_rank_is_causal_attention(dtype):
    """On a ring of one rank the zigzag pair is the whole sequence and the
    three tile cases add up to causal attention: forward and grads against
    ``dispatch_attention`` (B1-B3's plain versions on the CPU)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _tile_inputs(TILES["full"], seed=7))
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tex.ring_attention(ModelRing(), *ins)
    want = tdispatch.dispatch_attention(*ref, causal=True)
    (out.float() * do.float()).sum().backward()
    (want.float() * do.float()).sum().backward()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for a, b in zip(ins, ref):
        assert a.grad.dtype == dtype
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the card: B1 on the ring's tiles, B2/B3 against a merged lse


# (b, hq, hkv, lc, hd): the ring's sub-chunk tiles at the paths' head dims
CARD_TILES = [(1, 4, 2, 256, 128), (2, 4, 4, 200, 64)]


def _card_tiles(case, seed):
    """q and two KV sub-chunks on the card, bf16 head-major views of
    batch-major storage (the layout the ring hands the kernels)."""
    b, hq, hkv, lc, hd = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    smoke = _smoke()
    q = smoke.batch_major(gen, b, hq, lc, hd, torch.bfloat16)
    k0, v0, k1, v1 = (smoke.batch_major(gen, b, hkv, lc, hd, torch.bfloat16) for _ in range(4))
    do = smoke.batch_major(gen, b, hq, lc, hd, torch.bfloat16)
    return smoke, q, (k0, v0), (k1, v1), do


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_TILES)
@pytest.mark.parametrize("causal", [True, False], ids=["diagonal", "full"])
def test_b1_on_a_ring_tile_matches_plain_version_on_card(case, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    smoke, q, (k, v), _, _ = _card_tiles(case, seed=1)
    before = tf.flash_attention_lse.sm90_launches
    o, lse = tf.flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tf.flash_attention_lse.sm90_launches == before + 1
    po, plse = tf.flash_attention_lse_plain(q, k, v, causal=causal)
    o_abs, o_ulps, lse_rel = smoke.match_errors(o, lse, po, plse)
    assert smoke.within_tolerance(torch.bfloat16, o_abs, o_ulps, lse_rel), (o_abs, o_ulps, lse_rel)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_TILES)
@pytest.mark.parametrize("causal", [True, False], ids=["diagonal", "full"])
def test_b2_b3_against_a_merged_lse_match_plain_version_on_card(case, causal):
    """A ring row's statistics: (lse, Δ) merged over an earlier full tile and
    this tile; B2/B3 on this tile against them, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    smoke, q, (k0, v0), (k1, v1), do = _card_tiles(case, seed=2)
    o0, l0 = tf.flash_attention_lse_plain(q, k0, v0, causal=False)
    o1, l1 = tf.flash_attention_lse_plain(q, k1, v1, causal=causal)
    hm = lambda x: x.transpose(1, 2)            # noqa: E731
    init = (torch.zeros_like(hm(o0), dtype=torch.float32),
            torch.full(hm(l0[..., None])[..., 0].shape, -1e30, device="cuda"))
    o, lse = tex._merge_lse(*init, hm(o0), l0.transpose(1, 2))
    o, lse = tex._merge_lse(o, lse, hm(o1), l1.transpose(1, 2))
    lse = lse.transpose(1, 2).contiguous()
    delta = (do.float() * hm(o.to(torch.bfloat16)).float()).sum(-1)
    ours = tf.flash_attention_bwd(q, k1, v1, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    ref = tf.flash_attention_bwd_plain(q, k1, v1, do, lse, delta, causal=causal)
    errs = [smoke.grad_error(a, b) for a, b in zip(ours, ref)]
    assert smoke.grads_within(torch.bfloat16, errs), smoke.fmt_grad_errors(errs)
