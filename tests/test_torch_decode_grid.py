"""Serving on a (data, model) grid (A13.6): the sequence-sharded decode cache
and the sequence-sharded prefill, on gloo ranks as CPU subprocesses (a
``file://`` store under ``tmp_path``, as ``tests/test_torch_dp.py``): 2 ranks
on a (1, 2) grid, then 4 on (2, 2) and (1, 4) in turn.

The reference's sharded decode branch cannot run on this host's jax
(``tests/test_decode.py::test_distributed_decode_attention`` fails here, as
on every tree since the seed), so the grid is held to the reference's
single-device functions on the same numpy inputs and converted weights:

- the sharded ``decode_attention`` against the reference's single-device
  ``decode_attention`` on the whole cache: pos 0, 7, 31 and both sides of a
  block edge, window 0 and 5, with and without a softcap, GQA; the rank's
  rows of the output within 1e-5 and its block of the written cache within
  1e-6 (the reference test's own limits);
- prefill then decode steps that cross the block edge, against the
  reference's ``prefill``/``decode_step`` (``fill_cross`` for whisper; the
  SSM families serve the prompt through ``decode_step``), at 1e-5 of each
  logits tensor's largest value: the smoke dense model (gemma2: alternating
  windows, softcaps, post-norms), MoE (olmoe at a capacity that drops
  nothing), the hybrid (zamba2), the SSM (mamba2) and whisper, with a prompt
  the model axis divides and one it does not;
- the same runs against the port's one process on the rank's rows, at 1e-6
  of each tensor's largest value.

Also the ``dp_over_model`` remap on (1, 2): the model ranks split the
batch's rows. In this process: ``cache_specs``' K/V entries against the
reference's."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import ParallelPlan, get_smoke_config
from repro_torch.core.sharding import cache_specs, kv_cache_spec, seq_block
from repro_torch.core.tree import named_leaves

torch.set_num_threads(1)

B, T = 4, 16                                   # batch rows, max_seq
GRIDS = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
ATTN = dict(b=4, t=32, hq=8, hkv=2, hd=16)     # tests/test_decode.py's shapes
ATTN_CASES = [(pos, window, softcap) for pos in (0, 7, 31, "edge-1", "edge")
              for window in (0, 5) for softcap in (0.0, 30.0)]
ARCHS = ["gemma2-9b", "olmoe-1b-7b", "zamba2-1.2b", "mamba2-370m", "whisper-small"]
PROMPTS = {2: (8, 7), 4: (8, 6)}               # the model axis divides the first only
STEPS = 6                                      # decode steps after the prompt: past 8
LIMIT, CACHE_LIMIT, ONE_LIMIT = 1e-5, 1e-6, 1e-6
REMAP_ARCH = "gemma2-9b"


def _config(arch):
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


def _attn_inputs():
    rng = np.random.default_rng(0)
    a = ATTN
    shapes = {"q": (a["b"], 1, a["hq"], a["hd"]), "kc": (a["b"], a["t"], a["hkv"], a["hd"]),
              "vc": (a["b"], a["t"], a["hkv"], a["hd"]), "kn": (a["b"], 1, a["hkv"], a["hd"]),
              "vn": (a["b"], 1, a["hkv"], a["hd"])}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _pos(pos, m):
    t_loc = ATTN["t"] // m
    return {"edge-1": t_loc - 1, "edge": t_loc}.get(pos, pos)


def _tokens(cfg, s):
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab, (B, s + STEPS)).astype(np.int64)


def _frames(cfg):
    rng = np.random.default_rng(2)
    return rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _serve(model, params, cfg, s, tokens, rows=slice(None)):
    """Prefill (or fill_cross / the prompt through decode_step) then STEPS
    decode steps of ``rows`` of the batch: [prompt logits or None, logits of
    each step]."""
    tok = torch.from_numpy(tokens[rows])
    out = []
    if hasattr(model, "prefill"):
        logits, cache = model.prefill(params, {"tokens": tok[:, :s]}, T)
        out.append(logits)
        start = s
    else:
        cache = model.init_cache(tok.shape[0], T)
        if cfg.is_enc_dec:
            model.fill_cross(params, cache, torch.from_numpy(_frames(cfg)[rows]))
        out.append(None)
        start = 0
    for p in range(start, s + STEPS):
        lg, cache = model.decode_step(params, cache, tok[:, p], p)
        out.append(lg)
    return out


def _rank_attn(grid, m):
    from repro_torch.serve.attention import decode_attention
    x = {k: torch.from_numpy(v) for k, v in _attn_inputs().items()}
    lo, hi = ((grid.data.rank * B // grid.data.size, (grid.data.rank + 1) * B // grid.data.size)
              if grid.data.size > 1 else (0, B))
    t_loc = ATTN["t"] // m
    start, stop = seq_block(t_loc, grid.model.rank)
    out = {}
    for pos, window, softcap in ATTN_CASES:
        p = _pos(pos, m)
        kc = x["kc"][lo:hi, start:stop].clone()
        vc = x["vc"][lo:hi, start:stop].clone()
        o, kc, vc = decode_attention(x["q"][lo:hi], kc, vc, x["kn"][lo:hi], x["vn"][lo:hi], p,
                                     window=window, softcap=softcap, mesh=grid)
        out[f"{pos}/{window}/{softcap}"] = {"o": o.numpy(), "k": kc.numpy(), "v": vc.numpy(),
                                            "rows": (lo, hi), "block": (start, stop)}
    return out


def _rank_models(grid, m, out_dir):
    from repro_torch.models import build_model
    res = {}
    for arch in ARCHS:
        cfg = _config(arch)
        params = torch.load(Path(out_dir) / f"{arch}.pt", weights_only=False)
        plan = ParallelPlan(compute_dtype="float32")
        one = build_model(cfg, plan, device="cpu")
        gm = build_model(cfg, plan, device="cpu", mesh=grid)
        for s in PROMPTS[grid.size]:
            tokens = _tokens(cfg, s)
            got = _serve(gm, params, cfg, s, tokens)
            lo, hi = gm.place.rows(B)
            # one process on the rank's rows: what differs is the grid's
            # sequence sharding alone (the rows' split is held to the
            # reference below)
            want = _serve(one, params, cfg, s, tokens, slice(lo, hi))
            chunk = gm.seq_chunk(s) if hasattr(gm, "seq_chunk") else (0, s)
            errs = []
            for i, (a, b) in enumerate(zip(got, want)):
                if a is None:
                    continue
                b = b if i else b[:, chunk[0]:chunk[1]]
                errs.append(float((a - b).abs().max() / b.abs().max()))
            last = (gm.last_logits(got[0], s).numpy() if hasattr(gm, "last_logits") else None)
            res[f"{arch}/{s}"] = {"logits": [None if a is None else a.numpy() for a in got],
                                  "rows": (lo, hi), "chunk": chunk, "one_err": max(errs),
                                  "last": last}
    return res


def _rank_remap(grid, out_dir):
    """The dense smoke model on a (1, 2) grid under ``dp_over_model``: the
    model axis carries the batch's rows, the cache is whole in T."""
    from repro_torch.models import build_model
    cfg = _config(REMAP_ARCH)
    params = torch.load(Path(out_dir) / f"{REMAP_ARCH}.pt", weights_only=False)
    gm = build_model(cfg, ParallelPlan(compute_dtype="float32", dp_over_model=True),
                     device="cpu", mesh=grid)
    s = PROMPTS[2][0]
    got = _serve(gm, params, cfg, s, _tokens(cfg, s))
    return {"logits": [a.numpy() for a in got], "rows": gm.place.rows(B),
            "seq_sharded": gm.init_cache(B, T).seq_sharded}


def _rank_main(rank, n, store_path, out_dir):
    """Every grid of GRIDS[n] in turn (a process group each): the attention
    cases and the models; results saved by grid; with 2 ranks also the
    remap's (1, 2) grid."""
    from repro_torch.launch import init_grid_mesh
    torch.set_num_threads(1)
    for i, (d, m) in enumerate(GRIDS[n]):
        grid = init_grid_mesh(d, m, "cpu", init_method=f"file://{store_path}{i}", rank=rank)
        res = {"attn": _rank_attn(grid, m), "models": _rank_models(grid, m, out_dir),
               "model_rank": grid.model.rank, "data_rank": grid.data.rank}
        torch.save(res, Path(out_dir) / f"{d}x{m}.rank{rank}.pt")
        grid.close()
    if n == 2:
        grid = init_grid_mesh(1, 2, "cpu", init_method=f"file://{store_path}_remap", rank=rank,
                              dp_over_model=True)
        torch.save(_rank_remap(grid, out_dir), Path(out_dir) / f"remap.rank{rank}.pt")
        grid.close()


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_decode_grid as t; "
         "t._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])")


def _ref_params(arch):
    """The reference's seed-0 params (SSM conv taps and gated-norm scale
    drawn, as the port's tests draw them: zeros would zero every scan
    input), as numpy."""
    import jax
    from repro.core import ParallelPlan as RefPlan
    from repro.core import get_smoke_config as ref_smoke
    from repro.models import build_model as ref_build
    cfg = dataclasses.replace(ref_smoke(arch), moe=_config(arch).moe)
    model = ref_build(cfg, RefPlan(remat="none", compute_dtype="float32"))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    for k in ("conv_x", "conv_B", "conv_C", "scale"):
        if "ssm" in params.get("layers", {}):
            params["layers"]["ssm"][k] = (
                0.3 * rng.standard_normal(params["layers"]["ssm"][k].shape)).astype(np.float32)
    return model, params


def _ref_serve(arch, model, params, s):
    import jax
    import jax.numpy as jnp
    cfg = model.cfg
    tokens = jnp.asarray(_tokens(cfg, s), jnp.int32)
    step = jax.jit(model.decode_step)
    out = []
    if "prefill" in model.extras:
        prefill = jax.jit(model.extras["prefill"], static_argnums=2)
        logits, cache = prefill(params, {"tokens": tokens[:, :s]}, T)
        out.append(np.asarray(logits))
        start = s
    else:
        cache = model.init_cache(B, T)
        if "fill_cross" in model.extras:
            cache = jax.jit(model.extras["fill_cross"])(params, cache, jnp.asarray(_frames(cfg)))
        out.append(None)
        start = 0
    for p in range(start, s + STEPS):
        lg, cache = step(params, cache, tokens[:, p], jnp.int32(p))
        out.append(np.asarray(lg))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's weights converted for the ranks, both groups run:
    {(d, m): [rank results]}, and the reference's serving outputs."""
    from test_torch_dp import run_ranks
    from repro_torch.interop import params_from_numpy
    ref = {}
    out = {"ref": ref}
    dirs = {n: tmp_path_factory.mktemp(f"grid{n}") for n in GRIDS}
    for arch in ARCHS:
        model, params = _ref_params(arch)
        tparams = params_from_numpy(params, _config(arch), device="cpu")
        for d in dirs.values():
            torch.save(tparams, d / f"{arch}.pt")
        for s in sorted({s for p in PROMPTS.values() for s in p}):
            ref[f"{arch}/{s}"] = _ref_serve(arch, model, params, s)
    for n, d in dirs.items():
        run_ranks(n, d, CHILD, [], timeout=300)
        for dm, mm in GRIDS[n]:
            out[(dm, mm)] = [torch.load(d / f"{dm}x{mm}.rank{r}.pt", weights_only=False)
                             for r in range(n)]
    out["remap"] = [torch.load(dirs[2] / f"remap.rank{r}.pt", weights_only=False)
                    for r in range(2)]
    return out


def _ref_attn():
    import jax.numpy as jnp
    from repro.serve.attention import decode_attention
    x = {k: jnp.asarray(v) for k, v in _attn_inputs().items()}
    out = {}
    for m in sorted({m for grids in GRIDS.values() for _, m in grids}):
        for pos, window, softcap in ATTN_CASES:
            o, k, v = decode_attention(x["q"], x["kc"], x["vc"], x["kn"], x["vn"],
                                       jnp.int32(_pos(pos, m)), window=window,
                                       softcap=softcap, mesh=None)
            out[(m, f"{pos}/{window}/{softcap}")] = tuple(np.asarray(a) for a in (o, k, v))
    return out


GRID_IDS = [g for grids in GRIDS.values() for g in grids]


@pytest.mark.parametrize("grid", GRID_IDS, ids=[f"{d}x{m}" for d, m in GRID_IDS])
def test_sharded_decode_attention_matches_the_reference(results, grid):
    ref = _ref_attn()
    for r in results[grid]:
        for key, got in r["attn"].items():
            o, k, v = ref[(grid[1], key)]
            (lo, hi), (a, b) = got["rows"], got["block"]
            assert float(np.abs(got["o"] - o[lo:hi]).max()) < LIMIT, (grid, key)
            assert float(np.abs(got["k"] - k[lo:hi, a:b]).max()) < CACHE_LIMIT, (grid, key)
            assert float(np.abs(got["v"] - v[lo:hi, a:b]).max()) < CACHE_LIMIT, (grid, key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", GRID_IDS, ids=[f"{d}x{m}" for d, m in GRID_IDS])
def test_grid_serving_matches_the_reference(results, grid, arch):
    """Every rank's rows (and, of a sharded prefill, its chunk's positions)
    of every logits tensor within 1e-5 of the tensor's largest value of the
    reference's single-device run; within 1e-6 of the port's one process; a
    sharded prefill's last row handed to every rank."""
    n = grid[0] * grid[1]
    for s in PROMPTS[n]:
        want = results["ref"][f"{arch}/{s}"]
        chunks = set()
        for r in results[grid]:
            got = r["models"][f"{arch}/{s}"]
            assert got["one_err"] <= ONE_LIMIT, (arch, s, got["one_err"])
            lo, hi = got["rows"]
            a, b = got["chunk"]
            chunks.add((a, b))
            for i, (x, y) in enumerate(zip(got["logits"], want)):
                if x is None:
                    continue
                y = y[lo:hi] if i else y[lo:hi, a:b]
                err = float(np.abs(x - y).max() / np.abs(y).max())
                assert err <= LIMIT, (arch, s, i, err)
            if got["last"] is not None:
                last = want[0][lo:hi, -1]
                assert float(np.abs(got["last"] - last).max() / np.abs(last).max()) <= LIMIT
        sharded = s % grid[1] == 0 and arch in ("gemma2-9b", "olmoe-1b-7b")
        assert len(chunks) == (grid[1] if sharded else 1), (arch, s, chunks)


def test_dp_over_model_serves_rows_over_the_model_axis(results):
    """Under the remap the model ranks split the batch's rows (B / 2 each)
    and hold the whole sequence of the cache; each rank's logits are the
    reference's rows at 1e-5."""
    s = PROMPTS[2][0]
    want = results["ref"][f"{REMAP_ARCH}/{s}"]
    seen = []
    for r in results["remap"]:
        lo, hi = r["rows"]
        seen.append((lo, hi))
        assert hi - lo == B // 2 and r["seq_sharded"] is False
        for x, y in zip(r["logits"], want):
            err = float(np.abs(x - y[lo:hi]).max() / np.abs(y[lo:hi]).max())
            assert err <= LIMIT, err
    assert sorted(seen) == [(0, B // 2), (B // 2, B)]


def _ref_cache_specs(arch, mesh, batch_axes, plan):
    """The reference's cache of the smoke config (shapes) and its
    ``cache_specs`` by leaf name."""
    import jax
    from repro.core import ParallelPlan as RefPlan
    from repro.core import get_smoke_config as ref_smoke
    from repro.core.sharding import cache_specs as ref_cache_specs
    from repro.models import build_model as ref_build
    rplan = RefPlan(seq_shard_decode=plan.seq_shard_decode)
    model = ref_build(ref_smoke(arch), rplan)
    cache = jax.eval_shape(lambda: model.init_cache(B, T))
    specs = ref_cache_specs(cache, rplan, mesh, batch_axes)
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return cache, dict(zip([n for n, _ in named_leaves(cache)], leaves))


class FakeMesh:
    """Shape-only stand-in (rules consult mesh.shape only)."""
    def __init__(self, **shape):
        self.shape = shape


def _norm(spec):
    """A spec's entries with a one-axis tuple written as its axis (as
    ``PartitionSpec`` normalises them)."""
    return tuple((e[0] if len(e) == 1 else tuple(e)) if isinstance(e, (tuple, list)) else e
                 for e in spec)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-1.2b", "whisper-small", "mamba2-370m"])
def test_cache_specs_kv_entries_match_the_reference(arch):
    """The K/V entries of ``cache_specs`` are the reference's on data/model
    meshes, with the batch over data, replicated, and over the model axis
    (which then carries no sequence), and with ``seq_shard_decode`` off; the
    SSM state and conv tails stay whole over the model ranks (the port's
    placement, ROADMAP queue C)."""
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 4}, {"data": 2, "model": 3}):
        for batch_axes in (("data",), (), ("data", "model")):
            for seq in (True, False):
                plan = ParallelPlan(seq_shard_decode=seq)
                mesh = FakeMesh(**shape)
                cache, ref = _ref_cache_specs(arch, mesh, batch_axes, plan)
                ours = cache_specs(cache, plan, mesh, batch_axes)
                assert set(ours) == set(ref)
                for name, spec in ours.items():
                    if name.split("/")[-1] in ("k", "v", "attn_k", "attn_v", "cross_k",
                                               "cross_v"):
                        assert _norm(spec) == _norm(tuple(ref[name])), (name, shape,
                                                                       batch_axes, seq)
                    else:
                        assert "model" not in spec[2:], name
    assert kv_cache_spec(ParallelPlan()) == (("data",), "model", None, None)
    assert kv_cache_spec(ParallelPlan(seq_shard_decode=False), ()) == (None, None, None, None)


def test_seq_block_and_the_prefill_chunk_rule():
    """Rank r holds positions [r T_loc, (r + 1) T_loc); the prefill splits a
    prompt over the model ranks only when the axis divides it and it is no
    shorter than the axis (the reference's no-op rule), and not at all
    without ``seq_shard_attn``."""
    import types
    from repro_torch.models.families import Placement
    assert [seq_block(4, r) for r in range(3)] == [(0, 4), (4, 8), (8, 12)]
    ring = types.SimpleNamespace(size=4, rank=1)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 4}, model=ring, flat=None,
                                 data=types.SimpleNamespace(size=1, rank=0))
    place = Placement(mesh, ParallelPlan())
    assert place.seq_chunk(8) == (2, 4) and place.seq_chunk(6) == (0, 6)
    assert place.seq_chunk(2) == (0, 2)
    assert Placement(mesh, ParallelPlan(seq_shard_attn=False)).seq_chunk(8) == (0, 8)
