"""The roofline and the collective bytes (``repro_torch.perf.roofline``,
``launch.mesh``'s counters) against the reference's ``perf/roofline.py``:

- ``model_flops_for`` on the ten configs and four shapes (1e-12 relative);
- ``link_bytes`` against ``parse_collectives(...).link_bytes`` on one
  synthetic HLO line per kind at n = 2, 4, 8;
- ``Roofline``'s terms and row, with the reference's fields (``hlo_flops``
  and ``hlo_bytes`` named ``flops`` and ``bytes``: the port's reckoning);
- the byte floors of a train and a decode step;
- ``chip_smoke.py`` holding no copy of the H100 constants or the FLOP
  reckoning, only the names imported from ``perf/roofline.py``;
- on 2 gloo ranks (CPU subprocesses), every ``DataMesh`` and ``ModelRing``
  collective counting ``link_bytes`` of the tensor it moved, under the kind
  its ``seconds`` uses."""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from repro.core import ARCH_IDS, SHAPES_BY_NAME
from repro.launch.stepbuilder import resolve_config as ref_resolve_config
from repro.perf import roofline as ref_roofline
from repro_torch.core import ParallelPlan, get_smoke_config
from repro_torch.core.tree import leaves
from repro_torch.launch import DataMesh, ModelRing, init_data_mesh, resolve_config
from repro_torch.models import build_model
from repro_torch.perf import roofline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HLO_OPS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    for shape in SHAPES_BY_NAME.values():
        ref = ref_roofline.model_flops_for(ref_resolve_config(arch, shape.name), shape)
        ours = roofline.model_flops_for(resolve_config(arch, shape.name), shape)
        assert abs(ours - ref) <= 1e-12 * abs(ref), shape.name


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", roofline.COLLECTIVE_KINDS)
def test_link_bytes_match_the_reference_ring_model(kind, n):
    """One HLO line of ``kind`` over a group of n: the reference parses its
    result's bytes (f32[1024,96], 393,216 bytes) and costs it."""
    line = (f"  %x.1 = f32[1024,96]{{1,0}} {HLO_OPS[kind]}(f32[1024,96]{{1,0}} %p.0), "
            f"replica_groups=[{16 // n},{n}]<=[16]")
    stats = ref_roofline.parse_collectives(line, 16)
    assert stats.counts[kind] == 1 and stats.result_bytes[kind] == 1024 * 96 * 4
    assert roofline.link_bytes(kind, 1024 * 96 * 4, n) == stats.link_bytes[kind]
    assert roofline.link_bytes(kind, 1024 * 96 * 4, 1) == 0.0
    with pytest.raises(ValueError):
        roofline.link_bytes("send", 1, n)


def test_roofline_terms_and_row():
    r = roofline.Roofline("qwen1.5-4b", "train_4k", "1", 1, flops=2e15, bytes=4e11,
                          collective_bytes=9e9, model_flops=1.8e15,
                          collectives={"all_reduce": 9e9})
    assert r.t_compute == 2e15 / roofline.PEAK_BF16_FLOPS == 2e15 / 989e12
    assert r.t_memory == 4e11 / roofline.PEAK_BYTES == 4e11 / 3.35e12
    assert r.t_collective == 9e9 / roofline.NVLINK_BYTES_PER_DIRECTION == 9e9 / 450e9
    assert r.bottleneck == "compute" and r.useful_flops_ratio == 0.9
    ref = ref_roofline.Roofline("qwen1.5-4b", "train_4k", "1", 1, hlo_flops=2e15,
                                hlo_bytes=4e11, collective_bytes=9e9, model_flops=1.8e15,
                                collectives={"all_reduce": 9e9})
    rename = {"hlo_flops_per_device": "flops_per_device",
              "hlo_bytes_per_device": "bytes_per_device"}
    assert set(r.row()) == {rename.get(k, k) for k in ref.row()}
    assert r.row()["useful_flops_ratio"] == ref.row()["useful_flops_ratio"]
    assert roofline.Roofline("a", "s", "1", 1, 1.0, 1e6, 0.0, 1.0).bottleneck == "memory"
    assert math.isnan(roofline.Roofline("a", "s", "4", 4, 0.0, 0.0, 1.0, 1.0).useful_flops_ratio)


def test_byte_floors_of_a_step():
    """Train: params, grads (their dtype) and both fp32 moments, each read and
    written once. Decode: params and cache, each read once."""
    cfg = get_smoke_config("qwen1.5-4b")
    for dtype, size in (("float32", 4), ("bfloat16", 2)):
        model = build_model(cfg, ParallelPlan(param_dtype=dtype), device="meta")
        params = model.init(torch.Generator())
        n = sum(t.numel() for t in leaves(params))
        held = sum(t.numel() * t.element_size() for t in leaves(params))
        assert held < n * size + 1e6        # norm scales stay fp32
        assert roofline.train_bytes(params) == 2 * (2 * held + 8 * n)
        cache = model.init_cache(2, 32)
        assert roofline.decode_bytes(params, cache) == held + sum(
            t.numel() * t.element_size() for t in leaves(cache))


def test_chip_smoke_holds_one_copy_of_the_constants_and_the_flop_reckoning():
    from test_torch_dp import SMOKE
    names = ("PEAK_BF16_FLOPS", "PEAK_BYTES", "train_flops", "ssd_flops", "n_apps")
    for name in names:
        assert getattr(SMOKE, name) is getattr(roofline, name), name
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    defined |= {t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
                if isinstance(t, ast.Name)}
    assert not defined & set(names + ("encdec_train_flops",))


# ---------------------------------------------------------------------------
# the meshes' counters on 2 gloo ranks

CHILD = ("import sys, json; sys.path[:0] = sys.argv[1:3]; import test_torch_roofline as t; "
         "t._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])")


def _counted(mesh, call):
    """Run ``call``; what ``mesh`` counted meanwhile, as {kind: [count,
    result bytes, link bytes]} of the kinds that moved."""
    before = mesh.collective_stats()
    call()
    d = mesh.collective_stats() - before
    return {k: [d.counts[k], d.result_bytes[k], d.link_bytes[k]] for k in d.counts
            if d.counts[k]}


def _rank_main(rank, n, store_path, out_dir):
    torch.set_num_threads(1)
    mesh = init_data_mesh("cpu", init_method=f"file://{store_path}", rank=rank, world_size=n)
    ring = ModelRing(mesh.group, tuple(range(n)), "cpu")
    x = torch.arange(6 * 10, dtype=torch.float32).reshape(6, 10) + rank
    ints = torch.arange(3, dtype=torch.int64) + rank
    out = {
        "all_reduce_sum": _counted(mesh, lambda: mesh.all_reduce_sum(x.clone())),
        "all_reduce_int": _counted(mesh, lambda: mesh.all_reduce_int(ints.clone(), "max")),
        "reduce_scatter_mean": _counted(mesh, lambda: mesh.reduce_scatter_mean(x)),
        "all_gather": _counted(mesh, lambda: mesh.all_gather(x[:3].contiguous())),
        "broadcast_": _counted(mesh, lambda: mesh.broadcast_(x.clone(), 1)),
        "reduce_mean_": _counted(mesh, lambda: mesh.reduce_mean_(x.clone(), 0)),
        "shift": _counted(ring, lambda: ring.shift(x, 1)),
        "shift_a2a": _counted(ring, lambda: ring.shift(x.bfloat16(), -1, kind="a2a")),
        "chain": _counted(ring, lambda: ring.shift(x, 1, wrap=False)),
        "all_to_all": _counted(ring, lambda: ring.all_to_all(x.reshape(n, -1))),
        "ring_all_reduce_sum": _counted(ring, lambda: ring.all_reduce_sum(x)),
        "ring_all_reduce_max": _counted(ring, lambda: ring.all_reduce_max(x)),
        "seconds_kinds": [sorted(mesh.seconds), sorted(ring.seconds)],
        "stats_kinds": [sorted(mesh.collective_stats().counts),
                        sorted(ring.collective_stats().counts)],
    }
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    mesh.close()


def test_mesh_collectives_count_their_link_bytes(tmp_path):
    """Each collective of a 2-rank ``DataMesh`` and ``ModelRing`` counts one
    call, its result's bytes and ``link_bytes`` of the tensor it moved, under
    its ``seconds`` kind: a broadcast as an all-gather of its tensor, a
    reduce to one rank as a reduce-scatter of it; a chain's last rank sends
    nothing and counts no link bytes. One process's mesh counts nothing."""
    from test_torch_dp import run_ranks
    n = 2
    run_ranks(n, tmp_path, CHILD, [], timeout=120)
    lb = roofline.link_bytes
    full, half, ints = 6 * 10 * 4, 3 * 10 * 4, 3 * 8
    want = {
        "all_reduce_sum": {"all_reduce": [1, full, lb("all-reduce", full, n)]},
        "all_reduce_int": {"all_reduce": [1, ints, lb("all-reduce", ints, n)]},
        "reduce_scatter_mean": {"reduce_scatter": [1, half, lb("reduce-scatter", half, n)]},
        "all_gather": {"all_gather": [1, full, lb("all-gather", full, n)]},
        "broadcast_": {"all_gather": [1, full, lb("all-gather", full, n)]},
        "reduce_mean_": {"reduce_scatter": [1, full, lb("reduce-scatter", full / n, n)]},
        "shift": {"tick": [1, full, lb("collective-permute", full, n)]},
        "shift_a2a": {"a2a": [1, full // 2, lb("collective-permute", full // 2, n)]},
        "all_to_all": {"a2a": [1, full, lb("all-to-all", full, n)]},
        "ring_all_reduce_sum": {"all_reduce": [1, full, lb("all-reduce", full, n)]},
        "ring_all_reduce_max": {"all_reduce": [1, full, lb("all-reduce", full, n)]},
    }
    for r in range(n):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for call, w in want.items():
            assert got[call] == w, (r, call, got[call])
        chain = [1, full, lb("collective-permute", full, n) if r < n - 1 else 0.0]
        assert got["chain"] == {"tick": chain}, r
        assert got["seconds_kinds"] == got["stats_kinds"]
    one = DataMesh()
    one.all_reduce_sum(torch.ones(3))
    assert sum(one.collective_stats().counts.values()) == 0
