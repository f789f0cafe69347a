"""The dry run (``repro_torch.launch.dryrun``) against the reference's, on the
CPU with no card:

- every record of the ten full configs x four shapes on the ``pod16x16``
  stand-in is ``ok``, ``skipped`` or ``unsupported``, never ``failed``:
  skipped exactly where the reference's ``skip_reason`` skips, unsupported
  exactly on the cases named here (``UNSUPPORTED``), every ``pod2x16x16``
  record unsupported (pods as data replicas);
- ``placement_bytes`` to the byte against the reference's specs for rank 0
  (``param_specs``, under tp ``overlap_param_specs`` and under ep
  ``ep_spec_for_param``, as ``tests/test_torch_stepbuilder.py`` holds them;
  ``opt_state_specs``; ``cache_specs``), where the port differs in layout
  (ZeRO-1 under tp; the SSM tails whole) with the difference named;
- a full config's step (olmoe-1b-7b, train_4k) traced on the 256-rank fake
  group: ``ok``, its grads' data sums carrying ``perf.roofline.link_bytes``
  of the leaves rank 0 holds, to the byte, and no kernel built or launched;
- on the smoke configs of the reference's six ``test_dryrun_integration``
  cases, each on a (1, 2) grid: the trace on meta tensors on the plain route
  against the same step run on real CPU tensors under ``MemTracker`` (the
  peak by category, to the byte), and the traced collectives against a real
  2-rank gloo run's ``collective_stats()``, to the byte;
- the tracker's in-place rule against a train step run with no dispatch
  mode active (the allocator's events under ``torch.profiler``), with
  ``MemTracker`` as PyTorch ships it as the control that must miss;
- tensors without data (fake ``cuda`` tensors under ``FakeTensorMode``, and
  the trace's meta tensors on the kernels' route) launch and build nothing
  through the kernel wrappers; real CPU tensors take the plain versions as
  before;
- ``plan_from_args`` field for field the reference's, flag by flag, for every
  arch; the CLI's records and exit code."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import ARCH_IDS, SHAPES_BY_NAME
from repro.core import ParallelPlan as RefPlan
from repro.core.config import Family as RefFamily
from repro.core.sharding import cache_specs as ref_cache_specs
from repro.core.sharding import ep_spec_for_param, overlap_param_specs, param_specs
from repro.core.sharding import opt_state_specs as ref_opt_state_specs
from repro.launch.mesh import batch_axes_for as ref_batch_axes_for
from repro.launch.stepbuilder import resolve_config as ref_resolve_config
from repro.launch.stepbuilder import skip_reason as ref_skip_reason
from repro.models import build_model as ref_build_model
from repro_torch.core import ParallelPlan
from repro_torch.core import InputShape as TorchShape
from repro_torch.core.tree import named_leaves
from repro_torch.kernels import build
from repro_torch.launch import dryrun
from repro_torch.perf.roofline import link_bytes

REPO = Path(__file__).resolve().parent.parent
MESH = {"data": 16, "model": 16}
SSM_TAILS = {"state", "conv_x", "conv_B", "conv_C"}
TIMEOUT = 300

# the port's refusals on pod16x16 under the default plan, each with its
# ROADMAP item: the rings' families (A14.8) and the tp rings at a degree that
# does not divide the heads, the KV heads or the vocabulary (A14.9)
UNSUPPORTED = {
    ("pixtral-12b", "train_4k"): "A14.8", ("zamba2-1.2b", "train_4k"): "A14.8",
    ("whisper-small", "train_4k"): "A14.8", ("qwen2.5-14b", "train_4k"): "A14.9",
    ("gemma2-9b", "train_4k"): "A14.9", ("qwen1.5-4b", "train_4k"): "A14.9",
    ("mamba2-370m", "train_4k"): "A14.9",
}

torch.set_num_threads(1)


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


@pytest.fixture(autouse=True, scope="module")
def _one_meta_init_per_config():
    """A full config's meta init is drawn once per (config, dtype, padding)."""
    from repro_torch.launch import stepbuilder
    real, seen = stepbuilder.meta_params, {}

    def once(model):
        key = (model.cfg, model.plan.param_dtype, model.plan.pad_vocab_to_multiple)
        if key not in seen:
            seen[key] = real(model)
        return seen[key]
    stepbuilder.meta_params = once
    yield
    stepbuilder.meta_params = real


# ---------------------------------------------------------------------------
# the records on the production grid


def _record(arch, shape, multi_pod, plan):
    """The CLI's record of ``arch`` x ``shape`` on a production mesh, without
    the trace."""
    name, mesh_shape = dryrun.MESHES[multi_pod]
    return dryrun.record(arch, dryrun.SHAPES_BY_NAME[shape.name], mesh_shape, plan, name=name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_records_on_the_production_grid(arch):
    plan = dryrun.default_plan(arch)
    for shape in SHAPES_BY_NAME.values():
        rec = _record(arch, shape, False, plan)
        assert rec["status"] in ("ok", "skipped", "unsupported"), rec
        ref_reason = ref_skip_reason(ref_resolve_config(arch, shape.name), shape)
        assert (rec["status"] == "skipped") == bool(ref_reason), (shape.name, rec)
        if ref_reason:
            assert rec["reason"] == ref_reason
        want = UNSUPPORTED.get((arch, shape.name))
        assert (rec["status"] == "unsupported") == bool(want), (shape.name, rec)
        if want:
            assert rec["reason"].startswith("resolve_context: ") and want in rec["lifted_by"]
        if rec["status"] == "ok":
            assert rec["placement_bytes"]["total"] > 0 and rec["notes"]
        pod = _record(arch, shape, True, plan)
        assert pod["status"] == ("skipped" if ref_reason else "unsupported"), pod
        if not ref_reason:
            assert pod["reason"] == dryrun.PODS_AS_DATA and "A14.7" in pod["lifted_by"]
        assert pod["mesh"] == "pod2x16x16" and rec["mesh"] == "pod16x16"


def _ref_bytes(shape, spec, sizes, itemsize):
    """Rank 0's bytes of a leaf under a reference spec: GSPMD pads an uneven
    split, so rank 0 holds ceil(d / n) of a split dim."""
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[d] = -(-out[d] // sizes[axis])
    return int(np.prod(out)) * itemsize


def _ref_plan(plan):
    return RefPlan(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(RefPlan)})


def _flat(specs, shapes):
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return dict(zip([n for n, _ in named_leaves(shapes)], flat))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_bytes_match_the_reference(arch):
    """Rank 0's bytes by part on pod16x16 for every ok record: params by the
    reference's spec of each leaf (GSPMD's ``param_specs`` on one device's
    data axis, the overlap layout under tp, the expert spec under ep, as the
    port's step places them, for serving too: where GSPMD's ``param_specs``
    would move a split off a dim the axis does not divide, whisper-small's
    vocabulary, the port's placement keeps the overlap layout's dim), ZeRO-1
    moments by its ``opt_state_specs``, the
    decode cache by its ``cache_specs`` and the batch rows by its
    ``batch_axes_for``. Two layouts differ and keep or name the bytes: ZeRO-1
    under tp (the port splits each moment on the rank's TP shard, which the
    model axis already split where the reference takes another dim: the
    bytes a rank are equal), and the SSM state and conv tails, whole on each
    model rank in the port (``MESH["model"]`` times the reference's)."""
    plan = dryrun.default_plan(arch)
    rplan = _ref_plan(plan)
    mesh = FakeMesh(**MESH)
    for shape in SHAPES_BY_NAME.values():
        rec = _record(arch, shape, False, plan)
        if rec["status"] != "ok":
            continue
        got = rec["placement_bytes"]
        cfg = ref_resolve_config(arch, shape.name)
        model = ref_build_model(cfg, rplan)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        base = param_specs(shapes, cfg, rplan, mesh)
        over = overlap_param_specs(shapes, cfg, rplan, mesh) if plan.tp > 1 else base
        flat_over = _flat(over, shapes)
        specs = {}
        for name, leaf in named_leaves(shapes):
            ep = (ep_spec_for_param(tuple(name.split("/")), tuple(leaf.shape), rplan)
                  if plan.ep > 1 else None)
            specs[name] = ep if ep is not None else flat_over[name]
        params = sum(_ref_bytes(leaf.shape, specs[n], MESH, np.dtype(leaf.dtype).itemsize)
                     for n, leaf in named_leaves(shapes))
        assert got["params"] == params, (shape.name, got["params"], params)
        baxes = ref_batch_axes_for(mesh, shape.global_batch, rplan.pp, rplan.dp_over_model)
        rows = shape.global_batch // int(np.prod([MESH[a] for a in baxes]))
        if shape.kind == "train":
            assert got["grads"] == params
            pspecs = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(shapes), [specs[n] for n, _ in
                                                       named_leaves(shapes)])
            opt = _flat(ref_opt_state_specs(pspecs, shapes, rplan, mesh), shapes)
            moments = 2 * sum(_ref_bytes(leaf.shape, opt[n], MESH, 4)
                              for n, leaf in named_leaves(shapes))
            assert got["optimizer"] == moments, (got["optimizer"], moments)
            assert got["batch"] == 2 * rows * shape.seq_len * 4      # tokens, labels int32
        elif shape.kind == "decode":
            cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch, shape.seq_len))
            cspecs = _flat(ref_cache_specs(cache, rplan, mesh, baxes), cache)
            want = 0
            for name, leaf in named_leaves(cache):
                b = _ref_bytes(leaf.shape, cspecs[name], MESH, np.dtype(leaf.dtype).itemsize)
                if name.split("/")[-1] in SSM_TAILS and "model" in tuple(cspecs[name]):
                    b *= MESH["model"]        # whole on each model rank in the port
                want += b
            assert got["cache"] == want, (shape.name, got["cache"], want)
            assert got["batch"] == rows * 4


# ---------------------------------------------------------------------------
# a full config traced on the 256-rank fake group


def test_full_config_traces_on_256_fake_ranks(monkeypatch):
    """olmoe-1b-7b train_4k (tp 16 and ep 16 on the model axis, ZeRO-1 over
    the data axis), rank 0's step once: ok; the data group's reduce-scatters
    carry, to the byte, ``link_bytes`` of each leaf's mean grad block (every
    leaf's moments split here, so no grad is all-reduced) and its
    all-gathers those of each updated leaf; no kernel built or launched."""
    monkeypatch.setattr(build, "_nvcc", _no_nvcc)
    before = _launches()
    arch, shape = "olmoe-1b-7b", dryrun.SHAPES_BY_NAME["train_4k"]
    plan = dryrun.default_plan(arch)
    rec = dryrun.estimate(arch, shape, MESH, plan, name="pod16x16")
    assert rec["status"] == "ok" and _launches() == before
    peak = rec["traced"]["peak"]
    assert peak["total"] >= rec["traced"]["at_start"]["total"] > 0
    assert peak["params"] == rec["placement_bytes"]["params"]
    assert peak["optimizer"] == rec["placement_bytes"]["optimizer"]
    data = rec["collectives"]["by_ring"]["data"]
    # the leaves rank 0 holds, and their ZeRO-1 specs, as the placement gives them
    _, _, placement, _ = dryrun.build_step(arch, shape, dryrun.StandIn(MESH), plan)
    specs = placement[0].opt.mu
    rs = ag = 0.0
    whole = n_split = 0
    for name, spec in specs.items():
        size = int(np.prod(spec.shape)) * 4                         # fp32 grads and params
        if spec.dim is None:
            whole += 1
        else:
            rs += link_bytes("reduce-scatter", size / 16, 16)
            ag += link_bytes("all-gather", size, 16)
            n_split += 1
    assert whole == 0 and n_split == len(specs)    # every leaf's moments split over data
    assert data["reduce_scatter"]["link_bytes"] == rs
    assert data["reduce_scatter"]["count"] == data["all_gather"]["count"] == n_split
    assert data["all_gather"]["link_bytes"] == ag
    # the data group's all-reduces carry no grads: the loss, the clip's sum
    # and each MoE layer's routing statistics, (E,) floats at most
    n_exp = dryrun.resolve_config(arch, "train_4k").moe.num_experts
    assert data["all_reduce"]["result_bytes"] <= 4 * n_exp * data["all_reduce"]["count"]
    assert rec["roofline"]["collective_bytes_per_device"] == rec["collectives"]["link_bytes"] > 0


# ---------------------------------------------------------------------------
# the fake trace against real runs on the smoke configs


def _smoke_case(arch, kind):
    """The reference's ``test_dryrun_integration`` case on a (1, 2) grid: its
    smoke config and reduced shape (64 tokens, 8 rows), the default plan's
    recipe at degree 2."""
    from repro_torch.core.config import Family
    from repro_torch.launch.stepbuilder import resolve_config
    cfg = resolve_config(arch, "train_4k", smoke=True)
    moe = cfg.family == Family.MOE
    plan = ParallelPlan(tp=1 if moe else 2, ep=2 if moe else 1, remat="full")
    return cfg, TorchShape(f"{kind}_t", 64, 8, kind), plan


SMOKE_CASES = [("qwen1.5-4b", "train"), ("olmoe-1b-7b", "train"), ("mamba2-370m", "decode"),
               ("zamba2-1.2b", "decode"), ("whisper-small", "prefill"),
               ("pixtral-12b", "prefill")]


def _strip(tr):
    return {"peak": tr["peak"], "start": tr["start"], "collectives": tr["collectives"]}


def _rank_main(arch, kind, init_method, out):
    """One rank of the real 2-rank gloo run (the child of
    ``test_meta_trace_matches_real_runs``)."""
    torch.set_num_threads(1)
    cfg, shape, plan = _smoke_case(arch, kind)
    rank = int(os.environ["RANK"])
    tr = dryrun.trace_step(cfg, shape, plan, {"data": 1, "model": 2}, rank=rank, meta=False,
                           init_method=init_method)
    with open(out, "wb") as f:
        pickle.dump(_strip(tr), f)


CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import test_torch_dryrun as t; "
         "t._rank_main(*sys.argv[3:7])")


@pytest.mark.parametrize("arch,kind", SMOKE_CASES)
def test_meta_trace_matches_real_runs(tmp_path, arch, kind):
    cfg, shape, plan = _smoke_case(arch, kind)
    one = ParallelPlan(remat="full")
    real = dryrun.trace_step(cfg, shape, one, None, meta=False)
    traced = dryrun.trace_step(cfg, shape, one, None, meta=True, kernels=False)
    assert traced["peak"] == real["peak"] and traced["start"] == real["start"], (traced, real)
    assert real["peak"]["total"] > real["start"]["total"] > 0

    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(REPO / "src"), str(REPO / "tests"), arch, kind,
         init, str(tmp_path / f"rank{r}.pkl")],
        env={**os.environ, "RANK": str(r), "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    traced = dryrun.trace_step(cfg, shape, plan, {"data": 1, "model": 2}, meta=True,
                               kernels=False)
    assert traced["collectives"] == ranks[0]["collectives"], (traced["collectives"],
                                                              ranks[0]["collectives"])
    assert ranks[0]["collectives"] == ranks[1]["collectives"]
    # the train steps' rings and sums and the hybrid's sharded decode
    # attention move bytes; the prefill fn (the forward) runs whole on every
    # model rank, and so does the SSM decode (ROADMAP queue C)
    moves = kind == "train" or arch == "zamba2-1.2b"
    assert (traced["collectives"]["link_bytes"] > 0) == moves, traced["collectives"]


def _plain_peak(cfg, shape, plan):
    """The peak over its start of the train step run for real on the CPU
    with no dispatch mode active (no tracker): the allocator's own events
    under ``torch.profiler``'s memory profiling, on from before the state is
    made, so that every block freed in the step was seen allocated. Like
    ``trace_step``, one step runs first."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn, args, _, meta = dryrun.build_step(cfg, shape, None, plan, device="cpu")
        call, _ = dryrun._inputs(shape, meta["model"], args, plan, None, "cpu")
        call = (fn(*call)[0], call[1])
        with record_function("tracked step"):
            fn(*call)
    events = list(prof.profiler.kineto_results.events())
    window = next(e for e in events if e.name() == "tracked step")
    held = start = peak = None
    for e in sorted((e for e in events if e.name() == "[memory]"), key=lambda e: e.start_ns()):
        if start is None and e.start_ns() >= window.start_ns():
            start = peak = held or 0
        held = (held or 0) + e.nbytes()
        if start is not None and e.start_ns() <= window.end_ns():
            peak = max(peak, held)
    return peak - start


def _untouched_tracker_peak(cfg, shape, plan):
    """The same step's peak over its start under ``MemTracker`` as PyTorch
    ships it (the control: backward formulas' out-of-place variants)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    fn, args, _, meta = dryrun.build_step(cfg, shape, None, plan, device="cpu")
    call, _ = dryrun._inputs(shape, meta["model"], args, plan, None, "cpu")
    call = (fn(*call)[0], call[1])
    mt = MemTracker()
    with mt:
        mt.track_external(call[0].params, call[0].opt.mu, call[0].opt.nu, call[1])
        start = next(iter(mt.get_tracker_snapshot("current").values()))["Total"]
        fn(*call)
    return next(iter(mt.get_tracker_snapshot("peak").values()))["Total"] - start


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "olmoe-1b-7b", "mamba2-370m", "whisper-small"])
def test_tracker_peak_matches_a_run_without_a_dispatch_mode(arch):
    """The tracker's in-place rule (``dryrun._tracker``) against a plain run:
    a smoke config's train step (8 x 64 tokens, remat full), its peak over
    the step's start from ``trace_step`` on real CPU tensors within 1% of the
    same step's peak with no dispatch mode active (the allocator's events,
    which also see the workspaces an op allocates inside itself, invisible
    to any tracker at the dispatch level: 10-20 KB here); ``MemTracker``
    without the rule reads over 5% more (the loss's gather backward and the
    engine's accumulation adds out of place)."""
    from repro_torch.launch.stepbuilder import resolve_config
    cfg = resolve_config(arch, "train_4k", smoke=True)
    shape, plan = TorchShape("train_t", 64, 8, "train"), ParallelPlan(remat="full")
    plain = _plain_peak(cfg, shape, plan)
    tr = dryrun.trace_step(cfg, shape, plan, None, meta=False)
    ruled = tr["peak"]["total"] - tr["start"]["total"]
    assert abs(ruled - plain) <= 0.01 * plain, (ruled, plain)
    assert _untouched_tracker_peak(cfg, shape, plan) > 1.05 * plain


# ---------------------------------------------------------------------------
# the kernel seams on fake tensors


def _no_nvcc():
    raise AssertionError("nvcc was sought")


def _launches():
    from repro_torch.kernels import flash_attention as fa, grouped_gemm as gg, ssd_scan as ss
    return (fa.flash_attention_lse.launches, fa.flash_attention_bwd.dq_launches,
            fa.flash_attention_bwd.dkv_launches, gg.grouped_gemm.rows_launches,
            gg.grouped_gemm.contract_launches, ss.ssd_chunk_scan_fwd.launches,
            ss.ssd_chunk_scan_bwd.launches)


def _kernel_calls(device, dtype):
    """Every wrapper once, at shapes of the Hopper bodies: the outputs."""
    from repro_torch.kernels import flash_attention as fa, grouped_gemm as gg, ssd_scan as ss
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(shape, generator=g, dtype=torch.float32).to(dt).to(device) \
            if device == "cpu" else torch.empty(shape, dtype=dt, device=device)
    q, k, v = r(1, 4, 64, 128), r(1, 2, 64, 128), r(1, 2, 64, 128)
    o, lse = fa.flash_attention_lse(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, r(1, 4, 64, 128), lse, r(1, 4, 64, dt=torch.float32))
    x, w = r(4, 32, 64), r(4, 64, 48)
    gs = torch.tensor([32, 7, 0, 20], dtype=torch.int32, device=device)
    y = gg.grouped_gemm(x, w, gs)
    dw = gg.grouped_gemm(x.transpose(1, 2), r(4, 32, 48), gs, mask="contract")
    xs, dt_, A = r(1, 4, 256, 64), r(1, 4, 256, dt=torch.float32), r(4, dt=torch.float32)
    B, C = r(1, 1, 256, 64), r(1, 1, 256, 64)
    ys, enters, final = ss.ssd_chunk_scan_fwd(xs, dt_, A, B, C, chunk=128, save_enters=True)
    sgrads = ss.ssd_chunk_scan_bwd(xs, dt_, A, B, C, enters, r(1, 4, 256, 64, dt=torch.float32),
                                   r(1, 4, 64, 64, dt=torch.float32), chunk=128)
    return (o, lse, *grads, y, dw, ys, final, *sgrads)


def test_fake_cuda_tensors_build_and_launch_nothing(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    monkeypatch.setattr(build, "_nvcc", _no_nvcc)
    monkeypatch.setattr(build, "load", lambda name: _no_nvcc())
    before = _launches()
    with FakeTensorMode():
        outs = _kernel_calls("cuda", torch.bfloat16)
    assert _launches() == before
    assert all(isinstance(t, FakeTensor) and t.device.type == "cuda" for t in outs)
    assert [tuple(t.shape) for t in outs[:5]] == [(1, 4, 64, 128), (1, 4, 64), (1, 4, 64, 128),
                                                  (1, 2, 64, 128), (1, 2, 64, 128)]


def test_real_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels import flash_attention as fa, grouped_gemm as gg
    before = _launches()
    outs = _kernel_calls("cpu", torch.float32)
    assert _launches() == before
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in ((1, 4, 64, 128), (1, 2, 64, 128),
                                                     (1, 2, 64, 128)))
    o, lse = fa.flash_attention_lse_plain(q, k, v, causal=True, window=0, softcap=0.0,
                                          scale=128 ** -0.5, q_offset=0)
    assert torch.equal(outs[0], o) and torch.equal(outs[1], lse)
    assert not build.fake_card_active() and not build.on_card(q)
    x, w = outs[5].new_ones(2, 3, 4), outs[5].new_ones(2, 4, 5)
    assert torch.equal(gg.grouped_gemm(x, w), gg.grouped_gemm_plain(x, w, None))


def test_smoke_trace_on_the_kernel_route_builds_nothing(monkeypatch):
    """The dry run's trace (meta tensors under ``fake_card``) of a smoke MoE
    step: the kernels' route (their wrappers allocate, nothing launches) and
    a peak other than the plain route's."""
    monkeypatch.setattr(build, "_nvcc", _no_nvcc)
    monkeypatch.setattr(build, "load", lambda name: _no_nvcc())
    cfg, shape, _ = _smoke_case("olmoe-1b-7b", "train")
    plan = ParallelPlan(remat="full", compute_dtype="bfloat16")
    before = _launches()
    kern = dryrun.trace_step(cfg, shape, plan, None)
    plain = dryrun.trace_step(cfg, shape, plan, None, kernels=False)
    assert _launches() == before and not build.fake_card_active()
    assert kern["start"] == plain["start"] and kern["peak"] != plain["peak"]


# ---------------------------------------------------------------------------
# plan_from_args and the CLI


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module. It sets XLA_FLAGS for 512 devices on
    import: this process's backend is initialised first (one device) and the
    variable restored."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


FLAG_SETS = [[], ["--dp-shard", "2"], ["--remat", "selective"], ["--zero", "0"], ["--no-ep"],
             ["--no-seq-shard"], ["--pad-vocab", "128"], ["--microbatches", "4"],
             ["--dp-over-model"], ["--moe-dispatch", "scatter"],
             ["--remat", "none", "--zero", "2", "--no-ep", "--pad-vocab", "64",
              "--microbatches", "2", "--moe-dispatch", "einsum", "--dp-shard", "4"]]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_from_args_matches_the_reference(ref_dryrun, arch):
    fields = [f.name for f in dataclasses.fields(RefPlan)]
    ap = dryrun.parser()
    for flags in FLAG_SETS:
        args = ap.parse_args(flags)
        ours, ref = dryrun.plan_from_args(arch, args), ref_dryrun.plan_from_args(arch, args)
        assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}, flags
    assert dryrun.default_plan(arch).ep == (16 if ref_resolve_config(arch, "train_4k").family
                                            == RefFamily.MOE else 1)


def test_cli_writes_records_and_exits_zero(tmp_path, capsys):
    dryrun.main(["--arch", "whisper-small", "--multi-pod", "--out", str(tmp_path),
                 "--tag", "t"])
    recs = sorted(tmp_path.glob("t__whisper-small__*__pod2x16x16.json"))
    assert len(recs) == 4
    statuses = [json.loads(p.read_text())["status"] for p in recs]
    assert statuses.count("skipped") == 1 and statuses.count("unsupported") == 3
    dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "decode_32k", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "baseline__olmoe-1b-7b__decode_32k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["traced"]["peak"]["cache"] == \
        rec["placement_bytes"]["cache"]
    assert rec["roofline"]["chips"] == 256 and rec["trace_s"] > 0
    dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "decode_32k", "--out", str(tmp_path),
                 "--skip-existing"])
    assert "exists" in capsys.readouterr().out
