"""Pipeline parallelism across pods, with TP, CP and EP inside its ticks.

    PYTHONPATH=src python -m repro_torch.examples.pipeline_multipod              # on the card
    PYTHONPATH=src python -m repro_torch.examples.pipeline_multipod --device cpu

The reference's recipe (``examples/pipeline_multipod.py``) on eight rank
processes. The ``pipe-demo`` config (4 layers, d_model 128, 4 heads, 2 KV
heads, d_ff 256, vocab 512), ``pp=2``, ``microbatches=4``, seq 64, batch 8,
``Hyper(z_loss=0.0)``, weights from seed 0:

1. On a (pod 2, data 2, model 2) grid, GPipe and 1F1B (``plan.pp_schedule``)
   against the non-pipelined loss (within 2e-4), each schedule's peak memory
   a rank beside it: on the card ``torch.cuda.max_memory_allocated`` around
   the loss and its backward; on the CPU the bytes the forward saves for the
   backward (``saved_tensors_hooks``), the port's counterpart of the
   reference's compiled temp bytes.
2. 10 steps of 1F1B training: the global-norm clip at 1.0 over the stages
   (``pipeline_splits``) and AdamW at 1e-3, ZeRO-1 over the data ranks.
3. TP x PP (``tp=2, tp_impl="overlap"``): the ring steps of the overlap rings
   inside each 1F1B tick, against the pp-only loss on the trained params
   (within 2e-5).
4. CP x TP x PP on a (pod 2, cp 2, model 2) grid (``cp=2, cp_impl="ring"``):
   zigzag ring attention inside each tick, also within 2e-5.
5. The MoE twin (4 experts, top 2, one shared expert, capacity 2.0; seed 1),
   EP x TP x CP x PP with ep 4 folded onto cp x model, under the overlap ring
   and the blocking all-to-all: the same loss within 1e-6.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.examples import ranks as _ranks

GRID = {"pod": 2, "data": 2, "model": 2}
CP_GRID = {"pod": 2, "cp": 2, "model": 2}
RANKS = 8
TIMEOUT = 900.0       # seconds, the whole spawn
STEPS = 10
LR, CLIP = 1e-3, 1.0
PP_LIMIT, TP_LIMIT, EP_LIMIT = 2e-4, 2e-5, 1e-6


def demo_config():
    from repro_torch.core import Family, ModelConfig
    return ModelConfig("pipe-demo", Family.DENSE, n_layers=4, d_model=128, n_heads=4,
                       n_kv_heads=2, d_ff=256, vocab=512)


def moe_twin(cfg):
    from repro_torch.core import Family, MoEConfig
    return dataclasses.replace(cfg, family=Family.MOE, d_ff=0, moe=MoEConfig(
        num_experts=4, top_k=2, d_expert=128, num_shared_experts=1, capacity_factor=2.0))


def pipe_plan(impl="auto", **kw):
    from repro_torch.core import ParallelPlan
    return ParallelPlan(remat="none", compute_dtype="float32", pp=2, microbatches=4,
                        attn_impl=impl, moe_gemm_impl=impl, **kw)


def whole_params(cfg, dev, seed, init_params=None):
    """The whole param tree of one device: seed ``seed``'s draw, or
    ``init_params`` (a numpy tree in the reference's layout)."""
    from repro_torch.core import ParallelPlan
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    if init_params is not None:
        return params_from_numpy(init_params, cfg, device=dev)
    model = build_model(cfg, ParallelPlan(remat="none", compute_dtype="float32"), device=dev)
    return model.init(torch.Generator(device=dev).manual_seed(seed))


def rank_params(whole, plan, grid, grad=True):
    """This rank's part of ``whole`` under ``plan`` (new leaves)."""
    from repro_torch.core.sharding import grid_place, shard_layout
    from repro_torch.core.tree import leaves
    params = shard_layout(whole, plan, *grid_place(grid))
    for p in leaves(params):
        p.requires_grad_(grad)
    return params


def saved_bytes(fn, params):
    """Run ``fn`` and return (its value, the bytes of the distinct storages
    autograd saved for the backward meanwhile, ``params``' own aside)."""
    from repro_torch.core.tree import leaves
    seen = {p.untyped_storage().data_ptr() for p in leaves(params)}
    total = [0]

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in seen:
            seen.add(ptr)
            total[0] += t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        value = fn()
    return value, total[0]


def train_step(cfg, plan, grid):
    """The pipelined step: backward (the pipeline completes the grads), the
    clip at CLIP over the stages (``pipeline_splits``) and AdamW at LR on
    this rank's ZeRO-1 slices over its data group."""
    from repro_torch.core.sharding import opt_state_specs
    from repro_torch.core.tree import from_names, leaves, named_leaves
    from repro_torch.optim import adamw_update_sharded, clip_by_global_norm
    from repro_torch.train import Hyper, TrainState
    from repro_torch.train.pipeline import pipeline_splits, pipelined_loss_fn
    loss_fn = pipelined_loss_fn(cfg, plan, grid, ("data",), z_loss=Hyper(z_loss=0.0).z_loss)
    dmesh = grid.data

    def step(state, batch):
        params, opt = state
        for p in leaves(params):
            p.grad = None
        loss, _ = loss_fn(params, batch)
        loss.backward()
        specs = opt_state_specs(params, dmesh, plan)
        grads = {}
        with torch.no_grad():
            for name, leaf in named_leaves(params):
                g = torch.stack([p.grad for p in leaf]) if isinstance(leaf, list) else leaf.grad
                sp = specs[name]
                if sp.dim is not None:
                    k = sp.shape[sp.dim] // dmesh.size
                    g = g.narrow(sp.dim, dmesh.rank * k, k).contiguous()
                grads[name] = g
        for p in leaves(params):
            p.grad = None
        grads, gnorm = clip_by_global_norm(from_names(grads), CLIP, mesh=dmesh, specs=specs,
                                           splits=pipeline_splits(params, plan, grid))
        params, opt = adamw_update_sharded(grads, opt, params, LR, mesh=dmesh, specs=specs)
        return TrainState(params, opt), {"loss": loss.detach(), "grad_norm": gnorm}
    return step


def train_state(whole, plan, grid):
    from repro_torch.core.sharding import opt_state_specs
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState
    params = rank_params(whole, plan, grid)
    return TrainState(params, adamw_init(params, mesh=grid.data,
                                         specs=opt_state_specs(params, grid.data, plan)))


def rank_job(rank, init_method, device, check_plain=False, init_params=None):
    """One rank of the recipe (module docstring). ``init_params``: {"dense",
    "moe"} numpy trees in the reference's layout. Returns its losses, each
    schedule's peak, the training losses and grad norms and the B1-B4
    launches; with ``check_plain`` also ``checks``: the first training
    step's loss and the TP, CP and EP losses (each ``ep_impl``), each with
    its backward, through the kernels against the plain versions
    (``ranks.route_check``), their launches and seconds left out of the
    recipe's."""
    from repro_torch.core import InputShape, ParallelPlan
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch import init_grid_mesh
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_loss_fn
    from repro_torch.train.pipeline import pipelined_loss_fn
    dev = _ranks.rank_device(rank, device)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = demo_config()
    plan = pipe_plan()
    ds = SyntheticDataset(cfg, InputShape("pipe", seq_len=64, global_batch=8, kind="train"))

    def get_batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(i).items()}

    init = init_params or {}
    whole = whole_params(cfg, dev, 0, init.get("dense"))
    batch = get_batch(0)
    out = {"rank": rank, "checks": {}}
    checks, top = out["checks"], [0]      # top: the job's peak a rank, over its resets

    def check(name, loss_of, params, batch):
        """A route check, its memory kept out of the job's peak."""
        if check_plain:
            top[0] = max(top[0], _ranks.peak_bytes(dev))
            checks[name] = _ranks.route_check(loss_of, params, batch)
            _ranks.reset_peak(dev)
    before = _ranks.launches()
    t0 = time.perf_counter()
    one = build_model(cfg, ParallelPlan(remat="none", compute_dtype="float32"), device=dev)
    with torch.no_grad():
        ref_loss, _ = make_loss_fn(one, Hyper(z_loss=0.0))(whole, batch)
    out["ref_loss"] = float(ref_loss)
    say(f"non-pipelined loss {out['ref_loss']:.6f}  (bubble fraction "
        f"{(plan.pp - 1) / (plan.microbatches + plan.pp - 1):.0%})", flush=True)

    # --- GPipe and 1F1B on (pod 2, data 2, model 2) -------------------------
    # pp-only, the model axis replicates: each model index's (pod 2, data 2)
    # ranks form a pipeline of their own (the port's plans take tp = the model
    # axis's size, so a model axis of 2 under tp 1 is two such grids)
    m_idx, sub = rank % GRID["model"], rank // GRID["model"]
    grid = init_grid_mesh(GRID["data"], 1, dev, pod=GRID["pod"], backend="gloo",
                          init_method=init_method + f"_pp{m_idx}", rank=sub)
    out["sched"] = {}
    for sched in ("gpipe", "1f1b"):
        pl = dataclasses.replace(plan, pp_schedule=sched)
        lf = pipelined_loss_fn(cfg, pl, grid, ("data",))
        params = rank_params(whole, pl, grid)
        _ranks.reset_peak(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0

        loss, saved = saved_bytes(lambda: lf(params, batch)[0], params)
        loss.backward()
        loss = float(loss.detach())
        top[0] = max(top[0], _ranks.peak_bytes(dev))
        peak = _ranks.peak_bytes(dev) - base if dev.type == "cuda" else saved
        assert abs(out["ref_loss"] - loss) < PP_LIMIT, (sched, loss, out["ref_loss"])
        out["sched"][sched] = {"loss": loss, "peak_bytes": peak, "saved_bytes": saved}
        say(f"{sched:>6} loss {loss:.6f}  peak bytes a rank {peak}", flush=True)
        del params
    g, f = out["sched"]["gpipe"]["peak_bytes"], out["sched"]["1f1b"]["peak_bytes"]
    say(f"1f1b keeps {f / g:.0%} of gpipe's peak", flush=True)

    # --- 1F1B training --------------------------------------------------------
    check("first", lambda impl: pipelined_loss_fn(cfg, pipe_plan(impl), grid, ("data",),
                                                  z_loss=Hyper(z_loss=0.0).z_loss),
          rank_params(whole, plan, grid, grad=False), batch)
    state = train_state(whole, plan, grid)
    step = train_step(cfg, plan, grid)
    out["train"] = {"loss": [], "grad_norm": []}
    _ranks.reset_peak(dev)
    for i in range(STEPS):
        batch = get_batch(i)
        state, m = step(state, batch)
        out["train"]["loss"].append(float(m["loss"]))
        out["train"]["grad_norm"].append(float(m["grad_norm"]))
        if i % 3 == 0:
            say(f"pipelined step {i}: loss {out['train']['loss'][-1]:.4f}", flush=True)
    out["train"]["peak_bytes"] = _ranks.peak_bytes(dev)
    top[0] = max(top[0], out["train"]["peak_bytes"])
    say("multi-pod pipeline training OK", flush=True)

    # --- TP x PP on the trained params -----------------------------------------
    trained = _ranks.gather_whole(state.params, plan, grid, lambda p, c, m: p * GRID["data"])
    del state, step
    with torch.no_grad():
        base_loss, _ = pipelined_loss_fn(cfg, plan, grid, ("data",))(
            rank_params(trained, plan, grid, grad=False), batch)
    grid.close()
    grid = init_grid_mesh(GRID["data"], GRID["model"], dev, pod=GRID["pod"], backend="gloo",
                          init_method=init_method + "_tp", rank=rank)
    tp_plan = dataclasses.replace(plan, tp=2, tp_impl="overlap")
    tp_params = rank_params(trained, tp_plan, grid, grad=False)
    with torch.no_grad():
        tp_loss, _ = pipelined_loss_fn(cfg, tp_plan, grid, ("data",))(tp_params, batch)
    check("tp", lambda impl: pipelined_loss_fn(cfg, _ranks.routed(tp_plan, impl), grid,
                                               ("data",)), tp_params, batch)
    out["base_loss"], out["tp_loss"] = float(base_loss), float(tp_loss)
    assert abs(out["tp_loss"] - out["base_loss"]) < TP_LIMIT, (out["tp_loss"], out["base_loss"])
    say(f"TP x PP (1f1b + overlap rings) loss {out['tp_loss']:.6f} == pp-only loss "
        f"{out['base_loss']:.6f}", flush=True)
    grid.close()

    # --- CP x TP x PP and its MoE twin on (pod 2, cp 2, model 2) --------------
    cp_grid = init_grid_mesh(1, CP_GRID["model"], dev, cp=CP_GRID["cp"], pod=CP_GRID["pod"],
                             backend="gloo", init_method=init_method + "_cp", rank=rank)
    cp_plan = dataclasses.replace(tp_plan, cp=2, cp_impl="ring")
    cp_params = rank_params(trained, cp_plan, cp_grid, grad=False)
    with torch.no_grad():
        cp_loss, _ = pipelined_loss_fn(cfg, cp_plan, cp_grid, ())(cp_params, batch)
    check("cp", lambda impl: pipelined_loss_fn(cfg, _ranks.routed(cp_plan, impl), cp_grid, ()),
          cp_params, batch)
    out["cp_loss"] = float(cp_loss)
    assert abs(out["cp_loss"] - out["base_loss"]) < TP_LIMIT, (out["cp_loss"], out["base_loss"])
    say(f"CP x TP x PP (zigzag ring attention in each 1F1B tick) loss {out['cp_loss']:.6f} "
        f"== pp-only loss {out['base_loss']:.6f}", flush=True)
    moe_cfg = moe_twin(cfg)
    moe_whole = whole_params(moe_cfg, dev, 1, init.get("moe"))
    out["ep_loss"] = {}
    for ep_impl in ("blocking", "overlap"):
        ep_plan = dataclasses.replace(cp_plan, ep=4, ep_impl=ep_impl)
        ep_params = rank_params(moe_whole, ep_plan, cp_grid, grad=False)
        with torch.no_grad():
            loss, _ = pipelined_loss_fn(moe_cfg, ep_plan, cp_grid, ())(ep_params, batch)
        out["ep_loss"][ep_impl] = float(loss)
        check(f"ep_{ep_impl}", lambda impl: pipelined_loss_fn(
            moe_cfg, _ranks.routed(ep_plan, impl), cp_grid, ()), ep_params, batch)
        say(f"EP x TP x CP x PP ({ep_impl:>8} a2a) loss {float(loss):.6f}", flush=True)
    cp_grid.close()
    assert abs(out["ep_loss"]["overlap"] - out["ep_loss"]["blocking"]) < EP_LIMIT, out["ep_loss"]
    say("MoE parallel folding in the pipeline OK: overlapped ring == blocking all-to-all",
        flush=True)
    out.update(launches=_ranks.launches_since(before, checks.values()),
               seconds=time.perf_counter() - t0 - sum(c["seconds"] for c in checks.values()),
               peak_bytes=max(top[0], _ranks.peak_bytes(dev)))
    return out


def run(device=None):
    """The recipe on its eight ranks; returns each rank's readings."""
    return _ranks.spawn([(rank_job, {})], RANKS, device, TIMEOUT)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args()
    run(args.device)


if __name__ == "__main__":
    main()
