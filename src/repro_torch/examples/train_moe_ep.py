"""Expert-parallel MoE training on eight rank processes.

    PYTHONPATH=src python -m repro_torch.examples.train_moe_ep              # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_moe_ep --device cpu

The reference's recipe (``examples/train_moe_ep.py``): the reduced
olmoe-1b-7b config at ``capacity_factor=2.0`` (E / top_k: no token dropped,
so shard-local routing is the dense dispatch's math), in two placements:

- (a) ep-only on a (data 2, model 4) grid:
  ``ParallelPlan(ep=4, ep_impl="overlap", zero_stage=1, remat="selective",
  compute_dtype="float32")``, seq 64, batch 8, 100 steps under
  ``Hyper(peak_lr=5e-3, warmup_steps=10, total_steps=100)``. The routed
  experts ride the model axis (attention runs as a cp ring over it) and the
  dispatch/combine exchange is the overlap ring of ``dispatch_ep_a2a``. It
  prints the experts' placement, the loss and ``moe_aux``.
- (b) MoE parallel folding on a (data 2, cp 2, model 2) grid: attention keeps
  its cp x tp mapping (``ParallelPlan(ep=4, cp=2, cp_impl="ring", tp=2,
  tp_impl="overlap")``) while the MoE sublayer re-reads the same four ranks
  of a data index as one ep=4 expert ring. On the params trained in (a) and
  the last batch, the overlap ring and the blocking all-to-all must give the
  same loss to 1e-6.

Each rank is one process (``examples.ranks``); the trained params go from the
(a) grid to the (b) grid through the ranks' host copies.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.examples import ranks as _ranks

STEPS = 100
EP_GRID = {"data": 2, "model": 4}
FOLD_GRID = {"data": 2, "cp": 2, "model": 2}
RANKS = 8
TIMEOUT = 1800.0      # seconds, the whole spawn
FOLD_LIMIT = 1e-6


def moe_config():
    from repro_torch.core import get_smoke_config
    cfg = get_smoke_config("olmoe-1b-7b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))


def ep_plan(impl="auto"):
    from repro_torch.core import ParallelPlan
    return ParallelPlan(ep=4, ep_impl="overlap", zero_stage=1, remat="selective",
                        compute_dtype="float32", attn_impl=impl, moe_gemm_impl=impl)


def fold_plan(ep_impl, impl="auto"):
    from repro_torch.core import ParallelPlan
    return ParallelPlan(ep=4, ep_impl=ep_impl, cp=2, cp_impl="ring", tp=2, tp_impl="overlap",
                        remat="selective", compute_dtype="float32", attn_impl=impl,
                        moe_gemm_impl=impl)


def hyper():
    from repro_torch.train import Hyper
    return Hyper(peak_lr=5e-3, warmup_steps=10, total_steps=STEPS)


def _state(model, dev, grid, plan, init_params, cfg):
    """Seed 0's train state on ``grid``, or ``init_params`` (a whole numpy
    tree in the reference's layout) cut to this rank's part."""
    from repro_torch.core.sharding import grid_place, shard_layout
    from repro_torch.core.sharding import opt_state_specs
    from repro_torch.core.tree import leaves
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, init_train_state
    if init_params is None:
        return init_train_state(model, torch.Generator(device=dev).manual_seed(0), grid, plan)
    params = shard_layout(params_from_numpy(init_params, cfg, device=dev), plan,
                          *grid_place(grid))
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params, adamw_init(params, mesh=grid.data,
                                         specs=opt_state_specs(params, grid.data, plan)))


def rank_job(rank, init_method, device, steps=STEPS, check_plain=False, init_params=None):
    """One rank of both placements (module docstring). Returns the ep-only
    run's losses, grad norms and ``moe_aux``, the fold's two losses and the
    B1-B4 launches; with ``check_plain`` also ``checks``: the first step's
    loss and the fold's (each ``ep_impl``), each with its backward, through
    the kernels against the plain versions (``ranks.route_check``), their
    launches and seconds left out of the recipe's."""
    from repro_torch.core.sharding import ep_spec_for_param, grid_place, shard_layout
    from repro_torch.core import InputShape
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch import init_grid_mesh, rank_microbatches
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step
    from repro_torch.train.executor import make_executor_loss_fn
    dev = _ranks.rank_device(rank, device)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = moe_config()
    e = cfg.moe.num_experts
    ds = SyntheticDataset(cfg, InputShape("moe-ep", seq_len=64, global_batch=8, kind="train"))

    def get_batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(i).items()}

    # --- ep-only: experts over the model axis, the overlap ring -------------
    grid = init_grid_mesh(EP_GRID["data"], EP_GRID["model"], dev, backend="gloo",
                          init_method=init_method + "_ep", rank=rank)
    plan = ep_plan()
    out = {"rank": rank, "checks": {}}
    checks = out["checks"]
    before = _ranks.launches()
    t0 = time.perf_counter()
    model = build_model(cfg, plan, device=dev)
    state = _state(model, dev, grid, plan, init_params, cfg)
    if check_plain:
        checks["first"] = _ranks.route_check(
            lambda impl: make_executor_loss_fn(cfg, ep_plan(impl), grid, z_loss=hyper().z_loss),
            state.params, rank_microbatches(get_batch(0), grid.data, 1)[0])
    spec = ep_spec_for_param(("layers", "moe", "experts", "gate"),
                             (cfg.n_layers, e, cfg.d_model, cfg.moe.d_expert), plan)
    say(f"{e} experts sharded {spec} over grid {EP_GRID}: {e // 4} expert(s) per ring "
        f"rank, ep_impl={plan.ep_impl}", flush=True)
    _ranks.reset_peak(dev)
    step_fn = make_train_step(model, plan, hyper(), mesh=grid)
    hist = {"loss": [], "grad_norm": [], "moe_aux": []}
    for i in range(steps):
        batch = get_batch(i)
        state, m = step_fn(state, batch)
        for k in hist:
            hist[k].append(float(m[k]))
        if i % 20 == 0 or i == steps - 1:
            say(f"step {i:3d}  loss {hist['loss'][-1]:.4f}  moe_aux {hist['moe_aux'][-1]:.4f}",
                flush=True)
    say("expert-parallel MoE training OK", flush=True)
    out.update(hist, placement=str(spec), peak_bytes=_ranks.peak_bytes(dev))
    whole = _ranks.gather_whole(state.params, plan, grid, lambda p, c, m: m)
    grid.close()
    del state, step_fn, model

    # --- MoE parallel folding: ep == cp x tp on (2, 2, 2) -------------------
    fold = init_grid_mesh(FOLD_GRID["data"], FOLD_GRID["model"], dev, cp=FOLD_GRID["cp"],
                          backend="gloo", init_method=init_method + "_fold", rank=rank)
    out["fold"] = {}
    mb = rank_microbatches(batch, fold.data, 1)[0]
    for ep_impl in ("blocking", "overlap"):
        fplan = fold_plan(ep_impl)
        params = shard_layout(whole, fplan, *grid_place(fold))
        with torch.no_grad():
            loss, _ = make_executor_loss_fn(cfg, fplan, fold)(params, mb)
        loss = float(fold.data.all_reduce_mean(loss.detach().clone()))
        out["fold"][ep_impl] = loss
        if check_plain:
            checks[f"fold_{ep_impl}"] = _ranks.route_check(
                lambda impl: make_executor_loss_fn(cfg, fold_plan(ep_impl, impl), fold),
                params, mb)
        say(f"folded ep=4 (cp=2 x tp=2) {ep_impl:>8} a2a  loss {loss:.6f}", flush=True)
    fold.close()
    assert abs(out["fold"]["overlap"] - out["fold"]["blocking"]) < FOLD_LIMIT, out["fold"]
    say("MoE parallel folding OK: overlapped ring == blocking all-to-all", flush=True)
    out.update(launches=_ranks.launches_since(before, checks.values()),
               seconds=time.perf_counter() - t0 - sum(c["seconds"] for c in checks.values()))
    return out


def run(device=None, steps: int = STEPS):
    """Both placements on eight ranks; returns each rank's readings."""
    return _ranks.spawn([(rank_job, {"steps": steps})], RANKS, device, TIMEOUT)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    run(args.device, args.steps)


if __name__ == "__main__":
    main()
