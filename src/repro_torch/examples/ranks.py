"""Rank processes for the multi-rank examples.

The reference's examples force 8 (or 4) host devices into one JAX process; the
port's run one process per rank of the grid. :func:`spawn` starts ``n`` rank
processes (the spawn start method: a parent that holds a CUDA context cannot
fork), each running a list of jobs in turn, every job on a process group of its
own over a ``file://`` store in a temporary directory. A job is a module-level
function ``fn(rank, init_method, device, **kwargs) -> readings``, its keyword
arguments and, optionally, how many of the ranks run it (the first ones; the
others read None); the rank's readings come back to the parent through
``torch.save`` files. Every process is joined within ``timeout`` seconds (of
the whole spawn) or killed on the way out, and the directory removed.

:func:`route_check` holds the kernel route of a loss and its backward to the
plain route on the same params and batch, beside a recipe; the launches it
makes are left out of the recipe's (``launches_since``).

On the card every rank runs on a CUDA device (``cuda:r % device_count``): ranks
that share one card talk over gloo, the host transport (NCCL refuses two ranks
on one device). A rank never moves to the CPU on its own: ``device="cpu"`` runs
every rank on the CPU, the plain path.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch


def rank_device(rank: int, device: Optional[str]) -> torch.device:
    """The device of rank ``rank``: the CPU for ``device="cpu"``, else one of
    the CUDA cards (``resolve_device`` raises where there is none)."""
    from repro_torch.core import resolve_device
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device(device)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, n: int, tmp: str, jobs: Sequence[tuple], device: Optional[str]):
    """One rank: each job in turn on its own store, readings saved."""
    if rank_device(rank, device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    out: List[Any] = []
    try:
        for j, (fn, kwargs, *size) in enumerate(jobs):
            if size and rank >= size[0]:
                out.append(None)
                continue
            out.append(fn(rank, f"file://{tmp}/store{j}", device, **kwargs))
    except BaseException:
        traceback.print_exc()
        raise
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def spawn(jobs: Sequence[tuple], n: int, device: Optional[str],
          timeout: float) -> List[List[Any]]:
    """Run ``jobs`` in ``n`` rank processes; returns each job's readings, rank
    by rank (``out[job][rank]``, only the ranks that ran it). Raises if a rank
    fails or outlives ``timeout`` seconds."""
    import multiprocessing
    rank_device(0, device)                 # raises here, before any process starts
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    procs = []
    try:
        procs = [ctx.Process(target=_rank_main, args=(r, n, tmp, list(jobs), device))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            raise RuntimeError(f"rank processes of {[j[0].__qualname__ for j in jobs]} exited "
                               f"with {codes}")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(n)]
        return [[ranks[r][j] for r in range(job[2] if len(job) > 2 else n)]
                for j, job in enumerate(jobs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def gather_whole(params, plan, grid, index_of) -> Any:
    """The whole param tree from every rank's parts under ``plan``: each rank's
    host copy through ``all_gather_object`` over the grid's world, then
    ``core.sharding.gather_layout`` over the ranks of data index 0, which
    ``index_of(p, c, m)`` names (the global rank at pod p, cp c, model m).
    The whole tree lands on the params' device."""
    import torch.distributed as dist
    from repro_torch.core.sharding import gather_layout, grid_place
    from repro_torch.core.tree import leaves, map_tree
    device = leaves(params)[0].device
    mine = map_tree(lambda t: t.detach().cpu(), params)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    sizes = grid_place(grid)[1]
    shards = [every[index_of(p, c, m)] for p in range(sizes["pod"])
              for c in range(sizes["cp"]) for m in range(sizes["model"])]
    return map_tree(lambda t: t.to(device), gather_layout(shards, plan, sizes))


def peak_bytes(device: torch.device) -> int:
    """This process's peak of allocated device memory since the last reset."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def launches():
    """B1-B4's launch counters in this process: B1, B2 (dq), B3 (dk/dv), B4
    in rows and contract mode, and B1's and B4's launches by body."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd as b
    from repro_torch.kernels.flash_attention import flash_attention_lse as f
    from repro_torch.kernels.grouped_gemm import grouped_gemm as g
    return {"B1": f.launches, "B2": b.dq_launches, "B3": b.dkv_launches,
            "B4_rows": g.rows_launches, "B4_contract": g.contract_launches,
            "flash_fwd_sm90": f.sm90_launches, "flash_fwd_bf16": f.mma_launches,
            "flash_fwd_f32": f.f32_launches, "gg_sm90": g.sm90_launches,
            "gg_bf16": g.mma_launches, "gg_f32": g.f32_launches}


def launches_since(before: Dict[str, int], checks: Sequence[dict] = ()) -> Dict[str, int]:
    """The launches since ``before``, less those the ``checks``
    (``route_check`` readings taken since) made."""
    return {k: v - before[k] - sum(c["launched"][k] for c in checks)
            for k, v in launches().items()}


def count(launched: Dict[str, int]) -> int:
    """B1-B4's launches in a ``launches_since`` reading, all kernels."""
    return sum(launched[k] for k in ("B1", "B2", "B3", "B4_rows", "B4_contract"))


def routed(plan, impl: str):
    """``plan`` with attention and the expert GEMMs on route ``impl``."""
    import dataclasses
    return dataclasses.replace(plan, attn_impl=impl, moe_gemm_impl=impl)


def grads_of(loss_fn, params, batch):
    """``loss_fn(params, batch)`` and its backward on a copy of ``params``:
    (the loss, {leaf name: this rank's grad}), leaves without a grad here
    left out."""
    from repro_torch.core.tree import map_tree, named_leaves
    params = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
    loss, _ = loss_fn(params, batch)
    loss.backward()
    grads = {}
    for name, x in named_leaves(params):
        g = [p.grad for p in x] if isinstance(x, list) else [x.grad]
        if all(t is not None for t in g):
            grads[name] = torch.stack(g) if isinstance(x, list) else g[0]
    return float(loss.detach()), grads


def route_check(loss_of, params, batch) -> Dict[str, Any]:
    """One loss and its backward through the kernels (``loss_of("auto")``)
    and through the plain versions (``loss_of("plain")``) on the same
    ``params`` and ``batch``: the two losses, the worst leaf's grad error
    (``grad_rel``: max |kernel - plain| over the leaf's max |plain|; its name
    and absolute error beside it), the plain route's launches (0 when it is
    plain), and the launches and seconds the check took."""
    t0 = time.perf_counter()
    l0 = launches()
    k_loss, k_grads = grads_of(loss_of("auto"), params, batch)
    l1 = launches()
    p_loss, p_grads = grads_of(loss_of("plain"), params, batch)
    out = {"loss": [k_loss, p_loss], "grad_rel": 0.0, "grad_leaf": None, "grad_abs": 0.0}
    for name, g in p_grads.items():
        err = float((k_grads[name] - g).abs().max())
        top = float(g.abs().max())
        rel = err / top if top > 0 else (0.0 if err == 0 else float("inf"))
        if out["grad_leaf"] is None or rel > out["grad_rel"]:
            out.update(grad_rel=rel, grad_leaf=name, grad_abs=err)
    out.update(plain_launches=count(launches_since(l1)), launched=launches_since(l0),
               seconds=time.perf_counter() - t0)
    return out

