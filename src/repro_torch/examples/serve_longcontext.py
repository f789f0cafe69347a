"""Batched long-context serving with a sequence-sharded KV cache.

    PYTHONPATH=src python -m repro_torch.examples.serve_longcontext              # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_longcontext --device cpu

The reference's recipe (``examples/serve_longcontext.py``) on a (data 2, model
4) grid, eight rank processes: ``ParallelPlan(remat="none",
compute_dtype="float32", seq_shard_decode=True)``, batch 4, ``max_ctx`` 256,
a 16-token prompt (seed 0) and 32 greedy decode steps, for

- mamba2-370m (reduced), whose O(1) state takes the prompt through
  ``decode_step``, one token at a time;
- gemma2-9b (reduced) with ``sliding_window=64, long_context=True``, whose
  prompt goes through the sharded prefill; the K/V cache is laid out (batch @
  data, seq @ model) and each decode step merges the model ranks' partial
  attention (the logsumexp combine).

It prints each K/V cache entry's shape and placement, and asserts finite
logits. The data ranks split the batch's rows: each rank decodes its rows and
feeds back its own greedy tokens. As the port's grid serving does (ROADMAP
A13.6), the SSM states are whole on every model rank, and every model rank
holds the whole params.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.examples import ranks as _ranks

ARCHS = ("mamba2-370m", "gemma2-9b")
GRID = {"data": 2, "model": 4}
RANKS = 8
TIMEOUT = 900.0       # seconds, the whole spawn
BATCH, MAX_CTX, PROMPT, GEN = 4, 256, 16, 32


def serve_config(arch):
    from repro_torch.core import get_smoke_config
    cfg = get_smoke_config(arch)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=64, long_context=True)
    return cfg


def prompt_tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)


def serve(arch, grid, dev, impl="auto", init_params=None, steps=GEN, say=print):
    """Prefill (or the prompt through ``decode_step``) and ``steps`` greedy
    steps of this rank's rows: the logits of every decode step, the tokens
    fed back, and the prefill's last-position logits (None without a
    prefill)."""
    from repro_torch.core import ParallelPlan
    from repro_torch.core.sharding import cache_specs
    from repro_torch.core.tree import named_leaves
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model
    cfg = serve_config(arch)
    plan = ParallelPlan(remat="none", compute_dtype="float32", seq_shard_decode=True,
                        attn_impl=impl)
    model = build_model(cfg, plan, device=dev, mesh=grid)
    params = (model.init(torch.Generator(device=dev).manual_seed(0)) if init_params is None
              else params_from_numpy(init_params, cfg, device=dev))
    cache = model.init_cache(BATCH, MAX_CTX)
    specs = cache_specs(cache, plan, grid, ("data",))
    placement = {}
    for name, leaf in named_leaves(cache):
        if name in ("k", "v", "attn_k", "attn_v"):
            placement[name] = (tuple(leaf.shape), specs[name])
            say(f"{arch}: cache[{name}] {tuple(leaf.shape)} a rank, sharded {specs[name]}",
                flush=True)
    prompt = torch.from_numpy(prompt_tokens(cfg)).to(dev)
    lo, hi = model.place.rows(BATCH)
    steps_logits, tokens = [], []
    with torch.no_grad():
        if hasattr(model, "prefill"):
            logits_all, cache = model.prefill(params, {"tokens": prompt}, MAX_CTX)
            logits = model.last_logits(logits_all, PROMPT)
            prefill_last = logits.float().cpu().numpy()
            pos = PROMPT
        else:
            prefill_last = None
            for pos in range(PROMPT):
                logits, cache = model.decode_step(params, cache, prompt[lo:hi, pos], pos)
            pos = PROMPT
        for _ in range(steps):
            tok = torch.argmax(logits, -1)
            tokens.append(tok.cpu().numpy())
            logits, cache = model.decode_step(params, cache, tok, pos)
            steps_logits.append(logits.float().cpu().numpy())
            pos += 1
    assert all(np.isfinite(lg).all() for lg in steps_logits)
    gen = np.stack(tokens, 1)
    say(f"{arch}: generated {gen.shape} tokens a rank (rows {lo}:{hi} of {BATCH}), "
        f"first row: {gen[0][:10]}...", flush=True)
    return {"rows": (lo, hi), "tokens": gen, "logits": steps_logits, "placement": placement,
            "prefill_last": prefill_last}


def first_logits(served):
    """The logits a kernel route can move first: the prefill's last position
    (where there is a prefill) and the first decode step."""
    return [x for x in (served["prefill_last"], served["logits"][0]) if x is not None]


def rank_job(rank, init_method, device, check_plain=False, init_params=None):
    """One rank of the recipe for both models: each one's readings with the
    logits of its prefill's last position (where it has a prefill) and of its
    first decode step (``first["kernel"]``), the B1-B4 launches; with
    ``check_plain`` also the same logits through the plain versions
    (``first["plain"]``) and the launches that route made
    (``first["plain_launches"]``, 0 when it is plain)."""
    from repro_torch.launch import init_grid_mesh
    dev = _ranks.rank_device(rank, device)
    say = print if rank == 0 else (lambda *a, **k: None)
    grid = init_grid_mesh(GRID["data"], GRID["model"], dev, backend="gloo",
                          init_method=init_method, rank=rank)
    out = {"rank": rank}
    _ranks.reset_peak(dev)
    before = _ranks.launches()
    t0 = time.perf_counter()
    for arch in ARCHS:
        init = None if init_params is None else init_params[arch]
        out[arch] = serve(arch, grid, dev, init_params=init, say=say)
        out[arch]["first"] = {"kernel": first_logits(out[arch])}
        if check_plain:
            p0 = _ranks.launches()
            plain = serve(arch, grid, dev, "plain", init, steps=1, say=lambda *a, **k: None)
            out[arch]["first"].update(plain=first_logits(plain),
                                      plain_launches=_ranks.count(_ranks.launches_since(p0)))
    out.update(peak_bytes=_ranks.peak_bytes(dev), launches=_ranks.launches_since(before),
               seconds=time.perf_counter() - t0)
    grid.close()
    say("long-context serving OK", flush=True)
    return out


def run(device=None):
    """Both models on the eight ranks; returns each rank's readings."""
    return _ranks.spawn([(rank_job, {})], RANKS, device, TIMEOUT)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args()
    run(args.device)


if __name__ == "__main__":
    main()
