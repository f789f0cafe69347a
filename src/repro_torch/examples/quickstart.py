"""Quickstart: build a model, train it for a few hundred steps, watch it learn.

    PYTHONPATH=src python -m repro_torch.examples.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The reference's recipe (``examples/quickstart.py``): the reduced qwen1.5-4b
config, ``remat="selective"``, fp32, seq 64, batch 8, 200 steps with
``Hyper(peak_lr=5e-3, warmup_steps=20, total_steps=200)``. Loss falls from
about 6.6 to about 1.7.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import InputShape, ParallelPlan, get_smoke_config
from repro_torch.data import SyntheticDataset
from repro_torch.models import build_model
from repro_torch.core.tree import leaves
from repro_torch.train import Hyper, init_train_state, make_train_step

STEPS = 200


def run(device=None, steps: int = STEPS):
    """Train the recipe; returns the loss of every step (floats)."""
    cfg = get_smoke_config("qwen1.5-4b")
    plan = ParallelPlan(remat="selective", compute_dtype="float32")
    shape = InputShape("quickstart", seq_len=64, global_batch=8, kind="train")
    model = build_model(cfg, plan, device=device)
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(state.params))
    print(f"arch={cfg.arch_id} (reduced) params={n_params / 1e6:.1f}M "
          f"device={model.device}", flush=True)
    step_fn = make_train_step(model, plan, Hyper(peak_lr=5e-3, warmup_steps=20,
                                                 total_steps=STEPS))
    ds = SyntheticDataset(cfg, shape)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in ds.batch(i).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  lr {metrics['lr']:.2e}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}", flush=True)
    toks = steps * shape.global_batch * shape.seq_len
    print(f"done: {toks / (time.perf_counter() - t0):.0f} tokens/s", flush=True)
    return losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    run(args.device, args.steps)


if __name__ == "__main__":
    main()
