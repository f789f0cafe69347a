"""Where one device's fp32 grads of the dense training step part from an fp64
evaluation of the same step, and whether the LM head accounts for it.

qwen1.5-4b at full width cut to chip_smoke.py's ``TP_FP32_LAYERS`` layers, one
microbatch of 1 x 4096 (train_4k), fp32 compute, the first step from seed 0:
each leaf's clipped grads against ``chip_smoke.fp64_first_grads`` (the same
step evaluated in fp64 on the plain path), in units of the fp64 leaf's max
|value|, under variants that change one piece of the LM head or its loss:

- ``fp32``: the step as it runs;
- ``loss_fp64``: the cross-entropy (the softmax's max, sum of exponentials and
  target logit) in fp64, the head GEMM in fp32;
- ``head_fp64``: the head GEMM (the logits, and their dx and dW) in fp64, the
  loss in fp32;
- ``head_split``: the head GEMM in fp32 cut into two vocab halves, so that its
  dx contraction over the vocabulary is two half sums added, as the rings'
  head (``tensor_parallel.tp_head_nll`` at tp 2) forms it.

Each variant's grads are also set against the ``fp32`` variant's. Run on one
card from the repo root: ``python3 scripts/tp_fp32_probe.py``. Prints the
card's name and power limit, then one JSON line per variant.
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as S  # noqa: E402

VARIANTS = ("fp32", "loss_fp64", "head_fp64", "head_split")


@contextlib.contextmanager
def variant(name):
    """The one-device step's head or loss changed as ``name`` says (module
    docstring), restored on exit."""
    from repro_torch.models import families
    from repro_torch.train import step as step_mod
    real_logits, real_ce = families._logits, step_mod.cross_entropy

    def loss_fp64(logits, labels, **kw):
        return real_ce(logits.double(), labels, **kw).float()

    def head_fp64(params, x, cfg, dtype):
        return real_logits(params, x.double(), cfg, torch.float64)

    def head_split(params, x, cfg, dtype):
        assert not (cfg.tie_embeddings or cfg.final_logit_softcap)
        w = params["lm_head"]["w"].to(dtype)
        assert w.shape[1] == cfg.vocab and cfg.vocab % 2 == 0
        h = cfg.vocab // 2
        return torch.cat([x @ w[:, :h], x @ w[:, h:]], dim=-1).float()

    if name == "loss_fp64":
        step_mod.cross_entropy = loss_fp64
    elif name == "head_fp64":
        families._logits = head_fp64
    elif name == "head_split":
        families._logits = head_split
    try:
        yield
    finally:
        families._logits, step_mod.cross_entropy = real_logits, real_ce


def distances(grads, ref):
    """Each leaf's max |grads - ref| in units of ref's max |value|."""
    return {n: float(np.abs(grads[n] - r).max() / max(float(np.abs(r).max()), 1e-30))
            for n, r in ref.items()}


def main():
    S.phase_device()
    from repro_torch.core import resolve_device
    from repro_torch.train import Hyper
    resolve_device()
    S.timed("build", S.phase_build)
    cfg, plan, model, batches = S.tp_setup("dense", S.TP_FP32_LAYERS, "float32", tp=1)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    truth = S.fp64_first_grads(cfg, params, batches[0], 1, Hyper())
    del params
    S.free()
    base = None
    for name in VARIANTS:
        with variant(name):
            _, _, run = S.zero1_run(model, plan, batches, watch=S.ZeroWatch(steps=1))
        S.free()
        grads = run["grads"]
        base = base or grads
        far = distances(grads, truth)
        print(json.dumps({"variant": name, "loss": run["loss"][0],
                          "grad_norm": run["grad_norm"][0],
                          "from_fp64": far, "from_fp64_median": float(np.median(list(far.values()))),
                          "from_fp32_variant": distances(grads, base)}), flush=True)


if __name__ == "__main__":
    main()
