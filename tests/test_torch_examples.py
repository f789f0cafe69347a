"""The port's examples (``src/repro_torch/examples/``), in this process.

- ``preempt_resume`` against the reference's own example
  (``examples/preempt_resume.py``, run here with its ``run_with_recovery``
  and ``read_marker`` wrapped to keep what they return), on the reference's
  seed-0 weights carried over by ``interop``: the same preemption step (24)
  and marker tier ("disk"), the marker consumed and a bit-identical resume in
  the port, and the uninterrupted run's 40 losses within ``LOSS_REL`` of the
  reference's.
- Every example's entry points without a device raise on a host without CUDA:
  they run on the card unless the caller asks for the CPU, and never drop to
  it on their own.

The multi-rank examples run in ``tests/test_torch_examples_ranks.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import (pipeline_multipod, preempt_resume, quickstart,
                                  serve_longcontext, straggler_rebalance, train_moe_ep)

REPO = Path(__file__).resolve().parent.parent
# the port's and the reference's fp32 steps on the same weights and batches
# differ by rounding alone; over 40 AdamW steps at lr 5e-3 that stays under
# 1e-4 of the loss (measured here: 1.2e-5 at most)
LOSS_REL = 1e-4


def _reference_example():
    spec = importlib.util.spec_from_file_location("reference_preempt_resume",
                                                  REPO / "examples" / "preempt_resume.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def preempt_runs():
    """The reference example's main() with its reports and first marker kept,
    its seed-0 params as numpy, and the port's run on those params."""
    import jax
    from repro.core import ParallelPlan as RefPlan
    from repro.core import get_smoke_config as ref_smoke
    from repro.models import build_model as ref_build
    from repro.train import init_train_state as ref_init
    ref = _reference_example()
    reports, markers = [], []
    run_with_recovery, read_marker = ref.run_with_recovery, ref.read_marker

    def keep_report(*args, **kwargs):
        out = run_with_recovery(*args, **kwargs)
        reports.append(out[1])
        return out

    def keep_marker(directory):
        mk = read_marker(directory)
        markers.append(mk)
        return mk
    ref.run_with_recovery, ref.read_marker = keep_report, keep_marker
    ref.main()
    model = ref_build(ref_smoke("qwen1.5-4b"), RefPlan(remat="selective",
                                                       compute_dtype="float32"))
    params = jax.tree.map(np.asarray, ref_init(model, jax.random.PRNGKey(0)).params)
    port = preempt_resume.run(device="cpu", init_params=params, log=False)
    return {"reports": reports, "marker": markers[0], "port": port, "params": params}


def test_preempt_resume_preempts_where_the_reference_does(preempt_runs):
    ref_report = preempt_runs["reports"][1]
    port = preempt_runs["port"]
    assert ref_report.preempt_step == port["preempt_step"] == 24
    assert preempt_runs["marker"]["tier"] == port["marker_tier"] == "disk"


def test_preempt_resume_resumes_bit_identical(preempt_runs):
    port = preempt_runs["port"]
    assert port["marker_consumed"] and port["bit_identical"]
    assert port["steps_done"] == preempt_resume.N_STEPS
    # the resumed run replays the clean run's steps after the snapshot exactly
    tail = port["resumed_losses"][-(preempt_resume.N_STEPS - port["preempt_step"]):]
    assert tail == port["losses"][port["preempt_step"]:]


def test_preempt_resume_losses_match_the_reference(preempt_runs):
    ref = np.asarray(preempt_runs["reports"][0].losses)
    port = np.asarray(preempt_runs["port"]["losses"])
    assert ref.shape == port.shape == (preempt_resume.N_STEPS,)
    rel = np.abs(port - ref) / np.abs(ref)
    assert rel.max() <= LOSS_REL, rel.max()
    assert port[-1] < port[0]


def test_preempt_resume_first_step_is_the_runs_first(preempt_runs):
    """``first_check`` (what the card holds against the plain route) runs
    the uninterrupted run's own first loss; on the CPU both of its routes are
    the plain versions, so the losses and every leaf's grad agree exactly."""
    c = preempt_resume.first_check(device="cpu", init_params=preempt_runs["params"])
    assert c["loss"] == [preempt_runs["port"]["losses"][0]] * 2
    assert c["grad_leaf"] is not None and c["grad_rel"] == 0.0 and c["plain_launches"] == 0


def test_route_check_reads_the_worst_leaf():
    """``ranks.route_check`` (the card's kernel-against-plain check of a loss
    and its backward) holds each leaf's grad to the leaf's max, names the
    worst leaf (a list of per-layer tensors is one leaf) and leaves the
    params it was given untouched."""
    from repro_torch.examples import ranks
    params = {"a": torch.tensor([1.0, -2.0]),
              "layers": [{"w": torch.tensor([3.0])}, {"w": torch.tensor([4.0])}]}

    def loss_of(impl):
        k = 1.001 if impl == "auto" else 1.0

        def loss_fn(p, batch):
            layers = sum(lp["w"].square().sum() for lp in p["layers"])
            return p["a"].square().sum() + k * layers, {}
        return loss_fn
    c = ranks.route_check(loss_of, params, None)
    assert c["loss"][1] == 30.0 and c["loss"][0] == pytest.approx(30.025, rel=1e-6)
    assert c["grad_leaf"] == "layers/w"
    assert c["grad_rel"] == pytest.approx(1e-3, rel=1e-4)
    assert c["grad_abs"] == pytest.approx(8e-3, rel=1e-4)
    assert c["plain_launches"] == 0 and ranks.count(c["launched"]) == 0
    assert params["a"].grad is None and not params["a"].requires_grad



ENTRY_POINTS = {
    "quickstart.run": lambda: quickstart.run(steps=1),
    "preempt_resume.run": lambda: preempt_resume.run(),
    "preempt_resume.first_check": lambda: preempt_resume.first_check(),
    "train_moe_ep.run": lambda: train_moe_ep.run(steps=1),
    "pipeline_multipod.run": lambda: pipeline_multipod.run(),
    "serve_longcontext.run": lambda: serve_longcontext.run(),
    "straggler_rebalance.run": lambda: straggler_rebalance.run(),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_examples_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("module", [preempt_resume, train_moe_ep, pipeline_multipod,
                                    serve_longcontext, straggler_rebalance])
def test_main_defaults_to_the_card(module, monkeypatch):
    """``main()`` without ``--device`` asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    monkeypatch.setattr("sys.argv", [module.__name__])
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main()
