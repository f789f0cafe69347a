#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100 and
check its kernels.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order (each
prints its seconds):

1. device   — require CUDA with compute capability 9.0; print the card's name
   and power limit as nvidia-smi reports them;
2. build    — compile every CUDA source of the paths (one nvcc each, in parallel);
3. kernels  — hold each kernel against its plain PyTorch version on the card:
   the flash forward (o: fp32 to 3e-5, bf16 to 2 bf16 ulps; lse to 1e-5
   relative) and the backward's dq and dk/dv kernels (fp32 to 1e-5 of each
   tensor's largest value, bf16 to 2 bf16 ulps), fully masked rows included,
   at the paths' own shapes, with merged softmax statistics, and through the
   autograd Function; the grouped expert GEMM (fp32 to 5e-5 of the tensor's
   largest value, bf16 to 2 bf16 ulps, padding rows and experts with no load
   exactly 0) in its three uses — forward and dx (through a w^T view) in rows
   mode, dw (through an x^T view) in contract mode — at the MoE paths' shapes
   and a ragged one;
4. serving  — qwen2.5-14b at full width (48 layers, random bf16 weights from a
   seed): prefill of 4 x 1000 tokens, then 32 greedy decode steps, with the
   flash kernel's launches counted; the kernel held to its plain version, to
   the same tolerance, on every layer's own q/k/v from three full-width
   prefills (and, as a reading only, how far their logits drift from a
   prefill with plain attention); and a small smoke-config model on the card
   against the same model on the CPU;
5. training — the qwen1.5-4b smoke config on the card against the CPU (5 steps,
   loss and grad norm to 1e-4) and under the three remat modes (grads to 1e-6);
   the 200-step quickstart recipe (loss below 2.5 at the end); then qwen1.5-4b
   at full width (40 layers, 3.95 B parameters, fp32 masters, bf16 compute,
   remat "full", 2 microbatches of 1 x 4096 tokens): the backward kernels held
   to their plain version on every layer's own inputs, then one warm-up and
   three timed train steps with the kernels' launches counted, and a profile;
6. MoE serving — the deepseek-moe-16b smoke config on the card against the
   CPU; deepseek-moe-16b at full width and depth (28 layers, 16.9 B parameters,
   random bf16 weights from a seed): prefill of 4 x 1000 tokens under the
   einsum dispatch and under the scatter dispatch, 32 greedy decode steps, the
   kernels' launches counted (B1 28 and B4 84 per prefill, B4 84 per decode
   step); B4 held to its plain version on every layer's own inputs of a
   prefill; readings: the einsum-vs-scatter and kernel-vs-plain-GEMM logit
   drift and the one-hot dispatch einsums' time; profiles;
7. MoE training — the smoke config on the card against the CPU and under the
   three remat modes; deepseek-moe-16b at full width and 4 of its 28 layers
   (fp32 masters, remat "full", 2 microbatches of 1 x 4096): B4's every call of
   one microbatch (forward, recompute, dx, dw) held to its plain version, then
   one warm-up and three timed steps with the launches counted (B4 72 in rows
   mode and 24 in contract mode per step), and a profile;
8. SSD kernels — the Mamba2 chunk scan's forward (B5: y, entering and final
   states, to 2e-4 of max(1, max |plain|)) and backward (B6: ddt and dA to 1e-4
   of that measure, the bf16 dx, dB, dC to 2 bf16 ulps) against their plain
   versions at both families' serving and training shapes (a ragged 8000),
   chunks 16, 24 and 1, G = 2 and 4, a non-zero final-state cotangent, fp32 and
   bf16, and through the autograd Function;
9. mamba2-370m and zamba2-1.2b, each: the smoke config on the card against the
   CPU; serving at full width and depth (random bf16 weights and conv taps from
   a seed): a forward over 4 x 8000 tokens (B5 48 or 38 launches, B1 6 for the
   hybrid's shared block), a 16-token prompt through decode_step and 32 greedy
   steps, B5 held to its plain version on every layer's own inputs; training at
   full width and depth (fp32 masters, remat "full", 2 microbatches of 4 or 2 x
   4096): the smoke config card vs CPU and under the three remat modes, B5/B6
   held to their plain versions on every call of one microbatch, one warm-up
   and three timed steps with the launches counted (B5 192/152, B6 96/76, and
   B1/B2/B3 12 each for the hybrid), profiles;
10. times   — each kernel's time at its path's shapes beside its bound, its plain
   version's time and the library call's (none for B5/B6), printed as one JSON
   line.

Any failure raises: the script exits non-zero and prints no final line. The
last line is ``{"ok": true, "device": {...}}``.
"""

import os

# the full-width train step holds ~74 GB; segments that grow in place keep the
# allocator from failing on fragmentation near the card's 80 GB
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3

ARCH = "qwen2.5-14b"
BATCH, PROMPT, MAX_SEQ, DECODE_STEPS = 4, 1000, 1056, 32

# (b, hq, hkv, s, t, hd, causal, window, softcap, q_offset)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0, 0.0, 0),
    (1, 4, 4, 256, 256, 64, True, 32, 0.0, 0),
    (2, 2, 1, 100, 100, 32, True, 0, 30.0, 0),       # ragged S and T
    (1, 8, 2, 128, 128, 128, False, 0, 0.0, 0),
    (1, 2, 2, 64, 192, 64, True, 0, 0.0, 0),         # cross lengths
    (1, 4, 1, 128, 128, 256, True, 4096, 50.0, 0),   # gemma2-like head dim
    (1, 4, 2, 50, 177, 64, True, 0, 0.0, 127),       # q_offset (chunked prefill)
    (1, 2, 1, 64, 16, 64, True, 8, 0.0, 64),         # fully masked rows
    (BATCH, 40, 8, PROMPT, PROMPT, 128, True, 0, 0.0, 0),   # the serving path
]
# o in fp32 to 3e-5; o in bf16 to 2 bf16 ulps of the plain version's value
# (both round one fp32 result); lse, fp32 math on the same inputs in both
# dtypes, to 1e-5 relative. A KV tile dropped or counted twice moves o by tens
# of ulps. tests/test_torch_flash.py holds the kernel to the same.
O_ABS_F32, O_ULPS_BF16, LSE_REL = 3e-5, 2.0, 1e-5
TOLERANCE = "o: fp32 3e-5 abs, bf16 2 ulps of |plain| (floor 2^-10); lse: 1e-5 rel"
PROMPT_SEEDS = (0, 1, 2)      # prompts of the real-input layer check

# the backward kernels: dq, dk, dv judged against the largest |value| of the
# plain version's tensor (gradients have no fixed scale). fp32 within 1e-5 of
# it; bf16 within 2 bf16 ulps of each value, |value| floored at 2^-10 of the
# largest. A KV tile dropped or doubled in the dq sweep, or a query tile in the
# dk/dv sweep, misses by more than 4x (tests/test_torch_flash_bwd.py).
GRAD_REL_F32, GRAD_ULPS_BF16 = 1e-5, 2.0
GRAD_TOLERANCE = ("dq/dk/dv: fp32 1e-5 of the tensor's max |value|, bf16 2 ulps of "
                  "|plain| (floor 2^-10 of the max)")
TRAIN_ARCH = "qwen1.5-4b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 4096, 2, 2     # train_4k's sequence length
TRAIN_STEPS = 3                                    # timed, after one warm-up
TRAIN_CASE = (1, 20, 20, TRAIN_SEQ, TRAIN_SEQ, 128, True, 0, 0.0, 0)   # one microbatch

MOE_ARCH = "deepseek-moe-16b"
# training keeps 4 of the 28 layers: fp32 masters, grads and two moments take 16
# bytes a parameter, 270 GB for all 28 layers, 44 GB for these 4
MOE_TRAIN_LAYERS = 4
# B4 at the MoE paths' shapes (E, C, d, f), C = int(n * 6 / 64 * 1.25) for the n
# tokens of a call: the prefill (n 4 x 1000), a decode step (n 4), a training
# microbatch (n 4096); each GEMM also runs with d and f swapped (the down
# projection), and a ragged case
GEMM_CASES = [(64, 468, 2048, 1408), (64, 468, 1408, 2048), (64, 1, 2048, 1408),
              (64, 1, 1408, 2048), (64, 480, 2048, 1408), (64, 480, 1408, 2048),
              (5, 100, 136, 72)]
# fp32 within 5e-5 of the tensor's largest |value|; bf16 within 2 bf16 ulps of
# each value (both sides round one fp32 sum; |value| floored at 2^-10 of the
# largest); padding rows (rows mode) and experts with no load exactly 0. A
# dropped contraction tile or a row of another expert misses by far more
# (tests/test_torch_grouped_gemm.py).
GEMM_REL_F32, GEMM_ULPS_BF16 = 5e-5, 2.0
GEMM_TOLERANCE = ("fp32 5e-5 of the tensor's max |value|, bf16 2 ulps of |plain| "
                  "(floor 2^-10 of the max); padding rows and zero-load experts exactly 0")

SSM_ARCH, HYBRID_ARCH = "mamba2-370m", "zamba2-1.2b"
# serving: a forward over 4 x 8000 tokens (62 chunks of 128 and a ragged 64), then a
# 16-token prompt through decode_step and DECODE_STEPS greedy steps
SSM_BATCH, SSM_PROMPT, SSM_DECODE_PROMPT = 4, 8000, 16
# training: TRAIN_MICRO microbatches of 4 sequences (mamba2; B5's grid 4 x 32 = 128
# blocks) or 2 (zamba2: 2 x 64) of TRAIN_SEQ tokens
SSM_TRAIN_BATCH = {SSM_ARCH: 8, HYBRID_ARCH: 4}
# B5/B6 at (b, l, h, p, g, n, chunk): the four path shapes, the decode check's
# 16-token prompt (chunk 16), chunk 24 with G 4, G 2 on a ragged length, chunk 1
SSD_PATH_CASES = {
    "mamba2_serving": (SSM_BATCH, SSM_PROMPT, 32, 64, 1, 128, 128),
    "mamba2_training": (4, TRAIN_SEQ, 32, 64, 1, 128, 128),
    "zamba2_serving": (SSM_BATCH, SSM_PROMPT, 64, 64, 1, 64, 128),
    "zamba2_training": (2, TRAIN_SEQ, 64, 64, 1, 64, 128),
}
SSD_CASES = list(SSD_PATH_CASES.values()) + [
    (SSM_BATCH, SSM_DECODE_PROMPT, 32, 64, 1, 128, 16),
    (1, 96, 4, 8, 4, 8, 24),
    (2, 100, 4, 32, 2, 16, 16),
    (1, 7, 2, 4, 1, 4, 1),
]
# The reference's limits (y and states 2e-4, tests/test_kernels.py; gradients 1e-4,
# tests/test_kernels_grad.py) read against max(1, the tensor's largest |value|); a
# bf16 result (dx, dB, dC of bf16 inputs) within 2 bf16 ulps of each value (both
# sides round one fp32 value; floor 2^-10 of the max). A dropped chunk state or decay
# rates 0.1% off miss by 3x or more (tests/test_torch_ssd.py).
SSD_Y_TOL, SSD_GRAD_TOL, SSD_ULPS_BF16 = 2e-4, 1e-4, 2.0
SSD_FWD_TOLERANCE = "y, entering and final states: 2e-4 of max(1, max |plain|)"
SSD_BWD_TOLERANCE = ("ddt, dA: 1e-4 of max(1, max |plain|); dx, dB, dC (bf16): 2 ulps of "
                     "|plain| (floor 2^-10 of the max); fp32 inputs: all 1e-4")
BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attended_pairs(s, t, causal, window, q_offset):
    """(query, key) pairs the mask lets through: the work this input needs."""
    rows = q_offset + np.arange(s)[:, None]
    cols = np.arange(t)[None, :]
    m = np.ones((s, t), bool)
    if causal:
        m &= cols <= rows
    if window > 0:
        m &= (rows - cols) < window
    return int(m.sum())


def match_errors(o, lse, po, plse):
    """(max |o - po|, the same in bf16 ulps of |po|, max lse relative error).
    |po| is floored at 2^-10 so that the fp32 noise (~1e-6) on an output near
    zero is not counted in ulps of zero."""
    err = (o.float() - po.float()).abs()
    e = torch.frexp(po.float().abs().clamp(min=2 ** -10)).exponent
    ulps = err / torch.ldexp(torch.ones_like(err), e - 8)
    lse_rel = (lse - plse).abs() / plse.abs().clamp(min=1.0)
    return err.max().item(), ulps.max().item(), lse_rel.max().item()


def within_tolerance(dtype, o_abs, o_ulps, lse_rel):
    o_ok = o_ulps <= O_ULPS_BF16 if dtype == torch.bfloat16 else o_abs <= O_ABS_F32
    return o_ok and lse_rel <= LSE_REL


def grad_error(x, ref):
    """(max |x - ref|, the error in the limit's own measure: bf16 ulps of
    |ref| floored at 2^-10 of the tensor's largest |value|, or for fp32 the
    fraction of that largest |value|)."""
    ref = ref.float()
    err = (x.float() - ref).abs()
    big = ref.abs().max().clamp(min=1e-30)
    if x.dtype == torch.bfloat16:
        e = torch.frexp(torch.maximum(ref.abs(), big * 2 ** -10)).exponent
        ulps = err / torch.ldexp(torch.ones_like(err), e - 8)
        return err.max().item(), ulps.max().item()
    return err.max().item(), (err.max() / big).item()


def grads_within(dtype, errs):
    limit = GRAD_ULPS_BF16 if dtype == torch.bfloat16 else GRAD_REL_F32
    return all(e[1] <= limit for e in errs)


def fmt_grad_errors(errs):
    return ", ".join(f"{n} {a:.3e} ({u:.2e})" for n, (a, u) in zip(("dq", "dk", "dv"), errs))


def batch_major(gen, b, h, n, hd, dtype):
    """A head-major (B, H, N, hd) view of a batch-major tensor, as the model
    hands the kernel its q/k/v."""
    x = torch.randn(b, n, h, hd, generator=gen, device="cuda", dtype=torch.float32)
    return x.to(dtype).transpose(1, 2)


def bwd_inputs(gen, case, dtype, t_stats=None):
    """q, k, v, do (head-major views of batch-major tensors) and the softmax
    statistics of attention over the first ``t_stats`` keys (all by default):
    lse from the plain forward and delta = rowsum(dO * O), as the autograd
    Function takes it (O in the input dtype)."""
    from repro_torch.kernels.flash_attention import flash_attention_lse_plain
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = case
    q = batch_major(gen, b, hq, s, hd, dtype)
    k = batch_major(gen, b, hkv, t, hd, dtype)
    v = batch_major(gen, b, hkv, t, hd, dtype)
    do = batch_major(gen, b, hq, s, hd, dtype)
    tt = t if t_stats is None else t_stats
    o, lse = flash_attention_lse_plain(q, k[:, :, :tt], v[:, :, :tt], causal=causal,
                                       window=window, softcap=cap, q_offset=q_offset)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


def case_kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8], q_offset=case[9])


def bwd_counts():
    from repro_torch.kernels.flash_attention import flash_attention_bwd as bwd
    return bwd.dq_launches, bwd.dkv_launches


def gemm_counts():
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    return grouped_gemm.rows_launches, grouped_gemm.contract_launches


def all_counts():
    """Launches of B1, B2, B3 and B4 (rows mode, contract mode)."""
    from repro_torch.kernels.flash_attention import flash_attention_lse
    return (flash_attention_lse.launches, *bwd_counts(), *gemm_counts())


def reset_counts():
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_lse)
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    flash_attention_lse.launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    grouped_gemm.rows_launches = grouped_gemm.contract_launches = 0


def gemm_check(out, a, b, gs, mask):
    """B4's result against its plain version on the same inputs: (max |error|,
    the error in the limit's measure, whether padding rows and experts with no
    load are exactly 0, whether the error is within the limit)."""
    from repro_torch.kernels.grouped_gemm import grouped_gemm_plain
    ref = grouped_gemm_plain(a, b, gs, mask=mask)
    abs_err, err = grad_error(out, ref)
    limit = GEMM_ULPS_BF16 if out.dtype == torch.bfloat16 else GEMM_REL_F32
    zeros = True
    if gs is not None:
        o = out.float()
        zeros = bool((o[gs == 0] == 0).all())
        if mask == "rows":
            rows = torch.arange(o.shape[1], device=o.device)[None, :, None]
            zeros &= bool((o[(rows >= gs[:, None, None]).expand_as(o)] == 0).all())
    ok = err <= limit and zeros and bool(torch.isfinite(out).all())
    return abs_err, err, zeros, ok


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def to_cuda(tree):
    if isinstance(tree, dict):
        return {k: to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cuda(v) for v in tree]
    return tree.cuda()


def profile_window(name, fn):
    """Kernel time by name over one call of ``fn``, and the device's busy share
    of the profiled wall time (the profiler's own overhead included). Only the
    CUDA activity is traced: the host-side op events add nothing these numbers
    read and cost ~30 s of trace processing for a step of ~30,000 ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"profile {name}: wall {wall * 1e3:.2f} ms, kernels {busy * 1e3:.2f} ms, "
        f"device busy {busy / wall:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return torch.cuda.get_device_name(0)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(["flash_fwd", "flash_bwd", "grouped_gemm", "ssd_fwd", "ssd_bwd"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels():
    from repro_torch.kernels.flash_attention import (flash_attention_lse,
                                                     flash_attention_lse_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    path_errs = None
    for case in FLASH_CASES:
        b, hq, hkv, s, t, hd, causal, window, cap, q_offset = case
        for dtype in (torch.float32, torch.bfloat16):
            q = batch_major(gen, b, hq, s, hd, dtype)
            k = batch_major(gen, b, hkv, t, hd, dtype)
            v = batch_major(gen, b, hkv, t, hd, dtype)
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
            o, lse = flash_attention_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            po, plse = flash_attention_lse_plain(q, k, v, **kw)
            errs = match_errors(o, lse, po, plse)
            finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
            dead = plse < -1e29                  # fully masked rows
            dead_ok = bool((o.float()[dead] == 0).all() and (lse[dead] < -1e29).all())
            log(f"check {case} {str(dtype)[6:]}: o err {errs[0]:.3e} = {errs[1]:.2f} "
                f"bf16 ulps, lse rel err {errs[2]:.3e}, masked rows {int(dead.sum())}")
            if not (within_tolerance(dtype, *errs) and finite and dead_ok):
                raise AssertionError(f"flash_fwd disagrees with its plain version "
                                     f"on {case} {dtype}")
            if case == FLASH_CASES[-1] and dtype == torch.bfloat16:
                path_errs = errs
    return path_errs


def smoke_agreement(arch=ARCH):
    """A small model on the card (kernel path) against the same weights on the
    CPU (plain path), fp32: prefill and decode logits to 1e-4."""
    from repro_torch.core import ParallelPlan, get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config(arch)
    plan = ParallelPlan(compute_dtype="float32")
    gpu, cpu = build_model(cfg, plan), build_model(cfg, plan, device="cpu")
    cparams = cpu.init(torch.Generator().manual_seed(1))
    params = to_cuda(cparams)
    tokens = torch.randint(0, cfg.vocab, (2, 37),
                           generator=torch.Generator().manual_seed(2))
    lg, cache = gpu.prefill(params, {"tokens": tokens[:, :33].cuda()}, max_seq=40)
    clg, ccache = cpu.prefill(cparams, {"tokens": tokens[:, :33]}, max_seq=40)
    errs = [(lg.cpu() - clg).abs().max().item()]
    for pos in range(33, 37):
        lg, cache = gpu.decode_step(params, cache, tokens[:, pos].cuda(), pos)
        clg, ccache = cpu.decode_step(cparams, ccache, tokens[:, pos], pos)
        errs.append((lg.cpu() - clg).abs().max().item())
    log(f"smoke {arch} fp32, card vs cpu: max logit diff {max(errs):.3e}")
    if max(errs) > 1e-4:
        raise AssertionError("the card's smoke-config logits disagree with the CPU's")


def kernel_on_real_inputs(model, plain, params, cfg):
    """Hold the kernel to its plain version on every layer's own q/k/v, from a
    full-width prefill of each of three prompts. As a reading only, also how
    far each prefill's last-position logits lie from a prefill with plain
    attention: once two bf16 prefills differ anywhere, 48 layers of bf16
    rounding carry that to about 2e-2, whatever the kernel (PERF.md)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (flash_attention_lse,
                                                     flash_attention_lse_plain)
    real, calls = dispatch.flash_attention, []

    def capture(q, k, v, **kw):
        o, lse = flash_attention_lse(q, k, v, **kw)
        calls.append((q, k, v, kw, o, lse))
        return o

    worst = 0.0
    for seed in PROMPT_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(100 + seed)
        batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                                         generator=gen, device="cuda")}
        dispatch.flash_attention = capture
        try:
            logits, _ = model.prefill(params, batch, max_seq=MAX_SEQ)
        finally:
            dispatch.flash_attention = real
        last = logits[:, -1].clone()
        del logits
        if len(calls) != cfg.n_layers:
            raise AssertionError(f"captured {len(calls)} flash calls, "
                                 f"expected {cfg.n_layers}")
        errs = []
        for q, k, v, kw, o, lse in calls:
            errs.append(match_errors(o, lse, *flash_attention_lse_plain(q, k, v, **kw)))
        calls.clear()
        o_abs, o_ulps, lse_rel = (max(e[i] for e in errs) for i in range(3))
        worst = max(worst, o_ulps)
        ref = plain.prefill(params, batch, max_seq=MAX_SEQ)[0][:, -1]
        drift = ((last - ref).abs().max() / ref.abs().max()).item()
        log(f"real inputs, prompt seed {seed}: {len(errs)} layers, o err "
            f"{o_abs:.3e} = {o_ulps:.2f} bf16 ulps, lse rel err {lse_rel:.3e}; "
            f"prefill last-position logits, kernel vs plain attention: "
            f"max diff / max |logit| = {drift:.3e} (reading)")
        if not within_tolerance(torch.bfloat16, o_abs, o_ulps, lse_rel):
            raise AssertionError(f"flash_fwd disagrees with its plain version on "
                                 f"the prefill's own inputs (prompt seed {seed})")
    return worst


def phase_serving():
    from repro_torch.core import ParallelPlan, get_config
    from repro_torch.kernels.flash_attention import flash_attention_lse
    from repro_torch.models import build_model

    smoke_agreement()
    cfg = get_config(ARCH)
    model = build_model(cfg, ParallelPlan(compute_dtype="bfloat16",
                                         param_dtype="bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for lp in params["layers"] for d in lp.values()
                   for t in d.values())
    n_params += sum(t.numel() for k, d in params.items() if k != "layers"
                    for t in d.values())
    log(f"init {ARCH}: {n_params / 1e9:.2f} B params in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device="cuda")
    batch = {"tokens": tokens}

    # warm-up: one prefill and one decode step (cuBLAS heuristics, allocator)
    lg, cache = model.prefill(params, batch, max_seq=MAX_SEQ)
    model.decode_step(params, cache, lg[:, -1].argmax(-1), PROMPT)
    del lg, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention_lse.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_seq=MAX_SEQ)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = flash_attention_lse.launches
    if prefill_launches != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_fwd {prefill_launches} times, "
                             f"expected {cfg.n_layers}")
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite")
    tok = logits[:, -1].argmax(-1)
    del logits
    t0 = time.perf_counter()
    out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
    for i in range(DECODE_STEPS):
        lg, cache = model.decode_step(params, cache, tok, PROMPT + i)
        finite &= torch.isfinite(lg).all()      # checked after the loop: no sync
        tok = lg.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / DECODE_STEPS
    if not finite:
        raise AssertionError("decode logits are not finite")
    launches = flash_attention_lse.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"serving {ARCH}: prefill {BATCH}x{PROMPT} in {t_prefill * 1e3:.1f} ms = "
        f"{BATCH * PROMPT / t_prefill:.0f} tokens/s; decode {t_decode * 1e3:.2f} "
        f"ms/step (batch {BATCH}); peak memory {peak / 1e9:.2f} GB; "
        f"flash_fwd launches {launches}")
    log(f"generated tokens, row 0: {torch.stack(out, 1)[0, :10].tolist()}")
    profile_window("decode step", lambda: model.decode_step(
        params, cache, tok, PROMPT + DECODE_STEPS))
    del cache
    profile_window("prefill", lambda: model.prefill(params, batch, max_seq=MAX_SEQ))

    plain = build_model(cfg, ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16",
                                         attn_impl="plain"))
    real_ulps = kernel_on_real_inputs(model, plain, params, cfg)
    return launches, real_ulps


def phase_kernels_bwd():
    """The dq and dk/dv kernels against their plain version: every FLASH_CASES
    row and the training shape in both dtypes, merged softmax statistics, and
    the autograd Function. Returns the errors at the training shape (bf16)."""
    from repro_torch.kernels import flash_attention as tf
    from repro_torch.models.layers import attention_chunk_grads
    gen = torch.Generator(device="cuda").manual_seed(5)
    train_errs = None
    for case in FLASH_CASES + [TRAIN_CASE]:
        kw = case_kw(case)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, lse, delta = bwd_inputs(gen, case, dtype)
            before = bwd_counts()
            grads = tf.flash_attention_bwd(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            if bwd_counts() != (before[0] + 1, before[1] + 1):
                raise AssertionError("flash_attention_bwd did not launch both kernels")
            ref = tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
            errs = [grad_error(g, r) for g, r in zip(grads, ref)]
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            dead = lse < -1e29                   # fully masked rows
            dead_ok = bool((grads[0].float()[dead] == 0).all())
            log(f"check bwd {case} {str(dtype)[6:]}: {fmt_grad_errors(errs)}, "
                f"masked rows {int(dead.sum())}")
            if not (grads_within(dtype, errs) and finite and dead_ok):
                raise AssertionError(f"flash_bwd disagrees with its plain version "
                                     f"on {case} {dtype}")
            if case == TRAIN_CASE and dtype == torch.bfloat16:
                train_errs = errs
            del q, k, v, do, lse, delta, grads, ref

    # the chunk entry: statistics of attention over all 512 keys, gradients of
    # the first 256 only, against attention_chunk_grads
    case = (1, 4, 2, 256, 512, 128, True, 0, 0.0, 256)
    kw = case_kw(case)
    hm = lambda x: x.transpose(1, 2)                     # noqa: E731
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, lse, delta = bwd_inputs(gen, case, dtype)
        kh, vh = k[:, :, :256], v[:, :, :256]
        grads = tf.flash_attention_bwd(q, kh, vh, do, lse, delta, **kw)
        ref = attention_chunk_grads(hm(q), hm(kh), hm(vh), hm(do), hm(lse), hm(delta), **kw)
        errs = [grad_error(g, hm(r)) for g, r in zip(grads, ref)]
        log(f"check bwd merged statistics {case} {str(dtype)[6:]}: {fmt_grad_errors(errs)}")
        if not grads_within(dtype, errs):
            raise AssertionError(f"flash_bwd disagrees with attention_chunk_grads ({dtype})")

    # the autograd Function, fp32: grads of sum(flash_attention(q, k, v) * w)
    # against autograd through the plain forward. (In bf16 the Function takes
    # delta from the bf16-rounded O, as the reference does, while autograd
    # through the plain forward uses the unrounded one.)
    for case in (FLASH_CASES[0], FLASH_CASES[2], FLASH_CASES[6], FLASH_CASES[7]):
        kw = case_kw(case)
        b, hq, hkv, s, t, hd = case[:6]
        q, k, v, w = (batch_major(gen, b, h, n, hd, torch.float32).detach().requires_grad_()
                      for h, n in ((hq, s), (hkv, t), (hkv, t), (hq, s)))
        before = (tf.flash_attention_lse.launches, *bwd_counts())
        grads = torch.autograd.grad((tf.flash_attention(q, k, v, **kw) * w).sum(), (q, k, v))
        if (tf.flash_attention_lse.launches, *bwd_counts()) != tuple(x + 1 for x in before):
            raise AssertionError("the autograd Function did not launch B1, B2 and B3 once")
        ref = torch.autograd.grad((tf.flash_attention_lse_plain(q, k, v, **kw)[0] * w).sum(),
                                  (q, k, v))
        errs = [grad_error(g, r) for g, r in zip(grads, ref)]
        log(f"check autograd Function {case} float32: {fmt_grad_errors(errs)}")
        if not grads_within(torch.float32, errs):
            raise AssertionError(f"the autograd Function's grads disagree on {case}")
    return train_errs


def train_smoke_agreement(arch=TRAIN_ARCH):
    """A smoke config, fp32: 5 train steps on the card (kernels) against the
    same steps on the CPU (plain path), from the same weights and batches; then
    the three remat modes' grads on the card."""
    from repro_torch.core import REMAT_MODES, InputShape, ParallelPlan, get_smoke_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.core.tree import leaves
    from repro_torch.train import Hyper, TrainState, make_loss_fn, make_train_step
    cfg = get_smoke_config(arch)
    plan = ParallelPlan(compute_dtype="float32")
    hyper = Hyper(peak_lr=5e-3, warmup_steps=2, total_steps=5)
    ds = SyntheticDataset(cfg, InputShape("smoke", 64, 8, "train"))
    cpu = build_model(cfg, plan, device="cpu")
    cparams = cpu.init(torch.Generator().manual_seed(1))
    random_conv_taps(cparams, torch.Generator().manual_seed(3))
    runs = {}
    for name, model, params in (("card", build_model(cfg, plan), to_cuda(cparams)),
                                ("cpu", cpu, cparams)):
        for p in leaves(params):
            p.requires_grad_(True)
        step, state, out = make_train_step(model, plan, hyper), \
            TrainState(params, adamw_init(params)), []
        for i in range(5):
            batch = {k: torch.from_numpy(v).to(model.device) for k, v in ds.batch(i).items()}
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = out
    rel = max(abs(a - b) / abs(b) for pc, pp in zip(runs["card"], runs["cpu"])
              for a, b in zip(pc, pp))
    log(f"train smoke {arch} fp32, card vs cpu, 5 steps: (loss, grad_norm) card "
        f"{runs['card']}, cpu {runs['cpu']}; max relative difference {rel:.3e}")
    if rel > 1e-4:
        raise AssertionError("the card's smoke-config training disagrees with the CPU's")

    params = cpu.init(torch.Generator().manual_seed(2))
    random_conv_taps(params, torch.Generator().manual_seed(3))
    params = to_cuda(params)
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in ds.batch(7).items()}
    grads = {}
    for mode in REMAT_MODES:
        model = build_model(cfg, ParallelPlan(compute_dtype="float32", remat=mode))
        loss, _ = make_loss_fn(model, Hyper())(params, batch)
        grads[mode] = torch.autograd.grad(loss, leaves(params))
    for mode in ("full", "selective"):
        rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                  for a, b in zip(grads[mode], grads["none"]))
        same = all(torch.equal(a, b) for a, b in zip(grads[mode], grads["none"]))
        log(f"remat {mode} vs none on the card ({arch}): max relative grad difference "
            f"{rel:.3e}, "
            f"bit-identical {same}")
        if rel > 1e-6:
            raise AssertionError(f"remat={mode} changes the grads")


def train_flops(cfg, seq, tokens, params=None):
    """Reckoned FLOPs of one train step (forward + backward, no recompute): 6 per
    matmul parameter a token uses, plus causal attention, 6 Hq hd (S + 1) per
    token and attention layer, plus the SSD scans. Dense and MoE count their
    parameters analytically (``active_param_count``: for MoE the router, the
    top-k and shared experts; the embedding gather does none; a tied LM head
    counts once, as the head). The SSM and hybrid families count the model's
    real matrices (``params``; the analytic ``param_count`` omits the hybrid's
    shared MLP), the hybrid's shared block once per application, its attention
    on those applications only, and each layer's SSD forward and backward
    (``ssd_flops``). Neither the recompute nor the MoE one-hot dispatch einsums
    are counted."""
    from repro_torch.core import Family, leaves
    if cfg.family in (Family.SSM, Family.HYBRID):
        apps = n_apps(cfg)
        n_matmul = sum(t.numel() for lp in params["layers"] for t in leaves(lp) if t.dim() > 1)
        if apps:
            n_matmul += apps * sum(t.numel() for t in leaves(params["shared_attn"])
                                   if t.dim() > 1)
        n_matmul += (params["lm_head"]["w"] if "lm_head" in params
                     else params["embed"]["tok"]).numel()
        n_attn = apps
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        b = tokens // seq
        scan = cfg.n_layers * sum(ssd_flops(b, seq, heads, s.head_dim, s.d_state, s.chunk,
                                            backward=bw) for bw in (False, True))
    else:
        n_matmul = cfg.active_param_count() - cfg.vocab * cfg.d_model
        if cfg.tie_embeddings:
            n_matmul += cfg.vocab * cfg.d_model
        n_attn, scan = cfg.n_layers, 0
    attn = 6 * n_attn * cfg.n_heads * cfg.head_dim * (seq + 1)
    return (6 * n_matmul + attn) * tokens + scan


def backward_on_real_inputs(model, params, cfg, batch):
    """One microbatch's forward + backward at full width, no optimizer state:
    on every layer, B2 and B3 held to their plain version on that layer's own
    (q, k, v, dO, lse, delta), then discarded. As a reading only, the same
    step with attn_impl="plain": its loss and grad-norm difference."""
    import dataclasses
    from repro_torch.kernels import flash_attention as tf
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.train import Hyper, make_loss_fn
    real_bwd, errs = tf.flash_attention_bwd, []

    # The seam FlashAttention.backward calls: its own backward runs unchanged,
    # and each layer's kernel grads are held to the plain version on the same
    # arguments. functools.wraps copies the launch counters onto the wrapper,
    # so these launches leave the real counts alone.
    @functools.wraps(real_bwd)
    def checked_bwd(q, k, v, do, lse, delta, **kw):
        grads = real_bwd(q, k, v, do, lse, delta, **kw)
        ref = tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
        errs.append([grad_error(g, r) for g, r in zip(grads, ref)])
        return grads

    mb = {k: v[:1] for k, v in batch.items()}
    tf.flash_attention_bwd = checked_bwd
    try:
        loss, _ = make_loss_fn(model, Hyper())(params, mb)
        loss.backward()
    finally:
        tf.flash_attention_bwd = real_bwd
    gnorm = global_norm(map_tree(lambda p: p.grad, params)).item()
    loss = loss.item()
    if len(errs) != cfg.n_layers:
        raise AssertionError(f"checked {len(errs)} layers' backward, expected {cfg.n_layers}")
    worst = [max(e[i][1] for e in errs) for i in range(3)]
    worst_abs = [max(e[i][0] for e in errs) for i in range(3)]
    log(f"real inputs, full-width backward: {len(errs)} layers, max error dq/dk/dv "
        f"{worst_abs[0]:.3e}/{worst_abs[1]:.3e}/{worst_abs[2]:.3e} = "
        f"{worst[0]:.2f}/{worst[1]:.2f}/{worst[2]:.2f} bf16 ulps")
    if max(worst) > GRAD_ULPS_BF16:
        raise AssertionError("flash_bwd disagrees with its plain version on the "
                             "full-width step's own inputs")
    for p in leaves(params):
        p.grad = None
    plain = build_model(cfg, dataclasses.replace(model.plan, attn_impl="plain"))
    ploss, _ = make_loss_fn(plain, Hyper())(params, mb)
    ploss.backward()
    pnorm = global_norm(map_tree(lambda p: p.grad, params)).item()
    for p in leaves(params):
        p.grad = None
    log(f"reading: full-width loss {loss:.6f} (kernels) vs {ploss.item():.6f} (plain "
        f"attention), grad norm {gnorm:.6f} vs {pnorm:.6f}: relative differences "
        f"{abs(loss - ploss.item()) / abs(ploss.item()):.3e} and "
        f"{abs(gnorm - pnorm) / pnorm:.3e} (bf16 drift)")
    return max(worst[1:]), worst[0]


def phase_training():
    """Smoke agreement, remat modes, the quickstart recipe, then qwen1.5-4b at
    full width: the real-input backward check, one warm-up step and
    TRAIN_STEPS timed steps with the launches counted, and a profile."""
    from repro_torch.core import InputShape, ParallelPlan, get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.examples.quickstart import run as quickstart
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_lse
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.core.tree import leaves
    from repro_torch.train import Hyper, TrainState, make_train_step

    train_smoke_agreement()
    t0 = time.perf_counter()
    losses = quickstart()
    log(f"quickstart on the card: {len(losses)} steps in {time.perf_counter() - t0:.1f} s; "
        f"losses {[round(x, 4) for x in losses]}")
    if not losses[-1] < 2.5:
        raise AssertionError(f"quickstart loss at step {len(losses) - 1} is {losses[-1]}")

    cfg = get_config(TRAIN_ARCH)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    model = build_model(cfg, plan)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"init {TRAIN_ARCH}: {n_params / 1e9:.3f} B params (fp32) in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(TRAIN_STEPS + 2)]
    real = backward_on_real_inputs(model, params, cfg, batches[0])

    state = TrainState(params, adamw_init(params))
    del params
    step = make_train_step(model, plan, Hyper())
    state, m = step(state, batches[0])                 # warm-up
    log(f"warm-up step: loss {float(m['loss']):.6f}, grad_norm {float(m['grad_norm']):.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for i in range(TRAIN_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batches[1 + i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = (flash_attention_lse.launches, flash_attention_bwd.dq_launches,
                    flash_attention_bwd.dkv_launches)
        log(f"train step {i}: {times[-1] * 1e3:.1f} ms, loss {loss:.6f}, grad_norm "
            f"{gnorm:.6f}, lr {m['lr']:.3e}, launches B1/B2/B3 {launches}")
        want = (2 * TRAIN_MICRO * cfg.n_layers, TRAIN_MICRO * cfg.n_layers,
                TRAIN_MICRO * cfg.n_layers)
        if launches != want:
            raise AssertionError(f"a train step launched B1/B2/B3 {launches} times, "
                                 f"expected {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError("the full-width train step's loss or grad norm is not finite")
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times) / len(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens)
    log(f"training {TRAIN_ARCH} full width ({TRAIN_BATCH} x {TRAIN_SEQ}, microbatches "
        f"{TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms (mean of {TRAIN_STEPS}), "
        f"{tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} FLOP/step, mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    profile_window("train step", lambda: step(state, batches[-1]))
    return {"launches": launches, "real_dkv_ulps": real[0], "real_dq_ulps": real[1]}


def backward_times():
    """B1, B2 and B3 at the training shape (CUDA events), the plain backward
    and the library's backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tf
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = TRAIN_CASE
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do, lse, delta = bwd_inputs(gen, TRAIN_CASE, torch.bfloat16)
    kw = dict(case_kw(TRAIN_CASE), scale=hd ** -0.5)
    out = [torch.empty_like(x) for x in (q, k, v)]
    res = {which: cuda_ms(lambda: tf._bwd_launch(which, q, k, v, do, lse, delta, *out,
                                                 **kw), 20)
           for which in (0, 1)}
    plain_ms = cuda_ms(lambda: tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw),
                       3, warmup=1)
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True), 20)
    fwd_ms = cuda_ms(lambda: tf.flash_attention_lse(q, k, v, **case_kw(TRAIN_CASE)), 20)
    fwd_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    log(f"flash_bwd at the training shape: dq {res[0]:.4f} ms, dk/dv {res[1]:.4f} ms")
    pairs = attended_pairs(s, t, causal, window, q_offset) * b * hq
    in_bytes = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * 2 * b * hq * s
    bounds = {}
    for which, flops, nbytes in ((0, 6 * hd * pairs, in_bytes + 2 * q.numel()),
                                 (1, 8 * hd * pairs, in_bytes + 2 * (k.numel() + v.numel()))):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        bounds[which] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
        log(f"  {('dq', 'dk/dv')[which]} bound {bounds[which][0]:.4f} ms ({flops:.3e} FLOP, "
            f"{nbytes / 1e6:.1f} MB)")
    fwd_bound = max(4 * hd * pairs / PEAK_BF16_FLOPS,
                    (2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b * hq * s)
                    / PEAK_BYTES) * 1e3
    log(f"training shape: plain backward {plain_ms:.4f} ms, sdpa backward (dq+dk+dv) "
        f"{library_ms:.4f} ms; flash_fwd {fwd_ms:.4f} ms (bound {fwd_bound:.4f}, sdpa "
        f"{fwd_lib_ms:.4f})")
    return {"ms": res, "bounds": bounds, "plain_ms": plain_ms,
            "library_ms": library_ms, "fwd_ms": fwd_ms, "fwd_lib_ms": fwd_lib_ms,
            "fwd_bound_ms": fwd_bound}


def phase_kernels_gemm():
    """B4 against its plain version in its three uses at every GEMM_CASES
    shape, fp32 and bf16, with group sizes that include 0, C and a value that
    straddles a 64-row tile. Returns the errors at the prefill shape's forward
    (bf16)."""
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    gen = torch.Generator(device="cuda").manual_seed(6)
    path_errs = None
    for case in GEMM_CASES:
        e, c, d, f = case
        gs = torch.randint(0, c + 1, (e,), generator=gen, device="cuda", dtype=torch.int32)
        gs[0], gs[1] = 0, c
        gs[2] = min(c, 67)                       # straddles the second row tile
        for dtype in (torch.float32, torch.bfloat16):
            x, w, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((e, c, d), (e, d, f), (e, c, f)))
            for use, a, b, mask in (("forward", x, w, "rows"),
                                    ("dx", g, w.transpose(1, 2), "rows"),
                                    ("dw", x.transpose(1, 2), g, "contract")):
                before = gemm_counts()
                out = grouped_gemm(a, b, gs, mask=mask)
                torch.cuda.synchronize()
                if gemm_counts() != (before[0] + (mask == "rows"),
                                     before[1] + (mask == "contract")):
                    raise AssertionError("grouped_gemm did not count one launch")
                abs_err, err, zeros, ok = gemm_check(out, a, b, gs, mask)
                unit = "bf16 ulps" if dtype == torch.bfloat16 else "of the max"
                log(f"check grouped_gemm {case} {str(dtype)[6:]} {use} ({mask}): err "
                    f"{abs_err:.3e} = {err:.3g} {unit}, zeros exact {zeros}")
                if not ok:
                    raise AssertionError(f"grouped_gemm disagrees with its plain version on "
                                         f"{case} {dtype} {use}")
                if case == GEMM_CASES[0] and dtype == torch.bfloat16 and use == "forward":
                    path_errs = (abs_err, err)
            del x, w, g
    return path_errs


class GemmCapture:
    """Within the block, every call of B4's wrapper is held to its plain version
    on its own inputs, and the inputs of some calls are kept for timing: those
    whose indices are in ``keep`` and, with ``backward``, the first dw call
    (contract mode) as "dw" and the dx call just before it as "dx".
    ``functools.wraps`` copies the launch counters onto the wrapper, so these
    launches leave the real counts alone."""

    def __init__(self, keep=(), backward=False):
        self.keep, self.kept, self.errs = set(keep), {}, []
        self.backward, self.last = backward, None

    def __enter__(self):
        from repro_torch.kernels import grouped_gemm as tg
        self.real = real = tg.grouped_gemm

        @functools.wraps(real)
        def checked(a, b, gs=None, *, mask="rows"):
            out = real(a, b, gs, mask=mask)
            self.errs.append((mask, *gemm_check(out, a, b, gs, mask)))
            call = (a, b, gs, mask)
            if len(self.errs) - 1 in self.keep:
                self.kept[len(self.errs) - 1] = call
            if self.backward and mask == "contract" and "dw" not in self.kept:
                self.kept.update(dx=self.last, dw=call)
            self.last = call if self.backward and "dw" not in self.kept else None
            return out
        tg.grouped_gemm = checked
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import grouped_gemm as tg
        tg.grouped_gemm = self.real

    def summary(self, what):
        worst = {m: max((e[2] for e in self.errs if e[0] == m), default=0.0)
                 for m in ("rows", "contract")}
        n = {m: sum(e[0] == m for e in self.errs) for m in ("rows", "contract")}
        log(f"real inputs, {what}: B4 held to its plain version on {n['rows']} rows-mode "
            f"and {n['contract']} contract-mode calls; worst {worst['rows']:.3g} / "
            f"{worst['contract']:.3g} bf16 ulps, zeros exact "
            f"{all(e[3] for e in self.errs)}")
        if not all(e[4] for e in self.errs):
            raise AssertionError(f"grouped_gemm disagrees with its plain version on the "
                                 f"{what}'s own inputs")
        return max(worst.values())


def dispatch_times(cfg, n):
    """CUDA-event ms of one MoE layer's dispatch and combine at n tokens under
    both dispatch modes (random routing; the einsums' cost does not depend on
    the values)."""
    from repro_torch.models import moe as tmoe
    e = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(9)
    cap = max(int(n * e.top_k / e.num_experts * e.capacity_factor), 1)
    xf = torch.randn(n, cfg.d_model, generator=gen, device="cuda").bfloat16()
    probs = torch.softmax(torch.randn(n, e.num_experts, generator=gen, device="cuda"), -1)
    dispatch, combine = tmoe.topk_dispatch(probs, cfg, cap)
    h = torch.einsum("nec,nd->ecd", dispatch.bfloat16(), xf)
    slot, wts = tmoe.topk_scatter_dispatch(probs, cfg, cap)
    out = {
        "einsum_route": cuda_ms(lambda: tmoe.topk_dispatch(probs, cfg, cap), 10),
        "einsum_dispatch": cuda_ms(
            lambda: torch.einsum("nec,nd->ecd", dispatch.bfloat16(), xf), 10),
        "einsum_combine": cuda_ms(
            lambda: torch.einsum("nec,ecd->nd", combine.bfloat16(), h), 10),
        "scatter_route": cuda_ms(lambda: tmoe.topk_scatter_dispatch(probs, cfg, cap), 10),
        "scatter_dispatch": cuda_ms(lambda: tmoe._scatter_to_buffers(xf, slot, cfg, cap), 10),
        "scatter_combine": cuda_ms(
            lambda: tmoe._gather_from_buffers(h, slot, wts, torch.bfloat16), 10),
    }
    log(f"one layer's dispatch + combine at n = {n} (capacity {cap}), ms: " +
        ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def phase_moe_serving():
    """deepseek-moe-16b at full width and depth: the smoke config against the
    CPU, prefill under both dispatch modes, decode, B4 on every layer's own
    inputs, drift readings, profiles. Returns launches, errors, kept inputs."""
    from repro_torch.core import ParallelPlan, get_config, leaves
    from repro_torch.models import build_model

    smoke_agreement(MOE_ARCH)
    cfg = get_config(MOE_ARCH)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg, plan)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"init {MOE_ARCH}: {n_params / 1e9:.2f} B params (bf16) in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                                     device="cuda")}

    lg, cache = model.prefill(params, batch, max_seq=MAX_SEQ)        # warm-up
    model.decode_step(params, cache, lg[:, -1].argmax(-1), PROMPT)
    del lg, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_seq=MAX_SEQ)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = all_counts()
    want = (cfg.n_layers, 0, 0, 3 * cfg.n_layers, 0)
    if prefill_launches != want:
        raise AssertionError(f"the MoE prefill launched B1, B2, B3, B4 rows/contract "
                             f"{prefill_launches} times, expected {want}")
    if not torch.isfinite(logits).all():
        raise AssertionError("MoE prefill logits are not finite")
    last = logits[:, -1].clone()
    tok = last.argmax(-1)
    del logits
    reset_counts()
    t0 = time.perf_counter()
    out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
    for i in range(DECODE_STEPS):
        lg, cache = model.decode_step(params, cache, tok, PROMPT + i)
        finite &= torch.isfinite(lg).all()
        tok = lg.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / DECODE_STEPS
    decode_launches = all_counts()
    want = (0, 0, 0, 3 * cfg.n_layers * DECODE_STEPS, 0)
    if decode_launches != want:
        raise AssertionError(f"{DECODE_STEPS} MoE decode steps launched B1, B2, B3, B4 "
                             f"{decode_launches} times, expected {want}")
    if not finite:
        raise AssertionError("MoE decode logits are not finite")
    peak = torch.cuda.max_memory_allocated()
    log(f"serving {MOE_ARCH}: prefill {BATCH}x{PROMPT} (einsum dispatch) in "
        f"{t_prefill * 1e3:.1f} ms = {BATCH * PROMPT / t_prefill:.0f} tokens/s; decode "
        f"{t_decode * 1e3:.2f} ms/step (batch {BATCH}); peak memory {peak / 1e9:.2f} GB; "
        f"launches per prefill B1 {prefill_launches[0]}, B4 {prefill_launches[3]}; per "
        f"decode step B4 {decode_launches[3] // DECODE_STEPS}")
    log(f"generated tokens, row 0: {torch.stack(out, 1)[0, :10].tolist()}")

    scatter = build_model(cfg, dataclasses.replace(plan, moe_dispatch="scatter"))
    scatter.prefill(params, batch, max_seq=MAX_SEQ)                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    slogits, _ = scatter.prefill(params, batch, max_seq=MAX_SEQ)
    torch.cuda.synchronize()
    t_scatter = time.perf_counter() - t0
    if all_counts() != prefill_launches:
        raise AssertionError(f"the scatter prefill launched {all_counts()}, expected "
                             f"{prefill_launches}")
    sdrift = ((slogits[:, -1] - last).abs().max() / last.abs().max()).item()
    del slogits
    log(f"serving {MOE_ARCH}: prefill (scatter dispatch) in {t_scatter * 1e3:.1f} ms = "
        f"{BATCH * PROMPT / t_scatter:.0f} tokens/s; last-position logits, scatter vs "
        f"einsum: max diff / max |logit| = {sdrift:.3e} (reading)")
    dispatch_times(cfg, BATCH * PROMPT)

    profile_window("MoE decode step", lambda: model.decode_step(
        params, cache, tok, PROMPT + DECODE_STEPS))
    del cache
    profile_window("MoE prefill (einsum)", lambda: model.prefill(params, batch, max_seq=MAX_SEQ))
    profile_window("MoE prefill (scatter)",
                   lambda: scatter.prefill(params, batch, max_seq=MAX_SEQ))

    # B4 on every layer's own inputs of a prefill and a decode step; layer 0's
    # gate (call 0) and down (call 2) GEMMs kept for timing
    with GemmCapture(keep=(0, 2)) as cap:
        logits, cache = model.prefill(params, batch, max_seq=MAX_SEQ)
    real_ulps = cap.summary(f"{MOE_ARCH} prefill ({cfg.n_layers} layers)")
    kept = {"prefill": cap.kept[0], "prefill_down": cap.kept[2]}
    with GemmCapture(keep=(0,)) as cap:
        model.decode_step(params, cache, logits[:, -1].argmax(-1), PROMPT)
    real_ulps = max(real_ulps, cap.summary(f"{MOE_ARCH} decode step"))
    kept["decode"] = cap.kept[0]
    del cache
    plain = build_model(cfg, dataclasses.replace(plan, moe_gemm_impl="plain"))
    ref = plain.prefill(params, batch, max_seq=MAX_SEQ)[0][:, -1]
    drift = ((logits[:, -1] - ref).abs().max() / ref.abs().max()).item()
    log(f"reading: {MOE_ARCH} prefill last-position logits, B4 vs the plain expert GEMM: "
        f"max diff / max |logit| = {drift:.3e}")
    del logits, ref
    return {"prefill_b4": prefill_launches[3], "decode_b4": decode_launches[3],
            "real_ulps": real_ulps, "times": gemm_times(kept)}


def phase_moe_training():
    """The MoE smoke config against the CPU and under the remat modes, then
    deepseek-moe-16b at full width and MOE_TRAIN_LAYERS layers: B4 held to its
    plain version on every call of one microbatch, warm-up, timed steps with the
    launches counted, a profile."""
    from repro_torch.core import InputShape, ParallelPlan, get_config, leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.core.tree import map_tree
    from repro_torch.train import Hyper, TrainState, make_loss_fn, make_train_step

    train_smoke_agreement(MOE_ARCH)
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    model = build_model(cfg, plan)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"init {MOE_ARCH} ({MOE_TRAIN_LAYERS} of 28 layers): {n_params / 1e9:.3f} B params "
        f"(fp32) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(TRAIN_STEPS + 2)]

    # one microbatch's forward + backward: every B4 call held to its plain
    # version; the first dw call and the dx call just before it kept for timing
    mb = {k: v[:1] for k, v in batches[0].items()}
    with GemmCapture(backward=True) as cap:
        loss, _ = make_loss_fn(model, Hyper())(params, mb)
        loss.backward()
    real_ulps = cap.summary(f"{MOE_ARCH} training microbatch ({MOE_TRAIN_LAYERS} layers)")
    b4_times = gemm_times({"train_dx": cap.kept["dx"], "train_dw": cap.kept["dw"]})
    del cap
    log(f"full-width microbatch: loss {loss.item():.6f}, grad norm "
        f"{global_norm(map_tree(lambda p: p.grad, params)).item():.6f}")
    for p in leaves(params):
        p.grad = None

    state = TrainState(params, adamw_init(params))
    del params
    step = make_train_step(model, plan, Hyper())
    state, m = step(state, batches[0])                 # warm-up
    log(f"warm-up step: loss {float(m['loss']):.6f}, moe_aux {float(m['moe_aux']):.6f}, "
        f"grad_norm {float(m['grad_norm']):.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    n_mb = TRAIN_MICRO * cfg.n_layers
    want = (2 * n_mb, n_mb, n_mb, 9 * n_mb, 3 * n_mb)
    for i in range(TRAIN_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batches[1 + i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = all_counts()
        log(f"MoE train step {i}: {times[-1] * 1e3:.1f} ms, loss {loss:.6f}, moe_aux "
            f"{float(m['moe_aux']):.6f}, grad_norm {gnorm:.6f}, launches B1/B2/B3/B4 rows/"
            f"B4 contract {launches}")
        if launches != want:
            raise AssertionError(f"a MoE train step launched {launches}, expected {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError("the MoE train step's loss or grad norm is not finite")
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times) / len(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens)
    log(f"training {MOE_ARCH} full width, {MOE_TRAIN_LAYERS} layers ({TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, microbatches {TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms "
        f"(mean of {TRAIN_STEPS}), {tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} "
        f"FLOP/step (active params, no recompute, no dispatch einsums), mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    profile_window("MoE train step", lambda: step(state, batches[-1]))
    return {"train_b4_rows": launches[3], "train_b4_contract": launches[4],
            "real_ulps": real_ulps, "times": b4_times}


def gemm_times(kept):
    """B4 (CUDA events) on each kept path input beside its bound, its plain
    version and one ``torch.bmm`` on the masked inputs. The bound counts what
    this input needs: the real rows of the activations, the weights of experts
    with a load, the whole output written, 2 FLOP a multiply-add of real rows."""
    from repro_torch.kernels import grouped_gemm as tg
    res = {}
    for name, (a, b, gs, mask) in kept.items():
        e, m, k = a.shape
        n = b.shape[2]
        ms = cuda_ms(lambda: tg.grouped_gemm(a, b, gs, mask=mask), 20)
        plain_ms = cuda_ms(lambda: tg.grouped_gemm_plain(a, b, gs, mask=mask), 5, warmup=1)
        g = gs[:, None, None]
        if mask == "rows":
            am = torch.where(torch.arange(m, device="cuda")[None, :, None] < g, a, 0)
            bm = b
        else:
            ks = torch.arange(k, device="cuda")
            am = torch.where(ks[None, None, :] < g, a, 0)
            bm = torch.where(ks[None, :, None] < g, b, 0)
        library_ms = cuda_ms(lambda: torch.bmm(am, bm), 20)
        real = int(gs.sum())
        active = int((gs > 0).sum())
        if mask == "rows":
            flops = 2 * real * k * n
            nbytes = 2 * (real * k + active * k * n + e * m * n)
        else:
            flops = 2 * real * m * n
            nbytes = 2 * (real * m + real * n + e * m * n)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        res[name] = {"shape": [e, m, k, n], "mask": mask, "real_rows": real,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"grouped_gemm {name} {(e, m, k, n)} {mask}, {real} real rows: {ms:.4f} ms, "
            f"bound {res[name]['bound_ms']:.4f} ms ({flops:.3e} FLOP, {nbytes / 1e6:.1f} MB, "
            f"{res[name]['bound_by']}), plain {plain_ms:.4f} ms, bmm {library_ms:.4f} ms")
        del am, bm
    return res


# ---------------------------------------------------------------------------
# Mamba2 and the zamba2 hybrid: the SSD chunk scan (B5 forward, B6 backward)


def ssd_counts():
    from repro_torch.kernels import ssd_scan as ts
    return ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches


def reset_ssd_counts():
    from repro_torch.kernels import ssd_scan as ts
    ts.ssd_chunk_scan_fwd.launches = ts.ssd_chunk_scan_bwd.launches = 0


def ssd_error(x, ref):
    """(max |x - ref|, the error in the limit's measure): bf16 ulps of |ref| for
    a bf16 result (as ``grad_error``), else the fraction of max(1, max |ref|)."""
    if x.dtype == torch.bfloat16:
        return grad_error(x, ref)
    ref = ref.float()
    err = (x.float() - ref).abs().max()
    return err.item(), (err / ref.abs().max().clamp(min=1.0)).item()


def ssd_ok(x, err, limit):
    return bool(torch.isfinite(x).all()) and err[1] <= (
        SSD_ULPS_BF16 if x.dtype == torch.bfloat16 else limit)


def fmt_ssd(names, errs):
    return ", ".join(f"{n} {a:.3e} ({u:.2e})" for n, (a, u) in zip(names, errs))


def ssd_inputs(gen, case, dtype):
    """Head-major views of model-layout x, dt, B, C (as the dispatcher hands them
    to the kernels), x/B/C in ``dtype``; dt in [0.01, 0.2) and A in (-2, -0.5],
    the reference's test draws."""
    b, l, h, p, g, n, _ = case
    x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    dt = (0.01 + 0.19 * torch.rand(b, l, h, generator=gen, device="cuda")).transpose(1, 2)
    A = -(0.5 + 1.5 * torch.rand(h, generator=gen, device="cuda"))
    B, C = (torch.randn(b, l, g, n, generator=gen, device="cuda").to(dtype).transpose(1, 2)
            for _ in range(2))
    return x, dt, A, B, C


def ssd_check_fwd(ins, chunk, out):
    from repro_torch.kernels import ssd_scan as ts
    ref = ts.ssd_chunk_scan_fwd_plain(*ins, chunk=chunk)
    errs = [ssd_error(o, r) for o, r in zip(out, ref) if o is not None]
    return errs, all(ssd_ok(o, e, SSD_Y_TOL) for o, e in
                     zip([o for o in out if o is not None], errs))


def ssd_check_bwd(ins, dy, dfinal, chunk, grads):
    from repro_torch.kernels import ssd_scan as ts
    ref = ts.ssd_chunk_scan_bwd_plain(*ins, dy, dfinal, chunk=chunk)
    errs = [ssd_error(g, r) for g, r in zip(grads, ref)]
    return errs, all(ssd_ok(g, e, SSD_GRAD_TOL) and g.dtype == r.dtype
                     for g, e, r in zip(grads, errs, ref))


def phase_kernels_ssd():
    """B5 (y, entering states, final state) and B6 (dx, ddt, dA, dB, dC, with a
    non-zero final-state cotangent) against their plain versions at every
    SSD_CASES shape in fp32 and bf16, and the autograd Function through the
    dispatcher. Returns the errors at each path shape (bf16)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ssd_scan as ts
    gen = torch.Generator(device="cuda").manual_seed(8)
    path_errs = {}
    for case in SSD_CASES:
        b, l, h, p, g, n, chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(gen, case, dtype)
            before = ssd_counts()
            out = ts.ssd_chunk_scan_fwd(*ins, chunk=chunk, save_enters=True)
            torch.cuda.synchronize()
            ferrs, fok = ssd_check_fwd(ins, chunk, out)
            dy = torch.randn(b, l, h, p, generator=gen, device="cuda").transpose(1, 2)
            dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
            grads = ts.ssd_chunk_scan_bwd(*ins, out[1], dy, dfinal, chunk=chunk)
            torch.cuda.synchronize()
            if ssd_counts() != (before[0] + 1, before[1] + 1):
                raise AssertionError("ssd_chunk_scan_fwd/bwd did not count one launch each")
            berrs, bok = ssd_check_bwd(ins, dy, dfinal, chunk, grads)
            log(f"check ssd {case} {str(dtype)[6:]}: "
                f"{fmt_ssd(('y', 'enters', 'state'), ferrs)}; "
                f"{fmt_ssd(BWD_NAMES, berrs)}")
            if not (fok and bok):
                raise AssertionError(f"the SSD kernels disagree with their plain versions "
                                     f"on {case} {dtype}")
            for path, pcase in SSD_PATH_CASES.items():
                if case == pcase and dtype == torch.bfloat16:
                    path_errs[path] = (ferrs, berrs)
            del ins, out, dy, dfinal, grads

    # the autograd Function through the dispatcher, model layout, G = 2, ragged,
    # a loss on the final state too, against autograd through the plain dispatch
    for case in ((2, 200, 4, 64, 2, 128, 128), (1, 96, 4, 8, 4, 8, 24)):
        b, l, h, p, g, n, chunk = case
        base = [t.transpose(1, 2).contiguous() if t.dim() > 1 else t
                for t in ssd_inputs(gen, case, torch.float32)]
        w = torch.randn(b, l, h, p, generator=gen, device="cuda")
        grads = {}
        for impl in ("cuda", "plain"):
            ins = [t.detach().clone().requires_grad_() for t in base]
            before = ssd_counts()
            y, st = dispatch.dispatch_ssd_scan(*ins, chunk=chunk, impl=impl)
            grads[impl] = torch.autograd.grad((y * w).sum() + st.square().sum(), ins)
            want = (before[0] + 1, before[1] + 1) if impl == "cuda" else before
            if ssd_counts() != want:
                raise AssertionError(f"the {impl} dispatch launched {ssd_counts()}, "
                                     f"expected {want}")
        errs = [ssd_error(a, r) for a, r in zip(grads["cuda"], grads["plain"])]
        log(f"check ssd autograd Function {case} float32: "
            f"{fmt_ssd(BWD_NAMES, errs)}")
        if not all(e[1] <= SSD_GRAD_TOL for e in errs):
            raise AssertionError(f"the SSD autograd Function's grads disagree on {case}")
    return path_errs


class SSDCapture:
    """Within the block, every call of B5's and B6's wrappers is held to its
    plain version on its own inputs, and the first call of each is kept for
    timing. ``functools.wraps`` copies the launch counters onto the wrappers,
    so these launches leave the real counts alone."""

    def __enter__(self):
        from repro_torch.kernels import ssd_scan as ts
        self.real = (ts.ssd_chunk_scan_fwd, ts.ssd_chunk_scan_bwd)
        real_fwd, real_bwd = self.real
        self.fwd_errs, self.bwd_errs, self.kept = [], [], {}

        @functools.wraps(real_fwd)
        def checked_fwd(x, dt, A, Bm, Cm, *, chunk=128, save_enters=False):
            out = real_fwd(x, dt, A, Bm, Cm, chunk=chunk, save_enters=save_enters)
            self.fwd_errs.append(ssd_check_fwd((x, dt, A, Bm, Cm), chunk, out))
            self.kept.setdefault("fwd", ((x, dt, A, Bm, Cm), chunk, save_enters))
            return out

        @functools.wraps(real_bwd)
        def checked_bwd(x, dt, A, Bm, Cm, enters, dy, dfinal, *, chunk=128):
            grads = real_bwd(x, dt, A, Bm, Cm, enters, dy, dfinal, chunk=chunk)
            self.bwd_errs.append(ssd_check_bwd((x, dt, A, Bm, Cm), dy, dfinal, chunk, grads))
            self.kept.setdefault("bwd", ((x, dt, A, Bm, Cm, enters, dy, dfinal), chunk))
            return grads
        ts.ssd_chunk_scan_fwd, ts.ssd_chunk_scan_bwd = checked_fwd, checked_bwd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ssd_scan as ts
        ts.ssd_chunk_scan_fwd, ts.ssd_chunk_scan_bwd = self.real

    def summary(self, what):
        """Log and check the calls; returns each output's worst error in its
        limit's measure (y, state, ddt, dA: of max(1, max |ref|); dx, dB, dC:
        bf16 ulps)."""
        worst = {}
        for errs, names in ((self.fwd_errs, ("y", "state")), (self.bwd_errs, BWD_NAMES)):
            for e, _ in errs:
                pairs = zip(names, (e[0], e[-1])) if names[0] == "y" else zip(names, e)
                for name, (_, err) in pairs:
                    worst[name] = max(worst.get(name, 0.0), err)
        log(f"real inputs, {what}: B5 held to its plain version on {len(self.fwd_errs)} "
            f"calls, B6 on {len(self.bwd_errs)}; worst " +
            ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
        if not all(ok for _, ok in self.fwd_errs + self.bwd_errs):
            raise AssertionError(f"the SSD kernels disagree with their plain versions on "
                                 f"the {what}'s own inputs")
        return worst


def random_conv_taps(params, gen):
    """The reference initialises an SSM block's conv taps to zero, which zeroes
    x, B and C and so every SSD input and output at init. Draw them as PyTorch's
    depthwise Conv1d does (kaiming-uniform: U(-1/sqrt(K), 1/sqrt(K)), K = 4
    taps), in place, so the paths do real work. No-op for other families."""
    with torch.no_grad():
        for lp in params["layers"]:
            for k in ("conv_x", "conv_B", "conv_C") if "ssm" in lp else ():
                w = lp["ssm"][k]
                u = torch.rand(w.shape, generator=gen, device=gen.device)
                w.copy_((2 * u - 1) / w.shape[-1] ** 0.5)


def ssd_flops(b, l, h, p, n, chunk, backward=False):
    """The multiply-adds x 2 an SSD pass needs on these shapes, counting only
    the causal half (j <= i) of each chunk's (q, q) products. Forward per chunk
    of q real positions: C B^T and scores (x dt) over T = q(q+1)/2 pairs, C
    state^T and the state update, 2 q P N. Backward: scores and dscores, dxd's,
    dC's and dB's (q, q) terms (T (3N + 2P)) and five (q, P, N) products."""
    total = 0
    for start in range(0, l, chunk):
        q = min(chunk, l - start)
        t = q * (q + 1) // 2
        total += t * (3 * n + 2 * p) + 5 * q * p * n if backward else \
            t * (n + p) + 2 * q * p * n
    return 2 * b * h * total


def ssd_times(name, kept):
    """B5 and B6 (CUDA events) on a path's kept inputs beside their bounds and
    plain versions. B5's bytes: x, dt, B, C read once, y and the final state
    (and, under the VJP, the entering states) written; B6's: x, dt, B, C, the
    entering states, dy and dS_final read, its per-head fp32 dx, ddt, dda, dB, dC
    written. Operations at the bf16 tensor-core rate (989 TFLOP/s): the inputs
    arrive in bf16. There is no PyTorch call that computes an SSD scan."""
    from repro_torch.kernels import ssd_scan as ts
    res = {}
    (x, dt, A, Bm, Cm), chunk, save = kept["fwd"]
    b, h, l, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    nc = -(-l // chunk)
    esz = x.element_size()
    io = esz * (x.numel() + Bm.numel() + Cm.numel()) + 4 * dt.numel()
    units = [("fwd", lambda: ts.ssd_chunk_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk,
                                                   save_enters=save),
              lambda: ts.ssd_chunk_scan_fwd_plain(x, dt, A, Bm, Cm, chunk=chunk),
              ssd_flops(b, l, h, p, n, chunk),
              io + 4 * (x.numel() + b * h * p * n + (b * h * nc * p * n if save else 0)))]
    if "bwd" in kept:
        (xb, dtb, Ab, Bb, Cb, enters, dy, dfinal), chunk_b = kept["bwd"]
        args = (xb, dtb.float(), Ab.float().contiguous(), Bb, Cb, enters.contiguous(),
                dy.float().contiguous(), dfinal.contiguous(), chunk_b)
        bb, hb, lb, pb = xb.shape
        nb = Bb.shape[3]
        io_b = xb.element_size() * (xb.numel() + Bb.numel() + Cb.numel()) + 4 * dtb.numel()
        units.append(("bwd", lambda: ts._bwd_launch(*args),
                      lambda: ts.ssd_chunk_scan_bwd_plain(xb, dtb, Ab, Bb, Cb, dy, dfinal,
                                                          chunk=chunk_b),
                      ssd_flops(bb, lb, hb, pb, nb, chunk_b, backward=True),
                      io_b + 4 * (enters.numel() + dy.numel() + dfinal.numel()
                                  + xb.numel() + 2 * bb * hb * lb + 2 * bb * hb * lb * nb)))
    for kind, kernel, plain, flops, nbytes in units:
        ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(plain, 2, warmup=1)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        shape = list((xb if kind == "bwd" else x).shape)
        res[kind] = {"shape_bhlp": shape, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
        log(f"ssd_{kind} at {name} {tuple(shape)}: {ms:.4f} ms, bound "
            f"{res[kind]['bound_ms']:.4f} ms ({flops:.3e} FLOP, {nbytes / 1e6:.1f} MB, "
            f"{res[kind]['bound_by']}), plain {plain_ms:.4f} ms")
    return res


def ssm_smoke_agreement(arch):
    """A small model on the card (kernel path) against the same weights on the
    CPU (plain path), fp32: forward logits over 37 tokens (one ragged chunk)
    and 5 decode steps, to 1e-4."""
    from repro_torch.core import ParallelPlan, get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config(arch)
    plan = ParallelPlan(compute_dtype="float32")
    gpu, cpu = build_model(cfg, plan), build_model(cfg, plan, device="cpu")
    cparams = cpu.init(torch.Generator().manual_seed(1))
    random_conv_taps(cparams, torch.Generator().manual_seed(4))
    params = to_cuda(cparams)
    tokens = torch.randint(0, cfg.vocab, (2, 37), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        before = ssd_counts()[0]
        lg = gpu.forward(params, {"tokens": tokens.cuda()})[0]
        if ssd_counts()[0] != before + cfg.n_layers:
            raise AssertionError("the smoke forward did not run B5 on every layer")
        errs = [(lg.cpu() - cpu.forward(cparams, {"tokens": tokens})[0]).abs().max().item()]
        cache, ccache = gpu.init_cache(2, 8), cpu.init_cache(2, 8)
        for pos in range(5):
            lg, cache = gpu.decode_step(params, cache, tokens[:, pos].cuda(), pos)
            clg, ccache = cpu.decode_step(cparams, ccache, tokens[:, pos], pos)
            errs.append((lg.cpu() - clg).abs().max().item())
    log(f"smoke {arch} fp32, card vs cpu: max logit diff {max(errs):.3e}")
    if max(errs) > 1e-4:
        raise AssertionError("the card's smoke-config logits disagree with the CPU's")


def n_apps(cfg):
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


def phase_ssm_serving(arch):
    """``arch`` (mamba2-370m or zamba2-1.2b) at full width and depth, random bf16
    weights from a seed: the smoke config against the CPU; forward under
    no_grad over SSM_BATCH x SSM_PROMPT tokens (the prefill metric) with the
    launches counted; a SSM_DECODE_PROMPT-token prompt through decode_step, then
    DECODE_STEPS greedy steps; profiles; B5 held to its plain version on every
    layer's own inputs of the forward; B5 timed on them."""
    from repro_torch.core import ParallelPlan, get_config, leaves
    from repro_torch.models import build_model

    ssm_smoke_agreement(arch)
    cfg = get_config(arch)
    model = build_model(cfg, ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    random_conv_taps(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"init {arch}: {n_params / 1e6:.1f} M params (bf16) in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    batch = {"tokens": torch.randint(0, cfg.vocab, (SSM_BATCH, SSM_PROMPT), generator=gen,
                                     device="cuda")}
    apps = n_apps(cfg)
    with torch.no_grad():
        model.forward(params, batch)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        reset_ssd_counts()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, batch)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        fwd_launches = (*all_counts(), *ssd_counts())
        want = (apps, 0, 0, 0, 0, cfg.n_layers, 0)
        if fwd_launches != want:
            raise AssertionError(f"the {arch} forward launched B1, B2, B3, B4 rows/contract, "
                                 f"B5, B6 {fwd_launches} times, expected {want}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{arch} forward logits are not finite")
        del logits

        # the reference's serving flow for these families: the prompt through
        # decode_step, then greedy steps
        prompt = batch["tokens"][:, :SSM_DECODE_PROMPT]
        cache = model.init_cache(SSM_BATCH, SSM_DECODE_PROMPT + DECODE_STEPS + 1)
        steps = []
        for t in range(SSM_DECODE_PROMPT):
            lg, cache = model.decode_step(params, cache, prompt[:, t], t)
            steps.append(lg)
        ref = model.forward(params, {"tokens": prompt})[0]
        drift = ((torch.stack(steps, 1) - ref).abs().max() / ref.abs().max()).item()
        tok = lg.argmax(-1)
        reset_counts()
        reset_ssd_counts()
        t0 = time.perf_counter()
        out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
        for i in range(DECODE_STEPS):
            lg, cache = model.decode_step(params, cache, tok, SSM_DECODE_PROMPT + i)
            finite &= torch.isfinite(lg).all()
            tok = lg.argmax(-1)
            out.append(tok)
        torch.cuda.synchronize()
        t_decode = (time.perf_counter() - t0) / DECODE_STEPS
        if (*all_counts(), *ssd_counts()) != (0,) * 7:
            raise AssertionError(f"{arch} decode launched {(*all_counts(), *ssd_counts())}")
        if not finite:
            raise AssertionError(f"{arch} decode logits are not finite")
        peak = torch.cuda.max_memory_allocated()
        log(f"serving {arch}: forward {SSM_BATCH}x{SSM_PROMPT} in {t_fwd * 1e3:.1f} ms = "
            f"{SSM_BATCH * SSM_PROMPT / t_fwd:.0f} tokens/s; decode {t_decode * 1e3:.2f} "
            f"ms/step (batch {SSM_BATCH}); peak memory {peak / 1e9:.2f} GB; launches per "
            f"forward B5 {fwd_launches[5]}, B1 {fwd_launches[0]}")
        log(f"reading: {arch} decode-form logits over the {SSM_DECODE_PROMPT}-token prompt "
            f"vs forward's: max diff / max |logit| = {drift:.3e} (bf16)")
        log(f"generated tokens, row 0: {torch.stack(out, 1)[0, :10].tolist()}")
        profile_window(f"{arch} decode step", lambda: model.decode_step(
            params, cache, tok, SSM_DECODE_PROMPT + DECODE_STEPS))
        del cache
        profile_window(f"{arch} forward", lambda: model.forward(params, batch))
        with SSDCapture() as cap:
            model.forward(params, batch)
        real = cap.summary(f"{arch} forward ({cfg.n_layers} layers)")
        times = ssd_times(f"{arch} serving", cap.kept)
    return {"b5": fwd_launches[5], "b1": fwd_launches[0], "real": real, "times": times}


def phase_ssm_training(arch, batch_size):
    """The smoke config against the CPU and under the remat modes, then
    ``arch`` at full width and depth (fp32 masters, bf16 compute, remat "full",
    TRAIN_MICRO microbatches of batch_size / TRAIN_MICRO x TRAIN_SEQ): B5 and B6
    held to their plain versions on every call of one microbatch and timed on
    them, one warm-up and TRAIN_STEPS timed steps with the launches counted, a
    profile."""
    from repro_torch.core import InputShape, ParallelPlan, get_config, leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.core.tree import map_tree
    from repro_torch.train import Hyper, TrainState, make_loss_fn, make_train_step

    timed(f"{arch} smoke training", train_smoke_agreement, arch)
    cfg = get_config(arch)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    model = build_model(cfg, plan)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    random_conv_taps(params, gen)
    for p in leaves(params):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"init {arch}: {n_params / 1e6:.1f} M params (fp32) in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, batch_size, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(TRAIN_STEPS + 2)]

    mb = {k: v[:batch_size // TRAIN_MICRO] for k, v in batches[0].items()}
    with SSDCapture() as cap:
        loss, _ = make_loss_fn(model, Hyper())(params, mb)
        loss.backward()
    real = cap.summary(f"{arch} training microbatch ({cfg.n_layers} layers)")
    times = ssd_times(f"{arch} training", cap.kept)
    del cap
    log(f"full-width microbatch: loss {loss.item():.6f}, grad norm "
        f"{global_norm(map_tree(lambda p: p.grad, params)).item():.6f}")
    for p in leaves(params):
        p.grad = None

    state = TrainState(params, adamw_init(params))
    del params
    step = make_train_step(model, plan, Hyper())
    state, m = step(state, batches[0])                 # warm-up
    log(f"warm-up step: loss {float(m['loss']):.6f}, grad_norm {float(m['grad_norm']):.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    apps = n_apps(cfg)
    want = (TRAIN_MICRO * apps, TRAIN_MICRO * apps, TRAIN_MICRO * apps, 0, 0,
            2 * TRAIN_MICRO * cfg.n_layers, TRAIN_MICRO * cfg.n_layers)
    times_s, launches = [], None
    for i in range(TRAIN_STEPS):
        reset_counts()
        reset_ssd_counts()
        t0 = time.perf_counter()
        state, m = step(state, batches[1 + i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times_s.append(time.perf_counter() - t0)
        launches = (*all_counts(), *ssd_counts())
        log(f"{arch} train step {i}: {times_s[-1] * 1e3:.1f} ms, loss {loss:.6f}, grad_norm "
            f"{gnorm:.6f}, launches B1/B2/B3/B4 rows/B4 contract/B5/B6 {launches}")
        if launches != want:
            raise AssertionError(f"a {arch} train step launched {launches}, expected {want}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"the {arch} train step's loss or grad norm is not finite")
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times_s) / len(times_s)
    tokens = batch_size * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens, params=state.params)
    log(f"training {arch} full width and depth ({batch_size} x {TRAIN_SEQ}, microbatches "
        f"{TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms (mean of {TRAIN_STEPS}), "
        f"{tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} FLOP/step, mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    timed(f"{arch} train step profile", profile_window, f"{arch} train step",
          lambda: step(state, batches[-1]))
    return {"launches": launches, "real": real, "times": times}


def ssd_entries(ssd_errs, ssm):
    """The kernels-line entries of B5 and B6. ``ssd_errs``: the bf16 kernel
    checks at each path shape; ``ssm``: {arch: (serving, training)} results."""
    by_path = {"ssd_fwd": {}, "ssd_bwd": {}}
    for arch, (serve, train) in ssm.items():
        by_path["ssd_fwd"][f"{arch}_forward"] = serve["b5"]
        by_path["ssd_fwd"][f"{arch}_train_step"] = train["launches"][5]
        by_path["ssd_bwd"][f"{arch}_train_step"] = train["launches"][6]
    out = []
    for name, kind, line, i, names, tol in (
            ("ssd_fwd", "fwd", 79, 0, ("y", "enters", "state"), SSD_FWD_TOLERANCE),
            ("ssd_bwd", "bwd", 179, 1, BWD_NAMES, SSD_BWD_TOLERANCE)):
        head = ssm[SSM_ARCH][0 if kind == "fwd" else 1]["times"][kind]
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/ssd_scan.py:{line}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": max(a for errs in ssd_errs.values() for a, _ in errs[i]),
            "errors_at_path_shapes": {path: {n: e for n, (_, e) in zip(names, errs[i])}
                                      for path, errs in ssd_errs.items()},
            "real_inputs_worst": {f"{arch}_{which}": r["real"] for arch, pair in ssm.items()
                                  for which, r in zip(("serving", "training"), pair)},
            "tolerance": tol,
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "library_covers": "no PyTorch call computes an SSD chunk scan",
            "shapes": {f"{arch}_{which}": r["times"][kind] for arch, pair in ssm.items()
                       for which, r in zip(("serving", "training"), pair)
                       if kind in r["times"]},
            "check": "pass",
        })
    return out


def phase_times(launches, path_errs, real_ulps, train_errs, train, gemm_errs, moe_serve,
                moe_train, ssd_errs, ssm):
    from repro_torch.kernels.flash_attention import (flash_attention_lse,
                                                     flash_attention_lse_plain)
    import torch.nn.functional as F
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = FLASH_CASES[-1]
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = batch_major(gen, b, hq, s, hd, torch.bfloat16)
    k = batch_major(gen, b, hkv, t, hd, torch.bfloat16)
    v = batch_major(gen, b, hkv, t, hd, torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    ms = cuda_ms(lambda: flash_attention_lse(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: flash_attention_lse_plain(q, k, v, **kw), 5, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    pairs = attended_pairs(s, t, causal, window, q_offset)
    flops = 4 * hd * pairs * b * hq
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b * hq * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    log(f"flash_fwd at the path's shape: {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({flops:.3e} FLOP, {nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms")
    del q, k, v
    bt = backward_times()
    b1_train, b2_train, b3_train = train["launches"]
    entries = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": launches + b1_train,
        "launches_by_path": {"prefill": launches, "train_step": b1_train},
        "max_abs_err": path_errs[0],
        "max_err_bf16_ulps": path_errs[1],
        "lse_max_rel_err": path_errs[2],
        "real_inputs_max_err_bf16_ulps": real_ulps,
        "tolerance": TOLERANCE,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "train_shape_ms": bt["fwd_ms"],
        "train_shape_bound_ms": bt["fwd_bound_ms"],
        "train_shape_library_ms": bt["fwd_lib_ms"],
        "check": "pass",
    }]
    for which, name, line, count, real in (
            (0, "flash_bwd_dq", 242, b2_train, train["real_dq_ulps"]),
            (1, "flash_bwd_dkv", 278, b3_train, train["real_dkv_ulps"])):
        errs = train_errs[:1] if which == 0 else train_errs[1:]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": count,
            "launches_by_path": {"train_step": count},
            "max_abs_err": max(e[0] for e in errs),
            "max_err_bf16_ulps": max(e[1] for e in errs),
            "real_inputs_max_err_bf16_ulps": real,
            "tolerance": GRAD_TOLERANCE,
            "ms": bt["ms"][which],
            "plain_ms": bt["plain_ms"],
            "plain_covers": "dq, dk and dv in one call",
            "bound_ms": bt["bounds"][which][0],
            "bound_by": bt["bounds"][which][1],
            "library_ms": bt["library_ms"],
            "library_covers": "dq, dk and dv: SDPA's backward, set against dq + dk/dv",
            "check": "pass",
        })
    gt = {**moe_serve["times"], **moe_train["times"]}
    head = gt["prefill"]
    decode_steps = moe_serve["decode_b4"]
    entries.append({
        "name": "grouped_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
        "replaces": "src/repro/kernels/grouped_gemm.py:50",
        "launches": moe_serve["prefill_b4"] + decode_steps + moe_train["train_b4_rows"]
        + moe_train["train_b4_contract"],
        "launches_by_path": {"prefill": moe_serve["prefill_b4"],
                             "decode_step": decode_steps // DECODE_STEPS,
                             f"decode_{DECODE_STEPS}_steps": decode_steps,
                             "train_step_rows": moe_train["train_b4_rows"],
                             "train_step_contract": moe_train["train_b4_contract"]},
        "max_abs_err": gemm_errs[0],
        "max_err_bf16_ulps": gemm_errs[1],
        "real_inputs_max_err_bf16_ulps": max(moe_serve["real_ulps"], moe_train["real_ulps"]),
        "tolerance": GEMM_TOLERANCE,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_covers": "one torch.bmm on the row-masked inputs at the same shape",
        "shapes": {k: {kk: v[kk] for kk in ("shape", "mask", "real_rows", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms")}
                   for k, v in gt.items()},
        "check": "pass",
    })
    entries += ssd_entries(ssd_errs, ssm)
    print(json.dumps({"kernels": entries}), flush=True)


def free():
    gc.collect()
    torch.cuda.empty_cache()


def main():
    t0 = time.perf_counter()
    kind = phase_device()
    from repro_torch.core import resolve_device
    resolve_device()                       # fp32 matmuls in full fp32
    timed("build", phase_build)
    path_errs = timed("kernels (B1)", phase_kernels)
    train_errs = timed("kernels (B2, B3)", phase_kernels_bwd)
    gemm_errs = timed("kernels (B4)", phase_kernels_gemm)
    launches, real_ulps = timed("serving", phase_serving)
    free()                                 # the serving model's 30 GB
    train = timed("training", phase_training)
    free()
    moe_serve = timed("MoE serving", phase_moe_serving)
    free()                                 # the MoE model's 34 GB
    moe_train = timed("MoE training", phase_moe_training)
    free()
    ssd_errs = timed("kernels (B5, B6)", phase_kernels_ssd)
    free()
    ssm = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        serve = timed(f"{arch} serving", phase_ssm_serving, arch)
        free()
        train_r = timed(f"{arch} training", phase_ssm_training, arch, SSM_TRAIN_BATCH[arch])
        free()
        ssm[arch] = (serve, train_r)
    timed("times", phase_times, launches, path_errs, real_ulps, train_errs, train,
          gemm_errs, moe_serve, moe_train, ssd_errs, ssm)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
