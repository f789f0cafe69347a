#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100 and
check its kernels.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order:

1. device   — require CUDA with compute capability 9.0; print the card's name
   and power limit as nvidia-smi reports them;
2. build    — compile every CUDA source of the paths (one nvcc each, in parallel);
3. kernels  — hold each kernel against its plain PyTorch version on the card:
   the flash forward (o: fp32 to 3e-5, bf16 to 2 bf16 ulps; lse to 1e-5
   relative) and the backward's dq and dk/dv kernels (fp32 to 1e-5 of each
   tensor's largest value, bf16 to 2 bf16 ulps), fully masked rows included,
   at the paths' own shapes, with merged softmax statistics, and through the
   autograd Function;
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
6. times    — each kernel's time at its path's shape beside its bound, its plain
   version's time and the library call's, printed as one JSON line.

Any failure raises: the script exits non-zero and prints no final line. The
last line is ``{"ok": true, "device": {...}}``.
"""

import os

# the full-width train step holds ~74 GB; segments that grow in place keep the
# allocator from failing on fragmentation near the card's 80 GB
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

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


def reset_counts():
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_lse)
    flash_attention_lse.launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0


def to_cuda(tree):
    if isinstance(tree, dict):
        return {k: to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cuda(v) for v in tree]
    return tree.cuda()


def profile_window(name, fn):
    """Kernel time by name over one call of ``fn``, and the device's busy share
    of the profiled wall time (the profiler's own overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    logs = build.build(["flash_fwd", "flash_bwd"])
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


def smoke_agreement():
    """A small model on the card (kernel path) against the same weights on the
    CPU (plain path), fp32: prefill and decode logits to 1e-4."""
    from repro_torch.core import ParallelPlan, get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config(ARCH)
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
    log(f"smoke {ARCH} fp32, card vs cpu: max logit diff {max(errs):.3e}")
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


def train_smoke_agreement():
    """The qwen1.5-4b smoke config, fp32: 5 train steps on the card (kernels)
    against the same steps on the CPU (plain path), from the same weights and
    batches; then the three remat modes' grads on the card."""
    from repro_torch.core import REMAT_MODES, InputShape, ParallelPlan, get_smoke_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.core.tree import leaves
    from repro_torch.train import Hyper, TrainState, make_loss_fn, make_train_step
    cfg = get_smoke_config(TRAIN_ARCH)
    plan = ParallelPlan(compute_dtype="float32")
    hyper = Hyper(peak_lr=5e-3, warmup_steps=2, total_steps=5)
    ds = SyntheticDataset(cfg, InputShape("smoke", 64, 8, "train"))
    cpu = build_model(cfg, plan, device="cpu")
    cparams = cpu.init(torch.Generator().manual_seed(1))
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
    log(f"train smoke {TRAIN_ARCH} fp32, card vs cpu, 5 steps: (loss, grad_norm) card "
        f"{runs['card']}, cpu {runs['cpu']}; max relative difference {rel:.3e}")
    if rel > 1e-4:
        raise AssertionError("the card's smoke-config training disagrees with the CPU's")

    params = to_cuda(cpu.init(torch.Generator().manual_seed(2)))
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
        log(f"remat {mode} vs none on the card: max relative grad difference {rel:.3e}, "
            f"bit-identical {same}")
        if rel > 1e-6:
            raise AssertionError(f"remat={mode} changes the grads")


def train_flops(cfg, seq, tokens):
    """Reckoned FLOPs of one train step (forward + backward, no recompute):
    6 per matmul parameter per token (the embedding gather does none) plus
    causal attention, 6 L Hq hd (S + 1) per token."""
    n_matmul = cfg.param_count() - cfg.vocab * cfg.d_model
    attn = 6 * cfg.n_layers * cfg.n_heads * cfg.head_dim * (seq + 1)
    return (6 * n_matmul + attn) * tokens


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


def phase_times(launches, path_errs, real_ulps, train_errs, train):
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
    print(json.dumps({"kernels": entries}), flush=True)


def main():
    kind = phase_device()
    from repro_torch.core import resolve_device
    resolve_device()                       # fp32 matmuls in full fp32
    phase_build()
    path_errs = phase_kernels()
    train_errs = phase_kernels_bwd()
    launches, real_ulps = phase_serving()
    gc.collect()
    torch.cuda.empty_cache()               # the serving model's 30 GB
    train = phase_training()
    gc.collect()
    torch.cuda.empty_cache()
    phase_times(launches, path_errs, real_ulps, train_errs, train)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
