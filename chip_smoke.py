#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100 and check its kernels.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order:

1. device  — require CUDA with compute capability 9.0; print the card's name
   and power limit as nvidia-smi reports them;
2. build   — compile every CUDA source of the path (one nvcc each, in parallel);
3. kernels — hold each kernel against its plain PyTorch version on the card
   (o: fp32 to 3e-5, bf16 to 2 bf16 ulps; lse to 1e-5 relative), including
   fully masked rows and the serving path's own shape;
4. serving — qwen2.5-14b at full width (48 layers, random bf16 weights from a
   seed): prefill of 4 x 1000 tokens, then 32 greedy decode steps, with the
   flash kernel's launches counted; the kernel held to its plain version, to
   the same tolerance, on every layer's own q/k/v from three full-width
   prefills (and, as a reading only, how far their logits drift from a
   prefill with plain attention); and a small smoke-config model on the card
   against the same model on the CPU;
5. times   — each kernel's time at the path's shape beside its bound, its plain
   version's time and the library call's, printed as one JSON line.

Any failure raises: the script exits non-zero and prints no final line. The
last line is ``{"ok": true, "device": {...}}``.
"""

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


def batch_major(gen, b, h, n, hd, dtype):
    """A head-major (B, H, N, hd) view of a batch-major tensor, as the model
    hands the kernel its q/k/v."""
    x = torch.randn(b, n, h, hd, generator=gen, device="cuda", dtype=torch.float32)
    return x.to(dtype).transpose(1, 2)


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
    logs = build.build(["flash_fwd"])
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
    model = build_model(cfg, ParallelPlan(compute_dtype="bfloat16"))
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

    plain = build_model(cfg, ParallelPlan(compute_dtype="bfloat16", attn_impl="plain"))
    real_ulps = kernel_on_real_inputs(model, plain, params, cfg)
    return launches, real_ulps


def phase_times(launches, path_errs, real_ulps):
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
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": launches,
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
        "check": "pass",
    }
    print(json.dumps({"kernels": [entry]}), flush=True)


def main():
    kind = phase_device()
    from repro_torch.core import resolve_device
    resolve_device()                       # fp32 matmuls in full fp32
    phase_build()
    path_errs = phase_kernels()
    launches, real_ulps = phase_serving()
    phase_times(launches, path_errs, real_ulps)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
