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
   relative) on every FLASH_CASES row (the Hopper body's edges at hd 64 and
   128: ragged and short S/T, GQA groups 1/2/5, q_offset with fully masked
   rows, windows on the tile edge with and without softcap, interior tiles,
   zamba2's serving shape cut in S), and at both training paths' shapes and
   zamba2's serving shape (4 x 32 heads x 8000, hd 64; the plain version in
   blocks of query rows), where two launches must be bit-identical; the
   backward's dq and dk/dv kernels
   (fp32 to 1e-5 of each tensor's largest value, bf16 to 2 bf16 ulps), fully
   masked rows included, at the paths' own shapes and at the edges of the
   Hopper body, with merged softmax statistics, and through the autograd
   Function; two launches at each training path's shape (qwen1.5-4b's, hd
   128; zamba2's, hd 64) bit-identical; the grouped expert GEMM (fp32 to 5e-5
   of the tensor's largest value, bf16 to 2 bf16 ulps, padding rows and
   experts with no load exactly 0) in its three uses — forward and dx (through
   a w^T view) in rows mode, dw (through an x^T view) in contract mode — on
   every GEMM_CASES row (the MoE paths' shapes; NaN in padding rows, M off the
   128-row tile, all-padding tiles, K shorter than a tile, one row per
   expert, through the Hopper body), two launches at the prefill shape
   bit-identical. Every check counts the body its launch ran;
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
   versions on every SSD_CASES row: both families' serving and training shapes
   (a ragged 8000), chunks 16, 24 and 1, G = 2 and 4, and the Hopper body's
   edges (a single chunk, a ragged 64-row last chunk, N 64, G 2 and 4 at N 128),
   plus a strong-decay draw (exp(cs) underflows across a chunk); a non-zero
   final-state cotangent, fp32 and bf16, the body the rule names counted on
   each launch; on the Hopper body (bf16, chunk 128) each pass alone against
   its plain version, and two launches at each path shape bit-identical; and
   through the autograd Function (fp32 and bf16);
9. mamba2-370m and zamba2-1.2b, each: the smoke config on the card against the
   CPU; serving at full width and depth (random bf16 weights and conv taps from
   a seed): a forward over 4 x 8000 tokens (B5 48 or 38 launches, B1 6 for the
   hybrid's shared block), a 16-token prompt through decode_step and 32 greedy
   steps, B5 (and, for the hybrid, B1 on its 6 attention applications) held to
   its plain version on every layer's own inputs; training at
   full width and depth (fp32 masters, remat "full", 2 microbatches of 4 or 2 x
   4096): the smoke config card vs CPU and under the three remat modes, B5/B6
   (and, for the hybrid, B2/B3 on its 6 attention applications) held to their
   plain versions on every call of one microbatch, one warm-up
   and three timed steps with the launches counted (B5 192/152, B6 96/76, and
   B1/B2/B3 12 each for the hybrid; B1 also held to its plain version on the
   hybrid's 6 attention applications of one microbatch), profiles;
10. whisper-small serving — the smoke config (forward, fill_cross, decode) on the
   card against the CPU; full width and depth (12 + 12 layers, 334 M parameters,
   random bf16 weights from a seed): fill_cross over 4 x 1500 frames from
   SyntheticDataset (B1 12 launches, non-causal over a ragged T = 1500), a
   4-token prompt through decode_step, 32 greedy steps (B1 12 a step: the
   cross-attention at S = 1), max_seq 448; B1 held to its plain version on every
   encoder layer's own inputs and every cross-attention of one decode step;
11. whisper-small training — the smoke config card vs CPU and under the three
   remat modes; full width and depth (fp32 masters, bf16 compute, remat "full",
   8 x 4096 tokens with 8 x 1500 frames in 2 microbatches): B1/B2/B3 held to
   their plain versions on every call of one microbatch, one warm-up and three
   timed steps with the launches counted (B1 144, B2 72, B3 72), a profile;
12. whisper-small checkpoint — its full-width training state saved with
   async_snapshot after 2 steps, steps 3-4 while the copy drains, restored into
   a fresh state (bit for bit), steps 3-4 resumed (losses to 1e-6 relative),
   a save with free card memory for half the state restored bit for
   bit, the host-RAM tier restored after lose_group; stall, fence, copy to
   host, persist and restore times;
13. whisper-small fault tolerance — each dispatcher's fault seam (B1 at the
   encoder's shape, B4 and B5 at smoke shapes): unarmed, the undecorated call's
   bits; armed with nan, one NaN at the index the CPU computes. Then full width
   and depth under ``run_with_recovery`` (the training plan, the batch cut to
   4 x 4096 tokens with 4 x 1500 frames): a clean run of 11 steps; the chaos
   schedule (a spike x8 at step 5, kernel.attention NaN'd at 6 and 9, the
   step-8 shard write dropped, a 4 s hang at 10), whose actions, 3 restores
   and 1 corrupt checkpoint skipped are asserted, ending equal to the clean run
   bit for bit; a run resumed from its last checkpoint with a real SIGTERM at
   step 9 (just-in-time snapshot, PREEMPTED marker, flight dump) and a resume
   that ends equal to the clean run bit for bit; B1/B2/B3 counted on every step of these runs (Hopper bodies); the
   audit's cost;
14. whisper-small data parallel — ZeRO-1 on torch.distributed at full width
   and depth (fp32 masters, bf16 compute, remat "full", ``Hyper()``): two rank
   processes (spawn) on the one card over gloo, the host transport (NCCL
   refuses two ranks on one device), the global batch of 8 x 4096 tokens with
   8 x 1500 frames, each rank 2 microbatches of its 2 rows of each; on each
   rank, one microbatch of its own 2 rows first, with B1 (72 calls, forward
   and recompute) and B2/B3 (36) held to their plain versions on every call
   and dq to fp64 at the DP path's shapes (batch 2); then 4 steps
   against one device's step with 4 microbatches on the same batches and
   weights (``DP_TOLERANCE``: the first step's loss and grad norm to 1e-6
   relative and its grads to 1e-6 of each leaf's max, the ZeRO-1 update
   against ``adamw_update`` on the same whole grads to 1e-6; the later steps
   and the params after 4 steps readings, beside the same readings between
   one device's runs at 2 and 4 microbatches; the first 2 steps watched, the
   last 2 timed), B1/B2/B3 144/72/72 per rank per step on the
   Hopper bodies, step, reduce-scatter and all-gather ms, peak memory and the
   moment bytes each rank holds; a ZeRO-1 checkpoint saved at dp 2 (stall,
   gather, persist), restored at dp 2 ("replay") and onto one process
   (``restore_resharded``, "reshard", refused without ``elastic``), both bit
   for bit, the resumed steps to 1e-6; the integrity audit on every step
   (0.0 on each rank, equal checksums), and the steps again under
   ``run_with_recovery`` with rank 1's checksum bit-flipped at step 2: an sdc
   rollback on both ranks from their RAM tiers, ending equal to the clean steps
   bit for bit; then one NCCL rank at world size 1
   through the same step code against one device's step with 2 microbatches;
15. times   — each kernel's time at its path's shapes beside its bound, its plain
   version's time and the library call's (none for B5/B6); B1 at the serving
   and training shapes and at zamba2's serving (4 x 32 heads x 8000, hd 64)
   and training (2 x 32 x 4096) shapes, through the Hopper body and the first
   version's; B4 on the MoE paths' own inputs through both bf16 bodies, and at
   the training dx and dw shapes with every row real (full load); for
   B2/B3 also the whole FlashAttention.backward (delta pass, dq, dk/dv) beside
   SDPA's backward, at the training shape and at zamba2's; B5/B6 at the four
   SSM path shapes through the Hopper body, through the first version's body
   and pass by pass; B1-B3 at whisper's encoder, decode cross-attention (S = 1)
   and training cross- and self-attention shapes; printed as one JSON line.

On every path, every B1, B4, B5 and B6 launch (prefill, fill_cross, decode,
training and data-parallel training) must run the Hopper body
(``check_bodies``, from the wrappers' per-body
counters); the kernels line reports those counters by body.

Any failure raises: the script exits non-zero and prints no final line. The
last line is ``{"ok": true, "device": {...}}``.
"""

import os

# the full-width train step holds ~74 GB; segments that grow in place keep the
# allocator from failing on fragmentation near the card's 80 GB
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import contextlib
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

# (b, hq, hkv, s, t, hd, causal, window, softcap, q_offset). B1 in bf16 at hd 64
# and 128 runs the Hopper body (128-query blocks, 64-key streamed tiles), other
# head dims the first version. tests/test_torch_flash.py runs the same list on
# the card, so a new edge is one line here. The serving path's shape stays last.
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0, 0.0, 0),
    (1, 4, 4, 256, 256, 64, True, 32, 0.0, 0),
    (2, 2, 1, 100, 100, 32, True, 0, 30.0, 0),       # ragged S and T
    (1, 8, 2, 128, 128, 128, False, 0, 0.0, 0),
    (1, 2, 2, 64, 192, 64, True, 0, 0.0, 0),         # cross lengths
    (1, 4, 1, 128, 128, 256, True, 4096, 50.0, 0),   # gemma2-like head dim
    (1, 4, 2, 50, 177, 64, True, 0, 0.0, 127),       # q_offset (chunked prefill)
    (1, 2, 1, 64, 16, 64, True, 8, 0.0, 64),         # fully masked rows
    # the Hopper body's edges, at hd 64 and 128
    (1, 4, 4, 1000, 1000, 128, True, 0, 0.0, 0),     # ragged S and T, GQA group 1
    (2, 4, 2, 1000, 1000, 64, True, 0, 0.0, 0),      # ragged, group 2
    (1, 40, 8, 256, 256, 128, True, 0, 0.0, 0),      # group 5
    (1, 10, 2, 256, 256, 64, True, 0, 0.0, 0),
    (1, 4, 2, 300, 40, 64, False, 0, 0.0, 0),        # T shorter than one tile
    (1, 4, 2, 300, 40, 128, False, 0, 0.0, 0),
    (1, 2, 1, 192, 64, 64, True, 16, 0.0, 48),       # q_offset: rows 31.. see no key
    (1, 2, 1, 192, 64, 128, True, 16, 0.0, 48),
    # windows of 64 m + 63 without softcap: interior tiles, and tiles whose last
    # pair lies exactly on the window edge, where only the window clause of the
    # interior test says "straddles"
    (1, 4, 4, 1000, 1000, 128, True, 191, 0.0, 0),
    (2, 4, 2, 1000, 1000, 64, True, 255, 0.0, 0),
    (1, 4, 4, 512, 512, 128, True, 100, 30.0, 0),    # window and softcap
    (1, 4, 4, 512, 512, 64, True, 100, 30.0, 0),
    (2, 8, 8, 512, 512, 64, False, 0, 0.0, 0),       # interior tiles only
    (2, 8, 8, 512, 512, 128, False, 0, 0.0, 0),
    (4, 32, 32, 2000, 2000, 64, True, 0, 0.0, 0),    # zamba2's serving shape, S cut
    # whisper-small: the encoder (non-causal, T = 1500 ragged on the 64-key tile),
    # a decode step's cross-attention (S = 1: one real row of a 128-query block),
    # the training cross-attention (S = 4096 against 1500 frames)
    (4, 12, 12, 1500, 1500, 64, False, 0, 0.0, 0),
    (4, 12, 12, 1, 1500, 64, False, 0, 0.0, 0),
    (4, 12, 12, 4096, 1500, 64, False, 0, 0.0, 0),
    (BATCH, 40, 8, PROMPT, PROMPT, 128, True, 0, 0.0, 0),   # the serving path
]
# o in fp32 to 3e-5; o in bf16 to 2 bf16 ulps of the plain version's value
# (both round one fp32 result); lse, fp32 math on the same inputs in both
# dtypes, to 1e-5 relative. A KV tile dropped or counted twice moves o by tens
# of ulps. tests/test_torch_flash.py holds the kernel to the same.
O_ABS_F32, O_ULPS_BF16, LSE_REL = 3e-5, 2.0, 1e-5
TOLERANCE = "o: fp32 3e-5 abs, bf16 2 ulps of |plain| (floor 2^-10); lse: 1e-5 rel"
PROMPT_SEEDS = (0, 1, 2)      # prompts of the real-input layer check
# the plain forward runs in blocks of query rows of at most this many fp32
# scores (2 GB): zamba2's serving shape would need 33 GB in one call
PLAIN_SCORES = 2 ** 29

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
# B2/B3 in bf16 at hd 64 and 128 run the Hopper body (128-row blocks, 64-row
# streamed tiles). These are its edges; tests/test_torch_flash_bwd.py runs the
# same list on the card, so a new edge is one line here.
BWD_CASES = [
    (1, 4, 4, 1000, 1000, 128, True, 0, 0.0, 0),       # ragged S and T, group 1
    (1, 40, 8, 256, 256, 128, True, 0, 0.0, 0),        # GQA 40/8
    (2, 4, 2, 1000, 1000, 64, True, 0, 0.0, 0),        # ragged, GQA 2
    (1, 4, 2, 300, 40, 64, False, 0, 0.0, 0),          # T shorter than one tile
    (1, 2, 1, 200, 40, 128, True, 0, 0.0, 180),        # q_offset, short T
    (1, 4, 4, 512, 512, 128, True, 100, 30.0, 0),      # window edge, softcap
    (1, 2, 1, 192, 64, 64, True, 16, 0.0, 48),         # rows 31.. see no key
    (2, 8, 8, 512, 512, 64, False, 0, 0.0, 0),         # interior tiles only
    (1, 20, 20, 1024, 1024, 128, True, 0, 0.0, 0),     # training heads, cut S
    # windows of 64 m + 63 without softcap: interior tiles, and tiles whose last
    # pair lies exactly on the window edge, where only the window clause of the
    # interior test says "straddles"
    (1, 4, 4, 1000, 1000, 128, True, 191, 0.0, 0),
    (2, 4, 2, 1000, 1000, 64, True, 255, 0.0, 0),
    (4, 12, 12, 1500, 1500, 64, False, 0, 0.0, 0),     # whisper's encoder
    (4, 12, 12, 4096, 1500, 64, False, 0, 0.0, 0),     # whisper's training cross-attention
]
# zamba2's shared attention in one training microbatch, where B1/B2/B3 are also
# timed, and in its 4 x 8000 serving forward, where B1 is timed
HYBRID_ATTN_CASE = (2, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 64, True, 0, 0.0, 0)
HYBRID_SERVE_ATTN_CASE = (4, 32, 32, 8000, 8000, 64, True, 0, 0.0, 0)

MOE_ARCH = "deepseek-moe-16b"
# training keeps 4 of the 28 layers: fp32 masters, grads and two moments take 16
# bytes a parameter, 270 GB for all 28 layers, 44 GB for these 4
MOE_TRAIN_LAYERS = 4
# B4 at (E, C, d, f, group sizes, NaN padding). First the MoE paths' shapes, C =
# int(n * 6 / 64 * 1.25) for the n tokens of a call: the prefill (n 4 x 1000), a
# decode step (n 4), a training microbatch (n 4096), each GEMM also with d and f
# swapped (the down projection), group sizes drawn at random ("random": with 0, C
# and loads that straddle a 64- and a 128-row tile). Then the edges of both
# bodies, each with its group sizes (None: every row) and whether the padding rows
# of x and g hold NaN. tests/test_torch_grouped_gemm.py runs the same list on the
# card, so a new edge is one line here.
GEMM_CASES = [
    (64, 468, 2048, 1408, "random", False), (64, 468, 1408, 2048, "random", False),
    (64, 1, 2048, 1408, "random", False), (64, 1, 1408, 2048, "random", False),
    (64, 480, 2048, 1408, "random", False), (64, 480, 1408, 2048, "random", False),
    (5, 100, 136, 72, "random", False),
    (3, 33, 20, 17, (33, 7, 0), False),           # strides off the 16-byte rule
    (4, 100, 136, 72, (100, 0, 64, 65), False),   # a zero-load expert, loads on tile edges
    (8, 1, 256, 200, (1, 0, 1, 0, 0, 1, 1, 0), False),   # one row: the Hopper body's M = 1
    (2, 70, 1024, 96, (70, 3), False),            # a contraction longer than the ring
    (2, 64, 64, 64, None, False),
    # M off 128; a contract-mode tile straddling gs (129) over NaN padding in both
    # operands; an expert whose row tiles past the first are all padding (64)
    (4, 300, 256, 192, (300, 0, 129, 64), True),
    (3, 200, 40, 136, (200, 17, 0), False),       # K shorter than one tile
]
# fp32 within 5e-5 of the tensor's largest |value|; bf16 within 2 bf16 ulps of
# each value (both sides round one fp32 sum; |value| floored at 2^-10 of the
# largest); padding rows (rows mode) and experts with no load exactly 0. A
# dropped contraction tile or a row of another expert misses by far more
# (tests/test_torch_grouped_gemm.py).
GEMM_REL_F32, GEMM_ULPS_BF16 = 5e-5, 2.0
GEMM_TOLERANCE = ("fp32 5e-5 of the tensor's max |value|, bf16 2 ulps of |plain| "
                  "(floor 2^-10 of the max); padding rows and zero-load experts exactly 0")

WHISPER_ARCH = "whisper-small"
# serving: frames (4, 1500, 768) through fill_cross, a 4-token prompt through
# decode_step, then DECODE_STEPS greedy steps; the decoder's context is 448
# tokens (arXiv:2212.04356)
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_MAX_SEQ = 4, 4, 448
# training: train_4k's sequence with the registry's batch of 256 cut to 8 (one
# card), TRAIN_MICRO microbatches of 4, each with its 4 x 1500 frames
WHISPER_TRAIN_BATCH = 8
# B1-B3 at whisper's shapes, timed and held to their plain versions: the
# encoder, a decode step's cross-attention, and a training microbatch's
# cross-attention and decoder self-attention
WHISPER_CASES = {
    "encoder": (4, 12, 12, 1500, 1500, 64, False, 0, 0.0, 0),
    "decode_cross": (4, 12, 12, 1, 1500, 64, False, 0, 0.0, 0),
    "train_cross": (4, 12, 12, TRAIN_SEQ, 1500, 64, False, 0, 0.0, 0),
    "train_self": (4, 12, 12, TRAIN_SEQ, TRAIN_SEQ, 64, True, 0, 0.0, 0),
}

SSM_ARCH, HYBRID_ARCH = "mamba2-370m", "zamba2-1.2b"
# serving: a forward over 4 x 8000 tokens (62 chunks of 128 and a ragged 64), then a
# 16-token prompt through decode_step and DECODE_STEPS greedy steps
SSM_BATCH, SSM_PROMPT, SSM_DECODE_PROMPT = 4, 8000, 16
# training: TRAIN_MICRO microbatches of 4 sequences (mamba2; B5's grid 4 x 32 = 128
# blocks) or 2 (zamba2: 2 x 64) of TRAIN_SEQ tokens
SSM_TRAIN_BATCH = {SSM_ARCH: 8, HYBRID_ARCH: 4}
# B5/B6 at (b, l, h, p, g, n, chunk): the four path shapes; the first version's
# (fp32, and bf16 at chunks 16, 24 and 1): the decode check's 16-token prompt and a
# 16-token prompt at a few heads (chunk 16), chunk 24 with G 4, G 2 on a ragged
# length, chunk 1; the Hopper body's edges (bf16, chunk 128, P 64): a ragged 64-row
# last chunk, N 64, a single chunk (ragged, and whole at N 64), L = 8000's 62 chunks
# and a ragged 64 at a few heads, G 2 and G 4 at N 128. tests/test_torch_ssd.py
# runs the same list on the card, so a new edge is one line here.
SSD_PATH_CASES = {
    "mamba2_serving": (SSM_BATCH, SSM_PROMPT, 32, 64, 1, 128, 128),
    "mamba2_training": (4, TRAIN_SEQ, 32, 64, 1, 128, 128),
    "zamba2_serving": (SSM_BATCH, SSM_PROMPT, 64, 64, 1, 64, 128),
    "zamba2_training": (2, TRAIN_SEQ, 64, 64, 1, 64, 128),
}
SSD_CASES = list(SSD_PATH_CASES.values()) + [
    (SSM_BATCH, SSM_DECODE_PROMPT, 32, 64, 1, 128, 16),
    (1, 16, 4, 64, 1, 128, 16),
    (1, 96, 4, 8, 4, 8, 24),
    (2, 100, 4, 32, 2, 16, 16),
    (1, 7, 2, 4, 1, 4, 1),
    (2, 320, 4, 64, 1, 128, 128),
    (2, 256, 4, 64, 1, 64, 128),
    (2, 100, 4, 64, 1, 128, 128),
    (1, 128, 2, 64, 1, 64, 128),
    (2, 8000, 4, 64, 1, 128, 128),
    (2, 512, 8, 64, 2, 128, 128),
    (1, 384, 8, 64, 4, 128, 128),
]
# a strong-decay draw for the Hopper body: dt 10x the usual ([0.1, 2)), so exp(cs)
# underflows to 0 across a chunk (cs reaches ~ -170 by its end)
SSD_DECAY_CASE, SSD_DECAY_SCALE = (2, 384, 4, 64, 1, 128, 128), 10.0
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


def flash_plain(q, k, v, *, q_offset=0, **kw):
    """B1's plain version in blocks of query rows, each at its own q_offset,
    so that no block's fp32 scores pass PLAIN_SCORES: the same (o, lse) as one
    call, row by row."""
    from repro_torch.kernels.flash_attention import flash_attention_lse_plain
    b, hq, s, _ = q.shape
    rows = max(1, PLAIN_SCORES // (b * hq * k.shape[2]))
    parts = [flash_attention_lse_plain(q[:, :, r:r + rows], k, v, q_offset=q_offset + r, **kw)
             for r in range(0, s, rows)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([o for o, _ in parts], 2), torch.cat([lse for _, lse in parts], 2)


def dead_rows_ok(o, lse, plse):
    """Fully masked rows (plain lse ~ -1e30): o exactly 0 and lse ~ -1e30.
    Returns (how many, whether they hold)."""
    dead = plse < -1e29
    return int(dead.sum()), bool((o.float()[dead] == 0).all() and (lse[dead] < -1e29).all())


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


def body_counts():
    """B1's, B4's, B5's and B6's launches by body, under the bodies' kernel names."""
    from repro_torch.kernels.flash_attention import flash_attention_lse as f
    from repro_torch.kernels.grouped_gemm import grouped_gemm as g
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_bwd as sb, ssd_chunk_scan_fwd as sf
    return {"flash_fwd_sm90": f.sm90_launches, "flash_fwd_bf16": f.mma_launches,
            "flash_fwd_f32": f.f32_launches, "gg_sm90": g.sm90_launches,
            "gg_bf16": g.mma_launches, "gg_f32": g.f32_launches,
            "ssd_fwd_sm90": sf.sm90_launches, "ssd_fwd_simt": sf.simt_launches,
            "ssd_bwd_sm90": sb.sm90_launches, "ssd_bwd_simt": sb.simt_launches}


# window -> body_counts() as check_bodies read them there (a train step's: the
# last one's); the kernels line sums them over the windows of launches_by_path
BODY_COUNTS = {}


def reset_counts():
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_lse)
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    flash_attention_lse.launches = 0
    flash_attention_lse.sm90_launches = flash_attention_lse.mma_launches = 0
    flash_attention_lse.f32_launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    grouped_gemm.rows_launches = grouped_gemm.contract_launches = 0
    grouped_gemm.sm90_launches = grouped_gemm.mma_launches = grouped_gemm.f32_launches = 0
    reset_ssd_counts()


def check_bodies(what, counts, window=None):
    """Every B1 and B4 launch counted in ``counts`` (all_counts() since the
    last reset_counts(), then ssd_counts() on the SSM paths) ran the Hopper
    body, and so did every B5 and B6 launch; the counts by body are kept under
    ``window`` for the kernels line."""
    got = body_counts()
    b4 = counts[3] + counts[4]
    b5, b6 = counts[5:7] if len(counts) > 5 else (0, 0)
    log(f"bodies, {what}: " + ", ".join(f"{k} {v}" for k, v in got.items())
        + f" (B1 {counts[0]}, B4 {b4}, B5 {b5}, B6 {b6} launches)")
    want = dict.fromkeys(got, 0)
    want.update(flash_fwd_sm90=counts[0], gg_sm90=b4, ssd_fwd_sm90=b5, ssd_bwd_sm90=b6)
    if got != want:
        raise AssertionError(f"{what}: launches by body {got}, expected {want}")
    if window:
        BODY_COUNTS[window] = got


def launches_by_body(prefix, windows):
    """The per-body counts that check_bodies read, summed over ``windows``,
    for the bodies whose names start with ``prefix``."""
    return {name: sum(BODY_COUNTS[w][name] for w in windows)
            for name in body_counts() if name.startswith(prefix)}


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
            if any(w in line for w in ("Compiling entry", "Used", "spill", "wgmma", "warning")):
                log(f"  {name}: {line.strip()}")


def flash_case_check(case, dtype, gen):
    """B1 against its plain version on one case: the body the rule names ran
    (counted), o and lse within the limit, finite, fully masked rows o = 0 and
    lse ~ -1e30. Returns (errors, q, k, v, o, lse)."""
    from repro_torch.kernels import flash_attention as tf
    b, hq, hkv, s, t, hd = case[:6]
    q = batch_major(gen, b, hq, s, hd, dtype)
    k = batch_major(gen, b, hkv, t, hd, dtype)
    v = batch_major(gen, b, hkv, t, hd, dtype)
    body = tf.fwd_body(q)
    before = getattr(tf.flash_attention_lse, f"{body}_launches")
    o, lse = tf.flash_attention_lse(q, k, v, **case_kw(case))
    torch.cuda.synchronize()
    if getattr(tf.flash_attention_lse, f"{body}_launches") != before + 1:
        raise AssertionError(f"flash_attention_lse did not launch its {body} body")
    po, plse = flash_plain(q, k, v, **case_kw(case))
    errs = match_errors(o, lse, po, plse)
    del po
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    dead, dead_ok = dead_rows_ok(o, lse, plse)
    log(f"check {case} {str(dtype)[6:]} ({body}): o err {errs[0]:.3e} = {errs[1]:.2f} "
        f"bf16 ulps, lse rel err {errs[2]:.3e}, masked rows {dead}")
    if not (within_tolerance(dtype, *errs) and finite and dead_ok):
        raise AssertionError(f"flash_fwd disagrees with its plain version on {case} {dtype}")
    return errs, q, k, v, o, lse


def phase_kernels():
    """B1 against its plain version on every FLASH_CASES row in both dtypes and,
    in bf16, at the training path's shape (qwen1.5-4b's), zamba2's training and
    serving shapes and whisper's decoder self-attention in training, where two
    launches must also be bit-identical. Returns the bf16 errors at the
    serving, training, zamba2 and whisper shapes."""
    from repro_torch.kernels.flash_attention import flash_attention_lse
    gen = torch.Generator(device="cuda").manual_seed(0)
    path_errs = {}
    whisper = {case: f"whisper_{name}" for name, case in WHISPER_CASES.items()}
    for case in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            errs = flash_case_check(case, dtype, gen)[0]
            if case == FLASH_CASES[-1] and dtype == torch.bfloat16:
                path_errs["serving"] = errs
            if case in whisper and dtype == torch.bfloat16:
                path_errs[whisper[case]] = errs
    for name, case in (("train", TRAIN_CASE), ("hybrid_train", HYBRID_ATTN_CASE),
                       ("hybrid_serve", HYBRID_SERVE_ATTN_CASE),
                       ("whisper_train_self", WHISPER_CASES["train_self"])):
        errs, q, k, v, o, lse = flash_case_check(case, torch.bfloat16, gen)
        again = flash_attention_lse(q, k, v, **case_kw(case))
        same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        log(f"check {case} bfloat16: a second launch bit-identical: {same}")
        if not same:
            raise AssertionError(f"two launches of flash_fwd at {case} differ")
        path_errs[name] = errs
        del q, k, v, o, lse, again
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

    reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_seq=MAX_SEQ)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = flash_attention_lse.launches
    if prefill_launches != cfg.n_layers:
        raise AssertionError(f"prefill launched flash_fwd {prefill_launches} times, "
                             f"expected {cfg.n_layers}")
    check_bodies(f"{ARCH} prefill", all_counts(), "prefill")
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
    and BWD_CASES row and the training paths' shapes (qwen1.5-4b's, hd 128;
    zamba2's and whisper's encoder, cross- and self-attention, hd 64) in both
    dtypes, merged softmax statistics, and the autograd Function; two launches
    at each path shape bit-identical. Returns the bf16 errors at the path
    shapes: {"train": ..., "hybrid": ..., "whisper_encoder": ..., ...}."""
    from repro_torch.kernels import flash_attention as tf
    from repro_torch.models.layers import attention_chunk_grads
    gen = torch.Generator(device="cuda").manual_seed(5)
    path_errs = {}
    paths = {TRAIN_CASE: "train", HYBRID_ATTN_CASE: "hybrid",
             **{WHISPER_CASES[n]: f"whisper_{n}" for n in ("encoder", "train_cross",
                                                           "train_self")}}
    for case in dict.fromkeys(FLASH_CASES + BWD_CASES + list(paths)):
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
            if case in paths and dtype == torch.bfloat16:
                path_errs[paths[case]] = errs
                again = tf.flash_attention_bwd(q, k, v, do, lse, delta, **kw)
                same = all(torch.equal(a, b) for a, b in zip(grads, again))
                log(f"check bwd {case} bfloat16: a second launch bit-identical: {same}")
                if not same:
                    raise AssertionError(f"two launches of flash_bwd at {case} differ")
                del again
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
    return path_errs


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
    (``ssd_flops``); the encoder-decoder by ``encdec_train_flops``. Neither the
    recompute nor the MoE one-hot dispatch einsums are counted."""
    from repro_torch.core import Family, leaves
    if cfg.is_enc_dec:
        return encdec_train_flops(cfg, seq, tokens)
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


def encdec_train_flops(cfg, seq, tokens):
    """Reckoned FLOPs of one encoder-decoder train step (forward + backward, no
    recompute): 6 per matmul parameter a frame or a token uses (the encoder's
    layers and every decoder layer's cross keys and values on the frames; the
    decoder's self-attention, cross queries and output, MLP and the LM head on
    the tokens; the embedding gather does none), plus 12 hd FLOP per attended
    (query, key) pair and head: the encoder's non-causal F^2, the decoder's
    causal S(S+1)/2 and the cross-attention's S F, per sequence."""
    d, f, hd = cfg.d_model, cfg.enc_frames, cfg.head_dim
    kv = 2 * d * cfg.n_kv_heads * hd
    attn = 2 * d * cfg.n_heads * hd + kv
    mlp = 3 * d * cfg.d_ff
    b = tokens // seq
    per_frame = cfg.enc_layers * (attn + mlp) + cfg.n_layers * kv
    per_token = cfg.n_layers * (2 * attn - kv + mlp) + d * cfg.vocab
    pairs = cfg.enc_layers * f * f + cfg.n_layers * (seq * (seq + 1) // 2 + seq * f)
    return 6 * (per_frame * b * f + per_token * tokens) + 12 * cfg.n_heads * hd * b * pairs


def dq_fp64(q, k, v, do, lse, delta, *, causal, window=0, softcap=0.0, scale=None,
            q_offset=0):
    """B2's formula (dq against the given lse and delta) evaluated in fp64, in
    blocks of 512 query rows: the yardstick for both the kernel and the fp32
    plain version where dq's rows cancel."""
    from repro_torch.models.layers import NEG_INF, attn_mask
    b, hq, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    kf, vf = k.double(), v.double()
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for r in range(0, s, 512):
        n = min(512, s - r)
        qs = q[:, :, r:r + n].double().reshape(b, hkv, hq // hkv, n, hd)
        dos = do[:, :, r:r + n].double().reshape(b, hkv, hq // hkv, n, hd)
        sc = torch.einsum("bkgsd,bktd->bkgst", qs, kf) * scale
        dtanh = 1.0
        if softcap:
            th = torch.tanh(sc / softcap)
            sc, dtanh = softcap * th, 1.0 - th * th
        mask = attn_mask(q_offset + r + torch.arange(n, device=q.device),
                         torch.arange(t, device=q.device), causal=causal, window=window)
        l, dl = (x[:, :, r:r + n].double().reshape(b, hkv, hq // hkv, n, 1) for x in (lse, delta))
        p = torch.exp(torch.where(mask, sc - l, NEG_INF))
        ds = p * (torch.einsum("bkgsd,bktd->bkgst", dos, vf) - dl) * dtanh
        dq[:, :, r:r + n] = (torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
                             ).reshape(b, hq, n, hd)
    return dq


class FlashBwdCapture:
    """Within the block, every call of the backward kernels' wrapper (B2 and
    B3, as FlashAttention.backward makes it) is held to the plain version on
    its own (q, k, v, dO, lse, delta); with ``fp64``, the kernel's dq and the
    plain version's are also each held to an fp64 evaluation (``dq_fp64``).
    ``functools.wraps`` copies the launch counters onto the wrapper, so these
    launches leave the real counts alone."""

    def __init__(self, fp64=False):
        self.fp64, self.dq64 = fp64, []

    def __enter__(self):
        from repro_torch.kernels import flash_attention as tf
        self.real, self.errs = tf.flash_attention_bwd, []
        real = self.real

        @functools.wraps(real)
        def checked_bwd(q, k, v, do, lse, delta, **kw):
            grads = real(q, k, v, do, lse, delta, **kw)
            ref = tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
            self.errs.append([grad_error(g, r) for g, r in zip(grads, ref)])
            if self.fp64:
                truth = dq_fp64(q, k, v, do, lse, delta, **kw)
                self.dq64.append((grad_error(grads[0], truth)[1], grad_error(ref[0], truth)[1]))
            return grads
        tf.flash_attention_bwd = checked_bwd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as tf
        tf.flash_attention_bwd = self.real

    def summary(self, what, calls):
        """Check that ``calls`` calls were held and log them; returns the worst
        (dk/dv, dq) errors in bf16 ulps (None when no call was expected)."""
        if len(self.errs) != calls:
            raise AssertionError(f"checked {len(self.errs)} attention backwards on the "
                                 f"{what}, expected {calls}")
        if not calls:
            return None
        worst = [max(e[i][1] for e in self.errs) for i in range(3)]
        worst_abs = [max(e[i][0] for e in self.errs) for i in range(3)]
        log(f"real inputs, {what}: B2/B3 held to their plain version on {calls} calls, "
            f"max error dq/dk/dv {worst_abs[0]:.3e}/{worst_abs[1]:.3e}/{worst_abs[2]:.3e} = "
            f"{worst[0]:.2f}/{worst[1]:.2f}/{worst[2]:.2f} bf16 ulps")
        if self.dq64:
            kern, plain = (max(e[i] for e in self.dq64) for i in range(2))
            log(f"real inputs, {what}: dq against an fp64 evaluation, worst of {calls} calls: "
                f"the kernel {kern:.2f}, the fp32 plain version {plain:.2f} bf16 ulps")
            worst.append(kern)
        if max(worst) > GRAD_ULPS_BF16:
            raise AssertionError(f"flash_bwd disagrees with its plain version (or, for dq, "
                                 f"with fp64) on the {what}'s own inputs")
        return max(worst[1:3]), worst[0]


class FlashFwdCapture:
    """Within the block, every call of B1's wrapper (as FlashAttention.forward
    makes it) is held to the plain version (flash_plain) on its own (q, k, v),
    fully masked rows exactly, and must run the Hopper body.
    ``functools.wraps`` copies the launch counters onto the wrapper, so these
    launches leave the real counts alone."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as tf
        self.real, self.errs = tf.flash_attention_lse, []
        real = self.real

        @functools.wraps(real)
        def checked_fwd(q, k, v, **kw):
            o, lse = real(q, k, v, **kw)
            po, plse = flash_plain(q, k, v, **kw)
            self.errs.append((*match_errors(o, lse, po, plse), dead_rows_ok(o, lse, plse)[1]))
            return o, lse
        self.wrapper = checked_fwd
        tf.flash_attention_lse = checked_fwd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as tf
        tf.flash_attention_lse = self.real

    def summary(self, what, calls):
        """Check that ``calls`` calls were held, each through the Hopper body,
        and log them; returns the worst o error in bf16 ulps (None when no call
        was expected)."""
        hopper = self.wrapper.sm90_launches - self.real.sm90_launches
        if len(self.errs) != calls or hopper != calls:
            raise AssertionError(f"checked {len(self.errs)} attention forwards on the {what} "
                                 f"({hopper} through the Hopper body), expected {calls}")
        if not calls:
            return None
        o_abs, o_ulps, lse_rel = (max(e[i] for e in self.errs) for i in range(3))
        dead_ok = all(e[3] for e in self.errs)
        log(f"real inputs, {what}: B1 held to its plain version on {calls} calls, max o err "
            f"{o_abs:.3e} = {o_ulps:.2f} bf16 ulps, lse rel err {lse_rel:.3e}, fully "
            f"masked rows exact {dead_ok}")
        if not (within_tolerance(torch.bfloat16, o_abs, o_ulps, lse_rel) and dead_ok):
            raise AssertionError(f"flash_fwd disagrees with its plain version on the "
                                 f"{what}'s own inputs")
        return o_ulps


def backward_on_real_inputs(model, params, cfg, batch):
    """One microbatch's forward + backward at full width, no optimizer state:
    on every layer, B2 and B3 held to their plain version on that layer's own
    (q, k, v, dO, lse, delta), then discarded. As a reading only, the same
    step with attn_impl="plain": its loss and grad-norm difference."""
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.train import Hyper, make_loss_fn

    mb = {k: v[:1] for k, v in batch.items()}
    with FlashBwdCapture() as cap:
        loss, _ = make_loss_fn(model, Hyper())(params, mb)
        loss.backward()
    gnorm = global_norm(map_tree(lambda p: p.grad, params)).item()
    loss = loss.item()
    worst = cap.summary(f"full-width backward ({cfg.n_layers} layers)", cfg.n_layers)
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
    return worst


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
        check_bodies(f"{TRAIN_ARCH} train step {i}", all_counts(), "train_step")
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


def bwd_times_at(case, gen):
    """B2 and B3 at one bf16 shape (CUDA events) beside their bounds; the
    whole FlashAttention.backward (the delta pass, B2 and B3) and SDPA's
    backward, both through autograd on the same q, k, v and dO."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tf
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = case
    q, k, v, do, lse, delta = bwd_inputs(gen, case, torch.bfloat16)
    kw = dict(case_kw(case), scale=hd ** -0.5)
    out = [torch.empty_like(x) for x in (q, k, v)]
    ms = {which: cuda_ms(lambda: tf._bwd_launch(which, q, k, v, do, lse, delta, *out, **kw), 20)
          for which in (0, 1)}
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    o = tf.flash_attention(ql, kl, vl, **case_kw(case))
    whole_ms = cuda_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True), 20)
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=hq != hkv)
    library_ms = cuda_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True), 20)
    pairs = attended_pairs(s, t, causal, window, q_offset) * b * hq
    in_bytes = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * 2 * b * hq * s
    bounds = {}
    for which, flops, nbytes in ((0, 6 * hd * pairs, in_bytes + 2 * q.numel()),
                                 (1, 8 * hd * pairs, in_bytes + 2 * (k.numel() + v.numel()))):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        bounds[which] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    log(f"flash_bwd at {case}: dq {ms[0]:.4f} ms (bound {bounds[0][0]:.4f}, "
        f"{bounds[0][1]}), dk/dv {ms[1]:.4f} ms (bound {bounds[1][0]:.4f}, {bounds[1][1]}); "
        f"dq + dk/dv {ms[0] + ms[1]:.4f} ms; FlashAttention.backward (delta, dq, dk/dv) "
        f"{whole_ms:.4f} ms; sdpa backward {library_ms:.4f} ms")
    return {"ms": ms, "bounds": bounds, "whole_ms": whole_ms, "library_ms": library_ms,
            "inputs": (q, k, v, do, lse, delta, kw)}


def backward_times():
    """B2 and B3 at the training shape, at zamba2's and at whisper's encoder,
    training cross- and self-attention (bwd_times_at), and the plain backward
    at the training shape and whisper's."""
    from repro_torch.kernels import flash_attention as tf
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = bwd_times_at(TRAIN_CASE, gen)
    q, k, v, do, lse, delta, kw = res.pop("inputs")
    res["plain_ms"] = cuda_ms(lambda: tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw),
                              3, warmup=1)
    log(f"training shape: plain backward {res['plain_ms']:.4f} ms")
    del q, k, v, do, lse, delta
    hybrid = bwd_times_at(HYBRID_ATTN_CASE, gen)
    hybrid.pop("inputs")
    res["hybrid"] = hybrid
    for name in ("encoder", "train_cross", "train_self"):
        w = bwd_times_at(WHISPER_CASES[name], gen)
        q, k, v, do, lse, delta, kw = w.pop("inputs")
        w["plain_ms"] = cuda_ms(lambda: tf.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                                     **kw), 3, warmup=1)
        log(f"whisper {name}: plain backward {w['plain_ms']:.4f} ms")
        res[f"whisper_{name}"] = w
        del q, k, v, do, lse, delta
        free()
    return res


def fwd_times_at(case, gen):
    """B1 (CUDA events) at one bf16 shape, through the Hopper body and
    through the first-version mma.sync body, beside its bound, the plain version
    (flash_plain: in blocks of query rows where one call's fp32 scores would
    pass PLAIN_SCORES) and SDPA. The bound counts
    the attended pairs (two products, 4 hd FLOP a pair) and q, k, v read and o,
    lse written once."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tf
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = case
    q = batch_major(gen, b, hq, s, hd, torch.bfloat16)
    k = batch_major(gen, b, hkv, t, hd, torch.bfloat16)
    v = batch_major(gen, b, hkv, t, hd, torch.bfloat16)
    kw = dict(case_kw(case), scale=hd ** -0.5)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    ms = {body: cuda_ms(lambda: tf._fwd_launch(body, q, k, v, o, lse, **kw), 20)
          for body in ("sm90", "mma")}
    plain_ms = cuda_ms(lambda: flash_plain(q, k, v, **case_kw(case)), 3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=hq != hkv), 20)
    flops = 4 * hd * attended_pairs(s, t, causal, window, q_offset) * b * hq
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    res = {"shape": list(case[:6]), "ms": ms["sm90"], "mma_ms": ms["mma"],
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"flash_fwd at {case}: Hopper body {ms['sm90']:.4f} ms, mma.sync body "
        f"{ms['mma']:.4f} ms, bound {res['bound_ms']:.4f} ms ({flops:.3e} FLOP, "
        f"{nbytes / 1e6:.1f} MB, {res['bound_by']}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms")
    return res


def forward_times():
    """B1 at the serving and training paths' shapes, at zamba2's serving and
    training shapes and at whisper's four (fwd_times_at)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, case in (("serving", FLASH_CASES[-1]), ("train", TRAIN_CASE),
                       (f"{HYBRID_ARCH}_serving", HYBRID_SERVE_ATTN_CASE),
                       (f"{HYBRID_ARCH}_train", HYBRID_ATTN_CASE),
                       *((f"{WHISPER_ARCH}_{n}", c) for n, c in WHISPER_CASES.items())):
        out[name] = fwd_times_at(case, gen)
        free()
    return out


def gemm_case_inputs(case, dtype, gen):
    """x (E, C, d), w (E, d, f), g (E, C, f) of ``dtype`` and the group sizes of a
    GEMM_CASES row on the card ("random": drawn with 0, C and loads that
    straddle a 64- and a 128-row tile); with NaN padding, the rows of x and g at
    or past each expert's load hold NaN."""
    e, c, d, f, gs_spec, nan_pad = case
    if gs_spec == "random":
        gs = torch.randint(0, c + 1, (e,), generator=gen, device="cuda", dtype=torch.int32)
        gs[0], gs[1] = 0, c
        gs[2], gs[3] = min(c, 67), min(c, 131)
    else:
        gs = None if gs_spec is None else torch.tensor(gs_spec, dtype=torch.int32,
                                                        device="cuda")
    x, w, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((e, c, d), (e, d, f), (e, c, f)))
    if nan_pad:
        pad = torch.arange(c, device="cuda")[None, :, None] >= gs[:, None, None]
        x, g = (t.masked_fill(pad, float("nan")) for t in (x, g))
    return x, w, g, gs


def phase_kernels_gemm():
    """B4 against its plain version in its three uses at every GEMM_CASES row,
    fp32 and bf16, through the body the rule names (counted); two launches at
    the prefill shape bit-identical. Returns the errors at the prefill shape's
    forward (bf16)."""
    from repro_torch.kernels import grouped_gemm as tg
    gen = torch.Generator(device="cuda").manual_seed(6)
    path_errs = None
    for case in GEMM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, g, gs = gemm_case_inputs(case, dtype, gen)
            for use, a, b, mask in (("forward", x, w, "rows"),
                                    ("dx", g, w.transpose(1, 2), "rows"),
                                    ("dw", x.transpose(1, 2), g, "contract")):
                body = tg.gemm_body(a, b)
                before = (*gemm_counts(), getattr(tg.grouped_gemm, f"{body}_launches"))
                out = tg.grouped_gemm(a, b, gs, mask=mask)
                torch.cuda.synchronize()
                if (*gemm_counts(), getattr(tg.grouped_gemm, f"{body}_launches")) != (
                        before[0] + (mask == "rows"), before[1] + (mask == "contract"),
                        before[2] + 1):
                    raise AssertionError(f"grouped_gemm did not count one {body} launch")
                abs_err, err, zeros, ok = gemm_check(out, a, b, gs, mask)
                unit = "bf16 ulps" if dtype == torch.bfloat16 else "of the max"
                log(f"check grouped_gemm {case[:4]} {str(dtype)[6:]} {use} ({mask}, {body}): "
                    f"err {abs_err:.3e} = {err:.3g} {unit}, zeros exact {zeros}")
                if not ok:
                    raise AssertionError(f"grouped_gemm disagrees with its plain version on "
                                         f"{case} {dtype} {use}")
                if case == GEMM_CASES[0] and dtype == torch.bfloat16 and use == "forward":
                    path_errs = (abs_err, err)
                    same = torch.equal(out, tg.grouped_gemm(a, b, gs, mask=mask))
                    log(f"check grouped_gemm {case[:4]} bfloat16 forward: a second launch "
                        f"bit-identical: {same}")
                    if not same:
                        raise AssertionError(f"two launches of grouped_gemm at {case} differ")
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
    check_bodies(f"{MOE_ARCH} prefill", prefill_launches, "moe_prefill")
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
    check_bodies(f"{MOE_ARCH} {DECODE_STEPS} decode steps", decode_launches, "moe_decode")
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
    check_bodies(f"{MOE_ARCH} prefill (scatter)", prefill_launches)
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
    return {"prefill_b1": prefill_launches[0], "prefill_b4": prefill_launches[3],
            "decode_b4": decode_launches[3],
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
    kept = {"train_dx": cap.kept["dx"], "train_dw": cap.kept["dw"]}
    gen = torch.Generator(device="cuda").manual_seed(10)
    kept.update({f"{name}_full_load": full_load(*kept[name], gen) for name in list(kept)})
    b4_times = gemm_times(kept)
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
        check_bodies(f"{MOE_ARCH} train step {i}", launches, "moe_train_step")
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
    return {"train_b1": launches[0], "train_b4_rows": launches[3],
            "train_b4_contract": launches[4],
            "train_b2": launches[1], "train_b3": launches[2],
            "real_ulps": real_ulps, "times": b4_times}


def full_load(a, b, gs, mask, gen):
    """Random bf16 operands in the layouts (strides) of a kept B4 call, with
    every row real: group sizes at the rows (rows mode) or the contraction
    length (contract mode)."""
    def like(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device=t.device).normal_(generator=gen)
    full = a.shape[1] if mask == "rows" else a.shape[2]
    return like(a), like(b), torch.full_like(gs, full), mask


def gemm_times(kept):
    """B4 (CUDA events) on each kept path input through both bf16 bodies (the
    Hopper body and the first-version mma.sync body; "ms" is the one the rule
    routes the input to) beside its bound, its plain version and one
    ``torch.bmm`` on the masked inputs. The bound counts what this input needs:
    the real rows of the activations, the weights of experts with a load, the
    whole output written, 2 FLOP a multiply-add of real rows."""
    from repro_torch.kernels import grouped_gemm as tg
    res = {}
    for name, (a, b, gs, mask) in kept.items():
        e, m, k = a.shape
        n = b.shape[2]
        out = torch.empty((e, m, n), dtype=a.dtype, device="cuda")
        body_ms = {body: cuda_ms(lambda: tg._launch(body, a, b, out, gs, mask), 20)
                   for body in ("sm90", "mma")}
        body = tg.gemm_body(a, b)
        ms = body_ms[body]
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
        res[name] = {"shape": [e, m, k, n], "mask": mask, "real_rows": real, "body": body,
                     "ms": ms, "sm90_ms": body_ms["sm90"], "mma_ms": body_ms["mma"],
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"grouped_gemm {name} {(e, m, k, n)} {mask}, {real} real rows: {ms:.4f} ms "
            f"({body}; Hopper body {body_ms['sm90']:.4f}, mma.sync body {body_ms['mma']:.4f}), "
            f"bound {res[name]['bound_ms']:.4f} ms ({flops:.3e} FLOP, {nbytes / 1e6:.1f} MB, "
            f"{res[name]['bound_by']}), plain {plain_ms:.4f} ms, bmm {library_ms:.4f} ms")
        del am, bm, out
    return res


# ---------------------------------------------------------------------------
# Mamba2 and the zamba2 hybrid: the SSD chunk scan (B5 forward, B6 backward)


def ssd_counts():
    from repro_torch.kernels import ssd_scan as ts
    return ts.ssd_chunk_scan_fwd.launches, ts.ssd_chunk_scan_bwd.launches


def reset_ssd_counts():
    from repro_torch.kernels import ssd_scan as ts
    for fn in (ts.ssd_chunk_scan_fwd, ts.ssd_chunk_scan_bwd):
        fn.launches = fn.sm90_launches = fn.simt_launches = 0


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


def ssd_inputs(gen, case, dtype, dt_scale=1.0):
    """Head-major views of model-layout x, dt, B, C (as the dispatcher hands them
    to the kernels), x/B/C in ``dtype``; dt in [0.01, 0.2) (times ``dt_scale``)
    and A in (-2, -0.5], the reference's test draws."""
    b, l, h, p, g, n, _ = case
    x = torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    dt = (dt_scale * (0.01 + 0.19 * torch.rand(b, l, h, generator=gen, device="cuda"))
          ).transpose(1, 2)
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


def ssd_pass_errors(ins, dy, dfinal):
    """The Hopper body's passes, each launched alone on its plain version's
    inputs and held to that pass's plain version (fp32 outputs, in the
    max(1, max |plain|) measure): the forward's states pass (the plain
    increments then the plain state pass) and output; the backward's reverse
    states pass and gradient pass (its two kernels, rows and columns, together).
    Returns {pass: error}."""
    from repro_torch.kernels import ssd_scan as ts
    x, dt, A, Bm, Cm = ins
    chunk = ts.SM90_CHUNK
    dt, A = dt.float(), A.float().contiguous()
    err = lambda o, r: ssd_error(o, r)[1]  # noqa: E731
    errs = {}
    y, states, final = ts._fwd_buffers(x, Bm, chunk, states=True)
    enters, fin = ts.ssd_state_pass_plain(*ts.ssd_fwd_increments_plain(x, dt, A, Bm, chunk=chunk))
    ts._fwd_sm90(x, dt, A, Bm, Cm, y, states, final, passes=1)
    errs["fwd_states"] = max(err(states, enters), err(final, fin))
    states.copy_(enters)
    ts._fwd_sm90(x, dt, A, Bm, Cm, y, states, final, passes=2)
    errs["fwd_output"] = err(y, ts.ssd_fwd_output_plain(x, dt, A, Bm, Cm, enters, chunk=chunk))
    del y, states, final
    outs, scratch = ts._bwd_outputs(x, Bm), ts._bwd_scratch(x, Bm)
    dfinal = dfinal.float().contiguous()
    dstate = ts.ssd_dstate_pass_plain(*ts.ssd_bwd_increments_plain(dy, dt, A, Cm, chunk=chunk),
                                      dfinal)
    ts._bwd_sm90(x, dt, A, Bm, Cm, enters, dy, dfinal, outs, scratch, passes=1)
    errs["bwd_states"] = err(scratch[0], dstate)
    scratch[0].copy_(dstate)
    ts._bwd_sm90(x, dt, A, Bm, Cm, enters, dy, dfinal, outs, scratch, passes=6)
    ref = ts.ssd_bwd_grads_plain(x, dt, A, Bm, Cm, enters, dstate, dy, chunk=chunk)
    errs["bwd_grads"] = max(err(o, r) for o, r in zip(outs, ref))
    return errs


def phase_kernels_ssd():
    """B5 (y, entering states, final state) and B6 (dx, ddt, dA, dB, dC, with a
    non-zero final-state cotangent) against their plain versions at every
    SSD_CASES shape in fp32 and bf16 and at the strong-decay draw, the body the
    rule names counted on each launch; on the Hopper body also each pass alone
    against its plain version, and two launches at each path shape
    bit-identical; then the autograd Function through the dispatcher, fp32
    (the first version) and bf16 (the Hopper body). Returns (the errors at each
    path shape (bf16), the worst error of each Hopper pass)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ssd_scan as ts
    gen = torch.Generator(device="cuda").manual_seed(8)
    path_errs, pass_worst = {}, {}
    draws = [(case, dtype, 1.0) for case in SSD_CASES
             for dtype in (torch.float32, torch.bfloat16)]
    draws.append((SSD_DECAY_CASE, torch.bfloat16, SSD_DECAY_SCALE))
    for case, dtype, dt_scale in draws:
        b, l, h, p, g, n, chunk = case
        ins = ssd_inputs(gen, case, dtype, dt_scale)
        body = ts.ssd_body(ins[0], ins[3], ins[4], chunk)
        if body != ("sm90" if dtype == torch.bfloat16 and chunk == 128 else "simt"):
            raise AssertionError(f"the body rule names {body} for {case} {dtype}")
        before, bodies = ssd_counts(), body_counts()
        out = ts.ssd_chunk_scan_fwd(*ins, chunk=chunk, save_enters=True)
        torch.cuda.synchronize()
        ferrs, fok = ssd_check_fwd(ins, chunk, out)
        dy = torch.randn(b, l, h, p, generator=gen, device="cuda").transpose(1, 2)
        dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
        grads = ts.ssd_chunk_scan_bwd(*ins, out[1], dy, dfinal, chunk=chunk)
        torch.cuda.synchronize()
        after = body_counts()
        if (ssd_counts() != (before[0] + 1, before[1] + 1)
                or after[f"ssd_fwd_{body}"] != bodies[f"ssd_fwd_{body}"] + 1
                or after[f"ssd_bwd_{body}"] != bodies[f"ssd_bwd_{body}"] + 1):
            raise AssertionError(f"ssd_chunk_scan_fwd/bwd did not count one {body} launch each")
        berrs, bok = ssd_check_bwd(ins, dy, dfinal, chunk, grads)
        extra, pok = "", True
        if body == "sm90":
            perrs = ssd_pass_errors(ins, dy, dfinal)
            for k, v in perrs.items():
                pass_worst[k] = max(pass_worst.get(k, 0.0), v)
            pok = all(v <= (SSD_Y_TOL if k.startswith("fwd") else SSD_GRAD_TOL)
                      for k, v in perrs.items())
            extra = "; passes " + ", ".join(f"{k} {v:.2e}" for k, v in perrs.items())
        if case in SSD_PATH_CASES.values() and dtype == torch.bfloat16:
            out2 = ts.ssd_chunk_scan_fwd(*ins, chunk=chunk, save_enters=True)
            grads2 = ts.ssd_chunk_scan_bwd(*ins, out2[1], dy, dfinal, chunk=chunk)
            if not all(torch.equal(u, v) for u, v in zip((*out, *grads), (*out2, *grads2))):
                raise AssertionError(f"two launches of the SSD kernels differ on {case}")
            extra += "; two launches bit-identical"
            del out2, grads2
        log(f"check ssd {case} {str(dtype)[6:]}{f' dt x{dt_scale:g}' if dt_scale != 1 else ''} "
            f"({body}): {fmt_ssd(('y', 'enters', 'state'), ferrs)}; "
            f"{fmt_ssd(BWD_NAMES, berrs)}{extra}")
        if not (fok and bok and pok):
            raise AssertionError(f"the SSD kernels disagree with their plain versions "
                                 f"on {case} {dtype}")
        for path, pcase in SSD_PATH_CASES.items():
            if case == pcase and dtype == torch.bfloat16:
                path_errs[path] = (ferrs, berrs)
        del ins, out, dy, dfinal, grads

    # the autograd Function through the dispatcher, model layout, G = 2, ragged,
    # a loss on the final state too, against autograd through the plain dispatch
    for case, dtype in (((2, 200, 4, 64, 2, 128, 128), torch.float32),
                        ((1, 96, 4, 8, 4, 8, 24), torch.float32),
                        ((2, 200, 4, 64, 2, 128, 128), torch.bfloat16)):
        b, l, h, p, g, n, chunk = case
        base = [t.transpose(1, 2).contiguous() if t.dim() > 1 else t
                for t in ssd_inputs(gen, case, dtype)]
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
        log(f"check ssd autograd Function {case} {str(dtype)[6:]}: "
            f"{fmt_ssd(BWD_NAMES, errs)}")
        if not all(ssd_ok(a, e, SSD_GRAD_TOL) for a, e in zip(grads["cuda"], errs)):
            raise AssertionError(f"the SSD autograd Function's grads disagree on {case}")
    log("ssd Hopper passes, worst error: " +
        ", ".join(f"{k} {v:.2e}" for k, v in pass_worst.items()))
    return path_errs, pass_worst


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
    plain versions: the whole call through the body the rule names (the Hopper
    body at every path shape: B5 the wrapper, B6 its launch with the output
    allocation, as the first version was timed), the first version's body on
    the same inputs, and each Hopper pass alone. B5's bytes: x, dt, B, C read once,
    y and the final state (and, under the VJP, the entering states) written;
    B6's: x, dt, B, C, the entering states, dy and dS_final read, its per-head
    fp32 dx, ddt, dda, dB, dC written. Operations at the bf16 tensor-core rate
    (989 TFLOP/s): the inputs arrive in bf16. There is no PyTorch call that
    computes an SSD scan."""
    from repro_torch.kernels import ssd_scan as ts
    res = {}
    (x, dt, A, Bm, Cm), chunk, save = kept["fwd"]
    b, h, l, p = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    nc = -(-l // chunk)
    esz = x.element_size()
    io = esz * (x.numel() + Bm.numel() + Cm.numel()) + 4 * dt.numel()
    dtf, Af = dt.float(), A.float().contiguous()
    y, states, final = ts._fwd_buffers(x, Bm, chunk, states=True)

    def fwd_simt():
        y, enters, final = ts._fwd_buffers(x, Bm, chunk, states=save)
        ts._fwd_simt(x, dtf, Af, Bm, Cm, y, enters, final, chunk)
    units = [("fwd", lambda: ts.ssd_chunk_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk,
                                                   save_enters=save),
              fwd_simt,
              {name: functools.partial(ts._fwd_sm90, x, dtf, Af, Bm, Cm, y, states, final,
                                       passes=bit)
               for name, bit in (("states", 1), ("output", 2))},
              lambda: ts.ssd_chunk_scan_fwd_plain(x, dt, A, Bm, Cm, chunk=chunk),
              ssd_flops(b, l, h, p, n, chunk),
              io + 4 * (x.numel() + b * h * p * n + (b * h * nc * p * n if save else 0)))]
    if "bwd" in kept:
        (xb, dtb, Ab, Bb, Cb, enters, dy, dfinal), chunk_b = kept["bwd"]
        args = (xb, dtb.float(), Ab.float().contiguous(), Bb, Cb, enters.contiguous(),
                dy.float(), dfinal.contiguous(), chunk_b)
        bb, hb, lb, pb = xb.shape
        nb = Bb.shape[3]
        io_b = xb.element_size() * (xb.numel() + Bb.numel() + Cb.numel()) + 4 * dtb.numel()
        outs, scratch = ts._bwd_outputs(xb, Bb), ts._bwd_scratch(xb, Bb)
        dyk = args[6] if ts._rows_aligned(args[6]) else args[6].contiguous()
        units.append(("bwd", lambda: ts._bwd_launch("sm90", *args),
                      lambda: ts._bwd_launch("simt", *args),
                      {name: functools.partial(ts._bwd_sm90, *args[:6], dyk, args[7], outs,
                                               scratch, passes=bit)
                       for name, bit in (("states", 1), ("rows", 2), ("columns", 4))},
                      lambda: ts.ssd_chunk_scan_bwd_plain(xb, dtb, Ab, Bb, Cb, dy, dfinal,
                                                          chunk=chunk_b),
                      ssd_flops(bb, lb, hb, pb, nb, chunk_b, backward=True),
                      io_b + 4 * (enters.numel() + dy.numel() + dfinal.numel()
                                  + xb.numel() + 2 * bb * hb * lb + 2 * bb * hb * lb * nb)))
    for kind, kernel, simt, passes, plain, flops, nbytes in units:
        ms = cuda_ms(kernel, 10)
        simt_ms = cuda_ms(simt, 3, warmup=1)
        pass_ms = {k: cuda_ms(fn, 10) for k, fn in passes.items()}
        plain_ms = cuda_ms(plain, 2, warmup=1)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        shape = list((xb if kind == "bwd" else x).shape)
        res[kind] = {"shape_bhlp": shape, "ms": ms, "first_body_ms": simt_ms, "pass_ms": pass_ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
        log(f"ssd_{kind} at {name} {tuple(shape)}: {ms:.4f} ms (Hopper body; passes "
            + ", ".join(f"{k} {v:.4f}" for k, v in pass_ms.items())
            + f"), first version's body {simt_ms:.4f} ms, bound {res[kind]['bound_ms']:.4f} ms "
            f"({flops:.3e} FLOP, {nbytes / 1e6:.1f} MB, {res[kind]['bound_by']}), "
            f"plain {plain_ms:.4f} ms")
        if ms >= simt_ms:
            raise AssertionError(f"ssd_{kind}'s Hopper body is not faster than the first "
                                 f"version's at {name}: {ms:.4f} vs {simt_ms:.4f} ms")
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
        check_bodies(f"{arch} forward", fwd_launches, f"{arch}_forward")
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
        with SSDCapture() as cap, FlashFwdCapture() as fwd:
            model.forward(params, batch)
        real = cap.summary(f"{arch} forward ({cfg.n_layers} layers)")
        real_fwd = fwd.summary(f"{arch} forward ({apps} attention applications)", apps)
        del fwd
        times = ssd_times(f"{arch} serving", cap.kept)
    return {"b5": fwd_launches[5], "b1": fwd_launches[0], "real": real, "real_fwd": real_fwd,
            "times": times}


def phase_ssm_training(arch, batch_size):
    """The smoke config against the CPU and under the remat modes, then
    ``arch`` at full width and depth (fp32 masters, bf16 compute, remat "full",
    TRAIN_MICRO microbatches of batch_size / TRAIN_MICRO x TRAIN_SEQ): B5 and B6
    (and B2/B3 on the hybrid's attention applications) held to their plain
    versions on every call of one microbatch, B5/B6 timed on them, one warm-up
    and TRAIN_STEPS timed steps with the launches counted, a profile."""
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
    apps = n_apps(cfg)
    with SSDCapture() as cap, FlashBwdCapture() as attn, FlashFwdCapture() as fwd:
        loss, _ = make_loss_fn(model, Hyper())(params, mb)
        loss.backward()
    real = cap.summary(f"{arch} training microbatch ({cfg.n_layers} layers)")
    real_attn = attn.summary(f"{arch} training microbatch ({apps} attention applications)",
                             apps)
    real_fwd = fwd.summary(f"{arch} training microbatch ({apps} attention applications)", apps)
    del attn, fwd
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
        check_bodies(f"{arch} train step {i}", launches, f"{arch}_train_step")
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
    return {"launches": launches, "real": real, "real_attn": real_attn, "real_fwd": real_fwd,
            "times": times}


# ---------------------------------------------------------------------------
# whisper-small: the encoder-decoder (B1 on non-causal and cross shapes; B2/B3
# in training) and checkpointing of its training state


def encdec_smoke_agreement():
    """The whisper smoke config on the card (kernels) against the same weights
    on the CPU (plain path), fp32: forward logits, then fill_cross and 9 decode
    steps, to 1e-4."""
    from repro_torch.core import ParallelPlan, get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config(WHISPER_ARCH)
    plan = ParallelPlan(compute_dtype="float32")
    gpu, cpu = build_model(cfg, plan), build_model(cfg, plan, device="cpu")
    cparams = cpu.init(torch.Generator().manual_seed(1))
    params = to_cuda(cparams)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=gen)
    frames = torch.randn(2, cfg.enc_frames, cfg.d_model, generator=gen)
    with torch.no_grad():
        before = all_counts()[0]
        lg = gpu.forward(params, {"tokens": tokens.cuda(), "frames": frames.cuda()})[0]
        if all_counts()[0] != before + cfg.enc_layers + 2 * cfg.n_layers:
            raise AssertionError("the smoke forward did not run B1 on every attention call")
        errs = [(lg.cpu() - cpu.forward(cparams, {"tokens": tokens, "frames": frames})[0])
                .abs().max().item()]
        cache = gpu.fill_cross(params, gpu.init_cache(2, 9), frames.cuda())
        ccache = cpu.fill_cross(cparams, cpu.init_cache(2, 9), frames)
        for pos in range(9):
            lg, cache = gpu.decode_step(params, cache, tokens[:, pos].cuda(), pos)
            clg, ccache = cpu.decode_step(cparams, ccache, tokens[:, pos], pos)
            errs.append((lg.cpu() - clg).abs().max().item())
    log(f"smoke {WHISPER_ARCH} fp32, card vs cpu: max logit diff {max(errs):.3e} "
        f"(forward, then fill_cross and 9 decode steps)")
    if max(errs) > 1e-4:
        raise AssertionError("the card's smoke-config logits disagree with the CPU's")


def phase_whisper_serving():
    """whisper-small at full width and depth, random bf16 weights from a seed:
    the smoke config against the CPU; fill_cross over WHISPER_BATCH x 1500
    frames (B1 12 launches, one per encoder layer), a WHISPER_PROMPT-token
    prompt through decode_step, then DECODE_STEPS greedy steps (B1 12 a step:
    the cross-attention at S = 1); profiles; B1 held to its plain version on
    every encoder layer's own inputs and every decoder layer's cross-attention
    of one decode step."""
    from repro_torch.core import InputShape, ParallelPlan, get_config, leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model

    encdec_smoke_agreement()
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg, ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"init {WHISPER_ARCH}: {n_params / 1e6:.2f} M params (bf16; param_count "
        f"{cfg.param_count() / 1e6:.2f} M, which leaves out the two final norms) in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ds = SyntheticDataset(cfg, InputShape("whisper_serve", WHISPER_PROMPT, WHISPER_BATCH,
                                          "decode"))
    batch = {k: torch.from_numpy(v).cuda() for k, v in ds.batch(0).items()}
    frames, prompt = batch["frames"], batch["tokens"]

    def serve_prompt():
        cache = model.fill_cross(params, model.init_cache(WHISPER_BATCH, WHISPER_MAX_SEQ),
                                 frames)
        for t in range(WHISPER_PROMPT):
            lg, cache = model.decode_step(params, cache, prompt[:, t], t)
        return lg, cache

    with torch.no_grad():
        serve_prompt()                                              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cache = model.init_cache(WHISPER_BATCH, WHISPER_MAX_SEQ)
        reset_counts()
        t0 = time.perf_counter()
        model.fill_cross(params, cache, frames)
        torch.cuda.synchronize()
        t_fill = time.perf_counter() - t0
        fill_launches = all_counts()
        if fill_launches != (cfg.enc_layers, 0, 0, 0, 0):
            raise AssertionError(f"fill_cross launched B1, B2, B3, B4 {fill_launches}, "
                                 f"expected {cfg.enc_layers} B1")
        check_bodies(f"{WHISPER_ARCH} fill_cross", fill_launches, "whisper_fill_cross")
        if not (torch.isfinite(cache["cross_k"]).all() and torch.isfinite(cache["cross_v"]).all()):
            raise AssertionError("the cross keys or values are not finite")
        for t in range(WHISPER_PROMPT):
            lg, cache = model.decode_step(params, cache, prompt[:, t], t)
        tok = lg.argmax(-1)
        reset_counts()
        t0 = time.perf_counter()
        out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
        for i in range(DECODE_STEPS):
            lg, cache = model.decode_step(params, cache, tok, WHISPER_PROMPT + i)
            finite &= torch.isfinite(lg).all()
            tok = lg.argmax(-1)
            out.append(tok)
        torch.cuda.synchronize()
        t_decode = (time.perf_counter() - t0) / DECODE_STEPS
        decode_launches = all_counts()
        if decode_launches != (cfg.n_layers * DECODE_STEPS, 0, 0, 0, 0):
            raise AssertionError(f"{DECODE_STEPS} decode steps launched B1, B2, B3, B4 "
                                 f"{decode_launches}, expected {cfg.n_layers} B1 a step")
        check_bodies(f"{WHISPER_ARCH} {DECODE_STEPS} decode steps", decode_launches,
                     "whisper_decode")
        if not finite:
            raise AssertionError(f"{WHISPER_ARCH} decode logits are not finite")
        peak = torch.cuda.max_memory_allocated()
        n_frames = WHISPER_BATCH * cfg.enc_frames
        log(f"serving {WHISPER_ARCH}: fill_cross {WHISPER_BATCH} x {cfg.enc_frames} frames "
            f"in {t_fill * 1e3:.2f} ms = {n_frames / t_fill:.0f} encoder frames/s; decode "
            f"{t_decode * 1e3:.2f} ms/step (batch {WHISPER_BATCH}, max_seq {WHISPER_MAX_SEQ}); "
            f"peak memory {peak / 1e9:.2f} GB; B1 launches {fill_launches[0]} per fill_cross, "
            f"{decode_launches[0] // DECODE_STEPS} per decode step")
        log(f"generated tokens, row 0: {torch.stack(out, 1)[0, :10].tolist()}")
        pos = WHISPER_PROMPT + DECODE_STEPS
        profile_window(f"{WHISPER_ARCH} decode step", lambda: model.decode_step(
            params, cache, tok, pos))
        profile_window(f"{WHISPER_ARCH} fill_cross", lambda: model.fill_cross(
            params, cache, frames))
        with FlashFwdCapture() as enc:
            model.fill_cross(params, cache, frames)
        real_enc = enc.summary(f"{WHISPER_ARCH} fill_cross ({cfg.enc_layers} encoder layers)",
                               cfg.enc_layers)
        with FlashFwdCapture() as cross:
            model.decode_step(params, cache, tok, pos)
        real_cross = cross.summary(f"{WHISPER_ARCH} decode step ({cfg.n_layers} "
                                   f"cross-attentions at S = 1)", cfg.n_layers)
    return {"fill_b1": fill_launches[0], "decode_b1": decode_launches[0],
            "real_fwd": max(real_enc, real_cross)}


def whisper_train_setup():
    """whisper-small's full-width training model (fp32 masters, bf16 compute,
    remat "full", TRAIN_MICRO microbatches), its params from seed 0 as
    autograd leaves, and train_4k batches of WHISPER_TRAIN_BATCH sequences with
    their frames."""
    from repro_torch.core import InputShape, ParallelPlan, get_config, leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    cfg = get_config(WHISPER_ARCH)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    model = build_model(cfg, plan)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, WHISPER_TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(TRAIN_STEPS + 2)]
    return cfg, plan, model, params, batches


def phase_whisper_training():
    """The smoke config against the CPU and under the remat modes, then
    whisper-small at full width and depth: B1/B2/B3 held to their plain
    versions on every call of one microbatch, one warm-up and TRAIN_STEPS timed
    steps with the launches counted (B1 144, B2 72, B3 72 a step), a profile."""
    from repro_torch.core import leaves
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.core.tree import map_tree
    from repro_torch.train import Hyper, TrainState, make_loss_fn, make_train_step

    timed(f"{WHISPER_ARCH} smoke training", train_smoke_agreement, WHISPER_ARCH)
    t0 = time.perf_counter()
    cfg, plan, model, params, batches = whisper_train_setup()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"init {WHISPER_ARCH}: {n_params / 1e6:.2f} M params (fp32; param_count "
        f"{cfg.param_count() / 1e6:.2f} M) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    attn_calls = cfg.enc_layers + 2 * cfg.n_layers         # per forward of a microbatch
    mb = {k: v[:WHISPER_TRAIN_BATCH // TRAIN_MICRO] for k, v in batches[0].items()}
    with FlashBwdCapture(fp64=True) as bwd, FlashFwdCapture() as fwd:
        loss, _ = make_loss_fn(model, Hyper())(params, mb)
        loss.backward()
    real_bwd = bwd.summary(f"{WHISPER_ARCH} training microbatch", attn_calls)
    real_fwd = fwd.summary(f"{WHISPER_ARCH} training microbatch (forward and recompute)",
                           2 * attn_calls)
    del bwd, fwd
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
    want = (2 * TRAIN_MICRO * attn_calls, TRAIN_MICRO * attn_calls, TRAIN_MICRO * attn_calls,
            0, 0)
    times, launches = [], None
    for i in range(TRAIN_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batches[1 + i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = all_counts()
        log(f"{WHISPER_ARCH} train step {i}: {times[-1] * 1e3:.1f} ms, loss {loss:.6f}, "
            f"grad_norm {gnorm:.6f}, launches B1/B2/B3/B4 rows/B4 contract {launches}")
        if launches != want:
            raise AssertionError(f"a {WHISPER_ARCH} train step launched {launches}, "
                                 f"expected {want}")
        check_bodies(f"{WHISPER_ARCH} train step {i}", launches, "whisper_train_step")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"the {WHISPER_ARCH} train step's loss or grad norm is "
                                 f"not finite")
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(times) / len(times)
    tokens = WHISPER_TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens)
    log(f"training {WHISPER_ARCH} full width and depth ({WHISPER_TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens and {WHISPER_TRAIN_BATCH} x {cfg.enc_frames} frames, microbatches "
        f"{TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms (mean of {TRAIN_STEPS}), "
        f"{tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} FLOP/step, mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    timed(f"{WHISPER_ARCH} train step profile", profile_window, f"{WHISPER_ARCH} train step",
          lambda: step(state, batches[-1]))
    return {"launches": launches, "real_bwd": real_bwd, "real_fwd": real_fwd,
            "step_ms": [t * 1e3 for t in times]}


def host_named(tree):
    """{name: host numpy array} of a state in the checkpoint's layout (layer
    lists stacked, bf16 as its bits), through the store's blocking host copy."""
    from repro_torch.checkpoint import store
    from repro_torch.core.tree import named_leaves
    return {n: store._host(x)[0] for n, x in named_leaves(tree)}


def phase_whisper_checkpoint():
    """A checkpoint round trip of whisper-small's full-width training state in
    a temporary directory under build/ (removed after): 2 steps; the state as
    saved copied to the host (host_named) and into the RAM tier; an async
    save; steps 3 and 4 while the copy drains; a second save with steps 5 and
    6 under it (the pinned and staging buffers reused); a third save, from a
    new manager, with the card's free memory filled while it sizes its
    staging so that only half the state takes it and the other half is
    copied straight from the live tensors before the fence, with steps 7 and
    8 under it; steps 6 and 2 restored into a freshly built
    state, each of which must equal the state as saved bit for bit; steps 3
    and 4 again from step 2, whose losses must equal the uninterrupted run's
    to 1e-6 relative; the RAM tier restored after lose_group and compared
    too."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, MemoryCheckpointTier, store
    from repro_torch.optim import adamw_init
    from repro_torch.train import Hyper, TrainState, init_train_state, make_train_step

    cfg, plan, model, params, batches = whisper_train_setup()
    state = TrainState(params, adamw_init(params))
    del params
    step = make_train_step(model, plan, Hyper())
    for i in range(2):
        state, m = step(state, batches[i])
    saved = host_named(state)
    nbytes = sum(a.nbytes for a in saved.values())
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    try:
        mem = MemoryCheckpointTier(keep=1, groups=2)
        mem.save(2, state)
        mgr = CheckpointManager(tmp, keep=2, async_snapshot=True)

        def save_then_steps(mgr, step_no, batch_ids, leave_free=None):
            """save(step_no) with the copy draining under the steps of
            ``batch_ids``: (stall, fence, copy to host after it, persist
            seconds, bytes, the steps' ms and losses, bytes staged). With
            ``leave_free``, all of the card's free memory but HEADROOM and
            ``leave_free`` bytes is held while the save sizes its staging."""
            nonlocal state
            filler = None
            if leave_free is not None:
                torch.cuda.empty_cache()
                filler = torch.empty(torch.cuda.mem_get_info()[0] - store.HEADROOM - leave_free,
                                     dtype=torch.uint8, device="cuda")
            mgr.save(step_no, state)
            del filler
            stall = mgr.snapshot_seconds
            ms, losses = [], []
            for i in batch_ids:
                t0 = time.perf_counter()
                state, m = step(state, batches[i % len(batches)])
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            mgr.wait()
            return (stall, mgr.fence_seconds, mgr.d2h_seconds, mgr.persist_seconds,
                    mgr.bytes_written, ms, losses, mgr.staged_bytes)

        first = save_then_steps(mgr, 2, (2, 3))    # the buffers are allocated here
        losses = first[6]
        again = save_then_steps(mgr, 4, (4, 5))
        saved6 = host_named(state)
        bounded_mgr = CheckpointManager(Path(tmp) / "bounded", keep=1, async_snapshot=True)
        bounded = save_then_steps(bounded_mgr, 6, (6, 7), leave_free=nbytes // 2)
        if not 0 < bounded[7] < nbytes - 4:          # both routes ran (4: opt/step)
            raise AssertionError(f"staging with ~{nbytes // 2} bytes free took {bounded[7]}")
        for name, (stall, fence, d2h, persist, written, ms, _, staged) in (
                ("first", first), ("second", again), ("bounded", bounded)):
            log(f"checkpoint {WHISPER_ARCH} train state, {name} async save ({nbytes / 1e9:.3f} "
                f"GB, {len(saved)} leaves, {staged / 1e9:.3f} GB staged on the card, "
                f"{(nbytes - staged) / 1e9:.3f} GB copied straight to the host before the "
                f"fence): main thread stalled {stall * 1e3:.2f} ms; fence {fence * 1e3:.2f} ms "
                f"on the side stream (the main stream waits on it); the staged leaves' copy to "
                f"pinned host memory after it {d2h * 1e3:.2f} ms = "
                f"{staged / max(d2h, 1e-9) / 1e9:.2f} GB/s; persist {persist:.2f} s, "
                f"{written / 1e9:.3f} GB written; the two steps while it drained "
                f"{ms[0]:.1f} / {ms[1]:.1f} ms")
        log(f"the RAM tier's blocking snapshot: {mem.snapshot_seconds:.2f} s")

        fresh = init_train_state(model, torch.Generator(device="cuda").manual_seed(7))
        _, fresh = bounded_mgr.restore(fresh, step=6)
        got = host_named(fresh)
        same = fresh.opt.step == 6 and all(np.array_equal(got[n], saved6[n]) for n in saved6)
        log(f"restore of step 6, saved with bounded staging: every leaf equal to the state "
            f"as saved bit for bit: {same}")
        if not same:
            raise AssertionError("the state saved with bounded staging came back different")
        del saved6, got
        t0 = time.perf_counter()
        got_step, fresh = mgr.restore(fresh, step=2)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        got = host_named(fresh)
        same = (got_step == 2 and fresh.opt.step == 2 and list(got) == list(saved)
                and all(np.array_equal(got[n], saved[n]) for n in saved))
        log(f"restore of step 2 from disk (every digest verified): {t_restore:.2f} s; every "
            f"leaf equal to the saved state bit for bit (opt.step {fresh.opt.step} "
            f"included): {same}")
        if not same:
            raise AssertionError("the restored state differs from the saved one")

        resumed = []
        for i in (2, 3):
            fresh, m = step(fresh, batches[i])
            resumed.append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses))
        log(f"steps 3-4 resumed from the checkpoint: losses {resumed} vs uninterrupted "
            f"{losses}: max relative difference {rel:.3e}, bit-identical {resumed == losses}")
        if rel > 1e-6:
            raise AssertionError("the resumed steps' losses differ from the uninterrupted run's")

        lost = mem.lose_group(0)
        _, fresh = mem.restore(fresh)
        got = host_named(fresh)
        same = all(np.array_equal(got[n], saved[n]) for n in saved)
        log(f"RAM tier after lose_group(0) ({lost} buffers lost): restore "
            f"{mem.restore_seconds:.2f} s, {mem.last_rebuild} members rebuilt from the "
            f"mirror (verified), equal to the saved state: {same}")
        if not same or not mem.last_rebuild:
            raise AssertionError("the RAM tier did not rebuild the saved state")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    saves = {name: {"stall_ms": r[0] * 1e3, "fence_ms": r[1] * 1e3, "d2h_ms": r[2] * 1e3,
                    "persist_s": r[3], "bytes": r[4], "steps_ms_while_draining": r[5],
                    "staged_bytes": r[7]}
             for name, r in (("first_save", first), ("second_save", again),
                             ("bounded_save", bounded))}
    return {**saves, "restore_s": t_restore, "ram_tier_snapshot_s": mem.snapshot_seconds,
            "ram_tier_restore_s": mem.restore_seconds, "resumed_rel": rel,
            "bit_identical": resumed == losses}


# ---------------------------------------------------------------------------
# fault tolerance (phase 13): the seams, the chaos schedule and a preemption

# whisper-small at full width and depth under run_with_recovery: the training
# phase's plan with the batch cut to FT_BATCH x TRAIN_SEQ tokens (FT_BATCH x 1500
# frames, TRAIN_MICRO microbatches), FT_STEPS steps, a checkpoint every FT_EVERY.
# Each checkpoint of the 4.0 GB train state writes 4.0 GB to the machine's disk,
# whose writes a call may not take past 45 GiB (deleted files count): the chaos
# run's 11 steps save 4 (0, 4, the dropped 8, 8 again), and the preemption run
# resumes from its last one, so the phase writes 5 and the script 10.
FT_STEPS, FT_BATCH, FT_EVERY = 11, 4, 4
# the chaos schedule (tests/test_chaos.py's single-process schedule without its
# sdc entry, scaled to FT_STEPS): a train.step spike x8 at 5, kernel.attention
# NaN'd on every call at 6 and 9, the step-8 shard write dropped (so the restore
# at 9 skips it for 4), a host hang at 10 that must pass both the Monitor's
# floor and 5x the median step (~0.27 s at this batch)
FT_SPIKE_AT, FT_NAN_AT, FT_DROP_AT, FT_HANG_AT = 5, (6, 9), 8, 10
FT_HANG_S, FT_HANG_MIN_S = 4.0, 2.5
FT_ACTIONS = [(FT_SPIKE_AT, "spike", "rollback"), (FT_NAN_AT[0], "nan", "rollback"),
              (FT_NAN_AT[1], "nan", "rollback"), (FT_HANG_AT, "hang", "ignore")]
# a real SIGTERM during step 9 of a run resumed from the chaos run's step-8
# checkpoint: the driver stops before step 10; the policy's default grace
FT_PREEMPT_AT, FT_GRACE = 9, 30.0


def ft_seam_checks():
    """Each tainted dispatcher on the card: unarmed, the undecorated call's
    bits (B1 at whisper's encoder shape, B4 and B5 at smoke shapes of their
    case lists); armed with nan (every call), exactly one NaN, at the index the
    CPU computes from the spec; every launch on its Hopper body."""
    from repro_torch.ft import inject
    from repro_torch.kernels import dispatch
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq, hkv, s, t, hd = WHISPER_CASES["encoder"][:6]
    q, k, v = (batch_major(gen, b, h, n, hd, torch.bfloat16).transpose(1, 2)
               for h, n in ((hq, s), (hkv, t), (hkv, t)))
    x, w, _, gs = gemm_case_inputs(GEMM_CASES[6], torch.bfloat16, gen)
    ssd_case = SSD_CASES[9]
    xs, dt, A, B, C = (a.transpose(1, 2) if a.dim() > 1 else a
                       for a in ssd_inputs(gen, ssd_case, torch.bfloat16))
    seams = {
        "kernel.attention": (dispatch.dispatch_attention, (q, k, v),
                             dict(impl="cuda", causal=False)),
        "kernel.expert_gemm": (dispatch.dispatch_expert_gemm, (x, w, gs), dict(impl="cuda")),
        "kernel.ssd": (dispatch.dispatch_ssd_scan, (xs, dt, A, B, C),
                       dict(chunk=ssd_case[6], impl="cuda")),
    }
    first = lambda o: o[0] if isinstance(o, tuple) else o          # noqa: E731
    out = {}
    for i, (point, (fn, args, kw)) in enumerate(seams.items()):
        reset_counts()
        raw = first(fn.__wrapped__(*args, **kw))
        unarmed = first(fn(*args, **kw))
        spec = inject.FaultSpec(point, "nan", step=3 + i, tick=None)
        bad = first(inject.trace_with_faults(lambda: fn(*args, **kw), specs=[spec])())
        torch.cuda.synchronize()
        where = torch.isnan(bad).reshape(-1).nonzero().flatten().tolist()
        want = spec.key() % raw.numel()
        counts = all_counts() + ssd_counts()
        check_bodies(f"seam {point}", counts)
        launched = {"kernel.attention": counts[0], "kernel.expert_gemm": counts[3],
                    "kernel.ssd": counts[5]}[point]
        out[point] = {"unarmed_equal": torch.equal(raw, unarmed),
                      "nan_at": where, "cpu_index": want, "launches": launched}
        log(f"seam {point}: unarmed equal to the undecorated call {out[point]['unarmed_equal']}; "
            f"armed nan at {where} (the CPU's index {want}); {launched} launches for the "
            f"3 calls")
        if not (out[point]["unarmed_equal"] and where == [want] and launched == 3
                and not torch.isnan(raw).any()):
            raise AssertionError(f"the {point} seam: {out[point]}")
        del raw, unarmed, bad
    return out


def ft_counted(fn, calls):
    """``fn`` counting its calls in ``calls["n"]``."""
    def run(state, batch):
        calls["n"] += 1
        return fn(state, batch)
    return run


def ft_timed_restores(mgr, out):
    """``mgr.restore`` recording (step asked, seconds) of every call in ``out``,
    the corrupt checkpoints a fallback skips included."""
    real = mgr.restore

    def restore(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            out.append((kw.get("step"), time.perf_counter() - t0))
    mgr.restore = restore
    return mgr


def ft_restore_readings(flight):
    """Each restore of a flight log: its step, tier and the seconds from the
    policy decision to the restored state (the time to recover, the wait for a
    pending persist and the corrupt checkpoints skipped included)."""
    out, decided = [], None
    for e in flight.events:
        if e["kind"] == "policy":
            decided = e["t"]
        elif e["kind"] == "restore" and decided is not None:
            out.append({"step": e["step"], "tier": e["tier"], "s": e["t"] - decided})
            decided = None
    return out


def ft_same(a, b):
    """Whether two train states hold the same bits in every tensor (and the
    same optimizer step)."""
    from repro_torch.core.tree import leaves
    return a.opt.step == b.opt.step and all(torch.equal(x, y) for x, y in zip(leaves(a.params) + leaves(a.opt.mu)
                                                 + leaves(a.opt.nu),
                                                 leaves(b.params) + leaves(b.opt.mu)
                                                 + leaves(b.opt.nu)))


def phase_whisper_ft():
    """whisper-small at full width and depth through ``run_with_recovery``: the
    seams (``ft_seam_checks``), a clean run of FT_STEPS steps, the chaos
    schedule (FT_ACTIONS, 3 restores, 1 corrupt checkpoint skipped), which must
    end equal to the clean run bit for bit, losses included; a run resumed
    from the chaos run's last checkpoint with a real SIGTERM at FT_PREEMPT_AT
    (a just-in-time snapshot on the tier ``choose_tier`` picks, the PREEMPTED
    marker, a flight dump), then a resume in a fresh manager that consumes the
    marker and ends equal to the clean run bit for bit; every
    step's B1/B2/B3 launches counted on the Hopper bodies; then the audit's
    cost: 3 steps with ``integrity="audit"`` against 3 without."""
    import shutil
    import signal
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import InputShape, ParallelPlan, RecoveryPolicy, get_config
    from repro_torch.core.tree import map_tree
    from repro_torch.data import SyntheticDataset
    from repro_torch.ft import FlightRecorder, Monitor, PreemptionGuard, run_with_recovery
    from repro_torch.ft.inject import FaultSpec, armed, make_injector, trace_with_faults
    from repro_torch.ft.integrity import audit
    from repro_torch.ft.preempt import read_marker
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, init_train_state, make_train_step

    seams = ft_seam_checks()
    cfg = get_config(WHISPER_ARCH)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    log(f"fault tolerance: {WHISPER_ARCH} at full width and depth; cut: the batch "
        f"{WHISPER_TRAIN_BATCH} -> {FT_BATCH} x {TRAIN_SEQ} tokens ({FT_BATCH} x "
        f"{cfg.enc_frames} frames), {FT_STEPS} steps")
    model = build_model(cfg, plan)
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, FT_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(FT_STEPS)]
    fresh = lambda: init_train_state(model, torch.Generator(device="cuda").manual_seed(0))  # noqa: E731
    calls = {"n": 0}
    step = ft_counted(make_train_step(model, plan, Hyper()), calls)
    attn_calls = cfg.enc_layers + 2 * cfg.n_layers
    per_step = (2 * TRAIN_MICRO * attn_calls, TRAIN_MICRO * attn_calls,
                TRAIN_MICRO * attn_calls, 0, 0)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ft_", dir=ROOT / "build"))
    try:
        reset_counts()
        clean, losses, ms = fresh(), [], []
        for i in range(FT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clean, m = step(clean, batches[i])
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"clean run: {FT_STEPS} steps, {[round(x, 1) for x in ms]} ms, losses {losses}")

        flight = FlightRecorder(maxlen=1024, path=str(tmp / "chaos_flight.json"))
        disk_restores = []
        ckpt = ft_timed_restores(CheckpointManager(tmp / "chaos", keep=3, async_snapshot=True),
                                 disk_restores)
        nan_twin = trace_with_faults(step, specs=[
            FaultSpec("kernel.attention", "nan", step=FT_NAN_AT[0], tick=None)])
        used = set()

        def fault_step_fn(s):
            if s in FT_NAN_AT and s not in used:
                used.add(s)
                return nan_twin
            return None

        injector = make_injector([
            FaultSpec("train.step", "spike", step=FT_SPIKE_AT, scale=8.0),
            FaultSpec("train.step", "hang", step=FT_HANG_AT, sleep_s=FT_HANG_S)])
        t0 = time.perf_counter()
        with armed([FaultSpec("ckpt.shard_write", "drop_write", step=FT_DROP_AT)]):
            chaos, report = run_with_recovery(
                fresh(), step, lambda s: batches[s], FT_STEPS, ckpt,
                Monitor(min_history=4, hang_min_seconds=FT_HANG_MIN_S),
                ckpt_every=FT_EVERY, plan=plan, fault_injector=injector,
                fault_step_fn=fault_step_fn, policy=RecoveryPolicy(max_restores=8),
                flight=flight)
        chaos_s = time.perf_counter() - t0
        chaos_calls = calls["n"] - FT_STEPS
        restores = ft_restore_readings(flight)
        chaos_ok = {
            "actions": report.actions == FT_ACTIONS,
            "restores": report.restores == 3,
            "ckpt_fallbacks": report.ckpt_fallbacks == 1,
            "ckpt_corrupt_noted": any(a.kind == "ckpt_corrupt" for a in report.anomalies),
            "losses_bit_equal": report.losses == losses,
            "state_bit_equal": ft_same(chaos, clean),
        }
        log(f"chaos run: actions {report.actions}, restores {report.restores}, fallbacks "
            f"{report.ckpt_fallbacks}, anomalies {[(a.kind, a.step) for a in report.anomalies]}, "
            f"{chaos_calls} steps run in {chaos_s:.1f} s; restores {restores}; disk reads "
            f"{[(s, round(t, 2)) for s, t in disk_restores]}; checks {chaos_ok}")
        del chaos

        pflight = FlightRecorder(maxlen=256, path=str(tmp / "preempt_flight.json"))
        pdir = tmp / "chaos"
        pckpt = CheckpointManager(pdir, keep=3, async_snapshot=True, flight=pflight)
        resumed_from = pckpt.latest_step()
        if not resumed_from < FT_PREEMPT_AT:
            raise AssertionError(f"the chaos run left step {resumed_from} to resume from")

        def deliver(s, st):
            if s == FT_PREEMPT_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            return st

        quiet = lambda: Monitor(min_history=1000, hang_min_seconds=600.0)  # noqa: E731
        t0 = time.perf_counter()
        with PreemptionGuard(grace=FT_GRACE) as guard:
            mid, prep = run_with_recovery(
                fresh(), step, lambda s: batches[s], FT_STEPS, pckpt, quiet(),
                ckpt_every=FT_EVERY, plan=plan, fault_injector=deliver, preempt=guard,
                flight=pflight, resume=True)
        preempt_s = time.perf_counter() - t0
        marker = read_marker(pdir)
        exit_s = time.time() - guard.at_time if guard.at_time else None
        jit_s = pckpt.snapshot_seconds + pckpt.persist_seconds
        resume_reads = []
        resumed_ckpt = ft_timed_restores(CheckpointManager(pdir, keep=3, async_snapshot=True),
                                         resume_reads)
        t0 = time.perf_counter()
        resumed, rrep = run_with_recovery(
            mid, step, lambda s: batches[s], FT_STEPS, resumed_ckpt, quiet(),
            ckpt_every=FT_EVERY, plan=plan, resume=True)
        resume_s = time.perf_counter() - t0
        preempt_ok = {
            "preempted": prep.preempted and prep.preempt_step == FT_PREEMPT_AT + 1,
            "marker": marker is not None and marker["step"] == FT_PREEMPT_AT + 1
            and marker["signum"] == signal.SIGTERM,
            "flight_dumped": prep.flight_path is not None and Path(prep.flight_path).exists(),
            "marker_consumed": read_marker(pdir) is None,
            "resumed_to_end": rrep.steps_done == FT_STEPS and not rrep.preempted,
            "losses_bit_equal": (prep.losses[resumed_from:] + rrep.losses[FT_PREEMPT_AT + 1:]
                                 == losses[resumed_from:]),
            "state_bit_equal": ft_same(resumed, clean),
        }
        tier = marker["tier"] if marker else None
        log(f"preemption: resumed from step {resumed_from}, SIGTERM during step "
            f"{FT_PREEMPT_AT}, stopped at "
            f"{prep.preempt_step}; the just-in-time snapshot on {tier}: {jit_s:.2f} s (stall "
            f"{pckpt.snapshot_seconds:.2f} + persist {pckpt.persist_seconds:.2f}); signal to "
            f"exit {exit_s:.2f} s (a pending persist's fence included); run {preempt_s:.1f} "
            f"s; resume (disk reads {[(s, round(t, 2)) for s, t in resume_reads]}) "
            f"{resume_s:.1f} s; checks {preempt_ok}")
        del mid, resumed
        total = calls["n"]
        launches = all_counts()
        want = tuple(total * c for c in per_step)
        log(f"fault-tolerance runs: {total} steps, launches B1/B2/B3/B4 rows/B4 contract "
            f"{launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"the fault-tolerance runs launched {launches}, expected {want}")
        check_bodies("whisper fault-tolerance runs", launches, "whisper_ft")

        audit_plan = dataclasses.replace(plan, integrity="audit")
        timing = {}
        for name, p in (("off", plan), ("audit", audit_plan)):
            st, ms_p = make_train_step(model, p, Hyper()), []
            for i in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                clean, m = st(clean, batches[i])
                float(m["loss"])
                torch.cuda.synchronize()
                ms_p.append((time.perf_counter() - t0) * 1e3)
            timing[name] = ms_p
        audit_div = float(m["integrity_div"])
        grads = map_tree(lambda p: p.grad, clean.params)
        audit_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            int(audit(clean.params, grads)[0])
            audit_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"audit, one process: steps off {[round(x, 1) for x in timing['off']]} ms, audit "
            f"{[round(x, 1) for x in timing['audit']]} ms; the audit alone "
            f"{[round(x, 2) for x in audit_ms]} ms; integrity_div {audit_div}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = {k: v for k, v in {**chaos_ok, **{f"preempt_{k}": v for k, v in preempt_ok.items()},
                             "audit_div": audit_div == 0.0}.items() if not v}
    if bad:
        raise AssertionError(f"fault-tolerance phase: failed {sorted(bad)}")
    return {
        "batch": [FT_BATCH, TRAIN_SEQ], "steps": FT_STEPS, "seams": seams,
        "clean_step_ms": ms, "clean_losses": losses,
        "chaos": {"actions": report.actions, "restores": report.restores,
                  "ckpt_fallbacks": report.ckpt_fallbacks, "steps_run": chaos_calls,
                  "seconds": chaos_s, "restores_by_tier": restores,
                  "disk_reads": disk_restores, "checks": chaos_ok},
        "preempt": {"tier": tier, "preempt_step": prep.preempt_step, "seconds": preempt_s,
                    "jit_snapshot_s": jit_s, "signal_to_exit_s": exit_s, "resume_s": resume_s,
                    "resume_reads": resume_reads, "checks": preempt_ok},
        "launches": launches, "audit": {"steps_off_ms": timing["off"],
                                        "steps_audit_ms": timing["audit"],
                                        "audit_alone_ms": audit_ms, "div": audit_div},
    }


# ---------------------------------------------------------------------------
# data parallelism with ZeRO-1 (phase 14)

# Two ranks on the one card. NCCL refuses two ranks on one device, so they
# join a gloo group: the host transport (launch/mesh.py), every collective
# through host copies. Each rank takes DP_MICRO microbatches of its rows; one
# device's step on the same global batch runs DP_RANKS x DP_MICRO, so every
# microbatch holds the same rows in both runs and only the order of the fp32
# sums differs. One more process runs the same code through a real NCCL
# communicator at world size 1.
DP_RANKS, DP_MICRO, DP_STEPS = 2, 2, 4
DP_WATCHED = 2                    # the first steps, watched by ZeroWatch; the rest timed
DP_REL = 1e-6                     # ROADMAP's rule for parallel against one device
DP_TOLERANCE = ("the first step (the same params in both runs): loss and grad norm to "
                "1e-6 relative, grads to 1e-6 of each leaf's max |value|; each watched "
                "ZeRO-1 update to 1e-6 of each leaf's max against adamw_update on the "
                "same whole grads. Later steps' loss and grad norm and the params after "
                "DP_STEPS steps are readings, set beside the same readings between two "
                "sum orders of one device (dp_failures)")


def rel_err(a, b) -> float:
    """max |a - b| in units of b's max |value| (numpy or torch)."""
    a, b = (np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.detach().float() for x in (a, b))
    if isinstance(a, torch.Tensor):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


class ZeroWatch:
    """Watches the train step's optimizer call (patched in ``train.step`` while
    the watch is entered) on the first ``steps`` steps. ``grads`` holds the
    first step's grads as the optimizer gets them (clipped), whole (gathered
    over the ranks under a mesh), by name in stacked layout on the host. Under
    a mesh with ``shadow``, a copy of the params is updated by
    ``adamw_update`` on the same whole grads beside each watched ZeRO-1
    update, and ``shadow_err[i]`` is their largest difference over the leaves,
    in units of each leaf's max |value|: the ZeRO-1 update checked apart from
    the sum order of the grads."""

    def __init__(self, steps=1, shadow=False):
        self.steps, self.shadow = steps, shadow
        self.grads, self.shadow_err, self.calls = None, [], 0
        self._params = self._opt = None

    def __enter__(self):
        from repro_torch.train import step as step_mod
        self._mod = step_mod
        self._real = (step_mod.adamw_update, step_mod.adamw_update_sharded)
        step_mod.adamw_update, step_mod.adamw_update_sharded = self._single, self._sharded
        return self

    def __exit__(self, *exc):
        self._mod.adamw_update, self._mod.adamw_update_sharded = self._real
        self._params = self._opt = None

    def _keep(self, named):
        from repro_torch.checkpoint import store
        if self.calls == 0:
            self.grads = {n: store._host(x)[0] for n, x in named}

    def _single(self, grads, opt, params, lr, **kw):
        from repro_torch.core.tree import named_leaves
        self._keep(named_leaves(grads))
        self.calls += 1
        return self._real[0](grads, opt, params, lr, **kw)

    def _sharded(self, grads, opt, params, lr, *, mesh, specs, **kw):
        from repro_torch.checkpoint import store
        from repro_torch.core.tree import leaves, map_tree, named_leaves
        from repro_torch.optim import adamw_init
        if self.calls >= self.steps:
            return self._real[1](grads, opt, params, lr, mesh=mesh, specs=specs, **kw)
        whole = {}
        for name, g in named_leaves(grads):
            d = specs[name].dim
            whole[name] = g if d is None else mesh.all_gather(
                g.movedim(d, 0).contiguous()).movedim(0, d)
        self._keep(list(whole.items()))
        if self.shadow:
            if self._params is None:
                self._params = map_tree(lambda p: p.detach().clone(), params)
                self._opt = adamw_init(self._params)
            g = store._refill(map_tree(torch.empty_like, self._params), whole.__getitem__)
            self._params, self._opt = self._real[0](g, self._opt, self._params, lr, **kw)
            del g
        del whole
        out = self._real[1](grads, opt, params, lr, mesh=mesh, specs=specs, **kw)
        if self.shadow:
            self.shadow_err.append(max(rel_err(p, s) for p, s in
                                       zip(leaves(params), leaves(self._params))))
        self.calls += 1
        return out


def dp_agreement(dp, one):
    """A data-parallel run against one device's, each a dict of per-step
    ``loss`` and ``grad_norm``, the first step's ``grads`` and the final
    ``params`` (by name, host arrays): the largest relative differences, on
    the first step and over all steps."""
    rel = lambda a, b: abs(a - b) / abs(b)                      # noqa: E731
    return {
        "loss_rel_step0": rel(dp["loss"][0], one["loss"][0]),
        "grad_norm_rel_step0": rel(dp["grad_norm"][0], one["grad_norm"][0]),
        "first_grads_rel": max(rel_err(dp["grads"][n], g) for n, g in one["grads"].items()),
        "loss_rel": max(rel(a, b) for a, b in zip(dp["loss"], one["loss"])),
        "grad_norm_rel": max(rel(a, b) for a, b in zip(dp["grad_norm"], one["grad_norm"])),
        "params_rel": max(rel_err(dp["params"][n], p) for n, p in one["params"].items()),
    }


def dp_failures(agree, shadow_err):
    """What breaks DP_TOLERANCE in ``dp_agreement``'s numbers (None: no
    comparison with one device) and a ZeroWatch's ``shadow_err``. Only the
    first step is held to 1e-6: from there the two runs' params differ where
    AdamW divides a grad at the level of its sum-order error by its own
    running size (such an element moves by up to lr either way), and in bf16
    compute that reaches the next steps' loss. Two runs of one device at two
    microbatch counts differ the same way, so ``loss_rel``, ``grad_norm_rel``
    and ``params_rel`` are readings."""
    keys = ("loss_rel_step0", "grad_norm_rel_step0", "first_grads_rel")
    bad = [f"{k} {agree[k]:.3e}" for k in keys if agree is not None and not agree[k] <= DP_REL]
    bad += [f"shadow step {i}: {e:.3e}" for i, e in enumerate(shadow_err) if not e <= DP_REL]
    return bad


def zero1_run(model, plan, batches, mesh=None, seed=0, watch=None, prepare=None,
              around=None, hyper=None):
    """``len(batches)`` steps from fresh params of ``seed`` (``prepare(params)``
    first, if given) on ``mesh`` or on one device, under ``watch`` (a
    ZeroWatch), each step inside ``around(i)`` (a context manager), if given.
    Returns the state, the step and a dict of per-step ``loss`` and
    ``grad_norm`` (and, under ``plan.integrity == "audit"``, ``integrity_div``
    and ``integrity_checksum``), the first step's ``grads`` (from the watch)
    and the final ``params`` by name on the host."""
    import contextlib
    from repro_torch.checkpoint import store
    from repro_torch.core.tree import named_leaves
    from repro_torch.train import Hyper, init_train_state, make_train_step
    gen = torch.Generator(device=model.device).manual_seed(seed)
    state = init_train_state(model, gen, mesh, plan)
    if prepare is not None:
        prepare(state.params)
    step = make_train_step(model, plan, hyper or Hyper(), mesh=mesh)
    out = {"loss": [], "grad_norm": []}
    with watch or contextlib.nullcontext():
        for i, batch in enumerate(batches):
            with around(i) if around is not None else contextlib.nullcontext():
                state, m = step(state, batch)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
                if "integrity_div" in m:
                    out.setdefault("integrity_div", []).append(float(m["integrity_div"]))
                    out.setdefault("integrity_checksum", []).append(
                        int(m["integrity_checksum"]))
    out["grads"] = watch.grads if watch is not None else None
    out["params"] = {n: store._host(x)[0] for n, x in named_leaves(state.params)}
    return state, step, out


def dp_setup(microbatches):
    """whisper-small's full-width training model for the DP phase (fp32
    masters, bf16 compute, remat "full", ZeRO-1, the integrity audit on,
    ``microbatches`` per rank) and
    DP_STEPS + 1 train_4k batches of WHISPER_TRAIN_BATCH sequences with their
    frames (the last for the checkpoint's resumed step)."""
    from repro_torch.core import InputShape, ParallelPlan, get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    cfg = get_config(WHISPER_ARCH)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=microbatches, zero_stage=1, integrity="audit")
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, WHISPER_TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(DP_STEPS + 1)]
    return cfg, plan, build_model(cfg, plan), batches


def dp_step_counter(cfg, mesh, what, rec):
    """A context-manager factory for ``zero1_run``'s ``around``: each step's
    wall time (synchronised), its collectives' seconds (from the mesh, which
    waits for the device around each one from step DP_WATCHED on) and its
    B1/B2/B3 launches, which must be the counts stated before the run and all
    on the Hopper bodies."""
    import contextlib
    attn_calls = cfg.enc_layers + 2 * cfg.n_layers          # per forward of a microbatch
    want = (2 * DP_MICRO * attn_calls, DP_MICRO * attn_calls, DP_MICRO * attn_calls, 0, 0)

    @contextlib.contextmanager
    def around(i):
        reset_counts()
        mesh.timed = i >= DP_WATCHED          # the watched steps are not timed
        before = dict(mesh.seconds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("reduce_scatter", "all_gather", "all_reduce"):
            rec[f"{k}_ms"].append((mesh.seconds[k] - before[k]) * 1e3)
        launches = all_counts()
        rec["launches"] = launches[:3]
        if launches != want:
            raise AssertionError(f"{what} step {i} launched {launches}, expected {want}")
        check_bodies(f"{what} step {i}", launches, "whisper_dp_train_step")
        rec["bodies"] = BODY_COUNTS["whisper_dp_train_step"]
    return around


def dp_checked_microbatch(model, mesh, cfg, batch, what, out):
    """A ``prepare`` for ``zero1_run``: this rank's first microbatch of
    ``batch`` (its own rows, the DP path's shapes) through the loss and its
    backward with every B1 call held to the plain version and every B2/B3 call
    to theirs, dq also to fp64 (FlashFwdCapture, FlashBwdCapture); the worst
    errors in bf16 ulps go to ``out``, the grads are dropped."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch import rank_microbatches
    from repro_torch.train import Hyper, make_loss_fn
    attn_calls = cfg.enc_layers + 2 * cfg.n_layers          # per forward of a microbatch
    mb = rank_microbatches(batch, mesh, DP_MICRO)[0]
    rows = WHISPER_TRAIN_BATCH // (DP_RANKS * DP_MICRO)
    if mb["tokens"].shape[0] != rows:
        raise AssertionError(f"{what}: a microbatch of {mb['tokens'].shape[0]} rows, "
                             f"expected {rows}")

    def prepare(params):
        with FlashBwdCapture(fp64=True) as bwd, FlashFwdCapture() as fwd:
            loss, _ = make_loss_fn(model, Hyper())(params, mb)
            loss.backward()
        out["real_bwd_ulps"] = bwd.summary(f"{what} microbatch ({rows} rows)", attn_calls)
        out["real_fwd_ulps"] = fwd.summary(
            f"{what} microbatch ({rows} rows, forward and recompute)", 2 * attn_calls)
        for p in leaves(params):
            p.grad = None
    return prepare


DP_SDC_AT = 2                     # the step whose checksum rank 1 bit-flips


def dp_sdc_run(model, plan, batches, mesh, clean, clean_opt, out_dir):
    """The DP phase's steps again from seed 0 under ``run_with_recovery``, with
    the integrity checksum's input bit-flipped on rank 1 only at DP_SDC_AT (a
    rank-divergent value, as silent corruption makes): an ``sdc`` rollback on
    both ranks, served by each rank's RAM tier (a snapshot every 2 steps; rank
    1 loses its host group 0 first, so its restore rebuilds from the mirror).
    The losses, params and moments must equal the clean run's (``clean``,
    ``clean_opt``: ``zero1_run``'s results and its final moments) bit for bit."""
    from repro_torch.checkpoint import CheckpointManager, MemoryCheckpointTier
    from repro_torch.ft import FlightRecorder, Monitor, run_with_recovery
    from repro_torch.ft.inject import FaultSpec, trace_with_faults
    from repro_torch.train import Hyper, init_train_state, make_train_step
    step = make_train_step(model, plan, Hyper(), mesh=mesh)
    twin = trace_with_faults(step, specs=[FaultSpec(
        "integrity.checksum", "bitflip", step=DP_SDC_AT, tick=None, rank=1, axis="data")])
    mem = MemoryCheckpointTier(keep=1, groups=2)
    done = set()

    def fault_step_fn(s):
        if s == DP_SDC_AT and "twin" not in done:
            done.add("twin")
            return twin
        return None

    def injector(s, st):
        if s == DP_SDC_AT and mesh.rank == 1 and "lost" not in done:
            done.add("lost")
            mem.lose_group(0)
        return st

    flight = FlightRecorder(maxlen=256)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), mesh, plan)
    t0 = time.perf_counter()
    final, report = run_with_recovery(
        state, step, lambda s: batches[s], len(batches),
        CheckpointManager(out_dir, keep=1), Monitor(min_history=1000, hang_min_seconds=600.0),
        ckpt_every=len(batches) + 1, plan=plan, mesh=mesh, fault_injector=injector,
        fault_step_fn=fault_step_fn, mem_ckpt=mem, mem_every=2, flight=flight)
    seconds = time.perf_counter() - t0
    got = host_named(final.params)
    got_opt = host_named(final.opt)
    out = {"actions": report.actions, "restores": report.restores,
           "mem_restores": report.mem_restores, "seconds": seconds,
           "restores_by_tier": ft_restore_readings(flight),
           "ram_restore_s": mem.restore_seconds, "ram_rebuilt_members": mem.last_rebuild,
           "ram_snapshot_s": mem.snapshot_seconds,
           "losses_bit_equal": report.losses == clean["loss"],
           "state_bit_equal": (all(np.array_equal(got[n], a) for n, a in clean["params"].items())
                               and all(np.array_equal(got_opt[n], a)
                                       for n, a in clean_opt.items()))}
    log(f"dp rank {mesh.rank} sdc run: {out}")
    return out


def dp_rank(rank, init_method, out_dir):
    """One of the DP_RANKS processes of the DP phase, on cuda:0 over gloo:
    whisper-small at full width and depth under ZeRO-1, one microbatch of the
    rank's rows with B1-B3 held to their plain versions
    (``dp_checked_microbatch``), DP_STEPS steps (the
    first DP_WATCHED watched: the first one's whole grads kept, each ZeRO-1
    update held to adamw_update on the same grads; the others timed), then
    the checkpoint round trip: a save at dp 2, the step after it, a restore at
    dp 2 (routed "replay") and its resumed step, and an elastic restore onto
    one process (routed "reshard"; refused without ``elastic``). Rank 0 then runs one device's
    step on the same batches with DP_RANKS x DP_MICRO microbatches, and once
    more with DP_MICRO (the sum-order reading). Results go to
    ``out_dir/dp_rank{rank}.json``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import resolve_device
    from repro_torch.core.sharding import bytes_per_device, local_index, opt_state_specs
    from repro_torch.core.tree import leaves
    from repro_torch.ft.integrity import audit
    from repro_torch.launch import DataMesh, init_data_mesh
    from repro_torch.train import init_train_state, make_train_step
    resolve_device()
    mesh = init_data_mesh("cuda:0", backend="gloo", init_method=init_method, rank=rank,
                          world_size=DP_RANKS)
    log(f"dp rank {rank}: {mesh}")
    cfg, plan, model, batches = dp_setup(DP_MICRO)
    rec = {"ms": [], "reduce_scatter_ms": [], "all_gather_ms": [], "all_reduce_ms": []}
    counter = dp_step_counter(cfg, mesh, f"{WHISPER_ARCH} dp rank {rank}", rec)
    watch = ZeroWatch(steps=DP_WATCHED, shadow=True)
    real = {}
    check = dp_checked_microbatch(model, mesh, cfg, batches[0],
                                  f"{WHISPER_ARCH} dp rank {rank}", real)
    torch.cuda.reset_peak_memory_stats()
    state, step, dp = zero1_run(model, plan, batches[:DP_STEPS], mesh, watch=watch,
                                prepare=check, around=counter)
    peak = torch.cuda.max_memory_allocated()
    ospecs = opt_state_specs(state.params, mesh, plan)
    clean_opt = host_named(state.opt)
    audit_ms = []
    for _ in range(3):                     # the step's audit alone: the moments' slices
        torch.cuda.synchronize()           # stand in for the grads' (the same layout)
        t0 = time.perf_counter()
        int(audit(state.params, state.opt.mu, mesh, ospecs)[0])
        audit_ms.append((time.perf_counter() - t0) * 1e3)
    held = sum(t.numel() * t.element_size() for which in (state.opt.mu, state.opt.nu)
               for t in leaves(which))
    out = {"rank": rank, "mesh": repr(mesh), **rec, **real, "peak_bytes": peak,
           "moment_bytes": held, "moment_bytes_rule": 2 * bytes_per_device(ospecs, mesh),
           "moment_bytes_whole": 2 * bytes_per_device(ospecs, None),
           "loss": dp["loss"], "grad_norm": dp["grad_norm"], "shadow_err": watch.shadow_err,
           "integrity_div": dp["integrity_div"], "integrity_checksum": dp["integrity_checksum"],
           "audit_ms": audit_ms}
    log(f"dp rank {rank}: steps {[round(x, 1) for x in rec['ms']]} ms, losses {dp['loss']}, "
        f"grad norms {dp['grad_norm']}, ZeRO-1 update against adamw_update on the same "
        f"whole grads {watch.shadow_err}")

    ckdir = Path(out_dir) / "ckpt"
    saved = host_named(state)
    mgr = CheckpointManager(ckdir, keep=2)
    mgr.save(DP_STEPS, state, plan=plan, mesh=mesh)
    out["save"] = {"stall_s": mgr.snapshot_seconds, "d2h_s": mgr.d2h_seconds,
                   "gather_s": mgr.gather_seconds}
    state, m = step(state, batches[DP_STEPS])            # the step after the save
    loss_next = float(m["loss"])
    mgr.wait()                                            # a barrier of the ranks
    out["save"]["persist_s"] = mgr.persist_seconds if rank == 0 else None
    out["save"]["bytes"] = mgr.bytes_written if rank == 0 else None
    del state

    out["route_dp2"] = mgr.check_plan(plan, mesh=mesh)
    fresh = init_train_state(model, torch.Generator(device="cuda").manual_seed(7), mesh, plan)
    t0 = time.perf_counter()
    _, fresh = mgr.restore(fresh, mesh=mesh)
    torch.cuda.synchronize()
    out["restore_dp2_s"] = time.perf_counter() - t0
    got = host_named(fresh)
    out["restore_dp2_bit_exact"] = all(np.array_equal(got[n], a) for n, a in saved.items())
    fresh, m = step(fresh, batches[DP_STEPS])
    out["resumed_dp2_rel"] = abs(float(m["loss"]) - loss_next) / abs(loss_next)
    del fresh, got
    out["sdc"] = dp_sdc_run(model, plan, batches[:DP_STEPS], mesh, dp, clean_opt,
                            Path(out_dir) / "sdc")
    del clean_opt

    one = DataMesh(device=mesh.device)                    # dp 1: one process
    try:
        mgr.check_plan(plan, mesh=one)
        out["route_dp1_refused"] = False
    except ValueError:
        out["route_dp1_refused"] = True
    out["route_dp1"] = mgr.check_plan(plan, mesh=one, elastic=True)
    single = init_train_state(model, torch.Generator(device="cuda").manual_seed(7))
    t0 = time.perf_counter()
    _, single = mgr.restore_resharded(single, plan=plan)
    torch.cuda.synchronize()
    out["restore_dp1_s"] = time.perf_counter() - t0
    got = host_named(single)
    exact = True
    for name, a in saved.items():
        if name.startswith("opt/") and name != "opt/step":
            spec = ospecs[name.split("/", 2)[2]]
            a_whole = got[name][tuple(slice(lo, hi) for lo, hi in
                                      local_index(spec, rank, DP_RANKS))]
            exact &= np.array_equal(a_whole, a)
        else:
            exact &= np.array_equal(got[name], a)
    out["restore_dp1_bit_exact"] = bool(exact)
    del got
    plan1 = dataclasses.replace(plan, microbatches=DP_RANKS * DP_MICRO)
    if rank == 0:
        single, m = make_train_step(model, plan1)(single, batches[DP_STEPS])
        out["resumed_dp1_rel"] = abs(float(m["loss"]) - loss_next) / abs(loss_next)
    del single
    mesh.close()
    free()

    if rank == 0:
        _, _, ref = zero1_run(model, plan1, batches[:DP_STEPS], watch=ZeroWatch())
        out["agree"] = dp_agreement(dp, ref)
        free()
        _, _, ref2 = zero1_run(model, dataclasses.replace(plan, microbatches=DP_MICRO),
                               batches[:DP_STEPS], watch=ZeroWatch())
        out["one_device_mb2_vs_mb4"] = dp_agreement(ref2, ref)
        out["one_device_loss"] = ref["loss"]
        out["one_device_grad_norm"] = ref["grad_norm"]
    (Path(out_dir) / f"dp_rank{rank}.json").write_text(json.dumps(out))


def nccl_rank(init_method, out_dir):
    """The DP phase's NCCL process: world size 1 on cuda:0. The mesh's
    collectives on device tensors, then whisper-small at full width, DP_STEPS
    steps through the ZeRO-1 step code (every leaf whole at one rank, so each
    grad is all-reduced through NCCL), against one device's step without a
    mesh, DP_MICRO microbatches in both. Results to ``out_dir/nccl.json``."""
    from repro_torch.core import resolve_device
    from repro_torch.launch import init_data_mesh
    resolve_device()
    mesh = init_data_mesh("cuda:0", init_method=init_method, rank=0, world_size=1)
    log(f"nccl: {mesh}")
    x = torch.randn(8, 6, 4, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    seam = (torch.equal(mesh.reduce_scatter_mean(x.movedim(1, 0).contiguous()).movedim(0, 1), x)
            and torch.equal(mesh.all_gather(x), x)
            and torch.equal(mesh.all_reduce_mean(x.clone()), x))
    cfg, plan, model, batches = dp_setup(DP_MICRO)
    rec = {"ms": [], "reduce_scatter_ms": [], "all_gather_ms": [], "all_reduce_ms": []}
    counter = dp_step_counter(cfg, mesh, f"{WHISPER_ARCH} nccl", rec)
    watch = ZeroWatch(steps=DP_WATCHED, shadow=True)
    _, _, dp = zero1_run(model, plan, batches[:DP_STEPS], mesh, watch=watch, around=counter)
    free()
    _, _, ref = zero1_run(model, plan, batches[:DP_STEPS], watch=ZeroWatch())
    out = {"mesh": repr(mesh), "seam_equal": bool(seam), **rec, "loss": dp["loss"],
           "integrity_div": dp["integrity_div"],
           "grad_norm": dp["grad_norm"], "one_device_loss": ref["loss"],
           "one_device_grad_norm": ref["grad_norm"], "shadow_err": watch.shadow_err,
           "agree": dp_agreement(dp, ref),
           "params_bit_identical": all(np.array_equal(dp["params"][n], p)
                                       for n, p in ref["params"].items())}
    mesh.close()
    (Path(out_dir) / "nccl.json").write_text(json.dumps(out))


def phase_whisper_dp():
    """The DP phase: DP_RANKS spawned ranks on the one card over gloo
    (``dp_rank``), then one NCCL rank (``nccl_rank``), each a process of its
    own (spawn, not fork: the parent holds a CUDA context); their results
    checked here. Every process is joined or killed before this returns."""
    import multiprocessing
    import shutil
    import tempfile
    ctx = multiprocessing.get_context("spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dp_", dir=ROOT / "build")
    procs = []
    try:
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_rank, args=(r, f"file://{tmp}/store", tmp))
                 for r in range(DP_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        codes = [p.exitcode for p in procs]
        if codes != [0] * DP_RANKS:
            raise AssertionError(f"the DP ranks exited with {codes}")
        gloo_s = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"dp_rank{r}.json").read_text())
                 for r in range(DP_RANKS)]
        t0 = time.perf_counter()
        procs = [ctx.Process(target=nccl_rank, args=(f"file://{tmp}/nccl_store", tmp))]
        procs[0].start()
        procs[0].join(timeout=300)
        if procs[0].exitcode != 0:
            raise AssertionError(f"the NCCL rank exited with {procs[0].exitcode}")
        nccl_s = time.perf_counter() - t0
        nccl = json.loads((Path(tmp) / "nccl.json").read_text())
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    dp_report(ranks, nccl)
    log(f"phase DP: gloo ranks {gloo_s:.1f} s, nccl {nccl_s:.1f} s")
    return {"ranks": ranks, "nccl": nccl, "gloo_s": gloo_s, "nccl_s": nccl_s}


def dp_report(ranks, nccl):
    """Log the DP phase's results and hold them to DP_TOLERANCE and the
    checkpoint's bit-for-bit restores; keep the ranks' launches by body for
    the kernels line."""
    r0 = ranks[0]
    for r in ranks:
        timed_ms = {k: r[k][DP_WATCHED:] for k in ("ms", "reduce_scatter_ms", "all_gather_ms",
                                                  "all_reduce_ms")}
        log(f"dp rank {r['rank']} ({r['mesh']}): timed steps {timed_ms} (two ranks share one "
            f"card and their collectives go through host memory: no measure of DP scaling); "
            f"peak {r['peak_bytes'] / 1e9:.2f} GB; moments held {r['moment_bytes'] / 1e9:.3f} "
            f"GB (the rule's {r['moment_bytes_rule'] / 1e9:.3f} of "
            f"{r['moment_bytes_whole'] / 1e9:.3f}); launches B1/B2/B3 {r['launches']} a step; "
            f"on its own rows B1 {r['real_fwd_ulps']:.2f}, B2 (dq) {r['real_bwd_ulps'][1]:.2f}, "
            f"B3 (dk/dv) {r['real_bwd_ulps'][0]:.2f} bf16 ulps from their plain versions; "
            f"save stall {r['save']['stall_s']:.2f} s (host copy {r['save']['d2h_s']:.2f}, "
            f"gather {r['save']['gather_s']:.2f}); restore at dp 2 {r['restore_dp2_s']:.2f} s, "
            f"at dp 1 {r['restore_dp1_s']:.2f} s")
    agree = r0["agree"]
    log(f"dp {DP_RANKS} x {DP_MICRO} microbatches against one device x "
        f"{DP_RANKS * DP_MICRO}: losses {r0['loss']} / {r0['one_device_loss']}, grad norms "
        f"{r0['grad_norm']} / {r0['one_device_grad_norm']}; {agree}; the same between two "
        f"sum orders of one device ({DP_MICRO} microbatches against {DP_RANKS * DP_MICRO}): "
        f"{r0['one_device_mb2_vs_mb4']}")
    log(f"checkpoint at dp {DP_RANKS}: persist {r0['save']['persist_s']:.2f} s, "
        f"{r0['save']['bytes'] / 1e9:.3f} GB; routes {r0['route_dp2']} / {r0['route_dp1']} "
        f"(refused without elastic: {r0['route_dp1_refused']}); restores bit for bit "
        f"{[(r['restore_dp2_bit_exact'], r['restore_dp1_bit_exact']) for r in ranks]}; "
        f"resumed steps {[r['resumed_dp2_rel'] for r in ranks]}, one device "
        f"{r0['resumed_dp1_rel']:.3e}")
    for r in ranks:
        log(f"dp rank {r['rank']}: integrity audit {r['integrity_div']} (checksums "
            f"{r['integrity_checksum']}), the audit alone {[round(x, 2) for x in r['audit_ms']]} "
            f"ms; sdc run: actions {r['sdc']['actions']}, restores {r['sdc']['restores_by_tier']}, "
            f"RAM restore {r['sdc']['ram_restore_s']:.2f} s ({r['sdc']['ram_rebuilt_members']} "
            f"members rebuilt), bit-equal {r['sdc']['state_bit_equal']}, {r['sdc']['seconds']:.1f} s")
    log(f"nccl ({nccl['mesh']}): seam {nccl['seam_equal']}, step {nccl['ms'][DP_WATCHED:]} ms, "
        f"all-reduce {nccl['all_reduce_ms'][DP_WATCHED:]} ms; losses {nccl['loss']} / "
        f"{nccl['one_device_loss']}, grad norms {nccl['grad_norm']} / "
        f"{nccl['one_device_grad_norm']}; {nccl['agree']}; params bit-identical "
        f"{nccl['params_bit_identical']}; launches {nccl['launches']} a step")
    bad = []
    for what, res in [(f"dp rank {r['rank']}", r) for r in ranks] + [("nccl", nccl)]:
        bad += [f"{what}: {b}" for b in dp_failures(res.get("agree"), res["shadow_err"])]
    bad += [f"rank {r['rank']} reports {r['loss']} / {r['grad_norm']}" for r in ranks[1:]
            if (r["loss"], r["grad_norm"]) != (r0["loss"], r0["grad_norm"])]
    for r in ranks:
        if not (r["route_dp2"] == "replay" and r["route_dp1"] == "reshard"
                and r["route_dp1_refused"]):
            bad.append(f"rank {r['rank']}: routes {r['route_dp2']}, {r['route_dp1']}, "
                       f"refused {r['route_dp1_refused']}")
        if not (r["restore_dp2_bit_exact"] and r["restore_dp1_bit_exact"]):
            bad.append(f"rank {r['rank']}: a restore is not bit for bit")
        if not r["resumed_dp2_rel"] <= DP_REL:
            bad.append(f"rank {r['rank']}: resumed step {r['resumed_dp2_rel']:.3e}")
        if r["moment_bytes"] != r["moment_bytes_rule"]:
            bad.append(f"rank {r['rank']}: moments {r['moment_bytes']} != rule")
    for r in ranks:
        if any(d != 0.0 for d in r["integrity_div"]):
            bad.append(f"rank {r['rank']}: the audit read {r['integrity_div']} on a healthy run")
        sdc = r["sdc"]
        if not (sdc["actions"] == [[DP_SDC_AT, "sdc", "rollback"]] and sdc["restores"] == 1
                and sdc["mem_restores"] == 1 and sdc["losses_bit_equal"]
                and sdc["state_bit_equal"]):
            bad.append(f"rank {r['rank']}: the sdc run {sdc}")
    if any(r["integrity_checksum"] != r0["integrity_checksum"] for r in ranks[1:]):
        bad.append("the ranks' integrity checksums differ")
    if any(d != 0.0 for d in nccl["integrity_div"]):
        bad.append(f"nccl: the audit read {nccl['integrity_div']}")
    if not r0["resumed_dp1_rel"] <= DP_REL:
        bad.append(f"one device's resumed step {r0['resumed_dp1_rel']:.3e}")
    if not nccl["seam_equal"]:
        bad.append("the NCCL seam changed a tensor at world size 1")
    if bad:
        raise AssertionError("DP phase: " + "; ".join(bad))
    BODY_COUNTS["whisper_dp_train_step"] = {
        k: sum(r["bodies"][k] for r in ranks) for k in r0["bodies"]}
    BODY_COUNTS["whisper_dp_nccl_train_step"] = nccl["bodies"]


def dp_summary(dp):
    """The DP phase's numbers for the kernels line (``whisper-small_dp``)."""
    keys = ("ms", "reduce_scatter_ms", "all_gather_ms", "all_reduce_ms", "launches",
            "peak_bytes", "moment_bytes", "moment_bytes_whole", "save", "restore_dp2_s",
            "restore_dp1_s", "resumed_dp2_rel", "shadow_err", "real_fwd_ulps", "real_bwd_ulps",
            "integrity_div", "integrity_checksum", "audit_ms", "sdc")
    r0, nccl = dp["ranks"][0], dp["nccl"]
    return {
        "ranks": [{k: r[k] for k in keys} for r in dp["ranks"]],
        "transport": "gloo, host copies (two ranks on one card); no measure of DP scaling",
        "agreement_with_one_device": r0["agree"],
        "one_device_mb2_vs_mb4": r0["one_device_mb2_vs_mb4"],
        "resumed_dp1_rel": r0["resumed_dp1_rel"],
        "tolerance": DP_TOLERANCE,
        "nccl_world_1": {k: nccl[k] for k in ("ms", "all_reduce_ms", "launches", "agree",
                                               "params_bit_identical", "shadow_err")},
        "phase_s": {"gloo_ranks": dp["gloo_s"], "nccl": dp["nccl_s"]},
    }


def ft_summary(whisper, dp):
    """The fault-tolerance readings for the kernels line (``whisper-small_ft``):
    the phase's, the DP ranks' audit and sdc run, and the training phase's step
    time with the seams unarmed."""
    ft = whisper["ft"]
    return {
        **ft,
        "train_step_ms_seams_unarmed": whisper["train"]["step_ms"],
        "dp_ranks": [{k: r[k] for k in ("rank", "integrity_div", "integrity_checksum",
                                         "audit_ms", "sdc")} for r in dp["ranks"]],
        "dp_nccl_integrity_div": dp["nccl"]["integrity_div"],
    }


def ssd_entries(ssd_errs, ssm):
    """The kernels-line entries of B5 and B6. ``ssd_errs``: (the bf16 kernel
    checks at each path shape, the worst error of each Hopper pass); ``ssm``:
    {arch: (serving, training)} results."""
    path_errs, pass_worst = ssd_errs
    by_path = {"ssd_fwd": {}, "ssd_bwd": {}}
    windows = []
    for arch, (serve, train) in ssm.items():
        by_path["ssd_fwd"][f"{arch}_forward"] = serve["b5"]
        by_path["ssd_fwd"][f"{arch}_train_step"] = train["launches"][5]
        by_path["ssd_bwd"][f"{arch}_train_step"] = train["launches"][6]
        windows += [f"{arch}_forward", f"{arch}_train_step"]
    out = []
    for name, kind, line, i, names, tol in (
            ("ssd_fwd", "fwd", 79, 0, ("y", "enters", "state"), SSD_FWD_TOLERANCE),
            ("ssd_bwd", "bwd", 179, 1, BWD_NAMES, SSD_BWD_TOLERANCE)):
        head = ssm[SSM_ARCH][0 if kind == "fwd" else 1]["times"][kind]
        bodies = launches_by_body(name, windows)
        if bodies[f"{name}_sm90"] != sum(by_path[name].values()) or bodies[f"{name}_simt"]:
            raise AssertionError(f"{name}'s launches by body {bodies} do not add up to its "
                                 f"launches by path {by_path[name]} on the Hopper body")
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/ssd_scan.py:{line}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "launches_by_body": bodies,
            "max_abs_err": max(a for errs in path_errs.values() for a, _ in errs[i]),
            "errors_at_path_shapes": {path: {n: e for n, (_, e) in zip(names, errs[i])}
                                      for path, errs in path_errs.items()},
            "pass_errors_worst": {k: v for k, v in pass_worst.items() if k.startswith(kind)},
            "real_inputs_worst": {f"{arch}_{which}": r["real"] for arch, pair in ssm.items()
                                  for which, r in zip(("serving", "training"), pair)},
            "tolerance": tol,
            "ms": head["ms"],
            "first_body_ms": head["first_body_ms"],
            "pass_ms": head["pass_ms"],
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


def phase_times(launches, path_errs, real_ulps, bwd_errs, train, gemm_errs, moe_serve,
                moe_train, ssd_errs, ssm, whisper, dp):
    ft = forward_times()
    bt = backward_times()
    b1_train, b2_train, b3_train = train["launches"]
    hy_serve, hy_train = ssm[HYBRID_ARCH]
    b1_paths = {"prefill": launches, "train_step": b1_train,
                "moe_prefill": moe_serve["prefill_b1"], "moe_train_step": moe_train["train_b1"],
                f"{HYBRID_ARCH}_forward": hy_serve["b1"],
                f"{HYBRID_ARCH}_train_step": hy_train["launches"][0],
                "whisper_fill_cross": whisper["serve"]["fill_b1"],
                "whisper_decode": whisper["serve"]["decode_b1"],
                "whisper_train_step": whisper["train"]["launches"][0],
                "whisper_ft": whisper["ft"]["launches"][0],
                "whisper_dp_train_step": sum(r["launches"][0] for r in dp["ranks"]),
                "whisper_dp_nccl_train_step": dp["nccl"]["launches"][0]}
    b1_bodies = launches_by_body("flash_fwd", b1_paths)
    if sum(b1_bodies.values()) != sum(b1_paths.values()):
        raise AssertionError(f"B1's launches by body {b1_bodies} do not add up to its "
                             f"launches by path {b1_paths}")
    # the kernel checks' bf16 errors beside the times of the same shapes
    shapes = {name: dict(r) for name, r in ft.items()}
    for name, key in (("serving", "serving"), ("train", "train"),
                      (f"{HYBRID_ARCH}_serving", "hybrid_serve"),
                      (f"{HYBRID_ARCH}_train", "hybrid_train"),
                      *((f"{WHISPER_ARCH}_{n}", f"whisper_{n}") for n in WHISPER_CASES)):
        shapes[name].update(max_abs_err=path_errs[key][0], max_err_bf16_ulps=path_errs[key][1])
    head = ft["serving"]
    entries = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": sum(b1_paths.values()),
        "launches_by_path": b1_paths,
        "launches_by_body": b1_bodies,
        "max_abs_err": path_errs["serving"][0],
        "max_err_bf16_ulps": path_errs["serving"][1],
        "lse_max_rel_err": path_errs["serving"][2],
        "real_inputs_max_err_bf16_ulps": real_ulps,
        f"{HYBRID_ARCH}_real_inputs_max_err_bf16_ulps": max(hy_serve["real_fwd"],
                                                            hy_train["real_fwd"]),
        f"{WHISPER_ARCH}_real_inputs_max_err_bf16_ulps": max(
            whisper["serve"]["real_fwd"], whisper["train"]["real_fwd"],
            *(r["real_fwd_ulps"] for r in dp["ranks"])),
        "tolerance": TOLERANCE,
        "ms": head["ms"],
        "mma_body_ms": head["mma_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_covers": "SDPA's forward (o only) on the same q, k, v",
        "shapes": shapes,
        "check": "pass",
    }]
    hybrid_train = ssm[HYBRID_ARCH][1]["launches"]
    hybrid_real = ssm[HYBRID_ARCH][1]["real_attn"]            # (dk/dv, dq) in bf16 ulps
    for which, name, line, count, real in (
            (0, "flash_bwd_dq", 242, b2_train, train["real_dq_ulps"]),
            (1, "flash_bwd_dkv", 278, b3_train, train["real_dkv_ulps"])):
        errs, hy_errs = ((e[:1] if which == 0 else e[1:])
                         for e in (bwd_errs["train"], bwd_errs["hybrid"]))
        by_path = {"train_step": count, "moe_train_step": moe_train[f"train_b{which + 2}"],
                   f"{HYBRID_ARCH}_train_step": hybrid_train[which + 1],
                   f"{WHISPER_ARCH}_train_step": whisper["train"]["launches"][which + 1],
                   f"{WHISPER_ARCH}_ft": whisper["ft"]["launches"][which + 1],
                   f"{WHISPER_ARCH}_dp_train_step": sum(r["launches"][which + 1]
                                                        for r in dp["ranks"]),
                   f"{WHISPER_ARCH}_dp_nccl_train_step": dp["nccl"]["launches"][which + 1]}
        hy = bt["hybrid"]
        wh = {}
        for n in ("encoder", "train_cross", "train_self"):
            t, errs_n = bt[f"whisper_{n}"], bwd_errs[f"whisper_{n}"]
            errs_n = errs_n[:1] if which == 0 else errs_n[1:]
            wh[n] = {"shape": list(WHISPER_CASES[n][:7]), "ms": t["ms"][which],
                     "bound_ms": t["bounds"][which][0], "bound_by": t["bounds"][which][1],
                     "plain_ms": t["plain_ms"], "whole_backward_ms": t["whole_ms"],
                     "library_ms": t["library_ms"],
                     "max_abs_err": max(e[0] for e in errs_n),
                     "max_err_bf16_ulps": max(e[1] for e in errs_n)}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
            "whole_backward_ms": bt["whole_ms"],
            "whole_backward_covers": "FlashAttention.backward: the delta pass, dq and dk/dv",
            f"{HYBRID_ARCH}_shape": {"shape": list(HYBRID_ATTN_CASE[:6]), "ms": hy["ms"][which],
                                     "bound_ms": hy["bounds"][which][0],
                                     "bound_by": hy["bounds"][which][1],
                                     "whole_backward_ms": hy["whole_ms"],
                                     "library_ms": hy["library_ms"],
                                     "max_abs_err": max(e[0] for e in hy_errs),
                                     "max_err_bf16_ulps": max(e[1] for e in hy_errs),
                                     "real_inputs_max_err_bf16_ulps": hybrid_real[1 - which]},
            f"{WHISPER_ARCH}_shapes": wh,
            f"{WHISPER_ARCH}_real_inputs_max_err_bf16_ulps": max(
                whisper["train"]["real_bwd"][1 - which],
                *(r["real_bwd_ulps"][1 - which] for r in dp["ranks"])),
            "check": "pass",
        })
    gt = {**moe_serve["times"], **moe_train["times"]}
    head = gt["prefill"]
    decode_steps = moe_serve["decode_b4"]
    train_b4 = moe_train["train_b4_rows"] + moe_train["train_b4_contract"]
    b4_bodies = launches_by_body("gg_", ("moe_prefill", "moe_decode", "moe_train_step"))
    if sum(b4_bodies.values()) != moe_serve["prefill_b4"] + decode_steps + train_b4:
        raise AssertionError(f"B4's launches by body {b4_bodies} do not add up to its "
                             f"launches by path")
    entries.append({
        "name": "grouped_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
        "replaces": "src/repro/kernels/grouped_gemm.py:50",
        "launches": moe_serve["prefill_b4"] + decode_steps + train_b4,
        "launches_by_path": {"prefill": moe_serve["prefill_b4"],
                             "decode_step": decode_steps // DECODE_STEPS,
                             f"decode_{DECODE_STEPS}_steps": decode_steps,
                             "train_step_rows": moe_train["train_b4_rows"],
                             "train_step_contract": moe_train["train_b4_contract"]},
        "launches_by_body": b4_bodies,
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
        "shapes": gt,
        "check": "pass",
    })
    entries += ssd_entries(ssd_errs, ssm)
    print(json.dumps({"kernels": entries, f"{WHISPER_ARCH}_checkpoint": whisper["ckpt"],
                      f"{WHISPER_ARCH}_dp": dp_summary(dp),
                      f"{WHISPER_ARCH}_ft": ft_summary(whisper, dp)}), flush=True)


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
    bwd_errs = timed("kernels (B2, B3)", phase_kernels_bwd)
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
    whisper = {"serve": timed(f"{WHISPER_ARCH} serving", phase_whisper_serving)}
    free()
    whisper["train"] = timed(f"{WHISPER_ARCH} training", phase_whisper_training)
    free()
    whisper["ckpt"] = timed(f"{WHISPER_ARCH} checkpoint", phase_whisper_checkpoint)
    free()
    whisper["ft"] = timed(f"{WHISPER_ARCH} fault tolerance", phase_whisper_ft)
    free()
    dp = timed(f"{WHISPER_ARCH} data parallel", phase_whisper_dp)
    timed("times", phase_times, launches, path_errs, real_ulps, bwd_errs, train,
          gemm_errs, moe_serve, moe_train, ssd_errs, ssm, whisper, dp)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
