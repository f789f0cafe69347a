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
   zamba2's serving shape cut in S) and every HD_CASES row (head dims off the
   four built bodies: 8, 16, 40, 72, 96, 200, run at the next built one with
   the columns past hd masked; fp32 and first-version bf16 bodies, masked
   and windowed rows), and at both training paths' shapes and
   zamba2's serving shape (4 x 32 heads x 8000, hd 64; the plain version in
   blocks of query rows), where two launches must be bit-identical; the
   backward's dq and dk/dv kernels
   (fp32 to 1e-5 of each tensor's largest value, bf16 to 2 bf16 ulps), fully
   masked rows included, at the paths' own shapes, at the edges of the
   Hopper body and on every HD_CASES row, with merged softmax statistics, and through the autograd
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
12. whisper-small checkpoint — its full-width training state (2 + 2 layers,
   WHISPER_CUT_LAYERS) saved with
   async_snapshot after 2 steps, steps 3-4 while the copy drains, restored into
   a fresh state (bit for bit), steps 3-4 resumed (losses to 1e-6 relative),
   a save with free card memory for half the state restored bit for
   bit, the host-RAM tier restored after lose_group; stall, fence, copy to
   host, persist and restore times;
13. whisper-small fault tolerance — each dispatcher's fault seam (B1 at the
   encoder's shape, B4 and B5 at smoke shapes): unarmed, the undecorated call's
   bits; armed with nan, one NaN at the index the CPU computes. Then full width
   on 2 of its 12 + 12 layers each (WHISPER_CUT_LAYERS) under
   ``run_with_recovery`` (the training plan, the batch cut to 4 x 4096 tokens
   with 4 x 1500 frames): a clean run of 11 steps; the chaos
   schedule (a spike x8 at step 5, kernel.attention NaN'd at 6 and 9, the
   step-8 shard write dropped, a 4 s hang at 10), whose actions, 3 restores
   and 1 corrupt checkpoint skipped are asserted, ending equal to the clean run
   bit for bit; B1/B2/B3 counted on every step of these runs (Hopper bodies);
   the audit's cost. The preemption round is phase 14's: a SIGTERM from
   another process, at full depth;
14. the training CLI — ``python -m repro_torch.launch.train`` at whisper-small's
   full width and depth (``--full``, 12 + 12 layers, 334.52 M parameters,
   fp32 masters, bf16 compute, remat "none", 2 x 448 tokens with 2 x 1500
   frames, CLI_STEPS steps, no RAM tier, a checkpoint at step 0 only): a clean
   run in this process (``build`` and a plain loop of the step fn); a child
   CLI process on the card, sent a SIGTERM from this process once its step-0
   manifest is on disk (CLI_SIGNAL_DELAY s after), which must exit 0 after its
   just-in-time snapshot with the preemption line, the PREEMPTED marker (step
   k, 1 <= k < CLI_STEPS, SIGTERM, disk) and its flight JSON; then ``run``
   with ``--resume`` in this
   process, which must consume the marker, reach the end, and equal the clean
   run bit for bit (losses from step k, params, both moments, the step count);
   B1/B2/B3 counted on every step run here (Hopper bodies); the child's start-up,
   the step-0 and just-in-time persists (its flight log), signal to exit, the
   restore and the step ms;
15. whisper-small data parallel — ZeRO-1 on torch.distributed at full width
   on 2 + 2 layers (WHISPER_CUT_LAYERS; fp32 masters, bf16 compute, remat
   "full", ``Hyper()``): two rank
   processes (spawn) on the one card over gloo, the host transport (NCCL
   refuses two ranks on one device), the global batch of 8 x 4096 tokens with
   8 x 1500 frames, each rank 2 microbatches of its 2 rows of each; on each
   rank, one microbatch of its own 2 rows first, with B1 (12 calls, forward
   and recompute) and B2/B3 (6) held to their plain versions on every call
   and dq to fp64 at the DP path's shapes (batch 2); then 4 steps
   against one device's step with 4 microbatches on the same batches and
   weights (``DP_TOLERANCE``: the first step's loss and grad norm to 1e-6
   relative and its grads to 1e-6 of each leaf's max, the ZeRO-1 update
   against ``adamw_update`` on the same whole grads to 1e-6; the later steps
   and the params after 4 steps readings, beside the same readings between
   one device's runs at 2 and 4 microbatches; the first 2 steps watched, the
   last 2 timed), B1/B2/B3 24/12/12 per rank per step on the
   Hopper bodies, step, reduce-scatter and all-gather ms, peak memory and the
   moment bytes each rank holds; a ZeRO-1 checkpoint saved at dp 2 (stall,
   gather, persist), restored at dp 2 ("replay") and onto one process
   (``restore_resharded``, "reshard", refused without ``elastic``), both bit
   for bit, the resumed steps to 1e-6; the integrity audit on every step
   (0.0 on each rank, equal checksums), and the steps again under
   ``run_with_recovery`` with rank 1's checksum bit-flipped at step 2: an sdc
   rollback on both ranks from their RAM tiers, ending equal to the clean steps
   bit for bit; then ZeRO-3 (``dp_shard`` 2: the params themselves split
   over the two ranks, each layer gathered inside its remat boundary and its
   grads reduce-scattered in the backward) on the same ranks, model and
   batches: ZERO3_STEPS steps, each held by DP_TOLERANCE against the same
   one-device run and timed (step, all-gather and reduce-scatter ms less the
   check's own collectives, the param bytes a rank holds, peak memory beside
   the ZeRO-1 run's), its params after those steps set beside ZeRO-1's and
   one device's at 2 microbatches after as many; then one NCCL rank at world size 1
   through the same step code against one device's step with 2 microbatches;
16. tensor parallelism — the overlap rings (A13.2) on a (1, 2) grid: two rank
   processes (spawn) on the one card over gloo (each ring tick through host
   memory; no TP scaling or overlap is measured; at the same time as phase
   15's ranks until ZeRO-3, ``dp_and_tp``, so both phases' step readings
   then are kept apart as taken beside each other; ZeRO-3, the NCCL rank and
   the TP kernel timing run alone), 1 x 4096
   tokens, bf16 compute, remat "full": qwen1.5-4b at full width on 2 of its 40 layers, 3
   steps (B1/B2/B3 4/2/2 a rank a step at (1, 10, 4096, 128)),
   deepseek-moe-16b at full width on 1 of 28 layers, one step (B4 9 rows + 3
   contract a rank at d_expert 704), mamba2-370m at full width on 6 of its 48
   layers, one step (B5/B6 12/6 a rank at (1, 16, 4096, 64, 128)); on each rank's first
   microbatch every kernel call held to its plain version on the rank's own
   inputs (dq also to fp64); each family's losses against one device's on the
   same weights and batches (readings), then one fp32 step of qwen1.5-4b at 2
   layers held to one device's and to an fp64 evaluation by GRID_TOLERANCE,
   and its control (a bf16 partial sum in every row GEMM's ring), which must
   fail the grads rule; step, ring tick and
   all-reduce ms, peak memory and the launches by body; the kernels timed at
   the sharded shapes. No checkpoint;
17-19 run in one spawn of two rank processes (``phase_cp_ep_pp``: each rank
   runs the three phases' parts in turn, each on its own process group),
   which pays one start-up for the three;
17. context parallelism — the ring and gather modes (A13.3) on a (1, 2, 1)
   (data, cp, model) grid: two rank processes (spawn) on the one card over
   gloo (each hop through host memory; no CP scaling is measured), bf16
   compute, remat "full": qwen1.5-4b at full width on 2 of its 40 layers over
   1 x 16,384 tokens in the ring mode (each rank two zigzag sub-chunks of
   4096; B1/B2/B3 20/10/10 a rank a step: 5 tiles a layer, 2 diagonal and 3
   full, the other 3 masked and never launched), a warm-up and 1 step;
   mamba2-370m at full width on 6 of its 48 layers over 1 x 65,536 (32,768 a
   rank, the conv halo and the state chain; B5/B6 12/6 a rank a step at (1,
   32, 32768, 64, 128)), a warm-up and 2 steps; on each rank's first microbatch
   every kernel call held to its plain version on the rank's own inputs (B2/B3
   against the merged statistics, dq also to fp64); one device's loss on the
   same weights and batch (a reading); then fp32 steps at 2 layers, 1 x 4096:
   dense in the ring and the gather modes and Mamba2, each held to one
   device's and to an fp64 evaluation by GRID_TOLERANCE, and the ring's
   control (each tile's o rounded to bf16 before the merge), which must fail
   the grads rule; step, hop and all-reduce ms, peak memory and the launches
   by body; the kernels timed at the CP shapes (B1 on a diagonal and a full
   4096 x 4096 tile beside SDPA, B2/B3 on each against the row's merged
   statistics, B5/B6 at the rank's chunk). No checkpoint;
18. expert parallelism — the EP exchange (A13.4) on a (1, 2) grid in the
   ep-only placement (ep 2 on the model axis; attention a cp ring over it):
   two rank processes (spawn) on the one card over gloo (every exchange
   through host memory; no EP scaling or overlap is measured),
   deepseek-moe-16b at full width on 2 of its 28 layers over 1 x 4096 tokens,
   bf16 compute, remat "full", each rank 32 of the 64 routed experts: the
   overlap ring (a warm-up and 1 step; B4 48 rows + 12 contract a rank a
   step on a tick's (32, 240, 2048) chunk) and the blocking exchange (one
   step; B4 18 + 6 on the (32, 480, 2048) buffer), B1/B2/B3 20/10/10 a rank
   a step on the 1024 x 1024 ring tiles; on each rank's first microbatch in
   each mode every kernel call held to its plain version on the rank's own
   inputs (B2/B3 against the merged statistics, dq also to fp64); then fp32
   steps at 2 layers, 1 x 1024, a no-drop capacity (11 >= E / top_k): the
   overlap ring held to one device's and to an fp64 evaluation by
   GRID_TOLERANCE, the blocking step to the ring's (1e-6), and the control
   (each chunk's expert output rounded to bf16 before the combine), which
   must fail the grads rule; step, exchange, hop and all-reduce ms, peak
   memory and the launches by body; B4 timed on the kept chunk and buffer
   inputs and B1-B3 on the ring tiles. No checkpoint;
19. pipeline parallelism — GPipe and 1F1B (A13.5) on a (pod 2) grid: two rank
   processes (spawn) on the one card over gloo (every pod hop and the pod sum
   through host memory; no PP scaling or stage overlap is measured),
   qwen1.5-4b at full width on 4 of its 40 layers (2 a stage), 4
   microbatches of 1 x 4096 tokens, bf16 compute, remat "full": a checked
   call at M = 2 (every B1-B3 call of both stages held to its plain version
   on the rank's own inputs, dq also to fp64), 1F1B a warm-up and 1 step
   (B1/B2/B3 32/8/8 a step on stage 0, 24/8/8 on the last stage), GPipe
   one step (16/8/8); each schedule's peak memory, step, pod hop and pod
   sum ms; then fp32 steps at 2 layers, 4 x 1 x 1024: both schedules held to
   one device's and to an fp64 evaluation by GRID_TOLERANCE, GPipe to 1F1B
   (1e-6), and the control (each stage's outgoing activation rounded to bf16
   in the pod shift), which must fail the grads rule. No checkpoint;
20. grid serving — the sequence-sharded KV cache and prefill (A13.6) on a
   (1, 2) (data, model) grid: two rank processes (spawn) on the one card over
   gloo (every collective through host memory; no serving scaling is
   measured), gemma2-9b at full width and depth (42 layers, hd 256,
   softcaps, alternating 4,096-token windows, 9.24 B random bf16 weights
   from a seed, whole on each rank): a prefill of 1 x 6,144 tokens (batch 1:
   at batch 2 the two ranks' peaks summed to 77.3 GB), each
   rank's 3,072 queries against the K/V gathered over the ring (B1 42 a rank
   on the hd-256 body, ``flash_fwd_bf16``, at q_offset 0 or 3,072; on layers
   GRID_CHECK_LAYERS held to its plain version), max_seq 8,192 (each rank
   4,096 positions of the cache), 32 greedy decode steps through the sharded
   decode attention, then 2 more with every layer's decode attention held to
   the single-device one on the whole cache (2 bf16 ulps of each head's
   row, the cache writes exact); an fp32 run on 2 layers (1 x 1,536,
   max_seq 2,048, 16 steps) against one device on the same weights (logits
   to 1e-5, the tokens equal), and its control (each rank's partial o rounded
   to bf16 before the combine), which must fail; prefill, decode and combine
   ms, peak memory a rank; B1 timed at the prefill's shapes (a local and a
   global layer) beside its bound, its plain version and SDPA;
21. examples — the five examples of ``src/repro_torch/examples/`` at their
   recipes (fp32; the reduced configs): preempt_resume in this process (40
   steps, a notice before step 23, the resume bit-identical; preempted at 24
   on the disk tier), then in one set of eight rank processes on the card
   over gloo train_moe_ep (100 ep-only steps on (data 2, model 4), the fold on
   (data 2, cp 2, model 2) under both exchanges to 1e-6), pipeline_multipod
   (GPipe and 1F1B against the non-pipelined loss, 10 steps of 1F1B
   training, TP x PP and CP x TP x PP, the MoE twin under both exchanges),
   serve_longcontext (mamba2 and gemma2 on (data 2, model 4), 16-token
   prompts and 32 greedy steps) and, on four of them, straggler_rebalance
   (one rebalance from (2, 2) to (3, 1)). Each asserts its reference's
   readings; the kernels are held to the plain versions on the card at
   EXAMPLE_REL on the same inputs: the loss and every leaf's grad of each
   training example's first step, the fold's and the TP, CP and EP losses
   inside the pipeline's ticks (``ranks.route_check``), and serving's
   prefill last logits and first decode step's, the plain route launching
   nothing; every launch must run the fp32 bodies, and every kernel of an
   example's path must launch; seconds, readings and peak memory a rank;
22. dry run — the estimates (A14.5, ``repro_torch.launch.dryrun.estimate``) of
   the single-device cells, computed from the end of phase 2 in a child
   process on the host (``CUDA_VISIBLE_DEVICES`` empty: meta tensors under
   the kernels' route, nothing built or launched there; its launch counters
   must stay 0): qwen1.5-4b, deepseek-moe-16b (4 layers), mamba2-370m,
   zamba2-1.2b and whisper-small training at the phases' own rows and plans,
   and the qwen2.5-14b and deepseek-moe-16b serving prefill and decode. For
   each, the estimate's static bytes (params and moments; params and the
   decode cache for serving) beside what the phase allocated for them
   (``torch.cuda.memory_allocated()`` around the init and the moments, the
   batches left out), within DRYRUN_STATIC_REL; the traced peak beside the
   phase's ``torch.cuda.max_memory_allocated()``, within DRYRUN_PEAK_REL on
   every training cell (serving peaks are readings);
23. times   — each kernel's time at its path's shapes beside its bound, its plain
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
training, data-, tensor-, context-, expert- and pipeline-parallel training; the
fp32 TP, CP, EP and PP steps' B1, B4, B5 and B6 excepted, and the grid prefill's
B1 at hd 256, which must run the first version's body) must run the Hopper body
(``check_bodies``, from the wrappers' per-body
counters); the kernels line reports those counters by body.

The single-device serving and training phases (4-6 and 9-11) take their
model and their timed train and decode fns from
``repro_torch.launch.build_step`` (phase 7's 4 of 28 layers are no shape
name's: it builds its own); each serving phase also runs ``build_step``'s
prefill fn once on the timed prefill's batch, whose logits must equal the
timed prefill's bit for bit (whisper's timed prefill is ``fill_cross``: its
encoder output against the fn's), and each training phase prints a
``Roofline`` row beside its step time. The multi-rank phases print each
collective kind's link bytes (``collective_stats()``) beside its seconds.

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

# the H100's rates and the reckoned FLOPs of a step: one copy, in the port
from repro_torch.perf.roofline import (PEAK_BF16_FLOPS, PEAK_BYTES, Roofline,  # noqa: E402
                                       model_flops_for, n_apps, ssd_flops, train_bytes,
                                       train_flops)

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
# B1-B3 at the head dims the reference's kernel takes beside the four bodies' own
# (a multiple of 8 up to 256): the fp32 and first-version bf16 bodies at the least
# HD of 32, 64, 128, 256 that holds hd, the columns past hd masked. hd 16 is the
# straggler example's (slow-demo), 40, 72, 96 and 200 sit inside 64, 128, 128 and
# 256 (96 in bf16 on the first-version body, not the Hopper body's 128), 8 is the
# least. Ragged, windowed, softcapped and fully masked rows among them;
# phase_kernels and phase_kernels_bwd run each in both dtypes, and
# tests/test_torch_flash_hd.py runs the same list on the card.
HD_CASES = [
    (2, 4, 2, 100, 100, 16, True, 0, 0.0, 0),          # ragged S and T
    (1, 4, 4, 256, 256, 16, True, 40, 0.0, 0),         # window
    (1, 2, 1, 64, 16, 16, True, 8, 0.0, 64),           # fully masked rows
    (1, 4, 2, 130, 130, 40, True, 0, 30.0, 0),         # softcap, ragged
    (1, 4, 2, 200, 300, 40, True, 48, 0.0, 100),       # window, q_offset
    (1, 2, 1, 64, 16, 40, True, 8, 0.0, 64),           # fully masked rows
    (2, 4, 2, 96, 160, 72, False, 0, 0.0, 0),          # cross lengths
    (1, 4, 1, 128, 128, 72, True, 33, 20.0, 0),        # window and softcap
    (1, 4, 4, 128, 128, 8, True, 0, 0.0, 0),
    (1, 4, 2, 150, 150, 96, True, 0, 0.0, 0),
    (1, 2, 1, 96, 96, 200, True, 40, 0.0, 0),
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
    # the expert-parallel exchange (EP_SEQ over two ranks: C 240 a peer): a rank's
    # 32 experts on one ring tick's chunk and on the blocking path's two peers'
    # rows, every row real to the kernel (group sizes None)
    (32, 240, 2048, 1408, None, False), (32, 240, 1408, 2048, None, False),
    (32, 480, 2048, 1408, None, False), (32, 480, 1408, 2048, None, False),
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
# the checkpoint, fault-tolerance and data-parallel phases keep whisper-small's full width on
# WHISPER_CUT_LAYERS of its 12 encoder and 12 decoder layers each (the script's
# time limit: 6 until the expert-parallel phase, 4 until the grid serving phase)
WHISPER_CUT_LAYERS = 2
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

# the dry run's estimates of the single-device cells (phase 22): the child's
# time limit, the holds, and what each phase measured ({cell: {"static",
# "peak"}}, bytes)
DRYRUN_TIMEOUT = 1100
DRYRUN_STATIC_REL, DRYRUN_PEAK_REL = 0.01, 0.15
MEMORY = {}


def note_memory(cell, **readings):
    """A phase's memory readings (bytes) for the dry run's holds (phase 22)."""
    MEMORY.setdefault(cell, {}).update(readings)
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


def check_bodies(what, counts, window=None, fp32=False):
    """Every B1 and B4 launch counted in ``counts`` (all_counts() since the
    last reset_counts(), then ssd_counts() on the SSM paths) ran the Hopper
    body, and so did every B5 and B6 launch (with ``fp32``: the fp32 bodies of
    B1 and B4 and the first-version bodies of B5 and B6, the only ones that
    take fp32 inputs); the counts by body are kept under ``window`` for the
    kernels line."""
    got = body_counts()
    b4 = counts[3] + counts[4]
    b5, b6 = counts[5:7] if len(counts) > 5 else (0, 0)
    log(f"bodies, {what}: " + ", ".join(f"{k} {v}" for k, v in got.items())
        + f" (B1 {counts[0]}, B4 {b4}, B5 {b5}, B6 {b6} launches)")
    want = dict.fromkeys(got, 0)
    if fp32:
        want.update(flash_fwd_f32=counts[0], gg_f32=b4, ssd_fwd_simt=b5, ssd_bwd_simt=b6)
    else:
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


def link_bytes_since(ring, before):
    """{kind: link bytes} that ``ring`` (a ``DataMesh`` or ``ModelRing``)
    counted since ``before``, its ``collective_stats()`` then: this rank's
    bytes over links by the ring model, beside its ``seconds`` by kind."""
    return (ring.collective_stats() - before).link_bytes


def roofline_row(cfg, rows, seq, flops, params, step_s):
    """One device's ``Roofline`` of a train step of ``rows`` x ``seq`` tokens
    beside its measured time: the reckoned FLOPs at the bf16 peak, the stated
    floor of bytes (params, grads and both moments read and written once) at
    HBM's rate, no collectives. Logged."""
    from repro_torch.core import InputShape
    r = Roofline(cfg.arch_id, f"train {rows}x{seq}", "1", 1, flops=flops,
                 bytes=train_bytes(params), collective_bytes=0.0,
                 model_flops=model_flops_for(cfg, InputShape("cell", seq, rows, "train")))
    bound = max(r.t_compute, r.t_memory, r.t_collective)
    log(f"roofline {json.dumps(r.row())}; step {step_s * 1e3:.1f} ms against the bound "
        f"{bound * 1e3:.1f} ms ({r.bottleneck}): {bound / step_s:.2%}")


def built(arch, shape_name, plan):
    """``build_step(arch, shape_name, None, plan)`` on the card, its host
    seconds (the meta-device example args included) logged."""
    from repro_torch.launch import build_step
    t0 = time.perf_counter()
    out = build_step(arch, shape_name, None, plan)
    log(f"build_step {arch} {shape_name}: {time.perf_counter() - t0:.2f} s")
    return out


def prefill_fn_check(what, fn, params, batch, timed):
    """``build_step``'s prefill fn once on the timed prefill's ``batch``: its
    logits must equal ``timed`` (the timed prefill's, on the host) bit for
    bit, since the same layers run on the same inputs."""
    t0 = time.perf_counter()
    logits = fn(params, batch).cpu()
    same = logits.shape == timed.shape and torch.equal(logits, timed)
    log(f"{what}: build_step's prefill fn against the timed prefill: logits "
        f"{tuple(logits.shape)}, bit-identical {same} ({time.perf_counter() - t0:.2f} s)")
    if not same:
        diff = (logits - timed).abs() if logits.shape == timed.shape else None
        raise AssertionError(
            f"{what}: build_step's prefill fn's logits {tuple(logits.shape)} differ from the "
            f"timed prefill's {tuple(timed.shape)}" + (
                "" if diff is None else f" at {int((diff != 0).sum())} entries, max |diff| "
                f"{diff.max().item():.3e}"))


def profile_window(name, fn):
    """Kernel time by name over one call of ``fn``, and the device's busy share
    of the profiled wall time (the profiler's own overhead included). Only the
    CUDA activity is traced, and the device events are summed straight from
    the profiler's raw results: the host-side op events, and building
    ``key_averages()``'s Python events from the raw ones, add nothing these
    numbers read and cost ~30 s and ~10 s of trace processing for a step of
    ~30,000 kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_open = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_read = time.perf_counter()
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.name().startswith("["):
            ns, count = kernels.get(e.name(), (0, 0))
            kernels[e.name()] = (ns + e.duration_ns(), count + 1)
    busy = sum(ns for ns, _ in kernels.values()) / 1e9
    log(f"profile {name}: wall {wall * 1e3:.2f} ms, kernels {busy * 1e3:.2f} ms, "
        f"device busy {busy / wall:.1%} ({sum(c for _, c in kernels.values())} device events; "
        f"the profiler's own {t_read - t_open - wall:.2f} s + {time.perf_counter() - t_read:.2f} "
        f"s to read)")
    for key, (ns, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {ns / 1e6:9.3f} ms  x{count:<5d} {key[:100]}")


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
    """B1 against its plain version on every FLASH_CASES and HD_CASES row in both
    dtypes and,
    in bf16, at the training path's shape (qwen1.5-4b's), zamba2's training and
    serving shapes and whisper's decoder self-attention in training, where two
    launches must also be bit-identical. Returns the bf16 errors at the
    serving, training, zamba2 and whisper shapes."""
    from repro_torch.kernels.flash_attention import flash_attention_lse
    gen = torch.Generator(device="cuda").manual_seed(0)
    path_errs = {}
    whisper = {case: f"whisper_{name}" for name, case in WHISPER_CASES.items()}
    for case in FLASH_CASES + HD_CASES:
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
    from repro_torch.core import ParallelPlan
    from repro_torch.kernels.flash_attention import flash_attention_lse
    from repro_torch.models import build_model

    smoke_agreement()
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16")
    prefill_fn, _, _, meta = built(ARCH, "prefill_32k", plan)
    decode = built(ARCH, "decode_32k", plan)[0]
    cfg, model = meta["cfg"], meta["model"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
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
    decode(params, cache, lg[:, -1].argmax(-1), PROMPT)
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
    timed_logits = logits.cpu()
    del logits
    t0 = time.perf_counter()
    out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
    for i in range(DECODE_STEPS):
        lg, cache = decode(params, cache, tok, PROMPT + i)
        finite &= torch.isfinite(lg).all()      # checked after the loop: no sync
        tok = lg.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / DECODE_STEPS
    if not finite:
        raise AssertionError("decode logits are not finite")
    launches = flash_attention_lse.launches
    peak = torch.cuda.max_memory_allocated()
    # the params and the cache (and a few tokens' logits): the dry run's static bytes
    note_memory(f"{ARCH} serving", static=torch.cuda.memory_allocated() - base, peak=peak)
    log(f"serving {ARCH}: prefill {BATCH}x{PROMPT} in {t_prefill * 1e3:.1f} ms = "
        f"{BATCH * PROMPT / t_prefill:.0f} tokens/s; decode {t_decode * 1e3:.2f} "
        f"ms/step (batch {BATCH}); peak memory {peak / 1e9:.2f} GB; "
        f"flash_fwd launches {launches}")
    log(f"generated tokens, row 0: {torch.stack(out, 1)[0, :10].tolist()}")
    profile_window("decode step", lambda: decode(params, cache, tok, PROMPT + DECODE_STEPS))
    del cache
    profile_window("prefill", lambda: model.prefill(params, batch, max_seq=MAX_SEQ))
    prefill_fn_check(f"{ARCH} prefill", prefill_fn, params, batch, timed_logits)
    del timed_logits

    plain = build_model(cfg, ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16",
                                         attn_impl="plain"))
    real_ulps = kernel_on_real_inputs(model, plain, params, cfg)
    return launches, real_ulps


def phase_kernels_bwd():
    """The dq and dk/dv kernels against their plain version: every FLASH_CASES,
    BWD_CASES and HD_CASES row and the training paths' shapes (qwen1.5-4b's, hd 128;
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
    for case in dict.fromkeys(FLASH_CASES + BWD_CASES + HD_CASES + list(paths)):
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
    Each call is judged at its dtype's limit (GRAD_TOLERANCE).
    ``functools.wraps`` copies the launch counters onto the wrapper, so these
    launches leave the real counts alone."""

    def __init__(self, fp64=False):
        self.fp64, self.dq64 = fp64, []

    def __enter__(self):
        from repro_torch.kernels import flash_attention as tf
        self.real, self.errs, self.oks = tf.flash_attention_bwd, [], []
        real = self.real

        @functools.wraps(real)
        def checked_bwd(q, k, v, do, lse, delta, **kw):
            grads = real(q, k, v, do, lse, delta, **kw)
            ref = tf.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
            errs = [grad_error(g, r) for g, r in zip(grads, ref)]
            self.errs.append(errs)
            self.oks.append(grads_within(q.dtype, errs))
            if self.fp64:
                truth = dq_fp64(q, k, v, do, lse, delta, **kw)
                kern = grad_error(grads[0], truth)
                self.dq64.append((kern[1], grad_error(ref[0], truth)[1]))
                self.oks[-1] &= grads_within(q.dtype, [kern])
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
            f"{worst[0]:.3g}/{worst[1]:.3g}/{worst[2]:.3g} in the limit's measure (bf16 ulps; "
            f"fp32: of the tensor's max)")
        if self.dq64:
            kern, plain = (max(e[i] for e in self.dq64) for i in range(2))
            log(f"real inputs, {what}: dq against an fp64 evaluation, worst of {calls} calls: "
                f"the kernel {kern:.3g}, the fp32 plain version {plain:.3g} in the same measure")
            worst.append(kern)
        if not all(self.oks):
            raise AssertionError(f"flash_bwd disagrees with its plain version (or, for dq, "
                                 f"with fp64) on the {what}'s own inputs")
        return max(worst[1:3]), worst[0]


class FlashFwdCapture:
    """Within the block, every call of B1's wrapper (as FlashAttention.forward
    makes it) is held to the plain version (flash_plain) on its own (q, k, v),
    fully masked rows exactly, each at its dtype's limit (TOLERANCE), and
    must run the body ``summary`` names (the Hopper body unless told).
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
            self.errs.append((*match_errors(o, lse, po, plse), dead_rows_ok(o, lse, plse)[1],
                              o.dtype))
            return o, lse
        self.wrapper = checked_fwd
        tf.flash_attention_lse = checked_fwd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as tf
        tf.flash_attention_lse = self.real

    def summary(self, what, calls, body="sm90", launches=None):
        """Check that ``calls`` calls were held, each through ``body`` ("sm90",
        the Hopper body; "mma", the first version's; "f32", the fp32 one), of
        ``launches`` through it (``calls`` unless given), and log them;
        returns the worst o error in bf16 ulps (None when no call was
        expected)."""
        attr = f"{body}_launches"
        through = getattr(self.wrapper, attr) - getattr(self.real, attr)
        if len(self.errs) != calls or through != (calls if launches is None else launches):
            raise AssertionError(f"checked {len(self.errs)} attention forwards on the {what} "
                                 f"({through} through the {body} body), expected {calls}")
        if not calls:
            return None
        o_abs, o_ulps, lse_rel = (max(e[i] for e in self.errs) for i in range(3))
        dead_ok = all(e[3] for e in self.errs)
        log(f"real inputs, {what}: B1 held to its plain version on {calls} calls, max o err "
            f"{o_abs:.3e} = {o_ulps:.2f} bf16 ulps, lse rel err {lse_rel:.3e}, fully "
            f"masked rows exact {dead_ok}")
        if not all(within_tolerance(e[4], *e[:3]) and e[3] for e in self.errs):
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
    from repro_torch.core import InputShape, ParallelPlan
    from repro_torch.data import SyntheticDataset
    from repro_torch.examples.quickstart import run as quickstart
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_lse
    from repro_torch.optim import adamw_init
    from repro_torch.core.tree import leaves
    from repro_torch.train import TrainState

    train_smoke_agreement()
    t0 = time.perf_counter()
    losses = quickstart()
    log(f"quickstart on the card: {len(losses)} steps in {time.perf_counter() - t0:.1f} s; "
        f"losses {[round(x, 4) for x in losses]}")
    if not losses[-1] < 2.5:
        raise AssertionError(f"quickstart loss at step {len(losses) - 1} is {losses[-1]}")

    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    step, _, _, meta = built(TRAIN_ARCH, "train_4k", plan)
    cfg, model = meta["cfg"], meta["model"]
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    n_params = sum(p.numel() for p in leaves(params))
    log(f"init {TRAIN_ARCH}: {n_params / 1e9:.3f} B params (fp32) in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(TRAIN_STEPS + 2)]
    real = backward_on_real_inputs(model, params, cfg, batches[0])

    base = torch.cuda.memory_allocated()
    state = TrainState(params, adamw_init(params))
    note_memory(f"{TRAIN_ARCH} training", static=held + torch.cuda.memory_allocated() - base)
    del params
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
    note_memory(f"{TRAIN_ARCH} training", peak=peak)
    step_s = sum(times) / len(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens)
    log(f"training {TRAIN_ARCH} full width ({TRAIN_BATCH} x {TRAIN_SEQ}, microbatches "
        f"{TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms (mean of {TRAIN_STEPS}), "
        f"{tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} FLOP/step, mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    roofline_row(cfg, TRAIN_BATCH, TRAIN_SEQ, flops, state.params, step_s)
    profile_window("train step", lambda: step(state, batches[-1]))
    return {"launches": launches, "real_dkv_ulps": real[0], "real_dq_ulps": real[1]}


def bwd_times_at(case, gen, inputs=None):
    """B2 and B3 at one bf16 shape (CUDA events) beside their bounds; the
    whole FlashAttention.backward (the delta pass, B2 and B3) and SDPA's
    backward, both through autograd on the same q, k, v and dO. ``inputs``
    (q, k, v, dO, lse, delta) in place of ``bwd_inputs``' draw, for
    statistics merged over more keys than the case's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tf
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = case
    q, k, v, do, lse, delta = inputs or bwd_inputs(gen, case, torch.bfloat16)
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


def fwd_times_at(case, gen, bodies=("sm90", "mma"), masked_library=False):
    """B1 (CUDA events) at one bf16 shape, through the Hopper body and
    through the first-version mma.sync body (``bodies``: the first is the
    path's, whose time is ``ms``), beside its bound, the plain version
    (flash_plain: in blocks of query rows where one call's fp32 scores would
    pass PLAIN_SCORES) and SDPA (``masked_library``: under the case's causal
    and window mask at its q_offset, as a boolean mask; SDPA has no softcap).
    The bound counts the attended pairs (two products, 4 hd FLOP a pair) and
    q, k, v read and o, lse written once."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tf
    from repro_torch.models.layers import attn_mask
    b, hq, hkv, s, t, hd, causal, window, cap, q_offset = case
    q = batch_major(gen, b, hq, s, hd, torch.bfloat16)
    k = batch_major(gen, b, hkv, t, hd, torch.bfloat16)
    v = batch_major(gen, b, hkv, t, hd, torch.bfloat16)
    kw = dict(case_kw(case), scale=hd ** -0.5)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    ms = {body: cuda_ms(lambda: tf._fwd_launch(body, q, k, v, o, lse, **kw), 20)
          for body in bodies}
    plain_ms = cuda_ms(lambda: flash_plain(q, k, v, **case_kw(case)), 3, warmup=1)
    if masked_library:
        mask = attn_mask(q_offset + torch.arange(s, device="cuda"),
                         torch.arange(t, device="cuda"), causal=causal, window=window)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=hq != hkv), 5)
    else:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv), 20)
    flops = 4 * hd * attended_pairs(s, t, causal, window, q_offset) * b * hq
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    res = {"shape": list(case[:6]), "ms": ms[bodies[0]], "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if "mma" in ms and bodies[0] != "mma":
        res["mma_ms"] = ms["mma"]
    log(f"flash_fwd at {case}: " + ", ".join(f"{b_} body {m:.4f} ms" for b_, m in ms.items())
        + f", bound {res['bound_ms']:.4f} ms ({flops:.3e} FLOP, {nbytes / 1e6:.1f} MB, "
        f"{res['bound_by']}), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms")
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
    from repro_torch.core import ParallelPlan, leaves
    from repro_torch.models import build_model

    smoke_agreement(MOE_ARCH)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16")
    prefill_fn, _, _, meta = built(MOE_ARCH, "prefill_32k", plan)
    decode = built(MOE_ARCH, "decode_32k", plan)[0]
    cfg, model = meta["cfg"], meta["model"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"init {MOE_ARCH}: {n_params / 1e9:.2f} B params (bf16) in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                                     device="cuda")}

    lg, cache = model.prefill(params, batch, max_seq=MAX_SEQ)        # warm-up
    decode(params, cache, lg[:, -1].argmax(-1), PROMPT)
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
    timed_logits = logits.cpu()
    del logits
    reset_counts()
    t0 = time.perf_counter()
    out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
    for i in range(DECODE_STEPS):
        lg, cache = decode(params, cache, tok, PROMPT + i)
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
    note_memory(f"{MOE_ARCH} serving", static=torch.cuda.memory_allocated() - base, peak=peak)
    log(f"serving {MOE_ARCH}: prefill {BATCH}x{PROMPT} (einsum dispatch) in "
        f"{t_prefill * 1e3:.1f} ms = {BATCH * PROMPT / t_prefill:.0f} tokens/s; decode "
        f"{t_decode * 1e3:.2f} ms/step (batch {BATCH}); peak memory {peak / 1e9:.2f} GB; "
        f"launches per prefill B1 {prefill_launches[0]}, B4 {prefill_launches[3]}; per "
        f"decode step B4 {decode_launches[3] // DECODE_STEPS}")
    log(f"generated tokens, row 0: {torch.stack(out, 1)[0, :10].tolist()}")

    scatter = built(MOE_ARCH, "prefill_32k",
                    dataclasses.replace(plan, moe_dispatch="scatter"))[3]["model"]
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

    profile_window("MoE decode step", lambda: decode(params, cache, tok, PROMPT + DECODE_STEPS))
    del cache
    profile_window("MoE prefill (einsum)", lambda: model.prefill(params, batch, max_seq=MAX_SEQ))
    profile_window("MoE prefill (scatter)",
                   lambda: scatter.prefill(params, batch, max_seq=MAX_SEQ))
    prefill_fn_check(f"{MOE_ARCH} prefill", prefill_fn, params, batch, timed_logits)
    del timed_logits

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
    # MOE_TRAIN_LAYERS of the 28 layers (the fp32 state of all 28 does not fit
    # on one card): no shape name gives that config, so this phase builds its
    # model and step itself rather than through build_step
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    model = build_model(cfg, plan)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
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

    base = torch.cuda.memory_allocated()
    state = TrainState(params, adamw_init(params))
    note_memory(f"{MOE_ARCH} training", static=held + torch.cuda.memory_allocated() - base)
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
    note_memory(f"{MOE_ARCH} training", peak=peak)
    step_s = sum(times) / len(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens)
    log(f"training {MOE_ARCH} full width, {MOE_TRAIN_LAYERS} layers ({TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, microbatches {TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms "
        f"(mean of {TRAIN_STEPS}), {tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} "
        f"FLOP/step (active params, no recompute, no dispatch einsums), mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    roofline_row(cfg, TRAIN_BATCH, TRAIN_SEQ, flops, state.params, step_s)
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
    whole output written, 2 FLOP a multiply-add of real rows (every row where
    the call has no group sizes, as on the expert-parallel path)."""
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
        if gs is None:
            gs = torch.full((e,), m if mask == "rows" else k, dtype=torch.int32, device="cuda")
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


def phase_ssm_serving(arch):
    """``arch`` (mamba2-370m or zamba2-1.2b) at full width and depth, random bf16
    weights from a seed: the smoke config against the CPU; forward under
    no_grad over SSM_BATCH x SSM_PROMPT tokens (the prefill metric) with the
    launches counted; a SSM_DECODE_PROMPT-token prompt through decode_step, then
    DECODE_STEPS greedy steps; profiles; B5 held to its plain version on every
    layer's own inputs of the forward; B5 timed on them."""
    from repro_torch.core import ParallelPlan, leaves

    ssm_smoke_agreement(arch)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16")
    prefill_fn, _, _, meta = built(arch, "prefill_32k", plan)
    decode = built(arch, "decode_32k", plan)[0]
    cfg, model = meta["cfg"], meta["model"]
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
        timed_logits = logits.cpu()
        del logits

        # the reference's serving flow for these families: the prompt through
        # decode_step, then greedy steps
        prompt = batch["tokens"][:, :SSM_DECODE_PROMPT]
        cache = model.init_cache(SSM_BATCH, SSM_DECODE_PROMPT + DECODE_STEPS + 1)
        steps = []
        for t in range(SSM_DECODE_PROMPT):
            lg, cache = decode(params, cache, prompt[:, t], t)
            steps.append(lg)
        ref = model.forward(params, {"tokens": prompt})[0]
        drift = ((torch.stack(steps, 1) - ref).abs().max() / ref.abs().max()).item()
        tok = lg.argmax(-1)
        reset_counts()
        reset_ssd_counts()
        t0 = time.perf_counter()
        out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
        for i in range(DECODE_STEPS):
            lg, cache = decode(params, cache, tok, SSM_DECODE_PROMPT + i)
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
        profile_window(f"{arch} decode step", lambda: decode(
            params, cache, tok, SSM_DECODE_PROMPT + DECODE_STEPS))
        del cache
        profile_window(f"{arch} forward", lambda: model.forward(params, batch))
        prefill_fn_check(f"{arch} forward", prefill_fn, params, batch, timed_logits)
        del timed_logits
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
    from repro_torch.core import InputShape, ParallelPlan, leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.core.tree import map_tree
    from repro_torch.train import Hyper, TrainState, make_loss_fn

    timed(f"{arch} smoke training", train_smoke_agreement, arch)
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    step, _, _, meta = built(arch, "train_4k", plan)
    cfg, model = meta["cfg"], meta["model"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    params = model.init(gen)
    random_conv_taps(params, gen)
    for p in leaves(params):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
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

    base = torch.cuda.memory_allocated()
    state = TrainState(params, adamw_init(params))
    note_memory(f"{arch} training", static=held + torch.cuda.memory_allocated() - base)
    del params
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
    note_memory(f"{arch} training", peak=peak)
    step_s = sum(times_s) / len(times_s)
    tokens = batch_size * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens, params=state.params)
    log(f"training {arch} full width and depth ({batch_size} x {TRAIN_SEQ}, microbatches "
        f"{TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms (mean of {TRAIN_STEPS}), "
        f"{tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} FLOP/step, mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    roofline_row(cfg, batch_size, TRAIN_SEQ, flops, state.params, step_s)
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
    from repro_torch.core import InputShape, ParallelPlan, leaves
    from repro_torch.data import SyntheticDataset

    encdec_smoke_agreement()
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16")
    prefill_fn, _, _, meta = built(WHISPER_ARCH, "prefill_32k", plan)
    decode = built(WHISPER_ARCH, "decode_32k", plan)[0]
    cfg, model = meta["cfg"], meta["model"]
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
            lg, cache = decode(params, cache, prompt[:, t], t)
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
            lg, cache = decode(params, cache, prompt[:, t], t)
        tok = lg.argmax(-1)
        reset_counts()
        t0 = time.perf_counter()
        out, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
        for i in range(DECODE_STEPS):
            lg, cache = decode(params, cache, tok, WHISPER_PROMPT + i)
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
        profile_window(f"{WHISPER_ARCH} decode step", lambda: decode(params, cache, tok, pos))
        profile_window(f"{WHISPER_ARCH} fill_cross", lambda: model.fill_cross(
            params, cache, frames))
        whisper_prefill_fn_check(model, prefill_fn, params, cache, batch)
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


def whisper_prefill_fn_check(model, prefill_fn, params, cache, batch):
    """whisper's timed prefill is ``fill_cross``, which returns no logits:
    ``build_step``'s prefill fn (the model's forward on the prompt and its
    frames) runs the same encoder on the same frames, so the encoder output
    of one run of each must be equal bit for bit, and the fn's logits finite
    of shape (B, prompt, vocab)."""
    encoded = []

    def encode(p, frames):
        encoded.append(type(model).encode(model, p, frames))
        return encoded[-1]
    model.encode = encode
    try:
        model.fill_cross(params, cache, batch["frames"])
        logits = prefill_fn(params, batch)
    finally:
        del model.encode
    same = len(encoded) == 2 and torch.equal(encoded[0], encoded[1])
    log(f"{WHISPER_ARCH}: build_step's prefill fn against fill_cross: encoder output "
        f"{tuple(encoded[0].shape)} bit-identical {same}; logits {tuple(logits.shape)}")
    want = tuple(batch["tokens"].shape) + (model.cfg.vocab,)
    if not same or tuple(logits.shape) != want or not torch.isfinite(logits).all():
        raise AssertionError(f"{WHISPER_ARCH}: build_step's prefill fn disagrees with "
                             f"fill_cross's encoder, or its logits are not finite {want}")


def whisper_cut(cfg):
    """whisper-small at full width on WHISPER_CUT_LAYERS encoder and decoder
    layers."""
    return dataclasses.replace(cfg, n_layers=WHISPER_CUT_LAYERS, enc_layers=WHISPER_CUT_LAYERS)


def whisper_train_setup(cut=False):
    """whisper-small's full-width training model and step (fp32 masters, bf16
    compute, remat "full", TRAIN_MICRO microbatches; ``build_step``'s, or with
    ``cut`` ``whisper_cut``'s layers, which no shape name gives, built here),
    its params from seed 0 as autograd leaves, and train_4k batches of
    WHISPER_TRAIN_BATCH sequences with their frames."""
    from repro_torch.core import InputShape, ParallelPlan, get_config, leaves
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_train_step
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    if cut:
        cfg = whisper_cut(get_config(WHISPER_ARCH))
        model = build_model(cfg, plan)
        step = make_train_step(model, plan, Hyper())
    else:
        step, _, _, meta = built(WHISPER_ARCH, "train_4k", plan)
        cfg, model = meta["cfg"], meta["model"]
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    for p in leaves(params):
        p.requires_grad_(True)
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, WHISPER_TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(TRAIN_STEPS + 2)]
    return cfg, plan, model, params, batches, step


def phase_whisper_training():
    """The smoke config against the CPU and under the remat modes, then
    whisper-small at full width and depth: B1/B2/B3 held to their plain
    versions on every call of one microbatch, one warm-up and TRAIN_STEPS timed
    steps with the launches counted (B1 144, B2 72, B3 72 a step), a profile."""
    from repro_torch.core import leaves
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.core.tree import map_tree
    from repro_torch.train import Hyper, TrainState, make_loss_fn

    timed(f"{WHISPER_ARCH} smoke training", train_smoke_agreement, WHISPER_ARCH)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    cfg, plan, model, params, batches, step = whisper_train_setup()
    torch.cuda.synchronize()
    # the params: what the setup allocated but its batches
    held = torch.cuda.memory_allocated() - base - sum(
        t.numel() * t.element_size() for b in batches for t in b.values())
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

    base = torch.cuda.memory_allocated()
    state = TrainState(params, adamw_init(params))
    note_memory(f"{WHISPER_ARCH} training", static=held + torch.cuda.memory_allocated() - base)
    del params
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
    note_memory(f"{WHISPER_ARCH} training", peak=peak)
    step_s = sum(times) / len(times)
    tokens = WHISPER_TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, tokens)
    log(f"training {WHISPER_ARCH} full width and depth ({WHISPER_TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens and {WHISPER_TRAIN_BATCH} x {cfg.enc_frames} frames, microbatches "
        f"{TRAIN_MICRO}, remat full): step {step_s * 1e3:.1f} ms (mean of {TRAIN_STEPS}), "
        f"{tokens / step_s:.0f} tokens/s, reckoned {flops:.4e} FLOP/step, mfu "
        f"{flops / step_s / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    roofline_row(cfg, WHISPER_TRAIN_BATCH, TRAIN_SEQ, flops, state.params, step_s)
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
    """A checkpoint round trip of whisper-small's full-width training state
    (``whisper_cut``'s layers: the script's time limit) in
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
    from repro_torch.train import TrainState, init_train_state

    cfg, plan, model, params, batches, step = whisper_train_setup(cut=True)
    state = TrainState(params, adamw_init(params))
    del params
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
# fault tolerance (phase 13): the seams and the chaos schedule

# whisper-small at full width and depth under run_with_recovery: the training
# phase's plan with the batch cut to FT_BATCH x TRAIN_SEQ tokens (FT_BATCH x 1500
# frames, TRAIN_MICRO microbatches), FT_STEPS steps, a checkpoint every FT_EVERY.
# Each checkpoint writes the state to the machine's disk, whose writes a call may
# not take past 45 GiB (deleted files count): the chaos run's 11 steps save 4 (0,
# 4, the dropped 8, 8 again).
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
    end equal to the clean run bit for bit, losses included; every step's
    B1/B2/B3 launches counted on the Hopper bodies; then the audit's cost: 3
    steps with ``integrity="audit"`` against 3 without. The preemption round
    (a real SIGTERM and a resume) is ``phase_cli``'s, from another process at
    full depth."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import InputShape, ParallelPlan, RecoveryPolicy, get_config
    from repro_torch.core.tree import map_tree
    from repro_torch.data import SyntheticDataset
    from repro_torch.ft import FlightRecorder, Monitor, run_with_recovery
    from repro_torch.ft.inject import FaultSpec, armed, make_injector, trace_with_faults
    from repro_torch.ft.integrity import audit
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, init_train_state, make_train_step

    seams = ft_seam_checks()
    cfg = whisper_cut(get_config(WHISPER_ARCH))
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=TRAIN_MICRO)
    log(f"fault tolerance: {WHISPER_ARCH} at full width; cut: {cfg.enc_layers} + "
        f"{cfg.n_layers} layers, the batch {WHISPER_TRAIN_BATCH} -> {FT_BATCH} x {TRAIN_SEQ} "
        f"tokens ({FT_BATCH} x {cfg.enc_frames} frames), {FT_STEPS} steps")
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
    bad = {k: v for k, v in {**chaos_ok, "audit_div": audit_div == 0.0}.items() if not v}
    if bad:
        raise AssertionError(f"fault-tolerance phase: failed {sorted(bad)}")
    return {
        "batch": [FT_BATCH, TRAIN_SEQ], "steps": FT_STEPS, "seams": seams,
        "clean_step_ms": ms, "clean_losses": losses,
        "chaos": {"actions": report.actions, "restores": report.restores,
                  "ckpt_fallbacks": report.ckpt_fallbacks, "steps_run": chaos_calls,
                  "seconds": chaos_s, "restores_by_tier": restores,
                  "disk_reads": disk_restores, "checks": chaos_ok},
        "launches": launches, "audit": {"steps_off_ms": timing["off"],
                                        "steps_audit_ms": timing["audit"],
                                        "audit_alone_ms": audit_ms, "div": audit_div},
    }


# ---------------------------------------------------------------------------
# the training CLI (phase 14)

# ``python -m repro_torch.launch.train`` at whisper-small's full width and depth:
# Whisper's decoder context of 448 tokens (arXiv:2212.04356), batch 2 with its 2
# x 1500 frames, CLI_STEPS steps, remat "none" (a process's first checkpointed
# step imports ~9 s of modules, which the child would spend before it can stop),
# no RAM tier (its snapshot of the 4.01 GB state with digests and a mirror would
# follow every step), a checkpoint at step 0 only (--ckpt-every past --steps) and
# the just-in-time snapshot: two disk writes, one restore, one child process.
# The SIGTERM goes CLI_SIGNAL_DELAY s after step 0's manifest lands: the child
# frees the save's 4 GB of host buffers before its first preemption check, and a
# signal there would stop it at step 0. The child then sleeps 2 s before step 1
# (--simulate-hang-at 1), so the signal lands inside the driver before step 1 or
# during that sleep: it stops at step 1 or 2.
CLI_STEPS, CLI_SIGNAL_DELAY = 6, 2.0
CLI_ARGV = ["--arch", WHISPER_ARCH, "--full", "--batch", "2", "--seq", "448",
            "--steps", str(CLI_STEPS), "--ckpt-every", str(CLI_STEPS + 1),
            "--ckpt-memory-keep", "0", "--remat", "none"]
CLI_TIMEOUT = 300                 # seconds: the child's start-up to its exit


def cli_per_step(cfg, plan):
    """B1, B2, B3, B4 rows and B4 contract launches of one whisper train step
    under ``plan``: one B1 per attention call of each microbatch, twice under
    remat "full" (its recompute), one B2 and one B3 per call."""
    calls = plan.microbatches * (cfg.enc_layers + 2 * cfg.n_layers)
    return (calls * (2 if plan.remat == "full" else 1), calls, calls, 0, 0)


def cli_leaf_diffs(a, b):
    """{leaf: max |a - b|} of the leaves where two train states differ."""
    from repro_torch.core.tree import named_leaves
    out = {}
    for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        x, y = (torch.stack(v) if isinstance(v, list) else torch.as_tensor(v) for v in (x, y))
        if not torch.equal(x, y):
            out[name] = float((x.detach().double() - y.detach().double()).abs().max())
    return out


def phase_cli():
    """The CLI preempted by a SIGTERM from another process and resumed
    (module docstring, phase 14)."""
    import re
    import shutil
    import signal
    import tempfile
    import threading
    from repro_torch.ft.preempt import read_marker
    from repro_torch.launch import train as cli

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cli_", dir=ROOT / "build"))
    ckpt = tmp / "ckpt"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT / "src")
    lines = []
    t_spawn = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGV, "--ckpt-dir", str(ckpt),
         "--flight-path", str(tmp / "flight.json"), "--simulate-hang-at", "1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    pump = threading.Thread(target=lambda: lines.extend(
        (time.perf_counter(), line) for line in child.stdout), daemon=True)
    pump.start()
    try:
        # the clean run, while the child starts
        args = cli.parse(CLI_ARGV + ["--ckpt-dir", str(tmp / "clean")])
        built = cli.build(args)
        per_step = cli_per_step(built.cfg, built.plan)
        reset_counts()
        clean, losses, ms = built.state, [], []
        for i in range(CLI_STEPS):
            batch = {k: torch.from_numpy(v).cuda() for k, v in built.dataset.batch(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clean, m = built.step_fn(clean, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"cli: clean run in this process, {CLI_STEPS} steps {[round(x, 1) for x in ms]} ms, "
            f"losses {losses}")
        del built

        manifest = ckpt / "ckpt_00000000.json"
        while not manifest.exists():
            if child.poll() is not None or time.perf_counter() - t_spawn > CLI_TIMEOUT:
                raise AssertionError("the CLI child wrote no step-0 checkpoint:\n"
                                     + "".join(line for _, line in lines)[-4000:])
            time.sleep(0.02)
        t_manifest = time.perf_counter()
        time.sleep(CLI_SIGNAL_DELAY)
        os.kill(child.pid, signal.SIGTERM)
        t_signal = time.perf_counter()
        rc = child.wait(timeout=CLI_TIMEOUT)
        t_exit = time.perf_counter()
        pump.join(timeout=10)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    out = "".join(line for _, line in lines)
    log("cli child: " + out.strip().replace("\n", "\ncli child: "))
    started = next((t for t, line in lines if line.startswith("[train] arch=")), None)
    said = re.search(r"\[train\] preempted at step (\d+) \(signal (\d+)\)", out)
    marker = read_marker(ckpt)
    flight_path = tmp / "flight.json"
    flight = json.loads(flight_path.read_text()) if flight_path.exists() else {"events": []}
    saves = [e for e in flight["events"] if e["kind"] == "ckpt.persist"]
    k = marker["step"] if marker else None

    class TimedManager(cli.CheckpointManager):
        reads = []

        def restore(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return super().restore(*a, **kw)
            finally:
                TimedManager.reads.append(time.perf_counter() - t0)
    rargs = cli.parse(CLI_ARGV + ["--ckpt-dir", str(ckpt), "--resume",
                                  "--flight-path", str(tmp / "resume_flight.json")])
    real_manager, cli.CheckpointManager = cli.CheckpointManager, TimedManager
    try:
        rbuilt = cli.build(rargs)
        t0 = time.perf_counter()
        resumed, rrep = cli.run(rargs, rbuilt)
        resume_s = time.perf_counter() - t0
    finally:
        cli.CheckpointManager = real_manager
    del rbuilt
    launches = all_counts()
    steps_here = CLI_STEPS + (CLI_STEPS - k if k is not None else 0)
    want = tuple(steps_here * c for c in per_step)
    diffs = cli_leaf_diffs(resumed, clean)
    checks = {
        "exit_0": rc == 0,
        "preempted": said is not None and k is not None and int(said.group(1)) == k
        and int(said.group(2)) == signal.SIGTERM,
        "marker": marker is not None and 1 <= k < CLI_STEPS
        and marker["signum"] == signal.SIGTERM and marker["tier"] == "disk",
        "flight_dumped": flight.get("reason") == "preempt",
        "marker_consumed": read_marker(ckpt) is None,
        "resumed_to_end": rrep.steps_done == CLI_STEPS and not rrep.preempted,
        "losses_bit_equal": k is not None and rrep.losses[k:] == losses[k:],
        "state_bit_equal": ft_same(resumed, clean) and not diffs,
        "launches": launches == want,
    }
    readings = {
        "child_start_s": started - t_spawn if started else None,
        "step0_persist_s": saves[0]["seconds"] if saves else None,
        "spawn_to_step0_manifest_s": t_manifest - t_spawn,
        "signal_to_exit_s": t_exit - t_signal,
        "jit_persist_s": saves[-1]["seconds"] if len(saves) > 1 else None,
        "restore_s": TimedManager.reads,
        "resume_run_s": resume_s,
        "step_ms": ms,
    }
    log(f"cli: preempted at step {k} (marker {marker}); resumed losses {rrep.losses[k or 0:]}; "
        f"leaves that differ from the clean run {diffs}; launches B1/B2/B3/B4 rows/B4 "
        f"contract {launches} (expected {want} for {steps_here} steps); readings {readings}; "
        f"checks {checks}")
    del resumed, clean
    shutil.rmtree(tmp, ignore_errors=True)
    bad = sorted(c for c, ok in checks.items() if not ok)
    if bad:
        raise AssertionError(f"the CLI phase failed {bad}")
    check_bodies("the CLI's steps in this process", launches, "cli")
    return {"argv": CLI_ARGV, "preempt_step": k, "launches": launches,
            "per_step": per_step, "steps_in_process": steps_here, "losses": losses,
            "readings": readings, "checks": checks}


# ---------------------------------------------------------------------------
# data parallelism with ZeRO-1 (phase 15)

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
    the sum order of the grads. Under ZeRO-3 the shadow holds the whole
    params and each rank's parts are held to their cut of it (``part_of``).
    ``own_seconds`` and ``own_link_bytes`` keep, per watched call, the seconds
    and link bytes of the watch's own collectives by kind (a step's reading
    less them is the step's own)."""

    def __init__(self, steps=1, shadow=False):
        self.steps, self.shadow = steps, shadow
        self.grads, self.shadow_err, self.calls = None, [], 0
        self.own_seconds = []             # per watched call: the watch's own collectives
        self.own_link_bytes = []
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

    def _sharded(self, grads, opt, params, lr, *, mesh, specs, sharded_params=False, **kw):
        from repro_torch.checkpoint import store
        from repro_torch.core.tree import leaves, map_tree, named_leaves
        from repro_torch.optim import adamw_init
        from repro_torch.train.fsdp import gather_fsdp
        if self.calls >= self.steps:
            return self._real[1](grads, opt, params, lr, mesh=mesh, specs=specs,
                                 sharded_params=sharded_params, **kw)
        before, stats = dict(mesh.seconds), mesh.collective_stats()
        whole = {}
        for name, g in named_leaves(grads):
            d = specs[name].dim
            whole[name] = g if d is None else mesh.all_gather(
                g.movedim(d, 0).contiguous()).movedim(0, d)
        self._keep(list(whole.items()))
        if self.shadow:
            if self._params is None:
                # under ZeRO-3 the shadow holds the whole params the parts gather to
                self._params = map_tree(lambda p: p.detach().clone(), gather_fsdp(
                    params, mesh) if sharded_params else params)
                self._opt = adamw_init(self._params)
            g = store._refill(map_tree(torch.empty_like, self._params), whole.__getitem__)
            self._params, self._opt = self._real[0](g, self._opt, self._params, lr, **kw)
            del g
        del whole
        self.own_seconds.append({k: mesh.seconds[k] - before[k] for k in before})
        self.own_link_bytes.append(link_bytes_since(mesh, stats))
        out = self._real[1](grads, opt, params, lr, mesh=mesh, specs=specs,
                            sharded_params=sharded_params, **kw)
        if self.shadow:
            self.shadow_err.append(max(rel_err(p, part_of(s, p, mesh.rank)) for p, s in
                                       zip(leaves(params), leaves(self._params))
                                       if p.numel()))
        self.calls += 1
        return out


def part_of(whole, t, rank):
    """``whole`` cut to what the tensor ``t`` holds of it: its ZeRO-3 part
    (``core.sharding.FsdpPart``: a slice, or the layer itself on its owner),
    or all of it."""
    from repro_torch.core.sharding import fsdp_part
    part = fsdp_part(t)
    if part is None or part.dim is None:
        return whole
    k = t.shape[part.dim]
    return whole.narrow(part.dim, rank * k, k)


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
              around=None, hyper=None, keep_params=True, params_at=None):
    """``len(batches)`` steps from fresh params of ``seed`` (``prepare(params)``
    first, if given) on ``mesh`` or on one device, under ``watch`` (a
    ZeroWatch), each step inside ``around(i)`` (a context manager), if given.
    Returns the state, the step and a dict of per-step ``loss`` and
    ``grad_norm`` (and, under ``plan.integrity == "audit"``, ``integrity_div``
    and ``integrity_checksum``), the first step's ``grads`` (from the watch)
    and the final ``params`` by name on the host (None without
    ``keep_params``); with ``params_at`` (a step count) also ``params_at``,
    the whole params after that many steps."""
    import contextlib
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
            if params_at == i + 1:
                out["params_at"] = host_params(state.params, plan, mesh)
    out["grads"] = watch.grads if watch is not None else None
    out["params"] = host_params(state.params, plan, mesh) if keep_params else None
    return state, step, out


def host_params(params, plan, mesh):
    """The whole params by name on the host (ZeRO-3's parts gathered first)."""
    from repro_torch.checkpoint import store
    from repro_torch.core.tree import named_leaves
    if mesh is not None and plan.dp_shard > 1:
        from repro_torch.launch import data_mesh
        from repro_torch.train.fsdp import gather_fsdp
        params = gather_fsdp(params, data_mesh(mesh))
    return {n: store._host(x)[0] for n, x in named_leaves(params)}


def dp_setup(microbatches):
    """whisper-small's full-width training model for the DP phase
    (``whisper_cut``: WHISPER_CUT_LAYERS + WHISPER_CUT_LAYERS layers; fp32
    masters, bf16 compute, remat "full", ZeRO-1, the integrity audit on,
    ``microbatches`` per rank) and
    DP_STEPS + 1 train_4k batches of WHISPER_TRAIN_BATCH sequences with their
    frames (the last for the checkpoint's resumed step)."""
    from repro_torch.core import InputShape, ParallelPlan, get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    cfg = whisper_cut(get_config(WHISPER_ARCH))
    plan = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                        microbatches=microbatches, zero_stage=1, integrity="audit")
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, WHISPER_TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(DP_STEPS + 1)]
    return cfg, plan, build_model(cfg, plan), batches


def dp_step_counter(cfg, mesh, what, rec, timed_from=DP_WATCHED):
    """A context-manager factory for ``zero1_run``'s ``around``: each step's
    wall time (synchronised), its collectives' seconds (from the mesh, which
    waits for the device around each one from step ``timed_from`` on) and its
    B1/B2/B3 launches, which must be the counts stated before the run and all
    on the Hopper bodies."""
    import contextlib
    attn_calls = cfg.enc_layers + 2 * cfg.n_layers          # per forward of a microbatch
    want = (2 * DP_MICRO * attn_calls, DP_MICRO * attn_calls, DP_MICRO * attn_calls, 0, 0)

    @contextlib.contextmanager
    def around(i):
        reset_counts()
        mesh.timed = i >= timed_from          # the watched steps are not timed
        before, stats = dict(mesh.seconds), mesh.collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("reduce_scatter", "all_gather", "all_reduce"):
            rec[f"{k}_ms"].append((mesh.seconds[k] - before[k]) * 1e3)
        rec.setdefault("link_bytes", []).append(link_bytes_since(mesh, stats))
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
           # the ranks' agreement on each step's decision (one gloo max a step)
           "agreements": report.agreements,
           "agree_ms": report.agree_seconds * 1e3 / max(1, report.agreements),
           "losses_bit_equal": report.losses == clean["loss"],
           "state_bit_equal": (all(np.array_equal(got[n], a) for n, a in clean["params"].items())
                               and all(np.array_equal(got_opt[n], a)
                                       for n, a in clean_opt.items()))}
    log(f"dp rank {mesh.rank} sdc run: {out}")
    return out


def dp_rank(rank, init_method, out_dir, gate=None):
    """One of the DP_RANKS processes of the DP phase, on cuda:0 over gloo:
    whisper-small at full width (``whisper_cut``) under ZeRO-1, one microbatch of the
    rank's rows with B1-B3 held to their plain versions
    (``dp_checked_microbatch``), DP_STEPS steps (the
    first DP_WATCHED watched: the first one's whole grads kept, each ZeRO-1
    update held to adamw_update on the same grads; the others timed), then
    the checkpoint round trip: a save at dp 2, the step after it, a restore at
    dp 2 (routed "replay") and its resumed step, and an elastic restore onto
    one process (routed "reshard"; refused without ``elastic``). Rank 0 then runs one device's
    step on the same batches with DP_RANKS x DP_MICRO microbatches, and once
    more with DP_MICRO (the sum-order reading). Results go to
    ``out_dir/dp_rank{rank}.json``. ZeRO-3 starts once the file ``gate``
    exists, if given (``dp_and_tp``)."""
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
                                prepare=check, around=counter, params_at=ZERO3_STEPS)
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
    free()
    if gate is not None:
        out["waited_for_tp_s"] = wait_for(gate, f"dp rank {rank}")
    out["zero3"], z3 = zero3_run(cfg, plan, batches, mesh, out["peak_bytes"])
    mesh.close()
    free()

    if rank == 0:
        _, _, ref = zero1_run(model, plan1, batches[:DP_STEPS], watch=ZeroWatch(),
                              params_at=ZERO3_STEPS)
        out["agree"] = dp_agreement(dp, ref)
        # ZeRO-3 ran ZERO3_STEPS steps: its params against one device's after as many
        ref_at = {**ref, "params": ref["params_at"]}
        out["zero3"]["agree"] = dp_agreement(z3, ref_at)
        del z3
        free()
        _, _, ref2 = zero1_run(model, dataclasses.replace(plan, microbatches=DP_MICRO),
                               batches[:DP_STEPS], watch=ZeroWatch(), params_at=ZERO3_STEPS)
        out["one_device_mb2_vs_mb4"] = dp_agreement(ref2, ref)
        out["params_rel_at_zero3_steps"] = {
            "steps": ZERO3_STEPS, "zero3": out["zero3"]["agree"]["params_rel"],
            "zero1": dp_agreement({**dp, "params": dp["params_at"]}, ref_at)["params_rel"],
            "one_device_mb2_vs_mb4": dp_agreement({**ref2, "params": ref2["params_at"]},
                                                  ref_at)["params_rel"]}
        out["one_device_loss"] = ref["loss"]
        out["one_device_grad_norm"] = ref["grad_norm"]
    (Path(out_dir) / f"dp_rank{rank}.json").write_text(json.dumps(out))


ZERO3_STEPS = 2                   # every one watched (DP_TOLERANCE) and timed


def zero3_run(cfg, plan, batches, mesh, zero1_peak):
    """ZeRO-3 (``dp_shard`` 2) on the DP phase's ranks, model and batches:
    ZERO3_STEPS steps from seed 0, each watched (the update held to
    adamw_update on the same whole grads, ZeroWatch) and timed with the
    collectives waited for; the B1-B3 launches of each step as ZeRO-1's
    (dp_step_counter). Readings: step, all-gather and reduce-scatter ms less
    the watch's own collectives, the param bytes a rank holds against
    ZeRO-1's whole params, the peak memory against the ZeRO-1 run's. Returns
    (readings, zero1_run's results)."""
    from repro_torch.core.sharding import bytes_per_device, train_state_specs
    from repro_torch.core.tree import leaves
    from repro_torch.models import build_model
    plan3 = dataclasses.replace(plan, dp_shard=DP_RANKS)
    model = build_model(cfg, plan3, mesh=mesh)
    rec = {"ms": [], "reduce_scatter_ms": [], "all_gather_ms": [], "all_reduce_ms": []}
    counter = dp_step_counter(cfg, mesh, f"{WHISPER_ARCH} zero3 rank {mesh.rank}", rec,
                              timed_from=0)
    watch = ZeroWatch(steps=ZERO3_STEPS, shadow=True)
    torch.cuda.reset_peak_memory_stats()
    state, _, z3 = zero1_run(model, plan3, batches[:ZERO3_STEPS], mesh, watch=watch,
                             around=counter)
    mesh.timed = False
    own = watch.own_seconds
    for i, o in enumerate(own):           # the watch's own collectives out of the readings
        rec["ms"][i] -= 1e3 * sum(o.values())
        for k in ("reduce_scatter", "all_gather", "all_reduce"):
            rec[f"{k}_ms"][i] -= 1e3 * o[k]
        for k, v in watch.own_link_bytes[i].items():
            rec["link_bytes"][i][k] -= v
    specs = train_state_specs(state, mesh, plan3)
    pspecs = {k: s for k, s in specs.items() if k.startswith("params/")}
    out = {**rec, "peak_bytes": torch.cuda.max_memory_allocated(), "zero1_peak_bytes": zero1_peak,
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves(state.params)),
           "param_bytes_rule": bytes_per_device(pspecs, mesh),
           "param_bytes_zero1": bytes_per_device(pspecs, None),
           "loss": z3["loss"], "grad_norm": z3["grad_norm"], "shadow_err": watch.shadow_err,
           "integrity_div": z3["integrity_div"], "bodies": rec.get("bodies")}
    log(f"dp rank {mesh.rank} ZeRO-3: steps {[round(x, 1) for x in rec['ms']]} ms (all-gather "
        f"{[round(x, 1) for x in rec['all_gather_ms']]}, reduce-scatter "
        f"{[round(x, 1) for x in rec['reduce_scatter_ms']]}; link bytes by kind "
        f"{rec['link_bytes']}; the watch's own collectives taken out), params held {out['param_bytes'] / 1e9:.3f} GB (rule "
        f"{out['param_bytes_rule'] / 1e9:.3f}, ZeRO-1 {out['param_bytes_zero1'] / 1e9:.3f}), "
        f"peak {out['peak_bytes'] / 1e9:.2f} GB (ZeRO-1 {zero1_peak / 1e9:.2f}), losses "
        f"{z3['loss']}, update against adamw_update {watch.shadow_err}")
    del state, model
    return out, z3


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


def phase_whisper_dp(gate=None):
    """The DP phase: DP_RANKS spawned ranks on the one card over gloo
    (``dp_rank``; ZeRO-3 once the file ``gate`` exists, if given), then one
    NCCL rank (``nccl_rank``), each a process of its own (spawn, not fork:
    the parent holds a CUDA context); their results checked here. Every
    process is joined or killed before this returns."""
    import multiprocessing
    import shutil
    import tempfile
    ctx = multiprocessing.get_context("spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dp_", dir=ROOT / "build")
    procs = []
    try:
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_rank, args=(r, f"file://{tmp}/store", tmp, gate))
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


DP_BESIDE_TP = ("ms", "reduce_scatter_ms", "all_gather_ms", "all_reduce_ms", "save",
                "restore_dp2_s", "restore_dp1_s", "audit_ms", "sdc")
TP_BESIDE_DP = ("ms", "tick_ms", "all_reduce_ms", "seconds")


def dp_and_tp():
    """The DP and TP phases at once (the script's 1,200 s: one after the
    other they took 414.7 s of a 1,319.3 s run on an H100 machine with a
    slow host). Their four
    rank processes share the card and the host, so what is timed while both
    run is neither phase's own: the ZeRO-1 steps, the checkpoint's and the
    sdc run's seconds and the audit's ms (DP_BESIDE_TP), and the TP steps
    (TP_BESIDE_DP). Those readings are kept apart as such, never as a step's
    time. The DP ranks start ZeRO-3 only once the TP ranks have exited (the
    file ``gate``), and the TP kernels are timed once the DP phase is over,
    so ZeRO-3's, the NCCL rank's and the kernels' readings are each taken
    alone."""
    import shutil
    import tempfile
    import threading
    (ROOT / "build").mkdir(exist_ok=True)
    gate = Path(tempfile.mkdtemp(prefix="gate_", dir=ROOT / "build")) / "tp_ranks_done"
    dp_done, out = threading.Event(), {}

    def tp_thread():
        try:
            out["tp"] = timed("tensor parallel", phase_tp, gate, dp_done)
        except BaseException as e:                    # re-raised in the main thread
            out["error"] = e
        finally:
            gate.touch()
    thread = threading.Thread(target=tp_thread)
    thread.start()
    try:
        dp = timed(f"{WHISPER_ARCH} data parallel", phase_whisper_dp, str(gate))
    finally:
        dp_done.set()
        thread.join()
        shutil.rmtree(gate.parent, ignore_errors=True)
    if "error" in out:
        raise out["error"]
    return dp, out["tp"]


def wait_for(path, what, timeout=900):
    """Wait until the file ``path`` exists; its seconds."""
    t0 = time.perf_counter()
    while not Path(path).exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{what}: no {path} after {timeout} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def dp_report(ranks, nccl):
    """Log the DP phase's results and hold them to DP_TOLERANCE and the
    checkpoint's bit-for-bit restores; keep the ranks' launches by body for
    the kernels line."""
    r0 = ranks[0]
    for r in ranks:
        timed_ms = {k: r[k][DP_WATCHED:] for k in ("ms", "reduce_scatter_ms", "all_gather_ms",
                                                  "all_reduce_ms", "link_bytes")}
        log(f"dp rank {r['rank']} ({r['mesh']}): timed steps beside the TP ranks (not the "
            f"steps' own time) {timed_ms} (two ranks share one card and their collectives go "
            f"through host memory: no measure of DP scaling); "
            f"peak {r['peak_bytes'] / 1e9:.2f} GB; moments held {r['moment_bytes'] / 1e9:.3f} "
            f"GB (the rule's {r['moment_bytes_rule'] / 1e9:.3f} of "
            f"{r['moment_bytes_whole'] / 1e9:.3f}); launches B1/B2/B3 {r['launches']} a step; "
            f"on its own rows B1 {r['real_fwd_ulps']:.2f}, B2 (dq) {r['real_bwd_ulps'][1]:.2f}, "
            f"B3 (dk/dv) {r['real_bwd_ulps'][0]:.2f} bf16 ulps from their plain versions; "
            f"beside the TP ranks: save stall {r['save']['stall_s']:.2f} s (host copy "
            f"{r['save']['d2h_s']:.2f}, "
            f"gather {r['save']['gather_s']:.2f}); restore at dp 2 {r['restore_dp2_s']:.2f} s, "
            f"at dp 1 {r['restore_dp1_s']:.2f} s; ZeRO-3 waited "
            f"{r.get('waited_for_tp_s', 0.0):.1f} s for the TP ranks to exit")
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
            f"{r['integrity_checksum']}), beside the TP ranks: the audit alone "
            f"{[round(x, 2) for x in r['audit_ms']]} ms; sdc run: actions {r['sdc']['actions']}, restores {r['sdc']['restores_by_tier']}, "
            f"RAM restore {r['sdc']['ram_restore_s']:.2f} s ({r['sdc']['ram_rebuilt_members']} "
            f"members rebuilt), bit-equal {r['sdc']['state_bit_equal']}, {r['sdc']['seconds']:.1f} s; "
            f"{r['sdc']['agreements']} agreements, {r['sdc']['agree_ms']:.3f} ms each")
    log(f"nccl ({nccl['mesh']}): seam {nccl['seam_equal']}, step {nccl['ms'][DP_WATCHED:]} ms, "
        f"all-reduce {nccl['all_reduce_ms'][DP_WATCHED:]} ms, link bytes by kind "
        f"{nccl['link_bytes'][DP_WATCHED:]}; losses {nccl['loss']} / "
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
        # every step run, the rolled-back one and its replay included, agreed
        if sdc["agreements"] != DP_STEPS + 1:
            bad.append(f"rank {r['rank']}: {sdc['agreements']} agreements in the sdc run")
    if any(r["integrity_checksum"] != r0["integrity_checksum"] for r in ranks[1:]):
        bad.append("the ranks' integrity checksums differ")
    if any(d != 0.0 for d in nccl["integrity_div"]):
        bad.append(f"nccl: the audit read {nccl['integrity_div']}")
    if not r0["resumed_dp1_rel"] <= DP_REL:
        bad.append(f"one device's resumed step {r0['resumed_dp1_rel']:.3e}")
    if not nccl["seam_equal"]:
        bad.append("the NCCL seam changed a tensor at world size 1")
    for r in ranks:
        z3 = r["zero3"]
        bad += [f"rank {r['rank']} ZeRO-3: {b}"
                for b in dp_failures(z3.get("agree"), z3["shadow_err"])]
        if any(d != 0.0 for d in z3["integrity_div"]):
            bad.append(f"rank {r['rank']} ZeRO-3: the audit read {z3['integrity_div']}")
        if z3["param_bytes"] != z3["param_bytes_rule"]:
            bad.append(f"rank {r['rank']} ZeRO-3: params held {z3['param_bytes']} != rule")
        if (z3["loss"], z3["grad_norm"]) != (r0["zero3"]["loss"], r0["zero3"]["grad_norm"]):
            bad.append(f"rank {r['rank']} ZeRO-3 reports {z3['loss']} / {z3['grad_norm']}")
    log(f"ZeRO-3 (dp_shard {DP_RANKS}) against one device: {r0['zero3']['agree']}; the "
        f"params after {ZERO3_STEPS} steps against one device's, in units of each leaf's "
        f"max: {r0['params_rel_at_zero3_steps']} (ZeRO-3, ZeRO-1 and one device at "
        f"{DP_MICRO} microbatches; readings, DP_TOLERANCE)")
    if bad:
        raise AssertionError("DP phase: " + "; ".join(bad))
    BODY_COUNTS["whisper_dp_train_step"] = {
        k: sum(r["bodies"][k] for r in ranks) for k in r0["bodies"]}
    BODY_COUNTS["whisper_zero3_train_step"] = {
        k: sum(r["zero3"]["bodies"][k] for r in ranks) for k in r0["bodies"]}
    BODY_COUNTS["whisper_dp_nccl_train_step"] = nccl["bodies"]


def dp_summary(dp):
    """The DP phase's numbers for the kernels line (``whisper-small_dp``)."""
    keys = ("launches", "peak_bytes", "moment_bytes", "moment_bytes_whole",
            "resumed_dp2_rel", "shadow_err", "real_fwd_ulps", "real_bwd_ulps",
            "integrity_div", "integrity_checksum", "waited_for_tp_s")
    r0, nccl = dp["ranks"][0], dp["nccl"]
    return {
        "ranks": [{**{k: r.get(k) for k in keys},
                   "beside_tp_ranks": {k: r[k] for k in DP_BESIDE_TP}} for r in dp["ranks"]],
        "beside_tp_ranks": "taken while the TP ranks ran on the same card and host "
                           "(dp_and_tp): not the DP phase's own times",
        "transport": "gloo, host copies (two ranks on one card); no measure of DP scaling",
        "agreement_with_one_device": r0["agree"],
        "one_device_mb2_vs_mb4": r0["one_device_mb2_vs_mb4"],
        "resumed_dp1_rel": r0["resumed_dp1_rel"],
        "tolerance": DP_TOLERANCE,
        "nccl_world_1": {k: nccl[k] for k in ("ms", "all_reduce_ms", "launches", "agree",
                                               "params_bit_identical", "shadow_err")},
        "phase_s": {"gloo_ranks": dp["gloo_s"], "nccl": dp["nccl_s"]},
        "params_rel_at_zero3_steps": r0["params_rel_at_zero3_steps"],
        "zero3": {"plan": {"dp_shard": DP_RANKS},
                  "ranks": [{k: v for k, v in r["zero3"].items() if k not in ("agree", "bodies")}
                            for r in dp["ranks"]],
                  "agreement_with_one_device": r0["zero3"]["agree"]},
    }


# ---------------------------------------------------------------------------
# tensor parallelism (A13.2): the overlap rings on a (1, 2) grid
#
# Two rank processes (spawn) share the one card over gloo, as the DP phase's
# do: every ring tick goes D2H, through gloo, then H2D. The phase proves the
# rings and the kernels on the sharded shapes; it cannot measure TP scaling
# or overlap. Each family runs from the same two processes: qwen1.5-4b at
# full width on TP_FAMILIES["dense"]'s 2 of its 40 layers (8 until the CP
# phase, 4 until the grid serving phase needed the script's time) for
# TP_STEPS steps, then one fp32 step at TP_FP32_LAYERS layers;
# deepseek-moe-16b at full width on 1 of its 28 layers and
# mamba2-370m at full width on 6 of its 48 layers (the script's time limit), one step each;
# 1 x 4096 tokens, bf16 compute, remat "full". Nothing is checkpointed.
TP_RANKS = 2
TP_STEPS = 3
TP_FAMILIES = {"dense": (TRAIN_ARCH, 2), "moe": (MOE_ARCH, 1), "ssm": (SSM_ARCH, 6)}
TP_FP32_LAYERS = 2
TP_CASES = {"dense": (1, 10, 10, TRAIN_SEQ, TRAIN_SEQ, 128, True, 0, 0.0, 0),
            "moe": (1, 8, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, 0, 0.0, 0)}
# a leaf past DP_REL: the grid run's distance from fp64 against one device's
GRID_FP64_FACTOR = 2.0
GRID_TOLERANCE = ("an fp32 step on the grid (TP: TP_FP32_LAYERS layers; CP: CP_FP32_LAYERS, ring "
                  "and gather modes and Mamba2) against one device's on the same weights and "
                  "batch: loss and grad norm to 1e-6 relative and each watched ZeRO-1 update "
                  "against adamw_update (DP_TOLERANCE); each rank's clipped grads to 1e-6 of each "
                  "leaf's max against its part of one device's (its TP shard; the whole leaf "
                  "under CP), and a leaf past that no further from an fp64 evaluation of the "
                  "step than GRID_FP64_FACTOR (2) times one device's distance plus 1e-6 of the "
                  "leaf's max (one device's own fp32 grads sit a few 1e-6 from fp64 at full "
                  "width, and the rings add the sums they split in another order: ROADMAP queue "
                  "C, scripts/tp_fp32_probe.py). A control must fail the grads rule: TP, one "
                  "partial sum of every row GEMM's ring rounded to bf16; CP, each ring tile's o "
                  "rounded to bf16 before the merge. The bf16 steps' loss and grads against one "
                  "device are readings")


@contextlib.contextmanager
def fp64_eval():
    """Within the block the port computes in fp64 where it would in fp32: the
    compute dtype "float32" resolves to fp64, ``Tensor.float()`` (the model
    code's upcasts) to ``double()``, and ``torch.einsum`` promotes an fp32
    operand (the routing's one-hot tensors) to fp64, so one device's plain
    path gives an fp64 evaluation of the same step (rope's fp32 frequencies
    stay, as in every run)."""
    from repro_torch.core import device
    real = device.DTYPES["float32"], torch.Tensor.float, torch.einsum

    def einsum(eq, *ops):
        if any(o.dtype == torch.float64 for o in ops):
            ops = [o.double() if o.is_floating_point() else o for o in ops]
        return real[2](eq, *ops)
    device.DTYPES["float32"], torch.Tensor.float = torch.float64, torch.Tensor.double
    torch.einsum = einsum
    try:
        yield
    finally:
        device.DTYPES["float32"], torch.Tensor.float, torch.einsum = real


def fp64_first_grads(cfg, params, batch, microbatches, hyper):
    """The clipped grads of one device's step on ``batch`` from ``params``,
    evaluated in fp64 on the plain path, by name (stacked host float64)."""
    from repro_torch.core import ParallelPlan
    from repro_torch.core.tree import leaves, map_tree, named_leaves
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn
    from repro_torch.train.step import _split_microbatches
    plan = ParallelPlan(compute_dtype="float32", remat="none", attn_impl="plain",
                        moe_gemm_impl="plain", ssm_impl="plain")
    device = leaves(params)[0].device
    with fp64_eval():
        model = build_model(cfg, plan, device=device)
        p64 = map_tree(lambda t: t.detach().double().requires_grad_(True), params)
        loss_fn = make_loss_fn(model, hyper)
        for mb in _split_microbatches(batch, microbatches):
            (loss_fn(p64, mb)[0] / microbatches).backward()
    grads = {n: (torch.stack([t.grad for t in x]) if isinstance(x, list) else x.grad)
             for n, x in named_leaves(p64)}
    del p64
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(hyper.grad_clip / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: (g * scale).cpu().numpy() for n, g in grads.items()}


def tp_part(name, a, r, n):
    """Model rank r's TP shard of one device's whole leaf ``a`` (of n)."""
    from repro_torch.core.sharding import tp_shard_of
    return tp_shard_of(name, a, r, n)


def whole_part(name, a, r, n):
    """A CP rank's part of one device's leaf: all of it (cp replicates the
    weights)."""
    return a


def grid_grad_failures(shards, one, truth, part=tp_part):
    """The first step's clipped grads of a grid run (``shards[r]``: rank r's,
    by name) against one device's (``one``, whole) by GRID_TOLERANCE's grads
    rule, ``part(name, leaf, r, n)`` cutting one device's leaf to rank r's
    part of it, with ``truth`` the fp64 evaluation of one device's step (None:
    every leaf past 1e-6 of its max fails): (failures, {leaf@rank: (error,
    the grid run's and one device's distances from fp64)} for the leaves past
    1e-6 that the rule admits), each number in units of the leaf's max."""
    bad, explained = [], {}
    for name, g in one.items():
        for r, shard in enumerate(shards):
            ref = part(name, g, r, len(shards))
            err = rel_err(shard[name], ref)
            if err <= DP_REL:
                continue
            if truth is None:
                bad.append(f"{name} on rank {r}: {err:.3e} (no fp64 evaluation)")
                continue
            t = part(name, truth[name], r, len(shards))       # numpy, or tensors on one device
            mx = max(float(abs(t).max()), 1e-30)
            reading = (err, float(abs(shard[name] - t).max()) / mx,
                       float(abs(ref - t).max()) / mx)
            if reading[1] <= GRID_FP64_FACTOR * reading[2] + DP_REL:
                explained[f"{name}@{r}"] = reading
            else:
                bad.append(f"{name} on rank {r}: {reading}")
    return bad, explained


def grid_failures(agree, shadow_err, shards, one, truth, part=tp_part):
    """What breaks GRID_TOLERANCE: ``dp_failures`` on the agreement numbers
    (``grid_agreement``, or ``dp_agreement`` on one rank's part) with the
    grads rule of ``grid_grad_failures`` in place of its first_grads_rel;
    also returns the leaves past 1e-6 that the rule admits."""
    bad = [b for b in dp_failures(agree, shadow_err) if not b.startswith("first_grads_rel")]
    grads_bad, explained = grid_grad_failures(shards, one, truth, part)
    return bad + grads_bad, explained


@contextlib.contextmanager
def bf16_partial_sum():
    """GRID_TOLERANCE's control: within the block every row GEMM's ring
    (``matmul_reduce_scatter``, as the executor calls it) adds this rank's own
    partial product to its chunk rounded to bf16, a fault the grads rule must
    catch. The rounding goes into the forward values only; the cotangents
    pass as they would."""
    from repro_torch.kernels.dispatch import dispatch_tp_matmul
    from repro_torch.train import executor
    real = executor.matmul_reduce_scatter

    def rounded(ring, h, w):
        out = real(ring, h, w)
        s = out.shape[1]
        own = dispatch_tp_matmul(h[:, ring.rank * s:(ring.rank + 1) * s], w)
        return out + (own.to(torch.bfloat16).to(own.dtype) - own).detach()
    executor.matmul_reduce_scatter = rounded
    try:
        yield
    finally:
        executor.matmul_reduce_scatter = real


def grid_gather(named, grid):
    """Every grid rank's ``named`` host arrays (the same names, shapes and
    dtypes on each) on rank 0, in one flat gather over the grid's gloo host
    group (``checkpoint.store.gather_flat``, the grid save's): [rank 0's,
    rank 1's, ...] there, None elsewhere."""
    from repro_torch.checkpoint.store import gather_flat
    names = sorted(named)
    got = gather_flat([named[n] for n in names], grid.host_group)
    return None if got is None else [dict(zip(names, arrays)) for arrays in got]


def tp_setup(family, layers=None, dtype="bfloat16", tp=TP_RANKS, steps=1):
    """A family's full-width config (cut to ``layers`` layers where given), its
    plan (fp32 masters, ``dtype`` compute, remat "full", one microbatch of 1 x
    TRAIN_SEQ, ``tp``), the model and ``steps`` train_4k batches."""
    from repro_torch.core import InputShape, ParallelPlan, get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    arch, cut = TP_FAMILIES[family]
    cfg = get_config(arch)
    if layers or cut:
        cfg = dataclasses.replace(cfg, n_layers=layers or cut)
    plan = ParallelPlan(compute_dtype=dtype, param_dtype="float32", remat="full",
                        microbatches=1, tp=tp)
    ds = SyntheticDataset(cfg, InputShape("train_4k", TRAIN_SEQ, 1, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(steps)]
    return cfg, plan, build_model(cfg, plan), batches


def tp_taps(params):
    """The SSM family's conv taps drawn at random (``random_conv_taps``), the
    same on every rank and on one device (those leaves are whole on each)."""
    random_conv_taps(params, torch.Generator(device="cuda").manual_seed(5))


def tp_want(family, cfg):
    """The launches of one step (one microbatch, remat full): B1, B2, B3, B4
    rows, B4 contract, B5, B6."""
    n = cfg.n_layers
    if family == "ssm":
        return (0, 0, 0, 0, 0, 2 * n, n)
    b4 = (9 * n, 3 * n) if family == "moe" else (0, 0)
    return (2 * n, n, n, *b4, 0, 0)


def tp_checked_microbatch(family, cfg, plan, grid, batch, out, keep_dir):
    """A ``prepare`` for ``zero1_run``: the rank's first microbatch through
    the TP loss and its backward with every kernel call held to its plain
    version on the rank's own inputs (B1 FlashFwdCapture; B2/B3
    FlashBwdCapture, dq also to fp64; B4 GemmCapture; B5/B6 SSDCapture). B4's
    first call and first dx/dw, and B5/B6's first calls, are saved under
    ``keep_dir`` for the times at the sharded shapes."""
    from repro_torch.core.tree import leaves
    from repro_torch.train import Hyper
    from repro_torch.train.executor import make_executor_loss_fn

    def prepare(params):
        if family == "ssm":
            tp_taps(params)
        loss_fn = make_executor_loss_fn(cfg, plan, grid, z_loss=Hyper().z_loss)
        what = f"{cfg.arch_id} tp rank {grid.rank} microbatch"
        n = cfg.n_layers
        if family == "ssm":
            with SSDCapture() as ssd:
                loss, _ = loss_fn(params, batch)
                loss.backward()
            out["real_ssd"] = ssd.summary(what)
            if keep_dir is not None:
                torch.save(ssd.kept, Path(keep_dir) / "tp_ssd.pt")
        else:
            with FlashBwdCapture(fp64=True) as bwd, FlashFwdCapture() as fwd, \
                    GemmCapture(keep=(0,), backward=True) as gemm:
                loss, _ = loss_fn(params, batch)
                loss.backward()
            out["real_fwd_ulps"] = fwd.summary(f"{what} (forward and recompute)", 2 * n)
            out["real_bwd_ulps"] = bwd.summary(what, n)
            if family == "moe":
                out["real_gemm_ulps"] = gemm.summary(what)
                if keep_dir is not None:
                    torch.save({"tp_forward": gemm.kept[0], "tp_dx": gemm.kept["dx"],
                                "tp_dw": gemm.kept["dw"]}, Path(keep_dir) / "tp_gemm.pt")
        out["microbatch_loss"] = float(loss)
        for p in leaves(params):
            p.grad = None
    return prepare


def tp_step_counter(family, cfg, grid, rec):
    """A context-manager factory for ``zero1_run``'s ``around``: each step's
    wall time (synchronised), its ring seconds by kind (ticks, all-reduces;
    the ring waits for the device around each) and the kernels' launches,
    which must be ``tp_want``'s and all on the Hopper bodies."""
    want = tp_want(family, cfg)

    @contextlib.contextmanager
    def around(i):
        reset_counts()
        grid.model.timed = True
        before, stats = dict(grid.model.seconds), grid.model.collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("tick", "all_reduce"):
            rec[f"{k}_ms"].append((grid.model.seconds[k] - before[k]) * 1e3)
        rec.setdefault("link_bytes", []).append(link_bytes_since(grid.model, stats))
        launches = all_counts() + ssd_counts()
        rec["launches"] = launches
        if launches != want:
            raise AssertionError(f"{cfg.arch_id} tp step {i} launched {launches}, "
                                 f"expected {want}")
        check_bodies(f"{cfg.arch_id} tp rank {grid.rank} step {i}", launches,
                     f"tp_{family}_train_step")
        rec["bodies"] = BODY_COUNTS[f"tp_{family}_train_step"]
        grid.model.timed = False
    return around


def tp_family(family, grid, out_dir):
    """One family on this rank: the checked microbatch, the TP steps (the
    first one's grads kept), peak memory; then, on model rank 0 while rank 1
    waits, one device's steps on the same weights and batches, and the
    readings against it (the first step's grads for the dense family, over
    both ranks' shards)."""
    from repro_torch.core.tree import named_leaves
    from repro_torch.models import build_model
    steps = TP_STEPS if family == "dense" else 1
    cfg, plan, model, batches = tp_setup(family, steps=steps)
    rec = {"layers": cfg.n_layers, "ms": [], "tick_ms": [], "all_reduce_ms": []}
    check = tp_checked_microbatch(family, cfg, plan, grid, batches[0], rec,
                                  out_dir if grid.rank == 0 else None)
    torch.cuda.reset_peak_memory_stats()
    watch = ZeroWatch(steps=1)
    state, _, run = zero1_run(model, plan, batches, grid, watch=watch, prepare=check,
                              around=tp_step_counter(family, cfg, grid, rec))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["params_per_rank"] = sum(x.numel() for _, leaf in named_leaves(state.params)
                                 for x in (leaf if isinstance(leaf, list) else [leaf]))
    rec.update(loss=run["loss"], grad_norm=run["grad_norm"])
    log(f"tp rank {grid.rank} {cfg.arch_id} ({cfg.n_layers} layers): steps "
        f"{[round(x, 1) for x in rec['ms']]} ms, ticks {[round(x, 1) for x in rec['tick_ms']]} "
        f"ms, all-reduces {[round(x, 1) for x in rec['all_reduce_ms']]} ms, losses "
        f"{run['loss']}, peak {rec['peak_bytes'] / 1e9:.2f} GB")
    del state
    free()
    shards = grid_gather(watch.grads, grid) if family == "dense" else None
    grid.barrier_error(False)
    if grid.rank == 0:
        one_plan = dataclasses.replace(plan, tp=1)
        _, _, one = zero1_run(build_model(cfg, one_plan), one_plan, batches,
                              watch=ZeroWatch(steps=1),
                              prepare=tp_taps if family == "ssm" else None)
        rel = lambda a, b: abs(a - b) / abs(b)                      # noqa: E731
        rec["one_device"] = {"loss": one["loss"], "grad_norm": one["grad_norm"],
                             "loss_rel": [rel(a, b) for a, b in zip(run["loss"], one["loss"])],
                             "grad_norm_rel": [rel(a, b) for a, b in
                                               zip(run["grad_norm"], one["grad_norm"])]}
        if shards is not None:
            rec["one_device"]["first_grads_rel"] = grid_agreement(
                run, one, shards)["first_grads_rel"]
        log(f"tp {cfg.arch_id} against one device: {rec['one_device']}")
        free()
    grid.barrier_error(False)
    return rec


def tp_fp32(grid):
    """The dense family in fp32 at TP_FP32_LAYERS layers, one step, held to
    one device's step on the same weights and batch by GRID_TOLERANCE (on model
    rank 0, after the TP step and its control, ``bf16_partial_sum``, which
    must fail the grads rule). The step's kernel launches are counted (B1 on
    its fp32 body); the control's are not."""
    from repro_torch.models import build_model
    from repro_torch.train import Hyper
    cfg, plan, model, batches = tp_setup("dense", TP_FP32_LAYERS, "float32")
    reset_counts()
    watch = ZeroWatch(steps=1, shadow=True)
    _, _, run = zero1_run(model, plan, batches, grid, watch=watch)
    rec = {"layers": cfg.n_layers, "launches": all_counts(), "bodies": body_counts(),
           "loss": run["loss"], "grad_norm": run["grad_norm"], "shadow_err": watch.shadow_err}
    free()
    control = ZeroWatch(steps=1)
    with bf16_partial_sum():
        zero1_run(model, plan, batches, grid, watch=control)
    free()
    shards = grid_gather(watch.grads, grid)
    control_shards = grid_gather(control.grads, grid)
    grid.barrier_error(False)
    if grid.rank == 0:
        one_plan = dataclasses.replace(plan, tp=1)
        one_model = build_model(cfg, one_plan)
        _, _, one = zero1_run(one_model, one_plan, batches, watch=ZeroWatch(steps=1))
        params = one_model.init(torch.Generator(device="cuda").manual_seed(0))
        truth = fp64_first_grads(cfg, params, batches[0], 1, Hyper())
        del params
        agree = grid_agreement(run, one, shards)
        bad, explained = grid_failures(agree, watch.shadow_err, shards, one["grads"], truth)
        control_bad, _ = grid_grad_failures(control_shards, one["grads"], truth)
        if not control_bad:
            bad.append("the control (a bf16 partial sum in every row GEMM's ring) passes the "
                       "grads rule")
        rec.update(agree=agree, failures=bad, explained=explained, one_device_loss=one["loss"],
                   one_device_grad_norm=one["grad_norm"],
                   dp_tolerance_met=not bad and not explained,
                   control_failures=len(control_bad), control_first=control_bad[:3])
        log(f"tp fp32 {cfg.arch_id} ({cfg.n_layers} layers) against one device: loss "
            f"{run['loss']} / {one['loss']}, {agree}; DP_TOLERANCE met "
            f"{rec['dp_tolerance_met']}; leaves past 1e-6 that the fp64 rule admits "
            f"(error, TP's distance from fp64, one device's) {explained}; the control fails "
            f"the rule on {len(control_bad)} leaf shards, first {control_bad[:3]}; "
            f"failures {bad}")
        free()
    grid.barrier_error(False)
    return rec


def grid_agreement(run, one, shards, part=tp_part):
    """The first step of a grid run against one device's: loss and grad norm
    relative, and the clipped grads (``shards``, every rank's) against each
    rank's part of one device's, in units of each leaf's max."""
    rel = lambda a, b: abs(a - b) / abs(b)                      # noqa: E731
    return {"loss_rel_step0": rel(run["loss"][0], one["loss"][0]),
            "grad_norm_rel_step0": rel(run["grad_norm"][0], one["grad_norm"][0]),
            "first_grads_rel": max(rel_err(s[n], part(n, g, r, len(shards)))
                                   for n, g in one["grads"].items()
                                   for r, s in enumerate(shards))}


def tp_rank(rank, init_method, out_dir):
    """One of the TP_RANKS processes of the TP phase, on cuda:0 over gloo:
    the three families (``tp_family``), then the fp32 check (``tp_fp32``).
    Results go to ``out_dir/tp_rank{rank}.json``."""
    from repro_torch.core import resolve_device
    from repro_torch.launch import init_grid_mesh
    resolve_device()
    grid = init_grid_mesh(1, TP_RANKS, "cuda:0", backend="gloo", init_method=init_method,
                          rank=rank)
    log(f"tp rank {rank}: {grid}")
    out = {"rank": rank, "mesh": repr(grid)}
    for family in TP_FAMILIES:
        t0 = time.perf_counter()
        out[family] = tp_family(family, grid, out_dir)
        out[family]["seconds"] = time.perf_counter() - t0
        free()
    out["fp32"] = tp_fp32(grid)
    grid.close()
    (Path(out_dir) / f"tp_rank{rank}.json").write_text(json.dumps(out))


def rank_part(rank, init_method, device, target, out_dir):
    """One part of a spawn of rank processes (``spawned_ranks``):
    ``target(rank, init_method, out_dir)``, then the memory freed; returns
    its seconds."""
    t0 = time.perf_counter()
    target(rank, init_method, out_dir)
    free()
    return time.perf_counter() - t0


@contextlib.contextmanager
def spawned_ranks(parts, n, timeout):
    """The rank functions ``parts`` ({tag: ``target(rank, init_method,
    out_dir)``}, each writing ``out_dir/<tag>_rank<r>.json``) in turn in one
    spawn of ``n`` rank processes on the card (``examples.ranks.spawn``: a
    process group over a ``file://`` store for each part; every process
    joined within ``timeout`` seconds or killed). Yields (out_dir, {tag: the
    ranks' results}, {tag: its slowest rank's seconds}, the spawn's seconds)
    once all exited 0; ``out_dir`` is removed on the way out."""
    import shutil
    import tempfile
    from repro_torch.examples import ranks
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="_".join(parts) + "_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        seconds = ranks.spawn([(rank_part, {"target": fn, "out_dir": tmp})
                               for fn in parts.values()], n, "cuda", timeout)
        spawn_s = time.perf_counter() - t0
        results = {tag: [json.loads((Path(tmp) / f"{tag}_rank{r}.json").read_text())
                         for r in range(n)] for tag in parts}
        yield tmp, results, {tag: max(t) for tag, t in zip(parts, seconds)}, spawn_s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_tp(ranks_done=None, before_times=None):
    """The TP phase: TP_RANKS spawned ranks on the one card over gloo
    (``tp_rank``); their results checked here, then the kernels timed at the
    sharded shapes (B1-B3 at each attention family's, B4 and B5/B6 on rank
    0's kept inputs). Under ``dp_and_tp``: the file ``ranks_done`` is made
    once the ranks have exited, and the kernels are timed once the
    threading.Event ``before_times`` is set."""
    with spawned_ranks({"tp": tp_rank}, TP_RANKS, timeout=480) as (tmp, res, _, ranks_s):
        ranks = res["tp"]
        if ranks_done is not None:
            ranks_done.touch()
        tp_report(ranks)
        if before_times is not None:
            before_times.wait()
        t0 = time.perf_counter()
        times = tp_times(tmp)
        times_s = time.perf_counter() - t0
    log(f"phase TP: ranks {ranks_s:.1f} s, kernel times {times_s:.1f} s")
    return {"ranks": ranks, "times": times, "ranks_s": ranks_s, "times_s": times_s}


def tp_times(keep_dir):
    """The kernels at the TP path's sharded shapes: B1 (fwd_times_at) and
    B2/B3 (bwd_times_at, with the plain backward) at each attention family's
    (1, H/2, 4096, 128); B4 (gemm_times) and B5/B6 (ssd_times) on rank 0's
    kept inputs."""
    from repro_torch.kernels import flash_attention as tf
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for family, case in TP_CASES.items():
        fwd = fwd_times_at(case, gen)
        bwd = bwd_times_at(case, gen)
        q, k, v, do, lse, delta, kw = bwd.pop("inputs")
        bwd["plain_ms"] = cuda_ms(lambda: tf.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                                      **kw), 3, warmup=1)
        out[family] = {"fwd": fwd, "bwd": bwd}
        del q, k, v, do, lse, delta
        free()
    out["gemm"] = gemm_times(torch.load(Path(keep_dir) / "tp_gemm.pt"))
    free()
    out["ssd"] = ssd_times(f"{SSM_ARCH} tp", torch.load(Path(keep_dir) / "tp_ssd.pt"))
    free()
    return out


def tp_report(ranks):
    """Log the TP phase's results and hold them to their checks: every
    family's losses finite and equal on both ranks, the fp32 step by
    GRID_TOLERANCE; keep the launches by body for the kernels line."""
    r0 = ranks[0]
    bad = []
    for family in TP_FAMILIES:
        for r in ranks:
            f = r[family]
            log(f"tp {family} rank {r['rank']} ({r['mesh']}): beside the DP ranks (not the "
                f"steps' own time) steps {f['ms']} ms, ticks {f['tick_ms']} ms, all-reduces "
                f"{f['all_reduce_ms']} ms, link bytes a step by kind {f['link_bytes']} (two "
                f"ranks share one card and the rings go through "
                f"host memory: no measure of TP scaling or overlap); peak {f['peak_bytes'] / 1e9:.2f} GB, {f['params_per_rank'] / 1e9:.3f} "
                f"B params a rank; launches {f['launches']} a step; bodies {f['bodies']}; on its "
                f"own inputs {({k: f[k] for k in f if k.startswith('real_')})}; "
                f"{f['seconds']:.1f} s")
            if not all(np.isfinite(x) for x in f["loss"] + f["grad_norm"]):
                bad.append(f"{family} rank {r['rank']}: a loss or grad norm is not finite")
            if (f["loss"], f["grad_norm"]) != (r0[family]["loss"], r0[family]["grad_norm"]):
                bad.append(f"{family}: rank {r['rank']} reports {f['loss']} / {f['grad_norm']}")
        log(f"tp {family} against one device (readings): {r0[family]['one_device']}")
        BODY_COUNTS[f"tp_{family}_train_step"] = {
            k: sum(r[family]["bodies"][k] for r in ranks) for k in r0[family]["bodies"]}
    fp32 = r0["fp32"]
    bad += [f"fp32: {b}" for b in fp32["failures"]]
    BODY_COUNTS["tp_dense_fp32_train_step"] = {
        k: sum(r["fp32"]["bodies"][k] for r in ranks) for k in r0["fp32"]["bodies"]}
    if bad:
        raise AssertionError("TP phase: " + "; ".join(bad))


def tp_summary(tp):
    """The TP phase's numbers for the kernels line (``qwen1.5-4b_tp``)."""
    ranks = tp["ranks"]
    keys = ("launches", "peak_bytes", "params_per_rank", "loss", "grad_norm")
    return {
        "grid": {"data": 1, "model": TP_RANKS},
        "transport": "gloo, host copies (two ranks on one card); no measure of TP scaling",
        "beside_dp_ranks": "taken while the DP ranks ran on the same card and host "
                           "(dp_and_tp): not the TP steps' own times",
        "families": {family: {"arch": TP_FAMILIES[family][0],
                              "layers": ranks[0][family]["layers"],
                              "ranks": [{**{k: r[family][k] for k in keys},
                                         "beside_dp_ranks": {k: r[family][k]
                                                             for k in TP_BESIDE_DP}}
                                        for r in ranks],
                              "one_device": ranks[0][family]["one_device"],
                              "real_inputs": {k: ranks[0][family][k] for k in ranks[0][family]
                                              if k.startswith("real_")}}
                     for family in TP_FAMILIES},
        "fp32": {k: v for k, v in ranks[0]["fp32"].items() if k != "bodies"},
        "tolerance": GRID_TOLERANCE,
        "phase_s": {"ranks": tp["ranks_s"], "kernel_times": tp["times_s"]},
    }


def tp_launches(tp, i, families=("dense", "moe", "ssm", "fp32")):
    """One kernel's launches on the TP paths (``i``: its index in the
    launches tuple, B1, B2, B3, B4 rows, B4 contract, B5, B6), summed over the
    ranks, by window: {"tp_<family>_train_step": n} (the fp32 step as
    "tp_dense_fp32_train_step"); only the windows where it launched."""
    out = {}
    for family in families:
        n = sum(r[family]["launches"][i] if i < len(r[family]["launches"]) else 0
                for r in tp["ranks"])
        if n:
            out["tp_dense_fp32_train_step" if family == "fp32" else f"tp_{family}_train_step"] = n
    return out


# ---------------------------------------------------------------------------
# context parallelism (A13.3): CP_RANKS spawned ranks on the one card over
# gloo, a (1, 2, 1) (data, cp, model) grid. qwen1.5-4b at full width on
# CP_DENSE_LAYERS of its 40 layers over 1 x CP_DENSE_SEQ tokens in the ring
# mode (each rank two zigzag sub-chunks of CP_SUB), one warm-up and
# CP_DENSE_STEPS steps; mamba2-370m at full width on CP_SSM_LAYERS layers over 1 x
# CP_SSM_SEQ (each rank CP_SSM_SEQ / 2 contiguous), one warm-up and
# CP_SSM_STEPS steps; bf16 compute, remat "full"; then fp32 steps at
# CP_FP32_LAYERS layers and 1 x TRAIN_SEQ (dense ring and gather, Mamba2) held
# to one device's by GRID_TOLERANCE. Nothing is checkpointed.
CP_RANKS = 2
CP_DENSE_LAYERS = 2
CP_DENSE_SEQ = 16_384
CP_DENSE_STEPS = 1                # timed, after one warm-up
CP_SSM_SEQ = 65_536
CP_SSM_LAYERS = 6                 # of mamba2-370m's 48 (the script's time limit)
CP_SSM_STEPS = 2                  # timed, after one warm-up
CP_FP32_LAYERS = 2
CP_SUB = CP_DENSE_SEQ // (2 * CP_RANKS)          # a zigzag sub-chunk: one ring tile's side
CP_CASES = {"diagonal": (1, 20, 20, CP_SUB, CP_SUB, 128, True, 0, 0.0, 0),
            "full": (1, 20, 20, CP_SUB, CP_SUB, 128, False, 0, 0.0, 0)}


def cp_setup(family, layers=None, dtype="bfloat16", seq=CP_DENSE_SEQ, steps=1, impl="ring"):
    """A family's full-width config (qwen1.5-4b or mamba2-370m, cut to
    ``layers`` layers where given), its plan (fp32 masters, ``dtype``
    compute, remat "full", one microbatch of 1 x ``seq``, cp CP_RANKS in
    ``impl``), the model and ``steps`` batches."""
    from repro_torch.core import InputShape, ParallelPlan, get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    cfg = get_config(TRAIN_ARCH if family == "dense" else SSM_ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    plan = ParallelPlan(compute_dtype=dtype, param_dtype="float32", remat="full",
                        microbatches=1, cp=CP_RANKS, cp_impl=impl)
    ds = SyntheticDataset(cfg, InputShape("cp", seq, 1, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(steps)]
    return cfg, plan, build_model(cfg, plan), batches


def cp_want(family, cfg, impl):
    """The launches of one rank's step (one microbatch, remat full): B1, B2,
    B3, B4 rows, B4 contract, B5, B6. The ring runs 2 cp + 1 tiles a layer
    on each rank (of its 4 cp (q, k) sub-chunk pairs, the rest are masked
    and launch nothing), the gather mode one; B1 twice (forward, recompute)."""
    n = cfg.n_layers
    if family == "ssm":
        return (0, 0, 0, 0, 0, 2 * n, n)
    tiles = 2 * CP_RANKS + 1 if impl == "ring" else 1
    return (2 * tiles * n, tiles * n, tiles * n, 0, 0, 0, 0)


def cp_window(family, impl, fp32=False):
    """The kernels line's name for a CP path's step."""
    return f"cp_{family}{'_' + impl if family == 'dense' else ''}{'_fp32' if fp32 else ''}_train_step"


def cp_checked_microbatch(family, cfg, plan, grid, batch, out, keep_dir=None):
    """A ``prepare`` for ``zero1_run``: the rank's microbatch through the CP
    loss and its backward with every kernel call held to its plain version
    on the rank's own inputs (B1 FlashFwdCapture on every ring tile or the
    gather mode's one call, on the Hopper body in bf16 and the fp32 body in
    fp32; B2/B3 FlashBwdCapture against the merged statistics, dq also to
    fp64 in bf16; B5/B6 SSDCapture on the rank's chunk), as many calls as
    ``cp_want`` predicts. B5/B6's first calls are saved under ``keep_dir``
    for the times."""
    from repro_torch.core.tree import leaves
    from repro_torch.train import Hyper
    from repro_torch.train.executor import make_executor_loss_fn
    want = cp_want(family, cfg, plan.cp_impl)
    bf16 = plan.compute_dtype == "bfloat16"

    def prepare(params):
        if family == "ssm":
            tp_taps(params)
        loss_fn = make_executor_loss_fn(cfg, plan, grid, z_loss=Hyper().z_loss)
        what = f"{cfg.arch_id} cp {plan.cp_impl} {plan.compute_dtype} rank {grid.rank} microbatch"
        if family == "ssm":
            with SSDCapture() as ssd:
                loss, _ = loss_fn(params, batch)
                loss.backward()
            if (len(ssd.fwd_errs), len(ssd.bwd_errs)) != want[5:]:
                raise AssertionError(f"{what}: checked {len(ssd.fwd_errs)} B5 and "
                                     f"{len(ssd.bwd_errs)} B6 calls, expected {want[5:]}")
            out["real_ssd"] = ssd.summary(what)
            if keep_dir is not None:
                torch.save(ssd.kept, Path(keep_dir) / "cp_ssd.pt")
        else:
            with FlashBwdCapture(fp64=bf16) as bwd, FlashFwdCapture() as fwd:
                loss, _ = loss_fn(params, batch)
                loss.backward()
            out["real_fwd_ulps"] = fwd.summary(f"{what} (forward and recompute)", want[0],
                                               body="sm90" if bf16 else "f32")
            out["real_bwd_ulps"] = bwd.summary(f"{what} (merged statistics)", want[1])
        out["microbatch_loss"] = float(loss)
        for p in leaves(params):
            p.grad = None
    return prepare


def cp_step_counter(family, cfg, impl, grid, rec):
    """A context-manager factory for ``zero1_run``'s ``around``: each step's
    wall time (synchronised), its cp ring seconds by kind (hops; all-reduces,
    the grads' sum among them; the ring waits for the device around each) and
    the kernels' launches, which must be ``cp_want``'s and all on the Hopper
    bodies."""
    want = cp_want(family, cfg, impl)
    window = cp_window(family, impl)

    @contextlib.contextmanager
    def around(i):
        reset_counts()
        grid.cp.timed = True
        before, stats = dict(grid.cp.seconds), grid.cp.collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("tick", "all_reduce"):
            rec[f"{k}_ms"].append((grid.cp.seconds[k] - before[k]) * 1e3)
        rec.setdefault("link_bytes", []).append(link_bytes_since(grid.cp, stats))
        launches = all_counts() + ssd_counts()
        rec["launches"] = launches
        if launches != want:
            raise AssertionError(f"{cfg.arch_id} cp step {i} launched {launches}, "
                                 f"expected {want}")
        check_bodies(f"{cfg.arch_id} cp rank {grid.rank} step {i}", launches, window)
        rec["bodies"] = BODY_COUNTS[window]
        grid.cp.timed = False
    return around


def cp_family(family, grid, out_dir):
    """One family on this rank: the checked microbatch, a warm-up and the
    timed steps, peak memory; then, on rank 0 while rank 1 waits, one
    device's loss on the first batch from the same weights (a reading)."""
    from repro_torch.core.tree import named_leaves
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, make_loss_fn
    dense = family == "dense"
    steps = 1 + (CP_DENSE_STEPS if dense else CP_SSM_STEPS)
    cfg, plan, model, batches = cp_setup(family, CP_DENSE_LAYERS if dense else CP_SSM_LAYERS,
                                         seq=CP_DENSE_SEQ if dense else CP_SSM_SEQ, steps=steps)
    rec = {"layers": cfg.n_layers, "seq": batches[0]["tokens"].shape[1], "ms": [],
           "tick_ms": [], "all_reduce_ms": []}
    check = cp_checked_microbatch(family, cfg, plan, grid, batches[0], rec,
                                  out_dir if grid.rank == 0 else None)
    torch.cuda.reset_peak_memory_stats()
    state, _, run = zero1_run(model, plan, batches, grid, prepare=check,
                              around=cp_step_counter(family, cfg, plan.cp_impl, grid, rec),
                              keep_params=False)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["params_per_rank"] = sum(x.numel() for _, leaf in named_leaves(state.params)
                                 for x in (leaf if isinstance(leaf, list) else [leaf]))
    rec.update(loss=run["loss"], grad_norm=run["grad_norm"])
    log(f"cp rank {grid.rank} {cfg.arch_id} ({cfg.n_layers} layers, 1 x {rec['seq']}): steps "
        f"{[round(x, 1) for x in rec['ms']]} ms, hops {[round(x, 1) for x in rec['tick_ms']]} "
        f"ms, all-reduces {[round(x, 1) for x in rec['all_reduce_ms']]} ms, losses "
        f"{run['loss']}, peak {rec['peak_bytes'] / 1e9:.2f} GB")
    del state, model
    free()
    grid.barrier_error(False)
    if grid.rank == 0:
        one = build_model(cfg, dataclasses.replace(plan, cp=1))
        params = one.init(torch.Generator(device="cuda").manual_seed(0))
        if not dense:
            tp_taps(params)
        with torch.no_grad():
            loss = float(make_loss_fn(one, Hyper())(params, batches[0])[0])
        rec["one_device_loss"] = loss
        rec["one_device_loss_rel"] = abs(run["loss"][0] - loss) / abs(loss)
        log(f"cp {cfg.arch_id} step 0 loss {run['loss'][0]} against one device's {loss} on "
            f"the same weights and batch: {rec['one_device_loss_rel']:.3e} relative (a reading)")
        del params, one
        free()
    grid.barrier_error(False)
    return rec


@contextlib.contextmanager
def tile_bf16_rounding():
    """GRID_TOLERANCE's CP control: within the block each ring tile's o is
    rounded to bf16 before it merges into its row (``executor._merge_lse``),
    a fault the grads rule must catch."""
    from repro_torch.train import executor
    real = executor._merge_lse

    def rounded(o, lse, o_c, lse_c):
        return real(o, lse, o_c.to(torch.bfloat16).to(o_c.dtype), lse_c)
    executor._merge_lse = rounded
    try:
        yield
    finally:
        executor._merge_lse = real


def on_card(named):
    """Host arrays by name as tensors on the card (the grads rule then runs
    there: a few ms where numpy takes seconds on a full-width vocab)."""
    return {n: torch.from_numpy(np.ascontiguousarray(a)).cuda() for n, a in named.items()}


def cp_one_device(cfg, plan, batches, taps):
    """One device's step on the CP run's weights (seed 0) and batches, and an
    fp64 evaluation of its first step (``fp64_first_grads``); the first
    step's grads and the evaluation on the card."""
    from repro_torch.models import build_model
    from repro_torch.train import Hyper
    one_plan = dataclasses.replace(plan, cp=1)
    model = build_model(cfg, one_plan)
    _, _, one = zero1_run(model, one_plan, batches, watch=ZeroWatch(steps=1),
                          prepare=tp_taps if taps else None, keep_params=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    if taps:
        tp_taps(params)
    truth = fp64_first_grads(cfg, params, batches[0], 1, Hyper())
    del params, model
    free()
    return {**one, "grads": on_card(one["grads"])}, on_card(truth)


def rank_checksums(named, grid):
    """Every rank's exact uint32 checksum of its host arrays ``named``
    (``ft.integrity.tree_checksum``), gathered over the grid's host group:
    equal on every rank when they hold the same bits."""
    import torch.distributed as dist
    from repro_torch.ft.integrity import tree_checksum
    mine = int(tree_checksum({n: torch.from_numpy(np.ascontiguousarray(a))
                              for n, a in named.items()}))
    out = [None] * grid.size
    dist.all_gather_object(out, mine, group=grid.host_group)
    return out


def cp_fp32(grid):
    """The fp32 steps at CP_FP32_LAYERS layers and 1 x TRAIN_SEQ: dense in the
    ring and the gather modes, the ring's control (``tile_bf16_rounding``),
    and Mamba2, each one step. Every rank holds the same grads after the cp
    sum (checked by their checksums), so rank 0's first grads (whole leaves)
    are held to one device's step and its fp64 evaluation by GRID_TOLERANCE,
    which the control must fail. One device's step runs on rank 0 first,
    while rank 1 waits. Before each step but the control's, the rank's
    microbatch is checked whole (``cp_checked_microbatch``: every kernel call
    against its plain version, on the fp32 bodies); before the gather step,
    also in bf16 on the same weights, so that the gather mode's B1 with its
    causal q_offset and its B2/B3 meet their plain versions on the Hopper
    body. The steps' launches must be ``cp_want``'s, on the fp32 bodies; the
    control's are not counted."""
    out = {}
    for family, runs in (("dense", (("ring", "ring", False), ("gather", "gather", False),
                                     ("control", "ring", True))),
                         ("ssm", (("ring", "ring", False),))):
        cfg, plan, model, batches = cp_setup(family, CP_FP32_LAYERS, "float32", TRAIN_SEQ)
        one = truth = None
        if grid.rank == 0:
            one, truth = cp_one_device(cfg, plan, batches, family == "ssm")
        grid.barrier_error(False)
        for name, impl, control in runs:
            p = dataclasses.replace(plan, cp_impl=impl)
            checked, checked_bf16 = {}, {}
            prepare = None
            if not control:
                checks = [cp_checked_microbatch(family, cfg, p, grid, batches[0], checked)]
                if impl == "gather":
                    checks.append(cp_checked_microbatch(
                        family, cfg, dataclasses.replace(p, compute_dtype="bfloat16"), grid,
                        batches[0], checked_bf16))
                prepare = lambda params: [c(params) for c in checks]     # noqa: E731
            reset_counts()
            watch = ZeroWatch(steps=1, shadow=not control)
            with tile_bf16_rounding() if control else contextlib.nullcontext():
                _, _, run = zero1_run(model, p, batches, grid, watch=watch, prepare=prepare,
                                      keep_params=False)
            rec = {"layers": cfg.n_layers, "launches": all_counts() + ssd_counts(),
                   "bodies": body_counts(), "loss": run["loss"], "grad_norm": run["grad_norm"],
                   "rank_checksums": rank_checksums(watch.grads, grid), **checked}
            if checked_bf16:
                rec["bf16_microbatch"] = checked_bf16
            if not control:
                want = cp_want(family, cfg, impl)
                if tuple(rec["launches"]) != want:
                    raise AssertionError(f"{cfg.arch_id} cp fp32 {name} step launched "
                                         f"{rec['launches']}, expected {want}")
                check_bodies(f"{cfg.arch_id} cp fp32 {name} rank {grid.rank}",
                             rec["launches"], fp32=True)
            free()
            if grid.rank == 0:
                shards = [on_card(watch.grads)]
                bad = [] if len(set(rec["rank_checksums"])) == 1 else [
                    f"the ranks' grads differ: checksums {rec['rank_checksums']}"]
                if control:
                    control_bad, _ = grid_grad_failures(shards, one["grads"], truth, whole_part)
                    rec.update(control_failures=len(control_bad), control_first=control_bad[:3])
                    if not control_bad:
                        bad.append("the control (each ring tile's o rounded to bf16) passes "
                                   "the grads rule")
                    out["dense"]["ring"]["failures"] += bad
                else:
                    agree = grid_agreement(run, one, shards, whole_part)
                    rule_bad, explained = grid_failures(agree, watch.shadow_err, shards,
                                                        one["grads"], truth, whole_part)
                    rec.update(agree=agree, failures=bad + rule_bad, explained=explained,
                               one_device_loss=one["loss"],
                               one_device_grad_norm=one["grad_norm"],
                               dp_tolerance_met=not rule_bad and not explained)
                log(f"cp fp32 {cfg.arch_id} {name} ({cfg.n_layers} layers, 1 x {TRAIN_SEQ}): "
                    f"rank checksums {rec['rank_checksums']}; "
                    + (f"fails the grads rule on {rec['control_failures']} leaves, first "
                       f"{rec['control_first']}" if control else
                       f"loss {run['loss']} / {one['loss']}, {rec['agree']}; leaves past 1e-6 "
                       f"that the fp64 rule admits (error, CP's distance from fp64, one "
                       f"device's) {rec['explained']}; failures {rec['failures']}"))
                del shards
            out.setdefault(family, {})[name] = rec
            free()
            grid.barrier_error(False)
        del model, one, truth
        free()
    return out


def cp_rank(rank, init_method, out_dir):
    """One of the CP_RANKS processes of the CP phase, on cuda:0 over gloo:
    the dense and Mamba2 paths (``cp_family``), then the fp32 checks
    (``cp_fp32``). Results go to ``out_dir/cp_rank{rank}.json``."""
    from repro_torch.core import resolve_device
    from repro_torch.launch import init_grid_mesh
    resolve_device()
    grid = init_grid_mesh(1, 1, "cuda:0", cp=CP_RANKS, backend="gloo", init_method=init_method,
                          rank=rank)
    log(f"cp rank {rank}: {grid}")
    out = {"rank": rank, "mesh": repr(grid)}
    for family in ("dense", "ssm"):
        t0 = time.perf_counter()
        out[family] = cp_family(family, grid, out_dir)
        out[family]["seconds"] = time.perf_counter() - t0
        free()
    t0 = time.perf_counter()
    out["fp32"] = cp_fp32(grid)
    out["fp32"]["seconds"] = time.perf_counter() - t0
    grid.close()
    (Path(out_dir) / f"cp_rank{rank}.json").write_text(json.dumps(out))


def cp_bwd_inputs(gen, cases=CP_CASES):
    """q, dO and the two KV sub-chunks of a ring row (bf16, head-major views
    of batch-major tensors) with the row's statistics merged over both: an
    earlier sub-chunk seen whole and the row's own diagonal (lse from the
    plain forward over the two, delta = rowsum(dO * O)); the shapes of
    ``cases``' diagonal tile."""
    b, hq, hkv, s, t, hd = cases["diagonal"][:6]
    q = batch_major(gen, b, hq, s, hd, torch.bfloat16)
    k_full, v_full, k_diag, v_diag = (batch_major(gen, b, hkv, t, hd, torch.bfloat16)
                                      for _ in range(4))
    do = batch_major(gen, b, hq, s, hd, torch.bfloat16)
    o, lse = flash_plain(q, torch.cat([k_full, k_diag], 2), torch.cat([v_full, v_diag], 2),
                         causal=True, q_offset=t)
    delta = (do.float() * o.float()).sum(-1)
    return q, do, lse, delta, {"full": (k_full, v_full), "diagonal": (k_diag, v_diag)}


def ring_tile_times(cases, gen):
    """B1 (fwd_times_at, beside SDPA) on a diagonal and a full ring tile of
    ``cases``; B2/B3 (bwd_times_at, with the plain backward) on each against
    the statistics merged over the row."""
    from repro_torch.kernels import flash_attention as tf
    out = {}
    q, do, lse, delta, kv = cp_bwd_inputs(gen, cases)
    for name, case in cases.items():
        fwd = fwd_times_at(case, gen)
        k, v = kv[name]
        bwd = bwd_times_at(case, gen, inputs=(q, k, v, do, lse, delta))
        kw = bwd.pop("inputs")[-1]
        bwd["plain_ms"] = cuda_ms(lambda: tf.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                                      **kw), 3, warmup=1)
        out[name] = {"fwd": fwd, "bwd": bwd}
        free()
    del q, do, lse, delta, kv
    free()
    return out


def cp_times(keep_dir):
    """The kernels at the CP path's shapes: B1-B3 on a diagonal and a full
    ring tile at (1, 20, CP_SUB, 128) (``ring_tile_times``); B5/B6
    (ssd_times) on rank 0's kept inputs at (1, 32, CP_SSM_SEQ / 2, 64, 128)."""
    out = ring_tile_times(CP_CASES, torch.Generator(device="cuda").manual_seed(8))
    out["ssd"] = ssd_times(f"{SSM_ARCH} cp", torch.load(Path(keep_dir) / "cp_ssd.pt"))
    free()
    return out


def cp_report(ranks):
    """Log the CP phase's results and hold them to their checks: every
    family's losses finite and equal on both ranks, the fp32 steps by
    GRID_TOLERANCE and the control failing it; keep the launches by body for
    the kernels line."""
    r0 = ranks[0]
    bad = []
    for family in ("dense", "ssm"):
        for r in ranks:
            f = r[family]
            log(f"cp {family} rank {r['rank']} ({r['mesh']}): steps {f['ms']} ms, hops "
                f"{f['tick_ms']} ms, all-reduces {f['all_reduce_ms']} ms, link bytes a step by "
                f"kind {f['link_bytes']} (two ranks share one "
                f"card and the ring goes through host memory: no measure of CP scaling); peak "
                f"{f['peak_bytes'] / 1e9:.2f} GB, {f['params_per_rank'] / 1e9:.3f} B params a "
                f"rank; launches {f['launches']} a step; bodies {f['bodies']}; on its own inputs "
                f"{({k: f[k] for k in f if k.startswith('real_')})}; {f['seconds']:.1f} s")
            if not all(np.isfinite(x) for x in f["loss"] + f["grad_norm"]):
                bad.append(f"{family} rank {r['rank']}: a loss or grad norm is not finite")
            if (f["loss"], f["grad_norm"]) != (r0[family]["loss"], r0[family]["grad_norm"]):
                bad.append(f"{family}: rank {r['rank']} reports {f['loss']} / {f['grad_norm']}")
        window = cp_window(family, "ring")
        BODY_COUNTS[window] = {k: sum(r[family]["bodies"][k] for r in ranks)
                               for k in r0[family]["bodies"]}
    for family, runs in r0["fp32"].items():
        if family == "seconds":
            continue
        for name, rec in runs.items():
            bad += [f"fp32 {family} {name}: {b}" for b in rec.get("failures", [])]
            if name != "control":
                BODY_COUNTS[cp_window(family, name, fp32=True)] = {
                    k: sum(r["fp32"][family][name]["bodies"][k] for r in ranks)
                    for k in rec["bodies"]}
    if bad:
        raise AssertionError("CP phase: " + "; ".join(bad))


def cp_launches(cp, i):
    """One kernel's launches on the CP paths (``i``: its index in the
    launches tuple), summed over the ranks, by window (``cp_window``); only
    the windows where it launched."""
    out = {}
    for family in ("dense", "ssm"):
        n = sum(r[family]["launches"][i] for r in cp["ranks"])
        if n:
            out[cp_window(family, "ring")] = n
    for family, runs in cp["ranks"][0]["fp32"].items():
        if family == "seconds":
            continue
        for name in runs:
            n = sum(r["fp32"][family][name]["launches"][i] for r in cp["ranks"])
            if n and name != "control":
                out[cp_window(family, name, fp32=True)] = n
    return out


def cp_summary(cp):
    """The CP phase's numbers for the kernels line (``qwen1.5-4b_cp``)."""
    ranks = cp["ranks"]
    keys = ("ms", "tick_ms", "all_reduce_ms", "launches", "peak_bytes", "params_per_rank",
            "loss", "grad_norm", "seconds")
    return {
        "grid": {"data": 1, "cp": CP_RANKS, "model": 1},
        "transport": "gloo, host copies (two ranks on one card); no measure of CP scaling",
        "families": {family: {"arch": TRAIN_ARCH if family == "dense" else SSM_ARCH,
                              "cp_impl": "ring", "layers": ranks[0][family]["layers"],
                              "seq": ranks[0][family]["seq"],
                              "ranks": [{k: r[family][k] for k in keys} for r in ranks],
                              "one_device_loss": ranks[0][family]["one_device_loss"],
                              "one_device_loss_rel": ranks[0][family]["one_device_loss_rel"],
                              "real_inputs": {k: ranks[0][family][k] for k in ranks[0][family]
                                              if k.startswith("real_")}}
                     for family in ("dense", "ssm")},
        "fp32": {family: {name: {k: v for k, v in rec.items() if k != "bodies"}
                          for name, rec in runs.items()}
                 for family, runs in ranks[0]["fp32"].items() if family != "seconds"},
        "tolerance": GRID_TOLERANCE,
        "phase_s": {"ranks": cp["ranks_s"], "kernel_times": cp["times_s"],
                    "fp32_checks": ranks[0]["fp32"]["seconds"]},
    }


# ---------------------------------------------------------------------------
# expert parallelism (A13.4)


@contextlib.contextmanager
def ep_bf16_rounding():
    """GRID_TOLERANCE's EP control: within the block each chunk's expert
    output (``models.moe.ep_chunk_ffn``, as the executor calls it: every tick
    of the overlap ring, the blocking path's one call) is rounded to bf16
    before the combine exchange, a fault the grads rule must catch."""
    from repro_torch.models import moe
    real = moe.ep_chunk_ffn

    def rounded(w, h, **kw):
        y = real(w, h, **kw)
        return y.to(torch.bfloat16).to(y.dtype)
    moe.ep_chunk_ffn = rounded
    try:
        yield
    finally:
        moe.ep_chunk_ffn = real


def ep_part(plan, places, sizes):
    """A ``part`` for ``grid_grad_failures`` under an ep ``plan``: rank r's
    part of one device's whole leaf (its expert block, its TP shard where tp
    is on; ``places[r]`` the rank's ``core.sharding.grid_place`` index)."""
    from repro_torch.core.sharding import layout_part

    def part(name, a, r, n):
        return layout_part(name, a, plan, places[r], sizes)
    return part


# EP_RANKS spawned ranks on the one card over gloo, a (1, 2) grid: the ep-only
# placement (ep 2 on the model axis; attention a cp ring over it, the zigzag
# layout). deepseek-moe-16b at full width on EP_LAYERS of its 28 layers over 1 x
# EP_SEQ tokens (2048 a rank), bf16 compute, remat "full": the overlap ring, a
# warm-up and EP_STEPS steps; the blocking exchange, one step; then fp32 steps at
# EP_FP32_LAYERS layers and 1 x EP_FP32_SEQ at a no-drop capacity held to one
# device's by GRID_TOLERANCE. Nothing is checkpointed.
EP_RANKS = 2
EP_LAYERS = 2
EP_SEQ = TRAIN_SEQ
EP_STEPS = 1                      # the overlap ring's timed steps, after one warm-up
EP_FP32_LAYERS = 2
EP_FP32_SEQ = 1024
EP_SUB = EP_SEQ // (2 * EP_RANKS)                # a zigzag sub-chunk: one ring tile's side
EP_CASES = {"diagonal": (1, 16, 16, EP_SUB, EP_SUB, 128, True, 0, 0.0, 0),
            "full": (1, 16, 16, EP_SUB, EP_SUB, 128, False, 0, 0.0, 0)}


def ep_setup(layers, dtype="bfloat16", seq=EP_SEQ, steps=1, impl="overlap", no_drop=False):
    """deepseek-moe-16b's full-width config cut to ``layers`` layers (with
    ``no_drop``, a capacity factor of ceil(E / top_k), which drops nothing),
    its ep-only plan (fp32 masters, ``dtype`` compute, remat "full", one
    microbatch of 1 x ``seq``, ep EP_RANKS in ``impl``), the model and
    ``steps`` batches."""
    import math
    from repro_torch.core import InputShape, ParallelPlan, get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=layers)
    if no_drop:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(math.ceil(cfg.moe.num_experts / cfg.moe.top_k))))
    plan = ParallelPlan(compute_dtype=dtype, param_dtype="float32", remat="full",
                        microbatches=1, ep=EP_RANKS, ep_impl=impl)
    ds = SyntheticDataset(cfg, InputShape("ep", seq, 1, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(steps)]
    return cfg, plan, build_model(cfg, plan), batches


def ep_want(cfg, impl):
    """The launches of one rank's step (one microbatch, remat full): B1, B2,
    B3, B4 rows, B4 contract, B5, B6. Attention is the cp ring over the ep
    ring: 2 cp + 1 tiles a layer, B1 twice (forward, recompute). The expert
    SwiGLU's 3 GEMMs a call: "blocking" calls them once on all peers' rows
    in the forward and once in the recompute, and the backward runs 3 dx
    (rows) and 3 dw (contract); "overlap" calls them once a tick (EP_RANKS
    ticks) in the forward and in the recompute, and its backward re-runs each
    tick's forward (3 rows) before its 3 dx and 3 dw."""
    n, t = cfg.n_layers, EP_RANKS
    tiles = 2 * EP_RANKS + 1
    rows, contract = (9 * n, 3 * n) if impl == "blocking" else (12 * t * n, 3 * t * n)
    return (2 * tiles * n, tiles * n, tiles * n, rows, contract, 0, 0)


def ep_window(impl, fp32=False):
    """The kernels line's name for an EP path's step."""
    return f"ep_{impl}{'_fp32' if fp32 else ''}_train_step"


def ep_checked_microbatch(cfg, plan, grid, batch, out, keep_dir=None):
    """A ``prepare`` for ``zero1_run``: the rank's microbatch through the EP
    loss and its backward with every kernel call held to its plain version
    on the rank's own inputs (B1 FlashFwdCapture on every ring tile; B2/B3
    FlashBwdCapture against the merged statistics, dq also to fp64 in bf16;
    B4 GemmCapture on every expert GEMM of every chunk, forward, recompute,
    dx and dw), as many calls as ``ep_want`` predicts. B4's first call and
    first dx/dw are saved under ``keep_dir`` for the times."""
    from repro_torch.core.tree import leaves
    from repro_torch.train import Hyper
    from repro_torch.train.executor import make_executor_loss_fn
    want = ep_want(cfg, plan.ep_impl)
    bf16 = plan.compute_dtype == "bfloat16"

    def prepare(params):
        loss_fn = make_executor_loss_fn(cfg, plan, grid, z_loss=Hyper().z_loss)
        what = f"{cfg.arch_id} ep {plan.ep_impl} {plan.compute_dtype} rank {grid.rank} microbatch"
        with FlashBwdCapture(fp64=bf16) as bwd, FlashFwdCapture() as fwd, \
                GemmCapture(keep=(0,), backward=True) as gemm:
            loss, _ = loss_fn(params, batch)
            loss.backward()
        out["real_fwd_ulps"] = fwd.summary(f"{what} (forward and recompute)", want[0],
                                           body="sm90" if bf16 else "f32")
        out["real_bwd_ulps"] = bwd.summary(f"{what} (merged statistics)", want[1])
        calls = tuple(sum(e[0] == m for e in gemm.errs) for m in ("rows", "contract"))
        if calls != want[3:5]:
            raise AssertionError(f"{what}: checked {calls} B4 calls (rows, contract), "
                                 f"expected {want[3:5]}")
        out["real_gemm_ulps"] = gemm.summary(what)
        if keep_dir is not None:
            impl = plan.ep_impl
            torch.save({f"ep_{impl}_forward": gemm.kept[0], f"ep_{impl}_dx": gemm.kept["dx"],
                        f"ep_{impl}_dw": gemm.kept["dw"]}, Path(keep_dir) / f"ep_{impl}_gemm.pt")
        out["microbatch_loss"] = float(loss)
        for p in leaves(params):
            p.grad = None
    return prepare


def ep_step_counter(cfg, impl, grid, rec, fp32=False):
    """A context-manager factory for ``zero1_run``'s ``around``: each step's
    wall time (synchronised), its expert ring's seconds by kind (the ring
    attention's hops, the EP exchanges, the all-reduces with the grads' sum
    among them; the ring waits for the device around each) and the kernels'
    launches, which must be ``ep_want``'s and all on the Hopper bodies (the
    fp32 bodies with ``fp32``)."""
    want = ep_want(cfg, impl)
    window = ep_window(impl, fp32)

    @contextlib.contextmanager
    def around(i):
        reset_counts()
        grid.ep.timed = True
        before, stats = dict(grid.ep.seconds), grid.ep.collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("tick", "a2a", "all_reduce"):
            rec[f"{k}_ms"].append((grid.ep.seconds[k] - before[k]) * 1e3)
        rec.setdefault("link_bytes", []).append(link_bytes_since(grid.ep, stats))
        launches = all_counts() + ssd_counts()
        rec["launches"] = launches
        if launches != want:
            raise AssertionError(f"{cfg.arch_id} ep {impl} step {i} launched {launches}, "
                                 f"expected {want}")
        check_bodies(f"{cfg.arch_id} ep {impl} rank {grid.rank} step {i}", launches, window,
                     fp32=fp32)
        rec["bodies"] = BODY_COUNTS[window]
        grid.ep.timed = False
    return around


def ep_path(impl, grid, out_dir):
    """One exchange mode on this rank at full width: the checked microbatch,
    then the steps (the overlap ring a warm-up and EP_STEPS, the blocking
    exchange one), their readings and peak memory."""
    from repro_torch.core.tree import named_leaves
    steps = 1 + EP_STEPS if impl == "overlap" else 1
    cfg, plan, model, batches = ep_setup(EP_LAYERS, steps=steps, impl=impl)
    rec = {"layers": cfg.n_layers, "seq": batches[0]["tokens"].shape[1], "ms": [],
           "tick_ms": [], "a2a_ms": [], "all_reduce_ms": []}
    check = ep_checked_microbatch(cfg, plan, grid, batches[0], rec,
                                  out_dir if grid.rank == 0 else None)
    torch.cuda.reset_peak_memory_stats()
    state, _, run = zero1_run(model, plan, batches, grid, prepare=check,
                              around=ep_step_counter(cfg, impl, grid, rec), keep_params=False)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["params_per_rank"] = sum(x.numel() for _, leaf in named_leaves(state.params)
                                 for x in (leaf if isinstance(leaf, list) else [leaf]))
    rec.update(loss=run["loss"], grad_norm=run["grad_norm"])
    log(f"ep rank {grid.rank} {cfg.arch_id} {impl} ({cfg.n_layers} layers, 1 x {rec['seq']}): "
        f"steps {[round(x, 1) for x in rec['ms']]} ms, exchanges "
        f"{[round(x, 1) for x in rec['a2a_ms']]} ms, ring-attention hops "
        f"{[round(x, 1) for x in rec['tick_ms']]} ms, all-reduces "
        f"{[round(x, 1) for x in rec['all_reduce_ms']]} ms, losses {run['loss']}, peak "
        f"{rec['peak_bytes'] / 1e9:.2f} GB")
    del state, model
    free()
    grid.barrier_error(False)
    return rec


def ep_one_device(cfg, plan, batches):
    """One device's step on the EP run's weights (seed 0) and batch, and an
    fp64 evaluation of its first step (``fp64_first_grads``), both on the
    host."""
    from repro_torch.models import build_model
    from repro_torch.train import Hyper
    one_plan = dataclasses.replace(plan, ep=1)
    model = build_model(cfg, one_plan)
    _, _, one = zero1_run(model, one_plan, batches, watch=ZeroWatch(steps=1), keep_params=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    truth = fp64_first_grads(cfg, params, batches[0], 1, Hyper())
    del params, model
    free()
    return one, truth


def ep_fp32(grid):
    """The fp32 steps at EP_FP32_LAYERS layers and 1 x EP_FP32_SEQ at a
    no-drop capacity: the overlap ring, the blocking exchange and the
    control (``ep_bf16_rounding``), each one step from the same weights. One
    device's step and its fp64 evaluation run on rank 0 first, while rank 1
    waits. The overlap step's first grads, every rank's (rank 1 sends its
    expert blocks to rank 0; the other leaves are the same bits on both, by
    their checksums), are held to one device's by GRID_TOLERANCE; the
    blocking step's agree with the overlap ring's on each rank (1e-6 of each
    leaf's max, the same loss to 1e-6); the control must fail the grads rule
    (on rank 0's part). The overlap step's microbatch is checked call by call
    first (``ep_checked_microbatch``, the fp32 bodies); the steps' launches
    must be ``ep_want``'s on the fp32 bodies; the control's are not counted."""
    from repro_torch.core.sharding import grid_place
    cfg, plan, model, batches = ep_setup(EP_FP32_LAYERS, "float32", EP_FP32_SEQ, no_drop=True)
    one = truth = None
    if grid.rank == 0:
        one, truth = ep_one_device(cfg, plan, batches)
    grid.barrier_error(False)
    out, kept = {}, {}
    for name, impl, control in (("overlap", "overlap", False), ("blocking", "blocking", False),
                                ("control", "overlap", True)):
        p = dataclasses.replace(plan, ep_impl=impl)
        checked = {}
        prepare = (ep_checked_microbatch(cfg, p, grid, batches[0], checked)
                   if name == "overlap" else None)
        rec = {"layers": cfg.n_layers, "ms": [], "tick_ms": [], "a2a_ms": [],
               "all_reduce_ms": []}
        watch = ZeroWatch(steps=1, shadow=not control)
        with ep_bf16_rounding() if control else contextlib.nullcontext():
            _, _, run = zero1_run(model, p, batches, grid, watch=watch, prepare=prepare,
                                  around=None if control else
                                  ep_step_counter(cfg, impl, grid, rec, fp32=True),
                                  keep_params=False)
        rec.update(loss=run["loss"], grad_norm=run["grad_norm"], **checked)
        if control and grid.rank != 0:
            watch.grads = None                  # rank 0 alone holds the control to the rule
        kept[name] = (run, watch)
        out[name] = rec
        free()
    run, watch = kept["overlap"]
    grads = on_card(watch.grads)
    blocking = on_card(kept["blocking"][1].grads)
    out["blocking"]["against_overlap"] = {
        "loss_rel": abs(kept["blocking"][0]["loss"][0] - run["loss"][0]) / abs(run["loss"][0]),
        "grads_rel": max(rel_err(blocking[n], g) for n, g in grads.items())}
    del blocking
    experts = sorted(n for n in watch.grads if "experts" in n)
    shared = {n: a for n, a in watch.grads.items() if n not in experts}
    sums = rank_checksums(shared, grid)
    got = grid_gather({n: watch.grads[n] for n in experts}, grid)
    free()
    if grid.rank == 0:
        bad = [] if len(set(sums)) == 1 else [f"the ranks' shared grads differ: {sums}"]
        if out["blocking"]["against_overlap"]["loss_rel"] > DP_REL or \
                out["blocking"]["against_overlap"]["grads_rel"] > DP_REL:
            bad.append(f"the blocking step against the overlap ring: "
                       f"{out['blocking']['against_overlap']}")
        shards = [grads] + [{**grads, **on_card(g)} for g in got[1:]]
        places = [grid_place(grid)[0] | {"model": r} for r in range(EP_RANKS)]
        part = ep_part(plan, places, grid_place(grid)[1])
        one_grads, truth = on_card(one["grads"]), on_card(truth)
        agree = grid_agreement(run, {**one, "grads": one_grads}, shards, part)
        rule_bad, explained = grid_failures(agree, watch.shadow_err, shards, one_grads, truth,
                                            part)
        control = on_card(kept["control"][1].grads)
        control_bad, _ = grid_grad_failures([control], one_grads, truth, part)
        if not control_bad:
            bad.append("the control (each chunk's expert output rounded to bf16) passes the "
                       "grads rule")
        out["overlap"].update(agree=agree, failures=bad + rule_bad, explained=explained,
                              one_device_loss=one["loss"], one_device_grad_norm=one["grad_norm"],
                              dp_tolerance_met=not rule_bad and not explained)
        out["control"].update(control_failures=len(control_bad), control_first=control_bad[:3])
        log(f"ep fp32 {cfg.arch_id} ({cfg.n_layers} layers, 1 x {EP_FP32_SEQ}): loss "
            f"{run['loss']} / {one['loss']}, {agree}; leaves past 1e-6 that the fp64 rule admits "
            f"(error, EP's distance from fp64, one device's) {explained}; blocking against the "
            f"overlap ring {out['blocking']['against_overlap']}; the control fails the rule on "
            f"{len(control_bad)} leaves, first {control_bad[:3]}; failures "
            f"{out['overlap']['failures']}")
        del shards, one_grads, truth, control
    del grads, got, kept, model, one
    free()
    grid.barrier_error(False)
    return out


def ep_rank(rank, init_method, out_dir):
    """One of the EP_RANKS processes of the EP phase, on cuda:0 over gloo:
    the overlap ring and the blocking exchange at full width (``ep_path``),
    then the fp32 checks (``ep_fp32``). Results go to
    ``out_dir/ep_rank{rank}.json``."""
    from repro_torch.core import resolve_device
    from repro_torch.launch import init_grid_mesh
    resolve_device()
    grid = init_grid_mesh(1, EP_RANKS, "cuda:0", backend="gloo", init_method=init_method,
                          rank=rank)
    log(f"ep rank {rank}: {grid}")
    out = {"rank": rank, "mesh": repr(grid)}
    for impl in ("overlap", "blocking"):
        t0 = time.perf_counter()
        out[impl] = ep_path(impl, grid, out_dir)
        out[impl]["seconds"] = time.perf_counter() - t0
        free()
    t0 = time.perf_counter()
    out["fp32"] = ep_fp32(grid)
    out["fp32"]["seconds"] = time.perf_counter() - t0
    grid.close()
    (Path(out_dir) / f"ep_rank{rank}.json").write_text(json.dumps(out))


def ep_times(keep_dir):
    """The kernels at the EP path's shapes: B4 (gemm_times) on rank 0's kept
    inputs, a ring tick's chunk (32, C, 2048) and the blocking exchange's
    (32, 2 C, 2048) with their dx and dw; B1-B3 on the ep-only ring tiles
    (``ring_tile_times``)."""
    kept = {}
    for impl in ("overlap", "blocking"):
        kept.update(torch.load(Path(keep_dir) / f"ep_{impl}_gemm.pt"))
    out = {"gemm": gemm_times(kept)}
    del kept
    free()
    out.update(ring_tile_times(EP_CASES, torch.Generator(device="cuda").manual_seed(9)))
    return out


def ep_report(ranks):
    """Log the EP phase's results and hold them to their checks: each mode's
    losses finite and equal on both ranks, the fp32 steps by GRID_TOLERANCE
    and the control failing it; keep the launches by body for the kernels
    line."""
    r0 = ranks[0]
    bad = []
    for impl in ("overlap", "blocking"):
        for r in ranks:
            f = r[impl]
            log(f"ep {impl} rank {r['rank']} ({r['mesh']}): steps {f['ms']} ms, exchanges "
                f"{f['a2a_ms']} ms, ring-attention hops {f['tick_ms']} ms, all-reduces "
                f"{f['all_reduce_ms']} ms, link bytes a step by kind {f['link_bytes']} (two "
                f"ranks share one card and the exchanges go "
                f"through host memory: no measure of EP scaling or overlap); peak "
                f"{f['peak_bytes'] / 1e9:.2f} GB, {f['params_per_rank'] / 1e9:.3f} B params a "
                f"rank; launches {f['launches']} a step; bodies {f['bodies']}; on its own inputs "
                f"{({k: f[k] for k in f if k.startswith('real_')})}; {f['seconds']:.1f} s")
            if not all(np.isfinite(x) for x in f["loss"] + f["grad_norm"]):
                bad.append(f"{impl} rank {r['rank']}: a loss or grad norm is not finite")
            if (f["loss"], f["grad_norm"]) != (r0[impl]["loss"], r0[impl]["grad_norm"]):
                bad.append(f"{impl}: rank {r['rank']} reports {f['loss']} / {f['grad_norm']}")
        BODY_COUNTS[ep_window(impl)] = {k: sum(r[impl]["bodies"][k] for r in ranks)
                                        for k in r0[impl]["bodies"]}
    for impl in ("overlap", "blocking"):
        BODY_COUNTS[ep_window(impl, fp32=True)] = {
            k: sum(r["fp32"][impl]["bodies"][k] for r in ranks)
            for k in r0["fp32"][impl]["bodies"]}
    bad += [f"fp32: {b}" for b in r0["fp32"]["overlap"].get("failures", [])]
    if bad:
        raise AssertionError("EP phase: " + "; ".join(bad))


def ep_launches(ep, i):
    """One kernel's launches on the EP paths (``i``: its index in the
    launches tuple), summed over the ranks, by window (``ep_window``); only
    the windows where it launched."""
    out = {}
    for fp32 in (False, True):
        for impl in ("overlap", "blocking"):
            n = sum((r["fp32"] if fp32 else r)[impl]["launches"][i] for r in ep["ranks"])
            if n:
                out[ep_window(impl, fp32)] = n
    return out


def ep_summary(ep):
    """The EP phase's numbers for the kernels line (``deepseek-moe-16b_ep``)."""
    ranks = ep["ranks"]
    keys = ("ms", "a2a_ms", "tick_ms", "all_reduce_ms", "launches", "peak_bytes",
            "params_per_rank", "loss", "grad_norm", "seconds")
    return {
        "grid": {"data": 1, "model": EP_RANKS}, "plan": {"ep": EP_RANKS, "tp": 1, "cp": 1},
        "transport": "gloo, host copies (two ranks on one card); no measure of EP scaling",
        "layers": ranks[0]["overlap"]["layers"], "seq": ranks[0]["overlap"]["seq"],
        "modes": {impl: {"ranks": [{k: r[impl][k] for k in keys} for r in ranks],
                         "real_inputs": {k: ranks[0][impl][k] for k in ranks[0][impl]
                                         if k.startswith("real_")}}
                  for impl in ("overlap", "blocking")},
        "fp32": {name: {k: v for k, v in rec.items() if k != "bodies"}
                 for name, rec in ranks[0]["fp32"].items() if name != "seconds"},
        "tolerance": GRID_TOLERANCE,
        "phase_s": {"ranks": ep["ranks_s"], "kernel_times": ep["times_s"],
                    "fp32_checks": ranks[0]["fp32"]["seconds"]},
    }


# ---------------------------------------------------------------------------
# pipeline parallelism


def pp_train_step(loss_fn, plan, grid, hyper, watch=None):
    """A train step composed around a pipelined loss (``make_train_step``
    refuses ``plan.pp`` > 1, as the reference's callers compose theirs):
    backward (the pipeline completes the grads), the global-norm clip over
    the stages (``pipeline_splits``) and the ZeRO-1 AdamW update on this
    rank's slices of its grads over its data group. Returns step(state,
    batch) -> (state, {"loss", "grad_norm", "lr", "moe_aux"}); with a
    ``watch`` dict, a copy of the first step's clipped grads (this rank's, by
    name) lands in ``watch["grads"]``."""
    from repro_torch.core.sharding import opt_state_specs
    from repro_torch.core.tree import from_names, leaves, named_leaves
    from repro_torch.optim import adamw_update_sharded, clip_by_global_norm, cosine_schedule
    from repro_torch.train import TrainState
    from repro_torch.train.pipeline import pipeline_splits
    dmesh = grid.data

    def step(state, batch):
        params, opt = state
        for p in leaves(params):
            p.grad = None
        total, parts = loss_fn(params, batch)
        total.backward()
        specs = opt_state_specs(params, dmesh, plan)
        grads = {}
        with torch.no_grad():
            for name, leaf in named_leaves(params):
                g = (torch.stack([p.grad for p in leaf]) if isinstance(leaf, list)
                     else leaf.grad)
                sp = specs[name]
                if sp.dim is not None:
                    k = sp.shape[sp.dim] // dmesh.size
                    g = g.narrow(sp.dim, dmesh.rank * k, k).contiguous()
                grads[name] = g
        for p in leaves(params):
            p.grad = None
        # the grads are the same on every data rank: each slice counts once
        grads, gnorm = clip_by_global_norm(from_names(grads), hyper.grad_clip, mesh=dmesh,
                                           specs=specs,
                                           splits=pipeline_splits(params, plan, grid))
        if watch is not None and "grads" not in watch:
            watch["grads"] = {n: g.detach().float().clone() for n, g in named_leaves(grads)}
        lr = cosine_schedule(opt.step, hyper.peak_lr, hyper.warmup_steps, hyper.total_steps)
        params, opt = adamw_update_sharded(grads, opt, params, lr, mesh=dmesh, specs=specs,
                                           weight_decay=hyper.weight_decay)
        return TrainState(params, opt), {"loss": parts["xent"].detach() + parts["moe_aux"].detach(),
                                         "grad_norm": gnorm, "lr": lr,
                                         "moe_aux": parts["moe_aux"].detach()}
    return step


# PP_RANKS spawned ranks on the one card over gloo, a (pod 2) grid: qwen1.5-4b at
# full width on PP_LAYERS of its 40 layers (PP_LAYERS / 2 a stage), PP_MICRO
# microbatches of 1 x TRAIN_SEQ, bf16 compute, remat "full". 1F1B a warm-up and
# PP_STEPS timed steps, GPipe one step; before them each rank's checked call at
# M = P (every B1-B3 call held to its plain version on the rank's inputs). Then
# fp32 steps at PP_FP32_LAYERS layers (one a stage), PP_MICRO microbatches of 1
# x PP_FP32_SEQ, both schedules held to one device's by GRID_TOLERANCE, and the
# control (``pod_bf16_rounding``) failing it. Depth is cut: two ranks' fp32
# state at the full 40 layers does not fit the card.
PP_RANKS = 2
PP_LAYERS = 4
PP_MICRO = 4
PP_STEPS = 1                      # 1F1B's timed steps, after one warm-up
PP_FP32_LAYERS = 2
PP_FP32_SEQ = 1024
PP_SCHEDS = ("1f1b", "gpipe")


def pp_setup(layers, dtype="bfloat16", seq=None, steps=1):
    """qwen1.5-4b's full-width config cut to ``layers`` layers, its pipeline
    plan (fp32 masters, ``dtype`` compute, remat "full", PP_MICRO
    microbatches, pp PP_RANKS, 1F1B), the model and ``steps`` batches of
    PP_MICRO x ``seq``."""
    from repro_torch.core import InputShape, ParallelPlan, get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=layers)
    plan = ParallelPlan(compute_dtype=dtype, param_dtype="float32", remat="full",
                        microbatches=PP_MICRO, pp=PP_RANKS)
    ds = SyntheticDataset(cfg, InputShape("pp", seq or TRAIN_SEQ, PP_MICRO, "train"))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(i).items()}
               for i in range(steps)]
    return cfg, plan, build_model(cfg, plan), batches


def pp_want(cfg, plan, stage):
    """The launches of one rank's pipelined step (remat full): B1, B2, B3, B4
    rows, B4 contract, B5, B6. Each of the stage's layers runs each
    microbatch once forward in the fill-drain; GPipe replays it in the
    backward (B1 twice); 1F1B runs it again in the recompute (a), except on
    the last stage, whose output goes nowhere, and in (b), with its replay
    (B1 four times, three on the last stage). B2 and B3 once each."""
    n = cfg.n_layers // PP_RANKS * plan.microbatches
    per = 2 if plan.pp_schedule == "gpipe" else (3 if stage == PP_RANKS - 1 else 4)
    return (per * n, n, n, 0, 0, 0, 0)


def pp_window(sched, fp32=False):
    """The kernels line's name for a PP schedule's step."""
    return f"pp_{sched}{'_fp32' if fp32 else ''}_train_step"


@contextlib.contextmanager
def pod_bf16_rounding(grid):
    """GRID_TOLERANCE's PP control: within the block every stage's outgoing
    activation is rounded to bf16 in the pod shift (forward and recompute),
    a fault the grads rule must catch."""
    ring = grid.pod
    real = ring.shift

    def rounded(t, step=1, kind="tick", wrap=True):
        if step > 0 and t.is_floating_point():
            t = t.to(torch.bfloat16).to(t.dtype)
        return real(t, step, kind, wrap)
    ring.shift = rounded
    try:
        yield
    finally:
        ring.shift = real


def pp_checked_call(cfg, plan, grid, params, batch, out):
    """The rank's part of one pipelined call at M = P (``plan``'s
    microbatches) and its backward, every B1 call (fill-drain, recompute,
    rebuilt tick, remat replay) held to its plain version on its own inputs
    (FlashFwdCapture, the Hopper body in bf16, the fp32 body in fp32) and
    every B2/B3 call too (FlashBwdCapture, dq also to fp64 in bf16), as many
    calls as ``pp_want`` predicts."""
    from repro_torch.core.tree import leaves
    from repro_torch.train import Hyper
    from repro_torch.train.pipeline import pipelined_loss_fn
    want = pp_want(cfg, plan, grid.pod.rank)
    bf16 = plan.compute_dtype == "bfloat16"
    loss_fn = pipelined_loss_fn(cfg, plan, grid, (), z_loss=Hyper().z_loss)
    what = (f"{cfg.arch_id} pp {plan.pp_schedule} {plan.compute_dtype} stage {grid.pod.rank} "
            f"call of {plan.microbatches} microbatches")
    with FlashBwdCapture(fp64=bf16) as bwd, FlashFwdCapture() as fwd:
        loss, _ = loss_fn(params, batch)
        loss.backward()
    out["real_fwd_ulps"] = fwd.summary(f"{what} (every pass)", want[0],
                                       body="sm90" if bf16 else "f32")
    out["real_bwd_ulps"] = bwd.summary(what, want[1])
    out["checked_loss"] = float(loss.detach())
    for p in leaves(params):
        p.grad = None


def pp_steps(cfg, plan, grid, state, batches, rec, fp32=False, watch=None, count=True):
    """``len(batches)`` pipelined steps of ``plan``'s schedule from ``state``:
    each step's wall time (synchronised), the pod ring's hops and all-reduces
    (the grads' pod sum among them; the ring waits for the device around
    each), the loss and grad norm, and the launches, which must be
    ``pp_want``'s on the Hopper bodies (the fp32 bodies with ``fp32``;
    unchecked without ``count``). Returns the state."""
    from repro_torch.train import Hyper
    from repro_torch.train.pipeline import pipelined_loss_fn
    hyper = Hyper()
    step = pp_train_step(pipelined_loss_fn(cfg, plan, grid, (), z_loss=hyper.z_loss), plan,
                         grid, hyper, watch=watch)
    want = pp_want(cfg, plan, grid.pod.rank)
    window = pp_window(plan.pp_schedule, fp32)
    for key in ("ms", "hop_ms", "pod_sum_ms", "loss", "grad_norm"):
        rec.setdefault(key, [])
    for i, batch in enumerate(batches):
        reset_counts()
        grid.pod.timed = True
        before, stats = dict(grid.pod.seconds), grid.pod.collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["hop_ms"].append((grid.pod.seconds["tick"] - before["tick"]) * 1e3)
        rec["pod_sum_ms"].append((grid.pod.seconds["all_reduce"] - before["all_reduce"]) * 1e3)
        rec.setdefault("link_bytes", []).append(link_bytes_since(grid.pod, stats))
        grid.pod.timed = False
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        launches = all_counts() + ssd_counts()
        rec["launches"] = launches
        if count:
            if launches != want:
                raise AssertionError(f"{cfg.arch_id} pp {plan.pp_schedule} stage "
                                     f"{grid.pod.rank} step {i} launched {launches}, "
                                     f"expected {want}")
            check_bodies(f"{cfg.arch_id} pp {plan.pp_schedule} rank {grid.rank} step {i}",
                         launches, window, fp32=fp32)
            rec["bodies"] = BODY_COUNTS[window]
    return state


def pp_path(grid):
    """The main path on this rank at full width: the checked call, then 1F1B
    (a warm-up and PP_STEPS) and GPipe (one step), each schedule's peak
    memory; the 1F1B steps run on from the warm-up's state, GPipe's from
    theirs."""
    from repro_torch.core.tree import named_leaves
    from repro_torch.train import init_train_state
    cfg, plan, model, batches = pp_setup(PP_LAYERS, steps=PP_STEPS + 2)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), grid, plan)
    rec = {"layers": cfg.n_layers, "seq": TRAIN_SEQ, "microbatches": PP_MICRO,
           "stage": grid.pod.rank, "stage_layers": len(state.params["layers"]),
           "params_per_rank": sum(x.numel() for _, leaf in named_leaves(state.params)
                                  for x in (leaf if isinstance(leaf, list) else [leaf]))}
    t0 = time.perf_counter()
    checked = dataclasses.replace(plan, microbatches=PP_RANKS)
    pp_checked_call(cfg, checked, grid, state.params,
                    {k: v[:PP_RANKS] for k, v in batches[0].items()}, rec)
    rec["checked_s"] = time.perf_counter() - t0
    free()
    for sched, run in (("1f1b", batches[:1 + PP_STEPS]), ("gpipe", batches[1 + PP_STEPS:])):
        out = rec[sched] = {}
        torch.cuda.reset_peak_memory_stats()
        state = pp_steps(cfg, dataclasses.replace(plan, pp_schedule=sched), grid, state, run, out)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        free()
        log(f"pp rank {grid.rank} (stage {grid.pod.rank}) {cfg.arch_id} {sched} "
            f"({cfg.n_layers} layers, {PP_MICRO} x 1 x {TRAIN_SEQ}): steps "
            f"{[round(x, 1) for x in out['ms']]} ms, pod hops "
            f"{[round(x, 1) for x in out['hop_ms']]} ms, pod sums "
            f"{[round(x, 1) for x in out['pod_sum_ms']]} ms, losses {out['loss']}, peak "
            f"{out['peak_bytes'] / 1e9:.2f} GB, launches {out['launches']}")
    del state, model
    free()
    grid.barrier_error(False)
    return rec


def pp_fp32(grid):
    """The fp32 steps at PP_FP32_LAYERS layers, PP_MICRO x 1 x PP_FP32_SEQ:
    1F1B, GPipe and the control, each one step from the same weights (seed
    0). One device's step (PP_MICRO microbatches) and its fp64 evaluation run
    on rank 0 first, while rank 1 waits. After each step rank 1 sends its
    stage's layer grads to rank 0 (the leaves every stage holds are the same
    bits on both after the pod sum, by their checksums); rank 0 then holds
    both schedules' to one device's by GRID_TOLERANCE (each rank's grads
    against its part of one device's), GPipe's to 1F1B's (1e-6 of each
    leaf's max, the loss to 1e-6), and the control must fail the grads rule.
    The 1F1B step's call is checked call by call first (``pp_checked_call``,
    fp32 bodies); the steps' launches must be ``pp_want``'s on the fp32
    bodies; the control's are not counted."""
    import torch.distributed as dist
    from repro_torch.core.sharding import layout_part
    from repro_torch.ft.integrity import tree_checksum
    from repro_torch.models import build_model
    from repro_torch.train import Hyper, init_train_state
    cfg, plan, model, batches = pp_setup(PP_FP32_LAYERS, "float32", PP_FP32_SEQ)
    one = truth = None
    if grid.rank == 0:
        one_plan = dataclasses.replace(plan, pp=1)
        one_model = build_model(cfg, one_plan)
        _, _, one = zero1_run(one_model, one_plan, batches, watch=ZeroWatch(steps=1),
                              keep_params=False)
        params = one_model.init(torch.Generator(device="cuda").manual_seed(0))
        truth = fp64_first_grads(cfg, params, batches[0], PP_MICRO, Hyper())
        del params, one_model
        free()
    grid.barrier_error(False)
    out, grads = {}, {}
    for name, sched, control in (("1f1b", "1f1b", False), ("gpipe", "gpipe", False),
                                 ("control", "1f1b", True)):
        p = dataclasses.replace(plan, pp_schedule=sched)
        state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), grid, p)
        rec, watch = {"layers": cfg.n_layers}, {}
        if name == "1f1b":
            pp_checked_call(cfg, p, grid, state.params, batches[0], rec)
        with pod_bf16_rounding(grid) if control else contextlib.nullcontext():
            pp_steps(cfg, p, grid, state, batches, rec, fp32=True, watch=watch,
                     count=not control)
        mine = watch["grads"]
        shared = {n: g for n, g in mine.items() if not n.startswith("layers/")}
        sums = [None] * grid.size
        dist.all_gather_object(sums, int(tree_checksum(shared)), group=grid.host_group)
        rec["rank_checksums"] = sums
        got = grid_gather({n: g.cpu().numpy() for n, g in mine.items()
                           if n.startswith("layers/")}, grid)
        if got is not None:
            grads[name] = [mine] + [{**shared, **on_card(g)} for g in got[1:]]
        out[name] = rec
        del state, watch, mine, shared
        free()
    grid.barrier_error(False)
    if grid.rank == 0:
        sizes = {"pod": PP_RANKS, "model": 1, "cp": 1}

        def part(n, a, r, _n):
            return layout_part(n, a, plan, {"pod": r, "model": 0, "cp": 0}, sizes)
        one, truth = {**one, "grads": on_card(one["grads"])}, on_card(truth)
        for name in ("1f1b", "gpipe"):
            agree = grid_agreement(out[name], one, grads[name], part)
            bad, explained = grid_failures(agree, [], grads[name], one["grads"], truth, part)
            if len(set(out[name]["rank_checksums"])) != 1:
                bad.append(f"the stages' shared grads differ: {out[name]['rank_checksums']}")
            out[name].update(agree=agree, failures=bad, explained=explained,
                             one_device_loss=one["loss"], one_device_grad_norm=one["grad_norm"])
        against = {"loss_rel": abs(out["gpipe"]["loss"][0] - out["1f1b"]["loss"][0])
                   / abs(out["1f1b"]["loss"][0]),
                   "grads_rel": max(rel_err(g[n], f[n]) for g, f in
                                    zip(grads["gpipe"], grads["1f1b"]) for n in f)}
        out["gpipe"]["against_1f1b"] = against
        if against["loss_rel"] > DP_REL or against["grads_rel"] > DP_REL:
            out["gpipe"]["failures"].append(f"GPipe against 1F1B: {against}")
        control_bad, _ = grid_grad_failures(grads["control"], one["grads"], truth, part)
        out["control"].update(control_failures=len(control_bad), control_first=control_bad[:3])
        if not control_bad:
            out["1f1b"]["failures"].append("the control (each stage's outgoing activation "
                                           "rounded to bf16) passes the grads rule")
        log(f"pp fp32 {cfg.arch_id} ({cfg.n_layers} layers, {PP_MICRO} x 1 x {PP_FP32_SEQ}): "
            f"1f1b loss {out['1f1b']['loss']} / {one['loss']}, {out['1f1b']['agree']}; gpipe "
            f"{out['gpipe']['agree']}, against 1f1b {against}; leaves past 1e-6 that the fp64 "
            f"rule admits (error, PP's distance from fp64, one device's) "
            f"{out['1f1b']['explained']} / {out['gpipe']['explained']}; the control fails the "
            f"rule on {len(control_bad)} leaves, first {control_bad[:3]}; failures "
            f"{out['1f1b']['failures'] + out['gpipe']['failures']}")
        del grads, one, truth
    del model
    free()
    grid.barrier_error(False)
    return out


def pp_rank(rank, init_method, out_dir):
    """One of the PP_RANKS processes of the PP phase, on cuda:0 over gloo:
    the main path (``pp_path``), then the fp32 checks (``pp_fp32``). Results
    go to ``out_dir/pp_rank{rank}.json``."""
    from repro_torch.core import resolve_device
    from repro_torch.launch import init_grid_mesh
    resolve_device()
    grid = init_grid_mesh(1, 1, "cuda:0", pod=PP_RANKS, backend="gloo", init_method=init_method,
                          rank=rank)
    log(f"pp rank {rank}: {grid}")
    out = {"rank": rank, "mesh": repr(grid)}
    t0 = time.perf_counter()
    out["path"] = pp_path(grid)
    out["path"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fp32"] = pp_fp32(grid)
    out["fp32"]["seconds"] = time.perf_counter() - t0
    grid.close()
    (Path(out_dir) / f"pp_rank{rank}.json").write_text(json.dumps(out))


def phase_cp_ep_pp():
    """The CP, EP and PP phases in one spawn of CP_RANKS (= EP_RANKS =
    PP_RANKS) processes on the one card over gloo: ``cp_rank``, ``ep_rank``
    and ``pp_rank`` in turn, each on a process group of its own, so that the
    three pay one process's start-up (Python, PyTorch, the CUDA context, the
    kernels' load). Each phase's results are checked as it was alone
    (``cp_report``, ``ep_report``, ``pp_report``), then the kernels timed at
    the CP and EP shapes (``cp_times``, ``ep_times``). Returns the three
    phases' results."""
    assert CP_RANKS == EP_RANKS == PP_RANKS
    parts = {"cp": cp_rank, "ep": ep_rank, "pp": pp_rank}
    with spawned_ranks(parts, CP_RANKS, timeout=1500) as (tmp, res, part_s, ranks_s):
        out = {}
        for tag, report, times in (("cp", cp_report, cp_times), ("ep", ep_report, ep_times),
                                   ("pp", pp_report, None)):
            report(res[tag])
            t0 = time.perf_counter()
            out[tag] = {"ranks": res[tag], "ranks_s": part_s[tag]}
            if times is not None:
                out[tag]["times"] = times(tmp)
                out[tag]["times_s"] = time.perf_counter() - t0
                free()
    log(f"phase CP, EP, PP: ranks {ranks_s:.1f} s in one spawn (rank parts: " + ", ".join(
        f"{t} {out[t]['ranks_s']:.1f} s" for t in ("cp", "ep", "pp")) + "), kernel times "
        f"CP {out['cp']['times_s']:.1f} s, EP {out['ep']['times_s']:.1f} s")
    return out["cp"], out["ep"], out["pp"]


def pp_report(ranks):
    """Log the PP phase's results and hold them to their checks: each
    schedule's losses finite and equal on both ranks, the fp32 steps by
    GRID_TOLERANCE and the control failing it; keep the launches by body for
    the kernels line."""
    r0 = ranks[0]
    bad = []
    for sched in PP_SCHEDS:
        for r in ranks:
            f = r["path"][sched]
            log(f"pp {sched} rank {r['rank']} ({r['mesh']}, stage {r['path']['stage']}, "
                f"{r['path']['stage_layers']} layers): steps {f['ms']} ms, pod hops "
                f"{f['hop_ms']} ms, pod sums {f['pod_sum_ms']} ms, link bytes a step by kind "
                f"{f['link_bytes']} (two ranks share one card "
                f"and the hops go through host memory: no measure of PP scaling or stage "
                f"overlap); peak {f['peak_bytes'] / 1e9:.2f} GB, "
                f"{r['path']['params_per_rank'] / 1e9:.3f} B params a rank; launches "
                f"{f['launches']} a step; bodies {f['bodies']}")
            if not all(np.isfinite(x) for x in f["loss"] + f["grad_norm"]):
                bad.append(f"{sched} rank {r['rank']}: a loss or grad norm is not finite")
            if (f["loss"], f["grad_norm"]) != (r0["path"][sched]["loss"],
                                               r0["path"][sched]["grad_norm"]):
                bad.append(f"{sched}: rank {r['rank']} reports {f['loss']} / {f['grad_norm']}")
        BODY_COUNTS[pp_window(sched)] = {k: sum(r["path"][sched]["bodies"][k] for r in ranks)
                                         for k in r0["path"][sched]["bodies"]}
        BODY_COUNTS[pp_window(sched, fp32=True)] = {
            k: sum(r["fp32"][sched]["bodies"][k] for r in ranks)
            for k in r0["fp32"][sched]["bodies"]}
    for r in ranks:
        log(f"pp rank {r['rank']}: checked call {r['path']['checked_s']:.1f} s, B1 "
            f"{r['path']['real_fwd_ulps']} ulps, B2/B3 {r['path']['real_bwd_ulps']}")
    bad += [f"fp32: {b}" for s in PP_SCHEDS for b in r0["fp32"][s].get("failures", [])]
    if bad:
        raise AssertionError("PP phase: " + "; ".join(bad))


def pp_launches(pp, i):
    """One kernel's launches on the PP paths (``i``: its index in the
    launches tuple), summed over the ranks, by window (``pp_window``); only
    the windows where it launched."""
    out = {}
    for fp32 in (False, True):
        for sched in PP_SCHEDS:
            n = sum((r["fp32"] if fp32 else r["path"])[sched]["launches"][i]
                    for r in pp["ranks"])
            if n:
                out[pp_window(sched, fp32)] = n
    return out


def pp_summary(pp):
    """The PP phase's numbers for the kernels line (``qwen1.5-4b_pp``)."""
    ranks = pp["ranks"]
    keys = ("ms", "hop_ms", "pod_sum_ms", "launches", "peak_bytes", "loss", "grad_norm")
    return {
        "grid": {"pod": PP_RANKS}, "plan": {"pp": PP_RANKS, "microbatches": PP_MICRO,
                                            "remat": "full"},
        "transport": "gloo, host copies (two ranks on one card); no measure of PP scaling",
        "layers": PP_LAYERS, "seq": TRAIN_SEQ,
        "schedules": {s: {"ranks": [{"stage": r["path"]["stage"],
                                     **{k: r["path"][s][k] for k in keys}} for r in ranks]}
                      for s in PP_SCHEDS},
        "params_per_rank": [r["path"]["params_per_rank"] for r in ranks],
        "real_inputs": {r["rank"]: {k: r["path"][k] for k in ("real_fwd_ulps",
                                                              "real_bwd_ulps")}
                        for r in ranks},
        "fp32": {name: {k: v for k, v in rec.items() if k != "bodies"}
                 for name, rec in ranks[0]["fp32"].items() if name != "seconds"},
        "tolerance": GRID_TOLERANCE,
        "phase_s": {"ranks": pp["ranks_s"], "fp32_checks": ranks[0]["fp32"]["seconds"]},
    }


# ---------------------------------------------------------------------------
# serving on a (data, model) grid (A13.6): the sequence-sharded KV cache
#
# Two rank processes (spawn) on the one card over gloo, a (1, 2) grid, as the
# TP phase's: gemma2-9b (arXiv:2408.00118) at full width and depth, random
# bf16 weights from a seed, every model rank holding the whole params. Batch 1
# (at batch 2 the two ranks' peaks summed to 77.3 GB, above the 74 GB set for
# the pair) and a 6,144-token prompt: each rank prefills its 3,072 queries with K/V
# all-gathered over the model ring (B1 at hd 256, gemma2's softcap and
# alternating 4,096-token windows, q_offset = rank x 3,072); max_seq 8,192,
# gemma2's context, so each rank holds positions [r 4,096, (r + 1) 4,096) of
# the cache and the prompt and every decode step span both blocks (the local
# layers' window reaches into rank 0's block). 32 greedy decode steps through
# the sharded decode attention, whose combine is one MAX and one SUM
# all-reduce over the ring a layer. Every collective goes through host
# memory: no serving scaling is measured.
GRID_ARCH = "gemma2-9b"
GRID_RANKS = 2
GRID_BATCH, GRID_PROMPT, GRID_MAX_SEQ, GRID_STEPS = 1, 6144, 8192, 32
GRID_CHECK_LAYERS = (0, 1, 40, 41)          # B1 held on these layers (local, global)
GRID_CHECK_STEPS = 2                        # decode steps held call by call, after the timed
GRID_FP32 = dict(layers=2, batch=1, prompt=1536, max_seq=2048, steps=16)
GRID_REL = 1e-5
GRID_SERVE_TOLERANCE = (
    "B1 on the grid prefill's own inputs (layers GRID_CHECK_LAYERS): TOLERANCE; the "
    "sharded decode attention on every layer's own inputs at GRID_CHECK_STEPS steps "
    "against the single-device decode_attention on the whole cache: o to 2 bf16 ulps "
    "of each head's row (row_ulps), "
    "the cache writes exact; an fp32 run (GRID_FP32) against one device on the same "
    "weights: prefill and decode logits to 1e-5 of each tensor's max, the greedy tokens "
    "equal; the control (each rank's partial o rounded to bf16 before the combine) must "
    "fail the logits rule")
# B1 at the grid prefill's shape on rank 1 (its queries at q_offset 3,072), a
# local and a global layer
GRID_CASES = {"local": (GRID_BATCH, 16, 8, GRID_PROMPT // 2, GRID_PROMPT, 256, True, 4096,
                        50.0, GRID_PROMPT // 2),
              "global": (GRID_BATCH, 16, 8, GRID_PROMPT // 2, GRID_PROMPT, 256, True, 0,
                         50.0, GRID_PROMPT // 2)}


class SampledFwdCapture(FlashFwdCapture):
    """FlashFwdCapture on the calls whose index (from 0, in call order) is in
    ``sample`` only; every call counts as through the wrapper."""

    def __init__(self, sample):
        self.sample, self.calls = set(sample), 0

    def __enter__(self):
        from repro_torch.kernels import flash_attention as tf
        real, self.errs = tf.flash_attention_lse, []
        self.real = real

        @functools.wraps(real)
        def sampled(q, k, v, **kw):
            i, self.calls = self.calls, self.calls + 1
            o, lse = real(q, k, v, **kw)
            if i in self.sample:
                po, plse = flash_plain(q, k, v, **kw)
                self.errs.append((*match_errors(o, lse, po, plse),
                                  dead_rows_ok(o, lse, plse)[1], o.dtype))
                del po, plse
            return o, lse
        self.wrapper = sampled
        tf.flash_attention_lse = sampled
        return self


def row_ulps(out, ref):
    """(max |out - ref|, the same in bf16 ulps of each head's row of ``ref``:
    its largest |value| over hd, floored at 2^-10). The decode attention
    rounds its softmax weights to bf16 against the running max, the local
    block's on a rank and the whole cache's on one device, so two exact
    evaluations differ by about one rounding of the weights: a share of the
    row's scale, not of an element near zero."""
    err = (out.float() - ref.float()).abs()
    big = ref.float().abs().amax(dim=-1, keepdim=True).clamp(min=2 ** -10)
    ulps = err / torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return err.max().item(), ulps.max().item()


class DecodeCapture:
    """Within the block, every sharded ``decode_attention`` call (a layer's,
    as the models make it through ``serve.attention``) is held to the
    single-device version on the whole cache: the rank's block before the
    call and the other ranks' (hops over the model ring, on every rank) make
    the whole cache, the plain call writes it at ``pos`` and attends; the
    sharded output must be within 2 bf16 ulps of each head's row
    (``row_ulps``) and the rank's block after the call equal to its part of
    the whole one."""

    def __enter__(self):
        from repro_torch.serve import attention as sa
        self.mod, self.real, self.errs = sa, sa.decode_attention, []
        real = self.real

        def checked(q, kc, vc, kn, vn, pos, *, window=0, softcap=0.0, mesh=None, **kw):
            pre = (kc.clone(), vc.clone())
            out, kc, vc = real(q, kc, vc, kn, vn, pos, window=window, softcap=softcap,
                               mesh=mesh, **kw)
            ring = mesh.model
            whole = []
            for blk in pre:                       # blocks in rank order, every rank hops
                parts = [blk]
                for h in range(1, ring.size):
                    parts.append(ring.shift(blk, h))
                order = [(ring.rank - h) % ring.size for h in range(ring.size)]
                whole.append(torch.cat([parts[order.index(r)] for r in range(ring.size)], 1))
            ref, rk, rv = real(q, whole[0], whole[1], kn, vn, pos, window=window,
                               softcap=softcap)
            t = kc.shape[1]
            lo = ring.rank * t
            exact = bool(torch.equal(kc, rk[:, lo:lo + t]) and torch.equal(vc, rv[:, lo:lo + t]))
            self.errs.append((*row_ulps(out, ref), exact))
            return out, kc, vc
        sa.decode_attention = checked
        return self

    def __exit__(self, *exc):
        self.mod.decode_attention = self.real

    def summary(self, what, calls):
        if len(self.errs) != calls:
            raise AssertionError(f"checked {len(self.errs)} decode attentions on the {what}, "
                                 f"expected {calls}")
        o_abs, o_ulps = (max(e[i] for e in self.errs) for i in range(2))
        exact = all(e[2] for e in self.errs)
        log(f"real inputs, {what}: the sharded decode attention held to one device's on "
            f"the whole cache on {calls} calls, max o err {o_abs:.3e} = {o_ulps:.2f} bf16 "
            f"ulps, cache writes exact {exact}")
        if not (o_ulps <= O_ULPS_BF16 and exact):
            raise AssertionError(f"the sharded decode attention disagrees with one device's "
                                 f"on the {what}'s own inputs")
        return o_ulps


def grid_serve_setup(grid, layers=None, dtype="bfloat16"):
    """gemma2-9b (``layers`` of its 42; all by default) on ``grid`` and on one
    device, in ``dtype`` for both compute and params, and its params from
    seed 0 (the same on every rank)."""
    from repro_torch.core import ParallelPlan, get_config
    from repro_torch.models import build_model
    cfg = get_config(GRID_ARCH)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    plan = ParallelPlan(compute_dtype=dtype, param_dtype=dtype)
    model = build_model(cfg, plan, mesh=grid)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    return cfg, model, params


def grid_bodies():
    from repro_torch.kernels.flash_attention import flash_attention_lse as f
    return {"flash_fwd_sm90": f.sm90_launches, "flash_fwd_bf16": f.mma_launches,
            "flash_fwd_f32": f.f32_launches}


def grid_serving(grid, out):
    """The bf16 run at full width and depth (module notes above): a checked
    prefill (B1 held on GRID_CHECK_LAYERS) as the warm-up, the timed prefill
    and GRID_STEPS greedy decode steps, then GRID_CHECK_STEPS steps with every
    decode attention held to one device's. Readings into ``out``."""
    from repro_torch.kernels.flash_attention import flash_attention_lse
    cfg, model, params = grid_serve_setup(grid)
    n_params = sum(t.numel() for _, t in _named_tensors(params))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (GRID_BATCH, GRID_PROMPT), generator=gen,
                           device="cuda")
    ring = grid.model
    what = f"{GRID_ARCH} grid rank {grid.rank}"
    torch.cuda.synchronize()
    with SampledFwdCapture(GRID_CHECK_LAYERS) as fwd:
        logits, cache = model.prefill(params, {"tokens": tokens}, GRID_MAX_SEQ)
        del logits, cache
    out["real_fwd_ulps"] = fwd.summary(f"{what} prefill (layers {GRID_CHECK_LAYERS})",
                                       len(GRID_CHECK_LAYERS), body="mma",
                                       launches=cfg.n_layers)
    free()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ring.timed = True
    before, stats = dict(ring.seconds), ring.collective_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, GRID_MAX_SEQ)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_gather_ms"] = (ring.seconds["tick"] - before["tick"]) * 1e3
    out["prefill_link_bytes"] = link_bytes_since(ring, stats)
    out["prefill_b1"] = flash_attention_lse.launches
    out["bodies"] = grid_bodies()
    if out["prefill_b1"] != cfg.n_layers or out["bodies"]["flash_fwd_bf16"] != cfg.n_layers:
        raise AssertionError(f"{what} prefill: B1 {out['prefill_b1']} launches, by body "
                             f"{out['bodies']}, expected {cfg.n_layers} on flash_fwd_bf16")
    out["chunk"] = list(model.seq_chunk(GRID_PROMPT))
    out["logits_shape"] = list(logits.shape)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: prefill logits are not finite")
    tok = model.last_logits(logits, GRID_PROMPT).argmax(-1)
    del logits
    reset_counts()
    before, stats = dict(ring.seconds), ring.collective_stats()
    finite, toks = torch.ones((), dtype=torch.bool, device="cuda"), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(GRID_STEPS):
        lg, cache = model.decode_step(params, cache, tok, GRID_PROMPT + i)
        finite &= torch.isfinite(lg).all()
        tok = lg.argmax(-1)
        toks.append(tok)
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / GRID_STEPS
    out["combine_ms"] = (ring.seconds["all_reduce"] - before["all_reduce"]) * 1e3 / GRID_STEPS
    out["decode_link_bytes"] = {k: v / GRID_STEPS
                                for k, v in link_bytes_since(ring, stats).items()}
    out["decode_b1"] = flash_attention_lse.launches
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["tokens"] = torch.stack(toks, 1).tolist()
    ring.timed = False
    if not finite:
        raise AssertionError(f"{what}: decode logits are not finite")
    with DecodeCapture() as dec:
        for i in range(GRID_CHECK_STEPS):
            lg, cache = model.decode_step(params, cache, tok, GRID_PROMPT + GRID_STEPS + i)
            tok = lg.argmax(-1)
    out["decode_attn_ulps"] = dec.summary(f"{what} decode", GRID_CHECK_STEPS * cfg.n_layers)
    out["params"] = n_params
    out["cache_bytes_rank"] = sum(t.numel() * t.element_size() for t in cache.values())
    log(f"{what}: prefill {GRID_BATCH}x{GRID_PROMPT} (this rank's chunk {out['chunk']}) "
        f"{out['prefill_ms']:.1f} ms (K/V gathers {out['prefill_gather_ms']:.1f}), decode "
        f"{out['decode_ms']:.2f} ms/step (combine all-reduces {out['combine_ms']:.2f}), peak "
        f"{out['peak_bytes'] / 1e9:.2f} GB, cache part {out['cache_bytes_rank'] / 1e9:.2f} GB, "
        f"{n_params / 1e9:.2f} B params; tokens row 0 {out['tokens'][0][:8]}")
    del cache, params, model


def _named_tensors(params):
    from repro_torch.core.tree import leaves
    return [(None, t) for t in leaves(params)]


def grid_rounded_partials():
    """The fp32 rule's control: each rank's partial o rounded to bf16 before
    the combine (``serve.attention.combine_ring``)."""
    from repro_torch.serve import attention as sa
    real = sa.combine_ring

    @contextlib.contextmanager
    def ctx():
        sa.combine_ring = lambda ring, o, m, l: real(ring, o.to(torch.bfloat16).float(), m, l)
        try:
            yield
        finally:
            sa.combine_ring = real
    return ctx()


def grid_fp32_run(model, params, tokens, c):
    """Prefill and ``c["steps"]`` greedy decode steps: (prefill logits, the
    decode logits, the tokens)."""
    logits, cache = model.prefill(params, {"tokens": tokens}, c["max_seq"])
    tok = (model.last_logits(logits, c["prompt"]) if hasattr(model, "last_logits")
           and model.mesh is not None else logits[:, -1]).argmax(-1)
    steps, toks = [], []
    for i in range(c["steps"]):
        lg, cache = model.decode_step(params, cache, tok, c["prompt"] + i)
        tok = lg.argmax(-1)
        steps.append(lg)
        toks.append(tok)
    return logits, steps, torch.stack(toks, 1)


def grid_fp32(grid):
    """The fp32 check (GRID_FP32): the grid's prefill and decode logits
    against one device's run on the same weights, the greedy tokens equal;
    then the control, which must fail the logits rule."""
    from repro_torch.core import ParallelPlan
    from repro_torch.models import build_model
    c = GRID_FP32
    cfg, model, params = grid_serve_setup(grid, c["layers"], "float32")
    one = build_model(cfg, ParallelPlan(compute_dtype="float32", param_dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (c["batch"], c["prompt"]), generator=gen,
                           device="cuda")
    reset_counts()
    got = grid_fp32_run(model, params, tokens, c)
    bodies = grid_bodies()
    want = grid_fp32_run(one, params, tokens, c)
    lo, hi = model.seq_chunk(c["prompt"])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def agree(run):
        return {"prefill_rel": rel(run[0], want[0][:, lo:hi]),
                "decode_rel": max(rel(a, b) for a, b in zip(run[1], want[1])),
                "tokens_equal": bool(torch.equal(run[2], want[2]))}
    out = {"agree": agree(got), "bodies": bodies}
    with grid_rounded_partials():
        out["control"] = agree(grid_fp32_run(model, params, tokens, c))
    out["ok"] = (out["agree"]["prefill_rel"] <= GRID_REL and out["agree"]["decode_rel"]
                 <= GRID_REL and out["agree"]["tokens_equal"])
    out["control_fails"] = not (out["control"]["prefill_rel"] <= GRID_REL
                                and out["control"]["decode_rel"] <= GRID_REL)
    log(f"{GRID_ARCH} grid rank {grid.rank} fp32 ({c}): {out['agree']}; control (partial o "
        f"in bf16) {out['control']}; B1 by body {bodies}")
    return out


def grid_rank(rank, init_method, out_dir):
    """One of the GRID_RANKS processes of the grid serving phase, on cuda:0
    over gloo: the bf16 run (``grid_serving``), then the fp32 check
    (``grid_fp32``). Results go to ``out_dir/grid_rank{rank}.json``."""
    from repro_torch.core import resolve_device
    from repro_torch.launch import init_grid_mesh
    resolve_device()
    grid = init_grid_mesh(1, GRID_RANKS, "cuda:0", backend="gloo", init_method=init_method,
                          rank=rank)
    log(f"grid rank {rank}: {grid}")
    out = {"rank": rank, "mesh": repr(grid)}
    t0 = time.perf_counter()
    grid_serving(grid, out)
    out["serve_s"] = time.perf_counter() - t0
    free()
    t0 = time.perf_counter()
    out["fp32"] = grid_fp32(grid)
    out["fp32_s"] = time.perf_counter() - t0
    grid.close()
    (Path(out_dir) / f"grid_rank{rank}.json").write_text(json.dumps(out))


def grid_times():
    """B1 at the grid prefill's shapes (GRID_CASES) through the body the path
    runs at hd 256 (the first version's mma.sync body), beside its bound, the
    plain version and SDPA under the same causal and window mask (SDPA has no
    softcap)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    return {name: fwd_times_at(case, gen, bodies=("mma",), masked_library=True)
            for name, case in GRID_CASES.items()}


def phase_grid_serving():
    """The grid serving phase: GRID_RANKS spawned ranks on the one card over
    gloo (``grid_rank``), their results checked here, then B1 timed at the
    grid prefill's shapes."""
    with spawned_ranks({"grid": grid_rank}, GRID_RANKS, timeout=480) as (_, res, _, ranks_s):
        ranks = res["grid"]
        grid_report(ranks)
    t0 = time.perf_counter()
    times = grid_times()
    times_s = time.perf_counter() - t0
    log(f"phase grid serving: ranks {ranks_s:.1f} s, kernel times {times_s:.1f} s")
    return {"ranks": ranks, "times": times, "ranks_s": ranks_s, "times_s": times_s}


def grid_report(ranks):
    """Hold the ranks' results to GRID_SERVE_TOLERANCE; keep the prefill's
    launches by body for the kernels line."""
    bad = []
    r0 = ranks[0]
    for r in ranks:
        if not r["fp32"]["ok"]:
            bad.append(f"rank {r['rank']}: fp32 {r['fp32']['agree']}")
        if not r["fp32"]["control_fails"]:
            bad.append(f"rank {r['rank']}: the control passed {r['fp32']['control']}")
        if r["tokens"] != r0["tokens"]:
            bad.append(f"rank {r['rank']}: greedy tokens differ from rank 0's")
        if r["decode_b1"] != 0:
            bad.append(f"rank {r['rank']}: decode launched B1 {r['decode_b1']} times")
        log(f"grid rank {r['rank']}: prefill {r['prefill_ms']:.1f} ms, K/V gathers "
            f"{r['prefill_gather_ms']:.1f} ms, link bytes by kind {r['prefill_link_bytes']}; "
            f"decode {r['decode_ms']:.2f} ms a step, combine {r['combine_ms']:.2f} ms, link "
            f"bytes a step by kind {r['decode_link_bytes']}")
    if bad:
        raise AssertionError("grid serving phase: " + "; ".join(bad))
    BODY_COUNTS["gemma2_grid_prefill"] = {
        k: sum(r["bodies"].get(k, 0) for r in ranks) for k in body_counts()}


def grid_summary(grid):
    """The grid serving phase's numbers for the kernels line (``gemma2-9b_grid``)."""
    keys = ("chunk", "prefill_ms", "prefill_gather_ms", "prefill_link_bytes", "decode_ms",
            "combine_ms", "decode_link_bytes", "peak_bytes", "cache_bytes_rank", "real_fwd_ulps",
            "decode_attn_ulps", "serve_s", "fp32_s")
    return {
        "grid": {"data": 1, "model": GRID_RANKS},
        "plan": {"seq_shard_decode": True, "seq_shard_attn": True},
        "transport": "gloo, host copies (two ranks on one card); no measure of serving scaling",
        "batch": GRID_BATCH, "prompt": GRID_PROMPT, "max_seq": GRID_MAX_SEQ,
        "decode_steps": GRID_STEPS, "params": grid["ranks"][0]["params"],
        "ranks": [{k: r[k] for k in keys} for r in grid["ranks"]],
        "fp32": {r["rank"]: {k: r["fp32"][k] for k in ("agree", "control")}
                 for r in grid["ranks"]},
        "tolerance": GRID_SERVE_TOLERANCE,
        "phase_s": {"ranks": grid["ranks_s"], "kernel_times": grid["times_s"]},
    }


# ---------------------------------------------------------------------------
# the examples (phase 21)

# The five examples of src/repro_torch/examples/ at their recipes (each module's
# docstring): preempt_resume in this process, then train_moe_ep,
# pipeline_multipod, serve_longcontext and straggler_rebalance (on the first
# STRAGGLER_RANKS) one after another in one set of EXAMPLE_RANKS rank processes on
# the card over gloo: one start-up of Python, PyTorch, the CUDA context and the
# kernels' load for the four. Every example runs fp32 (head dims 64, 32 and 16: B1-B3's and
# B4's fp32 bodies). The kernels are held to the plain versions (attn_impl and
# moe_gemm_impl "plain", which must launch no kernel) on the card, at EXAMPLE_REL,
# on the same inputs: serve_longcontext's first logits (gemma2's prefill's last
# position, and both models' first decode step), and the route checks
# (``ranks.route_check``: a loss and its backward through both routes on the same
# params and batch; the loss and every leaf's grad compared) of each training
# example's first step, train_moe_ep's fold and pipeline_multipod's TP, CP and EP
# losses (each exchange), which the recipes run forward only.
EXAMPLE_RANKS = 8
STRAGGLER_RANKS = 4
EXAMPLE_REL = 1e-4
EXAMPLE_TOLERANCE = ("the kernels against the plain versions on the card (which launch no "
                     "kernel), on the same inputs: each route check's loss (a training "
                     "example's first step, the fold, the pipeline's TP, CP and EP) to 1e-4 "
                     "relative and every leaf's grad to 1e-4 of the leaf's max |value|; "
                     "serving's prefill last-position and first decode step logits to 1e-4 "
                     "of the tensor's max |value|")
EXAMPLE_TIMEOUT = 600
EXAMPLE_SLEEP_S = 0.04            # the reference's delay a layer on the slowed stage
EXAMPLE_KERNELS = {"preempt_resume": ("B1", "B2", "B3"), "train_moe_ep": ("B1", "B2", "B3", "B4"),
                   "pipeline_multipod": ("B1", "B2", "B3", "B4"),
                   "serve_longcontext": ("B1",), "straggler_rebalance": ("B1", "B2", "B3")}


def example_launches(ranks):
    """Launches summed over an example's ranks (their ``launches`` readings)."""
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def logits_failures(name, firsts, out):
    """Serving's first logits through the kernels against the plain route's
    on each rank (the prefill's last position, the first decode step), of
    each tensor's max |value|: ``out["logits_max_rel"]`` / ``_abs`` the
    largest; a failure line for each rank past EXAMPLE_REL or whose plain
    route launched."""
    bad = []
    for r, f in enumerate(firsts):
        pairs = list(zip(f["kernel"], f["plain"]))
        rel = max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)) for x, y in pairs)
        out["logits_max_rel"] = max(rel, out.get("logits_max_rel", 0.0))
        out["logits_max_abs"] = max([float(np.abs(x - y).max()) for x, y in pairs]
                                    + [out.get("logits_max_abs", 0.0)])
        if not rel <= EXAMPLE_REL:
            bad.append(f"{name} rank {r}: the first logits through the kernels {rel:.3e} off "
                       f"the plain route's")
        if f["plain_launches"]:
            bad.append(f"{name} rank {r}: the plain route launched {f['plain_launches']} kernels")
    return bad


def example_check_failures(name, checks_by_rank, out):
    """Each rank's route checks (``ranks.route_check``) held at EXAMPLE_REL:
    the loss, and the worst leaf's grad of its max |value|; the kernel route
    must have launched, the plain route not. ``out["checks"]``: each check's
    worst over the ranks."""
    bad, worst = [], out.setdefault("checks", {})
    for r, checks in enumerate(checks_by_rank):
        for part, c in checks.items():
            k, p = c["loss"]
            loss_rel = abs(k - p) / max(abs(p), 1e-30)
            w = worst.setdefault(part, {"loss_rel": 0.0, "grad_rel": 0.0})
            w["loss_rel"] = max(w["loss_rel"], loss_rel)
            if c["grad_rel"] >= w["grad_rel"]:
                w.update(grad_rel=c["grad_rel"], grad_abs=c["grad_abs"], leaf=c["grad_leaf"],
                         rank=r)
            if not (loss_rel <= EXAMPLE_REL and c["grad_rel"] <= EXAMPLE_REL):
                bad.append(f"{name} rank {r} {part}: through the kernels the loss "
                           f"{loss_rel:.3e} and the grad of {c['grad_leaf']} {c['grad_rel']:.3e} "
                           f"off the plain route's")
            if c["grad_leaf"] is None:
                bad.append(f"{name} rank {r} {part}: no grad to compare")
            if not count_launches(c["launched"]) or c["plain_launches"]:
                bad.append(f"{name} rank {r} {part}: the check launched "
                           f"{count_launches(c['launched'])} kernels, {c['plain_launches']} of "
                           f"them on the plain route")
    return bad


def checks_text(out):
    """The worst of each route check, for the log."""
    return "route checks (kernels against plain, worst rank): " + ", ".join(
        f"{part} loss {w['loss_rel']:.3e}, grad {w['grad_rel']:.3e} of {w['leaf']}'s max "
        f"({w['grad_abs']:.3e} absolute)" for part, w in out["checks"].items())


def count_launches(launched):
    """B1-B4's launches in a ``ranks.launches_since`` reading."""
    return sum(launched[k] for k in ("B1", "B2", "B3", "B4_rows", "B4_contract"))


def phase_examples():
    """Phase 21: the five examples on the card (above). Returns each one's
    seconds, readings, launches by kernel and by body and peak memory a rank;
    fails on a broken recipe assert, a kernel route off the plain route's,
    a kernel of the path not launched or a launch off the fp32 bodies."""
    from repro_torch.examples import (pipeline_multipod, preempt_resume, ranks,
                                      serve_longcontext, straggler_rebalance, train_moe_ep)
    out, bad = {}, []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases still hold
    t0 = time.perf_counter()
    pr = preempt_resume.run(log=False)
    counts = all_counts()
    pr_peak = torch.cuda.max_memory_allocated() - held
    pr_s = time.perf_counter() - t0
    check_bodies("preempt_resume", counts, window="example_preempt_resume", fp32=True)
    pr_check = preempt_resume.first_check()
    if (pr["preempt_step"], pr["marker_tier"]) != (24, "disk"):
        bad.append(f"preempt_resume: preempted at {pr['preempt_step']} on "
                   f"{pr['marker_tier']!r}, the reference's 24 on 'disk'")
    launches = dict(zip(("B1", "B2", "B3", "B4_rows", "B4_contract"), counts))
    out["preempt_resume"] = {
        "seconds": pr_s, "ranks": 1, "launches": launches,
        "peak_bytes": [pr_peak], "held_bytes": held,
        "readings": {k: pr[k] for k in ("preempt_step", "marker_tier", "marker_consumed",
                                        "bit_identical", "steps_done")}}
    bad += example_check_failures("preempt_resume", [{"first": pr_check}],
                                  out["preempt_resume"])
    log(f"example preempt_resume: {pr_s:.1f} s, preempted at step {pr['preempt_step']} "
        f"({pr['marker_tier']} snapshot), marker consumed {pr['marker_consumed']}, resumed "
        f"params bit-identical {pr['bit_identical']}, loss {pr['losses'][0]:.4f} -> "
        f"{pr['losses'][-1]:.4f}; peak {pr_peak / 1e6:.1f} MB above the {held / 1e6:.1f} MB "
        f"the script held; "
        f"launches {launches}; {checks_text(out['preempt_resume'])}")
    free()

    kw = {"check_plain": True}
    t0 = time.perf_counter()
    moe, pipe, serve, strag = ranks.spawn(
        [(train_moe_ep.rank_job, kw), (pipeline_multipod.rank_job, kw),
         (serve_longcontext.rank_job, kw),
         (straggler_rebalance.rank_job, {**kw, "sleep_s": EXAMPLE_SLEEP_S}, STRAGGLER_RANKS)],
        EXAMPLE_RANKS, "cuda", EXAMPLE_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    r0 = moe[0]
    out["train_moe_ep"] = {
        "readings": {"placement": r0["placement"], "loss": [r0["loss"][0], r0["loss"][-1]],
                     "moe_aux": [r0["moe_aux"][0], r0["moe_aux"][-1]], "fold": r0["fold"],
                     "steps": len(r0["loss"])}}
    bad += example_check_failures("train_moe_ep", [r["checks"] for r in moe],
                                  out["train_moe_ep"])
    log(f"example train_moe_ep: {r0['seconds']:.1f} s on rank 0, {len(r0['loss'])} steps, "
        f"experts {r0['placement']}, loss {r0['loss'][0]:.4f} -> {r0['loss'][-1]:.4f}, "
        f"moe_aux {r0['moe_aux'][-1]:.4f}; fold blocking {r0['fold']['blocking']:.6f}, overlap "
        f"{r0['fold']['overlap']:.6f}")
    p0 = pipe[0]
    out["pipeline_multipod"] = {"readings": {k: p0[k] for k in (
        "ref_loss", "sched", "base_loss", "tp_loss", "cp_loss", "ep_loss")}}
    bad += example_check_failures("pipeline_multipod", [r["checks"] for r in pipe],
                                  out["pipeline_multipod"])
    out["pipeline_multipod"]["readings"]["train_loss"] = p0["train"]["loss"]
    sched_peaks = {s: [r["sched"][s]["peak_bytes"] for r in pipe] for s in ("gpipe", "1f1b")}
    log(f"example pipeline_multipod: {p0['seconds']:.1f} s on rank 0; non-pipelined "
        f"{p0['ref_loss']:.6f}, gpipe {p0['sched']['gpipe']['loss']:.6f}, 1f1b "
        f"{p0['sched']['1f1b']['loss']:.6f}; peaks a rank (MB) gpipe "
        f"{[round(b / 1e6, 2) for b in sched_peaks['gpipe']]}, 1f1b "
        f"{[round(b / 1e6, 2) for b in sched_peaks['1f1b']]}; training "
        f"{p0['train']['loss'][0]:.4f} -> {p0['train']['loss'][-1]:.4f}; TP x PP "
        f"{p0['tp_loss']:.6f}, CP x TP x PP {p0['cp_loss']:.6f} (pp-only "
        f"{p0['base_loss']:.6f}); EP blocking {p0['ep_loss']['blocking']:.6f}, overlap "
        f"{p0['ep_loss']['overlap']:.6f}")
    s0 = serve[0]
    out["serve_longcontext"] = {"readings": {arch: {
        "placement": {k: [list(v[0]), str(v[1])] for k, v in s0[arch]["placement"].items()},
        "tokens_rank0_row0": s0[arch]["tokens"][0][:10].tolist()}
        for arch in serve_longcontext.ARCHS}}
    for arch in serve_longcontext.ARCHS:
        bad += logits_failures(f"serve_longcontext {arch}", [r[arch]["first"] for r in serve],
                               out["serve_longcontext"])
    log(f"example serve_longcontext: {s0['seconds']:.1f} s on rank 0; " + "; ".join(
        f"{arch} cache {out['serve_longcontext']['readings'][arch]['placement']}, first "
        f"tokens {out['serve_longcontext']['readings'][arch]['tokens_rank0_row0']}"
        for arch in serve_longcontext.ARCHS))
    g0 = strag[0]
    for r, rep in enumerate(strag):
        if rep["rebalances"] != 1 or rep["applied"] != [(3, 1)] or rep["steps_done"] != 18:
            bad.append(f"straggler_rebalance rank {r}: rebalances {rep['rebalances']} to "
                       f"{rep['applied']}, {rep['steps_done']} steps")
    out["straggler_rebalance"] = {"readings": {
        "first_attribution": g0["stragglers"][0], "actions": g0["actions"],
        "rebalances": g0["rebalances"], "restores": g0["restores"],
        "final_loss": g0["losses"][-1], "sleep_s": EXAMPLE_SLEEP_S}}
    bad += example_check_failures("straggler_rebalance", [r["checks"] for r in strag],
                                  out["straggler_rebalance"])
    log(f"example straggler_rebalance: {g0['seconds']:.1f} s on rank 0 (sleep_s "
        f"{EXAMPLE_SLEEP_S}); first attribution {g0['stragglers'][0]}; actions "
        f"{g0['actions']}; rebalances {g0['rebalances']}, restores {g0['restores']}")
    for name, rks in (("train_moe_ep", moe), ("pipeline_multipod", pipe),
                      ("serve_longcontext", serve), ("straggler_rebalance", strag)):
        lc = example_launches(rks)
        out[name].update(seconds=[r["seconds"] for r in rks], ranks=len(rks),
                         launches={k: lc[k] for k in ("B1", "B2", "B3", "B4_rows",
                                                      "B4_contract")},
                         peak_bytes=[r["peak_bytes"] for r in rks])
        b4 = lc["B4_rows"] + lc["B4_contract"]
        bodies = {**dict.fromkeys(body_counts(), 0),
                  **{k: v for k, v in lc.items() if k.startswith(("flash_fwd", "gg_"))}}
        if bodies["flash_fwd_f32"] != lc["B1"] or bodies["gg_f32"] != b4:
            bad.append(f"{name}: launches by body {bodies}, expected the fp32 bodies' only")
        BODY_COUNTS[f"example_{name}"] = bodies
        log(f"example {name}: launches {out[name]['launches']}, peak a rank (MB) "
            f"{[round(b / 1e6, 1) for b in out[name]['peak_bytes']]}; " + (
                checks_text(out[name]) if "checks" in out[name] else
                f"first logits through the kernels {out[name]['logits_max_rel']:.3e} of their "
                f"max ({out[name]['logits_max_abs']:.3e} absolute) off the plain route's"))
    for name, kernels in EXAMPLE_KERNELS.items():
        lc = out[name]["launches"]
        lc = {**lc, "B4": lc["B4_rows"] + lc["B4_contract"]}
        if any(lc[k] == 0 for k in kernels):
            bad.append(f"{name}: a kernel of its path did not launch: {lc}")
    log(f"phase examples: preempt_resume {pr_s:.1f} s in this process, the rank processes "
        f"{spawn_s:.1f} s (" + ", ".join(f"{n} {out[n]['seconds'][0]:.1f} s on rank 0" for n in (
            "train_moe_ep", "pipeline_multipod", "serve_longcontext", "straggler_rebalance"))
        + ")")
    if bad:
        raise AssertionError("examples: " + "; ".join(bad))
    out["phase_s"] = {"preempt_resume": pr_s, "rank_processes": spawn_s}
    return out


def example_path_launches(examples, key):
    """{"example_<name>": launches of ``key``} for the kernels line."""
    return {f"example_{n}": v["launches"][key] for n, v in examples.items()
            if n != "phase_s" and v["launches"][key]}


def ft_summary(whisper, dp):
    """The fault-tolerance readings for the kernels line (``whisper-small_ft``):
    the phase's, the DP ranks' audit and sdc run, and the training phase's step
    time with the seams unarmed."""
    ft = whisper["ft"]
    return {
        **ft,
        "train_step_ms_seams_unarmed": whisper["train"]["step_ms"],
        "dp_ranks": [{**{k: r[k] for k in ("rank", "integrity_div", "integrity_checksum")},
                      "beside_tp_ranks": {k: r[k] for k in ("audit_ms", "sdc")}}
                     for r in dp["ranks"]],
        "dp_nccl_integrity_div": dp["nccl"]["integrity_div"],
    }


def ssd_entries(ssd_errs, ssm, tp, cp):
    """The kernels-line entries of B5 and B6. ``ssd_errs``: (the bf16 kernel
    checks at each path shape, the worst error of each Hopper pass); ``ssm``:
    {arch: (serving, training)} results; ``tp``, ``cp``: the TP and CP
    phases'. Every launch ran the Hopper body but the fp32 CP step's, which
    ran the first version's (fp32)."""
    path_errs, pass_worst = ssd_errs
    by_path = {"ssd_fwd": {}, "ssd_bwd": {}}
    fp32_window = cp_window("ssm", "ring", fp32=True)
    windows = ["tp_ssm_train_step", cp_window("ssm", "ring"), fp32_window]
    for arch, (serve, train) in ssm.items():
        by_path["ssd_fwd"][f"{arch}_forward"] = serve["b5"]
        by_path["ssd_fwd"][f"{arch}_train_step"] = train["launches"][5]
        by_path["ssd_bwd"][f"{arch}_train_step"] = train["launches"][6]
        windows += [f"{arch}_forward", f"{arch}_train_step"]
    by_path["ssd_fwd"].update(tp_launches(tp, 5, ("ssm",)))
    by_path["ssd_bwd"].update(tp_launches(tp, 6, ("ssm",)))
    by_path["ssd_fwd"].update(cp_launches(cp, 5))
    by_path["ssd_bwd"].update(cp_launches(cp, 6))
    out = []
    for name, kind, line, i, names, tol in (
            ("ssd_fwd", "fwd", 79, 0, ("y", "enters", "state"), SSD_FWD_TOLERANCE),
            ("ssd_bwd", "bwd", 179, 1, BWD_NAMES, SSD_BWD_TOLERANCE)):
        head = ssm[SSM_ARCH][0 if kind == "fwd" else 1]["times"][kind]
        bodies = launches_by_body(name, windows)
        fp32 = by_path[name].get(fp32_window, 0)
        if (bodies[f"{name}_sm90"], bodies[f"{name}_simt"]) != (
                sum(by_path[name].values()) - fp32, fp32):
            raise AssertionError(f"{name}'s launches by body {bodies} do not add up to its "
                                 f"launches by path {by_path[name]} on the Hopper body (the "
                                 f"fp32 step's on the first version's)")
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
            "tp_shape": tp["times"]["ssd"][kind],
            "tp_real_inputs_worst": tp["ranks"][0]["ssm"]["real_ssd"],
            "cp_shape": cp["times"]["ssd"][kind],
            "cp_real_inputs_worst": {f"rank{r['rank']}": r["ssm"]["real_ssd"]
                                     for r in cp["ranks"]},
            "check": "pass",
        })
    return out


def phase_times(launches, path_errs, real_ulps, bwd_errs, train, gemm_errs, moe_serve,
                moe_train, ssd_errs, ssm, whisper, dp, tp, cp, ep, pp, grid, examples):
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
                "cli": whisper["cli"]["launches"][0],
                "whisper_dp_train_step": sum(r["launches"][0] for r in dp["ranks"]),
                "whisper_zero3_train_step": sum(r["zero3"]["launches"][0] for r in dp["ranks"]),
                "whisper_dp_nccl_train_step": dp["nccl"]["launches"][0],
                **tp_launches(tp, 0), **cp_launches(cp, 0), **ep_launches(ep, 0),
                **pp_launches(pp, 0),
                "gemma2_grid_prefill": sum(r["prefill_b1"] for r in grid["ranks"]),
                **example_path_launches(examples, "B1")}
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
        "tp_shapes": {family: tp["times"][family]["fwd"] for family in TP_CASES},
        "tp_real_inputs_max_err_bf16_ulps": max(r[family]["real_fwd_ulps"] for r in tp["ranks"]
                                                for family in TP_CASES),
        "cp_shapes": {name: cp["times"][name]["fwd"] for name in CP_CASES},
        "cp_real_inputs_max_err_bf16_ulps": max(r["dense"]["real_fwd_ulps"]
                                                for r in cp["ranks"]),
        "ep_shapes": {name: ep["times"][name]["fwd"] for name in EP_CASES},
        "ep_real_inputs_max_err_bf16_ulps": max(r[impl]["real_fwd_ulps"] for r in ep["ranks"]
                                                for impl in ("overlap", "blocking")),
        "pp_real_inputs_max_err_bf16_ulps": max(r["path"]["real_fwd_ulps"]
                                                for r in pp["ranks"]),
        "grid_prefill_shapes": grid["times"],
        "grid_prefill_body": "flash_fwd_bf16 (hd 256: the first version's mma.sync body)",
        "grid_real_inputs_max_err_bf16_ulps": max(r["real_fwd_ulps"] for r in grid["ranks"]),
        "grid_library_covers": "SDPA under the same causal and window mask, no softcap",
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
                   "cli": whisper["cli"]["launches"][which + 1],
                   f"{WHISPER_ARCH}_dp_train_step": sum(r["launches"][which + 1]
                                                        for r in dp["ranks"]),
                   f"{WHISPER_ARCH}_zero3_train_step": sum(r["zero3"]["launches"][which + 1]
                                                           for r in dp["ranks"]),
                   f"{WHISPER_ARCH}_dp_nccl_train_step": dp["nccl"]["launches"][which + 1],
                   **tp_launches(tp, which + 1), **cp_launches(cp, which + 1),
                   **ep_launches(ep, which + 1), **pp_launches(pp, which + 1),
                   **example_path_launches(examples, ("B2", "B3")[which])}
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
            "tp_shapes": {family: {
                "shape": list(case[:6]), "ms": tp["times"][family]["bwd"]["ms"][which],
                "bound_ms": tp["times"][family]["bwd"]["bounds"][which][0],
                "bound_by": tp["times"][family]["bwd"]["bounds"][which][1],
                "plain_ms": tp["times"][family]["bwd"]["plain_ms"],
                "whole_backward_ms": tp["times"][family]["bwd"]["whole_ms"],
                "library_ms": tp["times"][family]["bwd"]["library_ms"]}
                for family, case in TP_CASES.items()},
            "tp_real_inputs_max_err_bf16_ulps": max(
                r[family]["real_bwd_ulps"][1 - which] for r in tp["ranks"] for family in TP_CASES),
            "cp_shapes_merged_lse": {name: {
                "shape": list(case[:6]), "causal": case[6],
                "ms": cp["times"][name]["bwd"]["ms"][which],
                "bound_ms": cp["times"][name]["bwd"]["bounds"][which][0],
                "bound_by": cp["times"][name]["bwd"]["bounds"][which][1],
                "plain_ms": cp["times"][name]["bwd"]["plain_ms"],
                "whole_backward_ms": cp["times"][name]["bwd"]["whole_ms"],
                "library_ms": cp["times"][name]["bwd"]["library_ms"]}
                for name, case in CP_CASES.items()},
            "cp_real_inputs_max_err_bf16_ulps": max(r["dense"]["real_bwd_ulps"][1 - which]
                                                    for r in cp["ranks"]),
            "ep_shapes_merged_lse": {name: {
                "shape": list(case[:6]), "causal": case[6],
                "ms": ep["times"][name]["bwd"]["ms"][which],
                "bound_ms": ep["times"][name]["bwd"]["bounds"][which][0],
                "bound_by": ep["times"][name]["bwd"]["bounds"][which][1],
                "plain_ms": ep["times"][name]["bwd"]["plain_ms"],
                "whole_backward_ms": ep["times"][name]["bwd"]["whole_ms"],
                "library_ms": ep["times"][name]["bwd"]["library_ms"]}
                for name, case in EP_CASES.items()},
            "ep_real_inputs_max_err_bf16_ulps": max(
                r[impl]["real_bwd_ulps"][1 - which] for r in ep["ranks"]
                for impl in ("overlap", "blocking")),
            "pp_real_inputs_max_err_bf16_ulps": max(r["path"]["real_bwd_ulps"][1 - which]
                                                    for r in pp["ranks"]),
            "check": "pass",
        })
    gt = {**moe_serve["times"], **moe_train["times"]}
    head = gt["prefill"]
    decode_steps = moe_serve["decode_b4"]
    train_b4 = moe_train["train_b4_rows"] + moe_train["train_b4_contract"]
    tp_b4 = tuple(tp_launches(tp, i).get("tp_moe_train_step", 0) for i in (3, 4))
    ep_b4 = {f"{w}_{mode}": n for i, mode in ((3, "rows"), (4, "contract"))
             for w, n in ep_launches(ep, i).items()}
    ex_b4 = {f"{w}_{mode}": n for mode in ("rows", "contract")
             for w, n in example_path_launches(examples, f"B4_{mode}").items()}
    b4_bodies = launches_by_body("gg_", ("moe_prefill", "moe_decode", "moe_train_step",
                                         "tp_moe_train_step", *ep_launches(ep, 3),
                                         *example_path_launches(examples, "B4_rows")))
    if sum(b4_bodies.values()) != (moe_serve["prefill_b4"] + decode_steps + train_b4
                                   + sum(tp_b4) + sum(ep_b4.values()) + sum(ex_b4.values())):
        raise AssertionError(f"B4's launches by body {b4_bodies} do not add up to its "
                             f"launches by path")
    entries.append({
        "name": "grouped_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
        "replaces": "src/repro/kernels/grouped_gemm.py:50",
        "launches": (moe_serve["prefill_b4"] + decode_steps + train_b4 + sum(tp_b4)
                     + sum(ep_b4.values()) + sum(ex_b4.values())),
        "launches_by_path": {"prefill": moe_serve["prefill_b4"],
                             "decode_step": decode_steps // DECODE_STEPS,
                             f"decode_{DECODE_STEPS}_steps": decode_steps,
                             "train_step_rows": moe_train["train_b4_rows"],
                             "train_step_contract": moe_train["train_b4_contract"],
                             "tp_moe_train_step_rows": tp_b4[0],
                             "tp_moe_train_step_contract": tp_b4[1], **ep_b4, **ex_b4},
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
        "tp_shapes": tp["times"]["gemm"],
        "tp_real_inputs_max_err_bf16_ulps": max(r["moe"]["real_gemm_ulps"] for r in tp["ranks"]),
        "ep_shapes": ep["times"]["gemm"],
        "ep_real_inputs_max_err_bf16_ulps": max(r[impl]["real_gemm_ulps"] for r in ep["ranks"]
                                                for impl in ("overlap", "blocking")),
        "check": "pass",
    })
    entries += ssd_entries(ssd_errs, ssm, tp, cp)
    print(json.dumps({"kernels": entries, f"{WHISPER_ARCH}_checkpoint": whisper["ckpt"],
                      f"{WHISPER_ARCH}_dp": dp_summary(dp),
                      f"{WHISPER_ARCH}_ft": ft_summary(whisper, dp),
                      f"{WHISPER_ARCH}_cli": whisper["cli"],
                      f"{TRAIN_ARCH}_tp": tp_summary(tp),
                      f"{TRAIN_ARCH}_cp": cp_summary(cp),
                      f"{MOE_ARCH}_ep": ep_summary(ep),
                      f"{TRAIN_ARCH}_pp": pp_summary(pp),
                      f"{GRID_ARCH}_grid": grid_summary(grid),
                      "examples": {**examples, "tolerance": EXAMPLE_TOLERANCE}}), flush=True)


# ---------------------------------------------------------------------------
# the dry run's estimates of the single-device cells (phase 22)


def dryrun_cells():
    """{cell: [(config, InputShape, plan), ...]} of the single-device cells at
    the phases' own configs, rows and plans: a training cell's step, a
    serving cell's prefill and decode (its cache of MAX_SEQ positions)."""
    from repro_torch.core import InputShape, ParallelPlan
    from repro_torch.launch import resolve_config
    train = ParallelPlan(compute_dtype="bfloat16", param_dtype="float32", remat="full",
                         microbatches=TRAIN_MICRO)
    serve = ParallelPlan(compute_dtype="bfloat16", param_dtype="bfloat16")

    def cfg(arch, **cut):
        return dataclasses.replace(resolve_config(arch, "train_4k"), **cut)

    def rows(n):
        return InputShape("cell", TRAIN_SEQ, n, "train")
    cells = {
        f"{TRAIN_ARCH} training": [(cfg(TRAIN_ARCH), rows(TRAIN_BATCH), train)],
        f"{MOE_ARCH} training": [(cfg(MOE_ARCH, n_layers=MOE_TRAIN_LAYERS), rows(TRAIN_BATCH),
                                  train)],
        f"{SSM_ARCH} training": [(cfg(SSM_ARCH), rows(SSM_TRAIN_BATCH[SSM_ARCH]), train)],
        f"{HYBRID_ARCH} training": [(cfg(HYBRID_ARCH), rows(SSM_TRAIN_BATCH[HYBRID_ARCH]),
                                     train)],
        f"{WHISPER_ARCH} training": [(cfg(WHISPER_ARCH), rows(WHISPER_TRAIN_BATCH), train)],
    }
    for arch in (ARCH, MOE_ARCH):
        cells[f"{arch} serving"] = [(cfg(arch), InputShape("cell", PROMPT, BATCH, "prefill"), serve),
                                    (cfg(arch), InputShape("cell", MAX_SEQ, BATCH, "decode"), serve)]
    return cells


def dryrun_estimates(out_path):
    """The dry run's child (phase 22): each cell's estimate on meta tensors
    (``launch.dryrun.estimate``, no mesh), then the launch counters and the
    times nvcc or a kernel library was sought, as JSON at ``out_path``."""
    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import estimate
    torch.set_num_threads(1)
    sought = []

    def refuse(*args):
        sought.append(repr(args))
        raise RuntimeError("the dry run's child sought nvcc or a kernel library")
    build._nvcc, build.load = refuse, refuse
    out = {}
    for cell, runs in dryrun_cells().items():
        t0 = time.perf_counter()
        out[cell] = [estimate(cfg, shape, None, plan) for cfg, shape, plan in runs]
        print(f"dry run: {cell} estimated in {time.perf_counter() - t0:.1f} s", flush=True)
    out["_launches"] = [*all_counts(), *ssd_counts()]
    out["_sought"] = sought
    Path(out_path).write_text(json.dumps(out, default=str))


def start_dryrun():
    """The dry run's child process, started at the script's start: on the
    host, with no card visible, niced. Returns (process, its output path, its
    log path, its start time)."""
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    out, log_path = work / "dryrun_estimates.json", work / "dryrun_estimates.log"
    out.unlink(missing_ok=True)
    code = ("import os, sys; os.nice(10); sys.path[:0] = sys.argv[1:3]; import chip_smoke; "
            "chip_smoke.dryrun_estimates(sys.argv[3])")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT), str(ROOT / "src"),
                                 str(out)], stdout=f, stderr=subprocess.STDOUT,
                                env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                                     "OMP_NUM_THREADS": "1"})
    return proc, out, log_path, time.perf_counter()


def phase_dryrun(child):
    """Each cell's estimate beside the phase's readings (module docstring,
    phase 22): the static bytes within DRYRUN_STATIC_REL on every cell, the
    traced peak within DRYRUN_PEAK_REL on every training cell; the child
    built and launched nothing. Logs one JSON line of the readings."""
    proc, out, log_path, t0 = child
    try:
        proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"the dry run's child ran past {DRYRUN_TIMEOUT} s:\n"
                             f"{log_path.read_text()[-3000:]}")
    text = log_path.read_text()
    if proc.returncode != 0:
        raise AssertionError(f"the dry run's child failed ({proc.returncode}):\n{text[-4000:]}")
    for line in text.splitlines():
        log(line)
    est = json.loads(out.read_text())
    launches, sought = est.pop("_launches"), est.pop("_sought")
    log(f"dry run: the child's launch counters {launches}, nvcc or a library sought "
        f"{len(sought)} times")
    if any(launches) or sought:
        raise AssertionError(f"the dry run's child launched {launches} or sought {sought}")
    rows, failures = [], []
    for cell, recs in est.items():
        meas = MEMORY[cell]
        training = len(recs) == 1
        at = recs[-1]["traced"]["at_start"]
        static = at["params"] + (at["optimizer"] if training else at["cache"])
        peaks = [r["traced"]["peak"]["total"] for r in recs]
        row = {"cell": cell, "static_estimate": static, "static_measured": meas["static"],
               "static_ratio": static / meas["static"], "peak_traced": max(peaks),
               "peak_measured": meas["peak"], "peak_ratio": max(peaks) / meas["peak"],
               "trace_s": [r["trace_s"] for r in recs], "held": "peak" if training else
               "static only (serving peaks are readings)"}
        if not training:
            row["prefill_peak_traced"], row["decode_peak_traced"] = peaks
        rows.append(row)
        log(f"dry run {cell}: static {static / 1e9:.4f} GB estimated, "
            f"{meas['static'] / 1e9:.4f} GB allocated (ratio {row['static_ratio']:.5f}); "
            f"peak {max(peaks) / 1e9:.3f} GB traced, {meas['peak'] / 1e9:.3f} GB measured "
            f"(ratio {row['peak_ratio']:.4f}{'' if training else ', a reading'})")
        if abs(row["static_ratio"] - 1) > DRYRUN_STATIC_REL:
            failures.append(f"{cell}: static ratio {row['static_ratio']:.5f}")
        if training and abs(row["peak_ratio"] - 1) > DRYRUN_PEAK_REL:
            failures.append(f"{cell}: peak ratio {row['peak_ratio']:.4f}")
    log(json.dumps({"dryrun": rows}))
    if failures:
        raise AssertionError("the dry run's estimates miss the card's readings: "
                             + "; ".join(failures))
    return rows


def free():
    gc.collect()
    torch.cuda.empty_cache()


def main():
    t0 = time.perf_counter()
    kind = phase_device()
    children = []
    try:
        run(t0, kind, children)
    finally:
        for child in children:
            if child[0].poll() is None:
                child[0].kill()


def run(t0, kind, children):
    from repro_torch.core import resolve_device
    resolve_device()                       # fp32 matmuls in full fp32
    timed("build", phase_build)
    # phase 22's estimates on the host, beside the card's phases (after the
    # build: nvcc takes the host's cores first)
    children.append(start_dryrun())
    child = children[0]
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
    whisper["cli"] = timed("training CLI", phase_cli)
    free()
    dp, tp = timed("data and tensor parallel", dp_and_tp)
    free()
    cp, ep, pp = timed("context, expert and pipeline parallel", phase_cp_ep_pp)
    free()
    grid = timed("grid serving", phase_grid_serving)
    free()
    examples = timed("examples", phase_examples)
    free()
    timed("dry run", phase_dryrun, child)
    timed("times", phase_times, launches, path_errs, real_ulps, bwd_errs, train,
          gemm_errs, moe_serve, moe_train, ssd_errs, ssm, whisper, dp, tp, cp, ep, pp, grid,
          examples)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
