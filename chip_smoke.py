#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build every hand-written CUDA kernel from ``src/repro_torch/.../csrc``
   (K1, K2, K4/K5 in one source, and K3/K6/K7 in one source; and the
   parent's K4/K5 and K3/K6/K7 where ``tools/parent_kernels.py`` wrote
   them), one ``nvcc`` per source, started together, printing
   ``-Xptxas -v``; print K1's and
   K2's one-pass plans (registers, shared memory, co-resident blocks, chunk
   slots) at the main buckets;
2. K1 (f32 and bf16 moments) at the three LLaMA-60M bucket shapes, a
   FIRST-mode-sized leaf and a shape whose leaves end in a ragged chunk,
   levels 1-3, bf16 and f32 parameters, in every CASE (limiter with a zero
   and a non-zero history, a clipping case, weight decay, limiter off),
   each at two seed sets (the seeds earlier runs used, and new ones): the
   entry takes the design the capacity rule names (one pass where the
   bucket's G̃ fits on chip, else two; f32 (2, 4096, 1376) is beyond it and
   the one-pass entry
   refuses it), its two runs are bitwise equal, the one pass equals the
   two-pass kernel bitwise, and p, m, v and the norm are bitwise equal to
   the plain PyTorch version, which sums ‖G̃‖² in the kernels' order;
3. K2 (blocked-int8 moments) the same way: p, codes, scales and the norm
   bitwise equal to the plain version;
4. small-input check: a few steps of llama-60m-smoke, f32 and int8 state,
   from the same parameters and batches on the card and on the CPU give
   the same losses;
5. the f32 main path: ``repro_torch.launch.train.main`` trains full-width
   llama-60m with GWT-2 for 20 steps; K1 must launch exactly 3 times per
   step, all through the one-pass design (K2 never), the losses be finite
   and the last logged one below the first;
6. the int8 main path: the same with ``--state-codec int8``; K2 must
   launch 3 times per step through the one-pass design (K1 never); the
   state must be the JAX package's 48,273,508 bytes;
7. resume on the card: full width, int8, train 20 steps checkpointing at
   10, resume a fresh run from step 10; the result must be bitwise equal
   to the 20 straight steps of phase 6 (parameters, codes, scales, norms);
8. time K1 and K2 per launch at the main buckets, both designs in the same
   call (K1's one pass also with bf16 moments, beside its bound with
   2-byte moments): device time (CUDA events around each launch, L2
   flushed before it), time per call back to back, the plain version's,
   the bound; and the int8 path's generic decode/encode of the embedding's
   moments;
9. profile a few full-width steps of each path: ``optimizer.update`` vs the
   rest, device busy share, top kernels;
10. K3 (``haar_dwt_fwd_q``), K6 (``haar_dwt_fwd``) and K7 (``haar_dwt_inv``)
    against their plain versions on the card, bitwise, at the flattened
    LLaMA-60M leaf shapes and an odd-row shape, levels 1-3, every wire dtype;
    the fp8 inputs reach past 464 and +-inf, so the NaN-on-overflow rule is
    exercised; two runs must be bitwise equal; then K3's and K6's grouped
    entries over the 10 DP leaves, a mixed group (odd rows, an odd
    coefficient count, an unaligned leaf base) and 40 leaves (two
    launches), each leaf bitwise to its plain version, the launch and leaf
    counters exact;
11. the compressed data-parallel path: the launcher with ``--dp-reduce
    compressed`` (bf16 details, 20 steps) under a one-rank NCCL process
    group, so the gradient gather runs on the card; K3 must launch once per
    step for all 10 compressible leaves (20 launches, 200 leaves), K7 10
    times per step and K1 3 times (one pass), the wire bytes be the JAX
    package's 208,449,536 against 333,516,800, the losses finite and
    falling; then a shorter run with fp8 details and error feedback (K7 20
    times per step: the residue's reconstruction too); then one reduction
    of a full-width gradient grouped and leaf by leaf, bitwise equal, with
    each one's peak memory;
12. time K3, K6 and K7 per launch beside their bounds, plain versions and
    the parent revision's (in turns), K3 and K6 as one grouped launch over
    the DP group beside ten single launches, the grouped wrapper's host
    time, and profile the data-parallel step beside the plain f32 step;
13. K4 (``gwt_adam_tile``, f32 and bf16 moments) and K5
    (``gwt_adam_tile_q8``) against their plain versions at the staged
    path's leaf shapes, odd rows, and an L = 3 stack with an odd
    coefficient count per leaf (unaligned leaf bases, a ragged chunk, a
    partial quantization block), levels 1-3, f32 and bf16 gradients, both
    seed sets: G̃, m', v' (K5: G̃, codes, scales) and the ‖G̃‖² partials
    (``ref.chunk_ssq``) bitwise, two runs bitwise;
14. the staged path, ``gwt(fused_write=False)``, at full width through the
    ``TrainLoop``, f32 and int8, 20 steps each: K4 must launch 140 times
    (7 leaves x 20 steps), K1, K2 and K5 never, the loss fall and stay
    within ``TOL_STAGED_LOSS`` of the fused path's in the same call; the
    unrolled engine (``bucketed=False``) equal to the bucketed staged path,
    bitwise, over 3 full-width steps;
15. peak device memory of one ``optimizer.update``, fused write against
    staged, at full width and on the JAX benchmark's 4 x 256 x 2048 f32
    bucket;
16. the launcher's other choices at full width, 20 steps each (``--optimizer
    adam``, ``adam_mini``, ``muon``, ``sgd``; ``gwt --host adam_mini``,
    ``--host muon``; the low-rank ``galore``, ``apollo``, ``fira``,
    ``adarankgrad``, ``rso``, whose state bytes must be the JAX
    package's): losses finite and falling, no GWT kernel launched, state
    bytes, step time and peak memory printed;
17. time K4 and K5 per launch beside their bounds (K4 also with bf16
    moments), their plain versions, a
    ``copy_`` of the same bytes and, where ``tools/parent_kernels.py``
    wrote the parent revision's sources into ``build/parent_kernels/``, the
    parent's K4 and K5 (built in phase 1, timed in turns with the current
    ones), and profile the staged step beside the fused one;
18. the corpus path: build a byte corpus of ``src/repro/**/*.py`` with
    ``repro_torch.data.build_corpus`` (printing its hash and split sizes)
    and train full-width llama-60m GWT-2 on it for 20 steps with
    ``--data corpus --workers 2 --eval-every 10 --eval-batches 4``: K1
    must launch exactly 3 times per step, all one-pass, K2 never; the
    losses be finite and falling; evals at steps 10 and 20, finite and
    falling.  The same steps with ``--workers 0`` and no eval must give
    bitwise-equal losses, parameters and state; 10 steps + checkpoint +
    resume must equal the 20 straight steps bitwise; a resume against a
    corpus of another hash must be refused.  Prints the step time beside
    phase 5's synthetic step, the watchdog's dispatch and blocked
    s/step, and one eval's wall time, with the card's name and power
    limit;
19. bf16 optimizer state: ``gwt(state_dtype=torch.bfloat16)`` at full
    width through the ``TrainLoop``, 20 steps fused (K1 with bf16 moments:
    exactly 3 launches a step, all one pass) and 20 staged (K4 with bf16
    moments: 7 a step), nothing else launched; losses finite and falling,
    the staged within ``TOL_STAGED_LOSS`` of the fused; the moments bf16
    and the state the JAX package's 90,867,744 bytes;
20. the low-rank refresh: each of ``galore``, ``apollo``, ``fira``,
    ``adarankgrad``, ``rso`` at full width through the ``TrainLoop`` with
    ``update_gap=5`` for 20 steps (refreshes and moment rotations at 0, 5,
    10, 15): every non-refresh update makes 0 synchronizing calls
    (PyTorch's sync debug mode), no GWT kernel launches, losses finite and
    falling; the refresh update's time beside the steady one; for
    ``galore`` and ``rso`` 10 steps + checkpoint + resume equal the 20
    straight steps bitwise (the refreshes at 10 and 15 after the resume);
    APOLLO's projector draw (``core.prng``: jax.random's threefry bits,
    uniforms and normals) on the card against the CPU at full-width
    llama-60m and qwen2.5-3b (73728-row) leaves: bits and uniforms
    bitwise, normals within 4 f32 spacings, no synchronizing call;
21. K1 at the dense configs' bucket widths: one layer's rows of each
    qwen2.5-3b width ((2,2048,256), (2,2048,2048), (2,2048,11008),
    (1,11008,2048)) and the stacked bias buckets ((2,36,256), (1,36,2048))
    as phase 2 holds them at level 2; then each whole two-pass bucket
    ((1,396288,2048), (2,73728,11008), (2,73728,256), (2,73728,2048)) for
    K1 with f32 and bf16 moments and for K2, in every CASE: two runs and
    the plain version bitwise equal on every output (the largest has
    1.62e9 elements and 99,072 partials a leaf);
22. the dense main path: ``train.main`` trains qwen2.5-3b at full width
    cut to 9 of its 36 layers (GQA, QKV bias, remat; the depth cut keeps
    the script within its time) with GWT-2 for 20 steps at batch 16 x seq
    256, with f32 moments and with ``--state-codec int8``: K1 (int8: K2)
    4 times a step (``PINNED_GROUPS``: the three one-pass buckets, the
    bias buckets and wk/wv, in one grouped launch; the three two-pass
    buckets alone), nothing else launched; the state the JAX package's
    3,876,942,892 (int8: 1,029,812,992) bytes; losses finite and falling;
    step time, tokens/s, peak memory, a profile of the f32 step, K1 and K2
    per launch at each of the six buckets of the full depth beside the
    bound and the plain version, and the int8 wrap of the (151936, 2048)
    embedding's moments;
23. deepseek-67b, gemma2-9b and gemma3-27b at full width, cut to 2
    layers, 5 steps each through the launcher: deepseek (untied head on
    plain Adam) at 16 x 256, gemma2 (local and global, both softcaps) at
    1 x 8192 where the 4096 window takes the block-local route, gemma3
    (remainder blocks only, QK-norm) at 2 x 2048; state bytes the JAX
    package's, K1 counts and attention routes exact, losses finite;
24. the chunked route: ``_flash_attn`` against ``_direct_attn`` on the
    card at (1,4096,16,128) bf16, and one full-width qwen2.5-3b step cut
    to 2 layers at 1 x 16384, which takes it;
25. each dense smoke config, f32 and bf16, 3 steps on the card and on the
    CPU from the same parameters and batches: losses within
    ``TOL_SMOKE_LOSS``;
26. serving, the round trip: ``train.main`` trains full-width llama-60m
    GWT-2 f32 for 20 steps (K1 exactly 3 a step, one pass) and
    checkpoints; ``launch.serve.main --ckpt`` serves it (32 requests of
    ``build_workload``, prompts <= 128, gen <= 64, 8 slots, page 16, chunk
    64); then ``Engine.from_checkpoint``, continuous and static, bf16 and
    int8 pages: none of K1-K7 launched, the arena's storage unmoved,
    memory flat over the decode ticks, the free list recovered,
    ``kv_bytes`` exact (``KV_BYTES_PER_LAYER``); every request's tokens
    equal the dense ``generate`` path's up to a first divergence, which
    must be at a near tie (printed), continuous equal to static; the paged
    path's logits, teacher-forced on the dense tokens, within
    ``TOL_SERVE_BF16_SPACINGS`` (bf16 pages) and
    ``TOL_SERVE_INT8_SPACINGS`` (int8) of the dense path's, int8 picking
    the dense token on >= 0.9 of the steps; syncs per tick counted; the
    decode step timed and profiled (launches, device idle share, the page
    gather) beside its bound;
27. the same at qwen2.5-3b full width cut to 9 of its 36 layers, seed-0
    init, 16
    requests (prompts <= 256, gen <= 64), continuous, bf16 and int8
    pages;
28. serving steps of the smoke configs on the card and on the CPU from
    the same params (paged prefill, decode and chunk prefill for
    llama-60m, qwen2.5-3b, deepseek-67b; the dense ring-buffer decode for
    gemma2-9b and gemma3-27b; qwen2-vl-72b through the dense path, the
    MoE configs paged, in f32): logits within ``TOL_SERVE_SMOKE``;
    phase 25 also trains the qwen2-vl-72b and MoE smoke configs;
29. LoRA at full-width llama-60m on phase 26's checkpoint:
    ``train.main --finetune lora --lora-rank 8 --base-ckpt``, 20 steps
    GWT-2, f32 then int8 moments: K1 (int8: K2) once a step, one grouped
    launch over the four adapter buckets (``LORA_BUCKETS``: f32 adapters
    under the bf16 model's gradient, which the step casts to bf16), the
    base bitwise the checkpoint's, the adapter state the JAX package's
    bytes; each run bitwise (parameters, state, losses) to the same run
    with every bucket alone (4 launches a step; ``buckets_alone``), and
    the two timed A B B A (``PHASE29_ROUNDS`` rounds: each run's steady
    step time, the mean and spread of each side); each adapter
    bucket whole, K1 and K2 in every CASE, bitwise to the plain version;
    ``launch.serve.main --ckpt`` on the fine-tune (merged at load from its
    run metadata), and the engine's tokens equal dense ``generate`` on
    ``lora.merge``'s weights up to a near tie; K1/K2 timed per adapter
    bucket beside the bound;
30. LoRA at qwen2.5-3b full width and depth from a random base, 5 steps:
    K1 once a step (one grouped launch over the five adapter buckets, by
    ``PINNED_GROUPS``), step time, peak memory, adapter state bytes, the merge's
    share of the step; the five adapter buckets held whole and timed;
31. qwen2-vl-72b cut to 1 layer (every width published), 16 x 256, 5
    steps through the launcher: K1's launches and designs, the attention
    routes, the JAX package's state bytes, finite losses; every GWT bucket
    of the cut (``gwt_buckets``) held whole, K1 in every CASE, bitwise to
    the plain version;
32. qwen2-moe-a2.7b and qwen3-moe-30b-a3b cut to 2 layers, the same (K2
    too at every bucket of qwen3-moe); the expert buckets
    (``EXPERT_BUCKETS``, checked against the plan) timed; the dropped
    pairs a step and the aux loss read in a second run of the same steps
    with ``moe_probe`` (the timed run has no probe); qwen3-moe again with
    ``--state-codec int8`` (K2 by plan, the JAX package's state bytes)
    and K2 timed at its expert buckets;
33. jamba-v0.1-52b at full width cut to the first five kinds of its
    period (mamba, mamba+moe, mamba, mamba+moe, attn), 16 x 256, 5 steps
    through the launcher: K1's launches and designs by plan, nothing else
    launched, the attention routes, the JAX package's state bytes, losses
    finite and falling; every GWT bucket of the cut held against the plain
    version in every CASE, whole, or past 2^31 elements (the 3.76e9-element
    expert bucket) the whole-bucket launch bitwise to one launch per leaf
    and each leaf bitwise to the plain version; K1 timed at each bucket;
    a profiled step; the smoke config 3 steps on the card and on the CPU
    (f32 and bf16) within ``TOL_SMOKE_LOSS``, and its prefill + cached
    decode on the card against its own train forward;
34. xlstm-350m at full width cut to one period (8 layers) the same,
    with f32 and int8
    moments (K2 by plan, held and timed at every bucket), the sLSTM time
    loop's steps counted and one sLSTM block's launches profiled apart;
35. seamless-m4t-large-v2 at full width cut to 6 encoder and 6 decoder
    layers of its 12 + 12 the same (64 frames a row), its smoke config's
    ``decode_stack`` decode against teacher forcing on the card;
36. observability: ``tapped_update`` and ``update`` from two copies of
    the same parameters and state, 3 steps with the same gradients (the
    limiter clipping on the third), at llama-60m's buckets with K1 (f32
    moments), K2 (int8) and K4 (staged) and at qwen2.5-3b's
    (2,73728,11008) bucket with K1 (two passes): parameters and state
    bitwise equal, every bucket's taps against plain taps in f64 from
    copies of g, p before, p after and the norms (``TOL_TAP_SSQ``; clips
    and q8 saturation exact, ``q8_absmax`` bitwise), 0 synchronizing calls
    in either; the launcher with ``--metrics-dir`` at llama-60m, f32 and
    int8, 20 steps: the same launches and losses bitwise to phases 5-6,
    taps on steps 5, 10, 15, 20, the trace valid with the loop's spans;
    the ``TrainLoop``'s syncs over two log windows equal with and without
    the tapped step; the untapped and the tapped step timed A B B A at
    llama-60m and qwen2.5-3b (full depth, 16 x 256) with each segment's
    peak memory;
37. sharded parameters (``--shard-params auto``) against ``none`` under
    a one-rank NCCL group, where every placement is over mesh axes of
    size 1 and nothing is copied: qwen2.5-3b at full width and 9 layers,
    16 x 256, 3 steps of ``--mesh 1 --dp-reduce exact`` (K1 by plan in both
    designs, the same counts, losses, parameters and state bitwise, the
    auto peak within 1% of none's, each step time printed) and llama-60m
    10 steps of ``--state-codec int8 --dp-reduce compressed`` (K2 30, K3
    10, K7 100 in both, bitwise); the rule table's per-rank bytes of
    qwen2.5-3b on a ``data=8`` mesh, computed from shapes and printed as
    such.  No figure of more than one card exists;
38. the paper's example drivers (``repro_torch.examples``) as a user runs
    them: ``quickstart`` (llama-tiny, 60 steps of 16 x 128 under Adam,
    GWT-2 and GWT-3; K1 by plan), ``compare_optimizers`` at its defaults
    but for depth (llama-tiny at 2 of its 4 layers; 120 steps, nine
    methods; the Table II proxy with each method's
    launches, K1 by plan for the Adam-hosted GWT rows and none elsewhere),
    ``pretrain`` at llama-130m full width, 16 x 256, 40 steps
    checkpointing at 20, then its step-40 checkpoint removed and the run
    resumed from 20, bitwise to the 40 straight steps (K1 by plan in both),
    ``serve_batched`` at its defaults (no kernel), and
    ``optim.engine.live_update_bytes`` of one llama-60m update, fused (K1)
    against staged (K4), A B B A;
39. the ``model`` mesh axis: two processes on the card over gloo at
    ``--mesh 1x2`` (``tools/tp_rank.py``) against world 1 here, for
    llama-60m (f32 and int8 moments, 5 steps at lr 1e-3),
    qwen3-moe-30b-a3b's 1-layer cut, jamba-v0.1-52b's first block (mamba
    with its MLP), one period of xlstm-350m (8 layers, in f32 and in
    bf16) and seamless-m4t-large-v2 at 2 encoder and 2 decoder layers, all
    at full width (2 steps each): losses within 2e-3
    relative, the whole optimizer state and parameters at the end leaf by
    leaf (xlstm-350m's bf16 run against its f32 run, within 1.5 times
    world 1's own bf16 distance), each rank's bytes equal to the rule
    table's, K1/K2 launches equal to world 1's; peaks and step times
    printed; every run but LoRA's with ``--metrics-dir``: rank 0's
    optimizer taps on every step with world 1's keys in world 1's order,
    each kind within ``TP_TAPS_RTOL`` of world 1's (the int8 run also
    within twice world 1's own spread at ``--accum 2``, xLSTM's bf16 run
    within 1.5 times its distance from the f32 run), the counts exactly;
    and llama-60m (f32 moments, 5 steps) at ``--mesh 2`` without
    ``--dp-reduce`` (the data axis alone: each rank half the rows, the
    exact mean) against world 1 at ``--accum 2``, the same checks with
    each rank holding the whole trees;
40. the grouped K1 and K2 (``kernel.gwt_adam_fused_group``,
    ``gwt_adam_fused_q8_group``: one launch over several one-pass
    buckets): every set a main path groups (``PINNED_GROUPS``: the LoRA
    adapters of llama-60m and qwen2.5-3b, qwen2.5-3b's 9-layer cut,
    qwen2-vl-72b's and qwen3-moe's 1-layer cuts, xlstm-350m's 8 layers in
    bf16 and f32, the examples' llama-tiny at GWT-2 and GWT-3),
    qwen2.5-3b's two bias buckets and a FIRST-mode bucket with two
    LAST-mode ones, in every CASE, K1 over f32 and bf16 moments and K2,
    each pinned launch one grouped call: every output bitwise the
    per-bucket launches and the grouped plain version, each call counted
    once by launch and by its buckets, the card's ``group_plan`` the
    pinned launches; a FIRST-mode bucket and a bucket of another level
    split by the plan and refused by both wrappers; three sets timed as
    their grouped launches beside their per-bucket launches in the same
    call (A B B A, CUDA events, L2 flushed), the bounds, the grouped plain
    version and each wrapper's host us a call.  Since the engine groups,
    K1/K2 count a step as ``PINNED_GROUPS`` names, written out at the
    H100's figures (``plan_counts`` holds the card's plan to them):
    llama-60m's three buckets still 3 (no two fit one launch), its LoRA 1,
    qwen2.5-3b's 9-layer cut 4, its LoRA 1 (K2 2).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
# The phases run workloads of very different sizes in one process, and the
# full-width dense cuts (phase 23) peak within 15 GB of the card's 80 GB:
# with fixed segments, blocks that earlier phases left alive pin whole
# segments and the cache splits the rest (12 GiB reserved but unallocated
# at a 7.8 GiB request, seen on an H100).  Growable segments map what they
# use; set before torch touches CUDA.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM (NVIDIA data sheet and Hopper white paper): HBM3 bandwidth, the
# f32 and int32 rates outside the tensor cores, the peaks a bound is taken
# against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12

# the three GWT buckets of llama-60m after row merging, and the leaves each
# stands for; plus a FIRST-mode-sized leaf (a (8, 1376, 514) weight, whose
# last axis is not divisible by 4, arrives transposed as (8, 514, 1376))
MAIN_SHAPES = [("mixer wq/wk/wv/wo", (4, 4096, 512)),
               ("ffn w_gate/w_up", (2, 4096, 1376)),
               ("ffn w_down", (1, 11008, 512))]
FIRST_SHAPE = ("FIRST-mode (8,1376,514) leaf", (1, 4112, 1376))
# 37 * 86 = 3182 coefficients per leaf: 49.7 blocks of 64
PARTIAL_SHAPE = ("partial last block", (3, 37, 344))
LEVEL = 2
QBLOCK = 64
# the names of K1's CUDA kernels (gwt_adam_fused.cu and the one-pass and
# two-pass kernels of gwt_adam_common.cuh), as the profiler reports them
K1_KERNEL_NAMES = ("one_pass<", "norm_pass<", "scale_pass<", "write_pass<")
STEPS = 20
MAIN_ARGS = ["--arch", "llama-60m", "--steps", str(STEPS), "--batch", "16",
             "--seq", "256", "--log-every", "5", "--seed", "0"]
STATE_BYTES_INT8 = 48_273_508   # the JAX package's engine.state_bytes
# the compressible leaves of llama-60m as the reduction flattens them for
# K3 and K7, with their counts (10 launches per step); plus one odd-row shape
DP_SHAPES = [((32000, 512), 1), ((11008, 512), 1), ((4096, 1376), 2),
             ((4096, 512), 4), ((8, 512), 2)]
ODD_SHAPE = (37, 344)
# tree_wire_bytes of llama-60m in the JAX package: compressed with bf16
# details, and the exact f32 reduction
WIRE_BF16, WIRE_EXACT = 208_449_536, 333_516_800
DP_EF_STEPS = 10
# cycles the card spins before each timed DWT launch (about 0.5 ms at the
# H100's clock), longer than the host takes to queue the launch
SPIN_CYCLES = 1_000_000
# float8_e4m3fn codes the JAX package gives (ml_dtypes, no saturation)
FP8_EDGES = [(448.0, 0x7E), (464.0, 0x7E), (464.03125, 0x7F), (465.0, 0x7F),
             (-465.0, 0xFF), (480.0, 0x7F), (1e30, 0x7F),
             (math.inf, 0x7F), (-math.inf, 0xFF), (math.nan, 0x7F),
             (-0.0, 0x80), (2.0 ** -9, 0x01), (2.0 ** -10, 0x00)]

# (case, use_limiter, prev_norm, weight decay coefficient)
CASES = [("limiter, prev 0", True, 0.0, 0.0),
         ("limiter, prev > 0", True, 1e9, 0.0),
         ("limiter clips", True, 1.0, 0.0),
         ("weight decay", True, 1e9, 1e-4),
         ("limiter off", False, 0.0, 0.0)]

def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_inputs(shape, seed, dev, level=LEVEL, dtype=torch.bfloat16,
                mdtype=torch.float32, pdtype=None):
    """K1's inputs, g of ``dtype``, p of ``pdtype`` (``dtype`` where not
    given), the moments drawn in f32 and rounded to ``mdtype``."""
    L, m, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    g = (r(L, m, n) * 0.01).to(dtype)
    p = (r(L, m, n) * 0.02).to(pdtype or dtype)
    mm = r(L, m, n >> level) * 1e-3
    vv = torch.rand(L, m, n >> level, generator=gen, device=dev) * 1e-6
    return g, p, mm.to(mdtype), vv.to(mdtype)


def make_q8_inputs(shape, seed, dev, level=LEVEL, dtype=torch.bfloat16,
                   pdtype=None):
    """K1's inputs with the moments encoded by the port's codec."""
    from repro_torch.optim import codec
    g, p, mm, vv = make_inputs(shape, seed, dev, level, dtype,
                               pdtype=pdtype)
    L = shape[0]
    ids = torch.arange(L, device=dev)
    (qm, sm), (qv, sv) = (codec.quant_blocks(a.reshape(L, -1), ids + salt)
                          for a, salt in ((mm, 101), (vv, 202)))
    return g, p, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv


def q8_salts(L, dev, step=3):
    from repro_torch.optim import codec
    key = codec.make_key(0, dev)
    ids = torch.arange(L, device=dev)
    return [codec.slot_salt(key, torch.tensor(step, device=dev), s, ids)
            for s in (0, 1)]


# Phases 2-3 hold K1 and K2 at every shape, level and dtype below, in every
# CASE, at both seed sets: the entry's design (one pass where the bucket
# fits, else two) must be the one the capacity rule names, two runs bitwise
# equal, the one-pass result bitwise equal to the two-pass kernel's, and
# every output bitwise equal to the plain version's, the norm included (the
# plain version sums ‖G̃‖² in the kernels' order: ref.chunk_ssq,
# ref.leaf_norm).
FUSED_SHAPES = MAIN_SHAPES + [FIRST_SHAPE, PARTIAL_SHAPE]
FUSED_LEVELS = (1, 2, 3)
FUSED_DTYPES = (torch.bfloat16, torch.float32)
# the moment dtypes K1 and K4 take (gwt(state_dtype=...)), all held in
# phases 2 and 13
MOMENT_DTYPES = (torch.float32, torch.bfloat16)
MOMENT_NAMES = ["float32", "bfloat16"]
# 0: the seeds earlier runs used (at level 2); 1: seeds no earlier run used,
# so a pass that depends on the seed shows
SEED_SETS = (0, 1)


def seed(case, n, level, seed_set):
    """Inputs of a phase 2-3 case."""
    return 1000 * case + n + 7 * (level - LEVEL) + 1_000_003 * seed_set


def check_designs(kernel, name, label, shape, level, dtype, runs, two,
                  counts, one_pass):
    """The entry took the design the capacity rule names (its design
    counters moved by ``counts``), its two runs are bitwise equal, and, on
    a bucket that fits, they equal the two-pass kernel's bitwise."""
    what = f"{name} {label} {shape} l={level} {dtype}"
    if counts != ((2, 0) if one_pass else (0, 2)):
        raise AssertionError(f"{what}: design counters moved by {counts}, "
                             f"the capacity rule says "
                             f"{'one' if one_pass else 'two'} pass(es)")
    for a, b in zip(*runs):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two kernel runs differ")
    for a, b in zip(runs[0], two):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: one pass differs from two "
                                 f"passes in {int((a != b).sum())} of "
                                 f"{a.numel()} elements")


def refuses_one_pass(fn, what):
    try:
        fn()
    except ValueError as err:
        if "does not fit" not in str(err):
            raise
        return
    raise AssertionError(f"{what}: the one-pass entry took a bucket beyond "
                         f"capacity")


def fused_buckets(q8, shapes=FUSED_SHAPES, levels=FUSED_LEVELS):
    """Phase 2's (K1: also each moment dtype) and phase 3's buckets:
    ``(label, shape, level, dtype, moment dtype)``."""
    for label, shape in shapes:
        for level in levels:
            for dtype in FUSED_DTYPES:
                for mdtype in ((torch.float32,) if q8 else MOMENT_DTYPES):
                    yield label, shape, level, dtype, mdtype


def check_fused(kernel, ref, dev, q8, shapes=FUSED_SHAPES,
                levels=FUSED_LEVELS):
    """Phases 2 (K1) and 3 (``q8``: K2) at ``shapes`` x ``levels`` x
    FUSED_DTYPES x CASES x SEED_SETS, K1 with f32 and with bf16 moments
    (``MOMENT_DTYPES``): p, m, v and the norm (K2: p, codes, scales and
    the norm) bitwise equal to the plain version, two runs bitwise, the
    designs as ``check_designs`` holds them; phase 21 takes K1 at the
    dense configs' widths.  Returns the worst absolute error over the
    outputs (measured: 0 where it returns) and how many buckets took each
    design."""
    name = "K2" if q8 else "K1"
    lib = "gwt_adam_fused_q8" if q8 else "gwt_adam_fused"
    counter = ((lambda: (kernel.launches_q8_one_pass,
                         kernel.launches_q8_two_pass)) if q8 else
               (lambda: (kernel.launches_one_pass,
                         kernel.launches_two_pass)))
    outputs = ("p", "qm", "sm", "qv", "sv", "norm") if q8 \
        else ("p", "m", "v", "norm")
    taken = {"one": 0, "two": 0}
    step_size = torch.tensor(1e-3, device=dev)
    cases, err = 0, 0.0
    for label, shape, level, dtype, mdtype in fused_buckets(q8, shapes,
                                                            levels):
        L, m, n = shape
        salts = q8_salts(L, dev)
        usalts = [s.to(torch.uint32) for s in salts]
        moments = "int8 moments" if q8 else f"{mdtype} moments"
        one = kernel.one_pass_plan(lib, shape, dtype, level,
                                   mdtype)["grid"] > 0
        taken["one" if one else "two"] += 1
        for seed_set in SEED_SETS:
            for ci, (case, use_lim, prev, wd) in enumerate(CASES):
                sd = seed(ci, n, level, seed_set)
                pn = torch.full((L,), prev, device=dev)
                wd_coef = torch.tensor(wd, device=dev)
                kw = dict(level=level, gamma=1.01, use_limiter=use_lim,
                          weight_decay=wd != 0)
                if q8:
                    inputs = make_q8_inputs(shape, sd, dev, level, dtype)
                    kw["block"] = QBLOCK
                    want = ref.gwt_adam_fused_q8(
                        *inputs, *salts, pn, step_size, wd_coef, **kw)
                    args = lambda: (*(t.clone() for t in inputs), *usalts,
                                    pn, step_size, wd_coef)
                    entry = kernel.gwt_adam_fused_q8
                    entries = (kernel.gwt_adam_fused_q8_two_pass,
                               kernel.gwt_adam_fused_q8_one_pass)
                else:
                    inputs = make_inputs(shape, sd, dev, level, dtype,
                                         mdtype)
                    want = ref.gwt_adam_fused(*inputs, pn, step_size,
                                              wd_coef, **kw)
                    args = lambda: (*(t.clone() for t in inputs), pn,
                                    step_size, wd_coef)
                    entry = kernel.gwt_adam_fused
                    entries = (kernel.gwt_adam_fused_two_pass,
                               kernel.gwt_adam_fused_one_pass)
                before = counter()
                runs = [entry(*args(), **kw) for _ in range(2)]
                after = counter()
                two = entries[0](*args(), **kw)
                torch.cuda.synchronize()
                check_designs(kernel, name, label, shape, level, dtype,
                              runs, two, (after[0] - before[0],
                                          after[1] - before[1]), one)
                err = max(err, check_bands(
                    f"{name} {label} {shape} l={level} {dtype} {moments} / "
                    f"{case} / seed set {seed_set}", runs, want, outputs))
                if use_lim and prev == 1.0 and not torch.allclose(
                        runs[0][-1], torch.full_like(runs[0][-1], 1.01)):
                    raise AssertionError(
                        f"{name} {label}: clipping case did not clip "
                        f"({runs[0][-1].tolist()})")
                cases += 1
        if not one:
            refuses_one_pass(lambda: entries[1](*args(), **kw),
                             f"{name} {label} {shape} {dtype}")
        print(f"{name} {label} {shape} l={level} {dtype} {moments}: "
              f"{'one' if one else 'two'}-pass design, {len(CASES)} cases x "
              f"{len(SEED_SETS)} seed sets; {', '.join(outputs)} bitwise "
              f"equal to the plain version; two runs bitwise; "
              + ("bitwise equal to the two-pass kernel" if one else
                 "beyond one-pass capacity: the one-pass entry refuses it"))
    print(f"{name} vs plain: {cases} cases, {', '.join(outputs)} bitwise "
          f"(max |diff| {err}); buckets by design {taken}")
    return err, taken


def print_plans(kernel):
    """Phase 1: each one-pass kernel's registers, spill bytes and shared
    memory, and at the main path's buckets its blocks per SM, slots (chunk
    capacity) per block and grid."""
    for name in ("gwt_adam_fused", "gwt_adam_fused_q8"):
        for label, shape in MAIN_SHAPES + [FIRST_SHAPE]:
            for dtype in FUSED_DTYPES:
                plan = kernel.one_pass_plan(name, shape, dtype, LEVEL)
                print(f"one-pass plan {name} {shape} {dtype} l={LEVEL}: "
                      f"{plan['regs']} registers/thread, "
                      f"{plan['local_bytes']} B local (spills), "
                      f"{plan['static_smem']} B static shared, at most "
                      f"{plan['max_dyn_smem']} B dynamic shared per block, "
                      f"{plan['sms']} SMs; {plan['blocks_per_sm']} "
                      f"co-resident blocks/SM x {plan['slots']} chunk slots "
                      f"of {kernel.CHUNK * (1 << LEVEL) * dtype.itemsize} B "
                      f"= {plan['smem']} B per block, grid {plan['grid']}"
                      + ("" if plan["grid"] else " (two-pass: beyond "
                         "capacity)"))


# the leaves the staged path passes K4 at llama-60m, with their count per
# step (7 launches), and one odd shape
TILE_SHAPES = [("mixer wq/wk/wv/wo", (8, 512, 512), 4),
               ("ffn w_gate/w_up", (8, 512, 1376), 2),
               ("ffn w_down", (8, 1376, 512), 1)]
TILE_ODD = ("odd rows", (1, 37, 344), 0)
# (3, 101, 43 << l): 101 * 43 = 4343 coefficients per leaf at every level,
# odd, so the leaves after the first start unaligned; two whole chunks and
# a ragged third; 67 quantization blocks and a partial one of 55
TILE_ODD_NA = ("odd coefficients per leaf", 3, 101, 43)


def tile_inputs(shape, level, dtype, seed, dev):
    L, m, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = (torch.randn(L, m, n, generator=gen, device=dev) * 0.01).to(dtype)
    mm = torch.randn(L, m, n >> level, generator=gen, device=dev) * 1e-3
    vv = torch.rand(L, m, n >> level, generator=gen, device=dev) * 1e-6
    return g, mm, vv


def tile_q8_inputs(shape, level, dtype, seed, dev):
    """K4's inputs with the moments encoded by the port's codec, and the
    step's salts as K5 takes them."""
    from repro_torch.optim import codec
    g, mm, vv = tile_inputs(shape, level, dtype, seed, dev)
    L = shape[0]
    ids = torch.arange(L, device=dev)
    (qm, sm), (qv, sv) = (codec.quant_blocks(a.reshape(L, -1), ids + salt)
                          for a, salt in ((mm, 101), (vv, 202)))
    return (g, qm.reshape(mm.shape), sm, qv.reshape(vv.shape), sv), \
        q8_salts(L, dev)


def tile_cases():
    """Phase 13's (label, shape, level): the staged path's leaves, the odd
    rows and the odd coefficient counts, levels 1-3."""
    for level in (1, 2, 3):
        for label, shape, _ in TILE_SHAPES + [TILE_ODD]:
            yield label, shape, level
        label, L, m, a = TILE_ODD_NA
        yield label, (L, m, a << level), level


def check_tile(kernel, ref, dev):
    """Phase 13: K4 and K5 against their plain versions on the card at
    ``tile_cases()``, f32 and bf16 gradients, both seed sets, K4 with f32
    and with bf16 moments: G̃, m', v' (K5: G̃, codes, scales) and the ‖G̃‖²
    partials (``ref.chunk_ssq`` of the plain G̃) bitwise, two runs bitwise.
    Returns the number of cases K5 ran (K4 ran one per moment dtype) and
    the worst absolute error measured of K4 and of K5."""
    n, err = 0, {"K4": 0.0, "K5": 0.0}
    for label, shape, level in tile_cases():
        for dtype in (torch.float32, torch.bfloat16):
            for seed_set in SEED_SETS:
                sd = 17 * level + shape[-1] + (dtype == torch.bfloat16) \
                    + 1_000_003 * seed_set
                what = f"{label} {shape} l={level} {dtype} / seed set " \
                    f"{seed_set}"
                g, mm, vv = tile_inputs(shape, level, dtype, sd, dev)
                for mdtype in MOMENT_DTYPES:
                    m_in, v_in = mm.to(mdtype), vv.to(mdtype)
                    want = ref.gwt_adam_tile(g, m_in, v_in, level=level)
                    runs = [kernel.gwt_adam_tile(g, m_in, v_in, level=level)
                            for _ in range(2)]
                    torch.cuda.synchronize()
                    err["K4"] = max(err["K4"], check_bands(
                        f"K4 {what} {mdtype} moments", runs,
                        want[:3] + (ref.chunk_ssq(want[0], level),),
                        ("G̃", "m'", "v'", "partials")))
                args, salts = tile_q8_inputs(shape, level, dtype, sd, dev)
                kw = dict(level=level, block=QBLOCK)
                want = ref.gwt_adam_tile_q8(*args, *salts, **kw)
                usalts = [s.to(torch.uint32) for s in salts]
                runs = [kernel.gwt_adam_tile_q8(*args, *usalts, **kw)
                        for _ in range(2)]
                torch.cuda.synchronize()
                err["K5"] = max(err["K5"], check_bands(
                    f"K5 {what}", runs,
                    want[:5] + (ref.chunk_ssq(want[0], level),),
                    ("G̃", "qm'", "sm'", "qv'", "sv'", "partials")))
                n += 1
    print(f"K4/K5 vs plain: {n} cases each (K4 with f32 and with bf16 "
          f"moments in each), G̃, m', v' (K5: G̃, codes, scales) and the "
          f"‖G̃‖² partials bitwise, two runs bitwise (max |diff| {err})")
    return n, err


def synthetic(cfg, seq, batch, seed):
    """The launcher's synthetic source for ``cfg``: with ``seq // 4``
    frame embeddings a row for the encoder-decoder config."""
    from repro_torch.data.pipeline import make_source
    from repro_torch.models import encoder_frames
    return make_source("synthetic", cfg.vocab, seq, batch, seed=seed,
                       **encoder_frames(cfg, seq))


def small_training(dev, cfg, codecs, seq, steps, rtol):
    """``steps`` GWT-2 steps of ``cfg`` (batch 4 x ``seq``) under each
    state codec, from the same parameters and batches on the card and on
    the CPU; per-step losses within ``rtol``.  Returns the losses."""
    from repro_torch.core.gwt import gwt
    from repro_torch.models import module_for
    from repro_torch.optim.base import flatten_with_paths, unflatten
    from repro_torch.optim.schedules import warmup_cosine

    mod = module_for(cfg)
    model = mod.init(cfg, torch.Generator().manual_seed(0), "cpu")
    paths, leaves = flatten_with_paths(model.tree())
    data = synthetic(cfg, seq, 4, 0)
    result = {}
    for codec in codecs:
        losses = {}
        for device in ("cpu", "cuda"):
            tree = type(model)(cfg, unflatten(
                paths, [l.detach().to(device).clone()
                        for l in leaves])).tree()
            opt = gwt(warmup_cosine(0.01, steps), state_codec=codec)
            state = opt.init(tree)
            step = mod.make_train_step(cfg, opt)
            out = []
            for i in range(steps):
                b = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch(i).items()}
                tree, state, met = step(tree, state, b)
                out.append(met["loss"])
            losses[device] = torch.stack(out).cpu().numpy()
        print(f"smoke {cfg.name} {cfg.dtype} {codec} losses "
              f"cpu={losses['cpu'].tolist()} cuda={losses['cuda'].tolist()}")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=rtol)
        result[codec] = {d: l.tolist() for d, l in losses.items()}
    return result


def check_small_training(dev):
    """Phase 4: llama-60m-smoke, f32 and int8 state, same parameters and
    batches on the card and on the CPU; per-step losses within 1e-4
    relative."""
    from repro_torch import configs
    small_training(dev, configs.get_smoke("llama-60m"), ("f32", "int8"), 32,
                   4, 1e-4)


def time_ms(fn, iters):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(shape, esize=2, msize=4, psize=None):
    """Least time for one launch: bytes that must move (read g, p, m, v,
    prev_norm and the two scalars once; write p, m, v, new_norm once; g
    ``esize`` bytes an element, p ``psize`` (``esize`` where not given),
    the moments ``msize`` bytes each: 4 in f32, 2 in bf16) over HBM
    bandwidth, against the f32 operations over the f32 rate."""
    L, m, n = shape
    N, NA, B = L * m * n, L * m * (n >> LEVEL), 1 << LEVEL
    nbytes = 2 * N * (psize or esize) + N * esize + 4 * NA * msize \
        + 2 * L * 4 + 8
    # per coefficient: forward and inverse butterflies 2*(4B-4), Adam and
    # the preconditioner 11, detail scaling B-1; per element: round and
    # square-sum 2, limit 1, step and write 2
    ops = NA * (2 * (4 * B - 4) + 11 + (B - 1)) + N * 5
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def bound_q8(shape, esize=2, psize=None):
    """Least time for one K2 launch.  Bytes: read g (``esize`` bytes an
    element); read and write p (``psize``, ``esize`` where not given); read
    and write both moments' int8 codes and their f32 scales; read prev_norm,
    the salts and the two scalars, write new_norm.  Operations: K1's f32
    work plus dequantization (2) and requantization (~9 per moment) in f32,
    and the rounding hash (~10 int32 operations per moment), each type over
    its own rate."""
    L, m, n = shape
    N, NA, B = L * m * n, L * m * (n >> LEVEL), 1 << LEVEL
    nb = L * -(-(m * (n >> LEVEL)) // QBLOCK)
    nbytes = N * esize + 2 * N * (psize or esize) + 2 * 2 * NA \
        + 2 * 2 * nb * 4 + 4 * L * 4 + 8
    f32_ops = NA * (2 * (4 * B - 4) + 11 + (B - 1) + 2 + 2 * 9) + N * 5
    int_ops = NA * 2 * 10
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def time_fused(kernel, ref, dev, q8):
    """Phase 8: K1 (``q8``: K2) per launch at the main path's buckets, both
    designs in the same call: device time (CUDA events around each launch,
    L2 flushed before it; order one, two, two, one), time per call back to
    back (host included), the plain version's, the bound.  Returns one row
    per bucket."""
    rows = []
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    name = "K2" if q8 else "K1"
    for label, shape in MAIN_SHAPES:
        L = shape[0]
        pn = torch.full((L,), 1e9, device=dev)
        ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0,
                                                              device=dev)
        kw = dict(level=LEVEL, gamma=1.01, use_limiter=True,
                  weight_decay=False)
        if q8:
            inputs = make_q8_inputs(shape, 7, dev)
            salts = q8_salts(L, dev)
            args = (*inputs, *(s.to(torch.uint32) for s in salts), pn, ss,
                    wd)
            kw["block"] = QBLOCK
            plain = lambda: ref.gwt_adam_fused_q8(
                *inputs, *salts, pn, ss, wd, **kw)
            entry = {"one": kernel.gwt_adam_fused_q8_one_pass,
                     "two": kernel.gwt_adam_fused_q8_two_pass}
            counter = {"one": lambda: kernel.launches_q8_one_pass,
                       "two": lambda: kernel.launches_q8_two_pass}
            b_ms, b_by, nbytes = bound_q8(shape)
        else:
            g, p, mm, vv = make_inputs(shape, 7, dev)
            args = (g, p, mm, vv, pn, ss, wd)
            plain = lambda: ref.gwt_adam_fused(g, p, mm, vv, pn, ss, wd,
                                               **kw)
            entry = {"one": kernel.gwt_adam_fused_one_pass,
                     "two": kernel.gwt_adam_fused_two_pass}
            counter = {"one": lambda: kernel.launches_one_pass,
                       "two": lambda: kernel.launches_two_pass}
            b_ms, b_by, nbytes = bound(shape)
            # the same bucket with bf16 moments (gwt(state_dtype=bf16)),
            # one pass, in turns with the f32 moments' one pass below
            args16 = (g, p, mm.to(torch.bfloat16), vv.to(torch.bfloat16),
                      pn, ss, wd)
            entry["bf16"] = kernel.gwt_adam_fused_one_pass
            counter["bf16"] = counter["one"]
        call = {d: (lambda d=d: entry[d](*(args16 if d == "bf16" else args),
                                         **kw)) for d in entry}
        t_plain = [time_ms(plain, 5)]
        order = ("one", "two", "two", "one") if q8 else \
            ("one", "two", "bf16", "bf16", "two", "one")
        t_dev = {d: [] for d in entry}
        for d in order:
            t_dev[d].append(device_ms(call[d], 20, counter[d], flush))
        t_call = {d: [time_ms(call[d], 50)] for d in entry}
        t_plain.append(time_ms(plain, 5))
        row = {"bucket": label, "shape": list(shape), "per_step": 1,
               "ms": min(t_dev["one"]), "two_pass_ms": min(t_dev["two"]),
               "call_ms": min(t_call["one"]),
               "two_pass_call_ms": min(t_call["two"]),
               "plain_ms": min(t_plain), "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes}
        if not q8:
            b16_ms, b16_by, n16 = bound(shape, msize=2)
            row["bf16_moments"] = {
                "ms": min(t_dev["bf16"]), "call_ms": min(t_call["bf16"]),
                "bound_ms": b16_ms, "bound_by": b16_by, "bytes": n16}
            print(f"{name} time {label} {shape} bf16 moments: one pass "
                  f"{row['bf16_moments']['ms']:.4f} ms on the device (runs "
                  f"{t_dev['bf16']}, {b16_ms / row['bf16_moments']['ms']:.1%}"
                  f" of bound {b16_ms:.4f} ms, {n16 / 1e6:.2f} MB); per call "
                  f"{row['bf16_moments']['call_ms']:.4f} ms")
        print(f"{name} time {label} {shape}: one pass {row['ms']:.4f} ms on "
              f"the device (runs {t_dev['one']}, {b_ms / row['ms']:.1%} of "
              f"bound), two passes {row['two_pass_ms']:.4f} ms (runs "
              f"{t_dev['two']}, {b_ms / row['two_pass_ms']:.1%}); per call "
              f"back to back {row['call_ms']:.4f} / "
              f"{row['two_pass_call_ms']:.4f} ms; plain "
              f"{row['plain_ms']:.4f} ms (runs {t_plain}); bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB)")
        rows.append(row)
    return rows


def time_generic_wrap(dev, shape=(1, 32000, 512)):
    """The int8 path runs plain Adam on the embedding (llama-60m's 32000 x
    512; qwen2.5-3b's 151936 x 2048) through the engine's generic decode
    -> update -> encode: time the decode and the encode (with the rounding
    hash) of its two moments, per step."""
    from repro_torch.optim import codec
    gen = torch.Generator(device=dev).manual_seed(3)
    moments = [torch.randn(shape, generator=gen, device=dev) * 1e-3,
               torch.rand(shape, generator=gen, device=dev) * 1e-6]
    key = codec.make_key(0, dev)
    step = torch.tensor(5, dtype=torch.int32, device=dev)
    cdc = codec.get_codec("int8")
    enc = [cdc.encode(x, codec.slot_salt(key, step, i, 0))
           for i, x in enumerate(moments)]

    def decode():
        for e in enc:
            cdc.decode(e)

    def encode():
        for i, x in enumerate(moments):
            cdc.encode(x, codec.slot_salt(key, step, i, 0))

    t_dec = min(time_ms(decode, 5), time_ms(decode, 5))
    t_enc = min(time_ms(encode, 5), time_ms(encode, 5))
    print(f"generic int8 wrap of the embedding's m and v (2 x "
          f"{math.prod(shape) / 1e6:.1f} M): decode {t_dec:.3f} ms, encode "
          f"{t_enc:.3f} ms per step")
    return t_dec, t_enc


def profile_step(dev, codec, steps=4, dp_reduce=None, fused_write=True,
                 arch="llama-60m", batch=16, seq=256, cfg=None,
                 trace_ops=True):
    """Phase 9 (and 22 for qwen2.5-3b): where a full-width step's time
    goes.  First without the profiler: step time and
    ``optimizer.update``'s share (CUDA events around it).  Then under
    ``torch.profiler``: device kernel time per step (kernel durations; the
    profiler slows the host, not the kernels), launches per step, K1's
    kernels' share, and the ops that take the most device time.  ``cfg``
    (default ``configs.get_config(arch)``) may be a cut of it.
    ``trace_ops=False`` traces the device alone (the kernels that take the most time in place
    of the ops: tens of thousands of launches a step trace in a fraction
    of the time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core.gwt import gwt
    from repro_torch.models import module_for
    from repro_torch.optim.schedules import warmup_cosine

    cfg = cfg or configs.get_config(arch)
    mod = module_for(cfg)
    tree = mod.init(cfg, torch.Generator(device=dev).manual_seed(1),
                    dev).tree()
    opt = gwt(warmup_cosine(0.01, 100), state_codec=codec,
              fused_write=fused_write)
    state = opt.init(tree)
    marks = []

    def timed_update(grads, st, params):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = opt.update(grads, st, params)
        b.record()
        marks.append((a, b))
        return out

    step = mod.make_train_step(cfg, opt._replace(update=timed_update),
                               dp_reduce=dp_reduce)
    data = synthetic(cfg, seq, batch, 1)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}
               for i in range(2 * steps + 2)]

    def run(bs):
        nonlocal tree, state
        marks.clear()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for b in bs:
            tree, state, _ = step(tree, state, b)
        stop.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(stop) / len(bs),
                sum(a.elapsed_time(b) for a, b in marks) / len(bs))

    run(batches[:2])
    step_ms, opt_ms = run(batches[2:2 + steps])
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if trace_ops
                                      else [])
    with profile(activities=acts) as prof:
        prof_step_ms, _ = run(batches[2 + steps:])
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = [e.time_range.elapsed_us() for e in kernels]
    busy_ms = sum(kernel_us) / 1e3 / steps
    # K1's kernels: the one-pass design and the two-pass norm and write
    # passes of gwt_adam_fused.cu (K2's share the names; f32 runs no K2)
    k1_ms = sum(e.time_range.elapsed_us() for e in kernels
                if any(k in e.name for k in K1_KERNEL_NAMES)) / 1e3 / steps
    print(f"profile {arch} {codec} dp_reduce={dp_reduce} fused_write="
          f"{fused_write}: step {step_ms:.2f} ms, "
          f"optimizer.update {opt_ms:.2f} ms, rest of the step (data to model grads) "
          f"{step_ms - opt_ms:.2f} ms; device kernels {busy_ms:.2f} ms/step "
          f"= {busy_ms / step_ms:.1%} of the unprofiled step "
          f"({1 - busy_ms / step_ms:.1%} idle); {len(kernel_us) // steps} "
          f"kernel launches/step; step under the profiler "
          f"{prof_step_ms:.2f} ms; GWT kernels {k1_ms:.3f} ms/step "
          f"= {k1_ms / busy_ms:.2%} of device time")
    if trace_ops:
        dev_time = lambda e: getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0))
        top = [(dev_time(e), e.count, e.key) for e in prof.key_averages()]
    else:
        by_name = {}
        for e in kernels:
            t, n = by_name.get(e.name, (0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        top = [(t, n, name) for name, (t, n) in by_name.items()]
    for t, n, key in sorted(top, key=lambda r: -r[0])[:10]:
        print(f"  {t / 1e3 / steps:8.3f} ms/step device "
              f"{n // steps:5d} calls/step  {key[:70]}")
    return {"step_ms": step_ms, "update_ms": opt_ms,
            "device_busy_ms": busy_ms, "gwt_kernel_ms": k1_ms,
            "launches_per_step": len(kernel_us) // steps}


def reset_counts(kernel, hk):
    kernel.launches = kernel.launches_q8 = 0
    kernel.launches_one_pass = kernel.launches_two_pass = 0
    kernel.launches_q8_one_pass = kernel.launches_q8_two_pass = 0
    kernel.launches_group = kernel.buckets_group = 0
    kernel.launches_q8_group = kernel.buckets_q8_group = 0
    kernel.launches_tile = kernel.launches_tile_q8 = 0
    hk.launches_fwd = hk.launches_fwd_q = hk.launches_inv = 0
    hk.leaves_fwd = hk.leaves_fwd_q = 0


def all_counts(kernel, hk):
    """Every wrapper's launch count; K1 and K2 also by design and their
    grouped launches (of two or more buckets, as the engine makes them)
    with the buckets those covered, K3 and K6 also the leaves their grouped
    launches covered."""
    return {"K1": kernel.launches, "K2": kernel.launches_q8,
            "K1 one-pass": kernel.launches_one_pass,
            "K1 two-pass": kernel.launches_two_pass,
            "K2 one-pass": kernel.launches_q8_one_pass,
            "K2 two-pass": kernel.launches_q8_two_pass,
            "K1 group": kernel.launches_group,
            "K1 group buckets": kernel.buckets_group,
            "K2 group": kernel.launches_q8_group,
            "K2 group buckets": kernel.buckets_q8_group,
            "K3": hk.launches_fwd_q, "K4": kernel.launches_tile,
            "K5": kernel.launches_tile_q8, "K6": hk.launches_fwd,
            "K7": hk.launches_inv, "K3 leaves": hk.leaves_fwd_q,
            "K6 leaves": hk.leaves_fwd}


def fused_counts(k1=0, k2=0):
    """K1's and K2's counters when every bucket took the one-pass design
    alone (no grouped launch: llama-60m's three buckets, in plan order,
    never fit one launch two together)."""
    return {"K1": k1, "K2": k2, "K1 one-pass": k1, "K1 two-pass": 0,
            "K2 one-pass": k2, "K2 two-pass": 0, "K1 group": 0,
            "K1 group buckets": 0, "K2 group": 0, "K2 group buckets": 0}


def run_main_path(train, kernel, hk, codec, extra=()):
    """Phases 5 and 6: the launcher at full width, launch counts set to 0
    just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel, hk)
    t0 = time.perf_counter()
    res = train.main(MAIN_ARGS + ["--state-codec", codec, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated()
    logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
    print(f"main path {codec}: {STEPS} steps in {wall:.2f} s; logged losses "
          f"{logged}; launches {counts}; step {res.step_ms:.2f} ms; "
          f"{16 * 256 / (res.step_ms / 1e3):.0f} tokens/s; peak memory "
          f"{peak / 2**20:.1f} MiB")
    mine = "K1" if codec == "f32" else "K2"
    want = {k: 0 for k in counts}
    want.update(fused_counts(**{mine.lower(): 3 * STEPS}))
    if counts != want:
        raise AssertionError(f"{codec} path launched {counts} in {STEPS} "
                             f"steps, want {want}")
    if not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"non-finite losses {res.losses}")
    if not logged[-1] < logged[0]:
        raise AssertionError(f"loss did not fall: {logged}")
    from repro_torch.optim.base import flatten_with_paths
    for name, t in zip(*flatten_with_paths(res.params)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite parameter {name}")
    return res, counts[mine], peak


def assert_bitwise(a, b, what):
    from repro_torch.optim.base import flatten_with_paths
    pa, la = flatten_with_paths(a)
    pb, lb = flatten_with_paths(b)
    if pa != pb:
        raise AssertionError(f"{what}: different leaves")
    for path, x, y in zip(pa, la, lb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: {path} differs")


def check_resume(train, straight):
    """Phase 7: 20 int8 steps checkpointing at 10, then a fresh run resumed
    from step 10, against phase 6's 20 straight steps, bitwise."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = ["--state-codec", "int8", "--ckpt-dir", tmp,
                "--ckpt-every", "10"]
        first = train.main(MAIN_ARGS + ckpt)
        assert_bitwise(first.params, straight.params, "checkpointed run")
        shutil.rmtree(os.path.join(tmp, f"step_{STEPS:09d}"))
        resumed = train.main(MAIN_ARGS + ckpt + ["--resume"])
        if resumed.start_step != 10 or \
                first.losses[10:] != resumed.losses:
            raise AssertionError(f"resume from {resumed.start_step}: losses "
                                 f"{resumed.losses} vs {first.losses[10:]}")
        assert_bitwise(resumed.params, straight.params, "resumed params")
        assert_bitwise(resumed.opt_state, straight.opt_state,
                       "resumed optimizer state")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"resume: 10 steps + checkpoint + resume + 10 steps == {STEPS} "
          f"straight steps, bitwise (params, codes, scales, norms)")


def raw_bits(t):
    """A tensor's bit pattern as an integer tensor of its item size."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def haar_input(shape, seed, dev, scale, edges):
    """f32 gradient-like input.  With ``edges`` row 0 carries values past
    the fp8 range and +-inf, each in its own level-3 group of 8 columns, so
    no butterfly meets inf - inf."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(*shape, generator=gen, device=dev) * scale
    if not edges:
        return g
    cols = [0, 8, 16, 24, 32, 40, 48, 56][:shape[1] // 8]
    edge = [464.0, 465.0, -465.0, 1e30, math.inf, 480.0, -1000.0, -math.inf]
    g[0, cols] = torch.tensor(edge[:len(cols)], device=dev)
    return g


def abs_err(a, b) -> float:
    """The largest |a - b| over the elements (f64, NaN against NaN 0), in
    pieces so that a whole bucket needs no f64 copy of itself."""
    a, b = a.reshape(-1), b.reshape(-1)
    worst, step = 0.0, 1 << 26
    for i in range(0, a.numel(), step):
        d = (a[i:i + step].double() - b[i:i + step].double()).abs()
        worst = max(worst, torch.nan_to_num(d, nan=0.0).max().item())
    return worst


def check_bands(what, got_runs, want, names=None):
    """A kernel's outputs (bands, moments, norms, ...; ``names``, else
    numbered) against the plain version's: bitwise (NaN codes included),
    and the two kernel runs bitwise.  Returns the largest absolute error
    measured against the plain version (0 where it returns)."""
    for a, b in zip(*got_runs):
        if not torch.equal(raw_bits(a), raw_bits(b)):
            raise AssertionError(f"{what}: two kernel runs differ")
    names = names or [f"band {i}" for i in range(len(want))]
    if len(got_runs[0]) != len(want) or len(names) != len(want):
        raise AssertionError(f"{what}: {len(got_runs[0])} outputs, plain "
                             f"{len(want)}")
    for name, a, b in zip(names, got_runs[0], want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what} {name}: {a.dtype} {a.shape} vs "
                                 f"plain {b.dtype} {b.shape}")
        differ = int((raw_bits(a) != raw_bits(b)).sum())
        if differ:
            raise AssertionError(f"{what} {name}: {differ} of {a.numel()} "
                                 f"elements differ from the plain version "
                                 f"(max |diff| {abs_err(a, b):.3g})")
    return max((abs_err(a, b) for a, b in zip(got_runs[0], want)),
               default=0.0)


def check_fp8_rule(hk, dev):
    """The plain fp8 cast gives the JAX package's codes on the edge values,
    and K3's fp8 details equal it on a dense sweep across the 448/464
    boundary, NaN and +-inf."""
    from repro_torch.kernels.haar_dwt import ref as href
    vals = torch.tensor([v for v, _ in FP8_EDGES], device=dev)
    codes = href.to_wire(vals, torch.float8_e4m3fn).view(torch.uint8)
    want = [c for _, c in FP8_EDGES]
    if codes.tolist() != want:
        raise AssertionError(f"plain fp8 codes {codes.tolist()} != JAX's "
                             f"{want}")
    # level 1 on pairs (e, 0): D_1 = e * f32(1/sqrt 2) sweeps 424..495
    e = torch.linspace(600.0, 700.0, 4094, device=dev)
    e = torch.cat([e, torch.tensor([math.nan, math.inf], device=dev)])
    g = torch.stack([e, torch.zeros_like(e)], -1).reshape(2, -1)
    g = torch.cat([g, -g])
    got = hk.haar_dwt_fwd_q(g, 1, torch.float8_e4m3fn)
    check_bands("K3 fp8 sweep", [got, got],
                href.haar_dwt_fwd_q(g, 1, torch.float8_e4m3fn))
    nan = int((got[1].view(torch.uint8) & 0x7F == 0x7F).sum())
    print(f"fp8 rule: edge codes = JAX's {[hex(c) for c in want]}; K3 sweep "
          f"across 448/464 bitwise with the plain cast ({nan} NaN codes of "
          f"{got[1].numel()})")


def check_haar(hk, dev):
    """Phase 10: K3, K6, K7 against their plain versions, bitwise.  Returns
    the worst absolute error measured (0: any difference raises)."""
    from repro_torch.kernels.haar_dwt import ref as href
    check_fp8_rule(hk, dev)
    wires = (torch.bfloat16, torch.float16, torch.float8_e4m3fn)
    n_checks, err = 0, 0.0
    for shape in [s for s, _ in DP_SHAPES] + [ODD_SHAPE]:
        for level in (1, 2, 3):
            for wire in wires:
                scale = 200.0 if wire == torch.float8_e4m3fn else 1.0
                g = haar_input(shape, level + shape[0], dev, scale, True)
                want = href.haar_dwt_fwd_q(g, level, wire)
                runs = [hk.haar_dwt_fwd_q(g, level, wire) for _ in range(2)]
                err = max(err, check_bands(f"K3 {shape} l={level} {wire}",
                                           runs, want))
                n_checks += 1
            for dtype in (torch.float32, torch.bfloat16):
                g = haar_input(shape, 7 + level, dev, 1.0, False).to(dtype)
                want = href.haar_dwt_fwd(g, level)
                runs = [hk.haar_dwt_fwd(g, level) for _ in range(2)]
                err = max(err, check_bands(f"K6 {shape} l={level} {dtype}",
                                           runs, want))
                bands = runs[0]
                want = [href.haar_dwt_inv(bands[0], bands[1:])]
                runs = [[hk.haar_dwt_inv(bands[0], bands[1:])]
                        for _ in range(2)]
                err = max(err, check_bands(f"K7 {shape} l={level} {dtype}",
                                           runs, want))
                n_checks += 2
    torch.cuda.synchronize()
    print(f"K3/K6/K7 vs plain: {n_checks} cases bitwise (every band, NaN "
          f"codes included), two runs bitwise")
    check_haar_groups(hk, dev)
    return err


def unaligned(x):
    """A contiguous copy of ``x`` one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    return buf[1:].view(x.shape)


def group_cases(level):
    """(label, leaf shapes, indices of the leaves given unaligned) of phase
    10's grouped checks at ``level``: the data-parallel group; a mixed group
    with the odd-row shape, a leaf with an odd coefficient count (101 x 43,
    whose last tile is partial) given twice, once unaligned, and the
    smallest DP leaf; and 40 leaves, more than one launch takes."""
    dp = [shape for shape, count in DP_SHAPES for _ in range(count)]
    odd = (101, 43 << level)
    mixed = [ODD_SHAPE, odd, odd, (8, 512)]
    many = [(1 + i % 5, 8 * (3 + i % 11)) for i in range(40)]
    return [("DP group", dp, ()), ("mixed", mixed, (2,)),
            ("40 leaves", many, tuple(range(3, 40, 4)))]


def check_haar_groups(hk, dev):
    """Phase 10, grouped: K3 (bf16, f16, fp8 details) and K6 (bf16, f32)
    over each of ``group_cases`` at levels 1-3, every band of every leaf
    bitwise to the per-leaf plain version (the fp8 inputs reach past 464
    and +-inf), two runs bitwise, and the launch and leaf counters risen by
    the group's launches and leaves."""
    from repro_torch.kernels.haar_dwt import ref as href
    kinds = [("K3", torch.bfloat16), ("K3", torch.float16),
             ("K3", torch.float8_e4m3fn), ("K6", torch.bfloat16),
             ("K6", torch.float32)]
    for name, codes in [("K3 bf16", (0, 0, 1)), ("K3 fp8", (0, 0, 3)),
                        ("K6 bf16", (1, 1, 1)), ("K6 f32", (0, 0, 0))]:
        print(f"{name} grouped plan at level {LEVEL}: "
              f"{hk.fwd_plan(codes, LEVEL, dev)}")
    n_checks = 0
    for level in (1, 2, 3):
        cap = hk.fwd_plan((0, 0, 1), level, dev)["group_leaves"]
        for label, shapes, odd in group_cases(level):
            launches = -(-len(shapes) // cap)
            for name, kind in kinds:
                k3 = name == "K3"
                fp8 = kind == torch.float8_e4m3fn
                gs = [haar_input(shape, 31 * i + level, dev,
                                 200.0 if fp8 else 1.0, k3)
                      for i, shape in enumerate(shapes)]
                if not k3:
                    gs = [g.to(kind) for g in gs]
                gs = [unaligned(g) if i in odd else g
                      for i, g in enumerate(gs)]
                before = (hk.launches_fwd_q, hk.leaves_fwd_q,
                          hk.launches_fwd, hk.leaves_fwd)
                if k3:
                    runs = [hk.haar_dwt_fwd_q_group(gs, level, kind)
                            for _ in range(2)]
                    wants = [href.haar_dwt_fwd_q(g, level, kind) for g in gs]
                    rise = (2 * launches, 2 * len(gs), 0, 0)
                else:
                    runs = [hk.haar_dwt_fwd_group(gs, level)
                            for _ in range(2)]
                    wants = [href.haar_dwt_fwd(g, level) for g in gs]
                    rise = (0, 0, 2 * launches, 2 * len(gs))
                after = (hk.launches_fwd_q, hk.leaves_fwd_q,
                         hk.launches_fwd, hk.leaves_fwd)
                if tuple(a - b for a, b in zip(after, before)) != rise:
                    raise AssertionError(f"grouped {label}: counters rose "
                                         f"{before} -> {after}, want {rise}")
                for i, want in enumerate(wants):
                    check_bands(f"{name} group {label} leaf {i} "
                                f"{tuple(gs[i].shape)} l={level} {kind}",
                                [runs[0][i], runs[1][i]], want)
                n_checks += 1
    torch.cuda.synchronize()
    print(f"K3/K6 grouped vs per-leaf plain: {n_checks} groups bitwise "
          f"(10 DP leaves, mixed odd rows / odd coefficient count / "
          f"unaligned base, 40 leaves in {-(-40 // cap)} launches; "
          f"levels 1-3; K3 bf16/f16/fp8, K6 bf16/f32), two runs "
          f"bitwise, launch and leaf counters exact")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def one_rank_env():
    """Inside, ``launch.mesh.init_dp`` joins a one-rank NCCL group."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_dp_path(train, kernel, hk, extra, steps):
    """Phase 11: the launcher with --dp-reduce under a one-rank NCCL
    process group; launch counts set to 0 just before and read just
    after: K3 once a step for all 10 compressible leaves."""
    args = [a if a != str(STEPS) else str(steps) for a in MAIN_ARGS]
    with one_rank_env():
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernel, hk)
        t0 = time.perf_counter()
        res = train.main(args + ["--dp-reduce", "compressed", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts(kernel, hk)
        peak = torch.cuda.max_memory_allocated()
    ef = "--dp-error-feedback" in extra
    want = {k: 0 for k in counts}
    want.update(fused_counts(k1=3 * steps), K3=steps,
                K7=(20 if ef else 10) * steps)
    want["K3 leaves"] = 10 * steps
    logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
    print(f"dp path {extra}: {steps} steps in {wall:.2f} s; logged losses "
          f"{logged}; launches {counts}; step {res.step_ms:.2f} ms; wire "
          f"bytes {res.wire_bytes}; peak memory {peak / 2**20:.1f} MiB")
    if counts != want:
        raise AssertionError(f"dp path launched {counts}, want {want}")
    if not np.all(np.isfinite(res.losses)) or not logged[-1] < logged[0]:
        raise AssertionError(f"dp path losses {res.losses}")
    if not extra and res.wire_bytes != (WIRE_BF16, WIRE_EXACT):
        raise AssertionError(f"wire bytes {res.wire_bytes}, the JAX package "
                             f"counts {(WIRE_BF16, WIRE_EXACT)}")
    from repro_torch.optim.base import flatten_with_paths
    for name, t in zip(*flatten_with_paths(res.params)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite parameter {name}")
    return res, counts, peak


def check_grouped_reduction(hk, dev):
    """Phase 11: one reduction of a full-width llama-60m gradient (seed 0
    parameters, the launcher's first batch) over a one-rank NCCL group,
    grouped (``compressed_means``: one K3 launch) and leaf by leaf
    (``compressed_mean``: one K3 launch a leaf): the means bitwise equal,
    with bf16 details and with fp8 details and error feedback (residues
    too).  Prints each one's peak ``max_memory_allocated`` above what the
    gradients and earlier phases hold; returns them."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import compression as C
    from repro_torch.launch.mesh import init_dp
    from repro_torch.models import lm
    from repro_torch.optim.base import flatten_with_paths

    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticLM(cfg.vocab, 256, 16, seed=0).batch(0).items()}
    leaves = flatten_with_paths(params)[1]
    grads, _ = lm._accumulate(cfg, params, leaves,
                              lm.contiguous_microbatches(batch, 1), 1)
    del params, leaves, batch
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = [torch.randn(g.shape, generator=gen, device=dev) * 1e-4
            for g in grads]
    fp8 = torch.float8_e4m3fn
    ways = {
        "bf16": (lambda: C.compressed_means(grads, dp, 2, torch.bfloat16),
                 lambda: [C.compressed_mean(g, dp, 2, torch.bfloat16)
                          for g in grads]),
        "fp8+ef": (lambda: C.compressed_means_ef(grads, errs, dp, 2, fp8),
                   lambda: tuple(map(list, zip(*[
                       C.compressed_mean_ef(g, e, dp, 2, fp8)
                       for g, e in zip(grads, errs)])))),
    }
    peaks = {}
    with one_rank_env():
        dp = init_dp(dev)
        try:
            for label, (grouped, per_leaf) in ways.items():
                got = {}
                for way, fn in (("grouped", grouped), ("per leaf", per_leaf)):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    before = hk.launches_fwd_q
                    got[way] = fn()
                    torch.cuda.synchronize()
                    peaks[f"{label} {way}"] = (
                        torch.cuda.max_memory_allocated() - base) / 2**20
                    want = 1 if way == "grouped" else 10
                    if hk.launches_fwd_q - before != want:
                        raise AssertionError(
                            f"{label} {way}: {hk.launches_fwd_q - before} "
                            f"K3 launches, want {want}")
                flat = lambda x: x if label == "bf16" else x[0] + x[1]
                for i, (a, b) in enumerate(zip(flat(got["grouped"]),
                                               flat(got["per leaf"]))):
                    if not torch.equal(raw_bits(a), raw_bits(b)):
                        raise AssertionError(f"{label}: grouped and per-leaf "
                                             f"reductions differ at {i}")
                del got
        finally:
            dp.close()
    print(f"grouped DP reduction == per-leaf reduction, bitwise, at full "
          f"width (bf16 means; fp8 means and residues with error "
          f"feedback); peak MiB above the gradients: "
          + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items()))
    return peaks


def bound_haar(kind, shape, level=LEVEL, wire_bytes=2):
    """Least time for one launch at ``shape``: bytes over HBM bandwidth
    (each input read once, each output written once) against the
    butterflies' f32 operations (2 per element of each level's input)."""
    m, n = shape
    N = m * n
    if kind == "K3":      # f32 in, A_l f32, details in the wire dtype
        nbytes = 4 * N + 4 * (N >> level) + wire_bytes * (N - (N >> level))
    elif kind == "K6":    # bf16 in, bands in bf16
        nbytes = 2 * N + 2 * N
    else:                 # K7: f32 bands in, f32 out
        nbytes = 4 * N + 4 * N
    ops = sum(2 * (N >> k) for k in range(level))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def device_ms(fn, iters, launches, flush):
    """Device time per call of ``fn``, one kernel launch, from CUDA events
    recorded just before and just after each of ``iters`` calls.  Before
    each call ``flush`` (a tensor larger than the 50 MB L2 cache) is
    overwritten, so the call reads its inputs from device memory, as the
    step's first touch of a gradient does; then the card spins for
    ``SPIN_CYCLES``, so the call's launch is queued behind the start event
    before that event fires and the span between the events holds the
    kernel's device time and none of the host's.  ``launches()`` reads the
    wrapper's launch counter: it must rise by exactly ``iters`` (None: a
    library call, not counted)."""
    fn()
    torch.cuda.synchronize()
    spans = []
    before = launches and launches()
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        fn()
        stop.record()
        spans.append((start, stop))
    torch.cuda.synchronize()
    if launches is not None and launches() - before != iters:
        raise AssertionError(f"{launches() - before} kernel launches in "
                             f"{iters} timed calls")
    return sum(a.elapsed_time(b) for a, b in spans) / iters


class ParentHaar:
    """The parent revision's K3, K6 and K7 (``haar_dwt@parent``, one leaf
    a launch), called through that revision's C interface, with its own
    launch counter."""

    def __init__(self, build, hk):
        import ctypes
        self.ctypes, self.hk, self.launches = ctypes, hk, 0
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

        def declare(lib):
            for fn in (lib.haar_dwt_fwd, lib.haar_dwt_fwd_q,
                       lib.haar_dwt_inv):
                fn.argtypes = [i, i, vp, vp, vp, ll, i, vp]
                fn.restype = i
        self.lib = build.load(PARENT_HAAR, declare)

    def _call(self, fn, *args):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"parent {fn.__name__}: CUDA error {err}")
        self.launches += 1

    def _ptrs(self, ts):
        return (self.ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    def _fwd(self, fn, code, g, level, a_dtype, d_dtype):
        m, n = g.shape
        out = [torch.empty((m, n >> level), dtype=a_dtype, device=g.device)]
        out += [torch.empty((m, n >> k), dtype=d_dtype, device=g.device)
                for k in range(level, 0, -1)]
        self._call(fn, code, level, g.data_ptr(), out[0].data_ptr(),
                   self._ptrs(out[1:]), out[0].numel(),
                   int(g.data_ptr() % 16 == 0))
        return tuple(out)

    def fwd_q(self, g, level, wire):
        return self._fwd(self.lib.haar_dwt_fwd_q, self.hk._WIRE[wire], g,
                         level, torch.float32, wire)

    def fwd(self, g, level):
        return self._fwd(self.lib.haar_dwt_fwd, self.hk._IN[g.dtype], g,
                         level, g.dtype, g.dtype)

    def inv(self, a, ds):
        m, na = a.shape
        out = torch.empty((m, na << len(ds)), dtype=a.dtype, device=a.device)
        self._call(self.lib.haar_dwt_inv, self.hk._IN[a.dtype], len(ds),
                   a.data_ptr(), self._ptrs(ds), out.data_ptr(), a.numel(),
                   int(all(t.data_ptr() % 16 == 0 for t in (a, *ds))))
        return out


def dp_leaves(dev, dtype=torch.float32, seed=0):
    """The 10 compressible leaves of llama-60m as the reduction hands them
    to K3 (``DP_SHAPES``, each as often as a step has it), random
    normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*shape, generator=gen, device=dev).to(dtype)
            for shape, count in DP_SHAPES for _ in range(count)]


def host_us(fn, calls=100):
    """Host time per call of ``fn`` (the wrapper's Python, checks, ctypes
    call and launch), the card left to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def library_turn(kind, x, plain, dtype, flush):
    """The one PyTorch call that computes K6's or K7's function: a
    ``torch.matmul`` with the packed orthonormal Haar matrix of
    ``core.haar_matrix`` (``G @ H`` is the packed ``[A_l | D_l ... D_1]``,
    so K7 is ``packed @ H.T``), in the kernel's dtype (f32 with TF32 off,
    bf16 for bf16).  Its device time (as :func:`device_ms`, L2 flushed)
    and its largest difference from the plain version's bands."""
    from repro_torch.core import haar
    if kind == "K6":
        h = haar.haar_matrix(x.shape[-1], LEVEL, dtype).to(x.device)
        call = lambda: torch.matmul(x, h)
        want = torch.cat(plain(x), -1)
    else:
        packed = torch.cat(x, -1)
        h = haar.haar_matrix(packed.shape[-1], LEVEL, dtype).to(
            packed.device).T.contiguous()
        call = lambda: torch.matmul(packed, h)
        want = plain(x)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        err = float((call().float() - want.float()).abs().max())
        ms = min(device_ms(call, 20, None, flush) for _ in range(2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"library_ms": ms, "library_max_abs_err": err}


def time_haar(hk, dev, parent):
    """Phase 12 at level 2: per launch at each leaf shape, the kernel's
    device time (CUDA events around each launch, L2 flushed before it; the
    parent revision's K3, K6 and K7 in turns with the built ones, built,
    parent, parent, built, when ``parent``), its time per call back to
    back (CUDA events: the host's wrapper time when the host is slower than
    the card, and inputs warm in L2 when they fit), the plain version's,
    the bound; one step's worth is the count-weighted sum.  Then K3 (bf16
    and fp8 details) and K6 (bf16) over the whole DP group as one grouped
    launch: device time, time per call, the wrapper's host time per call
    against ten single-leaf calls', the plain versions' and the bound (the
    sum over the leaves).  Returns ``(rows, groups)``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.haar_dwt import ref as href
    old = ParentHaar(build, hk) if parent else None
    fp8 = torch.float8_e4m3fn
    # name: (kernel, parent's, plain, input dtype, kind, wire bytes, counter)
    q = lambda w: (lambda g: hk.haar_dwt_fwd_q(g, LEVEL, w),
                   old and (lambda g: old.fwd_q(g, LEVEL, w)),
                   lambda g: href.haar_dwt_fwd_q(g, LEVEL, w),
                   torch.float32, "K3", w.itemsize,
                   lambda: hk.launches_fwd_q)
    cases = {
        "K3 bf16": q(torch.bfloat16),
        "K3 fp8": q(fp8),
        "K6 bf16": (lambda g: hk.haar_dwt_fwd(g, LEVEL),
                    old and (lambda g: old.fwd(g, LEVEL)),
                    lambda g: href.haar_dwt_fwd(g, LEVEL),
                    torch.bfloat16, "K6", 2, lambda: hk.launches_fwd),
        "K7 f32": (lambda b: hk.haar_dwt_inv(b[0], b[1:]),
                   old and (lambda b: old.inv(b[0], b[1:])),
                   lambda b: href.haar_dwt_inv(b[0], b[1:]),
                   torch.float32, "K7", 4, lambda: hk.launches_inv),
    }
    rows = {name: [] for name in cases}
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    for shape, count in DP_SHAPES:
        g32 = torch.randn(*shape, device=dev)
        for name, (kern, prev, plain, dtype, kind, wb, counter) in \
                cases.items():
            x = g32.to(dtype)
            if kind == "K7":
                x = list(href.haar_dwt_fwd(g32, LEVEL))
            t_plain = [time_ms(lambda: plain(x), 5)]
            t_call = [time_ms(lambda: kern(x), 50), time_ms(lambda: kern(x),
                                                             50)]
            t_dev, t_parent = [], []
            for which in ("built", "parent", "parent", "built") if old \
                    else ("built", "built"):
                if which == "built":
                    t_dev.append(device_ms(lambda: kern(x), 20, counter,
                                           flush))
                else:
                    t_parent.append(device_ms(lambda: prev(x), 20,
                                              lambda: old.launches, flush))
            t_plain.append(time_ms(lambda: plain(x), 5))
            b_ms, b_by, nbytes = bound_haar(kind, shape, wire_bytes=wb)
            row = {"shape": list(shape), "per_step": count,
                   "ms": min(t_dev), "call_ms": min(t_call),
                   "parent_ms": min(t_parent) if old else None,
                   "plain_ms": min(t_plain), "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes}
            if kind in ("K6", "K7"):
                row.update(library_turn(kind, x, plain, dtype, flush))
            print(f"{name} time {shape}: kernel {row['ms']:.4f} ms on the "
                  f"device (runs {t_dev}), {b_ms / row['ms']:.1%} of bound; "
                  f"parent's "
                  + (f"{row['parent_ms']:.4f} ms (runs {t_parent})" if old
                     else "not built (tools/parent_kernels.py not run)")
                  + f"; {row['call_ms']:.4f} ms per call (runs {t_call}), "
                  f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
                  f"{b_by} ({nbytes / 1e6:.2f} MB)"
                  + (f"; torch.matmul with core.haar_matrix "
                     f"{row['library_ms']:.4f} ms, largest difference from "
                     f"the plain version {row['library_max_abs_err']:.3g}"
                     if "library_ms" in row else ""))
            rows[name].append(row)
    groups = {}
    for name in ("K3 bf16", "K3 fp8", "K6 bf16"):
        kern, _, plain, dtype, kind, wb, counter = cases[name]
        gs = dp_leaves(dev, dtype)
        if kind == "K3":
            wire = torch.bfloat16 if wb == 2 else fp8
            group = lambda: hk.haar_dwt_fwd_q_group(gs, LEVEL, wire)
        else:
            group = lambda: hk.haar_dwt_fwd_group(gs, LEVEL)
        singles = lambda: [kern(g) for g in gs]
        t_dev = [device_ms(group, 20, counter, flush) for _ in range(2)]
        t_call = [time_ms(group, 50) for _ in range(2)]
        t_plain = min(time_ms(lambda: [plain(g) for g in gs], 5)
                      for _ in range(2))
        host = [host_us(group), host_us(singles, 20)]
        step = {k: sum(r[k] * r["per_step"] for r in rows[name])
                for k in ("ms", "bound_ms", "bytes")}
        parent_step = sum(r["parent_ms"] * r["per_step"]
                          for r in rows[name]) if old else None
        groups[name] = {
            "ms": min(t_dev), "call_ms": min(t_call), "plain_ms": t_plain,
            "bound_ms": step["bound_ms"], "bytes": step["bytes"],
            "ten_launches_ms": step["ms"], "parent_ten_launches_ms":
            parent_step, "host_us_per_call": host[0],
            "host_us_ten_single_calls": host[1]}
        print(f"{name} DP group (10 leaves, one launch): kernel "
              f"{min(t_dev):.4f} ms on the device (runs {t_dev}), "
              f"{step['bound_ms'] / min(t_dev):.1%} of its bound "
              f"{step['bound_ms']:.4f} ms; as 10 single launches "
              f"{step['ms']:.4f} ms ({step['bound_ms'] / step['ms']:.1%}); "
              f"parent's 10 launches "
              + (f"{parent_step:.4f} ms" if old else "not built")
              + f"; {min(t_call):.4f} ms per call back to back; host "
              f"{host[0]:.1f} us per grouped call against {host[1]:.1f} us "
              f"for 10 single calls; plain {t_plain:.4f} ms")
    return rows, groups


def staged_loop(opt, steps, seed=0):
    """llama-60m at full width through the ``TrainLoop`` with ``opt``, from
    the launcher's parameters and batches (seed 0, batch 16 x seq 256):
    what ``train.main`` runs, with an optimizer the launcher does not
    offer.  Returns ``(params, state, losses, step_ms)``."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_source
    from repro_torch.models import lm
    from repro_torch.runtime.fault_tolerance import TrainLoop
    dev = torch.device("cuda")
    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                     dev).tree()
    state = opt.init(params)
    loop = TrainLoop(lm.make_train_step(cfg, opt),
                     make_source("synthetic", cfg.vocab, 256, 16, seed=seed),
                     device=dev, log_every=5, log=lambda line: None)
    params, state, losses = loop.run(params, state, num_steps=steps)
    torch.cuda.synchronize()
    step_ms = None if loop.steady_step_s is None \
        else loop.steady_step_s * 1e3
    return params, state, losses, step_ms


def gwt_opt(steps, **kw):
    from repro_torch.core.gwt import gwt
    from repro_torch.optim.schedules import warmup_cosine
    return gwt(warmup_cosine(0.01, steps), level=LEVEL, alpha=0.25, **kw)


# The staged path against the fused path of the same call, loss by loss.
# Both round G̃ to bf16 before the limiter (the fused kernels as their
# plain versions do); they differ in the order the per-leaf norm is summed
# (K1's block tree against torch.linalg.vector_norm), so a limiter scale
# can land one f32 spacing apart and bf16(scale) one bf16 spacing apart
# on a clipped step, which moves every element of that leaf's update by
# up to 2^-8 of itself; 20 steps carry that into the loss.  int8 adds
# stochastic requantization, where a one-spacing moment change flips a
# code.
TOL_STAGED_LOSS = {"f32": 5e-3, "int8": 5e-2}


def run_staged_path(kernel, hk, codec, fused):
    """The staged path, ``gwt(fused_write=False)``, at full width for
    ``STEPS`` steps, counts set to 0 just before and read just after: K4
    must launch once per GWT leaf per step (7 x 20 = 140), K1, K2 and K5
    never; the loss must fall and stay within ``TOL_STAGED_LOSS`` of the
    fused path's run ``fused`` (same parameters and batches)."""
    opt = gwt_opt(STEPS, fused_write=False, state_codec=codec)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel, hk)
    t0 = time.perf_counter()
    params, state, losses, step_ms = staged_loop(opt, STEPS)
    wall = time.perf_counter() - t0
    counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated() - base
    logged = [losses[i] for i in range(4, len(losses), 5)]
    gap = max(abs(a - b) for a, b in zip(losses, fused.losses))
    print(f"staged path {codec}: {STEPS} steps in {wall:.2f} s; logged "
          f"losses {logged}; launches {counts}; step {step_ms:.2f} ms "
          f"(fused path {fused.step_ms:.2f} ms); peak memory of the run "
          f"{peak / 2**20:.1f} MiB above what earlier phases hold; max "
          f"|loss - fused path's| {gap:.3g} (<= {TOL_STAGED_LOSS[codec]})")
    want = {k: 0 for k in counts}
    want.update(fused_counts(), K4=7 * STEPS)
    if counts != want:
        raise AssertionError(f"staged {codec} path launched {counts}, "
                             f"want {want}")
    if not np.all(np.isfinite(losses)) or not logged[-1] < logged[0]:
        raise AssertionError(f"staged {codec} losses {losses}")
    if gap > TOL_STAGED_LOSS[codec]:
        raise AssertionError(f"staged {codec} losses {losses} vs fused "
                             f"{fused.losses}")
    return {"losses": losses, "step_ms": step_ms, "peak_mib": peak / 2**20,
            "launches": counts, "max_loss_gap": gap}, params, state


def check_unrolled(steps=3):
    """The unrolled engine, ``gwt(bucketed=False)`` (every leaf through its
    rule's ``update``), a few full-width steps from the same parameters and
    batches as the bucketed staged path: parameters and state bitwise."""
    a = staged_loop(gwt_opt(steps, fused_write=False), steps)
    b = staged_loop(gwt_opt(steps, bucketed=False), steps)
    assert_bitwise(a[0], b[0], "unrolled vs bucketed staged params")
    assert_bitwise(a[1], b[1], "unrolled vs bucketed staged state")
    if a[2] != b[2]:
        raise AssertionError(f"unrolled losses {b[2]} vs staged {a[2]}")
    print(f"unrolled engine (bucketed=False): {steps} full-width steps "
          f"bitwise equal to the bucketed staged path (params, state, "
          f"losses {a[2]})")


def update_peak(opt, params, grads):
    """Bytes allocated at the peak of one ``opt.update`` (after a first
    update, so plans and salt tables exist), and that peak above what was
    allocated just before the call.  Garbage is collected first: device
    tensors in reference cycles that a collection frees during the update
    would otherwise lower its reading, down to 0 extra bytes."""
    state = opt.init(params)
    params, state = opt.update(grads, state, params)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt.update(grads, state, params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


def check_update_memory(dev):
    """Peak device memory of one ``optimizer.update``, fused write against
    the staged path: llama-60m at full width (bf16), and the JAX
    benchmark's bucket, 4 f32 leaves of 256 x 2048 at level 2 (its
    ``staged`` model charges the staged path with p and prev_norm held
    across the G̃ boundary; XLA's CPU buffer assignment gave 25,690,544 B
    against 35,651,636 B, 0.72x).  Returns a dict of the readings."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim.base import tree_map
    out = {}
    cfg = configs.get_config("llama-60m")
    gen = torch.Generator(device=dev).manual_seed(5)
    trees = {"llama-60m": lm.init(cfg, gen, dev).tree(),
             "bucket 4x256x2048 f32": {
                 f"w{i}": torch.randn(256, 2048, generator=gen, device=dev)
                 for i in range(4)}}
    for name, params in trees.items():
        row = {}
        for flow, kw in (("fused", {}), ("staged", {"fused_write": False})):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            copy = tree_map(torch.clone, params)
            ggen = torch.Generator(device=dev).manual_seed(7)
            grads = tree_map(lambda p: (torch.randn(
                p.shape, generator=ggen, device=dev) * 1e-2).to(p.dtype),
                params)
            peak, extra = update_peak(gwt_opt(100, **kw), copy, grads)
            row[flow] = {"peak_bytes": peak - base, "extra_bytes": extra}
            del copy, grads
        ratio = row["fused"]["peak_bytes"] / row["staged"]["peak_bytes"]
        ratio_extra = row["fused"]["extra_bytes"] / \
            row["staged"]["extra_bytes"]
        print(f"update peak memory {name}: fused {row['fused']} vs staged "
              f"{row['staged']} bytes (peak: parameters, gradients, state "
              f"and temporaries of the update; extra: above what was "
              f"allocated just before it); fused/staged {ratio:.3f} peak, "
              f"{ratio_extra:.3f} extra; the README's 0.72x is XLA's CPU "
              f"buffer assignment")
        row["ratio"], row["ratio_extra"] = ratio, ratio_extra
        out[name] = row
    return out


# the launcher's other choices: (label, arguments)
LOWRANK = ("galore", "apollo", "fira", "adarankgrad", "rso")
CHOICES = [("adam", ["--optimizer", "adam"]),
           ("adam_mini", ["--optimizer", "adam_mini"]),
           ("muon", ["--optimizer", "muon"]),
           ("sgd", ["--optimizer", "sgd"]),
           ("gwt --host adam_mini", ["--optimizer", "gwt", "--host",
                                     "adam_mini"]),
           ("gwt --host muon", ["--optimizer", "gwt", "--host", "muon"])] \
    + [(name, ["--optimizer", name]) for name in LOWRANK]
# the JAX package's engine.state_bytes at llama-60m: the low-rank families
# as its launcher builds them (rank_frac 0.25), and GWT-2 with bf16 moments
STATE_BYTES_LOWRANK = {"galore": 196_415_492, "apollo": 196_415_520,
                       "fira": 196_415_520, "adarankgrad": 196_415_520,
                       "rso": 196_415_492}
STATE_BYTES_GWT_BF16 = 90_867_744


def run_choices(train, kernel, hk):
    """Each of the launcher's other choices at full width for ``STEPS``
    steps, f32 matmuls (TF32 stays off): losses finite and falling, and no
    GWT kernel launched (none of these hosts runs the Adam kernels).  Peak
    memory is the run's own, above what earlier phases still hold.
    Returns ``{label: readings}``."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; Newton-Schulz must run "
                             "in f32")
    from repro_torch.optim.engine import state_bytes
    out = {}
    for label, args in CHOICES:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernel, hk)
        res = train.main(MAIN_ARGS + args)
        torch.cuda.synchronize()
        counts = all_counts(kernel, hk)
        peak = torch.cuda.max_memory_allocated() - base
        logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
        row = {"state_bytes": state_bytes(res.opt_state),
               "step_ms": res.step_ms, "peak_mib": peak / 2**20,
               "losses": logged}
        print(f"launcher {label}: logged losses {logged}; state "
              f"{row['state_bytes']} B = {row['state_bytes'] / 2**20:.2f} "
              f"MiB; step {res.step_ms:.2f} ms; peak {row['peak_mib']:.1f} "
              f"MiB; launches {counts}")
        if any(counts.values()):
            raise AssertionError(f"{label} launched {counts}")
        if not np.all(np.isfinite(res.losses)) or not logged[-1] < logged[0]:
            raise AssertionError(f"{label} losses {res.losses}")
        if label in STATE_BYTES_LOWRANK and \
                row["state_bytes"] != STATE_BYTES_LOWRANK[label]:
            raise AssertionError(f"{label} state is {row['state_bytes']} "
                                 f"bytes, the JAX package counts "
                                 f"{STATE_BYTES_LOWRANK[label]}")
        out[label] = row
    return out


def run_bf16_state(kernel, hk, fused_f32):
    """Phase 19: ``gwt(state_dtype=bfloat16)`` at full width through the
    ``TrainLoop``, fused write and staged, ``STEPS`` steps each, counts set
    to 0 just before each run and read just after: fused K1 3 launches a
    step, all one pass; staged K4 7 a step; nothing else.  Losses finite
    and falling, the staged path's within ``TOL_STAGED_LOSS["f32"]`` of the
    fused path's (both paths compute the same moments and round them
    alike; they differ in the limiter norm's sum order, as with f32
    moments); the moments bf16 and the state bytes the JAX package's.
    Printed beside phase 5's f32-moment run ``fused_f32``."""
    from repro_torch.optim.base import flatten_with_paths
    from repro_torch.optim.engine import state_bytes
    out, losses = {}, {}
    for flow, kw, want in (("fused", {}, fused_counts(k1=3 * STEPS)),
                           ("staged", {"fused_write": False},
                            {"K4": 7 * STEPS})):
        opt = gwt_opt(STEPS, state_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernel, hk)
        params, state, losses[flow], step_ms = staged_loop(opt, STEPS)
        counts = all_counts(kernel, hk)
        peak = torch.cuda.max_memory_allocated() - base
        expect = {k: 0 for k in counts}
        expect.update(want)
        if counts != expect:
            raise AssertionError(f"bf16-state {flow} path launched {counts}, "
                                 f"want {expect}")
        moments = [t.dtype for p, t in zip(*flatten_with_paths(state))
                   if p.endswith("/m") or p.endswith("/v")]
        if set(moments) != {torch.bfloat16}:
            raise AssertionError(f"bf16-state {flow}: moment dtypes "
                                 f"{set(moments)}")
        nbytes = state_bytes(state)
        if nbytes != STATE_BYTES_GWT_BF16:
            raise AssertionError(f"bf16 state is {nbytes} bytes, the JAX "
                                 f"package counts {STATE_BYTES_GWT_BF16}")
        logged = [losses[flow][i] for i in range(4, STEPS, 5)]
        if not np.all(np.isfinite(losses[flow])) or \
                not logged[-1] < logged[0]:
            raise AssertionError(f"bf16-state {flow} losses {losses[flow]}")
        out[flow] = {"losses": logged, "step_ms": step_ms,
                     "peak_mib": peak / 2**20, "launches": counts,
                     "state_bytes": nbytes}
        print(f"bf16 state, {flow}: {STEPS} steps, logged losses {logged}; "
              f"launches {counts}; state {nbytes} B = {nbytes / 2**20:.2f} "
              f"MiB; step {step_ms:.2f} ms; peak {peak / 2**20:.1f} MiB above "
              f"what earlier phases hold")
    gap = max(abs(a - b) for a, b in zip(losses["fused"], losses["staged"]))
    out["max_loss_gap"] = gap
    print(f"bf16 state: max |staged loss - fused loss| {gap:.3g} (<= "
          f"{TOL_STAGED_LOSS['f32']}); f32-moment fused path (phase 5) "
          f"losses {[fused_f32.losses[i] for i in range(4, STEPS, 5)]}")
    if gap > TOL_STAGED_LOSS["f32"]:
        raise AssertionError(f"bf16-state staged losses {losses['staged']} "
                             f"vs fused {losses['fused']}")
    return out


# Phase 20: the low-rank families with a projector refresh every
# REFRESH_GAP steps, so 20 steps refresh at 0, 5, 10 and 15.
REFRESH_GAP = 5


def lowrank_opt(name, steps, update_gap=REFRESH_GAP):
    from repro_torch import optim
    from repro_torch.optim.schedules import warmup_cosine
    return optim.make(name, lr=warmup_cosine(0.01, steps), rank_frac=0.25,
                      alpha=0.25, update_gap=update_gap)


def count_syncs(fn):
    """``fn()`` and the number of calls in it that blocked the host on the
    card (PyTorch's sync debug mode, as ``tools/step_time.py`` counts)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def watched(opt, log):
    """``opt`` whose ``update`` appends ``(start event, stop event, syncs)``
    to ``log``: one entry per step, in order."""
    def update(grads, state, params):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out, syncs = count_syncs(lambda: opt.update(grads, state, params))
        b.record()
        log.append((a, b, syncs))
        return out
    return opt._replace(update=update)


def resumed_loop(opt, ckpt_dir, start):
    """The phase-20 model from its checkpoint at ``start``, then the
    ``TrainLoop`` to ``STEPS``: a resumed run, as ``train.main --resume``
    restores one."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import make_source
    from repro_torch.models import lm
    from repro_torch.runtime.fault_tolerance import TrainLoop
    dev = torch.device("cuda")
    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    state, step = CheckpointManager(ckpt_dir).restore(
        None, {"params": params, "opt": opt.init(params)}, device=dev)
    if step != start:
        raise AssertionError(f"checkpoint at {step}, want {start}")
    params = lm.LM(cfg, state["params"]).tree()
    loop = TrainLoop(lm.make_train_step(cfg, opt),
                     make_source("synthetic", cfg.vocab, 256, 16, seed=0),
                     device=dev, log_every=5, log=lambda line: None)
    params, st, losses = loop.run(params, state["opt"], start_step=start,
                                  num_steps=STEPS)
    torch.cuda.synchronize()
    return params, st, losses


def checkpointed_loop(opt, ckpt_dir, steps):
    """``staged_loop`` to ``steps`` with a checkpoint at the end."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import make_source
    from repro_torch.models import lm
    from repro_torch.runtime.fault_tolerance import TrainLoop
    dev = torch.device("cuda")
    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    loop = TrainLoop(lm.make_train_step(cfg, opt),
                     make_source("synthetic", cfg.vocab, 256, 16, seed=0),
                     device=dev, ckpt=CheckpointManager(ckpt_dir),
                     ckpt_every=steps, log_every=5, log=lambda line: None)
    _, _, losses = loop.run(params, opt.init(params), num_steps=steps)
    torch.cuda.synchronize()
    return losses


def run_refresh(kernel, hk):
    """Phase 20: each low-rank family at full width through the
    ``TrainLoop`` with ``update_gap=REFRESH_GAP`` for ``STEPS`` steps
    (refreshes, and AdaRankGrad's and RSO's moment rotations, at steps 0,
    5, 10, 15): every non-refresh update makes 0 synchronizing calls, no
    GWT kernel launches, the losses are finite and falling.  Prints the
    update's time (CUDA events around it) on refresh steps beside the
    steady ones.  For galore and rso, 10 steps + checkpoint + a resumed
    run of 10 equal the 20 straight steps bitwise (losses, parameters,
    state): their refreshes at 10 and 15 come after the resume."""
    out = {}
    for name in LOWRANK:
        log = []
        reset_counts(kernel, hk)
        params, state, losses, step_ms = staged_loop(
            watched(lowrank_opt(name, STEPS), log), STEPS)
        counts = all_counts(kernel, hk)
        if any(counts.values()):
            raise AssertionError(f"{name} launched {counts}")
        if len(log) != STEPS:
            raise AssertionError(f"{name}: {len(log)} updates in {STEPS} "
                                 f"steps")
        syncs = [n for _, _, n in log]
        bad = [(i, n) for i, n in enumerate(syncs)
               if i % REFRESH_GAP and n]
        if bad:
            raise AssertionError(f"{name}: non-refresh updates synchronized "
                                 f"(step, calls) {bad}")
        ms = [a.elapsed_time(b) for a, b, _ in log]
        refresh = [ms[i] for i in range(REFRESH_GAP, STEPS, REFRESH_GAP)]
        steady = [ms[i] for i in range(2, STEPS) if i % REFRESH_GAP]
        logged = [losses[i] for i in range(4, STEPS, 5)]
        if not np.all(np.isfinite(losses)) or not logged[-1] < logged[0]:
            raise AssertionError(f"{name} losses {losses}")
        row = {"losses": logged, "step_ms": step_ms,
               "update_ms_refresh": sum(refresh) / len(refresh),
               "update_ms_steady": float(np.median(steady)),
               "update_ms_first": ms[0],
               "syncs_per_refresh": syncs[::REFRESH_GAP],
               "syncs_other_steps": sum(syncs) - sum(syncs[::REFRESH_GAP])}
        print(f"refresh {name} (update_gap {REFRESH_GAP}): logged losses "
              f"{logged}; update on refresh steps 5/10/15 "
              f"{row['update_ms_refresh']:.2f} ms (runs "
              f"{[round(x, 3) for x in refresh]}), steady "
              f"{row['update_ms_steady']:.2f} ms (median of "
              f"{len(steady)}), step 0 {ms[0]:.2f} ms; synchronizing calls "
              f"per refresh update {row['syncs_per_refresh']}, on the other "
              f"{STEPS - len(row['syncs_per_refresh'])} updates 0; step "
              f"{step_ms:.2f} ms")
        if name in ("galore", "rso"):
            tmp = tempfile.mkdtemp(prefix="chip_smoke_refresh_")
            try:
                first = checkpointed_loop(lowrank_opt(name, STEPS), tmp,
                                          STEPS // 2)
                r_params, r_state, r_losses = resumed_loop(
                    lowrank_opt(name, STEPS), tmp, STEPS // 2)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            if first != losses[:STEPS // 2] or r_losses != losses[STEPS // 2:]:
                raise AssertionError(f"{name} resume: losses {first} + "
                                     f"{r_losses} vs {losses}")
            assert_bitwise(r_params, params, f"{name} resumed params")
            assert_bitwise(r_state, state, f"{name} resumed state")
            row["resume_bitwise"] = True
            print(f"refresh {name}: {STEPS // 2} steps + checkpoint + resume "
                  f"+ {STEPS // 2} steps == {STEPS} straight steps, bitwise "
                  f"(losses, parameters, projectors, moments)")
        out[name] = row
    return out


# phase 20's draws: the tolerance of tests/test_torch_prng.py (normals
# within 4 f32 spacings of jax.random's); full-width leaves, (L, rows, n)
PRNG_SPACINGS = 4
PRNG_LEAVES = [("llama-60m mixer wq/wk/wv/wo", (8, 512, 512)),
               ("llama-60m ffn w_gate/w_up", (8, 512, 1376)),
               ("qwen2.5-3b mixer wq (73728 rows)", (36, 2048, 2048))]


def check_prng_card(dev):
    """Phase 20's draws: APOLLO's projector draw (``lowrank.draw_normal``,
    the shape ``lowrank._proj_shape`` gives at rank 1/4) on the card and on
    the CPU for full-width leaves: the threefry bits and the uniforms
    bitwise equal, the normals within PRNG_SPACINGS f32 spacings (the
    CPU's log1p and the card's may round apart), no synchronizing call in
    the card's draw."""
    from repro_torch.core import prng
    from repro_torch.optim import lowrank
    out = []
    for label, shape in PRNG_LEAVES:
        p = torch.empty(shape, device="meta")
        r = lowrank._rank(p, None, 0.25)
        pshape = tuple(lowrank._proj_shape(p, r, lowrank._project_left(p)))
        key = prng.fold_in(prng.key(7 + 3), 2)
        for fn in (prng.random_bits, prng.uniform):
            card = fn(key, pshape, device=dev).cpu()
            if not torch.equal(card, fn(key, pshape)):
                raise AssertionError(f"prng {fn.__name__} {pshape}: card "
                                     f"and CPU differ")
        torch.cuda.synchronize()
        card, syncs = count_syncs(
            lambda: lowrank.draw_normal(pshape, 7, 3, 2, dev))
        card = card.cpu()
        cpu = lowrank.draw_normal(pshape, 7, 3, 2, "cpu")
        sp = float(((card.double() - cpu.double()).abs()
                    / spacing(cpu)).max())
        same = float((card == cpu).double().mean())
        if syncs or sp > PRNG_SPACINGS or not torch.isfinite(card).all():
            raise AssertionError(f"prng normal {pshape}: {syncs} syncs, "
                                 f"{sp} spacings from the CPU's")
        print(f"prng {label}: APOLLO projector {pshape} ({card.numel()} "
              f"draws): bits and uniforms card == CPU bitwise; normals "
              f"within {sp:.0f} f32 spacings of the CPU's ({same:.4%} "
              f"bitwise); {syncs} synchronizing calls in the card's draw")
        out.append({"leaf": list(shape), "projector": list(pshape),
                    "normal_spacings": sp, "bitwise_share": same,
                    "syncs": syncs})
    return out


def spacing(t):
    """The f32 spacing at each element of ``t`` (f64)."""
    a = t.abs().float()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()


def bound_tile(shape, level=LEVEL, esize=2, q8=False, msize=4):
    """Least time for one K4 (``q8``: K5) launch on ``shape``.  Bytes: read
    g, write G̃ (``esize`` each), read and write m and v (``msize`` bytes
    each: f32 4, bf16 2; K5: int8 codes and one f32 scale per 64), the
    partials (and K5's salts).
    Operations: K1's per-coefficient f32 work without the write, the
    rounding and squaring of G̃, and K5's dequantization, requantization
    (f32) and rounding hash (int32), each type over its own rate."""
    L, m, n = shape
    N, NA, B = L * m * n, L * m * (n >> level), 1 << level
    parts = L * -(-(m * (n >> level)) // 2048)
    f32_ops = NA * (2 * (4 * B - 4) + 11 + (B - 1)) + N * 3
    int_ops = 0
    if q8:
        nb = L * -(-(m * (n >> level)) // QBLOCK)
        nbytes = 2 * N * esize + 2 * 2 * NA + 2 * 2 * nb * 4 + 2 * L * 4 \
            + parts * 4
        f32_ops += NA * (2 + 2 * 9)
        int_ops = NA * 2 * 10
    else:
        nbytes = 2 * N * esize + 4 * NA * msize + parts * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


# the parent revision's kernel sources, written by tools/parent_kernels.py
# before a chip call; phase 17 times its K4/K5 and phase 12 its K3/K6/K7
# beside the kernels as built.  A checkout without them (no git history to
# take them from) skips those comparisons.
PARENT_DIR = Path(REPO) / "build" / "parent_kernels"
PARENT_LIB = "gwt_adam_tile@parent"
PARENT_HAAR = "haar_dwt@parent"


# the C entry a parent source must have for this script to call it: K1's
# and K4's with the moment-dtype code (``mdtype``, since bf16 moments), and
# the one-leaf-a-launch K3 that ``ParentHaar`` calls (a parent with the
# grouped K3/K6 of the current source lacks it)
PARENT_ENTRIES = {
    "gwt_adam_fused": "int gwt_adam_fused(int dtype, int mdtype",
    "gwt_adam_tile": "int gwt_adam_tile(int dtype, int mdtype",
    "haar_dwt": "int haar_dwt_fwd_q("}


def register_parent(build, lib="gwt_adam_tile") -> bool:
    """Adds the parent's library ``lib`` to ``build.SOURCES`` as
    ``lib@parent`` (phase 1 then builds it with the others); False where
    tools/parent_kernels.py has not written the sources, or where the
    parent's C interface is not the one this script calls
    (``PARENT_ENTRIES``)."""
    src, headers = build.SOURCES[lib]
    if not (PARENT_DIR / src.name).exists():
        return False
    entry = PARENT_ENTRIES.get(lib)
    if entry and entry not in (PARENT_DIR / src.name).read_text():
        print(f"parent {src.name}: its C interface lacks {entry!r}; not "
              f"built or timed")
        return False
    build.SOURCES[f"{lib}@parent"] = (PARENT_DIR / src.name, tuple(
        PARENT_DIR / h.name for h in headers))
    return True


@contextlib.contextmanager
def library(build, lib, name, declare):
    """Inside, the wrappers of library ``lib`` launch library ``name``'s
    kernels (the same C interface)."""
    saved = build.load(lib, declare)
    build._libs[lib] = build.load(name, declare)
    try:
        yield
    finally:
        build._libs[lib] = saved


def tile_library(kernel, build, name):
    """Inside, the K4/K5 wrappers launch library ``name``'s kernels."""
    return library(build, "gwt_adam_tile", name, kernel._declare_tile)


def copy_ms(nbytes: int, flush: torch.Tensor, dev) -> float:
    """Device time of one ``copy_`` that reads and writes ``nbytes`` in all,
    timed as ``device_ms`` times a kernel (L2 flushed before each of 20)."""
    a = torch.empty(nbytes // 8, device=dev)
    b = torch.empty_like(a)
    spans = []
    for _ in range(20):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        b.copy_(a)
        e1.record()
        spans.append((e0, e1))
    torch.cuda.synchronize()
    return sum(x.elapsed_time(y) for x, y in spans) / len(spans)


def time_tile(kernel, ref, build, dev, parent):
    """Phase 17: K4 and K5 per launch at the staged path's leaf shapes
    (level 2, bf16 gradients): device time (CUDA events around each launch,
    L2 flushed before it) of the kernels as built and, if ``parent``, of
    the parent revision's in the same call, in turns (built, parent,
    parent, built); one ``copy_`` of the bytes the bound counts; time per
    call back to back; the plain version's; the bound.  Returns ``{"K4":
    rows, "K5": rows}``."""
    rows = {"K4": [], "K5": []}
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    for label, shape, count in TILE_SHAPES:
        g, mm, vv = tile_inputs(shape, LEVEL, torch.bfloat16, 3, dev)
        args, salts = tile_q8_inputs(shape, LEVEL, torch.bfloat16, 3, dev)
        usalts = [s.to(torch.uint32) for s in salts]
        cases = {
            "K4": (lambda: kernel.gwt_adam_tile(g, mm, vv, level=LEVEL),
                   lambda: ref.gwt_adam_tile(g, mm, vv, level=LEVEL),
                   lambda: kernel.launches_tile, False),
            "K5": (lambda: kernel.gwt_adam_tile_q8(
                       *args, *usalts, level=LEVEL, block=QBLOCK),
                   lambda: ref.gwt_adam_tile_q8(*args, *salts, level=LEVEL,
                                                block=QBLOCK),
                   lambda: kernel.launches_tile_q8, True)}
        for name, (kern, plain, counter, q8) in cases.items():
            t_plain = [time_ms(plain, 5)]
            t_call = [time_ms(kern, 50), time_ms(kern, 50)]
            t_dev, t_parent = [], []
            for which in (("built", "parent", "parent", "built") if parent
                          else ("built", "built")):
                if which == "built":
                    t_dev.append(device_ms(kern, 20, counter, flush))
                else:
                    with tile_library(kernel, build, PARENT_LIB):
                        t_parent.append(device_ms(kern, 20, counter, flush))
            t_plain.append(time_ms(plain, 5))
            b_ms, b_by, nbytes = bound_tile(shape, q8=q8)
            t_copy = [copy_ms(nbytes, flush, dev) for _ in range(2)]
            row = {"leaf": label, "shape": list(shape), "per_step": count,
                   "ms": min(t_dev), "call_ms": min(t_call),
                   "parent_ms": min(t_parent) if parent else None,
                   "copy_ms": min(t_copy), "plain_ms": min(t_plain),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            print(f"{name} time {label} {shape}: kernel {row['ms']:.4f} ms "
                  f"on the device (runs {t_dev}), {b_ms / row['ms']:.1%} of "
                  f"bound; parent's "
                  + (f"{row['parent_ms']:.4f} ms (runs {t_parent})" if parent
                     else "not built (tools/parent_kernels.py not run)")
                  + f"; copy_ of the same bytes {row['copy_ms']:.4f} ms; "
                  f"{row['call_ms']:.4f} ms per call (runs {t_call}), plain "
                  f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                  f"({nbytes / 1e6:.2f} MB)")
            if not q8:
                row["bf16_moments"] = time_tile_bf16(kernel, g, mm, vv,
                                                     shape, flush)
            rows[name].append(row)
    return rows


def time_tile_bf16(kernel, g, mm, vv, shape, flush):
    """K4 with the same moments rounded to bf16 (gwt(state_dtype=bf16)):
    device time per launch (as ``time_tile``, two runs of 20), per call,
    and the bound with 2-byte moments."""
    m16, v16 = mm.to(torch.bfloat16), vv.to(torch.bfloat16)
    kern = lambda: kernel.gwt_adam_tile(g, m16, v16, level=LEVEL)
    t_dev = [device_ms(kern, 20, lambda: kernel.launches_tile, flush)
             for _ in range(2)]
    t_call = [time_ms(kern, 50) for _ in range(2)]
    b_ms, b_by, nbytes = bound_tile(shape, msize=2)
    out = {"ms": min(t_dev), "call_ms": min(t_call), "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes}
    print(f"K4 time {shape} bf16 moments: kernel {out['ms']:.4f} ms on the "
          f"device (runs {t_dev}), {b_ms / out['ms']:.1%} of bound "
          f"{b_ms:.4f} ms ({nbytes / 1e6:.2f} MB); {out['call_ms']:.4f} ms "
          f"per call")
    return out


def tile_entry(name, launches, max_abs_err, rows, **extra):
    """K4's or K5's line: one step's worth, with the parent's design and
    the same-byte copy timed in the same call."""
    parent = None if rows[0]["parent_ms"] is None else \
        sum(r["parent_ms"] * r["per_step"] for r in rows)
    return step_entry(name, "gwt_adam/csrc/gwt_adam_tile.cu",
                      "src/repro/kernels/gwt_adam/kernel.py:"
                      + ("214" if name.endswith("q8") else "261"),
                      launches, max_abs_err, rows, parent_ms=parent,
                      copy_ms=sum(r["copy_ms"] * r["per_step"] for r in rows),
                      **extra)


def haar_entry(name, replaces, launches, max_abs_err, rows, **extra):
    return step_entry(name, "haar_dwt/csrc/haar_dwt.cu", replaces, launches,
                      max_abs_err, rows, **extra)


def group_entry(name, replaces, launches, max_abs_err, rows, group,
                **extra):
    """K3's or K6's line: ``ms``, ``call_ms``, ``plain_ms`` and
    ``bound_ms`` of one grouped launch over the DP group (one step's
    split), beside the same step as ten single-leaf launches and the
    parent revision's ten, timed in the same call."""
    entry = haar_entry(name, replaces, launches, max_abs_err, rows,
                       **extra)
    entry.update(ms=group["ms"], call_ms=group["call_ms"],
                 plain_ms=group["plain_ms"], bound_ms=group["bound_ms"],
                 group=group)
    return entry


def step_entry(name, source, replaces, launches, max_abs_err, rows,
               **extra):
    """One step's worth of a kernel launched per leaf: each shape's time
    times its launches per step."""
    def step(key):
        return sum(r[key] * r["per_step"] for r in rows)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": step("ms"), "call_ms": step("call_ms"),
            "plain_ms": step("plain_ms"), "bound_ms": step("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": step("library_ms") if all(
                "library_ms" in r for r in rows) else None,
            "per_launch": rows, **extra}


def bf16_step(rows):
    """One step's worth of K1's or K4's launches with bf16 moments."""
    return {k: sum(r["bf16_moments"][k] * r["per_step"] for r in rows)
            for k in ("ms", "call_ms", "bound_ms")}


def grouped_entry(name, source, replaces, launches, groups, klabel):
    """A grouped K1's or K2's line (phase 40): one step's grouped launches
    at llama-60m's LoRA adapter buckets (``ms``, ``bound_ms``,
    ``plain_ms``, ``host_us``) beside the same buckets' per-bucket
    launches in the same call; ``launches``: phase 29's grouped launches
    (20 steps); ``max_abs_err``: phase 40's largest |grouped - plain| and
    |grouped - per-bucket| over every set, CASE and kernel; every set's row
    under ``sets``."""
    rows = [r for r in groups["times"] if r["kernel"] == klabel]
    row = rows[0]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": groups["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "per_bucket_ms": row["per_bucket_ms"],
            "host_us": row["host_us"],
            "per_bucket_host_us": row["per_bucket_host_us"], "sets": rows,
            "checked": groups["launches"], "phase_s": groups["phase_s"]}


def fused_entry(name, source, replaces, launches, max_abs_err, rows,
                **extra):
    """K1's or K2's line: one step's worth of the one-pass design (``ms``,
    ``call_ms``) beside the two-pass design's, timed in the same call."""
    return step_entry(name, source, replaces, launches, max_abs_err, rows,
                      two_pass_ms=sum(r["two_pass_ms"] for r in rows),
                      two_pass_call_ms=sum(r["two_pass_call_ms"]
                                           for r in rows), **extra)


# Phase 18: the corpus path.  A byte corpus of the JAX package's sources
# (frozen, so its content hash is the same in every revision), built by the
# port's build_corpus, and a second build with another held-out tail (the
# same text and vocab, another hash) for the refused resume.
CORPUS_GLOB = os.path.join("src", "repro", "**", "*.py")
CORPUS_EVAL_FRACTIONS = (0.05, 0.1)
CORPUS_EVAL = ["--eval-every", "10", "--eval-batches", "4"]
EVAL_TIMING_RUNS = 5


def build_corpora(tmp):
    """The phase's corpus and the one with another eval tail; prints each
    one's hash and split sizes."""
    from repro_torch.data import build_corpus
    out = []
    for frac in CORPUS_EVAL_FRACTIONS:
        d = os.path.join(tmp, f"corpus_{frac}")
        t0 = time.perf_counter()
        index = build_corpus.build(os.path.join(REPO, CORPUS_GLOB), d,
                                   tokenizer_kind="byte",
                                   eval_fraction=frac)
        tr = index["splits"]["train"]["n_tokens"]
        ev = index["splits"]["eval"]["n_tokens"]
        print(f"corpus {CORPUS_GLOB} (byte, eval fraction {frac}): hash "
              f"{index['corpus_hash']}; train {tr} tokens "
              f"({(tr - 1) // 256} windows of 257), eval {ev} tokens "
              f"({(ev - 1) // 256} windows); built in "
              f"{time.perf_counter() - t0:.2f} s")
        out.append((d, index["corpus_hash"]))
    return out


def time_eval(res, corpus, dev):
    """Wall time of one eval as the launcher runs it (4 batches of 16 x
    256 of the eval split, a host fetch at the end), on the trained
    parameters: the first call and the best of the next ones."""
    from repro_torch import configs
    from repro_torch.data.eval import make_lm_evaluator
    from repro_torch.data.pipeline import make_source
    from repro_torch.data.store import TokenStore
    from repro_torch.models import lm
    cfg = configs.get_config("llama-60m")    # the launcher's vocab rule
    cfg = cfg.with_(vocab=max(cfg.vocab, TokenStore(corpus).vocab_size))
    batch, seq = (int(MAIN_ARGS[MAIN_ARGS.index(flag) + 1])
                  for flag in ("--batch", "--seq"))
    ev = make_lm_evaluator(cfg, lm, make_source(
        "corpus", cfg.vocab, seq, batch, corpus_dir=corpus, split="eval"),
        n_batches=4, device=dev)
    walls, losses = [], []
    for _ in range(1 + EVAL_TIMING_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(ev(res.params)["loss"])
        walls.append(time.perf_counter() - t0)
    if len(set(losses)) != 1 or losses[0] != res.evals[-1][1]:
        raise AssertionError(f"eval of the final parameters {losses} != "
                             f"the launcher's step-20 eval {res.evals[-1]}")
    return walls[0] * 1e3, min(walls[1:]) * 1e3


def run_corpus_path(train, kernel, hk, dev, synthetic, card):
    """Phase 18: full-width llama-60m GWT-2 on the byte corpus through K1,
    with 2 data workers and eval every 10 steps (launch counts set to 0
    just before and read just after); the same steps with the prefetch
    thread and no eval, bitwise; 10 steps + checkpoint + resume, bitwise;
    a resume against the other corpus refused.  Returns the K1 entry's
    ``corpus_path`` record."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        (corpus, digest), (other, _) = build_corpora(tmp)
        args = MAIN_ARGS + ["--data", "corpus", "--corpus-dir", corpus]
        reset_counts(kernel, hk)
        t0 = time.perf_counter()
        res = train.main(args + ["--workers", "2"] + CORPUS_EVAL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts(kernel, hk)
        want = {k: 0 for k in counts}
        want.update(fused_counts(k1=3 * STEPS))
        if counts != want:
            raise AssertionError(f"corpus path launched {counts} in {STEPS} "
                                 f"steps, want {want}")
        logged = [res.losses[i] for i in range(4, len(res.losses), 5)]
        if not np.all(np.isfinite(res.losses)) or not logged[-1] < logged[0]:
            raise AssertionError(f"corpus path losses {res.losses}")
        steps = [s for s, _ in res.evals]
        evals = [v for _, v in res.evals]
        if steps != [10, 20] or not np.all(np.isfinite(evals)):
            raise AssertionError(f"evals {res.evals}, want finite ones at "
                                 f"steps 10 and 20")
        if not evals[1] < evals[0]:
            raise AssertionError(f"eval loss did not fall: {res.evals}")
        plain = train.main(args + ["--workers", "0"])
        if plain.losses != res.losses:
            raise AssertionError(f"workers 0 without eval: {plain.losses} vs "
                                 f"{res.losses}")
        assert_bitwise(plain.params, res.params, "workers 0 without eval")
        assert_bitwise(plain.opt_state, res.opt_state,
                       "workers 0 without eval (state)")
        ckpt = ["--ckpt-dir", os.path.join(tmp, "ckpt"), "--ckpt-every",
                "10", "--workers", "2"] + CORPUS_EVAL
        first = train.main(args + ckpt)
        shutil.rmtree(os.path.join(tmp, "ckpt", f"step_{STEPS:09d}"))
        resumed = train.main(args + ckpt + ["--resume", "--workers", "0"])
        if resumed.start_step != 10 or first.losses[10:] != resumed.losses \
                or list(resumed.evals) != list(res.evals[1:]):
            raise AssertionError(f"resume from {resumed.start_step}: losses "
                                 f"{resumed.losses} vs {first.losses[10:]}, "
                                 f"evals {resumed.evals}")
        assert_bitwise(resumed.params, res.params, "resumed params")
        assert_bitwise(resumed.opt_state, res.opt_state, "resumed state")
        foreign = MAIN_ARGS + ["--data", "corpus", "--corpus-dir", other]
        try:
            train.main(foreign + ckpt + ["--resume"])
        except SystemExit as e:
            if "corpus_hash" not in str(e):
                raise
            refused = str(e)
        else:
            raise AssertionError("a resume on another corpus was not refused")
        eval_first_ms, eval_ms = time_eval(res, corpus, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wd, wd32 = res.watchdog, synthetic.watchdog
    record = {
        "corpus": CORPUS_GLOB, "corpus_hash": digest, "launches": counts,
        "losses": res.losses, "evals": [list(e) for e in res.evals],
        "step_ms": res.step_ms, "step_ms_workers_0_no_eval": plain.step_ms,
        "synthetic_step_ms": synthetic.step_ms,
        "dispatch_s_per_step": wd["dispatch_s_per_step"],
        "blocked_s_per_step": wd["blocked_s_per_step"],
        "synthetic_dispatch_s_per_step": wd32["dispatch_s_per_step"],
        "synthetic_blocked_s_per_step": wd32["blocked_s_per_step"],
        "watchdog_incidents": wd["incidents"],
        "eval_ms": eval_ms, "eval_first_ms": eval_first_ms,
        "wall_s": wall}
    print(f"corpus path: {STEPS} steps in {wall:.2f} s, workers 2, eval "
          f"every 10; logged losses {logged}; evals {res.evals}; launches "
          f"{counts}")
    print(f"corpus path: workers 0 without eval == workers 2 with eval, "
          f"bitwise (losses, params, state); 10 steps + checkpoint + resume "
          f"(workers 0) == {STEPS} straight, bitwise; other corpus refused "
          f"({refused.split(':')[0]})")
    print(f"corpus path numbers ({card}): step {res.step_ms:.2f} ms with "
          f"workers 2 and eval, {plain.step_ms:.2f} ms with workers 0 and no "
          f"eval, synthetic f32 step {synthetic.step_ms:.2f} ms (phase 5); "
          f"watchdog dispatch {wd['dispatch_s_per_step'] * 1e3:.2f} ms/step, "
          f"blocked {wd['blocked_s_per_step'] * 1e3:.2f} ms/step (synthetic "
          f"{wd32['dispatch_s_per_step'] * 1e3:.2f} / "
          f"{wd32['blocked_s_per_step'] * 1e3:.2f}), {wd['incidents']} "
          f"incidents; eval (4 x 16 x 256) {eval_ms:.2f} ms, first call "
          f"{eval_first_ms:.2f} ms")
    return record


# Phases 21-25: the dense attention family at full width.  GWT-2 over
# qwen2.5-3b's plan gives K1 six buckets a step, rows merged as
# ``ops._rows`` feeds them, in plan order; the stacked QKV biases are GWT
# leaves in the JAX package, and so in the port.
DENSE_ARCHS = ("qwen2.5-3b", "gemma2-9b", "gemma3-27b", "deepseek-67b")
# phase 25 also trains the M-RoPE and MoE smoke configs
NEW_ARCHS = ("qwen2-vl-72b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
QWEN_BUCKETS = [("ffn.w_down", (1, 396288, 2048)),
                ("ffn.w_gate (w_gate, w_up)", (2, 73728, 11008)),
                ("mixer.bk (bk, bv)", (2, 36, 256)),
                ("mixer.bq", (1, 36, 2048)),
                ("mixer.wk (wk, wv)", (2, 73728, 256)),
                ("mixer.wo (wo, wq)", (2, 73728, 2048))]
# phase 21: one layer's rows of each of those widths (the bias buckets
# whole), in every CASE at both seed sets
DENSE_SHAPES = [("wk/wv, one layer", (2, 2048, 256)),
                ("wo/wq, one layer", (2, 2048, 2048)),
                ("w_gate/w_up, one layer", (2, 2048, 11008)),
                ("w_down, one layer", (1, 11008, 2048)),
                ("bk/bv", (2, 36, 256)), ("bq", (1, 36, 2048))]
QWEN_ARGS = ["--arch", "qwen2.5-3b", "--steps", str(STEPS), "--batch",
             "16", "--seq", "256", "--log-every", "5", "--seed", "0"]
# qwen2.5-3b's depth in phases 22, 27 and 37: 9 of its 36 layers, every
# width published, to keep the script within its time (the kernel timings
# and phase 21's checks keep QWEN_BUCKETS, the full depth's buckets)
QWEN_LAYERS = 9
# the JAX package's engine.state_bytes of GWT-2 at full width and
# QWEN_LAYERS layers, per codec (8,039,764,012 / 2,135,562,352 B at 36)
QWEN_STATE_BYTES = {"f32": 3_876_942_892, "int8": 1_029_812_992}
# phase 23: (arch, layers, batch, seq, the JAX package's state bytes at
# that depth).  Every width is the published one; only depth is cut, to
# fit one card.  gemma2 at seq 8192 is the first length its 4096 window
# takes the block-local route at; gemma3 at 2 layers has only remainder
# (rem) blocks, both local, and its 1024 window divides 2048.
DENSE_CUTS = [("deepseek-67b", 2, 16, 256, 16_190_341_152),
              ("gemma2-9b", 2, 1, 8192, 8_132_898_876),
              ("gemma3-27b", 2, 2, 2048, 12_926_015_548)]
CUT_STEPS = 5
# phase 24: qwen2.5-3b's attention after the KV repeat, and a length past
# 8192 that takes the chunked route
FLASH_SHAPE = (1, 4096, 16, 128)
FLASH_SEQ = 16384
# _flash_attn against _direct_attn in bf16: each kv chunk's p·V is
# rounded to bf16 before the f32 sum, so the outputs may differ by a bf16
# spacing; 2 bf16 spacings at the direct output's largest magnitude (1
# measured on the CPU at (1, 2048, 4, 128))
TOL_FLASH_BF16_SPACINGS = 2
# phase 25: card against CPU, 3 GWT-2 steps of each smoke config.  f32 as
# phase 4; bf16 rounds every matmul output to 8 bits of mantissa, so a
# different summation order moves a logit by a bf16 spacing and the
# steps carry it: measured on an H100 at most 4.1e-4 relative (gemma3-27b
# smoke, step 3), so 2e-3 leaves a factor of 5 for other seeds, and a
# card-only fault that moves the loss by 0.2% fails
TOL_SMOKE_LOSS = {"float32": 1e-4, "bfloat16": 2e-3}
SMOKE_SEQ = 64                     # > the smoke window 32: block-local
ROUTES = ("_direct_attn", "_local_block_attn", "_flash_attn",
          "_flash_attn_noncausal")


def gwt_buckets(cfg, level=LEVEL):
    """The GWT buckets of GWT-``level`` over ``cfg``'s parameters as K1
    takes them: ``(name, (L, rows, n))``, and the names of the other
    buckets."""
    from repro_torch.core.gwt import gwt
    from repro_torch.models import module_for
    from repro_torch.optim.base import flatten_with_paths
    params = module_for(cfg).abstract_params(cfg)
    shapes = dict(zip(*flatten_with_paths(params)))
    gwt_b, other = [], {}
    for b in gwt(lr=0.01, level=level).engine.plan(params).buckets:
        s = tuple(shapes[b.paths[0]].shape)
        if b.name.startswith("gwt"):
            gwt_b.append((b.name, (len(b.paths), math.prod(s[:-1]), s[-1])))
        else:
            other.update({p: b.name for p in b.paths})
    return gwt_b, other


def one_pass(kernel, shape, dtype, q8=False, pdtype=None,
             level=LEVEL) -> bool:
    lib = "gwt_adam_fused_q8" if q8 else "gwt_adam_fused"
    return kernel.one_pass_plan(lib, shape, dtype, level,
                                pdtype=pdtype)["grid"] > 0


def pinned_sets(shapes, dtype, pdtype, level, q8):
    """The PINNED_GROUPS row of these buckets, and its K1 (``q8``: K2)
    sets; ``(None, [])`` where no row names them."""
    key = ([tuple(s) for s in shapes], dtype, pdtype or dtype, level)
    for label, bs, dt, pdt, lv, k1, k2 in PINNED_GROUPS:
        if ([tuple(s) for s in bs], dt, pdt or dt, lv) == key:
            return label, k2 if q8 else k1
    return None, []


def plan_counts(kernel, shapes, dtype, q8=False, pdtype=None,
                mdtype=torch.float32, level=LEVEL, alone=False):
    """K1's (``q8``: K2's) counters a step when the engine updates GWT
    buckets of ``shapes`` in plan order: each set PINNED_GROUPS names one
    grouped launch (one pass), every other bucket its own launch in the
    design the capacity rule names (``alone``: no set, every bucket alone,
    as under :func:`buckets_alone`).  Raises where the card's
    ``kernel.group_plan`` (the engine's) is not the pinned launches."""
    name = "gwt_adam_fused_q8" if q8 else "gwt_adam_fused"
    sms, smem = kernel.capacity(name, dtype, level, mdtype, pdtype or dtype)
    label, sets = pinned_sets(shapes, dtype, pdtype, level, q8)
    if alone:
        sets = []
    else:
        want = sorted(sets + [[i] for i in range(len(shapes))
                              if not any(i in x for x in sets)])
        got = kernel.group_plan([(s, dtype, level, None) for s in shapes],
                                sms, smem)
        if got != want:
            raise AssertionError(f"{label or shapes}: group_plan on this "
                                 f"card gives {got}, pinned {want}")
    single = [i for i in range(len(shapes)) if not any(i in x for x in sets)]
    two = sum(not kernel.one_pass_fits(shapes[i], dtype, level, sms, smem)
              for i in single)
    k = "K2" if q8 else "K1"
    n = len(sets) + len(single)
    return {k: n, f"{k} one-pass": n - two, f"{k} two-pass": two,
            f"{k} group": len(sets),
            f"{k} group buckets": sum(map(len, sets))}


def fused_plan_counts(kernel, cfg, steps, q8=False, level=LEVEL):
    """K1's (``q8``: K2's) expected counters over ``steps`` steps of
    GWT-``level`` on ``cfg`` (:func:`plan_counts`)."""
    buckets, _ = gwt_buckets(cfg, level)
    return {k: v * steps for k, v in plan_counts(
        kernel, [s for _, s in buckets], cfg.torch_dtype, q8,
        level=level).items()}


# phase 21's whole-bucket kernels: (label, K2?, moment dtype)
WHOLE_KERNELS = [("K1 f32 moments", False, torch.float32),
                 ("K1 bf16 moments", False, torch.bfloat16),
                 ("K2 int8 moments", True, None)]


def whole_bucket_case(kernel, ref, dev, shape, ci, q8, mdtype, case):
    """One CASE of a whole two-pass bucket: the entry twice (each on its
    own copies of the state) and the plain version, on the same inputs.
    Returns ``(runs, want, output names)``."""
    _, use_lim, prev, wd = case
    L = shape[0]
    sd = seed(ci, shape[2], LEVEL, 1)
    ss = torch.tensor(1e-3, device=dev)
    pn = torch.full((L,), prev, device=dev)
    wd_coef = torch.tensor(wd, device=dev)
    kw = dict(level=LEVEL, gamma=1.01, use_limiter=use_lim,
              weight_decay=wd != 0)
    if q8:
        g, *state = make_q8_inputs(shape, sd, dev)
        salts = q8_salts(L, dev)
        usalts = [t.to(torch.uint32) for t in salts]
        kw["block"] = QBLOCK
        want = ref.gwt_adam_fused_q8(g, *state, *salts, pn, ss, wd_coef,
                                     **kw)
        runs = [kernel.gwt_adam_fused_q8(g, *(t.clone() for t in state),
                                         *usalts, pn, ss, wd_coef, **kw)
                for _ in range(2)]
        return runs, want, ("p", "qm", "sm", "qv", "sv", "norm")
    g, *state = make_inputs(shape, sd, dev, mdtype=mdtype)
    want = ref.gwt_adam_fused(g, *state, pn, ss, wd_coef, **kw)
    runs = [kernel.gwt_adam_fused(g, *(t.clone() for t in state), pn, ss,
                                  wd_coef, **kw) for _ in range(2)]
    return runs, want, ("p", "m", "v", "norm")


def check_dense_fused(kernel, ref, dev):
    """Phase 21: K1 at one layer's rows of each qwen2.5-3b bucket width as
    phase 2 holds it (level 2, bf16 and f32 parameters, f32 and bf16
    moments, every CASE, both seed sets, bitwise); then every whole bucket
    of the plan that takes the two-pass design, K1 with f32 and with bf16
    moments and K2, in every CASE (the limiter active, inactive and off),
    two kernel runs bitwise to each other and to the plain version (the
    largest, (2, 73728, 11008), has 1.62e9 elements: byte offsets past
    2^31, and 99,072 chunk partials summed into each leaf's norm by the
    scale pass)."""
    _, taken = check_fused(kernel, ref, dev, q8=False, shapes=DENSE_SHAPES,
                           levels=(LEVEL,))
    whole = [(label, shape) for label, shape in QWEN_BUCKETS
             if not one_pass(kernel, shape, torch.bfloat16)]
    if len(whole) != 4 or any(one_pass(kernel, s, torch.bfloat16, True)
                              for _, s in whole):
        raise AssertionError(f"two-pass buckets {whole}; phase 21 expects "
                             f"the four large qwen2.5-3b buckets, for K1 "
                             f"and K2")
    for label, shape in whole:
        for name, q8, mdtype in WHOLE_KERNELS:
            t0 = time.perf_counter()
            for ci, case in enumerate(CASES):
                counter = (lambda: kernel.launches_q8_two_pass) if q8 \
                    else (lambda: kernel.launches_two_pass)
                before = counter()
                runs, want, outputs = whole_bucket_case(
                    kernel, ref, dev, shape, ci, q8, mdtype, case)
                torch.cuda.synchronize()
                if counter() - before != 2:
                    raise AssertionError(f"{name} {shape}: not the two-pass "
                                         f"design")
                check_bands(f"{name} whole bucket {label} {shape} / "
                            f"{case[0]}", runs, want, outputs)
                del runs, want
            print(f"{name} whole bucket {label} {shape} "
                  f"({math.prod(shape)} elements): two-pass design, "
                  f"{len(CASES)} cases, two runs and the plain version "
                  f"bitwise equal on {', '.join(outputs)} "
                  f"({time.perf_counter() - t0:.1f} s)")
            gc.collect()
            torch.cuda.empty_cache()
    return {"one_layer_widths": [s for _, s in DENSE_SHAPES],
            "buckets_by_design": taken,
            "whole_buckets_bitwise": [list(s) for _, s in whole],
            "whole_bucket_kernels": [n for n, _, _ in WHOLE_KERNELS]}


@contextlib.contextmanager
def depth_cut(arch, n_layers):
    """While the block runs, ``configs.get_config(arch)`` (what the
    launcher builds) has ``n_layers`` layers and every published width.
    ``n_layers`` may be a dict of config fields instead: the
    encoder-decoder stack's ``n_layers``, ``n_enc_layers`` and
    ``n_dec_layers``, or a ``dtype`` beside the depth."""
    from repro_torch import configs
    full = configs.get_config
    cut = n_layers if isinstance(n_layers, dict) else {"n_layers": n_layers}
    configs.get_config = lambda name: (full(name).with_(**cut)
                                       if name == arch else full(name))
    try:
        yield configs.get_config(arch)
    finally:
        configs.get_config = full


@contextlib.contextmanager
def route_counts():
    """Counts the calls of each attention route while the block runs."""
    from repro_torch.models import attention
    counts = dict.fromkeys(ROUTES, 0)
    saved = {name: getattr(attention, name) for name in ROUTES}

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(attention, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(attention, name, fn)


def want_routes(cfg, S, steps):
    """Route calls of ``steps`` steps: each block once forward and, with
    ``cfg.remat``, once more when the backward recomputes it."""
    kinds = list(cfg.pattern) * cfg.n_periods + \
        list(cfg.pattern[:cfg.rem_layers])
    want = dict.fromkeys(ROUTES, 0)
    for kind in kinds:
        window = cfg.window if kind == "attn_local" else 0
        if window and S > window and S % window == 0:
            route = "_local_block_attn"
        elif window and S > window:
            route = "_direct_attn"
        elif S > 8192:
            route = "_flash_attn"
        else:
            route = "_direct_attn"
        want[route] += steps * (2 if cfg.remat else 1)
    return want


def run_dense(train, kernel, hk, arch, argv, cfg, steps, state_bytes_want,
              seq, q8=False):
    """Train ``cfg`` through the launcher (counts set to 0 just before and
    read just after): K1's (``q8``: K2's) launches and designs, the
    attention routes, the state bytes, finite losses and parameters.
    Returns a summary."""
    from repro_torch.optim.engine import state_bytes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(kernel, hk)
    with route_counts() as routes:
        t0 = time.perf_counter()
        res = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update(fused_plan_counts(kernel, cfg, steps, q8))
    if counts != want:
        raise AssertionError(f"{arch}: launched {counts} in {steps} steps, "
                             f"want {want}")
    if routes != want_routes(cfg, seq, steps):
        raise AssertionError(f"{arch}: attention routes {routes}, want "
                             f"{want_routes(cfg, seq, steps)}")
    nbytes = state_bytes(res.opt_state)
    if nbytes != state_bytes_want:
        raise AssertionError(f"{arch}: state {nbytes} B, the JAX package "
                             f"counts {state_bytes_want}")
    if not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"{arch}: non-finite losses {res.losses}")
    from repro_torch.optim.base import flatten_with_paths
    for name, t in zip(*flatten_with_paths(res.params)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{arch}: non-finite parameter {name}")
    out = {"arch": arch, "layers": cfg.n_layers, "steps": steps,
           "losses": res.losses, "step_ms": res.step_ms,
           "peak_mib": peak / 2**20, "base_mib": base / 2**20,
           "state_bytes": nbytes, "routes": routes, "wall_s": wall}
    k = "K2" if q8 else "K1"
    out.update({f"{k.lower()}_launches": counts[k],
                f"{k.lower()}_one_pass": counts[f"{k} one-pass"],
                f"{k.lower()}_two_pass": counts[f"{k} two-pass"]})
    print(f"{arch} ({cfg.n_layers} layers, {' '.join(argv[2:])}): "
          f"{steps} steps in {wall:.2f} s, losses {res.losses}, step "
          f"{res.step_ms} ms, peak {peak / 2**20:.1f} MiB (held before "
          f"the run {base / 2**20:.1f} MiB), state {nbytes} "
          f"B, {k} {counts[k]} ({counts[f'{k} one-pass']} one pass, "
          f"{counts[f'{k} two-pass']} two passes), routes {routes}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def qwen_cut():
    """qwen2.5-3b at ``QWEN_LAYERS`` layers, every width published."""
    from repro_torch import configs
    return configs.get_config("qwen2.5-3b").with_(n_layers=QWEN_LAYERS)


def qwen_buckets(layers):
    """``QWEN_BUCKETS`` at ``layers`` of the 36: each stack's rows are its
    layers' rows."""
    return [(name, (L, rows * layers // 36, n))
            for name, (L, rows, n) in QWEN_BUCKETS]


def run_dense_main(train, kernel, hk, codec="f32"):
    """Phase 22: qwen2.5-3b at full width, ``QWEN_LAYERS`` layers, through
    the launcher, GWT-2, f32 (``codec`` int8: blocked-int8) moments,
    synthetic data, remat: K1 (int8: K2) as ``plan_counts`` names (4 a
    step: one grouped launch and three two-pass), nothing else; the state the JAX package's
    bytes; losses finite and falling."""
    with depth_cut("qwen2.5-3b", QWEN_LAYERS) as cfg:
        buckets, _ = gwt_buckets(cfg)
        if [s for _, s in buckets] != [
                s for _, s in qwen_buckets(QWEN_LAYERS)]:
            raise AssertionError(f"qwen2.5-3b's GWT buckets are {buckets}")
        q8 = codec == "int8"
        out = run_dense(train, kernel, hk, "qwen2.5-3b",
                        QWEN_ARGS + ["--state-codec", codec], cfg, STEPS,
                        QWEN_STATE_BYTES[codec], 256, q8)
    logged = [out["losses"][i] for i in range(4, STEPS, 5)]
    if not logged[-1] < logged[0]:
        raise AssertionError(f"qwen2.5-3b {codec}: loss did not fall: "
                             f"{logged}")
    out["codec"] = codec
    out["logged_losses"] = logged
    out["tokens_per_s"] = 16 * 256 / (out["step_ms"] / 1e3)
    out["designs"] = {name: "one" if one_pass(kernel, s, torch.bfloat16, q8)
                      else "two" for name, s in buckets}
    print(f"qwen2.5-3b main path, {codec} moments: step "
          f"{out['step_ms']:.2f} ms, {out['tokens_per_s']:.0f} tokens/s, "
          f"peak {out['peak_mib']:.1f} MiB; logged losses {logged}; "
          f"{'K2' if q8 else 'K1'} designs {out['designs']}")
    return out


def time_dense_fused(kernel, ref, dev, q8=False):
    """Phase 22's K1 (``q8``: K2) times: per launch at each qwen2.5-3b
    bucket in the design the entry takes (CUDA events around each launch,
    L2 flushed, best of two runs), per call back to back, the plain
    version's, the bound; for a two-pass bucket also the write pass alone
    (the call without the limiter, which launches nothing else)."""
    rows = []
    name = "K2" if q8 else "K1"
    flush = torch.empty(64 << 20, device=dev)   # 256 MB
    ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(level=LEVEL, gamma=1.01, use_limiter=True, weight_decay=False)
    for label, shape in QWEN_BUCKETS:
        pn = torch.full((shape[0],), 1e9, device=dev)
        one = one_pass(kernel, shape, torch.bfloat16, q8)
        if q8:
            inputs = make_q8_inputs(shape, 7, dev)
            salts = q8_salts(shape[0], dev)
            usalts = [t.to(torch.uint32) for t in salts]
            call = lambda **o: kernel.gwt_adam_fused_q8(
                *inputs, *usalts, pn, ss, wd, block=QBLOCK, **{**kw, **o})
            plain = lambda: ref.gwt_adam_fused_q8(
                *inputs, *salts, pn, ss, wd, block=QBLOCK, **kw)
            counter = (lambda: kernel.launches_q8_one_pass) if one else \
                (lambda: kernel.launches_q8_two_pass)
            b_ms, b_by, nbytes = bound_q8(shape)
        else:
            inputs = make_inputs(shape, 7, dev)
            call = lambda **o: kernel.gwt_adam_fused(*inputs, pn, ss, wd,
                                                     **{**kw, **o})
            plain = lambda: ref.gwt_adam_fused(*inputs, pn, ss, wd, **kw)
            counter = (lambda: kernel.launches_one_pass) if one else \
                (lambda: kernel.launches_two_pass)
            b_ms, b_by, nbytes = bound(shape)
        t_dev = [device_ms(call, 10, counter, flush) for _ in range(2)]
        t_call = time_ms(call, 10)
        t_plain = time_ms(plain, 1)
        row = {"bucket": label, "shape": list(shape), "per_step": 1,
               "design": "one" if one else "two", "ms": min(t_dev),
               "call_ms": t_call, "plain_ms": t_plain, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": nbytes}
        if not one:
            row["write_pass_ms"] = min(
                device_ms(lambda: call(use_limiter=False), 10, counter,
                          flush) for _ in range(2))
        print(f"{name} time qwen2.5-3b {label} {shape}: "
              f"{'one pass' if one else 'two passes'} {row['ms']:.4f} ms on "
              f"the device (runs {t_dev}, {b_ms / row['ms']:.1%} of bound "
              f"{b_ms:.4f} ms by {b_by}, {nbytes / 1e6:.2f} MB); per call "
              f"{t_call:.4f} ms; plain {t_plain:.4f} ms"
              + ("" if one else f"; the write pass alone "
                 f"{row['write_pass_ms']:.4f} ms"))
        rows.append(row)
        del inputs, call, plain
        torch.cuda.empty_cache()
    return rows


def run_dense_cuts(train, kernel, hk):
    """Phase 23: deepseek-67b, gemma2-9b and gemma3-27b at full width, cut
    in depth, CUT_STEPS steps each through the launcher (see
    ``run_dense``); deepseek's untied head gets plain Adam."""
    out = []
    for arch, layers, batch, seq, nbytes in DENSE_CUTS:
        with depth_cut(arch, layers) as cfg:
            _, other = gwt_buckets(cfg)
            if not cfg.tie_embeddings and \
                    other.get("embed/lm_head", "gwt").startswith("gwt"):
                raise AssertionError(f"{arch}: lm_head is not plain Adam")
            argv = ["--arch", arch, "--steps", str(CUT_STEPS), "--batch",
                    str(batch), "--seq", str(seq), "--log-every", "1",
                    "--seed", "0"]
            res = run_dense(train, kernel, hk, arch, argv, cfg, CUT_STEPS,
                            nbytes, seq)
        res.update(batch=batch, seq=seq, window=cfg.window,
                   attn_softcap=cfg.attn_softcap,
                   final_softcap=cfg.final_softcap, qk_norm=cfg.qk_norm,
                   rem_layers=cfg.rem_layers)
        out.append(res)
    return out


def check_flash(train, kernel, hk, dev):
    """Phase 24: ``_flash_attn`` (q_chunk 512, kv_chunk 2048) against
    ``_direct_attn`` on the card at qwen2.5-3b's attention shape in bf16,
    within TOL_FLASH_BF16_SPACINGS; then one full-width qwen2.5-3b step
    cut to 2 layers at batch 1 x seq 16384, which takes the chunked
    route, with a finite loss."""
    from repro_torch.models import attention
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(FLASH_SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    flash = lambda: attention._flash_attn(q, k, v, q_chunk=512,
                                          kv_chunk=2048)
    direct = lambda: attention._direct_attn(q, k, v, causal_offset=0,
                                            window=0, cap=0.0)
    got, want = flash(), direct()
    spacing = float(np.spacing(np.float32(want.float().abs().max().item()))
                    ) * 2 ** 16
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL_FLASH_BF16_SPACINGS * spacing:
        raise AssertionError(f"_flash_attn vs _direct_attn: max |diff| "
                             f"{err} > {TOL_FLASH_BF16_SPACINGS} bf16 "
                             f"spacings ({spacing})")
    t_flash, t_direct = time_ms(flash, 5), time_ms(direct, 5)
    print(f"_flash_attn vs _direct_attn {FLASH_SHAPE} bf16: max |diff| "
          f"{err} = {err / spacing:.3f} bf16 spacings at the largest "
          f"magnitude; {t_flash:.3f} vs {t_direct:.3f} ms")
    del q, k, v, got, want
    with depth_cut("qwen2.5-3b", 2) as cfg:
        argv = ["--arch", "qwen2.5-3b", "--steps", "1", "--batch", "1",
                "--seq", str(FLASH_SEQ), "--log-every", "1", "--seed", "0"]
        res = run_dense(train, kernel, hk, "qwen2.5-3b", argv, cfg, 1,
                        gwt_state_bytes(cfg), FLASH_SEQ)
    return {"shape": list(FLASH_SHAPE), "max_abs_err": err,
            "bf16_spacings": err / spacing, "flash_ms": t_flash,
            "direct_ms": t_direct, "step": res}


def gwt_state_bytes(cfg) -> int:
    """GWT-2's exact state bytes over ``cfg`` (on the ``meta`` device)."""
    from repro_torch.core.gwt import gwt
    from repro_torch.models import lm
    from repro_torch.optim.engine import state_bytes
    return state_bytes(gwt(lr=0.01).init(lm.abstract_params(cfg)))


def check_dense_small_training(dev):
    """Phase 25: each dense, M-RoPE and MoE SMOKE config, f32 and as
    published (bf16),
    3 GWT-2 steps on the card and on the CPU from the same parameters and
    batches (seq 64: the local layers take the block-local route)."""
    from repro_torch import configs
    out = {}
    for arch in DENSE_ARCHS + NEW_ARCHS:
        for dtype in TOL_SMOKE_LOSS:
            cfg = configs.get_smoke(arch).with_(dtype=dtype)
            out[f"{arch} {dtype}"] = small_training(
                dev, cfg, ("f32",), SMOKE_SEQ, 3, TOL_SMOKE_LOSS[dtype])
    return out


# ---------------------------------------------------------------------------
# Phases 26-29: serving (repro_torch.serve, repro_torch.launch.serve)
# ---------------------------------------------------------------------------

# (a) llama-60m at full width, trained 20 steps by the launcher and served
# from its checkpoint; (b) qwen2.5-3b at full width cut to QWEN_LAYERS
# of its 36 layers (to keep the script within its time; the decode tick is
# launch-bound, so its time and launches scale with the depth), seed-0
# init.
# Workloads from launch.serve.build_workload (rate 0: all at t=0)
SERVE_SPECS = {"llama-60m": {"requests": 32, "prompt": 128, "gen": 64},
               "qwen2.5-3b": {"requests": 16, "prompt": 256, "gen": 64}}
SERVE_SLOTS, SERVE_PAGE, SERVE_CHUNK = 8, 16, 64
# kv_bytes() a layer: pages x 16 tokens x 2 (K and V) x KV heads x (hd x 2
# B in bf16, or hd + 4 B in int8); llama-60m 97 pages (1 + 8 x 192/16; 8
# layers: 25,427,968 / 13,508,608 B), qwen2.5-3b 161 (1 + 8 x 320/16; 36
# layers: 94,961,664 / 48,964,608 B)
KV_BYTES_PER_LAYER = {("llama-60m", None): 3_178_496,
                      ("llama-60m", "int8"): 1_688_576,
                      ("qwen2.5-3b", None): 2_637_824,
                      ("qwen2.5-3b", "int8"): 1_360_128}
# The paged path against the dense path, teacher-forced on the dense
# tokens, in bf16 spacings of the dense logits' largest magnitude.  bf16
# pages: both compute the same function, but the chunk prefill's matmuls
# take 64 rows where the dense prefill takes the whole prompt, and the
# attention sums run over the gathered pages (masked entries add exactly
# 0) where the dense path's run over its own cache length, so a bf16
# output moves by a spacing where an f32 sum lands near a rounding
# boundary.  Measured on an H100 at 700 W: llama-60m 0.5 spacing with one
# request at a time, 1.0 with its 32 requests decoded as one batch (the
# check's form); qwen2.5-3b 0.125.  Held to 2.  int8 pages also carry each
# K/V entry's rounding to its head vector's absmax/127, about a bf16
# spacing of that absmax on every entry rather than near boundaries only
# (measured 1.0 and 0.156): held to 8.
TOL_SERVE_BF16_SPACINGS = 2
TOL_SERVE_INT8_SPACINGS = 8
# Two paths whose logits differ by at most e can pick different greedy
# tokens only where the top-2 margin is under 2e: a near tie.  A request's
# tokens must equal the dense path's up to its first divergence, and that
# divergence must be at a near tie (printed; its later tokens, on another
# context, are not compared).  int8 pages must also pick the dense token,
# teacher-forced (each step on the same context), on >= 0.9 of the steps:
# the reference's own gate (tests/test_serving.py:194).  The reference
# test's measure, the position-by-position agreement of the two engines'
# free-running outputs, compounds every flip into the tokens after it: it
# is printed.
INT8_AGREEMENT = 0.9
# Phase 28, card against CPU on the smoke configs: f32 logits within 32
# f32 spacings of the largest magnitude (other summation orders over 2-3
# layers); bf16 logits within 4 bf16 spacings, as above
TOL_SERVE_SMOKE = {"float32": ("f32", 32), "bfloat16": ("bf16", 4)}
BF16_FLOPS_PER_S = 989e12
PROFILED_TICKS = 5


def spacing_err(got, want, unit="bf16"):
    """max |got - want| in spacings of ``want``'s largest magnitude (f32,
    or bf16: 2^16 f32 spacings)."""
    got, want = got.double(), want.double()
    top = float(want.abs().max().item())
    sp = float(np.spacing(np.float32(max(top, 1e-30))))
    if unit == "bf16":
        sp *= 2 ** 16
    return float((got - want.to(got.device)).abs().max().item()) / sp


def dense_pass(cfg, params, prompt, gen, dev):
    """The dense path of ``launch.serve.generate`` on one request, keeping
    each step's logits: ``(tokens, logits (gen, V) f32)``."""
    from repro_torch.launch.serve import ensure_capacity, pad_cache
    from repro_torch.models import lm
    S = len(prompt)
    logits, cache = lm.make_prefill_step(cfg)(
        params, {"tokens": torch.tensor([prompt], device=dev)})
    cache = ensure_capacity(pad_cache(cache, S + gen), S + gen)
    decode = lm.make_decode_step(cfg)
    steps = [logits[0]]
    for _ in range(gen - 1):
        logits, cache = decode(params, cache,
                               {"tokens": torch.argmax(logits, -1)[:, None]})
        steps.append(logits[0])
    out = torch.stack(steps).float()
    return out.argmax(-1).tolist(), out


def paged_teacher_forced(cfg, params, reqs, dense, dev, quant=None):
    """The paged steps on every request at once, teacher-forced on the
    dense tokens: each prompt paged into its own pages by SERVE_CHUNK
    chunks (the last padded), then decode ticks over all requests as
    slots, a finished request's slot idle on the trash page.  Returns
    ``{rid: logits (len(tokens), V) f32}``: at the prompt's last position,
    then at each decode step."""
    from repro_torch.models import lm
    n = len(reqs)
    mp = max(-(-(len(r.prompt) + len(dense[r.rid][0])) // SERVE_PAGE)
             for r in reqs)
    pools = lm.init_paged_caches(cfg, 1 + n * mp, SERVE_PAGE, kv_quant=quant,
                                 device=dev)
    pt = 1 + np.arange(n * mp, dtype=np.int32).reshape(n, mp)
    T = lambda a: torch.tensor(np.asarray(a), device=dev)
    chunk = lm.make_chunk_prefill_step(cfg)
    out = {}
    for b, r in enumerate(reqs):
        for start in range(0, len(r.prompt), SERVE_CHUNK):
            piece = r.prompt[start:start + SERVE_CHUNK]
            logits, _ = chunk(params, pools, T(pt[b:b + 1]), T([start]),
                              T([piece + [0] * (SERVE_CHUNK - len(piece))]))
        out[r.rid] = [logits[0, len(piece) - 1].float()]
    decode = lm.make_paged_decode_step(cfg)
    for t in range(max(len(dense[r.rid][0]) for r in reqs) - 1):
        live = [b for b, r in enumerate(reqs) if t < len(dense[r.rid][0]) - 1]
        rows = np.zeros_like(pt)
        lens = np.zeros((n,), np.int32)
        toks = np.zeros((n, 1), np.int32)
        for b in live:
            r = reqs[b]
            rows[b], lens[b] = pt[b], len(r.prompt) + t
            toks[b, 0] = dense[r.rid][0][t]
        logits, _ = decode(params, pools, T(rows), T(lens), T(toks))
        for b in live:
            out[reqs[b].rid].append(logits[b].float())
    return {rid: torch.stack(v) for rid, v in out.items()}


def check_against_dense(label, reqs, dense, tol):
    """Every request's engine tokens equal the dense path's up to its first
    divergence, which must be at a near tie: a dense top-2 margin under
    twice ``tol`` bf16 spacings (printed).  ``dense[rid] = (tokens,
    margins, bf16 spacing of the logits)``.  Returns the divergences."""
    near = []
    for r in reqs:
        want, margins, spacing = dense[r.rid]
        if r.generated == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.generated, want))
                 if a != b)
        if margins[j] >= 2 * tol * spacing:
            raise AssertionError(
                f"{label}: request {r.rid} diverges from the dense path at "
                f"step {j} ({r.generated[j]} vs {want[j]}) where the dense "
                f"top-2 margin {margins[j]} >= 2 x {tol} bf16 spacings "
                f"({spacing})")
        near.append({"rid": r.rid, "step": j, "margin": margins[j],
                     "spacing": spacing})
        print(f"{label}: request {r.rid} diverges from the dense path at "
              f"step {j} of {len(want)} on a near tie (top-2 margin "
              f"{margins[j]:.4g}, bf16 spacing {spacing:.4g}); its later "
              f"tokens are not compared")
    return near


def dense_references(cfg, params, reqs, dev):
    """Phase 26/27's dense side, per request: the dense path's tokens (the
    first request's also through ``generate`` itself), each step's top-2
    margin and the logits' bf16 spacing; the paged path's logits,
    teacher-forced on those tokens, against the dense logits with bf16 and
    with int8 pages (within TOL_SERVE_BF16_SPACINGS and
    TOL_SERVE_INT8_SPACINGS), and int8's teacher-forced greedy agreement
    (at least INT8_AGREEMENT over all steps)."""
    from repro_torch.launch.serve import generate
    dense, dense_logits = {}, {}
    margins_all = []
    for r in reqs:
        tokens, logits = dense_pass(cfg, params, r.prompt, r.max_gen, dev)
        if r.rid == reqs[0].rid:
            via = generate(cfg, params, torch.tensor([r.prompt], device=dev),
                           r.max_gen)[0].tolist()
            if via != tokens:
                raise AssertionError(f"dense_pass {tokens} != generate {via}")
        top2 = logits.topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        spacing = float(np.spacing(np.float32(
            logits.abs().max().item()))) * 2 ** 16
        dense[r.rid], dense_logits[r.rid] = (tokens, margins, spacing), logits
        margins_all += [m / spacing for m in margins]
    paged = paged_teacher_forced(cfg, params, reqs, dense, dev)
    errs = [spacing_err(paged[rid], dense_logits[rid]) for rid in dense]
    del paged
    paged8 = paged_teacher_forced(cfg, params, reqs, dense, dev, "int8")
    errs8 = [spacing_err(paged8[rid], dense_logits[rid]) for rid in dense]
    agree = sum(int((paged8[rid].argmax(-1).cpu() ==
                     torch.tensor(dense[rid][0])).sum()) for rid in dense)
    total = sum(len(d[0]) for d in dense.values())
    del paged8, dense_logits
    tf8 = agree / total
    summary = {"bf16_spacings_max": max(errs),
               "bf16_spacings_mean": float(np.mean(errs)),
               "int8_spacings_max": max(errs8),
               "int8_spacings_mean": float(np.mean(errs8)),
               "int8_teacher_forced_agreement": tf8, "steps": total,
               "margin_spacings_quantiles": np.quantile(
                   margins_all, [0.0, 0.1, 0.5, 0.9]).tolist()}
    print(f"{cfg.name}: paged vs dense logits, teacher-forced over "
          f"{len(reqs)} requests: bf16 pages max {max(errs):.3f} (mean "
          f"{summary['bf16_spacings_mean']:.3f}), int8 pages max "
          f"{max(errs8):.3f} (mean {summary['int8_spacings_mean']:.3f}) bf16 "
          f"spacings; int8 picks the dense token on {tf8:.4f} of {total} "
          f"steps; dense top-2 margins in bf16 spacings (min, 10%, 50%, "
          f"90%) {summary['margin_spacings_quantiles']}")
    if max(errs) > TOL_SERVE_BF16_SPACINGS:
        raise AssertionError(f"{cfg.name}: bf16 pages vs dense {max(errs)} "
                             f"bf16 spacings > {TOL_SERVE_BF16_SPACINGS}")
    if max(errs8) > TOL_SERVE_INT8_SPACINGS:
        raise AssertionError(f"{cfg.name}: int8 pages vs dense {max(errs8)} "
                             f"bf16 spacings > {TOL_SERVE_INT8_SPACINGS}")
    if not tf8 >= INT8_AGREEMENT:
        raise AssertionError(f"{cfg.name}: int8 pages pick the dense token "
                             f"on {tf8:.4f} of steps < {INT8_AGREEMENT}")
    return dense, summary


def instrument(eng, syncs: bool):
    """Wrap the engine's two tick methods: for each tick that ran, its host
    wall time (a decode tick ends in its token fetch, so the card is done),
    with ``syncs`` the synchronizing calls in it (PyTorch's sync debug
    mode), and memory_allocated after it."""
    ticks = {"decode": [], "prefill": []}
    for kind in ticks:
        orig = getattr(eng, f"_{kind}_tick")

        def wrapped(*a, _orig=orig, _kind=kind):
            t0 = time.perf_counter()
            if syncs:
                ran, n = count_syncs(lambda: _orig(*a))
            else:
                ran, n = _orig(*a), None
            if ran:
                ticks[_kind].append((time.perf_counter() - t0, n,
                                     torch.cuda.memory_allocated()))
            return ran
        setattr(eng, f"_{kind}_tick", wrapped)
    return ticks


def arena_ptrs(eng):
    from repro_torch.optim.base import flatten_with_paths
    return [t.data_ptr() for t in flatten_with_paths(eng.pools)[1]]


def serve_run(label, make_engine, ecfg, reqs, static, kernel, hk,
              syncs=False):
    """One engine run, the launch counts set to 0 just before and read
    just after (the serve path launches none of K1-K7): the arena in
    place, the free list recovered, kv_bytes; stats, ticks, peak."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = make_engine(ecfg)
    ptrs = arena_ptrs(eng)
    eng.warmup()
    ticks = instrument(eng, syncs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(kernel, hk)
    stats = eng.run(reqs, static=static)
    counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"{label}: the serve path launched {counts}")
    if arena_ptrs(eng) != ptrs:
        raise AssertionError(f"{label}: the arena moved")
    if sorted(eng.free_pages) != list(range(1, eng.num_pages)):
        raise AssertionError(f"{label}: the free list did not recover")
    mem = [m for _, _, m in ticks["decode"]]
    if max(mem) != mem[0]:
        raise AssertionError(f"{label}: memory grew over decode ticks: "
                             f"{mem[0]} -> {max(mem)} B")
    dec = [t for t, _, _ in ticks["decode"]]
    pre = [t for t, _, _ in ticks["prefill"]]
    ttft = sorted(r.t_first - r.arrival for r in reqs)
    pct = lambda xs, p: xs[min(len(xs) - 1, int(p / 100 * len(xs)))]
    out = dict(stats, kv_bytes=eng.kv_bytes(), decode_ticks=len(dec),
               prefill_chunks=len(pre),
               decode_tick_ms=1e3 * float(np.mean(dec)),
               prefill_chunk_host_ms=1e3 * float(np.mean(pre)),
               decode_tokens_per_s=sum(len(r.generated) - 1 for r in reqs)
               / sum(dec),
               ttft_p50_s=pct(ttft, 50), ttft_p99_s=pct(ttft, 99),
               peak_mib=peak / 2**20, held_mib=base / 2**20,
               wall_s=time.perf_counter() - t0)
    if syncs:
        out["syncs_per_decode_tick"] = sorted({n for _, n, _ in
                                               ticks["decode"]})
        out["syncs_per_prefill_chunk"] = sorted({n for _, n, _ in
                                                 ticks["prefill"]})
    print(f"{label}: {stats['requests']} requests, "
          f"{stats['generated_tokens']} tokens in "
          f"{stats['makespan_s']:.3f} s ({stats['tokens_per_sec']:.1f} "
          f"tokens/s, {stats['requests_per_sec']:.2f} requests/s), p50/p99 "
          f"latency {stats['p50_s']:.3f} / {stats['p99_s']:.3f} s, TTFT "
          f"p50/p99 {out['ttft_p50_s']:.3f} / {out['ttft_p99_s']:.3f} s; "
          f"{len(dec)} decode ticks {out['decode_tick_ms']:.2f} ms each "
          f"(decode {out['decode_tokens_per_s']:.1f} tokens/s), "
          f"{len(pre)} prefill chunks {out['prefill_chunk_host_ms']:.2f} ms "
          f"of host each; kv_bytes {out['kv_bytes']}; peak "
          f"{out['peak_mib']:.1f} MiB (held before {out['held_mib']:.1f}); "
          f"{out['wall_s']:.1f} s with the engine's build and warm-up"
          + (f"; syncs per decode tick {out['syncs_per_decode_tick']}, per "
             f"prefill chunk {out['syncs_per_prefill_chunk']}"
             if syncs else ""))
    return eng, out


def decode_bound_ms(cfg, params, lens, quant):
    """Least time of a decode tick: every weight read once (the tied
    embedding once, as the head; the input rows are negligible), each
    active slot's cached K/V entries read once and its new ones written,
    over HBM bandwidth; against 2 x params x slots bf16 operations."""
    from repro_torch.optim.base import flatten_with_paths
    leaves = flatten_with_paths(params)[1]
    wbytes = sum(t.numel() * t.element_size() for t in leaves)
    entry = cfg.n_kv_heads * (2 * cfg.head_dim if quant is None
                              else cfg.head_dim + 4)
    kvbytes = (sum(lens) + len(lens)) * cfg.n_layers * 2 * entry
    flops = 2 * sum(t.numel() for t in leaves) * len(lens)
    return 1e3 * max((wbytes + kvbytes) / HBM_BYTES_PER_S,
                     flops / BF16_FLOPS_PER_S), wbytes


def profile_decode(label, eng, plen):
    """Time and profile the engine's decode step with every slot active at
    ``plen`` cached positions (pages assigned by hand): ms per tick (CUDA
    events around 20 ticks, each ending in its token fetch), launches,
    device busy ms and idle share over PROFILED_TICKS profiled ticks, the
    page gather's (``aten::index``) device ms; and a prefill chunk's."""
    from torch.profiler import ProfilerActivity, profile
    e = eng.ecfg
    eng.reset()
    pt = np.zeros((e.num_slots, e.max_pages), np.int32)
    for s in range(e.num_slots):
        pt[s] = 1 + s * e.max_pages + np.arange(e.max_pages)
    lens = np.full((e.num_slots,), plen, np.int32)
    toks = np.ones((e.num_slots, 1), np.int32)
    tick = lambda: eng._decode_step(pt, lens, toks).tolist()
    tick_ms = time_ms(tick, 20)
    chunk = lambda: eng._chunk_step(pt[:1], 0, np.ones(
        (1, e.prefill_chunk), np.int32)).tolist()
    chunk_ms = time_ms(chunk, 10)
    _, syncs = count_syncs(tick)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_TICKS):
            tick()
        wall = (time.perf_counter() - t0) / PROFILED_TICKS
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3 \
        / PROFILED_TICKS
    dev_time = lambda ev: getattr(ev, "self_device_time_total",
                                  getattr(ev, "self_cuda_time_total", 0))
    gather = sum(dev_time(ev) for ev in prof.key_averages()
                 if ev.key == "aten::index") / 1e3 / PROFILED_TICKS
    out = {"tick_ms": tick_ms, "prefill_chunk_ms": chunk_ms,
           "syncs_per_tick": syncs,
           "launches_per_tick": len(kernels) // PROFILED_TICKS,
           "device_busy_ms": busy, "profiled_tick_ms": wall * 1e3,
           "idle_share": 1 - busy / (wall * 1e3), "gather_ms": gather}
    print(f"{label} decode tick, {e.num_slots} slots at {plen} positions: "
          f"{tick_ms:.3f} ms (CUDA events), prefill chunk of "
          f"{e.prefill_chunk} {chunk_ms:.3f} ms; {syncs} syncs a tick; "
          f"profiled: {out['launches_per_tick']} launches a tick, device "
          f"busy {busy:.3f} of {wall * 1e3:.3f} ms ({out['idle_share']:.1%} "
          f"idle), page gather (aten::index) {gather:.3f} ms")
    ops = sorted(prof.key_averages(), key=lambda ev: -dev_time(ev))[:8]
    for ev in ops:
        print(f"  {dev_time(ev) / 1e3 / PROFILED_TICKS:8.3f} ms/tick device "
              f"{ev.count // PROFILED_TICKS:5d} calls/tick  {ev.key[:70]}")
    eng.reset()
    return out


def serve_cell(arch, cfg, params, make_engine, kernel, hk, dev, statics):
    """Phases 26 and 27's checks on one model: the dense references
    (``dense_references``), then for bf16 and int8 pages and each of
    ``statics`` an engine run (``serve_run``): tokens equal the dense
    path's up to a near-tie divergence, continuous equal to static,
    kv_bytes exact; the free-running int8 agreement printed; then the
    decode step timed and profiled."""
    from repro_torch.launch.serve import build_workload
    from repro_torch.serve.engine import EngineConfig
    spec = SERVE_SPECS[arch]
    work = lambda: build_workload(spec["requests"], cfg.vocab,
                                  spec["prompt"], spec["gen"], 0.0, seed=0)
    t0 = time.perf_counter()
    dense, summary = dense_references(cfg, params, work(), dev)
    dense_s = time.perf_counter() - t0
    runs, near, outs = {}, {}, {}
    for quant in (None, "int8"):
        ecfg = EngineConfig(num_slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                            max_ctx=spec["prompt"] + spec["gen"],
                            prefill_chunk=SERVE_CHUNK, kv_quant=quant)
        tol = TOL_SERVE_BF16_SPACINGS if quant is None \
            else TOL_SERVE_INT8_SPACINGS
        for static in statics:
            key = f"{quant or 'bf16'} {'static' if static else 'continuous'}"
            reqs = work()
            eng, out = serve_run(f"{arch} {key}", make_engine, ecfg, reqs,
                                 static, kernel, hk,
                                 syncs=(quant is None and not static))
            want_kv = KV_BYTES_PER_LAYER[arch, quant] * cfg.n_layers
            if out["kv_bytes"] != want_kv:
                raise AssertionError(f"{arch} {key}: kv_bytes "
                                     f"{out['kv_bytes']} != {want_kv}")
            runs[key], outs[key] = out, [r.generated for r in reqs]
            near[key] = check_against_dense(f"{arch} {key}", reqs, dense,
                                            tol)
            if quant is None and not static:
                prof = profile_decode(f"{arch} {key}", eng, spec["prompt"])
                prof["bound_ms"], prof["weight_bytes"] = decode_bound_ms(
                    cfg, eng.params, [spec["prompt"]] * SERVE_SLOTS, quant)
                runs[key]["profile"] = prof
            del eng
        if len(statics) == 2 and outs[f"{quant or 'bf16'} continuous"] != \
                outs[f"{quant or 'bf16'} static"]:
            raise AssertionError(f"{arch} {quant}: continuous and static "
                                 f"tokens differ")
    a, b = outs["bf16 continuous"], outs["int8 continuous"]
    free = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb)) \
        / sum(len(r) for r in a)
    c = runs["bf16 continuous"]
    print(f"{arch} serving: int8 vs bf16 pages, free-running engine "
          f"outputs position by position: {free:.4f} of tokens agree "
          f"(teacher-forced {summary['int8_teacher_forced_agreement']:.4f});"
          f" decode bound {c['profile']['bound_ms']:.3f} ms a tick (weights "
          f"{c['profile']['weight_bytes']} B) vs {c['profile']['tick_ms']:.3f}"
          f" ms; dense references {dense_s:.1f} s"
          + (f"; continuous vs static makespan {c['makespan_s']:.3f} vs "
             f"{runs['bf16 static']['makespan_s']:.3f} s, tokens/s "
             f"{c['tokens_per_sec']:.1f} vs "
             f"{runs['bf16 static']['tokens_per_sec']:.1f}"
             if "bf16 static" in runs else ""))
    return {"runs": runs, "int8_free_running_agreement": free,
            "paged_vs_dense": summary, "near_tie_divergences": near}


def run_serve_roundtrip(train, kernel, hk, dev, d):
    """Phase 26: the launcher trains full-width llama-60m GWT-2 f32 for 20
    steps (K1 exactly 3 a step, one pass) and checkpoints into ``d``; the
    serve launcher serves the checkpoint; then the engine from the same
    checkpoint, bf16 and int8 pages, continuous and static, against the
    dense path from the same restored params."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim.base import flatten_with_paths
    from repro_torch.serve.engine import Engine
    spec = SERVE_SPECS["llama-60m"]
    # ``d`` outlives the phase: phase 29 fine-tunes its checkpoint
    reset_counts(kernel, hk)
    t0 = time.perf_counter()
    res = train.main(MAIN_ARGS + ["--ckpt-dir", d, "--ckpt-every",
                                  str(STEPS)])
    train_s = time.perf_counter() - t0
    counts = all_counts(kernel, hk)
    want = {k: 0 for k in counts}
    want.update(fused_counts(k1=3 * STEPS))
    if counts != want:
        raise AssertionError(f"serve round trip training launched "
                             f"{counts}, want {want}")
    trained = [t.detach().clone() for t in
               flatten_with_paths(res.params)[1]]
    del res
    argv = ["--arch", "llama-60m", "--ckpt", d, "--requests",
            str(spec["requests"]), "--prompt-len", str(spec["prompt"]),
            "--gen", str(spec["gen"]), "--num-slots", str(SERVE_SLOTS),
            "--page-size", str(SERVE_PAGE), "--prefill-chunk",
            str(SERVE_CHUNK)]
    reset_counts(kernel, hk)
    t0 = time.perf_counter()
    launcher = serve.main(argv)
    print(f"serve round trip: training {train_s:.1f} s, serve.main "
          f"{time.perf_counter() - t0:.1f} s")
    if any(all_counts(kernel, hk).values()):
        raise AssertionError(f"serve.main launched {all_counts(kernel, hk)}")
    if launcher["kv_arena_bytes"] != KV_BYTES_PER_LAYER["llama-60m",
                                                        None] * 8:
        raise AssertionError(f"serve.main kv bytes "
                             f"{launcher['kv_arena_bytes']}")
    cfg = configs.get_config("llama-60m")
    make = lambda ecfg: Engine.from_checkpoint(cfg, d, ecfg, device=dev)
    params, _ = CheckpointManager(d).restore_params(
        None, lm.abstract_params(cfg), device=dev)
    for a, b in zip(flatten_with_paths(params)[1], trained):
        if not torch.equal(a, b):
            raise AssertionError("restored params differ from trained")
    del trained
    out = serve_cell("llama-60m", cfg, params, make, kernel, hk, dev,
                     (False, True))
    out["launcher"] = launcher
    return out


def run_serve_qwen(kernel, hk, dev):
    """Phase 27: qwen2.5-3b at full width, ``QWEN_LAYERS`` layers,
    seed-0 init, served continuous with bf16 and int8 pages."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    gc.collect()
    torch.cuda.empty_cache()
    cfg = qwen_cut()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    out = serve_cell("qwen2.5-3b", cfg, params,
                     lambda ecfg: Engine(cfg, params, ecfg), kernel, hk,
                     dev, (False,))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_smoke_card_vs_cpu(dev):
    """Phase 28: the smoke configs on the card and on the CPU from the
    same params and tokens.  llama-60m, qwen2.5-3b, deepseek-67b: two chunk
    prefills of one slot's 11-token prompt (the second padded), 4 paged
    decode ticks over 3 slots (two idle on the trash page), one chunk
    prefill of another slot; gemma2-9b and gemma3-27b: a 64-position dense
    prefill (window 32: the ring handoff) and 4 ring-buffer decode steps.
    Every call's logits within TOL_SERVE_SMOKE."""
    from repro_torch import configs
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import lm
    from repro_torch.optim.base import flatten_with_paths, unflatten

    def dense_calls(cfg, p, toks, T):
        lg, cache = lm.make_prefill_step(cfg)(p, {"tokens": T(toks[:, :64])})
        got = [lg]
        cache = pad_cache(cache, 68, window=cfg.window)
        for t in range(64, 68):
            lg, cache = lm.make_decode_step(cfg)(
                p, cache, {"tokens": T(toks[:, t:t + 1])})
            got.append(lg)
        return got

    def paged_calls(cfg, p, toks, T, device):
        pools = lm.init_paged_caches(cfg, 1 + 3 * 6, 4, device=device)
        pt = np.zeros((3, 6), np.int32)
        pt[0, :4], pt[2, :2] = [1, 2, 3, 4], [5, 6]
        chunk = lm.make_chunk_prefill_step(cfg)
        got = []
        for start in (0, 8):
            tk = np.zeros((1, 8), np.int32)
            piece = toks[0, start:min(start + 8, 11)]
            tk[0, :len(piece)] = piece
            got.append(chunk(p, pools, T(pt[:1]), T([start]), T(tk))[0])
        live = pt.copy()
        live[1:] = 0
        for i in range(4):
            last = np.zeros((3, 1), np.int32)
            last[0, 0] = toks[0, 11 + i]
            got.append(lm.make_paged_decode_step(cfg)(
                p, pools, T(live), T([11 + i, 0, 0]), T(last))[0])
        tk = np.zeros((1, 8), np.int32)
        tk[0, :6] = toks[1, :6]
        got.append(chunk(p, pools, T(pt[2:3]), T([0]), T(tk))[0])
        return got

    out = {}
    for arch in ("llama-60m", "qwen2.5-3b", "deepseek-67b", "gemma2-9b",
                 "gemma3-27b", "qwen2-vl-72b", "qwen2-moe-a2.7b",
                 "qwen3-moe-30b-a3b"):
        cfg = configs.get_smoke(arch)
        if cfg.n_experts:
            cfg = cfg.with_(dtype="float32")
        unit, tol = TOL_SERVE_SMOKE[cfg.dtype]
        base = lm.init(cfg, torch.Generator().manual_seed(0), "cpu").tree()
        paths, leaves = flatten_with_paths(base)
        toks = np.random.RandomState(3).randint(0, cfg.vocab, (2, 68))
        logs = {}
        for device in ("cpu", dev):
            p = unflatten(paths, [l.detach().to(device) for l in leaves])
            T = lambda a, _d=device: torch.tensor(np.asarray(a), device=_d)
            logs[str(device)] = dense_calls(cfg, p, toks, T) \
                if cfg.window or cfg.mrope_sections \
                else paged_calls(cfg, p, toks, T, device)
        errs = [spacing_err(g.float().cpu(), w.float(), unit)
                for g, w in zip(logs[str(dev)], logs["cpu"])]
        print(f"{arch} smoke ({cfg.dtype}) serving steps card vs CPU: max "
              f"{max(errs):.3f} {unit} spacings over {len(errs)} calls")
        if max(errs) > tol:
            raise AssertionError(f"{arch} smoke: card vs CPU {max(errs)} "
                                 f"{unit} spacings > {tol}")
        out[arch] = max(errs)
    return out


# ---------------------------------------------------------------------------
# Phases 29-32: LoRA fine-tuning and merged serving, M-RoPE at qwen2-vl-72b,
# the MoE configs
# ---------------------------------------------------------------------------

LORA_RANK, LORA_ALPHA = 8, 16.0
# the JAX package's engine.state_bytes of the launcher's LoRA (rank 8,
# GWT-2) at full width, per codec (tests/test_torch_lora.py)
LORA_STATE_BYTES = {("llama-60m", "f32"): 1_249_340,
                    ("llama-60m", "int8"): 331_904,
                    ("qwen2.5-3b", "f32"): 29_933_628}
# the adapter buckets K1 and K2 take (f32 p; bf16 g, the model dtype the
# step casts the gradients to), rows merged, in plan order
LORA_BUCKETS = {"llama-60m": [(1, 11008, 8), (5, 64, 512), (6, 4096, 8),
                              (2, 64, 1376)],
                "qwen2.5-3b": [(1, 396288, 8), (3, 288, 2048),
                               (6, 73728, 8), (2, 288, 11008),
                               (2, 288, 256)]}
LORA_SERVE = {"requests": 8, "prompt": 128, "gen": 32}
# phase 29's rounds of A B B A, the LoRA step grouped (A) and with every
# adapter bucket alone (B)
PHASE29_ROUNDS = 1

# The grouped launches the engine makes a step on the H100 (132 SMs; a
# block's 14 chunk slots of 16 KB for K1 and 13 for K2 at bf16 and level
# 2, tests/test_torch_fused_group.py): per configuration, its GWT buckets
# as K1 takes them in plan order, g's and p's dtypes (None: g's), the level,
# and K1's and K2's sets of buckets that share a launch (indices into the
# buckets).  Written out, not taken from kernel.group_plan, which the engine
# calls itself: plan_counts holds the card's plan to these, the counters to
# both.  Bucket lists no row names group nothing (llama-60m's, the 2-layer
# MoE, deepseek, gemma, jamba and seamless cuts: no two neighbouring
# one-pass buckets).
LLAMA_TINY_BUCKETS = [(1, 2752, 256), (2, 1024, 688), (4, 1024, 256)]
# the same cut to COMPARE_LAYERS (2) layers
LLAMA_TINY_2_BUCKETS = [(1, 1376, 256), (2, 512, 688), (4, 512, 256)]
XLSTM_8_BUCKETS = [(7, 2048, 1024), (8, 1024, 4096), (21, 2048, 2048),
                   (1, 1, 4096), (1, 1408, 1024), (2, 1024, 1408)]
PINNED_GROUPS = [
    # 11 + 20 + 24 + 22 = 77 chunks: one launch
    ("llama-60m LoRA adapters", LORA_BUCKETS["llama-60m"], torch.bfloat16,
     torch.float32, 2, [[0, 1, 2, 3]], [[0, 1, 2, 3]]),
    # 387 + 216 + 432 + 774 + 18 = 1827 chunks: K1's 14 x 132 = 1848 holds
    # them; K2's 1716 takes the first three, then the last two
    ("qwen2.5-3b LoRA adapters", LORA_BUCKETS["qwen2.5-3b"], torch.bfloat16,
     torch.float32, 2, [[0, 1, 2, 3, 4]], [[0, 1, 2], [3, 4]]),
    # phase 39's cut: 22 + 12 + 24 + 44 + 2 chunks
    ("qwen2.5-3b 2 layers LoRA adapters",
     [(1, 22016, 8), (3, 16, 2048), (6, 4096, 8), (2, 16, 11008),
      (2, 16, 256)], torch.bfloat16, torch.float32, 2,
     [[0, 1, 2, 3, 4]], [[0, 1, 2, 3, 4]]),
    # phases 22 and 37: bk/bv, bq and wk/wv, 2 + 3 + 1152 chunks; the rest
    # two-pass
    ("qwen2.5-3b 9 layers",
     [(1, 99072, 2048), (2, 18432, 11008), (2, 9, 256), (1, 9, 2048),
      (2, 18432, 256), (2, 18432, 2048)], torch.bfloat16, None, 2,
     [[2, 3, 4]], [[2, 3, 4]]),
    # phase 24's cut: the same three, 2 + 1 + 256 chunks
    ("qwen2.5-3b 2 layers",
     [(1, 22016, 2048), (2, 4096, 11008), (2, 2, 256), (1, 2, 2048),
      (2, 4096, 256), (2, 4096, 2048)], torch.bfloat16, None, 2,
     [[2, 3, 4]], [[2, 3, 4]]),
    # phase 31: the bias buckets, 2 + 1 chunks
    ("qwen2-vl-72b 1 layer",
     [(1, 29568, 8192), (2, 8192, 29568), (2, 1, 1024), (1, 1, 8192),
      (2, 8192, 1024), (2, 8192, 8192)], torch.bfloat16, None, 2,
     [[2, 3]], [[2, 3]]),
    # phase 39: two attention buckets, 256 + 1024 chunks
    ("qwen3-moe-30b-a3b 1 layer",
     [(1, 98304, 2048), (2, 262144, 768), (2, 2048, 512), (1, 4096, 2048),
      (1, 2048, 4096)], torch.bfloat16, None, 2, [[2, 3]], [[2, 3]]),
    # phases 34 and 39: the three one-pass buckets, 1 + 176 + 352 chunks
    ("xlstm-350m 8 layers", XLSTM_8_BUCKETS, torch.bfloat16, None, 2,
     [[3, 4, 5]], [[3, 4, 5]]),
    ("xlstm-350m 8 layers f32", XLSTM_8_BUCKETS, torch.float32, None, 2,
     [[3, 4, 5]], [[3, 4, 5]]),
    # phase 38: the examples' llama-tiny, 86 + 172 + 128 chunks at GWT-2
    ("llama-tiny (the examples) GWT-2", LLAMA_TINY_BUCKETS, torch.bfloat16,
     None, 2, [[0, 1, 2]], [[0, 1, 2]]),
    ("llama-tiny (the examples) GWT-3", LLAMA_TINY_BUCKETS, torch.bfloat16,
     None, 3, [[0, 1, 2]], [[0, 1, 2]]),
    # compare_optimizers at 2 layers: 43 + 86 + 64 chunks at GWT-2
    ("llama-tiny 2 layers GWT-2", LLAMA_TINY_2_BUCKETS, torch.bfloat16,
     None, 2, [[0, 1, 2]], [[0, 1, 2]]),
    ("llama-tiny 2 layers GWT-3", LLAMA_TINY_2_BUCKETS, torch.bfloat16,
     None, 3, [[0, 1, 2]], [[0, 1, 2]]),
]
# phases 31-32: (arch, layers, batch, seq, the JAX package's GWT-2 state
# bytes at that depth).  Every width is the published one; only depth is
# cut, to fit one card: qwen2-vl-72b's 8192 width, 29,568 d_ff and untied
# 152,064 vocab at 1 layer, the MoE configs at 2
NEW_CUTS = [("qwen2-vl-72b", 1, 16, 256, 21_686_865_964),
            ("qwen2-moe-a2.7b", 2, 16, 256, 4_911_505_464),
            ("qwen3-moe-30b-a3b", 2, 16, 256, 7_474_335_776)]
# phase 32's int8 run: the JAX package's state bytes of GWT-2 with blocked
# int8 moments at the 2-layer cut (tests/test_torch_dense.py)
INT8_CUTS = {"qwen3-moe-30b-a3b": 1_985_370_468}
# the expert buckets of the MoE cuts (bf16), found in the plan and timed;
# steps of the second, probed run that reads drops and the aux loss
EXPERT_BUCKETS = {"qwen3-moe-30b-a3b": [(2, 524288, 768),
                                        (1, 196608, 2048)],
                  "qwen2-moe-a2.7b": [(2, 262144, 1408),
                                      (1, 180224, 2048)]}
PROBE_STEPS = CUT_STEPS


def lora_argv(base, codec, ckpt=None, arch="llama-60m", steps=STEPS):
    argv = ["--arch", arch, "--steps", str(steps), "--batch", "16",
            "--seq", "256", "--log-every", "5" if steps >= 10 else "1",
            "--seed", "0",
            "--finetune", "lora", "--lora-rank", str(LORA_RANK),
            "--lora-alpha", str(LORA_ALPHA), "--state-codec", codec]
    if base:
        argv += ["--base-ckpt", base]
    if ckpt:
        argv += ["--ckpt-dir", ckpt, "--ckpt-every", str(steps)]
    return argv


def lora_plan(kernel, arch, q8, check=True, alone=False):
    """The adapter buckets of the launcher's LoRA tree on ``arch`` (checked
    against LORA_BUCKETS unless ``check`` is False: a depth cut's) and
    K1's (``q8``: K2's) counters a step (:func:`plan_counts`)."""
    from repro_torch import configs, optim
    from repro_torch.models import lm, lora
    from repro_torch.optim.base import flatten_with_paths
    tree = lora.inject(lm.abstract_params(configs.get_config(arch)),
                       LORA_RANK, (0, 0))
    shapes = dict(zip(*flatten_with_paths(tree)))
    opt = lora.wrap_optimizer(optim.make("gwt", lr=0.01))
    got = []
    for b in opt.engine.plan(tree).buckets:
        s = tuple(shapes[b.paths[0]].shape)
        if b.name.startswith("gwt"):
            got.append((len(b.paths), math.prod(s[:-1]), s[-1]))
        elif not b.name.startswith("frozen__base."):
            raise AssertionError(f"{arch} LoRA: bucket {b.name}")
    if check and got != LORA_BUCKETS[arch]:
        raise AssertionError(f"{arch} LoRA buckets {got}")
    return plan_counts(kernel, got, configs.get_config(arch).torch_dtype, q8,
                       pdtype=torch.float32, alone=alone)


@contextlib.contextmanager
def buckets_alone():
    """The engine with every GWT bucket alone, as before grouped launches:
    the ops grouping function replaced, inside this script only."""
    from repro_torch.kernels.gwt_adam import ops
    grouping = ops.fused_write_groups
    ops.fused_write_groups = lambda buckets, **kw: [
        [i] for i in range(len(buckets))]
    try:
        yield
    finally:
        ops.fused_write_groups = grouping


def check_buckets_whole(kernel, ref, dev, label, shapes, dtype, kernels,
                        pdtype=None):
    """Each bucket of ``shapes`` (``dtype`` g, ``pdtype`` p: ``dtype``
    where not given) whole, in every CASE: two kernel runs bitwise to each
    other and to the plain version, K1 with each moment dtype of
    ``kernels`` (None: K2)."""
    for shape in shapes:
        t0 = time.perf_counter()
        for mdtype in kernels:
            q8 = mdtype is None
            for ci, case in enumerate(CASES):
                _, use_lim, prev, wd = case
                L = shape[0]
                sd = seed(ci, shape[2], LEVEL, 1)
                ss = torch.tensor(1e-3, device=dev)
                pn = torch.full((L,), prev, device=dev)
                wd_coef = torch.tensor(wd, device=dev)
                kw = dict(level=LEVEL, gamma=1.01, use_limiter=use_lim,
                          weight_decay=wd != 0)
                before = kernel.launches_q8 if q8 else kernel.launches
                if q8:
                    g, *st = make_q8_inputs(shape, sd, dev, dtype=dtype,
                                            pdtype=pdtype)
                    salts = q8_salts(L, dev)
                    us = [t.to(torch.uint32) for t in salts]
                    want = ref.gwt_adam_fused_q8(g, *st, *salts, pn, ss,
                                                 wd_coef, block=QBLOCK, **kw)
                    runs = [kernel.gwt_adam_fused_q8(
                        g, *(t.clone() for t in st), *us, pn, ss, wd_coef,
                        block=QBLOCK, **kw) for _ in range(2)]
                    names = ("p", "qm", "sm", "qv", "sv", "norm")
                else:
                    g, *st = make_inputs(shape, sd, dev, dtype=dtype,
                                         mdtype=mdtype, pdtype=pdtype)
                    want = ref.gwt_adam_fused(g, *st, pn, ss, wd_coef, **kw)
                    runs = [kernel.gwt_adam_fused(
                        g, *(t.clone() for t in st), pn, ss, wd_coef, **kw)
                        for _ in range(2)]
                    names = ("p", "m", "v", "norm")
                torch.cuda.synchronize()
                after = kernel.launches_q8 if q8 else kernel.launches
                if after - before != 2:
                    raise AssertionError(f"{label} {shape}: {after - before}"
                                         f" launches for two calls")
                check_bands(f"{label} {shape} "
                            f"{'K2' if q8 else f'K1 {mdtype}'} / {case[0]}",
                            runs, want, names)
                del runs, want, g, st
        print(f"{label} bucket {shape} g {dtype} p {pdtype or dtype} "
              f"({math.prod(shape)} elements, "
              f"{'one' if one_pass(kernel, shape, dtype, pdtype=pdtype) else 'two'}"
              f"-pass design): {len(CASES)} cases x "
              f"{[str(m) if m else 'K2' for m in kernels]}, two runs and the "
              f"plain version bitwise ({time.perf_counter() - t0:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()


def time_buckets(kernel, ref, dev, label, shapes, dtype, q8=False,
                 pdtype=None):
    """K1's (``q8``: K2's) device time per launch at each bucket of
    ``dtype`` g and ``pdtype`` p (``dtype`` where not given; CUDA events,
    L2 flushed, best of two runs of 10), the plain version's, the bound;
    one launch a step each."""
    rows = []
    flush = torch.empty(64 << 20, device=dev)
    ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(level=LEVEL, gamma=1.01, use_limiter=True, weight_decay=False)
    esize = torch.empty((), dtype=dtype).element_size()
    psize = torch.empty((), dtype=pdtype or dtype).element_size()
    for shape in shapes:
        pn = torch.full((shape[0],), 1e9, device=dev)
        if q8:
            inputs = make_q8_inputs(shape, 7, dev, dtype=dtype,
                                    pdtype=pdtype)
            salts = q8_salts(shape[0], dev)
            us = [t.to(torch.uint32) for t in salts]
            call = lambda: kernel.gwt_adam_fused_q8(
                *inputs, *us, pn, ss, wd, block=QBLOCK, **kw)
            plain = lambda: ref.gwt_adam_fused_q8(
                *inputs, *salts, pn, ss, wd, block=QBLOCK, **kw)
            counter = lambda: kernel.launches_q8
            b_ms, b_by, nbytes = bound_q8(shape, esize, psize)
        else:
            inputs = make_inputs(shape, 7, dev, dtype=dtype, pdtype=pdtype)
            call = lambda: kernel.gwt_adam_fused(*inputs, pn, ss, wd, **kw)
            plain = lambda: ref.gwt_adam_fused(*inputs, pn, ss, wd, **kw)
            counter = lambda: kernel.launches
            b_ms, b_by, nbytes = bound(shape, esize, psize=psize)
        t_dev = min(device_ms(call, 10, counter, flush) for _ in range(2))
        t_plain = time_ms(plain, 1)
        row = {"bucket": f"{label} {list(shape)}", "shape": list(shape),
               "per_step": 1, "ms": t_dev, "plain_ms": t_plain,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "design": "one" if one_pass(kernel, shape, dtype, q8, pdtype)
               else "two"}
        print(f"{'K2' if q8 else 'K1'} time {label} {shape} g {dtype} p "
              f"{pdtype or dtype}: "
              f"{row['design']}-pass {t_dev:.4f} ms on the device "
              f"({b_ms / t_dev:.1%} of bound {b_ms:.4f} ms by {b_by}); plain "
              f"{t_plain:.4f} ms")
        rows.append(row)
        del inputs, call, plain
        torch.cuda.empty_cache()
    return rows


def lora_finetune(train, kernel, hk, label, argv, arch, codec, steps,
                  alone=False):
    """One ``--finetune lora`` run of the launcher, the counts set to 0
    just before and read just after: K1 (int8: K2) as the plan groups the
    adapter buckets each step (``alone``: every bucket alone), in the
    designs it names; the state the JAX package's bytes."""
    from repro_torch.optim.engine import state_bytes
    q8 = codec == "int8"
    per_step = lora_plan(kernel, arch, q8, alone=alone)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel, hk)
    t0 = time.perf_counter()
    with buckets_alone() if alone else contextlib.nullcontext():
        res = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update({k: v * steps for k, v in per_step.items()})
    if counts != want:
        raise AssertionError(f"{label}: launched {counts}, want {want}")
    nbytes = state_bytes(res.opt_state)
    if nbytes != LORA_STATE_BYTES[arch, codec]:
        raise AssertionError(f"{label}: state {nbytes} B, the JAX package "
                             f"counts {LORA_STATE_BYTES[arch, codec]}")
    if not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"{label}: losses {res.losses}")
    print(f"{label}: {steps} steps in {wall:.2f} s, losses {res.losses}, "
          f"step {res.step_ms:.2f} ms, peak {peak / 2**20:.1f} MiB, adapter "
          f"state {nbytes} B, launches {counts}")
    return res, {"arch": arch, "codec": codec, "steps": steps,
                 "losses": res.losses, "step_ms": res.step_ms,
                 "peak_mib": peak / 2**20, "state_bytes": nbytes,
                 "launches": {k: v for k, v in counts.items() if v},
                 "wall_s": wall}


def run_lora_roundtrip(train, kernel, hk, ref, dev, base):
    """Phase 29: LoRA on phase 26's 20-step llama-60m checkpoint ``base``:
    ``--finetune lora`` 20 steps GWT-2, f32 then int8 moments (K1, K2 4 a
    step at the f32 adapter buckets, held whole against the plain
    version); the base bitwise the checkpoint's after the run; the state
    the JAX package's bytes; then ``launch.serve.main --ckpt`` on the
    fine-tune (merged at load from its run metadata) and the engine's
    tokens against dense ``generate`` on ``lora.merge`` of the restored
    tree, up to a near tie."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_workload
    from repro_torch.models import lm, lora
    from repro_torch.optim.base import flatten_with_paths
    from repro_torch.serve.engine import Engine, EngineConfig
    cfg = configs.get_config("llama-60m")
    base_params, _ = CheckpointManager(base).restore_params(
        None, lm.abstract_params(cfg), device=dev)
    out = {}
    ft = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    try:
        for codec in ("f32", "int8"):
            # the rule at the H100's capacity: one grouped launch a step
            # over the four adapter buckets
            k = "K2" if codec == "int8" else "K1"
            per_step = lora_plan(kernel, "llama-60m", codec == "int8")
            if (per_step[k], per_step[f"{k} group"],
                    per_step[f"{k} group buckets"]) != (1, 1, 4):
                raise AssertionError(f"LoRA {codec}: the plan gives "
                                     f"{per_step}, want one grouped launch "
                                     f"over 4 buckets a step")
            res, summary = lora_finetune(
                train, kernel, hk, f"phase 29 llama-60m LoRA {codec}",
                lora_argv(base, codec, ft if codec == "f32" else None),
                "llama-60m", codec, STEPS)
            for (p, a), b in zip(zip(*flatten_with_paths(res.params["base"])),
                                 flatten_with_paths(base_params)[1]):
                if not torch.equal(a, b):
                    raise AssertionError(f"LoRA {codec}: base {p} moved")
            # the same run with every adapter bucket alone (4 launches a
            # step): bitwise the grouped run's
            alone, summary["alone"] = lora_finetune(
                train, kernel, hk, f"phase 29 llama-60m LoRA {codec}, "
                f"every bucket alone", lora_argv(base, codec), "llama-60m",
                codec, STEPS, alone=True)
            if alone.losses != res.losses:
                raise AssertionError(f"LoRA {codec}: losses grouped "
                                     f"{res.losses}, alone {alone.losses}")
            assert_bitwise(res.params, alone.params,
                           f"LoRA {codec} grouped vs alone, parameters")
            assert_bitwise(res.opt_state, alone.opt_state,
                           f"LoRA {codec} grouped vs alone, state")
            del res, alone
            # the step grouped (A) and alone (B), A B B A, PHASE29_ROUNDS
            # times over: the runs above are the first A B
            runs = {"grouped": [summary["step_ms"]],
                    "alone": [summary["alone"]["step_ms"]]}
            order = ["alone", "grouped"] + ["grouped", "alone", "alone",
                                            "grouped"] * (PHASE29_ROUNDS - 1)
            for side in order:
                res, more = lora_finetune(
                    train, kernel, hk, f"phase 29 llama-60m LoRA {codec}, "
                    f"{side} (timed)", lora_argv(base, codec), "llama-60m",
                    codec, STEPS, alone=side == "alone")
                runs[side].append(more["step_ms"])
                del res
            summary["step_ms_runs"] = runs
            spread = {k: (float(np.mean(v)), min(v), max(v))
                      for k, v in runs.items()}
            summary["step_ms_mean_min_max"] = spread
            print(f"phase 29 llama-60m LoRA {codec}: {STEPS} steps grouped "
                  f"({summary['launches']}) bitwise to every bucket alone "
                  f"({summary['alone']['launches']}): parameters, state, "
                  f"losses; steady step A B B A x {PHASE29_ROUNDS}: grouped "
                  f"{runs['grouped']} ms (mean {spread['grouped'][0]}), "
                  f"alone {runs['alone']} ms (mean {spread['alone'][0]}); "
                  f"card {smi()}")
            out[codec] = summary
        check_buckets_whole(kernel, ref, dev, "LoRA llama-60m",
                            LORA_BUCKETS["llama-60m"], cfg.torch_dtype,
                            (torch.float32, None), pdtype=torch.float32)
        reset_counts(kernel, hk)
        spec = LORA_SERVE
        argv = ["--arch", "llama-60m", "--ckpt", ft, "--requests",
                str(spec["requests"]), "--prompt-len", str(spec["prompt"]),
                "--gen", str(spec["gen"]), "--num-slots", str(SERVE_SLOTS),
                "--page-size", str(SERVE_PAGE), "--prefill-chunk",
                str(SERVE_CHUNK)]
        out["serve_launcher"] = serve.main(argv)
        tree, _ = CheckpointManager(ft).restore_params(
            None, lora.inject(lm.abstract_params(cfg), LORA_RANK, (0, 0)),
            device=dev)
        merged = lora.merge(tree, LORA_ALPHA, LORA_RANK)
        moved = sum(not torch.equal(a, b) for a, b in zip(
            flatten_with_paths(merged)[1], flatten_with_paths(base_params)[1]))
        ecfg = EngineConfig(num_slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                            max_ctx=spec["prompt"] + spec["gen"],
                            prefill_chunk=SERVE_CHUNK)
        eng = Engine.from_checkpoint(cfg, ft, ecfg, device=dev)
        for (p, a), b in zip(zip(*flatten_with_paths(eng.params)),
                             flatten_with_paths(merged)[1]):
            if not torch.equal(a, b):
                raise AssertionError(f"served {p} is not lora.merge's")
        reqs = build_workload(spec["requests"], cfg.vocab, spec["prompt"],
                              spec["gen"], 0.0, seed=1)
        eng.run(reqs)
        if any(all_counts(kernel, hk).values()):
            raise AssertionError(f"LoRA serving launched "
                                 f"{all_counts(kernel, hk)}")
        dense = {}
        for r in reqs:
            toks, logits = dense_pass(cfg, merged, list(r.prompt),
                                      r.max_gen, dev)
            top2 = logits.topk(2, dim=-1).values
            dense[r.rid] = (toks, (top2[:, 0] - top2[:, 1]).tolist(),
                            float(np.spacing(np.float32(
                                logits.abs().max().item()))) * 2 ** 16)
        near = check_against_dense("LoRA llama-60m served", reqs, dense,
                                   TOL_SERVE_BF16_SPACINGS)
        print(f"phase 29: the fine-tune merged at load moves {moved} "
              f"leaves; {len(reqs)} requests served equal dense generate "
              f"on lora.merge's weights up to {len(near)} near-tie "
              f"divergences")
        out.update(merged_leaves_moved=moved, near_tie_divergences=near)
    finally:
        shutil.rmtree(ft, ignore_errors=True)
    out["k1_adapter_buckets"] = time_buckets(
        kernel, ref, dev, "LoRA llama-60m", LORA_BUCKETS["llama-60m"],
        cfg.torch_dtype, pdtype=torch.float32)
    out["k2_adapter_buckets"] = time_buckets(
        kernel, ref, dev, "LoRA llama-60m", LORA_BUCKETS["llama-60m"],
        cfg.torch_dtype, q8=True, pdtype=torch.float32)
    return out


def run_lora_qwen(train, kernel, hk, ref, dev):
    """Phase 30: LoRA at qwen2.5-3b full width and depth, a random-init
    base, 5 steps: step time, peak memory, adapter state bytes; the
    merge's share of the step (``lora.merge`` of the run's tree timed
    alone); K1 at the adapter buckets timed and held whole."""
    from repro_torch.models import lora
    res, out = lora_finetune(train, kernel, hk, "phase 30 qwen2.5-3b LoRA",
                             lora_argv(None, "f32", arch="qwen2.5-3b",
                                       steps=CUT_STEPS),
                             "qwen2.5-3b", "f32", CUT_STEPS)
    tree = res.params
    del res
    with torch.no_grad():
        merge_ms = time_ms(lambda: lora.merge(tree, LORA_ALPHA, LORA_RANK),
                           3)
    out["merge_ms"] = merge_ms
    out["merge_share"] = merge_ms / out["step_ms"]
    print(f"phase 30: lora.merge alone {merge_ms:.2f} ms = "
          f"{out['merge_share']:.1%} of the {out['step_ms']:.2f} ms step "
          f"(the step merges once in the forward)")
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    check_buckets_whole(kernel, ref, dev, "LoRA qwen2.5-3b",
                        LORA_BUCKETS["qwen2.5-3b"], torch.bfloat16,
                        (torch.float32,), pdtype=torch.float32)
    out["k1_adapter_buckets"] = time_buckets(
        kernel, ref, dev, "LoRA qwen2.5-3b", LORA_BUCKETS["qwen2.5-3b"],
        torch.bfloat16, pdtype=torch.float32)
    return out


# ---------------------------------------------------------------------------
# Phase 40: the grouped K1 and K2 (kernel.gwt_adam_fused_group,
# gwt_adam_fused_q8_group), one launch over several one-pass buckets.
# Each set is held in every CASE with K1 over f32 and bf16 moments and
# with K2: every output bitwise the same buckets' per-bucket launches and
# the grouped plain version; each bucket has its own step size and weight
# decay, so a bucket's scalars reaching another shows.  Then each set is
# timed as grouped launches beside its per-bucket launches, A B B A.
def grouped_set(row):
    """A PINNED_GROUPS row as a GROUP_SETS set: the buckets its launches
    take, and the launches as indices into them."""
    label, shapes, dtype, pdtype, level, k1, k2 = row
    members = sorted({i for x in k1 + k2 for i in x})
    at = {i: j for j, i in enumerate(members)}
    return (label, [shapes[i] for i in members], dtype, pdtype, level,
            [[at[i] for i in x] for x in k1], [[at[i] for i in x] for x in k2])


# (label, shapes, g dtype, p dtype (None: g's), level, K1's launches, K2's)
GROUP_SETS = [grouped_set(row) for row in PINNED_GROUPS] + [
    # qwen2.5-3b's one-pass buckets at full depth: the stacked QKV biases
    ("qwen2.5-3b bias buckets", [(2, 36, 256), (1, 36, 2048)],
     torch.bfloat16, None, LEVEL, [[0, 1]], [[0, 1]]),
    # a FIRST-mode leaf's transposed stack with two LAST-mode buckets of
    # other widths (the bias buckets), bf16 p: the GWT rules share a group
    ("FIRST-mode with LAST-mode", [FIRST_SHAPE[1], (2, 36, 256),
                                   (1, 36, 2048)], torch.bfloat16, None,
     LEVEL, [[0, 1, 2]], [[0, 1, 2]]),
]
# the sets time_groups times, in this order
TIMED_GROUP_SETS = ("llama-60m LoRA adapters", "qwen2.5-3b LoRA adapters",
                    "qwen2.5-3b bias buckets")
# a FIRST-mode bucket and a bucket of another level: group_plan splits
# them, the grouped wrappers refuse them
GROUP_MIXED_LEVELS = [(FIRST_SHAPE[1], LEVEL), ((2, 36, 256), LEVEL + 1)]
# grouped K1's and K2's kernels: (label, K2?, moment dtype)
GROUP_KERNELS = WHOLE_KERNELS


def grouped_calls(shapes, dtype, pdtype, mdtype, case, dev, ci,
                  level=LEVEL):
    """One CASE's per-bucket calls over ``shapes`` (K2 where ``mdtype`` is
    None): the kernel's ``(args, kw)`` each (fresh copies of the inputs
    each time it is called: ``calls()``) and the plain version's."""
    _, use_lim, prev, wd = case
    kw = dict(level=level, gamma=1.01, use_limiter=use_lim,
              weight_decay=wd != 0)
    plain, inputs = [], []
    for k, shape in enumerate(shapes):
        L = shape[0]
        sd = seed(ci, shape[2], level, 1) + 31 * k
        pn = torch.full((L,), prev, device=dev)
        ss = torch.tensor(1e-3 * (k + 1), device=dev)
        wd_coef = torch.tensor(wd * (k + 1), device=dev)
        if mdtype is None:
            g, *st = make_q8_inputs(shape, sd, dev, level, dtype=dtype,
                                    pdtype=pdtype)
            salts = q8_salts(L, dev, step=3 + k)
            us = [t.to(torch.uint32) for t in salts]
            plain.append(((g, *st, *salts, pn, ss, wd_coef),
                          dict(kw, block=QBLOCK)))
            inputs.append((g, st, us, pn, ss, wd_coef))
        else:
            g, *st = make_inputs(shape, sd, dev, level, dtype=dtype,
                                 mdtype=mdtype, pdtype=pdtype)
            plain.append(((g, *st, pn, ss, wd_coef), kw))
            inputs.append((g, st, [], pn, ss, wd_coef))

    def calls():
        return [((g, *(t.clone() for t in st), *us, pn, ss, wd_coef),
                 dict(kw, block=QBLOCK) if us else kw)
                for g, st, us, pn, ss, wd_coef in inputs]
    return calls, plain


def group_launches(kernel, name, shapes, dtype, pdtype, mdtype,
                   level=LEVEL):
    """``kernel.group_plan``'s launches of ``shapes`` at the card's
    capacity for these dtypes."""
    sms, smem = kernel.capacity(name, dtype, level, mdtype or torch.float32,
                                pdtype or dtype)
    return kernel.group_plan([(s, dtype, level, None) for s in shapes], sms,
                             smem)


def launch_sets(grouped, launches, calls):
    """Each of ``launches`` (index lists into ``calls``) as one grouped
    call; the results in the calls' order."""
    out = [None] * len(calls)
    for launch in launches:
        for i, r in zip(launch, grouped([calls[i] for i in launch])):
            out[i] = r
    return out


def check_groups(kernel, ref, dev):
    """Phase 40's checks: every GROUP_SETS set in every CASE with each of
    GROUP_KERNELS, each pinned launch one grouped call: grouped ==
    per-bucket == grouped plain on every output, each call counted once
    by launch and by its buckets, the card's ``group_plan`` the pinned
    launches; the mixed-level set split by the plan and refused by both
    wrappers.  Returns each set's launches per kernel and the largest
    |grouped - plain| and |grouped - per-bucket| measured."""
    t0 = time.perf_counter()
    out, err = {}, 0.0
    for label, shapes, dtype, pdtype, level, k1, k2 in GROUP_SETS:
        out[label] = {}
        for klabel, q8, mdtype in GROUP_KERNELS:
            name = "gwt_adam_fused_q8" if q8 else "gwt_adam_fused"
            launches = k2 if q8 else k1
            planned = group_launches(kernel, name, shapes, dtype, pdtype,
                                     mdtype, level)
            if planned != launches or sorted(
                    i for x in launches for i in x) != list(range(
                        len(shapes))):
                raise AssertionError(f"{label} {klabel}: group_plan on "
                                     f"this card gives {planned}, pinned "
                                     f"{launches}")
            grouped = kernel.gwt_adam_fused_q8_group if q8 \
                else kernel.gwt_adam_fused_group
            single = kernel.gwt_adam_fused_q8 if q8 \
                else kernel.gwt_adam_fused
            plain = ref.gwt_adam_fused_q8_group if q8 \
                else ref.gwt_adam_fused_group
            names = ("p", "qm", "sm", "qv", "sv", "norm") if q8 \
                else ("p", "m", "v", "norm")
            for ci, case in enumerate(CASES):
                calls, plain_calls = grouped_calls(
                    shapes, dtype, pdtype, mdtype, case, dev, ci, level)
                want = plain(plain_calls)
                per = [single(*a, **kw) for a, kw in calls()]
                fresh = calls()
                before = all_group_counts(kernel)
                got = launch_sets(grouped, launches, fresh)
                torch.cuda.synchronize()
                counts = {k: v - before[k]
                          for k, v in all_group_counts(kernel).items()}
                k = "K2" if q8 else "K1"
                wcounts = {k: len(launches), f"{k} group": len(launches),
                           f"{k} group buckets": len(shapes)}
                if {c: counts[c] for c in wcounts} != wcounts:
                    raise AssertionError(f"{label} {klabel} {case[0]}: "
                                         f"counted {counts}, want {wcounts}")
                for shape, a, b, w in zip(shapes, got, per, want):
                    err = max(err, check_bands(
                        f"grouped {klabel} {label} {shape} / {case[0]}",
                        [a, b], w, names),
                        max(abs_err(x, y) for x, y in zip(a, b)))
                del got, per, want, fresh
            out[label][klabel] = launches
            for launch in launches:
                plan = kernel.group_launch_plan(
                    name, [shapes[i] for i in launch], dtype, level,
                    mdtype or torch.float32, pdtype)
                print(f"phase 40 group plan {name} {label} {launch} "
                      f"({klabel}): {plan['regs']} registers/thread, "
                      f"{plan['local_bytes']} B local, "
                      f"{plan['blocks_per_sm']} blocks/SM x "
                      f"{plan['slots']} chunk slots, grid {plan['grid']}")
        print(f"phase 40 {label} {shapes} {dtype} l={level}: grouped K1 "
              f"(f32 and bf16 moments) and K2 in {len(CASES)} cases "
              f"bitwise to the per-bucket launches and the grouped plain "
              f"version; launches {out[label]}")
    # mixed levels: split by the plan, refused by the wrappers
    (s0, l0), (s1, l1) = GROUP_MIXED_LEVELS
    dtype = torch.bfloat16
    sms, smem = kernel.capacity("gwt_adam_fused", dtype, l0)
    split = kernel.group_plan([(s0, dtype, l0, None), (s1, dtype, l1, None)],
                              sms, smem)
    if split != [[0], [1]]:
        raise AssertionError(f"mixed levels planned as {split}")
    for q8 in (False, True):
        calls = []
        for shape, level in GROUP_MIXED_LEVELS:
            c, _ = grouped_calls([shape], dtype, None,
                                 None if q8 else torch.float32, CASES[0],
                                 dev, 0, level)
            calls += c()
        before = all_group_counts(kernel)
        try:
            (kernel.gwt_adam_fused_q8_group if q8
             else kernel.gwt_adam_fused_group)(calls)
        except ValueError as e:
            if "level" not in str(e):
                raise
        else:
            raise AssertionError("a group of two levels was launched")
        if all_group_counts(kernel) != before:
            raise AssertionError("a refused group counted launches")
    print(f"phase 40: a FIRST-mode bucket and a level-{l1} bucket planned "
          f"as {split}, refused by both grouped wrappers; max |diff| {err}; "
          f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out, err


def all_group_counts(kernel):
    return {"K1": kernel.launches, "K1 group": kernel.launches_group,
            "K1 group buckets": kernel.buckets_group,
            "K2": kernel.launches_q8, "K2 group": kernel.launches_q8_group,
            "K2 group buckets": kernel.buckets_q8_group}


def time_groups(kernel, ref, dev):
    """Phase 40's times: per set and kernel (K1 f32 moments, K2), one
    step's grouped launches beside the same buckets' per-bucket launches
    in the same call, A B B A (device ms: CUDA events around each call, L2
    flushed before it, the best of each side's runs of 10), the bounds
    (``bound``, ``bound_q8``), the grouped plain version, and each
    wrapper's host µs a call."""
    flush = torch.empty(64 << 20, device=dev)
    rows = []
    sets = {row[0]: row for row in GROUP_SETS}
    for label, shapes, dtype, pdtype, level, k1, k2 in (
            sets[t] for t in TIMED_GROUP_SETS):
        for klabel, q8, mdtype in (GROUP_KERNELS[0], GROUP_KERNELS[2]):
            launches = k2 if q8 else k1
            calls, plain_calls = grouped_calls(
                shapes, dtype, pdtype, mdtype, CASES[1], dev, 1, level)
            fixed = calls()    # timed in place, as the step updates them
            grouped = kernel.gwt_adam_fused_q8_group if q8 \
                else kernel.gwt_adam_fused_group
            single = kernel.gwt_adam_fused_q8 if q8 \
                else kernel.gwt_adam_fused
            plain = ref.gwt_adam_fused_q8_group if q8 \
                else ref.gwt_adam_fused_group
            n, m = len(launches), len(shapes)
            fn = {"group": lambda: launch_sets(grouped, launches, fixed),
                  "single": lambda: [single(*a, **kw) for a, kw in fixed]}
            ctr = {"group": (lambda: kernel.launches_q8_group // n) if q8
                   else (lambda: kernel.launches_group // n),
                   "single": (lambda: (kernel.launches_q8 -
                                       kernel.launches_q8_group) // m)
                   if q8 else (lambda: (kernel.launches -
                                        kernel.launches_group) // m)}
            t = {"group": [], "single": []}
            for side in ("group", "single", "single", "group"):
                t[side].append(device_ms(fn[side], 10, ctr[side], flush))
            t_plain = time_ms(lambda: plain(plain_calls), 1)
            host = {side: host_us(fn[side]) for side in fn}
            esize = dtype.itemsize
            psize = (pdtype or dtype).itemsize
            b = [bound_q8(s, esize, psize) if q8 else bound(s, esize,
                                                             psize=psize)
                 for s in shapes]
            b_ms = sum(x[0] for x in b)
            row = {"set": label, "kernel": klabel,
                   "shapes": [list(s) for s in shapes],
                   "launches": launches, "ms": min(t["group"]),
                   "per_bucket_ms": min(t["single"]), "runs": t,
                   "plain_ms": t_plain, "bound_ms": b_ms,
                   "bound_by": "bytes" if all(x[1] == "bytes" for x in b)
                   else "operations", "bytes": sum(x[2] for x in b),
                   "host_us": host["group"],
                   "per_bucket_host_us": host["single"]}
            print(f"phase 40 time {klabel} {label}: grouped "
                  f"{row['ms']:.4f} ms a step on the device in {n} "
                  f"launch(es) ({b_ms / row['ms']:.1%} of bound "
                  f"{b_ms:.4f} ms by {row['bound_by']}), per-bucket "
                  f"{row['per_bucket_ms']:.4f} ms in {m} launches "
                  f"({b_ms / row['per_bucket_ms']:.1%}); runs A B B A "
                  f"{t['group'][0]:.4f} / {t['single'][0]:.4f} / "
                  f"{t['single'][1]:.4f} / {t['group'][1]:.4f}; host "
                  f"{host['group']:.1f} vs {host['single']:.1f} us a call; "
                  f"plain {t_plain:.3f} ms; card {smi()}")
            rows.append(row)
            del fixed, calls, plain_calls
    torch.cuda.empty_cache()
    return rows


def run_groups(kernel, ref, dev):
    """Phase 40: :func:`check_groups`, then :func:`time_groups`."""
    t0 = time.perf_counter()
    launches, err = check_groups(kernel, ref, dev)
    out = {"launches": launches, "max_abs_err": err,
           "times": time_groups(kernel, ref, dev)}
    out["phase_s"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def moe_probe():
    """Collects each MoE call's dropped pairs and aux loss (device
    scalars, read after the run: no sync in the step)."""
    from repro_torch.models import moe
    seen = {"dropped": [], "pairs": [], "aux": []}
    route, dense = moe.route, moe._moe_dense

    def counted_route(probs, cfg):
        out = route(probs, cfg)
        seen["dropped"].append((out[2] == out[3]).sum().detach())
        seen["pairs"].append(out[2].numel())
        return out

    def counted_dense(p, cfg, x, *rest):
        y, aux = dense(p, cfg, x, *rest)
        seen["aux"].append(aux.detach())
        return y, aux

    moe.route, moe._moe_dense = counted_route, counted_dense
    try:
        yield seen
    finally:
        moe.route, moe._moe_dense = route, dense


def moe_stats(train, arch, argv, layers, cfg):
    """Dropped pairs and the aux loss of the MoE layers over PROBE_STEPS
    launcher steps with ``moe_probe``, a run apart from the timed one (the
    probe adds a device reduction at every routing)."""
    argv = list(argv)
    argv[argv.index("--steps") + 1] = str(PROBE_STEPS)
    with depth_cut(arch, layers), moe_probe() as seen:
        train.main(argv)
        torch.cuda.synchronize()
    # the backward's recompute (remat) routes the same tokens again but
    # stops before the aux (the checkpoint stops once it has what the
    # backward needs): drops are averaged over every routing, the aux over
    # the forward's
    routes = len(seen["dropped"])
    dropped = torch.stack(seen["dropped"]).cpu().numpy()
    aux = torch.stack(seen["aux"]).float().cpu().numpy()
    out = dict(moe_probe_steps=PROBE_STEPS, moe_routings=routes,
               moe_aux_calls=len(aux),
               dropped_per_step=float(dropped.sum()) * layers / routes,
               routed_pairs_per_call=seen["pairs"][0],
               aux_mean=float(aux.mean()), aux_last=float(aux[-1]),
               capacity_factor=cfg.capacity_factor)
    print(f"{arch}: {routes} routings ({len(aux)} forward) in "
          f"{PROBE_STEPS} probed steps, {out['dropped_per_step']:.1f} of "
          f"{seen['pairs'][0] * layers} routed pairs dropped a step at "
          f"capacity factor {cfg.capacity_factor}, aux loss mean "
          f"{out['aux_mean']:.4f} (last {out['aux_last']:.4f})")
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_new_cuts(train, kernel, hk, ref, dev):
    """Phases 31 and 32: qwen2-vl-72b at 1 layer and the MoE configs at 2,
    full width, 16 x 256, CUT_STEPS steps each through the launcher
    (``run_dense``: K1's launches and designs, the attention routes, the
    JAX package's state bytes, finite losses and parameters); every GWT
    bucket of each cut held whole against the plain version (K2 too where
    the cut also runs int8); the MoE runs also report dropped pairs and
    the aux loss per layer call (``moe_stats``) and time their expert
    buckets."""
    out = []
    for arch, layers, batch, seq, nbytes in NEW_CUTS:
        argv = ["--arch", arch, "--steps", str(CUT_STEPS), "--batch",
                str(batch), "--seq", str(seq), "--log-every", "1",
                "--seed", "0"]
        with depth_cut(arch, layers) as cfg:
            res = run_dense(train, kernel, hk, arch, argv, cfg, CUT_STEPS,
                            nbytes, seq)
        res.update(batch=batch, seq=seq)
        buckets, _ = gwt_buckets(cfg)
        shapes = [s for _, s in buckets]
        check_buckets_whole(
            kernel, ref, dev, f"{arch} cut", shapes, cfg.torch_dtype,
            (torch.float32, None) if arch in INT8_CUTS else (torch.float32,))
        res["buckets_held_whole"] = [list(s) for s in shapes]
        if cfg.n_experts:
            missing = [s for s in EXPERT_BUCKETS[arch] if s not in shapes]
            if missing:
                raise AssertionError(f"{arch}: expert buckets {missing} not "
                                     f"in the plan {shapes}")
            res.update(moe_stats(train, arch, argv, layers, cfg))
            res["k1_expert_buckets"] = time_buckets(
                kernel, ref, dev, f"{arch} experts", EXPERT_BUCKETS[arch],
                torch.bfloat16)
            if arch in INT8_CUTS:
                # K2 on a main path at the expert buckets
                with depth_cut(arch, layers) as cfg8:
                    res["int8"] = run_dense(
                        train, kernel, hk, arch,
                        argv + ["--state-codec", "int8"], cfg8, CUT_STEPS,
                        INT8_CUTS[arch], seq, q8=True)
                res["k2_expert_buckets"] = time_buckets(
                    kernel, ref, dev, f"{arch} experts",
                    EXPERT_BUCKETS[arch], torch.bfloat16, q8=True)
        out.append(res)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 33-35: mamba with jamba-v0.1-52b, mLSTM/sLSTM with xlstm-350m, the
# encoder-decoder stack with seamless-m4t-large-v2
# ---------------------------------------------------------------------------

# (arch, layers or None for full depth, batch, seq, the JAX package's GWT-2
# state bytes at that depth for each codec run: tests/test_torch_ssm.py,
# test_torch_xlstm.py, test_torch_encdec.py; at a cut depth the JAX
# package's engine.state_bytes on the cut config's abstract parameters).
# Every width is the published one.  jamba is cut to the first five kinds
# of its period (mamba, mamba+moe, mamba, mamba+moe, attn): every kind it
# has, no whole period; xlstm-350m to one period of its three (seven mLSTM
# blocks and an sLSTM: 1,286,170,084 / 341,639,144 B at full depth), to
# keep the script within its time; seamless takes seq // 4 = 64 frames a
# row
# phase 35's seamless at 6 + 6 of its 12 + 12 layers (PR 31 cut it for
# time; every width and kernel design kept; 3,609,296,972 state bytes at
# the full depth)
SEAMLESS_PHASE_CUT = {"n_layers": 12, "n_enc_layers": 6, "n_dec_layers": 6}
SUBSTRATE_RUNS = [
    ("jamba-v0.1-52b", 5, 16, 256, {"f32": 17_665_458_288}),
    ("xlstm-350m", 8, 16, 256, {"f32": 703_455_844,
                                "int8": 186_855_688}),
    ("seamless-m4t-large-v2", SEAMLESS_PHASE_CUT, 16, 256,
     {"f32": 2_854_076_492}),
]
SUBSTRATE_STEPS = 5
# a bucket past this many elements is held leaf by leaf: the plain
# version's f32 temporaries of the whole bucket (15 GB each at jamba's
# 3.76e9-element expert bucket) do not fit beside it on the card
WHOLE_PLAIN_MAX = 2 ** 31
# jamba's expert buckets, checked against the plan: w_gate/w_up of the two
# MoE blocks ((16, 4096, 14336) each; 3.76e9 elements, past 2^31) and w_down
JAMBA_EXPERT_BUCKETS = [(4, 65536, 14336), (2, 229376, 4096)]
# a smoke config's cached decode on the card against its own train forward
# (teacher forcing, for the encoder-decoder): the reference test's
# atol = rtol
TOL_DECODE = 0.05
PROFILED_SUBSTRATE_STEPS = 1


def leaf_inputs(shape, seed_, dev, dtype=torch.bfloat16):
    """K1's inputs as :func:`make_inputs` draws them, one leaf at a time
    (so no f32 temporary of the whole bucket is made), f32 moments."""
    L, m, n = shape
    g = torch.empty(shape, dtype=dtype, device=dev)
    p = torch.empty(shape, dtype=dtype, device=dev)
    mm = torch.empty((L, m, n >> LEVEL), device=dev)
    vv = torch.empty((L, m, n >> LEVEL), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed_)
    for l in range(L):
        g[l] = torch.randn(m, n, generator=gen, device=dev) * 0.01
        p[l] = torch.randn(m, n, generator=gen, device=dev) * 0.02
        mm[l] = torch.randn(m, n >> LEVEL, generator=gen, device=dev) * 1e-3
        vv[l] = torch.rand(m, n >> LEVEL, generator=gen, device=dev) * 1e-6
    return g, p, mm, vv


def check_bucket_by_leaf(kernel, ref, dev, label, shape, dtype):
    """A bucket past WHOLE_PLAIN_MAX in every CASE: K1 (f32 moments) on
    the whole bucket, then on each leaf alone, bitwise equal (a leaf's sums
    run in its own chunks, whatever the bucket), and each leaf's launch
    bitwise to the plain version on that leaf (p, m, v, norm)."""
    L = shape[0]
    t0 = time.perf_counter()
    for ci, case in enumerate(CASES):
        _, use_lim, prev, wd = case
        g, p, mm, vv = leaf_inputs(shape, seed(ci, shape[2], LEVEL, 1), dev,
                                   dtype)
        ss = torch.tensor(1e-3, device=dev)
        pn = torch.full((L,), prev, device=dev)
        wd_coef = torch.tensor(wd, device=dev)
        kw = dict(level=LEVEL, gamma=1.01, use_limiter=use_lim,
                  weight_decay=wd != 0)
        before = kernel.launches
        whole = kernel.gwt_adam_fused(g, p.clone(), mm.clone(), vv.clone(),
                                      pn, ss, wd_coef, **kw)
        for l in range(L):
            sl = slice(l, l + 1)
            one = kernel.gwt_adam_fused(g[sl], p[sl].clone(),
                                        mm[sl].clone(), vv[sl].clone(),
                                        pn[sl], ss, wd_coef, **kw)
            want = ref.gwt_adam_fused(g[sl], p[sl], mm[sl], vv[sl], pn[sl],
                                      ss, wd_coef, **kw)
            torch.cuda.synchronize()
            check_bands(f"{label} {shape} leaf {l} / {case[0]}",
                        [one, tuple(t[sl] for t in whole)], want,
                        ("p", "m", "v", "norm"))
            del one, want
        torch.cuda.synchronize()
        if kernel.launches - before != 1 + L:
            raise AssertionError(f"{label} {shape}: "
                                 f"{kernel.launches - before} launches")
        del g, p, mm, vv, whole
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{label} bucket {shape} g {dtype} ({math.prod(shape)} elements, "
          f"{'one' if one_pass(kernel, shape, dtype) else 'two'}-pass "
          f"design): {len(CASES)} cases, the whole-bucket launch bitwise to "
          f"one launch per leaf and each leaf bitwise to the plain version "
          f"({time.perf_counter() - t0:.1f} s)")


def substrate_routes(cfg, seq, steps):
    """Attention route calls of ``steps`` launcher steps (each forward
    once more under remat): one direct call per attention block of the
    decoder-only stacks (no window, ``seq`` <= 8192), none for a recurrent
    block; the encoder-decoder's encoder self-attention (``seq // 4``
    frames) and the decoder's self- and cross-attention, direct at these
    lengths."""
    if cfg.window or seq > 4096:
        raise ValueError("substrate_routes counts direct routes only")
    want = dict.fromkeys(ROUTES, 0)
    per = steps * (2 if cfg.remat else 1)
    if cfg.arch_class == "encdec":
        want["_direct_attn"] = per * (cfg.n_enc_layers
                                      + 2 * cfg.n_dec_layers)
        return want
    kinds = list(cfg.pattern) * cfg.n_periods + \
        list(cfg.pattern[:cfg.rem_layers])
    want["_direct_attn"] = per * sum(k.split("+")[0] == "attn"
                                     for k in kinds)
    return want


@contextlib.contextmanager
def slstm_steps():
    """Counts the calls of ``xlstm.slstm_step`` (one position of an sLSTM
    block's time loop) while the block runs."""
    from repro_torch.models import xlstm
    calls = [0]
    step = xlstm.slstm_step

    def counted(*args, **kw):
        calls[0] += 1
        return step(*args, **kw)

    xlstm.slstm_step = counted
    try:
        yield calls
    finally:
        xlstm.slstm_step = step


def run_substrate(train, kernel, hk, arch, cfg, batch, seq, codec,
                  state_bytes_want):
    """One launcher run of ``cfg`` (the counts set to 0 just before and
    read just after): K1's (int8: K2's) launches and designs by plan,
    nothing else launched, the attention routes, the sLSTM loop's steps,
    the JAX package's state bytes, losses finite and falling, parameters
    finite.  Returns a summary."""
    from repro_torch.optim.base import flatten_with_paths
    from repro_torch.optim.engine import state_bytes
    q8 = codec == "int8"
    steps = SUBSTRATE_STEPS
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--log-every", "1", "--seed", "0",
            "--state-codec", codec]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with route_counts() as routes, slstm_steps() as loop:
        reset_counts(kernel, hk)
        t0 = time.perf_counter()
        res = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts(kernel, hk)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update(fused_plan_counts(kernel, cfg, steps, q8))
    if counts != want:
        raise AssertionError(f"{arch} {codec}: launched {counts} in {steps} "
                             f"steps, want {want}")
    if routes != substrate_routes(cfg, seq, steps):
        raise AssertionError(f"{arch}: attention routes {routes}, want "
                             f"{substrate_routes(cfg, seq, steps)}")
    n_slstm = sum(k == "slstm" for k in cfg.pattern) * cfg.n_periods
    loop_want = n_slstm * seq * steps * (2 if cfg.remat else 1)
    if loop[0] != loop_want:
        raise AssertionError(f"{arch}: {loop[0]} sLSTM steps, want "
                             f"{loop_want}")
    nbytes = state_bytes(res.opt_state)
    if nbytes != state_bytes_want:
        raise AssertionError(f"{arch} {codec}: state {nbytes} B, the JAX "
                             f"package counts {state_bytes_want}")
    losses = res.losses
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} {codec}: losses {losses} not finite "
                             f"and falling")
    for name, t in zip(*flatten_with_paths(res.params)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{arch}: non-finite parameter {name}")
    k = "K2" if q8 else "K1"
    out = {"arch": arch, "codec": codec, "layers": cfg.n_layers,
           "batch": batch, "seq": seq, "steps": steps, "losses": losses,
           "step_ms": res.step_ms,
           "tokens_per_s": batch * seq / (res.step_ms / 1e3),
           "peak_mib": peak / 2**20, "base_mib": base / 2**20,
           "state_bytes": nbytes, "routes": routes,
           "slstm_steps_per_step": loop[0] // steps, "wall_s": wall,
           f"{k.lower()}_launches": counts[k],
           f"{k.lower()}_one_pass": counts[f"{k} one-pass"],
           f"{k.lower()}_two_pass": counts[f"{k} two-pass"]}
    print(f"{arch} ({cfg.n_layers} layers, {batch} x {seq}, {codec}): "
          f"{steps} steps in {wall:.2f} s, losses {losses}, step "
          f"{res.step_ms:.2f} ms ({out['tokens_per_s']:.0f} tokens/s), peak "
          f"{peak / 2**20:.1f} MiB (held before {base / 2**20:.1f}), state "
          f"{nbytes} B, {k} {counts[k]} ({counts[f'{k} one-pass']} one "
          f"pass, {counts[f'{k} two-pass']} two), routes {routes}, sLSTM "
          f"steps {loop[0]}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def time_bucket_by_leaf(kernel, ref, dev, label, shape, dtype):
    """K1's device time at a bucket past WHOLE_PLAIN_MAX (CUDA events, L2
    flushed, best of two runs of 5), its bound, and the plain version's
    time summed over the leaves (the whole bucket's does not fit)."""
    flush = torch.empty(64 << 20, device=dev)
    ss, wd = torch.tensor(1e-3, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(level=LEVEL, gamma=1.01, use_limiter=True, weight_decay=False)
    pn = torch.full((shape[0],), 1e9, device=dev)
    g, p, mm, vv = leaf_inputs(shape, 7, dev, dtype)
    call = lambda: kernel.gwt_adam_fused(g, p, mm, vv, pn, ss, wd, **kw)
    t_dev = min(device_ms(call, 5, lambda: kernel.launches, flush)
                for _ in range(2))
    t_plain = 0.0
    for l in range(shape[0]):
        sl = slice(l, l + 1)
        t_plain += time_ms(lambda: ref.gwt_adam_fused(
            g[sl], p[sl], mm[sl], vv[sl], pn[sl], ss, wd, **kw), 1)
        torch.cuda.empty_cache()
    esize = torch.empty((), dtype=dtype).element_size()
    b_ms, b_by, nbytes = bound(shape, esize)
    row = {"bucket": f"{label} {list(shape)}", "shape": list(shape),
           "per_step": 1, "ms": t_dev, "plain_ms": t_plain,
           "plain_by_leaf": True, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes,
           "design": "one" if one_pass(kernel, shape, dtype) else "two"}
    print(f"K1 time {label} {shape} g {dtype}: {row['design']}-pass "
          f"{t_dev:.4f} ms on the device ({b_ms / t_dev:.1%} of bound "
          f"{b_ms:.4f} ms by {b_by}); plain {t_plain:.4f} ms (by leaf)")
    del g, p, mm, vv, call, flush
    torch.cuda.empty_cache()
    return row


def profile_slstm(dev, cfg, batch, seq):
    """Kernel launches and device time of one sLSTM block of ``cfg`` as
    the train step runs it (the block under remat: the forward, then the
    recomputed forward and the backward), at batch x seq, under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import blocks, lm
    from repro_torch.models.layers import Builder
    from repro_torch.optim.base import tree_map
    b = Builder(torch.Generator(device=dev).manual_seed(2), dev,
                cfg.torch_dtype)
    p = tree_map(lambda t: t.requires_grad_(),
                 blocks.block_init(b, cfg, "slstm"))
    x = torch.randn(batch, seq, cfg.d_model, device=dev,
                    dtype=cfg.torch_dtype, requires_grad=True)

    def run():
        y, _ = lm._block(cfg, "slstm", p, x, None, None)
        y.float().sum().backward()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"launches": len(kernels),
            "device_ms": sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3}


def smoke_decode(dev, cfg):
    """On the card: a smoke config's prefill of 28 positions and 4 cached
    decode steps against its own train forward (the encoder-decoder: the
    decoder's prefill over 8 frames and ``decode_stack``'s decode against
    teacher forcing), each within TOL_DECODE.  Returns the largest
    |difference|."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import module_for
    mod = module_for(cfg)
    model = mod.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = model.tree()
    S, prefix = 32, 28
    rng = np.random.RandomState(3)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, S))).to(dev)
    batch = {"tokens": toks[:, :prefix]}
    if cfg.arch_class == "encdec":
        frames = torch.from_numpy(rng.randn(2, 8, cfg.d_model)
                                  .astype(np.float32)).to(dev)
        batch["enc_embeds"] = frames
        with torch.no_grad():
            full = model(toks, frames).float()
    else:
        with torch.no_grad():
            full = model(toks).float()
    logits, cache = mod.make_prefill_step(cfg)(params, batch)
    if cfg.arch_class == "encdec":
        cache = {"dec": {"self": pad_cache(cache["dec"]["self"], S),
                         "cross": cache["dec"]["cross"]},
                 "pos": cache["pos"]}
    else:
        cache = pad_cache(cache, S)
    pairs = [(logits, full[:, prefix - 1])]
    decode = mod.make_decode_step(cfg)
    for t in range(prefix, S):
        logits, cache = decode(params, cache, {"tokens": toks[:, t:t + 1]})
        pairs.append((logits, full[:, t]))
    worst = 0.0
    for i, (got, want) in enumerate(pairs):
        diff = (got.float() - want).abs()
        if not bool((diff <= TOL_DECODE + TOL_DECODE * want.abs()).all()):
            raise AssertionError(f"{cfg.name} smoke: cached step {i} off "
                                 f"the train forward by {diff.max().item()}")
        worst = max(worst, diff.max().item())
    print(f"{cfg.name} smoke ({cfg.dtype}) on the card: prefill + "
          f"{S - prefix} cached decode steps against the "
          f"{'teacher-forced' if cfg.arch_class == 'encdec' else 'train'} "
          f"forward, max |diff| {worst:.4g} (atol = rtol = {TOL_DECODE})")
    return worst


def run_substrates(train, kernel, hk, ref, dev):
    """Phases 33-35, one per config of SUBSTRATE_RUNS: the launcher's runs
    (``run_substrate``; xlstm-350m with f32 and int8 moments), every GWT
    bucket of the run held against the plain version in every CASE (K1
    with f32 moments, K2 too after an int8 run; whole, or leaf by leaf past
    WHOLE_PLAIN_MAX), K1 (K2) timed at each bucket, a profiled step
    (launches, idle share; xlstm-350m's sLSTM blocks' launches apart), and
    the smoke config card vs CPU (3 steps, f32 and bf16; int8 too for
    xlstm-350m) and its cached decode on the card."""
    from repro_torch import configs
    out = []
    for phase, (arch, layers, batch, seq, state) in enumerate(
            SUBSTRATE_RUNS, start=33):
        t0 = time.perf_counter()
        parts = {}

        def lap(name, _t=[t0]):
            now = time.perf_counter()
            parts[name] = now - _t[0]
            _t[0] = now

        cut = depth_cut(arch, layers) if layers else \
            contextlib.nullcontext(configs.get_config(arch))
        res = {"phase": phase, "arch": arch}
        with cut as cfg:
            for codec, nbytes in state.items():
                res[codec] = run_substrate(train, kernel, hk, arch, cfg,
                                           batch, seq, codec, nbytes)
        lap("launcher")
        buckets, _ = gwt_buckets(cfg)
        shapes = [s for _, s in buckets]
        if arch == "jamba-v0.1-52b":
            missing = [s for s in JAMBA_EXPERT_BUCKETS if s not in shapes]
            if missing:
                raise AssertionError(f"jamba: expert buckets {missing} not "
                                     f"in the plan {shapes}")
        whole = [s for s in shapes if math.prod(s) <= WHOLE_PLAIN_MAX]
        by_leaf = [s for s in shapes if math.prod(s) > WHOLE_PLAIN_MAX]
        check_buckets_whole(
            kernel, ref, dev, f"{arch} run", whole, cfg.torch_dtype,
            (torch.float32, None) if "int8" in state else (torch.float32,))
        for s in by_leaf:
            check_bucket_by_leaf(kernel, ref, dev, f"{arch} run", s,
                                 cfg.torch_dtype)
        res["buckets_held_whole"] = [list(s) for s in whole]
        res["buckets_held_by_leaf"] = [list(s) for s in by_leaf]
        lap("buckets held")
        res["k1_buckets"] = time_buckets(kernel, ref, dev, arch, whole,
                                         cfg.torch_dtype) + [
            time_bucket_by_leaf(kernel, ref, dev, arch, s, cfg.torch_dtype)
            for s in by_leaf]
        if "int8" in state:
            res["k2_buckets"] = time_buckets(kernel, ref, dev, arch, shapes,
                                             cfg.torch_dtype, q8=True)
        for key, rows in (("k1", res["k1_buckets"]),
                          ("k2", res.get("k2_buckets", []))):
            if rows:
                res[f"{key}_ms_per_step"] = sum(r["ms"] for r in rows)
                res[f"{key}_bound_ms_per_step"] = sum(r["bound_ms"]
                                                      for r in rows)
        lap("buckets timed")
        slstm = any(k == "slstm" for k in cfg.pattern)
        res["profile"] = profile_step(dev, "f32", arch=arch, cfg=cfg,
                                      steps=PROFILED_SUBSTRATE_STEPS,
                                      batch=batch, seq=seq,
                                      trace_ops=not slstm)
        if slstm:
            one = profile_slstm(dev, cfg, batch, seq)
            n = sum(k == "slstm" for k in cfg.pattern) * cfg.n_periods
            res["slstm"] = dict(one, blocks=n, share_of_launches=n * one[
                "launches"] / res["profile"]["launches_per_step"])
            print(f"{arch}: one sLSTM block (forward, remat recompute, "
                  f"backward) {one['launches']} kernel launches, "
                  f"{one['device_ms']:.2f} ms device; its {n} blocks "
                  f"{res['slstm']['share_of_launches']:.1%} of the step's "
                  f"{res['profile']['launches_per_step']} launches")
        gc.collect()
        torch.cuda.empty_cache()
        lap("profiled")
        res["smoke"] = {}
        for dtype in TOL_SMOKE_LOSS:
            scfg = configs.get_smoke(arch).with_(dtype=dtype)
            codecs = ("f32", "int8") if "int8" in state and \
                dtype == "float32" else ("f32",)
            res["smoke"][dtype] = small_training(
                dev, scfg, codecs, SMOKE_SEQ, 3, TOL_SMOKE_LOSS[dtype])
        res["smoke"]["decode_max_abs_diff"] = smoke_decode(
            dev, configs.get_smoke(arch))
        lap("smoke")
        res["phase_s"] = time.perf_counter() - t0
        res["parts_s"] = parts
        print(f"phase {phase} ({arch}): {res['phase_s']:.1f} s ("
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
        out.append(res)
    return out


# phase 36: the observability slice.  The card's taps are held against
# plain taps taken in f64 from copies of g, p before, p after and the
# norms (``plain_bucket_taps``), each tensor reduced in pieces of
# TAP_PIECE_ROWS rows: the engine's f32 sums over its row blocks within
# TOL_TAP_SSQ relative (band_d_ssq relative to grad_ssq: a difference);
# clip counts and rates and the q8 saturation exact, q8_absmax bitwise
TOL_TAP_SSQ = 1e-5
TAP_PIECE_ROWS = 4096
# qwen2.5-3b's FFN w_gate/w_up bucket, (2, 73728, 11008) as K1 takes it
QWEN_TAP_LEAF = (36, 2048, 11008)
TAP_STEPS = 3            # dense, one-element, dense gradients
OBS_TIMED_STEPS = {"llama-60m": 5, "qwen2.5-3b": 5}   # steps a segment
OBS_SYNC_STEPS = 10      # the loop's syncs over two log windows


def f64_pieces(x):
    """``x`` as f64 pieces of whole rows of its last axis."""
    rows = x.reshape(-1, x.shape[-1]) if x.ndim else x.reshape(1, 1)
    for r in range(0, rows.shape[0], TAP_PIECE_ROWS):
        yield rows[r:r + TAP_PIECE_ROWS].double()


@torch.no_grad()
def plain_bucket_taps(name, gs, before, after, old_pn, new_st):
    """One bucket's taps in plain PyTorch from copies: ``gs`` its
    gradients, ``before``/``after`` its parameters around the update,
    ``old_pn`` the ``prev_norm`` before it (None: no limiter state),
    ``new_st`` the bucket's new (encoded) state."""
    from repro_torch.core import haar, limiter
    from repro_torch.optim.base import flatten_with_paths

    def ssq(xs):
        return sum(float((c * c).sum()) for x in xs for c in f64_pieces(x))

    out = {"grad_ssq": ssq(gs), "update_ssq": sum(
        float(((a - b) ** 2).sum()) for x, y in zip(after, before)
        for a, b in zip(f64_pieces(x), f64_pieces(y)))}
    if name.startswith("gwt_"):
        gt = [g.transpose(-1, -2).contiguous()
              if name.startswith("gwt_first") else g for g in gs]
        band_a = sum(float((a * a).sum()) for g in gt for c in f64_pieces(g)
                     for a in (haar.haar_approx(c, LEVEL),))
        out.update(band_a_ssq=band_a, band_d_ssq=out["grad_ssq"] - band_a)
        new_pn = new_st["prev_norm"]
        n = int(limiter.clip_flags(old_pn, new_pn,
                                   limiter.DEFAULT_GAMMA).sum())
        out.update(gnorm_ssq=float((new_pn.double() ** 2).sum()),
                   clip_count=float(n),
                   clip_rate=float(np.float32(n) / np.float32(len(gs))))
    leaves = dict(zip(*flatten_with_paths(new_st)))
    codes = [t for p, t in leaves.items()
             if p.endswith("q") and t.dtype == torch.int8]
    if codes:
        hits = sum(int(((t >= 127) | (t <= -127)).sum()) for t in codes)
        total = sum(t.numel() for t in codes)
        out["q8_sat_rate"] = float(np.float32(hits) / np.float32(total))
        scales = [t for p, t in leaves.items()
                  if p.endswith("scale") and t.dtype == torch.float32]
        out["q8_absmax"] = float(torch.stack([s.max() for s in scales])
                                 .max() * 127.0)
    return out


def compare_taps(label, got, want):
    """``got`` (the engine's device scalars) against ``want``; returns the
    largest relative error of the sums."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: tap names {sorted(got)}, want "
                             f"{sorted(want)}")
    worst = 0.0
    for key, w in want.items():
        bucket, tap = key.rsplit("/", 1)
        g = float(got[key])
        if tap in ("clip_count", "clip_rate", "q8_sat_rate", "q8_absmax"):
            if g != w:
                raise AssertionError(f"{label}: {key} {g}, plain {w}")
            continue
        scale = want[f"{bucket}/grad_ssq"] if tap == "band_d_ssq" \
            else abs(w)
        err = abs(g - w) / max(scale, 1e-300)
        worst = max(worst, err)
        if err > TOL_TAP_SSQ:
            raise AssertionError(f"{label}: {key} {g}, plain {w} (relative "
                                 f"{err:.3g} > {TOL_TAP_SSQ})")
    return worst


def tapped_vs_untapped(label, opt, make_params, make_grads, kernel, hk):
    """TAP_STEPS steps from two copies of the same parameters and state:
    each step ``update`` on one and ``tapped_update`` on the other with the
    same gradients (dense, one element a leaf, dense: the limiter clips on
    the third).  Parameters and state bitwise equal after every step; every
    bucket's taps against ``plain_bucket_taps`` from copies taken around
    the call (K1 and K2 write the stacked p and the moments in place:
    ``update_ssq`` must read the old p from the leaves); no synchronizing
    call in either update after the first.  Returns a summary."""
    from repro_torch.optim.base import flatten_with_paths
    pa, pb = make_params(), make_params()
    sa, sb = opt.init(pa), opt.init(pb)
    plan = opt.engine.plan(pb)
    worst, clips, syncs = 0.0, [], []
    reset_counts(kernel, hk)
    for k in range(TAP_STEPS):
        g = make_grads(k)
        gl = dict(zip(*flatten_with_paths(g)))
        before = {p: t.clone() for p, t in zip(*flatten_with_paths(pb))}
        old_pn = {b.name: sb["buckets"][b.name]["prev_norm"].clone()
                  for b in plan.buckets
                  if "prev_norm" in sb["buckets"][b.name]}
        (pa, sa), syncs_a = count_syncs(lambda: opt.update(g, sa, pa))
        (pb, sb, taps), syncs_b = count_syncs(
            lambda: opt.tapped_update(g, sb, pb))
        torch.cuda.synchronize()
        # a fresh optimizer's first update may set up a kernel's plan
        if k and (syncs_a or syncs_b):
            raise AssertionError(f"{label} step {k}: {syncs_a} / {syncs_b} "
                                 f"syncs in update / tapped_update")
        syncs.append((syncs_a, syncs_b))
        assert_bitwise(pa, pb, f"{label} step {k} parameters")
        assert_bitwise(sa, sb, f"{label} step {k} state")
        after = dict(zip(*flatten_with_paths(pb)))
        want = {}
        for b in plan.buckets:
            tp = plain_bucket_taps(
                b.name, [gl[p] for p in b.paths],
                [before[p] for p in b.paths], [after[p] for p in b.paths],
                old_pn.get(b.name), sb["buckets"][b.name])
            want.update({f"{b.name}/{t}": v for t, v in tp.items()})
        worst = max(worst, compare_taps(f"{label} step {k}", taps, want))
        clips.append(sum(v for key, v in want.items()
                         if key.endswith("/clip_count")))
        del before, after, taps, g, gl
    counts = {k: v for k, v in all_counts(kernel, hk).items() if v}
    print(f"phase 36 {label}: tapped_update == update bitwise over "
          f"{TAP_STEPS} steps, {len(plan.buckets)} buckets' taps vs plain "
          f"(worst relative {worst:.3g}), clipped leaves per step {clips}, "
          f"syncs (update, tapped_update) per step {syncs}; launches "
          f"{counts}")
    del pa, pb, sa, sb
    gc.collect()
    torch.cuda.empty_cache()
    return {"buckets": len(plan.buckets), "worst_rel_err": worst,
            "clipped_leaves": clips, "syncs": syncs, "launches": counts}


def tap_grads(shapes, k, dev):
    """Gradients of step ``k`` on ``dev`` for the shapes and dtypes of the
    tree ``shapes`` (``meta`` tensors will do): dense normals on steps 0
    and 2, one nonzero element a leaf on step 1."""
    from repro_torch.optim.base import tree_map
    gen = torch.Generator(device=dev).manual_seed(100 + k)

    def one(p):
        if k == 1:
            g = torch.zeros(p.shape, dtype=p.dtype, device=dev)
            g.view(-1)[0] = 1.0
            return g
        return (torch.randn(p.shape, generator=gen, device=dev)
                * 0.01).to(p.dtype)
    return tree_map(one, shapes)


def check_tapped_updates(kernel, hk, dev):
    """Phase 36's engine checks: llama-60m's buckets with K1 (f32
    moments), K2 (int8) and K4 (the staged path), and qwen2.5-3b's
    (2,73728,11008) bucket with K1 (two passes)."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get_config("llama-60m")

    def llama():
        return lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev).tree()
    shapes = lm.abstract_params(cfg)
    out = {}
    for label, kw in (("llama-60m f32 (K1)", {}),
                      ("llama-60m int8 (K2)", {"state_codec": "int8"}),
                      ("llama-60m staged f32 (K4)", {"fused_write": False})):
        out[label] = tapped_vs_untapped(
            label, gwt_opt(100, **kw), llama,
            lambda k: tap_grads(shapes, k, dev), kernel, hk)

    def qwen():
        gen = torch.Generator(device=dev).manual_seed(0)
        return {"layers": {"ffn": {n: (torch.randn(
            QWEN_TAP_LEAF, generator=gen, device=dev) * 0.02).to(
                torch.bfloat16) for n in ("w_gate", "w_up")}}}
    meta = {"layers": {"ffn": {n: torch.empty(QWEN_TAP_LEAF, device="meta",
                                              dtype=torch.bfloat16)
                               for n in ("w_gate", "w_up")}}}
    out["qwen2.5-3b (2,73728,11008) f32 (K1)"] = tapped_vs_untapped(
        "qwen2.5-3b (2,73728,11008) f32 (K1)", gwt_opt(100), qwen,
        lambda k: tap_grads(meta, k, dev), kernel, hk)
    return out


def check_metrics_dir(train, kernel, hk, codec, untapped):
    """The launcher with ``--metrics-dir`` (MAIN_ARGS, ``codec``): the same
    launches as phase 5/6's run and its losses bitwise; a ``train_step``
    record per step with the taps on each chunk's last step (5, 10, 15,
    20), the trace valid with the loop's spans."""
    from repro_torch.obs import trace as obs_trace
    d = tempfile.mkdtemp(prefix="chip_smoke_metrics_")
    try:
        reset_counts(kernel, hk)
        res = train.main(MAIN_ARGS + ["--state-codec", codec,
                                      "--metrics-dir", d])
        torch.cuda.synchronize()
        counts = all_counts(kernel, hk)
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(d, "trace.json")) as f:
            doc = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    mine = "K1" if codec == "f32" else "K2"
    want = {k: 0 for k in counts}
    want.update(fused_counts(**{mine.lower(): 3 * STEPS}))
    if counts != want:
        raise AssertionError(f"--metrics-dir {codec}: launched {counts}, "
                             f"want {want}")
    if res.losses != untapped.losses:
        raise AssertionError(f"--metrics-dir {codec}: losses {res.losses} "
                             f"differ from {untapped.losses} without it")
    steps = [r for r in recs if r["kind"] == "train_step"]
    tapped = [r["step"] for r in steps
              if any("/grad_ssq" in k for k in r)]
    if [r["step"] for r in steps] != list(range(1, STEPS + 1)) \
            or tapped != list(range(5, STEPS + 1, 5)) \
            or [r["loss"] for r in steps] != res.losses:
        raise AssertionError(f"--metrics-dir {codec}: train_step records "
                             f"{[(r['step'], len(r)) for r in steps]}")
    keys = sorted(k for k in steps[-1] if "/" in k)
    if codec == "int8" and not any(k.endswith("/q8_sat_rate") for k in keys):
        raise AssertionError("--metrics-dir int8: no q8 taps")
    obs_trace.validate(doc)
    spans = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    if not {"prefetch", "dispatch", "block"} <= spans:
        raise AssertionError(f"--metrics-dir {codec}: spans {spans}")
    last = {k: steps[-1][k] for k in keys}
    print(f"phase 36 --metrics-dir {codec}: {STEPS} steps, losses bitwise "
          f"to the run without it, launches {mine} {counts[mine]}, "
          f"{len(keys)} taps on steps {tapped}, kinds "
          f"{sorted({r['kind'] for r in recs})}, spans {sorted(spans)}; "
          f"step 20's GWT taps: " + ", ".join(
              f"{k} {v:.6g}" for k, v in last.items()
              if k.startswith("gwt_last__layers.b0.ffn.w_gate")))
    return {"launches": counts[mine], "taps": len(keys),
            "tapped_steps": tapped, "step_ms": res.step_ms,
            "record_kinds": sorted({r["kind"] for r in recs}),
            "spans": sorted(spans), "last_taps": last}


def time_tapped_step(arch, dev, batch=16, seq=256):
    """The untapped and the tapped train step of ``arch`` at full width
    (GWT-2 f32 moments, synthetic batches), timed in turns A B B A, each
    segment OBS_TIMED_STEPS[arch] steps between two synchronizes (host
    clock), with each segment's peak ``max_memory_allocated``; and the
    synchronizing calls of one step of each after one of each."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get_config(arch)
    n = OBS_TIMED_STEPS[arch]
    gc.collect()
    torch.cuda.empty_cache()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    opt = gwt_opt(1000)
    state = opt.init(params)
    steps = {"untapped": lm.make_train_step(cfg, opt),
             "tapped": lm.make_train_step(cfg, opt, taps=True)}
    data = synthetic(cfg, seq, batch, 0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()} for i in range(n)]
    syncs = {}
    for name, fn in steps.items():      # warm-up, then the sync count
        params, state, _ = fn(params, state, batches[0])
        (params, state, _), syncs[name] = count_syncs(
            lambda: fn(params, state, batches[0]))
    runs = {"untapped": [], "tapped": []}
    peaks = {"untapped": 0, "tapped": 0}
    for name in ("untapped", "tapped", "tapped", "untapped"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches:
            params, state, _ = steps[name](params, state, b)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) / n * 1e3)
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
    del params, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": arch, "steps_a_segment": n,
           "untapped_ms": runs["untapped"], "tapped_ms": runs["tapped"],
           "peak_mib": {k: v / 2**20 for k, v in peaks.items()},
           "syncs_per_step": syncs}
    base = float(np.mean(runs["untapped"]))
    dt = float(np.mean(runs["tapped"])) - base
    # the launcher taps one step of each log window (default 10 steps)
    out.update(tapped_minus_untapped_ms=dt,
               amortized_share_log_every_10=dt / 10 / base)
    print(f"phase 36 {arch} step, A B B A ({n} steps a segment): untapped "
          f"{runs['untapped']} ms, tapped {runs['tapped']} ms ({dt:+.2f} "
          f"ms; one tapped step in 10: {dt / 10 / base:+.3%} a step); peak "
          f"{out['peak_mib']['untapped']:.1f} / "
          f"{out['peak_mib']['tapped']:.1f} MiB; syncs per step {syncs}")
    return out


def loop_syncs(dev, tapped):
    """The synchronizing calls of a TrainLoop run of OBS_SYNC_STEPS
    llama-60m steps (two log windows), with or without the tapped step."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_source
    from repro_torch.models import lm
    from repro_torch.runtime.fault_tolerance import TrainLoop
    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     dev).tree()
    opt = gwt_opt(OBS_SYNC_STEPS)
    loop = TrainLoop(lm.make_train_step(cfg, opt),
                     make_source("synthetic", cfg.vocab, 256, 16, seed=0),
                     device=dev, log_every=5, log=lambda line: None,
                     tap_step=lm.make_train_step(cfg, opt, taps=True)
                     if tapped else None)
    (_, _, losses), syncs = count_syncs(lambda: loop.run(
        params, opt.init(params), num_steps=OBS_SYNC_STEPS))
    return losses, syncs


def run_observability(train, kernel, hk, dev, res32, res8, prof32):
    """Phase 36 (the observability slice): the tapped update on the card
    against plain taps at llama-60m's and qwen2.5-3b's buckets, bitwise to
    the untapped update; the launcher with ``--metrics-dir`` (f32 and
    int8, 20 steps); the loop's syncs with and without taps; the tapped
    and untapped step timed at llama-60m and qwen2.5-3b."""
    t0 = time.perf_counter()
    out = {"engine": check_tapped_updates(kernel, hk, dev)}
    out["metrics_dir"] = {"f32": check_metrics_dir(train, kernel, hk, "f32",
                                                   res32),
                          "int8": check_metrics_dir(train, kernel, hk,
                                                    "int8", res8)}
    loop_syncs(dev, False)     # warm-up: a first run may set up caches
    (l0, s0), (l1, s1) = loop_syncs(dev, False), loop_syncs(dev, True)
    if s0 != s1 or l0 != l1:
        raise AssertionError(f"TrainLoop: {s0} syncs without taps, {s1} "
                             f"with; losses {l0} vs {l1}")
    out["loop_syncs"] = {"steps": OBS_SYNC_STEPS, "log_windows": 2,
                         "untapped": s0, "tapped": s1}
    out["timing"] = [time_tapped_step("llama-60m", dev),
                     time_tapped_step("qwen2.5-3b", dev)]
    out["taps_off_launches_per_step"] = prof32["launches_per_step"]
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 36: TrainLoop syncs over {OBS_SYNC_STEPS} steps (2 log "
          f"windows) {s0} untapped, {s1} tapped, losses bitwise; taps-off "
          f"llama-60m f32 step {prof32['launches_per_step']} launches "
          f"(phase 9's profile); {out['phase_s']:.1f} s; card {smi()}")
    return out


# phase 37: the sharded-parameter layout (--shard-params auto) against the
# replicated one under a one-rank NCCL group: qwen2.5-3b at full width and
# QWEN_LAYERS layers, 16 x 256, SHARD_QWEN_STEPS steps with exact f32
# means, and llama-60m SHARD_Q8_STEPS steps of int8 moments with
# compressed means
SHARD_QWEN_STEPS = 3
SHARD_Q8_STEPS = 10
SHARD_QWEN_ARGS = ["--arch", "qwen2.5-3b", "--steps", str(SHARD_QWEN_STEPS),
                   "--batch", "16", "--seq", "256", "--log-every", "1",
                   "--seed", "0", "--mesh", "1", "--dp-reduce", "exact"]
SHARD_Q8_ARGS = ["--arch", "llama-60m", "--steps", str(SHARD_Q8_STEPS),
                 "--batch", "16", "--seq", "256", "--log-every", "5",
                 "--seed", "0", "--state-codec", "int8", "--dp-reduce",
                 "compressed"]
# the auto peak may exceed none's by this share at world size 1, where the
# placement copies nothing
SHARD_PEAK_SHARE = 0.01
# a data=8 mesh's per-rank bytes of qwen2.5-3b under the rule table (GWT-2
# f32 state, bf16 parameters): figures computed from shapes, not measured
SHARD_QWEN_RANK8 = {"state": 1_534_660_652, "params": 771_907_584}


def host_tree(res):
    """``{"losses", "params", "opt"}`` of a launcher result, the tensors
    copied to the host one leaf at a time (the next run needs the card's
    memory)."""
    from repro_torch.optim.base import flatten_with_paths
    paths, leaves = flatten_with_paths({"params": res.params,
                                        "opt": res.opt_state})
    return {"losses": list(res.losses),
            "leaves": dict(zip(paths, (t.detach().cpu() for t in leaves)))}


def sharded_run(train, kernel, hk, argv, label):
    """One launcher run under a one-rank NCCL group, counts set to 0 just
    before and read just after.  Returns the host copy of its result and
    its counts, peak (absolute and above what was held before) and step
    time."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with one_rank_env():
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernel, hk)
        t0 = time.perf_counter()
        res = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts(kernel, hk)
        peak = torch.cuda.max_memory_allocated()
    if not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"{label}: non-finite losses {res.losses}")
    out = {"counts": counts, "peak_mib": peak / 2**20,
           "peak_above_base_mib": (peak - base) / 2**20,
           "step_ms": res.step_ms, "wall_s": wall, "losses": res.losses}
    host = host_tree(res)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 37 {label}: {wall:.2f} s, losses {out['losses']}, step "
          f"{out['step_ms']} ms, peak {out['peak_mib']:.1f} MiB "
          f"({out['peak_above_base_mib']:.1f} above the {base / 2**20:.1f} "
          f"MiB held before), launches {counts}")
    return host, out


def check_same_run(a, b, what):
    """Losses, parameters and optimizer state bitwise (host copies)."""
    if a["losses"] != b["losses"]:
        raise AssertionError(f"{what}: losses {a['losses']} vs "
                             f"{b['losses']}")
    assert_bitwise(a["leaves"], b["leaves"], what)


def run_layouts(train, kernel, hk, argv, label, order, want):
    """``argv`` under each ``--shard-params`` of ``order`` in turn: every
    run's counts ``want`` and its result bitwise the first's.  Returns
    ``{layout: [summary, ...]}``."""
    first, out = None, {}
    for layout in order:
        host, r = sharded_run(train, kernel, hk,
                              argv + ["--shard-params", layout],
                              f"{label} {layout}")
        if r["counts"] != {k: want.get(k, 0) for k in r["counts"]}:
            raise AssertionError(f"{label} {layout}: launched "
                                 f"{r['counts']}, want {want}")
        if first is None:
            first = host
        else:
            check_same_run(host, first, f"{label} {layout}/{order[0]}")
        del host
        out.setdefault(layout, []).append(r)
    return out


def run_sharding(train, kernel, hk):
    """Phase 37 (the sharded-parameter slice): ``--shard-params auto``
    against ``none`` at world size 1 under a one-rank NCCL group, where
    every placement is over mesh axes of size 1 and nothing is copied.
    qwen2.5-3b at full width and ``QWEN_LAYERS`` layers with exact means,
    none auto auto
    none (K1 by plan in both designs in every run, losses, parameters and
    state bitwise, the auto peaks within ``SHARD_PEAK_SHARE`` of none's,
    each step time) and llama-60m with int8 moments and compressed means
    (K2, K3 and K7 the same counts, everything bitwise); then the rule
    table's per-rank bytes of qwen2.5-3b on a ``data=8`` mesh, computed
    from shapes."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    from repro_torch.optim import engine, make
    t0 = time.perf_counter()
    cfg = configs.get_config("qwen2.5-3b")
    with depth_cut("qwen2.5-3b", QWEN_LAYERS) as cut:
        qwen = run_layouts(train, kernel, hk, SHARD_QWEN_ARGS,
                           f"qwen2.5-3b {QWEN_LAYERS} layers exact",
                           ("none", "auto", "auto", "none"),
                           fused_plan_counts(kernel, cut, SHARD_QWEN_STEPS))
    peaks = {k: [r["peak_mib"] for r in rs] for k, rs in qwen.items()}
    if max(peaks["auto"]) > min(peaks["none"]) * (1 + SHARD_PEAK_SHARE):
        raise AssertionError(f"qwen2.5-3b: auto peaks {peaks['auto']} MiB "
                             f"over none's {peaks['none']}")
    want = fused_counts(k2=3 * SHARD_Q8_STEPS)
    want.update({"K3": SHARD_Q8_STEPS, "K7": 10 * SHARD_Q8_STEPS,
                 "K3 leaves": 10 * SHARD_Q8_STEPS})
    q8 = run_layouts(train, kernel, hk, SHARD_Q8_ARGS,
                     "llama-60m int8 compressed", ("none", "auto"), want)
    mesh = sharding.Mesh((8,), ("data",))
    sh = sharding.train_step_shardings(
        cfg, lm, {"tokens": torch.empty((16, 256), device="meta")}, mesh)
    abs_p = lm.abstract_params(cfg)
    st = make("gwt", lr=0.0, level=LEVEL).init(abs_p)
    rank8 = {"state": sharding.shard_bytes(st, sh.opt),
             "params": sharding.shard_bytes(abs_p, sh.params),
             "state_whole": engine.state_bytes(st),
             "params_whole": sharding.shard_bytes(abs_p, None)}
    if {k: rank8[k] for k in SHARD_QWEN_RANK8} != SHARD_QWEN_RANK8:
        raise AssertionError(f"qwen2.5-3b data=8 rank bytes {rank8}, want "
                             f"{SHARD_QWEN_RANK8}")
    steps = {k: [r["step_ms"] for r in rs] for k, rs in qwen.items()}
    out = {"qwen2.5-3b": qwen, "llama-60m int8 compressed": q8,
           "qwen2.5-3b data=8 rank bytes (computed)": rank8,
           "phase_s": time.perf_counter() - t0}
    c = qwen["auto"][0]["counts"]
    print(f"phase 37: qwen2.5-3b ({QWEN_LAYERS} layers) exact "
          f"none/auto/auto/none bitwise, K1 "
          f"{c['K1']} ({c['K1 one-pass']} one pass, {c['K1 two-pass']} "
          f"two) in each; step ms none {steps['none']} auto "
          f"{steps['auto']}; peak MiB none {peaks['none']} auto "
          f"{peaks['auto']}; llama-60m int8 compressed auto/none bitwise; "
          f"computed from shapes, not measured: a data=8 rank of qwen2.5-3b "
          f"holds {rank8['state']} of {rank8['state_whole']} state bytes "
          f"and {rank8['params']} of {rank8['params_whole']} parameter "
          f"bytes; {out['phase_s']:.1f} s; card {smi()}")
    return out



# phase 38: the paper's example drivers.  ``pretrain`` runs PRETRAIN_STEPS
# steps checkpointing at half of them, then resumes from half
PRETRAIN_STEPS = 40
# compare_optimizers' depth on the card (its llama-tiny has 4 layers)
COMPARE_LAYERS = 2


def counted(kernel, hk, fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before and read
    just after (the card synchronised): ``(result, counts)``."""
    reset_counts(kernel, hk)
    out = fn(*args)
    torch.cuda.synchronize()
    return out, all_counts(kernel, hk)


def expect_counts(label, counts, *wants):
    """``counts`` must be the sum of the ``wants`` (0 where none names a
    counter)."""
    want = dict.fromkeys(counts, 0)
    for w in wants:
        for k, v in w.items():
            want[k] += v
    if counts != want:
        raise AssertionError(f"{label}: launched {counts}, want {want}")


def run_quickstart(kernel, hk):
    """``quickstart`` as written: Adam, GWT-2, GWT-3 on llama-tiny, 60 steps
    of 16 x 128; K1 by plan for the two GWT runs, nothing else."""
    from repro_torch.examples import quickstart as qs
    t0 = time.perf_counter()
    results, counts = counted(kernel, hk, qs.main, ["--device", "cuda"])
    expect_counts("quickstart", counts,
                  *(fused_plan_counts(kernel, qs.CFG, qs.STEPS,
                                      level=kw["level"])
                    for name, kw in qs.METHODS if name == "gwt"))
    for tag, (loss, mib) in results.items():
        if not math.isfinite(loss):
            raise AssertionError(f"quickstart {tag}: final loss {loss}")
    out = {"results": {t: {"final_loss": l, "state_mib": m}
                       for t, (l, m) in results.items()},
           "counts": counts, "wall_s": time.perf_counter() - t0}
    print(f"phase 38 quickstart: {out['results']}; launches {counts}; "
          f"{out['wall_s']:.1f} s")
    return out


@contextlib.contextmanager
def tiny_cut(n_layers):
    """While the block runs, the examples' llama-tiny (``quickstart.CFG``,
    which ``compare_optimizers`` shares) has ``n_layers`` layers, every
    width its own."""
    from repro_torch.examples import compare_optimizers as co
    from repro_torch.examples import quickstart as qs
    full = qs.CFG
    qs.CFG = co.CFG = full.with_(n_layers=n_layers)
    try:
        yield qs.CFG
    finally:
        qs.CFG = co.CFG = full


def run_compare_optimizers(kernel, hk):
    """``compare_optimizers`` at its defaults (120 steps of 16 x 128, the
    nine methods, the same initial parameters for each) but for depth
    (llama-tiny cut from 4 layers to ``COMPARE_LAYERS``, to keep the script
    within its time), method by method with the counts read around each:
    K1 by plan for GWT with the Adam host, nothing for the others; losses
    finite and falling; then its table."""
    with tiny_cut(COMPARE_LAYERS):
        return _compare_optimizers(kernel, hk)


def _compare_optimizers(kernel, hk):
    from repro_torch.examples import compare_optimizers as co
    steps = 120
    rows, out = [], []
    for name, kw in co.METHODS:
        t0 = time.perf_counter()
        row, counts = counted(kernel, hk, co.run_method, name, kw, steps,
                              torch.device("cuda"))
        fused = name == "gwt" and kw.get("host", "adam") == "adam"
        expect_counts(row.tag, counts, fused_plan_counts(
            kernel, co.CFG, steps, level=kw["level"]) if fused else {})
        if not (np.all(np.isfinite(row.losses))
                and row.final_loss < row.losses[0]):
            raise AssertionError(f"{row.tag}: losses {row.losses[:3]} .. "
                                 f"final {row.final_loss}")
        rows.append(row)
        out.append({"method": row.tag, "final_loss": row.final_loss,
                    "state_mib": row.state_bytes / 2**20,
                    "first_loss": row.losses[0], "k1": counts["K1"],
                    "other_launches": sum(v for k, v in counts.items()
                                          if not k.startswith("K1")),
                    "wall_s": time.perf_counter() - t0})
        print(f"phase 38 {row.tag:22s} final_loss={row.final_loss:8.4f} "
              f"state={row.state_bytes / 2**20:7.1f}MiB K1 {counts['K1']} "
              f"({out[-1]['wall_s']:.1f} s)")
    co.print_table(rows)
    return out


def run_pretrain(kernel, hk):
    """``pretrain`` at its default model (llama-130m, full width) and batch
    (16 x 256): PRETRAIN_STEPS steps checkpointing at half of them; then
    the last checkpoint removed and the same command run again, which
    resumes from half; its losses, parameters and state bitwise to the
    straight run's, K1 by plan in both runs."""
    from repro_torch import configs
    from repro_torch.examples import pretrain
    cfg = configs.get_config("llama-130m")
    half = PRETRAIN_STEPS // 2
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    try:
        argv = ["--steps", str(PRETRAIN_STEPS), "--ckpt-dir", tmp,
                "--ckpt-every", str(half)]
        t0 = time.perf_counter()
        straight, c1 = counted(kernel, hk, pretrain.main, argv)
        wall = time.perf_counter() - t0
        expect_counts("pretrain", c1, fused_plan_counts(kernel, cfg,
                                                        PRETRAIN_STEPS))
        shutil.rmtree(os.path.join(tmp, f"step_{PRETRAIN_STEPS:09d}"))
        resumed, c2 = counted(kernel, hk, pretrain.main, argv)
        expect_counts("pretrain resumed", c2,
                      fused_plan_counts(kernel, cfg, half))
        if resumed.start_step != half \
                or resumed.losses != straight.losses[half:]:
            raise AssertionError(f"pretrain resumed from "
                                 f"{resumed.start_step}: losses "
                                 f"{resumed.losses} vs "
                                 f"{straight.losses[half:]}")
        assert_bitwise(resumed.params, straight.params, "pretrain params")
        assert_bitwise(resumed.opt_state, straight.opt_state,
                       "pretrain optimizer state")
        if not straight.losses[-1] < straight.losses[0]:
            raise AssertionError(f"pretrain: losses {straight.losses}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"arch": "llama-130m", "steps": PRETRAIN_STEPS,
           "losses": straight.losses, "step_ms": straight.step_ms,
           "resumed_step_ms": resumed.step_ms, "wall_s": wall,
           "k1": c1["K1"], "k1_resumed": c2["K1"]}
    print(f"phase 38 pretrain llama-130m 16 x 256: {PRETRAIN_STEPS} steps "
          f"in {wall:.2f} s, step {straight.step_ms} ms, losses "
          f"{straight.losses[0]:.4f} -> {straight.losses[-1]:.4f}; resumed "
          f"from {half} bitwise to the straight run (losses, parameters, "
          f"state); K1 {c1['K1']} + {c2['K1']}")
    del straight, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def update_peaks(kernel, hk, dev):
    """``optim.engine.live_update_bytes`` of one GWT-2 update, fused (K1)
    against staged (K4), A B B A, each after a first update from the same
    parameters and gradients, with what was allocated just before each
    call: llama-60m at full width, and its GWT leaves alone (without the
    embedding, whose plain Adam update is common to both flows)."""
    from repro_torch import configs
    from repro_torch.core.gwt import gwt
    from repro_torch.models import lm
    from repro_torch.optim import engine
    from repro_torch.optim.base import flatten_with_paths, tree_map, \
        unflatten
    cfg = configs.get_config("llama-60m")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(5),
                     dev).tree()
    flat = dict(zip(*flatten_with_paths(params)))
    gwt_paths = [p for b in gwt(lr=0.01).engine.plan(params).buckets
                 if b.name.startswith("gwt") for p in b.paths]
    trees = {"llama-60m": params,
             "llama-60m GWT leaves": unflatten(
                 gwt_paths, [flat[p] for p in gwt_paths])}
    out = {}
    for label, tree in trees.items():
        ggen = torch.Generator(device=dev).manual_seed(7)
        grads = tree_map(lambda p: (torch.randn(
            p.shape, generator=ggen, device=dev) * 1e-2).to(p.dtype), tree)
        row = out[label] = {"fused": [], "staged": []}
        for flow in ("fused", "staged", "staged", "fused"):
            opt = gwt_opt(100, fused_write=flow == "fused")
            copy = tree_map(torch.clone, tree)
            state = opt.init(copy)
            copy, state = opt.update(grads, state, copy)
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            peak, counts = counted(kernel, hk, engine.live_update_bytes,
                                   opt.update, grads, state, copy)
            expect_counts(f"{label} update {flow}", counts,
                          fused_plan_counts(kernel, cfg, 1)
                          if flow == "fused" else {"K4": len(gwt_paths)})
            row[flow].append({"peak_bytes": peak, "base_bytes": base,
                              "above_base_bytes": peak - base})
            del copy, state
            gc.collect()
            torch.cuda.empty_cache()
        del grads
        print(f"phase 38 live_update_bytes, one {label} GWT-2 update (peak "
              f"with the arguments resident; base: allocated before the "
              f"call), A B B A: fused {row['fused']}, staged "
              f"{row['staged']}")
    return out


def run_examples(kernel, hk, dev):
    """Phase 38: the four example drivers on the card, and the update's
    peak by ``live_update_bytes``."""
    from repro_torch.examples import serve_batched
    t0 = time.perf_counter()
    out = {"quickstart": run_quickstart(kernel, hk),
           "compare_optimizers": run_compare_optimizers(kernel, hk),
           "pretrain": run_pretrain(kernel, hk)}
    match, counts = counted(kernel, hk, serve_batched.main,
                            ["--device", "cuda"])
    expect_counts("serve_batched", counts)
    out["serve_batched"] = {"arch": "gemma2-9b", "agreement": match}
    out["update_peaks"] = update_peaks(kernel, hk, dev)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 38: the examples ran on the card, serve_batched "
          f"agreement {match}; {out['phase_s']:.1f} s; card {smi()}")
    return out


# phase 39: the model mesh axis.  Two processes share the one card, joined
# by a gloo group over CUDA tensors (NCCL refuses two ranks on one device;
# gloo takes all_reduce, all_gather and broadcast of CUDA tensors, through
# host memory), each running tools/tp_rank.py: the launcher at --mesh 1x2
# (the tensor-parallel step) for each of TP_RUNS at 16 x 256 and GWT-2.
# The same runs at world 1 in this process first, the reference they are
# held to, while the ranks start.  The MoE cut takes 2 steps: over gloo
# one of its steps moves ~15 GB through host memory at 2 layers (the
# update gathers each bucket's parameters, gradients and state) and takes
# 14-24 s; PR 31 cut it to 1 layer for time (every layer of it is
# attn+moe, every width and kernel design kept).
#
# Two checks against world 1.  The losses, each step within TP_LOSS_RTOL
# (relative; tests/test_torch_tp_ranks.py's bound for a bf16 model against
# one rank).  llama-60m's loss starts at 509, and at the launcher's lr 0.01
# it falls to 77 in two steps, a trajectory that amplifies a last-bit
# difference: world 1 against itself at --accum 2 (the same gradient
# summed in another order) is 1.6e-2 apart at step 5.  So the dense runs
# take TP_DENSE_LR, where they are not chaotic (tools/tp_phase.py --spread
# measures world 1's own spread there: 9.6e-6).  And, since a loss curve
# hides a gradient of the wrong scale (Adam's update is invariant to it),
# the whole optimizer state and parameters at the end of each run
# (gathered over model, as a checkpoint holds them), through a sketch of
# each leaf (tree_sketch): each state leaf within TP_STATE_RTOL of world
# 1's norm, each parameter leaf within TP_MOVE_RTOL of world 1's move from
# the init.  A gradient with one rank's share missing, or counted twice,
# is O(1) off in the moments; one of another direction, in both.  (The
# schedule's first lr is 0: a run's parameters first move at step 2.)
#
# The recurrent and encoder-decoder families split along model too: jamba
# cut to its first block (mamba with its dense MLP; jamba's attention and
# MoE blocks are the runs above's code), xlstm-350m to one period (seven
# mLSTM blocks and an sLSTM), seamless to two encoder and two decoder
# layers, each at full width.  jamba's 5-layer cut peaks at 67.5 GB at
# world 1, too much for two processes on one card.
#
# xlstm-350m runs twice, in f32 and in its config's bf16.  In bf16 its gate
# weights' and biases' gradients are rounding noise at the 10% level, so
# its rank is more than the bounds above from world 1's bf16 run without
# a fault: world 1's own bf16 state is that far from its f32 state.  So
# the f32 run is held to world 1 under the bounds above (a gradient share
# missing or counted twice is O(1) off there, a right one 1e-5), and the
# bf16 run, beside its losses, launches and bytes against world 1's bf16
# run, is held to the f32 run at world 1 (TP_NOISE_REF): each kind of
# leaf (one leaf, or one leaf of each block of the period pooled: a gate
# bias has 4 elements, and one leaf's distance is a coin flip of Adam's
# first step) no further from it than TP_BF16_NOISE times world 1's bf16
# run is, or within the bounds above (noise_check).
#
# LoRA runs the tensor-parallel step too: llama-60m with f32 and with int8
# moments, and qwen2.5-3b cut to 2 layers in its bf16 (at model=2 its 16
# query heads and 2 KV heads both split), rank 8, at TP_DENSE_LR.  Each
# rank holds its shards of the frozen base and the adapters split with
# their weights; the update gathers each adapter bucket whole for K1/K2.
# They take 4-5 steps: b starts at zero and the schedule's first lr is 0,
# so b first moves at step 2 and a first gets a nonzero gradient at step 3
# (its gradient is b's product); with fewer than four steps a's moments
# would be zero at the end, and a missing all-reduce of the replicated
# factor's gradient would pass unseen.  Beside the checks above, the base
# after the run is world 1's bitwise (its sketches equal: the base does
# not move, so state_check's bound is 0 there), and no rank logs a
# replicated step.
#
# The int8 LoRA run's own rounding spread is over TP_STATE_RTOL: world 1
# against itself at --accum 2 (the same gradients summed in another
# order) is 0.119 of the norm apart in a's int8 moments after 5 steps
# (a's moments start at step 3 from b's first moves; an int8 code at the
# stochastic-rounding threshold follows the last bit of its value), and
# the rank 0.116 (tools/tp_phase.py --spread).  So that run
# (TP_SPREAD_RUNS) also runs at world 1 at --accum 2, and its rank is
# held, leaf by leaf, within TP_SPREAD_FACTOR times the largest distance
# world 1 shows from itself there (state and move apart), or within the
# bounds above.  Without the all-reduce of the replicated factor's
# gradient the rank is 1.16 of the norm off (the f32 run 0.929: O(1)).
#
# The optimizer taps.  Every run but LoRA's (which builds no tapped step,
# as in the JAX launcher) takes --metrics-dir, at world 1 and on the ranks,
# each in its own directory: with --log-every 1 every step is a chunk's
# last and runs the tapped step (on the ranks the update gathers each
# bucket whole, and the taps are read off it).  Rank 0's train_step
# records must hold world 1's steps and, on each, world 1's tap keys in
# world 1's order; each kind of tap (tap_kind) within TP_TAPS_RTOL of
# world 1's, relative, and the counts (clip_count, clip_rate,
# q8_sat_rate) exactly.  The int8 run's moments may round to another code
# from a last-bit difference, so its taps (TP_TAPS_SPREAD_RUNS) are also
# held within TP_SPREAD_FACTOR times world 1's own distance at --accum 2;
# xLSTM's bf16 run's within TP_BF16_NOISE times world 1's bf16 run's
# distance from its f32 run (TP_NOISE_REF).
#
# One run is on the data axis alone: llama-60m at --mesh 2 without
# --dp-reduce (TP_DATA_RUNS), each rank 8 of the 16 rows and the exact
# mean of the gradients, held to world 1 at --accum 2 as above (losses,
# state, move, launches, taps; its parameters and state whole on each
# rank).  Not bitwise: world 1's microbatches take the JAX package's
# strided rows, a rank its contiguous block (tests/test_torch_shard_ranks
# .py measures the taps 4.3e-7 apart on the CPU).
TP_DENSE_LR = "1e-3"
TP_LORA = ["--finetune", "lora", "--lora-rank", str(LORA_RANK),
           "--lora-alpha", str(LORA_ALPHA)]
SEAMLESS_CUT = {"n_layers": 4, "n_enc_layers": 2, "n_dec_layers": 2}
XLSTM_CUT = {"n_layers": 8, "dtype": "float32"}
# (label, arch, depth cut, steps, extra flags)
TP_RUNS = [("llama-60m f32", "llama-60m", None, 5, ["--lr", TP_DENSE_LR]),
           ("llama-60m int8", "llama-60m", None, 5,
            ["--lr", TP_DENSE_LR, "--state-codec", "int8"]),
           ("qwen3-moe-30b-a3b 1 layer", "qwen3-moe-30b-a3b", 1, 2, []),
           ("jamba-v0.1-52b 1 layer", "jamba-v0.1-52b", 1, 2, []),
           ("xlstm-350m 8 layers f32", "xlstm-350m", XLSTM_CUT, 2, []),
           ("xlstm-350m 8 layers bf16", "xlstm-350m", 8, 2, []),
           ("seamless-m4t-large-v2 2+2 layers", "seamless-m4t-large-v2",
            SEAMLESS_CUT, 2, []),
           ("llama-60m LoRA f32", "llama-60m", None, 5,
            ["--lr", TP_DENSE_LR, *TP_LORA]),
           ("llama-60m LoRA int8", "llama-60m", None, 5,
            ["--lr", TP_DENSE_LR, "--state-codec", "int8", *TP_LORA]),
           ("qwen2.5-3b 2 layers LoRA", "qwen2.5-3b", 2, 4,
            ["--lr", TP_DENSE_LR, *TP_LORA]),
           ("llama-60m f32 --mesh 2", "llama-60m", None, 5,
            ["--lr", TP_DENSE_LR])]
# the runs along the data axis alone: --mesh 2 (the others: --mesh 1x2)
TP_DATA_RUNS = {"llama-60m f32 --mesh 2"}
TP_LOSS_RTOL = 2e-3
TP_STATE_RTOL = 5e-2
TP_MOVE_RTOL = 0.3
# a bf16 run's state and parameters against the f32 run at world 1
TP_NOISE_REF = {"xlstm-350m 8 layers bf16": "xlstm-350m 8 layers f32"}
# runs held to world 1's own spread (world 1 at --accum 2 against world 1)
TP_SPREAD_RUNS = {"llama-60m LoRA int8"}
TP_SPREAD_FACTOR = 2.0
TP_BF16_NOISE = 1.5
# the taps: the largest relative difference of each kind (tap_kind) to
# world 1's over the run's steps, measured worst beside (my chip calls 1-2
# of PR 31; a tap read off one rank's shard alone is ~0.5 off); the counts
# exactly.  The int8 run's update 5.24e-2 and q8_sat_rate 1.14e-2 sit
# under twice world 1's own spread (3.13e-2, 0.158)
TP_TAPS_RTOL = {"grad": 5e-3,        # 2.16e-3 (int8), 1.26e-3 (MoE)
                "update": 1e-2,      # 3.21e-3 (jamba), 1.47e-3 (--mesh 2)
                "q8_absmax": 1e-2}   # 4.18e-3
TP_TAPS_SPREAD_RUNS = {"llama-60m int8"}
TP_SKETCH = 64
# the rank processes' wall limit (not a numerical bound)
TP_TIMEOUT_S = 600


def tp_argv(arch, steps, extra):
    return ["--arch", arch, "--steps", str(steps), "--batch", "16",
            "--seq", "256", "--log-every", "1", "--seed", "0", *extra]


def tp_run(label, arch, layers, steps, extra):
    """One of ``TP_RUNS`` as the phase and the ranks take it: ``mesh`` the
    ranks' ``--mesh``, ``taps`` whether it records them (not LoRA)."""
    return {"label": label, "arch": arch, "layers": layers,
            "argv": tp_argv(arch, steps, extra), "steps": steps,
            "q8": "int8" in extra, "lora": "lora" in extra,
            "mesh": "2" if label in TP_DATA_RUNS else "1x2",
            "taps": "lora" not in extra}


def tap_records(d):
    """``(step, [(tap key, value), ...])`` of every ``train_step`` record
    of ``d/metrics.jsonl``, in file order."""
    out = []
    with open(os.path.join(d, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "train_step":
                out.append((rec["step"], [(k, v) for k, v in rec.items()
                                          if "/" in k]))
    return out


def tap_kind(key):
    """``grad`` (Σ g² and its bands), ``update`` (Σ (Δp)², the limiter's
    Σ norm²), else the tap's own name."""
    tap = key.rsplit("/", 1)[1]
    if tap in ("grad_ssq", "band_a_ssq", "band_d_ssq"):
        return "grad"
    if tap in ("update_ssq", "gnorm_ssq"):
        return "update"
    return tap


def taps_gap(got, want):
    """The largest relative difference of each kind of tap between two
    runs' records, and the failures of their steps and keys (each step
    tapped, world 1's keys in world 1's order)."""
    gap, failed = {}, []
    if [s for s, _ in got] != [s for s, _ in want]:
        return gap, [f"steps {[s for s, _ in got]}, world 1's "
                     f"{[s for s, _ in want]}"]
    for step, ((_, g), (_, w)) in enumerate(zip(got, want), 1):
        if not w or [k for k, _ in g] != [k for k, _ in w]:
            failed.append(f"step {step}: {len(g)} tap keys, world 1's "
                          f"{len(w)}, not the same list")
            continue
        for (k, a), (_, b) in zip(g, w):
            kind = tap_kind(k)
            d = abs(a - b) / abs(b) if b else abs(a)
            gap[kind] = max(gap.get(kind, 0.0), d)
    return gap, failed


def tp_taps_check(label, got, want, spread=None, noise=None):
    """Rank 0's taps records against world 1's: ``taps_gap`` within
    ``TP_TAPS_RTOL`` (the counts exactly), or within ``TP_SPREAD_FACTOR``
    times ``spread`` (world 1 at --accum 2 against world 1) or
    ``TP_BF16_NOISE`` times ``noise`` (world 1's bf16 run against its
    f32 run), per kind.  Prints the gaps; returns them and the
    failures."""
    gap, failed = taps_gap(got, want)
    bounds = {k: TP_TAPS_RTOL.get(k, 0.0) for k in gap}
    for factor, own in ((TP_SPREAD_FACTOR, spread), (TP_BF16_NOISE, noise)):
        if own is not None:
            bounds = {k: max(b, factor * own.get(k, 0.0))
                      for k, b in bounds.items()}
    failed += [f"{k} {d:.3g} off (bound {bounds[k]:.3g})"
               for k, d in gap.items() if d > bounds[k]]
    extra = "" if spread is None else \
        f"; world 1 at --accum 2 against world 1 {fmt_gap(spread)}"
    if noise is not None:
        extra += f"; world 1's bf16 run against its f32 run {fmt_gap(noise)}"
    print(f"phase 39 taps {label}: rank 0's records against world 1's, "
          f"{len(got)} steps x {len(got[0][1]) if got else 0} taps, the "
          f"largest relative difference per kind {fmt_gap(gap)} (bounds "
          f"{fmt_gap(bounds)}){extra}")
    return {"gap": gap, "bounds": bounds}, failed


def fmt_gap(gap):
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(gap.items()))


def tree_sketch(tree):
    """``{path: (sketch, norm)}`` of every leaf: the leaf flattened
    in f32, times a normal draw seeded by its path, summed into
    ``TP_SKETCH`` buckets in f64.  The sketches of two trees differ by a
    vector whose norm estimates that of their difference (within ~20% at
    64 buckets); ``norm`` is the leaf's own, exact."""
    from repro_torch.optim.base import flatten_with_paths
    out = {}
    for path, leaf in zip(*flatten_with_paths(tree)):
        x = leaf.detach().flatten().float()
        g = torch.Generator(device=x.device).manual_seed(
            zlib.crc32(path.encode()))
        y = x * torch.randn(x.numel(), generator=g, device=x.device)
        y = torch.nn.functional.pad(y, (0, (-y.numel()) % TP_SKETCH))
        out[path] = (y.view(-1, TP_SKETCH).sum(0, dtype=torch.float64)
                     .tolist(),
                     float(torch.linalg.vector_norm(x, dtype=torch.float64)))
        del x, y
    return out


def sketch_gap(a, b) -> float:
    return float(np.linalg.norm(np.subtract(a, b)))


def state_check(got, ref, bounds=(TP_STATE_RTOL, TP_MOVE_RTOL)):
    """A rank's ``{"params", "opt"}`` sketches against world 1's, leaf by
    leaf: the optimizer state relative to world 1's leaf norm, the
    parameters relative to world 1's move from the init, within
    ``bounds``.  Returns the largest of each with its leaf, and the
    failures."""
    worst = {"opt": (0.0, None), "params": (0.0, None)}
    failed = []
    for part, bound in zip(("opt", "params"), bounds):
        if set(got[part]) != set(ref[part]):
            failed.append(f"{part} leaves "
                          f"{sorted(set(got[part]) ^ set(ref[part]))[:4]} "
                          f"differ from world 1's")
            continue
        for path, (sk, _) in got[part].items():
            want, norm = ref[part][path]
            scale = norm if part == "opt" else sketch_gap(
                want, ref["init"][path][0])
            gap = sketch_gap(sk, want)
            rel = 0.0 if gap == 0.0 else (gap / scale if scale else math.inf)
            if rel > worst[part][0]:
                worst[part] = (rel, path)
            if rel > bound:
                failed.append(f"{part} {path} {rel:.3g} off (bound {bound})")
    return worst, failed


def leaf_kind(path: str) -> str:
    """``path`` with its block's index in the period made ``b*``: the
    leaves of one kind across the period's blocks."""
    return re.sub(r"(?<=layers[./])b\d+(?=[./])", "b*", path)


def noise_check(got, ref, f32):
    """A bf16 rank's ``{"params", "opt"}`` sketches against the f32 run at
    world 1 (``f32``), beside world 1's bf16 run (``ref``), pooled over
    each kind of leaf (``leaf_kind``: xLSTM's gate biases have one element
    a head, too few for one leaf's distance to measure rounding): each
    kind's distance from ``f32`` within ``TP_BF16_NOISE`` times world 1's,
    or within ``state_check``'s bound (relative as there, to the f32 run's
    norm and move, summed in squares over the kind).  Returns the kinds'
    ratios to world 1's distance, largest first, and the failures."""
    sums, failed = {}, []
    for part in ("opt", "params"):
        if set(got[part]) != set(f32[part]):
            failed.append(f"{part} leaves "
                          f"{sorted(set(got[part]) ^ set(f32[part]))[:4]} "
                          f"differ from the f32 run's")
            continue
        for path, (sk, _) in got[part].items():
            want, norm = f32[part][path]
            scale = norm if part == "opt" else sketch_gap(
                want, f32["init"][path][0])
            acc = sums.setdefault((part, leaf_kind(path)), [0.0, 0.0, 0.0])
            for j, x in enumerate((sketch_gap(sk, want),
                                   sketch_gap(ref[part][path][0], want),
                                   scale)):
                acc[j] += x * x
    ratios = []
    for (part, kind), sq in sums.items():
        gap, own, scale = (math.sqrt(x) for x in sq)
        bound = TP_STATE_RTOL if part == "opt" else TP_MOVE_RTOL
        ratios.append((gap / own if own else (0.0 if gap == 0.0 else
                                              math.inf), f"{part} {kind}"))
        if gap > max(TP_BF16_NOISE * own, bound * scale):
            failed.append(
                f"{part} {kind} {gap / scale if scale else math.inf:.3g} "
                f"from f32, world 1's bf16 run "
                f"{own / scale if scale else math.inf:.3g} (bound "
                f"{TP_BF16_NOISE}x that, or {bound})")
    return sorted(ratios, reverse=True), failed


def tp_table_bytes(cfg, codec, lora_rank=None):
    """The rule table's bytes of one rank at ``model=2``: parameters and
    GWT-2 state, computed from shapes; with ``lora_rank`` of the
    ``{"base", "lora"}`` tree (and the base's own)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import lora, module_for
    from repro_torch.optim import make
    mod = module_for(cfg)
    sh = sharding.tp_step_shardings(
        cfg, mod, {"tokens": torch.empty((16, 256), device="meta")},
        sharding.Mesh((1, 2), ("data", "model")), lora_rank=lora_rank,
        state_codec=codec)
    abs_p = mod.abstract_params(cfg)
    opt = make("gwt", lr=0.0, level=LEVEL, state_codec=codec)
    out = {}
    if lora_rank is not None:
        abs_p = lora.inject(abs_p, lora_rank, (0, 0))
        opt = lora.wrap_optimizer(opt)
        out = {"base": sharding.shard_bytes(abs_p["base"],
                                            sh.params["base"]),
               "base_whole": sharding.shard_bytes(abs_p["base"], None)}
    st = opt.init(abs_p)
    return {"params": sharding.shard_bytes(abs_p, sh.params),
            "state": sharding.shard_bytes(st, sh.opt),
            "params_whole": sharding.shard_bytes(abs_p, None),
            "state_whole": sharding.shard_bytes(st, None), **out}


def start_tp_ranks(runs, out):
    """Start the two ranks of tools/tp_rank.py on the card, their output
    to ``out``; each makes ``runs`` once ``out/go`` exists."""
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   PYTHONPATH=os.path.join(REPO, "src"))
        with open(os.path.join(out, f"log{rank}"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tools", "tp_rank.py"),
                 out, json.dumps(runs)], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def finish_tp_ranks(procs, out):
    """Let the ranks run, wait for both (killing both at ``TP_TIMEOUT_S``
    or when one fails); return each rank's run summaries and its log."""
    Path(out, "go").touch()
    deadline = time.perf_counter() + TP_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [Path(out, f"log{r}").read_text() for r in range(2)]
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 39 rank {rank} exited "
                                 f"{p.returncode}:\n{log[-6000:]}")
    return [json.loads(Path(out, f"rank{r}.json").read_text())
            for r in range(2)], logs


def run_tp(train, kernel, hk, only=None):
    """Phase 39 (the model mesh axis): each of ``TP_RUNS`` (``only``: the
    runs of those indices) at world 1 here, then at ``--mesh 1x2`` on two
    processes sharing the card.  Each
    rank's losses within ``TP_LOSS_RTOL`` of world 1's, its state and
    parameters at the end within ``TP_STATE_RTOL`` and ``TP_MOVE_RTOL``
    (``state_check``; a run of ``TP_NOISE_REF`` by ``noise_check``
    instead), its K1/K2 launches (by design)
    equal to world 1's and to the plan's, its parameter and state bytes
    equal to the rule table's; prints each rank's peak memory and step
    time beside world 1's.  Every run is checked before a failure
    raises."""
    t0 = time.perf_counter()
    labels = [r[0] for r in TP_RUNS]
    if only is not None:    # with the f32 runs the bf16 ones are held to
        only = set(only) | {labels.index(TP_NOISE_REF[labels[i]])
                            for i in only if labels[i] in TP_NOISE_REF}
    runs = [tp_run(*r) for i, r in enumerate(TP_RUNS)
            if only is None or i in only]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")

    def taps_dir(run, i, who):
        return {"metrics_dir": os.path.join(out_dir, f"{who}_{i}")} \
            if run["taps"] else {}
    procs = []
    try:
        procs = start_tp_ranks(runs, out_dir)
        # a data-axis run's reference: world 1 at --accum 2 (its rows)
        refs = [tp_world1(train, kernel, hk, {
            **run, **taps_dir(run, i, "w1"),
            "argv": run["argv"] + (["--accum", "2"]
                                   if run["mesh"] != "1x2" else [])})
            for i, run in enumerate(runs)]
        twins = {run["label"]: tp_world1(train, kernel, hk, {
            **run, **taps_dir(run, i, "w1_accum2"),
            "argv": run["argv"] + ["--accum", "2"]})
            for i, run in enumerate(runs)
            if run["label"] in TP_SPREAD_RUNS | TP_TAPS_SPREAD_RUNS}
        gc.collect()
        torch.cuda.empty_cache()
        t_ranks = time.perf_counter()
        ranks, logs = finish_tp_ranks(procs, out_dir)
        t_ranks = time.perf_counter() - t_ranks
        taps = {run["label"]: {who: tap_records(os.path.join(
            out_dir, f"{who}_{i}")) for who in ("w1", "tp", "w1_accum2")
            if os.path.exists(os.path.join(out_dir, f"{who}_{i}"))}
            for i, run in enumerate(runs) if run["taps"]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    out, failed = {}, []
    for i, (run, ref) in enumerate(zip(runs, refs)):
        label = run["label"]
        got = [r[i] for r in ranks]
        for rank, g in enumerate(got):
            if g["label"] != label:
                raise AssertionError(f"phase 39 rank {rank}: run {i} is "
                                     f"{g['label']}, want {label}")
            diff = [abs(a - b) for a, b in zip(g["losses"], ref["losses"])]
            rel = max(d / abs(b) for d, b in zip(diff, ref["losses"]))
            g["loss_rel_vs_world1"] = rel
            if len(g["losses"]) != run["steps"] or rel > TP_LOSS_RTOL \
                    or not np.all(np.isfinite(g["losses"])):
                failed.append(f"{label} rank {rank}: losses {g['losses']} "
                              f"vs world 1 {ref['losses']}, {rel:.3g} "
                              f"relative (bound {TP_LOSS_RTOL})")
            if g["counts"] != ref["counts"]:
                failed.append(f"{label} rank {rank}: launched "
                              f"{g['counts']}, world 1 {ref['counts']}")
            table = ref["table"]
            held = (table["params"], table["state"]) \
                if run["mesh"] == "1x2" else (table["params_whole"],
                                              table["state_whole"])
            if (g["params_bytes"], g["state_bytes"]) != held:
                failed.append(f"{label} rank {rank}: holds "
                              f"{g['params_bytes']} parameter and "
                              f"{g['state_bytes']} state bytes, the table "
                              f"says {table}")
            sketch = g.pop("sketch")
            bounds = (TP_STATE_RTOL, TP_MOVE_RTOL)
            if label in TP_SPREAD_RUNS:
                own, _ = state_check(twins[label]["sketch"], ref["sketch"])
                bounds = (max(TP_STATE_RTOL,
                              TP_SPREAD_FACTOR * own["opt"][0]),
                          max(TP_MOVE_RTOL,
                              TP_SPREAD_FACTOR * own["params"][0]))
                g["world1_spread"] = own
                print(f"phase 39 {label} rank {rank}: world 1 at --accum 2 "
                      f"against world 1: state {own['opt'][0]:.3g} (at "
                      f"{own['opt'][1]}), move {own['params'][0]:.3g} (at "
                      f"{own['params'][1]}); the rank's bounds "
                      f"{bounds[0]:.3g} and {bounds[1]:.3g}")
            worst, bad = state_check(sketch, ref["sketch"], bounds)
            if label in TP_NOISE_REF:
                f32 = refs[[r["label"] for r in runs].index(
                    TP_NOISE_REF[label])]["sketch"]
                ratios, bad = noise_check(sketch, ref["sketch"], f32)
                g["noise_ratio_vs_world1"] = ratios[:5]
                top = ", ".join(f"{r:.3g} {leaf}" for r, leaf in ratios[:5])
                print(f"phase 39 {label} rank {rank}: each kind of leaf's "
                      f"distance from the f32 run at world 1 over world 1's "
                      f"bf16 run's: largest {top}; median "
                      f"{ratios[len(ratios) // 2][0]:.3g} of {len(ratios)} "
                      f"kinds (bound {TP_BF16_NOISE}, or {TP_STATE_RTOL} "
                      f"and {TP_MOVE_RTOL} from f32; the state and move "
                      f"against world 1's bf16 run below are shown, not "
                      f"held)")
            failed += [f"{label} rank {rank}: {b}" for b in bad]
            if run["lora"]:
                base = [p for p in ref["sketch"]["params"]
                        if p.startswith("base/")]
                # the rank's sketches came through JSON: lists, not tuples
                moved = [p for p in base if list(sketch["params"][p])
                         != list(ref["sketch"]["params"][p])]
                g["base_bitwise"] = not moved and bool(base)
                if not g["base_bitwise"]:
                    failed.append(f"{label} rank {rank}: the base differs "
                                  f"from world 1's at {moved[:4]}")
                if g["base_bytes"] != table["base"]:
                    failed.append(f"{label} rank {rank}: holds "
                                  f"{g['base_bytes']} base bytes, the "
                                  f"table says {table['base']}")
                print(f"phase 39 {label} rank {rank}: the base "
                      f"({len(base)} leaves) "
                      f"{'bitwise' if g['base_bitwise'] else 'NOT bitwise'}"
                      f" world 1's; base {g['base_bytes']} of "
                      f"{table['base_whole']} bytes whole, adapters "
                      f"{g['params_bytes'] - g['base_bytes']} bytes")
            g["state_rel_vs_world1"] = worst["opt"]
            g["move_rel_vs_world1"] = worst["params"]
            print(f"phase 39 {label} rank {rank}: losses {g['losses']} "
                  f"(differences to world 1 {diff}, largest relative "
                  f"{rel:.3g}); after step {run['steps']} the optimizer "
                  f"state within {worst['opt'][0]:.3g} of world 1's norm "
                  f"(largest at {worst['opt'][1]}; bound {bounds[0]:.3g}), "
                  f"the parameters within {worst['params'][0]:.3g} of world "
                  f"1's move (largest at {worst['params'][1]}; bound "
                  f"{bounds[1]:.3g}); parameters {g['params_bytes']} "
                  f"and state {g['state_bytes']} bytes = the table's (of "
                  f"{table['params_whole']} and {table['state_whole']} "
                  f"whole); peak {g['peak_mib']:.1f} MiB (world 1 "
                  f"{ref['peak_mib']:.1f}); launches {g['counts']} = world "
                  f"1's; step {g['step_ms']} ms (world 1 {ref['step_ms']} "
                  f"ms; gloo over host memory, two processes on one card)")
        out[label] = {"world1": ref, "ranks": got}
        if label in taps:
            t = taps[label]
            spread = noise = None
            if label in TP_TAPS_SPREAD_RUNS:
                spread, bad = taps_gap(t["w1_accum2"], t["w1"])
                failed += [f"{label} taps of world 1 at --accum 2: {b}"
                           for b in bad]
            if label in TP_NOISE_REF:
                noise, bad = taps_gap(t["w1"],
                                      taps[TP_NOISE_REF[label]]["w1"])
                failed += [f"{label} taps of world 1 against its f32 run: "
                           f"{b}" for b in bad]
            out[label]["taps"], bad = tp_taps_check(
                label, t.get("tp", []), t["w1"], spread, noise)
            if len(t["w1"]) != run["steps"]:
                bad.append(f"world 1 recorded {len(t['w1'])} steps")
            failed += [f"{label} taps: {b}" for b in bad]
        if label in twins:
            out[label]["world1_accum2"] = {
                k: v for k, v in twins[label].items() if k != "sketch"}
    for ref in refs:
        ref.pop("sketch")
    for line in logs[0].splitlines():
        if "tensor_parallel=model" in line:
            print(f"phase 39 rank 0 logged: {line}")
    if any("tp_replicated" in log or "replicated step" in log
           for log in logs):
        failed.append("a rank logged a replicated step")
    out["phase_s"] = time.perf_counter() - t0
    out["ranks_s"] = t_ranks
    print(f"phase 39: {out['phase_s']:.1f} s (the two ranks "
          f"{t_ranks:.1f} s after world 1's runs); card {smi()}")
    if failed:
        raise AssertionError("phase 39: " + "; ".join(failed))
    return out


def tp_world1(train, kernel, hk, run):
    """One of ``TP_RUNS`` at world 1, counts set to 0 just before and
    read just after, and the sketches of its whole state and parameters at
    the end and of the init (``state_check``); with ``metrics_dir`` the
    run records its taps there."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import lora, module_for
    cut = depth_cut(run["arch"], run["layers"]) if run["layers"] \
        else contextlib.nullcontext()
    with cut:
        cfg = configs.get_config(run["arch"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernel, hk)
        res = train.main(run["argv"] + (
            ["--metrics-dir", run["metrics_dir"]]
            if run.get("metrics_dir") else []))
        torch.cuda.synchronize()
        counts = all_counts(kernel, hk)
        peak = torch.cuda.max_memory_allocated()
        ref = {"losses": list(res.losses), "counts": counts,
               "peak_mib": peak / 2**20, "step_ms": res.step_ms,
               "table": tp_table_bytes(cfg, "int8" if run["q8"] else "f32",
                                       LORA_RANK if run["lora"] else None),
               "sketch": {"params": tree_sketch(res.params),
                          "opt": tree_sketch(res.opt_state)}}
        del res
        # the launcher's init: the same seed on the card's generator
        init = module_for(cfg).init(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            torch.device("cuda")).tree()
        if run["lora"]:   # the launcher's adapters: b zero, a drawn
            init = lora.inject(init, LORA_RANK,
                               prng.fold_in(prng.key(0), 777))
        ref["sketch"]["init"] = tree_sketch(init)
        del init
        if run["lora"]:
            want = {k: v * run["steps"] for k, v in lora_plan(
                kernel, run["arch"], run["q8"],
                check=not run["layers"]).items()}
        else:
            want = fused_plan_counts(kernel, cfg, run["steps"],
                                     q8=run["q8"])
    label = run["label"]
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"phase 39 {label} world 1: launched "
                             f"{counts}, the plan says {want}")
    print(f"phase 39 {label} world 1: losses {ref['losses']}, step "
          f"{ref['step_ms']} ms, peak {ref['peak_mib']:.1f} MiB, launches "
          f"{counts}")
    return ref


class Laps:
    """Each phase group's seconds, printed as the group ends, with the
    script's seconds so far (``groups``: all of them, in order)."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.groups = {}

    def __call__(self, name):
        now = time.perf_counter()
        self.groups[name] = now - self.last
        self.last = now
        print(f"{name}: {self.groups[name]:.1f} s; the script so far "
              f"{now - self.t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.gwt_adam import kernel, ref
    from repro_torch.kernels.haar_dwt import kernel as hk
    from repro_torch.launch import train
    from repro_torch.optim.engine import state_bytes

    dev = torch.device("cuda")
    card = smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; card: {card}")

    lap = Laps()
    parent = register_parent(build)
    parent_haar = register_parent(build, "haar_dwt")
    if parent or parent_haar:
        print(f"parent kernels (K4/K5 for phase 17: {parent}, K3/K6/K7 for "
              f"phase 12: {parent_haar}): revision "
              f"{(PARENT_DIR / 'REVISION').read_text().strip()}")
    libs = build.build_all(tuple(build.SOURCES), verbose=True)
    print(f"build: {time.perf_counter() - lap.t0:.1f} s -> "
          f"{[os.path.relpath(p, REPO) for p in libs.values()]}")
    print_plans(kernel)
    lap("phase 1 (the build)")

    err_k1, designs_k1 = check_fused(kernel, ref, dev, q8=False)
    err_k2, designs_k2 = check_fused(kernel, ref, dev, q8=True)
    err_haar = check_haar(hk, dev)
    tile_cases_run, err_tile = check_tile(kernel, ref, dev)
    check_small_training(dev)
    groups = run_groups(kernel, ref, dev)
    lap("phases 2-4, 10, 13, 40 (the kernels against their plain versions;"
        " the grouped K1/K2 checked and timed)")

    res32, launches_k1, peak32 = run_main_path(train, kernel, hk, "f32")
    res8, launches_k2, peak8 = run_main_path(train, kernel, hk, "int8")
    mib8 = state_bytes(res8.opt_state)
    mib32 = state_bytes(res32.opt_state)
    print(f"optimizer state: f32 {mib32} B = {mib32 / 2**20:.2f} MiB, int8 "
          f"{mib8} B = {mib8 / 2**20:.2f} MiB")
    if mib8 != STATE_BYTES_INT8:
        raise AssertionError(f"int8 state is {mib8} bytes, the JAX package "
                             f"counts {STATE_BYTES_INT8}")
    check_resume(train, res8)
    res_dp, dp_counts, peak_dp = run_dp_path(train, kernel, hk, [], STEPS)
    res_ef, ef_counts, _ = run_dp_path(
        train, kernel, hk, ["--dp-detail-dtype", "float8_e4m3fn",
                            "--dp-error-feedback"], DP_EF_STEPS)
    reduction_peaks = check_grouped_reduction(hk, dev)

    staged32, _, _ = run_staged_path(kernel, hk, "f32", res32)
    staged8, _, _ = run_staged_path(kernel, hk, "int8", res8)
    check_unrolled()
    memory = check_update_memory(dev)
    choices = run_choices(train, kernel, hk)
    lap("phases 5-7, 11, 14-16 (llama-60m's paths)")

    rows_k1 = time_fused(kernel, ref, dev, q8=False)
    rows_k2 = time_fused(kernel, ref, dev, q8=True)
    rows_haar, groups_haar = time_haar(hk, dev, parent_haar)
    wrap_dec, wrap_enc = time_generic_wrap(dev)
    prof32 = profile_step(dev, "f32")
    prof8 = profile_step(dev, "int8")
    prof_dp = profile_step(dev, "f32", dp_reduce="compressed")
    rows_tile = time_tile(kernel, ref, build, dev, parent)
    prof_staged = profile_step(dev, "f32", fused_write=False)
    corpus_path = run_corpus_path(train, kernel, hk, dev, res32, card)
    bf16_state = run_bf16_state(kernel, hk, res32)
    refresh = run_refresh(kernel, hk)
    refresh["prng_card_vs_cpu"] = check_prng_card(dev)
    lap("phases 8-9, 12, 17-20 (timing, profiles, corpus, bf16 state, "
        "low-rank)")
    dense_fused = check_dense_fused(kernel, ref, dev)
    lap("phase 21 (K1/K2 at qwen2.5-3b's bucket widths)")
    qwen = run_dense_main(train, kernel, hk)
    qwen["profile"] = profile_step(dev, "f32", arch="qwen2.5-3b",
                                   cfg=qwen_cut())
    rows_qwen = time_dense_fused(kernel, ref, dev)
    qwen8 = run_dense_main(train, kernel, hk, "int8")
    rows_qwen8 = time_dense_fused(kernel, ref, dev, q8=True)
    qwen8["embedding_wrap_ms"] = dict(zip(
        ("decode", "encode"), time_generic_wrap(dev, (1, 151936, 2048))))
    for run, rows, k in ((qwen, rows_qwen, "K1"), (qwen8, rows_qwen8, "K2")):
        run[f"{k.lower()}_ms_per_step"] = sum(r["ms"] * r["per_step"]
                                              for r in rows)
        run[f"{k.lower()}_bound_ms_per_step"] = sum(
            r["bound_ms"] * r["per_step"] for r in rows)
        run[f"{k.lower()}_write_pass_ms_per_step"] = sum(
            r.get("write_pass_ms", 0.0) for r in rows)
        print(f"qwen2.5-3b {run['codec']}: {k} at the full depth's buckets "
              f"{run[f'{k.lower()}_ms_per_step']:.3f} ms a step on the "
              f"device (timed per launch; bound "
              f"{run[f'{k.lower()}_bound_ms_per_step']:.3f} ms; the two-pass "
              f"buckets' write passes alone "
              f"{run[f'{k.lower()}_write_pass_ms_per_step']:.3f} ms)")
    print(f"qwen2.5-3b f32, {QWEN_LAYERS} layers: profiled GWT kernels "
          f"{qwen['profile']['gwt_kernel_ms']:.3f} of "
          f"{qwen['profile']['device_busy_ms']:.2f} ms device time a step")
    lap(f"phase 22 (qwen2.5-3b at {QWEN_LAYERS} layers f32 and int8, "
        "profiled; K1/K2 timed)")
    cuts = run_dense_cuts(train, kernel, hk)
    flash = check_flash(train, kernel, hk, dev)
    dense_small = check_dense_small_training(dev)
    lap("phases 23-25 (the dense cuts, the chunked route, the smokes)")
    t_serve = time.perf_counter()
    base_ckpt = tempfile.mkdtemp(prefix="chip_smoke_base_")
    serving = {"llama-60m": run_serve_roundtrip(train, kernel, hk, dev,
                                                base_ckpt),
               "qwen2.5-3b": run_serve_qwen(kernel, hk, dev),
               "smoke_card_vs_cpu_spacings": serve_smoke_card_vs_cpu(dev),
               "phases_s": time.perf_counter() - t_serve}
    lap("phases 26-28 (serving)")
    try:
        lora_llama = run_lora_roundtrip(train, kernel, hk, ref, dev,
                                        base_ckpt)
    finally:
        shutil.rmtree(base_ckpt, ignore_errors=True)
    lora_qwen = run_lora_qwen(train, kernel, hk, ref, dev)
    new_cuts = run_new_cuts(train, kernel, hk, ref, dev)
    lap("phases 29-32 (LoRA, M-RoPE, MoE)")
    substrates = run_substrates(train, kernel, hk, ref, dev)
    lap("phases 33-35 (jamba, xlstm-350m, seamless)")
    observability = run_observability(train, kernel, hk, dev, res32, res8,
                                      prof32)
    lap("phase 36 (observability)")
    shard = run_sharding(train, kernel, hk)
    lap("phase 37 (sharded parameters)")
    examples = run_examples(kernel, hk, dev)
    lap("phase 38 (the examples)")
    tp = run_tp(train, kernel, hk)
    lap("phase 39 (the model axis)")
    print(f"phase groups' seconds: {json.dumps(lap.groups)}")
    print(f"staged step vs fused step (same call): launcher-equivalent "
          f"loop {staged32['step_ms']:.2f} vs {res32.step_ms:.2f} ms; "
          f"profiled {prof_staged['step_ms']:.2f} vs "
          f"{prof32['step_ms']:.2f} ms, update {prof_staged['update_ms']:.2f} "
          f"vs {prof32['update_ms']:.2f} ms, device "
          f"{prof_staged['device_busy_ms']:.2f} vs "
          f"{prof32['device_busy_ms']:.2f} ms")
    print(f"dp step vs plain step (same call): launcher {res_dp.step_ms:.2f} "
          f"vs {res32.step_ms:.2f} ms; profiled {prof_dp['step_ms']:.2f} vs "
          f"{prof32['step_ms']:.2f} ms; device {prof_dp['device_busy_ms']:.2f}"
          f" vs {prof32['device_busy_ms']:.2f} ms; kernel launches per step "
          f"{prof_dp['launches_per_step']} vs {prof32['launches_per_step']}; "
          f"peak memory of the DP run {peak_dp / 2**20:.1f} MiB")
    entries = [
        fused_entry("gwt_adam_fused", "gwt_adam/csrc/gwt_adam_fused.cu",
                    "src/repro/kernels/gwt_adam/kernel.py:404",
                    launches_k1, err_k1, rows_k1, step_ms=res32.step_ms,
                    peak_mib=peak32 / 2**20, profile=prof32,
                    phase_2_buckets_by_design=designs_k1,
                    corpus_path=corpus_path, moment_dtypes=MOMENT_NAMES,
                    bf16_moments=bf16_step(rows_k1),
                    bf16_state_fused=bf16_state["fused"],
                    bf16_state_max_loss_gap=bf16_state["max_loss_gap"],
                    lowrank_refresh=refresh,
                    dense={"k1_widths": dense_fused, "qwen2.5-3b": qwen,
                           "qwen2.5-3b_per_launch": rows_qwen,
                           "depth_cuts": cuts, "flash": flash,
                           "smoke_card_vs_cpu": dense_small},
                    serving=serving,
                    lora={"llama-60m": lora_llama, "qwen2.5-3b": lora_qwen},
                    mrope_moe_cuts=new_cuts,
                    recurrent_encdec=[
                        {k: v for k, v in r.items() if k not in
                         ("int8", "k2_buckets", "k2_ms_per_step",
                          "k2_bound_ms_per_step")} for r in substrates],
                    observability={k: v for k, v in observability.items()
                                   if k != "engine"} | {"engine": {
                                       k: v for k, v in
                                       observability["engine"].items()
                                       if "int8" not in k and "staged"
                                       not in k}},
                    sharded_params=shard["qwen2.5-3b"],
                    sharded_rank_bytes_computed=shard[
                        "qwen2.5-3b data=8 rank bytes (computed)"],
                    examples=examples,
                    tensor_parallel={k: v for k, v in tp.items()
                                     if k != "llama-60m int8"}),
        fused_entry("gwt_adam_fused_q8",
                    "gwt_adam/csrc/gwt_adam_fused_q8.cu",
                    "src/repro/kernels/gwt_adam/kernel.py:554",
                    launches_k2, err_k2, rows_k2, step_ms=res8.step_ms,
                    peak_mib=peak8 / 2**20, state_bytes=mib8,
                    profile=prof8, phase_3_buckets_by_design=designs_k2,
                    embedding_wrap_ms={
                        "decode": wrap_dec, "encode": wrap_enc},
                    dense={"qwen2.5-3b int8": qwen8,
                           "qwen2.5-3b_per_launch": rows_qwen8},
                    lora_int8={"llama-60m": lora_llama["int8"],
                               "adapter_buckets":
                               lora_llama["k2_adapter_buckets"]},
                    xlstm_int8=[{"arch": r["arch"], "run": r["int8"],
                                 "buckets": r["k2_buckets"],
                                 "ms_per_step": r["k2_ms_per_step"],
                                 "bound_ms_per_step":
                                 r["k2_bound_ms_per_step"]}
                                for r in substrates if "int8" in r],
                    observability={
                        "engine": observability["engine"][
                            "llama-60m int8 (K2)"],
                        "metrics_dir": observability["metrics_dir"]["int8"]},
                    sharded_params=shard["llama-60m int8 compressed"],
                    tensor_parallel=tp["llama-60m int8"]),
        grouped_entry("gwt_adam_fused_group",
                      "gwt_adam/csrc/gwt_adam_fused.cu",
                      "src/repro/kernels/gwt_adam/kernel.py:404",
                      lora_llama["f32"]["launches"].get("K1 group", 0),
                      groups, "K1 f32 moments"),
        grouped_entry("gwt_adam_fused_q8_group",
                      "gwt_adam/csrc/gwt_adam_fused_q8.cu",
                      "src/repro/kernels/gwt_adam/kernel.py:554",
                      lora_llama["int8"]["launches"].get("K2 group", 0),
                      groups, "K2 int8 moments"),
        group_entry("haar_dwt_fwd_q",
                    "src/repro/kernels/haar_dwt/kernel.py:124",
                    dp_counts["K3"], err_haar, rows_haar["K3 bf16"],
                    groups_haar["K3 bf16"],
                    fp8_per_launch=rows_haar["K3 fp8"],
                    fp8_group=groups_haar["K3 fp8"],
                    leaves=dp_counts["K3 leaves"], step_ms=res_dp.step_ms,
                    wire_bytes=res_dp.wire_bytes, profile=prof_dp,
                    peak_mib=peak_dp / 2**20,
                    reduction_peak_mib=reduction_peaks,
                    ef_fp8_launches=ef_counts),
        group_entry("haar_dwt_fwd", "src/repro/kernels/haar_dwt/kernel.py:93",
                    dp_counts["K6"], err_haar, rows_haar["K6 bf16"],
                    groups_haar["K6 bf16"]),
        haar_entry("haar_dwt_inv", "src/repro/kernels/haar_dwt/kernel.py:144",
                   dp_counts["K7"], err_haar, rows_haar["K7 f32"],
                   parent_ms=None if not parent_haar else sum(
                       r["parent_ms"] * r["per_step"]
                       for r in rows_haar["K7 f32"])),
        tile_entry("gwt_adam_tile", staged32["launches"]["K4"],
                   err_tile["K4"], rows_tile["K4"],
                   phase_13_cases=tile_cases_run,
                   staged_f32=staged32, staged_int8=staged8,
                   profile=prof_staged, update_memory=memory,
                   launcher_choices=choices, moment_dtypes=MOMENT_NAMES,
                   bf16_moments=bf16_step(rows_tile["K4"]),
                   bf16_state_staged=bf16_state["staged"],
                   observability=observability["engine"][
                       "llama-60m staged f32 (K4)"]),
        tile_entry("gwt_adam_tile_q8", staged32["launches"]["K5"],
                   err_tile["K5"], rows_tile["K5"], phase_13_cases=tile_cases_run),
    ]
    print(json.dumps({"kernels": entries}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
