#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, MoE training and MoE
serving paths, its serving engine, its int4 fused-dequant matmul, the
platform's conformance gate, its spawn path and its suspend-to-checkpoint
sessions and warm starts on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each on stdout:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the time to build every CUDA kernel of the paths
   (``int4_dequant``, ``flash_fwd``, ``flash_bwd``, ``gmm``,
   ``swiglu_gmm``, ``tgmm``, ``int4_matmul``) from
   ``odh_kubeflow_tpu_torch/csrc`` into ``build/torch_kernels/``, one
   ``nvcc`` per source, all at once; ptxas's registers, spills and any
   warning (a serialised ``wgmma``) per kernel.
2. ``kernels``: each kernel against its plain PyTorch version on the
   card: the int4 dequant bit for bit at the Llama-3-8B forward's shapes;
   the flash forward, dQ and dK/dV in bf16 at the 8B training shape, the
   Mixtral-8x1B one (hd 64), the 1B shape, a ragged length, packed
   documents and a non-causal case, to a stated tolerance. Times by CUDA
   events (median), the least time the card could take (bytes over its
   bandwidth or flops over its bf16 peak, whichever is larger), the plain
   version's time and, for attention at the two training shapes,
   ``F.scaled_dot_product_attention``'s as a yardstick.
3. ``slice``: Llama-3-8B at full width and depth with an int4 base
   (random weights from a seed) served through ``CompletionService`` and
   its HTTP surface; int4 launches exactly 225 per forward.
4. ``parity_on_card``: the serving path with the kernel against the plain
   dequant (bit-identical logits, cache and greedy tokens).
5. ``profile``: where an 8B decode step's device time goes.
6. ``train``: the 8B QLoRA step (int4 base, LoRA r16 on wq/wk/wv/wo,
   remat "attn") through ``Trainer.benchmark`` at batch 2, seq 4096:
   step time, tokens/s, MFU, peak memory, and the exact launches of each
   kernel per step.
7. ``train_parity_on_card``: a 2-layer model at 8B width, the loss and
   every adapter gradient with the kernels against the plain versions,
   on an unpacked and a packed batch (an ``a`` or ``b`` leaf relative to
   its own norm; a ``scale`` leaf, a cancelling sum, relative to the sum
   of its terms' magnitudes, both readings reported); and remat "attn"
   against "none".
8. ``train_profile``: where one 8B training step's device time goes.
9. ``moe_kernels`` (right after ``kernels``): the grouped-matmul kernels
   (``gmm``, the fused SwiGLU forward and backward) against their plain
   versions at the Mixtral-8x1B training shapes (M 17,408 sorted rows, D
   2048, F 8192, E 8) on four routings (balanced, one expert, two empty
   experts, a large tail), per 128-row tile, into NaN-filled buffers;
   two planted faults per kernel that the check must reject; times, bounds,
   plain and ``torch._grouped_mm`` yardsticks; the int8 trans ``gmm``'s
   first pass (the lhs times its scale) also timed alone.
10. ``moe_train``: the Mixtral-8x1B QLoRA step (int8 expert banks,
    dropless grouped dispatch, remat "attn" + ``pin_expert_acts``, LoRA
    r16 on wq/wk/wv/wo) through ``Trainer.benchmark`` at batch 2, seq 4096,
    with exact launches per step of all six kernels on its path.
11. ``moe_train_profile``: one MoE step's device time by kernel kind
    (the ``gmm`` product and its int8 trans prescale pass apart).
12. ``moe_train_parity_on_card``: a 2-layer model at 8x1B width on a
    packed batch, kernels against plain versions.
13. ``moe_kernels`` also holds the bf16-bank ``gmm`` (serving prefill M
    3,072 and training M 17,408, both orientations) and ``tgmm`` (both
    bank layouts) per tile on the four routings, with planted faults (a
    wrong expert, a skipped last K chunk or 64-row chunk, an empty group
    left unwritten), ``tgmm`` also bitwise equal over two launches
    (balanced and one expert), times (one expert too), bounds, plain and
    library yardsticks.
14. ``moe_serve``: Mixtral-8x1B at full width and depth, bf16 weights,
    dispatch grouped, over HTTP: 4 ragged prompts and one of 700 tokens
    (grouped prefills, exactly 48 ``gmm`` each) and one of 32 (ragged),
    greedy, 32 new tokens; no kernel per decode step; TTFT, decode step,
    peak memory.
15. ``moe_serve_parity_on_card``: the same prefills and greedy requests
    with the plain versions, both runs on the kernel run's routing
    (``RoutingTape``): logits per row, the routing flips the plain run
    would have made, greedy flips; ``moe_profile``: where a Mixtral-8x1B
    decode step's time goes, at batch 1 and 4.
16. ``moe_full_train``: the Mixtral-8x1B full fine-tune (every leaf
    trains, bf16 Adam state), 8 layers, batch 2 x seq 4096, through
    ``Trainer.benchmark``: exact launches (64 ``gmm``, 24 ``tgmm``, 8 of
    each flash kernel a step), every expert of every bank moved;
    ``moe_full_train_profile``; ``moe_full_train_parity_on_card`` (2
    layers, loss and every gradient, kernels against plain versions).
17. ``int4_matmul_kernels`` (right after ``kernels``): the int4
    fused-dequant matmul and its dX (``int4_mm``, ``int4_dlhs``) against
    their plain versions per 128 x 128 tile into NaN-filled buffers, at
    Llama-3-8B's four projection shapes at M 8,192 (the QLoRA step), 4 and
    1 (decode), at ragged shapes (both directions' generic kernels where
    N % 16 != 0, a ragged M on the Hopper kernels), group 64 and group 8,
    each launch on the instance ``int4_mm_instance`` /
    ``int4_dlhs_instance`` names; every dX launched twice, bitwise equal;
    at M 8,192 also against the dequant path; four planted faults each;
    the lm_head and a float32 ``x`` refused; times, bounds, plain,
    ``torch.matmul`` on a bf16 copy (product only) and the dequant path,
    per launch and per 8B forward.
18. ``int4_qlora_proj`` (after it): one 8B layer's seven projections at
    M 8,192 through ``int4_matmul`` with autograd: exactly 7 + 7 launches,
    every forward and every dX on the Hopper kernels, and no dequant; dx
    per tile against the dequant route (and how many elements differ);
    peak memory and time of both routes.
19. ``engine`` (after ``profile``, on the 8B int4 parameters of
    ``slice``): ``CompletionService(engine_slots=8)`` (chunk 8, 256-token
    prefill parts, 4 prefix entries) over HTTP: 16 staggered SSE streams
    of 64 tokens (aggregate tok/s, tokens per decode step, TTFT and
    burst-gap ITL p50/p95, dequant launches per request, peak memory)
    against the serial one-shot path (8 of them, a seed takes it), with
    first-step logits and greedy tokens held to the one-shot path's;
    mixed sampling and eos in one chunk; a 1,000-token admission behind
    4 streams in parts and whole (the longest stall); a shared 256-token
    prefix (a miss, then a hit, their TTFT). The greedy and sampling
    chunks are captured as CUDA graphs (1,800 dequants a chunk).
20. ``spec``: the 8B int4 target with a Llama-3.2-1B int4 draft, k 4:
    single-stream ``speculative_generate`` and the engine's speculative
    chunk (a graph) against the target alone; acceptance, target passes
    per token, ms per round, the host's wait at each round's sync.
21. ``w8a8``: Llama-3-8B int8, W8A8 decode against the dequant path
    (greedy agreement over 32 tokens, ms per decode step at 1, 4 and 8
    rows, eager and in the engine's replayed chunk; ``_int8_matmul`` at
    those rows bit-equal to its CPU path).
22. ``moe_engine`` (after ``moe_profile``): Mixtral-8x1B bf16 through the
    engine: 4 ragged prompts and one of 700 tokens (one grouped prefill,
    48 ``gmm``, on the engine thread), greedy against the one-shot path.
23. ``engine_graphs``: ms per decode step at 1, 4 and 8 active slots,
    the chunk replayed as a graph and run eagerly, for both models, peak
    memory of each; a replayed chunk against the eager one from one state
    (bit-identical for the dense model; reported for Mixtral).

24. ``mesh_train`` (after ``train_parity_on_card``): the ``train`` phase's
    8B QLoRA step through ``Trainer(mesh=build_mesh(MeshConfig()))`` on an
    NCCL group of one rank: 1 warm-up and 3 steps whose losses must equal
    the ``train`` phase's bit for bit, the exact launches per step, step
    time and peak memory against it; then one ``run_elastic`` step (its
    gang all-gather over NCCL).
25. ``ring_on_card``: ring attention's block schedule with the flash
    kernels through the loopback driver (4 virtual ranks) at Llama-3-8B
    attention width (Hq 32, Hkv 8, hd 128), batch 1, seq 16,384, plain and
    zigzag, causal, forward and backward: per 64-position tile against the
    same schedule on the plain versions and against one whole-sequence
    call of each kernel (``flash_attention.TILE_RTOL``), flash launches
    equal to the live block pairs, ms against the whole-sequence call.
26. ``moe_mesh_train`` (after ``moe_train_parity_on_card``): the
    ``moe_train`` phase's Mixtral-8x1B QLoRA step through
    ``Trainer(mesh=build_mesh(MeshConfig()))`` on an NCCL group of one
    rank: losses equal to ``moe_train``'s bit for bit, the same launches a
    step, step time and peak memory against it.
27. ``moe_ep_loopback``: one Mixtral-8x1B MoE layer at B 2 x S 4096
    through the expert-parallel path's loopback driver (int8 and bf16
    banks, 2 and 4 expert shards, ``ep_capacity_factor`` None and 1.25):
    out, dx, the router's and the bf16 banks' gradients per 128-row tile
    against one whole-batch grouped call, launches equal to shards x the
    whole call's, dropped assignments, ms and peak memory against the
    whole call; first each grouped kernel at 1, 2 and 4 local groups (an
    ``m_loc``-row buffer with its tail, an empty first group) against its
    plain version per tile.
28. ``pipe_loopback``: Llama-3-8B QLoRA (int4, LoRA r16, remat "attn", 32
    layers) at batch 8 x seq 1024 three ways on one set of weights: the
    unpipelined step, GPipe (4 stages, 8 microbatches) through the
    loopback driver with autograd, and 1F1B through its loopback driver:
    ms per step, peak memory above the weights, the exact launches of each
    flash kernel and the dequant written from the schedule
    (``PIPE_LAUNCHES``), the device's busy share of an unpipelined and a
    GPipe step (``torch.profiler``); GPipe against the unpipelined step
    (loss, adapter a/b gradients), 1F1B against GPipe, 1F1B's peak below
    GPipe's; then a
    2-layer 8B-width stack pipelined (2 stages, 2 microbatches), kernels
    against plain versions as ``train_parity_on_card``.
29. ``moe_pipe_loopback``: Mixtral-8x1B QLoRA (``moe_train``'s config) the
    same way, unpipelined and GPipe: the LM loss against the unpipelined
    step's, the aux against the mean of the per-microbatch auxes, exact
    launches of every grouped and flash kernel, the device's busy share,
    the routing flips between the two steps; a 2-layer 8x1B-width stack
    pipelined, kernels against
    plain versions on the kernel run's routing (``RoutingTape``).

30. ``long_context_text`` (after ``ring_on_card``): the fine-tune path from
    text: the port's tokenizer trained on the pinned docs
    (``tests/data/tokenizer_corpus``) at vocab 512, a document a section,
    the native packer's first 1 x 16,384 row (segment ids; equal to the
    Python path's); the flash forward, dQ and dK/dV kernels at the row's
    shape with its segment ids against their plain versions (one KV head
    group at a time, ``TILE_RTOL``, lse2 to 1e-3); and the 8B QLoRA step
    on the row (int8 base, LoRA r16,
    flash) under remat "none", "attn" and "attn_offload" on one init: the
    loss and adapter gradients at the init (attn_offload bit-equal to attn,
    none within ``REMAT_NONE_GRAD_TOL``), exact flash launches (64 / 32 /
    32 forwards), bytes parked on the host, then per policy 1 warm-up and
    2 timed steps, peak memory and a profiled step's device busy share
    (the union of the device's kernel and copy intervals over the wall
    time) and compute share (kernels alone).
31. ``moe_offload`` (after ``moe_ep_loopback``): the ``moe_train``
    configuration's loss and adapter gradients on one batch under "attn"
    and "attn_offload" from one init, twice in turns, bit for bit, the same
    launches, the seconds and peak memory of each and the bytes parked.
32. ``platform_conformance`` (after ``long_context_text``): the port's
    platform gate, ``conformance.run_conformance`` on GPU node pools, all
    eleven transitions (register, spawn, ready, share, quota-reject, cull,
    restart, preempt, gang-restart, elastic-resume, delete), its step 10
    on the card: Llama-3-8B QLoRA (``train``'s config and shape) trained 6
    steps without a preemption, then again preempted at step 3 by
    ``run_elastic``'s guard, a fresh ``Trainer`` restoring the checkpoint
    (adapters and optimizer state bit-equal to the preempted trainer's
    before any step) and training on to step 6 with the uninterrupted
    run's losses, bit for bit; the scorecard, each step's loss and time,
    peak memory, and the flash and dequant launches, exactly
    ``TRAIN_LAUNCHES_PER_STEP`` times the 12 steps taken.
33. ``platform_spawn`` (after ``platform_conformance``): the spawn path on
    GPU node pools. The port's store with the notebook and PodDefault
    admission webhooks, the notebook and profile controllers (queueing
    on), ``SliceScheduler``, the kubelet simulator and the JWA over HTTP
    on localhost; node pools of H100s (2 zones × 16 nodes × 8, one pool
    spot) and L4s (8 × 4); 4 profiles with GPU quotas of 128 / 96 / 64 /
    32. 500 notebooks POSTed through the JWA in a seeded order (GPU counts
    0 / 1 / 2 / 4 / 8 / 16 at 40 / 25 / 15 / 10 / 7 / 3 %, one in ten GPU
    notebooks on L4, one in ten interactive), in waves of 25 with a round
    of the controllers after each; then to the fixed point, where more
    admission cycles write nothing, no node holds more GPUs than it has,
    no namespace more than its quota, every gang is bound whole or not at
    all, every pending Workload has a reason and every GPU pod the
    GPU-runtime env. POST ms, cycle ms at the full queue, seconds to the
    fixed point, the counts. Then one interactive 1-GPU H100 notebook's
    pod env (resolved as a kubelet would, the workspace volume on a fresh
    directory) runs ``chip_smoke.py --notebook-serve``: Llama-3-8B int4
    served on the card, one greedy request; cold (the dequant kernel
    built into the PodDefault's directory), then after a JWA stop and
    start, warm (nothing built); the same tokens, seconds from process
    start to the first token.
34. ``platform_sessions`` (after ``platform_spawn``): suspend-to-checkpoint
    sessions and the warm-start subsystem on one H100 pool of 2 nodes × 8
    GPUs: the notebook controller (queueing, sessions, the compile-cache
    mount), the ``SessionManager`` as the gang scheduler's suspender, a
    ``CompileCacheService`` and a WarmPool of one 1-GPU standby. Three
    ``--notebook-serve`` processes in their pods' envs: the cold standby
    (``nvcc`` builds ``int4_dequant`` into ``staging_dir("cold")``,
    ``ingest_dir`` registers it), the notebook a JWA POST handed that
    standby (its mount filled by ``materialize_dir``; nothing built, the
    same tokens), and after a JWA suspend (the snapshot's receipt, the
    GPU to a waiting 8-GPU gang, the quota block's suspended GPU) and a
    JWA resume (the state restored with an equal digest before ready),
    the resumed notebook (nothing built, the same tokens); then one
    flipped byte of the stored artifact stages nothing.

Then the kernel table (``{"kernels": [...]}``), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero without the last line. Without a GPU it exits
2 and prints nothing on stdout.
"""

from __future__ import annotations

import os
import json
import math
import statistics
import sys
import time
import urllib.error
import urllib.request

# spec memory bandwidth by card (NVIDIA data sheets), bytes/s
SPEC_BANDWIDTH = (
    ("H100 80GB HBM3", 3.35e12),  # H100 SXM
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H200", 4.8e12),
)
INT4_GROUP = 128
# (name, K, N, launches per 8B forward) of every int4 matmul weight
SHAPES_8B = (
    ("wq/wo", 4096, 4096, 64),
    ("wk/wv", 4096, 1024, 64),
    ("w_gate/w_up", 4096, 14336, 64),
    ("w_down", 14336, 4096, 32),
    ("lm_head", 4096, 128256, 1),
)
# ragged shapes, one group (group = K): the tail kernel and a row count
# that is not a multiple of the rows per thread
SHAPES_RAGGED = (("ragged", 154, 1003), ("ragged16", 74, 208))
LAUNCHES_PER_FORWARD = 225
# flash attention shapes: (name, B, S, Hq, Hkv, hd, causal, packed); the
# first is the Llama-3-8B training step's, the main path's, the second the
# Mixtral-8x1B steps' (hd 64); both are also timed against the plain
# version and SDPA
FLASH_SHAPES = (
    ("8b_train", 2, 4096, 32, 8, 128, True, False),
    ("8x1b_train", 2, 4096, 32, 8, 64, True, False),
    ("1b_train", 8, 1024, 32, 8, 64, True, False),
    ("ragged1000", 2, 1000, 32, 8, 128, True, False),
    ("packed", 2, 4096, 32, 8, 128, True, True),
    ("non_causal", 1, 2048, 32, 8, 128, False, False),
)
# kernel vs plain in bf16: the sums run in another order (online softmax
# over 64-key tiles against one pass with the global row max, P and dS
# rounded to bf16 at different points), so agreement is to a few bf16
# ulps. Each output is held per tile of 64 positions of one row and head:
# ||kernel - plain|| / ||plain|| <= flash_attention.TILE_RTOL[kernel] in
# every tile (``flash_attention.tile_rel_err``), so a late tile is held to
# its own scale; lse2 (f32) to 1e-3 absolute
# planted faults at the 8B shape, each of which the check must reject: a
# forward and a dQ that skip the key tile at FAULT_TILE, a dK/dV that
# skips the query tile there
FAULT_TILE = (2048, 64)
MAIN_FLASH_SHAPES = ("8b_train", "8x1b_train")
# the 8B QLoRA training step: (batch, seq), and launches per step. Each
# of the 32 layers runs the flash forward once (remat "attn" saves its
# residuals) and the dQ and dK/dV kernels once; the int4 dequant runs for
# the 7 weights of each layer in the forward and again in the layer's
# recompute, plus once for the lm_head: 2 * 224 + 1
TRAIN_SHAPE = (2, 4096)
TRAIN_LAUNCHES_PER_STEP = {"flash_fwd": 32, "flash_dq": 32, "flash_dkv": 32,
                           "int4_dequant": 2 * 224 + 1}
# the platform gate's step 10: the steps its three runs take in all (6
# uninterrupted, then 3 preempted and 3 resumed)
CONFORMANCE_STEPS = 12
# the 2-layer parity model: ||kernel - plain|| / ||plain|| <= tol for
# every adapter gradient leaf; relative tolerance on the loss
TRAIN_GRAD_TOL = 5e-2
TRAIN_LOSS_RTOL = 2e-3
# remat "none" against "attn" on one model: the same arithmetic recomputed,
# max |none - attn| / max |attn| per adapter gradient leaf
REMAT_NONE_GRAD_TOL = 1e-3
# the Mixtral-8x1B QLoRA step: (batch, seq); M = round_up(B·S·k + E·128, 512)
# sorted rows per layer; launches per step. Each of the 16 layers runs, in
# the forward, the flash forward, the fused SwiGLU and the down projection
# (K 8192); remat "attn" with pin_expert_acts saves the flash residuals and
# the expert op's (y, g), so the recompute launches nothing; the backward
# runs dQ, dK/dV, the down dlhs (K 2048), the SwiGLU backward and the
# gate and up dlhs (K 8192)
MOE_TRAIN_SHAPE = (2, 4096)
MOE_M = 17_408
MOE_LAUNCHES_PER_STEP = {"flash_fwd": 16, "flash_dq": 16, "flash_dkv": 16,
                         "swiglu_fwd": 16, "swiglu_bwd": 16, "gmm_k8192": 48,
                         "gmm_k2048": 16, "gmm": 64, "gmm_bf16_k2048": 0,
                         "gmm_bf16_k8192": 0, "tgmm": 0}
# Mixtral-8x1B served at full depth with bf16 weights, dispatch grouped: a
# prefill of B·S·k >= 2048 assignments is grouped, M = round_up(B·S·k +
# E·128, 512) = 3072 sorted rows for [4, 256] and [1, 1024]; per grouped
# prefill each of the 16 layers runs gate and up (K 2048) and down (K 8192)
# on bf16 banks; decode steps take the ragged path, no kernel
MOE_SERVE_BATCH = (4, 256)
MOE_SERVE_M = 3072
MOE_SERVE_PREFILL = {"gmm_bf16_k2048": 32, "gmm_bf16_k8192": 16, "gmm": 48}
# serving parity, kernels against plain versions on the card, both runs
# on the kernel run's routing (RoutingTape): prefill logits per row,
# ||kernel - plain|| / ||plain|| over the row's real positions, within
# SERVE_LOGITS_RTOL (bf16 roundings taken in another order, carried
# through 16 layers; a tile given the wrong expert reads O(1)); greedy
# tokens identical up to any step whose top-2 logit margin is below
# GREEDY_FLIP_MARGIN, where a flip is reported
SERVE_LOGITS_RTOL = 5e-2
GREEDY_FLIP_MARGIN = 2e-1
# the Mixtral-8x1B full fine-tune, cut to 8 layers (16 layers hold 6.87e9
# bf16 params: params, grads and Adam's moments are 51.2 GiB before the
# optimizer's temporaries), batch 2 x seq 4096, remat "attn" without
# pin_expert_acts. Per layer and step: flash fwd, dQ, dK/dV once; gmm 3 in
# the forward (gate, up at K 2048; down at K 8192), 2 in the backward's
# recompute (gate, up: the expert op's saved output is y, JAX's "moe_y"),
# 3 dlhs (down at K 2048; gate, up at K 8192); tgmm 3 (the bank gradients)
MOE_FULL_LAYERS = 8
MOE_FULL_LAUNCHES_PER_STEP = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8,
                              "swiglu_fwd": 0, "swiglu_bwd": 0, "gmm_k8192": 0,
                              "gmm_k2048": 0, "gmm": 64, "gmm_bf16_k2048": 40,
                              "gmm_bf16_k8192": 24, "tgmm": 24}

# the int4 fused-dequant matmul (slice 5): Llama-3-8B's four distinct int4
# projection shapes (name, K, N, launches per 8B forward: 224 in all), at
# the QLoRA step's rows (batch 2 x seq 4096) and at decode (batch 4, 1)
INT4_MM_SHAPES = (
    ("wq/wo", 4096, 4096, 64),
    ("wk/wv", 4096, 1024, 64),
    ("gate/up", 4096, 14336, 64),
    ("down", 14336, 4096, 32),
)
INT4_MM_ROWS = (8192, 4, 1)
# shapes the contract accepts beyond those: ragged M and N (N % 16 != 0:
# both directions' generic instances), ragged M on the Hopper kernels,
# group 64 and a small group (scales by __ldg): (label, M, K, N, group)
INT4_MM_EXTRA = (
    ("ragged", 300, 2048, 200, 128),
    ("ragged decode", 1, 2048, 100, 128),
    ("ragged M", 300, 4096, 4096, 128),
    ("group 64", 512, 4096, 1024, 64),
    ("group 8", 512, 4096, 1024, 8),
)
# the 8B layer's seven projections at the QLoRA step's rows: (name, K, N)
INT4_LAYER = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
              ("wo", 4096, 4096), ("w_gate", 4096, 14336), ("w_up", 4096, 14336),
              ("w_down", 14336, 4096))
# the layer's dx through the kernels against the dequant route, per 128 x
# 128 tile: the two routes' bf16 activations (q, g, u) differ where sums
# taken in another order round apart, and those differences pass through
# silu(g)·u and a second product before they reach dx, so the bar is 5x
# the single-kernel TILE_RTOL
INT4_PROJ_RTOL = 1e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def spec_bandwidth(name: str) -> float:
    for key, bw in SPEC_BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"no spec bandwidth known for {name!r}")


def time_ms(torch, fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls, by
    CUDA events, after one warm-up call. The card first spins for ~10 ms
    so the host can queue all ``iters`` launches before the first one
    runs: the events then time the device, not the launch cost of a
    small shape."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # clock cycles
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernels_phase(torch, int4, bw: float) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    rows, max_err = [], 0.0
    shapes = [(n, K, N, K // INT4_GROUP, c) for n, K, N, c in SHAPES_8B]
    shapes += [(n, K, N, 1, 0) for n, K, N in SHAPES_RAGGED]
    for name, K, N, g, per_fwd in shapes:
        # enough distinct copies that a timed run reads cold weights, as
        # each layer's weights are cold in a forward (the L2 is 50 MB);
        # at most 32, so the host queues a timed run inside the spin
        out_bytes = K * N * 2
        copies = min(32, max(1, math.ceil(200e6 / (out_bytes + K * N // 2))))
        packed = [
            torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
            for _ in range(copies)
        ]
        scale = [
            torch.rand((g, N), generator=gen, device="cuda") * 0.02 + 1e-4
            for _ in range(copies)
        ]
        for dtype in (torch.bfloat16, torch.float32):
            got = int4.int4_dequant(packed[0], scale[0], dtype)
            want = int4.int4_dequant_reference(packed[0], scale[0], dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int4_dequant {name} {dtype}: max abs err {err} vs plain"
                )
            max_err = max(max_err, err)
            del got, want
            ms = time_ms(
                torch,
                lambda i: int4.int4_dequant(packed[i % copies], scale[i % copies], dtype),
                iters=max(20, copies),
            )
            plain_ms = time_ms(
                torch,
                lambda i: int4.int4_dequant_reference(
                    packed[i % copies], scale[i % copies], dtype
                ),
                iters=3,
                reps=3,
            )
            nbytes = K // 2 * N + g * N * 4 + K * N * (2 if dtype == torch.bfloat16 else 4)
            rows.append({
                "shape": name, "K": K, "N": N, "group": K // g,
                "dtype": str(dtype).replace("torch.", ""),
                "launches_per_8b_forward": per_fwd if dtype == torch.bfloat16 else 0,
                "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / bw * 1e3, "max_abs_err": err,
            })
        del packed, scale
        torch.cuda.empty_cache()
    fwd = [r for r in rows if r["launches_per_8b_forward"]]
    return {
        "name": "int4_dequant",
        "route": "cuda",
        "source": "odh_kubeflow_tpu_torch/csrc/int4_dequant.cu",
        "replaces": "odh_kubeflow_tpu/ops/pallas_int4.py:29",
        "tpu_kernel": "_dequant_kernel (pallas_call at odh_kubeflow_tpu/ops/pallas_int4.py:58)",
        "max_abs_err": max_err,
        # ms, plain_ms and bound_ms are for one 8B forward's 225 launches
        # (bf16 out, the serving path's dtype); per-shape rows follow
        "unit": "one Llama-3-8B forward (225 launches, bf16 out)",
        "ms": sum(r["ms"] * r["launches_per_8b_forward"] for r in fwd),
        "plain_ms": sum(r["plain_ms"] * r["launches_per_8b_forward"] for r in fwd),
        "bound_ms": sum(r["bound_ms"] * r["launches_per_8b_forward"] for r in fwd),
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes this unpack
        "shapes": rows,
    }


def post(base: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        base + "/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def slice_phase(torch, int4, cfg, params) -> tuple[dict, dict]:
    """Serve three kinds of request over HTTP; returns the phase record
    and the single greedy request (prompt, completion) for parity."""
    from odh_kubeflow_tpu_torch.models.serve import CompletionService, serve

    V = cfg.vocab_size
    gen = torch.Generator().manual_seed(7)

    def prompt(n):
        return torch.randint(1, V, (n,), generator=gen).tolist()

    single = [prompt(32)]
    ragged = [prompt(n) for n in (17, 64, 200, 256)]
    sampled = [prompt(40), prompt(90)]
    requests = [
        ("warmup", {"prompt": [prompt(8)], "max_tokens": 2}),
        ("single_first_token", {"prompt": single, "max_tokens": 1}),
        ("single", {"prompt": single, "max_tokens": 32}),
        ("ragged4_first_token", {"prompt": ragged, "max_tokens": 1}),
        ("ragged4", {"prompt": ragged, "max_tokens": 32}),
        ("sampled", {"prompt": sampled, "max_tokens": 32, "temperature": 0.8,
                     "top_k": 50, "top_p": 0.9, "seed": 11}),
    ]
    service = CompletionService(params, cfg, device="cuda")
    httpd = serve(service, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results = {}
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"/healthz answered {r.status}")
        torch.cuda.reset_peak_memory_stats()
        int4.launches = 0  # the main path's count starts here
        for name, body in requests:
            before = int4.launches
            t0 = time.perf_counter()
            code, out = post(base, body)
            dt = time.perf_counter() - t0
            if code != 200:
                raise AssertionError(f"{name}: HTTP {code}: {out}")
            comps = out["completions"]
            n = body["max_tokens"]
            if len(comps) != len(body["prompt"]):
                raise AssertionError(f"{name}: {len(comps)} completions")
            for c in comps:
                if len(c) != n or not all(0 <= t < V for t in c):
                    raise AssertionError(f"{name}: bad completion {c}")
            launched = int4.launches - before
            if launched != LAUNCHES_PER_FORWARD * (1 + n):
                raise AssertionError(
                    f"{name}: int4_dequant launched {launched} times, expected "
                    f"{LAUNCHES_PER_FORWARD} x {1 + n}"
                )
            results[name] = {"seconds": dt, "launches": launched,
                             "padded_shape": out["usage"]["padded_shape"],
                             "completion_tokens": out["usage"]["completion_tokens"]}
            if name == "single":
                served = {"prompt": single[0], "completion": comps[0]}
        total_launches = int4.launches
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
    finally:
        httpd.shutdown()
        httpd.server_close()

    def decode(prefix, rows):
        first = results[f"{prefix}_first_token"]["seconds"]
        full = results[prefix]["seconds"]
        step = (full - first) / 31
        return {"ttft_s": first, "request_s": full, "decode_step_ms": step * 1e3,
                "decode_tok_s": rows / step}

    record = {
        "phase": "slice",
        "config": "llama3_8b int4 (group 128), 32 layers, random weights (seed 0)",
        "launches": total_launches,
        "requests": results,
        "single": decode("single", 1),
        "ragged4": decode("ragged4", 4),
        "peak_memory_gb": peak_gb,
    }
    return record, served


def parity_phase(torch, int4, cfg, params, served) -> dict:
    """The kernel's dequant against the plain one inside the model."""
    from odh_kubeflow_tpu_torch.models.generate import init_cache
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig, forward_with_cache
    from odh_kubeflow_tpu_torch.models.quant import streaming_quantized_init
    from odh_kubeflow_tpu_torch.models.serve import CompletionService

    def with_plain_dequant(fn):
        kernel = int4.int4_dequant
        int4.int4_dequant = int4.int4_dequant_reference
        try:
            return fn()
        finally:
            int4.int4_dequant = kernel

    cfg2 = LlamaConfig.llama3_8b(num_layers=2)
    p2 = streaming_quantized_init(cfg2, 1, bits=4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, steps = 2, 16, 2
    toks = torch.randint(0, cfg2.vocab_size, (B, S + steps), generator=gen, device="cuda")

    def run():
        cache = init_cache(cfg2, B, S + steps, device="cuda")
        mask = torch.zeros((B, S + steps), dtype=torch.bool, device="cuda")
        mask[:, :S] = True
        pos = torch.arange(S, device="cuda").expand(B, S)
        outs = [forward_with_cache(p2, toks[:, :S], cfg2, cache, 0,
                                   positions=pos, kv_mask=mask)[0]]
        for i in range(steps):
            mask[:, S + i] = True
            pos = torch.full((B, 1), S + i, device="cuda")
            outs.append(forward_with_cache(p2, toks[:, S + i : S + i + 1], cfg2, cache,
                                           S + i, positions=pos, kv_mask=mask)[0])
        torch.cuda.synchronize()
        return outs, cache

    k_logits, k_cache = run()
    p_logits, p_cache = with_plain_dequant(run)
    if k_logits[0].shape != (B, S, cfg2.vocab_size):
        raise AssertionError(f"prefill logits shape {tuple(k_logits[0].shape)}")
    for a, b in zip(k_logits, p_logits):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite logits")
        if not torch.equal(a, b):
            raise AssertionError(
                f"logits differ: max abs {(a - b).abs().max().item()}"
            )
    for k in ("k", "v"):
        if not torch.equal(k_cache[k], p_cache[k]):
            raise AssertionError(f"cache {k} differs")
    del p2, k_cache, p_cache

    # the served request again, on the same path and padded shape, with
    # the plain dequant in the kernel's place
    before = int4.launches
    service = CompletionService(params, cfg, device="cuda")
    plain = with_plain_dequant(
        lambda: service.complete([served["prompt"]], max_tokens=32)
    )
    if int4.launches != before:
        raise AssertionError("the plain run launched the kernel")
    plain_tokens = plain["completions"][0]
    if plain_tokens != served["completion"]:
        raise AssertionError(
            f"served greedy tokens {served['completion']} != plain {plain_tokens}"
        )
    return {
        "phase": "parity_on_card",
        "two_layer_8b_width": "prefill + 2 decode steps: logits and cache bit-identical",
        "served_vs_plain_32_layers": "32 greedy tokens identical",
    }


def device_kernels(prof) -> dict:
    """{kernel name: (device microseconds, launches)} of a profiler run;
    a kernel event's ``device_time_total`` is its own duration."""
    kernels = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = e.name if len(e.name) <= 60 else e.name[:57] + "..."
            total, count = kernels.get(name, (0.0, 0))
            kernels[name] = (total + e.device_time_total, count + 1)
    return kernels


def profile_phase(torch, cfg, params, batch: int) -> dict:
    """Where one decode step's time goes (a dense or MoE model): its wall
    time (CUDA events, no profiler), then ``torch.profiler`` over the same
    steps for the device's busy share and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from odh_kubeflow_tpu_torch.models.generate import family_forward, init_cache

    cache_cfg, forward_with_cache = family_forward(cfg)
    S, steps = 64, 8
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (batch, S + 2 * steps + 1),
                         generator=gen, device="cuda")
    cache = init_cache(cache_cfg, batch, S + 2 * steps + 1, device="cuda")
    mask = torch.zeros((batch, S + 2 * steps + 1), dtype=torch.bool, device="cuda")
    mask[:, :S] = True
    forward_with_cache(params, toks[:, :S], cfg, cache, 0,
                       positions=torch.arange(S, device="cuda").expand(batch, S),
                       kv_mask=mask)

    def step(i):
        mask[:, S + i] = True
        forward_with_cache(params, toks[:, S + i : S + i + 1], cfg, cache, S + i,
                           positions=torch.full((batch, 1), S + i, device="cuda"),
                           kv_mask=mask)

    step(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, steps + 1):
        step(i)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps + 1, 2 * steps + 1):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = device_kernels(prof)
    device_ms = sum(t for t, _ in kernels.values()) / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "batch": batch,
        "decode_step_ms": step_ms,
        "profiled_step_wall_ms": wall_ms,
        "device_kernel_ms_per_step": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / wall_ms if kernels else "not measured",
        "top_kernels_ms_per_step": [
            {"kernel": k, "ms": t / 1e3 / steps, "launches": c // steps}
            for k, (t, c) in top
        ],
    }


def _live_pairs(B, S, causal, seg):
    """(query, key) pairs that attend, per query head, over the batch."""
    if seg is None:
        return B * (S * (S + 1) // 2 if causal else S * S)
    total = 0
    for row in seg.tolist():
        runs, prev = [], None
        for x in row:
            if x == prev:
                runs[-1] += 1
            else:
                runs.append(1)
                prev = x
        total += sum(n * (n + 1) // 2 if causal else n * n for n in runs)
    return total


def flash_work(B, S, Hq, Hkv, hd, pairs) -> dict:
    """{kernel: (flops, bytes)} of one flash launch over ``pairs`` live
    (query, key) pairs a query head: each input read once, each output
    written once."""
    qb, kb = B * S * Hq * hd * 2, B * S * Hkv * hd * 2
    rowb = B * Hq * S * 4
    return {
        "flash_fwd": (4 * hd * pairs * Hq, 2 * qb + 2 * kb + rowb),
        "flash_dq": (6 * hd * pairs * Hq, 3 * qb + 2 * kb + 2 * rowb),
        "flash_dkv": (8 * hd * pairs * Hq, 2 * qb + 4 * kb + 2 * rowb),
    }


def planted_faults(torch, fa, args, wants) -> dict:
    """Three broken kernels, made from the plain versions with segment ids
    and held to the check the real ones pass: a forward and a dQ that skip
    the key tile at ``FAULT_TILE``, a dK/dV that skips the query tile
    there. The check must reject each. ``max_abs_over_max`` is what a check
    against the tensor's largest value would see of the same fault."""
    q, k, v, lse, delta, do, _, _ = args
    want_out, want_dq, want_dk, want_dv = wants
    B, S = q.shape[:2]
    t0, width = FAULT_TILE
    zeros = torch.zeros((B, S), dtype=torch.int32, device=q.device)
    tile = zeros.clone()
    tile[:, t0 : t0 + width] = 1
    # the tile's keys (or queries) in a document of their own
    out_f, _ = fa.flash_fwd_reference(q, k, v, zeros, tile)
    dq_f = fa.flash_dq_reference(q, k, v, lse, delta, do, zeros, tile)
    dk_f, dv_f = fa.flash_dkv_reference(q, k, v, lse, delta, do, tile, zeros)
    cases = (
        ("flash_fwd", f"skips keys {t0}..{t0 + width - 1}", [(out_f, want_out)]),
        ("flash_dq", f"skips keys {t0}..{t0 + width - 1}", [(dq_f, want_dq)]),
        ("flash_dkv", f"skips queries {t0}..{t0 + width - 1}", [(dk_f, want_dk), (dv_f, want_dv)]),
    )
    result = {}
    for name, fault, pairs in cases:
        rel = max(fa.tile_rel_err(got, want) for got, want in pairs)
        over = max(((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
                   for got, want in pairs)
        if rel <= fa.TILE_RTOL[name]:
            raise AssertionError(f"{name}: the check passed a planted fault ({fault}): {rel}")
        result[name] = {"fault": fault, "tile_rel_err": rel, "max_abs_over_max": over}
    return result


def flash_kernels_phase(torch, fa, bw: float, peak: float) -> list[dict]:
    """Each flash kernel against its plain version at every shape; times
    (kernel at every shape, plain and SDPA at the main path's) and bounds."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    stats = {n: {"max_abs_err": 0.0, "tile_rel_err": 0.0, "shapes": []}
             for n in ("flash_fwd", "flash_dq", "flash_dkv")}

    def close(name, got, want, shape):
        err = (got.float() - want.float()).abs().max().item()
        rel = fa.tile_rel_err(got, want)
        if not rel <= fa.TILE_RTOL[name]:
            raise AssertionError(f"{name} {shape}: tile relative err {rel} > "
                                 f"{fa.TILE_RTOL[name]}")
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["tile_rel_err"] = max(st["tile_rel_err"], rel)
        return err, rel

    for shape, B, S, Hq, Hkv, hd, causal, packed in FLASH_SHAPES:
        def rnd(*dims):
            return torch.randn(dims, generator=gen, device="cuda").to(torch.bfloat16)

        q, k, v, do = rnd(B, S, Hq, hd), rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd), rnd(B, S, Hq, hd)
        seg = None
        if packed:  # documents of 200..1800 tokens back to back
            cuts = torch.randint(200, 1800, (B, 8), generator=gen, device="cuda").cumsum(1)
            seg = (torch.arange(S, device="cuda")[None, :, None] >= cuts[:, None, :]).sum(-1)
            seg = seg.to(torch.int32).contiguous()
        kw = dict(causal=causal, q_offset=0)
        out, lse = fa.flash_fwd(q, k, v, seg, seg, **kw)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, seg, seg, **kw)
        errs = {"flash_fwd": close("flash_fwd", out, ref_out, shape)}
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= 1e-3:
            raise AssertionError(f"flash_fwd {shape}: lse2 max abs err {lse_err}")
        del ref_lse
        delta = fa.flash_delta(out, do)
        args = (q, k, v, lse, delta, do, seg, seg)
        dq = fa.flash_dq(*args, **kw)
        ref_dq = fa.flash_dq_reference(*args, **kw)
        errs["flash_dq"] = close("flash_dq", dq, ref_dq, shape)
        dk, dv = fa.flash_dkv(*args, **kw)
        rk, rv = fa.flash_dkv_reference(*args, **kw)
        ek, ev = close("flash_dkv", dk, rk, shape), close("flash_dkv", dv, rv, shape)
        errs["flash_dkv"] = (max(ek[0], ev[0]), max(ek[1], ev[1]))
        if shape == FLASH_SHAPES[0][0]:
            for name, fault in planted_faults(torch, fa, args, (ref_out, ref_dq, rk, rv)).items():
                stats[name]["planted_fault"] = fault
        del dq, dk, dv, rk, rv, ref_out, ref_dq
        torch.cuda.empty_cache()

        pairs = _live_pairs(B, S, causal, seg)
        work = flash_work(B, S, Hq, Hkv, hd, pairs)
        launch = {
            "flash_fwd": lambda i: fa.flash_fwd(q, k, v, seg, seg, **kw),
            "flash_dq": lambda i: fa.flash_dq(*args, **kw),
            "flash_dkv": lambda i: fa.flash_dkv(*args, **kw),
        }
        for name in stats:
            flops, nbytes = work[name]
            row = {
                "shape": shape, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
                "causal": causal, "packed": packed, "live_pairs_per_head": pairs,
                "flops": flops, "bytes": nbytes, "max_abs_err": errs[name][0],
                "tile_rel_err": errs[name][1],
                "ms": time_ms(torch, launch[name], iters=10),
                "bound_ms": max(flops / peak, nbytes / bw) * 1e3,
                "bound_by": "operations" if flops / peak > nbytes / bw else "bytes",
            }
            row["tflops_per_s"] = flops / row["ms"] / 1e9
            stats[name]["shapes"].append(row)

        if shape in MAIN_FLASH_SHAPES:  # the main paths' shapes: plain and library
            plain = {
                "flash_fwd": lambda i: fa.flash_fwd_reference(q, k, v, seg, seg, **kw),
                "flash_dq": lambda i: fa.flash_dq_reference(*args, **kw),
                "flash_dkv": lambda i: fa.flash_dkv_reference(*args, **kw),
            }
            qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=True)
            lib_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, enable_gqa=True), iters=10)
            g = do.transpose(1, 2)
            lib_bwd = time_ms(torch, lambda i: torch.autograd.grad(
                sdpa, (qh, kh, vh), g, retain_graph=True), iters=10)
            # SDPA's backward computes dQ, dK and dV in one call: it stands
            # beside the dK/dV row alone, so the pair is not counted twice
            library = {"flash_fwd": lib_fwd, "flash_dq": None, "flash_dkv": lib_bwd}
            for name in stats:
                main = stats[name]["shapes"][-1]
                main["plain_ms"] = time_ms(torch, plain[name], iters=2, reps=3)
                main["library_ms"] = library[name]
                torch.cuda.empty_cache()
            # the backward pair, the dK/dV row beside SDPA's backward
            dkv_main = stats["flash_dkv"]["shapes"][-1]
            dkv_main["flash_bwd_pair_ms"] = stats["flash_dq"]["shapes"][-1]["ms"] + dkv_main["ms"]
            del sdpa, qh, kh, vh
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()

    rows = []
    tpu = {"flash_fwd": (169, 361, "_fwd_kernel"), "flash_dq": (401, 696, "_dq_kernel"),
           "flash_dkv": (489, 781, "_dkv_kernel")}
    for name, st in stats.items():
        main = st["shapes"][0]
        line, call, fn = tpu[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "odh_kubeflow_tpu_torch/csrc/"
            + ("flash_fwd.cu" if name == "flash_fwd" else "flash_bwd.cu"),
            "replaces": f"odh_kubeflow_tpu/ops/pallas_attention.py:{line}",
            "tpu_kernel": f"{fn} (pallas_call at odh_kubeflow_tpu/ops/pallas_attention.py:{call})",
            "max_abs_err": st["max_abs_err"],
            "tile_rel_err": st["tile_rel_err"],
            "tolerance": f"||kernel - plain|| / ||plain|| <= {fa.TILE_RTOL[name]} in every "
                         "tile of 64 positions of one row and head, bf16",
            "planted_fault": st["planted_fault"],
            # ms, plain_ms, bound_ms and library_ms: one launch at the 8B
            # training shape (B 2, S 4096, 32/8 heads, hd 128, causal)
            "unit": "one launch at the 8B training shape",
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            # one SDPA call: the forward, or on the dK/dV row the backward,
            # which computes dQ, dK and dV together (dQ: null)
            "library_ms": main["library_ms"],
            "shapes": st["shapes"],
        })
        if name == "flash_dkv":  # dQ + dK/dV, to stand beside library_ms
            rows[-1]["flash_bwd_pair_ms"] = main["flash_bwd_pair_ms"]
    return rows


def counts(fa, int4) -> dict:
    return {"flash_fwd": fa.fwd_launches, "flash_dq": fa.dq_launches,
            "flash_dkv": fa.dkv_launches, "int4_dequant": int4.launches}


def zero_counts(fa, int4) -> None:
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = int4.launches = 0
    int4.mm_launches = int4.dlhs_launches = 0
    int4.mm_launches_by_instance.clear()
    int4.dlhs_launches_by_instance.clear()


def train_phase(torch, fa, int4, peak: float) -> tuple[dict, object]:
    """The 8B QLoRA training step through ``Trainer.benchmark``."""
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    B, S = TRAIN_SHAPE
    cfg = LlamaConfig.llama3_8b(remat=True, remat_policy="attn")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4",
                      precompile_batch=(B, S))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 2**30
    steps, warmup = 3, 1
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, int4)  # the training path's count starts here
    bench, step_losses = benchmark_with_losses(trainer, B, S, steps, warmup)
    launched = counts(fa, int4)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = {k: n * (steps + warmup) for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
    if launched != expected:
        raise AssertionError(f"training launches {launched}, expected {expected}")
    metrics = trainer.train_step(trainer.make_fake_batch(B, S, seed=1))
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"loss {loss}, grad_norm {gnorm}")
    if not math.isfinite(bench["loss"]):
        raise AssertionError(f"benchmark loss {bench['loss']}")
    moved = {n: trainer.lora_params["layers"][n]["b"].abs().max().item()
             for n in trainer.lora_params["layers"]}
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"adapters b did not move from zero: {moved}")
    record = {
        "phase": "train",
        "config": "llama3_8b QLoRA: int4 base (group 128, random weights, seed 0), "
                  "LoRA r16 on wq/wk/wv/wo, remat attn, 32 layers",
        "batch": B, "seq": S, "steps": steps, "warmup": warmup,
        "init_s": init_s, "resident_params_gb": resident_gb, "peak_memory_gb": peak_gb,
        "step_time_s": bench["step_time_s"], "tokens_per_s": bench["tokens_per_s"],
        "model_flops_per_step": bench["model_flops_per_step"],
        "strict_mfu": bench["flops_per_s"] / peak,
        "train_equiv_mfu": bench["train_equiv_flops_per_s"] / peak,
        "peak_flops": peak, "loss_benchmark": bench["loss"], "step_losses": step_losses,
        "loss_after": loss, "grad_norm_after": gnorm,
        "launches": launched, "launches_per_step": TRAIN_LAUNCHES_PER_STEP,
        "adapter_b_max_abs": moved,
    }
    return record, trainer


def benchmark_with_losses(trainer, B: int, S: int, steps: int, warmup: int):
    """``Trainer.benchmark`` and the loss of each of its steps (kept as
    device tensors while it runs: no extra synchronisation)."""
    losses = []
    step = trainer.train_step

    def recording(batch):
        metrics = step(batch)
        losses.append(metrics["loss"])
        return metrics

    trainer.train_step = recording
    try:
        bench = trainer.benchmark(B, S, steps=steps, warmup=warmup)
    finally:
        del trainer.train_step  # back to the class's method
    return bench, [float(x) for x in losses]


def platform_conformance_phase(torch, fa, int4) -> tuple[dict, dict]:
    """The port's platform conformance gate, its step 10 training the 8B
    QLoRA model on the card through ``run_elastic``: preempted at step 3,
    resumed by a fresh trainer to step 6."""
    from odh_kubeflow_tpu_torch import conformance

    step10: dict = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, int4)  # the gate's count starts here
    t0 = time.perf_counter()
    scorecard = conformance.run_conformance(device="cuda", record=step10)
    seconds = time.perf_counter() - t0
    launched = counts(fa, int4)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if list(scorecard) != list(conformance.SCORECARD) or set(scorecard.values()) != {"PASS"}:
        raise AssertionError(f"conformance scorecard {scorecard}")
    taken = len(step10["reference_losses"]) + len(step10["step_losses"])
    expected = {k: n * CONFORMANCE_STEPS for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
    if taken != CONFORMANCE_STEPS or launched != expected:
        raise AssertionError(f"conformance launches {launched} over {taken} steps, "
                             f"expected {expected}")
    if not step10["resumed_bit_equal"]:
        raise AssertionError("resumed adapters differ from the preempted trainer's")
    if step10["step_losses"] != step10["reference_losses"]:
        raise AssertionError(f"resumed losses {step10['step_losses']} differ from the "
                             f"uninterrupted run's {step10['reference_losses']}")
    record = {
        "phase": "platform_conformance",
        "config": "conformance.run_conformance on GPU node pools (nvidia-h100-80gb, 8 "
                  "GPUs a node); step 10: llama3_8b QLoRA int4, LoRA r16, remat attn, "
                  "flash, 32 layers, 6 steps uninterrupted, then preempted at step 3 "
                  "and resumed by a fresh Trainer to 6",
        "scorecard": scorecard, "seconds": seconds, "peak_memory_gb": peak_gb,
        "batch": step10["batch"], "seq": step10["seq"],
        "steps_before_resume": step10["first_run"]["step"],
        "resumed_from": step10["second_run"]["resumed_from"],
        "steps_after_resume": step10["second_run"]["step"],
        "resumed_bit_equal": step10["resumed_bit_equal"],
        "step_losses": step10["step_losses"], "step_s": step10["step_s"],
        "reference_losses": step10["reference_losses"],
        "checkpoint_steps": step10["checkpoint_steps"],
        "launches": launched, "launches_per_step": TRAIN_LAUNCHES_PER_STEP,
    }
    return record, launched


# the platform's spawn path at the scale of the repo's control-plane bench
# (loadtest/control_plane_bench.py: 500 notebooks over 4 namespaces) on
# GPU node pools: (pool, GKE accelerator, nodes, GPUs a node, zone, spot)
SPAWN_POOLS = (
    ("h100-a", "nvidia-h100-80gb", 16, 8, "zone-a", False),
    ("h100-b", "nvidia-h100-80gb", 16, 8, "zone-b", True),
    ("l4", "nvidia-l4", 8, 4, "zone-a", False),
)
SPAWN_CPU_NODES = 4
# requests.nvidia.com/gpu of the four profiles: 320 in all, over the
# fleet's 288 GPUs, so the pools contend
SPAWN_QUOTAS = (128, 96, 64, 32)
SPAWN_NOTEBOOKS = 500
# the seed of the POST order and of each notebook's draw, and what it
# gives: the fleet's outcome is the seed's alone (``spawn_fleet``)
SPAWN_SEED = 0
SPAWN_OUTCOME = {"admitted": 58, "pending": 224, "quota_rejected": 1, "preempted": 3,
                 "gpus_placed": 152}
# a notebook's GPU count and its weight (%); one in ten GPU notebooks on
# L4 (at most 4 GPUs), one in ten notebooks at the higher priority class
SPAWN_GPU_COUNTS = ((0, 40), (1, 25), (2, 15), (4, 10), (8, 7), (16, 3))
SPAWN_L4_SHARE = 0.1
SPAWN_HIGH_SHARE = 0.1
SPAWN_HIGH_CLASS = ("interactive", 1000)
# POSTs arrive in waves; the controllers, the scheduler and the kubelet
# simulator run one round after each wave
SPAWN_WAVE = 25
SPAWN_MAX_ROUNDS = 200
# admission cycles run at the fixed point (timed; each must write nothing)
SPAWN_IDLE_CYCLES = 5
SPAWN_USER = "owner-{}@example.com"
SPAWN_RUNTIME_ENV = ("TORCH_CPP_LOG_LEVEL", "JAX_COORDINATOR_PORT", "ODH_TORCH_KERNEL_CACHE")
# the spawned notebook's greedy request: a first token, then 16
SPAWN_PROMPT = [(i * 7919) % 128_000 + 1 for i in range(32)]
SPAWN_NEW_TOKENS = 16
# the spawned notebook's serve: Llama-3-8B int4 at full width and depth
# (``models/serve.py``'s CLI arguments)
SPAWN_SERVE_ARGS = ("--config", "llama3_8b", "--int4")


def spawn_fleet() -> dict:
    """Boot the port's platform (store, CRDs, the notebook and PodDefault
    admission webhooks, the notebook and profile controllers with
    queueing, ``SliceScheduler``, the kubelet simulator, the JWA over
    HTTP on localhost), POST ``SPAWN_NOTEBOOKS`` notebooks through the
    JWA in a seeded order, drive the cluster to its fixed point and check
    it. Needs no card. Returns the record and the live fleet (for the
    card step; ``fleet["close"]()`` stops it).

    The seed alone decides the outcome. The store stamps objects one
    second apart in the order it stamps them (the CPU tests' clock), so
    creation order, which breaks ties of the admission order, is the
    POST order and not where a wall-clock second boundary fell; the
    controllers' clock moves one second a round, so a requeue comes due
    at the same round in every run."""
    import itertools
    import random

    from odh_kubeflow_tpu_torch.machinery import objects

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.controllers.notebook import (
        NotebookController, NotebookControllerConfig)
    from odh_kubeflow_tpu_torch.controllers.profile import ProfileController
    from odh_kubeflow_tpu_torch.controllers.runtime import Manager
    from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.scheduling.scheduler import SliceScheduler
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry
    from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
    from odh_kubeflow_tpu_torch.webhooks import (
        NotebookWebhook, PodDefaultWebhook, gpu_runtime_poddefault)

    stamp = objects.now_rfc3339
    ticks = itertools.count()
    epoch = time.time() - 86_400
    objects.now_rfc3339 = lambda: time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch + next(ticks)))
    clock = {"now": 0.0}
    api = APIServer()
    apis.register_crds(api)
    register_scheduling(api)
    apis.install_default_cluster_roles(api)
    PodDefaultWebhook(api).register()
    NotebookWebhook(api).register()
    cluster = FakeCluster(api)
    for i in range(SPAWN_CPU_NODES):
        cluster.add_node(f"cpu-{i}")
    for name, accel, nodes, per_node, zone, spot in SPAWN_POOLS:
        cluster.add_gpu_node_pool(name, accel, num_nodes=nodes, gpus_per_node=per_node,
                                  zone=zone, spot=spot)
    registry = Registry()
    mgr = Manager(api, time_fn=lambda: clock["now"], registry=registry)
    NotebookController(api, NotebookControllerConfig(enable_queueing=True),
                       registry=registry).register(mgr)
    ProfileController(api, registry=registry).register(mgr)
    scheduler = SliceScheduler(api, registry=registry)
    scheduler.register(mgr)
    cycles: list[float] = []  # ms of each admission cycle
    run_cycle = scheduler.run_cycle

    def timed_cycle():
        t0 = time.perf_counter()
        result = run_cycle()
        cycles.append((time.perf_counter() - t0) * 1e3)
        return result

    scheduler.run_cycle = timed_cycle
    api.create({"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
                "metadata": {"name": SPAWN_HIGH_CLASS[0]}, "value": SPAWN_HIGH_CLASS[1],
                "globalDefault": False})
    namespaces = [f"team-{i}" for i in range(len(SPAWN_QUOTAS))]
    for i, (ns, hard) in enumerate(zip(namespaces, SPAWN_QUOTAS)):
        api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                    "metadata": {"name": ns},
                    "spec": {"owner": {"kind": "User", "name": SPAWN_USER.format(i)},
                             "resourceQuotaSpec": {
                                 "hard": {f"requests.{apis.GPU_RESOURCE}": str(hard)}}}})
    mgr.drain()
    for ns in namespaces:
        api.create(gpu_runtime_poddefault(ns))
    jwa = JupyterWebApp(api, registry=registry)
    httpd = jwa.app.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    rng = random.Random(SPAWN_SEED)
    order = [(i, ns) for i, ns in enumerate(namespaces)
             for _ in range(SPAWN_NOTEBOOKS // len(namespaces))]
    rng.shuffle(order)
    counts, weights = zip(*SPAWN_GPU_COUNTS)
    plan = []
    for n, (owner, ns) in enumerate(order):
        gpus = rng.choices(counts, weights)[0]
        accel = "nvidia-h100-80gb"
        if gpus and rng.random() < SPAWN_L4_SHARE:
            accel, gpus = "nvidia-l4", min(gpus, 4)
        high = rng.random() < SPAWN_HIGH_SHARE
        plan.append((f"nb-{n:03d}", owner, ns, accel, gpus, high))

    def post(owner: int, ns: str, body: dict) -> tuple[int, dict]:
        req = urllib.request.Request(
            f"{base}/api/namespaces/{ns}/notebooks", method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "kubeflow-userid": SPAWN_USER.format(owner),
                     "Cookie": "XSRF-TOKEN=spawn", "X-XSRF-TOKEN": "spawn"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def drive() -> None:
        clock["now"] += 1.0
        mgr.drain(max_rounds=SPAWN_MAX_ROUNDS)
        cluster.step()
        mgr.drain(max_rounds=SPAWN_MAX_ROUNDS)

    def close() -> None:
        httpd.shutdown()
        httpd.server_close()
        mgr.stop()
        objects.now_rfc3339 = stamp

    post_ms = []
    t_first = time.perf_counter()
    try:
        for n, (name, owner, ns, accel, gpus, high) in enumerate(plan):
            body = {"name": name, "cpu": "1", "memory": "4Gi"}
            if gpus:
                body["gpus"] = {"accelerator": accel, "count": str(gpus)}
            t0 = time.perf_counter()
            code, out = post(owner, ns, body)
            post_ms.append((time.perf_counter() - t0) * 1e3)
            if code != 201:
                raise AssertionError(f"POST {ns}/{name}: HTTP {code}: {out}")
            if high:  # an admin marks the interactive ones
                api.patch("Notebook", name, {"metadata": {"annotations": {
                    "notebooks.kubeflow.org/priority-class": SPAWN_HIGH_CLASS[0]}}}, ns)
            if (n + 1) % SPAWN_WAVE == 0:
                drive()
        full_queue_from = len(cycles)
        # to the fixed point: a whole round that writes nothing
        for rounds in range(1, SPAWN_MAX_ROUNDS + 1):
            rv = api._rv
            drive()
            if api._rv == rv:
                break
        else:
            raise AssertionError(f"no fixed point in {SPAWN_MAX_ROUNDS} rounds")
        fixed_s = time.perf_counter() - t_first
        # more admission cycles (and kubelet passes) write nothing
        rv = api._rv
        for _ in range(SPAWN_IDLE_CYCLES):
            scheduler.run_cycle()
            cluster.step()
        if api._rv != rv:
            raise AssertionError(f"cycles at the fixed point wrote {api._rv - rv} objects")
        record = spawn_invariants(api, plan, namespaces)
        record["preempted"] = sum(
            int(float(line.rsplit(" ", 1)[1]))
            for line in registry.exposition().splitlines()
            if line.startswith("workload_preemptions_total{")
        )
        outcome = {k: record[k] for k in SPAWN_OUTCOME}
        if outcome != SPAWN_OUTCOME:
            raise AssertionError(f"seed {SPAWN_SEED} gave {outcome}, not {SPAWN_OUTCOME}")
    except BaseException:
        close()
        raise
    full = cycles[full_queue_from:]  # every GPU notebook's Workload exists
    record.update({
        "notebooks": len(plan), "namespaces": dict(zip(namespaces, SPAWN_QUOTAS)),
        "pools": [{"pool": p[0], "accelerator": p[1], "nodes": p[2], "gpus_per_node": p[3],
                   "zone": p[4], "spot": p[5]} for p in SPAWN_POOLS],
        "post_ms": {"p50": pctl(post_ms, 0.5), "p95": pctl(post_ms, 0.95), "max": max(post_ms)},
        "cycle_ms_full_queue": {"p50": pctl(full, 0.5), "max": max(full), "cycles": len(full),
                                "workloads": record["gpu_notebooks"]},
        "cycles": len(cycles), "rounds_after_last_post": rounds,
        "seconds_to_fixed_point": fixed_s,
    })
    fleet = {"api": api, "base": base, "plan": plan, "drive": drive, "close": close}
    return {"record": record, "fleet": fleet}


def spawn_invariants(api, plan, namespaces) -> dict:
    """The fixed point's invariants; raises on any breach. Returns the
    counts."""
    from odh_kubeflow_tpu_torch.apis import GPU_RESOURCE, pod_gpus
    from odh_kubeflow_tpu_torch.machinery.objects import parse_quantity

    capacity = {n["metadata"]["name"]: int(parse_quantity(
        n["status"]["allocatable"].get(GPU_RESOURCE, 0))) for n in api.list("Node")}
    used: dict = {}
    bound: dict = {}
    for pod in api.list("Pod"):
        node = pod["spec"].get("nodeName")
        gpus = int(pod_gpus(pod))
        if gpus:
            env = {e["name"] for e in pod["spec"]["containers"][0].get("env", [])}
            if not set(SPAWN_RUNTIME_ENV) <= env:
                raise AssertionError(f"GPU pod {pod['metadata']['name']} lacks the "
                                     f"GPU-runtime env: {sorted(env)}")
        if node and pod["status"].get("phase") not in ("Succeeded", "Failed"):
            used[node] = used.get(node, 0) + gpus
            wl = pod["metadata"]["labels"].get("scheduling.kubeflow.org/workload")
            if wl:
                key = (pod["metadata"]["namespace"], wl)
                bound[key] = bound.get(key, 0) + 1
    over = {n: (u, capacity.get(n)) for n, u in used.items() if u > capacity.get(n, 0)}
    if over:
        raise AssertionError(f"nodes over their GPUs: {over}")
    quotas = {q["metadata"]["namespace"]: int(parse_quantity(
        q["spec"]["hard"][f"requests.{GPU_RESOURCE}"])) for q in api.list("ResourceQuota")}
    admitted_gpus = dict.fromkeys(namespaces, 0)
    states: dict = {}
    reasons: dict = {}
    for wl in api.list("Workload"):
        ns, name = wl["metadata"]["namespace"], wl["metadata"]["name"]
        status = wl.get("status") or {}
        state = status.get("state", "")
        states[state] = states.get(state, 0) + 1
        n = bound.get((ns, name), 0)
        if n not in (0, wl["spec"]["nodes"]):
            raise AssertionError(f"gang {ns}/{name} bound {n} of {wl['spec']['nodes']}")
        if state == "Admitted":
            if n != wl["spec"]["nodes"]:
                raise AssertionError(f"admitted gang {ns}/{name} bound {n}")
            admitted_gpus[ns] += wl["spec"]["gpus"]
        else:
            if n or not status.get("reason") or not status.get("message"):
                raise AssertionError(f"pending {ns}/{name}: bound {n}, status {status}")
            reasons[status["reason"]] = reasons.get(status["reason"], 0) + 1
    for ns, gpus in admitted_gpus.items():
        if gpus > quotas[ns]:
            raise AssertionError(f"{ns} holds {gpus} GPUs over its quota {quotas[ns]}")
    gpu_notebooks = sum(1 for p in plan if p[4])
    if sum(states.values()) != gpu_notebooks:
        raise AssertionError(f"{sum(states.values())} workloads for {gpu_notebooks} GPU "
                             "notebooks")
    cpu_running = sum(1 for p in api.list("Pod") if not pod_gpus(p)
                      and p["status"].get("phase") == "Running")
    if cpu_running != len(plan) - gpu_notebooks:
        raise AssertionError(f"{cpu_running} CPU notebooks running of "
                             f"{len(plan) - gpu_notebooks}")
    placed = sum(used.values())
    return {
        "gpu_notebooks": gpu_notebooks, "cpu_notebooks_running": cpu_running,
        "admitted": states.get("Admitted", 0), "pending": states.get("Pending", 0),
        "pending_reasons": reasons, "quota_rejected": reasons.get("QuotaExhausted", 0),
        "admitted_gpus": admitted_gpus, "gpus_placed": placed,
        "gpus_free": sum(capacity.values()) - placed,
    }


def spawn_card_step(fleet: dict) -> dict:
    """One 1-GPU H100 notebook of the fleet (an interactive one, so that
    its restart re-admits over the full queue): its Running pod's
    container env, resolved as a kubelet would and with the workspace
    volume's mount path on a fresh directory, is the env of a process on
    the card that serves Llama-3-8B int4 and answers one greedy request
    (``--notebook-serve``). It runs cold, then after a JWA stop and start
    of the notebook, warm on the same directory."""
    import os
    import shutil
    import subprocess
    import tempfile

    from odh_kubeflow_tpu_torch.machinery.kubelet import container_env

    api, plan = fleet["api"], fleet["plan"]
    pick = None
    for name, owner, ns, accel, gpus, high in plan:
        wl = next((w for w in api.list("Workload", namespace=ns)
                   if w["metadata"]["name"] == name), None)
        if (accel, gpus, high) == ("nvidia-h100-80gb", 1, True) and wl is not None and (
                wl.get("status") or {}).get("state") == "Admitted":
            pick = (name, owner, ns)
            break
    if pick is None:
        raise AssertionError("no admitted interactive 1-GPU H100 notebook in the fleet")
    name, owner, ns = pick
    workspace = tempfile.mkdtemp(prefix="spawn-workspace-")
    scratch = tempfile.mkdtemp(prefix="spawn-logs-")

    def pod_env() -> tuple[dict, str]:
        pod = api.get("Pod", f"{name}-0", ns)
        if pod["status"].get("phase") != "Running":
            raise AssertionError(f"{ns}/{name}-0 is {pod['status'].get('phase')}")
        container = pod["spec"]["containers"][0]
        claim = {v["name"]: v.get("persistentVolumeClaim", {}).get("claimName")
                 for v in pod["spec"].get("volumes", [])}
        mount = next(m["mountPath"] for m in container["volumeMounts"]
                     if claim.get(m["name"]) == f"{name}-workspace")
        env = {k: (workspace + v[len(mount):] if v.startswith(mount) else v)
               for k, v in container_env(pod).items()}
        return env, pod["spec"]["nodeName"]

    def run(label: str) -> dict:
        env, node = pod_env()
        return {"node": node, "env": env,
                **run_notebook_process(label, env, env["ODH_TORCH_KERNEL_CACHE"], scratch)}

    def jwa_patch(stopped: bool) -> None:
        req = urllib.request.Request(
            f"{fleet['base']}/api/namespaces/{ns}/notebooks/{name}", method="PATCH",
            data=json.dumps({"stopped": stopped}).encode(),
            headers={"Content-Type": "application/json",
                     "kubeflow-userid": SPAWN_USER.format(owner),
                     "Cookie": "XSRF-TOKEN=spawn", "X-XSRF-TOKEN": "spawn"})
        with urllib.request.urlopen(req, timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"PATCH stopped={stopped}: HTTP {r.status}")

    def drive_until(done, what: str) -> int:
        for rounds in range(1, SPAWN_MAX_ROUNDS + 1):
            fleet["drive"]()
            if done():
                return rounds
        raise AssertionError(f"{what}: not reached in {SPAWN_MAX_ROUNDS} rounds")

    def phase_of() -> str:
        pods = [p for p in api.list("Pod", namespace=ns)
                if p["metadata"]["name"] == f"{name}-0"]
        return pods[0]["status"].get("phase", "") if pods else "gone"

    try:
        cold = run("cold")
        jwa_patch(True)
        stop_rounds = drive_until(lambda: phase_of() == "gone", "stopped")
        jwa_patch(False)
        start_rounds = drive_until(lambda: phase_of() == "Running", "restarted")
        warm = run("warm")
    finally:
        shutil.rmtree(workspace, ignore_errors=True)
        shutil.rmtree(scratch, ignore_errors=True)
    return {"notebook": f"{ns}/{name}", "cold": cold, "warm": warm,
            "restart_rounds": {"stop": stop_rounds, "start": start_rounds}}


def check_spawn_runs(step: dict) -> dict:
    """The cold run built the dequant kernel into the PodDefault's
    directory, the warm run built nothing there, both answered the same
    tokens with the dequant launches of their forwards; returns the
    phase's card-step record."""
    cold, warm = step["cold"], step["warm"]
    lib = [f for f in cold["after"] if f.startswith("libint4_dequant-") and f.endswith(".so")]
    if cold["before"] or cold["built"] != ["int4_dequant"] or not lib:
        raise AssertionError(f"cold run: directory before {cold['before']}, built "
                             f"{cold['built']}, after {sorted(cold['after'])}")
    if warm["built"] or warm["after"] != warm["before"] or warm["before"] != cold["after"]:
        raise AssertionError(f"warm run built {warm['built']}: {warm['before']} -> "
                             f"{warm['after']}")
    if warm["tokens"] != cold["tokens"] or warm["first"] != cold["first"]:
        raise AssertionError(f"warm tokens {warm['tokens']} != cold {cold['tokens']}")
    expected = LAUNCHES_PER_FORWARD * (2 + 1 + SPAWN_NEW_TOKENS)
    for r in (cold, warm):
        if r["launches"] != expected or len(r["tokens"]) != SPAWN_NEW_TOKENS:
            raise AssertionError(f"dequant launches {r['launches']} (expected {expected}), "
                                 f"{len(r['tokens'])} tokens")

    def summary(r):
        return {k: r[k] for k in ("node", "imported_s", "service_s", "first_token_s",
                                  "process_s", "built", "launches", "build_dir", "device")}

    return {
        "notebook": step["notebook"], "env": cold["env"],
        "kernel_dir_files": sorted(cold["after"]), "cold": summary(cold),
        "warm": summary(warm), "tokens": cold["tokens"],
        "restart_rounds": step["restart_rounds"],
        "launches": cold["launches"] + warm["launches"],
    }


def dir_state(path: str) -> dict:
    """File name → (size, mtime) of a directory's files ({} when absent)."""
    import os

    if not os.path.isdir(path):
        return {}
    return {f: (os.path.getsize(os.path.join(path, f)),
                os.path.getmtime(os.path.join(path, f))) for f in sorted(os.listdir(path))}


def notebook_serve_main() -> int:
    """The spawned notebook's process (``chip_smoke.py --notebook-serve``,
    in the env its pod would give it): ``models/serve.py``'s service for
    Llama-3-8B int4 at full width and depth (``build_service``, as
    ``python -m odh_kubeflow_tpu_torch.models.serve --config llama3_8b
    --int4`` builds it) on the card, served over HTTP on localhost; one
    greedy request for a first token, then for ``SPAWN_NEW_TOKENS``.
    Prints one JSON line: when the imports were done, the service built
    (the weights on the card) and the first token came, the tokens, the
    dequant launches, the kernels this process built and where."""
    from odh_kubeflow_tpu_torch.models.serve import build_service, serve
    from odh_kubeflow_tpu_torch.ops import _build, int4

    imported_at = time.time()
    service, args = build_service([*SPAWN_SERVE_ARGS, "--host", "127.0.0.1", "--port", "0"])
    service_at = time.time()
    httpd = serve(service, host=args.host, port=args.port)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    prompt = [t % service.cfg.vocab_size for t in SPAWN_PROMPT]
    try:
        int4.launches = 0
        code, first = post(base, {"prompt": [prompt], "max_tokens": 1})
        first_token_at = time.time()
        code2, out = post(base, {"prompt": [prompt], "max_tokens": SPAWN_NEW_TOKENS})
        if (code, code2) != (200, 200):
            raise AssertionError(f"HTTP {code}, {code2}: {first} {out}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    emit({"imported_at": imported_at, "service_at": service_at,
          "first_token_at": first_token_at, "first": first["completions"][0],
          "tokens": out["completions"][0], "launches": int4.launches,
          "built": sorted(_build.build_logs), "build_dir": str(_build.BUILD_DIR),
          "device": str(service.device)})
    return 0


def platform_spawn_phase() -> tuple[dict, int]:
    """The spawn path on GPU node pools: the fleet to its fixed point
    (``spawn_fleet``), then one notebook's serve on the card, cold and
    warm (``spawn_card_step``)."""
    t0 = time.perf_counter()
    out = spawn_fleet()
    fleet = out["fleet"]
    try:
        card = check_spawn_runs(spawn_card_step(fleet))
    finally:
        fleet["close"]()
    record = {"phase": "platform_spawn", **out["record"], "card_step": card,
              "seconds": time.perf_counter() - t0}
    return record, card["launches"]


# suspend-to-checkpoint sessions and the warm-start subsystem (slice 9,
# part 3): one H100 pool of 2 nodes × 8 GPUs in one profile namespace
SESSIONS_POOL = ("h100-s", "nvidia-h100-80gb", 2, 8)
SESSIONS_NS = "team-s"
SESSIONS_USER = "owner-s@example.com"
# requests.nvidia.com/gpu of the profile and its oversubscription factor
# (the JWA's quota block shows suspended sessions only under a factor)
SESSIONS_QUOTA = (16, 2)
# the notebook controller's compile-cache mount: the kernels' build
# directory of every GPU notebook (it wins over the GPU-runtime
# PodDefault's workspace directory)
SESSIONS_MOUNT = "/mnt/compile-cache"
SESSIONS_IMAGE = "kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.7.0"
SESSIONS_MAX_ROUNDS = 60


def sessions_fleet() -> dict:
    """Boot the platform with the sessions and warm-start subsystems: the
    store, CRDs, the notebook and PodDefault webhooks (the GPU-runtime
    PodDefault in the namespace), the notebook controller (queueing,
    sessions, the compile-cache mount), the ``SessionManager`` (its
    checkpoint store in a temp dir, the port's default backend) wired as
    the ``SliceScheduler``'s suspender, a ``CompileCacheService`` rooted
    in a temp dir, the ``WarmPoolController`` over both, the kubelet
    simulator and the JWA over HTTP on localhost. Needs no card."""
    import tempfile

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.controllers.notebook import (
        NotebookController, NotebookControllerConfig)
    from odh_kubeflow_tpu_torch.controllers.profile import ProfileController
    from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request
    from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.scheduling import (
        OVERSUBSCRIPTION_FACTOR_ANNOTATION, register_scheduling)
    from odh_kubeflow_tpu_torch.scheduling.scheduler import SliceScheduler
    from odh_kubeflow_tpu_torch.sessions import register_sessions
    from odh_kubeflow_tpu_torch.sessions.checkpoint import SessionCheckpointStore
    from odh_kubeflow_tpu_torch.sessions.manager import SessionConfig, SessionManager
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry
    from odh_kubeflow_tpu_torch.warmup import register_warmup
    from odh_kubeflow_tpu_torch.warmup.compilecache import (
        CompileCacheConfig, CompileCacheService)
    from odh_kubeflow_tpu_torch.warmup.pool import WarmPoolController
    from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
    from odh_kubeflow_tpu_torch.webhooks import (
        NotebookWebhook, PodDefaultWebhook, gpu_runtime_poddefault)

    # on the wall clock (a warm pool stamps lastSyncAt on every resync,
    # so a clock a second a stamp, as ``spawn_fleet``'s, never settles);
    # the phase drives the fleet between its creations, so no order ties
    root = tempfile.mkdtemp(prefix="platform-sessions-")
    clock = {"now": 0.0}
    api = APIServer()
    apis.register_crds(api)
    register_scheduling(api)
    register_sessions(api)
    register_warmup(api)
    apis.install_default_cluster_roles(api)
    PodDefaultWebhook(api).register()
    NotebookWebhook(api).register()
    cluster = FakeCluster(api)
    name, accel, nodes, per_node = SESSIONS_POOL
    cluster.add_gpu_node_pool(name, accel, num_nodes=nodes, gpus_per_node=per_node)
    registry = Registry()
    mgr = Manager(api, time_fn=lambda: clock["now"], registry=registry)
    NotebookController(api, NotebookControllerConfig(
        enable_queueing=True, enable_sessions=True, compile_cache_mount=SESSIONS_MOUNT),
        registry=registry).register(mgr)
    ProfileController(api, registry=registry).register(mgr)
    store = SessionCheckpointStore(os.path.join(root, "checkpoints"))
    sessions = SessionManager(api, SessionConfig(checkpoint_dir=os.path.join(root,
                                                                             "checkpoints")),
                              registry=registry, runtime=cluster.session_runtime, store=store)
    sessions.register(mgr)
    scheduler = SliceScheduler(api, registry=registry, suspender=sessions)
    scheduler.register(mgr)
    cache = CompileCacheService(api, CompileCacheConfig(cache_dir=os.path.join(root, "cc")),
                                registry=registry)
    warm = WarmPoolController(api, registry=registry, session_store=store,
                              compile_cache=cache)
    warm.register(mgr)
    hard, factor = SESSIONS_QUOTA
    api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                "metadata": {"name": SESSIONS_NS},
                "spec": {"owner": {"kind": "User", "name": SESSIONS_USER}}})
    mgr.drain()
    # the profile's quota with its oversubscription factor (an admin's
    # annotation; the profile controller writes no factor)
    api.create({"apiVersion": "v1", "kind": "ResourceQuota",
                "metadata": {"name": "kf-resource-quota", "namespace": SESSIONS_NS,
                             "annotations": {OVERSUBSCRIPTION_FACTOR_ANNOTATION: str(factor)}},
                "spec": {"hard": {f"requests.{apis.GPU_RESOURCE}": str(hard)}}})
    api.create(gpu_runtime_poddefault(SESSIONS_NS))
    jwa = JupyterWebApp(api, registry=registry)
    httpd = jwa.app.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def drive() -> None:
        clock["now"] += 1.0
        mgr.drain(max_rounds=SPAWN_MAX_ROUNDS)
        cluster.step()
        mgr.drain(max_rounds=SPAWN_MAX_ROUNDS)
        for pool in api.list("WarmPool"):  # the pools' resync tick
            warm.reconcile(Request(pool["metadata"]["namespace"], pool["metadata"]["name"]))

    def drive_until(done, what: str) -> int:
        for rounds in range(1, SESSIONS_MAX_ROUNDS + 1):
            drive()
            if done():
                return rounds
        raise AssertionError(f"{what}: not reached in {SESSIONS_MAX_ROUNDS} rounds")

    def call(method: str, path: str, body=None) -> tuple[int, dict]:
        req = urllib.request.Request(
            f"{base}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json", "kubeflow-userid": SESSIONS_USER,
                     "Cookie": "XSRF-TOKEN=s", "X-XSRF-TOKEN": "s"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def close() -> None:
        httpd.shutdown()
        httpd.server_close()
        mgr.stop()
        store.close()

    return {"api": api, "cluster": cluster, "jwa": jwa, "call": call, "drive": drive,
            "drive_until": drive_until, "close": close, "sessions": sessions,
            "scheduler": scheduler, "cache": cache, "store": store, "registry": registry,
            "root": root}


def run_notebook_process(label: str, env: dict, kernel_dir: str, scratch: str) -> dict:
    """``chip_smoke.py --notebook-serve`` in ``env`` (a pod's resolved
    env); the kernel directory's files before and after, and the
    seconds from process start to each milestone."""
    import subprocess

    before = dir_state(kernel_dir)
    out_path = os.path.join(scratch, f"{label}.out")
    err_path = os.path.join(scratch, f"{label}.err")
    t0 = time.time()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--notebook-serve"],
            env={**os.environ, **env, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))},
            stdout=out, stderr=err, timeout=600)
    lines = [x for x in open(out_path).read().splitlines() if x.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"{label} notebook process exit {proc.returncode}: "
                             f"{open(err_path).read()[-3000:]}")
    got = json.loads(lines[-1])
    return {"kernel_dir": kernel_dir, "before": before, "after": dir_state(kernel_dir),
            "imported_s": got["imported_at"] - t0, "service_s": got["service_at"] - t0,
            "first_token_s": got["first_token_at"] - t0, "process_s": time.time() - t0, **got}


def platform_sessions_phase(run_notebook=run_notebook_process) -> tuple[dict, int]:
    """The sessions and warm-start subsystems with Llama-3-8B int4 notebooks
    on the card (``sessions_fleet``; each notebook process is
    ``--notebook-serve`` in its pod's resolved env, the compile-cache
    mount on a directory of this host):

    1. cold standby: the WarmPool's Ready standby runs with its kernel
       directory at ``staging_dir("cold")``; ``nvcc`` builds
       ``int4_dequant`` there and ``ingest_dir`` registers it (one entry,
       topology ``sm_90a``, this host's ``nvcc`` and torch);
    2. warm handout: a JWA POST claims the standby, the template state is
       restored into the user's pod, ``materialize_dir`` fills its mount
       and its process builds nothing and serves the same tokens;
    3. suspend: a state tree (the process's tokens and launches) in the
       pod's container memory; a JWA stop with suspend snapshots it, the
       receipt is durable, the StatefulSet scales to zero and the GPU goes
       to a waiting 8-GPU gang; the quota block shows it suspended;
    4. resume: the JWA's resume route re-admits the notebook, the state
       is restored with an equal digest before it reads ready, and the
       resumed process serves warm with the same tokens;
    5. a corrupted artifact: ``materialize_dir`` stages nothing.

    ``run_notebook(label, env, kernel_dir, scratch)`` runs one notebook
    process (``run_notebook_process``)."""
    import hashlib
    import shutil
    import tempfile

    from odh_kubeflow_tpu_torch.machinery.kubelet import container_env
    from odh_kubeflow_tpu_torch.warmup import WARM_FROM_ANNOTATION
    from odh_kubeflow_tpu_torch.warmup.compilecache import (
        CompileKey, build_target, compiler_version)
    from odh_kubeflow_tpu_torch.warmup.pool import new_warm_pool

    t_phase = time.perf_counter()
    fleet = sessions_fleet()
    api, cluster, jwa, cache = fleet["api"], fleet["cluster"], fleet["jwa"], fleet["cache"]
    call, drive, drive_until = fleet["call"], fleet["drive"], fleet["drive_until"]
    ns, (pool_name, accel, _, per_node) = SESSIONS_NS, SESSIONS_POOL
    scratch = tempfile.mkdtemp(prefix="platform-sessions-logs-")
    topology, compiler = build_target(), compiler_version()

    def pod(name):
        pods = [p for p in api.list("Pod", namespace=ns)
                if p["metadata"]["name"] == f"{name}-0"]
        return pods[0] if pods else None

    def running(name):
        p = pod(name)
        return p is not None and p["status"].get("phase") == "Running"

    def workload(name):
        return next((w for w in api.list("Workload", namespace=ns)
                     if w["metadata"]["name"] == name), None)

    def admitted(name):
        wl = workload(name)
        return wl is not None and (wl.get("status") or {}).get("state") == "Admitted"

    def ckpt(name):
        rows = [c for c in api.list("SessionCheckpoint", namespace=ns)
                if c["metadata"]["name"] == name]
        return rows[0] if rows else None

    def pod_env(name, kernel_dir):
        p = pod(name)
        env = container_env(p)
        if env.get("ODH_TORCH_KERNEL_CACHE") != SESSIONS_MOUNT:
            raise AssertionError(f"{name}'s kernel directory {env.get('ODH_TORCH_KERNEL_CACHE')}"
                                 f" is not the compile-cache mount {SESSIONS_MOUNT}")
        env["ODH_TORCH_KERNEL_CACHE"] = kernel_dir
        return env, p["spec"]["nodeName"]

    def gpu_notebook(name, gpus):
        return {"name": name, "image": SESSIONS_IMAGE, "cpu": "1", "memory": "4Gi",
                "gpus": {"accelerator": accel, "count": str(gpus)}}

    record: dict = {"pool": {"name": pool_name, "accelerator": accel,
                             "nodes": SESSIONS_POOL[2], "gpus_per_node": per_node},
                    "mount": SESSIONS_MOUNT, "topology": topology, "compiler": compiler}
    try:
        # node 0 full (two 4-GPU notebooks), so the standby lands on node 1
        for fill in ("fill-a", "fill-b"):
            code, out = call("POST", f"/api/namespaces/{ns}/notebooks", gpu_notebook(fill, 4))
            if code != 201:
                raise AssertionError(f"POST {fill}: HTTP {code}: {out}")
        drive_until(lambda: running("fill-a") and running("fill-b"), "fillers running")
        api.create(new_warm_pool("wp", ns, size=1, accelerator=accel, count="1",
                                 image=SESSIONS_IMAGE))
        standby = "wp-standby-0"
        record["standby_rounds"] = drive_until(
            lambda: (api.get("WarmPool", "wp", ns).get("status") or {}).get(
                "readyStandbys") == 1, "standby ready")

        # 1. the cold standby
        staging = cache.staging_dir("cold")
        env, node = pod_env(standby, staging)
        cold = run_notebook(label="cold", env=env, kernel_dir=staging, scratch=scratch)
        cold["node"] = node
        ingested = cache.ingest_dir(staging, topology=topology, compiler_ver=compiler)
        entries = [e["spec"] for e in cache.entries()]
        libs = [f for f in cold["after"] if f.startswith("libint4_dequant-")
                and f.endswith(".so")]
        if cold["before"] or cold["built"] != ["int4_dequant"] or len(libs) != 1:
            raise AssertionError(f"cold standby: directory before {cold['before']}, built "
                                 f"{cold['built']}, after {sorted(cold['after'])}")
        if ingested != 1 or entries != [{"fingerprint": libs[0], "topology": topology,
                                         "compilerVersion": compiler}]:
            raise AssertionError(f"ingest_dir registered {ingested}: {entries}")

        # 2. the warm handout
        code, out = call("POST", f"/api/namespaces/{ns}/notebooks", gpu_notebook("nb-user", 1))
        if code != 201:
            raise AssertionError(f"POST nb-user: HTTP {code}: {out}")
        user = api.get("Notebook", "nb-user", ns)
        if user["metadata"]["annotations"].get(WARM_FROM_ANNOTATION) != "wp":
            raise AssertionError(f"nb-user was not handed the standby: "
                                 f"{user['metadata']['annotations']}")
        template = fleet["store"].load(f"warmpool-{ns}-wp-template")[0]
        record["handout_rounds"] = drive_until(
            lambda: running("nb-user") and (ckpt("nb-user") or {}).get("status", {}).get(
                "phase") == "Restored", "warm handout restored")
        restored = cluster.get_session_state(ns, "nb-user")
        if restored != template:
            raise AssertionError(f"template state {template} not restored: {restored}")
        # the pool has served its standby: it keeps none while the rest runs
        api.patch("WarmPool", "wp", {"spec": {"size": 0}}, ns)
        drive_until(lambda: not any(n["metadata"]["name"].startswith("wp-standby")
                                    for n in api.list("Notebook", namespace=ns)), "pool empty")
        mount_warm = tempfile.mkdtemp(prefix="mount-warm-")
        staged = cache.materialize_dir(mount_warm, topology=topology, compiler_ver=compiler)
        env, node = pod_env("nb-user", mount_warm)
        warm = run_notebook(label="warm", env=env, kernel_dir=mount_warm, scratch=scratch)
        warm["node"] = node
        if staged != 1 or warm["built"] or warm["after"] != warm["before"] or \
                sorted(warm["before"]) != libs:
            raise AssertionError(f"warm handout: staged {staged}, built {warm['built']}, "
                                 f"{warm['before']} -> {warm['after']}")
        if warm["tokens"] != cold["tokens"] or warm["first"] != cold["first"]:
            raise AssertionError(f"warm tokens {warm['tokens']} != cold {cold['tokens']}")

        # 3. suspend: the GPU goes to a waiting 8-GPU gang
        user_node = pod("nb-user")["spec"]["nodeName"]
        api.delete("Notebook", "fill-b", ns)
        drive_until(lambda: pod("fill-b") is None, "fill-b gone")
        code, out = call("POST", f"/api/namespaces/{ns}/notebooks", gpu_notebook("nb-gang", 8))
        if code != 201:
            raise AssertionError(f"POST nb-gang: HTTP {code}: {out}")
        drive_until(lambda: (workload("nb-gang") or {}).get("status", {}).get("state")
                    == "Pending", "gang queued")
        drive()
        waiting = workload("nb-gang")["status"]
        if waiting.get("state") != "Pending":
            raise AssertionError(f"the 8-GPU gang did not wait: {waiting}")
        state = {"tokens": warm["tokens"], "launches": warm["launches"]}
        cluster.set_session_state(ns, "nb-user", state)
        t0 = time.perf_counter()
        code, _ = call("PATCH", f"/api/namespaces/{ns}/notebooks/nb-user",
                       {"stopped": True, "suspend": True})
        if code != 200:
            raise AssertionError(f"suspend PATCH: HTTP {code}")
        suspend_rounds = drive_until(
            lambda: pod("nb-user") is None and workload("nb-user") is None
            and api.get("StatefulSet", "nb-user", ns)["spec"]["replicas"] == 0,
            "suspended and scaled down")
        suspend_s = time.perf_counter() - t0
        receipt = ckpt("nb-user")["status"]
        digest = hashlib.sha256(json.dumps(state, sort_keys=True, separators=(",", ":"))
                                .encode()).hexdigest()
        if (receipt.get("phase"), receipt.get("stateCaptured"), receipt.get("digest")) != (
                "Suspended", True, digest):
            raise AssertionError(f"suspend receipt {receipt} (state digest {digest})")
        gang_rounds = drive_until(lambda: admitted("nb-gang"), "gang admitted")
        gang_nodes = workload("nb-gang")["status"]["assignment"]["nodes"]
        if gang_nodes != [user_node]:
            raise AssertionError(f"the gang took {gang_nodes}, not the freed {user_node}")
        quota = jwa.gpu_quota(ns)
        if quota.get("suspended") != "1":
            raise AssertionError(f"the quota block does not show the suspended GPU: {quota}")
        suspend_row = jwa.notebook_row(api.get("Notebook", "nb-user", ns))["status"]

        # 4. resume: restored with an equal digest before it reads ready
        t0 = time.perf_counter()
        code, out = call("POST", f"/api/namespaces/{ns}/notebooks/nb-user/resume")
        if code != 200 or out.get("resume") != "warm":
            raise AssertionError(f"resume POST: HTTP {code}: {out}")
        early_ready = []

        def resumed():
            row = jwa.notebook_row(api.get("Notebook", "nb-user", ns))["status"]
            phase = (ckpt("nb-user") or {}).get("status", {}).get("phase")
            if row["phase"] == "ready" and phase != "Restored":
                early_ready.append(phase)
            return row["phase"] == "ready" and phase == "Restored"

        resume_rounds = drive_until(resumed, "resumed and ready")
        resume_s = time.perf_counter() - t0
        if early_ready:
            raise AssertionError(f"ready before the restore (checkpoint {early_ready})")
        back = cluster.get_session_state(ns, "nb-user")
        back_digest = hashlib.sha256(json.dumps(back, sort_keys=True, separators=(",", ":"))
                                     .encode()).hexdigest()
        if back != state or back_digest != receipt["digest"]:
            raise AssertionError(f"restored {back} ({back_digest}) != {receipt['digest']}")
        mount_resumed = tempfile.mkdtemp(prefix="mount-resumed-")
        cache.materialize_dir(mount_resumed, topology=topology, compiler_ver=compiler)
        env, node = pod_env("nb-user", mount_resumed)
        again = run_notebook(label="resumed", env=env, kernel_dir=mount_resumed,
                             scratch=scratch)
        again["node"] = node
        if again["built"] or again["after"] != again["before"] or again["tokens"] != \
                cold["tokens"]:
            raise AssertionError(f"resumed process: built {again['built']}, tokens "
                                 f"{again['tokens']}")

        # 5. a corrupted artifact is never staged
        key = CompileKey(libs[0], topology, compiler)
        path = os.path.join(cache.root, f"{key.key_id}.bin")
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0x01
        open(path, "wb").write(bytes(data))
        mount_bad = tempfile.mkdtemp(prefix="mount-corrupt-")
        corrupt = {"staged": cache.materialize_dir(mount_bad, topology=topology,
                                                   compiler_ver=compiler),
                   "files": sorted(os.listdir(mount_bad)), "entries": cache.stats()["entries"],
                   "artifact_kept": os.path.exists(path)}
        if corrupt != {"staged": 0, "files": [], "entries": 0, "artifact_kept": False}:
            raise AssertionError(f"the corrupted artifact: {corrupt}")
    finally:
        fleet["close"]()
        shutil.rmtree(scratch, ignore_errors=True)
        shutil.rmtree(fleet["root"], ignore_errors=True)

    metrics = {}
    for line in fleet["registry"].exposition().splitlines():
        if line.startswith(("session_", "compile_cache_", "warm_pool_",
                            "workload_preemptions_total")) and "_bucket" not in line:
            k, v = line.rsplit(" ", 1)
            metrics[k] = float(v)

    def summary(r):
        return {k: r[k] for k in ("node", "imported_s", "service_s", "first_token_s",
                                  "process_s", "built", "launches", "build_dir", "device")}

    runs = {"cold": cold, "warm": warm, "resumed": again}
    record.update({
        "phase": "platform_sessions",
        "runs": {k: summary(r) for k, r in runs.items()},
        "nvcc_runs": {k: len(r["built"]) for k, r in runs.items()},
        "tokens": cold["tokens"],
        # hits: the cache's digest-verified loads (the two warm mounts);
        # misses: the processes that ran nvcc; the corrupted artifact's
        # failed load purged its entry
        "cache": {"ingested": ingested, "materialized": staged, "entries": entries,
                  "hits": metrics.get("compile_cache_load_seconds_count", 0.0),
                  "misses": sum(1 for r in runs.values() if r["built"]),
                  "corrupt": corrupt},
        "handout": {"rounds": record.pop("handout_rounds"), "template": template},
        "suspend": {"request_to_scale_down_s": suspend_s, "rounds": suspend_rounds,
                    "receipt": {k: receipt[k] for k in ("checkpointStep", "digest",
                                                        "sizeBytes", "stateCaptured")},
                    "gang_admitted_rounds": gang_rounds, "gang_nodes": gang_nodes,
                    "gang_waited": {k: waiting.get(k) for k in ("reason", "message")},
                    "quota": quota, "row": suspend_row},
        "resume": {"request_to_ready_s": resume_s, "rounds": resume_rounds,
                   "warm_resume_histogram_s": {
                       "count": metrics.get("session_resume_seconds_count"),
                       "sum": metrics.get("session_resume_seconds_sum")},
                   "digest_equal": True},
        "metrics": metrics,
        "launches": sum(r["launches"] for r in runs.values()),
        "seconds": time.perf_counter() - t_phase,
    })
    for r in runs.values():
        if r["launches"] != LAUNCHES_PER_FORWARD * (2 + 1 + SPAWN_NEW_TOKENS):
            raise AssertionError(f"dequant launches {r['launches']}")
    return record, record["launches"]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_train_phase(torch, fa, int4, train_record: dict) -> tuple[dict, dict]:
    """The ``train`` phase's 8B QLoRA step through ``Trainer(mesh=)`` on an
    NCCL process group of one rank, ``MeshConfig()`` all ones (one card: a
    size-1 axis issues no collective), and one ``run_elastic`` step whose
    gang all-gather runs over NCCL."""
    import os
    import shutil

    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from odh_kubeflow_tpu_torch.train import CheckpointManager, TrainConfig, Trainer
    from odh_kubeflow_tpu_torch.train import elastic

    B, S = TRAIN_SHAPE
    steps, warmup = 3, 1
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshConfig(), device="cuda")
        cfg = LlamaConfig.llama3_8b(remat=True, remat_policy="attn")
        t0 = time.perf_counter()
        trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4",
                          mesh=mesh, precompile_batch=(B, S))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa, int4)  # the mesh path's count starts here
        bench, step_losses = benchmark_with_losses(trainer, B, S, steps, warmup)
        launched = counts(fa, int4)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        expected = {k: n * (steps + warmup) for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
        if launched != expected:
            raise AssertionError(f"mesh training launches {launched}, expected {expected}")
        want = train_record["step_losses"]
        if step_losses != want:
            raise AssertionError(f"mesh step losses {step_losses} != one-device {want}")
        gathers = []
        all_gather = dist.all_gather
        dist.all_gather = lambda *a, **k: gathers.append(1) or all_gather(*a, **k)
        ckpt = os.path.join("build", "chip_smoke_ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)  # the step must not resume from a stale one
        try:
            with CheckpointManager(ckpt, save_interval_steps=10**6) as mgr:
                t0 = time.perf_counter()
                result = elastic.run_elastic(
                    trainer, mgr, [trainer.make_fake_batch(B, S)], total_steps=trainer.step + 1)
                elastic_s = time.perf_counter() - t0
        finally:
            dist.all_gather = all_gather
        if result["preempted"] or result["step"] != steps + warmup + 1 or not gathers:
            raise AssertionError(f"run_elastic {result}, {len(gathers)} gang all-gathers")
    finally:
        dist.destroy_process_group()
    record = {
        "phase": "mesh_train",
        "config": "the train phase's: llama3_8b QLoRA int4, LoRA r16, remat attn, 32 "
                  "layers; Trainer(mesh=build_mesh(MeshConfig())) on an NCCL group of 1",
        "batch": B, "seq": S, "steps": steps, "warmup": warmup, "init_s": init_s,
        "step_time_s": bench["step_time_s"],
        "train_step_time_s": train_record["step_time_s"],
        "step_time_ratio": bench["step_time_s"] / train_record["step_time_s"],
        "peak_memory_gb": peak_gb, "train_peak_memory_gb": train_record["peak_memory_gb"],
        "step_losses": step_losses, "losses_equal_train_bitwise": True,
        "launches": launched, "launches_per_step": TRAIN_LAUNCHES_PER_STEP,
        "elastic": dict(result, seconds=elastic_s, gang_all_gathers=len(gathers)),
    }
    return record, launched


# ring attention on the card: Llama-3-8B attention width, one sequence of
# 16,384 tokens over 4 loopback ranks (blocks of 4,096)
RING_SHAPE = (1, 16_384, 32, 8, 128)
RING_RANKS = 4


def ring_on_card_phase(torch, fa) -> tuple[dict, dict]:
    """The ring's block schedule with its kernels (``flash_fwd``,
    ``flash_dq``, ``flash_dkv`` per live block pair) through the loopback
    driver, plain and zigzag layouts, causal, forward and backward: per
    64-position tile against the plain ring (the same schedule on the
    plain versions) and against one whole-sequence call of each kernel;
    launches against the live block pairs; ms against the whole call."""
    from odh_kubeflow_tpu_torch.parallel import ring_attention as ra

    B, S, Hq, Hkv, hd = RING_SHAPE
    C = RING_RANKS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = bf16(B, S, Hq, hd), bf16(B, S, Hkv, hd), bf16(B, S, Hkv, hd), bf16(B, S, Hq, hd)

    def whole_call(_=None):
        o, lse = fa.flash_fwd(q, k, v, causal=True)
        d = fa.flash_delta(o, do)
        return (o, fa.flash_dq(q, k, v, lse, d, do, causal=True),
                *fa.flash_dkv(q, k, v, lse, d, do, causal=True))

    whole = whole_call()  # the whole sequence in one call of each kernel
    whole_ms = time_ms(torch, whole_call, 2)
    names = ("out", "dq", "dk", "dv")
    kernel_of = {"out": "flash_fwd", "dq": "flash_dq", "dk": "flash_dkv", "dv": "flash_dkv"}
    layouts, launched = {}, {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for layout in ("plain", "zigzag"):
        zig = layout == "zigzag"
        perm = (lambda x: ra.zigzag_permute(x, C)) if zig else (lambda x: x)
        unperm = (lambda x: ra.zigzag_unpermute(x, C)) if zig else (lambda x: x)
        ins = [perm(x).contiguous() for x in (q, k, v, do)]

        def ring(plain=False):
            qq, kk, vv = (x.detach().requires_grad_() for x in ins[:3])
            out = ra.loopback_ring_attention(qq, kk, vv, num_ranks=C, layout=layout,
                                             plain=plain)
            return (out, *torch.autograd.grad(out, (qq, kk, vv), ins[3]))

        fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 2**30
        got = ring()
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30 - base_gb
        n = {"flash_fwd": fa.fwd_launches, "flash_dq": fa.dq_launches,
             "flash_dkv": fa.dkv_launches}
        live = ra.live_pairs(C, layout, causal=True)
        if n != dict.fromkeys(n, live):
            raise AssertionError(f"ring {layout}: launches {n}, live block pairs {live}")
        for key in launched:
            launched[key] += n[key]
        plain = ring(plain=True)
        errs = {}
        for name, g, p, w in zip(names, got, plain, whole):
            if not torch.isfinite(g).all():
                raise AssertionError(f"ring {layout} {name}: non-finite values")
            errs[name] = {"vs_plain": fa.tile_rel_err(g, p),
                          "vs_whole_flash": fa.tile_rel_err(unperm(g), w),
                          "max_abs_err_vs_plain": (g.float() - p.float()).abs().max().item()}
        del plain
        torch.cuda.empty_cache()
        ring_ms = time_ms(torch, lambda _: ring(), 2)
        layouts[layout] = {"launches": n, "live_block_pairs": live, "tile_rel_err": errs,
                           "ring_fwd_bwd_ms": ring_ms, "ring_over_whole": ring_ms / whole_ms,
                           "peak_memory_gb_above_inputs": peak_gb}
        for name, e in errs.items():
            tol = fa.TILE_RTOL[kernel_of[name]]
            if e["vs_plain"] > tol or e["vs_whole_flash"] > tol:
                raise AssertionError(f"ring {layout} {name}: {e} over {tol}; {layouts}")
    record = {
        "phase": "ring_on_card",
        "shape": {"batch": B, "seq": S, "q_heads": Hq, "kv_heads": Hkv, "head_dim": hd,
                  "ranks": C, "causal": True, "dtype": "bfloat16"},
        "input_mib": {"q": q.numel() * 2 / 2**20, "k": k.numel() * 2 / 2**20,
                      "v": v.numel() * 2 / 2**20},
        "whole_flash_fwd_bwd_ms": whole_ms, "tile_rtol": fa.TILE_RTOL, "layouts": layouts,
    }
    return record, launched


# ---------------------------------------------------------------------------
# the fine-tune path end to end at long context (slice 8): text ->
# the port's tokenizer -> the native packer -> the 8B QLoRA step at 16k, and
# remat "attn_offload" for Llama and the MoE

# the reference's hard regime (``bench.py``'s long-context row,
# ``loadtest/profile_step.py``'s 8b16k): Llama-3-8B, int8 base, one row of
# 16,384 tokens; here the row is the pinned docs (``tests/data/
# tokenizer_corpus``) tokenized at vocab 512, a document a section, packed
LONG_SEQ = 16_384
LONG_VOCAB = 512
LONG_CORPUS = ("GUIDE.md", "PARITY.md", "README.md")
LONG_POLICIES = ("none", "attn", "attn_offload")
# flash launches per fwd + bwd: each layer's forward once, its backward once;
# "none" recomputes the layer, the forward kernel with it
LONG_LAUNCHES = {"none": {"flash_fwd": 64, "flash_dq": 32, "flash_dkv": 32},
                 "attn": {"flash_fwd": 32, "flash_dq": 32, "flash_dkv": 32},
                 "attn_offload": {"flash_fwd": 32, "flash_dq": 32, "flash_dkv": 32}}
LONG_STEPS, LONG_WARMUP = 2, 1


def flash_residual_bytes(cfg, B: int, S: int) -> int:
    """What remat "attn" keeps of a Llama stack on the flash path: each
    layer's ``(out, lse2)``, bf16 ``[B, S, Hq, hd]`` and f32 ``[B, Hq, S]``."""
    return cfg.num_layers * (B * S * cfg.num_heads * cfg.head_dim * 2 + B * cfg.num_heads * S * 4)


def long_context_batch(torch) -> tuple[dict, dict]:
    """The pinned docs through the port's tokenizer (trained on them at
    vocab 512) and the native packer: the first ``1 x LONG_SEQ`` batch,
    with segment ids, on the card."""
    import os

    from odh_kubeflow_tpu_torch import native
    from odh_kubeflow_tpu_torch.train.data import pack_documents, prefetch_to_device
    from odh_kubeflow_tpu_torch.train.tokenizer import corpus_from_files, sections, train_bpe

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                        "tokenizer_corpus")
    texts = corpus_from_files([os.path.join(root, n) for n in LONG_CORPUS])
    t0 = time.perf_counter()
    tok = train_bpe(texts, vocab_size=LONG_VOCAB)
    train_s = time.perf_counter() - t0
    docs = [tok.encode(s, bos=True, eos=True) for t in texts for s in sections(t)]
    if not native.available():
        raise AssertionError("the native packer did not build (no C++ compiler)")
    t0 = time.perf_counter()
    packed = next(pack_documents(docs, 1, LONG_SEQ, engine="native"))
    pack_s = time.perf_counter() - t0
    python = next(pack_documents(docs, 1, LONG_SEQ, engine="python"))
    if any((packed[k] != python[k]).any() for k in python):
        raise AssertionError("the native packer's batch differs from the Python path's")
    seg = packed["segment_ids"][0]
    info = {"corpus_bytes": sum(len(t.encode()) for t in texts), "vocab": tok.vocab_size,
            "tokenizer_train_s": train_s, "documents": len(docs),
            "corpus_ids": sum(len(d) for d in docs), "pack_s": pack_s,
            "segments_in_row": int(seg.max()), "padding": int((seg == 0).sum()),
            "loss_tokens": int(packed["loss_mask"].sum())}
    return next(prefetch_to_device([packed])), info


def long_flash_check(torch, fa, cfg, seg) -> dict:
    """The three flash kernels at the 16k text row's shape (1 x LONG_SEQ,
    the model's heads, the row's own segment ids) on random bf16 inputs,
    each held to its plain version as ``flash_kernels_phase`` holds them
    (``TILE_RTOL`` per tile, lse2 to 1e-3). The plain version runs one KV
    head and its query group at a time: the whole row's f32 scores would
    take 32 GiB."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1617)
    seg = seg.to(torch.int32).contiguous()  # as ``flash_attention`` passes them on
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def rnd(h):
        return torch.randn((1, LONG_SEQ, h, hd), generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(Hq), rnd(Hkv), rnd(Hkv), rnd(Hq)
    out, lse = fa.flash_fwd(q, k, v, seg, seg)
    delta = fa.flash_delta(out, do)
    dq = fa.flash_dq(q, k, v, lse, delta, do, seg, seg)
    dk, dv = fa.flash_dkv(q, k, v, lse, delta, do, seg, seg)
    worst = {n: {"max_abs_err": 0.0, "tile_rel_err": 0.0}
             for n in ("flash_fwd", "flash_dq", "flash_dkv")}

    def close(name, got, want):
        st = worst[name]
        st["max_abs_err"] = max(st["max_abs_err"], (got.float() - want.float()).abs().max().item())
        st["tile_rel_err"] = max(st["tile_rel_err"], fa.tile_rel_err(got, want))

    lse_err, g = 0.0, Hq // Hkv
    for h in range(Hkv):  # KV head h and its query heads
        qs, ks = slice(h * g, (h + 1) * g), slice(h, h + 1)
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks], lse[:, qs], delta[:, qs], do[:, :, qs],
                seg, seg)
        ref_out, ref_lse = fa.flash_fwd_reference(*args[:3], seg, seg)
        close("flash_fwd", out[:, :, qs], ref_out)
        lse_err = max(lse_err, (lse[:, qs] - ref_lse).abs().max().item())
        del ref_out, ref_lse
        close("flash_dq", dq[:, :, qs], fa.flash_dq_reference(*args))
        rk, rv = fa.flash_dkv_reference(*args)
        close("flash_dkv", dk[:, :, ks], rk)
        close("flash_dkv", dv[:, :, ks], rv)
        del rk, rv
        torch.cuda.empty_cache()
    del q, k, v, do, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    for name, st in worst.items():
        if not st["tile_rel_err"] <= fa.TILE_RTOL[name]:
            raise AssertionError(f"{name} at the 16k text row: tile relative err "
                                 f"{st['tile_rel_err']} > {fa.TILE_RTOL[name]}")
    if not lse_err <= 1e-3:
        raise AssertionError(f"flash_fwd at the 16k text row: lse2 max abs err {lse_err}")
    return {"shape": f"1 x {LONG_SEQ}, {Hq}/{Hkv} heads, hd {hd}, the row's "
                     f"{int(seg.max())} segments, random bf16 inputs",
            "lse2_max_abs_err": lse_err, **worst,
            "tolerance": {n: f"||kernel - plain|| / ||plain|| <= {fa.TILE_RTOL[n]} in every "
                             "tile of 64 positions of one row and head" for n in worst}
                         | {"lse2": "max abs err <= 1e-3"}}


def long_context_text_phase(torch, fa, int4, bw: float, peak: float) -> tuple[dict, dict]:
    """The flash kernels against their plain versions at the packed 16k
    text row's shape and segments (``long_flash_check``), then the 8B
    QLoRA step (int8 base, LoRA r16, flash) on the row under remat "none",
    "attn" and "attn_offload", one init: per
    policy the loss and adapter gradients at the init (attn_offload's
    bit-equal to attn's, none's within the train phase's tolerance), exact
    flash launches, then 1 warm-up and 2 timed steps (host clock, read the
    loss), peak memory, and a profiled step's device busy share; for
    attn_offload the bytes parked on the host; each flash kernel's ms a
    launch in the profiled "attn" step beside its bound over the row's live
    pairs."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import offload
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig

    t_phase = time.perf_counter()
    batch, text = long_context_batch(torch)
    cfg = LlamaConfig.llama3_8b(remat=True, remat_policy="none")
    t0 = time.perf_counter()
    kernel_check = long_flash_check(torch, fa, cfg, batch["segment_ids"])
    kernel_check["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = live_lora_trainer(torch, cfg, "int8", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    want_parked = flash_residual_bytes(cfg, 1, LONG_SEQ)
    runs, grads = {}, {}
    zero_counts(fa, int4)  # the long-context path's count starts here
    expected = {k: 0 for k in ("flash_fwd", "flash_dq", "flash_dkv", "int4_dequant")}
    for policy in LONG_POLICIES:  # the loss and gradients at the shared init
        trainer.model_cfg = dataclasses.replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, offload.parked_bytes = counts(fa, int4), 0
        loss, grads[policy] = trainer.gradients(batch)
        n = {k: counts(fa, int4)[k] - before[k] for k in LONG_LAUNCHES[policy]}
        if n != LONG_LAUNCHES[policy]:
            raise AssertionError(f"{policy}: flash launches {n}, expected {LONG_LAUNCHES[policy]}")
        parked = offload.parked_bytes
        if parked != (want_parked if policy == "attn_offload" else 0):
            raise AssertionError(f"{policy}: {parked} bytes parked, expected {want_parked}")
        runs[policy] = {"loss": float(loss), "launches_fwd_bwd": n, "parked_bytes": parked,
                        "grad_peak_memory_gb_above_weights":
                            (torch.cuda.max_memory_allocated() - resident) / 2**30}
        for k, v in n.items():
            expected[k] += v
    for policy in LONG_POLICIES:  # the steps, timed
        trainer.model_cfg = dataclasses.replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(LONG_WARMUP + LONG_STEPS):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(batch)["loss"]))
            times.append(time.perf_counter() - t0)
        peak_mem = torch.cuda.max_memory_allocated()
        busy = busy_share(torch, lambda: (trainer.train_step(batch)["loss"], None),
                          names=("flash_fwd", "flash_dq", "flash_dkv"))
        for k, v in LONG_LAUNCHES[policy].items():
            expected[k] += v * (LONG_WARMUP + LONG_STEPS + 1)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{policy}: step losses {losses}")
        runs[policy].update(step_s=statistics.mean(times[LONG_WARMUP:]), step_times_s=times,
                            step_losses=losses, peak_memory_gb=peak_mem / 2**30,
                            peak_memory_gb_above_weights=(peak_mem - resident) / 2**30,
                            peak_memory_gb_above_step_start=(peak_mem - base) / 2**30,
                            tokens_per_s=LONG_SEQ / statistics.mean(times[LONG_WARMUP:]),
                            profiled_step=busy)
    launched = counts(fa, int4)
    if launched != expected:
        raise AssertionError(f"long-context launches {launched}, expected {expected}")
    a, o, n = grads["attn"], grads["attn_offload"], grads["none"]
    bad = [p for p in a if not torch.equal(a[p], o[p])]
    none_worst = max((n[p] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                     for p, g in a.items())
    gates = {
        "attn_offload_loss_equals_attn": runs["attn_offload"]["loss"] == runs["attn"]["loss"],
        "attn_offload_leaves_bit_equal": len(a) - len(bad), "leaves": len(a),
        "none_loss_rel_diff": abs(runs["none"]["loss"] - runs["attn"]["loss"])
                              / abs(runs["attn"]["loss"]),
        "none_worst_leaf_grad_rel_diff": none_worst,
        "none_leaves_bit_equal": sum(torch.equal(n[p], g) for p, g in a.items()),
    }
    pairs = _live_pairs(1, LONG_SEQ, True, batch["segment_ids"].cpu())
    prof = runs["attn"]["profiled_step"]
    flash = {}
    for name, (flops, nbytes) in flash_work(1, LONG_SEQ, cfg.num_heads, cfg.num_kv_heads,
                                            cfg.head_dim, pairs).items():
        ms = prof.get(f"{name}_ms")
        n = prof.get(f"{name}_launches")
        flash[name] = {"flops": flops, "bytes": nbytes,
                       "bound_ms": max(flops / peak, nbytes / bw) * 1e3,
                       "bound_by": "operations" if flops / peak > nbytes / bw else "bytes",
                       "ms_per_launch": ms / n if n else "not measured"}
    record = {
        "phase": "long_context_text",
        "config": "llama3_8b QLoRA: int8 base (random weights, seed 0), LoRA r16 on "
                  "wq/wk/wv/wo (b live), flash, 32 layers; batch 1 x 16,384 packed text",
        "text": text, "kernels_vs_plain_at_the_row": kernel_check,
        "init_s": init_s, "resident_params_gb": resident / 2**30,
        "live_pairs_per_head": pairs, "flash_in_attn_step": flash,
        "steps": LONG_STEPS, "warmup": LONG_WARMUP, "runs": runs, "gates": gates,
        "parked_bytes_expected": want_parked,
        "attn_minus_offload_peak_gb": runs["attn"]["peak_memory_gb"]
                                       - runs["attn_offload"]["peak_memory_gb"],
        "tolerances": {"none_loss_rtol": TRAIN_LOSS_RTOL,
                       "none_grad_tol": f"max |none - attn| / max |attn| per leaf <= "
                                        f"{REMAT_NONE_GRAD_TOL}",
                       "attn_offload": "bit-equal to attn"},
        "launches": launched,
    }
    if bad or not gates["attn_offload_loss_equals_attn"]:
        raise AssertionError(f"attn_offload differs from attn on {len(bad)} leaves: {record}")
    if gates["none_loss_rel_diff"] > TRAIN_LOSS_RTOL or none_worst > REMAT_NONE_GRAD_TOL:
        raise AssertionError(f"remat none differs from attn: {record}")
    del trainer, grads
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    return record, launched


def moe_offload_phase(torch, fa, int4, gm) -> tuple[dict, dict]:
    """The ``moe_train`` configuration (Mixtral-8x1B QLoRA, int8 banks,
    grouped, ``pin_expert_acts``) on one batch, its loss and adapter
    gradients under remat "attn" and "attn_offload" from one init, twice in
    turns (the first round warms up): bit for bit, the same launches, the
    forward and backward's seconds and peak memory of each, the bytes
    parked."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import offload

    t_phase = time.perf_counter()
    B, S = MOE_TRAIN_SHAPE
    cfg = moe_config()
    trainer = live_lora_trainer(torch, cfg, True, seed=0)
    batch = trainer.make_fake_batch(B, S, seed=5)
    resident = torch.cuda.memory_allocated()
    zero_moe_counts(fa, int4, gm)  # the offloaded MoE path's count starts here
    runs, grads = {}, {}
    for r in range(2):  # in turns; the first round warms up (pinned buffers, libraries)
        for policy in ("attn", "attn_offload"):
            trainer.model_cfg = dataclasses.replace(
                cfg, base=dataclasses.replace(cfg.base, remat_policy=policy))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before, offload.parked_bytes = moe_counts(fa, gm), 0
            t0 = time.perf_counter()
            loss, grads[policy] = trainer.gradients(batch)
            loss = float(loss)
            seconds = time.perf_counter() - t0
            after = moe_counts(fa, gm)
            n = {k: after[k] - before[k] for k in after}
            if n != MOE_LAUNCHES_PER_STEP:
                raise AssertionError(f"moe_offload {policy}: launches {n}")
            runs.setdefault(policy, {"fwd_bwd_s": []})["fwd_bwd_s"].append(seconds)
            runs[policy].update(loss=loss, parked_bytes=offload.parked_bytes, launches=n,
                                peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
                                peak_memory_gb_above_weights=(torch.cuda.max_memory_allocated()
                                                              - resident) / 2**30)
    launched = moe_counts(fa, gm)
    a, o = grads["attn"], grads["attn_offload"]
    bad = [p for p in a if not torch.equal(a[p], o[p])]
    record = {
        "phase": "moe_offload",
        "config": "the moe_train phase's: mixtral_8x1b QLoRA int8 banks, dispatch grouped, "
                  "pin_expert_acts, LoRA r16 (b live), 16 layers",
        "batch": B, "seq": S, "runs": runs, "leaves": len(a),
        "leaves_bit_equal": len(a) - len(bad),
        "attn_minus_offload_peak_gb": runs["attn"]["peak_memory_gb"]
                                       - runs["attn_offload"]["peak_memory_gb"],
        "launches": launched,
    }
    if int4.launches:
        raise AssertionError(f"moe_offload launched the int4 dequant: {record}")
    if bad or runs["attn_offload"]["loss"] != runs["attn"]["loss"] or \
            not runs["attn_offload"]["parked_bytes"] or runs["attn"]["parked_bytes"]:
        raise AssertionError(f"moe attn_offload differs from attn on {len(bad)} leaves: {record}")
    del trainer, grads
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    return record, launched


def llama_with_plain(fa, int4, fn):
    """``fn()`` with the flash kernels' and the int4 dequant's plain
    versions in their wrappers' place."""
    kept = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv, int4.int4_dequant)
    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
        fa.flash_fwd_reference, fa.flash_dq_reference, fa.flash_dkv_reference)
    int4.int4_dequant = int4.int4_dequant_reference
    try:
        return fn()
    finally:
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv, int4.int4_dequant = kept


def scale_term_magnitudes(torch, fn):
    """``fn()`` with each LoRA adapter's ``scale`` gradient replaced by the
    sum of the magnitudes of its terms: the adapter adds ``z · scale`` with
    ``z = (x @ a) @ b``, so ``d scale = Σ dy ⊙ z`` over every element, a
    sum that cancels to 1e-10–1e-6; this run gives ``Σ |dy ⊙ z|`` in its
    place, every value and every other gradient unchanged."""
    from odh_kubeflow_tpu_torch.models import llama

    class Magnitudes(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z, scale):
            ctx.save_for_backward(z, scale)
            return z * scale

        @staticmethod
        def backward(ctx, g):
            z, scale = ctx.saved_tensors
            terms = (g.float() * z.float()).abs().sum()
            return g * scale, terms.to(scale.dtype)

    adapted = llama._maybe_lora

    def probed(name, x, w, lora_layer, xq_sx=None, tp=None):
        if lora_layer is None or name not in lora_layer or tp is not None:
            return adapted(name, x, w, lora_layer, xq_sx, tp)
        ab = lora_layer[name]
        z = (x @ ab["a"].to(x.dtype)) @ ab["b"].to(x.dtype)
        return adapted(name, x, w, None, xq_sx, tp) + Magnitudes.apply(z, ab["scale"].to(x.dtype))

    llama._maybe_lora = probed
    try:
        return fn()
    finally:
        llama._maybe_lora = adapted


def adapter_grad_readings(torch, fa, int4, trainer, batch) -> dict:
    """The adapters' gradients with the kernels against the plain versions,
    leaf by leaf: ``rel`` is ``||kernel - plain|| / ||plain||``; a
    ``scale`` leaf, whose gradient is a cancelling sum, is read beside it
    against the sum of its terms' magnitudes from the plain run
    (``rel_terms``, ``scale_term_magnitudes``), and that is its gated
    reading; an ``a`` or ``b`` leaf's gated reading is ``rel``."""
    before = counts(fa, int4)
    k_loss, kernel = trainer.gradients(batch)
    mid = counts(fa, int4)
    if not all(mid[n] > before[n] for n in mid):
        raise AssertionError(f"a kernel did not launch: {before} -> {mid}")
    p_loss, plain = llama_with_plain(fa, int4, lambda: trainer.gradients(batch))
    _, terms = llama_with_plain(
        fa, int4, lambda: scale_term_magnitudes(torch, lambda: trainer.gradients(batch)))
    if counts(fa, int4) != mid:
        raise AssertionError("the plain run launched a kernel")
    leaves = {}
    for path, p in plain.items():
        k = kernel[path]
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"non-finite gradient {path}")
        diff = (k.float() - p.float()).norm()
        norm = p.float().norm()
        r = {"rel": (diff / norm.clamp_min(1e-30)).item(), "plain_norm": norm.item()}
        if path[-1] == "scale":
            t = terms[path].float().norm()
            r.update(terms_norm=t.item(), rel_terms=(diff / t.clamp_min(1e-30)).item())
            r["gated"] = r["rel_terms"]
        else:
            r["gated"] = r["rel"]
        leaves["/".join(path)] = r
    worst = max(leaves, key=lambda n: leaves[n]["rel"])
    gated = max(leaves, key=lambda n: leaves[n]["gated"])
    k_loss, p_loss = float(k_loss), float(p_loss)
    return {"loss_kernels": k_loss, "loss_plain": p_loss,
            "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
            "worst_leaf": worst, "worst_leaf_grad_rel_diff": leaves[worst]["rel"],
            "worst_gated_leaf": gated, "worst_gated_rel_diff": leaves[gated]["gated"],
            "leaves": leaves, "grads": kernel}


def train_parity_phase(torch, fa, int4) -> dict:
    """A 2-layer model at 8B width: the kernels against the plain versions
    inside one training step's loss and adapter gradients. Each ``a`` and
    ``b`` leaf is held to ``TRAIN_GRAD_TOL`` relative to its own norm, each
    ``scale`` leaf (a cancelling sum) to the same bound relative to the sum
    of its terms' magnitudes; both readings are reported."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig

    B, S = TRAIN_SHAPE
    cfg = LlamaConfig.llama3_8b(num_layers=2, remat=True, remat_policy="attn")
    trainer = parity_trainer(torch, cfg, seed=1)
    batches = {"unpacked": trainer.make_fake_batch(B, S, seed=2), "packed": parity_packed(cfg)}
    out = {"phase": "train_parity_on_card", "layers": 2, "batch": B, "seq": S,
           "grad_tol": f"a, b: ||kernel - plain|| / ||plain|| <= {TRAIN_GRAD_TOL}; scale: "
                       f"||kernel - plain|| / ||sum of |terms| (plain)|| <= {TRAIN_GRAD_TOL}",
           "loss_rtol": TRAIN_LOSS_RTOL}
    for name, batch in batches.items():
        r = adapter_grad_readings(torch, fa, int4, trainer, batch)
        grads = r.pop("grads")
        r["leaves"] = len(r["leaves"])
        out[name] = r
        if not (math.isfinite(r["loss_kernels"]) and r["loss_rel_diff"] <= TRAIN_LOSS_RTOL
                and r["worst_gated_rel_diff"] <= TRAIN_GRAD_TOL):
            raise AssertionError(f"train parity {name}: {out[name]}")
        if name == "unpacked":
            unpacked = (batch, grads)
    batch, attn_grads = unpacked
    trainer.model_cfg = dataclasses.replace(cfg, remat_policy="none")
    _, none_grads = trainer.gradients(batch)
    worst = max((none_grads[p] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for p, g in attn_grads.items())
    out["attn_vs_none_worst_leaf_grad_rel_diff"] = worst
    if worst > REMAT_NONE_GRAD_TOL:
        raise AssertionError(f"remat attn vs none gradients differ: {worst}")
    return out


def parity_trainer(torch, cfg, seed: int):
    """The parity model's trainer: int4 base, LoRA r16 whose ``b`` is
    drawn from seed 9 times 0.01 (a live adapter: every leaf has a
    gradient)."""
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4", seed=seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    with torch.no_grad():
        for ab in trainer.lora_params["layers"].values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.01)
    return trainer


def parity_packed(cfg):
    """The parity phase's packed batch: 24 documents of 100–1,500 tokens."""
    import torch

    from odh_kubeflow_tpu_torch.train.data import pack_documents, prefetch_to_device

    B, S = TRAIN_SHAPE
    rng = torch.Generator().manual_seed(10)
    docs = [torch.randint(1, cfg.vocab_size, (int(n),), generator=rng).tolist()
            for n in torch.randint(100, 1500, (24,), generator=rng)]
    return next(prefetch_to_device(pack_documents(docs, B, S)))


def train_profile_phase(torch, trainer) -> dict:
    """One 8B training step under ``torch.profiler``: the device's busy
    share and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.make_fake_batch(*TRAIN_SHAPE, seed=3)
    float(trainer.train_step(batch)["loss"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.train_step(batch)["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(t for t, _ in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "phase": "train_profile",
        "profiled_step_wall_ms": wall_ms,
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / wall_ms if kernels else "not measured",
        "top_kernels": [{"kernel": k, "ms": t / 1e3, "launches": c} for k, (t, c) in top],
    }


# ---------------------------------------------------------------------------
# MoE (slice 3): the Mixtral-8x1B QLoRA step and its grouped-matmul kernels


def grouped_offsets(torch, counts, M: int):
    """``route_sorted``'s offsets for per-expert row counts: starts padded
    to ``ALIGN``, ``offsets[E] = M`` (the last expert owns the tail)."""
    from odh_kubeflow_tpu_torch.ops.grouped_matmul import ALIGN

    starts, s = [], 0
    for c in counts:
        starts.append(s)
        s += -(-c // ALIGN) * ALIGN
    if s > M:
        raise ValueError(f"counts {counts} overflow M={M}")
    return torch.tensor(starts + [M], dtype=torch.int32, device="cuda")


def moe_routings(torch, B=MOE_TRAIN_SHAPE[0], S=MOE_TRAIN_SHAPE[1]) -> dict:
    """The routings the grouped kernels are held on, for a batch of B x S
    tokens: near-balanced (``route_sorted`` of random logits), one expert
    taking every row, two empty experts, and a large tail region past the
    last real group. At the 8x1B training shape (M 17,408) the tail is
    9,344 rows (7,500 real rows); at the serving prefill (M 3,072) 2,048
    (853 real rows)."""
    from odh_kubeflow_tpu_torch.models.moe import MoeConfig, route_sorted

    cfg = MoeConfig.mixtral_8x1b()
    E = cfg.num_experts
    gen = torch.Generator(device="cuda").manual_seed(31)
    logits = torch.randn((B, S, E), generator=gen, device="cuda")
    _, _, balanced, _, _ = route_sorted(logits, cfg)
    M = int(balanced[-1])
    per = B * S * cfg.num_experts_per_tok // E  # rows an expert when balanced
    if M == MOE_M:
        two_empty = [per + 700, 0, per + 300, per, per - 900, 0, per + 500, per]
        tail = [1000, 900, 1100, 800, 1000, 1050, 950, 700]
    else:
        two_empty = [per + 90, 0, per + 40, per, per - 110, 0, per + 60, per]
        tail = [128, 100, 130, 90, 120, 110, 95, 80]
    return {
        "balanced": balanced,
        "one_expert": grouped_offsets(torch, [0, 0, 0, M, 0, 0, 0, 0], M),
        "two_empty": grouped_offsets(torch, two_empty, M),
        "large_tail": grouped_offsets(torch, tail, M),
    }


def poison(torch, *shape) -> None:
    """Leave NaN in the caching allocator's next block of this size: an
    output element a kernel does not write then shows as NaN."""
    torch.full(shape, float("nan"), dtype=torch.bfloat16, device="cuda")


def wrong_expert(offs):
    """Offsets that hand the first 128-row tile of a group to the expert
    before it (the boundary moves one tile up)."""
    o = offs.clone()
    for e in range(1, o.numel() - 1):
        if o[e + 1] > o[e] and o[e] > 0:
            o[e] += 128
            return o
    raise AssertionError("no group boundary to move")


def library_ms(torch, fn, what="torch._grouped_mm"):
    """One library call timed as the yardstick, where the card's torch
    takes it: (ms, None), else (None, what it raised)."""
    if what.startswith("torch._grouped_mm") and not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm absent"
    try:
        fn(0)
        return time_ms(torch, fn, iters=10), None
    except Exception as e:  # noqa: BLE001 — a yardstick, not a phase result
        return None, f"{what} raised {type(e).__name__}: {str(e)[:200]}"


class TileChecks:
    """Per-kernel accuracy records of the grouped kernels: ``check`` holds
    a result per 128-row tile to ``TILE_RTOL``, ``plant`` requires the
    same check to reject each planted fault."""

    def __init__(self, gm, names):
        self.gm = gm
        self.stats = {n: {"max_abs_err": 0.0, "tile_rel_err": 0.0, "shapes": [],
                          "planted_fault": {}} for n in names}

    def check(self, name, got, want, label):
        if not bool(got.isfinite().all()):
            raise AssertionError(f"{name} {label}: non-finite output (an unwritten row?)")
        rel = self.gm.tile_rel_err(got, want)
        if not rel <= self.gm.TILE_RTOL:
            raise AssertionError(f"{name} {label}: tile relative err {rel} > {self.gm.TILE_RTOL}")
        st = self.stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], (got.float() - want.float()).abs().max().item())
        st["tile_rel_err"] = max(st["tile_rel_err"], rel)
        return rel

    def plant(self, name, label, want, faults):
        """faults: {description: output of the plain version made wrong}"""
        for what, bad in faults.items():
            rel = self.gm.tile_rel_err(bad, want)
            if rel <= self.gm.TILE_RTOL:
                raise AssertionError(f"{name}: the check passed a planted fault ({what}): {rel}")
            self.stats[name]["planted_fault"][f"{label}: {what}"] = rel


def gmm_work(M, K, N, E, kind):
    """(flops, bytes) of one launch over all M rows: each input read once,
    each output written once."""
    if kind == "swiglu_fwd":
        return 4 * M * K * N, M * K * 2 + 2 * E * K * N + 2 * E * N * 4 + 2 * M * N * 2
    if kind == "swiglu_bwd":
        return 2 * M * K * N, M * K * 2 + E * K * N + E * N * 4 + 4 * M * N * 2
    if kind in ("gmm_bf16", "tgmm"):  # bf16 bank or gradient, no scale
        return 2 * M * K * N, M * K * 2 + E * K * N * 2 + M * N * 2
    return 2 * M * K * N, M * K * 2 + E * K * N + E * max(K, N) * 4 + M * N * 2


def prescale(torch, gm, lhs, scale, offs):
    """A launch of the int8 trans ``gmm``'s first pass alone (``lhs``
    times its row's expert's scale, rounded to bf16), for its own time."""
    lib = gm._library("gmm")
    out = torch.empty_like(lhs)
    M, K = lhs.shape
    E = scale.shape[0]

    def run(i):
        rc = lib.gmm_prescale_launch(lhs.data_ptr(), scale.data_ptr(), offs.data_ptr(),
                                     out.data_ptr(), M, K, E,
                                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"prescale launch failed: CUDA error {rc}")

    return run


def moe_kernels_phase(torch, gm, bw: float, peak: float) -> list[dict]:
    """Each grouped kernel against its plain version at the Mixtral-8x1B
    training shapes (M 17,408 sorted rows, D 2048, F 8192, E 8), on four
    routings, per 128-row tile, into output buffers left full of NaN;
    planted faults the check must reject; times at the balanced routing."""
    E, D, F, M = 8, 2048, 8192, MOE_M
    gen = torch.Generator(device="cuda").manual_seed(77)
    routings = moe_routings(torch)

    def bf16(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def bank(*shape):
        q = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        last = shape[-1]
        s = torch.rand((shape[0], 1, last), generator=gen, device="cuda") * 2e-3 + 1e-4
        return q, s

    # (row, shape label, K, N, trans): the gmm launches of one MoE layer's step
    gmm_shapes = (
        ("gmm_k8192", "down fwd", F, D, False),
        ("gmm_k8192", "gate/up dlhs (trans)", F, D, True),
        ("gmm_k2048", "down dlhs (trans)", D, F, True),
    )
    checks = TileChecks(gm, ("gmm_k8192", "gmm_k2048", "swiglu_fwd", "swiglu_bwd"))
    stats, check, plant = checks.stats, checks.check, checks.plant

    for name, label, K, N, trans in gmm_shapes:
        lhs = bf16(M, K)
        q, s = bank(E, N, K) if trans else bank(E, K, N)
        for rname, offs in routings.items():
            poison(torch, M, N)
            got = gm.gmm(lhs, q, offs, trans, s)
            want = gm.gmm_reference(lhs, q, offs, trans, s)
            torch.cuda.synchronize()
            rel = check(name, got, want, f"{label} {rname}")
            if rname == "balanced":
                short = lhs.clone()
                short[:, -64:] = 0
                plant(name, label, want, {
                    "a tile given the wrong expert": gm.gmm_reference(
                        lhs, q, wrong_expert(offs), trans, s),
                    "the last K chunk of 64 skipped": gm.gmm_reference(short, q, offs, trans, s),
                })
                del short
                flops, nbytes = gmm_work(M, K, N, E, name)
                row = {"shape": label, "M": M, "K": K, "N": N, "trans": trans,
                       "flops": flops, "bytes": nbytes, "tile_rel_err": rel,
                       "ms": time_ms(torch, lambda i: gm.gmm(lhs, q, offs, trans, s), iters=10),
                       "plain_ms": time_ms(torch, lambda i: gm.gmm_reference(lhs, q, offs, trans, s),
                                           iters=2, reps=3),
                       "bound_ms": max(flops / peak, nbytes / bw) * 1e3,
                       "bound_by": "operations" if flops / peak > nbytes / bw else "bytes"}
                qb = q.to(torch.bfloat16)
                rhs = qb.transpose(1, 2) if trans else qb
                ends = offs[1:].contiguous()
                row["library_ms"], row["library_note"] = library_ms(
                    torch, lambda i: torch._grouped_mm(lhs, rhs, offs=ends))
                row["tflops_per_s"] = flops / row["ms"] / 1e9
                if trans:  # the first pass inside "ms", alone: read x, write it scaled
                    row["prescale_ms"] = time_ms(torch, prescale(torch, gm, lhs, s, offs),
                                                 iters=10)
                    row["prescale_bound_ms"] = (4 * M * K + 4 * E * K) / bw * 1e3
                stats[name]["shapes"].append(row)
                del qb, rhs
            del got, want
        del lhs, q, s
        torch.cuda.empty_cache()

    # the fused SwiGLU, forward and backward
    x = bf16(M, D)
    (wg, sg), (wu, su) = bank(E, D, F), bank(E, D, F)
    dh = bf16(M, F)
    for rname, offs in routings.items():
        poison(torch, M, F)
        h, g = gm.swiglu_fwd(x, wg, wu, sg, su, offs)
        wh, wgt = gm.swiglu_fwd_reference(x, wg, wu, sg, su, offs)
        torch.cuda.synchronize()
        rel_f = max(check("swiglu_fwd", h, wh, f"h {rname}"), check("swiglu_fwd", g, wgt, f"g {rname}"))
        poison(torch, M, F)
        dg, du = gm.swiglu_bwd(x, wu, su, wgt, dh, offs)
        wdg, wdu = gm.swiglu_bwd_reference(x, wu, su, wgt, dh, offs)
        torch.cuda.synchronize()
        rel_b = max(check("swiglu_bwd", dg, wdg, f"dg {rname}"),
                    check("swiglu_bwd", du, wdu, f"du {rname}"))
        if rname == "balanced":
            short = x.clone()
            short[:, -64:] = 0
            moved = wrong_expert(offs)
            plant("swiglu_fwd", "h", wh, {
                "a tile given the wrong expert":
                    gm.swiglu_fwd_reference(x, wg, wu, sg, su, moved)[0],
                "the last K chunk of 64 skipped":
                    gm.swiglu_fwd_reference(short, wg, wu, sg, su, offs)[0],
            })
            plant("swiglu_bwd", "dg", wdg, {
                "a tile given the wrong expert":
                    gm.swiglu_bwd_reference(x, wu, su, wgt, dh, moved)[0],
                "the last K chunk of 64 skipped":
                    gm.swiglu_bwd_reference(short, wu, su, wgt, dh, offs)[0],
            })
            del short
            ends = offs[1:].contiguous()
            wgu = torch.cat([wg, wu], dim=2).to(torch.bfloat16)
            wub = wu.to(torch.bfloat16)
            for name, rel, fn, plain, lib in (
                ("swiglu_fwd", rel_f, lambda i: gm.swiglu_fwd(x, wg, wu, sg, su, offs),
                 lambda i: gm.swiglu_fwd_reference(x, wg, wu, sg, su, offs),
                 lambda i: torch._grouped_mm(x, wgu, offs=ends)),
                ("swiglu_bwd", rel_b, lambda i: gm.swiglu_bwd(x, wu, su, wgt, dh, offs),
                 lambda i: gm.swiglu_bwd_reference(x, wu, su, wgt, dh, offs),
                 lambda i: torch._grouped_mm(x, wub, offs=ends)),
            ):
                flops, nbytes = gmm_work(M, D, F, E, name)
                row = {"shape": "gate/up D->F", "M": M, "K": D, "N": F, "flops": flops,
                       "bytes": nbytes, "tile_rel_err": rel,
                       "ms": time_ms(torch, fn, iters=10),
                       "plain_ms": time_ms(torch, plain, iters=2, reps=3),
                       "bound_ms": max(flops / peak, nbytes / bw) * 1e3,
                       "bound_by": "operations" if flops / peak > nbytes / bw else "bytes"}
                row["library_ms"], row["library_note"] = library_ms(torch, lib)
                row["tflops_per_s"] = flops / row["ms"] / 1e9
                stats[name]["shapes"].append(row)
            del wgu, wub
        del h, g, wh, wgt, dg, du, wdg, wdu
    del x, wg, wu, sg, su, dh
    torch.cuda.empty_cache()

    tpu = {
        "gmm_k8192": ("odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:307",
                      "_gmm_b_kernel (pallas_call at odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:447)",
                      "csrc/gmm.cu"),
        "gmm_k2048": ("odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:210",
                      "_gmm_a_kernel_q (pallas_call at odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:287)",
                      "csrc/gmm.cu"),
        "swiglu_fwd": ("odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:672",
                       "_swiglu_fwd_kernel (pallas_call at odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:757)",
                       "csrc/swiglu_gmm.cu"),
        "swiglu_bwd": ("odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:698",
                       "_swiglu_bwd_kernel (pallas_call at odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:782)",
                       "csrc/swiglu_gmm.cu"),
    }
    rows = []
    for name, st in stats.items():
        main_row = st["shapes"][0]
        replaces, fn, src = tpu[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "odh_kubeflow_tpu_torch/" + src,
            "replaces": replaces,
            "tpu_kernel": fn,
            "max_abs_err": st["max_abs_err"],
            "tile_rel_err": st["tile_rel_err"],
            "tolerance": f"||kernel - plain|| / ||plain|| <= {gm.TILE_RTOL} in every 128-row "
                         "tile, bf16, on 4 routings (balanced, one expert, two empty, large tail)",
            "planted_fault": st["planted_fault"],
            "unit": f"one launch at the Mixtral-8x1B training shape ({main_row['shape']}, "
                    f"M {MOE_M}, K {main_row['K']}, N {main_row['N']}, balanced routing)",
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library": "torch._grouped_mm over a bf16 copy of the bank"
                       + (" (gate|up concatenated: the two products only, no silu)"
                          if name == "swiglu_fwd" else
                          " (the u product only)" if name == "swiglu_bwd" else ""),
            "shapes": st["shapes"],
        })
    return rows


def moe_counts(fa, gm) -> dict:
    """Launches of the flash and grouped kernels; gmm_k* count the int8
    bank's launches, gmm_bf16_k* the bf16 bank's, gmm all of them."""
    by_k = gm.gmm_launches_by_k
    return {"flash_fwd": fa.fwd_launches, "flash_dq": fa.dq_launches,
            "flash_dkv": fa.dkv_launches, "swiglu_fwd": gm.swiglu_fwd_launches,
            "swiglu_bwd": gm.swiglu_bwd_launches,
            "gmm_k8192": by_k.get(("int8", 8192), 0), "gmm_k2048": by_k.get(("int8", 2048), 0),
            "gmm": gm.gmm_launches, "gmm_bf16_k2048": by_k.get(("bf16", 2048), 0),
            "gmm_bf16_k8192": by_k.get(("bf16", 8192), 0), "tgmm": gm.tgmm_launches}


def zero_moe_counts(fa, int4, gm) -> None:
    zero_counts(fa, int4)
    gm.gmm_launches = gm.swiglu_fwd_launches = gm.swiglu_bwd_launches = gm.tgmm_launches = 0
    gm.gmm_launches_by_k.clear()


def moe_with_plain(fa, gm, fn):
    """``fn()`` with every flash and grouped kernel's plain version in its
    wrapper's place."""
    names = (("flash_fwd", fa), ("flash_dq", fa), ("flash_dkv", fa), ("gmm", gm), ("tgmm", gm),
             ("swiglu_fwd", gm), ("swiglu_bwd", gm))
    kept = [getattr(m, n) for n, m in names]
    for n, m in names:
        setattr(m, n, getattr(m, n + "_reference"))
    try:
        return fn()
    finally:
        for (n, m), k in zip(names, kept):
            setattr(m, n, k)


def moe_config():
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.moe import MoeConfig

    return MoeConfig.mixtral_8x1b(
        base=LlamaConfig.llama3_1b(remat_policy="attn"), dispatch="grouped",
        pin_expert_acts=True,
    )


def moe_train_phase(torch, fa, int4, gm, peak: float) -> tuple[dict, object]:
    """The Mixtral-8x1B QLoRA step through ``Trainer.benchmark``."""
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    B, S = MOE_TRAIN_SHAPE
    cfg = moe_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base=True,
                      precompile_batch=(B, S))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 2**30
    steps, warmup = 3, 1
    torch.cuda.reset_peak_memory_stats()
    zero_moe_counts(fa, int4, gm)  # the MoE training path's count starts here
    bench, step_losses = benchmark_with_losses(trainer, B, S, steps, warmup)
    launched = moe_counts(fa, gm)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = {k: n * (steps + warmup) for k, n in MOE_LAUNCHES_PER_STEP.items()}
    if launched != expected or int4.launches:
        raise AssertionError(f"MoE training launches {launched} (int4 {int4.launches}), "
                             f"expected {expected}")
    metrics = trainer.train_step(trainer.make_fake_batch(B, S, seed=1))
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"loss {loss}, grad_norm {gnorm}")
    if not math.isfinite(bench["loss"]):
        raise AssertionError(f"benchmark loss {bench['loss']}")
    moved = {n: trainer.lora_params["layers"][n]["b"].abs().max().item()
             for n in trainer.lora_params["layers"]}
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"adapters b did not move from zero: {moved}")
    b = cfg.base
    record = {
        "phase": "moe_train",
        "config": f"mixtral_8x1b QLoRA: D {b.hidden_size}, F {b.intermediate_size}, "
                  f"{b.num_layers} layers, {b.num_heads}/{b.num_kv_heads} heads, hd {b.head_dim}, "
                  f"V {b.vocab_size}, E {cfg.num_experts}, top-{cfg.num_experts_per_tok}, int8 "
                  "base (random weights, seed 0), dispatch grouped, remat attn + pin_expert_acts, "
                  "LoRA r16 on wq/wk/wv/wo",
        "batch": B, "seq": S, "steps": steps, "warmup": warmup, "sorted_rows_M": MOE_M,
        "init_s": init_s, "resident_params_gb": resident_gb, "peak_memory_gb": peak_gb,
        "step_time_s": bench["step_time_s"], "tokens_per_s": bench["tokens_per_s"],
        "model_flops_per_step": bench["model_flops_per_step"],
        "strict_mfu": bench["flops_per_s"] / peak,
        "train_equiv_mfu": bench["train_equiv_flops_per_s"] / peak,
        "peak_flops": peak, "loss_benchmark": bench["loss"], "step_losses": step_losses,
        "loss_after": loss, "grad_norm_after": gnorm,
        "launches": launched, "launches_per_step": MOE_LAUNCHES_PER_STEP,
        "adapter_b_max_abs": moved,
    }
    return record, trainer


def moe_mesh_train_phase(torch, fa, int4, gm, moe_record: dict) -> tuple[dict, dict]:
    """The ``moe_train`` phase's Mixtral-8x1B QLoRA step through
    ``Trainer(mesh=build_mesh(MeshConfig()))`` on an NCCL group of one rank
    (every axis of size 1: the grouped path with no collective): its
    losses against ``moe_train``'s bit for bit, the same launches a step,
    step time and peak memory."""
    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    B, S = MOE_TRAIN_SHAPE
    steps, warmup = 3, 1
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshConfig(), device="cuda")
        t0 = time.perf_counter()
        trainer = Trainer(moe_config(), TrainConfig(), LoraConfig(rank=16), quantize_base=True,
                          mesh=mesh, precompile_batch=(B, S))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_moe_counts(fa, int4, gm)  # the mesh path's count starts here
        bench, step_losses = benchmark_with_losses(trainer, B, S, steps, warmup)
        launched = moe_counts(fa, gm)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
    finally:
        dist.destroy_process_group()
    expected = {k: n * (steps + warmup) for k, n in MOE_LAUNCHES_PER_STEP.items()}
    if launched != expected or int4.launches:
        raise AssertionError(f"MoE mesh training launches {launched} (int4 {int4.launches}), "
                             f"expected {expected}")
    want = moe_record["step_losses"]
    if step_losses != want:
        raise AssertionError(f"MoE mesh step losses {step_losses} != one-device {want}")
    record = {
        "phase": "moe_mesh_train",
        "config": "the moe_train phase's: mixtral_8x1b QLoRA int8, LoRA r16, grouped, remat "
                  "attn + pin_expert_acts, 16 layers; Trainer(mesh=build_mesh(MeshConfig())) on "
                  "an NCCL group of 1",
        "batch": B, "seq": S, "steps": steps, "warmup": warmup, "init_s": init_s,
        "step_time_s": bench["step_time_s"],
        "moe_train_step_time_s": moe_record["step_time_s"],
        "step_time_ratio": bench["step_time_s"] / moe_record["step_time_s"],
        "peak_memory_gb": peak_gb, "moe_train_peak_memory_gb": moe_record["peak_memory_gb"],
        "step_losses": step_losses, "losses_equal_moe_train_bitwise": True,
        "launches": launched, "launches_per_step": MOE_LAUNCHES_PER_STEP,
    }
    return record, launched


# the expert-parallel MoE on one card: one Mixtral-8x1B layer's router and
# experts at the training batch, its expert shards run one after another
EP_SHARDS = (2, 4)
EP_FACTORS = (None, 1.25)


def ep_local_kernel_checks(torch, gm, moe_lib, x, router, floats, banks_q) -> dict:
    """Each grouped kernel at an expert shard's shapes against its plain
    version per 128-row tile (``TileChecks``): ``n_local`` = 1, 2 and 4 of
    the 8 experts (offsets of ``n_local + 1`` entries), an ``m_loc``-row
    buffer whose last group carries the tail (``route_sorted_ep`` of the
    phase's tokens at a 1.25 budget, shard 0), and for 2 and 4 groups also
    a first group left empty (a budget can leave one so); a NaN-filled
    buffer under each output."""
    import dataclasses

    B, S, D = x.shape
    E = router.shape[1]
    F = floats["moe_gate"].shape[2]
    cfg = dataclasses.replace(moe_config(), ep_capacity_factor=1.25)
    logits = moe_lib._router_logits(x, {"router": router}).reshape(B * S, E)
    ones = torch.ones(B * S, dtype=torch.bool, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(43)

    def rows(m, n):
        return torch.randn((m, n), generator=gen, device="cuda").to(torch.bfloat16)

    names = ("gmm_int8_down", "gmm_int8_down_trans", "gmm_bf16_gate", "gmm_bf16_gate_trans",
             "swiglu_fwd", "swiglu_bwd", "tgmm")
    checks = TileChecks(gm, names)
    routings = []
    for n_local in (4, 2, 1):
        ep = E // n_local
        m_loc = moe_lib._ep_rows(B * S, cfg, ep, n_local)
        offs = moe_lib.route_sorted_ep(logits, cfg, 0, n_local, m_loc, ones)[4]
        sets = {"routed": offs}
        if n_local > 1:
            per = (m_loc - n_local * gm.ALIGN) // n_local
            sets["first_empty"] = grouped_offsets(torch, [0] + [per] * (n_local - 1), m_loc)
        for label, o in sets.items():
            routings.append({"groups": n_local, "routing": label, "offsets": o.tolist()})
            label = f"{n_local} groups, {label}"
            sl = slice(0, n_local)
            qd, sd = banks_q["moe_down"]["q"][sl], banks_q["moe_down"]["scale"][sl]
            qg, sg = banks_q["moe_gate"]["q"][sl], banks_q["moe_gate"]["scale"][sl]
            qu, su = banks_q["moe_up"]["q"][sl], banks_q["moe_up"]["scale"][sl]
            wg = floats["moe_gate"][sl]
            lhs_d, lhs_f = rows(m_loc, D), rows(m_loc, F)
            calls = {  # name: (kernel, plain version, arguments, output shape)
                "gmm_int8_down": (gm.gmm, gm.gmm_reference, (lhs_f, qd, o, False, sd), (m_loc, D)),
                "gmm_int8_down_trans": (gm.gmm, gm.gmm_reference, (lhs_d, qd, o, True, sd),
                                        (m_loc, F)),
                "gmm_bf16_gate": (gm.gmm, gm.gmm_reference, (lhs_d, wg, o, False, None),
                                  (m_loc, F)),
                "gmm_bf16_gate_trans": (gm.gmm, gm.gmm_reference, (lhs_f, wg, o, True, None),
                                        (m_loc, D)),
                # an empty group's weight gradient must be written as zeros
                "tgmm": (gm.tgmm, gm.tgmm_reference, (lhs_d, lhs_f, o, n_local),
                         (n_local * D, F)),
            }
            for name, (kernel, plain, args, shape) in calls.items():
                poison(torch, *shape)
                got, want = kernel(*args), plain(*args)
                checks.check(name, got.reshape(-1, got.shape[-1]),
                             want.reshape(-1, want.shape[-1]), label)
            poison(torch, m_loc, F)
            h, g = gm.swiglu_fwd(lhs_d, qg, qu, sg, su, o)
            hw, gw = gm.swiglu_fwd_reference(lhs_d, qg, qu, sg, su, o)
            checks.check("swiglu_fwd", h, hw, label + " (h)")
            checks.check("swiglu_fwd", g, gw, label + " (g)")
            dh = rows(m_loc, F)
            poison(torch, m_loc, F)
            dg, du = gm.swiglu_bwd(lhs_d, qu, su, gw, dh, o)
            dgw, duw = gm.swiglu_bwd_reference(lhs_d, qu, su, gw, dh, o)
            checks.check("swiglu_bwd", dg, dgw, label + " (dg)")
            checks.check("swiglu_bwd", du, duw, label + " (du)")
            del lhs_d, lhs_f, calls
    torch.cuda.empty_cache()
    return {"routings": routings,
            "kernels": {n: {k: v for k, v in st.items() if k != "planted_fault"}
                        for n, st in checks.stats.items()}}


def moe_ep_loopback_phase(torch, fa, int4, gm) -> tuple[dict, dict]:
    """One Mixtral-8x1B MoE layer (router and experts, B 2 x S 4096, bf16
    activations) through ``loopback_moe_mlp_grouped_ep``, forward and
    backward, with int8 banks (QLoRA) and bf16 banks (full fine-tune), at
    2 and 4 expert shards, with ``ep_capacity_factor`` None and 1.25.

    Each case's out, dx, router gradient and bf16 bank gradients are held
    per 128-row tile (``TILE_RTOL``) against two whole-batch calls: the
    grouped path, ``_moe_mlp_grouped``, and the expert-parallel path at one
    shard (its 17,408 rows are the grouped path's; its combine is
    ``_CombineWeighted``). The two whole calls round the routing weights'
    gradient differently (the grouped path's ``y · w`` in bf16, the
    expert-parallel combine in float32, both as JAX's), which moves
    dlogits, so against the grouped path the router gradient, a sum that
    cancels, is held relative to its terms' magnitudes ``|x|ᵀ·|dlogits|``
    and dx, where that rounding flips the last bit of about a fifth of the
    elements, is reported; against the one-shard call every tile is held.
    Also: the assignments a budget drops, each grouped kernel's launches
    against shards x the whole call's, the time and peak memory of both;
    first each grouped kernel at 1, 2 and 4 local groups
    (``ep_local_kernel_checks``)."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import moe as moe_lib
    from odh_kubeflow_tpu_torch.models.quant import quantize_tensor

    B, S = MOE_TRAIN_SHAPE
    cfg = moe_config()
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    D, F = cfg.base.hidden_size, cfg.base.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(41)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    x = randn(B, S, D)
    dout = randn(B, S, D)
    router = randn(D, E, scale=D**-0.5)
    floats = {"moe_gate": randn(E, D, F, scale=D**-0.5), "moe_up": randn(E, D, F, scale=D**-0.5),
              "moe_down": randn(E, F, D, scale=F**-0.5)}
    quantized = {n: quantize_tensor(w) for n, w in floats.items()}
    few_groups = ep_local_kernel_checks(torch, gm, moe_lib, x, router, floats, quantized)
    logits = moe_lib._router_logits(x, {"router": router}).reshape(B * S, E)
    ones = torch.ones(B * S, dtype=torch.bool, device="cuda")

    def tiles(v):  # [rows, n] -> per-128-row-tile sums of squares
        v = v.float().square().sum(-1)
        return torch.nn.functional.pad(v, (0, -v.shape[0] % gm.ALIGN)).reshape(-1, gm.ALIGN).sum(1)

    kinds, launched = {}, {}
    for kind in ("int8", "bf16"):
        banks = quantized if kind == "int8" else floats
        trained = [floats[n] for n in moe_lib.BANKS] if kind == "bf16" else []
        names = ("out", "dx", "router") + tuple(f"d{n}" for n in moe_lib.BANKS)[:len(trained)]

        def run(fn, dlogits=None):
            xx, rr = x.detach().requires_grad_(), router.detach().requires_grad_()
            ws = [w.detach().requires_grad_() for w in trained]
            layer = {"router": rr, **banks, **dict(zip(moe_lib.BANKS, ws))}
            logits_of = moe_lib._router_logits
            if dlogits is not None:  # keep the router logits' gradient

                def kept(*a):
                    out = logits_of(*a)
                    out.register_hook(dlogits.append)
                    return out

                moe_lib._router_logits = kept
            try:
                out, aux = fn(xx, layer)
            finally:
                moe_lib._router_logits = logits_of
            grads = torch.autograd.grad([out, aux], [xx, rr, *ws],
                                        [dout, torch.ones_like(aux)])
            return {n: g.reshape(-1, g.shape[-1]) for n, g in zip(names, (out.detach(), *grads))}

        def whole(xx, layer):
            return moe_lib._moe_mlp_grouped(xx, layer, cfg, keep_g=True)

        zero_moe_counts(fa, int4, gm)
        dlogits = []
        want = run(whole, dlogits)
        torch.cuda.synchronize()
        per_call = moe_counts(fa, gm)
        terms = tiles(x.float().abs().reshape(-1, D).T @ dlogits[0].abs().reshape(-1, E))
        del dlogits
        one = run(lambda xx, layer: moe_lib.loopback_moe_mlp_grouped_ep(xx, layer, cfg, 1,
                                                                        keep_g=True))
        whole_ms = time_ms(torch, lambda _: run(whole), 2)
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 2**30
        run(whole)
        whole_gb = torch.cuda.max_memory_allocated() / 2**30 - base_gb
        cases = {}
        for ep in EP_SHARDS:
            for factor in EP_FACTORS:
                c = dataclasses.replace(cfg, ep_capacity_factor=factor)
                label = f"ep{ep}_factor{factor}"

                def ep_call(xx, layer, c=c, ep=ep):
                    return moe_lib.loopback_moe_mlp_grouped_ep(xx, layer, c, ep, keep_g=True)

                zero_moe_counts(fa, int4, gm)  # this case's loopback run
                torch.cuda.reset_peak_memory_stats()
                got = run(ep_call)
                torch.cuda.synchronize()
                peak_gb = torch.cuda.max_memory_allocated() / 2**30 - base_gb
                n = moe_counts(fa, gm)
                if n != {key: ep * v for key, v in per_call.items()}:
                    raise AssertionError(f"{kind} {label}: launches {n}, whole call {per_call}")
                for key, v in n.items():
                    launched[key] = launched.get(key, 0) + v
                errs, bad = {}, []
                for name, g in got.items():
                    if not bool(g.isfinite().all()):
                        raise AssertionError(f"{kind} {label} {name}: non-finite values")
                    w = want[name]
                    e = {"vs_one_shard": gm.tile_rel_err(g, one[name]),
                         "vs_grouped": gm.tile_rel_err(g, w),
                         "max_abs_err_vs_grouped": (g.float() - w.float()).abs().max().item()}
                    if name == "router":
                        diff = tiles(g.float() - w.float())
                        e["vs_grouped_over_terms"] = (diff.sqrt() / terms.sqrt()).max().item()
                    gated = [e["vs_one_shard"]] + (
                        [] if name == "dx" else
                        [e["vs_grouped_over_terms"] if name == "router" else e["vs_grouped"]])
                    if not max(gated) <= gm.TILE_RTOL:
                        bad.append(name)
                    errs[name] = e
                del got
                torch.cuda.empty_cache()
                m_loc = moe_lib._ep_rows(B * S, c, ep, E // ep)
                kept = sum(int(moe_lib.route_sorted_ep(logits, c, s * (E // ep), E // ep, m_loc,
                                                       ones)[3].sum())
                           for s in range(ep))
                ms = time_ms(torch, lambda _: run(ep_call), 2)
                cases[label] = {"shards": ep, "ep_capacity_factor": factor,
                                "rows_per_shard_m_loc": m_loc, "rows_all_shards": ep * m_loc,
                                "dropped_assignments": B * S * k - kept,
                                "launches": n, "tile_rel_err": errs,
                                "fwd_bwd_ms": ms, "over_whole": ms / whole_ms,
                                "peak_memory_gb_above_inputs": peak_gb}
                if bad:
                    raise AssertionError(f"{kind} {label}: {bad} over {gm.TILE_RTOL}: {errs}")
        del want, one
        kinds[kind] = {"whole_call": {"sorted_rows_M": MOE_M, "launches": per_call,
                                      "fwd_bwd_ms": whole_ms,
                                      "peak_memory_gb_above_inputs": whole_gb},
                       "cases": cases}
    record = {
        "phase": "moe_ep_loopback",
        "shape": {"batch": B, "seq": S, "hidden": D, "ffn": F, "experts": E, "top_k": k,
                  "dtype": "bfloat16"},
        "tile_rtol": gm.TILE_RTOL, "few_groups": few_groups, "banks": kinds,
    }
    return record, launched


# ---------------------------------------------------------------------------
# pipeline parallelism (slice 8, part 2b): the pipe stages run one after
# another on the card through the loopback drivers, with the ranks'
# arithmetic (parallel/pipeline.py)

PIPE_STAGES, PIPE_MICROBATCHES = 4, 8
# batch x seq: the train phase's 8,192 tokens, one 1,024-token row a
# microbatch, so M > S and 1F1B's ring (min(S, M) inputs) shows
PIPE_SHAPE = (8, 1024)
# launches per step, written from the schedule before the first run. The 8B
# QLoRA stack (32 layers, 7 int4 weights a layer, remat "attn", which
# saves the flash forward's residuals): unpipelined, each layer runs the
# flash forward once, dQ and dK/dV once, and dequantizes its 7 weights in
# the forward and again in the recompute, plus one dequant of the lm_head
# (2 x 224 + 1). GPipe runs every layer once per microbatch, forward and
# backward: 8 x that. 1F1B runs each stage's forward without grad at F,
# again with grad at B (the flash forward then saved), then B's backward
# recomputes each layer (7 dequants): 2 x 256 flash forwards and 3 x 1,792
# + 1 dequants
PIPE_LAUNCHES = {
    "unpipelined": {"flash_fwd": 32, "flash_dq": 32, "flash_dkv": 32, "int4_dequant": 449},
    "gpipe": {"flash_fwd": 256, "flash_dq": 256, "flash_dkv": 256, "int4_dequant": 3585},
    "1f1b": {"flash_fwd": 512, "flash_dq": 256, "flash_dkv": 256, "int4_dequant": 5377},
}
# gates, stated before the first run. GPipe against the unpipelined step:
# the same model, its products on 1,024-row microbatches in place of 8,192
# rows, so bf16 roundings taken at other points: the loss to
# TRAIN_LOSS_RTOL, each adapter's a and b gradients to TRAIN_GRAD_TOL of
# their norm (train_parity_on_card's bars); the scale leaves reported.
# 1F1B against GPipe: the same per-(stage, microbatch) operations on the
# same inputs, the layer gradients summed in float32 over the microbatches
# in the same order; only the 1/M scale moves (a power of two, exact), so
# they should agree to the last bit where every product is recomputed alike:
# the loss to 1e-6 relative, each adapter's a and b gradient to 1e-5 of its
# norm. A scale gradient is a sum that cancels to 1e-10-1e-6 of its terms,
# so one bf16 rounding of a product the library computes another way when
# it is recomputed (on the CPU, MKL's path turns on memory alignment) moves
# it far more than its norm; it is held to the bf16 unit roundoff, 2^-8,
# of the sum of its terms' magnitudes (scale_term_magnitudes), which bounds
# what one rounding of each term can move
PIPE_1F1B_LOSS_RTOL = 1e-6
PIPE_1F1B_GRAD_TOL = 1e-5
PIPE_1F1B_SCALE_TERMS_TOL = 2**-8
# the 2-layer 8B-width and 8x1B-width pipelined stacks, kernels against
# plain versions: 2 stages of one layer, 2 microbatches of one 1,024-token
# row (the main path's shapes)
PIPE_PARITY = dict(stages=2, microbatches=2, batch=(2, 1024))
# Mixtral-8x1B QLoRA through GPipe: 16 layers in 4 stages of 4, the same
# batch. A microbatch of 1,024 tokens routes 2,048 assignments: the
# grouped path, M = round_up(2048 + 8 x 128, 512) = 3,072 sorted rows a
# call. Per layer and microbatch as moe_train's per layer: the flash
# forward, the fused SwiGLU and the down product (K 8192) forward; dQ,
# dK/dV, the down dlhs (K 2048), the SwiGLU backward and the gate and up
# dlhs (K 8192) backward; remat "attn" + pin_expert_acts saves the rest
MOE_PIPE_SORTED_ROWS = 3072
MOE_PIPE_LAUNCHES = {k: PIPE_MICROBATCHES * v for k, v in MOE_LAUNCHES_PER_STEP.items()}
# the pipelined aux against the mean of the per-microbatch auxes of the
# unpipelined forward on each microbatch alone: the same 128 float32 terms
# summed in another order
MOE_PIPE_AUX_RTOL = 1e-5


def live_lora_trainer(torch, cfg, quantize_base, seed: int):
    """A QLoRA trainer (LoRA r16) whose adapters' ``b`` is drawn from seed
    9 times 0.01 (a live adapter: every leaf has a gradient)."""
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base=quantize_base,
                      seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        for ab in trainer.lora_params["layers"].values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.01)
    return trainer


def pipe_batch(torch, vocab: int, shape=PIPE_SHAPE, seed: int = 12) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, vocab, shape, generator=gen, device="cuda")
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def microbatch_loss(torch, hidden, head, targets, M: int):
    """The mean over M row-block microbatches of each one's chunked cross
    entropy (chunk 1,024): on an unmasked batch, the global mean."""
    from odh_kubeflow_tpu_torch.train.trainer import chunked_cross_entropy

    total = 0.0
    for h, t in zip(hidden.chunk(M), targets.chunk(M)):
        total = total + chunked_cross_entropy(h, head, t, chunk=1024)
    return total / M


class PipelinedGradients:
    """``Trainer.gradients`` with the trainer's model run through the GPipe
    loopback (``forward(loopback_stages=)``): the loss and every adapter
    gradient, the loss the mean of the microbatches' chunked cross
    entropies (plus the router aux for a MoE model)."""

    def __init__(self, trainer, stages: int, microbatches: int):
        self.t, self.S, self.M = trainer, stages, microbatches

    def gradients(self, batch: dict):
        import torch

        from odh_kubeflow_tpu_torch.models import llama
        from odh_kubeflow_tpu_torch.models import moe as moe_lib
        from odh_kubeflow_tpu_torch.train.trainer import _leaves

        t = self.t
        paths, leaves = zip(*_leaves(t.lora_params))
        for x in leaves:
            x.requires_grad_(True)
        model = moe_lib if t.is_moe else llama
        out = model.forward(t.params, batch["tokens"], t.model_cfg, lora=t.lora_params,
                            return_hidden=True, loopback_stages=self.S,
                            pipeline_microbatches=self.M)
        hidden, aux = out if t.is_moe else (out, 0.0)
        loss = microbatch_loss(torch, hidden, llama.lm_head_weight(t.params, t.base_cfg),
                               batch["targets"], self.M) + aux
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(paths, grads))


def grad_rel(got: dict, want: dict) -> dict:
    """``||got - want|| / ||want||`` per leaf path."""
    return {"/".join(p): ((got[p].float() - w.float()).norm()
                          / w.float().norm().clamp_min(1e-30)).item() for p, w in want.items()}


def pipe_runs(torch, trainer, batch, S: int, M: int) -> dict:
    """The three ways to take the 8B QLoRA step's loss and adapter
    gradients on one batch: name -> fn() returning (loss, {path: grad}).
    GPipe and 1F1B run one stage function (``llama.pipeline_args``) and one
    head, the final norm and the chunked cross entropy of one microbatch,
    so they differ only in the order of their work."""
    from odh_kubeflow_tpu_torch.models import llama
    from odh_kubeflow_tpu_torch.ops.norms import rms_norm
    from odh_kubeflow_tpu_torch.ops.rope import rope_angles
    from odh_kubeflow_tpu_torch.parallel import pipeline
    from odh_kubeflow_tpu_torch.train.trainer import _leaves, chunked_cross_entropy

    cfg, params, lora = trainer.model_cfg, trainer.params, trainer.lora_params
    tokens, targets = batch["tokens"], batch["targets"]
    paths, leaves = zip(*_leaves(lora))
    for x in leaves:
        x.requires_grad_(True)

    def unpipelined():
        hidden = llama.forward(params, tokens, cfg, lora=lora, return_hidden=True)
        loss = microbatch_loss(torch, hidden, llama.lm_head_weight(params, cfg), targets, M)
        return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))

    def stack():
        """(embedded tokens, stage function, stage params, per-microbatch
        aux with the targets, head params, head function)."""
        B, T = tokens.shape
        x = params["embed"][tokens].to(cfg.dtype)
        sin, cos = rope_angles(torch.arange(T, device="cuda").expand(B, T), cfg.head_dim,
                               cfg.rope_theta)
        impl = llama.resolved_attention_impl(cfg, tokens.device)
        layer_fn = llama._make_layer_fn(cfg, impl, llama.causal_attention_fn(impl),
                                        cfg.remat_policy)
        stage_fn, stage_params, aux = llama.pipeline_args(
            layer_fn, params["layers"], lora["layers"], sin, cos, None, M)
        aux["targets"] = targets.reshape(M, B // M, T)
        head = {"final_norm": params["final_norm"], "head": llama.lm_head_weight(params, cfg)}

        def head_fn(hp, y, a):
            h = rms_norm(y, hp["final_norm"], cfg.rms_norm_eps)
            return chunked_cross_entropy(h, hp["head"], a["targets"], chunk=1024)

        return x, stage_fn, stage_params, aux, head, head_fn

    def gpipe():
        x, stage_fn, stage_params, aux, head, head_fn = stack()
        y = pipeline.loopback_pipeline_apply(stage_fn, stage_params, x, num_microbatches=M,
                                             num_stages=S, aux=aux)
        total = 0.0
        for m, y_m in enumerate(y.chunk(M)):
            total = total + head_fn(head, y_m, pipeline._aux_at(aux, m))
        loss = total / M
        return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))

    def one_f_one_b():
        x, stage_fn, stage_params, aux, head, head_fn = stack()
        loss, dlayers, _, _ = pipeline.loopback_pipeline_train_1f1b(
            stage_fn, head_fn, stage_params, head, x, num_microbatches=M, num_stages=S, aux=aux)
        grads = dict(_leaves({"layers": dlayers["lora"]}))
        return loss, {p: grads[p] for p in paths}

    return {"unpipelined": unpipelined, "gpipe": gpipe, "1f1b": one_f_one_b}


def timed_runs(torch, runs: dict, counts_of, expected: dict, rounds: int = 3) -> dict:
    """Each run ``rounds`` times in turns: its launches each time (held to
    ``expected``), its peak memory above what was allocated before it, and
    its ms per step (host clock, synchronised by reading the loss) over the
    rounds after the first. Returns name -> record with the last result."""
    out = {name: {"ms": [], "peak_gb": []} for name in runs}
    for r in range(rounds):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = counts_of()
            t0 = time.perf_counter()
            loss, grads = fn()
            loss = float(loss)
            dt = time.perf_counter() - t0
            after = counts_of()
            n = {k: after[k] - before[k] for k in expected[name]}
            if n != expected[name]:
                raise AssertionError(f"{name}: launches {n}, expected {expected[name]}")
            out[name]["peak_gb"].append((torch.cuda.max_memory_allocated() - base) / 2**30)
            if r:
                out[name]["ms"].append(dt * 1e3)
            if not math.isfinite(loss):
                raise AssertionError(f"{name}: loss {loss}")
            out[name].update(loss=loss, grads=grads, launches_per_step=n)
    for rec in out.values():
        rec["ms_per_step"] = statistics.mean(rec["ms"])
        rec["peak_memory_gb_above_weights"] = max(rec.pop("peak_gb"))
    return out


def _union_us(spans) -> float:
    """The time covered by ``(start, end)`` spans that may overlap."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def busy_share(torch, fn, names=()) -> dict:
    """One call of ``fn`` (a run returning (loss, grads)) under
    ``torch.profiler``, the device's activity only (a pipelined step's
    hundreds of thousands of host ops would take a minute to collect): its
    wall ms, the device's summed kernel ms, its busy share (the time in
    which some kernel or copy ran, over the wall time: a side stream's
    copies under remat "attn_offload" overlap the kernels, and count once),
    the same share without copies, and the kernels launched; with
    ``names``, the ms and launches of the kernels whose names hold each."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(fn()[0])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    if not kernels:
        return {"wall_ms": wall_ms, "device_kernel_ms": "not measured"}
    spans = [(e.time_range.start, e.time_range.end, e.name.startswith("Memcpy"))
             for e in prof.events() if str(e.device_type).endswith("CUDA")]
    copy_ms = sum(t for n, (t, _) in kernels.items() if n.startswith("Memcpy")) / 1e3
    out = {"wall_ms": wall_ms, "device_kernel_ms": sum(t for t, _ in kernels.values()) / 1e3,
           "device_busy_share": _union_us((a, b) for a, b, _ in spans) / 1e3 / wall_ms,
           "memcpy_ms": copy_ms,
           "compute_busy_share": _union_us((a, b) for a, b, c in spans if not c) / 1e3 / wall_ms,
           "kernel_launches": sum(c for _, c in kernels.values())}
    for want in names:
        hits = [(t, c) for n, (t, c) in kernels.items() if want in n]
        out[f"{want}_ms"] = sum(t for t, _ in hits) / 1e3
        out[f"{want}_launches"] = sum(c for _, c in hits)
    return out


def pipe_loopback_phase(torch, fa, int4) -> tuple[dict, dict]:
    """Llama-3-8B QLoRA (int4 base, LoRA r16 on wq/wk/wv/wo, remat "attn",
    32 layers) on batch 8 x seq 1024: the unpipelined step, GPipe through
    the loopback driver with autograd, and 1F1B through its loopback driver
    (4 stages of 8 layers, 8 microbatches), on one set of weights and one
    batch. ms per step, peak memory above the weights, exact launches (all
    gated); GPipe against the unpipelined step and 1F1B against GPipe;
    1F1B's peak below GPipe's. Then a 2-layer 8B-width stack pipelined at
    2 stages and 2 microbatches, kernels against plain versions."""
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig

    S, M = PIPE_STAGES, PIPE_MICROBATCHES
    cfg = LlamaConfig.llama3_8b(remat=True, remat_policy="attn")
    t0 = time.perf_counter()
    trainer = live_lora_trainer(torch, cfg, "int4", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = pipe_batch(torch, cfg.vocab_size)
    runs = pipe_runs(torch, trainer, batch, S, M)
    zero_counts(fa, int4)  # the pipelined path's count starts here
    res = timed_runs(torch, runs, lambda: counts(fa, int4), PIPE_LAUNCHES)
    launched = counts(fa, int4)
    # each scale leaf's terms' magnitudes (a GPipe run with the probe), and
    # a profile of each run: outside the count
    _, terms = scale_term_magnitudes(torch, runs["gpipe"])
    profiles = {name: busy_share(torch, runs[name]) for name in ("unpipelined", "gpipe")}
    u, g, o = res["unpipelined"], res["gpipe"], res["1f1b"]
    gpipe_vs = grad_rel(g["grads"], u["grads"])
    ofob_vs = grad_rel(o["grads"], g["grads"])
    ofob_terms = {"/".join(p): ((o["grads"][p].float() - g["grads"][p].float()).norm()
                                / terms[p].float().norm().clamp_min(1e-30)).item()
                  for p in terms if p[-1] == "scale"}
    is_ab = lambda p: not p.endswith("scale")  # noqa: E731
    gates = {
        "gpipe_loss_rel_diff": abs(g["loss"] - u["loss"]) / abs(u["loss"]),
        "gpipe_worst_ab_grad_rel_diff": max(v for p, v in gpipe_vs.items() if is_ab(p)),
        "gpipe_worst_scale_grad_rel_diff": max(v for p, v in gpipe_vs.items() if not is_ab(p)),
        "1f1b_loss_rel_diff": abs(o["loss"] - g["loss"]) / abs(g["loss"]),
        "1f1b_worst_ab_grad_rel_diff": max(v for p, v in ofob_vs.items() if is_ab(p)),
        "1f1b_worst_scale_grad_rel_diff": max(v for p, v in ofob_vs.items() if not is_ab(p)),
        "1f1b_worst_scale_grad_rel_terms": max(ofob_terms.values()),
        "1f1b_leaves_bit_equal": sum(torch.equal(o["grads"][p], x)
                                     for p, x in g["grads"].items()),
    }
    for rec in res.values():
        del rec["grads"]
    record = {
        "phase": "pipe_loopback",
        "config": "llama3_8b QLoRA: int4 base (random weights, seed 0), LoRA r16 on "
                  "wq/wk/wv/wo (b live), remat attn, 32 layers",
        "batch": PIPE_SHAPE[0], "seq": PIPE_SHAPE[1], "stages": S, "microbatches": M,
        "init_s": init_s, "runs": res, "profiles": profiles, "gates": gates,
        "leaves": len(gpipe_vs),
        "tolerances": {"gpipe_loss_rtol": TRAIN_LOSS_RTOL, "gpipe_ab_grad_tol": TRAIN_GRAD_TOL,
                       "1f1b_loss_rtol": PIPE_1F1B_LOSS_RTOL,
                       "1f1b_ab_grad_tol": PIPE_1F1B_GRAD_TOL,
                       "1f1b_scale_grad_tol_of_terms": PIPE_1F1B_SCALE_TERMS_TOL},
        "note": "the loopback runs the stages one after another: no bubble, no p2p",
    }
    bad = []
    if gates["gpipe_loss_rel_diff"] > TRAIN_LOSS_RTOL:
        bad.append("gpipe loss")
    if gates["gpipe_worst_ab_grad_rel_diff"] > TRAIN_GRAD_TOL:
        bad.append("gpipe grads")
    if gates["1f1b_loss_rel_diff"] > PIPE_1F1B_LOSS_RTOL:
        bad.append("1f1b loss")
    if gates["1f1b_worst_ab_grad_rel_diff"] > PIPE_1F1B_GRAD_TOL:
        bad.append("1f1b a/b grads")
    if gates["1f1b_worst_scale_grad_rel_terms"] > PIPE_1F1B_SCALE_TERMS_TOL:
        bad.append("1f1b scale grads")
    if not o["peak_memory_gb_above_weights"] < g["peak_memory_gb_above_weights"]:
        bad.append("1f1b peak not below gpipe's")
    del trainer, runs
    torch.cuda.empty_cache()
    record["parity"] = pipe_parity(torch, fa, int4, moe=False)
    if bad:
        raise AssertionError(f"pipe_loopback: {bad}: {record}")
    return record, launched


def pipe_parity(torch, fa, int4, gm=None, moe: bool = False) -> dict:
    """A 2-layer stack at 8B (or 8x1B) width pipelined through the GPipe
    loopback (``PIPE_PARITY``): the loss and every adapter gradient with the
    kernels against the plain versions, gated as train_parity_on_card's
    (a MoE model on the kernel run's routing, replayed)."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import moe as moe_lib
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig

    p = PIPE_PARITY
    if moe:
        cfg = moe_config()
        cfg = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, num_layers=2))
        trainer = live_lora_trainer(torch, cfg, True, seed=1)
    else:
        cfg = LlamaConfig.llama3_8b(num_layers=2, remat=True, remat_policy="attn")
        trainer = live_lora_trainer(torch, cfg, "int4", seed=1)
    shim = PipelinedGradients(trainer, p["stages"], p["microbatches"])
    batch = pipe_batch(torch, cfg.vocab_size, p["batch"], seed=13)
    out = {"layers": 2, **{k: v for k, v in p.items() if k != "batch"},
           "batch": p["batch"][0], "seq": p["batch"][1]}
    if not moe:
        r = adapter_grad_readings(torch, fa, int4, shim, batch)
        r.pop("grads")
        r["leaves"] = len(r["leaves"])
        out.update(r, grad_tol=TRAIN_GRAD_TOL, loss_rtol=TRAIN_LOSS_RTOL)
        ok = r["loss_rel_diff"] <= TRAIN_LOSS_RTOL and r["worst_gated_rel_diff"] <= TRAIN_GRAD_TOL
    else:
        tape = RoutingTape(torch, moe_lib)
        before = moe_counts(fa, gm)
        k_loss, k_grads = tape.record(lambda: shim.gradients(batch))
        mid = moe_counts(fa, gm)
        p_loss, p_grads = moe_with_plain(fa, gm, lambda: tape.replay(lambda: shim.gradients(batch)))
        if moe_counts(fa, gm) != mid:
            raise AssertionError("the plain run launched a kernel")
        used = [n for n, per in MOE_LAUNCHES_PER_STEP.items() if per]
        if not all(mid[n] > before[n] for n in used):
            raise AssertionError(f"a kernel did not launch: {before} -> {mid}")
        rel = grad_rel(k_grads, p_grads)
        k_loss, p_loss = float(k_loss), float(p_loss)
        out.update(loss_kernels=k_loss, loss_plain=p_loss,
                   loss_rel_diff=abs(k_loss - p_loss) / abs(p_loss),
                   worst_leaf_grad_rel_diff=max(rel.values()), leaves=len(rel),
                   routing_flips=tape.flip_report(), grad_tol=TRAIN_GRAD_TOL,
                   loss_rtol=TRAIN_LOSS_RTOL)
        ok = out["loss_rel_diff"] <= TRAIN_LOSS_RTOL and max(rel.values()) <= TRAIN_GRAD_TOL
    if not ok:
        raise AssertionError(f"pipelined parity ({'moe' if moe else 'llama'}): {out}")
    return out


def moe_pipe_loopback_phase(torch, fa, int4, gm) -> tuple[dict, dict]:
    """Mixtral-8x1B QLoRA (moe_train's config: int8 banks, grouped, remat
    "attn" + pin_expert_acts, 16 layers) on batch 8 x seq 1024: the
    unpipelined step and GPipe through the loopback (4 stages of 4 layers,
    8 microbatches) on one set of weights and one batch. The LM loss of
    GPipe against the unpipelined step's; its aux against the mean of the
    per-microbatch auxes of the unpipelined forward on each microbatch alone
    (JAX's pipelined aux); exact launches; the routings the two steps take
    compared; then a 2-layer 8x1B-width stack, kernels against plain
    versions on the kernel run's routing."""
    from odh_kubeflow_tpu_torch.models import llama
    from odh_kubeflow_tpu_torch.models import moe as moe_lib
    from odh_kubeflow_tpu_torch.train.trainer import _leaves

    S, M = PIPE_STAGES, PIPE_MICROBATCHES
    cfg = moe_config()
    t0 = time.perf_counter()
    trainer = live_lora_trainer(torch, cfg, True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = pipe_batch(torch, cfg.vocab_size)
    params, lora = trainer.params, trainer.lora_params
    tokens, targets = batch["tokens"], batch["targets"]
    paths, leaves = zip(*_leaves(lora))
    for x in leaves:
        x.requires_grad_(True)
    lm_aux = {}

    def step(name, **pipe):
        def fn():
            hidden, aux = moe_lib.forward(params, tokens, cfg, lora=lora, return_hidden=True,
                                          **pipe)
            lm = microbatch_loss(torch, hidden, llama.lm_head_weight(params, cfg.base), targets, M)
            grads = torch.autograd.grad(lm + aux, leaves)
            lm_aux[name] = (lm.item(), aux.item())
            return (lm + aux).detach(), dict(zip(paths, grads))

        return fn

    runs = {"unpipelined": step("unpipelined"),
            "gpipe": step("gpipe", loopback_stages=S, pipeline_microbatches=M)}
    zero_moe_counts(fa, int4, gm)  # the pipelined MoE path's count starts here
    res = timed_runs(torch, runs, lambda: moe_counts(fa, gm),
                     {"unpipelined": MOE_LAUNCHES_PER_STEP, "gpipe": MOE_PIPE_LAUNCHES})
    launched = moe_counts(fa, gm)
    if int4.launches:
        raise AssertionError(f"the MoE path launched {int4.launches} int4 dequants")
    profiles = {name: busy_share(torch, fn) for name, fn in runs.items()}
    # references, outside the count: each microbatch's own aux, and both
    # steps' routings (no-grad forwards, recorded in call order)
    with torch.no_grad():
        per_mb = [float(moe_lib.forward(params, tokens[m : m + 1], cfg, lora=lora,
                                        return_hidden=True)[1]) for m in range(M)]
        tapes = {}
        for name, pipe in (("unpipelined", {}),
                           ("gpipe", dict(loopback_stages=S, pipeline_microbatches=M))):
            tapes[name] = RoutingTape(torch, moe_lib)
            tapes[name].record(lambda pipe=pipe: moe_lib.forward(
                params, tokens, cfg, lora=lora, return_hidden=True, **pipe))
    # the pipelined routings in tick order: stage s runs its layers on
    # microbatch m at tick s + m; regroup them by layer, microbatches in order
    per_stage = cfg.base.num_layers // S
    order = [(s * per_stage + j, t - s) for t in range(M + S - 1) for s in range(S)
             if 0 <= t - s < M for j in range(per_stage)]
    by_layer = {}
    for (layer, m), ids in sorted(zip(order, tapes["gpipe"].ids)):
        by_layer.setdefault(layer, []).append(ids)
    regrouped = RoutingTape(torch, moe_lib)
    regrouped.ids = [torch.cat(by_layer[i]) for i in range(cfg.base.num_layers)]
    flips = tapes["unpipelined"].differs_from(regrouped)
    (u_lm, u_aux), (g_lm, g_aux) = lm_aux["unpipelined"], lm_aux["gpipe"]
    want_aux = sum(per_mb) / M
    u, g = res["unpipelined"], res["gpipe"]
    rel = grad_rel(g.pop("grads"), u.pop("grads"))
    gates = {"lm_loss_rel_diff": abs(g_lm - u_lm) / abs(u_lm),
             "aux_rel_diff_vs_per_microbatch_mean": abs(g_aux - want_aux) / abs(want_aux)}
    record = {
        "phase": "moe_pipe_loopback",
        "config": "mixtral_8x1b QLoRA: int8 banks (random weights, seed 0), dispatch grouped, "
                  "remat attn + pin_expert_acts, LoRA r16 on wq/wk/wv/wo (b live), 16 layers",
        "batch": PIPE_SHAPE[0], "seq": PIPE_SHAPE[1], "stages": S, "microbatches": M,
        "sorted_rows_per_call": MOE_PIPE_SORTED_ROWS, "init_s": init_s, "runs": res,
        "profiles": profiles,
        "lm_loss": {"unpipelined": u_lm, "gpipe": g_lm},
        "aux": {"unpipelined_whole_batch": u_aux, "gpipe": g_aux,
                "per_microbatch": per_mb, "per_microbatch_mean": want_aux},
        "gates": gates,
        "tolerances": {"lm_loss_rtol": TRAIN_LOSS_RTOL, "aux_rtol": MOE_PIPE_AUX_RTOL},
        # reported, not gated: the two steps' auxes differ by design
        "worst_adapter_grad_rel_diff_vs_unpipelined": max(rel.values()),
        "routing_flips_gpipe_vs_unpipelined": {
            "routings": len(flips), "flipped_tokens": sum(f["flipped"] for f in flips),
            "largest_margin": max((f["largest_margin"] for f in flips
                                   if f["largest_margin"] is not None), default=None)},
        "note": "the loopback runs the stages one after another: no bubble, no p2p",
    }
    bad = []
    if gates["lm_loss_rel_diff"] > TRAIN_LOSS_RTOL:
        bad.append("lm loss")
    if gates["aux_rel_diff_vs_per_microbatch_mean"] > MOE_PIPE_AUX_RTOL:
        bad.append("aux")
    del trainer, runs, tapes, regrouped
    torch.cuda.empty_cache()
    record["parity"] = pipe_parity(torch, fa, int4, gm, moe=True)
    if bad:
        raise AssertionError(f"moe_pipe_loopback: {bad}: {record}")
    return record, launched


KERNEL_KINDS = (  # (kind, substrings of the device kernel's name; first match)
    ("tgmm (tgmm.cu)", ("tgmm_kernel",)),
    ("grouped gemm (gmm.cu)", ("gmm_kernel",)),
    ("int8 trans prescale pass (gmm.cu)", ("prescale_kernel",)),
    ("swiglu fwd (swiglu_gmm.cu)", ("swiglu_fwd_kernel",)),
    ("swiglu bwd (swiglu_gmm.cu)", ("swiglu_bwd_kernel",)),
    ("flash (flash_fwd.cu, flash_bwd.cu)", ("flash_",)),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "Gemm", "cutlass", "sm90_xmma")),
)


def moe_train_profile_phase(torch, trainer, phase="moe_train_profile") -> dict:
    """One MoE training step under ``torch.profiler``: device ms by kernel
    kind, the busy share, and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.make_fake_batch(*MOE_TRAIN_SHAPE, seed=3)
    float(trainer.train_step(batch)["loss"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.train_step(batch)["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(t for t, _ in kernels.values()) / 1e3
    kinds = {}
    for k, (t, c) in kernels.items():
        kind = next((n for n, keys in KERNEL_KINDS if any(s in k for s in keys)),
                    "other (elementwise, norms, casts, loss, routing)")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + t / 1e3, n + c)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    # the PyTorch ops that own the device time (a custom op counts the
    # kernels it launches; an aten op its own elementwise kernels)
    ops = []
    for e in prof.key_averages():
        own = getattr(e, "self_device_time_total", None)
        if own is None:
            own = getattr(e, "self_cuda_time_total", 0.0)
        if own > 0 and str(e.device_type).endswith("CPU"):
            ops.append({"op": e.key, "self_device_ms": own / 1e3, "calls": e.count})
    ops.sort(key=lambda o: -o["self_device_ms"])
    return {
        "phase": phase,
        "top_ops": ops[:15],
        "profiled_step_wall_ms": wall_ms,
        "device_kernel_ms": device_ms if kernels else "not measured",
        "device_busy_share": device_ms / wall_ms if kernels else "not measured",
        "by_kind": {k: {"ms": ms, "launches": n} for k, (ms, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [{"kernel": k, "ms": t / 1e3, "launches": c} for k, (t, c) in top],
    }


def moe_train_parity_phase(torch, fa, int4, gm) -> dict:
    """A 2-layer model at 8x1B width, int8 banks, one packed batch: the
    loss and every adapter gradient with the kernels against the plain
    versions."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import moe as moe_lib
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
    from odh_kubeflow_tpu_torch.train.data import pack_documents, prefetch_to_device

    B, S = MOE_TRAIN_SHAPE
    cfg = moe_config()
    cfg = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, num_layers=2))
    trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base=True, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():  # a live adapter: b != 0, so every leaf has a gradient
        for ab in trainer.lora_params["layers"].values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.01)
    rng = torch.Generator().manual_seed(10)
    docs = [torch.randint(1, cfg.vocab_size, (int(n),), generator=rng).tolist()
            for n in torch.randint(100, 1500, (24,), generator=rng)]
    batch = next(prefetch_to_device(pack_documents(docs, B, S)))
    offsets = []
    route = moe_lib.route_sorted

    def spy(*a, **k):
        out = route(*a, **k)
        offsets.append(out[2].tolist())
        return out

    moe_lib.route_sorted = spy
    try:
        before = moe_counts(fa, gm)
        k_loss, k_grads = trainer.gradients(batch)
        mid = moe_counts(fa, gm)
        p_loss, p_grads = moe_with_plain(fa, gm, lambda: trainer.gradients(batch))
        after = moe_counts(fa, gm)
    finally:
        moe_lib.route_sorted = route
    used = [n for n, per_step in MOE_LAUNCHES_PER_STEP.items() if per_step]
    if not all(mid[n] > before[n] for n in used):
        raise AssertionError(f"a kernel did not launch: {before} -> {mid}")
    if after != mid:
        raise AssertionError("the plain run launched a kernel")
    k_loss, p_loss = float(k_loss), float(p_loss)
    worst = 0.0
    for path, pg in p_grads.items():
        kg = k_grads[path]
        if not bool(torch.isfinite(kg).all()):
            raise AssertionError(f"non-finite gradient {path}")
        worst = max(worst, ((kg.float() - pg.float()).norm()
                            / pg.float().norm().clamp_min(1e-30)).item())
    n = len(offsets) // 2
    out = {"phase": "moe_train_parity_on_card", "layers": 2, "batch": B, "seq": S,
           "packed_segments": int(batch["segment_ids"].max()),
           "padding_tokens": int((batch["segment_ids"] == 0).sum()),
           "grad_tol": f"||kernel - plain|| / ||plain|| <= {TRAIN_GRAD_TOL} per leaf",
           "loss_rtol": TRAIN_LOSS_RTOL, "loss_kernels": k_loss, "loss_plain": p_loss,
           "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
           "worst_leaf_grad_rel_diff": worst, "leaves": len(p_grads),
           "group_offsets_equal": offsets[:n] == offsets[n:]}
    if not (math.isfinite(k_loss) and out["loss_rel_diff"] <= TRAIN_LOSS_RTOL
            and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"MoE train parity: {out}")
    return out


# ---------------------------------------------------------------------------
# MoE serving and the MoE full fine-tune (slice 4): the bf16-bank grouped
# matmul and the expert weight gradient


def tgmm_library(torch, a, d, offs, E):
    """The yardstick of one ``tgmm``: ``torch._grouped_mm`` in its 2-D x
    2-D form (groups split the contraction), where the card's torch takes
    it, else a per-expert ``torch.mm`` loop; (ms, label, note)."""
    ends = offs[1:].contiguous()
    label = "torch._grouped_mm 2-D x 2-D (a^T strided)"
    ms, grouped_note = library_ms(torch, lambda i: torch._grouped_mm(a.t(), d, offs=ends), label)
    if ms is not None:
        return ms, label, None
    bounds = offs.tolist()
    out = torch.empty((E, a.shape[1], d.shape[1]), dtype=d.dtype, device=d.device)

    def loop(i):
        for e in range(E):
            s, t = bounds[e], bounds[e + 1]
            torch.mm(a[s:t].t(), d[s:t], out=out[e])

    ms, note = library_ms(torch, loop, "per-expert torch.mm loop")
    return ms, "per-expert torch.mm loop, bf16 (cuBLAS)", "; ".join(
        n for n in (grouped_note, note) if n)


def moe_bf16_kernels_phase(torch, gm, bw: float, peak: float) -> list[dict]:
    """The bf16-bank ``gmm`` (``_gmm_a_kernel`` and the unscaled
    ``_gmm_b_kernel``) at the serving prefill (M 3,072) and training (M
    17,408) shapes in both orientations, and ``tgmm`` at the training
    shape in both bank layouts, against their plain versions on four
    routings each, per 128-row tile (``tgmm``: of its ``[E·K, N]`` view),
    into NaN-filled buffers; planted faults the check must reject; times
    at the balanced routing."""
    E, D, F = 8, 2048, 8192
    gen = torch.Generator(device="cuda").manual_seed(78)
    routings = {MOE_M: moe_routings(torch), MOE_SERVE_M: moe_routings(torch, *MOE_SERVE_BATCH)}
    checks = TileChecks(gm, ("gmm_bf16_k2048", "gmm_bf16_k8192", "tgmm"))

    def bf16(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def timed(row, flops, nbytes, fn, plain):
        row.update(flops=flops, bytes=nbytes, ms=time_ms(torch, fn, iters=10),
                   plain_ms=time_ms(torch, plain, iters=2, reps=3),
                   bound_ms=max(flops / peak, nbytes / bw) * 1e3,
                   bound_by="operations" if flops / peak > nbytes / bw else "bytes")
        row["tflops_per_s"] = flops / row["ms"] / 1e9
        return row

    # (row, shape label, M, K, N, trans); each row's first shape is its main one
    gmm_shapes = (
        ("gmm_bf16_k2048", "gate/up fwd", MOE_M, D, F, False),
        ("gmm_bf16_k2048", "down dlhs (trans)", MOE_M, D, F, True),
        ("gmm_bf16_k2048", "serving prefill gate/up", MOE_SERVE_M, D, F, False),
        ("gmm_bf16_k2048", "down dlhs (trans) at the prefill's M", MOE_SERVE_M, D, F, True),
        ("gmm_bf16_k8192", "down fwd", MOE_M, F, D, False),
        ("gmm_bf16_k8192", "gate/up dlhs (trans)", MOE_M, F, D, True),
        ("gmm_bf16_k8192", "serving prefill down", MOE_SERVE_M, F, D, False),
        ("gmm_bf16_k8192", "gate/up dlhs (trans) at the prefill's M", MOE_SERVE_M, F, D, True),
    )
    for name, label, M, K, N, trans in gmm_shapes:
        lhs = bf16(M, K)
        w = bf16(E, N, K, scale=K**-0.5) if trans else bf16(E, K, N, scale=K**-0.5)
        for rname, offs in routings[M].items():
            poison(torch, M, N)
            got = gm.gmm(lhs, w, offs, trans)
            want = gm.gmm_reference(lhs, w, offs, trans)
            torch.cuda.synchronize()
            rel = checks.check(name, got, want, f"{label} M {M} {rname}")
            if rname == "balanced":
                short = lhs.clone()
                short[:, -64:] = 0
                checks.plant(name, f"{label} M {M}", want, {
                    "a tile given the wrong expert": gm.gmm_reference(
                        lhs, w, wrong_expert(offs), trans),
                    "the last K chunk of 64 skipped": gm.gmm_reference(short, w, offs, trans),
                })
                del short
                row = timed({"shape": label, "M": M, "K": K, "N": N, "trans": trans,
                             "tile_rel_err": rel}, *gmm_work(M, K, N, E, "gmm_bf16"),
                            lambda i: gm.gmm(lhs, w, offs, trans),
                            lambda i: gm.gmm_reference(lhs, w, offs, trans))
                rhs = w.transpose(1, 2) if trans else w
                ends = offs[1:].contiguous()
                row["library_ms"], row["library_note"] = library_ms(
                    torch, lambda i: torch._grouped_mm(lhs, rhs, offs=ends))
                checks.stats[name]["shapes"].append(row)
            del got, want
        del lhs, w
        torch.cuda.empty_cache()

    # tgmm: the gate/up gradient [8, 2048, 8192] from (xs, dg) and the down
    # gradient [8, 8192, 2048] from (h, dy)
    M = MOE_M
    for label, K, N in (("[8, 2048, 8192] from (xs, dg)", D, F),
                        ("[8, 8192, 2048] from (h, dy)", F, D)):
        a, d = bf16(M, K), bf16(M, N)
        for rname, offs in routings[M].items():
            poison(torch, E, K, N)
            got = gm.tgmm(a, d, offs, E)
            want = gm.tgmm_reference(a, d, offs, E)
            torch.cuda.synchronize()
            rel = checks.check("tgmm", got.view(E * K, N), want.view(E * K, N),
                               f"{label} {rname}")
            if rname in ("balanced", "one_expert"):
                # every element written once by one block, no atomics: two
                # launches agree bit for bit
                if not torch.equal(got, gm.tgmm(a, d, offs, E)):
                    raise AssertionError(f"tgmm {label} {rname}: two launches differ")
                checks.stats["tgmm"].setdefault("bitwise_equal_launches", []).append(
                    f"{label} {rname}")
            bounds = offs.tolist()
            if rname == "balanced":
                short = a.clone()
                short[bounds[1] - 64 : bounds[1]] = 0  # expert 0's last 64-row chunk
                checks.plant("tgmm", label, want.view(E * K, N), {
                    "a tile given the wrong expert":
                        gm.tgmm_reference(a, d, wrong_expert(offs), E).view(E * K, N),
                    "a group's last 64-row chunk skipped":
                        gm.tgmm_reference(short, d, offs, E).view(E * K, N),
                })
                del short
                row = timed({"shape": label, "M": M, "K": K, "N": N, "tile_rel_err": rel},
                            *gmm_work(M, K, N, E, "tgmm"), lambda i: gm.tgmm(a, d, offs, E),
                            lambda i: gm.tgmm_reference(a, d, offs, E))
                (row["library_ms"], row["library"],
                 row["library_note"]) = tgmm_library(torch, a, d, offs, E)
                checks.stats["tgmm"]["shapes"].append(row)
            if rname == "one_expert":  # skewed: 1 of 8 experts' blocks walk all M rows
                row["one_expert_ms"] = time_ms(torch, lambda i: gm.tgmm(a, d, offs, E), iters=10)
            if rname == "two_empty":
                empty = next(e for e in range(E) if bounds[e + 1] == bounds[e])
                stale = want.clone()
                stale[empty] = want[0]  # what a reused buffer could still hold
                checks.plant("tgmm", label, want.view(E * K, N), {
                    "an empty group left unwritten": stale.view(E * K, N)})
                del stale
            del got, want
        del a, d
        torch.cuda.empty_cache()

    tpu = {
        "gmm_bf16_k2048": (201, "_gmm_a_kernel (pallas_call at odh_kubeflow_tpu/ops/"
                                "pallas_grouped_matmul.py:287)", "csrc/gmm.cu"),
        "gmm_bf16_k8192": (307, "_gmm_b_kernel, unscaled (pallas_call at odh_kubeflow_tpu/ops/"
                                "pallas_grouped_matmul.py:447)", "csrc/gmm.cu"),
        "tgmm": (474, "_tgmm_kernel (pallas_call at odh_kubeflow_tpu/ops/"
                      "pallas_grouped_matmul.py:520)", "csrc/tgmm.cu"),
    }
    rows = []
    for name, st in checks.stats.items():
        main = st["shapes"][0]
        line, fn, src = tpu[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "odh_kubeflow_tpu_torch/" + src,
            "replaces": f"odh_kubeflow_tpu/ops/pallas_grouped_matmul.py:{line}",
            "tpu_kernel": fn,
            "max_abs_err": st["max_abs_err"],
            "tile_rel_err": st["tile_rel_err"],
            "tolerance": f"||kernel - plain|| / ||plain|| <= {gm.TILE_RTOL} in every 128-row "
                         "tile" + (" of the [E*K, N] view" if name == "tgmm" else "")
                         + ", bf16, on 4 routings (balanced, one expert, two empty, large tail)",
            "planted_fault": st["planted_fault"],
            "unit": f"one launch at the Mixtral-8x1B training shape ({main['shape']}, "
                    f"M {main['M']}, K {main['K']}, N {main['N']}, balanced routing)",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library": main.get("library", "torch._grouped_mm on the bf16 bank"),
            "shapes": st["shapes"],
        })
        if "bitwise_equal_launches" in st:
            rows[-1]["bitwise_equal_launches"] = st["bitwise_equal_launches"]
    return rows


def moe_serve_config():
    from odh_kubeflow_tpu_torch.models.moe import MoeConfig

    return MoeConfig.mixtral_8x1b(dispatch="grouped")


def moe_serve_requests(torch, V: int) -> dict:
    """{name: prompts}: 4 ragged prompts (bucket [4, 256], grouped), one of
    700 tokens (bucket [1, 1024], grouped), one of 32 (bucket [1, 64]:
    ragged, no kernel)."""
    gen = torch.Generator().manual_seed(17)

    def prompt(n):
        return torch.randint(1, V, (n,), generator=gen).tolist()

    return {"ragged4": [prompt(n) for n in (17, 64, 200, 256)], "long": [prompt(700)],
            "short": [prompt(32)]}


def moe_serve_phase(torch, fa, int4, gm, cfg, params) -> tuple[dict, dict]:
    """Serve Mixtral-8x1B over HTTP; the exact kernel launches of every
    request. Returns the phase record and the served greedy completions."""
    from odh_kubeflow_tpu_torch.models.serve import CompletionService, serve

    V = cfg.vocab_size
    prompts = moe_serve_requests(torch, V)
    grouped = {"ragged4": True, "long": True, "short": False}
    requests = [("warmup", "ragged4", 1)]
    for name in prompts:
        requests += [(f"{name}_first_token", name, 1), (name, name, 32)]
    service = CompletionService(params, cfg, device="cuda")
    httpd = serve(service, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, served = {}, {}
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"/healthz answered {r.status}")
        torch.cuda.reset_peak_memory_stats()
        zero_moe_counts(fa, int4, gm)  # the MoE serving path's count starts here
        for name, key, n in requests:
            before = moe_counts(fa, gm)
            t0 = time.perf_counter()
            code, out = post(base, {"prompt": prompts[key], "max_tokens": n})
            dt = time.perf_counter() - t0
            if code != 200:
                raise AssertionError(f"{name}: HTTP {code}: {out}")
            comps = out["completions"]
            if len(comps) != len(prompts[key]) or any(
                    len(c) != n or not all(0 <= t < V for t in c) for c in comps):
                raise AssertionError(f"{name}: bad completions {comps}")
            after = moe_counts(fa, gm)
            launched = {k: after[k] - before[k] for k in after}
            want = {k: MOE_SERVE_PREFILL.get(k, 0) if grouped[key] else 0 for k in after}
            if launched != want or int4.launches:
                raise AssertionError(f"{name}: launches {launched} (int4 {int4.launches}), "
                                     f"expected {want}: one grouped prefill, none per decode step")
            results[name] = {"seconds": dt, "gmm_launches": launched["gmm"],
                             "padded_shape": out["usage"]["padded_shape"],
                             "completion_tokens": out["usage"]["completion_tokens"]}
            if n == 32:
                served[key] = comps
        launched = moe_counts(fa, gm)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
    finally:
        httpd.shutdown()
        httpd.server_close()

    def decode(name, rows):
        first = results[f"{name}_first_token"]["seconds"]
        step = (results[name]["seconds"] - first) / 31
        return {"ttft_s": first, "request_s": results[name]["seconds"],
                "decode_step_ms": step * 1e3, "decode_tok_s": rows / step}

    b = cfg.base
    record = {
        "phase": "moe_serve",
        "config": f"mixtral_8x1b: D {b.hidden_size}, F {b.intermediate_size}, {b.num_layers} "
                  f"layers, {b.num_heads}/{b.num_kv_heads} heads, hd {b.head_dim}, V "
                  f"{b.vocab_size}, E {cfg.num_experts}, top-{cfg.num_experts_per_tok}; bf16 "
                  "weights (random, seed 0), dispatch grouped",
        "launches": launched, "prefill_launches": MOE_SERVE_PREFILL, "requests": results,
        "ragged4": decode("ragged4", 4), "long": decode("long", 1), "short": decode("short", 1),
        "peak_memory_gb": peak_gb,
    }
    return record, served


class RoutingTape:
    """Routing is discontinuous: a bf16 sum taken in another order flips a
    near-tied token's experts, that token's hidden state then moves by
    O(1), and through attention and later layers so do others'
    (``moe_serve_parity_on_card`` reports it as ``free_routing``: flips at
    far larger margins than any rounding explains, deep in the stack). So
    a kernel run and a plain run are compared with the same routing:
    ``record`` keeps every routing's top-k expert ids (the forward's, and a
    remat recompute's, in call order); ``replay`` hands them to the second
    run in the same order. The second run's router probabilities, its
    routing weights, aux loss and router gradient, still come from its own
    logits. ``flips`` lists, per replayed routing, the live tokens whose
    own top-k set would have differed, with their margins (the smaller of
    the 1st/2nd and 2nd/3rd router logit gaps)."""

    def __init__(self, torch, moe_lib):
        self.torch, self.moe = torch, moe_lib
        self.ids, self.masks, self.gaps, self.flips = [], [], [], []

    def _run(self, stats, fn):
        kept = self.moe._routing_stats
        self.moe._routing_stats = stats
        try:
            return fn()
        finally:
            self.moe._routing_stats = kept

    def record(self, fn):
        real = self.moe._routing_stats

        def stats(logits, cfg, token_mask=None):
            out = real(logits, cfg, token_mask)
            self.ids.append(out[1])
            self.masks.append(token_mask)
            self.gaps.append(self._gap(logits, cfg.num_experts_per_tok))
            return out

        self.ids, self.masks, self.gaps = [], [], []
        return self._run(stats, fn)

    @staticmethod
    def _gap(logits, k: int):
        """Per token, the smaller of the 1st/2nd and 2nd/3rd logit gaps."""
        z = logits.detach().float().sort(-1, descending=True).values
        return (z[..., :k] - z[..., 1 : k + 1]).min(-1).values

    def differs_from(self, other: "RoutingTape") -> list[dict]:
        """Per routing of two recorded runs, the live tokens whose top-k
        sets differ and the largest of their margins (this run's)."""
        out = []
        for a, b, mask, gap in zip(self.ids, other.ids, self.masks, self.gaps):
            diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
            if mask is not None:
                diff = diff & mask
            out.append({"flipped": int(diff.sum()),
                        "largest_margin": float(gap[diff].max()) if bool(diff.any()) else None})
        return out

    def replay(self, fn):
        torch = self.torch
        tape = list(self.ids)
        self.flips = []

        def stats(logits, cfg, token_mask=None):
            idx = tape.pop(0)
            probs = torch.softmax(logits, dim=-1)
            own = probs.topk(cfg.num_experts_per_tok, dim=-1).indices
            flip = (own.sort(-1).values != idx.sort(-1).values).any(-1)
            if token_mask is not None:
                flip = flip & token_mask
            gap = self._gap(logits, cfg.num_experts_per_tok)
            self.flips.append(gap[flip].tolist())
            # moe._routing_stats with the recorded ids in place of its top-k
            top_p = probs.gather(-1, idx)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
            first = torch.nn.functional.one_hot(idx[..., 0], logits.shape[-1]).float()
            if token_mask is None:
                return top_p, idx, first.mean((0, 1)), probs.mean((0, 1))
            m = token_mask.float()[..., None]
            denom = m.sum().clamp_min(1.0)
            return top_p, idx, (first * m).sum((0, 1)) / denom, (probs * m).sum((0, 1)) / denom

        out = self._run(stats, fn)
        if tape:
            raise AssertionError(f"the replayed run routed {len(tape)} times fewer")
        return out

    def flip_report(self) -> dict:
        margins = [m for call in self.flips for m in call]
        return {"routings": len(self.flips), "flipped_tokens": len(margins),
                "routings_with_flips": sum(1 for c in self.flips if c),
                "largest_flip_margin": max(margins, default=None)}


def moe_serve_parity_phase(torch, fa, gm, cfg, params, served) -> dict:
    """The served requests again with the plain versions in the kernels'
    place and the kernel run's routing (``RoutingTape``): prefill logits
    per row, the flips the plain run's own routing would have made, and
    greedy tokens."""
    import importlib

    from odh_kubeflow_tpu_torch.models import moe as moe_lib
    from odh_kubeflow_tpu_torch.models.generate import init_cache
    from odh_kubeflow_tpu_torch.models.serve import CompletionService, _bucket

    gen_mod = importlib.import_module("odh_kubeflow_tpu_torch.models.generate")
    prompts = moe_serve_requests(torch, cfg.vocab_size)
    service = CompletionService(params, cfg, device="cuda")
    tape = RoutingTape(torch, moe_lib)
    out = {"phase": "moe_serve_parity_on_card", "logits_rtol": SERVE_LOGITS_RTOL,
           "greedy_flip_margin": GREEDY_FLIP_MARGIN}
    for name, rows in prompts.items():
        # the prefill as the service pads it
        B = _bucket(len(rows), service.batch_buckets)
        S = _bucket(max(map(len, rows)), service.prompt_buckets)
        lens = torch.tensor([len(r) for r in rows] + [0] * (B - len(rows)), device="cuda")
        toks = torch.tensor([r + [0] * (S - len(r)) for r in rows] + [[0] * S] * (B - len(rows)),
                            device="cuda")
        kv = torch.arange(S, device="cuda")[None, :] < lens[:, None]

        def prefill():
            cache = init_cache(cfg.base, B, S, device="cuda")
            with torch.no_grad():
                return moe_lib.forward_with_cache(
                    params, toks, cfg, cache, 0, positions=torch.arange(S, device="cuda").expand(B, S),
                    kv_mask=kv, token_mask=kv)[0]

        before = gm.gmm_launches
        lk = tape.record(prefill)
        launched = gm.gmm_launches - before
        if launched != (MOE_SERVE_PREFILL["gmm"] if B * S * cfg.num_experts_per_tok >= 2048
                        else 0):
            raise AssertionError(f"{name}: the kernel prefill launched {launched} gmm")
        lp = moe_with_plain(fa, gm, lambda: tape.replay(prefill))
        prefill_flips = tape.flip_report()
        # for the record: the plain run on its own routing
        free = RoutingTape(torch, moe_lib)
        lf = moe_with_plain(fa, gm, lambda: free.record(prefill))
        if gm.gmm_launches - before != launched:
            raise AssertionError(f"{name}: the plain prefill launched a kernel")

        def rel_rows(a, b):
            return [((a[i, : lens[i]] - b[i, : lens[i]]).norm() / b[i, : lens[i]].norm()).item()
                    for i in range(len(rows))]

        if not all(bool(torch.isfinite(lk[b, : lens[b]]).all()) for b in range(len(rows))):
            raise AssertionError(f"{name}: non-finite prefill logits")
        row_rel, free_rel = rel_rows(lk, lp), rel_rows(lk, lf)
        free_flips = free.differs_from(tape)
        del lk, lp, lf
        if not max(row_rel) <= SERVE_LOGITS_RTOL:
            raise AssertionError(f"{name}: prefill logits rows {row_rel} > {SERVE_LOGITS_RTOL}")

        # greedy decoding through the service, each step's top-2 logit margin
        def complete(margins):
            real = gen_mod.sample_logits

            def spy(logits, generator, **kw):
                top = logits.topk(2, dim=-1).values
                margins.append((top[:, 0] - top[:, 1]).cpu())
                return real(logits, generator, **kw)

            gen_mod.sample_logits = spy
            try:
                return service.complete(rows, max_tokens=32)["completions"]
            finally:
                gen_mod.sample_logits = real

        mk, mp = [], []
        toks_k = tape.record(lambda: complete(mk))
        toks_p = moe_with_plain(fa, gm, lambda: tape.replay(lambda: complete(mp)))
        if toks_k != served[name]:
            raise AssertionError(f"{name}: a second kernel run gave other tokens than served")
        flips = []
        for b, (tk, tp) in enumerate(zip(toks_k, toks_p)):
            i = next((j for j, (x, y) in enumerate(zip(tk, tp)) if x != y), None)
            if i is None:
                continue
            margin = min(float(mk[i][b]), float(mp[i][b]))
            if margin >= GREEDY_FLIP_MARGIN:
                raise AssertionError(f"{name} row {b}: greedy tokens differ at step {i} with "
                                     f"a top-2 margin of {margin}")
            flips.append({"row": b, "step": i, "top2_margin": margin})
        out[name] = {"padded_shape": [B, S], "prefill_logits_row_rel_err": row_rel,
                     "prefill_routing_flips": prefill_flips,
                     "free_routing": {"prefill_logits_row_rel_err": free_rel,
                                      "flips_by_layer": free_flips},
                     "greedy_tokens_identical": toks_k == toks_p, "greedy_flips": flips,
                     "min_greedy_top2_margin": min(float(m.min()) for m in mp)}
    return out


def moe_full_config(num_layers: int = MOE_FULL_LAYERS):
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.moe import MoeConfig

    return MoeConfig.mixtral_8x1b(
        base=LlamaConfig.llama3_1b(remat_policy="attn", num_layers=num_layers),
        dispatch="grouped",
    )


def bank_sums(torch, params) -> dict:
    """Per bank, the f32 sum of each [layer, expert] matrix: a change shows
    that the expert's weights moved."""
    from odh_kubeflow_tpu_torch.models.moe import BANKS

    with torch.no_grad():
        return {n: torch.stack([params["layers"][n][i].float().sum(dim=(1, 2))
                                for i in range(params["layers"][n].shape[0])]) for n in BANKS}


def moe_full_train_phase(torch, fa, int4, gm, peak: float) -> tuple[dict, object]:
    """The Mixtral-8x1B full fine-tune step through ``Trainer.benchmark``."""
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    B, S = MOE_TRAIN_SHAPE
    cfg = moe_full_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, TrainConfig(), None, precompile_batch=(B, S))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 2**30
    start = bank_sums(torch, trainer.params)
    steps, warmup = 3, 1
    torch.cuda.reset_peak_memory_stats()
    zero_moe_counts(fa, int4, gm)  # the MoE full fine-tune's count starts here
    bench = trainer.benchmark(B, S, steps=steps, warmup=warmup)
    launched = moe_counts(fa, gm)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    expected = {k: n * (steps + warmup) for k, n in MOE_FULL_LAUNCHES_PER_STEP.items()}
    if launched != expected or int4.launches:
        raise AssertionError(f"MoE full fine-tune launches {launched} (int4 {int4.launches}), "
                             f"expected {expected}")
    metrics = trainer.train_step(trainer.make_fake_batch(B, S, seed=1))
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"loss {loss}, grad_norm {gnorm}")
    if not math.isfinite(bench["loss"]):
        raise AssertionError(f"benchmark loss {bench['loss']}")
    end = bank_sums(torch, trainer.params)
    still = {n: int((end[n] == start[n]).sum()) for n in end}
    if any(still.values()):
        raise AssertionError(f"[layer, expert] banks that did not move: {still}")
    b = cfg.base
    record = {
        "phase": "moe_full_train",
        "config": f"mixtral_8x1b full fine-tune: D {b.hidden_size}, F {b.intermediate_size}, "
                  f"{b.num_layers} layers (of 16), {b.num_heads}/{b.num_kv_heads} heads, hd "
                  f"{b.head_dim}, V {b.vocab_size}, E {cfg.num_experts}, "
                  f"top-{cfg.num_experts_per_tok}; bf16 params, grads and Adam moments "
                  "(random weights, seed 0), dispatch grouped, remat attn, every leaf trains",
        "reduced": "16 -> 8 layers: at 16 the 6.87e9 bf16 params, their grads and Adam's "
                   "two moments hold 51.2 GiB before the optimizer's temporaries",
        "batch": B, "seq": S, "steps": steps, "warmup": warmup, "sorted_rows_M": MOE_M,
        "params": sum(t.numel() for t in trainer.params["layers"].values())
        + trainer.params["embed"].numel() + trainer.params["final_norm"].numel(),
        "init_s": init_s, "resident_gb": resident_gb, "peak_memory_gb": peak_gb,
        "step_time_s": bench["step_time_s"], "tokens_per_s": bench["tokens_per_s"],
        "model_flops_per_step": bench["model_flops_per_step"],
        "strict_mfu": bench["flops_per_s"] / peak, "peak_flops": peak,
        "loss_benchmark": bench["loss"], "loss_after": loss, "grad_norm_after": gnorm,
        "launches": launched, "launches_per_step": MOE_FULL_LAUNCHES_PER_STEP,
        "banks_moved": {n: int(end[n].numel()) for n in end},
    }
    return record, trainer


def moe_full_train_parity_phase(torch, fa, int4, gm) -> dict:
    """A 2-layer model at 8x1B width, every leaf trainable, one packed
    batch: the loss and every gradient, banks included, with the kernels
    against the plain versions, both on the kernel run's routing
    (``RoutingTape``; the plain run's own flips are reported)."""
    from odh_kubeflow_tpu_torch.models import moe as moe_lib
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
    from odh_kubeflow_tpu_torch.train.data import pack_documents, prefetch_to_device

    B, S = MOE_TRAIN_SHAPE
    cfg = moe_full_config(num_layers=2)
    trainer = Trainer(cfg, TrainConfig(), None, seed=1)
    rng = torch.Generator().manual_seed(10)
    docs = [torch.randint(1, cfg.vocab_size, (int(n),), generator=rng).tolist()
            for n in torch.randint(100, 1500, (24,), generator=rng)]
    batch = next(prefetch_to_device(pack_documents(docs, B, S)))
    tape = RoutingTape(torch, moe_lib)
    before = moe_counts(fa, gm)
    k_loss, k_grads = tape.record(lambda: trainer.gradients(batch))
    mid = moe_counts(fa, gm)
    p_loss, p_grads = moe_with_plain(fa, gm, lambda: tape.replay(lambda: trainer.gradients(batch)))
    after = moe_counts(fa, gm)
    used = ("flash_fwd", "flash_dq", "flash_dkv", "gmm_bf16_k2048", "gmm_bf16_k8192", "tgmm")
    if not all(mid[n] > before[n] for n in used):
        raise AssertionError(f"a kernel did not launch: {before} -> {mid}")
    if after != mid:
        raise AssertionError("the plain run launched a kernel")
    k_loss, p_loss = float(k_loss), float(p_loss)
    rels = {}
    for path, pg in p_grads.items():
        kg = k_grads[path]
        if not bool(torch.isfinite(kg).all()):
            raise AssertionError(f"non-finite gradient {path}")
        rels["/".join(path)] = ((kg.float() - pg.float()).norm()
                                / pg.float().norm().clamp_min(1e-30)).item()
    out = {"phase": "moe_full_train_parity_on_card", "layers": 2, "batch": B, "seq": S,
           "packed_segments": int(batch["segment_ids"].max()),
           "grad_tol": f"||kernel - plain|| / ||plain|| <= {TRAIN_GRAD_TOL} per leaf",
           "loss_rtol": TRAIN_LOSS_RTOL, "loss_kernels": k_loss, "loss_plain": p_loss,
           "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
           "worst_leaf_grad_rel_diff": max(rels.values()), "leaf_grad_rel_diff": rels,
           "routing_flips": tape.flip_report()}
    if not (math.isfinite(k_loss) and out["loss_rel_diff"] <= TRAIN_LOSS_RTOL
            and out["worst_leaf_grad_rel_diff"] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"MoE full fine-tune parity: {out}")
    return out


# ---------------------------------------------------------------------------
# the int4 fused-dequant matmul (slice 5)


def int4_operands(torch, gen, K, N, group, copies=1, scale_hi=0.02):
    """``copies`` random packed weights (every nibble) and scales."""
    q4 = [torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda",
                        dtype=torch.int32).to(torch.uint8) for _ in range(copies)]
    s = [torch.rand((K // group, N), generator=gen, device="cuda") * scale_hi + 1e-4
         for _ in range(copies)]
    return q4, s


def int4_mm_work(M, K, N, group):
    """(flops, bytes) of one launch in either direction: the activations,
    the packed weights and scales read once, the result written once."""
    return 2 * M * K * N, M * K * 2 + K * N // 2 + K // group * N * 4 + M * N * 2


def int4_matmul_kernels_phase(torch, int4, bw: float, peak: float) -> tuple[dict, list[dict]]:
    """Both int4 matmul kernels against their plain versions at Llama-3-8B's
    four projection shapes, at M 8,192 (the QLoRA step) and M 4 and 1
    (decode), and at ragged shapes and group 64, per 128 x 128 output tile
    into NaN-filled buffers; at M 8,192 also against the port's dequant
    path (``int4_dequant`` kernel, then an f32 product); planted faults the
    check must reject; the lm_head must raise. Times by CUDA events:
    kernel, plain, ``torch.matmul`` on a pre-dequantized bf16 weight
    (product only) and the dequant path (``int4_dequant`` +
    ``torch.matmul``), with per-8B-forward totals by launch count."""
    gen = torch.Generator(device="cuda").manual_seed(91)
    checks = TileChecks(int4, ("int4_mm", "int4_dlhs"))
    stats = checks.stats

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    kinds = {  # name: (kernel, plain, weight as the product reads it)
        "int4_mm": (int4.int4_mm, int4.int4_matmul_reference, lambda w: w),
        "int4_dlhs": (int4.int4_dlhs, int4.int4_dlhs_reference, lambda w: w.t()),
    }
    # name: (the instance rule, its launch counts by instance)
    instances = {"int4_mm": (int4.int4_mm_instance, int4.mm_launches_by_instance),
                 "int4_dlhs": (int4.int4_dlhs_instance, int4.dlhs_launches_by_instance)}

    def launched_instances(name, before):
        counts = instances[name][1]
        return [k for k, v in counts.items() if v != before.get(k, 0)]
    for label, K, N, per_fwd in INT4_MM_SHAPES:
        for M in INT4_MM_ROWS:
            wbytes = K * N // 2 + K // INT4_GROUP * N * 4
            # at decode, enough distinct weights that a timed run reads them
            # cold, as a forward reads each layer's (the L2 is 50 MB)
            copies = 1 if M > 512 else min(32, max(1, math.ceil(200e6 / wbytes)))
            q4, s = int4_operands(torch, gen, K, N, INT4_GROUP, copies)
            x, d = bf16(M, K), bf16(M, N)
            for name, a in (("int4_mm", x), ("int4_dlhs", d)):
                fn, plain, orient = kinds[name]
                tag = f"{label} M {M}"
                poison(torch, M, N if name == "int4_mm" else K)
                before = dict(instances[name][1])
                got = fn(a, q4[0], s[0])
                want = plain(a, q4[0], s[0])
                torch.cuda.synchronize()
                row = {"shape": label, "M": M, "K": K, "N": N, "group": INT4_GROUP,
                       "launches_per_8b_forward": per_fwd,
                       "tile_rel_err": checks.check(name, got, want, tag),
                       "instance": launched_instances(name, before)}
                if row["instance"] != [instances[name][0](M, N, True)]:
                    raise AssertionError(f"{name} {tag}: launched {row['instance']}")
                if name == "int4_dlhs":
                    # no atomics, a fixed order of sums: a second launch
                    # gives the same bits
                    poison(torch, M, K)
                    again = fn(a, q4[0], s[0])
                    row["bitwise_equal_relaunch"] = bool(torch.equal(got, again))
                    if not row["bitwise_equal_relaunch"]:
                        raise AssertionError(f"int4_dlhs {tag}: two launches differ")
                    del again
                if M == INT4_MM_ROWS[0]:
                    # the port's current path: the dequant kernel (bit-exact), then
                    # one f32 product: the kernel must see the same bf16 weights
                    w = orient(int4.int4_dequant(q4[0], s[0]).float())
                    row["tile_rel_err_vs_dequant_path"] = checks.check(
                        name, got, (a.float() @ w).to(a.dtype), tag + " vs the dequant path")
                    del w
                if label == "wq/wo" and M == INT4_MM_ROWS[0]:
                    q, sc = q4[0], s[0]
                    short = a.clone()
                    short[:, -64:] = 0
                    unwritten = want.clone()
                    unwritten[:128, :128] = 0
                    checks.plant(name, tag, want, {
                        "nibble halves swapped": plain(a, (q >> 4) | (q << 4), sc),
                        "every group given the next group's scale": plain(a, q, sc.roll(-1, 0)),
                        ("the last K chunk of 64 skipped" if name == "int4_mm" else
                         "the last N block of 64 skipped"): plain(short, q, sc),
                        "one 128 x 128 output tile left unwritten (zeros)": unwritten,
                    })
                    del short, unwritten
                del got, want
                wb = [orient(int4.int4_dequant(qi, si)) for qi, si in zip(q4, s)]
                iters = max(10, copies)
                flops, nbytes = int4_mm_work(M, K, N, INT4_GROUP)
                row.update(
                    flops=flops, bytes=nbytes,
                    ms=time_ms(torch, lambda i: fn(a, q4[i % copies], s[i % copies]), iters),
                    plain_ms=time_ms(torch, lambda i: plain(a, q4[i % copies], s[i % copies]),
                                     iters=2, reps=3),
                    library_ms=time_ms(torch, lambda i: torch.matmul(a, wb[i % copies]), iters),
                    dequant_path_ms=time_ms(torch, lambda i: torch.matmul(
                        a, orient(int4.int4_dequant(q4[i % copies], s[i % copies]))), iters),
                    bound_ms=max(flops / peak, nbytes / bw) * 1e3,
                    bound_by="operations" if flops / peak > nbytes / bw else "bytes")
                row["tflops_per_s"] = flops / row["ms"] / 1e9
                row["gb_per_s"] = nbytes / row["ms"] / 1e6
                stats[name]["shapes"].append(row)
                del wb
            del q4, s, x, d
            torch.cuda.empty_cache()

    # shapes the contract accepts beyond the 8B's: checked, not timed
    extra = []
    for label, M, K, N, group in INT4_MM_EXTRA:
        q4, s = int4_operands(torch, gen, K, N, group)
        for name, a in (("int4_mm", bf16(M, K)), ("int4_dlhs", bf16(M, N))):
            fn, plain, _ = kinds[name]
            poison(torch, M, N if name == "int4_mm" else K)
            before = dict(instances[name][1])
            got = fn(a, q4[0], s[0], group)
            rel = checks.check(name, got, plain(a, q4[0], s[0]),
                               f"{label} M {M} K {K} N {N} g {group}")
            row = {"kernel": name, "shape": label, "M": M, "K": K, "N": N, "group": group,
                   "tile_rel_err": rel, "instance": launched_instances(name, before)}
            if row["instance"] != [instances[name][0](M, N, True)]:
                raise AssertionError(f"{name} {label}: launched {row['instance']}")
            extra.append(row)
    # the lm_head (N 128,256) is refused, as by the TPU kernels: callers
    # take the dequant path there; and a float32 x on the card is refused
    lm_q4 = torch.zeros((2048, 128256), dtype=torch.uint8, device="cuda")
    lm_s = torch.ones((32, 128256), device="cuda")
    refused = {}
    for name, a in (("int4_mm", bf16(1, 4096)), ("int4_dlhs", bf16(1, 128256))):
        fn = kinds[name][0]
        for what, args, err in (("lm_head", (a, lm_q4, lm_s), NotImplementedError),
                                ("float32 on the card", (a.float(), lm_q4, lm_s), TypeError)):
            try:
                fn(*args)
            except err as e:
                refused[f"{name} {what}"] = f"{type(e).__name__}: {e}"
            else:
                raise AssertionError(f"{name} took {what}, which it must refuse")
    del lm_q4, lm_s
    torch.cuda.empty_cache()

    totals = {}
    for name, st in stats.items():
        for M in INT4_MM_ROWS:
            rs = [r for r in st["shapes"] if r["M"] == M]
            totals.setdefault(name, {})[f"M {M}"] = {
                k: sum(r[k] * r["launches_per_8b_forward"] for r in rs)
                for k in ("ms", "bound_ms", "plain_ms", "library_ms", "dequant_path_ms")}
    tpu = {"int4_mm": (119, "_int4_mm_kernel (pallas_call at odh_kubeflow_tpu/ops/pallas_int4.py:175)"),
           "int4_dlhs": (193, "_int4_dlhs_kernel (pallas_call at "
                              "odh_kubeflow_tpu/ops/pallas_int4.py:244)")}
    rows = []
    for name, st in stats.items():
        main = st["shapes"][0]  # wq/wo at the QLoRA step's rows
        line, fn = tpu[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "odh_kubeflow_tpu_torch/csrc/int4_matmul.cu",
            "replaces": f"odh_kubeflow_tpu/ops/pallas_int4.py:{line}",
            "tpu_kernel": fn,
            "max_abs_err": st["max_abs_err"],
            "tile_rel_err": st["tile_rel_err"],
            "tolerance": f"||kernel - plain|| / ||plain|| <= {int4.TILE_RTOL} in every 128 x 128 "
                         "output tile, bf16, into NaN-filled buffers",
            "planted_fault": st["planted_fault"],
            "unit": f"one launch at the 8B wq/wo shape (M {main['M']}, K {main['K']}, "
                    f"N {main['N']}, group {INT4_GROUP})",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library": "torch.matmul on the pre-dequantized bf16 weight (product only: no "
                       "single call unpacks int4)",
            "dequant_path_ms": main["dequant_path_ms"],
            "dequant_path": "int4_dequant kernel + torch.matmul",
            "per_8b_forward": totals[name],
            "shapes": st["shapes"],
        })
    record = {"phase": "int4_matmul_kernels",
              "checked": {n: len(st["shapes"]) + len(INT4_MM_EXTRA) for n, st in stats.items()},
              "extra": extra,
              "refused": refused,
              "int4": [{k: r[k] for k in ("name", "max_abs_err", "tile_rel_err", "planted_fault",
                                          "ms", "plain_ms", "bound_ms", "library_ms",
                                          "dequant_path_ms", "per_8b_forward")} for r in rows]}
    return record, rows


def int4_qlora_proj_phase(torch, fa, int4, gm) -> dict:
    """The seven int4 projections of one Llama-3-8B layer at the QLoRA
    step's rows (M 8,192), bf16, autograd through ``int4_matmul`` with
    ``x.requires_grad`` and a seeded cotangent: exactly 7 matmul and 7 dX
    launches and no dequant; dx per 128 x 128 tile against the same layer
    through ``int4_dequant`` + ``torch.matmul``; peak device memory and
    host time of both routes."""
    gen = torch.Generator(device="cuda").manual_seed(92)
    M = INT4_MM_ROWS[0]
    # scales so each product is O(1): weights ~ 0.01, rows ~ 1
    layer = {n: [t[0] for t in int4_operands(torch, gen, K, N, INT4_GROUP, scale_hi=4e-3)]
             for n, K, N in INT4_LAYER}
    width = {n: (K, N) for n, K, N in INT4_LAYER}
    x0 = torch.randn((M, width["wq"][0]), generator=gen, device="cuda").to(torch.bfloat16)
    douts = [torch.randn((M, width[n][1]), generator=gen, device="cuda").to(torch.bfloat16)
             for n in ("wo", "wk", "wv", "w_down")]

    def layer_dx(proj):
        x = x0.clone().requires_grad_(True)
        q, k, v = (proj(x, *layer[n]) for n in ("wq", "wk", "wv"))
        o = proj(q, *layer["wo"])  # q stands in for attention's output
        g, u = proj(x, *layer["w_gate"]), proj(x, *layer["w_up"])
        h = (torch.nn.functional.silu(g.float()) * u.float()).to(x.dtype)
        torch.autograd.backward((o, k, v, proj(h, *layer["w_down"])), douts)
        return x.grad

    routes = {
        "kernel": lambda a, q4, s: int4.int4_matmul(a, q4, s, INT4_GROUP),
        "dequant": lambda a, q4, s: torch.matmul(a, int4.int4_dequant(q4, s)),
    }
    want_launches = {"kernel": {"int4_mm": 7, "int4_dlhs": 7, "int4_dequant": 0},
                     "dequant": {"int4_mm": 0, "int4_dlhs": 0, "int4_dequant": 7}}
    # every forward and every dX of the layer on the Hopper TMA kernels
    want_instances = {"mm": {}, "dlhs": {}}
    for _, _, N in INT4_LAYER:
        for d, rule in (("mm", int4.int4_mm_instance), ("dlhs", int4.int4_dlhs_instance)):
            i = rule(M, N, True)
            want_instances[d][i] = want_instances[d].get(i, 0) + 1
    out = {"phase": "int4_qlora_proj", "M": M, "layer": [list(p) for p in INT4_LAYER]}
    dx = {}
    for route, proj in routes.items():
        layer_dx(proj)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_moe_counts(fa, int4, gm)
        t0 = time.perf_counter()
        dx[route] = layer_dx(proj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {"int4_mm": int4.mm_launches, "int4_dlhs": int4.dlhs_launches,
                    "int4_dequant": int4.launches}
        others = {k: v for k, v in moe_counts(fa, gm).items() if v}
        if launched != want_launches[route] or others:
            raise AssertionError(f"int4_qlora_proj {route} route launched {launched} {others}, "
                                 f"want {want_launches[route]}")
        by_instance = {d: {k: v for k, v in counts.items() if v} for d, counts in
                       (("mm", int4.mm_launches_by_instance),
                        ("dlhs", int4.dlhs_launches_by_instance))}
        if by_instance != (want_instances if route == "kernel" else {"mm": {}, "dlhs": {}}):
            raise AssertionError(f"int4_qlora_proj {route} route: instances "
                                 f"{by_instance}, want {want_instances}")
        out[route] = {"launches": launched, "launches_by_instance": by_instance,
                      "fwd_bwd_s": wall,
                      "peak_above_weights_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    if not bool(dx["kernel"].isfinite().all()):
        raise AssertionError("int4_qlora_proj: non-finite dx")
    out["dx_tile_rel_err"] = int4.tile_rel_err(dx["kernel"], dx["dequant"])
    diff = (dx["kernel"].float() - dx["dequant"].float()).abs()
    out["dx_elements_differing"] = int((diff > 0).sum())
    out["dx_max_abs_diff"] = diff.max().item()
    out["dx_rms"] = {r: t.float().square().mean().sqrt().item() for r, t in dx.items()}
    out["tolerance"] = f"dx per 128 x 128 tile within {INT4_PROJ_RTOL} of the dequant route's"
    if not out["dx_tile_rel_err"] <= INT4_PROJ_RTOL:
        raise AssertionError(f"int4_qlora_proj: dx {out['dx_tile_rel_err']} > {INT4_PROJ_RTOL}")
    return out


# ---------------------------------------------------------------------------
# the serving engine (slice 7): continuous batching, chunked prefill, the
# prefix cache, speculative decoding, W8A8, the decode chunk as a CUDA graph

# the engine of the main path: 8 slots over a 2,048-token cache, 8-step
# chunks, the service's prompt buckets, 256-token prefill parts, 4 prefix
# entries (prefix buckets 256 and 512)
ENGINE_SLOTS, ENGINE_MAX_LEN = 8, 2048
ENGINE_KW = {"chunk": 8, "prefill_chunk": 256, "prefix_cache_entries": 4}
ENGINE_REQUESTS, ENGINE_NEW_TOKENS, ENGINE_SERIAL = 16, 64, 8
# engine_graphs: ms per decode step over chunks where exactly n slots are
# active (the first two such chunks skipped), GRAPH_CHUNKS chunks a run
GRAPH_SLOTS, GRAPH_CHUNKS = (1, 4, 8), 6
SPEC_K, SPEC_NEW_TOKENS = 4, 32
W8A8_ROWS, W8A8_NEW_TOKENS = (1, 4, 8), 32


def pctl(xs, q):
    """The loadtest's percentile (``loadtest/continuous_batching.py``)."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def latency_stats(ttfts, itls) -> dict:
    """TTFT and burst-gap ITL percentiles by the reference loadtest's rules
    (``loadtest/continuous_batching.py`` ``latency_stats``): ITL counts the
    gaps over 1 ms (the pauses a streaming client sees), ``stall_max_ms``
    the longest gap."""
    gaps = [g for g in itls if g > 1e-3]
    return {"ttft_p50_s": pctl(ttfts, 0.5), "ttft_p95_s": pctl(ttfts, 0.95),
            "itl_p50_ms": pctl(gaps, 0.5) * 1e3, "itl_p95_ms": pctl(gaps, 0.95) * 1e3,
            "stall_max_ms": max(itls, default=0.0) * 1e3}


def sse(base: str, body: dict) -> tuple[list, list]:
    """One streamed completion over HTTP: (frames, the client's arrival time
    of each), the POST's send time first."""
    t0 = time.monotonic()
    req = urllib.request.Request(
        base + "/v1/completions", data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"},
    )
    frames, times = [], [t0]
    with urllib.request.urlopen(req, timeout=900) as r:
        if r.headers["Content-Type"] != "text/event-stream":
            raise AssertionError(f"stream answered {r.status} {r.read()[:200]!r}")
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                frames.append(json.loads(line[len("data: "):]))
                times.append(time.monotonic())
    return frames, times


def step_ms(eng, variant: str, n: int) -> float:
    """Median host ms per decode step over the engine's chunks of
    ``variant`` with exactly ``n`` active slots, the first two skipped."""
    times = [t for v, a, t in eng.chunk_times if v == variant and a == n][2:]
    if not times:
        raise AssertionError(f"no {variant} chunk ran with {n} active slots")
    per = eng.spec_rounds_per_call if variant == "spec" else eng.chunk
    return statistics.median(times) / per * 1e3


def first_step_spy(engine_mod, eng):
    """Record each admission's first-step logits (the prefill's last real
    position) on the engine thread, keyed by prompt; returns (dict, undo)."""
    got, current = {}, {}
    real_tail, real_sample = eng._prefill_tail, engine_mod.sample_logits_rowwise

    def tail(slot, rem, start, bucket, req):
        current["req"] = req
        return real_tail(slot, rem, start, bucket, req)

    def sample(logits, *a):
        req = current.pop("req", None)
        if req is not None:  # a prefill (eager), never a captured chunk; no sync
            got[tuple(req.prompt)] = logits[0].float().clone()
        return real_sample(logits, *a)

    eng._prefill_tail = tail
    engine_mod.sample_logits_rowwise = sample

    def undo():
        del eng._prefill_tail
        engine_mod.sample_logits_rowwise = real_sample

    return got, undo


def one_shot_with_margins(gen_mod, service, prompt, n):
    """The one-shot path's greedy completion of one prompt (a seed forces
    it) and each step's logits' top-2 margin; step 0's logits too."""
    margins, first = [], []
    real = gen_mod.sample_logits

    def spy(logits, generator, **kw):
        # kept on the card: a read-back here would sync every step
        top = logits.topk(2, dim=-1).values
        margins.append(top[0, 0] - top[0, 1])
        if not first:
            first.append(logits[0].float().clone())
        return real(logits, generator, **kw)

    gen_mod.sample_logits = spy
    try:
        out = service.complete([prompt], max_tokens=n, seed=0)
    finally:
        gen_mod.sample_logits = real
    if out["usage"].get("engine"):
        raise AssertionError("a seeded request took the engine")
    return out["completions"][0], torch_list(margins), first[0]


def torch_list(scalars) -> list:
    """Device scalars as floats, one transfer."""
    import torch

    return torch.stack(scalars).float().tolist() if scalars else []


def greedy_parity(got, want, margins, fail=True) -> dict:
    """Greedy tokens of the engine against the one-shot path's: equal up to
    the first step whose one-shot top-2 margin is under GREEDY_FLIP_MARGIN
    (a bf16 near-tie the engine's other batch shape may flip)."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None and len(got) == len(want):
        return {"identical": True}
    i = min(len(got), len(want)) if i is None else i
    margin = margins[i] if i < len(margins) else float("inf")
    if fail and margin >= GREEDY_FLIP_MARGIN:
        raise AssertionError(f"greedy tokens differ at step {i} with a top-2 margin of {margin}")
    return {"identical": False, "first_difference": i, "top2_margin_there": margin,
            "cut_at_near_tie": margin < GREEDY_FLIP_MARGIN}


def engine_prompts(torch, V: int) -> list:
    """ENGINE_REQUESTS prompts of 17 to 240 tokens (buckets 64 and 256)."""
    gen = torch.Generator().manual_seed(23)
    lengths = torch.randint(17, 241, (ENGINE_REQUESTS,), generator=gen).tolist()
    return [torch.randint(1, V, (n,), generator=gen).tolist() for n in lengths]


def engine_phase(torch, int4, cfg, params) -> tuple[dict, object, list]:
    """Llama-3-8B int4 through ``CompletionService(engine_slots=8)`` and its
    HTTP surface. Returns the record, the service (its engine is reused by
    ``engine_graphs``) and the greedy completions of the staggered streams
    (``engine_mesh`` holds its tokens to them)."""
    import importlib
    import threading

    from odh_kubeflow_tpu_torch.models.serve import CompletionService, serve

    engine_mod = importlib.import_module("odh_kubeflow_tpu_torch.models.engine")
    gen_mod = importlib.import_module("odh_kubeflow_tpu_torch.models.generate")
    V = cfg.vocab_size
    prompts = engine_prompts(torch, V)
    gen = torch.Generator().manual_seed(29)

    def prompt(n):
        return torch.randint(1, V, (n,), generator=gen).tolist()

    service = CompletionService(params, cfg, engine_slots=ENGINE_SLOTS,
                                engine_max_len=ENGINE_MAX_LEN, device="cuda", **ENGINE_KW)
    eng = service.engine
    httpd = serve(service, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    record = {"phase": "engine",
              "config": "llama3_8b int4 (group 128), 32 layers, random weights (seed 0); "
                        f"engine {ENGINE_SLOTS} slots, max_len {ENGINE_MAX_LEN}, {ENGINE_KW}, "
                        "prompt buckets (64, 256, 1024), prefix buckets (256, 512)"}
    t_phase = time.perf_counter()
    try:
        # warm-up: the greedy and the sampling chunk each run once eagerly,
        # then are captured and replayed; a chunked (256-wide) admission
        for body in ({"prompt": [prompt(40)], "max_tokens": 25},
                     {"prompt": [prompt(40)], "max_tokens": 25, "temperature": 0.8},
                     {"prompt": [prompt(300)], "max_tokens": 2}):
            code, out = post(base, body)
            if code != 200 or not out["usage"].get("engine"):
                raise AssertionError(f"warm-up: HTTP {code}: {out}")
        if set(eng._graphs) != {"greedy", "sample"}:
            raise AssertionError(f"captured graphs {sorted(eng._graphs)}")
        record["captured_dequant_launches_per_chunk"] = {
            v: eng._graph_launches[v][0] for v in eng._graphs}
        if eng._graph_launches["greedy"][0] != LAUNCHES_PER_FORWARD * eng.chunk:
            raise AssertionError(f"a greedy chunk captured {eng._graph_launches['greedy'][0]} "
                                 f"dequants, not {LAUNCHES_PER_FORWARD} x {eng.chunk}")

        # 16 staggered streams over HTTP (SSE), 64 new tokens each: the main
        # path's launches are counted here, with only the engine thread on
        # the card (the HTTP threads only wait)
        first, undo = first_step_spy(engine_mod, eng)
        results = [None] * ENGINE_REQUESTS
        errors = []

        def client(i):
            try:
                results[i] = sse(base, {"prompt": prompts[i], "max_tokens": ENGINE_NEW_TOKENS})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{i}: {type(e).__name__}: {e}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.decode_steps = eng.tokens_emitted = 0
        int4.launches = 0  # the engine path's count starts here
        threads = [threading.Thread(target=client, args=(i,)) for i in range(ENGINE_REQUESTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
            time.sleep(0.05)  # staggered arrivals
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        engine_launches = int4.launches
        undo()
        # a prefill a request (none is chunked: every prompt is under 256
        # tokens) and a forward a decode step, 225 dequants each
        want = LAUNCHES_PER_FORWARD * (ENGINE_REQUESTS + eng.decode_steps)
        if engine_launches != want:
            raise AssertionError(f"the engine launched {engine_launches} dequants, not {want}")
        if errors or any(r is None for r in results):
            raise AssertionError(f"streams failed: {errors}")
        completions, ttfts, itls = [], [], []
        for frames, times in results:
            toks = [f["token"] for f in frames[:-1]]
            if frames[-1] != {"done": True, "tokens": toks} or len(toks) != ENGINE_NEW_TOKENS:
                raise AssertionError(f"SSE frames end {frames[-1]} after {len(toks)} tokens")
            if not all(0 <= t < V for t in toks):
                raise AssertionError(f"tokens out of range: {toks}")
            completions.append(toks)
            ttfts.append(times[1] - times[0])
            itls += [b - a for a, b in zip(times[1:-1], times[2:-1])]
        tokens = ENGINE_REQUESTS * ENGINE_NEW_TOKENS
        record["staggered"] = {
            "requests": ENGINE_REQUESTS, "new_tokens": ENGINE_NEW_TOKENS, "stagger_s": 0.05,
            "wall_s": wall, "aggregate_tok_s": tokens / wall,
            "tokens_per_decode_step": eng.tokens_emitted / eng.decode_steps,
            "decode_steps": eng.decode_steps, **latency_stats(ttfts, itls),
            "sse_frames_per_stream": ENGINE_NEW_TOKENS + 1,
            "dequant_launches": engine_launches,
            "dequant_launches_per_request": engine_launches / ENGINE_REQUESTS,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        }

        # the serial one-shot path on the same service (a seed takes it),
        # one request at a time: its rate, and greedy parity per request
        t_serial, parity, cut = 0.0, [], 0
        for i in range(ENGINE_SERIAL):
            t0 = time.perf_counter()
            want, margins, logits0 = one_shot_with_margins(gen_mod, service, prompts[i],
                                                           ENGINE_NEW_TOKENS)
            t_serial += time.perf_counter() - t0
            lk = first[tuple(prompts[i])]
            rel = ((lk - logits0).norm() / logits0.norm()).item()
            if not rel <= SERVE_LOGITS_RTOL:
                raise AssertionError(f"request {i}: first-step logits rel err {rel}")
            p = greedy_parity(completions[i], want, margins)
            cut += bool(p.get("cut_at_near_tie"))
            parity.append({"first_step_logits_rel_err": rel, **p})
        serial_tok_s = ENGINE_SERIAL * ENGINE_NEW_TOKENS / t_serial
        record["serial_one_shot"] = {"requests": ENGINE_SERIAL, "tok_s": serial_tok_s,
                                     "request_s": t_serial / ENGINE_SERIAL}
        record["staggered"]["aggregate_vs_serial"] = tokens / wall / serial_tok_s
        record["parity_vs_one_shot"] = {
            "first_step_logits_rtol": SERVE_LOGITS_RTOL, "greedy_flip_margin": GREEDY_FLIP_MARGIN,
            "requests": parity, "cut_at_near_tie": cut}

        # mixed sampling settings and eos in one chunk
        g = completions[0]
        eos = g[2]
        hs = [eng.submit(prompts[0], max_tokens=16),
              eng.submit(prompts[1], max_tokens=16, temperature=1.0, top_k=50),
              eng.submit(prompts[2], max_tokens=16, temperature=0.7, top_p=0.9),
              eng.submit(prompts[0], max_tokens=16, eos_id=eos)]
        outs = [h.result(timeout=300) for h in hs]
        if [len(o) for o in outs[:3]] != [16] * 3 or outs[3] != g[: g.index(eos) + 1]:
            raise AssertionError(f"mixed chunk: {outs}")
        if outs[0] != g[:16]:
            raise AssertionError("a greedy stream changed beside sampled ones")
        record["mixed_sampling_and_eos"] = {
            "greedy_equals_its_staggered_run": True, "eos_stream_tokens": len(outs[3]),
            "sampled_in_range": all(0 <= t < V for o in outs[1:3] for t in o)}

        # a 1,000-token admission behind 4 decoding streams, in parts and whole
        stalls = {}
        for label, chunked in (("prefill_chunk_256", 256), ("whole_prompt", None)):
            eng.prefill_chunk = chunked
            streams = [eng.submit(prompt(32), max_tokens=96, stream=True) for _ in range(4)]
            for s in streams:
                while len(s.tokens) < 9:
                    if s.done.wait(0.01):
                        break
            t_long = time.monotonic()
            long = eng.submit(prompt(1000), max_tokens=8)
            long.result(timeout=300)
            for s in streams:
                s.result(timeout=300)
            gaps = [b - a for s in streams for a, b in zip(s.times, s.times[1:]) if b > t_long]
            stalls[label] = {"stall_max_ms": max(gaps) * 1e3,
                             "long_ttft_s": long.ttft(), **latency_stats([], gaps)}
        eng.prefill_chunk = ENGINE_KW["prefill_chunk"]
        record["long_admission_behind_4_streams"] = stalls

        # a shared 256-token system prompt: a miss, then a hit
        system = prompt(256)
        hits0, misses0 = eng.prefix_hits, eng.prefix_misses
        a = eng.submit(system + prompt(32), max_tokens=4)
        a.result(timeout=300)
        b = eng.submit(system + prompt(32), max_tokens=4)
        b.result(timeout=300)
        if (eng.prefix_hits - hits0, eng.prefix_misses - misses0) != (1, 1):
            raise AssertionError(f"prefix hits {eng.prefix_hits - hits0}, misses "
                                 f"{eng.prefix_misses - misses0}")
        record["prefix_cache"] = {"hits": 1, "misses": 1, "ttft_miss_s": a.ttft(),
                                  "ttft_hit_s": b.ttft()}
        record["seconds"] = time.perf_counter() - t_phase
    finally:
        httpd.shutdown()
        httpd.server_close()
    return record, service, completions


def _replayed_equals_eager(torch, eng, prompts) -> dict:
    """One greedy chunk from the same admitted state, eager and as the
    replayed graph (the engine's thread stopped; this thread drives it on
    the engine's stream): which outputs are bit-identical."""
    from odh_kubeflow_tpu_torch.models.engine import _Request

    eng.stop()
    st = eng._state
    keys = [k for k in st if k not in ("cache", "dcache")]

    def snap():
        out = {k: st[k].clone() for k in keys}
        out.update({f"cache_{kv}": st["cache"][kv].clone() for kv in ("k", "v")})
        out["tokens"] = eng._out_toks.clone()
        return out

    with torch.no_grad(), torch.cuda.stream(eng._stream):
        eng._slot_req = [None] * eng.n_slots
        for p in prompts:
            eng._admit(_Request(prompt=p, max_tokens=64, temperature=0.0, top_k=0, top_p=0.0,
                                eos_id=-1))
        eng._pending_first.clear()
        start = snap()
        eng.cuda_graphs = False
        eng._run_chunk("greedy")
        eager = snap()
        for k in keys:
            st[k].copy_(start[k])
        for kv in ("k", "v"):
            st["cache"][kv].copy_(start[f"cache_{kv}"])
        eng.cuda_graphs = True
        eng._run_chunk("greedy")
        graph = snap()
    torch.cuda.synchronize()
    return {k: torch.equal(eager[k], graph[k]) for k in eager}


def slot_step_ms(eng, prompts) -> dict:
    """{n: ms per greedy decode step with n active slots} for n in
    GRAPH_SLOTS: n requests of GRAPH_CHUNKS chunks at once."""
    ms = {}
    for n in GRAPH_SLOTS:
        eng.chunk_times.clear()
        hs = [eng.submit(p, max_tokens=1 + eng.chunk * GRAPH_CHUNKS) for p in prompts[:n]]
        for h in hs:
            h.result(timeout=600)
        ms[n] = step_ms(eng, "greedy", n)
    return ms


def engine_graphs_model(torch, eng, prompts, label: str, dense: bool) -> dict:
    """ms per decode step at 1, 4 and 8 active slots, the chunk replayed as
    a graph and run eagerly, peak memory of each; then replayed against
    eager from one state (must be bit-identical for the dense model)."""
    out = {"model": label}
    for mode in ("graph", "eager"):
        eng.cuda_graphs = mode == "graph"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[mode] = {"decode_step_ms": slot_step_ms(eng, prompts),
                     "peak_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}
    out["graph_over_eager"] = {n: out["eager"]["decode_step_ms"][n]
                               / out["graph"]["decode_step_ms"][n] for n in GRAPH_SLOTS}
    # the graphs' pools stay reserved beyond the eager peak
    out["graph_pool_gb"] = {v: b / 2**30 for v, b in eng.graph_pool_bytes.items()}
    same = _replayed_equals_eager(torch, eng, prompts[:4])
    out["replayed_equals_eager"] = same
    if dense and not all(same.values()):
        raise AssertionError(f"{label}: a replayed chunk differs from the eager one: {same}")
    out["replay_profile"] = replay_profile(torch, eng)
    return out


def replay_profile(torch, eng, chunks: int = 2) -> dict:
    """The device's busy share while the greedy graph replays (the engine
    stopped, its 4 admitted slots from ``_replayed_equals_eager``)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), torch.cuda.stream(eng._stream):
        eng._run_chunk("greedy")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(chunks):
                eng._run_chunk("greedy")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / (chunks * eng.chunk)
    kernels = device_kernels(prof)
    device_ms = sum(t for t, _ in kernels.values()) / 1e3 / (chunks * eng.chunk)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    return {"profiled_step_wall_ms": wall_ms,
            "device_kernel_ms_per_step": device_ms if kernels else "not measured",
            "device_busy_share": device_ms / wall_ms if kernels else "not measured",
            "top_kernels_ms_per_step": [
                {"kernel": k, "ms": t / 1e3 / (chunks * eng.chunk),
                 "launches": c // (chunks * eng.chunk)} for k, (t, c) in top]}


def spec_phase(torch, int4, cfg, params) -> dict:
    """Llama-3-8B int4 target, Llama-3.2-1B int4 draft (both random, from
    seeds), k 4: single-stream ``speculative_generate`` and the engine's
    speculative chunk, each against the target decoding alone."""
    import importlib

    from odh_kubeflow_tpu_torch.models.engine import DecodeEngine
    from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.quant import streaming_quantized_init
    from odh_kubeflow_tpu_torch.models.spec_decode import SpecDecodeConfig, speculative_generate
    from odh_kubeflow_tpu_torch.utils import prometheus

    gen_mod = importlib.import_module("odh_kubeflow_tpu_torch.models.generate")
    t_phase = time.perf_counter()
    dcfg = LlamaConfig.llama3_1b()
    dparams = streaming_quantized_init(dcfg, 1, bits=4, device="cuda")
    prompt = engine_prompts(torch, cfg.vocab_size)[3][:48]
    toks = torch.tensor([prompt + [0] * (64 - len(prompt))], device="cuda")
    lens = torch.tensor([len(prompt)], device="cuda")
    N = SPEC_NEW_TOKENS

    margins = []
    real = gen_mod.sample_logits

    def spy(logits, generator, **kw):
        top = logits.topk(2, dim=-1).values
        margins.append(top[0, 0] - top[0, 1])
        return real(logits, generator, **kw)

    gen_mod.sample_logits = spy
    try:
        alone = generate(params, toks, cfg, GenerateConfig(max_new_tokens=N),
                         prompt_lengths=lens)["tokens"][0].tolist()
    finally:
        gen_mod.sample_logits = real
    margins = torch_list(margins)

    before = int4.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = speculative_generate(params, cfg, dparams, dcfg, toks,
                               SpecDecodeConfig(max_new_tokens=N, num_draft_tokens=SPEC_K),
                               prompt_lengths=lens)
    got = out["tokens"][0].tolist()
    wall = time.perf_counter() - t0
    rounds = out["rounds"]
    single = {
        "new_tokens": N, "rounds": rounds, "accepted_drafts": out["accepted_drafts"],
        "acceptance_rate": out["accepted_drafts"] / (rounds * SPEC_K),
        "target_passes_per_token": rounds / N, "ms_per_round": wall / rounds * 1e3,
        "sync_wait_ms_per_round": out["sync_s"] / rounds * 1e3,
        "dequant_launches": int4.launches - before,
        "vs_target_alone": greedy_parity(got, alone, margins),
    }

    eng = DecodeEngine(params, cfg, n_slots=4, max_len=ENGINE_MAX_LEN, draft_params=dparams,
                       draft_cfg=dcfg, spec_k=SPEC_K, device="cuda",
                       metrics_registry=prometheus.Registry())
    try:
        eng.submit(prompt, max_tokens=2 * SPEC_K * eng.spec_rounds_per_call).result(600)
        if "spec" not in eng._graphs:
            raise AssertionError("the speculative chunk was not captured")
        eng.chunk_times.clear()
        eng.spec_rounds = eng.tokens_emitted = 0
        got_e = eng.submit(prompt, max_tokens=N).result(timeout=600)
        engine_rec = {
            "spec_rounds": eng.spec_rounds,
            "tokens_per_round": eng.tokens_emitted / eng.spec_rounds,
            "ms_per_round": statistics.median(t for v, _, t in eng.chunk_times if v == "spec")
            / eng.spec_rounds_per_call * 1e3,
            "captured_dequant_launches_per_call": eng._graph_launches["spec"][0],
            "vs_target_alone": greedy_parity(got_e, alone, margins),
        }
    finally:
        eng.stop()
    return {"phase": "spec",
            "config": "target llama3_8b int4 (seed 0), draft llama3_1b int4 (seed 1), k 4",
            "note": "random weights: the draft and the target agree by chance only, so "
                    "acceptance is about 0 and this is no speed-up",
            "single_stream": single, "engine": engine_rec,
            "seconds": time.perf_counter() - t_phase}


def decode_step_ms(torch, cfg, params, batch: int, steps: int = 8) -> float:
    """Mean ms of one cached decode step of ``batch`` rows (CUDA events)."""
    from odh_kubeflow_tpu_torch.models.generate import family_forward, init_cache

    cache_cfg, fwd = family_forward(cfg)
    S = 64
    L = S + steps + 1
    cache = init_cache(cache_cfg, batch, L, device="cuda")
    mask = torch.zeros((batch, L), dtype=torch.bool, device="cuda")
    mask[:, :S] = True
    tok = torch.ones((batch, 1), dtype=torch.long, device="cuda")
    with torch.no_grad():
        fwd(params, tok.expand(batch, S), cfg, cache, 0,
            positions=torch.arange(S, device="cuda").expand(batch, S), kv_mask=mask)

        def step(i):
            mask[:, S + i] = True
            fwd(params, tok, cfg, cache, S + i,
                positions=torch.full((batch, 1), S + i, device="cuda"), kv_mask=mask)

        step(0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(1, steps + 1):
            step(i)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / steps


def w8a8_phase(torch) -> dict:
    """Llama-3-8B int8 (random, seed 0): W8A8 decode against the dequant
    path: greedy agreement, ms per decode step at 1, 4 and 8 rows, and
    ``_int8_matmul`` at those rows (``torch._int_mm``, rows padded to
    ``llama.INT_MM_MIN_ROWS``) bit-equal to its CPU path."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import llama
    from odh_kubeflow_tpu_torch.models.engine import DecodeEngine
    from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
    from odh_kubeflow_tpu_torch.models.quant import streaming_quantized_init
    from odh_kubeflow_tpu_torch.utils import prometheus

    t_phase = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b()
    w8 = dataclasses.replace(cfg, w8a8_decode=True)
    params = streaming_quantized_init(cfg, 0, bits=8, device="cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    gen = torch.Generator().manual_seed(31)
    int_mm = {}
    for M in W8A8_ROWS:
        x = torch.randn((M, cfg.hidden_size), generator=gen).to(torch.bfloat16)
        w = {k: v[0].contiguous() for k, v in params["layers"]["wk"].items()}
        got = llama._int8_matmul(x.cuda(), w)
        want = llama._int8_matmul(x, {k: v.cpu() for k, v in w.items()})
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"_int8_matmul at {M} rows differs from its CPU path")
        int_mm[M] = "bit-equal to the CPU path"
    prompt = engine_prompts(torch, cfg.vocab_size)[5][:40]
    toks = torch.tensor([prompt + [0] * (64 - len(prompt))], device="cuda")
    lens = torch.tensor([len(prompt)], device="cuda")
    outs = {}
    for label, c in (("dequant", cfg), ("w8a8", w8)):
        outs[label] = generate(params, toks, c, GenerateConfig(max_new_tokens=W8A8_NEW_TOKENS),
                               prompt_lengths=lens)["tokens"][0].tolist()
    agree = sum(a == b for a, b in zip(outs["dequant"], outs["w8a8"])) / W8A8_NEW_TOKENS
    first = next((i for i, (a, b) in enumerate(zip(outs["dequant"], outs["w8a8"])) if a != b),
                 None)
    ms = {label: {M: decode_step_ms(torch, c, params, M) for M in W8A8_ROWS}
          for label, c in (("dequant", cfg), ("w8a8", w8))}
    # where an eager 8-row step's device time goes, both paths
    profiles = {label: profile_phase(torch, c, params, ENGINE_SLOTS)
                for label, c in (("dequant", cfg), ("w8a8", w8))}
    # the same steps inside the engine's graph-replayed chunk (no host time)
    graphed = {}
    prompts = engine_prompts(torch, cfg.vocab_size)
    for label, c in (("dequant", cfg), ("w8a8", w8)):
        eng = DecodeEngine(params, c, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                           chunk=ENGINE_KW["chunk"], device="cuda",
                           metrics_registry=prometheus.Registry())
        try:
            eng.submit(prompt, max_tokens=1 + 3 * eng.chunk).result(timeout=600)  # captures
            graphed[label] = slot_step_ms(eng, prompts)
        finally:
            eng.stop()
    return {"phase": "w8a8", "config": "llama3_8b int8 per-channel, random weights (seed 0)",
            "resident_params_gb": resident, "int8_matmul_on_card": int_mm,
            "int_mm_min_rows": llama.INT_MM_MIN_ROWS,
            "greedy_agreement": agree, "first_difference": first,
            "decode_step_ms_eager": ms, "engine_graph_step_ms": graphed,
            "profile_8_rows": profiles,
            "seconds": time.perf_counter() - t_phase}


def moe_engine_phase(torch, fa, int4, gm, cfg, params, served) -> tuple[dict, object, list]:
    """Mixtral-8x1B bf16 through ``CompletionService(engine_slots=8)``: 4
    ragged prompts (ragged path: below 2,048 assignments) and one of 700
    tokens (bucket 1,024: the grouped prefill, 48 ``gmm`` on the engine
    thread); greedy against the one-shot service's completions (served by
    ``moe_serve``), TTFT and the decode step. Returns the record, the
    service (its engine is reused by ``engine_graphs``) and the engine's
    tokens (``moe_engine_mesh`` holds its tokens to them)."""
    import importlib

    from odh_kubeflow_tpu_torch.models.serve import CompletionService

    gen_mod = importlib.import_module("odh_kubeflow_tpu_torch.models.generate")
    t_phase = time.perf_counter()
    prompts = moe_serve_requests(torch, cfg.vocab_size)
    service = CompletionService(params, cfg, engine_slots=ENGINE_SLOTS,
                                engine_max_len=ENGINE_MAX_LEN, device="cuda",
                                chunk=ENGINE_KW["chunk"])
    eng = service.engine
    # warm-up: the engine thread's first grouped prefill (timed: it once
    # cost seconds in a bring-up run), and a chunk run eagerly, then captured
    t0 = time.perf_counter()
    eng.submit(prompts["long"][0], max_tokens=2).result(timeout=600)
    first_grouped_s = time.perf_counter() - t0
    eng.submit(prompts["short"][0], max_tokens=25).result(timeout=600)
    torch.cuda.synchronize()
    zero_moe_counts(fa, int4, gm)  # the MoE engine path's count starts here
    eng.chunk_times.clear()
    rows = prompts["ragged4"] + prompts["long"]
    hs = [eng.submit(p, max_tokens=32) for p in rows]
    got = [h.result(timeout=600) for h in hs]
    launched = moe_counts(fa, gm)
    if launched["gmm"] != MOE_SERVE_PREFILL["gmm"] or launched["gmm_bf16_k2048"] != 32:
        raise AssertionError(f"launches {launched}: one grouped prefill (the 700-token one)")
    parity = []
    for i, p in enumerate(rows):
        want, margins, _ = one_shot_with_margins(gen_mod, service, p, 32)
        parity.append(greedy_parity(got[i], want, margins, fail=False))
    served_rows = served["ragged4"] + served["long"]
    record = {"phase": "moe_engine",
              "config": "mixtral_8x1b bf16, 16 layers, dispatch grouped, random (seed 0); engine "
                        f"{ENGINE_SLOTS} slots, chunk {ENGINE_KW['chunk']}",
              "first_grouped_prefill_request_s": first_grouped_s,
              "launches": launched, "gmm_per_request": launched["gmm"] / len(rows),
              "ttft_s": [h.ttft() for h in hs],
              "decode_step_ms": statistics.median(t for v, _, t in eng.chunk_times)
              / eng.chunk * 1e3,
              "greedy_vs_one_shot": parity,
              "equal_to_moe_serve_completions": [g == s for g, s in zip(got, served_rows)],
              "note": "routing is discontinuous: a bf16 difference of the engine's batch shape "
                      "may flip an expert and the tokens after it; reported, not failed",
              "seconds": time.perf_counter() - t_phase}
    return record, service, got


# ---------------------------------------------------------------------------
# serving under a mesh (slice 8, part 3): the engine with
# DecodeEngine(mesh=build_mesh(MeshConfig())) on an NCCL group of one rank
# (one card: every axis has size 1, so no collective is issued and the
# decode chunk is still captured as a CUDA graph)

MESH_SAMPLED_TOKENS = 16


def one_rank_group(torch):
    """An NCCL process group of one rank and the all-ones mesh over it."""
    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    return build_mesh(MeshConfig(), device="cuda")


def serve_engine(cfg, params, mesh, **kw):
    """A ``DecodeEngine`` as ``CompletionService(engine_slots=8)`` builds it."""
    from odh_kubeflow_tpu_torch.models.engine import DecodeEngine
    from odh_kubeflow_tpu_torch.models.serve import DEFAULT_PROMPT_BUCKETS
    from odh_kubeflow_tpu_torch.utils import prometheus

    return DecodeEngine(params, cfg, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                        prompt_buckets=DEFAULT_PROMPT_BUCKETS, pad_id=0, mesh=mesh,
                        device="cuda", metrics_registry=prometheus.Registry(), **kw)


def engine_mesh_phase(torch, int4, cfg, params, completions, graph_step_ms) -> tuple[dict, int]:
    """The ``engine`` phase's Llama-3-8B int4 engine (8 slots, ``ENGINE_KW``)
    under a mesh at world size 1. Its greedy tokens for the 16 engine
    prompts (64 each, submitted at once) must be bit-equal to the engine
    phase's: a row's decode never reads another row, so they do not depend
    on the arrivals. Its sampled tokens must be bit-equal to those of a
    fresh engine without a mesh that runs the same requests in the same
    order (the noise a chunk draws depends on the history of the slots).
    The chunk must be captured, and the 16 prompts must take exactly 225
    dequants a prefill and a decode step. Returns the record and those
    launches (counted from 0 just before the 16 prompts)."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    V = cfg.vocab_size
    gen = torch.Generator().manual_seed(37)
    warm = [torch.randint(1, V, (40,), generator=gen).tolist() for _ in range(2)]
    prompts = engine_prompts(torch, V)
    sampled = [(prompts[0], dict(temperature=1.0, top_k=50)),
               (prompts[1], dict(temperature=0.7, top_p=0.9)),
               (prompts[2], dict(temperature=0.8))]

    def warm_and_sample(eng):
        # the greedy and the sampling chunk each run once eagerly, then are
        # captured; then the sampled requests, one at a time
        eng.submit(warm[0], max_tokens=25).result(timeout=600)
        eng.submit(warm[1], max_tokens=25, temperature=0.8).result(timeout=600)
        return [eng.submit(p, max_tokens=MESH_SAMPLED_TOKENS, **kw).result(timeout=600)
                for p, kw in sampled]

    plain = serve_engine(cfg, params, None, **ENGINE_KW)
    try:
        want_sampled = warm_and_sample(plain)
    finally:
        plain.stop()
    del plain
    torch.cuda.empty_cache()
    mesh = one_rank_group(torch)
    try:
        eng = serve_engine(cfg, params, mesh, **ENGINE_KW)
        try:
            got_sampled = warm_and_sample(eng)
            if not eng.cuda_graphs or set(eng._graphs) != {"greedy", "sample"}:
                raise AssertionError(f"under the mesh the captured graphs are "
                                     f"{sorted(eng._graphs)}")
            captured = eng._graph_launches["greedy"][0]
            if captured != LAUNCHES_PER_FORWARD * eng.chunk:
                raise AssertionError(f"a greedy chunk captured {captured} dequants")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eng.chunk_times.clear()
            eng.decode_steps = 0
            int4.launches = 0  # the mesh engine's count starts here
            t0 = time.perf_counter()
            hs = [eng.submit(p, max_tokens=ENGINE_NEW_TOKENS) for p in prompts]
            got = [h.result(timeout=600) for h in hs]
            wall = time.perf_counter() - t0
            launched = int4.launches
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            steps = eng.decode_steps
            step_8 = step_ms(eng, "greedy", ENGINE_SLOTS)
        finally:
            eng.stop()
    finally:
        dist.destroy_process_group()
    want = LAUNCHES_PER_FORWARD * (ENGINE_REQUESTS + steps)
    if launched != want:
        raise AssertionError(f"the mesh engine launched {launched} dequants, not {want}")
    if got != completions:
        i = next(i for i, (a, b) in enumerate(zip(got, completions)) if a != b)
        raise AssertionError(f"greedy tokens of prompt {i} differ from the engine phase's")
    if got_sampled != want_sampled:
        raise AssertionError("sampled tokens under the mesh differ from the engine's without")
    return {"phase": "engine_mesh",
            "config": "the engine phase's: llama3_8b int4, 8 slots, "
                      f"{ENGINE_KW}; DecodeEngine(mesh=build_mesh(MeshConfig())) on an NCCL "
                      "group of 1",
            "graphs": sorted(eng._graphs), "captured_dequant_launches_per_chunk": captured,
            "greedy_equal_engine_phase": True, "greedy_requests": ENGINE_REQUESTS,
            "sampled_equal_without_mesh": True, "sampled_requests": len(sampled),
            "dequant_launches": launched, "dequant_launches_per_request": launched
            / ENGINE_REQUESTS, "decode_steps": steps,
            "decode_step_ms_8_slots": step_8,
            "engine_graphs_decode_step_ms_8_slots": graph_step_ms,
            "wall_s": wall, "peak_memory_gb": peak_gb,
            "seconds": time.perf_counter() - t_phase}, launched


def moe_engine_mesh_phase(torch, fa, int4, gm, cfg, params, moe_engine_tokens,
                          moe_engine_launches) -> tuple[dict, dict]:
    """The ``moe_engine`` phase's Mixtral-8x1B bf16 engine under a mesh at
    world size 1, the same warm-up and rows (4 ragged prompts and the
    700-token one, 32 tokens each): tokens bit-equal to ``moe_engine``'s,
    and the same launches (one grouped prefill: 48 bf16 ``gmm``). Returns
    the record and the launches (counted from 0 just before the rows)."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    prompts = moe_serve_requests(torch, cfg.vocab_size)
    mesh = one_rank_group(torch)
    try:
        eng = serve_engine(cfg, params, mesh, chunk=ENGINE_KW["chunk"])
        try:
            eng.submit(prompts["long"][0], max_tokens=2).result(timeout=600)
            eng.submit(prompts["short"][0], max_tokens=25).result(timeout=600)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eng.chunk_times.clear()
            zero_moe_counts(fa, int4, gm)  # the mesh engine's count starts here
            hs = [eng.submit(p, max_tokens=32) for p in prompts["ragged4"] + prompts["long"]]
            got = [h.result(timeout=600) for h in hs]
            launched = moe_counts(fa, gm)
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            graphs = sorted(eng._graphs)
            step = statistics.median(t for v, _, t in eng.chunk_times) / eng.chunk * 1e3
        finally:
            eng.stop()
    finally:
        dist.destroy_process_group()
    if launched != moe_engine_launches or launched["gmm"] != MOE_SERVE_PREFILL["gmm"]:
        raise AssertionError(f"launches {launched}, the moe_engine phase's "
                             f"{moe_engine_launches}")
    if got != moe_engine_tokens:
        raise AssertionError("tokens under the mesh differ from the moe_engine phase's")
    if graphs != ["greedy"]:
        raise AssertionError(f"captured graphs {graphs}")
    return {"phase": "moe_engine_mesh",
            "config": "the moe_engine phase's: mixtral_8x1b bf16, dispatch grouped, 8 slots, "
                      f"chunk {ENGINE_KW['chunk']}; DecodeEngine(mesh=build_mesh(MeshConfig())) "
                      "on an NCCL group of 1",
            "tokens_equal_moe_engine": True, "launches": launched, "graphs": graphs,
            "decode_step_ms": step, "peak_memory_gb": peak_gb,
            "seconds": time.perf_counter() - t_phase}, launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 2
    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.quant import streaming_quantized_init
    from odh_kubeflow_tpu_torch.ops import _build, int4
    from odh_kubeflow_tpu_torch.ops import flash_attention as fa
    from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
    from odh_kubeflow_tpu_torch.utils.device import peak_flops_per_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = card_label()
    name = torch.cuda.get_device_name(0)
    bw = spec_bandwidth(name)
    peak = peak_flops_per_device(name)
    if not peak:
        raise RuntimeError(f"no bf16 peak known for {name!r}")
    kernel_names = ["int4_dequant", "flash_fwd", "flash_bwd", "gmm", "swiglu_gmm", "tgmm",
                    "int4_matmul"]
    t0 = time.perf_counter()
    _build.build(kernel_names)
    build_s = time.perf_counter() - t0
    ptxas = {
        n: [line.strip() for line in _build.build_logs.get(n, "").splitlines()
            if any(w in line for w in ("Function properties", "registers", "spill", "wgmma",
                                       "setmaxnreg", "arning"))]
        for n in kernel_names
    }
    emit({"phase": "device", "card": label, "device_name": name,
          "spec_bandwidth_bytes_s": bw, "peak_bf16_flops": peak, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s, "ptxas": ptxas})

    kernel = kernels_phase(torch, int4, bw)
    flash_rows = flash_kernels_phase(torch, fa, bw, peak)
    emit({"phase": "kernels", "int4_dequant_bit_exact": True,
          "shapes_checked": len(kernel["shapes"]),
          "flash": [{k: r[k] for k in ("name", "max_abs_err", "tile_rel_err", "planted_fault",
                                        "ms", "plain_ms", "bound_ms", "library_ms",
                                        "flash_bwd_pair_ms") if k in r}
                    for r in flash_rows]})
    record, int4_rows = int4_matmul_kernels_phase(torch, int4, bw, peak)
    record["card"] = label
    emit(record)
    # the int4 matmul's path (slice 5): one 8B layer's projections, autograd
    record = int4_qlora_proj_phase(torch, fa, int4, gm)
    record["card"] = label
    emit(record)
    proj_launches = record["kernel"]["launches"]
    proj_instances = record["kernel"]["launches_by_instance"]
    moe_rows = moe_kernels_phase(torch, gm, bw, peak)
    bf16_rows = moe_bf16_kernels_phase(torch, gm, bw, peak)
    emit({"phase": "moe_kernels", "card": label,
          "grouped": [{k: r[k] for k in ("name", "max_abs_err", "tile_rel_err", "planted_fault",
                                          "ms", "plain_ms", "bound_ms", "library_ms")}
                      for r in moe_rows + bf16_rows]})

    # serving (slice 1)
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = streaming_quantized_init(cfg, 0, bits=4, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 2**30
    zero_counts(fa, int4)  # slice_phase zeroes int4 again right before its requests
    record, served = slice_phase(torch, int4, cfg, params)
    record.update(init_s=init_s, resident_params_gb=resident_gb, card=label)
    if (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) != (0, 0, 0):
        raise AssertionError("the serving path launched a flash kernel")
    emit(record)
    serve_launches = record["launches"]
    emit(parity_phase(torch, int4, cfg, params, served))
    emit({"phase": "profile", "card": label,
          "steps": [profile_phase(torch, cfg, params, b) for b in (1, 4)]})

    # the serving engine (slice 7) on the same 8B int4 parameters
    record, service, completions = engine_phase(torch, int4, cfg, params)
    record["card"] = label
    emit(record)
    engine_launches = record["staggered"]["dequant_launches"]
    t0 = time.perf_counter()
    graphs = [engine_graphs_model(torch, service.engine, engine_prompts(torch, cfg.vocab_size),
                                  "llama3_8b int4", dense=True)]
    graphs_s = time.perf_counter() - t0
    del service
    torch.cuda.empty_cache()
    # serving under a mesh (slice 8, part 3) at world size 1
    record, engine_mesh_launches = engine_mesh_phase(
        torch, int4, cfg, params, completions, graphs[0]["graph"]["decode_step_ms"][ENGINE_SLOTS])
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    record = spec_phase(torch, int4, cfg, params)
    record["card"] = label
    emit(record)
    del params
    torch.cuda.empty_cache()
    record = w8a8_phase(torch)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()

    # training (slice 2)
    record, trainer = train_phase(torch, fa, int4, peak)
    record["card"] = label
    emit(record)
    train_record = record
    train_launches = record["launches"]
    emit(train_profile_phase(torch, trainer))
    del trainer
    torch.cuda.empty_cache()
    emit(train_parity_phase(torch, fa, int4))

    # multi-device training (slice 8, part 1) at world size 1, and the
    # ring's block schedule through the loopback driver
    record, mesh_launches = mesh_train_phase(torch, fa, int4, train_record)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    record, ring_launches = ring_on_card_phase(torch, fa)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    # the fine-tune path at long context: tokenizer, native packer, the 8B
    # step at 16k under remat none / attn / attn_offload
    record, long_launches = long_context_text_phase(torch, fa, int4, bw, peak)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    # the platform's conformance gate on GPU node pools (slice 9), its
    # elastic-resume step on the 8B QLoRA model
    record, conformance_launches = platform_conformance_phase(torch, fa, int4)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    # the spawn path (slice 9, part 2): 500 notebooks through the JWA,
    # the admission webhooks and the gang scheduler on GPU node pools,
    # then one spawned notebook's serve on the card, cold and warm
    record, spawn_launches = platform_spawn_phase()
    record["card"] = label
    emit(record)
    # suspend-to-checkpoint sessions and the warm-start subsystem (slice
    # 9, part 3): a cold standby, a warm handout, suspend and resume
    record, sessions_launches = platform_sessions_phase()
    record["card"] = label
    emit(record)

    # MoE training (slice 3)
    record, trainer = moe_train_phase(torch, fa, int4, gm, peak)
    record["card"] = label
    emit(record)
    moe_record = record
    moe_launches = record["launches"]
    emit(moe_train_profile_phase(torch, trainer))
    del trainer
    torch.cuda.empty_cache()
    emit(moe_train_parity_phase(torch, fa, int4, gm))

    # expert parallelism (slice 8, part 2a): the MoE step under a mesh at
    # world size 1, and the expert shards through the loopback driver
    record, moe_mesh_launches = moe_mesh_train_phase(torch, fa, int4, gm, moe_record)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    record, ep_launches = moe_ep_loopback_phase(torch, fa, int4, gm)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    record, moe_offload_launches = moe_offload_phase(torch, fa, int4, gm)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()

    # pipeline parallelism (slice 8, part 2b): GPipe and 1F1B over the 8B
    # and Mixtral-8x1B stacks through the loopback drivers
    record, pipe_launches = pipe_loopback_phase(torch, fa, int4)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()
    record, moe_pipe_launches = moe_pipe_loopback_phase(torch, fa, int4, gm)
    record["card"] = label
    emit(record)
    torch.cuda.empty_cache()

    # MoE serving (slice 4): Mixtral-8x1B, bf16 weights, grouped prefill
    from odh_kubeflow_tpu_torch.models import moe as moe_lib

    cfg = moe_serve_config()
    t0 = time.perf_counter()
    params = moe_lib.init_params(0, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 2**30
    record, served = moe_serve_phase(torch, fa, int4, gm, cfg, params)
    record.update(init_s=init_s, resident_params_gb=resident_gb, card=label)
    emit(record)
    moe_serve_launches = record["launches"]
    emit(moe_serve_parity_phase(torch, fa, gm, cfg, params, served))
    emit({"phase": "moe_profile", "card": label,
          "steps": [profile_phase(torch, cfg, params, b) for b in (1, 4)]})
    record, service, moe_engine_tokens = moe_engine_phase(torch, fa, int4, gm, cfg, params,
                                                          served)
    record["card"] = label
    emit(record)
    moe_engine_launches = record["launches"]
    t0 = time.perf_counter()
    graphs.append(engine_graphs_model(torch, service.engine,
                                      engine_prompts(torch, cfg.vocab_size),
                                      "mixtral_8x1b bf16", dense=False))
    emit({"phase": "engine_graphs", "card": label, "chunk": ENGINE_KW["chunk"],
          "chunks_per_run": GRAPH_CHUNKS, "models": graphs,
          "seconds": graphs_s + time.perf_counter() - t0})
    del service
    torch.cuda.empty_cache()
    record, moe_engine_mesh_launches = moe_engine_mesh_phase(
        torch, fa, int4, gm, cfg, params, moe_engine_tokens, moe_engine_launches)
    record["card"] = label
    emit(record)
    del params
    torch.cuda.empty_cache()

    # the MoE full fine-tune (slice 4): trainable bf16 banks
    record, trainer = moe_full_train_phase(torch, fa, int4, gm, peak)
    record["card"] = label
    emit(record)
    full_launches = record["launches"]
    emit(moe_train_profile_phase(torch, trainer, "moe_full_train_profile"))
    del trainer
    torch.cuda.empty_cache()
    emit(moe_full_train_parity_phase(torch, fa, int4, gm))

    kernel["launches_by_path"] = {"serve": serve_launches, "engine": engine_launches,
                                  "engine_mesh": engine_mesh_launches,
                                  "train": train_launches["int4_dequant"], "moe_train": 0,
                                  "mesh_train": mesh_launches["int4_dequant"],
                                  "pipe_loopback": pipe_launches["int4_dequant"],
                                  "platform_conformance":
                                      conformance_launches["int4_dequant"],
                                  "platform_spawn": spawn_launches,
                                  "platform_sessions": sessions_launches}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    paths = {"train": train_launches, "moe_train": moe_launches,
             "moe_serve": moe_serve_launches, "moe_engine": moe_engine_launches,
             "moe_engine_mesh": moe_engine_mesh_launches,
             "moe_full_train": full_launches, "mesh_train": mesh_launches,
             "ring_on_card": ring_launches, "moe_mesh_train": moe_mesh_launches,
             "moe_ep_loopback": ep_launches, "pipe_loopback": pipe_launches,
             "moe_pipe_loopback": moe_pipe_launches, "long_context_text": long_launches,
             "moe_offload": moe_offload_launches,
             "platform_conformance": conformance_launches}
    for row in flash_rows + moe_rows + bf16_rows:
        row["launches_by_path"] = {p: n[row["name"]] for p, n in paths.items()
                                   if n.get(row["name"])}
        row["launches"] = sum(row["launches_by_path"].values())
    for row in int4_rows:
        row["launches_by_path"] = {"int4_qlora_proj": proj_launches[row["name"]]}
        row["launches"] = proj_launches[row["name"]]
        row["launches_by_instance"] = proj_instances[row["name"].removeprefix("int4_")]
    emit({"kernels": [kernel, *flash_rows, *moe_rows, *bf16_rows, *int4_rows]})
    print(label, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(notebook_serve_main() if sys.argv[1:] == ["--notebook-serve"] else main())
