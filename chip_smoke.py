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
35. ``platform_remote`` (after ``platform_usage``): the platform over the
    wire. This process is the apiserver (the store with a WAL, the REST
    façade over TLS with bearer tokens on the event loop,
    ``APF_INFLIGHT_LIMIT`` 32, the admission webhooks, the JWA); the
    notebook controller, the gang scheduler and the kubelet simulator run
    in ``chip_smoke.py --platform-controllers``, a client of
    ``api_from_env()``, shipping its spans to ``/debug/traces/ingest``.
    A 1-GPU notebook POSTed through the JWA reaches Running over HTTPS;
    its trace is one tree across both processes; 500 watches add fewer
    than 10 threads; then, while the spawned notebook's process serves
    Llama-3-8B int4 warm (225 dequants a forward), ``chip_smoke.py
    --platform-flood`` sends user reads and writes (0.1 s deadlines, 5%
    already expired) at 16 threads, at 128 for 12 s with one namespace's
    reads slowed by 0.04 s (a second notebook POSTed halfway must reach
    Running in the flood), then at 16 until the throughput is back: no
    controller-level shed, user sheds at the level ceiling, every expired
    request a 504 that ran no handler, attempts per logical request at
    most 1.3, recovery to 95% within 10 s.
36. ``platform_failover`` (after ``platform_remote``): the highly available
    control plane over plain HTTP on localhost. The leader apiserver
    (``chip_smoke.py --platform-apiserver``: the store with a WAL, the
    webhooks, a ``LeaderElector`` holding ``control-plane-leader`` whose
    token the store ships under), a follower (``python -m
    odh_kubeflow_tpu_torch.machinery.replica`` with the promotion
    watchdog, a 1 s lease), two notebook controllers and the scheduler
    (``python -m ...controllers.notebook`` / ``...scheduling.scheduler``
    through ``runner.run_controller``: leader election, the informer cache
    fed off the follower, reads spread over "follower,leader" by
    ``ReplicaFanout``, writes 307'd from the follower to the leader). A
    notebook reaches Running; the controller holding the lease is
    SIGKILLed (the standby takes it, the token rises by one, the dead
    holder's write is 403 ``FencedOut``); the leader apiserver is
    SIGKILLed (the follower promotes itself under its token + 1 within
    two lease windows and a poll of the last renewal it saw, every
    Notebook, StatefulSet, Pod and Workload of the leader's log on it at
    the same rv, the old epoch fenced); a second notebook reaches Running
    on the promoted store; meanwhile the first notebook's process serves
    Llama-3-8B int4 on the card (225 dequants a forward) and answers once
    more after the promotion; no process loads ``jax`` or
    ``odh_kubeflow_tpu``; the phase within 60 s.
37. ``platform_partitions`` (after ``platform_failover``): the
    partitioned write path and the all-in-one platform (three WAL'd
    partitions, a partitioned follower, the split JWA, a SIGKILL and
    recovery on the WAL while a notebook serves on the card). The
    platform runs with the lock-order sanitizer armed
    (``GRAFT_SANITIZE=1``): before the kill and again at the phase's end
    on the restarted platform, ``/debug/locks`` must answer enabled, with
    at least one lock-order edge and no report.
38. ``native_jsontree`` (after ``device``, host only): the control
    plane's JSON-tree extension (``native/jsontree.cpp``) built with this
    machine's g++ and Python headers; ``serialize`` and ``objects`` on
    the native engine; ``dumps`` byte-identical to ``json.dumps`` and
    ``deepcopy`` equal and isolated on 3,000 seeded trees (frozen trees,
    non-BMP strings, ``inf``/``nan``, non-str keys that take the stdlib
    fallback); µs per call of both engines on a 300-Notebook list, on this
    machine's host CPU.

Every phase line carries ``wall_s``, its wall seconds since the previous
one. Then one ``phase_seconds`` line (each phase's seconds, their sum and
the script's), the kernel table (``{"kernels": [...]}``), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero without the last line. Without a GPU it exits
2 and prints nothing on stdout.
"""

from __future__ import annotations

import gc
import os
import json
import math
import statistics
import sys
import threading
import time
import urllib.error
import urllib.request
import urllib.parse

_SCRIPT_T0 = time.perf_counter()

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


# (phase, wall seconds) of every phase line emitted; a phase line's
# seconds run from the previous phase line (the first from the start)
PHASE_SECONDS: list = []
_PHASE_CLOCK = [time.perf_counter()]


def emit(obj) -> None:
    """Print one JSON line; a phase record (a dict with ``phase``) is
    stamped with ``wall_s``, its wall seconds since the previous one."""
    if isinstance(obj, dict) and "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "wall_s": now - _PHASE_CLOCK[0]}
        _PHASE_CLOCK[0] = now
        PHASE_SECONDS.append([obj["phase"], obj["wall_s"]])
    print(json.dumps(obj), flush=True)


def phase_seconds_line() -> dict:
    """The ``phase_seconds`` line: each phase's wall seconds and their
    sum, and the script's seconds so far."""
    return {"phase_seconds": PHASE_SECONDS, "sum_s": sum(s for _, s in PHASE_SECONDS),
            "script_s": time.perf_counter() - _SCRIPT_T0}


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
    import shutil
    import tempfile

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

    def run(label: str) -> dict:
        env, node = pod_process_env(api, name, ns, workspace)
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
    progress("service")  # the weights are on the card: the requests come next
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


def run_notebook_process(label: str, env: dict, kernel_dir: str, scratch: str,
                         mode: str = "--notebook-serve") -> dict:
    """``chip_smoke.py <mode>`` (``--notebook-serve`` by default) in
    ``env`` (a pod's resolved env); the kernel directory's files before
    and after, and the seconds from process start to each milestone the
    process stamps (``<name>_at`` → ``<name>_s``)."""
    import subprocess

    before = dir_state(kernel_dir)
    out_path = os.path.join(scratch, f"{label}.out")
    err_path = os.path.join(scratch, f"{label}.err")
    t0 = time.time()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), mode],
            env={**os.environ, **env, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))},
            stdout=out, stderr=err, timeout=600)
    lines = [x for x in open(out_path).read().splitlines() if x.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"{label} notebook process exit {proc.returncode}: "
                             f"{open(err_path).read()[-3000:]}")
    got = json.loads(lines[-1])
    stamps = {k[:-3] + "_s": v - t0 for k, v in got.items() if k.endswith("_at")}
    return {"kernel_dir": kernel_dir, "before": before, "after": dir_state(kernel_dir),
            **stamps, "process_s": time.time() - t0, **got}


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


# the observability path (slice 9, part 4): a notebook's profile on the
# card, served by TensorBoard over its PVC; traces, exemplars and SLOs of
# the spawn; the dashboard, VWA, TWA and KFAM apps; the exposure
# controller's lock release. One H100 pool of 2 nodes × 8 GPUs.
OBSERVE_POOL = ("h100-o", "nvidia-h100-80gb", 2, 8)
OBSERVE_NS = "team-o"
OBSERVE_USER = "owner-o@example.com"
OBSERVE_CONTRIBUTOR = "contrib-o@example.com"
OBSERVE_OUTSIDER = "outsider-o@example.com"
OBSERVE_QUOTA = 16
OBSERVE_PVC = ("trace-pvc", "/home/jovyan/traces")
OBSERVE_NOTEBOOK = "nb-profile"
OBSERVE_TENSORBOARD = "gpu-traces"
OBSERVE_MAX_ROUNDS = 60
# the spawn trace's milestones, in causal order
OBSERVE_MILESTONES = ("scheduler.admit", "kubelet.gang_bind", "kubelet.container_start")
# each counted kernel's device name in a trace (a substring of it)
PROFILE_KERNELS = {"flash_fwd": ("flash_fwd_kernel",), "flash_dq": ("flash_dq_kernel",),
                   "flash_dkv": ("flash_dkv_kernel",),
                   "int4_dequant": ("dequant_vec", "dequant_scalar")}


def observe_fleet() -> dict:
    """Boot the platform the observability path runs on: the store, CRDs,
    the PodDefault and notebook admission webhooks (and, ahead of them,
    the namespace's auth policy: every notebook created in ``OBSERVE_NS``
    asks for the auth sidecar, as the ODH dashboard's spawner does), the
    kubelet simulator, the notebook (with the culler, probing a fake
    Jupyter on localhost), profile, tensorboard and exposure controllers,
    ``SliceScheduler``, kfam, the JWA, VWA, TWA, kfam app and dashboard
    over HTTP on localhost, and one ``SpanCollector`` installed as the
    process's. The PVCs live in a temp directory, one host directory a
    claim (``pvc_dir``). Needs no card."""
    import tempfile
    from http.server import HTTPServer

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.conformance import _IdleJupyter
    from odh_kubeflow_tpu_torch.controllers.culler import Culler, CullerConfig
    from odh_kubeflow_tpu_torch.controllers.exposure import ExposureController
    from odh_kubeflow_tpu_torch.controllers.kfam import KfamService
    from odh_kubeflow_tpu_torch.controllers.notebook import (
        NotebookController, NotebookControllerConfig)
    from odh_kubeflow_tpu_torch.controllers.profile import ProfileController
    from odh_kubeflow_tpu_torch.controllers.runtime import Manager
    from odh_kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
    from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.scheduling.scheduler import SliceScheduler
    from odh_kubeflow_tpu_torch.utils import tracing
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry
    from odh_kubeflow_tpu_torch.web.dashboard import DashboardApp
    from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
    from odh_kubeflow_tpu_torch.web.kfam_app import KfamApp
    from odh_kubeflow_tpu_torch.web.twa import TensorboardsWebApp
    from odh_kubeflow_tpu_torch.web.vwa import VolumesWebApp
    from odh_kubeflow_tpu_torch.webhooks import NotebookWebhook, PodDefaultWebhook
    from odh_kubeflow_tpu_torch.webhooks.notebook import INJECT_AUTH_ANNOTATION

    root = tempfile.mkdtemp(prefix="platform-observe-")
    collector = tracing.SpanCollector()
    previous = tracing.set_collector(collector)
    jupyter = HTTPServer(("127.0.0.1", 0), _IdleJupyter)
    threading.Thread(target=jupyter.serve_forever, daemon=True).start()
    clock = {"now": 0.0}
    api = APIServer()
    apis.register_crds(api)
    register_scheduling(api)
    apis.install_default_cluster_roles(api)

    def auth_policy(req):
        if req.operation == "CREATE" and req.obj["metadata"].get("namespace") == OBSERVE_NS:
            req.obj["metadata"].setdefault("annotations", {})[INJECT_AUTH_ANNOTATION] = "true"
            return req.obj
        return None

    api.register_admission_hook({"Notebook"}, auth_policy, mutating=True,
                                name="namespace-auth-policy")
    PodDefaultWebhook(api).register()
    NotebookWebhook(api).register()
    cluster = FakeCluster(api)
    name, accel, nodes, per_node = OBSERVE_POOL
    cluster.add_gpu_node_pool(name, accel, num_nodes=nodes, gpus_per_node=per_node)
    registry = Registry()
    mgr = Manager(api, time_fn=lambda: clock["now"], registry=registry)
    culler = Culler(api, CullerConfig(check_gpu_duty_cycle=False),
                    base_url_fn=lambda nb: f"http://127.0.0.1:{jupyter.server_port}")
    NotebookController(api, NotebookControllerConfig(enable_queueing=True, enable_culling=True),
                       registry=registry, culler=culler).register(mgr)
    ProfileController(api, registry=registry).register(mgr)
    TensorboardController(api).register(mgr)
    ExposureController(api).register(mgr)
    SliceScheduler(api, registry=registry).register(mgr)
    kfam = KfamService(api)
    apps = {"jwa": JupyterWebApp(api, registry=registry), "vwa": VolumesWebApp(api, registry),
            "twa": TensorboardsWebApp(api, registry), "kfam": KfamApp(api, registry=registry),
            "dashboard": DashboardApp(api, kfam=kfam, registry=registry)}
    servers = {k: app.app.serve("127.0.0.1", 0) for k, app in apps.items()}

    def call(app: str, method: str, path: str, body=None, user=OBSERVE_USER):
        req = urllib.request.Request(
            f"http://127.0.0.1:{servers[app].server_address[1]}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json", "kubeflow-userid": user,
                     "Cookie": "XSRF-TOKEN=o", "X-XSRF-TOKEN": "o"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def drive() -> None:
        clock["now"] += 1.0
        mgr.drain(max_rounds=OBSERVE_MAX_ROUNDS)
        cluster.step()
        mgr.drain(max_rounds=OBSERVE_MAX_ROUNDS)

    def drive_until(done, what: str) -> int:
        for rounds in range(1, OBSERVE_MAX_ROUNDS + 1):
            drive()
            if done():
                return rounds
        raise AssertionError(f"{what}: not reached in {OBSERVE_MAX_ROUNDS} rounds")

    def pvc_dir(claim: str) -> str:
        path = os.path.join(root, "pvcs", OBSERVE_NS, claim)
        os.makedirs(path, exist_ok=True)
        return path

    def close() -> None:
        for server in servers.values():
            server.shutdown()
            server.server_close()
        jupyter.shutdown()
        jupyter.server_close()
        mgr.stop()
        tracing.set_collector(previous)

    return {"api": api, "cluster": cluster, "apps": apps, "call": call, "drive": drive,
            "drive_until": drive_until, "pvc_dir": pvc_dir, "close": close,
            "collector": collector, "registry": registry, "root": root}


def notebook_profile_main() -> int:
    """The notebook's process on the card (``chip_smoke.py
    --notebook-profile``, in the env its pod would give it, its kernel
    directory warm): the kernel-startup hook first (the profiler's
    capture server), then the ``train`` phase's step (Llama-3-8B at full
    width and depth, ``remat_policy="attn"``, int4 base, LoRA r16 on
    wq/wk/wv/wo, batch 2 × 4096): one step, then one step under
    ``profiling.capture_trace`` into ``$ODH_TORCH_PROFILER_LOGDIR``. Prints
    one JSON line: the milestones, both losses, the process's launch
    counters over the profiled step and the trace's kernels by name, each
    counted kernel's device ms in the trace, the profiled step's wall
    time."""
    from odh_kubeflow_tpu_torch.utils import profiling

    exec(compile(profiling.kernel_startup_snippet(), "<ipython-startup>", "exec"), {})
    import torch

    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.ops import _build, int4
    from odh_kubeflow_tpu_torch.ops import flash_attention as fa
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    imported_at = time.time()
    server = None
    if profiling.server_started():
        port = profiling._STATE["port"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            server = {"port": port, "healthz": r.status}
    logdir = os.environ[profiling.LOGDIR_ENV]
    B, S = TRAIN_SHAPE
    cfg = LlamaConfig.llama3_8b(remat=True, remat_policy="attn")
    trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4",
                      precompile_batch=(B, S))
    torch.cuda.synchronize()
    trainer_at = time.time()
    batch = trainer.make_fake_batch(B, S, seed=1)
    t0 = time.perf_counter()
    first_loss = float(trainer.train_step(batch)["loss"])
    first_step_wall_s = time.perf_counter() - t0
    first_step_at = time.time()
    before = counts(fa, int4)
    t0 = time.perf_counter()
    with profiling.capture_trace(logdir):
        t1 = time.perf_counter()
        loss = float(trainer.train_step(batch)["loss"])
        profiled_step_wall_s = time.perf_counter() - t1
    capture_wall_s = time.perf_counter() - t0
    after = counts(fa, int4)
    events = profiling.latest_trace_events(logdir)
    kernels = profiling.kernel_events(events)
    traced, device_ms = {}, {}
    for name, patterns in PROFILE_KERNELS.items():
        hits = [e for e in kernels if any(p in e["name"] for p in patterns)]
        traced[name] = len(hits)
        device_ms[name] = sum(e["dur"] for e in hits) / 1e3
    sessions = profiling.trace_sessions(logdir)
    emit({"imported_at": imported_at, "trainer_at": trainer_at, "first_step_at": first_step_at,
          "profiled_at": time.time(), "server": server, "first_loss": first_loss,
          "loss": loss, "first_step_wall_s": first_step_wall_s,
          "profiled_step_wall_s": profiled_step_wall_s, "capture_wall_s": capture_wall_s,
          "launched": {k: after[k] - before[k] for k in after}, "launches_total": after,
          "traced": traced, "device_ms": device_ms,
          "trace_kernels": len(kernels),
          "trace_kernel_ms": sum(e["dur"] for e in kernels) / 1e3,
          "trace_events": len(events), "sessions": sessions,
          "files": sorted(os.listdir(sessions[-1])) if sessions else [],
          "built": sorted(_build.build_logs), "build_dir": str(_build.BUILD_DIR),
          "device": torch.cuda.get_device_name(0)})
    return 0


def run_profile_process(env: dict, scratch: str) -> dict:
    """``chip_smoke.py --notebook-profile`` in ``env`` (the notebook pod's
    resolved env)."""
    return run_notebook_process("profile", env, env["ODH_TORCH_KERNEL_CACHE"], scratch,
                                mode="--notebook-profile")


def platform_observe_phase(run_profile=run_profile_process) -> tuple[dict, dict]:
    """The observability path (``observe_fleet``), each step timed:

    1. a user creates a workgroup through the dashboard; with the
       profile's GPU quota (an admin's ``resourceQuotaSpec``), the
       dashboard's quota panel shows its ``requests.nvidia.com/gpu`` row;
       the owner adds a contributor through the kfam app, whom the
       dashboard lists; an outsider gets 403;
    2. the VWA POSTs ``trace-pvc``;
    3. the JWA POSTs a 1-GPU notebook mounting it; the auth policy asks
       for the sidecar, the notebook webhook locks the notebook, the
       exposure controller releases the lock once the ServiceAccount and
       secrets exist, and the notebook becomes ready. The POST's trace
       holds the scheduler's admission and the kubelet's bind and
       container start, assembles into one tree and ends its milestones
       in causal order; the OpenMetrics exposition of
       ``http_request_duration_seconds`` carries its trace id as an
       exemplar;
    4. the notebook's process on the card (``run_profile``) profiles an
       8B QLoRA step into the PVC: its trace counts the step's kernels as
       the process's launch counters do;
    5. the TWA POSTs a Tensorboard on ``pvc://trace-pvc/logs``: its
       Deployment mounts the claim and serves ``/logs/logs``, the kubelet
       runs it and the TWA lists it ready; its ``/logs`` route reports the
       claim (not listable, as JAX's), and a second Tensorboard on the
       PVC's host directory, under ``TWA_LOCAL_LOGS_ROOT``, lists the
       session's trace;
    6. the dashboard's ``/api/metrics`` (16 GPUs, 1 in use), ``/api/slo``
       (every default SLO; ``spawn-ready-p99`` counts the spawn) and
       ``/api/usage`` (503: no meter).

    ``run_profile(env, scratch)`` runs the notebook's process
    (``run_profile_process``); returns the record and the process's
    launches."""
    import shutil
    import tempfile

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.machinery.kubelet import container_env
    from odh_kubeflow_tpu_torch.machinery.objects import annotations_of
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.utils import profiling, tracing
    from odh_kubeflow_tpu_torch.utils.prometheus import parse_openmetrics
    from odh_kubeflow_tpu_torch.utils.slo import default_slos
    from odh_kubeflow_tpu_torch.webhooks.notebook import LOCK_ANNOTATION

    t_phase = time.perf_counter()
    fleet = observe_fleet()
    api, call, drive_until = fleet["api"], fleet["call"], fleet["drive_until"]
    ns, (pvc, mount) = OBSERVE_NS, OBSERVE_PVC
    scratch = tempfile.mkdtemp(prefix="platform-observe-logs-")
    steps: dict = {}
    record: dict = {"pool": dict(zip(("name", "accelerator", "nodes", "gpus_per_node"),
                                     OBSERVE_POOL))}

    def ok(code, out, want, what):
        if code != want:
            raise AssertionError(f"{what}: HTTP {code}, not {want}: {out}")
        return out

    def step(name):
        steps[name] = time.perf_counter() - marks.pop()
        marks.append(time.perf_counter())

    marks = [time.perf_counter()]
    saved_root = os.environ.get("TWA_LOCAL_LOGS_ROOT")
    try:
        # the SLO engine's first sample: burn rates are differences
        ok(*call("dashboard", "GET", "/api/slo?tick=1"), 200, "first SLO sample")
        # 1. the workgroup, its quota panel and a contributor
        ok(*call("dashboard", "POST", "/api/workgroup/create", {"namespace": ns}), 201,
           "workgroup create")
        api.patch("Profile", ns, {"spec": {"resourceQuotaSpec": {"hard": {
            f"requests.{apis.GPU_RESOURCE}": str(OBSERVE_QUOTA)}}}})
        drive_until(lambda: any(r["resource"] == f"requests.{apis.GPU_RESOURCE}"
                                for r in call("dashboard", "GET",
                                              f"/api/workgroup/quota/{ns}")[1].get("quota", [])),
                    "quota row")
        quota = call("dashboard", "GET", f"/api/workgroup/quota/{ns}")[1]["quota"]
        exists = call("dashboard", "GET", "/api/workgroup/exists")[1]
        binding = {"user": {"kind": "User", "name": OBSERVE_CONTRIBUTOR},
                   "referredNamespace": ns,
                   "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "ClusterRole",
                               "name": "kubeflow-edit"}}
        ok(*call("kfam", "POST", "/kfam/v1/bindings", binding), 201, "kfam binding")
        bindings = ok(*call("kfam", "GET", f"/kfam/v1/bindings?namespace={ns}"), 200,
                      "kfam bindings")["bindings"]
        contributors = ok(*call("dashboard", "GET", f"/api/workgroup/contributors/{ns}"), 200,
                          "contributors")["contributors"]
        denied = {"quota": call("dashboard", "GET", f"/api/workgroup/quota/{ns}",
                                user=OBSERVE_OUTSIDER)[0],
                  "activities": call("dashboard", "GET", f"/api/activities/{ns}",
                                     user=OBSERVE_OUTSIDER)[0],
                  "vwa": call("vwa", "GET", f"/api/namespaces/{ns}/pvcs",
                              user=OBSERVE_OUTSIDER)[0]}
        if OBSERVE_CONTRIBUTOR not in contributors or denied != {
                "quota": 403, "activities": 403, "vwa": 403}:
            raise AssertionError(f"contributors {contributors}, outsider {denied}")
        record["workgroup"] = {"exists": exists, "quota": quota, "bindings": len(bindings),
                               "contributors": contributors, "outsider": denied}
        step("workgroup")

        # 2. the trace volume
        ok(*call("vwa", "POST", f"/api/namespaces/{ns}/pvcs", {"pvc": {
            "metadata": {"name": pvc},
            "spec": {"accessModes": ["ReadWriteOnce"],
                     "resources": {"requests": {"storage": "10Gi"}}}}}), 201, "VWA POST")
        step("volume")

        # 3. the notebook: locked, released, ready; its spawn trace
        ok(*call("jwa", "POST", f"/api/namespaces/{ns}/notebooks", {
            "name": OBSERVE_NOTEBOOK, "image": SESSIONS_IMAGE, "cpu": "1", "memory": "4Gi",
            "gpus": {"accelerator": OBSERVE_POOL[1], "count": "1"},
            "dataVolumes": [{"mount": mount, "existingSource": {
                "persistentVolumeClaim": {"claimName": pvc}}}]}), 201, "JWA POST")
        exposition = fleet["registry"].exposition(openmetrics=True)
        nb = api.get("Notebook", OBSERVE_NOTEBOOK, ns)
        tid = tracing.trace_id_of(nb)
        locked = annotations_of(nb).get(LOCK_ANNOTATION)
        if not tid or locked != "odh-notebook-controller-lock":
            raise AssertionError(f"the POSTed notebook: trace {tid}, lock {locked}")

        def ready():
            sts = [s for s in api.list("StatefulSet", namespace=ns)
                   if s["metadata"]["name"] == OBSERVE_NOTEBOOK]
            return bool(sts and (sts[0].get("status") or {}).get("readyReplicas"))

        ready_rounds = drive_until(ready, "notebook ready")
        nb = api.get("Notebook", OBSERVE_NOTEBOOK, ns)
        exposure = {
            "lock_released": LOCK_ANNOTATION not in annotations_of(nb),
            "service_account": bool(api.list("ServiceAccount", namespace=ns,
                                             field_matches={"metadata.name": OBSERVE_NOTEBOOK})),
            "secrets": sorted(s["metadata"]["name"] for s in api.list("Secret", namespace=ns)
                              if s["metadata"]["name"].startswith(OBSERVE_NOTEBOOK)),
            "route_backend": api.get("HTTPRoute", OBSERVE_NOTEBOOK, ns)["spec"]["rules"][0][
                "backendRefs"][0],
            "network_policies": sorted(p["metadata"]["name"]
                                       for p in api.list("NetworkPolicy", namespace=ns)),
            "rounds_to_ready": ready_rounds,
        }
        if not exposure["lock_released"] or exposure["route_backend"] != {
                "name": f"{OBSERVE_NOTEBOOK}-tls", "port": 8443}:
            raise AssertionError(f"exposure: {exposure}")
        spans = fleet["collector"].trace(tid)
        tree = tracing.assemble(spans)

        def size(node):
            return 1 + sum(size(c) for c in node["children"])

        ends = {}
        for s in spans:
            ends[s.name] = max(ends.get(s.name, 0.0), s.end)
        names = sorted({s.name for s in spans})
        missing = [m for m in OBSERVE_MILESTONES if m not in ends]
        order = [ends.get(m) for m in OBSERVE_MILESTONES]
        exemplars = [ex[0].get("trace_id")
                     for _, labels, _, ex in parse_openmetrics(exposition)[
                         "http_request_duration_seconds"]["samples"]
                     if ex is not None and labels.get("app") == "jupyter-web-app"]
        trace = {"trace_id": tid, "spans": len(spans), "tree_nodes": size(tree),
                 "root": tree["span"].name, "names": names,
                 "milestone_end_offsets_s": {m: ends[m] - tree["span"].start
                                             for m in OBSERVE_MILESTONES if m in ends},
                 "causal_order": not missing and order == sorted(order),
                 "exemplar": tid in exemplars}
        if missing or not trace["causal_order"] or trace["tree_nodes"] != len(spans) or \
                not trace["exemplar"]:
            raise AssertionError(f"the spawn trace: {trace}")
        record.update(exposure=exposure, trace=trace)
        step("spawn")

        # 4. the profiled step on the card, in the notebook pod's env
        pod = api.get("Pod", f"{OBSERVE_NOTEBOOK}-0", ns)
        env = container_env(pod)
        trace_dir = fleet["pvc_dir"](pvc)
        env.update({"ODH_TORCH_KERNEL_CACHE": str(_build.BUILD_DIR),  # warm: built already
                    profiling.LOGDIR_ENV: os.path.join(trace_dir, "logs"),
                    profiling.PORT_ENV: str(free_port())})
        mounts = [m["mountPath"] for m in pod["spec"]["containers"][0]["volumeMounts"]]
        if mount not in mounts:
            raise AssertionError(f"the notebook pod mounts {mounts}, not {mount}")
        run = run_profile(env, scratch)
        want = TRAIN_LAUNCHES_PER_STEP
        if run["launched"] != want or run["traced"] != want or not math.isfinite(run["loss"]):
            raise AssertionError(f"the profiled step: launched {run['launched']}, traced "
                                 f"{run['traced']}, expected {want}; loss {run['loss']}")
        if run["built"] or not run["server"]:
            raise AssertionError(f"the notebook process built {run['built']}, capture server "
                                 f"{run['server']}")
        record["notebook_process"] = {k: run[k] for k in (
            "imported_s", "trainer_s", "first_step_s", "profiled_s", "process_s",
            "first_step_wall_s", "profiled_step_wall_s", "capture_wall_s", "first_loss", "loss", "launched", "traced", "device_ms",
            "trace_kernels", "trace_kernel_ms", "trace_events", "files", "server", "built",
            "device")}
        step("profile")

        # 5. TensorBoard over the trace volume
        ok(*call("twa", "POST", f"/api/namespaces/{ns}/tensorboards",
                 {"name": OBSERVE_TENSORBOARD, "logspath": f"pvc://{pvc}/logs"}), 201,
           "TWA POST")

        def tb_ready():
            rows = call("twa", "GET", f"/api/namespaces/{ns}/tensorboards")[1]["tensorboards"]
            return any(r["name"] == OBSERVE_TENSORBOARD and r["status"]["phase"] == "ready"
                       for r in rows)

        tb_rounds = drive_until(tb_ready, "tensorboard ready")
        spec = api.get("Deployment", OBSERVE_TENSORBOARD, ns)["spec"]["template"]["spec"]
        claims = [v.get("persistentVolumeClaim", {}).get("claimName")
                  for v in spec.get("volumes", [])]
        args = spec["containers"][0]["args"]
        if pvc not in claims or "--logdir=/logs/logs" not in args:
            raise AssertionError(f"the tensorboard Deployment: volumes {claims}, args {args}")
        pvc_logs = ok(*call("twa", "GET", f"/api/namespaces/{ns}/tensorboards/"
                                          f"{OBSERVE_TENSORBOARD}/logs"), 200, "TWA logs")
        os.environ["TWA_LOCAL_LOGS_ROOT"] = trace_dir
        local = f"{OBSERVE_TENSORBOARD}-local"
        ok(*call("twa", "POST", f"/api/namespaces/{ns}/tensorboards",
                 {"name": local, "logspath": os.path.join(trace_dir, "logs")}), 201,
           "TWA POST (local)")
        listing = ok(*call("twa", "GET", f"/api/namespaces/{ns}/tensorboards/{local}/logs"),
                     200, "TWA logs (local)")
        listed = [f["path"] for f in listing["files"] if f["path"].endswith(".trace.json.gz")]
        session = os.path.basename(run["sessions"][-1])
        if not listing["listable"] or not any(session in p for p in listed) or \
                pvc_logs.get("claim") != pvc or pvc_logs.get("listable"):
            raise AssertionError(f"TWA /logs: pvc {pvc_logs}, local {listing}")
        record["tensorboard"] = {
            "rounds_to_ready": tb_rounds, "claims": claims, "args": args,
            "image": spec["containers"][0]["image"],
            "pvc_logs": {k: pvc_logs[k] for k in ("scheme", "claim", "prefix", "listable")},
            "listed": listed}
        step("tensorboard")

        # 6. the dashboard's panels
        metrics = ok(*call("dashboard", "GET", "/api/metrics"), 200, "/api/metrics")
        panel = metrics[apis.ACCELERATOR_MAPPING["tpu"]]
        capacity = {r["accelerator"]: r[apis.ACCELERATOR_MAPPING["capacityChips"]] for r in panel}
        used = {r["accelerator"]: r[apis.ACCELERATOR_MAPPING["usedChips"]] for r in panel}
        slo = ok(*call("dashboard", "GET", "/api/slo?tick=1"), 200, "/api/slo")["slos"]
        usage = call("dashboard", "GET", "/api/usage")
        spawn_rows = [r for r in slo if r["slo"] == "spawn-ready-p99"]
        if capacity != {OBSERVE_POOL[1]: OBSERVE_POOL[2] * OBSERVE_POOL[3]} or \
                used != {OBSERVE_POOL[1]: 1} or \
                {r["slo"] for r in slo} != {s.name for s in default_slos()} or \
                not spawn_rows or min(r["total"] for r in spawn_rows) < 1 or usage[0] != 503:
            raise AssertionError(f"dashboard: metrics {metrics}, slo {slo}, usage {usage}")
        record["dashboard"] = {"metrics": metrics, "usage_status": usage[0],
                               "slo": [{k: r[k] for k in ("slo", "window", "total", "bad",
                                                          "burnRate", "alerting")}
                                       for r in slo]}
        step("dashboard")
    finally:
        if saved_root is None:
            os.environ.pop("TWA_LOCAL_LOGS_ROOT", None)
        else:
            os.environ["TWA_LOCAL_LOGS_ROOT"] = saved_root
        fleet["close"]()
        shutil.rmtree(scratch, ignore_errors=True)
        shutil.rmtree(fleet["root"], ignore_errors=True)
    record.update(phase="platform_observe", steps_s=steps,
                  seconds=time.perf_counter() - t_phase)
    return record, run["launches_total"]


# -- the metered path (slice 9, part 5) ----------------------------------------

USAGE_POOL = ("h100-u", "nvidia-h100-80gb", 2, 8)
USAGE_NS = "team-u"
USAGE_USER = "owner-u@example.com"
USAGE_NOTEBOOK = "nb-usage"
USAGE_STEPS = 12  # timed steps after the first
USAGE_IDLE_S = 25.0  # the process idles this long, holding its weights
USAGE_SAMPLE_S = 1.0  # the meter's cadence (UsageConfig.sample_seconds)
USAGE_WINDOW_S = 10.0  # the ledger's windows (UsageConfig.window_seconds)
USAGE_CULL_IDLE_S = 15.0
USAGE_AGENT_INTERVAL_S = 1.0  # the agent's sample interval
USAGE_ACTIVE_RTOL = 0.10  # active GPU-s over the steps vs their event time
USAGE_CONSERVATION_EPS = 0.05  # GPU-s: allocated == active + idle + unsampled
USAGE_LEDGER_EPS = 1e-3  # GPU-s: records round to 1e-6, read views to 1e-3
USAGE_CRASH_AFTER_S = 3.0  # into the idle window
USAGE_KILL_OP = 2  # WAL IO ops into the crashing flush: its first record's fsync
USAGE_PROCESS_LIMIT_S = 400
AGENT_PATH = os.path.join("images", "jupyter-pytorch-cuda", "gpu-activity-agent")
PROGRESS = "@progress "  # a notebook process's progress line (not its JSON record)


def progress(event: str, **kw) -> None:
    print(PROGRESS + json.dumps({"event": event, "at": time.time(), **kw}), flush=True)


def notebook_usage_main() -> int:
    """The metered notebook's process on the card (``chip_smoke.py
    --notebook-usage``, in the env its pod would give it, its kernel
    directory warm): it starts the GPU activity agent as its child
    (``GPU_AGENT_PORT`` from the env), then the ``train`` phase's model
    (Llama-3-8B at full width and depth, ``remat_policy="attn"``, int4
    base, LoRA r16 on wq/wk/wv/wo, batch 2 × 4096): one step, then
    ``USAGE_STEPS`` steps timed with CUDA events, then ``USAGE_IDLE_S`` of
    idling with its weights held. A progress line marks each window's
    end as it happens; the last line is one JSON record: the wall-clock
    bounds of each window (imports, init, first step, steps, idle), the
    steps' device ms, the losses and the launch counters over the 13
    steps."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    started_at = time.time()
    agent = subprocess.Popen(
        [sys.executable, os.path.join(here, AGENT_PATH)],
        env={**os.environ, "GPU_AGENT_INTERVAL": str(USAGE_AGENT_INTERVAL_S)},
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        agent_line = agent.stdout.readline().strip()
        progress("agent", line=agent_line)
        agent_at = time.time()
        import torch

        from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
        from odh_kubeflow_tpu_torch.models.lora import LoraConfig
        from odh_kubeflow_tpu_torch.ops import _build, int4
        from odh_kubeflow_tpu_torch.ops import flash_attention as fa
        from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

        imported_at = time.time()
        progress("imported")
        B, S = TRAIN_SHAPE
        cfg = LlamaConfig.llama3_8b(remat=True, remat_policy="attn")
        trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4",
                          precompile_batch=(B, S))
        batch = trainer.make_fake_batch(B, S, seed=1)
        torch.cuda.synchronize()
        init_at = time.time()
        progress("init")
        zero_counts(fa, int4)
        first_loss = float(trainer.train_step(batch)["loss"])
        first_step_at = time.time()
        progress("first_step")
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(USAGE_STEPS)]
        losses = []
        for start, end in events:
            start.record()
            losses.append(trainer.train_step(batch)["loss"])
            end.record()
        torch.cuda.synchronize()
        steps_at = time.time()
        progress("steps")
        launched = counts(fa, int4)
        step_ms = [a.elapsed_time(b) for a, b in events]
        losses = [float(x) for x in losses]
        time.sleep(USAGE_IDLE_S)  # idle, the weights held
        idle_at = time.time()
        emit({"started_at": started_at, "agent_at": agent_at, "imported_at": imported_at,
              "init_at": init_at, "first_step_at": first_step_at, "steps_at": steps_at,
              "idle_at": idle_at,
              "windows": {"imports": [agent_at, imported_at], "init": [imported_at, init_at],
                          "first_step": [init_at, first_step_at],
                          "steps": [first_step_at, steps_at], "idle": [steps_at, idle_at]},
              "agent": agent_line, "first_loss": first_loss, "losses": losses,
              "step_ms": step_ms, "steps_device_s": sum(step_ms) / 1e3,
              "launched": launched, "built": sorted(_build.build_logs),
              "device": torch.cuda.get_device_name(0)})
        return 0
    finally:
        agent.terminate()
        agent.wait(timeout=10)


class _Recorder:
    """A histogram that also keeps every observation (the phase's
    percentiles; the histogram's buckets are too coarse for a p50)."""

    def __init__(self, hist, sink: list):
        self.hist, self.sink = hist, sink

    def observe(self, value: float) -> None:
        self.sink.append(value)
        self.hist.observe(value)


def usage_control_plane(wal_dir: str, agent_url: str, jupyter_url: str, registry, slo_engine,
                        io=None, first: bool = False) -> dict:
    """One incarnation of the metered control plane: the store recovered
    from ``wal_dir`` (through ``io``, a ``KillPointIO`` for the one that
    dies), the CRDs, the PodDefault and notebook webhooks, the kubelet
    simulator (``first``: with its ``USAGE_POOL`` nodes), the notebook
    (queueing, culling), profile controllers, the ``SessionManager`` and
    the ``SliceScheduler``, one ``UsageMeter`` (1 s samples, 10 s windows)
    whose ``sample_fn`` GETs the agent at ``agent_url``, the culler
    (15 s idle, its duty probe on the same agent) — every one of them
    wired to the meter — and the JWA and dashboard over HTTP on
    localhost. The registry and the SLO engine are the web tier's, which
    outlives a store. Each agent answer the meter or the culler reads
    lands in ``payloads``. Needs no card."""
    import tempfile

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.controllers.culler import Culler, CullerConfig
    from odh_kubeflow_tpu_torch.controllers.notebook import (
        NotebookController, NotebookControllerConfig)
    from odh_kubeflow_tpu_torch.controllers.profile import ProfileController
    from odh_kubeflow_tpu_torch.controllers.runtime import Manager
    from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.machinery.usage import UsageConfig, UsageMeter, register_usage
    from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.scheduling.scheduler import SliceScheduler
    from odh_kubeflow_tpu_torch.sessions import register_sessions
    from odh_kubeflow_tpu_torch.sessions.manager import SessionConfig, SessionManager
    from odh_kubeflow_tpu_torch.web.dashboard import DashboardApp
    from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
    from odh_kubeflow_tpu_torch.webhooks import NotebookWebhook, PodDefaultWebhook

    t0 = time.perf_counter()
    wal = WriteAheadLog(wal_dir, io=io)
    api = APIServer.recover(wal)
    recovered_s = time.perf_counter() - t0
    apis.register_crds(api)
    register_scheduling(api)
    register_sessions(api)
    register_usage(api)
    apis.install_default_cluster_roles(api)
    api.attach_metrics(registry)
    acks, batches = [], []
    api._m_ack = _Recorder(api._m_ack, acks)
    api._m_batch = _Recorder(api._m_batch, batches)
    PodDefaultWebhook(api).register()
    NotebookWebhook(api).register()
    cluster = FakeCluster(api)
    if first:
        name, accel, nodes, per_node = USAGE_POOL
        cluster.add_gpu_node_pool(name, accel, num_nodes=nodes, gpus_per_node=per_node)
    payloads: list = []

    def get_agent(url: str):
        try:
            with urllib.request.urlopen(url, timeout=2.0) as r:
                got = json.loads(r.read().decode())
        except (urllib.error.URLError, OSError, ValueError):
            return None
        payloads.append((time.time(), got))
        return got

    def sample_fn(namespace: str, notebook: str):
        got = get_agent(agent_url)
        try:
            return float(got["duty_cycle_pct"]) if isinstance(got, dict) else None
        except (KeyError, TypeError, ValueError):
            return None

    meter = UsageMeter(api, UsageConfig(enabled=True, sample_seconds=USAGE_SAMPLE_S,
                                        window_seconds=USAGE_WINDOW_S),
                       registry=registry, sample_fn=sample_fn)
    mgr = Manager(api, registry=registry)
    culler = Culler(api, CullerConfig(cull_idle_seconds=USAGE_CULL_IDLE_S,
                                      idleness_check_seconds=USAGE_SAMPLE_S),
                    base_url_fn=lambda nb: jupyter_url, gpu_url_fn=lambda nb: agent_url,
                    meter=meter)
    plain_get = culler._get_json
    culler._get_json = lambda url: get_agent(url) if url == agent_url else plain_get(url)
    NotebookController(api, NotebookControllerConfig(enable_queueing=True, enable_culling=True),
                       registry=registry, culler=culler, meter=meter).register(mgr)
    ProfileController(api, registry=registry).register(mgr)
    sessions = SessionManager(api, SessionConfig(checkpoint_dir=tempfile.mkdtemp(
        prefix="platform-usage-ckpt-")), registry=registry, runtime=cluster.session_runtime,
        meter=meter)
    sessions.register(mgr)
    SliceScheduler(api, registry=registry, suspender=sessions, meter=meter).register(mgr)
    apps = {"jwa": JupyterWebApp(api, registry=registry, meter=meter),
            "dashboard": DashboardApp(api, registry=registry, slo_engine=slo_engine,
                                      meter=meter)}
    servers = {k: app.app.serve("127.0.0.1", 0) for k, app in apps.items()}

    def call(app: str, method: str, path: str, body=None, user=USAGE_USER):
        req = urllib.request.Request(
            f"http://127.0.0.1:{servers[app].server_address[1]}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json", "kubeflow-userid": user,
                     "Cookie": "XSRF-TOKEN=u", "X-XSRF-TOKEN": "u"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def close() -> None:
        if servers.pop("closed", None) is None:
            for server in list(servers.values()):
                server.shutdown()
                server.server_close()
            servers["closed"] = True
            mgr.stop()
            api.close()

    return {"api": api, "wal": wal, "cluster": cluster, "meter": meter, "mgr": mgr,
            "culler": culler, "call": call, "close": close, "acks": acks, "batches": batches,
            "payloads": payloads, "recovered_s": recovered_s}


def run_usage_process(env: dict, scratch: str) -> "subprocess.Popen":
    """``chip_smoke.py --notebook-usage`` in ``env`` (the notebook pod's
    resolved env), its stdout in ``<scratch>/usage.out``."""
    import subprocess

    out = open(os.path.join(scratch, "usage.out"), "w")
    err = open(os.path.join(scratch, "usage.err"), "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--notebook-usage"],
        env={**os.environ, **env, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))},
        stdout=out, stderr=err)


def attributed_spans(samples, start: float, end: float, gap: float) -> list:
    """The meter's trailing attribution, straight-line: each sample
    ``(t, duty)`` after ``start`` covers ``(previous, t]`` when that span
    is at most ``gap`` long (else it stays unsampled); samples at or
    before the previous one are stale; none past ``end`` counts."""
    spans, prev = [], start
    for t, duty in samples:
        if t <= prev:
            continue
        if t > end:
            break
        if t - prev <= gap:
            spans.append((prev, t, min(max(duty, 0.0), 100.0)))
        prev = t
    return spans


def window_seconds(spans, a: float, b: float) -> tuple:
    """(active, sampled) seconds of ``spans`` inside ``[a, b]``."""
    active = sampled = 0.0
    for s, e, duty in spans:
        overlap = max(0.0, min(e, b) - max(s, a))
        sampled += overlap
        active += overlap * duty / 100.0
    return active, sampled


def timeline_samples(meter, namespace: str, notebook: str) -> tuple:
    """The (t, duty) samples and the marks of one notebook's timeline."""
    rows = [r for r in meter.timelines(namespace, limit=10_000) if r["notebook"] == notebook]
    events = rows[0]["events"] if rows else []
    return ([(e["t"], e["value"]) for e in events if e["kind"] == "sample"],
            [(e["t"], e["value"]) for e in events if e["kind"] == "mark"])


def platform_usage_phase(run_process=run_usage_process) -> tuple[dict, dict]:
    """GPU-second metering on a crash-safe store (``usage_control_plane``):

    1. a user's profile, then the JWA POSTs a 1-GPU notebook; the
       scheduler admits its Workload and the meter opens a 1-GPU
       allocation;
    2. the notebook's process on the card (``run_process``, in the pod's
       env): the GPU activity agent, the 8B QLoRA first step, 12 steps
       timed with CUDA events, 25 s idle. Every ``USAGE_SAMPLE_S`` the
       phase drives the controllers (the culler probes the agent and feeds
       the meter) and polls the meter (sweep, sample, flush);
    3. ``USAGE_CRASH_AFTER_S`` into the idle window the store dies at the
       fsync of a flush's first record (``KillPointIO``); the phase
       recovers the store from its WAL, a new meter ``recover()``s the
       ledger, new controllers and web apps take over, and the process
       runs on;
    4. the culler stamps activity from the agent's duty through the
       steps (no Jupyter traffic: busy-but-quiet), stops the notebook once
       it has idled ``USAGE_CULL_IDLE_S``, and the release closes the
       allocation;
    5. the checks: the agent read ``device-metrics`` every time; the active
       GPU-seconds over the steps equal their event time within 10% ± one
       sample, the idle window counts as idle; conservation; the records
       sum to the live totals and to a straight-line sum of the samples
       (across the crash: nothing lost, nothing counted twice);
       ``/api/usage`` and the JWA's usage block; ``gpu_seconds_total``'s
       active phase and ``idle-waste`` above zero; 13 steps' launches.

    ``run_process(env, scratch)`` starts the notebook's process
    (``run_usage_process``) and returns its ``Popen``; returns the
    record and the process's launches."""
    import shutil
    import tempfile
    from http.server import HTTPServer

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.conformance import _IdleJupyter
    from odh_kubeflow_tpu_torch.controllers.culler import _parse_time
    from odh_kubeflow_tpu_torch.machinery import usage as usage_lib
    from odh_kubeflow_tpu_torch.machinery.faults import KillPointIO
    from odh_kubeflow_tpu_torch.machinery.kubelet import container_env
    from odh_kubeflow_tpu_torch.machinery.objects import annotations_of
    from odh_kubeflow_tpu_torch.machinery.wal import CrashPoint
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry
    from odh_kubeflow_tpu_torch.utils.slo import SLOEngine

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="platform-usage-")
    wal_dir = os.path.join(root, "wal")
    ns, nb_name = USAGE_NS, USAGE_NOTEBOOK
    agent_port = free_port()
    agent_url = f"http://127.0.0.1:{agent_port}" + apis.ACCELERATOR_MAPPING["/api/tpu/activity"]
    class Kernel(_IdleJupyter):
        """The notebook's idle kernel: last active when the cell that
        started the run last printed."""

    Kernel.idle_since = time.time()
    jupyter = HTTPServer(("127.0.0.1", 0), Kernel)
    threading.Thread(target=jupyter.serve_forever, daemon=True).start()
    jupyter_url = f"http://127.0.0.1:{jupyter.server_port}"
    registry = Registry()
    slo_engine = SLOEngine(registry)
    kill_io = KillPointIO(kill_at_op=1 << 62, seed=SPAWN_SEED)
    plane = usage_control_plane(wal_dir, agent_url, jupyter_url, registry, slo_engine,
                                io=kill_io, first=True)
    first_plane = plane
    planes = [plane]
    steps: dict = {}
    record: dict = {"pool": dict(zip(("name", "accelerator", "nodes", "gpus_per_node"),
                                     USAGE_POOL))}
    proc = None
    marks = [time.perf_counter()]

    def step(name):
        steps[name] = time.perf_counter() - marks.pop()
        marks.append(time.perf_counter())

    def ok(code, out, want, what):
        if code != want:
            raise AssertionError(f"{what}: HTTP {code}, not {want}: {out}")
        return out

    def tick() -> None:
        plane["mgr"].drain(max_rounds=OBSERVE_MAX_ROUNDS)
        plane["cluster"].step()
        plane["mgr"].drain(max_rounds=OBSERVE_MAX_ROUNDS)

    try:
        ok(*plane["call"]("dashboard", "GET", "/api/slo?tick=1"), 200, "first SLO sample")
        plane["api"].create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                             "metadata": {"name": ns},
                             "spec": {"owner": {"kind": "User", "name": USAGE_USER}}})
        tick()
        # 1. the notebook, admitted: the meter opens a 1-GPU allocation
        ok(*plane["call"]("jwa", "POST", f"/api/namespaces/{ns}/notebooks", {
            "name": nb_name, "image": SESSIONS_IMAGE, "cpu": "1", "memory": "4Gi",
            "gpus": {"accelerator": USAGE_POOL[1], "count": "1"}}), 201, "JWA POST")
        for _ in range(OBSERVE_MAX_ROUNDS):
            tick()
            sts = [s for s in plane["api"].list("StatefulSet", namespace=ns)
                   if s["metadata"]["name"] == nb_name]
            if sts and (sts[0].get("status") or {}).get("readyReplicas"):
                break
        else:
            raise AssertionError("the metered notebook never became ready")
        opened = plane["meter"].notebook_usage(ns, nb_name)
        if not opened["allocated"] or opened["gpus"] != 1:
            raise AssertionError(f"the meter's allocation at admission: {opened}")
        admit_t = plane["meter"]._open[(ns, nb_name)].opened_at
        step("spawn")

        # 2. the notebook's process; the control plane ticks beside it
        pod = plane["api"].get("Pod", f"{nb_name}-0", ns)
        env = container_env(pod)
        env.update({"ODH_TORCH_KERNEL_CACHE": str(_build.BUILD_DIR),  # warm: built already
                    "GPU_AGENT_PORT": str(agent_port)})
        scratch = os.path.join(root, "process")
        os.makedirs(scratch, exist_ok=True)
        proc = run_process(env, scratch)
        out_path = os.path.join(scratch, "usage.out")
        seen: dict = {}
        crash = None
        released_t = None
        deadline = time.time() + USAGE_PROCESS_LIMIT_S
        next_t = time.time()
        while True:
            for line in open(out_path).read().splitlines():
                if line.startswith(PROGRESS):
                    ev = json.loads(line[len(PROGRESS):])
                    if ev["event"] not in seen:
                        seen[ev["event"]] = ev["at"]
                        if ev["event"] in ("agent", "imported"):
                            # the cell that started the run, and its
                            # first output: the kernel's last activity
                            Kernel.idle_since = ev["at"]
            tick()
            if crash is None and "steps" in seen and \
                    time.time() >= seen["steps"] + USAGE_CRASH_AFTER_S:
                # 3. the store dies inside a flush, at its first record's fsync
                wal_io = plane["wal"].io
                ops_before = wal_io.ops
                wal_io.kill_at = ops_before + USAGE_KILL_OP
                try:
                    plane["meter"].poll()
                    raise AssertionError("the flush survived its kill point")
                except CrashPoint as e:
                    died_at = time.time()
                    crash = {"at": died_at, "error": str(e), "wal_ops": wal_io.ops,
                             "kill_at_op": wal_io.kill_at}
                dead = plane
                dead["close"]()
                t0 = time.perf_counter()
                plane = usage_control_plane(wal_dir, agent_url, jupyter_url, registry,
                                            slo_engine)
                plane["meter"].recover()
                planes.append(plane)
                records = plane["api"].list("UsageRecord", namespace=ns)
                resumed_from = max((r["status"]["flushedThrough"] for r in records),
                                   default=admit_t)
                crash.update(recovery_s=time.perf_counter() - t0,
                             store_recover_s=plane["recovered_s"],
                             resumed_from=resumed_from, lost_s=died_at - resumed_from,
                             records_recovered=len(records),
                             open_after_recover=plane["meter"].notebook_usage(
                                 ns, nb_name)["allocated"])
            else:
                plane["meter"].poll()
            usage_now = plane["meter"].notebook_usage(ns, nb_name)
            if released_t is None and crash is not None and not usage_now["allocated"]:
                released_t = time.time()
            if proc.poll() is not None and (released_t is not None or
                                            proc.returncode != 0):
                break
            if time.time() > deadline:
                raise AssertionError(f"the metered process ran past {USAGE_PROCESS_LIMIT_S}s")
            next_t += USAGE_SAMPLE_S
            time.sleep(max(0.0, next_t - time.time()))
        lines = [x for x in open(out_path).read().splitlines() if x.startswith("{")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"the metered notebook process exit {proc.returncode}: "
                                 f"{open(os.path.join(scratch, 'usage.err')).read()[-3000:]}")
        run = json.loads(lines[-1])
        if crash is None:
            raise AssertionError("the store never crashed: the idle window was too short")
        step("process")

        # 4-5. the ledger, closed
        meter, api = plane["meter"], plane["api"]
        meter.flush()
        end_t = time.time()
        nb = api.get("Notebook", nb_name, ns)
        ann = annotations_of(nb)
        samples1, _ = timeline_samples(first_plane["meter"], ns, nb_name)
        samples2, marks2 = timeline_samples(meter, ns, nb_name)
        releases = [t for t, label in marks2 if str(label).startswith("released:")]
        if apis.STOP_ANNOTATION not in ann or not releases:
            raise AssertionError(f"the culler did not stop the notebook: {ann}, marks {marks2}")
        release_t = releases[0]
        gap = 4.0 * USAGE_SAMPLE_S  # UsageConfig.max_sample_gap
        resumed_from = crash["resumed_from"]
        spans = (attributed_spans([s for s in samples1 if s[0] <= resumed_from], admit_t,
                                  resumed_from, gap)
                 + attributed_spans(samples2, resumed_from, release_t, gap))
        longest = max(e - s for s, e, _ in spans)
        gpus = 1
        line = {"allocated": gpus * (release_t - admit_t),
                "active": gpus * sum((e - s) * d / 100.0 for s, e, d in spans),
                "sampled": gpus * sum(e - s for s, e, _ in spans)}
        row = [r for r in meter.summary(t=end_t)["namespaces"] if r["namespace"] == ns][0]
        live = {"allocated": row[usage_lib.ALLOCATED], "active": row[usage_lib.ACTIVE],
                "idle": row[usage_lib.IDLE], "unsampled": row[usage_lib.UNSAMPLED]}
        persisted = {"allocated": 0.0, "active": 0.0, "idle": 0.0, "unsampled": 0.0,
                     "sampled": 0.0}
        recs = api.list("UsageRecord", namespace=ns)
        for rec in recs:
            st = rec["status"]
            for k, f in (("allocated", usage_lib.ALLOCATED), ("active", usage_lib.ACTIVE),
                         ("idle", usage_lib.IDLE), ("unsampled", usage_lib.UNSAMPLED),
                         ("sampled", usage_lib.SAMPLED)):
                persisted[k] += st[f]
        sources = sorted({p.get("source") for p0 in planes for _, p in p0["payloads"]
                          if isinstance(p, dict)})
        n_payloads = sum(len(p0["payloads"]) for p0 in planes)
        w = run["windows"]
        steps_active, steps_sampled = window_seconds(spans, *w["steps"])
        idle_active, idle_sampled = window_seconds(spans, w["idle"][0], release_t)
        idle_window = release_t - w["idle"][0]

        def mean_duty(a, b):
            act, smp = window_seconds(spans, a, b)
            return 100.0 * act / smp if smp else None

        stop_t = _parse_time(ann[apis.STOP_ANNOTATION])
        last_busy = max((t for t, d in samples1 + samples2
                         if d >= 5.0 and t <= release_t), default=None)
        checks = {
            "device_metrics_every_sample": sources == ["device-metrics"] and n_payloads > 0,
            "steps_active": abs(steps_active - run["steps_device_s"])
                            <= USAGE_ACTIVE_RTOL * run["steps_device_s"] + longest,
            "idle_active": idle_active <= longest,
            "idle_counted_idle": abs((idle_sampled - idle_active) - idle_window) <= longest,
            "conservation": abs(live["allocated"] - live["active"] - live["idle"]
                                - live["unsampled"]) <= USAGE_CONSERVATION_EPS,
            "records_sum_to_live": all(abs(persisted[k] - live[k]) <= USAGE_LEDGER_EPS
                                       for k in live),
            "straight_line": all(abs(line[k] - persisted[k]) <= USAGE_LEDGER_EPS
                                 for k in line),
            "culler_spared_steps": stop_t >= w["steps"][1] + USAGE_CULL_IDLE_S - 1.0,
            "culler_stopped_idle": stop_t <= w["idle"][1],
            "release_after_last_busy": last_busy is not None and release_t > last_busy,
            "launches": run["launched"] == {k: (1 + USAGE_STEPS) * v
                                            for k, v in TRAIN_LAUNCHES_PER_STEP.items()},
            "wal_recovered": crash["records_recovered"] > 0 and crash["open_after_recover"],
        }
        # the web tier's views of the same ledger
        code, usage = plane["call"]("dashboard", "GET", "/api/usage")
        ns_rows = [r for r in (usage.get("usage") or {}).get("namespaces", [])
                   if r["namespace"] == ns]
        details = ok(*plane["call"]("jwa", "GET",
                                    f"/api/namespaces/{ns}/notebooks/{nb_name}/details"),
                     200, "JWA details")
        block = details["details"].get("usage") or {}
        slo_rows = ok(*plane["call"]("dashboard", "GET", "/api/slo?tick=1"), 200,
                      "/api/slo")["slos"]
        idle_waste = [r for r in slo_rows if r["slo"] == "idle-waste"]
        active_counter = meter.m_gpu_seconds.value({"namespace": ns, "phase": "active"})
        checks.update({
            "api_usage": code == 200 and bool(ns_rows) and abs(
                ns_rows[0][usage_lib.ALLOCATED] - live["allocated"]) <= USAGE_LEDGER_EPS,
            "jwa_usage": abs(block.get(usage_lib.ALLOCATED, -1) - live["allocated"])
                         <= USAGE_LEDGER_EPS
                         and abs(block.get(usage_lib.ACTIVE, -1) - live["active"])
                         <= USAGE_LEDGER_EPS,
            "gpu_seconds_active": active_counter > 0,
            "idle_waste": bool(idle_waste) and max(r["total"] for r in idle_waste) > 0
                          and max(r["bad"] for r in idle_waste) > 0,
        })
        wal_stats = {"fsyncs": sum(p["wal"].fsync_total for p in planes),
                     "records": sum(p["wal"].appended_total for p in planes),
                     "batches": sum(len(p["batches"]) for p in planes)}
        acks = sorted(a for p in planes for a in p["acks"])
        batch_sizes = [b for p in planes for b in p["batches"]]
        wal_stats.update(
            mean_batch=statistics.fmean(batch_sizes) if batch_sizes else None,
            ack_p50_ms=1e3 * acks[len(acks) // 2] if acks else None,
            ack_p99_ms=1e3 * acks[min(len(acks) - 1, int(0.99 * len(acks)))] if acks else None,
            acks=len(acks))
        record.update(
            process={k: run[k] for k in ("windows", "step_ms", "steps_device_s", "first_loss",
                                         "losses", "launched", "built", "agent", "device")},
            step_s=[ms / 1e3 for ms in run["step_ms"]],
            duty={"imports": mean_duty(*w["imports"]), "init": mean_duty(*w["init"]),
                  "first_step": mean_duty(*w["first_step"]), "steps": mean_duty(*w["steps"]),
                  "idle": mean_duty(w["idle"][0], release_t)},
            steps_window={"active_gpu_s": steps_active, "sampled_gpu_s": steps_sampled,
                          "event_s": run["steps_device_s"],
                          "wall_s": w["steps"][1] - w["steps"][0]},
            idle_window={"active_gpu_s": idle_active,
                         "idle_gpu_s": idle_sampled - idle_active, "window_s": idle_window},
            longest_sample_s=longest, samples=len(spans), agent_reads=n_payloads,
            sources=sources, ledger={"live": live, "persisted": persisted,
                                     "straight_line": line, "records": len(recs)},
            culler={"stop_at_after_steps_s": stop_t - w["steps"][1],
                    "release_after_steps_s": release_t - w["steps"][1],
                    "last_activity": ann.get(apis.LAST_ACTIVITY_ANNOTATION)},
            crash=crash, wal=wal_stats, api_usage=ns_rows[0] if ns_rows else None,
            jwa_usage=block, idle_waste=idle_waste, checks=checks)
        failed = [k for k, v in checks.items() if not v]
        if failed:
            raise AssertionError(f"platform_usage checks failed: {failed}: {record}")
        step("ledger")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for p in planes:
            try:
                p["close"]()
            except Exception:  # noqa: BLE001 — the dead store closes once already
                pass
        jupyter.shutdown()
        jupyter.server_close()
        shutil.rmtree(root, ignore_errors=True)
    record.update(phase="platform_usage", steps_s=steps,
                  seconds=time.perf_counter() - t_phase)
    return record, run["launched"]


# the platform over the wire (slice 9, part 6): the apiserver is this
# process (the store with a WAL, the REST façade over TLS with bearer
# tokens on the event loop, the admission webhooks, the JWA); the
# controllers (``--platform-controllers``), a user flood
# (``--platform-flood``) and the spawned notebook (``--notebook-serve``)
# are processes of their own, as the manifests deploy them
REMOTE_POOL = ("h100-r", "nvidia-h100-80gb", 2, 8)
REMOTE_NAMESPACES = ("team-r0", "team-r1", "team-r2", "team-r3")
REMOTE_SLOW_NS = "team-r3"  # one of four: its reads carry the injected latency
REMOTE_USER = "owner-r@example.com"
REMOTE_TOKENS = {"controller": "remote-controller-token", "flood": "remote-user-token"}
REMOTE_INFLIGHT_LIMIT = 32  # APF_INFLIGHT_LIMIT
# level ceilings: controllers may fill 22 of the 32 seats (the drill's
# 70%, loadtest/overload_drill.py DRILL_ENV), user traffic 4 (12.5%, not
# the drill's 50%): the façade serves one Python process, whose loop
# caps the requests a second, so 128 user clients keep only a few
# handlers in flight at once (a seat is held for a handler's run, not
# for the wait at the loop), where the drill's workers hold a seat each
REMOTE_APF_ENV = {"APF_LEVEL_SYSTEM": "100", "APF_LEVEL_CONTROLLER": "70",
                  "APF_LEVEL_USER": "12.5", "APF_LEVEL_BACKGROUND": "6.25"}
# the flood clients' breakers on the drill's compressed timescale
# (overload_drill.py DRILL_ENV: a 0.5 s window of 5 calls, 0.25 s
# cooldowns), but for its 0.02 s slow-call threshold: the drill's calls
# take 1 ms in process, a call here a TLS handshake (14-16 ms p50 at the
# paced baseline on the H100 machine). With the defaults (10 s, 1 s) the
# breakers kept the flood off the façade for most of it, and the user
# seats' ceiling shed as few as 8 requests in its 12 s
REMOTE_FLOOD_BREAKER_ENV = {"BREAKER_WINDOW_SECONDS": "0.5", "BREAKER_MIN_REQUESTS": "5",
                            "BREAKER_COOLDOWN_SECONDS": "0.25"}
REMOTE_WORKERS = 64  # WEB_WORKERS: the façade's handler pool
REMOTE_SEED = 20260807  # the drill's seed
REMOTE_FLOOD_THREADS = 128  # 4x the inflight limit
REMOTE_BASE_THREADS = 16  # under the limit: the baseline and the recovery
# the baseline's and the recovery's users are paced, each one request a
# period (64/s in all), so that they stay under the limit: closed-loop,
# 16 users filled the façade (104-244 ok/s on the H100 machine, with
# 429s at the user seats and client timeouts), and its throughput then
# read the host's load at that moment, not the façade's health
REMOTE_USER_PERIOD_S = 0.25
# the user threads run in this many processes of their own (one Python
# process cannot open TLS connections fast enough to load the façade)
REMOTE_FLOOD_PROCESSES = 4
REMOTE_BASE_S = 2.0
# "about 10 s": 12, so that the second notebook, POSTed in its middle,
# has 6 s to reach Running (4.3 s on the H100 machine with 10 s)
REMOTE_FLOOD_S = 12.0
REMOTE_WINDOW_S = 1.0  # recovery windows
REMOTE_RECOVERY_S = 10.0
REMOTE_USER_DEADLINE_S = 0.1  # overload_drill.py LEVEL_DEADLINES[user]
REMOTE_USER_PAUSE_S = 0.05  # a user's pause after a refused or failed request
REMOTE_EXPIRED_SHARE = 0.05
REMOTE_WRITE_SHARE = 0.2
REMOTE_LIST_SHARE = 0.2
REMOTE_OBJECTS = 16  # ConfigMaps per namespace that the flood reads and patches
REMOTE_INJECTED_LATENCY_S = 0.04  # overload_drill.py INJECTED_LATENCY_S
REMOTE_WATCHES = 500
REMOTE_WATCH_THREADS_GATE = 10  # tests/test_webtier.py:418
REMOTE_ATTEMPTS_GATE = 1.3
REMOTE_RECOVERY_GATE = 0.95
REMOTE_STEP_S = 0.1  # the kubelet simulator's pass interval
REMOTE_RUNNING_LIMIT_S = 60.0
# the remote spawn trace's milestones, in causal order (first start)
REMOTE_MILESTONES = ("reconcile", "scheduler.admit", "kubelet.container_start")
EXPIRED_HEADER = "X-Smoke-Expired"  # marks the flood's already-expired requests


class SlowNamespace:
    """The store as the façade serves it, with ``FaultInjector``'s latency
    on the reads (get, list, list_chunk) of one namespace; everything else
    goes straight to the store."""

    def __init__(self, api, injector, namespace: str):
        self._api, self._injector, self._ns = api, injector, namespace

    def __getattr__(self, name: str):
        return getattr(self._api, name)

    def _slow(self, namespace) -> None:
        if namespace == self._ns:
            self._injector._fault_point("read", mutating=False)

    def get(self, kind, name, namespace=None):
        self._slow(namespace)
        return self._api.get(kind, name, namespace)

    def list(self, kind, namespace=None, **kw):
        self._slow(namespace)
        return self._api.list(kind, namespace=namespace, **kw)

    def list_chunk(self, kind, namespace=None, **kw):
        self._slow(namespace)
        return self._api.list_chunk(kind, namespace=namespace, **kw)


def remote_apiserver(root: str) -> dict:
    """The apiserver process's side of the phase (needs no card): the
    port's store with a write-ahead log under ``root``, CRDs, the default
    cluster roles, the notebook and PodDefault admission webhooks with the
    GPU-runtime PodDefault in each namespace, the user's edit binding, the
    flood's ConfigMaps; ``httpapi.serve`` over TLS (certificates from
    ``webhooks/certs.py``) with a ``TokenAuthenticator``, on the event
    loop, ``APF_INFLIGHT_LIMIT`` 32, one namespace's reads slowed by
    ``FaultInjector``; the JWA on microweb's event loop. Returns the
    handles; ``fleet["close"]()`` stops it."""
    import ssl

    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.machinery import eventloop, httpapi
    from odh_kubeflow_tpu_torch.machinery.faults import FaultInjector, FaultSchedule
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.utils import tracing
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry
    from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
    from odh_kubeflow_tpu_torch.webhooks import (
        NotebookWebhook, PodDefaultWebhook, gpu_runtime_poddefault)
    from odh_kubeflow_tpu_torch.webhooks.certs import generate_webhook_certs

    os.makedirs(root, exist_ok=True)
    cert, key, ca = generate_webhook_certs(dns_names=["localhost"],
                                           ip_sans=["127.0.0.1"]).write(root)
    token_file = os.path.join(root, "tokens.csv")
    with open(token_file, "w") as f:
        f.write(f"{REMOTE_TOKENS['controller']},system:serviceaccount:kubeflow:"
                "notebook-controller,uid-c\n")
        f.write(f"{REMOTE_TOKENS['flood']},{REMOTE_USER},uid-u\n")
    collector = tracing.SpanCollector()
    old_collector = tracing.set_collector(collector)
    api = APIServer(wal=WriteAheadLog(os.path.join(root, "wal")))
    registry = Registry()
    api.attach_metrics(registry)
    apis.register_crds(api)
    register_scheduling(api)
    apis.install_default_cluster_roles(api)
    PodDefaultWebhook(api).register()
    NotebookWebhook(api).register()
    for ns in REMOTE_NAMESPACES:
        api.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": ns}})
        api.create(gpu_runtime_poddefault(ns))
        api.create({"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
                    "metadata": {"name": "owner-edit", "namespace": ns},
                    "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                                "kind": "ClusterRole", "name": "kubeflow-edit"},
                    "subjects": [{"kind": "User", "name": REMOTE_USER}]})
        for i in range(REMOTE_OBJECTS):
            api.create({"apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": f"cm-{i:02d}", "namespace": ns},
                        "data": {"n": "0"}})
    injector = FaultInjector(api, seed=REMOTE_SEED, registry=registry, schedule=FaultSchedule(
        latency=1.0, latency_seconds=REMOTE_INJECTED_LATENCY_S))
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    # WEB_INLINE_THRESHOLD_MS=0: every handler runs in the worker pool,
    # so the seats the limiter counts are the handlers in flight (a
    # handler inline on the loop runs alone and never fills a seat)
    inline = eventloop.INLINE_THRESHOLD_SECONDS
    eventloop.INLINE_THRESHOLD_SECONDS = 0.0
    saved = {k: os.environ.get(k) for k in REMOTE_APF_ENV}
    os.environ.update(REMOTE_APF_ENV)  # read once, when the limiter is built
    try:
        _, port, httpd = httpapi.serve(
            SlowNamespace(api, injector, REMOTE_SLOW_NS), ssl_context=ctx,
            authenticator=httpapi.TokenAuthenticator.from_file(token_file),
            metrics_registry=registry, inflight_limit=REMOTE_INFLIGHT_LIMIT,
            event_loop=True, workers=REMOTE_WORKERS)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rest = httpd._app  # the façade's WSGI app (RestAPI)
    # REST handler ms by level and time, and handler runs for requests
    # that arrived with their deadline spent (there must be none)
    samples: list = []
    expired_handled = [0]
    handle, dispatch = rest._handle, rest._dispatch
    expired_key = "HTTP_" + EXPIRED_HEADER.upper().replace("-", "_")

    def timed_handle(environ, start_response):
        t0 = time.perf_counter()
        try:
            return handle(environ, start_response)
        finally:
            controller = ("odh=controller" in environ.get("HTTP_TRACESTATE", "")
                          or environ.get("HTTP_X_PRIORITY_LEVEL") == "controller")
            samples.append((time.time(), "controller" if controller else "user",
                            (time.perf_counter() - t0) * 1e3))

    def counted_dispatch(kind, route, method, qs, environ, start_response):
        if environ.get(expired_key):
            expired_handled[0] += 1
        return dispatch(kind, route, method, qs, environ, start_response)

    rest._handle, rest._dispatch = timed_handle, counted_dispatch
    jwa_httpd = JupyterWebApp(api, registry=registry).app.serve("127.0.0.1", 0, event_loop=True)

    def close() -> None:
        jwa_httpd.shutdown()
        httpd.shutdown()
        api.close()
        tracing.set_collector(old_collector)
        eventloop.INLINE_THRESHOLD_SECONDS = inline

    return {"api": api, "registry": registry, "collector": collector, "injector": injector,
            "url": f"https://127.0.0.1:{port}", "ca": ca, "root": root,
            "jwa": f"http://127.0.0.1:{jwa_httpd.server_address[1]}",
            "rest_ms": samples, "expired_handled": expired_handled, "server": httpd,
            "close": close}


def start_remote_process(fleet: dict, mode: str, env: dict, label: str) -> dict:
    """``chip_smoke.py <mode>`` (``start_process``) with the
    ``api_from_env`` ladder's env (URL, token file, CA)."""
    token = os.path.join(fleet["root"], f"{label}.token")
    with open(token, "w") as f:
        f.write(REMOTE_TOKENS[label])
    return start_process(label, [os.path.abspath(__file__), mode],
                         {"KUBE_API_URL": fleet["url"], "KUBE_API_TOKEN_FILE": token,
                          "KUBE_API_CA_FILE": fleet["ca"], **env}, fleet["root"])


def stop_remote_process(p: dict, timeout: float = 60.0) -> dict:
    """Close the process's stdin (its signal to stop), wait for it and
    return its last JSON line; kill it on a timeout."""
    import subprocess

    try:
        p["proc"].stdin.close()
    except OSError:
        pass
    try:
        p["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p["proc"].kill()
        p["proc"].wait()
        raise AssertionError(f"{p['label']} process did not stop in {timeout} s")
    p["reader"].join(timeout=10)
    out = [x for x in p["lines"] if x.startswith("{")]
    if p["proc"].returncode != 0 or not out:
        raise AssertionError(f"{p['label']} process exit {p['proc'].returncode}: "
                             f"{open(p['err']).read()[-3000:]}")
    return json.loads(out[-1])


def platform_controllers_main() -> int:
    """The controller process (``chip_smoke.py --platform-controllers``):
    its client from ``api_from_env()`` (``KUBE_API_URL``,
    ``KUBE_API_TOKEN_FILE``, ``KUBE_API_CA_FILE``); through the port's
    ``Manager`` the notebook controller (queueing on) and the gang
    scheduler, whose reconcile traffic the façade classifies
    controller-level by its trace marker; the kubelet simulator on one
    ``nvidia-h100-80gb`` pool of two nodes, on a second client that
    declares itself controller-level, a pass every ``REMOTE_STEP_S``;
    its spans shipped to the apiserver's ``/debug/traces/ingest``. Runs
    until its stdin closes, then prints one JSON line."""
    import ssl

    from odh_kubeflow_tpu_torch.controllers.notebook import (
        NotebookController, NotebookControllerConfig)
    from odh_kubeflow_tpu_torch.controllers.runtime import Manager
    from odh_kubeflow_tpu_torch.machinery.client import api_from_env
    from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.scheduling.scheduler import SliceScheduler
    from odh_kubeflow_tpu_torch.utils import tracing
    from odh_kubeflow_tpu_torch.utils.prometheus import Registry

    api = api_from_env()
    kube = api_from_env()
    kube.priority_level = "controller"
    for client in (api, kube):
        register_scheduling(client)
    exporter = tracing.RemoteSpanExporter(
        os.environ["KUBE_API_URL"], flush_interval=0.2,
        ssl_context=ssl.create_default_context(cafile=os.environ["KUBE_API_CA_FILE"])).install()
    registry = Registry()
    mgr = Manager(api, registry=registry)
    NotebookController(api, NotebookControllerConfig(enable_queueing=True),
                       registry=registry).register(mgr)
    SliceScheduler(api, registry=registry).register(mgr)
    cluster = FakeCluster(kube)
    name, accel, nodes, per_node = REMOTE_POOL
    cluster.add_gpu_node_pool(name, accel, num_nodes=nodes, gpus_per_node=per_node)
    mgr.start()
    stop = threading.Event()

    def watch_stdin() -> None:
        sys.stdin.read()  # returns at EOF: the parent closed it
        stop.set()

    threading.Thread(target=watch_stdin, daemon=True).start()
    progress("ready")
    steps, errors = 0, []
    while not stop.is_set():
        try:
            cluster.step()
            steps += 1
        except Exception as e:  # noqa: BLE001 — a failed pass retries on the next one
            errors.append(f"{type(e).__name__}: {e}"[:200])
        stop.wait(REMOTE_STEP_S)
    mgr.stop()
    exporter.close()
    reconciles = {}
    for line in registry.exposition().splitlines():
        if line.startswith("controller_runtime_reconcile_total{"):
            labels, value = line.rsplit(" ", 1)
            reconciles[labels[len("controller_runtime_reconcile_total"):]] = float(value)
    emit({"kubelet_steps": steps, "kubelet_step_errors": len(errors),
          "kubelet_errors": errors[:5], "reconciles": reconciles,
          "spans_shipped": exporter.shipped_total, "spans_dropped": exporter.dropped_total,
          "reference_modules": sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("jax", "odh_kubeflow_tpu"))})
    return 0


def remote_flood_plan(seed: int, n: int) -> list:
    """The flood's seeded requests: ``(op, namespace, name, expired)``,
    op "get" / "list" / "patch" at 60 / 20 / 20 %, a seeded
    ``REMOTE_EXPIRED_SHARE`` sent with their deadline already spent: one
    at a seeded place in each block of ``1 / REMOTE_EXPIRED_SHARE``, so
    that a 1 s window of paced users holds as many as the baseline's
    second (their count drawn at random moved a window's ok count by a
    few percent against the 95% recovery gate)."""
    import random

    rng = random.Random(seed)
    block = round(1 / REMOTE_EXPIRED_SHARE)
    out = []
    for k in range(n):
        if k % block == 0:
            hit = rng.randrange(block)
        r = rng.random()
        op = "list" if r < REMOTE_LIST_SHARE else (
            "patch" if r < REMOTE_LIST_SHARE + REMOTE_WRITE_SHARE else "get")
        out.append((op, rng.choice(REMOTE_NAMESPACES),
                    f"cm-{rng.randrange(REMOTE_OBJECTS):02d}", k % block == hit))
    return out


def flood_schedule() -> list:
    """The flood processes' stages as (name, threads in all, start offset
    s, seconds, a user's period s or None for back-to-back requests): the
    paced baseline, the flood, then the paced recovery windows."""
    out = [("baseline", REMOTE_BASE_THREADS, 0.0, REMOTE_BASE_S, REMOTE_USER_PERIOD_S),
           ("flood", REMOTE_FLOOD_THREADS, REMOTE_BASE_S, REMOTE_FLOOD_S, None)]
    t = REMOTE_BASE_S + REMOTE_FLOOD_S
    for _ in range(int(REMOTE_RECOVERY_S / REMOTE_WINDOW_S)):
        out.append(("recovery", REMOTE_BASE_THREADS, t, REMOTE_WINDOW_S, REMOTE_USER_PERIOD_S))
        t += REMOTE_WINDOW_S
    return out


def platform_flood_main() -> int:
    """One of the user flood's ``REMOTE_FLOOD_PROCESSES`` processes
    (``chip_smoke.py --platform-flood``, index ``REMOTE_FLOOD_INDEX``):
    user-level reads and writes through one ``RemoteAPIServer`` (its
    breaker, the process's shared retry budget), each under a
    ``REMOTE_USER_DEADLINE_S`` deadline, from its seeded plan
    (``REMOTE_FLOOD_SEED`` + index); the plan's expired requests go out
    raw with ``X-Request-Deadline: 0``. Prints a ready line, waits for
    ``go <wall-clock start>`` on stdin, then runs its share of the
    threads of each stage of ``flood_schedule()`` from that start (a paced
    user sends on its slots, staggered over all processes' users, and
    skips the slots it missed; a progress line with its ok count at each
    stage's end), until a second
    stdin line (the parent saw the recovery) or the schedule's end; one
    JSON line at the end (each successful request's ms in ``ms``)."""
    import http.client
    import itertools
    import ssl

    from odh_kubeflow_tpu_torch.machinery import overload
    from odh_kubeflow_tpu_torch.machinery.client import api_from_env
    from odh_kubeflow_tpu_torch.machinery.store import APIError

    os.environ["KUBE_LIST_PAGE_SIZE"] = "0"
    api = api_from_env()
    ctx = ssl.create_default_context(cafile=os.environ["KUBE_API_CA_FILE"])
    token = open(os.environ["KUBE_API_TOKEN_FILE"]).read().strip()
    index = int(os.environ.get("REMOTE_FLOOD_INDEX", "0"))
    seed = int(os.environ.get("REMOTE_FLOOD_SEED", REMOTE_SEED)) + index
    plan = remote_flood_plan(seed, 100_000)
    cursor = itertools.count()
    local = threading.local()
    throttle = api._throttle

    def counted_throttle() -> None:  # runs once for each attempt that goes on the wire
        local.wire += 1
        throttle()

    api._throttle = counted_throttle
    lock = threading.Lock()

    def one(stage: dict, i: int) -> None:
        op, ns, name, expired = plan[i % len(plan)]
        if expired:
            path = f"/api/v1/namespaces/{ns}/configmaps" + ("" if op == "list" else f"/{name}")
            req = urllib.request.Request(api.base_url + path, headers={
                "Authorization": f"Bearer {token}", overload.DEADLINE_HEADER: "0.000",
                EXPIRED_HEADER: "1"})
            try:
                with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
                    code = r.status
            except urllib.error.HTTPError as e:
                code = e.code
            except (OSError, http.client.HTTPException):
                code = -1
            with lock:
                stage["expired_sent"] += 1
                stage["expired_504"] += code == 504
            return
        local.wire = 0
        t0 = time.perf_counter()
        err = ""
        try:
            with overload.deadline_scope(REMOTE_USER_DEADLINE_S):
                if op == "get":
                    api.get("ConfigMap", name, ns)
                elif op == "list":
                    api.list("ConfigMap", namespace=ns)
                else:
                    api.patch("ConfigMap", name, {"data": {"n": str(i)}}, ns)
        except (APIError, OSError, ValueError, http.client.HTTPException) as e:
            err = type(e).__name__
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
            stage["logical"] += 1
            stage["attempts"] += local.wire
            stage["wired_logical"] += local.wire > 0
            if err:
                stage["failed"] += 1
                stage["errors"][err] = stage["errors"].get(err, 0) + 1
            else:
                stage["ok"] += 1
                stage["ms"].append(round(ms, 3))
        if err:
            time.sleep(REMOTE_USER_PAUSE_S)

    def run(name: str, threads: int, everyone: int, start: float, end: float,
            period) -> dict:
        stage = {"stage": name, "threads": threads, "ok": 0, "failed": 0, "logical": 0,
                 "wired_logical": 0, "attempts": 0, "errors": {}, "ms": [],
                 "expired_sent": 0, "expired_504": 0}

        def worker(user: int) -> None:
            if period is None:
                while time.time() < end:
                    one(stage, next(cursor))
                return
            slot = start + period * user / everyone
            while True:
                now = time.time()
                if slot < now:
                    slot += math.ceil((now - slot) / period) * period
                if slot >= end:
                    return
                time.sleep(slot - now)
                one(stage, next(cursor))
                slot += period

        time.sleep(max(start - time.time(), 0))
        progress(f"{name}_start", threads=threads)
        ts = [threading.Thread(target=worker, args=(j * share + index,), daemon=True)
              for j in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        progress(f"{name}_end", ok=stage["ok"])
        return stage

    progress("ready")
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        return 1
    t0 = float(line[1])
    stop = threading.Event()  # "stop" on stdin: the recovery has been seen

    def watch_stdin() -> None:
        sys.stdin.readline()
        stop.set()

    threading.Thread(target=watch_stdin, daemon=True).start()
    share = REMOTE_FLOOD_PROCESSES
    stages = []
    for name, threads, start, seconds, period in flood_schedule():
        if stop.is_set():
            break
        stages.append(run(name, threads // share + (index < threads % share), threads,
                          t0 + start, t0 + start + seconds, period))
    budget = overload.shared_budget()
    emit({"index": index, "seed": seed, "stages": stages,
          "budget": {"tokens": budget.tokens(), "spent": budget._m_spent.value(),
                     "exhausted": budget._m_exhausted.value()},
          "breaker": api._breaker.state})
    return 0


def pod_process_env(api, name: str, ns: str, workspace: str) -> tuple[dict, str]:
    """A Running notebook pod's container env, resolved as a kubelet
    would, with the workspace volume's mount path on ``workspace``; and
    its node."""
    from odh_kubeflow_tpu_torch.machinery.kubelet import container_env

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


def remote_post(fleet: dict, ns: str, name: str) -> float:
    """POST one 1-GPU H100 notebook through the JWA; returns the POST's
    wall-clock start."""
    body = {"name": name, "cpu": "1", "memory": "4Gi",
            "gpus": {"accelerator": REMOTE_POOL[1], "count": "1"}}
    req = urllib.request.Request(
        f"{fleet['jwa']}/api/namespaces/{ns}/notebooks", method="POST",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "kubeflow-userid": REMOTE_USER,
                 "Cookie": "XSRF-TOKEN=remote", "X-XSRF-TOKEN": "remote"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=60) as r:
        if r.status != 201:
            raise AssertionError(f"POST {ns}/{name}: HTTP {r.status}")
    return t0


def wait_running(api, ns: str, name: str, limit: float = REMOTE_RUNNING_LIMIT_S) -> float:
    """Polls the store until ``<name>-0`` is Running; its wall-clock time."""
    end = time.time() + limit
    while time.time() < end:
        pods = [p for p in api.list("Pod", namespace=ns) if p["metadata"]["name"] == f"{name}-0"]
        if pods and (pods[0].get("status") or {}).get("phase") == "Running":
            return time.time()
        time.sleep(0.02)
    raise AssertionError(f"{ns}/{name}-0 not Running in {limit} s")


def remote_trace(fleet: dict, ns: str, name: str) -> dict:
    """The spawn's trace as ``/debug/traces?trace=<id>&format=json`` serves
    it: one tree under the JWA's POST span, the store's CREATE stamp on
    the notebook, the controller process's spans (arrived through the
    ingest route) with the milestones in causal order, and the façade's
    spans of the remote reconcile's calls."""
    import ssl

    from odh_kubeflow_tpu_torch.utils import tracing

    tid = fleet["api"].get("Notebook", name, ns)["metadata"]["annotations"][
        tracing.TRACE_ANNOTATION]
    ctx = ssl.create_default_context(cafile=fleet["ca"])
    end = time.time() + 10
    while True:
        with urllib.request.urlopen(f"{fleet['url']}/debug/traces?trace={tid}&format=json",
                                    context=ctx, timeout=10) as r:
            body = json.loads(r.read())
        spans = [tracing.SpanRecord.from_dict(d) for t in body["traces"] for d in t["spans"]]
        names = {s.name for s in spans}
        if all(m in names for m in REMOTE_MILESTONES) or time.time() > end:
            break
        time.sleep(0.2)  # the controller process ships every 0.2 s
    tree = tracing.assemble(spans) if spans else None

    def size(node):
        return 1 + sum(size(c) for c in node["children"])

    starts: dict = {}
    for s in spans:
        starts[s.name] = min(starts.get(s.name, s.start), s.start)
    missing = [m for m in REMOTE_MILESTONES if m not in starts]
    order = [starts.get(m) for m in REMOTE_MILESTONES]
    root = tree["span"] if tree else None
    record = {
        "trace_id": tid, "spans": len(spans), "tree_nodes": size(tree) if tree else 0,
        "root": root.name if root else None, "names": sorted(names),
        "ingested": sum(s.name in ("reconcile", "scheduler.admit")
                        or s.name.startswith("kubelet.") for s in spans),
        "apiserver_spans": sum(s.name == "apiserver" for s in spans),
        "milestone_start_offsets_s": {m: starts[m] - root.start for m in REMOTE_MILESTONES
                                      if m in starts and root},
        "causal_order": not missing and order == sorted(order),
    }
    if (missing or not record["causal_order"] or record["tree_nodes"] != len(spans)
            or not (root and root.name.startswith("jupyter-web-app:POST"))
            or not record["apiserver_spans"]):
        raise AssertionError(f"the remote spawn trace: {record}")
    return record


def remote_watches(fleet: dict, n: int = REMOTE_WATCHES) -> dict:
    """``n`` watches over TLS on raw sockets (no client thread each),
    every one greeted and then live for one event; the apiserver's thread
    count at 0 (its handler pool at full size) and at ``n`` watches;
    every one gone from the store after the close."""
    import resource
    import socket
    import ssl

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = 4 * n + 256  # this process holds both ends of every stream
    if soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (want if hard == resource.RLIM_INFINITY else min(want, hard), hard))
    api, ns = fleet["api"], REMOTE_NAMESPACES[0]
    host, port = fleet["url"].rsplit("/", 1)[1].split(":")
    ctx = ssl.create_default_context(cafile=fleet["ca"])
    watchers0 = len(api._watches)
    # the façade's handler pool starts its workers on demand, up to its
    # fixed REMOTE_WORKERS (it grew by 12 while the watches opened in one
    # of seven runs on the CPU, with every watch live): all of them are
    # started first, so that the count reads what the watches add
    pool = fleet["server"]._pool
    barrier = threading.Barrier(REMOTE_WORKERS + 1)
    started = [pool.submit(barrier.wait, 30) for _ in range(REMOTE_WORKERS)]
    barrier.wait(30)
    for f in started:
        f.result()
    threads0 = threading.active_count()
    streams = []
    t0 = time.perf_counter()
    try:
        for _ in range(n):
            s = ctx.wrap_socket(socket.create_connection((host, int(port)), timeout=30),
                                server_hostname=host)
            s.sendall(f"GET /api/v1/namespaces/{ns}/configmaps?watch=true"
                      "&sendInitialEvents=false HTTP/1.1\r\nHost: t\r\n"
                      f"Authorization: Bearer {REMOTE_TOKENS['flood']}\r\n\r\n".encode())
            f = s.makefile("rb")
            streams.append((s, f))
            if b"200" not in f.readline():
                raise AssertionError("watch refused")
            while f.readline() not in (b"\r\n", b"\n"):
                pass
            if b"HEARTBEAT" not in f.readline():
                raise AssertionError("no watch greeting")
        open_s = time.perf_counter() - t0
        threads_n = threading.active_count()
        api.create({"apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": "watch-probe", "namespace": ns}})
        live = sum(b"watch-probe" in f.readline() for _, f in streams)
    finally:
        for s, f in streams:
            f.close()
            s.close()
    end = time.time() + 10
    while len(api._watches) > watchers0 and time.time() < end:
        time.sleep(0.05)
    record = {"watches": n, "threads_at_0": threads0, "threads_at_n": threads_n,
              "threads_added": threads_n - threads0, "live": live, "open_s": open_s,
              "store_watchers_left": len(api._watches) - watchers0}
    if (record["threads_added"] >= REMOTE_WATCH_THREADS_GATE or live != n
            or record["store_watchers_left"] != 0):
        raise AssertionError(f"watches: {record}")
    return record


def shed_counts(registry) -> dict:
    metric = registry.metric("inflight_shed_total")
    return {f"{labels['level']}/{labels['reason']}": value
            for labels, value in (metric.samples() if metric is not None else [])}


def rest_ms(samples, a: float, b: float) -> dict:
    """REST handler ms p50 / p99 by level between wall-clock ``a`` and
    ``b``, and the most handlers of the level in flight at once."""
    out = {}
    for level in ("controller", "user"):
        rows = [(t, ms) for t, lv, ms in samples if a <= t <= b and lv == level]
        xs = [ms for _, ms in rows]
        edges = sorted([(t - ms / 1e3, 1) for t, ms in rows] + [(t, -1) for t, _ in rows])
        peak = depth = 0
        for _, d in edges:
            depth += d
            peak = max(peak, depth)
        out[level] = {"n": len(xs), "p50": pctl(xs, 0.5), "p99": pctl(xs, 0.99),
                      "peak_in_flight": peak}
    return out


def run_notebook_thread(env: dict, scratch: str) -> dict:
    """``run_notebook_process`` on a thread, so that the notebook serves
    while the flood runs; its record (or its error) lands in the returned
    dict once ``["thread"]`` has finished."""
    out: dict = {}

    def target() -> None:
        try:
            out.update(run_notebook_process("remote", env, env["ODH_TORCH_KERNEL_CACHE"],
                                            scratch))
        except BaseException as e:  # noqa: BLE001 — re-raised by the phase
            out["error"] = e

    out["thread"] = threading.Thread(target=target, daemon=True)
    out["thread"].start()
    return out


def flood_stages(outs: list) -> list:
    """The flood processes' records summed stage by stage: counts, ok per
    second over the stage's planned seconds, p50 / p99 ms of the
    successful requests."""
    rows = []
    ran = min(len(o["stages"]) for o in outs)
    for k, (name, threads, start, seconds, period) in enumerate(flood_schedule()[:ran]):
        parts = [o["stages"][k] for o in outs]
        row = {"stage": name, "threads": threads, "start_s": start, "seconds": seconds,
               "period_s": period}
        for key in ("ok", "failed", "logical", "wired_logical", "attempts", "expired_sent",
                    "expired_504"):
            row[key] = sum(p[key] for p in parts)
        errors: dict = {}
        for p in parts:
            for e, n in p["errors"].items():
                errors[e] = errors.get(e, 0) + n
        ms = [x for p in parts for x in p["ms"]]
        row.update(errors=errors, ok_per_s=row["ok"] / seconds, p50_ms=pctl(ms, 0.5),
                   p99_ms=pctl(ms, 0.99))
        rows.append(row)
    return rows


def platform_remote_phase(run_notebook=run_notebook_thread, spawn_tokens=None,
                          seed: int = REMOTE_SEED) -> tuple[dict, int]:
    """The platform over the wire: the apiserver here; the controllers,
    the flood and the notebook in processes of their own.

    1. A 1-GPU notebook POSTed through the JWA; the controller process
       takes it to a Running pod over HTTPS (seconds, no flood).
    2. Its trace on ``/debug/traces``: one tree, the controller process's
       spans ingested, milestones in causal order.
    3. ``REMOTE_WATCHES`` watches over the wire: fewer than
       ``REMOTE_WATCH_THREADS_GATE`` threads added, all gone after.
    4. The notebook's process (``run_notebook``, in the pod's env, the
       dequant library staged in its kernel directory; started before 2
       and 3) serves Llama-3-8B int4: once its weights are on the card
       the flood processes run the baseline, the flood (a second
       notebook POSTed halfway, which must reach Running before the
       flood ends) and the recovery windows.
    5. The gates: no controller-level shed, user-level sheds at the level
       ceiling, every expired request a 504 that ran no handler,
       attempts per logical request, recovery, the notebook's tokens
       (equal to ``spawn_tokens`` when given) and dequant launches."""
    import shutil
    import tempfile

    from odh_kubeflow_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="platform-remote-")
    fleet = remote_apiserver(root)
    procs: list = []
    record: dict = {"phase": "platform_remote"}
    try:
        controllers = start_remote_process(fleet, "--platform-controllers", {}, "controller")
        procs.append(controllers)
        floods = [start_remote_process(fleet, "--platform-flood",
                                       {"REMOTE_FLOOD_SEED": str(seed),
                                        "REMOTE_FLOOD_INDEX": str(i),
                                        **REMOTE_FLOOD_BREAKER_ENV}, "flood")
                  for i in range(REMOTE_FLOOD_PROCESSES)]
        procs += floods
        for p in procs:
            if not p["ready"].wait(120) or "ready" not in p["events"]:
                raise AssertionError(f"{p['label']} process never got ready: "
                                     f"{open(p['err']).read()[-3000:]}")
        api, ns = fleet["api"], REMOTE_NAMESPACES[0]
        # 1. the spawn over the wire
        t_post = remote_post(fleet, ns, "nb-remote")
        record["spawn_s"] = wait_running(api, ns, "nb-remote") - t_post
        # 4a. the notebook's process, warm, starts in its pod's env (its
        # imports overlap the next two checks)
        env, node = pod_process_env(api, "nb-remote", ns, os.path.join(root, "workspace"))
        kernel_dir = env["ODH_TORCH_KERNEL_CACHE"]
        os.makedirs(kernel_dir, exist_ok=True)
        lib = _build._target("int4_dequant")
        if lib.exists():  # built by this process's device phase
            shutil.copy2(lib, os.path.join(kernel_dir, lib.name))
        notebook = run_notebook(env, root)
        # 2. one trace
        record["trace"] = remote_trace(fleet, ns, "nb-remote")
        # 3. watches without threads
        record["watches"] = remote_watches(fleet)
        # 4b. the flood starts once the notebook's weights are on the
        # card, so that it runs while the notebook serves
        out_path = os.path.join(root, "remote.out")
        end = time.time() + 300
        while notebook["thread"].is_alive() and time.time() < end:
            if os.path.exists(out_path) and '"event": "service"' in open(out_path).read():
                break
            time.sleep(0.05)
        t0 = time.time() + 0.5
        for p in floods:
            p["proc"].stdin.write(f"go {t0}\n")
            p["proc"].stdin.flush()
        flood_t0, flood_t1 = t0 + REMOTE_BASE_S, t0 + REMOTE_BASE_S + REMOTE_FLOOD_S
        time.sleep(max(flood_t0 + REMOTE_FLOOD_S / 2 - time.time(), 0))
        second = {"post": remote_post(fleet, REMOTE_NAMESPACES[1], "nb-remote-2")}
        second["running"] = wait_running(api, REMOTE_NAMESPACES[1], "nb-remote-2")
        # 5. the recovery windows until one reaches the gate (the ok
        # counts summed over the flood processes as each stage ends);
        # closing their stdin then stops the flood processes
        end = time.time() + REMOTE_RECOVERY_S + 60
        while time.time() < end and all(p["proc"].poll() is None for p in floods):
            ends = [[e["ok"] for e in p["history"] if e["event"].endswith("_end")]
                    for p in floods]
            oks = [sum(col) for col in zip(*ends)]  # stages every process has ended
            if len(oks) > 2 and oks[-1] / REMOTE_WINDOW_S >= (
                    REMOTE_RECOVERY_GATE * oks[0] / REMOTE_BASE_S):
                break
            time.sleep(0.05)
        outs = [stop_remote_process(p, timeout=REMOTE_RECOVERY_S + 60) for p in floods]
        notebook["thread"].join(timeout=600)
        if "error" in notebook:
            raise notebook["error"]
        if notebook["thread"].is_alive():
            raise AssertionError("the notebook process did not finish")
        ctl_out = stop_remote_process(controllers)
        queues = api.debug_queues()
    finally:
        for p in procs:
            if p["proc"].poll() is None:
                p["proc"].kill()
                p["proc"].wait()
        fleet["close"]()
        shutil.rmtree(root, ignore_errors=True)
    stages = flood_stages(outs)
    base, flood_stage, windows = stages[0], stages[1], stages[2:]
    recovered = next((k for k, w in enumerate(windows)
                      if w["ok_per_s"] >= REMOTE_RECOVERY_GATE * base["ok_per_s"]), None)
    sheds = shed_counts(fleet["registry"])
    expired = {"sent": sum(s["expired_sent"] for s in stages),
               "504": sum(s["expired_504"] for s in stages),
               "handled": fleet["expired_handled"][0]}
    wire = sum(s["attempts"] for s in stages)
    on_wire = sum(s["wired_logical"] for s in stages)
    expected = LAUNCHES_PER_FORWARD * (2 + 1 + SPAWN_NEW_TOKENS)

    def stage_row(s):
        return {k: s[k] for k in ("threads", "period_s", "seconds", "ok_per_s", "ok", "failed",
                                  "errors", "p50_ms", "p99_ms")}

    record.update({
        "notebook": {k: notebook[k] for k in ("imported_s", "service_s", "first_token_s",
                                              "process_s", "built", "launches", "device")},
        "notebook_node": node,
        "first_token_split_s": {"imports": notebook["imported_s"],
                                "load": notebook["service_s"] - notebook["imported_s"],
                                "first_token": notebook["first_token_s"] - notebook["service_s"]},
        "tokens": notebook["tokens"],
        "rest_ms": {"unloaded": rest_ms(fleet["rest_ms"], t0, flood_t0),
                    "flood": rest_ms(fleet["rest_ms"], flood_t0, flood_t1)},
        "shed": sheds, "expired": expired,
        "attempts_per_logical": wire / max(on_wire, 1),
        "attempts": {"wire": wire, "logical_on_wire": on_wire,
                     "logical": sum(s["logical"] for s in stages),
                     "budgets": [o["budget"] for o in outs],
                     "breakers": [o["breaker"] for o in outs]},
        "flood_processes": REMOTE_FLOOD_PROCESSES,
        "baseline": stage_row(base), "flood": stage_row(flood_stage),
        "recovery": [stage_row(w) for w in windows],
        "recovery_s": None if recovered is None else (recovered + 1) * REMOTE_WINDOW_S,
        "second_notebook": {"post_to_running_s": second["running"] - second["post"],
                            "posted_into_flood_s": second["post"] - flood_t0,
                            "running_before_flood_end": second["running"] <= flood_t1},
        "wal": queues["wal"], "controllers": ctl_out,
        "injected_latencies": fleet["injector"].m_faults.value({"kind": "latency"}),
        "seconds": time.perf_counter() - t_phase,
    })
    problems = []
    if spawn_tokens is not None and notebook["tokens"] != spawn_tokens:
        problems.append(f"tokens {notebook['tokens']} != platform_spawn's {spawn_tokens}")
    if notebook["launches"] != expected or len(notebook["tokens"]) != SPAWN_NEW_TOKENS:
        problems.append(f"dequant launches {notebook['launches']} (expected {expected})")
    if notebook["built"]:
        problems.append(f"the warm notebook built {notebook['built']}")
    if any(k.startswith("controller/") and v for k, v in sheds.items()):
        problems.append(f"controller-level sheds {sheds}")
    if not sheds.get("user/level"):
        problems.append(f"no user-level shed at the level ceiling: {sheds}")
    if not expired["sent"] or expired["504"] != expired["sent"] or expired["handled"]:
        problems.append(f"expired requests: {expired}")
    if record["attempts_per_logical"] > REMOTE_ATTEMPTS_GATE:
        problems.append(f"attempts per logical request {record['attempts_per_logical']}")
    if not record["second_notebook"]["running_before_flood_end"]:
        problems.append(f"second notebook: {record['second_notebook']}")
    if recovered is None:
        problems.append(f"no recovery to {REMOTE_RECOVERY_GATE} of {base['ok_per_s']}/s in "
                        f"{REMOTE_RECOVERY_S} s")
    if problems:
        raise AssertionError(f"platform_remote: {problems}; {record}")
    return record, notebook["launches"]


# ---------------------------------------------------------------------------
# platform_failover (slice 9, part 7): the highly available control plane

FAILOVER_NS = "team-fo"
FAILOVER_POOL = ("h100-fo", "nvidia-h100-80gb", 1, 8)
FAILOVER_USER = "owner-fo@example.com"
FAILOVER_IDENTITY = "replica-b"  # the follower's watchdog identity (SHARD_IDENTITY)
FAILOVER_CP_LEASE = "control-plane-leader"  # held by the apiserver in its own store
FAILOVER_LEASE_NS = "kubeflow"
# the control-plane lease (the apiserver's elector, the follower's watchdog):
# whole seconds, the Lease field's unit
FAILOVER_CP_LEASE_S = 1.0
FAILOVER_CP_RENEW_S = 0.1  # the apiserver's renew period
FAILOVER_GRACE_WINDOWS = 1.0  # PROMOTION_GRACE_WINDOWS
# the controllers' lease: the runner renews it every third of it and
# retries a failed renewal a quarter later (``runner._lease_periods``: 2 s
# and 1.5 s), so a renewal that fails while writes have no leader (the
# apiserver's failover, two control-plane windows and two polls) is
# tried again 3.5 s later, before the holder's 0.8-lease deadline
FAILOVER_CTL_LEASE_S = 6.0
FAILOVER_PHASE_LIMIT_S = 60.0
# the apiserver is killed once no write but a lease renewal has landed for
# this long (the standby controller's first reconciles write Events)
FAILOVER_QUIET_S = 1.0
FAILOVER_STEP_S = 0.1  # the kubelet simulator's pass interval
FAILOVER_KINDS = ("Notebook", "StatefulSet", "Pod", "Workload")
FAILOVER_REFERENCE = ("jax", "odh_kubeflow_tpu")
FAILOVER_CONTROLLER_ENV = {
    "LEADER_ELECT": "true", "LEASE_DURATION": str(FAILOVER_CTL_LEASE_S),
    "INFORMER_CACHE": "true", "ENABLE_GPU_QUEUEING": "true",
    "ENABLE_SESSION_SUSPEND": "false", "TRACE_EXPORT": "false",
    "METRICS_HOST": "127.0.0.1",
}


def platform_apiserver_main() -> int:
    """The leader apiserver process (``chip_smoke.py --platform-apiserver``):
    the port's store with its write-ahead log under ``$FAILOVER_ROOT/wal``
    (no snapshots: every acked record stays in the log), the CRDs, the
    notebook and PodDefault admission webhooks with the GPU-runtime
    PodDefault in ``FAILOVER_NS``; ``httpapi.serve`` over plain HTTP on
    127.0.0.1 with the replication routes. A ``LeaderElector`` holds
    ``control-plane-leader`` in its own store, renewed every
    ``FAILOVER_CP_RENEW_S``; the store ships under the elector's fencing
    token (``replication_epoch``). Prints a ``ready`` progress line with
    its URL and token; a ``report`` line on stdin prints the reference
    modules loaded, the applied rv and the rv of the last write of any kind
    but Lease; stdin's EOF stops it."""
    from odh_kubeflow_tpu_torch import apis
    from odh_kubeflow_tpu_torch.machinery import httpapi
    from odh_kubeflow_tpu_torch.machinery.leader import LeaderElector
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling
    from odh_kubeflow_tpu_torch.webhooks import (
        NotebookWebhook, PodDefaultWebhook, gpu_runtime_poddefault)

    root = os.environ["FAILOVER_ROOT"]
    api = APIServer(wal=WriteAheadLog(os.path.join(root, "wal")), snapshot_interval=0)
    apis.register_crds(api)
    register_scheduling(api)
    apis.install_default_cluster_roles(api)
    PodDefaultWebhook(api).register()
    NotebookWebhook(api).register()
    api.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": FAILOVER_NS}})
    api.create(gpu_runtime_poddefault(FAILOVER_NS))
    elector = LeaderElector(api, FAILOVER_CP_LEASE, namespace=FAILOVER_LEASE_NS,
                            identity="apiserver-a", lease_duration=FAILOVER_CP_LEASE_S,
                            renew_period=FAILOVER_CP_RENEW_S, retry_period=FAILOVER_CP_RENEW_S)
    if not elector.acquire(timeout=10):
        raise AssertionError("the apiserver could not take its own lease")
    api.replication_epoch = elector.token

    def lost() -> None:
        print("apiserver: control-plane lease lost; exiting", flush=True)
        os._exit(1)

    elector.run(on_lost=lost)
    _, port, httpd = httpapi.serve(api, host="127.0.0.1", port=0)

    def reference() -> list:
        return sorted(m for m in sys.modules if m.split(".")[0] in FAILOVER_REFERENCE)

    progress("ready", url=f"http://127.0.0.1:{port}", token=elector.token, pid=os.getpid(),
             reference_modules=reference())
    for line in sys.stdin:
        if line.strip() == "report":
            progress("report", reference_modules=reference(), rv=api.applied_rv(),
                     non_lease_rv=max(v for k, v in api._kind_rv.items() if k != "Lease"))
    httpd.shutdown()
    api.close()
    emit({"token": elector.token, "rv": api.applied_rv(), "reference_modules": reference()})
    return 0


def notebook_failover_main() -> int:
    """The notebook's process in ``platform_failover``
    (``chip_smoke.py --notebook-failover``, in its pod's env): the
    ``--notebook-serve`` service for Llama-3-8B int4 on the card, one
    greedy request for a first token and one for ``SPAWN_NEW_TOKENS``;
    then it waits for a line on stdin (the phase writes it after the
    promotion) and answers the first request once more. Prints one JSON
    line: the milestones, the tokens, the dequant launches after each
    request, the kernels it built and the reference modules loaded."""
    from odh_kubeflow_tpu_torch.models.serve import build_service, serve
    from odh_kubeflow_tpu_torch.ops import _build, int4

    imported_at = time.time()
    service, args = build_service([*SPAWN_SERVE_ARGS, "--host", "127.0.0.1", "--port", "0"])
    service_at = time.time()
    progress("service")
    httpd = serve(service, host=args.host, port=args.port)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    prompt = [t % service.cfg.vocab_size for t in SPAWN_PROMPT]
    stage_launches = []
    try:
        int4.launches = 0
        code, first = post(base, {"prompt": [prompt], "max_tokens": 1})
        first_token_at = time.time()
        stage_launches.append(int4.launches)
        code2, out = post(base, {"prompt": [prompt], "max_tokens": SPAWN_NEW_TOKENS})
        stage_launches.append(int4.launches)
        if (code, code2) != (200, 200):
            raise AssertionError(f"HTTP {code}, {code2}: {first} {out}")
        progress("served")
        sys.stdin.readline()  # the phase's go: the apiserver has failed over
        go_at = time.time()
        code3, again = post(base, {"prompt": [prompt], "max_tokens": 1})
        stage_launches.append(int4.launches)
        if code3 != 200:
            raise AssertionError(f"HTTP {code3} after the promotion: {again}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    emit({"imported_at": imported_at, "service_at": service_at,
          "first_token_at": first_token_at, "go_at": go_at, "answered_at": time.time(),
          "first": first["completions"][0], "tokens": out["completions"][0],
          "after_promotion": again["completions"][0], "stage_launches": stage_launches,
          "launches": int4.launches, "built": sorted(_build.build_logs),
          "device": str(service.device),
          "reference_modules": sorted(m for m in sys.modules
                                      if m.split(".")[0] in FAILOVER_REFERENCE)})
    return 0


def reference_poison(root: str) -> str:
    """A directory that shadows ``jax`` and ``odh_kubeflow_tpu``: a
    process started in it (``python -m`` puts its working directory first
    on the path) that imports either writes its pid and the name to
    ``reference-imports.log`` beside it and gets an ImportError."""
    path = os.path.join(root, "poison")
    log = os.path.join(root, "reference-imports.log")
    for name in FAILOVER_REFERENCE:
        os.makedirs(os.path.join(path, name), exist_ok=True)
        with open(os.path.join(path, name, "__init__.py"), "w") as f:
            f.write(f"import os\nwith open({log!r}, 'a') as f:\n"
                    f"    f.write(f'{{os.getpid()}} {name}\\n')\n"
                    f"raise ImportError('{name} is not to be loaded by the port')\n")
    return path


def start_process(label: str, argv: list, env: dict, root: str,
                  cwd: str | None = None) -> dict:
    """``python <argv>`` in a process of its own with ``env`` on top of
    this one's and the checkout on ``PYTHONPATH`` (in ``cwd`` when given);
    its stdout lines collected by a reader thread (progress events: the
    last of each name in ``events``, all in ``history``; ``ready`` set on
    the ``ready`` event or at EOF), stdin kept open (closing it stops a
    process that waits on it), stderr to ``<root>/<label>.err``."""
    import subprocess

    err_path = os.path.join(root, f"{label}.err")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, *argv], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err, text=True, cwd=cwd,
                                env={**os.environ, "PYTHONPATH": here, **env})
    lines: list = []
    events: dict = {}
    history: list = []
    ready = threading.Event()
    cond = threading.Condition()

    def read() -> None:
        for line in proc.stdout:
            line = line.rstrip("\n")
            with cond:
                lines.append(line)
                if line.startswith(PROGRESS):
                    ev = json.loads(line[len(PROGRESS):])
                    events[ev["event"]] = ev
                    history.append(ev)
                    if ev["event"] == "ready":
                        ready.set()
                cond.notify_all()
        ready.set()
        with cond:
            cond.notify_all()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return {"label": label, "proc": proc, "lines": lines, "events": events,
            "history": history, "ready": ready, "cond": cond, "reader": reader,
            "err": err_path, "started": time.time()}


def wait_line(p: dict, pred, limit: float, what: str):
    """The first stdout line (or progress event, for a string ``pred``)
    of ``p`` that matches; fails on the process's exit or after ``limit``."""
    end = time.time() + limit
    with p["cond"]:
        while True:
            if isinstance(pred, str):
                if pred in p["events"]:
                    return p["events"][pred]
            else:
                for line in p["lines"]:
                    if pred(line):
                        return line
            if p["proc"].poll() is not None and not p["reader"].is_alive():
                raise AssertionError(f"{p['label']} exited {p['proc'].returncode} before "
                                     f"{what}: {open(p['err']).read()[-3000:]}")
            left = end - time.time()
            if left <= 0:
                raise AssertionError(f"{p['label']}: no {what} in {limit} s: "
                                     f"{open(p['err']).read()[-3000:]}")
            p["cond"].wait(min(left, 0.2))


def failover_notebook_process(env: dict, root: str) -> dict:
    """``chip_smoke.py --notebook-failover`` in the pod's env: returns
    ``go()`` (the phase's signal after the promotion) and ``result()``
    (its JSON record, with the seconds from process start to each
    milestone, ``<name>_at`` → ``<name>_s``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    p = start_process("notebook", [os.path.abspath(__file__), "--notebook-failover"], env,
                      root, here)

    def go() -> None:
        p["proc"].stdin.write("go\n")
        p["proc"].stdin.flush()

    def result(limit: float = 600.0) -> dict:
        line = wait_line(p, lambda x: x.startswith("{"), limit, "its record")
        p["proc"].wait(timeout=60)
        if p["proc"].returncode != 0:
            raise AssertionError(f"notebook exit {p['proc'].returncode}: "
                                 f"{open(p['err']).read()[-3000:]}")
        got = json.loads(line)
        return {**{k[:-3] + "_s": v - p["started"] for k, v in got.items()
                   if k.endswith("_at")}, **got}

    return {"process": p, "go": go, "result": result}


def scrape(url: str) -> dict:
    """``cache_hits_total`` and ``cache_misses_total`` of a ``/metrics``,
    summed over kinds; and the reconciles by result."""
    with urllib.request.urlopen(url, timeout=10) as r:
        text = r.read().decode()
    out = {"cache_hits": 0.0, "cache_misses": 0.0, "reconciles": {}}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, value = line.rsplit(" ", 1)
        if name.startswith("cache_hits_total"):
            out["cache_hits"] += float(value)
        elif name.startswith("cache_misses_total"):
            out["cache_misses"] += float(value)
        elif name.startswith("controller_runtime_reconcile_total{"):
            out["reconciles"][name[len("controller_runtime_reconcile_total"):]] = float(value)
    return out


def failover_state(api, procs: dict, kubelet_errors: list) -> dict:
    """What a stalled step of ``platform_failover`` leaves to read: the
    objects of ``FAILOVER_KINDS`` on ``api`` with their phases, each
    process's exit code, last stdout lines and stderr tail, and the
    kubelet simulator's last errors."""
    out: dict = {"objects": {}, "processes": {}, "kubelet_errors": kubelet_errors[-5:]}
    for kind in FAILOVER_KINDS:
        try:
            out["objects"][kind] = [
                [o["metadata"]["name"], o["metadata"].get("resourceVersion"),
                 (o.get("status") or {}).get("phase")
                 or (o.get("status") or {}).get("conditions", [])[-1:]]
                for o in api.list(kind, namespace=FAILOVER_NS)]
        except Exception as e:  # noqa: BLE001 — a diagnostic, never the failure itself
            out["objects"][kind] = repr(e)[:200]
    for label, p in procs.items():
        with open(p["err"]) as f:
            err = f.read()[-1500:]
        out["processes"][label] = {"rc": p["proc"].poll(), "out": list(p["lines"])[-5:],
                                   "err": err}
    return out


def http_client(url: str, retries: int = 1):
    """The port's ``RemoteAPIServer`` at ``url`` over plain HTTP, short
    retries, the CRD and scheduling kinds registered."""
    from odh_kubeflow_tpu_torch.apis import register_crds
    from odh_kubeflow_tpu_torch.machinery.client import RemoteAPIServer
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling

    c = RemoteAPIServer(url, retries=retries, retry_base=0.02, retry_cap=0.1, timeout=10)
    register_crds(c)
    register_scheduling(c)
    return c


def poll_until(fn, limit: float, what: str, period: float = 0.02):
    """``fn()``'s first truthy value, polled every ``period``; a transport
    or API error counts as not yet; fails after ``limit`` s."""
    from odh_kubeflow_tpu_torch.machinery.store import APIError

    end = time.time() + limit
    while True:
        try:
            got = fn()
        except (OSError, APIError):
            got = None
        if got:
            return got
        if time.time() > end:
            raise AssertionError(f"no {what} in {limit} s")
        time.sleep(period)


def platform_failover_phase(run_notebook=failover_notebook_process, spawn_tokens=None,
                            limit_s: float = FAILOVER_PHASE_LIMIT_S,
                            scheduling_s: float = 0.0) -> tuple[dict, int]:
    """The highly available control plane, every process through its
    normal entry point, plain HTTP on 127.0.0.1:

    - A, the leader apiserver: ``chip_smoke.py --platform-apiserver``;
    - B, the follower: ``python -m odh_kubeflow_tpu_torch.machinery.replica``
      (``REPLICA_OF`` A, the promotion watchdog on, a 1 s lease, one
      grace window);
    - two notebook controllers and one scheduler: ``python -m
      odh_kubeflow_tpu_torch.controllers.notebook`` / ``...scheduling.
      scheduler`` through ``runner.run_controller`` with leader election,
      ``KUBE_API_URL`` B (which 307s writes to A until it is promoted),
      ``READ_FROM_REPLICA`` "B,A" (``ReplicaFanout``), the informer cache
      and ``/metrics``;
    - the kubelet simulator here, against B; the notebook's process on the
      card (``run_notebook``, in its pod's env).

    1. B cold-joins (snapshot, then the stream to A's rv). 2. ``nb-fo-1``
    POSTed through the JWA's ``create_notebook`` reaches Running. 3. The
    notebook controller holding its lease is SIGKILLed: the standby takes
    the lease within its duration + a renew period + 1 s, the transitions
    and the token rise by one, and a write under the dead holder's token
    is a 403 ``FencedOut`` that applies nothing. 4. Once B holds A's rv,
    A is SIGKILLed: B's watchdog promotes B under A's token + 1 within
    (1 + grace) windows and two polls of the last renewal B saw; every
    Notebook, StatefulSet, Pod and Workload of A's log is on B at its rv
    (A is killed once no write but a lease renewal has landed for
    ``FAILOVER_QUIET_S``: replication is asynchronous, so a write acked in
    the last interval before a crash is lost by design, and this drill
    does not measure that), the records A acked beyond B are only Leases,
    and a write or a
    replicated record under A's epoch is fenced. 5. ``nb-fo-2`` reaches
    Running on the promoted B; no other process exited. 6. The notebook's
    8B int4 tokens (equal to ``spawn_tokens`` when given), its answer after
    the promotion and its dequant launches (225 a forward). 7. No process
    loaded ``jax`` or ``odh_kubeflow_tpu``. 8. The phase within
    ``limit_s``. ``scheduling_s`` widens the promotion bound for a host
    whose other work delays the watchdog's polls (the CPU test's shared
    cores); the card runs with none."""
    import shutil
    import signal
    import tempfile

    from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
    from odh_kubeflow_tpu_torch.machinery.leader import fenced
    from odh_kubeflow_tpu_torch.machinery.replica import ReplicaStore
    from odh_kubeflow_tpu_torch.machinery.runner import _lease_periods
    from odh_kubeflow_tpu_torch.machinery.store import (APIServer, FencedOut,
                                                        NotFound, parse_micro_time)
    from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp

    t_phase = time.perf_counter()
    ctl_renew_s = _lease_periods(FAILOVER_CTL_LEASE_S)["renew_period"]
    root = tempfile.mkdtemp(prefix="platform-failover-")
    poison = reference_poison(root)
    here = os.path.dirname(os.path.abspath(__file__))
    record: dict = {"phase": "platform_failover",
                    "leases_s": {"control_plane": FAILOVER_CP_LEASE_S,
                                 "controllers": FAILOVER_CTL_LEASE_S,
                                 "grace_windows": FAILOVER_GRACE_WINDOWS}}
    procs: dict = {}
    stop_kubelet = threading.Event()
    kubelet_errors: list = []
    problems: list = []
    notebook = None

    client = http_client

    def served_rv(c) -> int:
        c.list("Lease", namespace=FAILOVER_LEASE_NS)
        return int(c.applied_rv() or 0)

    def lease(c, name: str) -> dict:
        return dict(c.get("Lease", name, FAILOVER_LEASE_NS)["spec"])

    def poll(fn, limit: float, what: str, period: float = 0.02):
        return poll_until(fn, limit, f"platform_failover: {what}", period)

    def running(c, name: str):
        pods = [p for p in c.list("Pod", namespace=FAILOVER_NS)
                if p["metadata"]["name"] == f"{name}-0"]
        return bool(pods) and (pods[0].get("status") or {}).get("phase") == "Running"

    try:
        # A, then B's cold join
        a = start_process("apiserver", [os.path.join(here, "chip_smoke.py"),
                                        "--platform-apiserver"],
                          {"FAILOVER_ROOT": root}, root, poison)
        procs["apiserver"] = a
        ready = wait_line(a, "ready", 60, "ready line")
        url_a, token_a = ready["url"], int(ready["token"])
        api_a = client(url_a)
        port_b = free_port()
        url_b = f"http://127.0.0.1:{port_b}"
        b = start_process("replica", ["-m", "odh_kubeflow_tpu_torch.machinery.replica"], {
            "REPLICA_OF": url_a, "PROMOTION_WATCHDOG": "true",
            "LEASE_DURATION": str(FAILOVER_CP_LEASE_S),
            "PROMOTION_GRACE_WINDOWS": str(FAILOVER_GRACE_WINDOWS),
            "LEADER_ELECTION_ID": FAILOVER_CP_LEASE,
            "LEADER_ELECTION_NAMESPACE": FAILOVER_LEASE_NS,
            "SHARD_IDENTITY": FAILOVER_IDENTITY, "HOST": "127.0.0.1", "PORT": str(port_b)},
            root, poison)
        procs["replica"] = b
        wait_line(b, lambda x: "serving reads on" in x, 60, "its serving line")
        api_b = client(url_b)
        target = served_rv(api_a)
        poll(lambda: served_rv(api_b) >= target, 30, "cold join")
        record["join_s"] = time.time() - b["started"]
        with urllib.request.urlopen(url_b + "/metrics", timeout=10) as r:
            lag = [x for x in r.read().decode().splitlines()
                   if x.startswith("replica_lag_records ")]
        record["join_lag_records"] = float(lag[0].split()[1]) if lag else None

        # the controllers, through runner.run_controller
        common = {**FAILOVER_CONTROLLER_ENV, "KUBE_API_URL": url_b,
                  "READ_FROM_REPLICA": f"{url_b},{url_a}"}
        for (label, module), port in zip(
                (("scheduler", "odh_kubeflow_tpu_torch.scheduling.scheduler"),
                 ("notebook-1", "odh_kubeflow_tpu_torch.controllers.notebook"),
                 ("notebook-2", "odh_kubeflow_tpu_torch.controllers.notebook")),
                listen_ports(3)):
            procs[label] = start_process(label, ["-m", module],
                                         {**common, "METRICS_PORT": str(port)}, root, poison)
        for label in ("scheduler", "notebook-1", "notebook-2"):
            wait_line(procs[label], lambda x: "waiting for leader lease" in x, 60,
                      "its election line")
        holder_line = poll(lambda: [
            (label, line) for label in ("notebook-1", "notebook-2")
            for line in list(procs[label]["lines"]) if line.endswith(" running")], 60,
            "a running notebook controller")
        for label in ("scheduler",):
            wait_line(procs[label], lambda x: x.endswith(" running"), 60, "running")
        holder = holder_line[0][0]
        standby = "notebook-2" if holder == "notebook-1" else "notebook-1"

        def metrics_url(label: str) -> str:
            line = wait_line(procs[label], lambda x: "metrics on :" in x, 60, "its metrics line")
            return f"http://127.0.0.1:{line.split(':')[-1].split('/')[0]}/metrics"

        # the kubelet simulator, here, against B
        kube = client(url_b, retries=1)
        kube.priority_level = "controller"
        cluster = FakeCluster(kube)
        pool, accel, nodes, per_node = FAILOVER_POOL
        cluster.add_gpu_node_pool(pool, accel, num_nodes=nodes, gpus_per_node=per_node)

        def kubelet() -> None:
            while not stop_kubelet.is_set():
                try:
                    cluster.step()
                except Exception as e:  # noqa: BLE001 — the next pass retries
                    kubelet_errors.append(f"{type(e).__name__}: {e}"[:160])
                stop_kubelet.wait(FAILOVER_STEP_S)

        kubelet_thread = threading.Thread(target=kubelet, daemon=True)
        kubelet_thread.start()
        jwa = JupyterWebApp(client(url_b, retries=4))
        body = {"name": "", "cpu": "1", "memory": "4Gi",
                "gpus": {"accelerator": accel, "count": "1"}}

        # 2. the first notebook
        t0 = time.time()
        jwa.create_notebook(FAILOVER_NS, {**body, "name": "nb-fo-1"}, FAILOVER_USER)
        poll(lambda: running(api_b, "nb-fo-1"), 60, "nb-fo-1 Running")
        record["nb1_post_to_running_s"] = time.time() - t0
        env, node = pod_process_env(api_b, "nb-fo-1", FAILOVER_NS,
                                    os.path.join(root, "workspace"))
        kernel_dir = env["ODH_TORCH_KERNEL_CACHE"]
        os.makedirs(kernel_dir, exist_ok=True)
        lib = _build._target("int4_dequant")
        if lib.exists():  # built by this process's device phase
            shutil.copy2(lib, os.path.join(kernel_dir, lib.name))
        notebook = run_notebook(env, root)
        record["notebook_node"] = node
        caches = {"holder": scrape(metrics_url(holder)),
                  "scheduler": scrape(metrics_url("scheduler"))}

        # 3. kill the controller holding notebook-controller-leader
        ctl_lease = "notebook-controller-leader"
        before = lease(api_b, ctl_lease)
        dead_pid = procs[holder]["proc"].pid
        if not before["holderIdentity"].endswith(f"_{dead_pid}"):
            raise AssertionError(f"lease holder {before['holderIdentity']} is not {holder} "
                                 f"(pid {dead_pid})")
        os.kill(dead_pid, signal.SIGKILL)
        t_kill = time.time()
        after = poll(lambda: (lambda s: s if s["holderIdentity"] != before["holderIdentity"]
                              else None)(lease(api_b, ctl_lease)),
                     FAILOVER_CTL_LEASE_S + 10, "controller takeover", period=0.01)
        takeover_s = time.time() - t_kill
        record["controller_takeover"] = {
            "s": takeover_s,
            "limit_s": FAILOVER_CTL_LEASE_S + ctl_renew_s + 1.0,
            "transitions": [before["leaseTransitions"], after["leaseTransitions"]],
            "token": [before["fencingToken"], after["fencingToken"]],
            "new_holder_pid": int(after["holderIdentity"].rsplit("_", 1)[1])}
        try:
            with fenced(FAILOVER_LEASE_NS, ctl_lease, int(before["fencingToken"])):
                client(url_b).create({"apiVersion": "v1", "kind": "ConfigMap",
                                      "metadata": {"name": "deposed-write",
                                                   "namespace": FAILOVER_NS}})
            fenced_out = "applied"
        except FencedOut:
            fenced_out = "FencedOut"
        try:
            api_a.get("ConfigMap", "deposed-write", FAILOVER_NS)
            deposed_applied = True
        except NotFound:
            deposed_applied = False
        record["controller_takeover"].update(deposed_write=fenced_out,
                                             deposed_applied=deposed_applied)
        caches["standby"] = scrape(metrics_url(standby))

        # 4. kill the leader apiserver once only leases move (the standby's
        # first reconciles have landed) and B holds A's rv
        def report_a() -> dict:
            n = len(a["history"])
            a["proc"].stdin.write("report\n")
            a["proc"].stdin.flush()
            wait_line(a, lambda _x: len(a["history"]) > n, 10, "its report")
            return a["history"][-1]

        report = report_a()
        quiet_from = t_quiet = time.time()
        end = time.time() + 30
        while time.time() - quiet_from < FAILOVER_QUIET_S:
            if time.time() > end:
                raise AssertionError("platform_failover: writes other than leases never "
                                     f"stopped for {FAILOVER_QUIET_S} s")
            time.sleep(0.05)
            again = report_a()
            if again["non_lease_rv"] != report["non_lease_rv"]:
                quiet_from = time.time()
            report = again
        record["quiet_wait_s"] = time.time() - t_quiet
        caught = poll(lambda: (lambda ra: ra if served_rv(api_b) == ra else None)(
            served_rv(api_a)), 30, "B at A's rv", period=0.005)
        held = {k: sorted((o["metadata"]["namespace"], o["metadata"]["name"],
                           o["metadata"]["resourceVersion"]) for o in api_a.list(k))
                for k in FAILOVER_KINDS}
        os.kill(a["proc"].pid, signal.SIGKILL)
        t_kill_a = time.time()
        a["proc"].wait()
        # the stream's last bytes land, then B is frozen until it promotes
        time.sleep(0.3)
        follower_rv = served_rv(api_b)
        seen = lease(api_b, FAILOVER_CP_LEASE)
        promoted = poll(lambda: (lambda s: s if s["holderIdentity"] == FAILOVER_IDENTITY
                                 else None)(lease(api_b, FAILOVER_CP_LEASE)),
                        30, "promotion", period=0.01)
        promoted_at = parse_micro_time(promoted["acquireTime"])
        last_renew = parse_micro_time(seen["renewTime"])
        # the watchdog polls every third of a lease (``PromotionWatchdog.
        # run``); step() sees the lease lapsed at most a poll after it
        # does, counts the grace from that poll, and promotes at the first
        # poll the grace later: at most one more
        poll_s = max(FAILOVER_CP_LEASE_S / 3.0, 0.05)
        bound = ((1 + FAILOVER_GRACE_WINDOWS) * FAILOVER_CP_LEASE_S + 2 * poll_s
                 + scheduling_s)
        on_b = {k: sorted((o["metadata"]["namespace"], o["metadata"]["name"],
                           o["metadata"]["resourceVersion"]) for o in api_b.list(k))
                for k in FAILOVER_KINDS}
        wal_a = APIServer.recover(WriteAheadLog(os.path.join(root, "wal")))
        _, records = WriteAheadLog(os.path.join(root, "wal")).recover()
        at_kill = {k: sorted((o["metadata"]["namespace"], o["metadata"]["name"],
                              o["metadata"]["resourceVersion"]) for o in wal_a.list(k))
                   for k in FAILOVER_KINDS}
        wal_a.close()
        lost = {k: sorted(set(at_kill[k]) - set(on_b[k])) for k in FAILOVER_KINDS}
        beyond: dict = {}
        beyond_records = []
        for rec in records:
            if rec.get("op") != "register" and int(rec.get("rv", 0)) > follower_rv:
                obj = rec.get("obj") or {}
                kind = obj.get("kind", "")
                beyond[kind] = beyond.get(kind, 0) + 1
                meta = obj.get("metadata") or {}
                beyond_records.append([rec.get("rv"), kind, rec.get("etype"),
                                       f"{meta.get('namespace', '')}/{meta.get('name', '')}",
                                       obj.get("reason")])
        try:
            with fenced(FAILOVER_LEASE_NS, FAILOVER_CP_LEASE, token_a):
                client(url_b).create({"apiVersion": "v1", "kind": "ConfigMap",
                                      "metadata": {"name": "old-epoch-write",
                                                   "namespace": FAILOVER_NS}})
            old_epoch_write = "applied"
        except FencedOut:
            old_epoch_write = "FencedOut"
        with urllib.request.urlopen(url_b + "/replication/snapshot", timeout=30) as r:
            cut = json.loads(r.read())
        copy = ReplicaStore()
        copy.load_snapshot(cut)
        last = max((r for r in records if r.get("op") != "register"),
                   key=lambda r: int(r.get("rv", 0)))
        replay = dict(last["obj"])
        replay["metadata"] = {**replay["metadata"], "resourceVersion": str(cut["rv"] + 1)}
        try:
            copy.apply_replicated(last.get("etype", "MODIFIED"), replay, epoch=token_a)
            replayed = "applied"
        except FencedOut:
            replayed = "FencedOut"
        record["apiserver_failover"] = {
            "b_at_a_rv": caught, "follower_rv": follower_rv,
            "a_wal_rv": wal_a.applied_rv(), "acked_beyond_follower": beyond,
            "acked_beyond_records": beyond_records[:10],
            "kill_to_promoted_s": promoted_at - t_kill_a,
            "renew_to_promoted_s": promoted_at - last_renew, "bound_s": bound,
            "epoch": [token_a, int(promoted["fencingToken"]), int(cut["epoch"])],
            "held_at_kill": {k: len(v) for k, v in held.items()},
            "in_wal_at_kill": {k: len(v) for k, v in at_kill.items()},
            "lost": lost, "old_epoch_write": old_epoch_write, "old_epoch_replay": replayed}

        # 5. the second notebook on the promoted B, once the controllers
        # have renewed their leases on it
        for name in (ctl_lease, "gpu-scheduler-leader"):
            poll(lambda: parse_micro_time(lease(api_b, name)["renewTime"]) > promoted_at,
                 FAILOVER_CTL_LEASE_S, f"{name} renewed on the promoted store")
        t0 = time.time()
        jwa.create_notebook(FAILOVER_NS, {**body, "name": "nb-fo-2"}, FAILOVER_USER)
        try:
            poll(lambda: running(api_b, "nb-fo-2"), 60, "nb-fo-2 Running")
        except AssertionError as e:
            raise AssertionError(f"{e}; {failover_state(api_b, procs, kubelet_errors)}") from None
        record["nb2_post_to_running_s"] = time.time() - t0
        record["nb2_after_promotion_s"] = time.time() - promoted_at
        exited = {label: p["proc"].returncode for label, p in procs.items()
                  if label not in ("apiserver", holder) and p["proc"].poll() is not None}

        # 6. the notebook answers after the promotion
        notebook["go"]()
        nb = notebook["result"]()
        caches["standby_end"] = scrape(metrics_url(standby))
        caches["scheduler_end"] = scrape(metrics_url("scheduler"))
        record["caches"] = caches
    finally:
        stop_kubelet.set()
        for label, p in procs.items():
            if p["proc"].poll() is None:
                p["proc"].send_signal(signal.SIGINT)
        for label, p in procs.items():
            try:
                p["proc"].wait(timeout=10)
            except Exception:  # noqa: BLE001 — a process that ignores SIGINT is killed
                p["proc"].kill()
                p["proc"].wait()
        if notebook is not None and notebook["process"]["proc"].poll() is None:
            notebook["process"]["proc"].kill()
            notebook["process"]["proc"].wait()
    poisoned = (open(os.path.join(root, "reference-imports.log")).read().split("\n")
                if os.path.exists(os.path.join(root, "reference-imports.log")) else [])
    shutil.rmtree(root, ignore_errors=True)
    expected = LAUNCHES_PER_FORWARD * (2 + 1 + SPAWN_NEW_TOKENS)
    launches = nb["stage_launches"]
    record.update({
        "notebook": {k: nb.get(k) for k in ("imported_s", "service_s", "first_token_s",
                                            "go_s", "answered_s", "built", "device",
                                            "stage_launches", "launches")},
        "tokens": nb["tokens"], "after_promotion": nb["after_promotion"],
        "exited": exited, "kubelet_step_errors": len(kubelet_errors),
        "kubelet_errors": kubelet_errors[:5],
        "reference": {"imports": [x for x in poisoned if x],
                      "apiserver": report["reference_modules"],
                      "notebook": nb["reference_modules"]},
        "seconds": time.perf_counter() - t_phase,
    })
    ct, af = record["controller_takeover"], record["apiserver_failover"]
    if ct["s"] > ct["limit_s"]:
        problems.append(f"controller takeover {ct['s']:.2f} s > {ct['limit_s']} s")
    if ct["transitions"][1] != ct["transitions"][0] + 1 or ct["token"][1] != ct["token"][0] + 1:
        problems.append(f"takeover transitions {ct['transitions']}, token {ct['token']}")
    if ct["new_holder_pid"] != procs[standby]["proc"].pid:
        problems.append(f"the new holder is pid {ct['new_holder_pid']}, not the standby")
    if ct["deposed_write"] != "FencedOut" or ct["deposed_applied"]:
        problems.append(f"deposed holder's write: {ct['deposed_write']}, applied "
                        f"{ct['deposed_applied']}")
    if af["renew_to_promoted_s"] > af["bound_s"] or af["kill_to_promoted_s"] < 0:
        problems.append(f"promotion {af['renew_to_promoted_s']:.2f} s after the last renewal "
                        f"B saw (bound {af['bound_s']:.2f} s)")
    if af["epoch"] != [token_a, token_a + 1, token_a + 1]:
        problems.append(f"epochs {af['epoch']} (A's token + 1 expected)")
    if any(af["lost"].values()):
        problems.append(f"lost across the promotion: {af['lost']}")
    if set(af["acked_beyond_follower"]) - {"Lease"}:
        problems.append(f"A acked beyond B: {af['acked_beyond_follower']}")
    if af["old_epoch_write"] != "FencedOut" or af["old_epoch_replay"] != "FencedOut":
        problems.append(f"old epoch: write {af['old_epoch_write']}, replay "
                        f"{af['old_epoch_replay']}")
    if exited:
        problems.append(f"processes exited: {exited}")
    if spawn_tokens is not None and nb["tokens"] != spawn_tokens:
        problems.append(f"tokens {nb['tokens']} != platform_spawn's {spawn_tokens}")
    if nb["after_promotion"] != nb["first"] or nb["go_at"] < promoted_at:
        problems.append(f"after the promotion: {nb['after_promotion']} vs {nb['first']}")
    if (launches[1] != expected or launches[2] - launches[1] != launches[0]
            or launches[0] % LAUNCHES_PER_FORWARD or len(nb["tokens"]) != SPAWN_NEW_TOKENS):
        problems.append(f"dequant launches {launches} (expected {expected} after the "
                        f"first two requests, 225 a forward)")
    if any(record["reference"].values()):
        problems.append(f"reference modules: {record['reference']}")
    if record["seconds"] > limit_s:
        problems.append(f"the phase took {record['seconds']:.1f} s > {limit_s} s")
    if problems:
        raise AssertionError(f"platform_failover: {problems}; {record}")
    return record, nb["launches"]


PARTITIONS_N = 3
PARTITIONS_NS_PER = 2  # namespaces a partition
PARTITIONS_NOTEBOOKS = 4  # notebooks a namespace, one of the first namespace's on a GPU
PARTITIONS_EXTRA = 6  # notebooks created during the follower's merged walk
PARTITIONS_WALK_LIMIT = 5  # the follower's merged page size
PARTITIONS_PAGE_LIMIT = 3  # the split JWA's namespace page size
PARTITIONS_USER = "owner-pp@example.com"
PARTITIONS_GPU_QUOTA = "8"
PARTITIONS_GPU = ("nvidia-h100-80gb", "1")
PARTITIONS_PHASE_LIMIT_S = 45.0
PARTITIONS_RUNNING_AFTER_UP_S = 10.0  # the GPU pod Running again after "platform up"
PARTITIONS_CONVERGE_S = 10.0  # the follower's digests equal the platform's again
PARTITIONS_QUIET_S = 0.5  # no write on any partition for this long before a digest
PARTITIONS_KINDS = ("Profile", "Notebook", "StatefulSet")
# the platform process's settings: no sampler, pool or suspender writes on
# their own clock, so the store is quiet once the notebooks run; the
# lock-order sanitizer armed, read back through /debug/locks
PARTITIONS_PLATFORM_ENV = {
    "STORE_PARTITIONS": str(PARTITIONS_N), "USAGE_METERING": "false",
    "WARM_POOL_ENABLED": "false", "ENABLE_SESSION_SUSPEND": "false",
    "ENABLE_GPU_QUEUEING": "true", "TRACE_EXPORT": "false", "SNAPSHOT_INTERVAL": "0",
    "GRAFT_SANITIZE": "1",
}


def partition_namespaces(n: int = PARTITIONS_N, per: int = PARTITIONS_NS_PER) -> list:
    """``per`` namespaces on each of ``n`` partitions by ``partition_of``
    (``loadtest/overload_drill.py``'s pick), as [(namespace, partition)]
    in partition order."""
    from odh_kubeflow_tpu_torch.machinery.partition import partition_of

    by: dict = {p: [] for p in range(n)}
    i = 0
    while any(len(v) < per for v in by.values()):
        ns = f"team-pp-{i}"
        p = partition_of(ns, n)
        if len(by[p]) < per:
            by[p].append(ns)
        i += 1
    return [(ns, p) for p in range(n) for ns in by[p]]


def partition_states(url: str, n: int = PARTITIONS_N) -> list:
    """Each partition's state as ``/replication/snapshot?partition=<i>``
    serves it: ``[partition, sha256 over its objects, rv]``; the same
    function reads the platform and its follower."""
    import hashlib

    out = []
    for p in range(n):
        with urllib.request.urlopen(f"{url}/replication/snapshot?partition={p}",
                                    timeout=30) as r:
            cut = json.loads(r.read())
        objs = sorted(cut["objects"], key=lambda o: (
            o.get("kind", ""), o["metadata"].get("namespace", ""), o["metadata"]["name"]))
        digest = hashlib.sha256(json.dumps(objs, sort_keys=True).encode()).hexdigest()
        out.append([p, digest, int(cut["rv"])])
    return out


def follower_gauges(url: str) -> dict:
    """The partitioned follower's per-partition gauges on its ``/metrics``:
    ``{name: {partition: value}}``."""
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("replica_") and '{partition="' in line:
            name, rest = line.split("{", 1)
            part = int(rest.split('"')[1])
            out.setdefault(name, {})[part] = float(line.rsplit(" ", 1)[1])
    return out


def jwa_request(base: str, method: str, path: str, body=None) -> tuple[int, dict]:
    """One request to a JWA as ``PARTITIONS_USER`` (with the XSRF pair on
    writes); (status, JSON body), HTTP errors included."""
    req = urllib.request.Request(base + path, method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          "kubeflow-userid": PARTITIONS_USER,
                                          "Cookie": "XSRF-TOKEN=pp", "X-XSRF-TOKEN": "pp"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def debug_locks(url: str) -> dict:
    """The platform's ``/debug/locks``: whether the sanitizer is armed,
    its lock-order edges and its reports."""
    with urllib.request.urlopen(url + "/debug/locks?format=json", timeout=10) as r:
        data = json.loads(r.read().decode())
    edges = sorted(f"{a} -> {b}" for a, dsts in data["orderGraph"].items() for b in dsts)
    return {"enabled": data["enabled"], "edges": len(edges), "order": edges,
            "reports": data["reports"]}


def check_locks(locks: dict, when: str) -> None:
    """Armed, at least one edge witnessed, no report; else the phase fails."""
    if not locks["enabled"] or locks["edges"] < 1 or locks["reports"]:
        raise AssertionError(f"platform_partitions: /debug/locks {when}: {locks}")


def platform_partitions_phase(run_notebook=failover_notebook_process, spawn_tokens=None,
                              limit_s: float = PARTITIONS_PHASE_LIMIT_S) -> tuple[dict, int]:
    """The partitioned write path and the all-in-one platform, every
    process through its normal entry point, plain HTTP on 127.0.0.1:

    - P: ``python -m odh_kubeflow_tpu_torch.platform --sim --sim-gpu-nodes
      1`` with ``STORE_PARTITIONS=3`` and ``WAL_DIR`` here: three WAL'd
      partitions behind a ``PartitionRouter``; its controllers and informer
      cache hold merged watches over the three;
    - F: ``python -m odh_kubeflow_tpu_torch.machinery.replica`` with
      ``REPLICA_OF`` P and ``STORE_PARTITIONS=3``: one ``?partition=``-
      scoped follower a partition behind a reads-only router;
    - W: ``python -m odh_kubeflow_tpu_torch.web.jwa`` with ``KUBE_API_URL``
      P and ``READ_FROM_REPLICA`` F;
    - the notebook's process on the card (``run_notebook``, in its pod's
      env), started as soon as its pod is Running.

    1. Six namespaces, two a partition; a Profile each (the profile
    controller in P makes the RoleBindings and ``kf-resource-quota`` on
    ``requests.nvidia.com/gpu``); 4 notebooks a namespace POSTed through
    W, one on a GPU: all 24 Running. 2. F's cluster-wide Notebook walk at
    ``limit=5`` (composite tokens) returns the 24 once each, in order,
    while 6 more are created; W's namespace walk at ``limit=3`` returns its
    4 rows with ``servedRvPartitions`` of three entries; the first page's
    token 410s after a notebook there changed. 3. The notebook's 8B int4
    tokens (equal to ``spawn_tokens`` when given) at 225 dequant launches
    a forward. 4. Quiet, then each partition's state on P and F equal; P
    SIGKILLed and started again on its ``WAL_DIR``: every partition
    recovers its state, every Profile, Notebook and StatefulSet its uid and
    rv, the ``--sim`` nodes re-register, the GPU pod is Running within 10
    s of ``platform up``; F, not restarted, equals P again within 10 s. 5.
    One more notebook a partition Running through W; the card notebook
    answers. 6. No process loaded ``jax`` or ``odh_kubeflow_tpu``. 7.
    The phase within ``limit_s``. P runs with ``GRAFT_SANITIZE=1``: its
    ``/debug/locks`` answers enabled, with an edge and no report, before
    the kill and on the restarted P at the end."""
    import shutil
    import signal
    import tempfile

    from odh_kubeflow_tpu_torch.machinery.partition import is_composite_token
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.webhooks import gpu_runtime_poddefault

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="platform-partitions-")
    poison = reference_poison(root)
    api_port, web_port, f_port = listen_ports(3)
    url_p, url_f = f"http://127.0.0.1:{api_port}", f"http://127.0.0.1:{f_port}"
    p_argv = ["-m", "odh_kubeflow_tpu_torch.platform", "--sim", "--sim-gpu-nodes", "1",
              "--host", "127.0.0.1", "--api-port", str(api_port), "--web-port", str(web_port)]
    p_env = {**PARTITIONS_PLATFORM_ENV, "WAL_DIR": os.path.join(root, "wal")}
    record: dict = {"phase": "platform_partitions", "partitions": PARTITIONS_N}
    procs: dict = {}
    problems: list = []
    notebook = None
    namespaces = partition_namespaces()
    gpu_ns, gpu_nb = namespaces[0][0], "nb-gpu"
    walked_ns = namespaces[0][0]

    client = http_client

    def poll(fn, limit: float, what: str, period: float = 0.02):
        return poll_until(fn, limit, f"platform_partitions: {what}", period)

    def pods(c) -> dict:
        return {(o["metadata"]["namespace"], o["metadata"]["name"][:-2]): o
                for o in c.list("Pod") if o["metadata"]["name"].endswith("-0")}

    def running(c, want) -> bool:
        got = pods(c)
        return all((got.get(k) or {}).get("status", {}).get("phase") == "Running"
                   for k in want)

    def post(ns: str, name: str, gpu: bool = False) -> float:
        body = {"name": name, "cpu": "0.5", "memory": "1Gi"}
        if gpu:
            body.update(cpu="1", memory="4Gi",
                        gpus={"accelerator": PARTITIONS_GPU[0], "count": PARTITIONS_GPU[1]})
        t0 = time.time()
        code, out = jwa_request(url_w, "POST", f"/api/namespaces/{ns}/notebooks", body)
        if code != 201:
            raise AssertionError(f"POST {ns}/{name} through W: HTTP {code} {out}")
        return t0

    def quiet(c, what: str) -> list:
        """Waits until no partition's rv moves for ``PARTITIONS_QUIET_S``;
        returns the rvs."""
        c.list("Namespace")
        last, since = c.applied_rvs(), time.time()
        end = time.time() + 20
        while time.time() - since < PARTITIONS_QUIET_S:
            if time.time() > end:
                raise AssertionError(f"platform_partitions: writes never stopped ({what})")
            time.sleep(0.05)
            c.list("Namespace")
            now = c.applied_rvs()
            if now != last:
                last, since = now, time.time()
        return [last[p] for p in range(PARTITIONS_N)]

    def identities(c) -> dict:
        return {k: sorted([o["metadata"].get("namespace", ""), o["metadata"]["name"],
                           o["metadata"]["uid"], o["metadata"]["resourceVersion"]]
                          for o in c.list(k)) for k in PARTITIONS_KINDS}

    try:
        # P, then F, then W (W's informer syncs from F)
        procs["platform"] = start_process("platform", p_argv, p_env, root, poison)
        wait_line(procs["platform"], lambda x: "platform up" in x, 60, "platform up")
        record["boot_s"] = time.time() - procs["platform"]["started"]
        procs["follower"] = start_process(
            "follower", ["-m", "odh_kubeflow_tpu_torch.machinery.replica"],
            {"REPLICA_OF": url_p, "STORE_PARTITIONS": str(PARTITIONS_N),
             "HOST": "127.0.0.1", "PORT": str(f_port)}, root, poison)
        wait_line(procs["follower"], lambda x: "serving merged reads on" in x, 60,
                  "its serving line")
        # W's informer lists every kind P registered: F must hold them first
        poll(lambda: partition_states(url_f) == partition_states(url_p), 30, "F's cold join")
        record["follower_join_s"] = time.time() - procs["follower"]["started"]
        procs["jwa"] = start_process(
            "jwa", ["-m", "odh_kubeflow_tpu_torch.web.jwa"],
            {"KUBE_API_URL": url_p, "READ_FROM_REPLICA": url_f, "HOST": "127.0.0.1",
             "PORT": "0", "TRACE_EXPORT": "false"}, root, poison)
        api = client(url_p)

        # 1. the tenants, two a partition
        for ns, _ in namespaces:
            api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                        "metadata": {"name": ns},
                        "spec": {"owner": {"kind": "User", "name": PARTITIONS_USER},
                                 "resourceQuotaSpec": {"hard": {
                                     "requests.nvidia.com/gpu": PARTITIONS_GPU_QUOTA}}}})
            api.create(gpu_runtime_poddefault(ns))
        line = wait_line(procs["jwa"], lambda x: "jupyter-web-app on http://" in x, 60,
                         "its serving line")
        url_w = "http://127.0.0.1:" + line.rsplit(":", 1)[1].strip()
        quotas = poll(lambda: (lambda qs: qs if len(qs) == len(namespaces) else None)(
            [q for q in api.list("ResourceQuota") if q["metadata"]["name"] == "kf-resource-quota"
             and "requests.nvidia.com/gpu" in q["spec"]["hard"]]), 20, "six GPU quotas")
        # W authorizes once its cache holds the profile controller's RoleBindings
        for ns, _ in namespaces:
            poll(lambda ns=ns: jwa_request(url_w, "GET", f"/api/namespaces/{ns}/notebooks")[0]
                 == 200, 20, f"W's authorization in {ns}")
        stable = []
        t_gpu = post(gpu_ns, gpu_nb, gpu=True)
        stable.append((gpu_ns, gpu_nb))
        for ns, _ in namespaces:
            for j in range(PARTITIONS_NOTEBOOKS - (ns == gpu_ns)):
                post(ns, f"nb-{j}")
                stable.append((ns, f"nb-{j}"))
        stable.sort()
        poll(lambda: running(api, [(gpu_ns, gpu_nb)]), 30, "the GPU notebook Running")
        record["gpu_post_to_running_s"] = time.time() - t_gpu
        env, node = pod_process_env(api, gpu_nb, gpu_ns, os.path.join(root, "workspace"))
        kernel_dir = env["ODH_TORCH_KERNEL_CACHE"]
        os.makedirs(kernel_dir, exist_ok=True)
        lib = _build._target("int4_dequant")
        if lib.exists():  # built by this process's device phase
            shutil.copy2(lib, os.path.join(kernel_dir, lib.name))
        notebook = run_notebook(env, root)
        record["notebook_node"] = node
        poll(lambda: running(api, stable), 30, "the 24 notebooks Running")
        record["all_running_s"] = time.time() - t_gpu
        record["quotas"] = len(quotas)

        # 2. F's merged walk under writers, then W's namespace pages
        fc = client(url_f)
        poll(lambda: len(fc.list("Notebook")) == len(stable), 10, "the 24 on F")
        extra_ns = [ns for ns, _ in namespaces if ns != walked_ns]
        extras, seen, token, pages, tokens_composite = [], [], "", 0, True
        while True:
            items, token = fc.list_chunk("Notebook", limit=PARTITIONS_WALK_LIMIT,
                                         continue_token=token or None)
            pages += 1
            tokens_composite = tokens_composite and (not token or is_composite_token(token))
            seen += [(o["metadata"]["namespace"], o["metadata"]["name"]) for o in items]
            for _ in range(2):
                if len(extras) < PARTITIONS_EXTRA:
                    ns = extra_ns[len(extras) % len(extra_ns)]
                    post(ns, f"zz-{len(extras)}")
                    extras.append((ns, f"zz-{len(extras)}"))
            if not token:
                break
        record["follower_walk"] = {
            "pages": pages, "rows": len(seen), "extras_created": len(extras),
            "extras_seen": len([k for k in seen if k in extras]),
            "stable_in_order": [k for k in seen if k in stable] == stable,
            "duplicates": len(seen) - len(set(seen)),
            "composite_tokens": tokens_composite}
        poll(lambda: running(api, stable + extras), 30, "the extra notebooks Running")
        quiet(api, "before W's walk")
        rows, bodies, token, path = [], [], "", f"/api/namespaces/{walked_ns}/notebooks"
        while True:
            q = f"?limit={PARTITIONS_PAGE_LIMIT}" + (
                "&continue=" + urllib.parse.quote(token, safe="") if token else "")
            code, body = jwa_request(url_w, "GET", path + q)
            if code != 200:
                raise AssertionError(f"W's page: HTTP {code} {body}")
            bodies.append(body)
            rows += [r["name"] for r in body["notebooks"]]
            if not token:
                first_token = body.get("continue", "")
            token = body.get("continue", "")
            if not token:
                break
        nb = api.get("Notebook", "nb-0", walked_ns)
        nb["metadata"].setdefault("labels", {})["walked"] = "true"
        api.update(nb)
        stale = poll(lambda: (lambda r: r if r[0] == 410 else None)(jwa_request(
            url_w, "GET", path + f"?limit={PARTITIONS_PAGE_LIMIT}&continue="
            + urllib.parse.quote(first_token, safe=""))), 10, "a 410 for the stale token")
        record["jwa_walk"] = {
            "namespace": walked_ns, "pages": len(bodies), "rows": sorted(rows),
            "served_rv_partitions": [sorted(b.get("servedRvPartitions") or {}) for b in bodies],
            "served_rv": [b.get("servedRv") for b in bodies], "stale_token": stale[0]}

        # 4. quiet; P and F equal; kill P and start it again on its WAL
        rvs = quiet(api, "before the kill")
        before = partition_states(url_p)
        f_before = poll(lambda: (lambda s: s if s == before else None)(
            partition_states(url_f)), PARTITIONS_CONVERGE_S, "F equal to P before the kill")
        ids_before = identities(api)
        gpu_pod = pods(api)[(gpu_ns, gpu_nb)]
        gauges_before = follower_gauges(url_f)
        record["locks_before_kill"] = debug_locks(url_p)
        check_locks(record["locks_before_kill"], "before the kill")
        p = procs.pop("platform")
        os.kill(p["proc"].pid, signal.SIGKILL)
        t_kill = time.time()
        p["proc"].wait()
        procs["platform_killed"] = p
        procs["platform"] = start_process("platform-2", p_argv, p_env, root, poison)
        wait_line(procs["platform"], lambda x: "platform up" in x, 60, "platform up again")
        t_up = time.time()
        api = client(url_p)
        after = partition_states(url_p)
        ids_after = identities(api)
        poll(lambda: running(api, [(gpu_ns, gpu_nb)]), 30, "the GPU pod Running again")
        gpu_running_s = time.time() - t_up
        gpu_pod_after = pods(api)[(gpu_ns, gpu_nb)]
        f_after = poll(lambda: (lambda s: s if s == partition_states(url_p) else None)(
            partition_states(url_f)), 30, "F equal to P after the restart")
        f_converged_s = time.time() - t_up
        gauges_after = follower_gauges(url_f)
        snaps = [int(gauges_after["replica_snapshots_loaded"][i]
                     - gauges_before["replica_snapshots_loaded"][i])
                 for i in range(PARTITIONS_N)]
        record["recovery"] = {
            "quiet_rvs": rvs, "states_before": before, "states_after": after,
            "follower_before": f_before, "follower_after": f_after,
            "states_equal": after == before,
            "identities_equal": ids_after == ids_before,
            "objects": {k: len(v) for k, v in ids_before.items()},
            "kill_to_up_s": t_up - t_kill,
            "gpu_pod_uid_kept": gpu_pod["metadata"]["uid"] == gpu_pod_after["metadata"]["uid"],
            "gpu_pod_running_after_up_s": gpu_running_s,
            "follower_converged_after_up_s": f_converged_s,
            "follower_resumed": ["rv" if s == 0 else "snapshot" for s in snaps],
            "follower_reconnects": [int(gauges_after["replica_reconnects"][i]
                                        - gauges_before["replica_reconnects"][i])
                                    for i in range(PARTITIONS_N)],
            "follower_pid_kept": procs["follower"]["proc"].poll() is None}

        # 5. one notebook a partition through W, then the card answers
        t0 = time.time()
        after_nbs = []
        for part in range(PARTITIONS_N):
            ns = next(n for n, q in namespaces if q == part)
            post(ns, "after")
            after_nbs.append((ns, "after"))
        poll(lambda: running(api, after_nbs), 30, "a notebook a partition Running")
        record["after_recovery_running_s"] = time.time() - t0
        notebook["go"]()
        nb_rec = notebook["result"]()
        record["locks_after_restart"] = debug_locks(url_p)
        check_locks(record["locks_after_restart"], "on the restarted platform")
        print("platform_partitions /debug/locks edges: before the kill "
              f"{record['locks_before_kill']['edges']}, after the restart "
              f"{record['locks_after_restart']['edges']}", flush=True)
        exited = {label: p["proc"].returncode for label, p in procs.items()
                  if label != "platform_killed" and p["proc"].poll() is not None}
    finally:
        for label, p in procs.items():
            if p["proc"].poll() is None:
                p["proc"].send_signal(signal.SIGINT)
        for label, p in procs.items():
            try:
                p["proc"].wait(timeout=10)
            except Exception:  # noqa: BLE001 — a process that ignores SIGINT is killed
                p["proc"].kill()
                p["proc"].wait()
        if notebook is not None and notebook["process"]["proc"].poll() is None:
            notebook["process"]["proc"].kill()
            notebook["process"]["proc"].wait()
    log = os.path.join(root, "reference-imports.log")
    poisoned = open(log).read().split("\n") if os.path.exists(log) else []
    shutil.rmtree(root, ignore_errors=True)
    expected = LAUNCHES_PER_FORWARD * (2 + 1 + SPAWN_NEW_TOKENS)
    launches = nb_rec["stage_launches"]
    record.update({
        "notebook": {k: nb_rec.get(k) for k in ("imported_s", "service_s", "first_token_s",
                                                "go_s", "answered_s", "built", "device",
                                                "stage_launches", "launches")},
        "tokens": nb_rec["tokens"], "after_recovery": nb_rec["after_promotion"],
        "exited": exited,
        "reference": {"imports": [x for x in poisoned if x],
                      "notebook": nb_rec["reference_modules"]},
        "seconds": time.perf_counter() - t_phase,
    })
    fw, jw, rc = record["follower_walk"], record["jwa_walk"], record["recovery"]
    if (not fw["stable_in_order"] or fw["duplicates"] or not fw["composite_tokens"]
            or fw["extras_created"] != PARTITIONS_EXTRA or fw["pages"] < 2):
        problems.append(f"follower walk {fw}")
    if jw["rows"] != sorted(n for ns, n in stable if ns == walked_ns):
        problems.append(f"W's walk rows {jw['rows']}")
    if any(len(s) != PARTITIONS_N for s in jw["served_rv_partitions"]) or jw["pages"] < 2:
        problems.append(f"W's pages: {jw}")
    if jw["stale_token"] != 410:
        problems.append(f"stale token answered {jw['stale_token']}")
    if rc["follower_before"] != rc["states_before"]:
        problems.append("F differed from P before the kill")
    if not rc["states_equal"]:
        problems.append(f"states after the restart {rc['states_after']} != {rc['states_before']}")
    if not rc["identities_equal"]:
        problems.append("a Profile, Notebook or StatefulSet changed uid or rv across the restart")
    if rc["gpu_pod_running_after_up_s"] > PARTITIONS_RUNNING_AFTER_UP_S:
        problems.append(f"GPU pod Running {rc['gpu_pod_running_after_up_s']:.1f} s after up")
    if rc["follower_converged_after_up_s"] > PARTITIONS_CONVERGE_S or not rc["follower_pid_kept"]:
        problems.append(f"follower converged {rc['follower_converged_after_up_s']:.1f} s after "
                        "up (or restarted)")
    if exited:
        problems.append(f"processes exited: {exited}")
    if spawn_tokens is not None and nb_rec["tokens"] != spawn_tokens:
        problems.append(f"tokens {nb_rec['tokens']} != platform_spawn's {spawn_tokens}")
    if nb_rec["after_promotion"] != nb_rec["first"] or nb_rec["go_at"] < t_up:
        problems.append(f"after the recovery: {nb_rec['after_promotion']} vs {nb_rec['first']}")
    if (launches[1] != expected or launches[2] - launches[1] != launches[0]
            or launches[0] % LAUNCHES_PER_FORWARD or len(nb_rec["tokens"]) != SPAWN_NEW_TOKENS):
        problems.append(f"dequant launches {launches} (expected {expected} after the first two "
                        "requests, 225 a forward)")
    if any(record["reference"].values()):
        problems.append(f"reference modules: {record['reference']}")
    if record["seconds"] > limit_s:
        problems.append(f"the phase took {record['seconds']:.1f} s > {limit_s} s")
    if problems:
        raise AssertionError(f"platform_partitions: {problems}; {record}")
    return record, nb_rec["launches"]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def listen_ports(n: int) -> list[int]:
    """``n`` distinct free ports below the kernel's ephemeral range, for
    servers that bind long after their port is chosen (a standby
    controller serves ``/metrics`` only once it holds its lease): a port
    from ``free_port()`` lies in that range, where any outgoing
    connection may take it first."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    if low < 4096:  # no room below the range: take the ephemeral ones
        return [free_port() for _ in range(n)]
    rng = random.Random()
    ports: list[int] = []
    while len(ports) < n:
        port = rng.randrange(max(2048, low - 16384), low)
        if port in ports:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
    return ports


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
    plain_ms = {n: 0.0 for n in worst}  # summed over the KV head groups

    def timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn()
        end.record()
        end.synchronize()
        plain_ms[name] += start.elapsed_time(end)
        return got

    for h in range(Hkv):  # KV head h and its query heads
        qs, ks = slice(h * g, (h + 1) * g), slice(h, h + 1)
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks], lse[:, qs], delta[:, qs], do[:, :, qs],
                seg, seg)
        ref_out, ref_lse = timed("flash_fwd", lambda: fa.flash_fwd_reference(*args[:3], seg, seg))
        close("flash_fwd", out[:, :, qs], ref_out)
        lse_err = max(lse_err, (lse[:, qs] - ref_lse).abs().max().item())
        del ref_out, ref_lse
        close("flash_dq", dq[:, :, qs], timed("flash_dq", lambda: fa.flash_dq_reference(*args)))
        rk, rv = timed("flash_dkv", lambda: fa.flash_dkv_reference(*args))
        close("flash_dkv", dk[:, :, ks], rk)
        close("flash_dkv", dv[:, :, ks], rv)
        del rk, rv
        torch.cuda.empty_cache()
    times = long_row_times(torch, fa, q, k, v, do, seg, lse, delta)
    times["plain_ms"] = plain_ms
    times["plain_note"] = ("the plain versions one KV head group (4 query heads) at a time, "
                           "summed over the 8 groups, one pass, no warm-up: the whole row's "
                           "f32 scores [1, 32, 16384, 16384] take 32 GiB, and its "
                           "probabilities and their gradient as much again")
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
            "lse2_max_abs_err": lse_err, **worst, "times": times,
            "tolerance": {n: f"||kernel - plain|| / ||plain|| <= {fa.TILE_RTOL[n]} in every "
                             "tile of 64 positions of one row and head" for n in worst}
                         | {"lse2": "max abs err <= 1e-3"}}


def long_row_times(torch, fa, q, k, v, do, seg, lse, delta) -> dict:
    """At the 16k packed row (``[1, 16384, 32, 128]`` queries, 8 KV heads,
    the row's segment ids): the three flash kernels' ms a launch, and the
    library's yardstick, ``F.scaled_dot_product_attention`` with the
    segment-causal boolean mask (GQA by ``enable_gqa``), forward and
    forward + backward (dQ, dK, dV together). Device time by CUDA events
    (``time_ms``)."""
    import torch.nn.functional as F

    kernels = {
        "flash_fwd": lambda i: fa.flash_fwd(q, k, v, seg, seg),
        "flash_dq": lambda i: fa.flash_dq(q, k, v, lse, delta, do, seg, seg),
        "flash_dkv": lambda i: fa.flash_dkv(q, k, v, lse, delta, do, seg, seg),
    }
    out = {"kernel_ms": {n: time_ms(torch, fn, iters=3, reps=3) for n, fn in kernels.items()}}
    S, group = q.shape[1], q.shape[2] // k.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = ((seg[0][:, None] == seg[0][None, :]) & (pos[:, None] >= pos[None, :]))[None, None]
    g = do.transpose(1, 2)
    # GQA through ``enable_gqa`` first; where no backend takes that with a
    # mask, the KV heads repeated to the query heads (outside the timing)
    routes = (("enable_gqa", k, v, {"enable_gqa": True}),
              ("kv heads repeated", k.repeat_interleave(group, dim=2),
               v.repeat_interleave(group, dim=2), {}))
    errors = []
    for route, kk, vv, kw in routes:
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, kk, vv))

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, **kw)

        try:
            fwd = time_ms(torch, lambda i: sdpa(), iters=3, reps=3)
            fwd_bwd = time_ms(torch, lambda i: torch.autograd.grad(sdpa(), (qh, kh, vh), g),
                              iters=3, reps=3)
        except (RuntimeError, torch.OutOfMemoryError) as e:
            errors.append(f"{route}: {type(e).__name__}: {str(e)[:200]}")
            continue
        finally:
            del qh, kh, vh
            torch.cuda.empty_cache()
        out.update(sdpa_route=route, sdpa_fwd_ms=fwd, sdpa_fwd_bwd_ms=fwd_bwd,
                   sdpa_bwd_ms=fwd_bwd - fwd)
        break
    else:
        out["sdpa_fwd_ms"] = out["sdpa_fwd_bwd_ms"] = "not measured: " + "; ".join(errors)
    out["sdpa_errors"] = errors
    del mask, routes
    torch.cuda.empty_cache()
    out["kernel_pair_ms"] = out["kernel_ms"]["flash_dq"] + out["kernel_ms"]["flash_dkv"]
    out["kernel_fwd_bwd_ms"] = out["kernel_ms"]["flash_fwd"] + out["kernel_pair_ms"]
    return out


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


JSONTREE_TREES = 3000  # seeded trees held to the stdlib
JSONTREE_SEED = 26
JSONTREE_NOTEBOOKS = 300  # the timed list's length
JSONTREE_REPS = 30  # timed calls per engine (the median is reported)


def jsontree_tree(rng, objects, depth: int = 0):
    """A seeded JSON-shaped tree with the serializer's edges: non-BMP and
    control characters, ``inf``/``nan``/``-0.0``, big ints, tuples, the
    informer cache's frozen subclasses, and (rarely) a non-str key that
    the extension hands back to the stdlib."""
    import string

    roll = rng.random()
    if depth >= 4 or roll < 0.45:
        leaf = rng.randrange(8)
        if leaf == 0:
            return rng.choice([None, True, False])
        if leaf == 1:
            return rng.randrange(-(10**20), 10**20)
        if leaf == 2:
            return rng.choice([rng.uniform(-1e6, 1e6), rng.random() * 10 ** rng.randrange(-20, 20)])
        if leaf == 3:
            return rng.choice([math.inf, -math.inf, math.nan, -0.0, 0.0])
        alphabet = (string.ascii_letters + string.digits + '"\\\b\t\n\f\r/ ' + "éüß "
                    + "\U0001f600\U0001f9ea\U00010348" + "\x00\x1f\x7f")
        return "".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 24)))
    if roll < 0.72:
        d = {"k%d" % i: jsontree_tree(rng, objects, depth + 1) for i in range(rng.randrange(0, 6))}
        if rng.random() < 0.03:
            d[rng.choice([1, 2.5, True, None])] = "non-str key"
        return objects.freeze(d) if rng.random() < 0.2 else d
    items = [jsontree_tree(rng, objects, depth + 1) for _ in range(rng.randrange(0, 6))]
    if rng.random() < 0.1:
        return tuple(items)
    return objects.freeze(items) if rng.random() < 0.2 else items


def notebook_list(n: int) -> dict:
    """A NotebookList of ``n`` notebooks in the shape the JWA and the REST
    façade serve (metadata, a GPU container spec, status conditions)."""
    items = []
    for i in range(n):
        ns, name = f"team-{i % 12}", f"nb-{i:04d}"
        items.append({
            "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {
                "name": name, "namespace": ns, "uid": f"00000000-0000-4000-8000-{i:012d}",
                "resourceVersion": str(1000 + i), "generation": 1,
                "creationTimestamp": "2026-10-19T08:00:00Z",
                "labels": {"app": name, "notebook-name": name, "gpu-runtime": "true"},
                "annotations": {"notebooks.kubeflow.org/gpu-accelerator": "nvidia-h100-80gb",
                                "notebooks.kubeflow.org/gpu-count": "1",
                                "notebooks.kubeflow.org/last-activity": "2026-10-19T08:30:00Z",
                                "notebooks.kubeflow.org/creator": f"owner-{i}@example.com"}},
            "spec": {"template": {"spec": {
                "serviceAccountName": "default-editor",
                "containers": [{
                    "name": name, "image": "kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.7.0",
                    "resources": {"requests": {"cpu": "1", "memory": "4Gi", "nvidia.com/gpu": "1"},
                                  "limits": {"cpu": "2", "memory": "8Gi", "nvidia.com/gpu": "1"}},
                    "env": [{"name": "NB_PREFIX", "value": f"/notebook/{ns}/{name}"}],
                    "volumeMounts": [{"name": "workspace", "mountPath": "/home/jovyan"},
                                     {"name": "dshm", "mountPath": "/dev/shm"}]}],
                "volumes": [{"name": "workspace",
                             "persistentVolumeClaim": {"claimName": f"{name}-workspace"}},
                            {"name": "dshm", "emptyDir": {"medium": "Memory"}}]}}},
            "status": {"readyReplicas": 1, "containerState": {"running": {
                "startedAt": "2026-10-19T08:01:00Z"}},
                "conditions": [{"type": "Ready", "status": "True",
                                "lastProbeTime": "2026-10-19T08:01:05Z"}]}})
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "NotebookList",
            "metadata": {"resourceVersion": str(1000 + n)}, "items": items}


def native_jsontree_phase(label: str) -> dict:
    """The control plane's JSON-tree extension on this machine's host:
    built with its g++ and Python headers, taken by ``serialize`` and
    ``objects``, held byte for byte to the stdlib on seeded trees, and
    timed against the stdlib on a 300-Notebook list (host CPU time, not
    the card's)."""
    import random

    from odh_kubeflow_tpu_torch import native
    from odh_kubeflow_tpu_torch.machinery import objects, serialize

    t0 = time.perf_counter()
    so = native.build_jsontree()
    build_s = time.perf_counter() - t0
    if so is None:
        raise AssertionError("native_jsontree: no C++ compiler on this machine")
    if serialize.engine() != "native" or objects.engine() != "native":
        raise AssertionError(f"native_jsontree: engines {serialize.engine()}/{objects.engine()}")
    c_copy = native._jsontree_module().deepcopy
    if objects._native() is not c_copy:
        raise AssertionError("native_jsontree: objects.deepcopy is not on the extension")
    rng = random.Random(JSONTREE_SEED)
    mismatches, shared, fallbacks = [], 0, 0
    for i in range(JSONTREE_TREES):
        tree = jsontree_tree(rng, objects)
        want = json.dumps(tree).encode()
        if serialize.dumps(tree) != want:
            mismatches.append(("dumps", i))
        copy = objects.deepcopy(tree)
        if json.dumps(copy).encode() != want:
            mismatches.append(("deepcopy", i))
        stack = [(copy, tree)]
        while stack:
            a, b = stack.pop()
            if isinstance(a, (dict, list)):
                if a is b or type(a) not in (dict, list):
                    shared += 1
                pairs = zip(a.values(), b.values()) if isinstance(a, dict) else zip(a, b)
                stack.extend(pairs)
        fallbacks += "non-str key" in want.decode()
    if mismatches or shared:
        raise AssertionError(f"native_jsontree: mismatches {mismatches[:5]}, shared {shared}")

    doc = notebook_list(JSONTREE_NOTEBOOKS)
    frozen = objects.freeze(doc)

    def us(fn, arg) -> float:
        fn(arg)
        times = []
        for _ in range(JSONTREE_REPS):
            t = time.perf_counter()
            fn(arg)
            times.append(time.perf_counter() - t)
        return statistics.median(times) * 1e6

    timings = {}
    for engine in ("python", "native"):
        serialize.set_engine(engine)
        try:
            timings[f"dumps_{engine}_us"] = us(serialize.dumps, frozen)
        finally:
            serialize.set_engine(None)
    timings["deepcopy_python_us"] = us(objects._py_deepcopy, doc)
    timings["deepcopy_native_us"] = us(objects.deepcopy, doc)
    timings["thaw_python_us"] = us(objects._thaw, frozen)
    timings["thaw_native_us"] = us(objects.mutable, frozen)
    return {"phase": "native_jsontree", "card": label, "where": "host CPU of the card machine",
            "engine": serialize.engine(), "deepcopy_engine": objects.engine(),
            "library": os.path.relpath(str(so)), "build_s": build_s,
            "trees": JSONTREE_TREES, "seed": JSONTREE_SEED, "fallback_trees": fallbacks,
            "notebooks": JSONTREE_NOTEBOOKS, "list_bytes": len(serialize.dumps(frozen)),
            **timings,
            "dumps_speedup": timings["dumps_python_us"] / timings["dumps_native_us"],
            "deepcopy_speedup": timings["deepcopy_python_us"] / timings["deepcopy_native_us"]}


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
    # the control plane's JSON-tree extension, on this machine's host CPU
    emit(native_jsontree_phase(label))

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
    # the platform phases time host loops (the meter's 1 s samples, the
    # culler, the apiserver's event loop) in this process: what the model
    # phases left on its heap moves out of the cyclic collector's reach,
    # so that a full collection cannot stall them for seconds
    gc.collect()
    gc.freeze()
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
    spawn_tokens = record["card_step"]["tokens"]
    # suspend-to-checkpoint sessions and the warm-start subsystem (slice
    # 9, part 3): a cold standby, a warm handout, suspend and resume
    record, sessions_launches = platform_sessions_phase()
    record["card"] = label
    emit(record)
    # the observability path (slice 9, part 4): the notebook's 8B QLoRA
    # step profiled on the card into its PVC, served by TensorBoard; the
    # spawn's trace, exemplar and SLOs; the dashboard, VWA, TWA, kfam app
    record, observe_launches = platform_observe_phase()
    record["card"] = label
    emit(record)
    # GPU-second metering on a crash-safe store (slice 9, part 5): the
    # notebook's 8B QLoRA steps and idle time metered from the GPU
    # activity agent's NVML duty, across a store crash inside a flush
    record, usage_launches = platform_usage_phase()
    record["card"] = label
    emit(record)
    # the platform over the wire (slice 9, part 6): the controllers in a
    # process of their own against the REST façade over TLS, 500 watches,
    # a user flood against the overload defense while the spawned
    # notebook serves the 8B int4 model on the card
    record, remote_launches = platform_remote_phase(spawn_tokens=spawn_tokens)
    record["card"] = label
    emit(record)
    # the highly available control plane (slice 9, part 7): leader
    # election with fencing, the informer cache, a WAL-shipped follower
    # promoted by its watchdog; a notebook serves on the card while a
    # controller and then the leader apiserver are SIGKILLed
    record, failover_launches = platform_failover_phase(spawn_tokens=spawn_tokens)
    record["card"] = label
    emit(record)
    # the partitioned write path and the all-in-one platform (slice 9,
    # part 8): three WAL'd partitions behind the partition router, a
    # partitioned follower and the split JWA; the platform is SIGKILLed
    # and recovers while a notebook serves on the card
    record, partitions_launches = platform_partitions_phase(spawn_tokens=spawn_tokens)
    record["card"] = label
    emit(record)

    gc.unfreeze()
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
                                  "platform_sessions": sessions_launches,
                                  "platform_observe": observe_launches["int4_dequant"],
                                  "platform_usage": usage_launches["int4_dequant"],
                                  "platform_remote": remote_launches,
                                  "platform_failover": failover_launches,
                                  "platform_partitions": partitions_launches}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    paths = {"train": train_launches, "moe_train": moe_launches,
             "moe_serve": moe_serve_launches, "moe_engine": moe_engine_launches,
             "moe_engine_mesh": moe_engine_mesh_launches,
             "moe_full_train": full_launches, "mesh_train": mesh_launches,
             "ring_on_card": ring_launches, "moe_mesh_train": moe_mesh_launches,
             "moe_ep_loopback": ep_launches, "pipe_loopback": pipe_launches,
             "moe_pipe_loopback": moe_pipe_launches, "long_context_text": long_launches,
             "moe_offload": moe_offload_launches,
             "platform_conformance": conformance_launches,
             "platform_observe": observe_launches,
             "platform_usage": usage_launches}
    for row in flash_rows + moe_rows + bf16_rows:
        row["launches_by_path"] = {p: n[row["name"]] for p, n in paths.items()
                                   if n.get(row["name"])}
        row["launches"] = sum(row["launches_by_path"].values())
    for row in int4_rows:
        row["launches_by_path"] = {"int4_qlora_proj": proj_launches[row["name"]]}
        row["launches"] = proj_launches[row["name"]]
        row["launches_by_instance"] = proj_instances[row["name"].removeprefix("int4_")]
    emit(phase_seconds_line())
    emit({"kernels": [kernel, *flash_rows, *moe_rows, *bf16_rows, *int4_rows]})
    print(label, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit({"--notebook-serve": notebook_serve_main,
              "--notebook-profile": notebook_profile_main,
              "--notebook-usage": notebook_usage_main,
              "--platform-controllers": platform_controllers_main,
              "--platform-apiserver": platform_apiserver_main,
              "--notebook-failover": notebook_failover_main,
              "--platform-flood": platform_flood_main}.get(
                  " ".join(sys.argv[1:]), main)())
