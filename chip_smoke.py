#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, MoE training and MoE
serving paths and its int4 fused-dequant matmul on one NVIDIA GPU and
check them.

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
   on an unpacked and a packed batch; and remat "attn" against "none".
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

Then the kernel table (``{"kernels": [...]}``), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero without the last line. Without a GPU it exits
2 and prints nothing on stdout.
"""

from __future__ import annotations

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
# the 2-layer parity model: ||kernel - plain|| / ||plain|| <= tol for
# every adapter gradient leaf; relative tolerance on the loss
TRAIN_GRAD_TOL = 5e-2
TRAIN_LOSS_RTOL = 2e-3
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
        qb, kb = B * S * Hq * hd * 2, B * S * Hkv * hd * 2
        rowb = B * Hq * S * 4
        work = {  # (flops, bytes: each input read once, each output written once)
            "flash_fwd": (4 * hd * pairs * Hq, 2 * qb + 2 * kb + rowb),
            "flash_dq": (6 * hd * pairs * Hq, 3 * qb + 2 * kb + 2 * rowb),
            "flash_dkv": (8 * hd * pairs * Hq, 2 * qb + 4 * kb + 2 * rowb),
        }
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
    bench = trainer.benchmark(B, S, steps=steps, warmup=warmup)
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
        "peak_flops": peak, "loss_benchmark": bench["loss"],
        "loss_after": loss, "grad_norm_after": gnorm,
        "launches": launched, "launches_per_step": TRAIN_LAUNCHES_PER_STEP,
        "adapter_b_max_abs": moved,
    }
    return record, trainer


def train_parity_phase(torch, fa, int4) -> dict:
    """A 2-layer model at 8B width: the kernels against the plain versions
    inside one training step's loss and adapter gradients."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
    from odh_kubeflow_tpu_torch.train.data import pack_documents, prefetch_to_device

    def with_plain(fn):
        kept = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv, int4.int4_dequant)
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
            fa.flash_fwd_reference, fa.flash_dq_reference, fa.flash_dkv_reference)
        int4.int4_dequant = int4.int4_dequant_reference
        try:
            return fn()
        finally:
            fa.flash_fwd, fa.flash_dq, fa.flash_dkv, int4.int4_dequant = kept

    B, S = TRAIN_SHAPE
    cfg = LlamaConfig.llama3_8b(num_layers=2, remat=True, remat_policy="attn")
    trainer = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base="int4", seed=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    with torch.no_grad():  # a live adapter: b != 0, so every leaf has a gradient
        for ab in trainer.lora_params["layers"].values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.01)
    rng = torch.Generator().manual_seed(10)
    docs = [torch.randint(1, cfg.vocab_size, (int(n),), generator=rng).tolist()
            for n in torch.randint(100, 1500, (24,), generator=rng)]
    packed = next(prefetch_to_device(pack_documents(docs, B, S)))
    batches = {"unpacked": trainer.make_fake_batch(B, S, seed=2), "packed": packed}
    out = {"phase": "train_parity_on_card", "layers": 2, "batch": B, "seq": S,
           "grad_tol": f"||kernel - plain|| / ||plain|| <= {TRAIN_GRAD_TOL} per leaf",
           "loss_rtol": TRAIN_LOSS_RTOL}
    for name, batch in batches.items():
        before = counts(fa, int4)
        k_loss, k_grads = trainer.gradients(batch)
        mid = counts(fa, int4)
        if not all(mid[n] > before[n] for n in mid):
            raise AssertionError(f"{name}: a kernel did not launch: {before} -> {mid}")
        p_loss, p_grads = with_plain(lambda: trainer.gradients(batch))
        if counts(fa, int4) != mid:
            raise AssertionError(f"{name}: the plain run launched a kernel")
        k_loss, p_loss = float(k_loss), float(p_loss)
        worst = 0.0
        for path, pg in p_grads.items():
            kg = k_grads[path]
            if not bool(torch.isfinite(kg).all()):
                raise AssertionError(f"{name}: non-finite gradient {path}")
            rel = ((kg.float() - pg.float()).norm() / pg.float().norm().clamp_min(1e-30)).item()
            worst = max(worst, rel)
        out[name] = {"loss_kernels": k_loss, "loss_plain": p_loss,
                     "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
                     "worst_leaf_grad_rel_diff": worst, "leaves": len(p_grads)}
        if not (math.isfinite(k_loss) and out[name]["loss_rel_diff"] <= TRAIN_LOSS_RTOL
                and worst <= TRAIN_GRAD_TOL):
            raise AssertionError(f"train parity {name}: {out[name]}")
        if name == "unpacked":
            unpacked = (batch, k_grads)
    batch, attn_grads = unpacked
    trainer.model_cfg = dataclasses.replace(cfg, remat_policy="none")
    _, none_grads = trainer.gradients(batch)
    worst = max((none_grads[p] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for p, g in attn_grads.items())
    out["attn_vs_none_worst_leaf_grad_rel_diff"] = worst
    if worst > 1e-3:
        raise AssertionError(f"remat attn vs none gradients differ: {worst}")
    return out


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
    bench = trainer.benchmark(B, S, steps=steps, warmup=warmup)
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
        "peak_flops": peak, "loss_benchmark": bench["loss"],
        "loss_after": loss, "grad_norm_after": gnorm,
        "launches": launched, "launches_per_step": MOE_LAUNCHES_PER_STEP,
        "adapter_b_max_abs": moved,
    }
    return record, trainer


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
    del params
    torch.cuda.empty_cache()

    # training (slice 2)
    record, trainer = train_phase(torch, fa, int4, peak)
    record["card"] = label
    emit(record)
    train_launches = record["launches"]
    emit(train_profile_phase(torch, trainer))
    del trainer
    torch.cuda.empty_cache()
    emit(train_parity_phase(torch, fa, int4))

    # MoE training (slice 3)
    record, trainer = moe_train_phase(torch, fa, int4, gm, peak)
    record["card"] = label
    emit(record)
    moe_launches = record["launches"]
    emit(moe_train_profile_phase(torch, trainer))
    del trainer
    torch.cuda.empty_cache()
    emit(moe_train_parity_phase(torch, fa, int4, gm))

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

    kernel["launches"] = serve_launches + train_launches["int4_dequant"]
    kernel["launches_by_path"] = {"serve": serve_launches,
                                  "train": train_launches["int4_dequant"], "moe_train": 0}
    paths = {"train": train_launches, "moe_train": moe_launches,
             "moe_serve": moe_serve_launches, "moe_full_train": full_launches}
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
    sys.exit(main())
