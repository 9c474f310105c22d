#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each on stdout:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the time to build every CUDA kernel of the path
   from ``odh_kubeflow_tpu_torch/csrc`` into ``build/torch_kernels/``.
2. ``kernels``: each kernel against its plain PyTorch version on the
   card, bit for bit, at the shapes the Llama-3-8B forward gives it, with
   its time (CUDA events, median), the least time the card could take
   (bytes moved over the card's spec bandwidth) and the plain version's
   time.
3. ``slice``: Llama-3-8B at full width and depth with an int4 base
   (random weights from a seed) served through ``CompletionService`` and
   its HTTP surface: single-prompt, 4 ragged prompts and a sampled
   request. Checks status, token ids, lengths, and that the int4 kernel
   ran exactly 225 times per forward (32 layers x 7 weights + lm_head).
4. ``parity_on_card``: a 2-layer model at the 8B width gives the same
   logits and cache, bit for bit, with the kernel as with the plain
   dequant in its place; and the 32-layer model's served greedy tokens
   equal those of the plain dequant.

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


def profile_phase(torch, cfg, params, batch: int) -> dict:
    """Where one 8B decode step's time goes: its wall time (CUDA events,
    no profiler), then ``torch.profiler`` over the same steps for the
    device's busy share and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from odh_kubeflow_tpu_torch.models.generate import init_cache
    from odh_kubeflow_tpu_torch.models.llama import forward_with_cache

    S, steps = 64, 8
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (batch, S + 2 * steps + 1),
                         generator=gen, device="cuda")
    cache = init_cache(cfg, batch, S + 2 * steps + 1, device="cuda")
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
    kernels = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            us = e.device_time_total  # a kernel's own duration, microseconds
            name = e.name if len(e.name) <= 60 else e.name[:57] + "..."
            total, count = kernels.get(name, (0.0, 0))
            kernels[name] = (total + us, count + 1)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU", file=sys.stderr)
        return 2
    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.quant import streaming_quantized_init
    from odh_kubeflow_tpu_torch.ops import _build, int4

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = card_label()
    name = torch.cuda.get_device_name(0)
    bw = spec_bandwidth(name)
    t0 = time.perf_counter()
    _build.build(["int4_dequant"])
    build_s = time.perf_counter() - t0
    ptxas = [
        line.strip()
        for line in _build.build_logs.get("int4_dequant", "").splitlines()
        if "registers" in line or "spill" in line
    ]
    emit({"phase": "device", "card": label, "device_name": name,
          "spec_bandwidth_bytes_s": bw, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s, "ptxas": ptxas})

    kernel = kernels_phase(torch, int4, bw)
    emit({"phase": "kernels", "int4_dequant_bit_exact": True,
          "shapes_checked": len(kernel["shapes"])})

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = streaming_quantized_init(cfg, 0, bits=4, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 2**30
    record, served = slice_phase(torch, int4, cfg, params)
    record.update(init_s=init_s, resident_params_gb=resident_gb, card=label)
    emit(record)
    kernel["launches"] = record["launches"]

    emit(parity_phase(torch, int4, cfg, params, served))
    emit({"phase": "profile", "card": label,
          "steps": [profile_phase(torch, cfg, params, b) for b in (1, 4)]})

    emit({"kernels": [kernel]})
    print(label, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
