#!/usr/bin/env python3
"""Where the time of the two Hopper-redesigned kernels goes, on one NVIDIA
GPU: the flash-attention forward (``csrc/flash_fwd.cu``) and the fused
SwiGLU backward (``csrc/swiglu_gmm.cu``).

    python3 tools/hopper_redesign_ablation.py [--parent DIR]

Builds edited copies of each source side by side under
``build/hopper_ablation/`` and times each by CUDA events at the main
paths' shapes: flash at the Llama-3-8B (hd 128) and Mixtral-8x1B (hd 64)
training shapes (B 2, S 4096, 32/8 heads, causal), the SwiGLU backward at
the Mixtral-8x1B one (M 17,408, K 2048, N 8192, E 8, balanced routing).

- ``as_built``: the kernel as committed (its tile error against the plain
  version is printed);
- flash ``no_pingpong``: the two consumer warpgroups issue their products
  without taking turns; ``no_softmax``: the online softmax skipped (P is
  the raw scores); ``no_pv``: the P.V product skipped;
- SwiGLU ``no_widen``: the int8-to-bf16 pass skipped (the tensor cores
  read stale shared memory); ``no_epilogue``: the dsilu arithmetic
  skipped (g and dh are loaded and stored back unchanged); ``no_wgmma``:
  the product skipped;
- ``mma_sync``: with ``--parent DIR``, the same kernel from a checkout of
  the commit before the redesign (its ``mma.sync`` + ``cp.async`` design),
  timed in turns with ``as_built`` on the same card.

Only ``as_built`` and ``mma_sync`` compute the function; the others are
timings of broken copies, never loaded by the port. Prints the ptxas
report of every copy, one JSON line per shape, then the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FLASH_EDITS = {
    "no_pingpong": (
        ("auto my_turn = [&] { sm90::named_sync(2 + cw, 256); };", "auto my_turn = [&] {};"),
        ("if (cw == 0 || j + 1 < n_tiles) sm90::named_arrive(3 - cw, 256);", "(void)j;"),
        ("if (cw == 1) sm90::named_arrive(2, 256);", ""),
    ),
    "no_softmax": (("softmax(sc, m, l, alpha, p.scale_log2);", "alpha[0] = alpha[1] = 1.f;"),),
    "no_pv": (("issue_pv<HD>(o, pa, sV(sp));", "sm90::wgmma_commit();"),
              ("issue_pv<HD>(o, pa, sV(sl));", "sm90::wgmma_commit();")),
}
SWIGLU_EDITS = {
    "no_widen": (("for (int i = first; i < end; i += step) {",
                  "for (int i = first; i < 0; i += step) {"),),
    "no_epilogue": (("for (int j = 0; j < kBN / 8; ++j) {", "for (int j = 0; j < 0; ++j) {"),),
    "no_wgmma": (("for (int k16 = 0; k16 < kBK / 16; ++k16) {", "for (int k16 = 0; k16 < 0; ++k16) {"),),
}
SOURCES = {"flash_fwd": FLASH_EDITS, "swiglu_gmm": SWIGLU_EDITS}


def variants(src: str, edits: dict) -> dict[str, str]:
    out = {"as_built": src}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(torch_build, parent: Path | None):
    """{source: {variant: ctypes library}} and the ptxas lines of each."""
    csrc = ROOT / "odh_kubeflow_tpu_torch" / "csrc"
    out = ROOT / "build" / "hopper_ablation"
    procs = {}
    for source, edits in SOURCES.items():
        found = variants((csrc / f"{source}.cu").read_text(), edits)
        dirs = {name: csrc for name in found}
        if parent is not None:
            pcsrc = parent / "odh_kubeflow_tpu_torch" / "csrc"
            found["mma_sync"] = (pcsrc / f"{source}.cu").read_text()
            dirs["mma_sync"] = pcsrc
        for name, src in found.items():
            d = out / source / name
            d.mkdir(parents=True, exist_ok=True)
            for header in dirs[name].glob("*.cuh"):
                shutil.copy(header, d)
            (d / f"{source}.cu").write_text(src)
            procs[(source, name)] = subprocess.Popen(
                [torch_build._nvcc(), *torch_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for (source, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{source} {name}: nvcc exit {proc.returncode}\n{log}")
        ptxas[f"{source} {name}"] = [
            line.strip() for line in log.splitlines()
            if any(w in line for w in ("entry function", "registers", "spill", "C7"))]
        lib = ctypes.CDLL(str(out / source / name / "lib.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        if source == "flash_fwd":
            lib.flash_fwd_launch.argtypes = (
                [P] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + [I] * 8 + [ctypes.c_float, P])
            lib.flash_fwd_launch.restype = I
        else:
            lib.swiglu_bwd_launch.argtypes = [P] * 8 + [I] * 4 + [P]
            lib.swiglu_bwd_launch.restype = I
        libs.setdefault(source, {})[name] = lib
    return libs, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the commit before the redesign, for the mma_sync rows")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("hopper_redesign_ablation: no CUDA device", file=sys.stderr)
        return 2
    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.ops import flash_attention as fa
    from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm

    libs, ptxas = build(_build, args.parent)
    print(json.dumps({"ptxas": ptxas}), flush=True)

    def time_ms(fn, iters=10, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        return statistics.median(times)

    def in_turns(row, fns):
        """as_built and mma_sync in turns (mma_sync, as_built, as_built,
        mma_sync), the edited copies once each"""
        order = list(fns)
        if "mma_sync" in fns:
            order = ["mma_sync", "as_built"] + [n for n in fns if n not in ("mma_sync", "as_built")]
            order += ["as_built", "mma_sync"]
        for name in order:
            row.setdefault(name, []).append(time_ms(fns[name]))

    gen = torch.Generator(device="cuda").manual_seed(71)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, hd in (("8b_train", 128), ("8x1b_train", 64)):
        B, S, Hq, Hkv = 2, 4096, 32, 8
        q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty_like(q)
        lse = torch.empty((B, Hq, S), device="cuda")
        strides = fa._strides(q, k, v, out)
        fns = {name: (lambda lib=lib: lib.flash_fwd_launch(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, out.data_ptr(),
                   lse.data_ptr(), strides, B, S, S, Hq, Hkv, hd, 1, 0, hd**-0.5 * fa.LOG2E,
                   stream))
               for name, lib in libs["flash_fwd"].items()}
        row = {"kernel": "flash_fwd", "shape": shape, "flops": 4 * hd * Hq * B * S * (S + 1) // 2}
        in_turns(row, fns)
        err = {}
        for name in ("as_built", "mma_sync"):
            if name in fns:
                if fns[name]() != 0:
                    raise RuntimeError(f"flash_fwd {name} launch failed")
                torch.cuda.synchronize()
                err[name] = fa.tile_rel_err(out, fa.flash_fwd_reference(q, k, v)[0])
        row["tile_rel_err"] = err
        print(json.dumps(row), flush=True)
        del q, k, v, out, lse
        torch.cuda.empty_cache()

    M, K, N, E = 17_408, 2048, 8192, 8
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wu = torch.randint(-127, 128, (E, K, N), generator=gen, device="cuda", dtype=torch.int8)
    su = torch.rand((E, 1, N), generator=gen, device="cuda") * 2e-3 + 1e-4
    g = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
    dh = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
    offs = torch.tensor([i * (M // E) for i in range(E)] + [M], dtype=torch.int32, device="cuda")
    dg, du = torch.empty_like(g), torch.empty_like(g)
    fns = {name: (lambda lib=lib: lib.swiglu_bwd_launch(
               x.data_ptr(), wu.data_ptr(), su.data_ptr(), offs.data_ptr(), g.data_ptr(),
               dh.data_ptr(), dg.data_ptr(), du.data_ptr(), M, K, N, E, stream))
           for name, lib in libs["swiglu_gmm"].items()}
    row = {"kernel": "swiglu_bwd", "shape": f"M {M}, K {K}, N {N}, E {E}, balanced",
           "flops": 2 * M * K * N}
    in_turns(row, fns)
    err = {}
    want = gm.swiglu_bwd_reference(x, wu, su, g, dh, offs)[0]
    for name in ("as_built", "mma_sync"):
        if name in fns:
            if fns[name]() != 0:
                raise RuntimeError(f"swiglu_bwd {name} launch failed")
            torch.cuda.synchronize()
            err[name] = gm.tile_rel_err(dg, want)
    row["tile_rel_err"] = err
    print(json.dumps(row), flush=True)
    print(card_label(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
