#!/usr/bin/env python3
"""Where the int4 matmul's input gradient (dX, ``int4_dlhs_launch``) spends
its time, on one NVIDIA GPU. It is the first design's kernel
(``int4_mm_kernel``, ``mma.sync``); the forward runs on the persistent
product and is ablated by ``tools/hopper_redesign_ablation.py --only int4_mm``.

    python3 tools/int4_matmul_ablation.py      # from the root of a checkout

Builds edited copies of ``odh_kubeflow_tpu_torch/csrc/int4_matmul.cu``
side by side under ``build/int4_ablation/`` and times each dX by CUDA
events at Llama-3-8B's wq/wo and gate/up shapes (M 8,192) and at decode
(M 1):

- ``as_built``: the kernel as committed;
- ``no_launch_bound``: without ``__launch_bounds__(256, 2)`` (ptxas then
  chooses the register count, printed);
- ``no_unpack``: the unpack pass skipped (the tensor cores read stale
  shared memory), ``no_mma``: the product skipped, ``neither``: both, so
  only the loads and the loop remain.

Only ``as_built`` computes the function (its tile error against the plain
version is printed); the others are timings of broken copies, never
loaded by the port. Prints one JSON line per shape, then the card.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LAUNCH_BOUND = "__launch_bounds__(kThreads, 2) int4_mm_kernel"
UNPACK = "      unpack_staged<kDlhs>(sW, stage(kc % kStages), k0, k0 >= K2, g.group);"
MMA = "      mma_chunk<kDlhs>(acc, reinterpret_cast<const bf16*>(stage(kc % kStages)), sW);"
SHAPES = ((8192, 4096, 4096), (8192, 4096, 14336), (1, 4096, 4096), (1, 14336, 4096))


def variants(src: str) -> dict[str, str]:
    for needle in (LAUNCH_BOUND, UNPACK, MMA):
        if needle not in src:
            raise RuntimeError(f"the kernel source no longer holds {needle!r}")
    return {
        "as_built": src,
        "no_launch_bound": src.replace(LAUNCH_BOUND, "__launch_bounds__(kThreads) int4_mm_kernel"),
        "no_unpack": src.replace(UNPACK, ""),
        "no_mma": src.replace(MMA, ""),
        "neither": src.replace(UNPACK, "").replace(MMA, ""),
    }


def build(torch_build) -> tuple[dict[str, ctypes.CDLL], dict[str, list[str]]]:
    csrc = ROOT / "odh_kubeflow_tpu_torch" / "csrc"
    out = ROOT / "build" / "int4_ablation"
    procs = {}
    for name, src in variants((csrc / "int4_matmul.cu").read_text()).items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "int4_matmul.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [torch_build._nvcc(), *torch_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "int4_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        regs[name] = [line.strip() for line in log.splitlines()
                      if "entry function" in line or "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.int4_dlhs_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        lib.int4_dlhs_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int4_matmul_ablation: no CUDA device", file=sys.stderr)
        return 2
    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.ops import _build, int4

    libs, regs = build(_build)
    print(json.dumps({"ptxas": regs}), flush=True)

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

    gen = torch.Generator(device="cuda").manual_seed(93)
    stream = torch.cuda.current_stream().cuda_stream
    for M, K, N in SHAPES:
        d = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
        q4 = torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
        s = torch.rand((K // 128, N), generator=gen, device="cuda") * 0.02 + 1e-4
        dx = torch.empty((M, K), dtype=torch.bfloat16, device="cuda")
        row = {"M": M, "K": K, "N": N}
        for name, lib in libs.items():
            dl = (lambda lib=lib: lib.int4_dlhs_launch(d.data_ptr(), q4.data_ptr(), s.data_ptr(),
                                                       dx.data_ptr(), M, K, N, 128, stream))
            row[name] = {"dlhs_ms": time_ms(dl)}
            if name == "as_built":
                if dl() != 0:
                    raise RuntimeError("int4 dlhs launch failed")
                torch.cuda.synchronize()
                row[name]["tile_rel_err"] = int4.tile_rel_err(
                    dx, int4.int4_dlhs_reference(d, q4, s))
        print(json.dumps(row), flush=True)
    print(card_label(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
