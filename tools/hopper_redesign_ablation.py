#!/usr/bin/env python3
"""Where the time of the Hopper-redesigned kernels goes, on one NVIDIA GPU:
the flash-attention forward (``csrc/flash_fwd.cu``), its dQ and dK/dV
kernels (``csrc/flash_bwd.cu``), the fused SwiGLU
forward and backward (``csrc/swiglu_gmm.cu``), the grouped matmul in
its four instances (``csrc/gmm.cu``), the expert weight gradient
(``csrc/tgmm.cu``) and the int4 fused-dequant forward and input gradient
(``csrc/int4_matmul.cu`` ``int4_mm_launch``, ``int4_dlhs_launch``); the
grouped ones, the int4 kernels' schedule and the SwiGLU forward share
``csrc/grouped_sm90.cuh``.

    python3 tools/hopper_redesign_ablation.py [--parent DIR] [--only NAME ...]

Builds edited copies of each source side by side under
``build/hopper_ablation/`` and times each by CUDA events at the main
paths' shapes: flash at the Llama-3-8B (hd 128) and Mixtral-8x1B (hd 64)
training shapes (B 2, S 4096, 32/8 heads, causal), the backward also on
the 8B shape packed with documents of 512 tokens; the SwiGLU kernels at
the Mixtral-8x1B one (M 17,408, K 2048, N 8192, E 8, balanced routing);
``gmm`` at the Mixtral-8x1B QLoRA step's int8 shapes, the full
fine-tune's bf16 ones (M 17,408) and the serving prefill's (M 3,072);
``tgmm`` at the full fine-tune's two weight gradients ([8, 2048, 8192] and
[8, 8192, 2048] from M 17,408 rows), balanced and with every row on one
expert; ``int4_mm`` and ``int4_dlhs`` at Llama-3-8B's four int4
projection shapes (group 128) at M 8,192 and at decode (M 4 and 1, the
weights read cold from rotating copies, as ``chip_smoke.py`` times them).

- ``as_built``: the kernel as committed (its tile error against the plain
  version is printed);
- flash ``no_pingpong``: the two consumer warpgroups issue their products
  without taking turns; ``no_softmax``: the online softmax skipped (P is
  the raw scores); ``no_pv``: the P.V product skipped;
- flash backward ``no_exp``: the mask and exp2 pass skipped (P is the raw
  scores); ``no_dscores``: dS = P (dP - delta) skipped (dS is dP);
  ``no_dq_product``: dQ's dS.K skipped; ``no_dk_product``: dK/dV's dS^T.Q
  skipped; ``no_pingpong`` (dQ): the warpgroups issue without taking
  turns;
- grouped kernels ``no_widen``: the int8-to-bf16 pass skipped (the tensor
  cores read stale shared memory); ``no_epilogue``: the epilogue's
  arithmetic and stores skipped (the SwiGLU backward still loads g and dh
  and stores them back unchanged); ``no_wgmma``: the product skipped;
- persistent grid (``gmm``, SwiGLU forward, ``tgmm``, ``int4_mm``,
  ``int4_dlhs``): ``n_raster`` walks the column blocks of one row tile
  before the next row tile (groups of one row tile), ``m_raster`` every row
  tile of a column block before the next; ``bn128`` and ``bn256`` (``gmm``,
  ``tgmm``) force the output tile width, ``t16`` and ``t128`` (int4) the
  tokens of a tile; ``no_widen`` (int4) skips the nibble unpack into
  registers, ``no_wgmma`` the product, ``ldg_scales`` reads the group scales
  by ``__ldg`` instead of staging them with the chunk, ``no_epilogue``
  (``int4_dlhs``) skips the transpose through shared memory (behind a
  test of the accumulators that never holds, so the products stay) and
  the TMA stores, ``one_scale_path`` (``int4_dlhs``) compiles the staged
  and the ``__ldg`` scales into one kernel, chosen at run time (an edit of one int4 kernel's code may touch the other's too: each
  copy times one kernel);
- ``parent``: with ``--parent DIR``, the same kernel from another checkout
  (e.g. the commit before a redesign), timed in turns with ``as_built``
  on the same card (parent, as_built, ..., as_built, parent).

Only ``as_built``, the width, tile, order and scale-path copies, and
``parent`` compute the function (their tile error is printed); the others
are timings of broken copies, never loaded by the port. Prints the ptxas report of every copy, one JSON line per shape,
then the card.
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

HEADER = "grouped_sm90.cuh"
NO_WIDEN = (HEADER, "for (int i = first; i < end; i += step)",
            "for (int i = first; i < 0; i += step)")
NO_WGMMA = (HEADER, "for (int k16 = 0; k16 < kBK / 16; ++k16) {",
            "for (int k16 = 0; k16 < 0; ++k16) {")
N_RASTER = (HEADER, "constexpr int kGroupM = 8;", "constexpr int kGroupM = 1;")
M_RASTER = (HEADER, "constexpr int kGroupM = 8;", "constexpr int kGroupM = 1 << 20;")
WIDTH = "return tiles256 < 3LL * sms ? 128 : 256;"
ROWS = "int tile_rows(int M) {"
WIDEN_FRAG = "widen_frag(a[j], st + R::kX + cw * R::kQ, j, q, col, sh, sc);"
WIDEN_DLHS = "widen_dlhs(a[j], st + D::kD, j, q, row, sc);"
ISSUE_RS = ("issue_rs<BT>(acc0, acc1, a[j], sm90::desc128(st + j * 32, 16, 1024), kc > 0 || "
            "j > 0);")


# {source: {variant: ((file, old, new), ...)}}; every occurrence of old in
# its file is replaced, and there must be one
SOURCES = {
    "flash_fwd": {
        "no_pingpong": (
            ("flash_fwd.cu", "auto my_turn = [&] { sm90::named_sync(2 + cw, 256); };",
             "auto my_turn = [&] {};"),
            ("flash_fwd.cu", "if (cw == 0 || j + 1 < n_tiles) sm90::named_arrive(3 - cw, 256);",
             "(void)j;"),
            ("flash_fwd.cu", "if (cw == 1) sm90::named_arrive(2, 256);", ""),
        ),
        "no_softmax": (("flash_fwd.cu", "softmax(sc, m, l, alpha, p.scale_log2);",
                        "alpha[0] = alpha[1] = 1.f;"),),
        "no_pv": (("flash_fwd.cu", "issue_pv<HD>(o, pa, sV(sp));", "sm90::wgmma_commit();"),
                  ("flash_fwd.cu", "issue_pv<HD>(o, pa, sV(sl));", "sm90::wgmma_commit();")),
    },
    "flash_bwd": {
        "no_exp": (
            ("flash_bwd.cu", "if (masked(k0, seg)) dq_mask(st, k0, row, qseg, ks, quad, p, seg);", ""),
            ("flash_bwd.cu", "dq_probs(st, lse, p.scale_log2);", ""),
            ("flash_bwd.cu", "if (masked) dkv_mask(st, q0, krow, kseg, s_qseg[s], quad, p, seg);", ""),
            ("flash_bwd.cu", "dkv_probs(st, s_lse[s], quad, p.scale_log2);", ""),
        ),
        "no_dscores": (("flash_bwd.cu", "dq_dscores(dp, st, delta);", ""),
                       ("flash_bwd.cu", "dkv_dscores(dp, st, s_delta[s], quad);", "")),
        "no_dq_product": (("flash_bwd.cu", "issue_nn<HD>(dq, dsa, sK(sp));", ""),),
        "no_dk_product": (("flash_bwd.cu", "issue_nn<HD>(dk, dsa, sQ(s));", ""),),
        "no_pingpong": (
            ("flash_bwd.cu", "auto my_turn = [&] { sm90::named_sync(3 + cw, 256); };",
             "auto my_turn = [&] {};"),
            ("flash_bwd.cu", "if (cw == 0 || j + 1 < n_tiles) sm90::named_arrive(4 - cw, 256);",
             "(void)j;"),
            ("flash_bwd.cu", "if (cw == 1) sm90::named_arrive(3, 256);", ""),
        ),
    },
    "swiglu_gmm": {
        "no_widen": (NO_WIDEN,),
        "fwd_no_epilogue": (("swiglu_gmm.cu", "for (int j0 = 0; j0 < kPairs; j0 += 4) {",
                             "for (int j0 = 0; j0 < 0; j0 += 4) {"),),
        "fwd_no_wgmma": (NO_WGMMA,),
        "fwd_n_raster": (N_RASTER,),
        "fwd_m_raster": (M_RASTER,),
        "bwd_no_epilogue": (("swiglu_gmm.cu", "for (int j = 0; j < kBN / 8; ++j) {",
                             "for (int j = 0; j < 0; ++j) {"),),
        "bwd_no_wgmma": (("swiglu_gmm.cu", "for (int k16 = 0; k16 < kBK / 16; ++k16) {",
                          "for (int k16 = 0; k16 < 0; ++k16) {"),),
    },
    "gmm": {
        "no_widen": (NO_WIDEN,),
        "no_epilogue": (("gmm.cu", "for (int j0 = 0; j0 < BN / 8; j0 += 4) {",
                         "for (int j0 = 0; j0 < 0; j0 += 4) {"),),
        "no_wgmma": (NO_WGMMA,),
        "n_raster": (N_RASTER,),
        "m_raster": (M_RASTER,),
        "bn128": ((HEADER, WIDTH, "return 128;"),),
        "bn256": ((HEADER, WIDTH, "return 256;"),),
    },
    "tgmm": {
        "no_epilogue": (("tgmm.cu", "for (int j0 = 0; j0 < BN / 8; j0 += 4) {",
                         "for (int j0 = 0; j0 < 0; j0 += 4) {"),),
        "no_wgmma": (NO_WGMMA,),
        "n_raster": (N_RASTER,),
        "m_raster": (M_RASTER,),
        "bn128": ((HEADER, WIDTH, "return 128;"),),
        "bn256": ((HEADER, WIDTH, "return 256;"),),
    },
    "int4_matmul": {
        "no_widen": (("int4_matmul.cu", WIDEN_FRAG, ""),
                     ("int4_matmul.cu", WIDEN_DLHS, "(void)sc;")),
        "no_wgmma": (("int4_matmul.cu", ISSUE_RS, ""),),
        "n_raster": (N_RASTER,),
        "m_raster": (M_RASTER,),
        "t16": (("int4_matmul.cu", ROWS + " return M <= 16 ? 16 : 128; }", ROWS + " return 16; }"),),
        "t128": (("int4_matmul.cu", ROWS + " return M <= 16 ? 16 : 128; }",
                  ROWS + " return 128; }"),),
        "ldg_scales": (("int4_matmul.cu", "const bool staged = p.gshift >= 6;",
                        "const bool staged = false;"),
                       ("int4_matmul.cu", "const bool scales_staged = g.group >= 64;",
                        "const bool scales_staged = false;")),
        # the accumulators stay live (else the products are dead code)
        "no_epilogue": (("int4_matmul.cu", "for (int jj = 0; jj < BT / 8; jj += 2) {",
                         "for (int jj = 0; jj < BT / 8 && acc0[0] == 1.5f && acc1[0] == 1.5f; "
                         "jj += 2) {"),
                        ("int4_matmul.cu", "sm90::tma_store_2d(tdx, panel0, p0 + 64 * cw, m0);", ""),
                        ("int4_matmul.cu", "sm90::tma_store_2d(tdx, panel1, half + p0 + 64 * cw, m0);",
                         "")),
        # the first build: staged and __ldg scales chosen at run time in one kernel
        "one_scale_path": (("int4_matmul.cu", "if constexpr (kStaged) {", "if (p.gshift >= 6) {"),
                           ("int4_matmul.cu", "if (kStaged) sm90::prefetch_map(ts);",
                            "if (p.gshift >= 6) sm90::prefetch_map(ts);"),
                           ("int4_matmul.cu", "(kStaged ? D::kS : 0)", "(p.gshift >= 6 ? D::kS : 0)"),
                           ("int4_matmul.cu", "if (kStaged) {", "if (p.gshift >= 6) {")),
    },
}
# the copies each timed kernel takes (a source's other copies edit another
# kernel of it)
KERNELS = {
    "flash_fwd": ("flash_fwd", ("no_pingpong", "no_softmax", "no_pv")),
    "flash_dq": ("flash_bwd", ("no_exp", "no_dscores", "no_dq_product", "no_pingpong")),
    "flash_dkv": ("flash_bwd", ("no_exp", "no_dscores", "no_dk_product")),
    "swiglu_fwd": ("swiglu_gmm", ("no_widen", "fwd_no_epilogue", "fwd_no_wgmma", "fwd_n_raster",
                                  "fwd_m_raster")),
    "swiglu_bwd": ("swiglu_gmm", ("no_widen", "bwd_no_epilogue", "bwd_no_wgmma")),
    "gmm": ("gmm", ("no_widen", "no_epilogue", "no_wgmma", "n_raster", "m_raster", "bn128",
                    "bn256")),
    "tgmm": ("tgmm", ("no_epilogue", "no_wgmma", "n_raster", "m_raster", "bn128", "bn256")),
    "int4_mm": ("int4_matmul", ("no_widen", "no_wgmma", "n_raster", "m_raster", "t16", "t128",
                                "ldg_scales")),
    "int4_dlhs": ("int4_matmul", ("no_widen", "no_wgmma", "no_epilogue", "n_raster", "m_raster",
                                  "t16", "t128", "ldg_scales", "one_scale_path")),
}


def copies(csrc: Path, source: str) -> dict[str, dict[str, str]]:
    """{variant: {file name: text}} of one source and the headers."""
    files = {h.name: h.read_text() for h in csrc.glob("*.cuh")}
    files[f"{source}.cu"] = (csrc / f"{source}.cu").read_text()
    out = {"as_built": files}
    for name, edits in SOURCES[source].items():
        edited = dict(files)
        for fname, old, new in edits:
            if old not in edited[fname]:
                raise RuntimeError(f"{source} {name}: {fname} no longer holds {old!r}")
            edited[fname] = edited[fname].replace(old, new)
        out[name] = edited
    return out


def build(torch_build, sources, parent: Path | None):
    """{source: {variant: ctypes library}} and the ptxas lines of each."""
    csrc = ROOT / "odh_kubeflow_tpu_torch" / "csrc"
    out = ROOT / "build" / "hopper_ablation"
    procs = {}
    for source in sources:
        found = copies(csrc, source)
        if parent is not None:
            pcsrc = parent / "odh_kubeflow_tpu_torch" / "csrc"
            found["parent"] = {**{h.name: h.read_text() for h in pcsrc.glob("*.cuh")},
                               f"{source}.cu": (pcsrc / f"{source}.cu").read_text()}
        for name, files in found.items():
            d = out / source / name
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            for fname, text in files.items():
                (d / fname).write_text(text)
            procs[(source, name)] = subprocess.Popen(
                [torch_build._nvcc(), *torch_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for (source, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{source} {name}: nvcc exit {proc.returncode}\n{log}")
        ptxas[f"{source} {name}"] = [
            line.strip() for line in log.splitlines()
            if any(w in line for w in ("entry function", "registers", "spill", "C7"))]
        lib = ctypes.CDLL(str(out / source / name / "lib.so"))
        if source == "flash_fwd":
            lib.flash_fwd_launch.argtypes = (
                [P] * 7 + [ctypes.POINTER(ctypes.c_longlong)] + [I] * 8 + [ctypes.c_float, P])
            lib.flash_fwd_launch.restype = I
        elif source == "flash_bwd":
            S = ctypes.POINTER(ctypes.c_longlong)
            lib.flash_dq_launch.argtypes = [P] * 9 + [S] + [I] * 8 + [ctypes.c_float] * 2 + [P]
            lib.flash_dq_launch.restype = I
            lib.flash_dkv_launch.argtypes = [P] * 10 + [S] + [I] * 8 + [ctypes.c_float] * 2 + [P]
            lib.flash_dkv_launch.restype = I
        elif source == "swiglu_gmm":
            lib.swiglu_fwd_launch.argtypes = [P] * 8 + [I] * 4 + [P]
            lib.swiglu_fwd_launch.restype = I
            lib.swiglu_bwd_launch.argtypes = [P] * 8 + [I] * 4 + [P]
            lib.swiglu_bwd_launch.restype = I
        elif source == "tgmm":
            lib.tgmm_launch.argtypes = [P] * 4 + [I] * 4 + [P]
            lib.tgmm_launch.restype = I
        elif source == "int4_matmul":
            L = ctypes.c_longlong
            for fn in (lib.int4_mm_launch, lib.int4_dlhs_launch):
                fn.argtypes = [P] * 4 + [L] * 4 + [P]
                fn.restype = I
        else:
            lib.gmm_launch.argtypes = [P] * 6 + [I] * 5 + [P]
            lib.gmm_launch.restype = I
            lib.gmm_bf16_launch.argtypes = [P] * 4 + [I] * 5 + [P]
            lib.gmm_bf16_launch.restype = I
        libs.setdefault(source, {})[name] = lib
    return libs, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout (e.g. the commit before the redesign), timed in turns")
    ap.add_argument("--only", nargs="*", choices=list(KERNELS), default=list(KERNELS),
                    help="the kernels to time (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("hopper_redesign_ablation: no CUDA device", file=sys.stderr)
        return 2
    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.ops import flash_attention as fa
    from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm

    sources = sorted({KERNELS[k][0] for k in args.only})
    libs, ptxas = build(_build, sources, args.parent)
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

    def run(kernel, row, make_fn, check):
        """Time each copy of one kernel, as_built and parent in turns;
        check(name) gives a computing copy's tile error after its launch."""
        source, variants = KERNELS[kernel]
        fns = {name: make_fn(lib) for name, lib in libs[source].items()
               if name in ("as_built", "parent", *variants)}
        order = ["as_built", *variants, "as_built"]
        if "parent" in fns:
            order = ["parent", *order, "parent"]
        for name in order:
            row.setdefault(name, []).append(time_ms(fns[name]))
        err = {}
        for name in ("as_built", "parent", "no_pingpong", "n_raster", "m_raster",
                     "fwd_n_raster", "fwd_m_raster", "bn128", "bn256", "t16", "t128",
                     "ldg_scales", "one_scale_path"):
            if name in fns:
                if fns[name]() != 0:
                    raise RuntimeError(f"{kernel} {name}: launch failed")
                torch.cuda.synchronize()
                err[name] = check()
        row["tile_rel_err"] = err
        print(json.dumps(row), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(71)
    stream = torch.cuda.current_stream().cuda_stream
    if "flash_fwd" in args.only:
        for shape, hd in (("8b_train", 128), ("8x1b_train", 64)):
            B, S, Hq, Hkv = 2, 4096, 32, 8
            q = torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.empty_like(q)
            lse = torch.empty((B, Hq, S), device="cuda")
            strides = fa._strides(q, k, v, out)
            want = fa.flash_fwd_reference(q, k, v)[0]
            run("flash_fwd",
                {"kernel": "flash_fwd", "shape": shape, "flops": 4 * hd * Hq * B * S * (S + 1) // 2},
                lambda lib: lambda: lib.flash_fwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, out.data_ptr(),
                    lse.data_ptr(), strides, B, S, S, Hq, Hkv, hd, 1, 0, hd**-0.5 * fa.LOG2E,
                    stream),
                lambda: fa.tile_rel_err(out, want))
            del q, k, v, out, lse, want
            torch.cuda.empty_cache()

    if {"flash_dq", "flash_dkv"} & set(args.only):
        # the two training shapes, and the 8B one on packed documents of
        # 512 tokens (segment ids: the mask and the tiles of two documents)
        for shape, hd, doc in (("8b_train", 128, 0), ("8x1b_train", 64, 0),
                               ("8b_packed_512", 128, 512)):
            B, S, Hq, Hkv = 2, 4096, 32, 8
            q, do = (torch.randn((B, S, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(2))
            k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            seg = None
            pairs = Hq * B * S * (S + 1) // 2
            if doc:
                seg = (torch.arange(S, device="cuda") // doc).to(torch.int32).expand(B, S)
                seg = seg.contiguous()
                pairs = Hq * B * (S // doc) * doc * (doc + 1) // 2
            out, lse = fa.flash_fwd(q, k, v, seg, seg)
            delta = fa.flash_delta(out, do)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            ops = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), None if seg is None else seg.data_ptr(),
                   None if seg is None else seg.data_ptr())
            tail = (B, S, S, Hq, Hkv, hd, 1, 0, hd**-0.5 * fa.LOG2E, hd**-0.5, stream)
            if "flash_dq" in args.only:
                strides = fa._strides(q, k, v, do, dq)
                want = fa.flash_dq_reference(q, k, v, lse, delta, do, seg, seg)
                run("flash_dq", {"kernel": "flash_dq", "shape": shape, "flops": 6 * hd * pairs},
                    lambda lib, strides=strides: lambda: lib.flash_dq_launch(
                        *ops, dq.data_ptr(), strides, *tail),
                    lambda want=want: fa.tile_rel_err(dq, want))
                del want
            if "flash_dkv" in args.only:
                strides = fa._strides(q, k, v, do, dk, dv)
                want_k, want_v = fa.flash_dkv_reference(q, k, v, lse, delta, do, seg, seg)
                run("flash_dkv", {"kernel": "flash_dkv", "shape": shape, "flops": 8 * hd * pairs},
                    lambda lib, strides=strides: lambda: lib.flash_dkv_launch(
                        *ops, dk.data_ptr(), dv.data_ptr(), strides, *tail),
                    lambda: max(fa.tile_rel_err(dk, want_k), fa.tile_rel_err(dv, want_v)))
                del want_k, want_v
            del q, k, v, do, out, lse, delta, dq, dk, dv, seg
            torch.cuda.empty_cache()

    E, D, F = 8, 2048, 8192

    def balanced(M):
        return torch.tensor([i * (M // E) // 128 * 128 for i in range(E)] + [M],
                            dtype=torch.int32, device="cuda")

    def int8_bank(*shape):
        q = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        return q, torch.rand((shape[0], 1, shape[-1]), generator=gen, device="cuda") * 2e-3 + 1e-4

    M = 17_408
    offs = balanced(M)
    x = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
    if {"swiglu_fwd", "swiglu_bwd"} & set(args.only):
        (wg, sg), (wu, su) = int8_bank(E, D, F), int8_bank(E, D, F)
        g = torch.randn((M, F), generator=gen, device="cuda").to(torch.bfloat16)
        dh = torch.randn((M, F), generator=gen, device="cuda").to(torch.bfloat16)
        a, b = torch.empty_like(g), torch.empty_like(g)
        label = f"M {M}, K {D}, N {F}, E {E}, balanced"
        if "swiglu_fwd" in args.only:
            want = gm.swiglu_fwd_reference(x, wg, wu, sg, su, offs)[0]
            run("swiglu_fwd", {"kernel": "swiglu_fwd", "shape": label, "flops": 4 * M * D * F},
                lambda lib: lambda: lib.swiglu_fwd_launch(
                    x.data_ptr(), wg.data_ptr(), wu.data_ptr(), sg.data_ptr(), su.data_ptr(),
                    offs.data_ptr(), a.data_ptr(), b.data_ptr(), M, D, F, E, stream),
                lambda: gm.tile_rel_err(a, want))
        if "swiglu_bwd" in args.only:
            want = gm.swiglu_bwd_reference(x, wu, su, g, dh, offs)[0]
            run("swiglu_bwd", {"kernel": "swiglu_bwd", "shape": label, "flops": 2 * M * D * F},
                lambda lib: lambda: lib.swiglu_bwd_launch(
                    x.data_ptr(), wu.data_ptr(), su.data_ptr(), offs.data_ptr(), g.data_ptr(),
                    dh.data_ptr(), a.data_ptr(), b.data_ptr(), M, D, F, E, stream),
                lambda: gm.tile_rel_err(a, want))
        del wg, sg, wu, su, g, dh, a, b, want
        torch.cuda.empty_cache()

    if "gmm" in args.only:
        # (bank, M, K, N, trans, what): the main paths' gmm launches
        shapes = (
            ("int8", M, F, D, False, "QLoRA down fwd"),
            ("int8", M, F, D, True, "QLoRA gate/up dlhs"),
            ("int8", M, D, F, True, "QLoRA down dlhs"),
            ("bf16", M, D, F, False, "full FT gate/up fwd"),
            ("bf16", M, D, F, True, "full FT down dlhs"),
            ("bf16", M, F, D, False, "full FT down fwd"),
            ("bf16", M, F, D, True, "full FT gate/up dlhs"),
            ("bf16", 3072, D, F, False, "prefill gate/up"),
            ("bf16", 3072, F, D, False, "prefill down"),
        )
        for bank, m, K, N, trans, what in shapes:
            lhs = torch.randn((m, K), generator=gen, device="cuda").to(torch.bfloat16)
            o = balanced(m)
            shape = (E, N, K) if trans else (E, K, N)
            if bank == "int8":
                w, s = int8_bank(*shape)
            else:
                w, s = (torch.randn(shape, generator=gen, device="cuda") * K**-0.5).to(
                    torch.bfloat16), None
            out = torch.empty((m, N), dtype=torch.bfloat16, device="cuda")
            scaled = torch.empty_like(lhs)
            want = gm.gmm_reference(lhs, w, o, trans, s)

            def make(lib, lhs=lhs, w=w, s=s, o=o, out=out, scaled=scaled, m=m, K=K, N=N,
                     trans=trans):
                if s is None:
                    return lambda: lib.gmm_bf16_launch(lhs.data_ptr(), w.data_ptr(), o.data_ptr(),
                                                       out.data_ptr(), m, K, N, E, int(trans),
                                                       stream)
                return lambda: lib.gmm_launch(lhs.data_ptr(), w.data_ptr(), s.data_ptr(),
                                              o.data_ptr(), out.data_ptr(), scaled.data_ptr(), m,
                                              K, N, E, int(trans), stream)

            run("gmm", {"kernel": f"gmm {bank}" + (" trans" if trans else ""), "shape": what,
                        "M": m, "K": K, "N": N, "flops": 2 * m * K * N,
                        "width": gm.gmm_tile_width(
                            m, N, torch.cuda.get_device_properties(0).multi_processor_count)},
                make, lambda out=out, want=want: gm.tile_rel_err(out, want))
            del lhs, w, s, out, scaled, want
            torch.cuda.empty_cache()

    if "tgmm" in args.only:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        one = torch.tensor([0] * 4 + [M] * 5, dtype=torch.int32, device="cuda")
        for K, N, what in ((D, F, "full FT gate/up dW"), (F, D, "full FT down dW")):
            lhs = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            dout = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
            out = torch.empty((E, K, N), dtype=torch.bfloat16, device="cuda")
            for routing, o in (("balanced", offs), ("one_expert", one)):
                want = gm.tgmm_reference(lhs, dout, o, E)
                run("tgmm", {"kernel": "tgmm", "shape": f"{what} [{E}, {K}, {N}]",
                             "routing": routing, "M": M, "K": K, "N": N,
                             "flops": 2 * M * K * N, "width": gm.tgmm_tile_width(K, N, E, sms)},
                    lambda lib, o=o, K=K, N=N: lambda: lib.tgmm_launch(
                        lhs.data_ptr(), dout.data_ptr(), o.data_ptr(), out.data_ptr(), M, K, N,
                        E, stream),
                    lambda want=want: gm.tile_rel_err(out.view(-1, out.shape[-1]),
                                                      want.view(-1, want.shape[-1])))
                del want
            del lhs, dout, out
            torch.cuda.empty_cache()

    int4_kernels = [k for k in ("int4_mm", "int4_dlhs") if k in args.only]
    if int4_kernels:
        from odh_kubeflow_tpu_torch.ops import int4

        group = 128
        for rows in (8192, 4, 1):
            for label, K, N in (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024),
                                ("gate/up", 4096, 14336), ("down", 14336, 4096)):
                wbytes = K * N // 2 + K // group * N * 4
                # at decode, enough weights that each launch reads its own cold
                copies = 1 if rows > 512 else min(32, max(1, -(-200_000_000 // wbytes)))
                q4 = [torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda",
                                    dtype=torch.int32).to(torch.uint8) for _ in range(copies)]
                sc = [torch.rand((K // group, N), generator=gen, device="cuda") * 0.02 + 1e-4
                      for _ in range(copies)]
                for kernel in int4_kernels:
                    dlhs = kernel == "int4_dlhs"
                    # x [rows, K] -> out [rows, N], or dout [rows, N] -> dx [rows, K]
                    a = torch.randn((rows, N if dlhs else K), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    out = torch.empty((rows, K if dlhs else N), dtype=torch.bfloat16,
                                      device="cuda")
                    plain = int4.int4_dlhs_reference if dlhs else int4.int4_matmul_reference
                    rule = int4.int4_dlhs_instance if dlhs else int4.int4_mm_instance
                    turn = [0]

                    def make(lib, a=a, q4=q4, sc=sc, out=out, rows=rows, K=K, N=N, turn=turn,
                             dlhs=dlhs):
                        fn = lib.int4_dlhs_launch if dlhs else lib.int4_mm_launch

                        def launch():
                            i = turn[0] % len(q4)
                            turn[0] += 1
                            return fn(a.data_ptr(), q4[i].data_ptr(), sc[i].data_ptr(),
                                      out.data_ptr(), rows, K, N, group, stream)
                        return launch

                    def check(a=a, q4=q4, sc=sc, out=out, turn=turn, plain=plain):
                        i = (turn[0] - 1) % len(q4)  # the copy the last launch read
                        return int4.tile_rel_err(out, plain(a, q4[i], sc[i]))

                    run(kernel, {"kernel": kernel, "shape": f"{label} M {rows}", "M": rows,
                                 "K": K, "N": N, "flops": 2 * rows * K * N,
                                 "instance": rule(rows, N, True)},
                        make, check)
                    del a, out
                del q4, sc
                torch.cuda.empty_cache()
    print(card_label(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
