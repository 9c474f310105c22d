#!/usr/bin/env python3
"""What the mesh path and the ring cost on one card.

    python3 tools/mesh_overhead.py

1. The Llama-3-8B QLoRA step (int4 base, LoRA r16, remat "attn", batch 2
   x seq 4096, as ``chip_smoke.py``'s ``train`` phase), then the
   Mixtral-8x1B QLoRA step (``moe_train``'s), each without a mesh and
   through ``Trainer(mesh=build_mesh(MeshConfig()))`` on an NCCL group of
   one rank, in turns: one-device, (the group made) one-device, mesh,
   one-device, mesh; each the mean of 3 steps after one warm-up, host
   clock, synchronised by reading the loss. Then one profiled step of
   each: device time, wall time, launches, the largest kernels.
2. The loopback ring at ``chip_smoke.py``'s ``RING_SHAPE`` (4 ranks,
   causal), plain and zigzag, forward and backward: the host's time to
   issue it and a profile of one run (device time by kernel); and a
   profile of one whole-sequence call of each flash kernel.

Prints one JSON line each, then the card.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from odh_kubeflow_tpu_torch import card_label
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig
    from odh_kubeflow_tpu_torch.ops import _build
    from odh_kubeflow_tpu_torch.ops import flash_attention as fa
    from odh_kubeflow_tpu_torch.parallel import ring_attention as ra
    from odh_kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    if not torch.cuda.is_available():
        print("mesh_overhead: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["int4_dequant", "flash_fwd", "flash_bwd", "gmm", "swiglu_gmm"])

    def profiled(fn) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = cs.device_kernels(prof)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        return {"wall_ms": wall * 1e3,
                "device_ms": sum(t for t, _ in kernels.values()) / 1e3,
                "launches": sum(c for _, c in kernels.values()),
                "top": [{"kernel": k[:70], "ms": t / 1e3, "launches": c}
                        for k, (t, c) in top]}

    models = {"llama3_8b": (LlamaConfig.llama3_8b(remat=True, remat_policy="attn"), "int4",
                            cs.TRAIN_SHAPE),
              "mixtral_8x1b": (cs.moe_config(), True, cs.MOE_TRAIN_SHAPE)}
    for model, (cfg, quantize_base, (B, S)) in models.items():
        one = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base=quantize_base)
        batch = one.make_fake_batch(B, S)

        def step_s(trainer, n=3) -> float:
            float(trainer.train_step(batch)["loss"])
            t0 = time.perf_counter()
            for _ in range(n):
                metrics = trainer.train_step(batch)
            float(metrics["loss"])
            return (time.perf_counter() - t0) / n

        turns = {"one_device": step_s(one)}
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{cs.free_port()}",
                                world_size=1, rank=0)
        try:
            turns["one_device_group_made"] = step_s(one)
            mesh = Trainer(cfg, TrainConfig(), LoraConfig(rank=16), quantize_base=quantize_base,
                           mesh=build_mesh(MeshConfig()))
            turns["mesh_1"] = step_s(mesh)
            turns["one_device_2"] = step_s(one)
            turns["mesh_2"] = step_s(mesh)
            cs.emit({"model": model, "step_s": turns})
            cs.emit({"model": model, "profiled_step": "one_device",
                     **profiled(lambda: float(one.train_step(batch)["loss"]))})
            cs.emit({"model": model, "profiled_step": "mesh",
                     **profiled(lambda: float(mesh.train_step(batch)["loss"]))})
        finally:
            dist.destroy_process_group()
        del one, mesh
        torch.cuda.empty_cache()

    Bq, Sq, Hq, Hkv, hd = cs.RING_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = bf16(Bq, Sq, Hq, hd), bf16(Bq, Sq, Hkv, hd), bf16(Bq, Sq, Hkv, hd), bf16(Bq, Sq, Hq, hd)
    for layout in ("plain", "zigzag"):
        def ring():
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
            out = ra.loopback_ring_attention(qq, kk, vv, num_ranks=cs.RING_RANKS, layout=layout)
            return torch.autograd.grad(out, (qq, kk, vv), do)

        ring()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring()
        issue_ms = (time.perf_counter() - t0) * 1e3
        cs.emit({"ring": layout, "host_issue_ms": issue_ms, **profiled(ring)})

    def whole():
        o, lse = fa.flash_fwd(q, k, v, causal=True)
        d = fa.flash_delta(o, do)
        fa.flash_dq(q, k, v, lse, d, do, causal=True)
        fa.flash_dkv(q, k, v, lse, d, do, causal=True)

    cs.emit({"whole_sequence_flash": True, **profiled(whole)})
    print(card_label(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
