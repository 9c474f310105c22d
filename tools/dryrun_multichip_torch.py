#!/usr/bin/env python3
"""The port's multi-device dry run: full training steps over an n-rank mesh
for every parallelism axis, then expert, pipe and sharded serving, one step
or request each on tiny shapes, as ``__graft_entry__.dryrun_multichip`` does
for the JAX package.

    python tools/dryrun_multichip_torch.py 4                # one NCCL rank per card
    python tools/dryrun_multichip_torch.py 8 --device cpu   # 8 gloo ranks on the CPU

By default it runs one NCCL rank per card (n cards; it raises with fewer),
its tiny models in the kernels' contract (bfloat16, head dim 64). With
``--device cpu`` the same code starts n gloo ranks (``parallel/launch.py``
``spawn_cpu_ranks``), one process each, in one group, as the JAX version
forces n virtual CPU devices. In order:

1. ``mesh_configs(n)``: the data, fsdp, context and tensor axes in two
   rotations (ring attention where context > 1), the second with an int8
   QLoRA base: a LoRA step of a tiny Llama on each;
2. a full fine-tuning step of ``mixtral_tiny`` with the grouped dispatch at
   expert > 1 (data x fsdp x expert), asserting that the expert-parallel
   grouped path is the one taken (``moe.dispatch_path``);
3. a LoRA step over pipe=2 (GPipe through the trainer);
4. at n % 4 == 0, ``mixtral_tiny`` over pipe=2 x expert=2;
5. at n % 8 == 0, the sharded ``DecodeEngine`` at data=2 x fsdp=2 x
   tensor=2 (data=n/4 past 8 ranks, where the JAX version serves on its
   first 8 devices) with ``prefill_chunk=16``, greedy-exact against the
   one-device ``generate``.

Rank 0 prints one ``dryrun_multichip ok: ...`` line per run, as the JAX
version does. Any failure on any rank fails the command.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from odh_kubeflow_tpu_torch.parallel.mesh import MeshConfig  # noqa: E402

WAIT = 600


def mesh_configs(n_devices: int) -> list[MeshConfig]:
    """The mesh shapes of the rotations (the JAX version's ``_mesh_configs``).
    With >= 16 devices one shape has all four of data, fsdp, context and
    tensor > 1; with 8 two shapes rotate the factors of 2 so that each axis
    is > 1 in one of them. An odd factor of n rides the data axis."""
    odd = n_devices
    while odd % 2 == 0:
        odd //= 2
    twos = (n_devices // odd).bit_length() - 1

    def distribute(order):
        axes = {"data": odd, "fsdp": 1, "context": 1, "tensor": 1}
        for i in range(twos):
            axes[order[i % len(order)]] *= 2
        return MeshConfig(**axes)

    uniq = []
    for c in (distribute(("tensor", "context", "fsdp", "data")),
              distribute(("data", "fsdp", "context", "tensor"))):
        if c not in uniq:
            uniq.append(c)
    return uniq


class _Report:
    """Rank 0's lines, printed as they come and kept for the caller."""

    def __init__(self, rank: int):
        self.rank, self.lines, self.results = rank, [], {}

    def ok(self, text: str) -> None:
        if self.rank == 0:
            line = f"dryrun_multichip ok: {text}"
            print(line, flush=True)
            self.lines.append(line)


def _registry():
    from odh_kubeflow_tpu_torch.utils import prometheus

    return prometheus.Registry()


def _loss(metrics) -> float:
    loss = float(metrics["loss"])
    if loss != loss:  # noqa: PLR0124
        raise AssertionError("loss is NaN")
    return loss


def _axes(cfg: MeshConfig, *names) -> dict:
    return {n: getattr(cfg, n) for n in names}


def _tiny(device: str, **kw):
    """``LlamaConfig.tiny`` in float32, the JAX version's; on the card in
    the kernels' contract (flash and the ring's blocks take bfloat16 at head
    dim 64 or 128): bfloat16, head dim 64."""
    from odh_kubeflow_tpu_torch.models import LlamaConfig

    extra = dict(dtype=torch.bfloat16, head_dim=64) if device == "cuda" else dict(
        dtype=torch.float32)
    return LlamaConfig.tiny(**{**extra, **kw})


def _mixtral_tiny(device: str, **kw):
    """``MoeConfig.mixtral_tiny``, on the card on ``_tiny``'s backbone."""
    from odh_kubeflow_tpu_torch.models import moe

    if device == "cuda":
        kw = dict(base=_tiny(device), **kw)
    return moe.MoeConfig.mixtral_tiny(**kw)


def _dryrun_axes(n: int, device: str, report: _Report) -> None:
    from odh_kubeflow_tpu_torch.models import LoraConfig
    from odh_kubeflow_tpu_torch.parallel.mesh import build_mesh
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    for i, mesh_cfg in enumerate(mesh_configs(n)):
        cfg = _tiny(device, attention_impl="ring" if mesh_cfg.context > 1 else "dense")
        quantize_base = i == 1  # the second rotation: an int8 QLoRA base
        trainer = Trainer(cfg, TrainConfig(warmup_steps=1, total_steps=4),
                          lora_cfg=LoraConfig(rank=4), mesh=build_mesh(mesh_cfg, device),
                          quantize_base=quantize_base, metrics_registry=_registry())
        dp_total = mesh_cfg.data * mesh_cfg.fsdp
        loss = _loss(trainer.train_step(trainer.make_fake_batch(-(-8 // dp_total) * dp_total,
                                                                32)))
        report.ok(f"mesh={_axes(mesh_cfg, 'data', 'fsdp', 'context', 'tensor')} "
                  + ("(int8 QLoRA base) " if quantize_base else "") + f"loss={loss:.4f}")


def _dryrun_expert_parallel(n: int, device: str, report: _Report) -> None:
    """A full fine-tuning step of ``mixtral_tiny`` on the grouped dispatch
    with the expert axis > 1: banks over expert, the grouped kernels on each
    rank's local experts between the all-gather dispatch and the
    reduce-scatter combine (``moe._moe_mlp_grouped_ep``)."""
    from odh_kubeflow_tpu_torch.models import moe
    from odh_kubeflow_tpu_torch.parallel.mesh import build_mesh
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    expert = 2 if n % 2 == 0 else 1
    rest = n // expert
    fsdp = 2 if rest % 2 == 0 else 1
    mesh_cfg = MeshConfig(data=rest // fsdp, fsdp=fsdp, expert=expert)
    mesh = build_mesh(mesh_cfg, device)
    cfg = _mixtral_tiny(device, dispatch="grouped")
    # big enough that each (data, fsdp) group takes the grouped path:
    # (B·S / (data·fsdp))·k >= 2048; smaller batches take the ragged path
    B, S = 8, 512
    probe = torch.empty((B, S, cfg.base.hidden_size), device="meta")
    path = moe.dispatch_path(probe, cfg, mesh)
    if path != ("grouped_ep" if expert > 1 else "grouped"):
        raise AssertionError(f"expert-parallel grouped path did not engage: {path}")
    trainer = Trainer(cfg, TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4),
                      mesh=mesh, seed=1, metrics_registry=_registry())
    tokens = torch.ones((B, S), dtype=torch.long)
    loss = _loss(trainer.train_step({"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}))
    report.ok(f"mesh={_axes(mesh_cfg, 'data', 'fsdp', 'expert')} "
              f"(MoE expert-parallel, dispatch=grouped) loss={loss:.4f}")


def _dryrun_pipeline_parallel(n: int, device: str, report: _Report) -> None:
    """A LoRA step over pipe=2 through the trainer (the stage's layers on
    each pipe rank, GPipe), then at n % 4 == 0 ``mixtral_tiny`` over
    pipe=2 x expert=2 (the router aux through the pipeline's scalar)."""
    from odh_kubeflow_tpu_torch.models import LoraConfig
    from odh_kubeflow_tpu_torch.parallel.mesh import build_mesh
    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer

    if n % 2:
        return
    train_cfg = TrainConfig(warmup_steps=1, total_steps=4, pipeline_microbatches=2)
    trainer = Trainer(_tiny(device), train_cfg,
                      lora_cfg=LoraConfig(rank=4),
                      mesh=build_mesh(MeshConfig(pipe=2, data=n // 2), device),
                      metrics_registry=_registry())
    loss = _loss(trainer.train_step(trainer.make_fake_batch(n // 2 * 2, 32)))
    report.ok(f"mesh={dict(data=n // 2, pipe=2)} (GPipe pipeline-parallel trainer) "
              f"loss={loss:.4f}")
    if n % 4:
        return
    mesh_cfg = MeshConfig(pipe=2, expert=2, data=n // 4)
    trainer = Trainer(_mixtral_tiny(device), train_cfg,
                      mesh=build_mesh(mesh_cfg, device), metrics_registry=_registry())
    loss = _loss(trainer.train_step(trainer.make_fake_batch(n // 4 * 2 * 2, 32)))
    report.ok(f"mesh={dict(data=mesh_cfg.data, pipe=2, expert=2)} "
              f"(MoE pipeline x expert parallel) loss={loss:.4f}")


def _dryrun_sharded_serving(n: int, device: str, report: _Report) -> None:
    """The continuous-batching engine under data x fsdp x tensor (slots over
    data and fsdp, KV heads over tensor), one prompt admitted in 16-token
    parts, greedy-exact against the one-device ``generate``."""
    from odh_kubeflow_tpu_torch.models import llama
    from odh_kubeflow_tpu_torch.models.engine import DecodeEngine
    from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
    from odh_kubeflow_tpu_torch.parallel import mesh as mesh_lib

    if n % 8:
        return
    cfg = _tiny(device)
    params = llama.init_params(3, cfg, torch.float32, device=device)
    prompt = list(range(3, 3 + 24))
    want = generate(params, torch.tensor([prompt], device=device), cfg,
                    GenerateConfig(max_new_tokens=6, cache_dtype=torch.float32))
    want_toks = want["tokens"][0][: int(want["lengths"][0])].tolist()

    # the JAX version serves on the first 8 devices; past 8 ranks every
    # rank serves here, the data axis (and the slots) growing with n
    mesh_cfg = MeshConfig(data=2 * (n // 8), fsdp=2, tensor=2)
    mesh = mesh_lib.build_mesh(mesh_cfg, device)
    sharded = mesh_lib.shard_tree(params, mesh, llama.param_specs(cfg))
    engine = DecodeEngine(sharded, cfg, n_slots=4 * (n // 8), max_len=128, chunk=4,
                          prompt_buckets=(16, 32), cache_dtype=torch.float32, mesh=mesh,
                          prefill_chunk=16, device=device, metrics_registry=_registry())
    if report.rank:
        engine.stop()  # waits for rank 0's stop
        return
    try:
        got = engine.submit(prompt, max_tokens=6).result(timeout=WAIT)
    finally:
        engine.stop()
    if got != want_toks:
        raise AssertionError(f"sharded engine {got} != one-device generate {want_toks}")
    report.results["engine_tokens"], report.results["generate_tokens"] = got, want_toks
    report.ok(f"mesh={_axes(mesh_cfg, 'data', 'fsdp', 'tensor')} "
              f"(sharded DecodeEngine serving, chunked prefill) greedy-exact {len(got)} tokens")


def dryrun_multichip(rank: int, world: int, device: str, out_path: str) -> None:
    """Every run of the dry run on this rank (all ranks call this); rank 0
    writes its lines and the engine's tokens to ``out_path`` as JSON."""
    report = _Report(rank)
    _dryrun_axes(world, device, report)
    _dryrun_expert_parallel(world, device, report)
    _dryrun_pipeline_parallel(world, device, report)
    _dryrun_sharded_serving(world, device, report)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"lines": report.lines, **report.results}, f)


def _nccl_entry(rank: int, world: int, port: int, out_path: str) -> None:
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=WAIT))
    try:
        dryrun_multichip(rank, world, "cuda", out_path)
    finally:
        dist.destroy_process_group()


def run(n_devices: int, device: str = "cuda", workdir: str | None = None) -> dict:
    """The dry run on ``n_devices`` ranks; returns rank 0's record
    (``lines``, ``engine_tokens``, ``generate_tokens``)."""
    from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        if device == "cpu":
            spawn_cpu_ranks(dryrun_multichip, n_devices, device, out_path,
                            rendezvous_dir=tmp, threads=1)
        elif device == "cuda":
            if torch.cuda.device_count() < n_devices:
                raise RuntimeError(f"device cuda needs {n_devices} cards, "
                                   f"{torch.cuda.device_count()} visible")
            import socket

            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            mp.start_processes(_nccl_entry, args=(n_devices, port, out_path),
                               nprocs=n_devices, start_method="spawn")
        else:
            raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
        with open(out_path) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    run(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
