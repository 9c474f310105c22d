"""Distributed bring-up and the elastic runner on gloo ranks.

- ``env_contract`` parses the platform's env as the JAX package's does;
  ``initialize_from_env`` is a no-op for one process and, with a
  two-worker contract, joins two processes over TCP.
- ``run_elastic`` at fsdp=4: SIGTERM on one rank stops every rank at the
  same step (the gang's all-gather) with a forced checkpoint; two ranks at
  fsdp=2 (joined through ``initialize_from_env``) resume from it, and
  their next loss equals the loss the fsdp=4 run would have taken next
  (rtol 1e-5: the sums over fsdp run in another order).
"""

import os
import signal
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from odh_kubeflow_tpu.utils.distributed import env_contract as jenv_contract
from odh_kubeflow_tpu_torch.models import llama, lora
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.train import CheckpointManager, TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train.elastic import PreemptionGuard, run_elastic
from odh_kubeflow_tpu_torch.utils import distributed
from odh_kubeflow_tpu_torch.utils import prometheus

KILL_AT = 3


def test_env_contract_parsing_matches_jax(monkeypatch):
    cases = [
        {"TPU_WORKER_HOSTNAMES": "nb-0.svc,nb-1.svc", "TPU_WORKER_ID": "1",
         "JAX_COORDINATOR_ADDRESS": "nb-0.svc:8476"},
        {"TPU_WORKER_HOSTNAMES": "nb-0.svc,nb-1.svc", "TPU_WORKER_ID": "0",
         "JAX_COORDINATOR_ADDRESS": "nb-0.svc"},  # the default port appended
        {"TPU_WORKER_HOSTNAMES": "a,b,c", "JAX_COORDINATOR_PORT": "9000"},
        {"TPU_WORKER_HOSTNAMES": "localhost"},  # one host
    ]
    for env in cases:
        for k in ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID", "JAX_COORDINATOR_ADDRESS",
                  "JAX_COORDINATOR_PORT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert distributed.env_contract() == jenv_contract()
    assert distributed.env_contract()["num_processes"] == 1
    assert distributed.initialize_from_env(device="cpu") is False
    assert not dist.is_initialized()
    assert distributed.backend_for("cpu") == "gloo"


def _trainer(mesh):
    return Trainer(
        llama.LlamaConfig.tiny(dtype=torch.float32),
        TrainConfig(warmup_steps=1, total_steps=50, learning_rate=1e-2),
        lora.LoraConfig(rank=2), mesh=mesh, device="cpu",
        metrics_registry=prometheus.Registry(),
    )


def _preempted_at_fsdp4(rank, world, ckpt, out_path):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=world), device="cpu")
    trainer = _trainer(mesh)
    batch = trainer.make_fake_batch(8, 16)

    def on_step(step, _metrics):
        if step == KILL_AT and rank == 1:  # one rank's reclaim notice
            os.kill(os.getpid(), signal.SIGTERM)

    with CheckpointManager(ckpt, save_interval_steps=10**6) as mgr:
        guard = PreemptionGuard().install()
        try:
            result = run_elastic(trainer, mgr, (batch for _ in range(100)), total_steps=50,
                                 on_step=on_step, guard=guard)
        finally:
            guard.uninstall()
        assert result == {"step": KILL_AT, "preempted": True, "resumed_from": None}, result
        assert mgr.latest_step() == KILL_AT
    next_loss = float(trainer.eval_step(batch)["loss"])
    if rank == 0:
        torch.save({"next_loss": next_loss}, out_path)


def _resumed_at_fsdp2(rank, port, ckpt, out_path):
    os.environ.update(TPU_WORKER_HOSTNAMES="w0,w1", TPU_WORKER_ID=str(rank),
                      JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
    torch.set_num_threads(2)
    assert distributed.initialize_from_env(device="cpu") is True
    try:
        mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=2), device="cpu")
        trainer = _trainer(mesh)
        batch = trainer.make_fake_batch(8, 16)
        seen = {}
        with CheckpointManager(ckpt, save_interval_steps=10**6) as mgr:
            result = run_elastic(trainer, mgr, [batch] * 10, total_steps=KILL_AT + 1,
                                 on_step=lambda step, m: seen.update({step: float(m["loss"])}))
        assert result == {"step": KILL_AT + 1, "preempted": False, "resumed_from": KILL_AT}
        if rank == 0:
            torch.save({"next_loss": seen[KILL_AT + 1]}, out_path)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_elastic_preempted_at_fsdp4_resumes_at_fsdp2_with_the_same_next_loss(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    (tmp_path / "a").mkdir()
    spawn_cpu_ranks(_preempted_at_fsdp4, 4, ckpt, str(tmp_path / "a.pt"),
                    rendezvous_dir=str(tmp_path / "a"))
    mp.start_processes(_resumed_at_fsdp2, args=(_free_port(), ckpt, str(tmp_path / "b.pt")),
                       nprocs=2, start_method="spawn")
    want = torch.load(tmp_path / "a.pt")["next_loss"]
    got = torch.load(tmp_path / "b.pt")["next_loss"]
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)
