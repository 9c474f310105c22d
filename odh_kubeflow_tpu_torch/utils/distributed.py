"""``torch.distributed`` bring-up from the platform's injected env contract
(counterpart of ``utils/distributed.py``).

The notebook controller provisions a multi-host slice as a StatefulSet
plus a headless service and injects each worker's identity:
``TPU_WORKER_HOSTNAMES`` (comma list of stable DNS names),
``TPU_WORKER_ID`` (the pod index) and ``JAX_COORDINATOR_ADDRESS``
(worker 0's name and port). The variable names are the platform's and
stay as they are; here they start one process per card: the process
index is the rank, the host list's length the world size, and the
coordinator address the TCP rendezvous of ``init_process_group``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from odh_kubeflow_tpu_torch.utils.device import resolve_device


def env_contract() -> dict:
    """The parsed contract, without side effects."""
    hostnames = [
        h for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
    ]
    worker_id = int(os.environ.get("TPU_WORKER_ID", "0") or "0")
    port = os.environ.get("JAX_COORDINATOR_PORT", "8476")
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    if not coordinator and hostnames:
        coordinator = f"{hostnames[0]}:{port}"
    elif coordinator and ":" not in coordinator:
        coordinator = f"{coordinator}:{port}"
    return {
        "hostnames": hostnames,
        "num_processes": len(hostnames),
        "process_id": worker_id,
        "coordinator_address": coordinator,
    }


def backend_for(device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_from_env(device="cuda") -> bool:
    """``init_process_group`` over ``tcp://<coordinator>`` when the
    platform injected a multi-process contract (NCCL on the card, gloo
    when ``device="cpu"``); a no-op returning False for a single process.

    Call once, before any collective. On the card each process takes the
    card of its local index (one process per card)."""
    c = env_contract()
    if c["num_processes"] <= 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(c["process_id"] % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(dev),
        init_method=f"tcp://{c['coordinator_address']}",
        world_size=c["num_processes"],
        rank=c["process_id"],
    )
    return True
