"""``torch.distributed`` bring-up from the platform's injected env contract
(counterpart of ``utils/distributed.py``).

The notebook controller provisions a multi-node notebook as a StatefulSet
plus a headless service and injects each pod's identity:
``TPU_WORKER_HOSTNAMES`` (comma list of stable DNS names, one a pod),
``TPU_WORKER_ID`` (the pod index) and ``JAX_COORDINATOR_ADDRESS``
(pod 0's name and port). The variable names are the platform's and stay
as they are.

JAX starts one process a host and that process drives every chip of its
host, so its device count is hosts × chips a host. NCCL wants one process
a card, so here a pod starts one process for each card it holds
(``launch_local``): with ``local`` cards a pod, the process of local
index ``i`` on pod ``w`` has global rank ``w × local + i`` in a world of
``hosts × local`` processes, all meeting at the coordinator address. On
the card ``launch_local`` starts ``torch.cuda.device_count()`` processes
(the pod's ``nvidia.com/gpu`` limit, all visible); on the CPU the caller
passes the count. A bare ``initialize_from_env()`` is one process of its
pod, as in JAX's contract.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from odh_kubeflow_tpu_torch.utils.device import resolve_device


def env_contract(local_processes: int = 1, local_rank: int = 0) -> dict:
    """The parsed contract, without side effects. ``num_processes`` is
    the world (hosts × ``local_processes``) and ``process_id`` the global
    rank of local process ``local_rank``; with one process a pod both
    read as the JAX package's do."""
    if not 0 <= local_rank < local_processes:
        raise ValueError(f"local rank {local_rank} outside {local_processes} local processes")
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
        "num_processes": len(hostnames) * local_processes,
        "process_id": worker_id * local_processes + local_rank,
        "coordinator_address": coordinator,
    }


def backend_for(device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def local_process_count(device="cuda", local_processes: Optional[int] = None) -> int:
    """The processes ``launch_local`` starts: one a visible card on the
    card; on the CPU ``local_processes`` (1 when not given)."""
    if local_processes is not None:
        return local_processes
    if resolve_device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def initialize_from_env(device="cuda", local_rank: int = 0, local_processes: int = 1) -> bool:
    """``init_process_group`` over ``tcp://<coordinator>`` when the
    contract describes more than one process (NCCL on the card, gloo
    when ``device="cpu"``); a no-op returning False for a single process.

    Call once in each of a pod's ``local_processes`` processes, before
    any collective; ``launch_local`` starts them, one a card, and passes
    both. A bare call is its pod's only process, on the pod's first card.
    On the card the process of local index ``local_rank`` takes that card."""
    c = env_contract(local_processes, local_rank)
    if c["num_processes"] <= 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend_for(dev),
        init_method=f"tcp://{c['coordinator_address']}",
        world_size=c["num_processes"],
        rank=c["process_id"],
    )
    return True


def _local_entry(local_rank: int, fn: Callable, device, local: int, args) -> None:
    initialize_from_env(device, local_rank, local)
    try:
        fn(local_rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_local(
    fn: Callable, *args, device="cuda", local_processes: Optional[int] = None
) -> None:
    """Start the pod's processes, one a card (``local_processes`` on the
    CPU), each joined to the whole gang through ``initialize_from_env``,
    and run ``fn(local_rank, *args)`` in each (``fn`` and ``args`` must
    pickle); returns when all have ended, raising if any failed."""
    local = local_process_count(device, local_processes)
    mp.start_processes(
        _local_entry, args=(fn, device, local, args), nprocs=local, start_method="spawn"
    )
