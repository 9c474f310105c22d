"""Run a function on several CPU ranks, one process each, joined in a gloo
process group: the port's multi-process runs on a machine without cards
(its tests among them). On a multi-GPU host, start one process per card
with the platform's env contract instead (``utils/distributed.py``).

    spawn_cpu_ranks(fn, 4, arg, rendezvous_dir=tmp)  # fn(rank, 4, arg) in each

The ranks meet through a file in ``rendezvous_dir`` (a fresh directory:
no TCP port to clash with other runs on the machine). A rank's exception
fails the call, after every process has ended.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, fn: Callable, world_size: int, path: str, threads: int, args):
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method=f"file://{path}", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=300),
    )
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn_cpu_ranks(
    fn: Callable, world_size: int, *args, rendezvous_dir: str, threads: int = 2
) -> None:
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned processes
    (``fn`` and ``args`` must pickle), each with ``threads`` CPU threads;
    returns when all have ended, raising if any failed."""
    path = os.path.join(rendezvous_dir, "rendezvous")
    if os.path.exists(path):
        raise FileExistsError(f"{path} exists: each group needs a fresh rendezvous file")
    mp.start_processes(
        _entry, args=(fn, world_size, path, threads, args), nprocs=world_size,
        start_method="spawn",
    )
