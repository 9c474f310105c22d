"""One process per card of a pod: the port's world is hosts × local cards.

The notebook controller gives each pod of a multi-node GPU notebook all
the GPUs of its node and one hostname in ``TPU_WORKER_HOSTNAMES``. JAX
starts one process a host that drives every chip of it, so its device
count is hosts × chips a host; NCCL wants one process a card, so the
port starts ``local`` processes a pod with global rank
``worker × local + local_index``.
"""

import os
import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from odh_kubeflow_tpu.utils.distributed import env_contract as jax_env_contract
from odh_kubeflow_tpu_torch.utils import distributed

ENV_KEYS = ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID", "JAX_COORDINATOR_ADDRESS",
            "JAX_COORDINATOR_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_hosts_of_eight_cards_make_a_world_of_sixteen(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "nb-0.nb-hosts,nb-1.nb-hosts")
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "nb-0.nb-hosts:8476")
    jax_c = jax_env_contract()
    # JAX: one process a host; each drives its host's 8 chips, so its
    # device count is 2 × 8 = 16, the world the port now starts
    assert jax_c["num_processes"] == 2
    jax_devices = jax_c["num_processes"] * 8
    ranks = set()
    for local_rank in range(8):
        c = distributed.env_contract(local_processes=8, local_rank=local_rank)
        assert c["num_processes"] == jax_devices == 16
        assert (c["hostnames"], c["coordinator_address"]) == (
            jax_c["hostnames"], jax_c["coordinator_address"])
        ranks.add(c["process_id"])
    assert ranks == set(range(8, 16))  # pod 1 holds ranks 8..15
    # one process a pod reads as JAX's contract
    assert distributed.env_contract() == jax_c
    with pytest.raises(ValueError, match="local rank"):
        distributed.env_contract(local_processes=2, local_rank=2)
    assert distributed.local_process_count("cpu") == 1
    assert distributed.local_process_count("cpu", 4) == 4


def test_a_bare_call_is_its_pods_only_process(monkeypatch):
    """A one-pod notebook with four cards (the controller injects
    ``localhost``): a bare ``initialize_from_env()`` is one process of a
    one-process world and returns False, whatever the card count; the
    pod's four processes are ``launch_local``'s to start."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def no_rendezvous(*args, **kwargs):
        raise AssertionError("a one-process world joined a rendezvous")

    monkeypatch.setattr(dist, "init_process_group", no_rendezvous)
    assert distributed.initialize_from_env() is False
    assert distributed.initialize_from_env(device="cpu") is False
    assert not dist.is_initialized()
    # the same pod's processes, as launch_local passes them
    assert [distributed.env_contract(4, i)["process_id"] for i in range(4)] == [0, 1, 2, 3]
    assert distributed.env_contract(4, 0)["num_processes"] == 4


def _member(local_rank: int, out_dir: str) -> None:
    world, rank = dist.get_world_size(), dist.get_rank()
    seen = [torch.zeros(1) for _ in range(world)]
    dist.all_gather(seen, torch.tensor([float(rank)]))
    with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
        f.write(f"{world} {os.environ['TPU_WORKER_ID']} {local_rank} "
                f"{' '.join(str(int(t.item())) for t in seen)}")


def _pod(worker: int, port: int, out_dir: str) -> None:
    os.environ.update(TPU_WORKER_HOSTNAMES="nb-0,nb-1", TPU_WORKER_ID=str(worker),
                      JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
    torch.set_num_threads(1)
    distributed.launch_local(_member, out_dir, device="cpu", local_processes=2)


def test_two_pods_of_two_cards_join_one_group_of_four(tmp_path):
    mp.start_processes(_pod, args=(_free_port(), str(tmp_path)), nprocs=2,
                       start_method="spawn")
    rows = {}
    for rank in range(4):
        world, worker, local, *seen = (tmp_path / f"rank{rank}").read_text().split()
        rows[rank] = (int(world), int(worker), int(local), [int(s) for s in seen])
    assert {r: (w, wk, lc) for r, (w, wk, lc, _) in rows.items()} == {
        0: (4, 0, 0), 1: (4, 0, 1), 2: (4, 1, 0), 3: (4, 1, 1)}
    assert all(seen == [0, 1, 2, 3] for *_, seen in rows.values())
