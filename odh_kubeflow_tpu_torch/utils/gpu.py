"""GPU types: peak rates for MFU accounting and the node-pool metadata of
the platform side (counterpart of the JAX package's ``utils/tpu.py``).

One table of the cards the port knows. Each row gives torch's device
name, the card's bf16 dense tensor-core peak and, for a card that GKE
offers as a node-pool type, the ``cloud.google.com/gke-accelerator``
value, its GPUs per node and the GPU counts a notebook may ask for. The notebook controller turns an (accelerator, count)
request into ``nvidia.com/gpu`` limits and node selectors, and a request
larger than one node into ``ceil(gpus / gpus_per_node)`` StatefulSet
replicas: the counterparts of ``chips_in_topology`` and
``hosts_in_slice``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class GpuType:
    device_name: str  # a substring of torch.cuda.get_device_name()
    peak_bf16_flops: float  # dense, at the card's full power limit
    accelerator: str = ""  # the cloud.google.com/gke-accelerator value
    gpus_per_node: int = 0
    counts: tuple[int, ...] = ()  # GPU counts a notebook may request
    display_name: str = ""  # the spawner's dropdown label
    # the nvcc target the port's kernels are built for on this card
    # (the compile cache's topology axis, warmup/compilecache.py)
    arch: str = ""


_TO_64 = (1, 2, 4, 8, 16, 32, 64)

# peaks: NVIDIA data sheets; node shapes: the GKE machine types
GPU_TYPES: tuple[GpuType, ...] = (
    GpuType("H100 80GB HBM3", 989e12, "nvidia-h100-80gb", 8, _TO_64, "NVIDIA H100 80GB",
            "sm_90a"),
    GpuType("H100 80GB HBM3", 989e12, "nvidia-h100-mega-80gb", 8, (8, 16, 32, 64),
            "NVIDIA H100 Mega 80GB", "sm_90a"),
    GpuType("H100 NVL", 835e12, arch="sm_90a"),
    GpuType("H100 PCIe", 756e12, arch="sm_90a"),
    GpuType("H200", 989e12, "nvidia-h200-141gb", 8, (8, 16, 32, 64), "NVIDIA H200 141GB",
            "sm_90a"),
    GpuType("L4", 121e12, "nvidia-l4", 4, (1, 2, 4, 8, 16), "NVIDIA L4", "sm_89"),
)

# the node-pool view: accelerator label value → its row
GPU_ACCELERATORS: dict[str, GpuType] = {t.accelerator: t for t in GPU_TYPES if t.accelerator}


def peak_bf16_flops(device_name: str) -> float:
    """Peak bf16 dense FLOP/s of the card torch names ``device_name``;
    0.0 when the card is unknown."""
    for t in GPU_TYPES:
        if t.device_name in device_name:
            return t.peak_bf16_flops
    return 0.0


def gpus_in_request(count: str) -> int:
    """The GPU count of a request (the counterpart of
    ``chips_in_topology``): a positive integer."""
    n = int(count)
    if n <= 0:
        raise ValueError(f"GPU count must be positive, got {count!r}")
    return n


def nodes_in_slice(accelerator_type: str, gpus: int) -> int:
    """Nodes a request of ``gpus`` GPUs spans: ``ceil(gpus /
    gpus_per_node)`` (the counterpart of ``hosts_in_slice``)."""
    per_node = GPU_ACCELERATORS[accelerator_type].gpus_per_node
    return max(1, math.ceil(gpus / per_node))
