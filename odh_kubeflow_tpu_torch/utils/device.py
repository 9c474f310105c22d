"""Device resolution: the counterpart of ``utils/tpu.py``.

The port runs on the card. ``resolve_device`` defaults to ``cuda`` and
raises when no GPU is present, so nothing silently falls back to the
CPU; the CPU is used only when a caller asks for it (the tests do).
"""

from __future__ import annotations

import subprocess

import torch

from odh_kubeflow_tpu_torch.utils.gpu import peak_bf16_flops


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``cuda`` unless told otherwise; raises when CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def peak_flops_per_device(name: str | None = None) -> float:
    """Peak bf16 dense FLOP/s of one card for MFU accounting (the
    counterpart of ``utils/tpu.py`` ``peak_flops_per_chip``), from the
    table of ``utils/gpu.py``; ``name`` defaults to card 0's. 0.0 when
    the card is unknown or absent."""
    if name is None:
        if not torch.cuda.is_available():
            return 0.0
        name = torch.cuda.get_device_name(0)
    return peak_bf16_flops(name)


def card_label() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card). Every timing is reported beside it: a card
    set below its maximum power runs slower under load."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
