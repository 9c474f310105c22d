"""LoRA adapters for the stacked-layer Llama (counterpart of
``models/lora.py``).

The adapter tree mirrors ``params["layers"]`` with the same leading
``[L, ...]`` axis, so the decoder loop slices base weights and adapters
in lockstep.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
from odh_kubeflow_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

# the only valid targets for the MoE family (its expert banks replace
# the dense MLP weights; adapters attach to attention projections)
ATTENTION_TARGETS = ("wq", "wk", "wv", "wo")

_TARGET_DIMS = {
    # name -> (fan_in attr, fan_out attr) resolved against LlamaConfig
    "wq": ("hidden_size", "q_dim"),
    "wk": ("hidden_size", "kv_dim"),
    "wv": ("hidden_size", "kv_dim"),
    "wo": ("q_dim", "hidden_size"),
    "w_gate": ("hidden_size", "intermediate_size"),
    "w_up": ("hidden_size", "intermediate_size"),
    "w_down": ("intermediate_size", "hidden_size"),
}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Sequence[str] = ATTENTION_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora_params(
    seed: int,
    cfg: LlamaConfig,
    lora: LoraConfig,
    dtype=torch.float32,
    *,
    device="cuda",
) -> Params:
    """A ~ gaussian, B = 0: the adapter starts as a zero delta."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L = cfg.num_layers
    layers: Params = {}
    for name in lora.targets:
        fan_in = getattr(cfg, _TARGET_DIMS[name][0])
        fan_out = getattr(cfg, _TARGET_DIMS[name][1])
        a = torch.randn(
            (L, fan_in, lora.rank), generator=gen, dtype=torch.float32, device=dev
        )
        layers[name] = {
            "a": (a * fan_in**-0.5).to(dtype),
            "b": torch.zeros((L, lora.rank, fan_out), dtype=dtype, device=dev),
            "scale": torch.full((L,), lora.scale, dtype=torch.float32, device=dev),
        }
    return {"layers": layers}


def _copy_dicts(tree):
    return {k: _copy_dicts(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def merge_lora(params: Params, lora_params: Params) -> Params:
    """Fold adapters into the base weights (for export / serving). The
    dict structure is copied; untouched tensors are shared."""
    merged = _copy_dicts(params)
    for name, ab in lora_params["layers"].items():
        w = params["layers"][name]
        delta = torch.einsum(
            "lir,lro->lio", ab["a"].to(torch.float32), ab["b"].to(torch.float32)
        ) * ab["scale"][:, None, None]
        merged["layers"][name] = (w.to(torch.float32) + delta).to(w.dtype)
    return merged
