"""KV-cache autoregressive generation (counterpart of
``models/generate.py``).

- **Physical vs logical positions.** Ragged (right-padded) prompts
  share one physical write index, slot ``prompt_pad + step``, while
  rope uses each row's *logical* position ``prompt_len + step``. The pad
  slots in between are never attended: ``kv_mask`` marks valid cache
  slots and grows by exactly the written slot each step.
- **Always N decode steps**, as the JAX scan runs them: a row that hit
  ``eos_id`` emits ``pad_id`` from then on.
- The loop stays on the device: no step reads a value back to the
  host, so the card is never waiting on Python between steps.

Sampling: greedy, temperature, top-k, and nucleus (top-p), composed in
that order. Random draws come from the ``torch.Generator`` passed in,
never from the global generator, so a seed reproduces a completion.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from odh_kubeflow_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    forward_with_cache,
)
from odh_kubeflow_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    pad_id: int = 0
    cache_dtype: Any = torch.bfloat16


def init_cache(
    cfg: LlamaConfig,
    batch_size: int,
    max_len: int,
    dtype=torch.bfloat16,
    *,
    device="cuda",
) -> Params:
    """Preallocated KV cache: ``{"k","v"}: [L, B, S_max, Hkv, hd]``, on the
    card unless ``device`` says otherwise."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def filter_logits(
    logits: torch.Tensor,  # [B, V] float32
    *,
    temperature: float,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Temperature, then top-k, then top-p: the logits ``sample_logits``
    draws from, with ``-inf`` outside the kept set."""
    logits = logits / temperature
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix whose mass reaches top_p (the token
        # that crosses the threshold is included, per nucleus sampling)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True
        )
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample_logits(
    logits: torch.Tensor,  # [B, V] float32
    generator: Optional[torch.Generator],
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample next-token ids [B] from final-position logits. Greedy
    ignores ``generator``; sampling draws Gumbel noise from it."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a torch.Generator")
    # Gumbel-max: argmax(logits + Gumbel noise) is a draw from
    # softmax(logits), as jax.random.categorical samples
    u = torch.rand(
        logits.shape, generator=generator, dtype=torch.float32, device=logits.device
    )
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def family_forward(cfg):
    """(cache-shape config, cached-forward fn) for a dense or MoE config —
    the single model-family dispatch point of ``generate``. A MoeConfig
    wraps a dense backbone whose shapes drive the cache; its own cached
    forward routes the MLP through the experts."""
    if hasattr(cfg, "base"):
        from odh_kubeflow_tpu_torch.models import moe

        return cfg.base, moe.forward_with_cache
    return cfg, forward_with_cache


def generate(
    params: Params,
    prompt_tokens: torch.Tensor,  # [B, S_prompt] integer, right-padded
    cfg: LlamaConfig,
    gen_cfg: GenerateConfig,
    *,
    prompt_lengths: Optional[torch.Tensor] = None,  # [B] integer
    lora: Optional[Params] = None,
    generator: Optional[torch.Generator] = None,
) -> dict[str, torch.Tensor]:
    """Autoregressive generation on ``prompt_tokens``' device.

    Returns ``{"tokens": [B, max_new_tokens], "lengths": [B]}`` where
    ``lengths`` counts generated tokens up to and including the first
    ``eos_id`` (or ``max_new_tokens`` when eos never fires); positions
    past a row's eos hold ``pad_id``.
    """
    dev = prompt_tokens.device
    B, S_prompt = prompt_tokens.shape
    N = gen_cfg.max_new_tokens
    max_len = S_prompt + N
    if prompt_lengths is None:
        prompt_lengths = torch.full((B,), S_prompt, device=dev)
    prompt_lengths = prompt_lengths.to(device=dev, dtype=torch.long)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    sample = dict(
        temperature=gen_cfg.temperature, top_k=gen_cfg.top_k, top_p=gen_cfg.top_p
    )

    cache_cfg, fwd = family_forward(cfg)
    cache = init_cache(cache_cfg, B, max_len, gen_cfg.cache_dtype, device=dev)
    slots = torch.arange(max_len, device=dev)[None, :]  # [1, S_max]
    kv_mask = slots < prompt_lengths[:, None]  # prompt region valid

    # --- prefill: whole prompt at physical slots [0, S_prompt) -------
    positions = torch.arange(S_prompt, device=dev).expand(B, S_prompt)
    logits, cache = fwd(
        params,
        prompt_tokens,
        cfg,
        cache,
        0,
        positions=positions,
        kv_mask=kv_mask,
        lora=lora,
        token_mask=kv_mask[:, :S_prompt],
    )
    # next token comes from each row's last *real* prompt position
    last = logits[torch.arange(B, device=dev), prompt_lengths - 1]
    token = sample_logits(last, generator, **sample)

    # --- decode: one token per step at physical slot S_prompt + i ----
    pad = torch.tensor(gen_cfg.pad_id, dtype=token.dtype, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    emitted = []
    for i in range(N):
        write_index = S_prompt + i
        kv_mask = kv_mask | (slots == write_index)
        positions = (prompt_lengths + i)[:, None]  # logical rope position
        logits, cache = fwd(
            params,
            token[:, None],
            cfg,
            cache,
            write_index,
            positions=positions,
            kv_mask=kv_mask,
            lora=lora,
        )
        next_token = sample_logits(logits[:, 0, :], generator, **sample)
        emitted.append(torch.where(done, pad, token))
        if gen_cfg.eos_id is not None:
            done = done | (token == gen_cfg.eos_id)
        token = torch.where(done, pad, next_token)

    if emitted:
        tokens = torch.stack(emitted, dim=1)
    else:
        tokens = torch.zeros((B, 0), dtype=token.dtype, device=dev)
    lengths = (tokens != gen_cfg.pad_id).sum(dim=1)
    return {"tokens": tokens, "lengths": lengths}
