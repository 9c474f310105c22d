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

Under a mesh (``generate(mesh=)``, one process a rank) the cache shards as
JAX's ``cache_specs``: the batch over (data, fsdp), the KV heads over
tensor. Each rank decodes its block of the prompt batch (replicated over
tensor and expert) through the sharded cached forward, draws the noise of
the whole batch from the same generator state and keeps its rows, so the
tokens are the one-device ones; the tokens and lengths are gathered whole
on every rank at the end.
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
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_TENSOR,
    P,
    local_shard,
)
from odh_kubeflow_tpu_torch.utils.device import resolve_device

# the axes the serving batch (the cache's, generate's prompts, the
# engine's slots) is split over; tensor and expert ranks replicate it
SERVE_BATCH_AXES = (AXIS_DATA, AXIS_FSDP)


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    pad_id: int = 0
    cache_dtype: Any = torch.bfloat16


def cache_specs(cfg: LlamaConfig) -> Params:
    """The sharding of ``init_cache``'s tree, JAX's: the batch over (data,
    fsdp), the KV heads over tensor (the tensor-split wk/wv produce them,
    so the cache write needs no collective)."""
    spec = P(None, SERVE_BATCH_AXES, None, AXIS_TENSOR, None)
    return {"k": spec, "v": spec}


def check_serving_mesh(mesh, cfg: LlamaConfig, batch_size: Optional[int] = None) -> None:
    """Raise where serving cannot run on ``mesh``: a pipe or context axis
    (the cached forward runs every layer on the whole sequence), KV heads
    that do not split over tensor, or a batch that does not split over
    (data, fsdp)."""
    for axis in (AXIS_PIPE, AXIS_CONTEXT):
        if mesh.sizes[axis] > 1:
            raise ValueError(
                f"serving under a mesh shards the batch over (data, fsdp) and the heads "
                f"over tensor; {axis}={mesh.sizes[axis]} is not a serving axis"
            )
    t = mesh.sizes[AXIS_TENSOR]
    if cfg.num_kv_heads % t:
        raise ValueError(f"{cfg.num_kv_heads} KV heads do not split over tensor={t}")
    n = mesh.size(SERVE_BATCH_AXES)
    if batch_size is not None and batch_size % n:
        raise ValueError(
            f"batch {batch_size} does not split over data x fsdp = {n}: serving needs a "
            f"multiple of {n} rows (slots)"
        )


def init_cache(
    cfg: LlamaConfig,
    batch_size: int,
    max_len: int,
    dtype=torch.bfloat16,
    *,
    device="cuda",
    mesh=None,
) -> Params:
    """Preallocated KV cache: ``{"k","v"}: [L, B, S_max, Hkv, hd]``, on the
    card unless ``device`` says otherwise. Under ``mesh`` it is this rank's
    block of the global cache by ``cache_specs`` (``batch_size`` is the
    global batch), on the mesh's device."""
    shape = [cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim]
    if mesh is not None:
        check_serving_mesh(mesh, cfg, batch_size)
        device = mesh.device
        shape[1] //= mesh.size(SERVE_BATCH_AXES)
        shape[3] //= mesh.sizes[AXIS_TENSOR]
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def batch_block(mesh) -> tuple[int, int]:
    """``(index, count)`` of this rank's block of a serving batch: its
    (data, fsdp) coordinate and the number of blocks."""
    return mesh.index(SERVE_BATCH_AXES), mesh.size(SERVE_BATCH_AXES)


def filter_logits(
    logits: torch.Tensor,  # [B, V] float32
    *,
    temperature,
    top_k=None,
    top_p=None,
) -> torch.Tensor:
    """Temperature, then top-k, then top-p: the logits a sampler draws
    from, with ``-inf`` outside the kept set.

    Each knob is a number shared by every row (``generate``) or a ``[B]``
    tensor, one value a row (the engine's slots, JAX's
    ``sample_logits_rowwise``): there a temperature <= 0 divides by 1, a
    top-k <= 0 and a top-p outside (0, 1) are off for that row."""
    V = logits.shape[-1]
    if isinstance(temperature, torch.Tensor):
        temperature = torch.where(temperature > 0, temperature, 1.0)[:, None]
    logits = logits / temperature
    if isinstance(top_k, torch.Tensor):
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        kth = sorted_desc.gather(1, torch.clamp(top_k - 1, 0, V - 1)[:, None])
        logits = torch.where((top_k[:, None] > 0) & (logits < kth), float("-inf"), logits)
    elif top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if isinstance(top_p, torch.Tensor):
        # off rows keep every token: no prefix mass reaches 2
        top_p = torch.where((top_p > 0) & (top_p < 1), top_p, 2.0)[:, None]
    elif top_p is None or top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest prefix whose mass reaches top_p (the token that
    # crosses the threshold is included, per nucleus sampling)
    keep = cum - probs < top_p
    cutoff = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, float("-inf"), logits)


def gumbel_noise(shape, generator: torch.Generator, device, rows=None) -> torch.Tensor:
    """Gumbel noise from ``generator``: argmax(logits + noise) is a draw
    from softmax(logits), as ``jax.random.categorical`` samples. ``rows``,
    ``(first, total)``: draw the noise of a ``[total, ...]`` batch and keep
    rows ``[first, first + shape[0])``, so a rank holding a block of the
    batch draws what one device would draw for those rows."""
    if rows is not None:
        first, total = rows
        return gumbel_noise((total, *shape[1:]), generator, device)[first : first + shape[0]]
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_logits(
    logits: torch.Tensor,  # [B, V] float32
    generator: Optional[torch.Generator],
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    rows=None,
) -> torch.Tensor:
    """Sample next-token ids [B] from final-position logits. Greedy
    ignores ``generator``; sampling draws Gumbel noise from it (``rows``:
    see ``gumbel_noise``)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a torch.Generator")
    noise = gumbel_noise(logits.shape, generator, logits.device, rows)
    return torch.argmax(logits + noise, dim=-1)


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
    mesh=None,
) -> dict[str, torch.Tensor]:
    """Autoregressive generation on ``prompt_tokens``' device.

    Returns ``{"tokens": [B, max_new_tokens], "lengths": [B]}`` where
    ``lengths`` counts generated tokens up to and including the first
    ``eos_id`` (or ``max_new_tokens`` when eos never fires); positions
    past a row's eos hold ``pad_id``.

    Under ``mesh`` every rank passes the whole prompt batch and its shards
    of the params (``param_specs``); it decodes its (data, fsdp) block on
    the mesh's device and returns the whole result, the same on every rank.
    """
    rows = None
    if mesh is not None:
        check_serving_mesh(mesh, family_forward(cfg)[0], prompt_tokens.shape[0])
        index, n = batch_block(mesh)
        total = prompt_tokens.shape[0]
        rows = (index * (total // n), total)
        if prompt_lengths is not None:
            prompt_lengths = local_shard(torch.as_tensor(prompt_lengths), mesh,
                                         P(SERVE_BATCH_AXES))
        prompt_tokens = local_shard(prompt_tokens, mesh, P(SERVE_BATCH_AXES)).to(mesh.device)
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
        temperature=gen_cfg.temperature, top_k=gen_cfg.top_k, top_p=gen_cfg.top_p, rows=rows
    )

    cache_cfg, fwd = family_forward(cfg)
    if mesh is None:
        cache = init_cache(cache_cfg, B, max_len, gen_cfg.cache_dtype, device=dev)
        sharded = {}
    else:
        cache = init_cache(cache_cfg, rows[1], max_len, gen_cfg.cache_dtype, mesh=mesh)
        sharded = {"mesh": mesh}
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
        **sharded,
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
            **sharded,
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
    if mesh is not None:
        group = mesh.group(SERVE_BATCH_AXES)
        tokens, lengths = col.gather_dim(tokens, group, 0), col.gather_dim(lengths, group, 0)
    return {"tokens": tokens, "lengths": lengths}
