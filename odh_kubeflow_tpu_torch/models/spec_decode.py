"""Speculative decoding: draft-model proposals, one target verification
(counterpart of ``models/spec_decode.py``).

Decode streams the whole weight set for every token. A small draft
model proposes ``k`` tokens; the target scores all of them in one cached
forward ``k + 1`` tokens wide and accepts the longest prefix that matches
its own greedy choices, plus one token of its own. Greedy speculative
decoding is exact: the stream equals the target decoding alone; the
draft only changes how often the target's weights are read.

- The reference's ``lax.while_loop`` is a Python loop over rounds here.
  A round's accept length reaches the host once (one sync a round), and
  the host then knows every cache offset of the next round, so the
  forwards take plain integer offsets.
- Rejected proposals leave stale cache entries behind the masked
  horizon: ``kv_mask`` and the causal offset keep them from being
  attended, so the cache is never rewound.

Single stream (B = 1): per-row accept lengths need per-row offsets,
which the engine (``models/engine.py``) has.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from odh_kubeflow_tpu_torch.models.generate import family_forward, init_cache

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    max_new_tokens: int = 64
    num_draft_tokens: int = 4  # k
    eos_id: Optional[int] = None
    pad_id: int = 0
    cache_dtype: Any = torch.bfloat16


def speculative_generate(
    target_params: Params,
    target_cfg,
    draft_params: Params,
    draft_cfg,
    prompt_tokens: torch.Tensor,  # [1, S_prompt] integer, right-padded
    spec_cfg: SpecDecodeConfig = SpecDecodeConfig(),
    *,
    prompt_lengths: Optional[torch.Tensor] = None,  # [1] integer
    target_lora: Optional[Params] = None,
    draft_lora: Optional[Params] = None,
) -> dict:
    """Greedy speculative decode on ``prompt_tokens``' device; returns
    ``{"tokens": [1, N], "lengths": [1], "accepted_drafts": int,
    "rounds": int, "sync_s": float}``.

    ``accepted_drafts / (rounds * k)`` is the acceptance rate; a round
    emits 1 to k + 1 tokens, so the target runs ``rounds`` wide forwards
    instead of N narrow ones. ``sync_s`` is the host's time waiting at
    the rounds' syncs. A right-padded prompt decodes from slot
    ``prompt_len`` on, inside the pad region, whose masked slots are
    overwritten before they are ever attended."""
    B, S_prompt = prompt_tokens.shape
    if B != 1:
        raise ValueError(
            "speculative decoding is the single-stream latency path "
            f"(per-row acceptance needs per-row cache offsets); got B={B}"
        )
    t_base, t_fwd = family_forward(target_cfg)
    d_base, d_fwd = family_forward(draft_cfg)
    if t_base.vocab_size != d_base.vocab_size:
        raise ValueError(
            f"draft/target vocab mismatch: {d_base.vocab_size} vs {t_base.vocab_size}"
        )
    dev = prompt_tokens.device
    N, k, pad = spec_cfg.max_new_tokens, spec_cfg.num_draft_tokens, spec_cfg.pad_id
    max_len = S_prompt + N + k + 1  # the verify window may overhang by k
    slots = torch.arange(max_len, device=dev)[None, :]
    plen = S_prompt if prompt_lengths is None else int(prompt_lengths[0])

    t_cache = init_cache(t_base, 1, max_len, spec_cfg.cache_dtype, device=dev)
    d_cache = init_cache(d_base, 1, max_len, spec_cfg.cache_dtype, device=dev)

    # --- prefill both models on the prompt --------------------------------
    positions = torch.arange(S_prompt, device=dev)[None, :]
    prompt_mask = slots < plen
    t_logits, _ = t_fwd(target_params, prompt_tokens, target_cfg, t_cache, 0,
                        positions=positions, kv_mask=prompt_mask, lora=target_lora)
    d_fwd(draft_params, prompt_tokens, draft_cfg, d_cache, 0,
          positions=positions, kv_mask=prompt_mask, lora=draft_lora)
    # the first token: the target's choice after the last real position
    t_cur = torch.argmax(t_logits[:, plen - 1], dim=-1)  # [1]

    out = torch.full((N + k + 1,), pad, dtype=torch.long, device=dev)
    out[0] = t_cur[0]
    idx = torch.arange(k + 1, device=dev)
    n_gen, acc, rounds, done, sync_s = 1, 0, 0, False, 0.0
    while n_gen < N and not done:
        pos = plen + n_gen - 1  # slot of t_cur
        # k + 1 greedy draft steps: the draft also consumes its last
        # proposal, so on full acceptance its cache has no hole
        tok, drafts = t_cur, []
        for i in range(k + 1):
            write = pos + i
            logits, _ = d_fwd(draft_params, tok[None, :], draft_cfg, d_cache, write,
                              positions=torch.full((1, 1), write, device=dev),
                              kv_mask=slots < write + 1, lora=draft_lora)
            tok = torch.argmax(logits[:, 0, :], dim=-1)
            drafts.append(tok)
        drafts = torch.cat(drafts[:k])  # [k]
        # one wide target forward over [t_cur, d_1..d_k] at slots pos..pos+k;
        # choice[j] is the target's token after consuming window[j]
        window = torch.cat([t_cur, drafts])[None, :]
        t_logits, _ = t_fwd(target_params, window, target_cfg, t_cache, pos,
                            positions=pos + idx[None, :], kv_mask=slots < pos + k + 1,
                            lora=target_lora)
        choice = torch.argmax(t_logits[0], dim=-1)  # [k + 1]
        # the longest prefix where the draft matched the target
        accept_t = torch.cumprod((drafts == choice[:k]).long(), dim=0).sum()
        # emitted: d_1..d_accept, then the target's own token
        cand = torch.cat([drafts, drafts.new_zeros(1)])
        emitted = torch.where(idx < accept_t, cand,
                              torch.where(idx == accept_t, choice[accept_t], pad))
        hit = (
            torch.zeros((), dtype=torch.bool, device=dev) if spec_cfg.eos_id is None
            else ((emitted == spec_cfg.eos_id) & (idx <= accept_t)).any()
        )
        out[n_gen : n_gen + k + 1] = emitted
        t0 = time.perf_counter()
        accept, hit = torch.stack([accept_t, hit.long()]).tolist()  # the round's sync
        sync_s += time.perf_counter() - t0
        t_cur = choice[accept : accept + 1]
        n_gen += accept + 1
        acc += accept
        rounds += 1
        done = bool(hit)

    tokens = out[:N][None, :].clone()
    cut = min(n_gen, N)
    if spec_cfg.eos_id is not None:
        is_eos = (tokens[0, :cut] == spec_cfg.eos_id).nonzero()
        if len(is_eos):
            cut = int(is_eos[0, 0]) + 1
    tokens[:, cut:] = pad
    return {
        "tokens": tokens,
        "lengths": torch.tensor([cut], device=dev),
        "accepted_drafts": acc,
        "rounds": rounds,
        "sync_s": sync_s,
    }
