"""Training loop for Llama and Mixtral-style MoE models on one GPU: full
fine-tune, LoRA, or QLoRA on an int8/int4 base (counterpart of
``train/trainer.py``).

The JAX trainer compiles one sharded ``train_step`` against a mesh; this
one runs eagerly on one device. The trainable tree (the adapters, or the
whole model) and the optimizer state are plain dicts of tensors, so a
test or a restore assigns ``trainer.lora_params`` the way JAX code
assigns the attribute. The optimizer is the optax chain of
``_make_optimizer`` written out by hand: ``clip_by_global_norm`` then
``adamw`` on a linear-warmup cosine-decay schedule. The forward is
``models/llama.py`` ``forward`` (flash attention and the remat policies
on the card), or for a ``MoeConfig`` ``models/moe.py`` ``forward``, whose
router aux loss is added to the LM loss; sequences longer than 2048 take
the chunked loss, which never builds ``[B, S, V]`` logits.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from odh_kubeflow_tpu_torch.models import llama
from odh_kubeflow_tpu_torch.models import lora as lora_lib
from odh_kubeflow_tpu_torch.models import moe as moe_lib
from odh_kubeflow_tpu_torch.models.quant import streaming_quantized_init
from odh_kubeflow_tpu_torch.ops import _build
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

# step times span ms-scale tiny test models to minutes-long 8B steps (the
# first observation includes the kernel build unless it was started early)
_STEP_TIME_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    z_loss: float = 0.0


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, S, V] float32
    targets: torch.Tensor,  # [B, S] integer
    loss_mask: Optional[torch.Tensor] = None,  # [B, S]
    z_loss: float = 0.0,
) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - target_logit
    if z_loss:
        nll = nll + z_loss * logz.square()
    if loss_mask is None:
        return nll.mean()
    m = loss_mask.to(torch.float32)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def _chunk_nll(h, head, t, m, z_loss: float):
    """One chunk's (sum of masked nll, sum of mask)."""
    logits = llama.f32_product(h, head.to(h.dtype))  # [B, c, V] f32
    logz = torch.logsumexp(logits, dim=-1)
    # the target logit from a gather of head columns and a row-wise dot,
    # not from the [B, c, V] logits; the columns are rounded to the
    # activation dtype first, as the logits' head is, so nll is not biased
    ht = head.index_select(1, t.reshape(-1)).to(h.dtype)  # [D, B*c]
    ht = ht.T.reshape(h.shape).to(torch.float32)
    nll = logz - (h.to(torch.float32) * ht).sum(-1)
    if z_loss:
        nll = nll + z_loss * logz.square()
    m = m.to(torch.float32)
    return (nll * m).sum(), m.sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,  # [B, S, D] model dtype
    head: torch.Tensor,  # [D, V]
    targets: torch.Tensor,  # [B, S] integer
    loss_mask: Optional[torch.Tensor] = None,  # [B, S]
    z_loss: float = 0.0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Cross entropy that never holds the full ``[B, S, V]`` logits: the
    head and the nll run chunk by chunk over the sequence, each chunk
    under ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward and peak memory is one ``[B, chunk, V]`` block. ``chunk``
    must divide S."""
    B, S, _ = hidden.shape
    if S % chunk:
        raise ValueError(f"chunk {chunk} must divide sequence length {S}")
    if loss_mask is None:
        loss_mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    nll_sum = mask_sum = 0.0
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (hidden[:, sl], head, targets[:, sl].long(), loss_mask[:, sl], z_loss)
        if torch.is_grad_enabled():
            a, b = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            a, b = _chunk_nll(*args)
        nll_sum = nll_sum + a
        mask_sum = mask_sum + b
    return nll_sum / torch.clamp(mask_sum, min=1.0)


# ---------------------------------------------------------------------------
# optimizer: optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay))


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), 0.1 * lr)`` at ``count``."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    if count < warmup:  # linear from 0 to peak
        return peak * min(max(count, 0), warmup) / warmup
    decay = max(cfg.total_steps, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else 0.1
    frac = min(count - warmup, decay) / decay
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)


def _leaves(tree, path=()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs in sorted key order, as JAX flattens a dict, so
    two trees of one structure line up whatever their insertion order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(trainable: Params) -> dict:
    """``{"count", "mu", "nu"}``: the step count (optax's schedule and
    Adam counts, which move together) and the two moments, shaped and
    typed like the trainable tree."""
    zeros = lambda t: torch.zeros_like(t, requires_grad=False)  # noqa: E731
    return {"count": 0, "mu": _map(zeros, trainable), "nu": _map(zeros, trainable)}


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.to(torch.float32).square().sum() for t in tensors))


@torch.no_grad()
def apply_optimizer(
    cfg: TrainConfig, trainable: Params, grads: list, gnorm: torch.Tensor, state: dict
) -> None:
    """One update, in place on ``trainable`` and ``state``; ``grads``
    follow ``_leaves(trainable)`` and ``gnorm`` is their global norm."""
    # clip_by_global_norm: rescale only when the norm reaches the limit
    clip = gnorm >= cfg.max_grad_norm
    lr = learning_rate(cfg, state["count"])  # optax's pre-increment count
    count = state["count"] + 1
    bc1, bc2 = 1 - cfg.b1**count, 1 - cfg.b2**count
    params = [t for _, t in _leaves(trainable)]
    mus = [t for _, t in _leaves(state["mu"])]
    nus = [t for _, t in _leaves(state["nu"])]
    for p, g, mu, nu in zip(params, grads, mus, nus):
        g = torch.where(clip, (g / gnorm.to(g.dtype)) * cfg.max_grad_norm, g)
        mu.copy_((1 - cfg.b1) * g + cfg.b1 * mu)
        nu.copy_((1 - cfg.b2) * g.square() + cfg.b2 * nu)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) + cfg.weight_decay * p
        p.copy_(p + (-lr) * update)
    state["count"] = count


# ---------------------------------------------------------------------------


class Trainer:
    """Owns the device, the parameters, the optimizer state and the step.

    ``lora_cfg=None`` trains every parameter; otherwise the base is frozen
    (float, or int8/int4 with ``quantize_base``) and only the adapters
    train; on a MoE model they attach to the attention projections only.
    ``device`` stands where the JAX trainer takes a mesh: one device, the
    card by default."""

    def __init__(
        self,
        model_cfg,  # LlamaConfig or MoeConfig
        train_cfg: TrainConfig = TrainConfig(),
        lora_cfg: Optional[lora_lib.LoraConfig] = None,
        mesh=None,
        seed: int = 0,
        quantize_base: "bool | str" = False,  # True/"int8" or "int4"
        precompile_batch: Optional[tuple] = None,  # (batch, seq[, keys])
        metrics_registry: Optional[prometheus.Registry] = None,
        *,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh needs multi-device parallelism (DeviceMesh/FSDP2), which the "
                "port does not have yet; this trainer runs on one device"
            )
        self.is_moe = isinstance(model_cfg, moe_lib.MoeConfig)
        if not (self.is_moe or isinstance(model_cfg, llama.LlamaConfig)):
            raise TypeError(
                f"model_cfg must be a LlamaConfig or a MoeConfig, got {type(model_cfg).__name__}"
            )
        if self.is_moe and lora_cfg is not None:
            bad = set(lora_cfg.targets) - set(lora_lib.ATTENTION_TARGETS)
            if bad:
                raise ValueError(
                    "MoE LoRA adapts attention projections only (expert banks "
                    f"replace the dense MLP); invalid targets: {sorted(bad)}"
                )
        if quantize_base and lora_cfg is None:
            raise ValueError(
                "quantize_base freezes the base weights as int8/int4 — "
                "it requires LoRA adapters to have anything to train"
            )
        if quantize_base not in (False, True, "int8", "int4"):
            raise ValueError(
                f"quantize_base must be False/True/'int8'/'int4', got {quantize_base!r}"
            )
        self.model_cfg = model_cfg
        # the dense backbone: attention, adapter widths, the lm_head
        self.base_cfg = model_cfg.base if self.is_moe else model_cfg
        self.train_cfg = train_cfg
        self.lora_cfg = lora_cfg
        self.quantize_base = quantize_base
        self.quant_bits = 4 if quantize_base == "int4" else (8 if quantize_base else 0)
        self.device = resolve_device(device)
        self._m_step_time = (metrics_registry or prometheus.default_registry).histogram(
            "train_step_time_seconds",
            "Wall-clock time per train_step call (first call includes the "
            "kernel build unless precompiled)",
            buckets=_STEP_TIME_BUCKETS,
        )
        self._build_thread: Optional[threading.Thread] = None
        self._build_error: Optional[Exception] = None
        if precompile_batch is not None:
            self.precompile_async(*precompile_batch)

        if quantize_base:
            # leaf by leaf: the float tree of the model never exists whole
            self.params = streaming_quantized_init(
                model_cfg, seed, bits=self.quant_bits, device=self.device
            )
        else:
            init = moe_lib.init_params if self.is_moe else llama.init_params
            self.params = init(seed, model_cfg, dtype=self.base_cfg.dtype, device=self.device)
        self.lora_params = (
            lora_lib.init_lora_params(seed + 1, self.base_cfg, lora_cfg, device=self.device)
            if lora_cfg is not None
            else None
        )
        self.opt_state = init_opt_state(self._trainable())
        self.step = 0

    def _trainable(self) -> Params:
        return self.lora_params if self.lora_cfg is not None else self.params

    # -- loss -----------------------------------------------------------------

    def _batch(self, batch: dict) -> dict:
        types = {"loss_mask": torch.float32, "segment_ids": torch.int32}
        return {
            k: torch.as_tensor(v).to(self.device, types.get(k, torch.long), non_blocking=True)
            for k, v in batch.items()
        }

    def _loss_fn(self, trainable: Params, batch: dict) -> torch.Tensor:
        if self.lora_cfg is not None:
            params, lora_params = self.params, trainable
        else:
            params, lora_params = trainable, None
        tokens = batch["tokens"]
        seq_len = tokens.shape[1]
        # long context: never materialise [B, S, V] logits
        chunked = seq_len > 2048 and seq_len % 1024 == 0
        model = moe_lib if self.is_moe else llama
        out = model.forward(
            params, tokens, self.model_cfg, lora=lora_params,
            segment_ids=batch.get("segment_ids"), return_hidden=chunked,
        )
        # MoE: the router's load-balancing loss rides on the LM loss
        out, aux = out if self.is_moe else (out, None)
        if chunked:
            loss = chunked_cross_entropy(
                out, llama.lm_head_weight(params, self.base_cfg), batch["targets"],
                batch.get("loss_mask"), z_loss=self.train_cfg.z_loss,
            )
        else:
            loss = cross_entropy_loss(
                out, batch["targets"], batch.get("loss_mask"), z_loss=self.train_cfg.z_loss
            )
        return loss if aux is None else loss + aux

    # -- kernel build ahead of the first step ----------------------------------

    def precompile_async(
        self,
        batch_size: int,
        seq_len: int,
        keys: tuple = ("tokens", "targets", "loss_mask"),
    ) -> None:
        """Start the one-time set-up of the first step on a background
        thread. In eager PyTorch there is no step to compile: that set-up
        is the build of the CUDA kernels this trainer will launch (int4
        dequant for an int4 base, the flash kernels on the card, the
        grouped-matmul kernels for a grouped MoE and, when its banks
        train, their weight-gradient kernel), so this
        starts ``_build.build`` on them now and ``train_step`` joins it.
        The shape arguments are kept for signature parity. On the CPU
        nothing is built."""
        del batch_size, seq_len, keys
        if self._build_thread is not None or self.device.type != "cuda":
            return
        names = ["int4_dequant"] if self.quant_bits == 4 else []
        if llama.resolved_attention_impl(self.base_cfg, self.device) == "flash":
            names += ["flash_fwd", "flash_bwd"]
        if self.is_moe and self.model_cfg.dispatch == "grouped":
            names += ["gmm", "swiglu_gmm"]
            if self.lora_cfg is None:  # the banks train: their weight gradient
                names += ["tgmm"]

        def work():
            try:
                _build.build(names)
            except Exception as e:  # noqa: BLE001 — re-raised by train_step
                self._build_error = e

        self._build_thread = threading.Thread(target=work, daemon=True)
        self._build_thread.start()

    def _join_build(self) -> None:
        if self._build_thread is not None:
            self._build_thread.join()
        if self._build_error is not None:
            raise RuntimeError("building the CUDA kernels failed") from self._build_error

    # -- steps ----------------------------------------------------------------

    def _loss_and_grads(self, batch: dict):
        self._join_build()
        batch = self._batch(batch)
        trainable = self._trainable()
        leaves = [t for _, t in _leaves(trainable)]
        for t in leaves:
            t.requires_grad_(True)
        loss = self._loss_fn(trainable, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return loss.detach(), grads

    def gradients(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The loss and ``{path: gradient}`` of every trainable leaf for one
        batch, with no update: what ``train_step`` computes before it
        steps the optimizer."""
        loss, grads = self._loss_and_grads(batch)
        paths = [p for p, _ in _leaves(self._trainable())]
        return loss, dict(zip(paths, grads))

    def train_step(self, batch: dict) -> dict:
        """One optimizer step; returns ``{"loss", "grad_norm"}`` (0-d
        tensors on the device: reading them synchronises), the loss before
        the update and the global norm of the raw gradients."""
        t_start = time.perf_counter()
        loss, grads = self._loss_and_grads(batch)
        gnorm = global_norm(grads)
        apply_optimizer(self.train_cfg, self._trainable(), grads, gnorm, self.opt_state)
        self.step += 1
        self._m_step_time.observe(time.perf_counter() - t_start)
        return {"loss": loss, "grad_norm": gnorm}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Loss on a held-out batch: no gradient, no state touched."""
        self._join_build()
        return {"loss": self._loss_fn(self._trainable(), self._batch(batch))}

    # -- checkpoint / resume ----------------------------------------------------
    #
    # The trainable tree + optimizer state + step round-trip through
    # `train.checkpoint.CheckpointManager`. Base params are NOT saved on the
    # LoRA path: they are frozen and reproducible from the pretrained
    # weights, so adapter checkpoints stay megabytes.

    def _checkpoint_state(self) -> dict:
        return {"trainable": self._trainable(), "opt_state": self.opt_state}

    def save_checkpoint(self, manager, *, force: bool = False) -> bool:
        """``manager`` is a ``train.checkpoint.CheckpointManager``;
        ``force=True`` bypasses its save_interval_steps policy."""
        return manager.save(self.step, self._checkpoint_state(), force=force)

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> int:
        """Restores trainable + optimizer state onto this trainer's device;
        returns the restored step."""
        step = manager.latest_step() if step is None else step
        state = manager.restore(self._checkpoint_state(), step=step)
        if self.lora_cfg is not None:
            self.lora_params = state["trainable"]
        else:
            self.params = state["trainable"]
        self.opt_state = state["opt_state"]
        self.step = int(step)
        return self.step

    # -- convenience ------------------------------------------------------------

    def make_fake_batch(self, batch_size: int, seq_len: int, seed: int = 0) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        tokens = torch.randint(
            0, self.model_cfg.vocab_size, (batch_size, seq_len), generator=gen,
            device=self.device,
        )
        return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}

    def benchmark(
        self, batch_size: int, seq_len: int, steps: int = 10, warmup: int = 2
    ) -> dict:
        batch = self.make_fake_batch(batch_size, seq_len)
        for _ in range(max(warmup, 1)):  # >=1: keep the kernel build out of timing
            metrics = self.train_step(batch)
        float(metrics["loss"])  # a host read synchronises the device
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = self.train_step(batch)
        loss = float(metrics["loss"])
        dt = (time.perf_counter() - t0) / steps
        tokens = batch_size * seq_len
        # Useful-FLOPs accounting (strict MFU, the PaLM-paper sense):
        # - full fine-tune: fwd + bwd ≈ 3× forward (dx + dW per matmul);
        # - LoRA / frozen base: dW of every frozen matmul is *not*
        #   computed, so weight matmuls cost 2× (fwd + dx) — but the
        #   attention backward (dQ/dK/dV) is required to reach the
        #   adapters upstream, so the quadratic term still counts 3×.
        # Rematerialisation recompute is never credited; the 3×-based
        # figure is additionally reported as train_equiv_flops_per_s
        # (the 6ND convention most cited "LoRA MFU" numbers use). A MoE
        # model counts its k active experts and the router only
        # (``MoeConfig.flops_per_token``: strict-sparse).
        fpt = self.model_cfg.flops_per_token(seq_len)
        if self.lora_cfg is not None:
            attn_fpt = self.model_cfg.attn_flops_per_token(seq_len)
            flops = (2 * fpt + attn_fpt) * tokens
        else:
            flops = 3 * fpt * tokens
        return {
            "step_time_s": dt,
            "tokens_per_s": tokens / dt,
            "model_flops_per_step": flops,
            "flops_per_s": flops / dt,
            "train_equiv_flops_per_s": 3 * fpt * tokens / dt,
            "loss": loss,
        }
