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

Under a mesh (``Trainer(mesh=build_mesh(...))``, one process per card)
each rank initialises, holds and updates only its shards of the params,
the adapters and the Adam moments (the JAX package's specs), trains on
its block of the batch (``train/data.py`` ``shard_batch``), and the
model code issues the collectives (``models/llama.py``). The loss is
the mean over the global count of target tokens; each gradient is summed
over the data, fsdp, expert and context axes it is not sharded over (a
sharded leaf's fsdp sum is its gather's reduce-scatter); the global norm
sums each leaf's squares over its shards once. A grouped MoE runs
expert-parallel (``models/moe.py``): its banks shard over ``expert`` and
sum their gradients over data and fsdp only, and each rank's loss share
carries its part of the router aux, so the aux enters the summed loss
once. The ragged and einsum dispatches shard their banks over expert,
fsdp and tensor, as JAX's ``param_specs`` do. With ``pipe > 1`` each rank also holds only its pipeline stage's
layers (``_pipe_shard_layer_specs``), initialised alone, and the layer
stack runs through GPipe (``parallel/pipeline.py``) on
``TrainConfig.pipeline_microbatches`` microbatches, each rank's block of
the batch taken microbatch-major. The embedding, final norm and head run
on every stage, each stage's loss share is divided by the stage count, and
the replicated leaves' gradients are summed over ``pipe`` as over the
token axes: the embedding's arrive on stage 0 alone, the head's as equal
parts on every stage, and every replica takes the same step.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from odh_kubeflow_tpu_torch.models import llama
from odh_kubeflow_tpu_torch.models import lora as lora_lib
from odh_kubeflow_tpu_torch.models import moe as moe_lib
from odh_kubeflow_tpu_torch.models.quant import (
    quantized_param_specs,
    streaming_quantized_init,
)
from odh_kubeflow_tpu_torch.ops import _build
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel import mesh as mesh_lib
from odh_kubeflow_tpu_torch.train.data import shard_batch
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
    # microbatches per GPipe schedule when the mesh shards `pipe` (the
    # bubble is (S-1)/(M+S-1)); must divide the batch
    pipeline_microbatches: int = 8


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


def _vocab_logsumexp(logits: torch.Tensor, tp) -> torch.Tensor:
    """logsumexp over the vocab, whose columns are split over ``tp``: the
    max and the sum of exponentials all-reduced (the sum's backward is
    the identity: every rank computes the same loss)."""
    if tp is None:
        return torch.logsumexp(logits, dim=-1)
    m = col.all_reduce_max(logits.amax(-1), tp)
    return torch.log(col.all_reduce(torch.exp(logits - m[..., None]).sum(-1), tp)) + m


def _local_targets(t: torch.Tensor, v0: int, n: int):
    """Targets as indices into this rank's ``n`` vocab columns from
    ``v0`` (clamped) and whether each lies there."""
    local = t - v0
    return local.clamp(0, n - 1), (local >= 0) & (local < n)


def _chunk_nll(h, head, t, m, z_loss: float, tp=None, v0: int = 0):
    """One chunk's (sum of masked nll, sum of mask). Under ``tp`` the head
    holds this rank's vocab columns from ``v0``."""
    logits = llama.f32_product(h, head.to(h.dtype))  # [B, c, V] f32
    logz = _vocab_logsumexp(logits, tp)
    # the target logit from a gather of head columns and a row-wise dot,
    # not from the [B, c, V] logits; the columns are rounded to the
    # activation dtype first, as the logits' head is, so nll is not biased
    if tp is not None:
        t, hit = _local_targets(t, v0, head.shape[1])
    ht = head.index_select(1, t.reshape(-1)).to(h.dtype)  # [D, B*c]
    ht = ht.T.reshape(h.shape).to(torch.float32)
    target = (h.to(torch.float32) * ht).sum(-1)
    if tp is not None:
        target = col.all_reduce(target * hit, tp)
    nll = logz - target
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
    nll_sum, mask_sum = chunked_nll_sums(hidden, head, targets, loss_mask, z_loss, chunk)
    return nll_sum / torch.clamp(mask_sum, min=1.0)


def chunked_nll_sums(hidden, head, targets, loss_mask=None, z_loss=0.0, chunk=1024,
                     tp=None, v0: int = 0):
    """``chunked_cross_entropy``'s (sum of masked nll, sum of mask); under
    ``tp`` the head holds this rank's vocab columns from ``v0``."""
    B, S, _ = hidden.shape
    if S % chunk:
        raise ValueError(f"chunk {chunk} must divide sequence length {S}")
    if loss_mask is None:
        loss_mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    nll_sum = mask_sum = 0.0
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (hidden[:, sl], head, targets[:, sl].long(), loss_mask[:, sl], z_loss, tp, v0)
        if torch.is_grad_enabled():
            a, b = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            a, b = _chunk_nll(*args)
        nll_sum = nll_sum + a
        mask_sum = mask_sum + b
    return nll_sum, mask_sum


def nll_sums(logits, targets, loss_mask=None, z_loss=0.0, tp=None, v0: int = 0):
    """``cross_entropy_loss``'s (sum of masked nll, sum of mask) on this
    rank's vocab columns of the logits (from ``v0``) under ``tp``."""
    logz = _vocab_logsumexp(logits, tp)
    t, hit = _local_targets(targets.long(), v0, logits.shape[-1])
    target = logits.gather(-1, t[..., None])[..., 0]
    if tp is not None:
        target = col.all_reduce(target * hit, tp)
    nll = logz - target
    if z_loss:
        nll = nll + z_loss * logz.square()
    m = torch.ones_like(nll) if loss_mask is None else loss_mask.to(torch.float32)
    return (nll * m).sum(), m.sum()


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


def sharded_global_norm(tensors, specs, mesh) -> torch.Tensor:
    """The global norm of the whole gradients whose local shards are
    ``tensors``: each leaf's squares summed over the ranks it is sharded
    across, once; a leaf replicated across a group counts once."""
    keys = []
    for spec in specs:
        axes = tuple(a for a in mesh_lib.AXIS_ORDER if a in mesh_lib.spec_axes(spec))
        keys.append(axes if mesh.group(axes) is not None else ())
    if not any(keys):
        return global_norm(tensors)  # nothing sharded: the one-device sum
    buckets: dict = {}
    for t, axes in zip(tensors, keys):
        buckets.setdefault(axes, []).append(t.to(torch.float32).square().sum())
    total = sum(col.all_reduce_sum(sum(sqs), mesh.group(axes))
                for axes, sqs in sorted(buckets.items()))
    return torch.sqrt(total)


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


def _world_group():
    """The default group, or None for a single process."""
    return dist.group.WORLD if dist.get_world_size() > 1 else None


# the axes a loss share is taken over: every token axis, and the pipe
# stages, each of which computes the head on the whole output
SHARE_AXES = mesh_lib.TOKEN_AXES + (mesh_lib.AXIS_PIPE,)


def _grad_axes(spec) -> tuple:
    """The axes a gradient sums over after the backward: the share axes
    its leaf is not sharded over (a sharded leaf's fsdp sum is its
    gather's reduce-scatter; tensor-replicated leaves see equal
    gradients on every tensor rank; a replicated leaf sums its stages'
    parts)."""
    sharded = mesh_lib.spec_axes(spec)
    return tuple(a for a in SHARE_AXES if a not in sharded)


def _pipe_shard_layer_specs(spec_tree):
    """Every spec under a ``layers`` subtree with its leading (layer) dim
    over ``pipe``: a rank holds its stage's layers."""

    def walk(tree, in_layers):
        if isinstance(tree, dict):
            return {k: walk(v, in_layers or k == "layers") for k, v in tree.items()}
        if not in_layers:
            return tree
        return mesh_lib.P(mesh_lib.AXIS_PIPE, *tuple(tree)[1:])

    return walk(spec_tree, False)


def _keep_shard(mesh, specs):
    """``keep`` for the inits: this rank's shard of a drawn leaf (or of
    one layer of a ``layers`` leaf, whose spec drops the layer axis)."""

    def keep(path, t, per_layer):
        spec = specs
        for k in path:
            spec = spec[k]
        return mesh_lib.local_shard(t, mesh, spec[1:] if per_layer else spec).contiguous()

    return keep


class Trainer:
    """Owns the device, the parameters, the optimizer state and the step.

    ``lora_cfg=None`` trains every parameter; otherwise the base is frozen
    (float, or int8/int4 with ``quantize_base``) and only the adapters
    train; on a MoE model they attach to the attention projections only.
    Without a mesh it trains on ``device``, the card by default; with a
    ``parallel.mesh.Mesh`` (data, fsdp, tensor, context and pipe axes for
    a Llama config; for a MoE the same, plus expert, where JAX's dispatch
    decisions allow: a grouped MoE's large batches take data, fsdp,
    expert and pipe) each rank trains its shards on the mesh's device,
    with ``pipe > 1`` its pipeline stage's layers."""

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
        # point the kernels' build directory at the platform's mounted
        # cache before any kernel loads — no-op unless
        # ODH_TORCH_KERNEL_CACHE is set (warmup/ subsystem)
        from odh_kubeflow_tpu_torch.warmup.compilecache import install_process_cache

        install_process_cache()
        self.is_moe = isinstance(model_cfg, moe_lib.MoeConfig)
        if not (self.is_moe or isinstance(model_cfg, llama.LlamaConfig)):
            raise TypeError(
                f"model_cfg must be a LlamaConfig or a MoeConfig, got {type(model_cfg).__name__}"
            )
        if mesh is not None:
            if not isinstance(mesh, mesh_lib.Mesh):
                raise TypeError(
                    f"mesh must be a parallel.mesh.Mesh (build_mesh), got {type(mesh).__name__}"
                )
            device = mesh.device
        self.mesh = mesh
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

        self.param_specs = self.train_specs = None
        self.stages = 1 if mesh is None else mesh.sizes[mesh_lib.AXIS_PIPE]
        keep = layers = None
        if mesh is not None:
            self.param_specs = (moe_lib if self.is_moe else llama).param_specs(model_cfg)
            if quantize_base:
                self.param_specs = quantized_param_specs(self.param_specs, self.quant_bits)
            self.train_specs = (
                self.param_specs if lora_cfg is None
                else lora_lib.lora_specs(self.base_cfg, lora_cfg)
            )
            if self.stages > 1:
                # stage ownership: every stacked per-layer leaf shards its
                # layer dim over pipe, and the init builds only the stage's
                L = self.base_cfg.num_layers
                if L % self.stages:
                    raise ValueError(f"layer dim {L} does not divide into {self.stages} stages")
                self.param_specs = _pipe_shard_layer_specs(self.param_specs)
                self.train_specs = _pipe_shard_layer_specs(self.train_specs)
                n = L // self.stages
                layers = range(mesh.coords[mesh_lib.AXIS_PIPE] * n,
                               (mesh.coords[mesh_lib.AXIS_PIPE] + 1) * n)
            keep = _keep_shard(mesh, self.param_specs)
        init = dict(device=self.device, keep=keep, layers=layers)
        if quantize_base:
            # leaf by leaf: the float tree of the model never exists whole
            self.params = streaming_quantized_init(model_cfg, seed, bits=self.quant_bits, **init)
        elif self.is_moe:
            self.params = moe_lib.init_params(seed, model_cfg, dtype=self.base_cfg.dtype, **init)
        else:
            self.params = llama.init_params(seed, model_cfg, dtype=model_cfg.dtype, **init)
        self.lora_params = None
        if lora_cfg is not None:
            self.lora_params = lora_lib.init_lora_params(
                seed + 1, self.base_cfg, lora_cfg, device=self.device
            )
            if mesh is not None:  # adapters are small: drawn whole, then sharded
                self.lora_params = mesh_lib.shard_tree(self.lora_params, mesh, self.train_specs)
        self.opt_state = init_opt_state(self._trainable())
        self.step = 0

    def _trainable(self) -> Params:
        return self.lora_params if self.lora_cfg is not None else self.params

    # -- loss -----------------------------------------------------------------

    def _batch(self, batch: dict) -> dict:
        """The batch on the device; under a mesh, this rank's block of the
        global batch."""
        types = {"loss_mask": torch.float32, "segment_ids": torch.int32}
        if self.mesh is not None:
            B, S = batch["tokens"].shape
            M = None
            if self.stages > 1:
                M = self.train_cfg.pipeline_microbatches
                if B % M:
                    raise ValueError(f"batch {B} not divisible by pipeline_microbatches={M}")
            if self.is_moe:  # JAX's refusals of the global (micro)batch, before the split
                D = self.base_cfg.hidden_size
                moe_lib.dispatch_path(torch.empty((B // (M or 1), S, D), device="meta"),
                                      self.model_cfg, self.mesh)
            batch = shard_batch(batch, self.mesh, microbatches=M)
        return {
            k: torch.as_tensor(v).to(self.device, types.get(k, torch.long), non_blocking=True)
            for k, v in batch.items()
        }

    def _loss_fn(self, trainable: Params, batch: dict) -> torch.Tensor:
        if self.lora_cfg is not None:
            params, lora_params = self.params, trainable
        else:
            params, lora_params = trainable, None
        if self.mesh is not None:
            return self._mesh_loss(params, lora_params, batch)
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

    def _mesh_loss(self, params: Params, lora_params, batch: dict) -> torch.Tensor:
        """This rank's share of the global mean loss: its masked nll sum over
        the global count of target tokens, plus, for a MoE model, the aux
        (the same on every rank) over the number of ranks; with pipe > 1
        every stage computes the same head, so its share is divided by the
        stage count. The ranks' shares sum to the loss, and so do their
        gradients."""
        mesh, cfg = self.mesh, self.base_cfg
        seq_len = batch["tokens"].shape[1] * mesh.sizes[mesh_lib.AXIS_CONTEXT]
        chunked = seq_len > 2048 and seq_len % 1024 == 0
        model = moe_lib if self.is_moe else llama
        out = model.forward(
            params, batch["tokens"], self.model_cfg, lora=lora_params,
            segment_ids=batch.get("segment_ids"), return_hidden=chunked, mesh=mesh,
            pipeline_microbatches=self.train_cfg.pipeline_microbatches,
        )
        out, aux = out if self.is_moe else (out, None)
        par = llama.Sharding(mesh, cfg)
        vocab = dict(tp=par.tp, v0=par.vocab_start(cfg))
        z = self.train_cfg.z_loss
        if chunked:
            nll, count = chunked_nll_sums(
                out, par.head(params, cfg), batch["targets"], batch.get("loss_mask"), z,
                **vocab,
            )
        else:
            nll, count = nll_sums(out, batch["targets"], batch.get("loss_mask"), z, **vocab)
        count = col.all_reduce_sum(count, mesh.group(mesh_lib.TOKEN_AXES))
        loss = nll / torch.clamp(count, min=1.0)
        if aux is not None:
            loss = loss + aux / mesh.size(mesh_lib.TOKEN_AXES)
        return loss / self.stages if self.stages > 1 else loss

    def _reported(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss from this rank's share."""
        if self.mesh is None:
            return loss
        return col.all_reduce_sum(loss, self.mesh.group(SHARE_AXES))

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
        impl = llama.resolved_attention_impl(self.base_cfg, self.device, self.mesh)
        if impl in ("flash", "ring"):
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
        if self.mesh is not None:
            grads = [
                col.all_reduce_sum(g, self.mesh.group(_grad_axes(spec)))
                for g, spec in zip(grads, self._train_spec_leaves())
            ]
        return self._reported(loss.detach()), grads

    def _train_spec_leaves(self) -> list:
        return [s for _, s in _leaves(self.train_specs)]

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
        if self.mesh is None:
            gnorm = global_norm(grads)
        else:
            gnorm = sharded_global_norm(grads, self._train_spec_leaves(), self.mesh)
        apply_optimizer(self.train_cfg, self._trainable(), grads, gnorm, self.opt_state)
        self.step += 1
        self._m_step_time.observe(time.perf_counter() - t_start)
        return {"loss": loss, "grad_norm": gnorm}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Loss on a held-out batch: no gradient, no state touched."""
        self._join_build()
        return {"loss": self._reported(self._loss_fn(self._trainable(), self._batch(batch)))}

    # -- checkpoint / resume ----------------------------------------------------
    #
    # The trainable tree + optimizer state + step round-trip through
    # `train.checkpoint.CheckpointManager`. Base params are NOT saved on the
    # LoRA path: they are frozen and reproducible from the pretrained
    # weights, so adapter checkpoints stay megabytes.

    def _checkpoint_state(self) -> dict:
        return {"trainable": self._trainable(), "opt_state": self.opt_state}

    def _checkpoint_specs(self) -> dict:
        specs = self.train_specs
        return {"trainable": specs, "opt_state": {"count": None, "mu": specs, "nu": specs}}

    def save_checkpoint(self, manager, *, force: bool = False) -> bool:
        """``manager`` is a ``train.checkpoint.CheckpointManager``;
        ``force=True`` bypasses its save_interval_steps policy. Under a mesh
        every rank calls it: the state is gathered whole, rank 0 writes it
        (the call returns when it is written), and any mesh can restore it."""
        if self.mesh is None:
            return manager.save(self.step, self._checkpoint_state(), force=force)
        if not force and self.step % manager.save_interval_steps:
            return False
        state = mesh_lib.gather_tree(self._checkpoint_state(), self.mesh,
                                     self._checkpoint_specs())
        saved = False
        if self.mesh.rank == 0:
            saved = manager.save(self.step, state, force=True)
            # every rank returns once the step is on disk, so any of them
            # may restore it next
            manager.wait_until_finished()
        flag = torch.tensor([float(saved)], device=self.device)
        return bool(col.all_reduce_sum(flag, _world_group()).item())

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> int:
        """Restores trainable + optimizer state onto this trainer's device
        (under a mesh: this rank's shards of it, whatever mesh wrote it);
        returns the restored step."""
        step = manager.latest_step() if step is None else step
        if self.mesh is None:
            state = manager.restore(self._checkpoint_state(), step=step)
        else:
            state = mesh_lib.shard_tree(manager.restore(None, step=step), self.mesh,
                                        self._checkpoint_specs())
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
