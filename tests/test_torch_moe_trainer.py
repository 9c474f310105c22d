"""The port's MoE trainer against the JAX package's, float32: the QLoRA
step and the full fine-tune.

JAX's ``Trainer(MoeConfig.mixtral_tiny(dispatch="grouped",
pin_expert_acts=True), lora r4, quantize_base=True)`` runs on a
one-device CPU mesh (its grouped-matmul Pallas kernels in interpret
mode); the port's ``Trainer(..., device="cpu")`` runs beside it with
JAX's int8 base and adapters carried across. Three steps, each holding
the loss, every adapter gradient, the gradient norm and the adapters
after the update to rtol 1e-4 (sums in another order; Adam divides by
the root of the second moment). The smallest top-2 router margin of the
port's tokens is asserted above 1e-4 (``tests/test_torch_moe.py``).

The full fine-tune (``lora_cfg=None``) trains every leaf, the expert
banks through the float grouped path (JAX's ``gmm`` and ``_tgmm`` in
interpret mode): three steps, the loss per step to 1e-5 relative and
every leaf to 1e-3 absolute, a tenth of one step at lr 1e-2 (a few of
the weights have gradients at Adam's eps scale, where the normalised
update depends on the last bits of the sums; ``tests/test_torch_trainer.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.models.llama import LlamaConfig as JLlamaConfig
from odh_kubeflow_tpu.models.lora import LoraConfig as JLoraConfig
from odh_kubeflow_tpu.models.quant import quantize_tensor as jquantize
from odh_kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from odh_kubeflow_tpu.train import TrainConfig as JTrainConfig
from odh_kubeflow_tpu.train import Trainer as JTrainer
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora, moe
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_moe import MARGIN, ROUTER_GAIN, margins  # noqa: F401

TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
JCFG = jmoe.MoeConfig.mixtral_tiny(base=JLlamaConfig.tiny(dtype=jnp.float32),
                                   dispatch="grouped", pin_expert_acts=True)
TCFG = moe.MoeConfig.mixtral_tiny(base=llama.LlamaConfig.tiny(dtype=torch.float32),
                                  dispatch="grouped", pin_expert_acts=True)
B, S = 2, 512  # B·S·k = 2048: the grouped path engages


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jt = JTrainer(JCFG, JTrainConfig(**TC), JLoraConfig(rank=4),
                  mesh=build_mesh(MeshConfig(), jax.devices()[:1]), quantize_base=True, seed=8)
    # the random base draws every weight ~ N(0, 0.02²), norms included,
    # which packs the router logits together; unit MLP norms and a wider
    # router (int8, from a numpy seed) spread them: top-2 margins ≥ 4e-3
    layers = jt.params["layers"]
    layers["mlp_norm"] = jnp.ones_like(layers["mlp_norm"])
    router = np.random.default_rng(105).standard_normal((2, 64, 4)).astype(np.float32) * 0.2
    layers["router"] = jquantize(jnp.asarray(router))
    tt = Trainer(TCFG, TrainConfig(**TC), lora.LoraConfig(rank=4), quantize_base=True,
                 device="cpu", metrics_registry=prometheus.Registry())
    tt.params = convert.from_numpy_tree(_np(jt.params), device="cpu")
    tt.lora_params = convert.from_numpy_tree(_np(jt.lora_params), device="cpu")
    return jt, tt


def test_moe_qlora_steps_match_jax(pair, monkeypatch):
    jt, tt = pair
    assert tt.params["layers"]["moe_gate"]["q"].dtype == torch.int8
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    seg = np.repeat((np.arange(S) >= 190).astype(np.int32)[None] + 1, B, 0)
    seg[0, -40:] = 0  # padding: no expert row, no aux mass, no loss
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1), "segment_ids": seg,
             "loss_mask": (seg > 0).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    margins = []
    stats = moe._routing_stats

    def spy(logits, cfg, token_mask=None):
        live = logits if token_mask is None else logits[token_mask]
        z = live.detach().sort(-1, descending=True).values
        margins.append(float((z[..., :2] - z[..., 1:3]).min()))
        return stats(logits, cfg, token_mask)

    monkeypatch.setattr(moe, "_routing_stats", spy)
    with jax.set_mesh(jt.mesh):
        jgrad = jax.jit(jax.value_and_grad(jt._loss_fn))
    fused = gm.swiglu_fwd_launches, gm.gmm_launches
    for _ in range(3):
        with jax.set_mesh(jt.mesh):
            jloss, jg = jgrad(jt.lora_params, jt.params, jbatch)
        loss, grads = tt.gradients(batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        jleaves = dict(zip([p for p, _ in ttrainer._leaves(tt.lora_params)],
                           jax.tree.leaves(_np(jg))))
        for path, g in grads.items():
            np.testing.assert_allclose(g.numpy(), jleaves[path], rtol=1e-4,
                                       atol=1e-4 * np.abs(jleaves[path]).max() + 1e-9)
        jm = jt.train_step(jbatch)
        tm = tt.train_step(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        for g, w in zip(jax.tree.leaves(convert.to_numpy_tree(tt.lora_params)),
                        jax.tree.leaves(_np(jt.lora_params))):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert min(margins) > 1e-4
    assert float(tt.lora_params["layers"]["wq"]["b"].abs().max()) > 0
    # CPU tensors take the plain versions: no kernel launched
    assert (gm.swiglu_fwd_launches, gm.gmm_launches) == fused


def _batch(seed=6):
    toks = np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)
    seg = np.repeat((np.arange(S) >= 190).astype(np.int32)[None] + 1, B, 0)
    seg[0, -40:] = 0  # padding: no expert row, no aux mass, no loss
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1), "segment_ids": seg,
            "loss_mask": (seg > 0).astype(np.float32)}


def test_moe_full_finetune_steps_match_jax(margins):  # noqa: F811
    jt = JTrainer(JCFG, JTrainConfig(**TC), None,
                  mesh=build_mesh(MeshConfig(), jax.devices()[:1]), seed=8)
    jt.params["layers"]["router"] = jt.params["layers"]["router"] * ROUTER_GAIN
    tt = Trainer(TCFG, TrainConfig(**TC), None, device="cpu",
                 metrics_registry=prometheus.Registry())
    tt.params = convert.from_numpy_tree(_np(jt.params), device="cpu")
    start = {p: t.clone() for p, t in ttrainer._leaves(tt.params)}
    assert tt.params["layers"]["moe_gate"].dtype == torch.float32
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jm = jt.train_step(jbatch)
        tm = tt.train_step(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        for g, w in zip(jax.tree.leaves(convert.to_numpy_tree(tt.params)),
                        jax.tree.leaves(_np(jt.params))):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    assert min(margins) > MARGIN
    # a full fine-tune trains every leaf: norms, router and the three banks too
    for path, t in ttrainer._leaves(tt.params):
        assert not torch.equal(t.detach(), start[path]), path


def test_moe_trainer_refuses_mlp_targets_and_counts_strict_sparse_flops(pair):
    jt, tt = pair
    with pytest.raises(ValueError, match="attention projections only"):
        Trainer(TCFG, lora_cfg=lora.LoraConfig(targets=("wq", "w_gate")), device="cpu")
    with pytest.raises(ValueError):
        JTrainer(JCFG, lora_cfg=JLoraConfig(targets=("wq", "w_gate")),
                 mesh=build_mesh(MeshConfig(), jax.devices()[:1]))
    out = tt.benchmark(2, 512, steps=1, warmup=1)
    tokens = 2 * 512
    want = (2 * JCFG.flops_per_token(512) + JCFG.attn_flops_per_token(512)) * tokens
    assert out["model_flops_per_step"] == want
    assert out["train_equiv_flops_per_s"] * out["step_time_s"] == pytest.approx(
        3 * JCFG.flops_per_token(512) * tokens)
    assert tt.make_fake_batch(1, 8)["tokens"].max() < TCFG.vocab_size
    with pytest.raises(NotImplementedError, match="multi-device parallelism"):
        Trainer(TCFG, lora_cfg=lora.LoraConfig(), mesh=object(), device="cpu")


def test_moe_long_sequence_takes_the_chunked_loss_with_the_aux(monkeypatch):
    cfg = dataclasses.replace(TCFG, dispatch="einsum")
    tt = Trainer(cfg, TrainConfig(warmup_steps=1, total_steps=4), lora.LoraConfig(rank=2),
                 device="cpu", metrics_registry=prometheus.Registry())
    batch = tt.make_fake_batch(1, 3072)
    seen = []
    chunked = ttrainer.chunked_cross_entropy
    monkeypatch.setattr(ttrainer, "chunked_cross_entropy",
                        lambda *a, **k: seen.append(1) or chunked(*a, **k))
    with torch.no_grad():
        logits, aux = moe.forward(tt.params, batch["tokens"], cfg, lora=tt.lora_params)
        dense = ttrainer.cross_entropy_loss(logits, batch["targets"]) + aux
    np.testing.assert_allclose(float(tt.eval_step(batch)["loss"]), float(dense), rtol=1e-5)
    assert seen == [1] and float(aux) > 0
