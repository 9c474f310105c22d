"""The port's sharded trainer against the JAX package's on the same mesh.

The JAX ``Trainer`` runs in the test process on four virtual CPU devices
with a ``MeshConfig``; the port's runs on four gloo ranks with the same
``MeshConfig``, each rank given its shards of the JAX trainer's initial
params and adapters. Both take three steps on one numpy batch. Cases:
LoRA at fsdp=4, full fine-tune at data=2 × fsdp=2 and at fsdp=2 ×
tensor=2, QLoRA int4 at fsdp=2 × tensor=2 under remat "attn" (the
gathers and collectives inside checkpointed layers), LoRA at fsdp=2 ×
context=2 (ring attention in the model). float32 throughout. Held to: loss rtol
1e-5, gradient norm rtol 1e-4, each trainable leaf (gathered) after each
step rtol 1e-4 with atol 1e-5 (LoRA) or 1e-3 (full fine-tune: a handful
of weights have gradients at Adam's eps, where the update depends on the
last bits of the sums; ``test_torch_trainer.py`` says the same).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import LlamaConfig as JLlamaConfig
from odh_kubeflow_tpu.models import LoraConfig as JLoraConfig
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.train import TrainConfig as JTrainConfig
from odh_kubeflow_tpu.train import Trainer as JTrainer
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus

TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
STEPS = 3
# (name, mesh axes, LoRA, quantize_base, config overrides)
CASES = [
    ("lora_fsdp4", dict(fsdp=4), True, False, {}),
    ("full_data2_fsdp2", dict(data=2, fsdp=2), False, False, {}),
    ("full_fsdp2_tensor2", dict(fsdp=2, tensor=2), False, False, {}),
    ("qlora_int4_fsdp2_tensor2", dict(fsdp=2, tensor=2), True, "int4",
     dict(remat=True, remat_policy="attn")),
    ("lora_fsdp2_context2", dict(fsdp=2, context=2), True, False, {}),
]


def _batch(B=4, S=16, seed=3, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _np(tree):
    """numpy copies: the JAX trainer donates its state's buffers to the
    next step, and a view would follow them."""
    return jax.tree.map(np.array, tree)


def _port_ranks(rank, world, cases, out_path):
    """Each case on this rank: load the JAX trainer's initial state as
    shards, take the steps; rank 0 saves the losses, norms and gathered
    trainable trees."""
    results = {}
    for name, axes, with_lora, qb, over, params, lora_params, batch in cases:
        mesh = tmesh.build_mesh(tmesh.MeshConfig(**axes), device="cpu")
        tt = Trainer(
            llama.LlamaConfig.tiny(dtype=torch.float32, **over), TrainConfig(**TC),
            lora.LoraConfig(rank=4) if with_lora else None, mesh=mesh, quantize_base=qb,
            device="cpu", metrics_registry=prometheus.Registry(),
        )
        tt.params = tmesh.shard_tree(convert.from_numpy_tree(params, "cpu"), mesh,
                                     tt.param_specs)
        if with_lora:
            tt.lora_params = tmesh.shard_tree(convert.from_numpy_tree(lora_params, "cpu"),
                                              mesh, tt.train_specs)
        tt.opt_state = ttrainer.init_opt_state(tt._trainable())
        steps = []
        for _ in range(STEPS):
            m = tt.train_step(batch)
            tree = tmesh.gather_tree(tt._trainable(), mesh, tt.train_specs)
            # copies: numpy views of CPU tensors follow in-place updates
            tree = jax.tree.map(np.copy, convert.to_numpy_tree(tree))
            steps.append((float(m["loss"]), float(m["grad_norm"]), tree))
        results[name] = steps
    if rank == 0:
        torch.save(results, out_path)


def test_sharded_trainer_matches_jax_on_each_mesh(tmp_path):
    devices = jax.devices()
    assert len(devices) >= 4
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cases, want = [], {}
    for name, axes, with_lora, qb, over in CASES:
        jt = JTrainer(
            JLlamaConfig.tiny(dtype=jnp.float32, **over), JTrainConfig(**TC), JLoraConfig(rank=4) if with_lora else None,
            mesh=jbuild_mesh(JMeshConfig(**axes), devices[:4]), quantize_base=qb,
        )
        if with_lora:  # nonzero adapters, so the adapters' products matter from step 1
            rng = np.random.default_rng(5)
            jt.lora_params = jax.tree.map(
                lambda x: jax.device_put(
                    rng.standard_normal(x.shape).astype(np.float32) * 0.1 if x.ndim == 3
                    and x.shape[1] == 4 else np.asarray(x), x.sharding),
                jt.lora_params,
            )
        cases.append((name, axes, with_lora, qb, over, _np(jt.params),
                      _np(jt.lora_params) if with_lora else None, batch))
        steps = []
        for _ in range(STEPS):
            m = jt.train_step(jbatch)
            tree = jt.lora_params if with_lora else jt.params
            steps.append((float(m["loss"]), float(m["grad_norm"]), _np(tree)))
        want[name] = steps

    out = tmp_path / "port.pt"
    spawn_cpu_ranks(_port_ranks, 4, cases, str(out), rendezvous_dir=str(tmp_path))
    got = torch.load(out, weights_only=False)

    for name, _, with_lora, _, _ in CASES:
        atol = 1e-5 if with_lora else 1e-3
        for i, ((gl, gn, gtree), (wl, wn, wtree)) in enumerate(zip(got[name], want[name])):
            np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"{name} step {i}")
            np.testing.assert_allclose(gn, wn, rtol=1e-4, err_msg=f"{name} step {i}")
            for g, w in zip(jax.tree.leaves(gtree), jax.tree.leaves(wtree)):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol,
                                           err_msg=f"{name} step {i}")
        if with_lora:  # the adapters moved
            start = next(c[6] for c in cases if c[0] == name)
            assert not np.array_equal(jax.tree.leaves(got[name][-1][2])[0],
                                      jax.tree.leaves(start)[0])


@pytest.mark.parametrize("quantize_base", [False, "int4"], ids=["f32", "int4"])
def test_param_specs_match_jax(quantize_base):
    """The port's param, quantized and adapter specs are the JAX
    package's, spec for spec."""
    from odh_kubeflow_tpu.models import llama as jllama
    from odh_kubeflow_tpu.models import lora as jlora
    from odh_kubeflow_tpu.models import quant as jquant

    for tie in (False, True):
        jcfg = dataclasses.replace(JLlamaConfig.tiny(), tie_embeddings=tie)
        tcfg = llama.LlamaConfig.tiny(tie_embeddings=tie)
        jspecs, tspecs = jllama.param_specs(jcfg), llama.param_specs(tcfg)
        if quantize_base:
            jspecs = jquant.quantized_param_specs(jspecs, bits=4)
            from odh_kubeflow_tpu_torch.models.quant import quantized_param_specs

            tspecs = quantized_param_specs(tspecs, bits=4)
        is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
        jl = jax.tree.leaves_with_path(jspecs, is_leaf=is_spec)
        tl = ttrainer._leaves(tspecs)
        assert [jax.tree_util.keystr(p) for p, _ in jl] == [
            "".join(f"['{k}']" for k in p) for p, _ in tl
        ]
        for (_, j), (_, t) in zip(jl, tl):
            assert tuple(j) == tuple(t)
    jl = jlora.lora_specs(jcfg, JLoraConfig(rank=4))
    tl = lora.lora_specs(tcfg, lora.LoraConfig(rank=4))
    for name, ab in jl["layers"].items():
        assert {k: tuple(v) for k, v in ab.items()} == {
            k: tuple(v) for k, v in tl["layers"][name].items()
        }
