"""The expert-parallel full fine-tune at data=4 against the JAX package's.

The grouped MoE full fine-tune of ``tests/test_torch_pipeline_moe_trainer.py``
(``mixtral_tiny``, float32, its 8 × 512 batch, the router × 16, lr 1e-3)
runs unpipelined at data=4: four gloo ranks against JAX's ``Trainer`` on
four virtual CPU devices, from JAX's initial state. Each rank's (data,
fsdp) group holds 1,024 tokens, 2,048 assignments: the expert-parallel
grouped path (``models/moe.py`` ``_moe_mlp_grouped_ep``), its aux sums
psum'd over data.

Held: the first step's gradients leaf by leaf (1e-4 of each leaf's largest
element) and three steps (``check_steps``: loss 1e-5, gradient norm
1e-4); the gradients at data=4 against the one-device gradients, in each
package (1e-5 of the largest element); the router's gradient of the aux
alone at data=4 against JAX's one-device gradient (1e-4 of its largest
element, as every gradient through the whole model here).

A gap of 5.1e-4 in this model's first gradient norm was once read between
this path and JAX's. It was the reference, not the port: JAX's pipelined
trainer takes the mean of the microbatches' router auxes (the load-balancing
loss is not linear in the batch), and the unpipelined path had been held
against that per-microbatch value. ``test_the_gap_was_the_per_microbatch_aux``
pins it: JAX's per-microbatch loss (``_PerMicrobatch``, 2 microbatches)
reads its norm 5e-4 off JAX's whole-batch norm, and the port's data=4 norm
is JAX's whole-batch one. One spawn of four ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.train import TrainConfig as JTrainConfig
from odh_kubeflow_tpu.train import Trainer as JTrainer
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import moe
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_pipeline_trainer import (
    FULL_ROUTER_GAIN,
    JMOE,
    MARGIN,
    STEPS,
    TC,
    TMOE,
    _PerMicrobatch,
    check_steps,
)

WORLD = 4
AXES = dict(data=4)
B, S = 8, 512
LR = 1e-3
TRAIN = dict(TC, learning_rate=LR)


def _batch():
    toks = np.random.default_rng(3).integers(0, 256, (B, S)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _np(tree):
    return jax.tree.map(np.array, tree)


def _jtrainer(axes, start=None, cls=JTrainer, **train):
    n = int(np.prod(list(axes.values()))) if axes else 1
    jt = cls(JMOE, JTrainConfig(**TRAIN, **train), None,
             mesh=jbuild_mesh(JMeshConfig(**axes), jax.devices()[:n]), seed=8)
    if start is None:
        jt.params["layers"]["router"] = jt.params["layers"]["router"] * FULL_ROUTER_GAIN
    else:
        jt.params = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding), start, jt.params)
    return jt


def _jgrads(jt, batch):
    with jax.set_mesh(jt.mesh):
        return jax.tree.leaves(_np(jax.jit(jax.grad(jt._loss_fn))(jt.params, None, batch)))


@pytest.fixture(scope="module")
def jax_ref():
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    one = _jtrainer({})
    start = _np(one.params)
    out = {"start": start, "one_grads": _jgrads(one, batch)}
    with jax.set_mesh(one.mesh):
        out["router_aux"] = np.asarray(jax.jit(jax.grad(
            lambda p: jmoe.forward(p, batch["tokens"], JMOE)[1]))(one.params)["layers"]["router"])
    jt = _jtrainer(AXES, start)
    steps = []
    for _ in range(STEPS):
        grads = _jgrads(jt, batch)
        m = jt.train_step(batch)
        steps.append((float(m["loss"]), float(m["grad_norm"]), _np(jt.params), grads))
    out["steps"] = steps
    per_mb = _jtrainer(AXES, start, _PerMicrobatch, pipeline_microbatches=2)
    out["per_microbatch_norm"] = float(per_mb.train_step(batch)["grad_norm"])
    return out


def _port_ranks(rank, world, start, out_path):
    seen = []
    stats = moe._routing_stats

    def spy(logits, cfg, token_mask=None):
        z = logits.detach().float().sort(-1, descending=True).values
        seen.append(float((z[..., :2] - z[..., 1:3]).min()))
        return stats(logits, cfg, token_mask)

    moe._routing_stats = spy
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**AXES), device="cpu")
    tt = Trainer(TMOE, TrainConfig(**TRAIN), None, mesh=mesh, device="cpu",
                 metrics_registry=prometheus.Registry())
    tt.params = tmesh.shard_tree(convert.from_numpy_tree(start, "cpu"), mesh, tt.param_specs)
    tt.opt_state = ttrainer.init_opt_state(tt._trainable())
    res = {}
    # the router's gradient of the aux alone: each rank's share is aux / 4
    router = tt.params["layers"]["router"].requires_grad_(True)
    tokens = tmesh.local_shard(torch.from_numpy(_batch()["tokens"]).long(), mesh,
                               tmesh.batch_spec())
    _, aux = moe.forward(tt.params, tokens, TMOE, mesh=mesh)
    (g,) = torch.autograd.grad(aux / WORLD, router)
    res["router_aux"] = col.all_reduce_sum(g, mesh.group(tmesh.AXIS_DATA)).numpy()
    router.requires_grad_(False)
    steps = []
    for _ in range(STEPS):
        _, grads = tt.gradients(_batch())
        grads = [g.numpy().copy() for g in grads.values()]
        m = tt.train_step(_batch())
        tree = tmesh.gather_tree(tt.params, mesh, tt.param_specs)
        steps.append((float(m["loss"]), float(m["grad_norm"]),
                      jax.tree.map(np.copy, convert.to_numpy_tree(tree)), grads))
    res["steps"] = steps
    res["margin"] = min(seen)
    if rank == 0:
        one = Trainer(TMOE, TrainConfig(**TRAIN), None, device="cpu",
                      metrics_registry=prometheus.Registry())
        one.params = convert.from_numpy_tree(start, "cpu")
        res["one_grads"] = [g.numpy().copy() for g in one.gradients(_batch())[1].values()]
        torch.save(res, out_path)


@pytest.fixture(scope="module")
def port(jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep_full")
    out = tmp / "port.pt"
    spawn_cpu_ranks(_port_ranks, WORLD, jax_ref["start"], str(out), rendezvous_dir=str(tmp))
    res = torch.load(out, weights_only=False)
    assert res["margin"] > 8 * MARGIN, res["margin"]
    return res


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_ep_full_finetune_at_data4_matches_jax(port, jax_ref):
    for g, w in zip(port["steps"][0][3], jax_ref["steps"][0][3]):
        _close(g, w, 1e-4)
    check_steps(port["steps"], jax_ref["steps"], False, jax_ref["start"], lr=LR)


def test_data4_gradients_equal_the_one_device_gradients(port, jax_ref):
    """Each package at data=4 against itself on one device, leaf by leaf."""
    for g, w in zip(port["steps"][0][3], port["one_grads"]):
        _close(g, w, 1e-5)
    for g, w in zip(jax_ref["steps"][0][3], jax_ref["one_grads"]):
        _close(g, w, 1e-5)


def test_router_gradient_of_the_aux_at_data4(port, jax_ref):
    """The aux's sums psum'd over data, and their backward summed too."""
    _close(port["router_aux"], jax_ref["router_aux"], 1e-4)


def test_the_gap_was_the_per_microbatch_aux(port, jax_ref):
    """The 5.1e-4 once read here: JAX's per-microbatch loss against its
    whole-batch loss, not the port against JAX."""
    whole, per_mb = jax_ref["steps"][0][1], jax_ref["per_microbatch_norm"]
    assert 3e-4 < abs(per_mb - whole) / whole < 1e-3
    np.testing.assert_allclose(port["steps"][0][1], whole, rtol=1e-4)
    assert abs(port["steps"][0][1] - per_mb) / per_mb > 3e-4
