"""The port's ragged and einsum MoE under a mesh against the JAX package's.

JAX's GSPMD shards both dispatches from the specs (``moe.param_specs``'
non-grouped branch: the banks' E over expert, D over fsdp, F over tensor);
the port runs them on eight gloo ranks with the collectives placed by hand
(``models/moe.py`` ``_moe_mlp_sharded``): each rank's rows gathered over
expert and its sequence over context, every row routed over all E
experts, its own experts' slots run tensor-parallel over F, the expert
shards' outputs reduce-scattered back. JAX runs on eight virtual CPU
devices with the same ``MeshConfig``; the weights are JAX's
``init_params`` carried across by ``convert.py`` (the router scaled by
``ROUTER_GAIN`` so every top-2 margin clears ``MARGIN``: routing is
discontinuous), inputs from a numpy seed, float32. One spawn of eight
ranks computes every case.

Cases: ``moe_mlp`` with "ragged" and with "einsum" at fsdp=2 × expert=2 ×
tensor=2, and "ragged" at expert=2 × context=2 × tensor=2 (the sequence
gathered before routing): the output, the aux and the gradients of
``sum(out²) + aux`` by x, the router and the three banks, and the
router's gradient of the aux alone; ``moe.forward`` with each dispatch at
fsdp=2 × expert=2 × tensor=2 (logits and aux); three QLoRA ``Trainer``
steps of the default (ragged) ``mixtral_tiny`` on an int8 base at data=2
× fsdp=2 × expert=2 against JAX's ``Trainer`` (``tests/test_moe.py``'s
``test_moe_qlora_int8_base_trains`` mesh). Tolerances as
``tests/test_torch_moe_ep.py``'s: outputs and gradients 1e-5 relative to
their largest element, logits 1e-4, aux 1e-6 (1e-5 through the whole
forward); the trainer as ``tests/test_torch_pipeline_trainer.py``'s
``check_steps``.
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
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.train import TrainConfig as JTrainConfig
from odh_kubeflow_tpu.train import Trainer as JTrainer
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora, moe
from odh_kubeflow_tpu_torch.parallel import collectives as col
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_moe import MARGIN, ROUTER_GAIN
from test_torch_pipeline_trainer import check_steps

WORLD = 8
B, S, D = 8, 64, 64
BANK_NAMES = ("router",) + moe.BANKS
MESH = dict(fsdp=2, expert=2, tensor=2)
# name: (mesh axes, dispatch)
MLP_CASES = {
    "ragged": (MESH, "ragged"),
    "einsum": (MESH, "einsum"),
    "ragged_context": (dict(expert=2, context=2, tensor=2), "ragged"),
}
FORWARD_CASES = ("ragged", "einsum")
TRAIN_MESH = dict(data=2, fsdp=2, expert=2)
TRAIN_B, TRAIN_S = 8, 32
TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
STEPS = 3
QLORA_ROUTER_SCALE = 1.6
JF32 = JLlamaConfig.tiny(dtype=jnp.float32)
TF32 = llama.LlamaConfig.tiny(dtype=torch.float32)
# a bank's local block on a rank, per layer: E over expert, F over tensor
# (D stays whole: the model gathers it over fsdp before the MLP)
LOCAL = {"moe_gate": tmesh.P(tmesh.AXIS_EXPERT, None, tmesh.AXIS_TENSOR),
         "moe_up": tmesh.P(tmesh.AXIS_EXPERT, None, tmesh.AXIS_TENSOR),
         "moe_down": tmesh.P(tmesh.AXIS_EXPERT, tmesh.AXIS_TENSOR, None)}


def _jcfg(dispatch):
    return jmoe.MoeConfig.mixtral_tiny(base=JF32, dispatch=dispatch)


def _tcfg(dispatch):
    return moe.MoeConfig.mixtral_tiny(base=TF32, dispatch=dispatch)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jbuild_mesh(JMeshConfig(**axes), jax.devices()[:n])


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _inputs():
    params = jmoe.init_params(jax.random.key(0), _jcfg("ragged"))
    params["layers"]["router"] = params["layers"]["router"] * ROUTER_GAIN
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, S, D)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, JF32.vocab_size, (B, 32)).astype(np.int32)
    toks = rng.integers(0, 256, (TRAIN_B, TRAIN_S)).astype(np.int32)
    return {"params": _np(params), "layer": _np(jax.tree.map(lambda a: a[0], params["layers"])),
            "x": x, "tokens": tokens,
            "batch": {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}}


def _jax_trainer():
    jt = JTrainer(jmoe.MoeConfig.mixtral_tiny(base=JF32), JTrainConfig(**TC),
                  JLoraConfig(rank=4), mesh=_jmesh(TRAIN_MESH), quantize_base=True, seed=8)
    layers = jt.params["layers"]
    # the random base draws every weight ~ N(0, 0.02²), norms included, which
    # packs the router logits together; unit MLP norms and a wider int8
    # router spread them (as tests/test_torch_pipeline_moe_trainer.py)
    router = np.random.default_rng(105).standard_normal((2, 64, 4)).astype(np.float32)
    layers["mlp_norm"] = jax.device_put(np.ones(layers["mlp_norm"].shape, np.float32),
                                        layers["mlp_norm"].sharding)
    q = jquantize(jnp.asarray(router * QLORA_ROUTER_SCALE))
    layers["router"] = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding), q,
                                    layers["router"])
    rng = np.random.default_rng(5)  # live adapters: b != 0
    jt.lora_params = jax.tree.map(
        lambda a: jax.device_put(rng.standard_normal(a.shape).astype(np.float32) * 0.1
                                 if a.ndim == 3 and a.shape[1] == 4 else np.asarray(a),
                                 a.sharding),
        jt.lora_params)
    return jt


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """Every case through the JAX package on eight virtual devices."""
    out = {"mlp": {}, "forward": {}}
    x, layer = jnp.asarray(inputs["x"]), inputs["layer"]
    for name, (axes, dispatch) in MLP_CASES.items():
        cfg = _jcfg(dispatch)

        def loss(x, layer, cfg=cfg):
            o, aux = jmoe.moe_mlp(x, layer, cfg)
            return jnp.sum(o**2) + aux, (o, aux)

        with jax.set_mesh(_jmesh(axes)):
            (_, (o, aux)), (gx, gl) = jax.jit(
                jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(x, layer)
            g = {"x": np.asarray(gx), **{n: np.asarray(gl[n]) for n in BANK_NAMES}}
            g["router_aux"] = np.asarray(jax.jit(jax.grad(
                lambda l, x, cfg=cfg: jmoe.moe_mlp(x, l, cfg)[1]))(layer, x)["router"])
        out["mlp"][name] = (np.asarray(o), float(aux), g)
    for name in FORWARD_CASES:
        with jax.set_mesh(_jmesh(MESH)):
            logits, aux = jax.jit(lambda p, t, c=_jcfg(name): jmoe.forward(p, t, c))(
                inputs["params"], jnp.asarray(inputs["tokens"]))
        out["forward"][name] = (np.asarray(logits), float(aux))
    jt = _jax_trainer()
    out["train_start"] = (_np(jt.params), _np(jt.lora_params))
    jbatch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    steps = []
    for _ in range(STEPS):
        m = jt.train_step(jbatch)
        steps.append((float(m["loss"]), float(m["grad_norm"]), _np(jt.lora_params), None))
    out["train"] = steps
    return out


def _margin_spy(seen):
    stats = moe._routing_stats

    def spy(logits, cfg, token_mask=None):
        live = logits if token_mask is None else logits[token_mask]
        z = live.detach().float().sort(-1, descending=True).values
        k = cfg.num_experts_per_tok
        seen.append(float((z[..., :k] - z[..., 1 : k + 1]).min()))
        return stats(logits, cfg, token_mask)

    moe._routing_stats = spy


def _mlp_on_rank(name, mesh, inputs):
    """One ``moe_mlp`` case on this rank's block: the gathered output, the
    aux and the whole gradients of ``sum(out²) + aux``. The tensor ranks
    compute the same loss (replicated), so a rank's share is its block's
    ``sum(out²)`` and the aux over the token ranks; the gradients sum over
    the token axes a leaf is not split over."""
    axes, dispatch = MLP_CASES[name]
    cfg = _tcfg(dispatch)
    xspec = tmesh.P(tmesh.BATCH_AXES, tmesh.AXIS_CONTEXT)
    x = tmesh.local_shard(torch.from_numpy(inputs["x"]), mesh, xspec).clone()
    whole = convert.from_numpy_tree(inputs["layer"], device="cpu")
    layer = {k: (tmesh.local_shard(v, mesh, LOCAL[k]).clone() if k in LOCAL else v)
             for k, v in whole.items()}
    leaves = [x] + [layer[n] for n in BANK_NAMES]
    for t in leaves:
        t.requires_grad_(True)
    out, aux = moe.moe_mlp(x, layer, cfg, mesh=mesh)
    ntok = mesh.size(tmesh.TOKEN_AXES)
    gs = torch.autograd.grad((out**2).sum() + aux / ntok, leaves, retain_graph=True)
    (router_aux,) = torch.autograd.grad(aux / ntok, layer["router"])
    tokens = mesh.group(tmesh.TOKEN_AXES)
    g = {"x": tmesh.gather_full(gs[0], mesh, xspec),
         "router": col.all_reduce_sum(gs[1], tokens),
         "router_aux": col.all_reduce_sum(router_aux, tokens)}
    rest = mesh.group((tmesh.AXIS_DATA, tmesh.AXIS_FSDP, tmesh.AXIS_CONTEXT))
    for n, t in zip(moe.BANKS, gs[2:]):
        g[n] = tmesh.gather_full(col.all_reduce_sum(t, rest), mesh, LOCAL[n])
    return (tmesh.gather_full(out.detach(), mesh, xspec).numpy(), float(aux),
            {k: v.numpy() for k, v in g.items()})


def _forward_on_rank(name, mesh, inputs):
    cfg = _tcfg(name)
    tree = tmesh.shard_tree(convert.from_numpy_tree(inputs["params"], device="cpu"), mesh,
                            moe.param_specs(cfg))
    batch = tmesh.P(tmesh.BATCH_AXES)
    tokens = tmesh.local_shard(torch.from_numpy(inputs["tokens"]).long(), mesh, batch)
    with torch.no_grad():
        logits, aux = moe.forward(tree, tokens, cfg, mesh=mesh)
    return (tmesh.gather_full(logits, mesh, tmesh.P(tmesh.BATCH_AXES, None, tmesh.AXIS_TENSOR))
            .numpy(), float(aux))


def _train_on_rank(mesh, inputs, start):
    tt = Trainer(moe.MoeConfig.mixtral_tiny(base=TF32), TrainConfig(**TC), lora.LoraConfig(rank=4),
                 mesh=mesh, quantize_base=True, device="cpu",
                 metrics_registry=prometheus.Registry())
    params, lora_params = start
    tt.params = tmesh.shard_tree(convert.from_numpy_tree(params, "cpu"), mesh, tt.param_specs)
    tt.lora_params = tmesh.shard_tree(convert.from_numpy_tree(lora_params, "cpu"), mesh,
                                      tt.train_specs)
    tt.opt_state = ttrainer.init_opt_state(tt._trainable())
    steps = []
    for _ in range(STEPS):
        m = tt.train_step(inputs["batch"])
        tree = tmesh.gather_tree(tt._trainable(), mesh, tt.train_specs)
        steps.append((float(m["loss"]), float(m["grad_norm"]),
                      jax.tree.map(np.copy, convert.to_numpy_tree(tree)), None))
    return steps


def _port_ranks(rank, world, inputs, start, out_path):
    margins = []
    _margin_spy(margins)
    res = {"mlp": {}, "forward": {}}
    for name, (axes, _) in MLP_CASES.items():
        res["mlp"][name] = _mlp_on_rank(name, tmesh.build_mesh(tmesh.MeshConfig(**axes), "cpu"),
                                        inputs)
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**MESH), device="cpu")
    for name in FORWARD_CASES:
        res["forward"][name] = _forward_on_rank(name, mesh, inputs)
    res["train"] = _train_on_rank(tmesh.build_mesh(tmesh.MeshConfig(**TRAIN_MESH), "cpu"),
                                  inputs, start)
    res["margin"] = min(margins)
    if rank == 0:
        torch.save(res, out_path)


@pytest.fixture(scope="module")
def port(inputs, jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh")
    out = tmp / "port.pt"
    spawn_cpu_ranks(_port_ranks, WORLD, inputs, jax_ref["train_start"], str(out),
                    rendezvous_dir=str(tmp), threads=1)
    res = torch.load(out, weights_only=False)
    # every routing the ranks ran is decided alike
    assert res["margin"] > MARGIN, res["margin"]
    return res


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_sharded_moe_mlp_matches_jax(name, port, jax_ref):
    (out, aux, grads), (jout, jaux, jgrads) = port["mlp"][name], jax_ref["mlp"][name]
    _close(out, jout, 1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    for k in jgrads:
        _close(grads[k], jgrads[k], 1e-5)
    assert np.abs(jgrads["router_aux"]).max() > 0


@pytest.mark.parametrize("name", FORWARD_CASES)
def test_sharded_moe_forward_matches_jax(name, port, jax_ref):
    (logits, aux), (jlogits, jaux) = port["forward"][name], jax_ref["forward"][name]
    _close(logits, jlogits, 1e-4)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)


def test_ragged_qlora_trainer_matches_jax(port, jax_ref):
    check_steps(port["train"], jax_ref["train"], True, jax_ref["train_start"][1])


def test_dispatch_path_takes_ragged_and_einsum_under_a_mesh():
    """No refusal of either dispatch on a mesh that shards everything."""
    mesh = tmesh.Mesh(tmesh.MeshConfig(data=2, fsdp=2, expert=2, tensor=2, context=2),
                      torch.device("cpu"), None, rank=0)
    x = torch.empty((16, 64, D), device="meta")
    for dispatch in ("ragged", "einsum"):
        assert moe.dispatch_path(x, _tcfg(dispatch), mesh) == dispatch
    # a grouped config's small batch takes the exact ragged path there too
    assert moe.dispatch_path(x[:, :8], _tcfg("grouped"), mesh) == "ragged_exact"
