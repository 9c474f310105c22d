"""The port's expert-parallel grouped MoE against the JAX package's.

JAX's grouped MoE runs under a mesh on four virtual CPU devices (its
``shard_map`` over data, fsdp and expert, the Pallas grouped kernels in
interpret mode); the port's runs on four gloo ranks with the same
``MeshConfig``, each rank holding its batch block and its experts, the
collectives placed by hand (``models/moe.py`` ``_moe_mlp_grouped_ep``).
The weights are JAX's ``init_params`` carried across by ``convert.py``
(the router scaled by ``ROUTER_GAIN``, so the smallest top-2 margin clears
``MARGIN``: routing is discontinuous), the inputs come from a numpy seed,
and everything is float32. One spawn of four ranks computes every case.

Cases, as ``tests/test_moe_ep.py``'s: ``moe_mlp`` at fsdp=2 × expert=2
(with the gradients of ``sum(out²) + aux`` by x, the router and the three
banks, and the router's gradient of the aux alone, which a wrong backward
of the statistics' sum scales), data=4, expert=4 (gradients too), a token mask, and
``ep_capacity_factor=1.0`` (the same bounded drops as JAX's); the
tensor=2 and indivisible-batch errors with JAX's texts; ``moe.forward``
end to end with float and with int8 banks; three trainer steps (QLoRA
int8 at fsdp=2 × expert=2 on a packed batch, the full fine-tune at
data=2 × expert=2) against JAX's ``Trainer`` on the same mesh; a mesh
checkpoint saved at expert=2 and restored at expert=1; and the loopback
driver at four shards against the ranks. Tolerances as JAX's: output and
gradients 1e-5 relative to their largest element, logits 1e-4, aux 1e-6
(1e-5 through the whole forward); the trainers as
``tests/test_torch_parallel_trainer.py``'s, with the first step's
gradients too, and the full fine-tune's elements whose gradient sits at
Adam's eps held apart (``test_moe_sharded_trainer_matches_jax``).
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
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.collectives import psum
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.train import CheckpointManager, TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_moe import MARGIN, ROUTER_GAIN

WORLD = 4
B, S, D = 8, 512, 64
BANK_NAMES = ("router",) + moe.BANKS
# name: (mesh axes, config overrides, token mask, gradients)
MLP_CASES = {
    "fsdp2_expert2": (dict(fsdp=2, expert=2), {}, False, True),
    "data4": (dict(data=4), {}, False, False),
    "expert4": (dict(expert=4), {}, False, True),
    "token_mask": (dict(fsdp=2, expert=2), {}, True, False),
    "budget": (dict(fsdp=2, expert=2), dict(ep_capacity_factor=1.0), False, False),
}
FORWARD_CASES = ("f32", "int8")
FORWARD_MESH = dict(fsdp=2, expert=2)
TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
STEPS = 3
TRAIN_B = 4  # B·S·k over a (data, fsdp) group of 2 is 2048: the grouped path
# (name, mesh axes, LoRA + int8 base)
TRAIN_CASES = [
    ("qlora_fsdp2_expert2", dict(fsdp=2, expert=2), True),
    ("full_data2_expert2", dict(data=2, expert=2), False),
]
ADAM_EPS = 1e-8  # the trainers' Adam eps
RESTORE_MESH = dict(fsdp=4)  # expert=1: every rank holds every expert
JMLP = jmoe.MoeConfig.mixtral_tiny(dispatch="grouped")
TMLP = moe.MoeConfig.mixtral_tiny(base=llama.LlamaConfig.tiny(dtype=torch.float32),
                                  dispatch="grouped")
JF32 = dataclasses.replace(JMLP, base=JLlamaConfig.tiny(dtype=jnp.float32))
JTRAIN = jmoe.MoeConfig.mixtral_tiny(base=JLlamaConfig.tiny(dtype=jnp.float32),
                                     dispatch="grouped", pin_expert_acts=True)
TTRAIN = moe.MoeConfig.mixtral_tiny(base=llama.LlamaConfig.tiny(dtype=torch.float32),
                                    dispatch="grouped", pin_expert_acts=True)


def _np(tree):
    """numpy copies (the JAX trainer donates its buffers to the next step)."""
    return jax.tree.map(np.array, tree)


def _jmesh(axes):
    return jbuild_mesh(JMeshConfig(**axes), jax.devices()[:WORLD])


def _mask():
    lens = np.array([S, S // 3, S, S // 2, S, S, S // 4, S])
    return np.arange(S)[None, :] < lens[:, None]


def _inputs():
    """JAX's weights (one layer, and the whole tree in float32), the
    activations, the tokens and the trainer batches, as numpy."""
    params = jmoe.init_params(jax.random.key(0), JF32)
    params["layers"]["router"] = params["layers"]["router"] * ROUTER_GAIN
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, S, D)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, JF32.vocab_size, (B, S)).astype(np.int32)
    toks = rng.integers(0, 256, (TRAIN_B, S)).astype(np.int32)
    seg = np.repeat((np.arange(S) >= 190).astype(np.int32)[None] + 1, TRAIN_B, 0)
    seg[0, -40:] = 0  # padding: no expert row, no aux mass, no loss
    packed = {"tokens": toks, "targets": np.roll(toks, -1, axis=1), "segment_ids": seg,
              "loss_mask": (seg > 0).astype(np.float32)}
    plain = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    big = rng.integers(0, 256, (2 * TRAIN_B, S)).astype(np.int32)
    return {"params": _np(params), "layer": _np(jax.tree.map(lambda a: a[0], params["layers"])),
            "x": x, "tokens": tokens, "mask": _mask(),
            "batches": {"qlora_fsdp2_expert2": packed, "full_data2_expert2": plain},
            "restore_batch": {"tokens": big, "targets": np.roll(big, -1, axis=1)}}


def _int8_banks(params):
    out = jax.tree.map(lambda a: a, params)
    for name in moe.BANKS:
        out["layers"][name] = _np(jquantize(jnp.asarray(params["layers"][name])))
    return out


def _jax_trainer(name, axes, qlora):
    jt = JTrainer(JTRAIN, JTrainConfig(**TC), JLoraConfig(rank=4) if qlora else None,
                  mesh=_jmesh(axes), quantize_base=qlora, seed=8)
    layers = jt.params["layers"]
    if qlora:
        # the random base draws every weight ~ N(0, 0.02²), norms included,
        # which packs the router logits together; unit MLP norms and a wider
        # int8 router spread them (as tests/test_torch_moe_trainer.py)
        router = np.random.default_rng(105).standard_normal((2, 64, 4)).astype(np.float32)
        layers["mlp_norm"] = jax.device_put(np.ones(layers["mlp_norm"].shape, np.float32),
                                            layers["mlp_norm"].sharding)
        q = jquantize(jnp.asarray(router * 0.2))
        layers["router"] = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding), q,
                                        layers["router"])
        rng = np.random.default_rng(5)  # live adapters: b != 0
        jt.lora_params = jax.tree.map(
            lambda a: jax.device_put(rng.standard_normal(a.shape).astype(np.float32) * 0.1
                                     if a.ndim == 3 and a.shape[1] == 4 else np.asarray(a),
                                     a.sharding),
            jt.lora_params)
    else:
        layers["router"] = layers["router"] * ROUTER_GAIN
    return jt


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """Every case through the JAX package on four virtual devices."""
    out = {"mlp": {}, "forward": {}, "train": {}, "train_start": {}}
    x, layer, mask = jnp.asarray(inputs["x"]), inputs["layer"], jnp.asarray(inputs["mask"])
    for name, (axes, over, masked, grads) in MLP_CASES.items():
        cfg = dataclasses.replace(JMLP, **over)
        m = mask if masked else None

        def loss(x, layer, cfg=cfg, m=m):
            o, aux = jmoe.moe_mlp(x, layer, cfg, token_mask=m)
            return jnp.sum(o**2) + aux, (o, aux)

        with jax.set_mesh(_jmesh(axes)):
            if grads:
                (_, (o, aux)), (gx, gl) = jax.jit(
                    jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(x, layer)
                g = {"x": np.asarray(gx), **{n: np.asarray(gl[n]) for n in BANK_NAMES}}
                # the router's gradient through the aux alone: the statistics'
                # sum and its backward
                g["router_aux"] = np.asarray(jax.jit(jax.grad(
                    lambda l, x, cfg=cfg, m=m: jmoe.moe_mlp(x, l, cfg, token_mask=m)[1]))(
                        layer, x)["router"])
            else:
                _, (o, aux) = jax.jit(loss)(x, layer)
                g = None
        out["mlp"][name] = (np.asarray(o), float(aux), g)
    # the exact path at the budget case's mesh: what the drops remove
    with jax.set_mesh(_jmesh(MLP_CASES["budget"][0])):
        o, _ = jax.jit(lambda x, l: jmoe.moe_mlp(x, l, JMLP))(x, layer)
    out["budget_exact"] = np.asarray(o)
    for name in FORWARD_CASES:
        params = inputs["params"] if name == "f32" else _int8_banks(inputs["params"])
        with jax.set_mesh(_jmesh(FORWARD_MESH)):
            logits, aux = jax.jit(lambda p, t: jmoe.forward(p, t, JF32))(
                params, jnp.asarray(inputs["tokens"]))
        out["forward"][name] = (np.asarray(logits), float(aux))
    for name, axes, qlora in TRAIN_CASES:
        jt = _jax_trainer(name, axes, qlora)
        out["train_start"][name] = (_np(jt.params), _np(jt.lora_params) if qlora else None)
        jbatch = {k: jnp.asarray(v) for k, v in inputs["batches"][name].items()}
        with jax.set_mesh(jt.mesh):
            jgrad = jax.jit(jax.grad(jt._loss_fn))
        steps = []
        for _ in range(STEPS):
            with jax.set_mesh(jt.mesh):
                g = _np(jgrad(jt.lora_params if qlora else jt.params,
                              jt.params if qlora else None, jbatch))
            m = jt.train_step(jbatch)
            steps.append((float(m["loss"]), float(m["grad_norm"]),
                          _np(jt.lora_params if qlora else jt.params), jax.tree.leaves(g)))
        out["train"][name] = steps
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


def _experts(tree, mesh):
    """This rank's experts of each bank of a one-layer tree."""
    spec = tmesh.P(tmesh.AXIS_EXPERT)
    return {k: (tmesh.local_shard(v, mesh, spec) if k in moe.BANKS else v)
            for k, v in tree.items()}


def _mlp_on_rank(name, mesh, inputs):
    """One ``moe_mlp`` case on this rank's block: the gathered output, the
    aux and (where asked) the whole gradients of ``sum(out²) + aux``, each
    rank's loss share carrying the aux over the number of ranks."""
    _, over, masked, grads = MLP_CASES[name]
    cfg = dataclasses.replace(TMLP, **over)
    batch = tmesh.P(tmesh.BATCH_AXES)
    x = tmesh.local_shard(torch.from_numpy(inputs["x"]), mesh, batch).clone()
    m = tmesh.local_shard(torch.from_numpy(inputs["mask"]), mesh, batch) if masked else None
    layer = _experts(convert.from_numpy_tree(inputs["layer"], device="cpu"), mesh)
    leaves = [x] + [layer[n] for n in BANK_NAMES]
    for t in leaves:
        t.requires_grad_(True)
    out, aux = moe.moe_mlp(x, layer, cfg, token_mask=m, mesh=mesh)
    result = [tmesh.gather_full(out.detach(), mesh, batch), float(aux), None]
    if grads:
        # each rank's loss share carries the aux over the number of ranks
        share = (out**2).sum() + aux / WORLD
        gs = torch.autograd.grad(share, leaves, retain_graph=True)
        (router_aux,) = torch.autograd.grad(aux / WORLD, layer["router"])
        everyone = mesh.group(tmesh.BATCH_AXES)
        # the router is whole on every rank: its gradient sums over all
        g = {"x": tmesh.gather_full(gs[0], mesh, batch), "router": psum(gs[1], everyone),
             "router_aux": psum(router_aux, everyone)}
        for n, t in zip(moe.BANKS, gs[2:]):  # experts' sums over the (data, fsdp) groups
            t = psum(t, mesh.group((tmesh.AXIS_DATA, tmesh.AXIS_FSDP)))
            g[n] = tmesh.gather_full(t, mesh, tmesh.P(tmesh.AXIS_EXPERT))
        result[2] = {k: v.numpy() for k, v in g.items()}
    result[0] = result[0].numpy()
    return result


def _forward_on_rank(name, mesh, inputs):
    params = inputs["params"] if name == "f32" else _int8_banks(inputs["params"])
    tree = convert.from_numpy_tree(params, device="cpu")
    specs = moe.param_specs(TTRAIN)
    if name == "int8":  # the banks' codes and scales shard alike ([L, E, 1, N] scales)
        for n in moe.BANKS:
            specs["layers"][n] = {"q": specs["layers"][n], "scale": specs["layers"][n]}
    tree = tmesh.shard_tree(tree, mesh, specs)
    batch = tmesh.P(tmesh.BATCH_AXES)
    tokens = tmesh.local_shard(torch.from_numpy(inputs["tokens"]).long(), mesh, batch)
    cfg = dataclasses.replace(TTRAIN, pin_expert_acts=False)
    with torch.no_grad():
        logits, aux = moe.forward(tree, tokens, cfg, mesh=mesh)
    return tmesh.gather_full(logits, mesh, batch).numpy(), float(aux)


def _port_trainer(mesh, qlora):
    return Trainer(TTRAIN, TrainConfig(**TC), lora.LoraConfig(rank=4) if qlora else None,
                   mesh=mesh, quantize_base=qlora, device="cpu",
                   metrics_registry=prometheus.Registry())


def _gathered(tt):
    tree = tmesh.gather_tree(tt._trainable(), tt.mesh, tt.train_specs)
    return jax.tree.map(np.copy, convert.to_numpy_tree(tree))


def _port_ranks(rank, world, inputs, starts, ckpt, out_path):
    """Every case on this rank; rank 0 saves the results."""
    margins = []
    _margin_spy(margins)
    res = {"mlp": {}, "forward": {}, "train": {}}
    for name, (axes, *_) in MLP_CASES.items():
        mesh = tmesh.build_mesh(tmesh.MeshConfig(**axes), device="cpu")
        res["mlp"][name] = _mlp_on_rank(name, mesh, inputs)
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**FORWARD_MESH), device="cpu")
    for name in FORWARD_CASES:
        res["forward"][name] = _forward_on_rank(name, mesh, inputs)
    for name, axes, qlora in TRAIN_CASES:
        mesh = tmesh.build_mesh(tmesh.MeshConfig(**axes), device="cpu")
        tt = _port_trainer(mesh, qlora)
        params, lora_params = starts[name]
        tt.params = tmesh.shard_tree(convert.from_numpy_tree(params, "cpu"), mesh,
                                     tt.param_specs)
        if qlora:
            tt.lora_params = tmesh.shard_tree(convert.from_numpy_tree(lora_params, "cpu"),
                                              mesh, tt.train_specs)
        tt.opt_state = ttrainer.init_opt_state(tt._trainable())
        specs = [s for _, s in ttrainer._leaves(tt.train_specs)]
        steps = []
        for _ in range(STEPS):
            _, grads = tt.gradients(inputs["batches"][name])
            grads = [tmesh.gather_full(g, mesh, spec).numpy()
                     for g, spec in zip(grads.values(), specs)]
            m = tt.train_step(inputs["batches"][name])
            steps.append((float(m["loss"]), float(m["grad_norm"]), _gathered(tt), grads))
        res["train"][name] = steps
    # the full fine-tune's state saved at expert=2, restored at expert=1
    with CheckpointManager(ckpt, save_interval_steps=10**6) as mgr:
        assert tt.save_checkpoint(mgr, force=True)
        other = _port_trainer(tmesh.build_mesh(tmesh.MeshConfig(**RESTORE_MESH), device="cpu"),
                              qlora=False)
        restored_step = other.restore_checkpoint(mgr)
    res["restore"] = {
        "step": (restored_step, tt.step), "saved": _gathered(tt), "restored": _gathered(other),
        "opt_count": (other.opt_state["count"], tt.opt_state["count"]),
        "banks_local": tuple(other.params["layers"]["moe_gate"].shape),
        "next_loss": [float(t.train_step(inputs["restore_batch"])["loss"]) for t in (tt, other)],
    }
    res["min_margin"] = min(margins)
    if rank == 0:
        torch.save(res, out_path)


@pytest.fixture(scope="module")
def port(inputs, jax_ref, tmp_path_factory):
    """Every case on four gloo ranks, in one spawn."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    out = tmp / "port.pt"
    spawn_cpu_ranks(_port_ranks, WORLD, inputs, jax_ref["train_start"], str(tmp / "ckpt"),
                    str(out), rendezvous_dir=str(tmp))
    res = torch.load(out, weights_only=False)
    assert res["min_margin"] > MARGIN  # every routing the ranks ran is decided alike
    return res


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) / scale < tol


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_grouped_ep_matches_jax(name, port, jax_ref, inputs):
    (out, aux, grads), (jout, jaux, jgrads) = port["mlp"][name], jax_ref["mlp"][name]
    if MLP_CASES[name][2]:  # masked tokens' outputs are the path's own business
        out, jout = out * inputs["mask"][..., None], jout * inputs["mask"][..., None]
    _close(out, jout, 1e-5)
    # the aux from the (data, fsdp) sums of the balance statistics: the
    # global batch's, not a mean of group means
    assert abs(aux - jaux) < 1e-6
    if MLP_CASES[name][3]:
        for k in ("x", "router_aux") + BANK_NAMES:
            _close(grads[k], jgrads[k], 1e-5)


def test_grouped_ep_budget_drops_are_bounded(port, jax_ref):
    """``ep_capacity_factor=1.0``: the same drops as JAX's (matched above),
    finite, and within the budget's envelope of the exact path."""
    out = port["mlp"]["budget"][0]
    assert np.isfinite(out).all()
    exact = jax_ref["budget_exact"]
    assert np.abs(out - exact).sum() / (np.abs(exact).sum() + 1e-9) < 0.25


@pytest.mark.parametrize("name", FORWARD_CASES)
def test_grouped_ep_forward_matches_jax(name, port, jax_ref):
    (logits, aux), (jlogits, jaux) = port["forward"][name], jax_ref["forward"][name]
    _close(logits, jlogits, 1e-4)
    assert abs(aux - jaux) < 1e-5


def test_loopback_matches_the_ranks(port, inputs):
    """The loopback driver at four virtual shards, one device, against the
    ranks at expert=4 (one (data, fsdp) group: the whole batch)."""
    out, aux, grads = port["mlp"]["expert4"]
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    layer = convert.from_numpy_tree(inputs["layer"], device="cpu")
    leaves = [x] + [layer[n].requires_grad_(True) for n in BANK_NAMES]
    lout, laux = moe.loopback_moe_mlp_grouped_ep(x, layer, TMLP, 4)
    got = torch.autograd.grad((lout**2).sum() + laux, leaves)
    _close(lout.detach().numpy(), out, 1e-5)
    assert abs(float(laux) - aux) < 1e-6
    for k, g in zip(("x",) + BANK_NAMES, got):
        _close(g.numpy(), grads[k], 1e-5)


def _fake_mesh(**axes):
    """A mesh's shape and this rank's place, without a process group: what
    the dispatch rules read."""
    return tmesh.Mesh(tmesh.MeshConfig(**axes), torch.device("cpu"), None, rank=0)


@pytest.mark.parametrize("case", ["tensor", "indivisible"])
def test_grouped_rejects_what_jax_rejects(case, inputs):
    """No silent fallback: a tensor-sharded mesh and a batch the batch axes
    do not divide are ``ValueError``s with JAX's texts."""
    if case == "tensor":
        axes, shape, match = dict(data=4, tensor=2), (B, S, D), "tensor/context"
    else:  # 4 rows over data·fsdp·expert = 8 shards
        axes, shape, match = dict(data=2, fsdp=2, expert=2), (4, 2048, D), "not divisible"
    layer = jax.tree.map(jnp.asarray, inputs["layer"])
    with jax.set_mesh(jbuild_mesh(JMeshConfig(**axes), jax.devices())):
        with pytest.raises(ValueError, match=match) as want:
            jax.jit(lambda x, l: jmoe.moe_mlp(x, l, JMLP))(jnp.zeros(shape), layer)
    mesh = _fake_mesh(**axes)
    with pytest.raises(ValueError) as got:
        moe.dispatch_path(torch.empty(shape, device="meta"), TMLP, mesh)
    assert str(got.value) == str(want.value)
    if case == "tensor":  # through moe_mlp on this rank's block of the batch
        x = torch.zeros((B // 4, S, D))
        with pytest.raises(ValueError) as got:
            moe.moe_mlp(x, convert.from_numpy_tree(inputs["layer"], device="cpu"), TMLP,
                        mesh=mesh)
        assert str(got.value) == str(want.value)
    else:  # through the trainer, before the batch is split
        tt = Trainer(TTRAIN, lora_cfg=lora.LoraConfig(rank=2), quantize_base=True, mesh=mesh,
                     device="cpu", metrics_registry=prometheus.Registry())
        toks = np.zeros(shape[:2], np.int32)
        with pytest.raises(ValueError) as got:
            tt.train_step({"tokens": toks, "targets": toks})
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_moe_sharded_trainer_matches_jax(name, port, jax_ref):
    """Each step: the loss, the gradient norm and every trainable leaf after
    the update; at the first step also every gradient (1e-4 of its largest
    element, as ``tests/test_torch_moe_trainer.py``'s). The full
    fine-tune's weights are held to 1e-3 absolute, a tenth of one step at
    lr 1e-2, except where JAX's gradient of an element has been within ten
    times Adam's eps (1e-8): there the normalised step g / (|g| + eps)
    turns on the last bits of the sum, which another summation order
    moves (a bank weight's gradient of -1.3e-8 against JAX's -2.0e-8 is a
    5e-7-relative difference and moves the step by 1e-3), so those
    elements are held to what Adam can move a weight in the steps taken,
    and they must stay under a thousandth of their leaf."""
    qlora = next(c[2] for c in TRAIN_CASES if c[0] == name)
    lr = TC["learning_rate"]
    tiny = None
    for i, ((gl, gn, gtree, grads), (wl, wn, wtree, wgrads)) in enumerate(
            zip(port["train"][name], jax_ref["train"][name])):
        msg = f"{name} step {i}"
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=msg)
        np.testing.assert_allclose(gn, wn, rtol=1e-4, err_msg=msg)
        if i == 0:  # the one state both trainers share by construction
            for g, w in zip(grads, wgrads):
                _close(g, w, 1e-4)
        now = [np.abs(w) < 10 * ADAM_EPS for w in wgrads]
        tiny = now if tiny is None else [a | b for a, b in zip(tiny, now)]
        for g, w, t in zip(jax.tree.leaves(gtree), jax.tree.leaves(wtree), tiny):
            if qlora:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=msg)
                continue
            assert t.mean() < 1e-3, msg
            np.testing.assert_allclose(g[~t], w[~t], rtol=1e-4, atol=1e-3, err_msg=msg)
            assert (np.abs(g[t] - w[t]) <= 2.2 * lr * (i + 1)).all(), msg
    start = jax_ref["train_start"][name][1 if qlora else 0]
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(port["train"][name][-1][2]), jax.tree.leaves(start))]
    assert all(moved)  # every trainable leaf moved, the banks of the full fine-tune too


def test_moe_mesh_checkpoint_restores_resharded(port):
    """Saved gathered at data=2 × expert=2, restored at fsdp=4 (expert=1:
    whole banks on every rank): the same state, and the next step's loss."""
    r = port["restore"]
    assert r["step"][0] == r["step"][1] == STEPS and r["opt_count"][0] == r["opt_count"][1]
    assert r["banks_local"] == (2, 4, 64, 128)  # [L, E, D, F]: every expert
    saved, restored = jax.tree.leaves(r["saved"]), jax.tree.leaves(r["restored"])
    assert len(saved) == len(restored)
    for a, b in zip(saved, restored):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r["next_loss"][1], r["next_loss"][0], rtol=1e-5)


def test_moe_quantized_and_adapter_specs_match_jax():
    """``quant.quantized_param_specs`` of the MoE tree (int8 banks under
    the expert spec, the router's codes over fsdp) and ``lora.lora_specs``
    (attention adapters only) are the JAX package's."""
    from odh_kubeflow_tpu.models import lora as jlora
    from odh_kubeflow_tpu.models import quant as jquant
    from odh_kubeflow_tpu_torch.models.quant import quantized_param_specs

    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
    for dispatch in ("grouped", "ragged"):
        jspecs = jquant.quantized_param_specs(
            jmoe.param_specs(dataclasses.replace(JMLP, dispatch=dispatch)), bits=8)
        tspecs = quantized_param_specs(
            moe.param_specs(dataclasses.replace(TMLP, dispatch=dispatch)), bits=8)
        jl = jax.tree.leaves_with_path(jspecs, is_leaf=is_spec)
        tl = ttrainer._leaves(tspecs)
        assert [jax.tree_util.keystr(p) for p, _ in jl] == [
            "".join(f"['{k}']" for k in p) for p, _ in tl]
        assert [tuple(j) for _, j in jl] == [tuple(t) for _, t in tl]
    jl = jlora.lora_specs(JMLP.base, JLoraConfig(rank=4))
    tl = lora.lora_specs(TMLP.base, lora.LoraConfig(rank=4))
    assert {n: {k: tuple(v) for k, v in ab.items()} for n, ab in jl["layers"].items()} == {
        n: {k: tuple(v) for k, v in ab.items()} for n, ab in tl["layers"].items()}
