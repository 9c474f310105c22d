"""The port's pipelined trainer (``Trainer(mesh=)`` with ``pipe > 1``)
against the JAX package's, for the Llama family.

The JAX ``Trainer`` runs in the test process on four virtual CPU devices
with ``TrainConfig.pipeline_microbatches``; the port's runs on four gloo
ranks with the same ``MeshConfig``, each rank given its shards (its
stage's layers) of the JAX trainer's initial state. Both take three steps
on one numpy batch, in float32. Cases: LoRA at pipe=2 × data=2 and at
pipe=2 × context=2 (ring attention inside the stages), the full fine-tune
at pipe=2 × fsdp=2, QLoRA int4 at pipe=2 × tensor=2 under remat "attn".
Held as ``tests/test_torch_parallel_trainer.py`` holds them: loss rtol
1e-5, gradient norm rtol 1e-4, each trainable leaf after each step rtol
1e-4 with atol 1e-5 (LoRA) or 1e-3 (full fine-tune, with the elements at
Adam's eps held apart, ``check_steps``).

JAX's pipelined trainer gets pipe × context wrong: its gradient norm on
this batch is 2.444 where its unpipelined trainer at context=2 × data=2,
and its pipelined one at pipe=2 × data=2, read 3.799
(``test_jax_pipelined_context_gradient_is_a_reference_fault`` pins it). A
dense model's math does not depend on the microbatches, so that case is
held to JAX's unpipelined trainer on context=2 × data=2 (``REFERENCE``).

Also: the pipelined init gathered equals the one-device init bit for bit
(float and int4 bases, and the adapters); a checkpoint saved at pipe=2
restores at fsdp=4 and on one device; the replicated leaves (embedding,
final norm, head) are bit-equal across the pipe ranks after the steps; a
batch that the microbatches do not divide is refused with JAX's text.
``tests/test_torch_pipeline_moe_trainer.py`` holds the MoE family.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from odh_kubeflow_tpu.models import LlamaConfig as JLlamaConfig
from odh_kubeflow_tpu.models import LoraConfig as JLoraConfig
from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.models.quant import quantize_tensor as jquantize
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.train import TrainConfig as JTrainConfig
from odh_kubeflow_tpu.train import Trainer as JTrainer
from odh_kubeflow_tpu.train.trainer import cross_entropy_loss as jcross_entropy
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora, moe
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.train import CheckpointManager, TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus

WORLD = 4
TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
STEPS = 3
MARGIN = 1e-4  # the smallest top-2 router margin any routing may take
ADAM_EPS = 1e-8  # the trainers' Adam eps
JDENSE, TDENSE = JLlamaConfig.tiny(dtype=jnp.float32), llama.LlamaConfig.tiny(dtype=torch.float32)
JMOE = jmoe.MoeConfig.mixtral_tiny(base=JDENSE, dispatch="grouped", pin_expert_acts=True)
TMOE = moe.MoeConfig.mixtral_tiny(base=TDENSE, dispatch="grouped", pin_expert_acts=True)
# name: (mesh axes, MoE, LoRA, quantize_base, dense overrides, microbatches, batch rows, seq
# [, TrainConfig overrides])
CASES = {
    "lora_pipe2_data2": (dict(pipe=2, data=2), False, True, False, {}, 2, 8, 16),
    "lora_pipe2_context2": (dict(pipe=2, context=2), False, True, False, {}, 2, 8, 16),
    "full_pipe2_fsdp2": (dict(pipe=2, fsdp=2), False, False, False, {}, 4, 8, 16),
    "qlora_int4_pipe2_tensor2": (dict(pipe=2, tensor=2), False, True, "int4",
                                 dict(remat=True, remat_policy="attn"), 2, 8, 16),
}
# cases held to a JAX trainer on another mesh: JAX's own pipelined trainer
# is at fault there
REFERENCE = {"lora_pipe2_context2": dict(context=2, data=2)}
INIT_CASES = ("full_pipe2_fsdp2", "qlora_int4_pipe2_tensor2")
CKPT_CASE = "full_pipe2_fsdp2"
REPLICATED = ("embed", "final_norm", "lm_head")
# router scales that keep every top-2 margin far above MARGIN (MoE cases)
QLORA_ROUTER_SCALE = 1.6
FULL_ROUTER_GAIN = 16.0


def _np(tree):
    """numpy copies (the JAX trainer donates its buffers to the next step)."""
    return jax.tree.map(np.array, tree)


def _configs(case):
    _, is_moe, _, _, over, M, *_ = case
    if is_moe:
        return JMOE, TMOE, M
    return (dataclasses.replace(JDENSE, **over), dataclasses.replace(TDENSE, **over), M)


def _train_cfg(case):
    _, _, _, _, _, M, _, _, *over = case
    return dict(TC, pipeline_microbatches=M, **(over[0] if over else {}))


def _batch(case):
    B, S = case[6:8]
    toks = np.random.default_rng(3).integers(0, 256, (B, S)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


class _PerMicrobatch(JTrainer):
    """JAX's ``Trainer`` with the pipelined MoE loss written out: the mean
    over the microbatches (contiguous row blocks) of each one's LM loss and
    router aux, each microbatch through JAX's unpipelined forward. What
    JAX's pipeline computes: every microbatch passes the same layers, and
    its aux is its own routing's. A dense model's loss is JAX's own: its
    math does not depend on the microbatches."""

    def _moe_loss_fn(self, params, lora_params, batch):
        M = self.train_cfg.pipeline_microbatches
        tokens, targets = batch["tokens"], batch["targets"]
        mb = tokens.shape[0] // M
        total = 0.0
        for m in range(M):
            rows = slice(m * mb, (m + 1) * mb)
            logits, aux = jmoe.forward(params, tokens[rows], self.model_cfg, lora=lora_params)
            total = total + jcross_entropy(logits, targets[rows]) + aux
        return total / M


def _jax_trainer(case, axes=None, start=None):
    """The case's JAX trainer on its mesh (or, unpipelined, on ``axes``),
    from its own init of seed 8 or, given ``start``, from those params."""
    mesh_axes, is_moe, with_lora, qb, *_ = case
    jcfg, _, M = _configs(case)
    axes = axes or mesh_axes
    cls = _PerMicrobatch if "pipe" not in axes else JTrainer
    devices = jax.devices()[: int(np.prod(list(axes.values())))]
    jt = cls(jcfg, JTrainConfig(**_train_cfg(case)),
             JLoraConfig(rank=4) if with_lora else None,
             mesh=jbuild_mesh(JMeshConfig(**axes), devices), quantize_base=qb, seed=8)
    if start is not None:
        jt.params = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding), start, jt.params)
        return jt
    layers = jt.params["layers"]
    if is_moe and with_lora:
        # the random base draws every weight ~ N(0, 0.02²), norms included,
        # which packs the router logits together; unit MLP norms and a wider
        # int8 router spread them (as tests/test_torch_moe_ep.py)
        router = np.random.default_rng(105).standard_normal((2, 64, 4)).astype(np.float32)
        router = router * QLORA_ROUTER_SCALE
        layers["mlp_norm"] = jax.device_put(np.ones(layers["mlp_norm"].shape, np.float32),
                                            layers["mlp_norm"].sharding)
        q = jquantize(jnp.asarray(router))
        layers["router"] = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding), q,
                                        layers["router"])
    elif is_moe:
        layers["router"] = layers["router"] * FULL_ROUTER_GAIN
    if with_lora:  # live adapters, so the adapters' products matter from step 1
        rng = np.random.default_rng(5)
        jt.lora_params = jax.tree.map(
            lambda a: jax.device_put(rng.standard_normal(a.shape).astype(np.float32) * 0.1
                                     if a.ndim == 3 and a.shape[1] == 4 else np.asarray(a),
                                     a.sharding),
            jt.lora_params)
    return jt


def _run_jax(jt, batch, steps=STEPS):
    """Each step's (loss, gradient norm, trainable tree, and for a full
    fine-tune the gradient leaves taken before the step)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    full = jt.lora_cfg is None
    if full:
        with jax.set_mesh(jt.mesh):
            jgrad = jax.jit(jax.grad(jt._loss_fn))
    out = []
    for _ in range(steps):
        grads = None
        if full:
            with jax.set_mesh(jt.mesh):
                grads = jax.tree.leaves(_np(jgrad(jt.params, None, jbatch)))
        m = jt.train_step(jbatch)
        tree = jt.lora_params if not full else jt.params
        out.append((float(m["loss"]), float(m["grad_norm"]), _np(tree), grads))
    return out


def jax_reference(cases, reference):
    """Each case's JAX start and steps (on ``reference``'s mesh where given)."""
    out = {"start": {}, "steps": {}}
    for name, case in cases.items():
        jt = _jax_trainer(case, reference.get(name))
        out["start"][name] = (_np(jt.params), _np(jt.lora_params) if jt.lora_cfg else None)
        out["steps"][name] = _run_jax(jt, _batch(case))
    return out


@pytest.fixture(scope="module")
def jax_ref():
    out = jax_reference(CASES, REFERENCE)
    # JAX's own pipelined trainer on pipe x context: one step
    name = "lora_pipe2_context2"
    jt = _jax_trainer(CASES[name])
    jt.lora_params = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding),
                                  out["start"][name][1], jt.lora_params)
    jt.params = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding),
                             out["start"][name][0], jt.params)
    out["jax_pipelined_context"] = _run_jax(jt, _batch(CASES[name]), steps=1)[0]
    return out


def _margin_spy(seen):
    stats = moe._routing_stats

    def spy(logits, cfg, token_mask=None):
        z = logits.detach().float().sort(-1, descending=True).values
        k = cfg.num_experts_per_tok
        seen.append(float((z[..., :k] - z[..., 1 : k + 1]).min()))
        return stats(logits, cfg, token_mask)

    moe._routing_stats = spy


def _port_trainer(case, mesh, seed=0):
    _, _, with_lora, qb, *_ = case
    _, tcfg, M = _configs(case)
    return Trainer(tcfg, TrainConfig(**_train_cfg(case)),
                   lora.LoraConfig(rank=4) if with_lora else None, mesh=mesh, quantize_base=qb,
                   seed=seed, device="cpu", metrics_registry=prometheus.Registry())


def _gathered(tt, tree=None, specs=None):
    tree = tt._trainable() if tree is None else tree
    tree = tmesh.gather_tree(tree, tt.mesh, tt.train_specs if specs is None else specs)
    return jax.tree.map(np.copy, convert.to_numpy_tree(tree))


def _replicas_equal(tt) -> bool:
    """Every replicated leaf equal, bit for bit, on every pipe rank."""
    group = tt.mesh.group(tmesh.AXIS_PIPE)
    same = True
    for k in REPLICATED:
        if k not in tt.params:
            continue
        t = tt.params[k].contiguous()
        parts = [torch.empty_like(t) for _ in range(tt.stages)]
        dist.all_gather(parts, t, group=group)
        same &= all(torch.equal(parts[0], p) for p in parts)
    flag = torch.tensor([float(same)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def port_ranks(rank, world, cases, init_cases, ckpt_case, starts, ckpt, out_path):
    """Every case on this rank: its own pipelined init gathered (the
    ``init_cases``), then JAX's start as shards and the steps; the
    ``ckpt_case``'s state saved and restored on other meshes. Rank 0 saves
    the results."""
    margins = []
    _margin_spy(margins)
    res = {"steps": {}, "replicas_equal": {}, "init": {}, "margins": {}}
    for name, case in cases.items():
        axes, _, with_lora, *_ = case
        margins.clear()
        mesh = tmesh.build_mesh(tmesh.MeshConfig(**axes), device="cpu")
        if name in init_cases:  # before JAX's state goes in
            tt = _port_trainer(case, mesh, seed=4)
            res["init"][name] = (_gathered(tt, tt.params, tt.param_specs), _gathered(tt))
        tt = _port_trainer(case, mesh)
        params, lora_params = starts[name]
        tt.params = tmesh.shard_tree(convert.from_numpy_tree(params, "cpu"), mesh,
                                     tt.param_specs)
        if with_lora:
            tt.lora_params = tmesh.shard_tree(convert.from_numpy_tree(lora_params, "cpu"), mesh,
                                              tt.train_specs)
        tt.opt_state = ttrainer.init_opt_state(tt._trainable())
        steps = []
        for _ in range(STEPS):
            m = tt.train_step(_batch(case))
            steps.append((float(m["loss"]), float(m["grad_norm"]), _gathered(tt), None))
        res["steps"][name] = steps
        res["margins"][name] = min(margins, default=float("inf"))
        if not with_lora and tt.stages > 1:
            res["replicas_equal"][name] = _replicas_equal(tt)
        if name == ckpt_case:
            saved = tt
    if ckpt_case is not None:  # saved at its pipe mesh, restored at fsdp=4 and on one device
        case = cases[ckpt_case]
        with CheckpointManager(ckpt, save_interval_steps=10**6) as mgr:
            assert saved.save_checkpoint(mgr, force=True)
            other = _port_trainer(case, tmesh.build_mesh(tmesh.MeshConfig(fsdp=4), device="cpu"))
            other.restore_checkpoint(mgr)
            res["restore"] = {
                "saved": _gathered(saved), "fsdp4": _gathered(other),
                "next_loss": [float(t.train_step(_batch(case))["loss"]) for t in (saved, other)]}
            if rank == 0:
                one = _port_trainer(case, None)
                one.restore_checkpoint(mgr)
                res["restore"]["one_device"] = jax.tree.map(
                    np.copy, convert.to_numpy_tree(one._trainable()))
    if rank == 0:
        torch.save(res, out_path)


def run_port(tmp, cases, init_cases, ckpt_case, starts):
    """``port_ranks`` on four gloo ranks, in one spawn."""
    out = tmp / "port.pt"
    spawn_cpu_ranks(port_ranks, WORLD, cases, init_cases, ckpt_case, starts, str(tmp / "ckpt"),
                    str(out), rendezvous_dir=str(tmp))
    res = torch.load(out, weights_only=False)
    # every routing the ranks ran is decided alike
    assert min(res["margins"].values()) > MARGIN, res["margins"]
    return res


@pytest.fixture(scope="module")
def port(jax_ref, tmp_path_factory):
    return run_port(tmp_path_factory.mktemp("pipeline_trainer"), CASES, INIT_CASES, CKPT_CASE,
                    jax_ref["start"])


def check_steps(got, want, with_lora, start, lr=TC["learning_rate"]):
    """Each step's loss, gradient norm and trainable leaves; every leaf
    moved. A full fine-tune's weights are held to 1e-3 absolute, except
    where JAX's gradient of an element has been nonzero and within ten times
    Adam's eps (1e-8): there the normalised step g / (|g| + eps) turns on the last bits
    of the sum, which another summation order moves, so those elements are
    held to what Adam can move a weight in the steps taken, and they must
    stay under a thousandth of their leaf, or one element of a smaller leaf
    (``tests/test_torch_moe_ep.py``'s rule; the tiny router has 512)."""
    tiny = None
    for i, ((gl, gn, gtree, _), (wl, wn, wtree, wgrads)) in enumerate(zip(got, want)):
        msg = f"step {i}"
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=msg)
        np.testing.assert_allclose(gn, wn, rtol=1e-4, err_msg=msg)
        if with_lora:
            for g, w in zip(jax.tree.leaves(gtree), jax.tree.leaves(wtree)):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=msg)
            continue
        now = [(np.abs(w) < 10 * ADAM_EPS) & (w != 0) for w in wgrads]  # a zero moves nothing
        tiny = now if tiny is None else [a | b for a, b in zip(tiny, now)]
        for g, w, t in zip(jax.tree.leaves(gtree), jax.tree.leaves(wtree), tiny):
            assert t.sum() <= max(1, 1e-3 * t.size), msg
            np.testing.assert_allclose(g[~t], w[~t], rtol=1e-4, atol=1e-3, err_msg=msg)
            assert (np.abs(g[t] - w[t]) <= 2.2 * lr * (i + 1)).all(), msg
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got[-1][2]), jax.tree.leaves(start))]
    assert all(moved)  # every trainable leaf moved, every stage's


def check_init(case, got):
    """The gathered pipelined init against the one-device init, bit for bit."""
    one = _port_trainer(case, None, seed=4)
    params, trainable = got
    pairs = [(params, one.params)] + ([(trainable, one.lora_params)] if case[2] else [])
    for g_tree, w_tree in pairs:
        want = ttrainer._leaves(convert.to_numpy_tree(w_tree))
        got_l = ttrainer._leaves(g_tree)
        assert [p for p, _ in got_l] == [p for p, _ in want]
        for (_, g), (_, w) in zip(got_l, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_trainer_matches_jax(name, port, jax_ref):
    with_lora = CASES[name][2]
    check_steps(port["steps"][name], jax_ref["steps"][name], with_lora,
                jax_ref["start"][name][1 if with_lora else 0])


def test_jax_pipelined_context_gradient_is_a_reference_fault(port, jax_ref):
    """JAX's pipelined trainer at pipe=2 × context=2 takes another gradient
    than the same model unpipelined at context=2 × data=2 and pipelined at
    pipe=2 × data=2 (the same init, batch and loss); the port takes theirs."""
    loss, norm, *_ = jax_ref["jax_pipelined_context"]
    unpiped = jax_ref["steps"]["lora_pipe2_context2"][0]
    np.testing.assert_allclose(loss, unpiped[0], rtol=1e-6)
    np.testing.assert_allclose(unpiped[1], jax_ref["steps"]["lora_pipe2_data2"][0][1], rtol=1e-5)
    assert abs(norm - unpiped[1]) > 0.1 * unpiped[1]
    np.testing.assert_allclose(port["steps"]["lora_pipe2_context2"][0][1], unpiped[1], rtol=1e-4)


@pytest.mark.parametrize("name", [n for n in CASES if not CASES[n][2]])
def test_replicated_leaves_stay_equal_across_stages(name, port):
    assert port["replicas_equal"][name]


@pytest.mark.parametrize("name", INIT_CASES)
def test_pipelined_init_is_the_one_device_init(name, port):
    """Each stage builds only its layers, the random streams advanced past
    the others: gathered, bit for bit the one-device init of the seed."""
    check_init(CASES[name], port["init"][name])


def test_pipelined_checkpoint_restores_on_other_meshes(port):
    r = port["restore"]
    saved = jax.tree.leaves(r["saved"])
    for got in (r["fsdp4"], r["one_device"]):
        got = jax.tree.leaves(got)
        assert len(got) == len(saved)
        for a, b in zip(saved, got):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r["next_loss"][1], r["next_loss"][0], rtol=1e-5)


def test_pipelined_batch_must_divide_into_microbatches():
    """JAX's refusal, with its text, before any collective: the trainer
    checks the global batch before it splits it."""
    mesh = tmesh.Mesh(tmesh.MeshConfig(pipe=2, data=2), torch.device("cpu"), None, rank=0)
    tt = Trainer(TDENSE, TrainConfig(pipeline_microbatches=4), lora.LoraConfig(rank=2),
                 mesh=mesh, device="cpu", metrics_registry=prometheus.Registry())
    toks = np.zeros((6, 16), np.int32)
    jt = JTrainer(JDENSE, JTrainConfig(pipeline_microbatches=4), JLoraConfig(rank=2),
                  mesh=jbuild_mesh(JMeshConfig(pipe=2, data=2), jax.devices()[:4]))
    with pytest.raises(ValueError) as want:
        jt.train_step({"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)})
    with pytest.raises(ValueError) as got:
        tt.train_step({"tokens": toks, "targets": toks})
    assert str(got.value) == str(want.value)
    # a microbatch that the batch axes do not split: a clear refusal
    with pytest.raises(ValueError, match="does not split over the batch axes"):
        tt.train_step({"tokens": np.zeros((4, 16), np.int32), "targets": np.zeros((4, 16))})
