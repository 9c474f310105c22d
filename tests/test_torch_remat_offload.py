"""Remat policy "attn_offload" (``models/offload.py``): what "attn" keeps,
parked in host memory between a layer's forward and its backward.

The port's loss and adapter gradients under "attn_offload" against the JAX
package's under "attn_offload" (on the CPU its offload to pinned host memory
is a copy: the same arithmetic as "attn"), and bit-equal to the port's own
"attn" on the same inputs; the flash forward runs once a layer (L calls),
and the bytes parked are the residuals of every layer. ``LlamaConfig.tiny``
on the dense and the flash path (JAX's Pallas kernels in interpret mode, the
port's plain versions), ``mixtral_tiny`` on the grouped dispatch with the
"moe_g" pin and on the default one, with ``remat_pin_layers``, through the
loopback pipeline (GPipe, and 1F1B, whose recompute keeps on the device),
one ``Trainer`` step, and trainer steps under two meshes
on four gloo ranks (one spawn).

Tolerance against JAX, float32: loss rtol 1e-5, each gradient leaf 1e-4 of
its largest magnitude (sums in another order through two layers and the
recompute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import llama as jax_llama
from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.train import trainer as jtrainer
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama, lora, moe, offload
from odh_kubeflow_tpu_torch.ops import flash_attention as fa
from odh_kubeflow_tpu_torch.ops import grouped_matmul as gm
from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
from odh_kubeflow_tpu_torch.train import trainer as ttrainer
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_llama import JCFG, TCFG, np_lora, trees
from test_torch_moe import MARGIN, _params, margins  # noqa: F401
from test_torch_moe import JCFG as JMOE
from test_torch_moe import TCFG as TMOE
from test_torch_trainer import TC, _batch, _np, _pair

ATTN = ("wq", "wk", "wv", "wo")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _inputs(B, S, seed, vocab=256, split=9):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    seg = np.repeat((np.arange(S) >= split).astype(np.int32)[None] + 1, B, 0)
    return toks, seg


def _jax_grads(forward, params, cfg, lora_np, toks, seg):
    def loss_fn(lp):
        out = forward(params, jnp.asarray(toks), cfg, lora=lp, segment_ids=jnp.asarray(seg))
        logits, aux = out if isinstance(out, tuple) else (out, 0.0)
        return jtrainer.cross_entropy_loss(logits, jnp.roll(jnp.asarray(toks), -1, 1)) + aux

    loss, g = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, lora_np))
    return float(loss), convert.from_numpy_tree(jax.tree.map(np.asarray, g), device="cpu")


def _port_grads(forward, params, cfg, lora_np, toks, seg, **kw):
    """(loss, {path: grad}, flash forward calls, bytes parked)."""
    tree = convert.from_numpy_tree(lora_np, device="cpu")
    paths, leaves = zip(*ttrainer._leaves(tree))
    for x in leaves:
        x.requires_grad_(True)
    fa.fwd_launches = 0
    offload.parked_bytes = 0
    calls = []
    plain = fa.flash_fwd_reference
    fa.flash_fwd_reference = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        t = torch.from_numpy(toks).long()
        out = forward(params, t, cfg, lora=tree, segment_ids=torch.from_numpy(seg), **kw)
        logits, aux = out if isinstance(out, tuple) else (out, 0.0)
        loss = ttrainer.cross_entropy_loss(logits, torch.roll(t, -1, 1)) + aux
        grads = torch.autograd.grad(loss, leaves)
    finally:
        fa.flash_fwd_reference = plain
    return loss.detach(), dict(zip(paths, grads)), len(calls), offload.parked_bytes


def _close_to_jax(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    for path, w in ttrainer._leaves(jgrads):
        g, w = grads[path].numpy(), w.numpy()
        assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max(), (path, np.abs(g - w).max())


def _bit_equal(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for p in a[1]:
        assert torch.equal(a[1][p], b[1][p]), p


def _residual_bytes(cfg, B, S, impl, layers):
    """What "attn" keeps a layer, times the layers: flash ``(out, lse2)``
    or the dense attention output, in float32."""
    out = B * S * cfg.num_heads * cfg.head_dim * 4
    return layers * (out + (B * cfg.num_heads * S * 4 if impl == "flash" else 0))


@pytest.mark.parametrize("impl,pin", [("dense", None), ("flash", None), ("flash", 1)])
def test_llama_attn_offload_matches_jax_and_equals_attn(impl, pin):
    B, S, L = 2, 24, TCFG.num_layers
    jp, tp = trees("f32", seed=2)
    lp = np_lora(JCFG, seed=3, targets=ATTN)
    toks, seg = _inputs(B, S, seed=4)
    kw = dict(attention_impl=impl, remat=True, remat_policy="attn_offload", remat_pin_layers=pin)
    jloss, jgrads = _jax_grads(jax_llama.forward, jp, dataclasses.replace(JCFG, **kw), lp,
                               toks, seg)
    cfg = dataclasses.replace(TCFG, **kw)
    off = _port_grads(llama.forward, tp, cfg, lp, toks, seg)
    _close_to_jax(off[0], off[1], jloss, jgrads)
    attn = _port_grads(llama.forward, tp, dataclasses.replace(cfg, remat_policy="attn"), lp,
                       toks, seg)
    _bit_equal(off, attn)
    if impl == "flash" and pin is None:  # JAX's own "attn_offload" is its "attn" here
        jattn = _jax_grads(jax_llama.forward, jp, dataclasses.replace(
            JCFG, **dict(kw, remat_policy="attn")), lp, toks, seg)
        assert jattn[0] == jloss
        for path, g in ttrainer._leaves(jgrads):
            assert torch.equal(g, jattn[1]["layers"][path[1]][path[2]]), path
    parked = L - (L - pin if pin else 0)  # the unpinned prefix ("none") parks nothing
    if impl == "flash":
        assert off[2] == attn[2] == L + (L - parked)  # a parked layer never re-runs it
    assert off[3] == _residual_bytes(TCFG, B, S, impl, parked)
    assert attn[3] == 0
    assert offload._last() is None  # the parked regions went with the graph


@pytest.mark.parametrize("impl,dispatch,pin_acts", [("flash", "grouped", True),
                                                    ("dense", None, False)])
def test_moe_attn_offload_matches_jax_and_equals_attn(margins, impl, dispatch,  # noqa: F811
                                                      pin_acts):
    """``mixtral_tiny``: every name and op "attn" keeps (routing, the
    expert op's ``(y, g)`` or "moe_y", "moe_out", the attention residuals)
    is parked; the fused expert forward runs L times with the pin."""
    B, S, L = 2, 512, TMOE.base.num_layers
    jp, tp = _params(int8=dispatch == "grouped", seed=3)  # int8 banks: the fused kernel
    lp = np_lora(JCFG, seed=5, targets=ATTN)
    toks, seg = _inputs(B, S, seed=6, split=300)
    base_kw = dict(attention_impl=impl, remat=True, remat_policy="attn_offload")
    moe_kw = dict(pin_expert_acts=pin_acts, **({"dispatch": dispatch} if dispatch else {}))
    jcfg = dataclasses.replace(JMOE, base=dataclasses.replace(JMOE.base, **base_kw), **moe_kw)
    jloss, jgrads = _jax_grads(jmoe.forward, jp, jcfg, lp, toks, seg)
    cfg = dataclasses.replace(TMOE, base=dataclasses.replace(TMOE.base, **base_kw), **moe_kw)
    fused = []
    fwd = gm.swiglu_fwd_reference
    gm.swiglu_fwd_reference = lambda *a: fused.append(1) or fwd(*a)
    try:
        off = _port_grads(moe.forward, tp, cfg, lp, toks, seg)
        n_fused = len(fused)
        attn = _port_grads(moe.forward, tp, dataclasses.replace(
            cfg, base=dataclasses.replace(cfg.base, remat_policy="attn")), lp, toks, seg)
    finally:
        gm.swiglu_fwd_reference = fwd
    assert min(margins) > MARGIN
    _close_to_jax(off[0], off[1], jloss, jgrads)
    _bit_equal(off, attn)
    if impl == "flash":
        assert off[2] == L
    if dispatch == "grouped":
        assert n_fused == L  # the pinned (y, g) come back from the host
    assert off[3] > _residual_bytes(TMOE.base, B, S, impl, L)  # and the MoE's names
    assert attn[3] == 0


def test_attn_offload_through_the_loopback_pipeline_equals_attn():
    """GPipe over 2 loopback stages and 2 microbatches: a layer call per
    (stage, microbatch), each its own parked region."""
    B, S, L = 4, 16, TCFG.num_layers
    _, tp = trees("f32", seed=7)
    lp = np_lora(JCFG, seed=8, targets=ATTN)
    toks, seg = _inputs(B, S, seed=9, split=5)
    cfg = dataclasses.replace(TCFG, attention_impl="flash", remat=True,
                              remat_policy="attn_offload")
    kw = dict(loopback_stages=2, pipeline_microbatches=2)
    off = _port_grads(llama.forward, tp, cfg, lp, toks, seg, **kw)
    attn = _port_grads(llama.forward, tp, dataclasses.replace(cfg, remat_policy="attn"), lp,
                       toks, seg, **kw)
    _bit_equal(off, attn)
    assert off[2] == attn[2] == L * 2  # once a layer and microbatch
    assert off[3] == _residual_bytes(TCFG, B, S, "flash", L)


def test_attn_offload_under_1f1b_keeps_on_the_device_and_equals_attn():
    """1F1B's B recomputes a stage from its stored input and backpropagates
    at once, so "attn_offload" parks nothing there and runs as "attn": loss
    and adapter gradients bit-equal, no bytes parked."""
    from odh_kubeflow_tpu_torch.ops.norms import rms_norm
    from odh_kubeflow_tpu_torch.ops.rope import rope_angles
    from odh_kubeflow_tpu_torch.parallel import pipeline as pp

    B, T, S, M = 4, 16, 2, 2
    _, tp = trees("f32", seed=7)
    adapters = convert.from_numpy_tree(np_lora(JCFG, seed=8, targets=ATTN), device="cpu")
    toks, seg = _inputs(B, T, seed=9, split=5)
    tokens = torch.from_numpy(toks).long()
    sin, cos = rope_angles(torch.arange(T).expand(B, T), TCFG.head_dim, TCFG.rope_theta)
    head = {"final_norm": tp["final_norm"], "head": tp["lm_head"]}

    def head_fn(hp, y, a):
        h = rms_norm(y, hp["final_norm"], TCFG.rms_norm_eps)
        return ttrainer.chunked_cross_entropy(h, hp["head"], a["targets"], chunk=T)

    runs = {}
    for policy in ("attn", "attn_offload"):
        cfg = dataclasses.replace(TCFG, attention_impl="flash", remat=True, remat_policy=policy)
        layer_fn = llama._make_layer_fn(cfg, "flash", llama.causal_attention_fn("flash"), policy)
        lora_layers = {k: {n: t.clone().requires_grad_(True) for n, t in ab.items()}
                       for k, ab in adapters["layers"].items()}
        stage_fn, stage_params, aux = llama.pipeline_args(
            layer_fn, tp["layers"], lora_layers, sin, cos, torch.from_numpy(seg), M)
        aux["targets"] = torch.roll(tokens, -1, 1).reshape(M, B // M, T)
        offload.parked_bytes = 0
        loss, dlayers, _, _ = pp.loopback_pipeline_train_1f1b(
            stage_fn, head_fn, stage_params, head, tp["embed"][tokens], num_microbatches=M,
            num_stages=S, aux=aux)
        runs[policy] = (loss, dict(ttrainer._leaves(dlayers["lora"])), offload.parked_bytes)
    _bit_equal(runs["attn_offload"], runs["attn"])
    assert runs["attn_offload"][2] == 0


def test_trainer_step_under_attn_offload_matches_jax_and_attn():
    """One ``Trainer`` step under "attn_offload" against JAX's ``Trainer``
    under "attn" (JAX's jitted step cannot place residuals on the host on
    the CPU backend: "no registered implementation for ...
    annotate_device_placement for Host"; un-jitted, its "attn_offload" is
    its "attn" bit for bit, see the test above), and a second port trainer
    under "attn" on the same params: loss, gradient norm and adapters bit
    for bit."""
    kw = dict(attention_impl="flash", remat=True)
    jt, tt = _pair(jcfg=dataclasses.replace(JCFG, **kw, remat_policy="attn"),
                   tcfg=dataclasses.replace(TCFG, **kw, remat_policy="attn_offload"))
    ta = Trainer(dataclasses.replace(TCFG, **kw, remat_policy="attn"), TrainConfig(**TC),
                 lora.LoraConfig(rank=4), device="cpu", metrics_registry=prometheus.Registry())
    ta.params = convert.from_numpy_tree(_np(jt.params), device="cpu")
    ta.lora_params = convert.from_numpy_tree(_np(jt.lora_params), device="cpu")
    batch = _batch(S=32)
    batch["segment_ids"] = np.repeat((np.arange(32) >= 13).astype(np.int32)[None] + 1, 2, 0)
    offload.parked_bytes = 0
    jm = jt.train_step({k: jnp.asarray(v) for k, v in batch.items()})
    tm = tt.train_step(batch)
    assert offload.parked_bytes == _residual_bytes(TCFG, 2, 32, "flash", TCFG.num_layers)
    am = ta.train_step(batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
        assert torch.equal(tm[k], am[k]), k
    jleaves = jax.tree.leaves(_np(jt.lora_params))
    for (p, a), (_, b), w in zip(ttrainer._leaves(tt.lora_params),
                                 ttrainer._leaves(ta.lora_params), jleaves):
        assert torch.equal(a, b), p
        np.testing.assert_allclose(a.detach().numpy(), w, rtol=1e-4, atol=1e-5)


def _mesh_ranks(rank, world, out_path):
    """Each mesh: a trainer under "attn" and one under "attn_offload" from
    one seed, one step on one batch: loss, gradient norm and this rank's
    adapter shards bit for bit, and bytes parked."""
    from odh_kubeflow_tpu_torch.parallel import mesh as tmesh

    flags = []
    for axes, impl in ((dict(context=2, tensor=2), "ring"), (dict(fsdp=2, tensor=2), "flash")):
        mesh = tmesh.build_mesh(tmesh.MeshConfig(**axes), device="cpu")
        out = {}
        for policy in ("attn", "attn_offload"):
            cfg = dataclasses.replace(TCFG, attention_impl=impl, remat=True, remat_policy=policy)
            t = Trainer(cfg, TrainConfig(**TC), lora.LoraConfig(rank=4), mesh=mesh, seed=3,
                        device="cpu", metrics_registry=prometheus.Registry())
            offload.parked_bytes = 0
            m = t.train_step(_batch(B=4, S=32))
            out[policy] = (m, t.lora_params, offload.parked_bytes)
        (ma, la, pa), (mo, lo, po) = out["attn"], out["attn_offload"]
        flags += [torch.equal(ma["loss"], mo["loss"]), torch.equal(ma["grad_norm"], mo["grad_norm"]),
                  all(torch.equal(a, b) for (_, a), (_, b) in zip(ttrainer._leaves(la),
                                                                 ttrainer._leaves(lo))),
                  pa == 0 and po > 0]
    flags = torch.tensor([float(f) for f in flags])
    torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MIN)
    if rank == 0:
        torch.save(flags, out_path)


def test_attn_offload_under_a_mesh_equals_attn(tmp_path):
    """Four gloo ranks, one spawn: ring attention over context=2 x tensor=2
    (the ring's "attn_out" parked) and flash over fsdp=2 x tensor=2."""
    from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks

    out = tmp_path / "flags.pt"
    spawn_cpu_ranks(_mesh_ranks, 4, str(out), rendezvous_dir=str(tmp_path), threads=1)
    assert torch.load(out).tolist() == [1.0] * 8
