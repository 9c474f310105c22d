"""The port's pipeline drivers (``parallel/pipeline.py``) against the JAX
package's, on ``tests/test_pipeline.py``'s cases.

JAX runs on eight virtual CPU devices (``MeshConfig(pipe=S, data=8/S)``);
the port's process-group driver on four gloo ranks (``pipe=S,
data=4/S``), every rank holding the whole batch and its stage's layers,
all in float32, in one spawn. Cases: the MLP stack at (pipe, M) in
{(2, 4), (4, 2), (4, 8)}, output and gradients (1e-5 absolute, as JAX's
test); ``aux`` following its microbatch; a tiny Llama stack of decoder
layers at pipe 2 (1e-4); 1F1B against GPipe plus autograd on the ranks,
and against JAX's 1F1B (loss, dlayers, dhead, dx at 1e-4 of their largest
element, JAX's bar), with every stage's gradient rows populated; the
loopback drivers equal to the ranks bit for bit, both schedules; the
schedules' tick count 2(M+S-1) and 1F1B's ring depth min(S, M); the
divisibility errors with JAX's texts. Then, port only, the model-level
loopback the card check drives: ``forward(loopback_stages=)`` against the
unpipelined forward (Llama hidden states and adapter gradients; a MoE's
aux the mean of the microbatches' auxes), and 1F1B over the Llama stack
against GPipe plus autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from odh_kubeflow_tpu.models import llama as jllama
from odh_kubeflow_tpu.parallel.mesh import AXIS_PIPE as JPIPE
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from odh_kubeflow_tpu.parallel.pipeline import pipeline_train_1f1b as jpipeline_train_1f1b
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel import pipeline as pp
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks

WORLD = 4
L, D, B = 8, 16, 8
GRID = [(2, 4), (4, 2), (4, 8)]
AUX_M = 4
LLAMA_B, LLAMA_S = 2, 8
LAYER_SPEC = tmesh.P(tmesh.AXIS_PIPE)


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w1": f(L, D, D) * 0.1, "w2": f(L, D, D) * 0.1, "x": f(B, D), "targets": f(B, D),
            "head": f(D) * 0.3, "llama_x": f(LLAMA_B, LLAMA_S, 64)}


# ---------------------------------------------------------------------------
# JAX


def _jstage(stage_params, x):
    def layer(x, lp):
        return x + jax.nn.gelu(x @ lp["w1"], approximate=False) @ lp["w2"], None

    return jax.lax.scan(layer, x, stage_params)[0]


def _jhead(hp, y):
    return jnp.sum((y @ hp["w"]) ** 2)


def _jput(params, mesh):
    return jax.device_put(params, jax.tree.map(lambda _: NamedSharding(mesh, JP(JPIPE)), params))


def _jmesh(pipe):
    return jbuild_mesh(JMeshConfig(pipe=pipe, data=8 // pipe), jax.devices()[:8])


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_ref(inputs):
    params = {"w1": jnp.asarray(inputs["w1"]), "w2": jnp.asarray(inputs["w2"])}
    x, targets = jnp.asarray(inputs["x"]), jnp.asarray(inputs["targets"])
    head = {"w": jnp.asarray(inputs["head"])}
    out = {"grid": {}, "1f1b": {}}
    for pipe, M in GRID:
        mesh = _jmesh(pipe)
        with jax.set_mesh(mesh):
            def loss(p, x, M=M):
                y = jpipeline_apply(_jstage, p, x, num_microbatches=M)
                return jnp.mean((y - targets) ** 2), y

            (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                _jput(params, mesh), x)
            lo, dl, dh, dx = jax.jit(lambda p, hp, x, M=M: jpipeline_train_1f1b(
                _jstage, _jhead, p, hp, x, num_microbatches=M))(_jput(params, mesh), head, x)
        out["grid"][(pipe, M)] = (np.asarray(y), {k: np.asarray(v) for k, v in gp.items()},
                                  np.asarray(gx))
        out["1f1b"][(pipe, M)] = (float(lo), {k: np.asarray(v) for k, v in dl.items()},
                                  np.asarray(dh["w"]), np.asarray(dx))
    # aux: microbatch i's tag i, added by each of the 2 stages
    mesh = _jmesh(2)
    with jax.set_mesh(mesh):
        out["aux"] = np.asarray(jax.jit(lambda p, x, a: jpipeline_apply(
            lambda sp, s, at: _jstage(sp, s) + at["tag"], p, x, num_microbatches=AUX_M,
            aux=a))(_jput(params, mesh), x, {"tag": jnp.arange(AUX_M, dtype=jnp.float32)}))
    # the tiny Llama stack, 2 stages of one layer each
    cfg = jllama.LlamaConfig.tiny(remat=False, dtype=jnp.float32)
    lp = jllama.init_params(jax.random.PRNGKey(0), cfg)["layers"]
    positions = jnp.arange(LLAMA_S, dtype=jnp.int32)[None, :]
    sin, cos = jllama.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    attn = jllama._select_attention(cfg)

    def layer_fn(x, l):
        return jllama._decoder_layer(cfg, attn, x, l, None, sin, cos, None)[0], None

    def stage_fn(stage_layers, x_mb):
        xx = x_mb.reshape(x_mb.shape[0], LLAMA_S, cfg.hidden_size)
        return jax.lax.scan(layer_fn, xx, stage_layers)[0].reshape(x_mb.shape)

    lx = jnp.asarray(inputs["llama_x"])
    with jax.set_mesh(mesh):
        y = jax.jit(lambda p, xf: jpipeline_apply(stage_fn, p, xf, num_microbatches=2))(
            _jput(lp, mesh), lx.reshape(LLAMA_B, -1))
    out["llama"] = ({k: np.asarray(v) for k, v in lp.items()}, np.asarray(y).reshape(lx.shape))
    return out


# ---------------------------------------------------------------------------
# the port


def _stage(p, x):
    for i in range(p["w1"].shape[0]):
        x = x + F.gelu(x @ p["w1"][i]) @ p["w2"][i]
    return x


def _head(hp, y):
    return ((y @ hp["w"]) ** 2).sum()


def _leaf(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _mlp_on_rank(mesh, inputs, M):
    """GPipe's output and gradients of the mean squared error, 1F1B's result,
    both gathered; and the same through the loopback drivers (rank 0)."""
    S = mesh.sizes[tmesh.AXIS_PIPE]
    full = {k: _leaf(inputs[k], False) for k in ("w1", "w2")}
    local = {k: v.detach().requires_grad_(True)
             for k, v in tmesh.shard_tree(full, mesh, {"w1": LAYER_SPEC, "w2": LAYER_SPEC}).items()}
    x, targets = _leaf(inputs["x"]), torch.from_numpy(inputs["targets"])
    y = pp.pipeline_apply(_stage, local, x, num_microbatches=M, mesh=mesh)
    dy = torch.autograd.grad(((y - targets) ** 2).mean(), y, retain_graph=True)[0]
    # the loss reads y once: its cotangent enters on one rank of the group
    last = mesh.coords[tmesh.AXIS_PIPE] == S - 1
    g1, g2, gx = torch.autograd.grad(y, [local["w1"], local["w2"], x],
                                     dy if last else torch.zeros_like(dy), allow_unused=True)
    pipe = mesh.group(tmesh.AXIS_PIPE)
    gx = _psum(torch.zeros_like(x) if gx is None else gx, pipe)  # stage 0's, on every rank
    grads = {"w1": tmesh.gather_full(g1, mesh, LAYER_SPEC),
             "w2": tmesh.gather_full(g2, mesh, LAYER_SPEC)}
    head = {"w": _leaf(inputs["head"])}
    lo, dl, dh, dx = pp.pipeline_train_1f1b(_stage, _head, local, head, x, num_microbatches=M,
                                            mesh=mesh)
    dl = {k: tmesh.gather_full(v, mesh, LAYER_SPEC) for k, v in dl.items()}
    # GPipe plus autograd of the same per-microbatch loss, on the ranks
    y2 = pp.pipeline_apply(_stage, local, x, num_microbatches=M, mesh=mesh)
    want = sum(_head(head, c) for c in y2.chunk(M)) / M
    wg = torch.autograd.grad(want / S, [local["w1"], local["w2"], head["w"], x],
                             allow_unused=True)
    wg = [tmesh.gather_full(wg[0], mesh, LAYER_SPEC), tmesh.gather_full(wg[1], mesh, LAYER_SPEC),
          *(torch.zeros_like(x) if g is None else g for g in wg[2:])]
    wg[2:] = [_psum(g, pipe) for g in wg[2:]]
    res = {"y": y.detach().numpy(), "grads": {k: v.numpy() for k, v in grads.items()},
           "dx": gx.numpy(), "1f1b": (float(lo), {k: v.numpy() for k, v in dl.items()},
                                      dh["w"].numpy(), dx.numpy()),
           "gpipe_autograd": (float(want), [g.numpy() for g in wg])}
    if mesh.rank == 0:
        res["loopback"] = _loopback_equal(full, inputs, M, S, y, dy, grads, gx,
                                          (lo, dl, dh, dx))
    return res


def _psum(t, group):
    import torch.distributed as dist

    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def _loopback_equal(full, inputs, M, S, y, dy, grads, gx, ranks_1f1b) -> dict:
    """Both loopback drivers against the ranks' results, bit for bit."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in full.items()}
    x = _leaf(inputs["x"])
    yl = pp.loopback_pipeline_apply(_stage, params, x, num_microbatches=M, num_stages=S)
    g1, g2, gxl = torch.autograd.grad(yl, [params["w1"], params["w2"], x], dy)
    head = {"w": _leaf(inputs["head"])}
    lo, dl, dh, dx = pp.loopback_pipeline_train_1f1b(_stage, _head, params, head, x,
                                                     num_microbatches=M, num_stages=S)
    rlo, rdl, rdh, rdx = ranks_1f1b
    return {
        "gpipe": torch.equal(yl, y) and torch.equal(g1, grads["w1"])
        and torch.equal(g2, grads["w2"]) and torch.equal(gxl, gx),
        "1f1b": torch.equal(lo, rlo) and torch.equal(dl["w1"], rdl["w1"])
        and torch.equal(dl["w2"], rdl["w2"]) and torch.equal(dh["w"], rdh["w"])
        and torch.equal(dx, rdx),
    }


def _llama_on_rank(mesh, lp_np, lx):
    cfg = llama.LlamaConfig.tiny(remat=False, dtype=torch.float32)
    layers = tmesh.shard_tree(convert.from_numpy_tree(lp_np, "cpu"), mesh,
                              {k: LAYER_SPEC for k in lp_np})
    positions = torch.arange(LLAMA_S)[None, :]
    from odh_kubeflow_tpu_torch.ops.rope import rope_angles

    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    layer_fn = llama._make_layer_fn(cfg, "dense", llama.causal_attention_fn("dense"), "none")
    x = torch.from_numpy(lx)
    stage_fn, stage_params, aux = llama.pipeline_args(
        layer_fn, layers, None, sin.expand(LLAMA_B, -1, -1), cos.expand(LLAMA_B, -1, -1), None, 2)
    with torch.no_grad():
        return pp.pipeline_apply(stage_fn, stage_params, x, num_microbatches=2, aux=aux,
                                 mesh=mesh).numpy()


def _port_ranks(rank, world, inputs, llama_ref, out_path):
    res = {"grid": {}}
    for pipe, M in GRID:
        mesh = tmesh.build_mesh(tmesh.MeshConfig(pipe=pipe, data=world // pipe), device="cpu")
        res["grid"][(pipe, M)] = _mlp_on_rank(mesh, inputs, M)
    mesh = tmesh.build_mesh(tmesh.MeshConfig(pipe=2, data=world // 2), device="cpu")
    local = tmesh.shard_tree({k: torch.from_numpy(inputs[k]) for k in ("w1", "w2")}, mesh,
                             {"w1": LAYER_SPEC, "w2": LAYER_SPEC})
    with torch.no_grad():
        res["aux"] = pp.pipeline_apply(
            lambda sp, s, at: _stage(sp, s) + at["tag"], local, torch.from_numpy(inputs["x"]),
            num_microbatches=AUX_M, aux={"tag": torch.arange(AUX_M, dtype=torch.float32)},
            mesh=mesh).numpy()
    res["llama"] = _llama_on_rank(mesh, *llama_ref)
    if rank == 0:
        torch.save(res, out_path)


@pytest.fixture(scope="module")
def port(inputs, jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    out = tmp / "port.pt"
    spawn_cpu_ranks(_port_ranks, WORLD, inputs, (jax_ref["llama"][0], inputs["llama_x"]),
                    str(out), rendezvous_dir=str(tmp))
    return torch.load(out, weights_only=False)


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-9)


@pytest.mark.parametrize("pipe,microbatches", GRID)
def test_pipeline_matches_jax(pipe, microbatches, port, jax_ref):
    got, (y, gp, gx) = port["grid"][(pipe, microbatches)], jax_ref["grid"][(pipe, microbatches)]
    np.testing.assert_allclose(got["y"], y, atol=1e-5)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(got["grads"][k], gp[k], atol=1e-5)
    np.testing.assert_allclose(got["dx"], gx, atol=1e-5)


def test_pipeline_aux_follows_its_microbatch(port, jax_ref):
    np.testing.assert_allclose(port["aux"], jax_ref["aux"], atol=1e-5)


def test_llama_layer_stack_pipelines(port, jax_ref):
    np.testing.assert_allclose(port["llama"], jax_ref["llama"][1], atol=1e-4)


@pytest.mark.parametrize("pipe,microbatches", GRID)
def test_1f1b_matches_gpipe_autograd_and_jax(pipe, microbatches, port, jax_ref):
    got = port["grid"][(pipe, microbatches)]
    lo, dl, dh, dx = got["1f1b"]
    want, (w1, w2, wh, wx) = got["gpipe_autograd"]
    assert abs(lo - want) < 1e-4 * abs(want)
    for g, w in ((dl["w1"], w1), (dl["w2"], w2), (dh, wh), (dx, wx)):
        assert _rel(g, w) < 1e-4
    jlo, jdl, jdh, jdx = jax_ref["1f1b"][(pipe, microbatches)]
    assert abs(lo - jlo) < 1e-4 * abs(jlo)
    for g, w in ((dl["w1"], jdl["w1"]), (dl["w2"], jdl["w2"]), (dh, jdh), (dx, jdx)):
        assert _rel(g, w) < 1e-4
    for k in ("w1", "w2"):  # every stage contributed: no layer's gradient is all zero
        assert (np.abs(dl[k]).sum(axis=(1, 2)) > 0).all()


@pytest.mark.parametrize("pipe,microbatches", GRID)
def test_loopback_equals_the_ranks_bit_for_bit(pipe, microbatches, port):
    assert port["grid"][(pipe, microbatches)]["loopback"] == {"gpipe": True, "1f1b": True}


@pytest.mark.parametrize("pipe,microbatches", GRID)
def test_schedule_ticks_and_1f1b_ring_depth(pipe, microbatches):
    S, M = pipe, microbatches
    for kind in pp.KINDS:
        ticks = pp.schedule(S, M, kind)
        assert len(ticks) == 2 * (M + S - 1)
        actions = [a for t in ticks for a in t]
        assert sorted((a.stage, a.op, a.microbatch) for a in actions) == sorted(
            (s, op, m) for s in range(S) for op in "FB" for m in range(M))
        for t in ticks:  # one action a stage a tick
            assert len({a.stage for a in t}) == len(t)
    one = pp.schedule(S, M, "1f1b")
    assert max(pp.max_in_flight(one, s) for s in range(S)) == min(S, M)
    assert [pp.max_in_flight(one, s) for s in range(S)] == [min(S - s, M) for s in range(S)]
    assert [pp.max_in_flight(pp.schedule(S, M, "gpipe"), s) for s in range(S)] == [M] * S
    # a message is read the tick after it is sent: F(m) of stage s+1 and
    # B(m) of stage s-1 follow F(m) and B(m) of stage s by one tick
    at = {(a.stage, a.op, a.microbatch): i for i, t in enumerate(one) for a in t}
    for s in range(S - 1):
        for m in range(M):
            assert at[(s + 1, "F", m)] == at[(s, "F", m)] + 1
            assert at[(s, "B", m)] == at[(s + 1, "B", m)] + 1


def test_pipeline_validates_divisibility():
    """JAX's texts: a layer dim the stages do not divide, a batch the
    microbatches do not divide; and a mesh without the axis."""
    jmesh = _jmesh(4)
    with jax.set_mesh(jmesh):
        with pytest.raises(ValueError) as jl:
            jpipeline_apply(_jstage, {"w1": jnp.ones((6, 4, 4)), "w2": jnp.ones((6, 4, 4))},
                            jnp.ones((4, 4)), num_microbatches=2)
        with pytest.raises(ValueError) as jb:
            jpipeline_apply(_jstage, {"w1": jnp.ones((8, 4, 4)), "w2": jnp.ones((8, 4, 4))},
                            jnp.ones((5, 4)), num_microbatches=2)
    with pytest.raises(ValueError) as tl:
        pp.loopback_pipeline_apply(_stage, {"w1": torch.ones(6, 4, 4), "w2": torch.ones(6, 4, 4)},
                                   torch.ones(4, 4), num_microbatches=2, num_stages=4)
    assert str(tl.value) == str(jl.value)
    mesh = tmesh.Mesh(tmesh.MeshConfig(pipe=4), torch.device("cpu"), None, rank=0)
    for call in (
        lambda: pp.loopback_pipeline_apply(
            _stage, {"w1": torch.ones(8, 4, 4), "w2": torch.ones(8, 4, 4)}, torch.ones(5, 4),
            num_microbatches=2, num_stages=4),
        lambda: pp.pipeline_apply(_stage, {"w1": torch.ones(2, 4, 4), "w2": torch.ones(2, 4, 4)},
                                  torch.ones(5, 4), num_microbatches=2, mesh=mesh),
        lambda: pp.pipeline_train_1f1b(_stage, _head, {"w1": torch.ones(2, 4, 4)}, {},
                                       torch.ones(5, 4), num_microbatches=2, mesh=mesh),
    ):
        with pytest.raises(ValueError) as tb:
            call()
        assert str(tb.value) == str(jb.value)
    with pytest.raises(ValueError, match="mesh has no 'pipe' axis"):
        pp.pipeline_apply(_stage, {}, torch.ones(4, 4), num_microbatches=2, mesh=None)


# ---------------------------------------------------------------------------
# the model-level loopback (what the card check drives), port only


def _tiny_lora(num_layers=4):
    from odh_kubeflow_tpu_torch.models import lora

    cfg = llama.LlamaConfig.tiny(num_layers=num_layers, dtype=torch.float32)
    params = llama.init_params(0, cfg, device="cpu")
    adapters = lora.init_lora_params(1, cfg, lora.LoraConfig(rank=4), device="cpu")
    gen = torch.Generator().manual_seed(2)
    for ab in adapters["layers"].values():  # live adapters: every leaf has a gradient
        ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen) * 0.1)
    tokens = torch.randint(0, cfg.vocab_size, (8, 16), generator=gen)
    return cfg, params, adapters, tokens


def _adapter_grads(loss, adapters):
    from odh_kubeflow_tpu_torch.train.trainer import _leaves

    paths, leaves = zip(*_leaves(adapters))
    return dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _close_trees(got, want, rtol):
    for p, w in want.items():
        assert float((got[p] - w).norm() / w.norm()) < rtol, p


@pytest.mark.parametrize("stages,microbatches", [(2, 2), (4, 8)])
def test_llama_forward_loopback_matches_unpipelined(stages, microbatches):
    """``forward(loopback_stages=)``: the hidden states and the adapters'
    gradients of the unpipelined forward (float32: the microbatches' products
    round alike to 1e-6)."""
    cfg, params, adapters, tokens = _tiny_lora()
    for ab in adapters["layers"].values():
        for t in ab.values():
            t.requires_grad_(True)
    out = {}
    for name, kw in (("whole", {}), ("piped", dict(loopback_stages=stages,
                                                   pipeline_microbatches=microbatches))):
        h = llama.forward(params, tokens, cfg, lora=adapters, return_hidden=True, **kw)
        out[name] = (h.detach(), _adapter_grads((h**2).mean(), adapters))
    np.testing.assert_allclose(out["piped"][0].numpy(), out["whole"][0].numpy(), atol=1e-5)
    _close_trees(out["piped"][1], out["whole"][1], 1e-5)


def test_llama_1f1b_matches_gpipe_on_the_stack():
    """1F1B over the decoder stack (``llama.pipeline_args``) against GPipe
    plus autograd with one per-microbatch head: loss and adapter gradients."""
    from odh_kubeflow_tpu_torch.ops.norms import rms_norm
    from odh_kubeflow_tpu_torch.ops.rope import rope_angles
    from odh_kubeflow_tpu_torch.train.trainer import _leaves, chunked_cross_entropy

    cfg, params, adapters, tokens = _tiny_lora()
    for ab in adapters["layers"].values():
        for t in ab.values():
            t.requires_grad_(True)
    S, M = 2, 4
    B, T = tokens.shape
    sin, cos = rope_angles(torch.arange(T).expand(B, T), cfg.head_dim, cfg.rope_theta)
    layer_fn = llama._make_layer_fn(cfg, "dense", llama.causal_attention_fn("dense"), "none")
    stage_fn, stage_params, aux = llama.pipeline_args(
        layer_fn, params["layers"], adapters["layers"], sin, cos, None, M)
    aux["targets"] = torch.roll(tokens, -1, 1).reshape(M, B // M, T)
    head = {"final_norm": params["final_norm"], "head": params["lm_head"]}

    def head_fn(hp, y, a):
        h = rms_norm(y, hp["final_norm"], cfg.rms_norm_eps)
        return chunked_cross_entropy(h, hp["head"], a["targets"], chunk=T)

    x = params["embed"][tokens]
    y = pp.loopback_pipeline_apply(stage_fn, stage_params, x, num_microbatches=M, num_stages=S,
                                   aux=aux)
    want = sum(head_fn(head, y_m, pp._aux_at(aux, m)) for m, y_m in enumerate(y.chunk(M))) / M
    want_grads = _adapter_grads(want, adapters)
    loss, dlayers, _, dx = pp.loopback_pipeline_train_1f1b(
        stage_fn, head_fn, stage_params, head, x, num_microbatches=M, num_stages=S, aux=aux)
    assert dx is None and dlayers["layers"]["wq"] is None  # what needs no gradient gets none
    np.testing.assert_allclose(float(loss), want.item(), rtol=1e-6)
    _close_trees(dict(_leaves({"layers": dlayers["lora"]})), want_grads, 1e-5)


def test_moe_forward_loopback_aux_is_the_microbatch_mean():
    """``moe.forward(loopback_stages=)``: the hidden states of the
    unpipelined forward, and the aux the mean of each microbatch's own
    (the load-balancing loss is not linear in the batch)."""
    from odh_kubeflow_tpu_torch.models import moe

    cfg = moe.MoeConfig.mixtral_tiny(base=llama.LlamaConfig.tiny(num_layers=4,
                                                                 dtype=torch.float32))
    params = moe.init_params(0, cfg, device="cpu")
    params["layers"]["router"] = params["layers"]["router"] * 8.0
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        whole, whole_aux = moe.forward(params, tokens, cfg, return_hidden=True)
        piped, aux = moe.forward(params, tokens, cfg, return_hidden=True, loopback_stages=2,
                                 pipeline_microbatches=4)
        per = [float(moe.forward(params, t[None], cfg, return_hidden=True)[1]) for t in tokens]
    np.testing.assert_allclose(piped.numpy(), whole.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(aux), sum(per) / 4, rtol=1e-6)
    assert abs(float(aux) - float(whole_aux)) > 1e-6 * abs(float(whole_aux))
