"""MoE serving under a mesh: the port's ``generate(mesh=)`` and
``DecodeEngine(mesh=)`` for ``mixtral_tiny`` on four gloo ranks at fsdp=2
× expert=2 against the JAX package's ``generate`` on four virtual CPU
devices with the same mesh.

The batch splits over fsdp and is replicated over expert: each expert
rank runs its experts' slots of every row and the shards' outputs are
all-reduced (``models/moe.py`` ``_moe_mlp_sharded``, rows replicated over
expert); an engine admission's one prompt is replicated over every batch
axis. Cases: greedy ``generate`` with the default ragged dispatch (its
capacity drops are JAX's: the same rows, the same sequence length) and
with a grouped config (decode and small prefills take the exact ragged
path), token for token against JAX's; the grouped config's engine (4
slots, ``prefill_chunk=16``: the longest prompt admits in parts) against
JAX's ``generate`` of each prompt; and a grouped ``generate`` whose
prefill is large enough for the expert-parallel grouped path (4 × 512
prompts: 2,048 assignments a (data, fsdp) group), its rows replicated over
expert, against the port's one-device ``generate`` (dropless both ways).
The router is scaled by ``GAIN`` so that every top-2 margin of the
routings compared with JAX clears ``MARGIN`` 8×; the 2,048-token prompts
of the port-only case are held to ``MARGIN`` itself (both sides float32
in one package). Float32, one spawn of four ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.models.generate import GenerateConfig as JGenerateConfig
from odh_kubeflow_tpu.models.generate import generate as jgenerate
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.parallel.mesh import shard_tree as jshard_tree
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import moe
from odh_kubeflow_tpu_torch.models.engine import DecodeEngine
from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_moe import JCFG, MARGIN, TCFG

WORLD = 4
AXES = dict(fsdp=2, expert=2)
GAIN = 16.0
NEW = 8
DISPATCHES = ("ragged", "grouped")
PROMPTS = [[5, 9, 13], list(range(3, 40)), [7] * 10, [11, 2]]
WAIT = 300


def _params():
    jp = jmoe.init_params(jax.random.key(0), JCFG)
    jp["layers"]["router"] = jp["layers"]["router"] * GAIN
    return jax.tree.map(np.asarray, jp)


def _gen_prompt():
    return np.random.default_rng(11).integers(1, JCFG.vocab_size, (4, 12)).astype(np.int32)


def _padded():
    rows = np.zeros((len(PROMPTS), max(map(len, PROMPTS))), np.int32)
    for i, p in enumerate(PROMPTS):
        rows[i, : len(p)] = p
    return rows, np.array([len(p) for p in PROMPTS], np.int32)


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def jax_ref(params):
    mesh = jbuild_mesh(JMeshConfig(**AXES), jax.devices()[:WORLD])
    out = {}
    with jax.set_mesh(mesh):
        for d in DISPATCHES:
            cfg = dataclasses.replace(JCFG, dispatch=d)
            sharded = jshard_tree(jax.tree.map(jnp.asarray, params), mesh, jmoe.param_specs(cfg))
            gen_cfg = JGenerateConfig(max_new_tokens=NEW, cache_dtype=jnp.float32)
            out[d] = np.asarray(jax.jit(lambda p, t, c=cfg: jgenerate(p, t, c, gen_cfg))(
                sharded, jnp.asarray(_gen_prompt()))["tokens"])
        rows, lengths = _padded()
        cfg = dataclasses.replace(JCFG, dispatch="grouped")
        sharded = jshard_tree(jax.tree.map(jnp.asarray, params), mesh, jmoe.param_specs(cfg))
        toks = jgenerate(sharded, jnp.asarray(rows), cfg,
                         JGenerateConfig(max_new_tokens=NEW, cache_dtype=jnp.float32),
                         prompt_lengths=jnp.asarray(lengths))["tokens"]
    out["engine"] = np.asarray(toks).tolist()
    return out


def _port_ranks(rank, world, params, out_path):
    seen = []
    stats = moe._routing_stats

    def spy(logits, cfg, token_mask=None):
        live = logits if token_mask is None else logits[token_mask]
        z = live.detach().float().sort(-1, descending=True).values
        k = cfg.num_experts_per_tok
        seen.append(float((z[..., :k] - z[..., 1 : k + 1]).min()))
        return stats(logits, cfg, token_mask)

    moe._routing_stats = spy
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**AXES), device="cpu")
    tree = convert.from_numpy_tree(params, device="cpu")
    res = {}
    for d in DISPATCHES:
        cfg = dataclasses.replace(TCFG, dispatch=d)
        sharded = tmesh.shard_tree(tree, mesh, moe.param_specs(cfg))
        res[d] = generate(sharded, torch.from_numpy(_gen_prompt()).long(), cfg,
                          GenerateConfig(max_new_tokens=NEW, cache_dtype=torch.float32),
                          mesh=mesh)["tokens"].numpy()
    eng = DecodeEngine(sharded, cfg, n_slots=4, max_len=128, chunk=4, prompt_buckets=(16, 64),
                       cache_dtype=torch.float32, prefill_chunk=16, mesh=mesh, device="cpu",
                       metrics_registry=prometheus.Registry())
    if rank == 0:
        try:
            res["engine"] = [h.result(WAIT) for h in
                             [eng.submit(p, max_tokens=NEW) for p in PROMPTS]]
        finally:
            eng.stop()
    else:
        eng.stop()
    jax_margin = min(seen)
    seen.clear()
    # the expert-parallel grouped prefill in serving: rows not split over expert
    long = torch.from_numpy(np.random.default_rng(12).integers(
        1, JCFG.vocab_size, (4, 512))).long()
    gcfg = GenerateConfig(max_new_tokens=3, cache_dtype=torch.float32)
    res["ep_path"] = moe.dispatch_path(torch.empty((4, 512, 64), device="meta"), cfg, mesh)
    res["ep_generate"] = generate(sharded, long, cfg, gcfg, mesh=mesh)["tokens"].numpy()
    margins = torch.tensor([jax_margin, min(seen)])
    torch.distributed.all_reduce(margins, op=torch.distributed.ReduceOp.MIN)
    res["margin"], res["ep_margin"] = margins.tolist()
    if rank == 0:
        res["ep_one_device"] = generate(tree, long, cfg, gcfg)["tokens"].numpy()
        torch.save(res, out_path)


@pytest.fixture(scope="module")
def port(params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_serve_mesh")
    out = tmp / "port.pt"
    spawn_cpu_ranks(_port_ranks, WORLD, params, str(out), rendezvous_dir=str(tmp), threads=1)
    res = torch.load(out, weights_only=False)
    assert res["margin"] > 8 * MARGIN, res["margin"]
    return res


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_sharded_generate_matches_jax(dispatch, port, jax_ref):
    np.testing.assert_array_equal(port[dispatch], jax_ref[dispatch])


def test_moe_grouped_ep_prefill_in_serving(port):
    assert port["ep_margin"] > MARGIN, port["ep_margin"]
    assert port["ep_path"] == "grouped_ep"
    np.testing.assert_array_equal(port["ep_generate"], port["ep_one_device"])


def test_moe_engine_under_mesh_matches_jax_generate(port, jax_ref):
    assert port["engine"] == [row[:NEW] for row in jax_ref["engine"]]
