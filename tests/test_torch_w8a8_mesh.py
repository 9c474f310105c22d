"""W8A8 decode under a mesh with tensor > 1: the port's ``generate(mesh=)``
with ``w8a8_decode`` on four gloo ranks (fsdp=2 × tensor=2) against the
JAX package's jitted ``generate`` on four virtual CPU devices, one int8
tree.

A row-parallel product (wo, w_down) holds its rank's columns of each
input row, so its per-token amax is one all-reduce MAX over tensor, and
its int32 partial products add over tensor before the rescale: the
sharded W8A8 products are the one-device ones. The greedy tokens must
equal JAX's exactly. Margins: the sharded prefill logits equal the
port's one-device W8A8 logits to 1e-5 of their scale, which is far below
the smallest top-1/top-2 gap of the prefill's last positions, so equal
tokens are not a tie broken the same way by luck. One spawn.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models.generate import GenerateConfig as JGenerateConfig
from odh_kubeflow_tpu.models.generate import generate as jgenerate
from odh_kubeflow_tpu.models.llama import param_specs as jparam_specs
from odh_kubeflow_tpu.models.quant import quantized_param_specs as jquant_specs
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.parallel.mesh import shard_tree as jshard_tree
from odh_kubeflow_tpu_torch.models import llama, quant
from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, generate, init_cache
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from test_torch_llama import JCFG, TCFG, trees

WORLD = 4
AXES = dict(fsdp=2, tensor=2)
NEW = 8
LOGIT_RTOL = 1e-5
JW = dataclasses.replace(JCFG, w8a8_decode=True)
TW = dataclasses.replace(TCFG, w8a8_decode=True)


def _prompt():
    return np.random.default_rng(21).integers(1, JCFG.vocab_size, (2, 7)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    return trees("int8", seed=9)


@pytest.fixture(scope="module")
def jax_tokens(model):
    jp, _ = model
    mesh = jbuild_mesh(JMeshConfig(**AXES), jax.devices()[:WORLD])
    gen = JGenerateConfig(max_new_tokens=NEW, cache_dtype=jnp.float32)
    with jax.set_mesh(mesh):
        sharded = jshard_tree(jp, mesh, jquant_specs(jparam_specs(JCFG)))
        out = jax.jit(lambda p, t: jgenerate(p, t, JW, gen))(sharded, jnp.asarray(_prompt()))
    return np.asarray(out["tokens"])


def _prefill_logits(params, mesh=None):
    """The prefill's logits of this rank's rows (its fsdp block)."""
    toks = torch.from_numpy(_prompt()).long()
    B, S = toks.shape
    if mesh is not None:
        n = B // mesh.sizes["fsdp"]
        toks = toks[mesh.coords["fsdp"] * n:(mesh.coords["fsdp"] + 1) * n]
    cache = init_cache(TW, B, 16, dtype=torch.float32, device="cpu", mesh=mesh)
    pos = torch.arange(S)[None].expand(toks.shape[0], S)
    logits, _ = llama.forward_with_cache(params, toks, TW, cache, 0, positions=pos, mesh=mesh)
    return logits


def _ranks(rank, world, params, out_path):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**AXES), device="cpu")
    tp = mesh.group("tensor")
    # the row's amax after the all-reduce is the whole row's
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 5, 64)).astype(np.float32))
    x[..., 40] = 9.0  # the max of some rows on tensor rank 1's columns only
    half = x.shape[-1] // 2
    t = mesh.coords["tensor"]
    xq, sx = llama._quant_act(x[..., t * half:(t + 1) * half], tp)
    fq, fsx = llama._quant_act(x)
    res = {"amax": bool(torch.equal(sx, fsx)) and bool(torch.equal(xq, fq[..., t * half:(t + 1) * half]))}
    sharded = tmesh.shard_tree(params, mesh, quant.quantized_param_specs(llama.param_specs(TCFG)))
    gen = GenerateConfig(max_new_tokens=NEW, cache_dtype=torch.float32)
    res["tokens"] = generate(sharded, torch.from_numpy(_prompt()).long(), TW, gen,
                             mesh=mesh)["tokens"].numpy()
    res["logits"] = _prefill_logits(sharded, mesh).numpy()
    if rank == 0:
        res["one_logits"] = _prefill_logits(params).numpy()
        res["one_tokens"] = generate(params, torch.from_numpy(_prompt()).long(), TW,
                                     gen)["tokens"].numpy()
    flags = torch.tensor([float(res["amax"])])
    torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MIN)
    res["amax_all"] = float(flags)
    if rank == 0:
        torch.save(res, out_path)


@pytest.fixture(scope="module")
def port(model, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w8a8_mesh")
    out = tmp / "port.pt"
    spawn_cpu_ranks(_ranks, WORLD, model[1], str(out), rendezvous_dir=str(tmp), threads=1)
    return torch.load(out, weights_only=False)


def test_row_parallel_amax_is_the_whole_rows(port):
    """Every rank's scale equals the whole row's, and its int8 codes equal
    its columns of the whole row's codes."""
    assert port["amax_all"] == 1.0


def test_w8a8_tokens_under_tensor_2_equal_jax(port, jax_tokens):
    np.testing.assert_array_equal(port["tokens"], jax_tokens)
    np.testing.assert_array_equal(port["one_tokens"], jax_tokens)


def test_w8a8_sharded_logits_are_the_one_device_ones(port):
    """Rank 0 holds the first fsdp block of rows; its whole-vocab logits
    against the one-device logits of the same rows, and the last
    positions' greedy gaps far above the difference."""
    got, want = port["logits"], port["one_logits"][: port["logits"].shape[0]]
    scale = float(np.abs(want).max())
    diff = float(np.abs(got - want).max())
    assert diff <= LOGIT_RTOL * scale, (diff, scale)
    top2 = np.sort(port["one_logits"][:, -1], axis=-1)[:, -2:]
    gap = float((top2[:, 1] - top2[:, 0]).min())
    assert gap > 100 * max(diff, LOGIT_RTOL * scale), (gap, diff)
