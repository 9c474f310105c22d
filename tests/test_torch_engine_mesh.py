"""Serving under a mesh: the port's ``generate(mesh=)`` and
``DecodeEngine(mesh=)`` on eight gloo ranks against the JAX package's on
eight virtual CPU devices, at data=2 × fsdp=2 × tensor=2 (the reference's
``tests/test_engine.py::test_engine_under_mesh_greedy_exact`` and
``tests/test_generate.py::test_sharded_decode_matches_single_device``).

Each rank holds its shards of one float32 tiny Llama (``param_specs``)
and its block of the cache (``generate.cache_specs``: the slots over
(data, fsdp), the KV heads over tensor). Greedy tokens must equal JAX's
exactly: the sharded ``generate`` against JAX's jitted sharded
``generate``; the engine (4 prompts, ``prefill_chunk=16``: one prompt
admits in parts) against JAX's engine on the same mesh. Sampled
requests, prefix-cache hits and the speculative engine under the mesh
must equal the port's one-device engine running the same requests in the
same order (sampled ones one at a time: the noise a step draws depends on
the slots' history, not on the mesh). Also the refusals under a mesh:
``submit`` off rank 0, ``cuda_graphs=True`` with an axis > 1, a foreign
mesh. One spawn of eight ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models.engine import DecodeEngine as JDecodeEngine
from odh_kubeflow_tpu.models.generate import GenerateConfig as JGenerateConfig
from odh_kubeflow_tpu.models.generate import cache_specs as jcache_specs
from odh_kubeflow_tpu.models.generate import generate as jgenerate
from odh_kubeflow_tpu.models.llama import param_specs as jparam_specs
from odh_kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from odh_kubeflow_tpu.parallel.mesh import build_mesh as jbuild_mesh
from odh_kubeflow_tpu.parallel.mesh import shard_tree as jshard_tree
from odh_kubeflow_tpu_torch.models import llama
from odh_kubeflow_tpu_torch.models.engine import DecodeEngine
from odh_kubeflow_tpu_torch.models.generate import GenerateConfig, cache_specs, generate
from odh_kubeflow_tpu_torch.parallel import mesh as tmesh
from odh_kubeflow_tpu_torch.parallel.launch import spawn_cpu_ranks
from odh_kubeflow_tpu_torch.utils import prometheus
from test_torch_llama import JCFG, TCFG, trees

WORLD = 8
AXES = dict(data=2, fsdp=2, tensor=2)
WAIT = 300
PROMPTS = [[5, 9, 13], list(range(3, 40)), [7] * 10, [11, 2]]  # tests/test_engine.py's
NEW = 10
SAMPLED = [([5, 9, 13], dict(temperature=0.9, top_k=20)),
           (list(range(3, 40)), dict(temperature=0.7, top_p=0.9)),
           ([7] * 10, dict(temperature=1.2))]
SYSTEM = list(range(20, 40))  # a shared prompt prefix past the 16-token bucket
ENGINE_KW = dict(n_slots=4, max_len=256, chunk=4, prompt_buckets=(16, 64))


def _gen_prompt():
    return np.random.default_rng(11).integers(0, JCFG.vocab_size, (4, 6)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    return trees("f32", seed=3)


@pytest.fixture(scope="module")
def draft():
    return trees("f32", seed=4)


@pytest.fixture(scope="module")
def jax_ref(model):
    """JAX's sharded generate and its engine under the mesh."""
    jp, _ = model
    mesh = jbuild_mesh(JMeshConfig(**AXES), jax.devices())
    gen_cfg = JGenerateConfig(max_new_tokens=5, cache_dtype=jnp.float32)
    with jax.set_mesh(mesh):
        sharded = jshard_tree(jp, mesh, jparam_specs(JCFG))
        out = jax.jit(lambda p, t: jgenerate(p, t, JCFG, gen_cfg))(sharded,
                                                                  jnp.asarray(_gen_prompt()))
    eng = JDecodeEngine(sharded, JCFG, cache_dtype=jnp.float32, mesh=mesh, prefill_chunk=16,
                        **ENGINE_KW)
    try:
        handles = [eng.submit(p, max_tokens=NEW) for p in PROMPTS]
        engine_tokens = [h.result(timeout=WAIT) for h in handles]
    finally:
        eng.stop()
    return {"generate": np.asarray(out["tokens"]), "engine": engine_tokens}


def _engine(params, mesh=None, **kw):
    kw = {**ENGINE_KW, "cache_dtype": torch.float32, "device": "cpu",
          "metrics_registry": prometheus.Registry(), **kw}
    return DecodeEngine(params, TCFG, mesh=mesh, **kw)


def _script(eng):
    """The requests every engine of the comparison runs, in one order: the
    greedy prompts at once, the sampled ones one at a time, then a prompt
    sharing a cached prefix with the one before it."""
    out = {"greedy": [h.result(WAIT) for h in
                      [eng.submit(p, max_tokens=NEW) for p in PROMPTS]]}
    out["sampled"] = [eng.submit(p, max_tokens=8, **kw).result(WAIT) for p, kw in SAMPLED]
    hits = eng.prefix_hits
    out["prefix"] = [eng.submit(SYSTEM + tail, max_tokens=6).result(WAIT)
                     for tail in ([1, 2, 3], [4, 5])]
    out["prefix_hits"] = eng.prefix_hits - hits
    return out


def _spec_script(eng):
    return [h.result(WAIT) for h in [eng.submit(p, max_tokens=NEW) for p in PROMPTS]]


def _port_ranks(rank, world, params, draft, out_path):
    """Every case on this rank; rank 0 submits and runs the one-device
    engines after the mesh ones."""
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**AXES), device="cpu")
    specs = llama.param_specs(TCFG)
    sharded = tmesh.shard_tree(params, mesh, specs)
    res = {"generate": generate(sharded, torch.from_numpy(_gen_prompt()).long(), TCFG,
                                GenerateConfig(max_new_tokens=5, cache_dtype=torch.float32),
                                mesh=mesh)["tokens"].numpy()}
    try:
        _engine(sharded, mesh, cuda_graphs=True)
        res["graphs_refused"] = False
    except NotImplementedError as e:
        res["graphs_refused"] = "cuda_graphs=True under a mesh" in str(e)
    kw = dict(prefill_chunk=16, prefix_cache_entries=2, prefix_buckets=(16,))
    eng = _engine(sharded, mesh, **kw)
    spec_kw = dict(draft_params=tmesh.shard_tree(draft, mesh, specs), draft_cfg=TCFG)
    if rank:
        try:
            eng.submit([1, 2], max_tokens=2)
            res["submit_refused"] = False
        except RuntimeError as e:
            res["submit_refused"] = "rank 0 only" in str(e)
        eng.stop()  # waits for rank 0's stop
        spec = _engine(sharded, mesh, **spec_kw)
        spec.stop()
    else:
        try:
            res["mesh"] = _script(eng)
        finally:
            eng.stop()
        spec = _engine(sharded, mesh, **spec_kw)
        try:
            res["mesh_spec"] = _spec_script(spec)
        finally:
            spec.stop()
        one = _engine(params, **kw)
        try:
            res["one"] = _script(one)
        finally:
            one.stop()
        one = _engine(params, draft_params=draft, draft_cfg=TCFG)
        try:
            res["one_spec"] = _spec_script(one)
        finally:
            one.stop()
    flags = torch.tensor([float(res.get("submit_refused", True)), float(res["graphs_refused"])])
    torch.distributed.all_reduce(flags, op=torch.distributed.ReduceOp.MIN)
    if rank == 0:
        res["refusals"] = flags.tolist()
        torch.save(res, out_path)


@pytest.fixture(scope="module")
def port(model, draft, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine_mesh")
    out = tmp / "port.pt"
    spawn_cpu_ranks(_port_ranks, WORLD, model[1], draft[1], str(out), rendezvous_dir=str(tmp),
                    threads=1)
    return torch.load(out, weights_only=False)


def test_sharded_generate_matches_jax(port, jax_ref):
    np.testing.assert_array_equal(port["generate"], jax_ref["generate"])


def test_engine_under_mesh_matches_jax_engine(port, jax_ref):
    """Greedy, with one prompt admitted in 16-token parts, token for token."""
    assert port["mesh"]["greedy"] == jax_ref["engine"]


def test_engine_under_mesh_equals_the_one_device_engine(port):
    """Sampled streams and a prefix-cache hit under the mesh: the port's
    one-device engine's tokens, and the same hits."""
    assert port["mesh"] == port["one"]
    assert port["mesh"]["prefix_hits"] == 1
    assert all(len(t) == 8 for t in port["mesh"]["sampled"])


def test_speculative_engine_under_mesh(port, jax_ref):
    """The draft's cache shards as the target's; the tokens are greedy's."""
    assert port["mesh_spec"] == port["one_spec"] == jax_ref["engine"]


def test_engine_mesh_refusals(port, model):
    """``submit`` off rank 0 and ``cuda_graphs=True`` with an axis > 1 raise
    on every rank; a foreign mesh is a ``TypeError``."""
    assert port["refusals"] == [1.0, 1.0]
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        DecodeEngine(model[1], TCFG, mesh=object(), device="cpu")


def test_cache_specs_equal_jax():
    got = {k: tuple(v) for k, v in cache_specs(TCFG).items()}
    want = {k: tuple(v) for k, v in jcache_specs(JCFG).items()}
    assert got == want
