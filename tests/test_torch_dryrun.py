"""The port's ``dryrun_multichip`` (``tools/dryrun_multichip_torch.py``) at
n = 8, in one spawn of eight gloo ranks: the six kinds of
``dryrun_multichip ok`` line the JAX version prints (two mesh rotations
over data, fsdp, context and tensor, the second on an int8 QLoRA base; the
expert-parallel grouped MoE step; the pipe=2 trainer; pipe=2 x expert=2;
the sharded engine), and the sharded engine's greedy tokens, which equal
the one-device ``generate`` of the port (the tool's own check) and of the
JAX package on the same weights. The mesh rotations are the JAX version's
``_mesh_configs`` for every n. Without ``--device cpu`` the tool wants a
card a rank."""

import dataclasses
import importlib.util
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.models import llama as jax_llama
from odh_kubeflow_tpu.models.generate import GenerateConfig as JGenerateConfig
from odh_kubeflow_tpu.models.generate import generate as jgenerate
from odh_kubeflow_tpu_torch import convert
from odh_kubeflow_tpu_torch.models import llama

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the ranks unpickle the tool's function by its module's name: the spawned
# processes take this sys.path
sys.path.insert(0, str(REPO / "tools"))
import dryrun_multichip_torch as tool  # noqa: E402

KINDS = (
    r"mesh=\{'data': 1, 'fsdp': 2, 'context': 2, 'tensor': 2\} loss=",
    r"mesh=\{'data': 2, 'fsdp': 2, 'context': 2, 'tensor': 1\} \(int8 QLoRA base\) loss=",
    r"mesh=\{'data': 2, 'fsdp': 2, 'expert': 2\} \(MoE expert-parallel, dispatch=grouped\) "
    r"loss=",
    r"mesh=\{'data': 4, 'pipe': 2\} \(GPipe pipeline-parallel trainer\) loss=",
    r"mesh=\{'data': 2, 'pipe': 2, 'expert': 2\} \(MoE pipeline x expert parallel\) loss=",
    r"mesh=\{'data': 2, 'fsdp': 2, 'tensor': 2\} \(sharded DecodeEngine serving, chunked "
    r"prefill\) greedy-exact 6 tokens",
)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    return tool.run(8, "cpu", workdir=str(tmp_path_factory.mktemp("dryrun")))


def test_dryrun_prints_the_six_kinds_of_ok_line(record):
    lines = record["lines"]
    assert len(lines) == len(KINDS)
    for line, kind in zip(lines, KINDS):
        assert re.fullmatch(r"dryrun_multichip ok: " + kind + r"(\d+\.\d{4})?", line), line
        if "loss=" in line:
            assert np.isfinite(float(line.rsplit("=", 1)[1]))


def test_sharded_engine_tokens_equal_generate_of_both_packages(record):
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init_params(3, cfg, torch.float32, device="cpu")  # the tool's weights
    jp = jax.tree.map(jnp.asarray, convert.to_numpy_tree(params))
    prompt = list(range(3, 3 + 24))
    want = jgenerate(jp, jnp.asarray([prompt], jnp.int32),
                     jax_llama.LlamaConfig.tiny(dtype=jnp.float32),
                     JGenerateConfig(max_new_tokens=6, cache_dtype=jnp.float32))
    jtoks = np.asarray(want["tokens"][0][: int(want["lengths"][0])]).tolist()
    assert record["engine_tokens"] == record["generate_tokens"] == jtoks
    assert len(jtoks) == 6


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_mesh_rotations_are_the_reference_ones(n):
    ref = _load("graft_entry", REPO / "__graft_entry__.py")._mesh_configs(n)
    got = tool.mesh_configs(n)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in ref]


def test_the_default_device_is_the_card(monkeypatch):
    """Without ``--device cpu`` the dry run runs an NCCL rank a card, and
    raises when fewer cards are visible than ranks asked for."""
    monkeypatch.setattr(tool.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards, 1 visible"):
        tool.main(["2"])
