"""The port's pipelined trainer against the JAX package's for a grouped MoE
(the Mixtral-shaped family), as ``tests/test_torch_pipeline_trainer.py``
holds the Llama family: four gloo ranks against four virtual devices,
three steps from the JAX trainer's initial state, float32, the same
tolerances.

Cases: the QLoRA step on int8 banks at pipe=2 × expert=2 (the
expert-parallel path inside each stage, on the stage's expert group) and
the full fine-tune at pipe=2 × data=2. A microbatch needs B·S·k >= 2048
assignments a (data, fsdp) group to take the grouped path, hence S 512.
Each rank's block of the batch is taken microbatch-major, so its
microbatch m is its share of the global microbatch m: the router aux is
each microbatch's own, and the step's aux their mean (JAX's pipelined
value, not the unpipelined aux of the whole batch).

JAX's pipelined trainer aborts on pipe × expert (its expert-parallel
``shard_map`` nests inside the pipeline's, which is manual over ``pipe``
already). So that case's reference is JAX's ``Trainer`` on an expert=2
mesh whose loss is JAX's pipelined semantics written out
(``_PerMicrobatch``: the mean over the microbatches of each one's LM loss
and aux through JAX's unpipelined forward).
``test_per_microbatch_reference_is_jax_pipelined`` holds that
construction to JAX's own pipelined trainer where JAX runs it (the full
fine-tune at pipe=2 × data=2, against data=2). The routers are scaled so
that every routing's smallest top-2 margin stays far above ``MARGIN``:
routing is discontinuous. The full fine-tune steps at lr 1e-3 (``CASES``). Also the pipelined int8 init against the
one-device init, bit for bit, and the replicated leaves across stages.
"""

import pytest

from test_torch_pipeline_trainer import (
    _batch,
    _train_cfg,
    _jax_trainer,
    _run_jax,
    check_init,
    check_steps,
    jax_reference,
    run_port,
)

# name: (mesh axes, MoE, LoRA, quantize_base, dense overrides, microbatches, batch rows, seq
# [, TrainConfig overrides]). The full fine-tune steps at lr 1e-3: at 1e-2 an
# element whose gradient cancels to 1e-7-1e-6 takes Adam's whole normalised
# step with the sign that the last bits of its sum give, so a weight moves by
# up to 2e-2 with the summation order (the full fine-tune hazard of ROADMAP
# §3), and the next step's gradient norm follows it
CASES = {
    "moe_qlora_int8_pipe2_expert2": (dict(pipe=2, expert=2), True, True, True, {}, 2, 4, 512),
    "moe_full_pipe2_data2": (dict(pipe=2, data=2), True, False, False, {}, 2, 8, 512,
                             dict(learning_rate=1e-3)),
}
REFERENCE = {"moe_qlora_int8_pipe2_expert2": dict(expert=2)}
VALIDATE = ("moe_full_pipe2_data2", dict(data=2))
INIT_CASES = ("moe_qlora_int8_pipe2_expert2",)


def _lr(case):
    return {"lr": _train_cfg(case)["learning_rate"]}


@pytest.fixture(scope="module")
def jax_ref():
    out = jax_reference(CASES, REFERENCE)
    name, axes = VALIDATE
    jt = _jax_trainer(CASES[name], axes, start=out["start"][name][0])
    out["validate"] = _run_jax(jt, _batch(CASES[name]))
    return out


@pytest.fixture(scope="module")
def port(jax_ref, tmp_path_factory):
    return run_port(tmp_path_factory.mktemp("pipeline_moe_trainer"), CASES, INIT_CASES, None,
                    jax_ref["start"])


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_moe_trainer_matches_jax(name, port, jax_ref):
    case = CASES[name]
    with_lora = case[2]
    check_steps(port["steps"][name], jax_ref["steps"][name], with_lora,
                jax_ref["start"][name][1 if with_lora else 0], **_lr(case))


def test_per_microbatch_reference_is_jax_pipelined(jax_ref):
    """The per-microbatch reference that stands in for JAX's pipelined
    trainer on pipe × expert equals JAX's pipelined trainer where that runs."""
    case = CASES[VALIDATE[0]]
    check_steps(jax_ref["validate"], jax_ref["steps"][VALIDATE[0]], False,
                jax_ref["start"][VALIDATE[0]][0], **_lr(case))


def test_pipelined_moe_replicated_leaves_stay_equal_across_stages(port):
    assert port["replicas_equal"]["moe_full_pipe2_data2"]


@pytest.mark.parametrize("name", INIT_CASES)
def test_pipelined_moe_init_is_the_one_device_init(name, port):
    check_init(CASES[name], port["init"][name])
