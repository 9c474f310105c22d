"""The port's platform conformance gate (``odh_kubeflow_tpu_torch/
conformance.py``) on the CPU: the same eleven transitions as the JAX
package's gate (``tests/test_conformance.py``), on GPU node pools, with
step 10 training the tiny Llama config through the port's ``Trainer``,
``CheckpointManager``, ``PreemptionGuard`` and ``run_elastic``."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from odh_kubeflow_tpu_torch.conformance import PREEMPT_AT, SCORECARD, TOTAL_STEPS, run_conformance

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def one_thread():
    # many tiny steps: one thread keeps them fast under the suite's workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_conformance_gate_green_on_cpu(one_thread):
    record = {}
    scorecard = run_conformance(device="cpu", record=record)
    assert list(scorecard) == list(SCORECARD)
    assert all(v == "PASS" for v in scorecard.values()), scorecard
    # step 10: preempted at 3, resumed bit for bit by a fresh trainer, on to 6
    assert record["model"] == "tiny"
    assert record["first_run"] == {"step": PREEMPT_AT, "preempted": True, "resumed_from": None}
    assert record["second_run"] == {"step": TOTAL_STEPS, "preempted": False,
                                    "resumed_from": PREEMPT_AT}
    assert record["resumed_bit_equal"] is True
    assert len(record["step_losses"]) == TOTAL_STEPS
    assert record["step_losses"] == record["reference_losses"]
    assert record["checkpoint_steps"][-1] == TOTAL_STEPS


def test_the_gate_trains_on_the_card_by_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train the 8B model on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_conformance()


def _stale_restore(restore, *keys):
    """``CheckpointManager.restore`` with one element of the first leaf
    under ``keys`` moved by one."""
    def restore_stale(self, state_like, step=None):
        state = restore(self, state_like, step)
        leaf = state
        for key in keys:
            leaf = leaf[key]
        while isinstance(leaf, dict):
            leaf = leaf[sorted(leaf)[0]]
        leaf.view(-1)[0] += 1.0
        return state
    return restore_stale


@pytest.mark.parametrize("keys", [("opt_state", "nu"), ("trainable",)],
                         ids=["stale-moment", "stale-adapter"])
def test_resume_check_refuses_a_restore_that_is_not_the_preempted_state(
        one_thread, monkeypatch, keys):
    # a checkpoint that comes back other than the preempted trainer held
    # it fails step 10 before the resumed run takes a step
    from odh_kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    monkeypatch.setattr(CheckpointManager, "restore",
                        _stale_restore(CheckpointManager.restore, *keys))
    record = {}
    with pytest.raises(AssertionError, match="resumed state differs"):
        run_conformance(device="cpu", record=record)
    assert record["resumed_bit_equal"] is False
    assert len(record["step_losses"]) == PREEMPT_AT


def test_module_cli_prints_an_eleven_step_scorecard_on_cpu():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.set_num_threads(1); "
         "from odh_kubeflow_tpu_torch.conformance import main; "
         "sys.exit(main(['--device', 'cpu']))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.endswith("(11/11)") and "elastic-resume=PASS" in line, line
