"""Platform conformance gate on GPU node pools (the port's copy of the JAX
package's ``conformance.py``).

One run drives every platform capability end to end against the
embedded control plane — each step both asserts its own transitions
and sets up the next, so a pass certifies the capabilities *compose*:

    register → spawn (GPU gang) → ready → share (kfam) →
    quota-reject a second gang → cull (idle) → restart →
    preempt → gang restart → elastic train resume → delete (cascade)

The control-plane steps are pure Python. Step 10 trains through the
port's ``Trainer``, ``CheckpointManager``, ``PreemptionGuard`` and
``run_elastic`` on the card (``device="cuda"``, the default: Llama-3-8B
QLoRA at full width and depth, int4 base, LoRA r16, batch 2 × seq 4096)
or, when the caller asks for it, on the CPU at the tiny config. It is
preempted at step 3; a fresh trainer restores the checkpoint, whose
adapters and optimizer state must be the preempted trainer's bit for
bit, and trains on to step 6, taking the losses a run of the same six
steps without a preemption took.

    python -m odh_kubeflow_tpu_torch.conformance              # on the card
    python -m odh_kubeflow_tpu_torch.conformance --device cpu

It prints a one-line capability scorecard and exits non-zero on the
first broken transition.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import (
    GPU_ACCELERATOR_ANNOTATION,
    GPU_COUNT_ANNOTATION,
    GPU_RESOURCE,
    LAST_ACTIVITY_ANNOTATION,
    STOP_ANNOTATION,
    register_crds,
)
from odh_kubeflow_tpu_torch.controllers.culler import Culler, CullerConfig, _fmt_time
from odh_kubeflow_tpu_torch.controllers.kfam import KfamService, binding_name
from odh_kubeflow_tpu_torch.controllers.notebook import (
    NotebookController,
    NotebookControllerConfig,
)
from odh_kubeflow_tpu_torch.controllers.profile import GPU_QUOTA_KEY, ProfileController
from odh_kubeflow_tpu_torch.controllers.runtime import Manager
from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
from odh_kubeflow_tpu_torch.machinery.store import APIServer, NotFound

OWNER = "alice@example.com"
NS = "team-conf"
ACCELERATOR = "nvidia-h100-80gb"  # a3-highgpu-8g: 8 GPUs a node
GPUS = 4  # one notebook's request, and the tenant's whole quota
SCORECARD = (
    "register", "spawn", "ready", "share", "quota-reject", "cull",
    "restart", "preempt", "gang-restart", "elastic-resume", "delete",
)
PREEMPT_AT, TOTAL_STEPS = 3, 6


class _IdleJupyter(BaseHTTPRequestHandler):
    """Fake Jupyter API reporting an idle kernel last active at epoch
    ``idle_since`` — what the culler's real HTTP probe reads."""

    idle_since = 0.0

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        if self.path.endswith("/api/kernels"):
            body = [{
                "execution_state": "idle",
                "last_activity": _fmt_time(type(self).idle_since),
            }]
        elif self.path.endswith("/api/terminals"):
            body = []
        else:
            self.send_response(404)
            self.end_headers()
            return
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def _notebook(name: str) -> dict:
    return {
        "apiVersion": "kubeflow.org/v1beta1",
        "kind": "Notebook",
        "metadata": {
            "name": name,
            "namespace": NS,
            "annotations": {
                GPU_ACCELERATOR_ANNOTATION: ACCELERATOR,
                GPU_COUNT_ANNOTATION: str(GPUS),
            },
        },
        "spec": {
            "template": {
                "spec": {"containers": [{"name": name, "image": "pytorch:cuda"}]}
            }
        },
    }


def train_setup(device) -> dict:
    """Step 10's model and batch for ``device``: on the card Llama-3-8B
    QLoRA (int4 base, LoRA r16 on wq/wk/wv/wo, remat "attn", flash, batch
    2 × seq 4096); on the CPU the JAX gate's tiny model (LoRA r2, batch 2
    × seq 16)."""
    from odh_kubeflow_tpu_torch.models.llama import LlamaConfig
    from odh_kubeflow_tpu_torch.models.lora import LoraConfig

    if device.type == "cuda":
        return dict(model="llama3_8b",
                    cfg=LlamaConfig.llama3_8b(remat=True, remat_policy="attn"),
                    lora=LoraConfig(rank=16), quantize_base="int4", batch=2, seq=4096)
    return dict(model="tiny", cfg=LlamaConfig.tiny(), lora=LoraConfig(rank=2),
                quantize_base=False, batch=2, seq=16)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _bit_equal(got, want) -> bool:
    """Every leaf of ``got`` equals ``want``'s bit for bit: tensors by
    dtype, shape and bytes (on the host)."""
    import torch

    def bits(t):
        return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)

    a, b = dict(_leaves(got)), dict(_leaves(want))
    if a.keys() != b.keys():
        return False
    for k, x in a.items():
        y = b[k]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(bits(x), bits(y))):
                return False
        elif x != y:
            return False
    return True


def elastic_resume(device, ckpt_dir: str, record: Optional[dict] = None) -> None:
    """Step 10: preemption forces a checkpoint, a fresh trainer resumes
    from it and finishes (single-process here; ``run_elastic`` runs the
    same loop on every rank of a gang). A run of the same steps without a
    preemption comes first: the preempted and resumed run must take the
    same losses, and the state the resumed trainer restores must be the
    preempted trainer's, bit for bit. Fills ``record`` with what it saw:
    both runs' losses, the preempted and resumed runs' steps and the step
    the resume started from, each of their steps' wall time, the
    checkpointed steps."""
    import torch

    from odh_kubeflow_tpu_torch.train import TrainConfig, Trainer
    from odh_kubeflow_tpu_torch.train.checkpoint import CheckpointManager, _to_host
    from odh_kubeflow_tpu_torch.train.elastic import PreemptionGuard, run_elastic

    setup = train_setup(device)
    rec: dict[str, Any] = record if record is not None else {}
    rec.update(model=setup["model"], batch=setup["batch"], seq=setup["seq"],
               reference_losses=[], step_losses=[], step_s=[])

    def make_trainer():
        return Trainer(setup["cfg"], TrainConfig(warmup_steps=1, total_steps=100),
                       lora_cfg=setup["lora"], quantize_base=setup["quantize_base"],
                       device=device)

    def batches(tr):
        while True:
            yield tr.make_fake_batch(setup["batch"], setup["seq"])

    # the reference: the same steps from the same init, never preempted
    tr = make_trainer()
    for _, batch in zip(range(TOTAL_STEPS), batches(tr)):
        rec["reference_losses"].append(float(tr.train_step(batch)["loss"]))
    del tr

    last = [time.perf_counter()]

    def timed(hook=None):
        def on_step(step_num, metrics):
            rec["step_losses"].append(float(metrics["loss"]))  # a host read synchronises
            now = time.perf_counter()
            rec["step_s"].append(now - last[0])
            last[0] = now
            if hook is not None:
                hook(step_num)
        return on_step

    tr = make_trainer()
    manager = CheckpointManager(ckpt_dir, save_interval_steps=2)
    guard = PreemptionGuard().install()

    def preempt_at(step_num):
        if step_num >= PREEMPT_AT:
            guard._stop.set()  # the SIGTERM latch, delivered

    try:
        last[0] = time.perf_counter()
        out = run_elastic(tr, manager, batches(tr), total_steps=10,
                          on_step=timed(preempt_at), guard=guard)
    finally:
        guard.uninstall()
    manager.wait_until_finished()
    assert out["preempted"] and out["step"] == PREEMPT_AT, out
    rec["first_run"] = out
    preempted_state = _to_host(tr._checkpoint_state())
    del tr  # the resume is a fresh process's trainer

    tr2 = make_trainer()
    restore = tr2.restore_checkpoint

    def checked_restore(manager, step=None):
        # run_elastic's own restore, checked before any step runs: the
        # state the resumed run trains from is the preempted trainer's
        resumed = restore(manager, step)
        rec["resumed_bit_equal"] = _bit_equal(tr2._checkpoint_state(), preempted_state)
        assert rec["resumed_bit_equal"], "resumed state differs from the preempted trainer's"
        return resumed

    tr2.restore_checkpoint = checked_restore
    manager2 = CheckpointManager(ckpt_dir, save_interval_steps=2)
    last[0] = time.perf_counter()
    out2 = run_elastic(tr2, manager2, batches(tr2), total_steps=TOTAL_STEPS,
                       on_step=timed())
    manager2.wait_until_finished()
    assert out2["resumed_from"] == PREEMPT_AT, out2
    assert out2["step"] == TOTAL_STEPS and not out2["preempted"], out2
    losses = rec["step_losses"]
    assert len(losses) == TOTAL_STEPS and all(map(math.isfinite, losses)), losses
    assert losses == rec["reference_losses"], (
        f"preempted and resumed losses {losses} differ from the uninterrupted "
        f"run's {rec['reference_losses']}")
    rec["second_run"] = out2
    rec["checkpoint_steps"] = manager2.all_steps()
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_conformance(
    verbose: bool = False,
    *,
    device="cuda",
    record: Optional[dict] = None,
) -> dict:
    """Run the full capability sequence; returns the scorecard dict
    (step → "PASS"). Raises AssertionError at the first transition that
    does not hold, with the failing step named.

    ``device`` is where step 10 trains: the card by default (raising
    without one), the CPU when asked, each at its own model
    (``train_setup``); ``record`` receives step 10's readings
    (``elastic_resume``)."""
    from odh_kubeflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    scorecard: dict = {}

    def step(name):
        def mark(_result=None):
            scorecard[name] = "PASS"
            if verbose:
                print(f"conformance: {name} PASS", flush=True)

        return mark

    clock = {"now": time.time()}
    now_fn = lambda: clock["now"]  # noqa: E731

    server = HTTPServer(("127.0.0.1", 0), _IdleJupyter)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    jupyter_url = f"http://127.0.0.1:{server.server_port}"

    try:
        api = APIServer()
        register_crds(api)
        cluster = FakeCluster(api)
        # one H100 pool of two 8-GPU nodes; the tenant's quota is one
        # notebook's 4 GPUs, so the second spawn must trip it
        cluster.add_gpu_node_pool("h100", ACCELERATOR, num_nodes=2, gpus_per_node=8)
        mgr = Manager(api, time_fn=now_fn)
        culler = Culler(
            api,
            CullerConfig(cull_idle_seconds=600, idleness_check_seconds=60),
            base_url_fn=lambda nb: jupyter_url,
            now_fn=now_fn,
        )
        NotebookController(
            api, NotebookControllerConfig(enable_culling=True), culler=culler
        ).register(mgr)
        ProfileController(api).register(mgr)
        kfam = KfamService(api, cluster_admins={"root@example.com"})

        # 1. register — a Profile materialises the tenant: namespace,
        # owner rolebinding, service account, GPU quota
        api.create({
            "apiVersion": "kubeflow.org/v1",
            "kind": "Profile",
            "metadata": {"name": NS},
            "spec": {
                "owner": {"kind": "User", "name": OWNER},
                "resourceQuotaSpec": {"hard": {GPU_QUOTA_KEY: str(GPUS)}},
            },
        })
        mgr.drain()
        api.get("Namespace", NS)
        assert (
            api.get("ResourceQuota", "kf-resource-quota", NS)["spec"]["hard"][
                GPU_QUOTA_KEY
            ]
            == str(GPUS)
        )
        step("register")()

        # 2. spawn — GPU notebook: STS + service + scheduled pod
        api.create(_notebook("nb1"))
        mgr.drain()
        cluster.step()
        mgr.drain()
        sts = api.get("StatefulSet", "nb1", NS)
        limits = sts["spec"]["template"]["spec"]["containers"][0][
            "resources"
        ]["limits"]
        assert limits[GPU_RESOURCE] == str(GPUS)
        step("spawn")()

        # 3. ready — pod Running, status mirrored onto the CR
        nb = api.get("Notebook", "nb1", NS)
        assert nb["status"]["readyReplicas"] == 1, nb["status"]
        assert api.get("Pod", "nb1-0", NS)["status"]["phase"] == "Running"
        step("ready")()

        # 4. share — the owner grants a contributor via kfam
        kfam.create_binding(
            {
                "user": {"kind": "User", "name": "bob@example.com"},
                "referredNamespace": NS,
                "roleRef": {
                    "apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole",
                    "name": "kubeflow-edit",
                },
            },
            requester=OWNER,
        )
        api.get("RoleBinding", binding_name("bob@example.com", "edit"), NS)
        assert kfam.namespaces_for_user("bob@example.com") == [NS]
        step("share")()

        # 5. quota-reject — a second notebook would exceed the tenant's
        # GPU quota: the pod must never materialise and the denial
        # must be observable
        api.create(_notebook("nb2"))
        mgr.drain()
        cluster.step()
        mgr.drain()
        try:
            api.get("Pod", "nb2-0", NS)
            raise AssertionError("quota-exceeding pod was created")
        except NotFound:
            pass
        denials = [
            e
            for e in api.list("Event", namespace=NS)
            if e["reason"] == "FailedCreate"
            and "exceeded quota" in e["message"]
        ]
        assert denials, "no quota denial event"
        api.delete("Notebook", "nb2", NS)
        mgr.drain()
        step("quota-reject")()

        # 6. cull — idle past the threshold: the culler stamps
        # last-activity, sets the stop annotation, STS scales to zero
        _IdleJupyter.idle_since = clock["now"]
        clock["now"] += 61  # past the check period: the probe runs and
        mgr.drain()         # stamps last-activity while the pod is up
        clock["now"] += 700  # > cull_idle_seconds of reported idleness
        mgr.drain()  # the cull decision
        cluster.step()
        mgr.drain()
        nb = api.get("Notebook", "nb1", NS)
        anns = nb["metadata"]["annotations"]
        assert STOP_ANNOTATION in anns, anns.keys()
        assert LAST_ACTIVITY_ANNOTATION in anns
        assert api.get("StatefulSet", "nb1", NS)["spec"]["replicas"] == 0
        step("cull")()

        # 7. restart — clearing the stop annotation brings it back
        api.patch(
            "Notebook", "nb1",
            {"metadata": {"annotations": {STOP_ANNOTATION: None}}}, NS,
        )
        mgr.drain()
        cluster.step()
        mgr.drain()
        assert api.get("Pod", "nb1-0", NS)["status"]["phase"] == "Running"
        step("restart")()

        # 8. preempt — GKE reclaims the GPU node: SlicePreempted
        # condition + warning event + gang teardown
        node = api.get("Pod", "nb1-0", NS)["spec"]["nodeName"]
        cluster.preempt_node(node)
        mgr.drain()
        nb = api.get("Notebook", "nb1", NS)
        conds = {c["type"]: c for c in nb["status"]["conditions"]}
        assert conds["SlicePreempted"]["status"] == "True"
        step("preempt")()

        # 9. gang-restart — capacity returns, the group re-materialises
        cluster.add_gpu_node_pool("h100-b", ACCELERATOR, num_nodes=1, gpus_per_node=8)
        mgr.drain()
        cluster.step()
        mgr.drain()
        assert api.get("Pod", "nb1-0", NS)["status"]["phase"] == "Running"
        step("gang-restart")()

        # 10. elastic-resume — the training story the platform hosts:
        # preemption forces a checkpoint, a fresh trainer resumes from
        # it and finishes
        with tempfile.TemporaryDirectory() as ckpt_dir:
            elastic_resume(device, ckpt_dir, record)
        step("elastic-resume")()

        # 11. delete — owner cascade removes everything the CR owns
        api.delete("Notebook", "nb1", NS)
        mgr.drain()
        for kind, name in (
            ("StatefulSet", "nb1"),
            ("Service", "nb1"),
            ("Pod", "nb1-0"),
        ):
            try:
                api.get(kind, name, NS)
                raise AssertionError(f"{kind}/{name} survived deletion")
            except NotFound:
                pass
        step("delete")()

        mgr.stop()
    finally:
        server.shutdown()
        server.server_close()

    return scorecard


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="where step 10 trains: cuda (default) or cpu")
    args = parser.parse_args(argv)
    try:
        scorecard = run_conformance(verbose=False, device=args.device)
    except (AssertionError, NotFound) as e:
        # name the broken transition: everything after the last PASS
        print(f"conformance: FAIL — {type(e).__name__}: {e}")
        return 1
    line = " ".join(f"{k}={v}" for k, v in scorecard.items())
    print(
        f"conformance: {line} ({len(scorecard)}/{len(scorecard)})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
