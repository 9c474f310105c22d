"""Gang scheduling of GPU notebooks (the port's copy of the JAX
package's ``scheduling/__init__.py``).

A multi-node GPU notebook is a gang: NCCL needs every worker present, so
a notebook spanning two nodes bound one of two strands its GPUs. The JAX
package adds a mini-Kueue for that:

- ``workload``  — derive a gang ``Workload`` object (node count, GPU
  count, accelerator selector, priority) from a Notebook's StatefulSet
  shape;
- ``queue``     — per-profile GPU quota pools fed by ``kf-resource-quota``
  and a cluster-wide GPU node-pool inventory snapshotted from Nodes;
- ``scheduler`` — the admission cycle: all-or-nothing fit, priority
  preemption, requeue with backoff.

The contract with the rest of the platform:

- with queueing on, the notebook controller creates one Workload per
  GPU notebook and stamps the pod template with
  ``ADMISSION_GATE_ANNOTATION``;
- the kubelet sim honors the gate: gated pods stay Pending
  (``SchedulingGated``) until their Workload is admitted, then the
  whole gang binds to the scheduler's node assignment atomically —
  all pods or none;
- ``web/jwa`` surfaces queue position and the pending reason.
"""

from typing import Any

GROUP = "scheduling.kubeflow.org"
WORKLOAD_API_VERSION = f"{GROUP}/v1alpha1"

# pod-template annotation naming the Workload that must be admitted
# before the pod may schedule (the kubelet sim honors it the way the
# real cluster honors spec.schedulingGates + Kueue's ungating webhook)
ADMISSION_GATE_ANNOTATION = f"{GROUP}/admission-gate"

# pod label grouping the members of one gang (ordinal label
# apps.kubernetes.io/pod-index maps each member to its assigned node)
WORKLOAD_LABEL = f"{GROUP}/workload"

# Notebook annotation selecting a PriorityClass (scheduling.k8s.io/v1)
PRIORITY_CLASS_ANNOTATION = "notebooks.kubeflow.org/priority-class"

# ResourceQuota annotation enabling GPU oversubscription for a quota
# pool (sessions/ subsystem, NotebookOS-style): committed sessions
# (running + suspended-to-checkpoint) may hold up to hard × factor
# GPUs — only the RUNNING ones occupy physical inventory; suspended
# sessions hold a checkpoint, not GPUs. Without the annotation (or at
# factor 1) the plain quota semantics hold unchanged.
OVERSUBSCRIPTION_FACTOR_ANNOTATION = f"{GROUP}/oversubscription-factor"

# Workload status states
STATE_PENDING = "Pending"
STATE_ADMITTED = "Admitted"


def register_scheduling(api: Any) -> None:
    """Register the Workload kind on an APIServer-shaped api."""
    api.register_kind(WORKLOAD_API_VERSION, "Workload", "workloads", True)
