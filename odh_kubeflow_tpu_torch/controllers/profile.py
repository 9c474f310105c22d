"""profile-controller: multi-tenancy — Profile CR → namespace + RBAC +
authz policy + GPU ResourceQuota + cloud-credential plugins (the port's
copy of the JAX package's ``controllers/profile.py``).

Reference parity (components/profile-controller/controllers/
profile_controller.go): Reconcile :105-322, namespace create + owner
guard :127-198, AuthorizationPolicy :407-472, SA+rolebinding helpers
:559-639, quota :526-557, plugin dispatch :643-675, finalizer :284-319,
default-labels live reload :356-387 + readDefaultLabelsFromFile
:743-758. Plugins: plugin_iam.go:22-80, plugin_workload_identity.go
:32-52.

On GPU node pools ``kf-resource-quota`` speaks
``requests.nvidia.com/gpu`` (the JAX package's ``requests.google.com/tpu``):
per-namespace GPU budgeting is the platform's quota story. The plugins
take injectable IAM clients; the cloud IAM clients that
``plugins_from_env`` builds, and the split-process ``main()``, are not
ported yet (ROADMAP.md)."""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.controllers import reconcilehelper
from odh_kubeflow_tpu_torch.controllers.runtime import Manager, Request, Result
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.objects import mutable
from odh_kubeflow_tpu_torch.machinery.store import APIServer, NotFound
from odh_kubeflow_tpu_torch.utils import prometheus

Obj = dict[str, Any]

PROFILE_FINALIZER = "profile-finalizer.kubeflow.org"
OWNER_ANNOTATION = "owner"
QUOTA_NAME = "kf-resource-quota"
# the GPU quota key of kf-resource-quota (the counterpart of
# QUOTA_TPU_KEY / ``requests.google.com/tpu``; reference
# profile_controller.go:253-268 generalized)
GPU_QUOTA_KEY = os.environ.get("QUOTA_GPU_KEY", "requests.nvidia.com/gpu")
USER_HEADER = os.environ.get("USERID_HEADER", "kubeflow-userid")
DEFAULT_EDITOR = "default-editor"
DEFAULT_VIEWER = "default-viewer"
ADMIN_ROLE = "kubeflow-admin"
EDIT_ROLE = "kubeflow-edit"
VIEW_ROLE = "kubeflow-view"


def _stamp_editor_sa(api: APIServer, ns: str, key: str, value: str) -> None:
    """Annotate the namespace's default-editor ServiceAccount through
    ``patch`` — the server-side guaranteedUpdate shape (read-merge-write
    with Conflict retries, the error-contract policy anchor), so a race
    with another controller stamping the same SA never surfaces."""
    api.patch(
        "ServiceAccount",
        DEFAULT_EDITOR,
        {"metadata": {"annotations": {key: value}}},
        ns,
    )


class ProfilePlugin:
    """Apply/Revoke contract (profile_controller.go:77-83); revoke must
    be idempotent."""

    kind = ""

    def apply(self, api: APIServer, profile: Obj, spec: Obj) -> None:
        raise NotImplementedError

    def revoke(self, api: APIServer, profile: Obj, spec: Obj) -> None:
        raise NotImplementedError


class GcpWorkloadIdentityPlugin(ProfilePlugin):
    """Binds the namespace's default-editor KSA to a GCP service account
    (plugin_workload_identity.go:32-52). The IAM mutation goes through
    an injectable client so tests (and clusters without egress) stub it."""

    kind = "WorkloadIdentity"

    def __init__(self, iam_client: Optional[Callable[[str, str, str], None]] = None):
        # iam_client(gcp_sa, member, action) — action add|remove
        self.iam_client = iam_client or (lambda *a: None)

    def apply(self, api: APIServer, profile: Obj, spec: Obj) -> None:
        gcp_sa = spec.get("gcpServiceAccount", "")
        ns = obj_util.name_of(profile)
        # protocol-ok: read by GKE workload identity, not package code
        _stamp_editor_sa(api, ns, "iam.gke.io/gcp-service-account", gcp_sa)
        member = f"serviceAccount:{ns}.svc.id.goog[{ns}/{DEFAULT_EDITOR}]"
        self.iam_client(gcp_sa, member, "add")

    def revoke(self, api: APIServer, profile: Obj, spec: Obj) -> None:
        gcp_sa = spec.get("gcpServiceAccount", "")
        ns = obj_util.name_of(profile)
        member = f"serviceAccount:{ns}.svc.id.goog[{ns}/{DEFAULT_EDITOR}]"
        self.iam_client(gcp_sa, member, "remove")


class AwsIamForServiceAccountPlugin(ProfilePlugin):
    kind = "AwsIamForServiceAccount"

    def __init__(self, iam_client: Optional[Callable[[str, str, str], None]] = None):
        self.iam_client = iam_client or (lambda *a: None)

    def apply(self, api: APIServer, profile: Obj, spec: Obj) -> None:
        arn = spec.get("awsIamRole", "")
        ns = obj_util.name_of(profile)
        # protocol-ok: read by the EKS pod-identity webhook
        _stamp_editor_sa(api, ns, "eks.amazonaws.com/role-arn", arn)
        self.iam_client(arn, f"{ns}/{DEFAULT_EDITOR}", "add")

    def revoke(self, api: APIServer, profile: Obj, spec: Obj) -> None:
        arn = spec.get("awsIamRole", "")
        ns = obj_util.name_of(profile)
        self.iam_client(arn, f"{ns}/{DEFAULT_EDITOR}", "remove")


class ProfileController:
    def __init__(
        self,
        api: APIServer,
        default_labels: Optional[dict[str, str]] = None,
        labels_path: Optional[str] = None,
        plugins: Optional[dict[str, ProfilePlugin]] = None,
        registry: Optional[prometheus.Registry] = None,
    ):
        self.api = api
        self.labels_path = labels_path
        self._default_labels = default_labels or {
            "istio-injection": "enabled",
            # protocol-ok: consumed by the external katib webhook
            "katib.kubeflow.org/metrics-collector-injection": "enabled",
        }
        self.plugins = plugins or {
            "WorkloadIdentity": GcpWorkloadIdentityPlugin(),
            "AwsIamForServiceAccount": AwsIamForServiceAccountPlugin(),
        }
        reg = registry or prometheus.default_registry
        self.m_requests = reg.counter(
            "profile_controller_requests_total", "Profile reconcile requests"
        )
        self.m_errors = reg.counter(
            "profile_controller_errors_total", "Profile reconcile errors"
        )
        self._labels_mtime: Optional[float] = None

    def register(self, mgr: Manager) -> None:
        ctrl = mgr.new_controller("profile-controller", "Profile", self.reconcile)
        ctrl.owns("Namespace")
        ctrl.owns("AuthorizationPolicy")
        ctrl.owns("ServiceAccount")
        ctrl.owns("RoleBinding")
        ctrl.owns("ResourceQuota")

    # -- default labels live reload ------------------------------------------

    def default_labels(self) -> dict[str, str]:
        """Re-read the labels file when it changed (the fsnotify watch
        in the reference, :356-387, polled here)."""
        if not self.labels_path:
            return dict(self._default_labels)
        try:
            mtime = os.path.getmtime(self.labels_path)
            if mtime != self._labels_mtime:
                with open(self.labels_path) as f:
                    self._default_labels = json.load(f)
                self._labels_mtime = mtime
        except OSError:
            pass
        return dict(self._default_labels)

    def reconcile_all(self) -> None:
        for profile in self.api.list("Profile"):
            self.reconcile(Request("", obj_util.name_of(profile)))

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, req: Request) -> Result:
        self.m_requests.inc()
        try:
            # mutable(): the finalizer add/remove edits the in-hand object
            profile = mutable(self.api.get("Profile", req.name))
        except NotFound:
            return Result()

        meta = obj_util.meta(profile)
        if meta.get("deletionTimestamp"):
            self._run_plugins(profile, revoke=True)
            if PROFILE_FINALIZER in (meta.get("finalizers") or []):
                meta["finalizers"] = [
                    f for f in meta["finalizers"] if f != PROFILE_FINALIZER
                ]
                # a Conflict re-enqueues this Profile; the strip is
                # idempotent on the next pass
                self.api.update(profile)  # contract-ok: level-triggered
            return Result()

        if PROFILE_FINALIZER not in (meta.get("finalizers") or []):
            meta.setdefault("finalizers", []).append(PROFILE_FINALIZER)
            # a Conflict re-enqueues this Profile; the stamp is
            # idempotent on the next pass
            profile = self.api.update(profile)  # contract-ok: level-triggered

        try:
            self._reconcile_namespace(profile)
            self._reconcile_authorization_policy(profile)
            self._reconcile_service_accounts(profile)
            self._reconcile_owner_rolebinding(profile)
            self._reconcile_quota(profile)
            self._run_plugins(profile, revoke=False)
        except Exception:
            self.m_errors.inc(labels={"severity": "major"})
            raise
        return Result()

    def _owner_email(self, profile: Obj) -> str:
        return obj_util.get_path(profile, "spec", "owner", "name", default="")

    def _reconcile_namespace(self, profile: Obj) -> None:
        name = obj_util.name_of(profile)
        labels = self.default_labels()
        # protocol-ok: standard grouping label read by dashboards/kubectl
        labels["app.kubernetes.io/part-of"] = "kubeflow-profile"
        labels["kubernetes.io/metadata.name"] = name
        ns = {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {
                "name": name,
                "labels": labels,
                "annotations": {OWNER_ANNOTATION: self._owner_email(profile)},
            },
        }
        try:
            existing = self.api.get("Namespace", name)
            # ownership guard (:169-198): a namespace not created by this
            # profile must not be captured
            owner_ann = obj_util.annotations_of(existing).get(OWNER_ANNOTATION)
            refs = obj_util.meta(existing).get("ownerReferences") or []
            owned = any(
                r.get("uid") == obj_util.meta(profile).get("uid") for r in refs
            )
            if not owned and owner_ann != self._owner_email(profile):
                raise RuntimeError(
                    f"namespace {name} exists and is not owned by profile"
                )
        except NotFound:
            pass
        reconcilehelper.reconcile_object(
            self.api, ns, owner=profile, copier=self._ns_copier
        )

    @staticmethod
    def _ns_copier(desired: Obj, current: Obj) -> bool:
        changed = False
        cur_labels = obj_util.meta(current).setdefault("labels", {})
        for k, v in obj_util.labels_of(desired).items():
            if cur_labels.get(k) != v:
                cur_labels[k] = v
                changed = True
        cur_ann = obj_util.meta(current).setdefault("annotations", {})
        for k, v in obj_util.annotations_of(desired).items():
            if cur_ann.get(k) != v:
                cur_ann[k] = v
                changed = True
        return changed

    def _reconcile_authorization_policy(self, profile: Obj) -> None:
        """User-header match + same-ns + probe paths + the notebook
        controller's kernels GET (:407-472)."""
        name = obj_util.name_of(profile)
        policy = {
            "apiVersion": "security.istio.io/v1beta1",
            "kind": "AuthorizationPolicy",
            "metadata": {"name": f"ns-owner-access-istio", "namespace": name},
            "spec": {
                "rules": [
                    {
                        "when": [
                            {
                                "key": f"request.headers[{USER_HEADER}]",
                                "values": [self._owner_email(profile)],
                            }
                        ]
                    },
                    {
                        "from": [
                            {"source": {"namespaces": [name]}}
                        ]
                    },
                    {
                        "to": [
                            {
                                "operation": {
                                    "paths": [
                                        "/healthz",
                                        "/metrics",
                                        "/wait-for-drain",
                                    ]
                                }
                            }
                        ]
                    },
                    {
                        "to": [
                            {
                                "operation": {
                                    "methods": ["GET"],
                                    "paths": ["*/api/kernels"],
                                }
                            }
                        ]
                    },
                ]
            },
        }
        reconcilehelper.reconcile_object(self.api, policy, owner=profile)

    def _reconcile_service_accounts(self, profile: Obj) -> None:
        ns = obj_util.name_of(profile)
        for sa_name, role in ((DEFAULT_EDITOR, EDIT_ROLE), (DEFAULT_VIEWER, VIEW_ROLE)):
            sa = {
                "apiVersion": "v1",
                "kind": "ServiceAccount",
                "metadata": {"name": sa_name, "namespace": ns},
            }
            reconcilehelper.reconcile_object(
                self.api, sa, owner=profile, copier=lambda d, c: False
            )
            rb = {
                "apiVersion": "rbac.authorization.k8s.io/v1",
                "kind": "RoleBinding",
                "metadata": {"name": sa_name, "namespace": ns},
                "subjects": [
                    {"kind": "ServiceAccount", "name": sa_name, "namespace": ns}
                ],
                "roleRef": {
                    "apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole",
                    "name": role,
                },
            }
            reconcilehelper.reconcile_object(self.api, rb, owner=profile)

    def _reconcile_owner_rolebinding(self, profile: Obj) -> None:
        ns = obj_util.name_of(profile)
        rb = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {"name": "namespaceAdmin", "namespace": ns},
            "subjects": [
                {
                    "kind": obj_util.get_path(
                        profile, "spec", "owner", "kind", default="User"
                    ),
                    "name": self._owner_email(profile),
                    "apiGroup": "rbac.authorization.k8s.io",
                }
            ],
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": ADMIN_ROLE,
            },
        }
        reconcilehelper.reconcile_object(self.api, rb, owner=profile)

    def _reconcile_quota(self, profile: Obj) -> None:
        spec = obj_util.get_path(
            profile, "spec", "resourceQuotaSpec", default={}
        ) or {}
        ns = obj_util.name_of(profile)
        if not spec.get("hard"):
            try:
                self.api.delete("ResourceQuota", QUOTA_NAME, ns)
            except NotFound:
                pass
            return
        quota = {
            "apiVersion": "v1",
            "kind": "ResourceQuota",
            "metadata": {"name": QUOTA_NAME, "namespace": ns},
            "spec": obj_util.deepcopy(spec),
        }
        reconcilehelper.reconcile_object(self.api, quota, owner=profile)

    def _run_plugins(self, profile: Obj, revoke: bool) -> None:
        for plugin_spec in (
            obj_util.get_path(profile, "spec", "plugins", default=[]) or []
        ):
            kind = plugin_spec.get("kind", "")
            plugin = self.plugins.get(kind)
            if plugin is None:
                continue
            spec = plugin_spec.get("spec") or {}
            if revoke:
                plugin.revoke(self.api, profile, spec)
            else:
                plugin.apply(self.api, profile, spec)

