"""kfam: profile + contributor-binding management (access-management;
the port's copy of the JAX package's ``controllers/kfam.py``).

Reference parity (components/access-management/kfam/): binding name
mangling bindings.go:60-77, role-name map :39-46, Create (RoleBinding +
per-user AuthorizationPolicy) :80-150, owner/admin permission gate
api_default.go:303 + informer-backed RoleBinding lookup :53-91.

This module is the service's logic; the JAX package's ``web/kfam_app.py``
wraps it with the HTTP surface (port 8081 in the reference), which the
port has not taken yet."""

from __future__ import annotations

from typing import Any, Optional

from odh_kubeflow_tpu_torch.controllers.profile import USER_HEADER
from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import APIServer, AlreadyExists, Invalid, NotFound

Obj = dict[str, Any]

# kfam role name ↔ ClusterRole (bindings.go:39-46)
ROLE_MAP = {
    "admin": "kubeflow-admin",
    "edit": "kubeflow-edit",
    "view": "kubeflow-view",
}
ROLE_MAP_REVERSE = {v: k for k, v in ROLE_MAP.items()}


def binding_name(user: str, role: str) -> str:
    """user-<mangled-email>-clusterrole-<role> (bindings.go:60-77)."""
    mangled = user.replace("@", "-").replace(".", "-").lower()
    return f"user-{mangled}-clusterrole-kubeflow-{role}"


class KfamService:
    def __init__(self, api: APIServer, cluster_admins: Optional[set[str]] = None):
        self.api = api
        self.cluster_admins = cluster_admins or set()

    # -- permission gate -----------------------------------------------------

    def is_cluster_admin(self, user: str) -> bool:
        return user in self.cluster_admins

    def is_owner_or_admin(self, user: str, namespace: str) -> bool:
        if self.is_cluster_admin(user):
            return True
        try:
            profile = self.api.get("Profile", namespace)
        except NotFound:
            return False
        owner = obj_util.get_path(profile, "spec", "owner", "name", default="")
        if owner == user:
            return True
        for rb in self.api.list("RoleBinding", namespace=namespace):
            if obj_util.get_path(rb, "roleRef", "name") != "kubeflow-admin":
                continue
            for s in rb.get("subjects") or []:
                if s.get("kind") == "User" and s.get("name") == user:
                    return True
        return False

    def has_binding(self, user: str, namespace: str) -> bool:
        """Any kfam-managed binding for ``user`` in ``namespace`` —
        contributors see read-only namespace panels (quota, activities)
        the owner does."""
        return bool(self.list_bindings(namespace=namespace, user=user))

    # -- profiles ------------------------------------------------------------

    def create_profile(self, profile: Obj) -> Obj:
        return self.api.create(profile)

    def delete_profile(self, name: str, requester: str) -> None:
        if not self.is_owner_or_admin(requester, name):
            raise Invalid(f"{requester} may not delete profile {name}")
        self.api.delete("Profile", name)

    def list_profiles(self) -> list[Obj]:
        return self.api.list("Profile")

    # -- bindings ------------------------------------------------------------

    def create_binding(self, binding: Obj, requester: str) -> None:
        """binding = {user: Subject, referredNamespace, RoleRef}."""
        namespace = binding.get("referredNamespace", "")
        if not namespace:
            raise Invalid("referredNamespace required")
        if not self.is_owner_or_admin(requester, namespace):
            raise Invalid(
                f"{requester} is neither owner nor admin of {namespace}"
            )
        user = obj_util.get_path(binding, "user", "name", default="")
        role_ref = binding.get("roleRef") or {}
        role = ROLE_MAP_REVERSE.get(role_ref.get("name", ""), "")
        if not user or not role:
            raise Invalid("binding needs user.name and a known roleRef")

        rb = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {
                "name": binding_name(user, role),
                "namespace": namespace,
                "annotations": {"role": role, "user": user},
            },
            "subjects": [
                {
                    "kind": "User",
                    "name": user,
                    "apiGroup": "rbac.authorization.k8s.io",
                }
            ],
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": ROLE_MAP[role],
            },
        }
        try:
            self.api.create(rb)
        except AlreadyExists:
            pass
        # per-user istio AuthorizationPolicy (bindings.go:80-95)
        policy = {
            "apiVersion": "security.istio.io/v1beta1",
            "kind": "AuthorizationPolicy",
            "metadata": {
                "name": binding_name(user, role),
                "namespace": namespace,
                "annotations": {"role": role, "user": user},
            },
            "spec": {
                "rules": [
                    {
                        "when": [
                            {
                                "key": f"request.headers[{USER_HEADER}]",
                                "values": [user],
                            }
                        ]
                    }
                ]
            },
        }
        try:
            self.api.create(policy)
        except AlreadyExists:
            pass

    def delete_binding(self, binding: Obj, requester: str) -> None:
        namespace = binding.get("referredNamespace", "")
        if not self.is_owner_or_admin(requester, namespace):
            raise Invalid(
                f"{requester} is neither owner nor admin of {namespace}"
            )
        user = obj_util.get_path(binding, "user", "name", default="")
        role = ROLE_MAP_REVERSE.get(
            obj_util.get_path(binding, "roleRef", "name", default=""), ""
        )
        name = binding_name(user, role)
        for kind in ("RoleBinding", "AuthorizationPolicy"):
            try:
                self.api.delete(kind, name, namespace)
            except NotFound:
                pass

    def list_bindings(
        self, namespace: Optional[str] = None, user: Optional[str] = None
    ) -> list[Obj]:
        out = []
        for rb in self.api.list("RoleBinding", namespace=namespace):
            ann = obj_util.annotations_of(rb)
            if "user" not in ann or "role" not in ann:
                continue  # not a kfam-managed binding
            if user and ann["user"] != user:
                continue
            out.append(
                {
                    "user": {"kind": "User", "name": ann["user"]},
                    "referredNamespace": obj_util.namespace_of(rb),
                    "roleRef": {
                        "apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole",
                        "name": ROLE_MAP.get(ann["role"], ann["role"]),
                    },
                }
            )
        return out

    def namespaces_for_user(self, user: str) -> list[str]:
        """Namespaces where the user is owner or contributor — what the
        spawner's namespace dropdown shows."""
        namespaces = set()
        for profile in self.api.list("Profile"):
            owner = obj_util.get_path(profile, "spec", "owner", "name", default="")
            if owner == user:
                namespaces.add(obj_util.name_of(profile))
        for b in self.list_bindings(user=user):
            namespaces.add(b["referredNamespace"])
        return sorted(namespaces)
