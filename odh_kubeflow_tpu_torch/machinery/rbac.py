"""RBAC evaluation over stored (Cluster)Role / (Cluster)RoleBinding objects
(the port's copy of the JAX package's ``machinery/rbac.py``).

The reference platform delegates authorization to the Kubernetes
SubjectAccessReview API (crud_backend authz, SURVEY.md §2.2; kfam's
owner/admin gate uses informer-cached RoleBindings). Here the evaluator
is embedded: ``can(user, verb, resource, namespace)`` answers the same
question against the APIServer's RBAC objects, and the web layer's
``@needs_authorization`` decorator calls it exactly where the reference
posts a SubjectAccessReview.
"""

from __future__ import annotations

from typing import Optional

from odh_kubeflow_tpu_torch.machinery.store import APIServer, NotFound


def _rule_matches(
    rule: dict, verb: str, api_group: str, resource: str, name: Optional[str]
) -> bool:
    def _match(allowed, value) -> bool:
        allowed = allowed or []
        return "*" in allowed or value in allowed

    if not _match(rule.get("verbs"), verb):
        return False
    if not _match(rule.get("apiGroups"), api_group):
        return False
    # k8s RBAC requires subresources ("notebooks/status") to be listed
    # explicitly — a grant on the base resource does NOT cover them
    resources = rule.get("resources") or []
    if "*" not in resources and resource not in resources:
        return False
    if name and rule.get("resourceNames"):
        return name in rule["resourceNames"]
    return True


def _subject_matches(subject: dict, user: str, groups: list[str]) -> bool:
    kind = subject.get("kind", "")
    if kind == "User":
        return subject.get("name") == user
    if kind == "Group":
        return subject.get("name") in groups
    if kind == "ServiceAccount":
        sa_user = (
            f"system:serviceaccount:{subject.get('namespace', '')}:"
            f"{subject.get('name', '')}"
        )
        return sa_user == user
    return False


class RBACEvaluator:
    def __init__(self, api: APIServer):
        self.api = api

    def _role_rules(self, ref: dict, binding_ns: Optional[str]) -> list[dict]:
        kind = ref.get("kind", "Role")
        name = ref.get("name", "")
        try:
            if kind == "ClusterRole":
                role = self.api.get("ClusterRole", name)
            else:
                role = self.api.get("Role", name, binding_ns)
        except NotFound:
            # a binding to a deleted role grants nothing (k8s behaviour)
            return []
        return role.get("rules") or []

    def can(
        self,
        user: str,
        verb: str,
        resource: str,
        namespace: Optional[str] = None,
        api_group: str = "",
        name: Optional[str] = None,
        groups: Optional[list[str]] = None,
    ) -> bool:
        """SubjectAccessReview semantics: cluster bindings grant
        everywhere; namespaced bindings grant within their namespace."""
        groups = groups or []
        for binding in self.api.list("ClusterRoleBinding"):
            if any(
                _subject_matches(s, user, groups)
                for s in binding.get("subjects") or []
            ):
                for rule in self._role_rules(binding.get("roleRef", {}), None):
                    if _rule_matches(rule, verb, api_group, resource, name):
                        return True
        if namespace:
            for binding in self.api.list("RoleBinding", namespace=namespace):
                if any(
                    _subject_matches(s, user, groups)
                    for s in binding.get("subjects") or []
                ):
                    for rule in self._role_rules(
                        binding.get("roleRef", {}), namespace
                    ):
                        if _rule_matches(rule, verb, api_group, resource, name):
                            return True
        return False
