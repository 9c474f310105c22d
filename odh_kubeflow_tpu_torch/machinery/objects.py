"""Helpers for dict-shaped Kubernetes objects (the port's copy of the
JAX package's ``machinery/objects.py``).

All API objects of the control plane are plain nested dicts (the
dynamic-client representation); typed accessors live with the component
that owns the CRD (``apis/``). These helpers cover the metadata and
selector semantics every layer shares. ``deepcopy`` and ``mutable`` run
in the native JSON-tree extension (``native/jsontree.cpp``) where it
builds, and in Python otherwise.
"""

from __future__ import annotations

import copy
import fnmatch
import time
from typing import Any, Optional

Obj = dict[str, Any]

_native_copy = None
_native_tried = False


_SCALARS = (str, int, float, bool, type(None))

def _py_deepcopy(obj: Obj) -> Obj:
    t = type(obj)
    if t is dict:
        return {k: _py_deepcopy(v) for k, v in obj.items()}
    if t is list:
        return [_py_deepcopy(v) for v in obj]
    if t in _SCALARS:
        return obj
    return copy.deepcopy(obj)


deepcopy_calls = 0


def deepcopy_count() -> int:
    """Total ``deepcopy`` invocations since import (monotonic): the
    informer cache's zero-copy read hits are held to it."""
    return deepcopy_calls


def _native():
    """The native deep copy, probed once (None without a compiler)."""
    global _native_copy, _native_tried
    if not _native_tried:
        _native_tried = True
        try:
            from odh_kubeflow_tpu_torch import native

            _native_copy = native.jsontree_deepcopy()
        except Exception:  # noqa: BLE001 — any native failure → Python
            _native_copy = None
    return _native_copy


def engine() -> str:
    """The engine ``deepcopy`` runs on: ``"native"`` or ``"python"``."""
    return "native" if _native() is not None else "python"


def deepcopy(obj: Obj) -> Obj:
    """Deep copy specialised for JSON-shaped trees (dict/list/scalars
    are the only shapes API objects use): the native extension where it
    builds, the tree-specialised Python copy otherwise. Exotic leaves go
    through ``copy.deepcopy`` on both paths. Frozen trees
    (``FrozenDict``/``FrozenList``) come back as plain mutable
    dicts/lists either way."""
    global deepcopy_calls
    deepcopy_calls += 1
    fn = _native()
    if fn is not None:
        return fn(obj)
    return _py_deepcopy(obj)


# ---------------------------------------------------------------------------
# frozen (zero-copy, read-only) object trees
#
# The informer cache and the store's watch fan-out hand out ONE shared
# object per event/entry instead of a per-reader deepcopy. Safety comes
# from deep-freezing: every container in the tree is a FrozenDict /
# FrozenList whose mutators raise, so an aliasing bug surfaces as a
# loud FrozenObjectError instead of silent cross-reader corruption.
# ``mutable()`` is the copy-on-write escape hatch for the code paths
# that legitimately edit what they read (status writers, finalizers).


class FrozenObjectError(TypeError):
    """Attempted mutation of a shared cached object. Take a private
    copy with ``objects.mutable(obj)`` (or ``machinery.cache.mutable``)
    before editing."""


def _blocked(self, *args, **kwargs):
    raise FrozenObjectError(
        "cached object is read-only (shared, zero-copy); use "
        "mutable(obj) to get a private editable copy"
    )


class FrozenDict(dict):
    """A dict subclass whose mutators raise. Subclassing ``dict`` keeps
    ``isinstance(x, dict)``, JSON serialisation, and every read path
    working unchanged."""

    __slots__ = ()

    __setitem__ = _blocked
    __delitem__ = _blocked
    pop = _blocked
    popitem = _blocked
    clear = _blocked
    update = _blocked
    __ior__ = _blocked

    def setdefault(self, key, default=None):
        # reads through shared helpers (``meta(obj)``) use setdefault
        # on keys that exist; only an actual insert is a mutation
        if key in self:
            return self[key]
        _blocked(self)

    def __deepcopy__(self, memo):
        return mutable(self)

    def __copy__(self):
        return mutable(self)

    def __reduce__(self):
        return (dict, (mutable(self),))


class FrozenList(list):
    __slots__ = ()

    __setitem__ = _blocked
    __delitem__ = _blocked
    __iadd__ = _blocked
    __imul__ = _blocked
    append = _blocked
    extend = _blocked
    insert = _blocked
    pop = _blocked
    remove = _blocked
    clear = _blocked
    sort = _blocked
    reverse = _blocked

    def __deepcopy__(self, memo):
        return mutable(self)

    def __copy__(self):
        return mutable(self)

    def __reduce__(self):
        return (list, (mutable(self),))


def freeze(obj):
    """Deep-freeze a JSON-shaped tree into shared-safe read-only form.
    Already-frozen trees return as-is (freezing is idempotent and
    O(1) on the fast path), so one frozen copy per store event serves
    every watcher and the cache without re-conversion."""
    t = type(obj)
    if t in (FrozenDict, FrozenList) or t in _SCALARS:
        return obj
    if isinstance(obj, dict):
        return FrozenDict((k, freeze(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return FrozenList(freeze(v) for v in obj)
    return obj  # exotic immutable leaf; shared as-is


def is_frozen(obj) -> bool:
    return type(obj) in (FrozenDict, FrozenList)


def _thaw(obj):
    if isinstance(obj, dict):
        return {k: _thaw(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_thaw(v) for v in obj]
    return obj


def mutable(obj):
    """Copy-on-write escape hatch: a frozen tree comes back as a fresh,
    fully mutable deep copy; anything else passes through UNCHANGED (a
    plain dict from the uncached store is already the caller's private
    copy — re-copying it would pay the tax the cache exists to kill)."""
    if not is_frozen(obj):
        return obj
    fn = _native()
    if fn is not None:
        return fn(obj)
    return _thaw(obj)


def meta(obj: Obj) -> Obj:
    return obj.setdefault("metadata", {})


def name_of(obj: Obj) -> str:
    return obj.get("metadata", {}).get("name", "")


def namespace_of(obj: Obj) -> str:
    return obj.get("metadata", {}).get("namespace", "")


def labels_of(obj: Obj) -> dict[str, str]:
    return obj.get("metadata", {}).get("labels") or {}


def annotations_of(obj: Obj) -> dict[str, str]:
    return obj.get("metadata", {}).get("annotations") or {}


def set_label(obj: Obj, key: str, value: str) -> None:
    meta(obj).setdefault("labels", {})[key] = value


def set_annotation(obj: Obj, key: str, value: str) -> None:
    meta(obj).setdefault("annotations", {})[key] = value


def parse_rfc3339(s: str) -> float:
    """RFC3339 → epoch seconds; fractional seconds dropped, malformed
    or empty input parses as 0.0 (the epoch — i.e. 'very old')."""
    import calendar
    import time as _time

    try:
        return calendar.timegm(
            _time.strptime(
                s.split(".")[0].rstrip("Z") + "Z", "%Y-%m-%dT%H:%M:%SZ"
            )
        )
    except (ValueError, AttributeError):
        return 0.0


def now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def owner_reference(owner: Obj, *, controller: bool = True, block: bool = True) -> Obj:
    return {
        "apiVersion": owner.get("apiVersion", ""),
        "kind": owner.get("kind", ""),
        "name": name_of(owner),
        "uid": meta(owner).get("uid", ""),
        "controller": controller,
        "blockOwnerDeletion": block,
    }


def set_controller_reference(obj: Obj, owner: Obj) -> None:
    refs = meta(obj).setdefault("ownerReferences", [])
    for ref in refs:
        if ref.get("controller"):
            ref.update(owner_reference(owner))
            return
    refs.append(owner_reference(owner))


def get_path(obj: Obj, *path, default=None):
    cur: Any = obj
    for p in path:
        if isinstance(cur, dict) and p in cur:
            cur = cur[p]
        elif isinstance(cur, list) and isinstance(p, int) and p < len(cur):
            cur = cur[p]
        else:
            return default
    return cur


# ---------------------------------------------------------------------------
# label selectors


def match_label_selector(selector: Optional[Obj], labels: dict[str, str]) -> bool:
    """LabelSelector semantics: matchLabels AND matchExpressions.

    An empty/None selector matches everything (k8s convention for the
    selectors used by PodDefault / AuthorizationPolicy matching).
    """
    if not selector:
        return True
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key", "")
        op = expr.get("operator", "In")
        values = expr.get("values") or []
        has = key in labels
        if op == "In":
            if not has or labels[key] not in values:
                return False
        elif op == "NotIn":
            if has and labels[key] in values:
                return False
        elif op == "Exists":
            if not has:
                return False
        elif op == "DoesNotExist":
            if has:
                return False
        else:
            raise ValueError(f"unknown selector operator {op!r}")
    return True


def parse_selector_string(s: str) -> Obj:
    """'a=b,c!=d,e' → LabelSelector dict (the list-API query form).

    Supports '=', '==', '!=', bare-key existence and kube's '!key'
    (DoesNotExist, which the gang scheduler's remote lists need; the JAX
    package's parser has no such form); anything else raises rather
    than silently mis-parsing."""
    match_labels: dict[str, str] = {}
    exprs: list[Obj] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, _, v = part.partition("!=")
            exprs.append(
                {"key": k.strip(), "operator": "NotIn", "values": [v.strip()]}
            )
        elif "=" in part:
            k, _, v = part.partition("=")
            if "(" in v or " in " in part:
                raise ValueError(f"unsupported selector segment {part!r}")
            match_labels[k.strip()] = v.strip().lstrip("=")
        elif " " in part or "(" in part:
            raise ValueError(f"unsupported selector segment {part!r}")
        elif part.startswith("!"):
            exprs.append({"key": part[1:].strip(), "operator": "DoesNotExist"})
        else:
            exprs.append({"key": part, "operator": "Exists"})
    sel: Obj = {}
    if match_labels:
        sel["matchLabels"] = match_labels
    if exprs:
        sel["matchExpressions"] = exprs
    return sel


# ---------------------------------------------------------------------------
# JSON merge patch (RFC 7386)


def json_merge_patch(target: Any, patch: Any) -> Any:
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    if not isinstance(target, dict):
        target = {}
    result = copy.deepcopy(target)
    for k, v in patch.items():
        if v is None:
            result.pop(k, None)
        else:
            result[k] = json_merge_patch(result.get(k), v)
    return result


# ---------------------------------------------------------------------------
# quantity parsing (resource limits: '500m', '1Gi', '4')


_SUFFIXES = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(q) -> float:
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suffix in sorted(_SUFFIXES, key=len, reverse=True):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * _SUFFIXES[suffix]
    return float(s)


def glob_match(pattern: str, value: str) -> bool:
    return fnmatch.fnmatchcase(value, pattern)
