"""The kube-metadata contract registry and its drift lint.

Components on this platform coordinate through object METADATA at
least as much as through the API verbs: the suspend contract is three
annotations, admission gating is an annotation plus a label, warm-pool
claims are a handshake of five, the usage ledger and the tracer stamp
their own. Each key is a protocol — somebody writes it, somebody else
reads it, and nothing ever checked that both ends exist. Reviews of
the reference found exactly that failing, twice: annotation writers
whose readers never fired.

``analysis/protocol.json`` is the registry (the ``knobs.json`` mold):
every domain-prefixed annotation/label key and every owned status
field, with the kind it rides on, its writer and reader modules, and a
one-line description. This module is the enforcement:

- an AST scanner mines every metadata read/write across the package —
  string-literal keys (``cloud.google.com/gke-nodepool``), module
  constants named ``*_ANNOTATION``/``*_LABEL`` (including bare-name
  values like ``kubeflow-resource-stopped``), resolvable f-strings
  (``f"{GROUP}/workload"``), and prefix constants
  (``…/poddefault-``) — classifying each site as a write (subscript
  store, ``setdefault``, ``pop``, ``del``, metadata dict literal) or a
  read (``get``, load subscript, ``in``, selector dicts,
  ``startswith``, label-index registration);
- :func:`protocol_violations` is the four-way tier-1-gated cross-check:
  code⊆registry (no undocumented keys), registry⊆code (no phantom
  keys), writer-without-reader / reader-without-writer orphan
  detection (externally-owned keys carry ``# protocol-ok: <reason>``
  in code AND an ``external`` note in the registry), and a GUIDE.md
  appendix that must match the rendered registry byte-exact;
- the ``protocol-drift`` :class:`ProgramRule` surfaces the code-side
  violations through ``python -m odh_kubeflow_tpu_torch.analysis`` with
  site-anchored witnesses, sharing ``--format=json`` / ``--baseline``
  semantics with every other graftlint rule.

Status/condition fields are registry-DECLARED, not exhaustively mined:
the scanner verifies each declared field has live writers and readers
(``obj["status"][f]``, ``get_path(obj, "status", f)``, status dict
literals), but does not claim to find every status touch — annotation
and label keys are where the cross-component protocol lives.

Resource names (``nvidia.com/gpu``) are registered with type
``resource`` and exempt from orphan analysis: the writer is the pod
spec (kube semantics), not a platform module.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import sys
from typing import Iterator, Optional

from odh_kubeflow_tpu_torch.analysis.graftlint import (
    Finding,
    ProgramRule,
    SourceFile,
    iter_sources,
    package_root,
    register,
)

# ---------------------------------------------------------------------------
# key recognition

# a domain-prefixed kube metadata key: <dns-domain>/<name>, exactly one
# slash, the domain carrying at least one dot (so media types and path
# fragments don't match)
_DOMAIN_KEY_RE = re.compile(
    r"^[a-z0-9](?:[a-z0-9.-]*[a-z0-9])?\.[a-z]{2,}/"
    r"[A-Za-z0-9][A-Za-z0-9._-]*$"
)
# apiVersion strings share the shape (`rbac.authorization.k8s.io/v1`);
# a version segment after the slash disqualifies the string as a key
_VERSION_SEGMENT_RE = re.compile(r"^v\d+(?:(?:alpha|beta)\d+)?$")

# module constants with these name suffixes register their value as a
# key even when it is bare (no domain prefix): `OWNER_ANNOTATION =
# "owner"`, `GPU_RUNTIME_LABEL = "gpu-runtime"`
_CONST_SUFFIXES = ("_ANNOTATION", "_LABEL", "_ANNOTATION_PREFIX", "_LABEL_PREFIX")

REGISTRY_BASENAME = "protocol.json"
GUIDE_RELPATH = os.path.join("odh_kubeflow_tpu_torch", "GUIDE.md")
APPENDIX_HEADING = "## Appendix: metadata protocol reference"
# presence of this file marks a package-scale run (fixture one-file
# programs only get the code⊆registry check)
ANCHOR_FILE = "apis/__init__.py"
MARKER = "protocol-ok:"


def registry_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), REGISTRY_BASENAME
    )


def repo_root() -> str:
    return os.path.dirname(package_root())


def guide_path() -> str:
    return os.path.join(repo_root(), GUIDE_RELPATH)


def guide_text() -> str:
    with open(guide_path(), encoding="utf-8") as fh:
        return fh.read()


def load_registry(path: Optional[str] = None) -> dict:
    with open(path or registry_path(), encoding="utf-8") as fh:
        return json.load(fh)


def is_protocol_key(value: str) -> bool:
    """Whether a string literal is a domain-prefixed metadata key (and
    not an apiVersion)."""
    if not _DOMAIN_KEY_RE.match(value):
        return False
    name = value.split("/", 1)[1]
    return not _VERSION_SEGMENT_RE.match(name)


# ---------------------------------------------------------------------------
# the scanner


@dataclasses.dataclass(frozen=True)
class Site:
    """One metadata-key touch: where, which way, and whether the
    statement carries a ``# protocol-ok:`` marker."""

    rel: str
    line: int
    access: str  # "write" | "read"
    marked: bool


@dataclasses.dataclass
class Scan:
    """The mined protocol surface of one file set."""

    # key (or prefix key, trailing "-") → sites
    keys: dict[str, list[Site]] = dataclasses.field(default_factory=dict)
    # keys whose constant is *_PREFIX-named or dash-terminated
    prefixes: set[str] = dataclasses.field(default_factory=set)
    # declared-status-field name → sites
    status: dict[str, list[Site]] = dataclasses.field(default_factory=dict)

    def add(self, key: str, site: Site, prefix: bool = False) -> None:
        self.keys.setdefault(key, []).append(site)
        if prefix:
            self.prefixes.add(key)

    def writers(self, key: str) -> list[str]:
        return sorted(
            {s.rel for s in self.keys.get(key, []) if s.access == "write"}
        )

    def readers(self, key: str) -> list[str]:
        return sorted(
            {s.rel for s in self.keys.get(key, []) if s.access == "read"}
        )


def _module_constants(sources: list[SourceFile]) -> dict[str, dict[str, str]]:
    """rel → {constant name → string value}, resolving same-module
    f-strings (``WORKLOAD_LABEL = f"{GROUP}/workload"``) and then
    cross-module ``from x import NAME`` links."""
    plain: dict[str, dict[str, str]] = {}
    pending: dict[str, list[tuple[str, ast.JoinedStr]]] = {}
    for src in sources:
        consts: dict[str, str] = {}
        fstrings: list[tuple[str, ast.JoinedStr]] = []
        for node in src.tree.body:
            targets: list[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names or value is None:
                continue
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                for n in names:
                    consts[n] = value.value
            elif isinstance(value, ast.JoinedStr):
                for n in names:
                    fstrings.append((n, value))
        plain[src.rel] = consts
        pending[src.rel] = fstrings
    by_rel = {s.rel: s for s in sources}
    for rel, fstrings in pending.items():
        for name, node in fstrings:
            resolved = _resolve_fstring(node, rel, plain, by_rel)
            if resolved is not None:
                plain[rel][name] = resolved
    return plain


def _import_map(
    src: SourceFile,
) -> tuple[dict[str, list[tuple[str, str]]], dict[str, list[str]]]:
    """Two resolution maps for ``from x import y [as z]`` statements
    inside the package: imported NAME → candidate (origin rel, origin
    name) pairs, and imported MODULE alias → candidate origin rels
    (``from pkg.utils import tracing`` binds a module — its constants
    are reached through attribute access, ``tracing.TRACE_ANNOTATION``)."""
    names: dict[str, list[tuple[str, str]]] = {}
    modules: dict[str, list[str]] = {}
    pkg = os.path.basename(package_root())
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.module:
            parts = node.module.split(".")
            if node.level == 0 and parts[0] != pkg:
                continue
            if node.level == 0:
                parts = parts[1:]
        elif node.level:
            # `from . import x` / `from .. import x` — resolve against
            # this file's own package path
            parts = src.rel.split("/")[: -node.level]
            if node.module:
                parts += node.module.split(".")
        else:
            continue
        base = "/".join(parts)
        name_origins = (
            [f"{base}.py", f"{base}/__init__.py"] if base else ["__init__.py"]
        )
        for a in node.names:
            bound = a.asname or a.name
            for origin in name_origins:
                names.setdefault(bound, []).append((origin, a.name))
            mod_base = f"{base}/{a.name}" if base else a.name
            modules.setdefault(bound, []).extend(
                [f"{mod_base}.py", f"{mod_base}/__init__.py"]
            )
    return names, modules


def _resolve_fstring(
    node: ast.JoinedStr,
    rel: str,
    consts: dict[str, dict[str, str]],
    by_rel: dict[str, SourceFile],
) -> Optional[str]:
    parts: list[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        elif isinstance(v, ast.FormattedValue) and isinstance(
            v.value, ast.Name
        ):
            name = v.value.id
            val = consts.get(rel, {}).get(name)
            if val is None and rel in by_rel:
                names, _ = _import_map(by_rel[rel])
                for origin, orig_name in names.get(name, []):
                    val = consts.get(origin, {}).get(orig_name)
                    if val is not None:
                        break
            if val is None:
                return None
            parts.append(val)
        else:
            return None
    return "".join(parts)


_SELECTOR_KWARGS = frozenset(
    {"label_selector", "field_matches", "match_labels", "fallback_selector"}
)
# dict-literal keys whose VALUE dict queries metadata rather than
# building it: `{"selector": {KEY: v}}` on a Service, `matchLabels` in
# network policies / PodDefaults, `nodeSelector` on pod specs
_SELECTOR_DICT_KEYS = frozenset({"selector", "matchLabels", "nodeSelector"})
_WRITE_METHODS = frozenset({"setdefault", "pop"})


def _call_writes(meth: str) -> bool:
    """Whether passing a key to ``meth(…)`` mutates metadata:
    ``setdefault``/``pop`` on the dict itself, and the package's
    mutation helpers (``set_annotation``, ``set_label``,
    ``_stamp_editor_sa``, …)."""
    return meth in _WRITE_METHODS or meth.startswith("set_") or "stamp" in meth


class _KeyVisitor:
    """Walks one file, resolving key expressions and classifying each
    by syntactic context. Parent chains are tracked explicitly — the
    classification of a key is a property of what ENCLOSES it."""

    def __init__(
        self,
        src: SourceFile,
        consts: dict[str, str],
        imports: tuple[dict[str, list[tuple[str, str]]], dict[str, list[str]]],
        all_consts: dict[str, dict[str, str]],
        scan: Scan,
        declared_status: frozenset[str],
    ):
        self.src = src
        self.consts = consts
        self.import_names, self.import_modules = imports
        self.all_consts = all_consts
        self.scan = scan
        self.declared_status = declared_status
        # module-level STRING constant definitions are not protocol
        # touches — skip anything enclosed by one (matched by node
        # identity). Module-level dict/list config still counts: a
        # toleration table keyed by a node label USES the label.
        self._const_defs: set[int] = set()
        for node in src.tree.body:
            value = None
            if isinstance(node, ast.Assign):
                value = node.value
            elif isinstance(node, ast.AnnAssign):
                value = node.value
            if isinstance(value, (ast.Constant, ast.JoinedStr)):
                self._const_defs.add(id(node))

    # -- key resolution ------------------------------------------------------

    def _classify_const(self, name: str, val: str) -> Optional[tuple[str, bool]]:
        is_key_name = name.endswith(_CONST_SUFFIXES)
        prefix = name.endswith(("_ANNOTATION_PREFIX", "_LABEL_PREFIX")) or (
            is_key_name and val.endswith("-")
        )
        if is_key_name or is_protocol_key(val):
            return val, prefix
        return None

    def _const_value(self, name: str) -> Optional[tuple[str, bool]]:
        val = self.consts.get(name)
        orig = name
        if val is None:
            for origin, orig_name in self.import_names.get(name, []):
                val = self.all_consts.get(origin, {}).get(orig_name)
                if val is not None:
                    orig = orig_name
                    break
        if val is None:
            return None
        return self._classify_const(orig, val)

    def _attr_value(self, mod_alias: str, attr: str) -> Optional[tuple[str, bool]]:
        for origin in self.import_modules.get(mod_alias, []):
            val = self.all_consts.get(origin, {}).get(attr)
            if val is not None:
                return self._classify_const(attr, val)
        return None

    def key_of(self, node: ast.AST) -> Optional[tuple[str, bool]]:
        """(key, is_prefix) when ``node`` denotes a protocol key."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if is_protocol_key(node.value):
                return node.value, node.value.endswith("-")
            return None
        if isinstance(node, ast.Name):
            return self._const_value(node.id)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            return self._attr_value(node.value.id, node.attr)
        if isinstance(node, ast.JoinedStr):
            # f"{PREFIX}{name}" → a use of the prefix key
            for v in node.values:
                if isinstance(v, ast.FormattedValue) and isinstance(
                    v.value, ast.Name
                ):
                    got = self._const_value(v.value.id)
                    if got is not None and got[1]:
                        return got[0], True
            resolved = _resolve_fstring(
                node,
                self.src.rel,
                self.all_consts,
                {self.src.rel: self.src},
            )
            if resolved is not None and is_protocol_key(resolved):
                return resolved, resolved.endswith("-")
        return None

    # -- context classification ----------------------------------------------

    def classify(self, parents: list[ast.AST], node: ast.AST) -> str:
        """"write", "read", or "skip" (constant definitions)."""
        if any(id(p) in self._const_defs for p in parents):
            return "skip"  # the module-level definition site itself
        for i in range(len(parents) - 1, -1, -1):
            p = parents[i]
            outer = parents[i - 1] if i > 0 else None
            if isinstance(p, ast.Subscript) and p.slice is node:
                if isinstance(p.ctx, (ast.Store, ast.Del)):
                    return "write"
                return "read"
            if isinstance(p, ast.Call):
                fn = p.func
                meth = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else ""
                )
                if node in p.args or any(
                    kw.value is node for kw in p.keywords
                ):
                    if _call_writes(meth):
                        return "write"
                    return "read"
                node = p
                continue
            if isinstance(p, ast.Compare):
                return "read"
            if isinstance(p, ast.Dict):
                if node in p.keys:
                    return self._dict_key_access(parents[:i], p)
                return "read"
            if isinstance(p, (ast.Tuple, ast.List, ast.Set, ast.JoinedStr,
                              ast.FormattedValue, ast.BinOp)):
                node = p
                continue
            if outer is None:
                break
            node = p
        return "read"

    def _dict_key_access(
        self, parents: list[ast.AST], d: ast.Dict
    ) -> str:
        """A dict literal keyed by a protocol key: selector position →
        read (the dict QUERIES the key); anywhere else → write (the
        dict BUILDS metadata)."""
        node: ast.AST = d
        for p in reversed(parents):
            if isinstance(p, ast.Call):
                for kw in p.keywords:
                    if (
                        kw.value is node or kw is node
                    ) and kw.arg in _SELECTOR_KWARGS:
                        return "read"
                fn = p.func
                meth = fn.attr if isinstance(fn, ast.Attribute) else ""
                if node in p.args and meth in (
                    "match_label_selector",
                    "register_label_index",
                ):
                    return "read"
                return "write"
            if isinstance(p, ast.Assign):
                for t in p.targets:
                    if isinstance(t, ast.Name) and "selector" in t.id.lower():
                        return "read"
                return "write"
            if isinstance(p, ast.Dict):
                # the dict we're bubbling up through may itself be the
                # VALUE of a selector key (`"matchLabels": {KEY: v}`)
                for k, v in zip(p.keys, p.values):
                    if (
                        v is node
                        and isinstance(k, ast.Constant)
                        and k.value in _SELECTOR_DICT_KEYS
                    ):
                        return "read"
                node = p
                continue
            if isinstance(p, (ast.Tuple, ast.List, ast.keyword)):
                node = p
                continue
            break
        return "write"

    # -- the walk ------------------------------------------------------------

    def run(self) -> None:
        self._walk(self.src.tree, [], self.src.tree)

    def _walk(self, node: ast.AST, parents: list[ast.AST], stmt: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            child_stmt = child if isinstance(child, ast.stmt) else stmt
            got = self.key_of(child)
            if got is not None:
                key, prefix = got
                access = self.classify(parents + [node], child)
                if access != "skip":
                    self.scan.add(
                        key,
                        Site(
                            self.src.rel,
                            getattr(child, "lineno", 1),
                            access,
                            _has_marker(self.src, child_stmt),
                        ),
                        prefix,
                    )
                if isinstance(child, ast.JoinedStr):
                    continue  # don't descend into a resolved f-string
            self._status_probe(child, parents + [node], child_stmt)
            self._walk(child, parents + [node], child_stmt)

    # -- status fields -------------------------------------------------------

    def _status_probe(
        self, node: ast.AST, parents: list[ast.AST], stmt: ast.AST
    ) -> None:
        """Declared status fields touched through ``x["status"][f]``,
        ``x.get("status", {}).get(f)``, ``get_path(x, "status", f, …)``
        and ``{"status": {f: …}}`` / ``x["status"] = {f: …}`` shapes."""
        if not self.declared_status:
            return

        def is_status(expr: ast.AST) -> bool:
            # unwrap the pervasive `(x.get("status") or {})` guard
            if isinstance(expr, ast.BoolOp):
                return any(is_status(v) for v in expr.values)
            if (
                isinstance(expr, ast.Subscript)
                and isinstance(expr.slice, ast.Constant)
                and expr.slice.value == "status"
            ):
                return True
            if (
                isinstance(expr, ast.Call)
                and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in ("get", "setdefault")
                and expr.args
                and isinstance(expr.args[0], ast.Constant)
                and expr.args[0].value == "status"
            ):
                return True
            # local-variable indirection: `status = ckpt.get("status")
            # or {}` then `status.get("phase")` — a name heuristic, but
            # the idiom is pervasive and fields are declared-only
            if isinstance(expr, ast.Name) and "status" in expr.id.lower():
                return True
            return False

        def emit(field: str, line: int, access: str) -> None:
            if field in self.declared_status:
                self.scan.status.setdefault(field, []).append(
                    Site(self.src.rel, line, access, _has_marker(self.src, stmt))
                )

        if isinstance(node, ast.Subscript) and isinstance(
            node.slice, ast.Constant
        ):
            field = node.slice.value
            if isinstance(field, str) and is_status(node.value):
                access = (
                    "write"
                    if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read"
                )
                emit(field, node.lineno, access)
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("get", "setdefault")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and is_status(node.func.value)
        ):
            emit(
                node.args[0].value,
                node.lineno,
                "write" if node.func.attr == "setdefault" else "read",
            )
        if (
            isinstance(node, ast.Call)
            and (
                (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "get_path"
                )
                or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get_path"
                )
            )
            and len(node.args) >= 3
            and isinstance(node.args[1], ast.Constant)
            and node.args[1].value == "status"
            and isinstance(node.args[2], ast.Constant)
            and isinstance(node.args[2].value, str)
        ):
            emit(node.args[2].value, node.lineno, "read")
        # wl["status"].update({f: …})
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "update"
            and is_status(node.func.value)
            and node.args
            and isinstance(node.args[0], ast.Dict)
        ):
            for k in node.args[0].keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    emit(k.value, k.lineno, "write")
        # obj["status"] = {f: …}  /  status_patch = {f: …}  /
        # {"status": {f: …}}
        fields_dict: Optional[ast.Dict] = None
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and is_status(node.targets[0])
            and isinstance(node.value, ast.Dict)
        ):
            fields_dict = node.value
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (
                    isinstance(k, ast.Constant)
                    and k.value == "status"
                    and isinstance(v, ast.Dict)
                ):
                    fields_dict = v
        if fields_dict is not None:
            for k in fields_dict.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    emit(k.value, k.lineno, "write")


def _has_marker(src: SourceFile, stmt: ast.AST) -> bool:
    # the statement span, plus the line directly above it (the natural
    # home of a standalone `# protocol-ok: <reason>` comment). The
    # line above only counts when it IS a comment line — a trailing
    # marker on the previous statement must not leak downward
    start = getattr(stmt, "lineno", 1)
    end = getattr(stmt, "end_lineno", None) or start
    if any(MARKER in src.line(n) for n in range(start, end + 1)):
        return True
    if start <= 1:
        return False
    above = src.line(start - 1).strip()
    return above.startswith("#") and MARKER in above


def scan_sources(
    sources: list[SourceFile], declared_status: frozenset[str] = frozenset()
) -> Scan:
    scan = Scan()
    consts = _module_constants(sources)
    for src in sources:
        _KeyVisitor(
            src,
            consts.get(src.rel, {}),
            _import_map(src),
            consts,
            scan,
            declared_status,
        ).run()
    return scan


def scan_package(
    root: Optional[str] = None,
    declared_status: frozenset[str] = frozenset(),
) -> Scan:
    return scan_sources(list(iter_sources(root)), declared_status)


# ---------------------------------------------------------------------------
# the appendix (knobs mold: generated-by-enforcement)

_TYPE_ORDER = ("annotation", "label", "resource")
_TYPE_HEADING = {
    "annotation": "Annotations",
    "label": "Labels",
    "resource": "Resource names",
}


def _mods(rels: list[str]) -> str:
    return ", ".join(f"`{r}`" for r in rels) if rels else "—"


def appendix_row(entry: dict) -> str:
    """The canonical GUIDE.md appendix table row for one key — the
    lint demands this EXACT line, so the appendix is generated-by-
    enforcement exactly like the knob reference."""
    ext = " (external)" if entry.get("external") else ""
    return (
        f"| `{entry['key']}` | {entry.get('rides_on', '—')} | "
        f"{_mods(entry.get('writers', []))} | "
        f"{_mods(entry.get('readers', []))} | "
        f"{entry['description']}{ext} |"
    )


def status_row(entry: dict) -> str:
    return (
        f"| `{entry['field']}` | {entry.get('rides_on', '—')} | "
        f"{_mods(entry.get('writers', []))} | "
        f"{_mods(entry.get('readers', []))} | "
        f"{entry['description']} |"
    )


def render_appendix(registry: Optional[dict] = None) -> str:
    """The full appendix body (type-grouped tables) rendered from the
    registry — paste-ready for GUIDE.md under the
    '## Appendix: metadata protocol reference' heading."""
    reg = registry if registry is not None else load_registry()
    by_type: dict[str, list[dict]] = {}
    for e in reg.get("keys", []):
        by_type.setdefault(e.get("type", "annotation"), []).append(e)
    lines: list[str] = []
    for t in _TYPE_ORDER:
        if t not in by_type:
            continue
        lines += [
            f"### {_TYPE_HEADING[t]}",
            "",
            "| key | rides on | writers | readers | description |",
            "|---|---|---|---|---|",
        ]
        lines += [
            appendix_row(e)
            for e in sorted(by_type[t], key=lambda x: x["key"])
        ]
        lines.append("")
    status = reg.get("status_fields", [])
    if status:
        lines += [
            "### Status fields",
            "",
            "| field | rides on | writers | readers | description |",
            "|---|---|---|---|---|",
        ]
        lines += [
            status_row(e) for e in sorted(status, key=lambda x: x["field"])
        ]
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


# ---------------------------------------------------------------------------
# the four-way cross-check


def _match_registry_key(key: str, entries: dict[str, dict]) -> Optional[str]:
    """The registry key covering ``key`` — exact, or a registered
    prefix entry the key extends."""
    if key in entries:
        return key
    for rkey, e in entries.items():
        if e.get("prefix") and key.startswith(rkey):
            return rkey
    return None


def protocol_violations(
    root: Optional[str] = None,
    registry: Optional[dict] = None,
    guide: Optional[str] = None,
    scan: Optional[Scan] = None,
) -> list[str]:
    """Every drift between code, registry and GUIDE.md — empty on a
    healthy tree (the tier-1 gate, ``tests/test_torch_protocol.py``)."""
    reg = registry if registry is not None else load_registry()
    entries = {e["key"]: e for e in reg.get("keys", [])}
    status_entries = {e["field"]: e for e in reg.get("status_fields", [])}
    declared_status = frozenset(status_entries)
    scanned = (
        scan
        if scan is not None
        else scan_package(root, declared_status=declared_status)
    )
    text = guide if guide is not None else guide_text()
    out: list[str] = []

    for key in sorted(scanned.keys):
        rkey = _match_registry_key(key, entries)
        if rkey is None:
            sites = scanned.keys[key]
            where = ", ".join(
                sorted({s.rel for s in sites})
            )
            out.append(
                f"undocumented metadata key {key!r} (touched in {where}): "
                "add it to analysis/protocol.json with type/rides_on/"
                "writers/readers/description"
            )
    seen_by_rkey: dict[str, list[Site]] = {}
    for key, sites in scanned.keys.items():
        rkey = _match_registry_key(key, entries)
        if rkey is not None:
            seen_by_rkey.setdefault(rkey, []).extend(sites)
    for rkey, e in entries.items():
        sites = seen_by_rkey.get(rkey)
        if not sites:
            out.append(
                f"phantom metadata key {rkey!r}: registered in "
                "analysis/protocol.json but never touched by package "
                "code — delete the entry or fix the scanner miss"
            )
            continue
        writers = sorted({s.rel for s in sites if s.access == "write"})
        readers = sorted({s.rel for s in sites if s.access == "read"})
        if writers != e.get("writers", []):
            out.append(
                f"metadata key {rkey!r}: registry writers "
                f"{e.get('writers', [])} != scanned {writers} — resync "
                "with `python -m odh_kubeflow_tpu_torch.analysis.protocol "
                "--sync-registry`"
            )
        if readers != e.get("readers", []):
            out.append(
                f"metadata key {rkey!r}: registry readers "
                f"{e.get('readers', [])} != scanned {readers} — resync "
                "with `python -m odh_kubeflow_tpu_torch.analysis.protocol "
                "--sync-registry`"
            )
        if e.get("type") == "resource":
            continue  # written by pod specs, kube semantics
        marked = any(s.marked for s in sites)
        external = bool(e.get("external"))
        if writers and not readers and not marked:
            out.append(
                f"orphan metadata key {rkey!r}: written in "
                f"{', '.join(writers)} but nothing in the package reads "
                "it — dead protocol, or an external consumer; fix the "
                "dead write or mark a site `# protocol-ok: <reason>` "
                'and set "external" in the registry'
            )
        if readers and not writers and not marked:
            out.append(
                f"orphan metadata key {rkey!r}: read in "
                f"{', '.join(readers)} but nothing in the package writes "
                "it — dead read, or an externally-written key; fix the "
                "dead read or mark a site `# protocol-ok: <reason>` "
                'and set "external" in the registry'
            )
        if external and not marked:
            out.append(
                f"metadata key {rkey!r} is marked external in the "
                "registry but no touch site carries `# protocol-ok: "
                "<reason>` — annotate the code so the exemption is "
                "visible where the key is used"
            )
    for field, e in status_entries.items():
        sites = scanned.status.get(field, [])
        writers = sorted({s.rel for s in sites if s.access == "write"})
        readers = sorted({s.rel for s in sites if s.access == "read"})
        if not writers:
            out.append(
                f"status field {field!r}: registered in "
                "analysis/protocol.json but no package writer found — "
                "delete the entry or fix the scanner miss"
            )
        if not readers:
            out.append(
                f"status field {field!r}: registered in "
                "analysis/protocol.json but no package reader found — "
                "delete the entry or fix the scanner miss"
            )
        if writers and e.get("writers", []) != writers:
            out.append(
                f"status field {field!r}: registry writers "
                f"{e.get('writers', [])} != scanned {writers} — resync "
                "with `python -m odh_kubeflow_tpu_torch.analysis.protocol "
                "--sync-registry`"
            )
        if readers and e.get("readers", []) != readers:
            out.append(
                f"status field {field!r}: registry readers "
                f"{e.get('readers', [])} != scanned {readers} — resync "
                "with `python -m odh_kubeflow_tpu_torch.analysis.protocol "
                "--sync-registry`"
            )
    if APPENDIX_HEADING not in text:
        out.append(
            f"GUIDE.md is missing the '{APPENDIX_HEADING}' section "
            "— render it with `python -m odh_kubeflow_tpu_torch.analysis."
            "protocol --render-appendix`"
        )
    else:
        for e in reg.get("keys", []):
            if appendix_row(e) not in text:
                out.append(
                    f"metadata key {e['key']!r}'s appendix row is stale "
                    "or missing in GUIDE.md — regenerate with "
                    "`python -m odh_kubeflow_tpu_torch.analysis.protocol "
                    "--render-appendix`"
                )
        for e in reg.get("status_fields", []):
            if status_row(e) not in text:
                out.append(
                    f"status field {e['field']!r}'s appendix row is "
                    "stale or missing in GUIDE.md — regenerate with "
                    "`python -m odh_kubeflow_tpu_torch.analysis.protocol "
                    "--render-appendix`"
                )
    return sorted(out)


# ---------------------------------------------------------------------------
# the lint rule


@register
class ProtocolDriftRule(ProgramRule):
    """The code-side half of the protocol cross-check, surfaced with
    site anchors through the shared graftlint CLI: undocumented keys,
    orphaned writers/readers, and registry drift. The GUIDE appendix
    byte-exactness and phantom-key checks live in
    :func:`protocol_violations` (the knobs mold) — they anchor to the
    registry and the guide, not to package code."""

    id = "protocol-drift"
    description = (
        "kube-metadata key drifting from the protocol registry "
        "(undocumented key, orphaned writer/reader, stale writers/"
        "readers lists)"
    )

    def check_program(self, program) -> Iterator[Finding]:
        try:
            reg = load_registry()
        except (OSError, ValueError):
            return
        entries = {e["key"]: e for e in reg.get("keys", [])}
        declared_status = frozenset(
            e["field"] for e in reg.get("status_fields", [])
        )
        sources = list(program.sources.values())
        scan = scan_sources(sources, declared_status)
        by_rel = {s.rel: s for s in sources}
        full = ANCHOR_FILE in program.sources

        def anchor(sites: list[Site]) -> tuple[SourceFile, ast.AST]:
            first = min(sites, key=lambda s: (s.rel, s.line))
            src = by_rel[first.rel]
            node = ast.Module(body=[], type_ignores=[])
            node.lineno = first.line  # type: ignore[attr-defined]
            node.end_lineno = first.line  # type: ignore[attr-defined]
            return src, node

        for key in sorted(scan.keys):
            if _match_registry_key(key, entries) is None:
                src, node = anchor(scan.keys[key])
                yield self.finding(
                    src,
                    node,
                    f"metadata key {key!r} is not in the protocol "
                    "registry — add it to analysis/protocol.json with "
                    "type/rides_on/writers/readers/description (and "
                    "re-render the GUIDE appendix)",
                )
        if not full:
            return
        seen_by_rkey: dict[str, list[Site]] = {}
        for key, sites in scan.keys.items():
            rkey = _match_registry_key(key, entries)
            if rkey is not None:
                seen_by_rkey.setdefault(rkey, []).extend(sites)
        for rkey, e in entries.items():
            sites = seen_by_rkey.get(rkey)
            if not sites or e.get("type") == "resource":
                continue
            writers = sorted({s.rel for s in sites if s.access == "write"})
            readers = sorted({s.rel for s in sites if s.access == "read"})
            marked = any(s.marked for s in sites)
            if writers and not readers and not marked:
                src, node = anchor(
                    [s for s in sites if s.access == "write"]
                )
                yield self.finding(
                    src,
                    node,
                    f"metadata key {rkey!r} is written here but nothing "
                    "in the package reads it — dead protocol or an "
                    "external consumer; fix the write or mark "
                    "`# protocol-ok: <reason>` and set \"external\" in "
                    "analysis/protocol.json",
                )
            if readers and not writers and not marked:
                src, node = anchor(
                    [s for s in sites if s.access == "read"]
                )
                yield self.finding(
                    src,
                    node,
                    f"metadata key {rkey!r} is read here but nothing in "
                    "the package writes it — dead read or an externally-"
                    "written key; fix the read or mark "
                    "`# protocol-ok: <reason>` and set \"external\" in "
                    "analysis/protocol.json",
                )
            if writers != e.get("writers", []) or readers != e.get(
                "readers", []
            ):
                src, node = anchor(sites)
                yield self.finding(
                    src,
                    node,
                    f"metadata key {rkey!r}: the registry's writers/"
                    "readers lists are stale (registry "
                    f"{e.get('writers', [])}/{e.get('readers', [])}, "
                    f"scanned {writers}/{readers}) — resync with "
                    "`python -m odh_kubeflow_tpu_torch.analysis.protocol "
                    "--sync-registry` and re-render the GUIDE appendix",
                )


# ---------------------------------------------------------------------------
# CLI (knobs mold + --sync-registry)


def sync_registry(path: Optional[str] = None) -> dict:
    """Re-mine writers/readers into the registry file, preserving
    hand-written fields (type, rides_on, description, external,
    prefix) — the maintenance half of the ratchet: add the row by
    hand, let the scanner keep the file lists honest."""
    p = path or registry_path()
    reg = load_registry(p)
    declared_status = frozenset(
        e["field"] for e in reg.get("status_fields", [])
    )
    scan = scan_package(declared_status=declared_status)
    entries = {e["key"]: e for e in reg.get("keys", [])}
    seen: dict[str, list[Site]] = {}
    for key, sites in scan.keys.items():
        rkey = _match_registry_key(key, entries)
        if rkey is not None:
            seen.setdefault(rkey, []).extend(sites)
    for e in reg.get("keys", []):
        sites = seen.get(e["key"], [])
        e["writers"] = sorted({s.rel for s in sites if s.access == "write"})
        e["readers"] = sorted({s.rel for s in sites if s.access == "read"})
    for e in reg.get("status_fields", []):
        sites = scan.status.get(e["field"], [])
        e["writers"] = sorted({s.rel for s in sites if s.access == "write"})
        e["readers"] = sorted({s.rel for s in sites if s.access == "read"})
    with open(p, "w", encoding="utf-8") as fh:
        json.dump(reg, fh, indent=2, sort_keys=False)
        fh.write("\n")
    return reg


def main(argv: Optional[list[str]] = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if "--render-appendix" in args:
        print(render_appendix(), end="")
        return 0
    if "--sync-registry" in args:
        reg = sync_registry()
        print(
            f"protocol-registry: resynced {len(reg.get('keys', []))} "
            f"key(s) + {len(reg.get('status_fields', []))} status "
            "field(s)",
            file=sys.stderr,
        )
        return 0
    if "--dump-scan" in args:
        reg = load_registry()
        declared_status = frozenset(
            e["field"] for e in reg.get("status_fields", [])
        )
        scan = scan_package(declared_status=declared_status)
        for key in sorted(scan.keys):
            for s in scan.keys[key]:
                print(f"{key}\t{s.access}\t{s.rel}:{s.line}"
                      + ("\tmarked" if s.marked else ""))
        for field in sorted(scan.status):
            for s in scan.status[field]:
                print(f"status.{field}\t{s.access}\t{s.rel}:{s.line}")
        return 0
    violations = protocol_violations()
    for v in violations:
        print(v)
    reg = load_registry()
    n = len(reg.get("keys", []))
    ns = len(reg.get("status_fields", []))
    if violations:
        print(
            f"protocol-registry: {len(violations)} violation(s) across "
            f"{n} key(s) + {ns} status field(s)",
            file=sys.stderr,
        )
        return 1
    print(
        f"protocol-registry: clean ({n} keys, {ns} status fields)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
