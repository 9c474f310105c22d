"""Knob-registry drift lint: every env knob, accounted for.

The platform is configured by ~130 ``os.environ`` reads spread across
the runner, client, replica, profile and platform layers. Each knob is
documented in the port's guide (``odh_kubeflow_tpu_torch/GUIDE.md``,
outside ``docs/``) and, for the deployed components, set in a manifest
env stanza — three surfaces that drift independently: manifests that
ship envs nothing reads, and new knobs landing in code without a guide
row.

This module makes the registry (``analysis/knobs.json``) the single
machine-readable source of truth and cross-checks it against all three
surfaces, tier-1 gated (``tests/test_torch_knobs.py``) and CLI-runnable::

    python -m odh_kubeflow_tpu_torch.analysis.knobs

Checks:

- **undocumented**: a knob read in package code but absent from the
  registry — add a registry entry (name, scope, default, description).
- **phantom**: a registry knob no code reads — delete the entry or the
  dead config it describes. Entries marked ``"dynamic": true`` are
  exempt (read via generated code or a computed name the AST scan
  cannot see, e.g. the in-pod profiler autostart flag).
- **guide**: every registry knob must appear backticked in
  ``odh_kubeflow_tpu_torch/GUIDE.md`` (the knob reference appendix).
- **manifest**: every ``env:`` name in the port's overlay
  (``manifests/overlays/gpu/**.yaml``; empty until the port ships its
  deployment files) that looks like a platform knob must be a registry
  knob (or listed in the registry's ``manifest_external`` allowlist —
  envs owned by kube or third-party images).

The scanner is AST-based and understands the package's idioms:
``os.environ.get/[]/setdefault``, ``os.getenv``, ``env = os.environ``
aliases, module-level name constants (``CHAOS_ENV = "GRAFT_CHAOS"``),
and per-file env-reader helpers (``_env_int("SNAPSHOT_BYTES", …)``,
nested ``flag("USE_ISTIO")`` closures) — a helper is any function with
a parameter that flows into an environ read's key position.
"""

from __future__ import annotations

import ast
import json
import os
import re
import sys
from typing import Iterator, Optional

from odh_kubeflow_tpu_torch.analysis.graftlint import iter_sources, package_root

_attr = None  # no callgraph dependency: the scan is self-contained


def registry_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "knobs.json")


def repo_root() -> str:
    return os.path.dirname(package_root())


GUIDE_NAME = "GUIDE.md"


def guide_path() -> str:
    return os.path.join(package_root(), GUIDE_NAME)


def manifests_root() -> str:
    return os.path.join(repo_root(), "manifests", "overlays", "gpu")


# knob names are SCREAMING_SNAKE; anything else in an env stanza (e.g.
# lowercase pod metadata) is ignored by the manifest cross-check
_KNOB_NAME_RE = re.compile(r"^[A-Z][A-Z0-9_]{2,}$")


# ---------------------------------------------------------------------------
# scanner


def _environ_aliases(tree: ast.AST) -> set[str]:
    """Names bound to ``os.environ`` — ``env = os.environ`` aliases and
    ``from os import environ`` imports. A bare name called ``environ``
    is NOT assumed (WSGI handlers take a request dict by that name)."""
    aliases: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if a.name == "environ":
                    aliases.add(a.asname or a.name)
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if (
            isinstance(v, ast.Attribute)
            and v.attr == "environ"
            and isinstance(v.value, ast.Name)
            and v.value.id == "os"
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases.add(t.id)
    return aliases


def _name_constants(tree: ast.AST) -> dict[str, str]:
    """Module-level ``NAME = "LITERAL"`` string constants (resolves
    ``os.environ.get(CHAOS_ENV)``)."""
    out: dict[str, str] = {}
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def _is_environ_base(node: ast.AST, aliases: set[str]) -> bool:
    """``os.environ`` / a recorded alias of it."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return isinstance(node.value, ast.Name) and node.value.id == "os"
    return isinstance(node, ast.Name) and node.id in aliases


def _env_key_exprs(tree: ast.AST, aliases: set[str]) -> Iterator[ast.AST]:
    """Every expression used as an environ KEY in this tree:
    ``<environ>.get/setdefault(K, …)``, ``<environ>[K]``,
    ``os.getenv(K, …)``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in ("get", "setdefault", "pop")
                and _is_environ_base(f.value, aliases)
                and node.args
            ):
                yield node.args[0]
            elif (
                isinstance(f, ast.Attribute)
                and f.attr == "getenv"
                and isinstance(f.value, ast.Name)
                and f.value.id == "os"
                and node.args
            ):
                yield node.args[0]
        elif isinstance(node, ast.Subscript) and _is_environ_base(
            node.value, aliases
        ):
            yield node.slice


def _helper_params(tree: ast.AST, aliases: set[str]) -> dict[str, int]:
    """Functions (at any nesting) where a PARAMETER flows into an
    environ read's key position → {helper name: param index}. Catches
    ``_env_int(name, default)`` and the nested ``flag(name)`` idiom."""
    helpers: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = [a.arg for a in node.args.args]
        for key in _env_key_exprs(node, aliases):
            if isinstance(key, ast.Name) and key.id in params:
                helpers[node.name] = params.index(key.id)
    return helpers


def scan_tree(tree: ast.AST) -> set[str]:
    """Knob names read by one parsed module."""
    aliases = _environ_aliases(tree)
    consts = _name_constants(tree)
    names: set[str] = set()

    def key_name(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            return consts.get(expr.id)
        return None

    for key in _env_key_exprs(tree, aliases):
        name = key_name(key)
        if name:
            names.add(name)
    helpers = _helper_params(tree, aliases)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = None
        if isinstance(node.func, ast.Name):
            fname = node.func.id
        elif isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        idx = helpers.get(fname or "")
        if idx is None:
            continue
        # self/cls offset does not apply: helpers here are module-level
        # or nested functions, never methods, and the scan is per-file
        if idx < len(node.args):
            name = key_name(node.args[idx])
            if name:
                names.add(name)
    return names


def scan_source(text: str) -> set[str]:
    """Fixture entry point: knob names read by a source string."""
    return scan_tree(ast.parse(text))


def scan_package(root: Optional[str] = None) -> dict[str, list[str]]:
    """Knob → sorted list of package-relative files reading it."""
    out: dict[str, set[str]] = {}
    for src in iter_sources(root):
        for name in scan_tree(src.tree):
            out.setdefault(name, set()).add(src.rel)
    return {k: sorted(v) for k, v in sorted(out.items())}


# ---------------------------------------------------------------------------
# registry + cross-checks


def load_registry(path: Optional[str] = None) -> dict:
    with open(path or registry_path(), encoding="utf-8") as fh:
        return json.load(fh)


def guide_text(path: Optional[str] = None) -> str:
    with open(path or guide_path(), encoding="utf-8") as fh:
        return fh.read()


def guide_knob_mentions(text: str) -> set[str]:
    """Backticked SCREAMING_SNAKE names anywhere in the guide text."""
    return {
        m.group(1)
        for m in re.finditer(r"`([A-Z][A-Z0-9_]{2,})(?:=[^`]*)?`", text)
    }


# scopes in appendix order (free-form strings; unknown scopes sort last)
_SCOPE_ORDER = (
    "platform", "runner", "client", "replica", "controller", "scheduler",
    "sessions", "warmup", "profile", "web", "webhooks", "pod", "test",
)


def appendix_row(entry: dict) -> str:
    """The canonical GUIDE.md appendix table row for one registry
    entry — the lint demands this EXACT line in the guide, so the
    appendix is generated-by-enforcement: edit knobs.json, re-render,
    and a stale default/description row fails tier-1."""
    default = entry.get("default") or "—"
    return f"| `{entry['name']}` | {default} | {entry['description']} |"


def render_appendix(registry: Optional[dict] = None) -> str:
    """The full '## Appendix: knob reference' body (scope-grouped
    tables) rendered from the registry — paste-ready for GUIDE.md."""
    reg = registry if registry is not None else load_registry()
    by_scope: dict[str, list[dict]] = {}
    for e in reg.get("knobs", []):
        by_scope.setdefault(e.get("scope", "?"), []).append(e)
    order = [s for s in _SCOPE_ORDER if s in by_scope] + sorted(
        s for s in by_scope if s not in _SCOPE_ORDER
    )
    lines: list[str] = []
    for scope in order:
        lines += [f"### {scope}", "", "| knob | default | description |",
                  "|---|---|---|"]
        lines += [
            appendix_row(e)
            for e in sorted(by_scope[scope], key=lambda x: x["name"])
        ]
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def manifest_env_names(root: Optional[str] = None) -> dict[str, list[str]]:
    """Env names set in manifest stanzas: ``- name: KNOB`` entries and
    kustomize ``KNOB=value`` literals, knob-shaped names only."""
    root = root or manifests_root()
    out: dict[str, set[str]] = {}
    name_re = re.compile(r"^\s*-?\s*name:\s*([A-Z][A-Z0-9_]{2,})\s*$")
    literal_re = re.compile(r"^\s*-\s*([A-Z][A-Z0-9_]{2,})=")
    for dirpath, _dirs, files in os.walk(root):
        for fname in sorted(files):
            if not fname.endswith((".yaml", ".yml")):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    m = name_re.match(line) or literal_re.match(line)
                    if m and _KNOB_NAME_RE.match(m.group(1)):
                        out.setdefault(m.group(1), set()).add(rel)
    return {k: sorted(v) for k, v in sorted(out.items())}


def knob_violations(
    root: Optional[str] = None,
    registry: Optional[dict] = None,
    guide: Optional[str] = None,
    manifests: Optional[dict[str, list[str]]] = None,
) -> list[str]:
    """Every drift between code, registry, GUIDE.md and manifests —
    empty on a healthy tree (the tier-1 gate). ``guide`` is the guide
    TEXT (defaults to the port's GUIDE.md): each registry knob must appear
    backticked AND its exact :func:`appendix_row` must be present, so
    the appendix cannot drift from the registry's defaults or
    descriptions."""
    reg = registry if registry is not None else load_registry()
    knobs = {e["name"]: e for e in reg.get("knobs", [])}
    scanned = scan_package(root)
    text = guide if guide is not None else guide_text()
    guide_names = guide_knob_mentions(text)
    manifest = (
        manifests if manifests is not None else manifest_env_names()
    )
    external = set(reg.get("manifest_external", []))
    out: list[str] = []
    for name, files in scanned.items():
        if name not in knobs:
            out.append(
                f"undocumented knob {name!r} (read in {', '.join(files)}): "
                "add it to analysis/knobs.json with scope/default/"
                "description and a GUIDE.md row"
            )
    for name, entry in knobs.items():
        if entry.get("dynamic"):
            continue
        if name not in scanned:
            out.append(
                f"phantom knob {name!r}: registered in analysis/knobs.json "
                "but no package code reads it — delete the entry or mark "
                'it "dynamic" with a pointer to the generated read site'
            )
    for name, entry in knobs.items():
        if name not in guide_names:
            out.append(
                f"knob {name!r} is not documented in GUIDE.md — add "
                "it to a knob table (the Knob reference appendix at "
                "minimum)"
            )
        elif appendix_row(entry) not in text:
            out.append(
                f"knob {name!r}'s appendix row is stale or missing in "
                "GUIDE.md (default/description diverged from "
                "analysis/knobs.json) — regenerate with `python -m "
                "odh_kubeflow_tpu_torch.analysis.knobs --render-appendix`"
            )
    for name, files in manifest.items():
        if name in knobs or name in external:
            continue
        out.append(
            f"manifest env {name!r} ({', '.join(files)}) is not a "
            "registered knob: nothing in the package reads it — remove "
            "the stanza, wire the knob, or allowlist it under "
            '"manifest_external" in analysis/knobs.json'
        )
    return sorted(out)


def main(argv: Optional[list[str]] = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if "--render-appendix" in args:
        # paste-ready appendix body for GUIDE.md, straight from
        # the registry (the lint holds the guide to these exact rows)
        print(render_appendix(), end="")
        return 0
    violations = knob_violations()
    for v in violations:
        print(v)
    n = len(load_registry().get("knobs", []))
    if violations:
        print(
            f"knob-registry: {len(violations)} violation(s) across "
            f"{n} registered knob(s)",
            file=sys.stderr,
        )
        return 1
    print(f"knob-registry: clean ({n} knobs)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
