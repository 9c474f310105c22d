"""graftlint: AST-based checker for platform invariants.

The control plane's correctness rests on conventions the compiler
never sees — frozen cache objects must not be mutated without
``mutable()``, hot paths must not issue bare cluster-wide lists,
metric names must follow controller-runtime conventions, reconcile
loops must not swallow errors, and nothing blocking may run under a
store/cache lock. Each convention is a :class:`Rule` over the Python
``ast`` (stdlib only, no third-party deps); this module is the
framework — the registry, per-line suppression syntax, file/rule
allowlists, and the findings report. The platform's rules live in
``analysis/rules.py`` and self-register on import.

Usage::

    python -m odh_kubeflow_tpu_torch.analysis            # whole package, exit 1 on findings
    python -m odh_kubeflow_tpu_torch.analysis --select uncached-list path/to/file.py

Suppression::

    something_flagged()  # graftlint: disable=<rule>[,<rule2>] <reason>

applies to every finding whose line falls inside the suppressing
statement (so a multi-line call needs the marker on any of its lines).
``disable=all`` silences every rule on that line. A whole file opts
out of one rule with ``# graftlint: disable-file=<rule> <reason>`` on
any line (reserve this for generated or fixture code). The legacy
``# uncached-ok: <reason>`` marker is honoured by the
``uncached-list`` rule for continuity with the old grep-based scan.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Iterable, Iterator, Optional

PACKAGE = "odh_kubeflow_tpu_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,-]+)(?:\s+(?P<reason>.*))?"
)
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*graftlint:\s*disable-file=([A-Za-z0-9_,-]+)(?:\s+(?P<reason>.*))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location. ``end_line`` is the
    last line of the offending statement — suppression markers
    anywhere in the span apply (multi-line calls put the comment where
    it reads best)."""

    rule: str
    path: str  # package-relative posix path
    line: int
    message: str
    severity: str = "error"
    end_line: int = 0

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.severity}: [{self.rule}] {self.message}"


class SourceFile:
    """A parsed source file plus the comment-level context rules need
    (suppression markers, section = first directory under the
    package)."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        parts = self.rel.split("/")
        self.section = parts[0] if len(parts) > 1 else ""
        self._line_disables: dict[int, set[str]] = {}
        self._file_disables: set[str] = set()
        for lineno, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self._line_disables[lineno] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
            m = _SUPPRESS_FILE_RE.search(line)
            if m:
                self._file_disables.update(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, rule: str, start: int, end: Optional[int] = None) -> bool:
        """Whether ``rule`` is disabled for lines ``start..end`` (a
        statement's span) — by a line marker inside the span or a
        file-level marker."""
        if rule in self._file_disables or "all" in self._file_disables:
            return True
        for lineno in range(start, (end or start) + 1):
            rules = self._line_disables.get(lineno)
            if rules and (rule in rules or "all" in rules):
                return True
        return False

    def span_text(self, start: int, end: Optional[int] = None) -> str:
        return "\n".join(
            self.lines[start - 1 : (end or start)]
        )


class Rule:
    """Base class: subclass, set ``id``/``description``, implement
    ``check``, and register with :func:`register`. ``dirs`` (sections
    under the package) and ``files`` (exact package-relative paths)
    are the file allowlists — the UNION applies when both are set
    (a dir-scoped rule can pull in individual out-of-dir files, e.g.
    ``unbounded-list`` covering ``machinery/replica.py`` next to
    ``web/``); both ``None`` means every file."""

    id: str = ""
    description: str = ""
    severity: str = "error"
    dirs: Optional[tuple[str, ...]] = None
    files: Optional[tuple[str, ...]] = None
    whole_program = False

    def applies(self, src: SourceFile) -> bool:
        if self.files is None and self.dirs is None:
            return True
        return bool(
            (self.files is not None and src.rel in self.files)
            or (self.dirs is not None and src.section in self.dirs)
        )

    def check(self, src: SourceFile) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(
        self, src: SourceFile, node: ast.AST, message: str
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            self.id,
            src.rel,
            line,
            message,
            self.severity,
            end_line=getattr(node, "end_lineno", None) or line,
        )


class ProgramRule(Rule):
    """A whole-program rule: instead of one file at a time it sees the
    complete analyzed file set as a :class:`callgraph.Program` (call
    graph + lock-context dataflow) and reports across function and
    file boundaries. ``check_program`` runs once per lint invocation;
    per-line/file suppression applies to its findings exactly as to
    per-file findings (by the finding's path + line span)."""

    whole_program = True

    def check(self, src: SourceFile) -> Iterator[Finding]:
        return iter(())  # program rules never run per-file

    def check_program(self, program) -> Iterator[Finding]:
        raise NotImplementedError


RULES: dict[str, Rule] = {}


def register(cls: type) -> type:
    """Class decorator adding a rule to the global registry."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"{cls.__name__} has no rule id")
    RULES[rule.id] = rule
    return cls


def active_rules(select: Optional[Iterable[str]] = None) -> list[Rule]:
    """The rule allowlist: all registered rules, or the ``select``
    subset (unknown ids raise — a typo must not silently skip)."""
    _ensure_rules_loaded()
    if select is None:
        return list(RULES.values())
    out = []
    for rule_id in select:
        if rule_id not in RULES:
            raise KeyError(
                f"unknown rule {rule_id!r}; known: {', '.join(sorted(RULES))}"
            )
        out.append(RULES[rule_id])
    return out


def _ensure_rules_loaded() -> None:
    from odh_kubeflow_tpu_torch.analysis import rules as _rules  # noqa: F401 — self-registering


# ---------------------------------------------------------------------------
# runners


def run_source(src: SourceFile, rules: Iterable[Rule]) -> list[Finding]:
    """Run per-file ``rules`` over one parsed file, applying
    suppressions."""
    findings: list[Finding] = []
    for rule in rules:
        if rule.whole_program or not rule.applies(src):
            continue
        for f in rule.check(src):
            if not src.suppressed(f.rule, f.line, f.end_line or f.line):
                findings.append(f)
    return findings


def run_program_rules(
    sources: list[SourceFile], rules: Iterable[Rule]
) -> list[Finding]:
    """Run the whole-program rules once over the analyzed file set,
    applying per-line/file suppressions by finding location."""
    prules = [r for r in rules if r.whole_program]
    if not prules:
        return []
    from odh_kubeflow_tpu_torch.analysis.callgraph import build_program

    program = build_program(sources)
    by_rel = {s.rel: s for s in sources}
    findings: list[Finding] = []
    for rule in prules:
        for f in rule.check_program(program):
            src = by_rel.get(f.path)
            if src is not None and src.suppressed(
                f.rule, f.line, f.end_line or f.line
            ):
                continue
            findings.append(f)
    return findings


def lint_source(
    text: str, rel: str, select: Optional[Iterable[str]] = None
) -> list[Finding]:
    """Lint a source string as if it lived at package-relative path
    ``rel`` (the fixture-snippet entry point tests use). Whole-program
    rules see a one-file program, so interprocedural fixtures stay
    self-contained."""
    src = SourceFile(path=rel, rel=rel, text=text)
    rules = active_rules(select)
    findings = run_source(src, rules)
    findings.extend(run_program_rules([src], rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_sources(
    root: Optional[str] = None, rel_root: Optional[str] = None
) -> Iterator[SourceFile]:
    """Every ``.py`` file under ``root`` (vendored frontend assets and
    caches are skipped). ``rel_root`` anchors the package-relative
    paths rules scope on — linting a subdirectory of the package must
    keep each file's real section (``controllers/…``), not re-root it."""
    root = root or package_root()
    rel_root = rel_root or root
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [
            d for d in dirnames if d not in ("__pycache__", "frontend")
        ]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, rel_root)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            yield SourceFile(path, rel, text)


def run_package(
    root: Optional[str] = None, select: Optional[Iterable[str]] = None
) -> list[Finding]:
    """Run the rule set over the whole package; findings come back
    sorted by path/line (the tier-1 gate asserts this is empty modulo
    the committed baseline)."""
    rules = active_rules(select)
    sources = list(iter_sources(root))
    findings: list[Finding] = []
    for src in sources:
        findings.extend(run_source(src, rules))
    findings.extend(run_program_rules(sources, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_paths(
    paths: Iterable[str], select: Optional[Iterable[str]] = None
) -> list[Finding]:
    """Run rules over explicit files/directories. Paths inside the
    package keep their package-relative section (so dir-scoped rules
    apply as in a package run); outside paths are treated as
    section-less. Whole-program rules see exactly the given file set —
    call chains leaving it are simply unresolved."""
    rules = active_rules(select)
    root = package_root()
    sources: list[SourceFile] = []
    for path in paths:
        abspath = os.path.abspath(path)
        inside = abspath == root or abspath.startswith(root + os.sep)
        if os.path.isdir(path):
            sources.extend(
                iter_sources(abspath, rel_root=root if inside else abspath)
            )
            continue
        rel = (
            os.path.relpath(abspath, root)
            if inside
            else os.path.basename(path)
        )
        with open(path, encoding="utf-8") as f:
            text = f.read()
        sources.append(SourceFile(path, rel, text))
    findings: list[Finding] = []
    for src in sources:
        findings.extend(run_source(src, rules))
    findings.extend(run_program_rules(sources, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# baseline (ratcheting: CI fails only on NEW findings)


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


_LINE_REF_RE = re.compile(r"(\.py):\d+")


def baseline_key(f: Finding) -> tuple[str, str, str]:
    """A finding's baseline identity: rule + path + message, with NO
    line numbers — not the finding's own, and not the ``file.py:NN``
    references inside interprocedural witness chains (normalized to
    ``file.py``). Unrelated edits shift lines, and a baseline that
    churns on every refactor protects nothing. A finding whose
    normalized message changes (different chain shape, different
    lock) is a new finding."""
    return (f.rule, f.path, _LINE_REF_RE.sub(r"\1", f.message))


def load_baseline(path: str) -> list[tuple[str, str, str]]:
    """The accepted-findings multiset from ``path`` ([] when the file
    does not exist — an absent baseline accepts nothing). Messages are
    normalized exactly like :func:`baseline_key` so hand-edited or
    older baseline files keep matching."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return [
        (e["rule"], e["path"], _LINE_REF_RE.sub(r"\1", e["message"]))
        for e in doc.get("findings", [])
    ]


def write_baseline(path: str, findings: list[Finding]) -> None:
    doc = {
        "comment": (
            "graftlint accepted-findings baseline: the gate fails only "
            "on findings NOT in this list. Regenerate with "
            "`python -m odh_kubeflow_tpu_torch.analysis --write-baseline` "
            "after deliberately accepting a finding; shrink it "
            "whenever one is fixed."
        ),
        "findings": [
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def apply_baseline(
    findings: list[Finding], baseline: list[tuple[str, str, str]]
) -> tuple[list[Finding], int]:
    """Subtract the baseline multiset from ``findings``: each baseline
    entry absorbs at most one finding with the same identity (two NEW
    instances of a baselined shape still surface one). Returns
    (unbaselined findings, how many were absorbed)."""
    budget: dict[tuple[str, str, str], int] = {}
    for key in baseline:
        budget[key] = budget.get(key, 0) + 1
    out: list[Finding] = []
    absorbed = 0
    for f in findings:
        key = baseline_key(f)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            absorbed += 1
            continue
        out.append(f)
    return out, absorbed


# ---------------------------------------------------------------------------
# CLI


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {PACKAGE}.analysis",
        description="AST-based platform invariant checker (graftlint)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=f"files or directories to lint (default: the {PACKAGE} package)",
    )
    parser.add_argument(
        "--select",
        help="comma-separated rule allowlist (default: all rules)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="findings output format (json: machine-readable array)",
    )
    parser.add_argument(
        "--baseline",
        help=(
            "accepted-findings file to subtract (default: the committed "
            "analysis/baseline.json on whole-package runs)"
        ),
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring any baseline",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="write the current findings to the baseline file and exit 0",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in active_rules():
            scope = (
                ", ".join(rule.files)
                if rule.files
                else (", ".join(rule.dirs) + "/" if rule.dirs else "package-wide")
            )
            print(f"{rule.id:<22} [{scope}] {rule.description}")
        return 0

    select = (
        [r.strip() for r in args.select.split(",") if r.strip()]
        if args.select
        else None
    )
    if args.paths:
        findings = run_paths(args.paths, select)
    else:
        findings = run_package(select=select)

    baseline_path = args.baseline or (
        default_baseline_path() if not args.paths else None
    )
    if args.write_baseline:
        if (args.paths or args.select) and not args.baseline:
            # a scoped run sees a PARTIAL finding set; writing it to
            # the committed package baseline would silently delete
            # every other accepted entry
            print(
                "graftlint: refusing --write-baseline on a path/--select"
                "-scoped run without an explicit --baseline path (it "
                "would clobber the committed package baseline)",
                file=sys.stderr,
            )
            return 2
        path = args.baseline or default_baseline_path()
        write_baseline(path, findings)
        print(
            f"graftlint: wrote {len(findings)} finding(s) to {path}",
            file=sys.stderr,
        )
        return 0
    absorbed = 0
    if baseline_path is not None and not args.no_baseline:
        findings, absorbed = apply_baseline(
            findings, load_baseline(baseline_path)
        )

    if args.format == "json":
        print(
            json.dumps(
                [
                    {
                        "rule": f.rule,
                        "path": f.path,
                        "line": f.line,
                        "end_line": f.end_line or f.line,
                        "severity": f.severity,
                        "message": f.message,
                    }
                    for f in findings
                ],
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f.render())
    n_rules = len(active_rules(select))
    suffix = f" ({absorbed} baselined)" if absorbed else ""
    if findings:
        print(
            f"graftlint: {len(findings)} new finding(s) across "
            f"{n_rules} rule(s){suffix}",
            file=sys.stderr,
        )
        return 1
    print(f"graftlint: clean ({n_rules} rules){suffix}", file=sys.stderr)
    return 0
