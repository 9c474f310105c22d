"""Package-wide call graph + lock-context dataflow for graftlint.

The per-function rules in ``analysis/rules.py`` see one AST at a time;
the concurrency bugs that survived PRs 7–10 never lived in one
function. A ``with lock:`` body that calls a helper that calls a
helper that fsyncs stalls every contender just as surely as an inline
``time.sleep`` — but only a whole-program view can see the chain. This
module builds that view, conservatively:

- **Function table**: every module-level function and class method in
  the analyzed file set, keyed ``"<rel>::<Class.>name"``.
- **Call resolution** (deliberately precise-over-complete — an
  interprocedural lint that guesses wrong gets suppressed wholesale):
  plain names resolve through the module's own functions and its
  ``from pkg.mod import name`` imports; ``self.m()``/``cls.m()``
  resolve within the enclosing class (and package-resolvable bases);
  ``mod.f()`` resolves through module import aliases; any other
  ``obj.m()`` resolves by method name only when the whole program
  defines at most :data:`AMBIG_LIMIT` methods called ``m`` (unique-ish
  class-hierarchy analysis). Everything else is left unresolved.
- **Lock identity**: ``with <lockish>:`` regions are named via the
  sanitizer factory calls (``self._lock = new_rlock("apiserver.store")``
  maps ``self._lock`` in that class to ``"apiserver.store"``), falling
  back to ``Class.attr`` — lockdep semantics, every instance of a lock
  role shares a rank, matching ``analysis/sanitizer.py``.
- **Summaries**: per function, the blocking leaf calls and lock
  acquisitions reachable through resolved calls, each with the full
  witness call chain — the rules render those chains into findings.

Blocking leaves are the platform's known thread-stallers: ``time.sleep``,
``os.fsync``, socket/HTTP IO (``urlopen``/``getresponse``/``recv``/
``sendall``/``connect``/``accept``), and method ``get(timeout=…)``
(queue/Watch drains). ``Condition.wait`` is exempt (it releases the
lock while blocked), and ``asyncio.sleep``/awaited calls are never
blocking (they yield the loop, which is the point).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator, Optional

from odh_kubeflow_tpu_torch.analysis.graftlint import SourceFile

PACKAGE = "odh_kubeflow_tpu_torch"

# an attribute call `obj.m()` with an untypable receiver resolves by
# method name alone when at most this many classes define `m`; beyond
# it the call is left unresolved (precision over completeness)
AMBIG_LIMIT = 3

# markers identifying a with-context expression as a lock (shared
# vocabulary with rules.BlockingUnderLockRule / the sanitizer names)
LOCKISH_MARKERS = ("lock", "mutex", "_cv", "cond")

_WAIT_EXEMPT = frozenset({"wait", "wait_for"})

# method names that collide with builtin container/str/file/queue/
# thread protocol methods NEVER resolve by name alone: `reports.append`
# is a list append, not WriteAheadLog.append, no matter how few classes
# define the name. (self.m() and mod.f() resolution is unaffected.)
_BUILTIN_METHODS = frozenset(
    name
    for t in (list, dict, set, frozenset, tuple, str, bytes, bytearray)
    for name in dir(t)
    if not name.startswith("__")
) | frozenset(
    {
        "put", "put_nowait", "get_nowait", "qsize", "empty", "task_done",
        "start", "join", "acquire", "release", "wait", "notify",
        "notify_all", "set", "clear", "is_set", "locked", "close",
        "flush", "fileno", "readline", "seek", "tell", "cancel", "result",
    }
)
_SOCKET_TERMINALS = frozenset(
    {"urlopen", "getresponse", "recv", "sendall", "accept", "connect"}
)
_FACTORY_TERMINALS = frozenset({"new_lock", "new_rlock"})


def _attr_chain(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def blocking_leaf(call: ast.Call, awaited: bool = False) -> Optional[str]:
    """What this call blocks on, or None. ``awaited`` calls yield the
    event loop instead of a thread and are never blocking."""
    if awaited:
        return None
    chain = _attr_chain(call.func)
    if not chain:
        return None
    terminal = chain[-1]
    head = [c.lower() for c in chain[:-1]]
    if terminal == "sleep":
        if "asyncio" in head:
            return None
        return "time.sleep"
    if terminal == "fsync":
        return "os.fsync"
    if terminal in _SOCKET_TERMINALS and terminal != "connect":
        return f"socket/HTTP {terminal}"
    if terminal == "connect" and any("socket" in h or "conn" in h for h in head):
        return "socket connect"
    if terminal == "request" and any("http" in h for h in head):
        return "http client request"
    if (
        terminal == "get"
        and len(chain) > 1
        and any(
            kw.arg == "timeout"
            and not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
            for kw in call.keywords
        )
    ):
        return "blocking get(timeout=…)"
    return None


def is_lockish(expr: ast.AST) -> bool:
    chain = _attr_chain(expr)
    if not chain:
        return False
    terminal = chain[-1].lower()
    return any(m in terminal for m in LOCKISH_MARKERS)


@dataclasses.dataclass
class CallSite:
    node: ast.Call
    targets: tuple[str, ...]  # resolved candidate quals (may be empty)
    label: str  # human-readable callee for chain rendering


@dataclasses.dataclass
class LockSite:
    lock: str
    node: ast.AST  # the with statement


@dataclasses.dataclass
class Region:
    """One ``with <lock>:`` critical section inside a function.
    Direct blocking leaves inside it are the per-file
    ``blocking-under-lock`` rule's job; a region only carries what the
    interprocedural rules consume — calls and nested acquisitions."""

    lock: str
    node: ast.With
    calls: list[CallSite]
    nested: list[LockSite]  # lock acquisitions lexically inside


@dataclasses.dataclass
class FuncInfo:
    qual: str
    src: SourceFile
    node: ast.AST
    cls: Optional[str]
    is_async: bool
    calls: list[CallSite] = dataclasses.field(default_factory=list)
    blocking: list[tuple[str, ast.AST]] = dataclasses.field(default_factory=list)
    acquires: list[LockSite] = dataclasses.field(default_factory=list)
    regions: list[Region] = dataclasses.field(default_factory=list)

    @property
    def short(self) -> str:
        return self.qual.split("::", 1)[1]


@dataclasses.dataclass
class Step:
    """One hop of a witness chain: a function plus the site inside it
    where the next hop (or the leaf op) happens."""

    func: str  # short name of the function this step is IN
    path: str
    line: int
    what: str  # callee label or leaf description


Chain = tuple  # tuple[Step, ...]


def _mod_rel(module: str) -> Optional[str]:
    """``odh_kubeflow_tpu_torch.machinery.store`` → ``machinery/store.py``."""
    if module == PACKAGE:
        return "__init__.py"
    prefix = PACKAGE + "."
    if not module.startswith(prefix):
        return None
    return module[len(prefix):].replace(".", "/") + ".py"


class Program:
    """The analyzed file set plus its call graph and lock dataflow."""

    def __init__(self, sources: Iterable[SourceFile]):
        self.sources: dict[str, SourceFile] = {s.rel: s for s in sources}
        self.functions: dict[str, FuncInfo] = {}
        # method name → quals of every class method with that name
        self._methods: dict[str, list[str]] = {}
        # (rel, name) → qual for module-level functions
        self._module_funcs: dict[tuple[str, str], str] = {}
        # rel → {local alias → module rel} for module imports
        self._mod_aliases: dict[str, dict[str, str]] = {}
        # rel → names bound by NON-package imports (os, time, urllib…):
        # attribute calls rooted at these must never fall through to
        # method-name CHA (os.fsync is not some class's fsync method)
        self._foreign_roots: dict[str, set[str]] = {}
        # rel → {local name → (module rel, original name)} for
        # from-imports of functions
        self._from_imports: dict[str, dict[str, tuple[str, str]]] = {}
        # rel → {class → tuple of base class names}
        self._bases: dict[str, dict[str, tuple[str, ...]]] = {}
        # (class, attr) → sanitizer factory lock name; attr → names
        self._lock_names: dict[tuple[str, str], str] = {}
        self._lock_attr_names: dict[str, set[str]] = {}
        self._reach_blocking: dict[str, dict[str, Chain]] = {}
        self._reach_acquires: dict[str, dict[str, Chain]] = {}
        for src in self.sources.values():
            self._index_file(src)
        for src in self.sources.values():
            self._analyze_file(src)

    # -- indexing ------------------------------------------------------------

    def _index_file(self, src: SourceFile) -> None:
        aliases: dict[str, str] = {}
        froms: dict[str, tuple[str, str]] = {}
        foreign: set[str] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    rel = _mod_rel(a.name)
                    if rel is not None:
                        aliases[a.asname or a.name.rsplit(".", 1)[-1]] = rel
                    else:
                        foreign.add(a.asname or a.name.split(".", 1)[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                mod_rel = _mod_rel(node.module)
                for a in node.names:
                    # `from pkg.machinery import backoff` imports a
                    # MODULE; `from pkg.machinery.store import
                    # paged_list_all` imports a function — try both
                    sub_rel = _mod_rel(f"{node.module}.{a.name}")
                    if sub_rel is not None and sub_rel in self.sources:
                        aliases[a.asname or a.name] = sub_rel
                    elif mod_rel is not None:
                        froms[a.asname or a.name] = (mod_rel, a.name)
                    else:
                        foreign.add(a.asname or a.name)
        self._mod_aliases[src.rel] = aliases
        self._from_imports[src.rel] = froms
        self._foreign_roots[src.rel] = foreign

        bases: dict[str, tuple[str, ...]] = {}
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{src.rel}::{node.name}"
                self._add_func(qual, src, node, None)
                self._module_funcs[(src.rel, node.name)] = qual
            elif isinstance(node, ast.ClassDef):
                bases[node.name] = tuple(
                    b.id for b in node.bases if isinstance(b, ast.Name)
                )
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        qual = f"{src.rel}::{node.name}.{item.name}"
                        self._add_func(qual, src, item, node.name)
                        self._methods.setdefault(item.name, []).append(qual)
                self._index_lock_factories(src, node)
        self._bases[src.rel] = bases

    def _add_func(self, qual: str, src: SourceFile, node, cls) -> None:
        self.functions[qual] = FuncInfo(
            qual=qual,
            src=src,
            node=node,
            cls=cls,
            is_async=isinstance(node, ast.AsyncFunctionDef),
        )

    def _index_lock_factories(self, src: SourceFile, cls: ast.ClassDef) -> None:
        """``self.X = new_lock("name")`` / ``new_rlock`` assignments
        anywhere in the class map (class, X) → the sanitizer name —
        the same rank the runtime order graph uses."""
        for node in ast.walk(cls):
            if not (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
            ):
                continue
            chain = _attr_chain(node.value.func)
            if not chain or chain[-1] not in _FACTORY_TERMINALS:
                continue
            if not (
                node.value.args
                and isinstance(node.value.args[0], ast.Constant)
                and isinstance(node.value.args[0].value, str)
            ):
                continue
            name = node.value.args[0].value
            for target in node.targets:
                tchain = _attr_chain(target)
                if len(tchain) == 2 and tchain[0] == "self":
                    self._lock_names[(cls.name, tchain[1])] = name
                    self._lock_attr_names.setdefault(tchain[1], set()).add(name)

    # -- lock identity -------------------------------------------------------

    def lock_id(self, expr: ast.AST, cls: Optional[str]) -> Optional[str]:
        """The rank name for a with-context lock expression, or None
        when the expression is not lockish."""
        if isinstance(expr, ast.Call):
            # `with self._lock_for(k):` etc. — name by the call's
            # terminal when lockish
            chain = _attr_chain(expr.func)
            if chain and any(m in chain[-1].lower() for m in LOCKISH_MARKERS):
                return chain[-1]
            return None
        if not is_lockish(expr):
            return None
        chain = _attr_chain(expr)
        terminal = chain[-1]
        if len(chain) == 2 and chain[0] in ("self", "cls") and cls:
            named = self._lock_names.get((cls, terminal))
            if named is not None:
                return named
            return f"{cls}.{terminal}"
        # longer chains (`self._wal.io_lock`) and bare names: a unique
        # factory name for the attr wins, else the bare terminal
        names = self._lock_attr_names.get(terminal)
        if names is not None and len(names) == 1:
            return next(iter(names))
        return terminal

    # -- call resolution -----------------------------------------------------

    def _method_in_class(self, rel: str, cls: str, name: str) -> Optional[str]:
        qual = f"{rel}::{cls}.{name}"
        if qual in self.functions:
            return qual
        for base in self._bases.get(rel, {}).get(cls, ()):  # same-file bases
            found = self._method_in_class(rel, base, name)
            if found is not None:
                return found
        return None

    def resolve(self, call: ast.Call, fn: FuncInfo) -> tuple[str, ...]:
        f = call.func
        rel = fn.src.rel
        if isinstance(f, ast.Name):
            local = self._module_funcs.get((rel, f.id))
            if local is not None:
                return (local,)
            imported = self._from_imports.get(rel, {}).get(f.id)
            if imported is not None:
                target = self._module_funcs.get(imported)
                if target is not None:
                    return (target,)
            return ()
        if not isinstance(f, ast.Attribute):
            return ()
        chain = _attr_chain(f)
        if not chain:
            return ()
        terminal = chain[-1]
        if len(chain) == 2 and chain[0] in ("self", "cls") and fn.cls:
            found = self._method_in_class(rel, fn.cls, terminal)
            return (found,) if found is not None else ()
        if len(chain) == 2:
            mod = self._mod_aliases.get(rel, {}).get(chain[0])
            if mod is not None:
                target = self._module_funcs.get((mod, terminal))
                return (target,) if target is not None else ()
        if chain[0] in self._foreign_roots.get(rel, ()):
            # rooted at a non-package import (os.fsync, time.*): the
            # callee is stdlib/third-party, never a package method
            return ()
        if terminal in _BUILTIN_METHODS:
            return ()
        candidates = self._methods.get(terminal, [])
        if 1 <= len(candidates) <= AMBIG_LIMIT:
            return tuple(sorted(candidates))
        return ()

    # -- per-function analysis ----------------------------------------------

    def _analyze_file(self, src: SourceFile) -> None:
        for fn in self.functions.values():
            if fn.src is not src:
                continue
            self._analyze_func(fn)

    def _iter_live(self, node: ast.AST) -> Iterator[tuple[ast.AST, bool]]:
        """(descendant, awaited) pairs executing in this function —
        nested defs/lambdas run later and are pruned."""
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(child, ast.Await):
                for sub in ast.iter_child_nodes(child):
                    yield sub, True
                    yield from self._iter_live(sub)
                continue
            yield child, False
            yield from self._iter_live(child)

    def _call_label(self, call: ast.Call) -> str:
        chain = _attr_chain(call.func)
        return ".".join(chain) if chain else "<call>"

    def _analyze_func(self, fn: FuncInfo) -> None:
        for node, awaited in self._iter_live(fn.node):
            if isinstance(node, ast.Call):
                leaf = blocking_leaf(node, awaited)
                chain = _attr_chain(node.func)
                if chain and chain[-1] in _WAIT_EXEMPT:
                    leaf = None
                if leaf is not None:
                    fn.blocking.append((leaf, node))
                fn.calls.append(
                    CallSite(node, self.resolve(node, fn), self._call_label(node))
                )
            elif isinstance(node, ast.With):
                locks = [
                    lock
                    for item in node.items
                    if (lock := self.lock_id(item.context_expr, fn.cls))
                    is not None
                ]
                for idx, lock in enumerate(locks):
                    fn.acquires.append(LockSite(lock, node))
                    region = self._region(fn, lock, node)
                    # `with a, b:` acquires left-to-right: each earlier
                    # item holds while the later ones are taken — the
                    # same ordering edges the nested spelling records
                    for later in locks[idx + 1:]:
                        if later != lock:
                            region.nested.append(LockSite(later, node))
                    fn.regions.append(region)

    def _region(self, fn: FuncInfo, lock: str, w: ast.With) -> Region:
        calls: list[CallSite] = []
        nested: list[LockSite] = []
        for stmt in w.body:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                # a def/lambda DEFINED under the lock runs later,
                # outside it (_iter_live prunes these one level down;
                # the seed statement itself must be pruned too)
                continue
            for node, _awaited in [(stmt, False), *self._iter_live(stmt)]:
                if isinstance(node, ast.Call):
                    calls.append(
                        CallSite(
                            node, self.resolve(node, fn), self._call_label(node)
                        )
                    )
                elif isinstance(node, ast.With) and node is not w:
                    for item in node.items:
                        inner = self.lock_id(item.context_expr, fn.cls)
                        if inner is not None:
                            nested.append(LockSite(inner, node))
        return Region(lock, w, calls, nested)

    # -- transitive summaries ------------------------------------------------

    def reach_blocking(self, qual: str) -> dict[str, Chain]:
        """Blocking leaves reachable from ``qual`` through resolved
        calls (the function's own leaves included): leaf description →
        witness chain."""
        return self._reach(qual, self._reach_blocking, "blocking")

    def reach_acquires(self, qual: str) -> dict[str, Chain]:
        """Locks acquired by ``qual`` or anything it transitively
        calls: lock rank → witness chain."""
        return self._reach(qual, self._reach_acquires, "acquires")

    def _reach(self, qual: str, memo: dict, what: str) -> dict[str, Chain]:
        out, _pending = self._reach_rec(qual, memo, what, set())
        return out

    def _reach_rec(
        self, qual: str, memo: dict, what: str, stack: set[str]
    ) -> tuple[dict[str, Chain], set[str]]:
        """DFS with SCC-aware memoization: a summary computed while a
        call cycle is still open is INCOMPLETE for the cycle's inner
        members (they never see facts flowing through the back edge),
        so only the DFS root of its cycle — where every branch has
        been merged — is cached; inner members recompute as roots of
        their own later queries. Returns (summary, pending back-edge
        targets still on the stack)."""
        if qual in memo:
            return memo[qual], set()
        if qual in stack:
            return {}, {qual}
        fn = self.functions.get(qual)
        if fn is None:
            memo[qual] = {}
            return memo[qual], set()
        stack.add(qual)
        out: dict[str, Chain] = {}
        pending: set[str] = set()
        if what == "blocking":
            for desc, node in fn.blocking:
                out.setdefault(
                    desc,
                    (Step(fn.short, fn.src.rel, node.lineno, desc),),
                )
        else:
            for site in fn.acquires:
                out.setdefault(
                    site.lock,
                    (
                        Step(
                            fn.short,
                            fn.src.rel,
                            site.node.lineno,
                            f"acquires {site.lock!r}",
                        ),
                    ),
                )
        for cs in fn.calls:
            for target in cs.targets:
                if target == qual:
                    continue
                sub, sub_pending = self._reach_rec(target, memo, what, stack)
                pending |= sub_pending
                for key, chain in sub.items():
                    out.setdefault(
                        key,
                        (Step(fn.short, fn.src.rel, cs.node.lineno, cs.label),)
                        + chain,
                    )
        stack.discard(qual)
        pending.discard(qual)
        if not pending:
            memo[qual] = out
        return out, pending


def render_chain(chain: Chain) -> str:
    """``f (store.py:12) → g (wal.py:290) → os.fsync`` — the witness
    path a finding carries."""
    parts = []
    for step in chain:
        fname = step.path.rsplit("/", 1)[-1]
        parts.append(f"{step.func} ({fname}:{step.line})")
    if chain:
        parts.append(chain[-1].what)
    return " → ".join(parts)


def build_program(sources: Iterable[SourceFile]) -> Program:
    return Program(sources)
