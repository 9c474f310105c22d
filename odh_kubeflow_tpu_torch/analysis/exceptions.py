"""Interprocedural exception-flow analysis: error contracts, checked.

The platform's failure paths are governed by written contracts that
nothing enforced statically until now:

- the client's **verb × error retry policy** (429 retried for every verb by
  the client; Conflict surfaced to callers that must level-trigger or
  read-merge-write-retry; 410 Expired handled by relist/restart loops);
- the **fencing rule** — ``FencedOut``/``NotLeader`` mean *this
  replica lost authority*; they must abort the holder, never be
  swallowed by a broad handler that keeps acting as leader;
- the **410 restart contracts** (paginated walks and watch
  resumes restart from fresh state on ``Expired``).

Each was proven once by a drill and can rot silently as new callers
land. This module closes the gap with *raise-set inference* over the
whole-program call graph (``analysis/callgraph.py``):

- the ``APIError`` hierarchy is **mined from machinery/store.py** (any
  package file can extend it; fixtures fall back to the known default);
- per-function *can-raise* sets are seeded from ``raise`` sites and
  from a **verb model** of the API surface (``<…api/client/store>.
  update(…)`` can raise Conflict/FencedOut/… — the same receiver
  vocabulary the frozen-mutation and unfenced-write rules use);
- sets propagate through resolved call edges (module functions,
  ``self.``-methods, import aliases, bounded class-hierarchy analysis)
  with full witness chains;
- ``try/except`` narrows **hierarchy-aware** (``except APIError:``
  absorbs ``Conflict``; a handler whose body re-raises bare is a
  pass-through, not an absorber; module-level handler-tuple constants
  like ``_OUTAGE_ERRORS`` are resolved);
- calls routed through ``machinery.backoff.retry`` absorb their
  policy's retryable set for contract purposes (the *can-raise* view
  keeps them — retry re-raises after attempts are exhausted, so a
  ``except Conflict:`` around a retry call is NOT dead);
- declared **retry-policy anchors** (the client's verb × error table in
  ``RemoteAPIServer._request``, the store's guaranteedUpdate-style
  ``patch``) are verified structurally every run — if a refactor drops
  the ``backoff.retry`` wrap, the anchor fails, the absorbed errors
  reappear at every call site, and the contract rule reports both the
  anchor and the newly-escaping paths with witness chains.

Three whole-program rules ride on the inference (registered on import,
baseline-ratcheted like every graftlint rule):

- ``error-contract``: the declarative contract table — reconcile
  bodies, web handlers, the scheduler cycle, the SessionManager, and
  the promotion watchdog's ``step`` must handle-or-retry
  ``{Conflict, Expired, TooManyRequests}`` at the site where they can
  surface. An escaping retryable error is a finding carrying the full
  entry-point → raising-call chain. Sites that *deliberately* rely on
  an outer mechanism (level-triggered requeue, the kube 410 pagination
  contract) annotate ``# contract-ok: <reason>``.
- ``handler-masks-fencing``: an ``except`` that catches ``FencedOut``
  or ``NotLeader`` — directly, or via a broad ``APIError``/
  ``Exception`` clause that a fencing error can actually reach — and
  *continues* instead of aborting/recording the deposition.
  ``# fencing-ok: <reason>`` marks a deliberate handler.
- ``dead-except``: a handler catching a platform error that no
  reachable operation in its try body can raise — the drift left
  behind when a refactor moves the raising call out from under a
  once-correct handler. Only fires when every call in the body is
  fully analyzable (resolved, verb-modeled, or provably foreign), so
  an unresolvable call never produces a false "dead".
"""

from __future__ import annotations

import ast
import builtins
import dataclasses
from typing import Iterator, Optional

from odh_kubeflow_tpu_torch.analysis import callgraph
from odh_kubeflow_tpu_torch.analysis.callgraph import (
    Chain,
    FuncInfo,
    Program,
    Step,
    render_chain,
)
from odh_kubeflow_tpu_torch.analysis.graftlint import (
    Finding,
    ProgramRule,
    SourceFile,
    register,
)

_attr_chain = callgraph._attr_chain

# the APIError hierarchy as of machinery/store.py — the fixture-mode
# fallback; real package runs re-mine it from source so a new error
# class is picked up the moment it lands
DEFAULT_HIERARCHY: dict[str, Optional[str]] = {
    "APIError": None,
    "NotFound": "APIError",
    "AlreadyExists": "APIError",
    "Conflict": "APIError",
    "Invalid": "APIError",
    "BadRequest": "APIError",
    "Denied": "APIError",
    "Unauthorized": "APIError",
    "TooManyRequests": "APIError",
    "DeadlineExceeded": "APIError",
    "Expired": "APIError",
    "FencedOut": "APIError",
    "NotLeader": "APIError",
}

# the retryable set every contract entry point must handle-or-retry
RETRYABLE = frozenset({"Conflict", "Expired", "TooManyRequests"})
# authority failures: abort, never swallow
FENCING = frozenset({"FencedOut", "NotLeader"})

# the error surface of each API verb as seen through the platform
# client stack — the error axis of the client's verb × error table.
# Deliberately generous: over-approximating can-raise keeps dead-except
# conservative, and the contract rule only acts on RETRYABLE ∩ set.
# EVERY verb includes NotFound: the store raises it for an
# unregistered kind (the "subsystem not installed" contract callers
# probe with `except NotFound`).
_VERB_COMMON = frozenset(
    # DeadlineExceeded: every verb sheds with 504 once the caller's
    # end-to-end deadline expires (machinery/overload.py) — and it is
    # deliberately NOT in RETRYABLE: the caller already gave up
    {"NotFound", "Denied", "Unauthorized", "TooManyRequests",
     "DeadlineExceeded"}
)
_MUTATION_COMMON = _VERB_COMMON | frozenset(
    {"Invalid", "BadRequest", "FencedOut", "NotLeader"}
)
VERB_RAISES: dict[str, frozenset[str]] = {
    "get": _VERB_COMMON,
    "list": _VERB_COMMON,
    # rv-pinned / continue-token walks can outlive the compacted window
    "list_chunk": _VERB_COMMON | {"Expired", "BadRequest"},
    "watch": _VERB_COMMON | {"Expired"},
    # paged_list_all restarts Expired walks internally — model
    # the helper itself, not its internals
    "paged_list_all": _VERB_COMMON,
    "create": _MUTATION_COMMON | {"AlreadyExists"},
    "create_or_get": _MUTATION_COMMON,
    "update": _MUTATION_COMMON | {"Conflict"},
    "update_status": _MUTATION_COMMON | {"Conflict"},
    "patch": _MUTATION_COMMON | {"Conflict"},
    "delete": _MUTATION_COMMON,
    "emit_event": _MUTATION_COMMON,
}

# receiver vocabulary marking a call as an API-surface verb (shared
# spirit with frozen-mutation's _CLIENTISH / unfenced-write's
# _WRITERISH, plus the read-replica handles)
_CLIENTISH = frozenset(
    {
        "api",
        "client",
        "store",
        "server",
        "backend",
        "cache",
        "informer",
        "replica",
        "leader",
    }
)

# beyond callgraph.AMBIG_LIMIT: raise-set propagation takes the UNION
# over same-named method candidates, which stays sound as a may-raise
# set — so it can afford a wider net than the concurrency rules
EXC_AMBIG_LIMIT = 8

# call terminals that provably cannot raise platform errors (logging,
# metrics, time/format plumbing) — everything else unresolved poisons
# dead-except completeness
_SAFE_TERMINALS = frozenset(
    {
        "debug", "info", "warning", "error", "exception", "critical", "log",
        "getLogger", "inc", "dec", "observe", "labels", "set_gauge",
        "monotonic", "perf_counter", "sleep", "time", "isoformat",
        "strftime", "utcnow", "now", "timestamp", "total_seconds",
        "format", "format_map", "encode", "decode", "hexdigest",
    }
)


@dataclasses.dataclass(frozen=True)
class RetryPolicyAnchor:
    """A function declared to own part of the retry policy: it must
    wrap its API call in ``machinery.backoff.retry`` (verified
    structurally each run). While verified, the errors it absorbs are
    subtracted from the contract view of every matching verb call —
    delete the wrap and they reappear everywhere, with chains."""

    file: str
    func: str  # short name ("Class.method")
    absorbs: frozenset[str]
    verbs: Optional[frozenset[str]]  # None = every verb call
    description: str

    @property
    def qual(self) -> str:
        return f"{self.file}::{self.func}"


POLICY_ANCHORS: tuple[RetryPolicyAnchor, ...] = (
    RetryPolicyAnchor(
        file="machinery/client.py",
        func="RemoteAPIServer._request",
        absorbs=frozenset({"TooManyRequests"}),
        verbs=None,
        description=(
            "client retry policy: a 429 was never executed "
            "server-side, so the client retries it for every verb "
            "after the Retry-After wait"
        ),
    ),
    RetryPolicyAnchor(
        file="machinery/store.py",
        func="APIServer.patch",
        absorbs=frozenset({"Conflict"}),
        verbs=frozenset({"patch"}),
        description=(
            "kube guaranteedUpdate shape: patch is a read-merge-write "
            "that retries Conflict server-side"
        ),
    ),
)


@dataclasses.dataclass(frozen=True)
class Site:
    """One witness: the chain from the owning function inward to the
    raise/model leaf, plus the AST node of the head site (the call or
    raise statement in the owning function — where suppression markers
    and finding spans anchor)."""

    chain: Chain
    node: ast.AST


# (error name, witness, escapes in can-raise view, escapes in contract view)
_SiteRow = tuple[str, Site, bool, bool]


@dataclasses.dataclass
class _FnResult:
    sites: list[_SiteRow]
    complete: bool  # no unanalyzable call reachable (incl. callees)


_EMPTY = _FnResult([], True)


@dataclasses.dataclass(frozen=True)
class ContractEntry:
    kind: str
    qual: str
    fn: FuncInfo


class _Handler:
    """One except clause, normalized: caught type names (module-level
    tuple constants resolved) and whether the body re-raises bare."""

    __slots__ = ("names", "passthrough", "node")

    def __init__(self, names: tuple[str, ...], passthrough: bool, node):
        self.names = names
        self.passthrough = passthrough
        self.node = node


def mine_hierarchy(program: Program) -> dict[str, Optional[str]]:
    """The APIError class tree: seeded from ``machinery/store.py`` when
    it is in the analyzed set (package runs), from the known default
    otherwise (fixtures), then extended to fixpoint with any class in
    the file set deriving from a known error."""
    if "machinery/store.py" in program.sources:
        hierarchy: dict[str, Optional[str]] = {"APIError": None}
    else:
        hierarchy = dict(DEFAULT_HIERARCHY)
    changed = True
    while changed:
        changed = False
        for src in program.sources.values():
            for node in src.tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                if node.name in hierarchy:
                    continue
                for base in node.bases:
                    chain = _attr_chain(base)
                    if chain and chain[-1] in hierarchy:
                        hierarchy[node.name] = chain[-1]
                        changed = True
                        break
    return hierarchy


class ExceptionAnalysis:
    """Raise-set inference over a :class:`callgraph.Program`. One
    instance per program (cached on the program object — every rule in
    a lint invocation shares the memoized summaries)."""

    @classmethod
    def of(cls, program: Program) -> "ExceptionAnalysis":
        inst = getattr(program, "_exception_analysis", None)
        if inst is None:
            inst = cls(program)
            program._exception_analysis = inst
        return inst

    def __init__(self, program: Program):
        self.program = program
        self.hierarchy = mine_hierarchy(program)
        self._memo: dict[str, _FnResult] = {}
        self._funcs: dict[str, FuncInfo] = dict(program.functions)
        # class name → quals of __init__ methods (constructor calls
        # resolve so `Result()` never poisons dead-except completeness)
        self._class_inits: dict[str, list[str]] = {}
        self._known_classes: set[str] = set()
        # rel → {name → tuple of caught-type terminals} for module-level
        # `_ERRS = (APIError, OSError)`-style handler constants
        self._handler_tuples: dict[str, dict[str, tuple[str, ...]]] = {}
        for src in program.sources.values():
            self._index_source(src)
        self.route_handlers: list[FuncInfo] = []
        self._index_route_handlers()
        # anchor → "verified" | "missing" | "absent"
        self.anchor_status: dict[RetryPolicyAnchor, str] = {}
        self._verify_anchors()

    # -- indexing ------------------------------------------------------------

    def _index_source(self, src: SourceFile) -> None:
        consts: dict[str, tuple[str, ...]] = {}
        for node in src.tree.body:
            if isinstance(node, ast.ClassDef):
                self._known_classes.add(node.name)
                init = f"{src.rel}::{node.name}.__init__"
                if init in self._funcs:
                    self._class_inits.setdefault(node.name, []).append(init)
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Tuple
            ):
                names = tuple(
                    chain[-1]
                    for e in node.value.elts
                    if (chain := _attr_chain(e))
                )
                if names and len(names) == len(node.value.elts):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            consts[target.id] = names
        self._handler_tuples[src.rel] = consts

    def _index_route_handlers(self) -> None:
        """Web handlers are nested defs under ``@app.route(...)`` inside
        app factories — not in the module-level function table. Index
        them as entry points, with ``cls`` set to the enclosing class so
        ``self.helper()`` calls resolve."""
        for src in self.program.sources.values():
            if src.section != "web":
                continue
            self._walk_for_routes(src, src.tree, cls=None, prefix="")

    def _walk_for_routes(
        self, src: SourceFile, node: ast.AST, cls: Optional[str], prefix: str
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._walk_for_routes(src, child, child.name, prefix)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                routed = any(
                    isinstance(dec, ast.Call)
                    and (chain := _attr_chain(dec.func))
                    and chain[-1] == "route"
                    for dec in child.decorator_list
                )
                if routed:
                    qual = f"{src.rel}::{prefix}{child.name}@{child.lineno}"
                    fn = FuncInfo(
                        qual=qual,
                        src=src,
                        node=child,
                        cls=cls,
                        is_async=isinstance(child, ast.AsyncFunctionDef),
                    )
                    self._funcs[qual] = fn
                    self.route_handlers.append(fn)
                self._walk_for_routes(
                    src, child, cls, prefix=f"{prefix}{child.name}."
                )

    # -- hierarchy -----------------------------------------------------------

    def _ancestors(self, err: str) -> set[str]:
        out = {err}
        cur: Optional[str] = err
        while cur is not None:
            cur = self.hierarchy.get(cur)
            if cur is not None:
                out.add(cur)
        return out

    def catches(self, caught_names, err: str) -> bool:
        """Hierarchy-aware: does a clause catching ``caught_names``
        catch platform error ``err``?"""
        anc = self._ancestors(err)
        return any(
            n in ("Exception", "BaseException") or n in anc
            for n in caught_names
        )

    def handler_spec(self, src: SourceFile, handler: ast.ExceptHandler) -> _Handler:
        t = handler.type
        if t is None:
            names: tuple[str, ...] = ("BaseException",)
        elif isinstance(t, ast.Tuple):
            parts: list[str] = []
            for e in t.elts:
                chain = _attr_chain(e)
                if chain:
                    parts.append(chain[-1])
            names = tuple(parts)
        else:
            chain = _attr_chain(t)
            names = (chain[-1],) if chain else ()
            # `except _OUTAGE_ERRORS:` — a module-level tuple constant
            if names and isinstance(t, ast.Name):
                expanded = self._handler_tuples.get(src.rel, {}).get(t.id)
                if expanded is not None:
                    names = expanded
        # a handler re-raises via bare `raise` OR `raise e` of its own
        # bound name — both are pass-throughs, not absorbers
        passthrough = any(
            isinstance(n, ast.Raise)
            and (
                n.exc is None
                or (
                    isinstance(n.exc, ast.Name)
                    and handler.name is not None
                    and n.exc.id == handler.name
                )
            )
            for n in _live_walk(handler.body)
        )
        return _Handler(names, passthrough, handler)

    # -- anchors -------------------------------------------------------------

    def _verify_anchors(self) -> None:
        for anchor in POLICY_ANCHORS:
            if anchor.file not in self.program.sources:
                # fixtures / scoped runs: the policy lives outside the
                # analyzed set — treat it as in force
                self.anchor_status[anchor] = "absent"
                continue
            fn = self.program.functions.get(anchor.qual)
            ok = fn is not None and any(
                isinstance(n, ast.Call) and self._is_retry_call(n, fn)
                for n in _live_walk(
                    fn.node.body if hasattr(fn.node, "body") else []
                )
            )
            self.anchor_status[anchor] = "verified" if ok else "missing"

    def _anchor_absorbed(self, verb: str, err: str) -> bool:
        for anchor in POLICY_ANCHORS:
            if self.anchor_status.get(anchor) == "missing":
                continue
            if anchor.verbs is not None and verb not in anchor.verbs:
                continue
            if any(self.catches((a,), err) for a in anchor.absorbs):
                return True
        return False

    # -- call classification -------------------------------------------------

    def _is_retry_call(self, call: ast.Call, fn: FuncInfo) -> bool:
        chain = _attr_chain(call.func)
        if not chain or chain[-1] != "retry":
            return False
        if len(chain) > 1:
            return any("backoff" in part.lower() for part in chain[:-1])
        # bare `retry(...)`: accept when imported from machinery.backoff
        imported = self.program._from_imports.get(fn.src.rel, {}).get("retry")
        return imported is not None and imported[0].endswith("backoff.py")

    def _retry_absorbed_names(self, call: ast.Call) -> Optional[tuple[str, ...]]:
        """The statically-visible retryable set of a ``backoff.retry``
        call: names from a Name/Attribute/Tuple argument; ``None`` for
        predicates (lambdas) — absorb nothing statically. No retryable
        argument at all means the default ``(Exception,)``."""
        expr: Optional[ast.AST] = None
        for kw in call.keywords:
            if kw.arg == "retryable":
                expr = kw.value
        if expr is None and len(call.args) > 1:
            expr = call.args[1]
        if expr is None:
            return ("Exception",)
        elts = expr.elts if isinstance(expr, ast.Tuple) else [expr]
        names: list[str] = []
        for e in elts:
            chain = _attr_chain(e)
            if not chain or (
                chain[-1] not in self.hierarchy
                and chain[-1] not in ("Exception", "BaseException")
            ):
                return None
            names.append(chain[-1])
        return tuple(names)

    def _api_verb(self, call: ast.Call) -> Optional[str]:
        chain = _attr_chain(call.func)
        if len(chain) < 2 or chain[-1] not in VERB_RAISES:
            return None
        for part in chain[:-1]:
            p = part.lower().strip("_")
            if p in _CLIENTISH or p.endswith(
                ("api", "client", "store", "replica")
            ):
                return chain[-1]
        # `paged_list_all(api, ...)` is a module function taking the
        # client as an argument
        return None

    def _resolve(self, call: ast.Call, fn: FuncInfo) -> tuple[str, ...]:
        targets = self.program.resolve(call, fn)
        if targets:
            return targets
        f = call.func
        rel = fn.src.rel
        if isinstance(f, ast.Name):
            inits = self._class_inits.get(f.id)
            if inits:
                return tuple(sorted(inits))
            imported = self.program._from_imports.get(rel, {}).get(f.id)
            if imported is not None:
                init = f"{imported[0]}::{imported[1]}.__init__"
                if init in self._funcs:
                    return (init,)
            return ()
        chain = _attr_chain(f)
        if not chain or len(chain) < 2:
            return ()
        if chain[0] in self.program._foreign_roots.get(rel, ()):
            return ()
        terminal = chain[-1]
        if terminal in callgraph._BUILTIN_METHODS:
            return ()
        candidates = self.program._methods.get(terminal, [])
        if 1 <= len(candidates) <= EXC_AMBIG_LIMIT:
            return tuple(sorted(candidates))
        return ()

    def _call_is_harmless(self, call: ast.Call, fn: FuncInfo) -> bool:
        """Whether an otherwise-unresolved call provably cannot raise a
        platform error (foreign module, python builtin, container
        method, logging/metrics plumbing, known no-__init__ class)."""
        f = call.func
        rel = fn.src.rel
        if isinstance(f, ast.Name):
            if hasattr(builtins, f.id):
                return True
            if f.id in self._known_classes:
                return True  # no __init__ in the table → nothing to raise
            imported = self.program._from_imports.get(rel, {}).get(f.id)
            if imported is not None and imported[1] in self._known_classes:
                return True
            return False
        chain = _attr_chain(f)
        if not chain:
            return False
        if chain[0] in self.program._foreign_roots.get(rel, ()):
            return True
        terminal = chain[-1]
        if terminal in VERB_RAISES:
            # an API-verb name on a receiver we could not classify:
            # `c.get(...)` may be a dict get OR a store read that
            # raises NotFound — never "harmless" for dead-except
            return False
        return (
            terminal in callgraph._BUILTIN_METHODS
            or terminal in _SAFE_TERMINALS
        )

    # -- per-function inference ----------------------------------------------

    def result_for(self, qual: str) -> _FnResult:
        res, _pending = self._result_rec(qual, set())
        return res

    def _result_rec(
        self, qual: str, stack: set[str]
    ) -> tuple[_FnResult, set[str]]:
        """SCC-aware memoized DFS, same discipline as
        ``callgraph._reach_rec``: summaries computed while a call cycle
        is open are only cached at the cycle's DFS root."""
        if qual in self._memo:
            return self._memo[qual], set()
        if qual in stack:
            return _EMPTY, {qual}
        fn = self._funcs.get(qual)
        if fn is None:
            self._memo[qual] = _EMPTY
            return _EMPTY, set()
        stack.add(qual)
        body = fn.node.body if hasattr(fn.node, "body") else []
        sites, complete, pending = self._collect(fn, body, (), stack)
        stack.discard(qual)
        pending.discard(qual)
        res = _FnResult(sites, complete)
        if not pending:
            self._memo[qual] = res
        return res, pending

    def _collect(
        self,
        fn: FuncInfo,
        stmts: list,
        guards: tuple,
        stack: set[str],
    ) -> tuple[list[_SiteRow], bool, set[str]]:
        """Walk ``stmts`` as executed inside ``fn`` under the given
        enclosing-handler ``guards``; return the escaping site rows,
        body completeness, and pending (open-cycle) callees."""
        sites: list[_SiteRow] = []
        state = {"complete": True}
        pending: set[str] = set()

        def escapes(err: str, g: tuple) -> bool:
            for handlers in reversed(g):
                for h in handlers:
                    if self.catches(h.names, err):
                        if h.passthrough:
                            break  # re-raised: keeps propagating out
                        return False
                    # only the FIRST matching clause runs
            return True

        def add(err: str, site: Site, in_can: bool, in_esc: bool, g: tuple):
            if not escapes(err, g):
                return
            # `# contract-ok: <reason>` on the site certifies the escape
            # as deliberately handled by an outer mechanism — cleared
            # from the contract view HERE so the certification holds
            # through every caller chain, not just the entry function
            if in_esc and _marked(fn.src, site.node, "contract-ok"):
                in_esc = False
            sites.append((err, site, in_can, in_esc))

        def visit_call(call: ast.Call, g: tuple) -> None:
            label = ".".join(_attr_chain(call.func)) or "<call>"
            if self._is_retry_call(call, fn):
                absorbed = self._retry_absorbed_names(call)
                rows, wrapped_complete = self._wrapped_rows(
                    call, fn, stack, pending
                )
                state["complete"] &= wrapped_complete
                for err, site, inner_esc in rows:
                    contract_ok = absorbed is not None and any(
                        self.catches((a,), err) for a in absorbed
                    )
                    add(err, site, True, inner_esc and not contract_ok, g)
                return
            verb = self._api_verb(call)
            if verb is not None:
                for err in sorted(VERB_RAISES[verb]):
                    site = Site(
                        (
                            Step(
                                fn.short,
                                fn.src.rel,
                                call.lineno,
                                f"{label}() can raise {err}",
                            ),
                        ),
                        call,
                    )
                    add(err, site, True, not self._anchor_absorbed(verb, err), g)
                return
            targets = self._resolve(call, fn)
            if targets:
                for target in sorted(targets):
                    if target == fn.qual:
                        continue
                    sub, sub_pending = self._result_rec(target, stack)
                    pending.update(sub_pending)
                    state["complete"] &= sub.complete
                    head = Step(fn.short, fn.src.rel, call.lineno, label)
                    seen: set[tuple[str, bool]] = set()
                    for err, site, in_can, in_esc in sub.sites:
                        key = (err, in_esc)
                        if key in seen:
                            continue
                        seen.add(key)
                        add(
                            err,
                            Site((head,) + site.chain, call),
                            in_can,
                            in_esc,
                            g,
                        )
                return
            if not self._call_is_harmless(call, fn):
                state["complete"] = False

        def visit(node: ast.AST, g: tuple, bound: frozenset) -> None:
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return  # runs later, outside these guards
            if isinstance(node, ast.Try):
                handlers = tuple(
                    self.handler_spec(fn.src, h) for h in node.handlers
                )
                for s in node.body:
                    visit(s, g + (handlers,), bound)
                for h in node.handlers:
                    # the handler's bound name re-raised inside its body
                    # is the pass-through handler_spec already models —
                    # not an unknown variable raise
                    inner = bound | {h.name} if h.name else bound
                    for s in h.body:
                        visit(s, g, inner)
                for s in node.orelse:  # not guarded by this try's handlers
                    visit(s, g, bound)
                for s in node.finalbody:
                    visit(s, g, bound)
                return
            if isinstance(node, ast.Raise) and node.exc is not None:
                target = (
                    node.exc.func if isinstance(node.exc, ast.Call) else node.exc
                )
                chain = _attr_chain(target)
                if chain and chain[-1] in self.hierarchy:
                    err = chain[-1]
                    site = Site(
                        (
                            Step(
                                fn.short,
                                fn.src.rel,
                                node.lineno,
                                f"raise {err}",
                            ),
                        ),
                        node,
                    )
                    add(err, site, True, True, g)
                elif (
                    isinstance(node.exc, ast.Name) and node.exc.id in bound
                ):
                    pass  # `raise e` of a handler's bound name: passthrough
                elif isinstance(node.exc, ast.Call) and (
                    chain and chain[-1][:1].isupper()
                ):
                    pass  # a non-platform exception class constructor
                else:
                    # `raise err` through a variable (or a factory call):
                    # it COULD hold any platform error the inference
                    # cannot see — poison completeness so dead-except
                    # never calls a live handler dead over it
                    state["complete"] = False
            if isinstance(node, ast.Call):
                visit_call(node, g)
                if self._is_retry_call(node, fn):
                    return  # the wrapped thunk was analyzed specially
            for child in ast.iter_child_nodes(node):
                visit(child, g, bound)

        for stmt in stmts:
            visit(stmt, guards, frozenset())
        return sites, state["complete"], pending

    def _wrapped_rows(
        self, call: ast.Call, fn: FuncInfo, stack: set[str], pending: set[str]
    ) -> tuple[list[tuple[str, Site]], bool]:
        """Raise rows of the thunk handed to ``backoff.retry`` — a
        lambda body analyzed inline, or a function reference resolved
        like a call — plus a completeness verdict (an unresolvable
        thunk, e.g. a nested def, yields no rows and must poison
        dead-except completeness rather than read as raise-free).
        Sites anchor on the retry call statement."""
        if not call.args:
            return [], True
        thunk = call.args[0]
        # (err, witness, inner contract-escape) — the inner view
        # survives so an anchor-absorbed error (the client's 429
        # policy) does not reappear just because a retry wraps the call
        rows: list[tuple[str, Site, bool]] = []
        if isinstance(thunk, ast.Lambda):
            sub_sites, sub_complete, sub_pending = self._collect(
                fn, [ast.Expr(value=thunk.body)], (), stack
            )
            pending.update(sub_pending)
            seen: dict[str, int] = {}
            for err, site, in_can, in_esc in sub_sites:
                if not in_can:
                    continue
                if err not in seen:
                    seen[err] = len(rows)
                    rows.append((err, Site(site.chain, call), in_esc))
                elif in_esc and not rows[seen[err]][2]:
                    rows[seen[err]] = (err, Site(site.chain, call), True)
            return rows, sub_complete
        pseudo = ast.Call(func=thunk, args=[], keywords=[])
        ast.copy_location(pseudo, call)
        ast.fix_missing_locations(pseudo)
        label = ".".join(_attr_chain(thunk)) or "<thunk>"
        targets = sorted(self._resolve(pseudo, fn))
        if not targets:
            return [], False
        complete = True
        seen = {}
        for target in targets:
            sub, sub_pending = self._result_rec(target, stack)
            pending.update(sub_pending)
            complete &= sub.complete
            head = Step(fn.short, fn.src.rel, call.lineno, f"retry({label})")
            for err, site, in_can, in_esc in sub.sites:
                if not in_can:
                    continue
                witness = Site((head,) + site.chain, call)
                if err not in seen:
                    seen[err] = len(rows)
                    rows.append((err, witness, in_esc))
                elif in_esc and not rows[seen[err]][2]:
                    rows[seen[err]] = (err, witness, True)
        return rows, complete

    # -- entry points --------------------------------------------------------

    _RECONCILE_SECTIONS = ("controllers", "scheduling", "sessions")
    _RECONCILE_NAMES = ("reconcile", "reconcile_notebook", "reconcile_all")
    _PROMOTER_FILES = ("machinery/promoter.py",)

    def contract_entries(self) -> Iterator[ContractEntry]:
        for qual, fn in sorted(self.program.functions.items()):
            name = fn.short.rsplit(".", 1)[-1]
            if (
                fn.src.section in self._RECONCILE_SECTIONS
                and name in self._RECONCILE_NAMES
                and fn.cls is not None
            ):
                yield ContractEntry("reconcile", qual, fn)
            elif (
                fn.src.rel in self._PROMOTER_FILES
                and name == "step"
                and fn.cls is not None
            ):
                yield ContractEntry("promoter step", qual, fn)
        for fn in self.route_handlers:
            yield ContractEntry("web handler", fn.qual, fn)

    def entry_sites(self, fn: FuncInfo) -> list[_SiteRow]:
        """Every escaping site of an entry-point body — unlike the
        memoized single-witness summaries, the contract rule reports
        each offending site so per-site ``# contract-ok`` markers work
        and fixing one site surfaces the next deterministically."""
        body = fn.node.body if hasattr(fn.node, "body") else []
        sites, _complete, _pending = self._collect(fn, body, (), set())
        return sites


# ---------------------------------------------------------------------------
# helpers


def _live_walk(stmts) -> Iterator[ast.AST]:
    """All descendants executing in the enclosing function — nested
    defs/lambdas pruned."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _marked(src: SourceFile, node: ast.AST, marker: str) -> bool:
    start = getattr(node, "lineno", 1)
    end = getattr(node, "end_lineno", None) or start
    return any(marker in src.line(n) for n in range(start, end + 1))


# ---------------------------------------------------------------------------
# error-contract


@register
class ErrorContractRule(ProgramRule):
    """The declarative contract table (reconcile bodies, web handlers,
    the scheduler cycle, SessionManager, promotion watchdog): every
    site where a retryable error — ``Conflict``, ``Expired``,
    ``TooManyRequests`` — can surface must handle it, route it through
    ``backoff.retry``, or carry ``# contract-ok: <reason>`` naming the
    outer mechanism relied on (level-triggered requeue, the kube 410
    pagination contract). Also verifies the declared retry-policy
    anchors still wrap their API call in ``backoff.retry`` — reverting
    the client policy reports the anchor AND re-surfaces every
    absorbed escape with entry-point → raise witness chains."""

    id = "error-contract"
    description = (
        "retryable error (Conflict/Expired/429) escaping a contract "
        "entry point unhandled, with witness chain"
    )

    def check_program(self, program) -> Iterator[Finding]:
        ea = ExceptionAnalysis.of(program)
        for anchor in POLICY_ANCHORS:
            if ea.anchor_status.get(anchor) != "missing":
                continue
            src = program.sources[anchor.file]
            fn = program.functions.get(anchor.qual)
            node = fn.node if fn is not None else src.tree
            yield self.finding(
                src,
                node,
                f"retry-policy anchor {anchor.func} no longer routes "
                f"through machinery.backoff.retry ({anchor.description});"
                f" restore the retry wrap or update POLICY_ANCHORS — "
                f"until then {'/'.join(sorted(anchor.absorbs))} escapes "
                "every caller",
            )
        for entry in ea.contract_entries():
            reported: set[tuple[int, str]] = set()
            for err, site, _in_can, in_esc in ea.entry_sites(entry.fn):
                if not in_esc or err not in RETRYABLE:
                    continue
                key = (site.node.lineno, err)
                if key in reported:
                    continue
                reported.add(key)
                if _marked(entry.fn.src, site.node, "contract-ok"):
                    continue
                yield self.finding(
                    entry.fn.src,
                    site.node,
                    f"{entry.kind} {entry.fn.short} lets retryable "
                    f"{err} escape: {render_chain(site.chain)}; handle "
                    "it at this site, route it through backoff.retry, "
                    "or annotate with `# contract-ok: <reason>`",
                )


# ---------------------------------------------------------------------------
# handler-masks-fencing


# a handler body counts as aborting/recording the deposition when it
# re-raises, calls a stand-down-ish method (incl. fail-stop paths like
# the committer's _commit_failed), or records the fenced state
_ABORTISH_PARTS = (
    "stop", "stand", "shutdown", "abort", "exit", "depose", "kill", "fail",
)
_FENCED_STATE_ATTRS = ("fenced", "deposed", "stopped")


@register
class HandlerMasksFencingRule(ProgramRule):
    """``FencedOut``/``NotLeader`` mean this replica's authority is
    GONE — acting on the error by logging and carrying on is how a
    deposed leader keeps writing (the TOCTOU the fencing tokens
    exist to close). Flags an ``except`` clause that catches a fencing
    error — named directly, or via a broad ``APIError``/``Exception``
    clause the inference proves a fencing error can actually reach —
    and neither re-raises, nor calls a stand-down path, nor records the
    deposition. ``# fencing-ok: <reason>`` marks deliberate handlers
    (e.g. a drill harness)."""

    id = "handler-masks-fencing"
    description = (
        "except clause swallows FencedOut/NotLeader and continues "
        "instead of standing down"
    )

    _SECTIONS = ("controllers", "machinery", "scheduling", "sessions")

    def _aborts(self, handler: ast.ExceptHandler) -> bool:
        for node in _live_walk(handler.body):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if any(
                    part_l in p.lower()
                    for p in chain
                    for part_l in _ABORTISH_PARTS
                ):
                    return True
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    tchain = _attr_chain(target)
                    if tchain and any(
                        marker in tchain[-1].lower()
                        for marker in _FENCED_STATE_ATTRS
                    ):
                        return True
        return False

    def check_program(self, program) -> Iterator[Finding]:
        ea = ExceptionAnalysis.of(program)
        for qual, fn in sorted(ea._funcs.items()):
            if fn.src.section not in self._SECTIONS:
                continue
            body = fn.node.body if hasattr(fn.node, "body") else []
            for node in _live_walk(body):
                if not isinstance(node, ast.Try):
                    continue
                yield from self._check_try(ea, fn, node)

    def _check_try(self, ea: ExceptionAnalysis, fn, node: ast.Try):
        handlers = [ea.handler_spec(fn.src, h) for h in node.handlers]
        # which fencing errors the try body can actually raise (for the
        # broad-clause half); witness for the message
        body_sites, _complete, _pending = ea._collect(fn, node.body, (), set())
        reach: dict[str, Site] = {}
        for err, site, in_can, _in_esc in body_sites:
            if in_can and err in FENCING:
                reach.setdefault(err, site)
        remaining = set(reach)
        for spec in handlers:
            h = spec.node
            direct = [n for n in spec.names if n in FENCING]
            caught_here = {e for e in remaining if ea.catches(spec.names, e)}
            if spec.passthrough or self._aborts(h):
                remaining -= caught_here
                continue
            if _marked(fn.src, h, "fencing-ok"):
                remaining -= caught_here
                continue
            if direct:
                yield self.finding(
                    fn.src,
                    h,
                    f"handler catches {'/'.join(sorted(set(direct)))} and "
                    "continues; a fenced replica must stand down — "
                    "re-raise, stop the component, or record the "
                    "deposition (`# fencing-ok: <reason>` if deliberate)",
                )
            elif caught_here:
                err = sorted(caught_here)[0]
                yield self.finding(
                    fn.src,
                    h,
                    f"broad handler absorbs {err} raised in its try "
                    f"body ({render_chain(reach[err].chain)}) and "
                    "continues; catch the fencing error first and "
                    "stand down, or annotate with "
                    "`# fencing-ok: <reason>`",
                )
            remaining -= caught_here


# ---------------------------------------------------------------------------
# dead-except


@register
class DeadExceptRule(ProgramRule):
    """Refactor drift: an ``except <PlatformError>:`` whose try body —
    proven fully analyzable, every call resolved/verb-modeled/foreign —
    cannot raise anything the clause catches. The handler is dead code
    that silently documents a failure mode that no longer exists (or
    worse, was moved out from under it). Conservative by construction:
    any call the inference cannot account for disables the check for
    that body."""

    id = "dead-except"
    description = (
        "except clause catching a platform error its try body provably "
        "cannot raise"
    )

    _SECTIONS = (
        "controllers",
        "machinery",
        "scheduling",
        "sessions",
        "web",
        "webhooks",
    )
    _NEVER_DEAD = frozenset({"Exception", "BaseException"})

    def check_program(self, program) -> Iterator[Finding]:
        ea = ExceptionAnalysis.of(program)
        for qual, fn in sorted(ea._funcs.items()):
            if fn.src.section not in self._SECTIONS:
                continue
            body = fn.node.body if hasattr(fn.node, "body") else []
            for node in _live_walk(body):
                if not isinstance(node, ast.Try):
                    continue
                yield from self._check_try(ea, fn, node)

    def _check_try(self, ea: ExceptionAnalysis, fn, node: ast.Try):
        sites, complete, _pending = ea._collect(fn, node.body, (), set())
        if not complete:
            return
        raisable = {err for err, _site, in_can, _in_esc in sites if in_can}
        absorbed: set[str] = set()
        for handler in node.handlers:
            spec = ea.handler_spec(fn.src, handler)
            if not spec.names or any(
                n not in ea.hierarchy or n in self._NEVER_DEAD
                for n in spec.names
            ):
                # broad / non-platform clauses: other rules' turf; they
                # still absorb for later clauses
                absorbed |= {e for e in raisable if ea.catches(spec.names, e)}
                continue
            live = raisable - absorbed
            if not any(ea.catches(spec.names, e) for e in live):
                yield self.finding(
                    fn.src,
                    handler,
                    f"except {'/'.join(spec.names)} is dead: no "
                    "reachable operation in the try body can raise it "
                    "(every call resolved); remove the handler or the "
                    "drift that orphaned it",
                )
            absorbed |= {e for e in raisable if ea.catches(spec.names, e)}
