"""The platform's graftlint rules.

Each rule encodes one invariant the control plane relies on but the
language cannot enforce. Rules are deliberately conservative: a rule
that cries wolf gets suppressed wholesale and protects nothing, so
every heuristic here is tuned to flag the shapes that are bugs in
THIS codebase (see each rule's docstring for the exact contract).

Add a rule by subclassing :class:`graftlint.Rule`, decorating with
``@register``, and giving it a fixture-proven true positive (the JAX
package's ``tests/test_analysis.py`` fixtures run through both packages'
rules in ``tests/test_torch_analysis.py``) — the whole-package gate keeps the tree
clean against it from then on.
"""

from __future__ import annotations

import ast
from typing import Any, Iterator, Optional

from odh_kubeflow_tpu_torch.analysis import callgraph
from odh_kubeflow_tpu_torch.analysis.graftlint import (
    Finding,
    ProgramRule,
    Rule,
    SourceFile,
    register,
)
from odh_kubeflow_tpu_torch.utils.prometheus import metric_name_violations

# kinds whose unselective cluster-wide list is always a smell on a hot
# path (they all have namespace buckets and/or platform indexers)
INDEXABLE_KINDS = frozenset(
    {
        "Pod",
        "StatefulSet",
        "Deployment",
        "Service",
        "Event",
        "Node",
        "Notebook",
        "PersistentVolumeClaim",
        "ResourceQuota",
        "Secret",
    }
)

# dict/list mutators that modify in place (FrozenDict/FrozenList raise
# on every one of these)
_MUTATORS = frozenset(
    {
        "append",
        "extend",
        "insert",
        "pop",
        "popitem",
        "clear",
        "update",
        "remove",
        "sort",
        "reverse",
        "setdefault",
    }
)


# one attribute-chain walker for the per-file and whole-program
# analyses (``self.api.get`` → ["self", "api", "get"])
_attr_chain = callgraph._attr_chain


def _root_name(node: ast.AST) -> Optional[str]:
    """The base Name of a subscript/attribute access path
    (``obj["a"]["b"]`` → "obj"), or None."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


# ---------------------------------------------------------------------------
# uncached-list


@register
class UncachedListRule(Rule):
    """AST-accurate replacement for the old grep scan in
    the JAX package's ``tests/test_cache.py``: a cluster-wide ``.list("<Kind>")`` of an
    indexable kind — no namespace, no selector, no field match — on a
    hot path scans and freezes/copies the whole cluster per call. Use
    the namespaced/selector/indexed read forms, or mark a genuinely
    global cold/snapshot pass with ``# uncached-ok: <reason>``."""

    id = "uncached-list"
    description = (
        "bare cluster-wide list() of an indexable kind on a hot path"
    )
    dirs = ("controllers", "web", "scheduling", "webhooks", "sessions",
            "warmup")
    # the partition router's merge and move paths issue list() calls
    # themselves; an unselective cluster-wide scan of an indexable
    # kind there multiplies by the partition count
    files = ("machinery/partition.py",)

    _SELECTIVE_KWARGS = ("namespace", "label_selector", "field_matches")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "list"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in INDEXABLE_KINDS
            ):
                continue
            kind = node.args[0].value
            selective = len(node.args) > 1 or any(
                kw.arg in self._SELECTIVE_KWARGS
                and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None
                )
                for kw in node.keywords
            )
            if selective:
                continue
            # legacy marker continuity: `# uncached-ok: <reason>` on
            # any line of the call keeps working
            span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
            if any("uncached-ok" in src.line(n) for n in span):
                continue
            yield self.finding(
                src,
                node,
                f"cluster-wide list of indexable kind {kind!r}; use a "
                "namespaced/selector/indexed read or annotate with "
                "`# uncached-ok: <reason>`",
            )


# ---------------------------------------------------------------------------
# unbounded-list


@register
class UnboundedListRule(Rule):
    """A list call on a serving path — web/HTTP handlers and the
    informer's prime/resync — that names a kind but carries no
    ``limit`` builds one response-sized payload for the WHOLE
    collection: at fleet size (25k+ notebooks) that is a multi-MB
    serialize-and-ship per request. Such calls must paginate
    (``limit=`` / ``list_chunk`` walks) or be explicitly marked
    ``# unbounded-ok: <reason>`` (the standing reason in web/ is a
    cache-served zero-copy read — the informer mirror hands out shared
    references, no payload is built). Scope: ``web/`` plus the
    informer cache's own prime path."""

    id = "unbounded-list"
    description = (
        "list of a kind without a limit on a serving/prime path "
        "(fleet-sized payload)"
    )
    dirs = ("web",)
    # beyond web/: the informer prime path, the read-replica serving
    # tier, and the partition router's scatter-gather merge — a
    # fleet-sized unpaginated list there defeats the whole point of
    # scaling the read path out. (Base Rule.applies unions files +
    # dirs.)
    files = (
        "machinery/cache.py",
        "machinery/replica.py",
        "machinery/partition.py",
    )

    _LISTERS = frozenset({"api", "client", "server", "store", "backend"})

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "list"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                continue
            chain = _attr_chain(node.func)
            if not any(part in self._LISTERS for part in chain[:-1]):
                continue
            if any(
                kw.arg == "limit"
                and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None
                )
                for kw in node.keywords
            ):
                continue
            span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
            if any("unbounded-ok" in src.line(n) for n in span):
                continue
            yield self.finding(
                src,
                node,
                f"list of {node.args[0].value!r} without a limit on a "
                "serving/prime path; paginate (limit= / list_chunk) or "
                "annotate with `# unbounded-ok: <reason>`",
            )


# ---------------------------------------------------------------------------
# swallowed-exception


@register
class SwallowedExceptionRule(Rule):
    """A bare ``except:`` or ``except Exception:`` whose body neither
    re-raises nor leaves any trace (log, Event, metric, or real
    handling) turns every failure in controllers/webhooks/scheduling/
    machinery into silence — reconcile loops quietly stop converging.
    Handlers that do anything observable (a call, a raise, a
    conditional) pass; only trivially-swallowing bodies (``pass``,
    ``continue``, ``return <constant>``) are flagged."""

    id = "swallowed-exception"
    # (sessions/ included: a swallowed snapshot failure silently loses
    # a user's kernel)
    description = "broad except handler that silently discards the error"
    dirs = ("controllers", "webhooks", "scheduling", "machinery", "sessions")

    _BROAD = ("Exception", "BaseException")

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        if isinstance(t, ast.Name):
            return t.id in self._BROAD
        if isinstance(t, ast.Tuple):
            return any(
                isinstance(e, ast.Name) and e.id in self._BROAD for e in t.elts
            )
        return False

    def _trivial(self, body: list[ast.stmt]) -> bool:
        for stmt in body:
            if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
                continue
            if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Constant
            ):
                continue  # docstring / ellipsis
            if isinstance(stmt, ast.Return):
                v = stmt.value
                if v is None or isinstance(v, (ast.Constant, ast.Name)):
                    continue
                if isinstance(v, (ast.List, ast.Dict, ast.Tuple, ast.Set)) and not getattr(
                    v, "elts", getattr(v, "keys", ())
                ):
                    continue  # return [] / {} / ()
            return False
        return True

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if self._is_broad(node) and self._trivial(node.body):
                yield self.finding(
                    src,
                    node,
                    "broad except swallows the error with no log/Event/"
                    "metric; handle it, narrow the exception type, or "
                    "annotate with a reason",
                )


# ---------------------------------------------------------------------------
# blocking-under-lock (static half; analysis/sanitizer.py is the
# runtime half)


@register
class BlockingUnderLockRule(Rule):
    """``time.sleep``, HTTP client calls, and blocking queue/watch
    ``get(timeout=…)`` inside a ``with <lock>:`` block stall every
    other thread contending for that lock — the exact shape of the
    old ``_RateLimiter`` bug. ``Condition.wait`` is exempt (it
    releases the lock while blocked)."""

    id = "blocking-under-lock"
    description = "blocking call (sleep/HTTP/watch-get) while holding a lock"
    files = (
        "machinery/store.py",
        "machinery/cache.py",
        "machinery/client.py",
        "controllers/runtime.py",
        "scheduling/scheduler.py",
        "scheduling/queue.py",
        # checkpoint IO (snapshot HTTP hooks, orbax writes) must never
        # run under store/cache locks — suspend would stall every reader
        "sessions/manager.py",
        "sessions/checkpoint.py",
        # grew concurrent in PRs 7/10: the WAL's group-commit io_lock
        # and the event-loop serving tier
        "machinery/wal.py",
        "machinery/eventloop.py",
        # singleflight: the compile-cache inflight lock must only guard
        # the table — compiles and artifact IO happen outside it
        "warmup/compilecache.py",
        "warmup/pool.py",
        # the replication pull loop blocks on sockets by design — but
        # NEVER under the replica store's lock (rv-pinned reads park on
        # a Condition there, which is the one exempt form)
        "machinery/replica.py",
        # the partition router's merged-watch pump lock serializes leg
        # drains on the WRITE path — a blocking get under it would
        # stall every mutator of every partition at once
        "machinery/partition.py",
    )

    # one lock vocabulary for the per-file and whole-program analyses
    # (callgraph.is_lockish uses the same tuple)
    _LOCKISH = callgraph.LOCKISH_MARKERS
    _WAITS = frozenset({"wait", "wait_for"})

    def _is_lockish(self, expr: ast.AST) -> bool:
        chain = _attr_chain(expr)
        if not chain:
            return False
        terminal = chain[-1].lower()
        return any(marker in terminal for marker in self._LOCKISH)

    def _blocking_call(self, call: ast.Call) -> Optional[str]:
        # ONE blocking-leaf vocabulary for the per-file and
        # through-calls analyses (callgraph.blocking_leaf): sleep,
        # fsync, socket/HTTP IO, blocking get(timeout=…)
        desc = callgraph.blocking_leaf(call)
        if desc == "os.fsync":
            chain = _attr_chain(call.func)
            if chain and chain[0] == "self":
                # self.io.fsync(f) — a method indirection (the WAL's
                # FileIO), which the interprocedural rule chases
                return None
        return desc

    def _iter_immediate(self, node: ast.AST) -> Iterator[ast.AST]:
        """Descendants that execute inside the critical section —
        nested defs/lambdas run later, outside the lock, and are
        pruned (``ast.walk`` would descend into them)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            yield child
            yield from self._iter_immediate(child)

    def _scan_body(
        self, src: SourceFile, body: list[ast.stmt]
    ) -> Iterator[Finding]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # defined under the lock, executed later
            for node in [stmt, *self._iter_immediate(stmt)]:
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func)
                if chain and chain[-1] in self._WAITS:
                    continue
                what = self._blocking_call(node)
                if what:
                    yield self.finding(
                        src,
                        node,
                        f"{what} while holding a lock; move the blocking "
                        "call outside the critical section",
                    )

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.With):
                continue
            if any(
                self._is_lockish(item.context_expr) for item in node.items
            ):
                yield from self._scan_body(src, node.body)


# ---------------------------------------------------------------------------
# retry-without-backoff


@register
class RetryWithoutBackoffRule(Rule):
    """A hand-rolled retry loop — ``while True`` or fixed-count
    ``for … in range(n)`` around an API call, swallowing the error to
    go around again with a constant sleep (or none) — synchronises
    every failing client into a thundering herd against the recovering
    server. Route retries through ``machinery.backoff`` (jittered
    exponential delays, capped attempts, Retry-After honoured). A loop
    that references the backoff helper, sleeps a *computed* delay, or
    whose except handler exits the loop (return/raise/break) is not a
    retry loop and passes."""

    id = "retry-without-backoff"
    description = (
        "bare retry loop around API calls without the shared backoff "
        "helper"
    )
    dirs = ("machinery", "controllers")

    _API_TERMINALS = frozenset(
        {
            "create",
            "update",
            "update_status",
            "patch",
            "delete",
            "list",
            "watch",
            "urlopen",
            "_request",
            "_do_request",
            "_call",
            "_query",
            "emit_event",
            "create_or_get",
        }
    )
    _BACKOFFISH_CALLS = frozenset({"retry", "next_delay", "delays"})

    def _is_retry_loop_header(self, node: ast.AST) -> bool:
        if isinstance(node, ast.While):
            return isinstance(node.test, ast.Constant) and bool(
                node.test.value
            )
        if isinstance(node, ast.For):
            it = node.iter
            return (
                isinstance(it, ast.Call)
                and isinstance(it.func, ast.Name)
                and it.func.id == "range"
            )
        return False

    def _iter_live(self, node: ast.AST) -> Iterator[ast.AST]:
        """Descendants executing inside the loop iteration — nested
        defs/lambdas run later and are pruned."""
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            yield child
            yield from self._iter_live(child)

    def _uses_backoff(self, loop: ast.AST) -> bool:
        for node in [loop, *self._iter_live(loop)]:
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if chain and (
                    chain[-1] in self._BACKOFFISH_CALLS
                    or any("backoff" in c.lower() for c in chain)
                ):
                    return True
            if isinstance(node, ast.Name) and "backoff" in node.id.lower():
                return True
            if isinstance(node, ast.Attribute) and (
                "backoff" in node.attr.lower()
            ):
                return True
        return False

    def _handler_retries(self, handler: ast.ExceptHandler) -> bool:
        """Whether the handler lets the loop go around again: a body
        ending in return/raise/break exits instead of retrying."""
        if not handler.body:
            return True
        last = handler.body[-1]
        return not isinstance(last, (ast.Return, ast.Raise, ast.Break))

    def _api_retry_try(self, loop: ast.AST) -> Optional[ast.Try]:
        for node in self._iter_live(loop):
            if not isinstance(node, ast.Try):
                continue
            in_try = [
                n
                for stmt in node.body
                for n in [stmt, *self._iter_live(stmt)]
            ]
            calls_api = any(
                isinstance(n, ast.Call)
                and (chain := _attr_chain(n.func))
                and chain[-1] in self._API_TERMINALS
                and len(chain) > 1
                for n in in_try
            )
            if calls_api and any(
                self._handler_retries(h) for h in node.handlers
            ):
                return node
        return None

    def _sleeps_constant_or_nothing(self, loop: ast.AST) -> bool:
        for node in self._iter_live(loop):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if not chain or chain[-1] != "sleep":
                continue
            if not all(isinstance(a, ast.Constant) for a in node.args):
                return False  # computed delay: some pacing policy exists
        return True  # constant sleeps and no sleep at all both flag

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not self._is_retry_loop_header(node):
                continue
            if self._uses_backoff(node):
                continue
            if self._api_retry_try(node) is None:
                continue
            if not self._sleeps_constant_or_nothing(node):
                continue
            yield self.finding(
                src,
                node,
                "retry loop around an API call with constant (or no) "
                "sleep; use machinery.backoff.retry()/next_delay() for "
                "jittered, capped retries",
            )


# ---------------------------------------------------------------------------
# unbudgeted-retry


@register
class UnbudgetedRetryRule(Rule):
    """A retry site on the API path that ignores the process-wide
    retry budget (``machinery.overload.shared_budget``) amplifies load
    exactly when the fleet can least afford it: every stacked layer
    multiplies attempts-per-logical-request during a brownout — the
    retry-storm half of a metastable failure. Two shapes flag in
    ``machinery/`` and ``web/``: a ``backoff.retry(...)`` call that
    does not thread a ``budget=``, and a hand-rolled reconnect loop
    pacing itself with ``backoff.next_delay`` that consults neither a
    retry budget nor a circuit breaker anywhere in its body. The
    escape hatch is ``# budget-ok: <reason>`` on a line of the flagged
    call, for retries that genuinely must not be budget-bound: loops
    that MUST go forever (the replication stream), purely local
    optimistic-concurrency merges, and third-party-API etag races."""

    id = "unbudgeted-retry"
    description = (
        "API-path retry without the shared overload retry budget "
        "(thread budget= or justify with # budget-ok)"
    )
    dirs = ("machinery", "web")

    _GUARD_TOKENS = ("budget", "breaker")

    def _escaped(self, src: SourceFile, node: ast.AST) -> bool:
        last = getattr(node, "end_lineno", None) or node.lineno
        return any(
            "budget-ok" in src.line(i)
            for i in range(node.lineno, last + 1)
        )

    def _backoff_call(self, node: ast.AST, name: str) -> bool:
        if not isinstance(node, ast.Call):
            return False
        chain = _attr_chain(node.func)
        return bool(
            chain
            and chain[-1] == name
            and any("backoff" in c.lower() for c in chain[:-1])
        )

    def _iter_live(self, node: ast.AST, stop_at_loops: bool = False):
        """Descendants executing in ``node``'s own iteration: nested
        defs/lambdas run later and are pruned; with ``stop_at_loops``
        nested loops are pruned too (innermost-loop attribution)."""
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if stop_at_loops and isinstance(child, (ast.While, ast.For)):
                continue
            yield child
            yield from self._iter_live(child, stop_at_loops)

    def _loop_guarded(self, loop: ast.AST) -> bool:
        """Whether the loop's live body consults a budget or breaker —
        any name/attribute carrying either token (``self._breaker``,
        ``budget.try_spend()``…)."""
        for node in self._iter_live(loop):
            if isinstance(node, ast.Name) and any(
                t in node.id.lower() for t in self._GUARD_TOKENS
            ):
                return True
            if isinstance(node, ast.Attribute) and any(
                t in node.attr.lower() for t in self._GUARD_TOKENS
            ):
                return True
            if isinstance(node, ast.keyword) and node.arg and any(
                t in node.arg.lower() for t in self._GUARD_TOKENS
            ):
                return True
        return False

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if self._backoff_call(node, "retry"):
                has_budget = any(
                    kw.arg == "budget" for kw in node.keywords
                )
                if not has_budget and not self._escaped(src, node):
                    yield self.finding(
                        src,
                        node,
                        "backoff.retry without a retry budget: thread "
                        "budget=overload.shared_budget() (or a shared "
                        "RetryBudget) so stacked retry layers share one "
                        "amplification bound, or justify with "
                        "# budget-ok: <reason>",
                    )
            if isinstance(node, (ast.While, ast.For)):
                calls = [
                    n
                    for n in self._iter_live(node, stop_at_loops=True)
                    if self._backoff_call(n, "next_delay")
                ]
                if not calls or self._loop_guarded(node):
                    continue
                for call in calls:
                    if not self._escaped(src, call):
                        yield self.finding(
                            src,
                            call,
                            "reconnect loop paced by backoff.next_delay "
                            "consults neither a retry budget nor a "
                            "circuit breaker; gate it (see client.py's "
                            "watch pump) or justify with "
                            "# budget-ok: <reason>",
                        )


# ---------------------------------------------------------------------------
# unfenced-write


@register
class UnfencedWriteRule(Rule):
    """A module that participates in leader election or shard
    membership (imports ``machinery.leader`` / constructs a
    ``LeaderElector``/``ShardMembership``) is a controller-path
    writer, and every store write it issues must carry its lease
    epoch: either lexically inside ``with <elector>.fence():`` /
    ``with fenced(...):``, or through a receiver whose name marks it
    fenced (``fenced_api.update(...)``). A raw write in such a module
    is exactly the leader-election TOCTOU the store's fencing-token
    check closes — a deposed holder completing an in-flight write
    after losing the lease. Components that get their fence from the
    Manager (``fence_fn``) never import leader machinery and are out
    of scope, same scope discipline as ``retry-without-backoff``.
    Genuinely epoch-free writes (boot-time registration, test
    scaffolding) are annotated ``# unfenced-ok: <reason>``."""

    id = "unfenced-write"
    description = (
        "store write in a leader-electing module outside a fencing "
        "context"
    )
    dirs = ("controllers", "machinery", "scheduling", "sessions", "web",
            "warmup")

    # the fencing helpers themselves (and the runner, which only wires
    # electors into the Manager) are the mechanism, not consumers
    _EXEMPT_FILES = frozenset({"machinery/leader.py"})

    _WRITE_TERMINALS = frozenset(
        {
            "create",
            "update",
            "update_status",
            "patch",
            "delete",
            "emit_event",
            "create_or_get",
        }
    )
    _WRITERISH = frozenset({"api", "client", "store"})
    _LEADER_NAMES = ("LeaderElector", "ShardMembership")

    def _module_uses_leader(self, tree: ast.AST) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod.endswith("machinery.leader") or mod == "leader":
                    return True
            elif isinstance(node, ast.Import):
                if any(
                    a.name.endswith("machinery.leader") for a in node.names
                ):
                    return True
            elif isinstance(node, ast.Name) and node.id in self._LEADER_NAMES:
                return True
        return False

    def _is_fence_ctx(self, expr: ast.AST) -> bool:
        """``<elector>.fence()`` / ``fenced(...)`` / ``leader.fenced(…)``
        — any call whose terminal name is fence-ish."""
        if not isinstance(expr, ast.Call):
            return False
        chain = _attr_chain(expr.func)
        return bool(chain) and chain[-1] in ("fence", "fenced")

    def _is_raw_write(self, call: ast.Call) -> bool:
        chain = _attr_chain(call.func)
        if len(chain) < 2 or chain[-1] not in self._WRITE_TERMINALS:
            return False
        receiver = chain[:-1]
        if any("fenced" in part.lower() for part in receiver):
            return False  # a fence-carrying handle
        return any(part in self._WRITERISH for part in receiver)

    def _visit(
        self, src: SourceFile, node: ast.AST, fenced: bool
    ) -> Iterator[Finding]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a function body starts unfenced: the fence is a dynamic
            # contextvar, and a def's call site is unknown lexically
            for child in node.body:
                yield from self._visit(src, child, False)
            return
        if isinstance(node, ast.Lambda):
            # conservatively skipped: `retry(lambda: api.update(x))`
            # inside a fence block runs while the fence is installed
            return
        if isinstance(node, ast.With):
            inner = fenced or any(
                self._is_fence_ctx(item.context_expr) for item in node.items
            )
            for child in node.body:
                yield from self._visit(src, child, inner)
            return
        if (
            not fenced
            and isinstance(node, ast.Call)
            and self._is_raw_write(node)
        ):
            span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
            if not any("unfenced-ok" in src.line(i) for i in span):
                yield self.finding(
                    src,
                    node,
                    "store write in a leader-electing module without "
                    "a fencing context; wrap in `with elector.fence():`"
                    " (or route through a fenced handle), or annotate "
                    "with `# unfenced-ok: <reason>`",
                )
        for child in ast.iter_child_nodes(node):
            yield from self._visit(src, child, fenced)

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.rel in self._EXEMPT_FILES:
            return
        if not self._module_uses_leader(src.tree):
            return
        for child in src.tree.body:
            yield from self._visit(src, child, False)


# ---------------------------------------------------------------------------
# hot-path-json-dumps


@register
class HotPathJsonDumpsRule(Rule):
    """Every JSON response the web/API tier emits must flow through
    ``machinery.serialize.dumps`` (C-speed, byte-identical to
    ``json.dumps``) or the serialized-bytes cache — a direct
    ``json.dumps`` on a serving path silently reverts that response to
    an interpreter tree walk per hit, exactly the cost the native
    serializer removed. Scope is the serving tiers (``web/``,
    ``machinery/``); ``machinery/serialize.py`` itself is exempt (it
    IS the fallback). Genuinely cold or outbound sites (client request
    bodies, cloud-API payloads, bench baselines) are marked
    ``# dumps-ok: <reason>`` on any line of the call."""

    id = "hot-path-json-dumps"
    description = (
        "direct json.dumps on a web/machinery serving path (bypasses "
        "the native serializer)"
    )
    dirs = ("web", "machinery")

    _EXEMPT_FILES = frozenset({"machinery/serialize.py"})

    @staticmethod
    def _json_module_names(tree: ast.AST) -> frozenset[str]:
        """Local names bound to the ``json`` module (``import json``,
        ``import json as _json``) — so a same-named ``dumps`` method on
        some other object is never mistaken for the stdlib encoder."""
        names = {"json"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "json":
                        names.add(a.asname or a.name)
        return frozenset(names)

    @staticmethod
    def _bare_dumps_names(tree: ast.AST) -> frozenset[str]:
        """Local names bound to ``json.dumps`` via
        ``from json import dumps [as …]``."""
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "json":
                for a in node.names:
                    if a.name == "dumps":
                        names.add(a.asname or a.name)
        return frozenset(names)

    def check(self, src: SourceFile) -> Iterator[Finding]:
        if src.rel in self._EXEMPT_FILES:
            return
        json_names = self._json_module_names(src.tree)
        bare_names = self._bare_dumps_names(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            hit = (
                isinstance(func, ast.Attribute)
                and func.attr == "dumps"
                and isinstance(func.value, ast.Name)
                and func.value.id in json_names
            ) or (
                isinstance(func, ast.Name) and func.id in bare_names
            )
            if not hit:
                continue
            span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
            if any("dumps-ok" in src.line(n) for n in span):
                continue
            yield self.finding(
                src,
                node,
                "direct json.dumps on a serving path; route through "
                "machinery.serialize.dumps (or the serialized-bytes "
                "cache), or annotate with `# dumps-ok: <reason>`",
            )


# ---------------------------------------------------------------------------
# span-in-hot-loop


@register
class SpanInHotLoopRule(Rule):
    """Span recording is cheap per span but NOT free-per-million:
    every ``tracing.span(...)`` allocates ids and lands a record in
    the collector ring. Creating one inside a per-watch-event or
    per-page loop in ``machinery/`` (the event pumps, list walkers,
    and serving paths everything else rides on) turns a single
    request into an unbounded span fan-out and flushes the ring of
    the traces an operator actually wants. Span the operation, not
    the iteration — or mark a deliberately-traced loop body with
    ``# span-ok: <reason>``. Nested function bodies inside the loop
    are skipped (they execute on their own schedule, not
    per-iteration)."""

    id = "span-in-hot-loop"
    description = (
        "tracing.span() created inside a per-event/per-page loop in "
        "machinery/"
    )
    dirs = ("machinery",)

    _SPAN_ATTRS = frozenset({"span", "child_span"})

    @staticmethod
    def _loop_body_nodes(loop: ast.AST) -> Iterator[ast.AST]:
        """Walk a loop's body, pruning nested function/lambda scopes
        (their bodies don't run per-iteration)."""
        stack = list(loop.body) + list(getattr(loop, "orelse", []))
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _is_span_call(self, node: ast.AST, bare_names: frozenset[str]) -> bool:
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in self._SPAN_ATTRS
            and isinstance(func.value, ast.Name)
            and func.value.id == "tracing"
        ):
            return True
        return isinstance(func, ast.Name) and func.id in bare_names

    @staticmethod
    def _bare_span_names(tree: ast.AST) -> frozenset[str]:
        """Names bound via ``from …tracing import span [as …]``."""
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (
                node.module or ""
            ).endswith("tracing"):
                for a in node.names:
                    if a.name in ("span", "child_span"):
                        names.add(a.asname or a.name)
        return frozenset(names)

    def check(self, src: SourceFile) -> Iterator[Finding]:
        bare = self._bare_span_names(src.tree)
        for loop in ast.walk(src.tree):
            if not isinstance(loop, (ast.For, ast.While, ast.AsyncFor)):
                continue
            for node in self._loop_body_nodes(loop):
                if not self._is_span_call(node, bare):
                    continue
                span_lines = range(
                    node.lineno, (node.end_lineno or node.lineno) + 1
                )
                if any("span-ok" in src.line(n) for n in span_lines):
                    continue
                yield self.finding(
                    src,
                    node,
                    "span created inside a loop on a machinery hot "
                    "path; span the operation outside the loop or "
                    "annotate with `# span-ok: <reason>`",
                )


# ---------------------------------------------------------------------------
# metric-naming


def metric_definition_sites(
    root: Optional[str] = None,
) -> list[tuple[str, str, str, int]]:
    """Every statically visible metric definition in the package:
    ``(rel_path, type, name, lineno)`` for ``registry.counter/gauge/
    histogram("literal", …)`` calls and direct ``Counter/Gauge/
    Histogram("literal", …)`` constructions. Exposed so tests can
    assert the scan still sees the platform's metric surface (an empty
    scan means the detector broke, not that the tree is clean)."""
    from odh_kubeflow_tpu_torch.analysis.graftlint import iter_sources

    out = []
    for src in iter_sources(root):
        for typ, name, node in _iter_metric_defs(src.tree):
            out.append((src.rel, typ, name, node.lineno))
    return out


_FACTORY_METHODS = {  # registry.counter("name", …) — the common form
    "counter": "counter",
    "gauge": "gauge",
    "histogram": "histogram",
}
_CONSTRUCTORS = {  # Counter("name", …) — only when provably prometheus's
    "Counter": "counter",
    "Gauge": "gauge",
    "Histogram": "histogram",
}


def _prometheus_constructor_aliases(tree: ast.AST) -> dict[str, str]:
    """Local names bound to utils.prometheus's Counter/Gauge/Histogram
    via ``from … prometheus import`` — so ``collections.Counter("x")``
    and other same-named classes are never mistaken for metrics."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.ImportFrom)
            and node.module
            and node.module.split(".")[-1] == "prometheus"
        ):
            for a in node.names:
                if a.name in _CONSTRUCTORS:
                    aliases[a.asname or a.name] = _CONSTRUCTORS[a.name]
    return aliases


def _iter_metric_defs(tree: ast.AST) -> Iterator[tuple[str, str, ast.Call]]:
    ctor_aliases = _prometheus_constructor_aliases(tree)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        func = node.func
        typ = None
        if isinstance(func, ast.Attribute):
            typ = _FACTORY_METHODS.get(func.attr)
            if typ is None and func.attr in _CONSTRUCTORS:
                # prometheus.Counter(…) / <…>.prometheus.Counter(…)
                chain = _attr_chain(func)
                if "prometheus" in chain[:-1]:
                    typ = _CONSTRUCTORS[func.attr]
        elif isinstance(func, ast.Name):
            typ = ctor_aliases.get(func.id)
        if typ is None:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
            continue
        yield typ, first.value, node


@register
class MetricNamingRule(Rule):
    """The registry conventions (``utils.prometheus.
    metric_name_violations``) checked statically at every definition
    site, so a misnamed metric fails lint before any process registers
    it. Literal ``labelnames`` tuples are checked too."""

    id = "metric-naming"
    description = "metric definition violating Prometheus naming conventions"

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for typ, name, node in _iter_metric_defs(src.tree):
            labelnames: list[str] = []
            for kw in node.keywords:
                if kw.arg == "labelnames" and isinstance(
                    kw.value, (ast.Tuple, ast.List)
                ):
                    labelnames = [
                        e.value
                        for e in kw.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    ]
            for violation in metric_name_violations(name, typ, labelnames):
                yield self.finding(src, node, violation)


# ---------------------------------------------------------------------------
# frozen-mutation


_READ_METHODS = frozenset({"get", "list", "by_index", "index_buckets"})
_CLIENTISH = frozenset({"api", "client", "cache", "informer", "store"})


def _is_cache_read(call: ast.Call) -> bool:
    """A call that returns shared frozen objects when the platform
    runs cache-fronted: ``<…>.api/client/cache.get/list/by_index/
    index_buckets(…)`` or the ``list_by_index`` helper."""
    if isinstance(call.func, ast.Name):
        return call.func.id == "list_by_index"
    chain = _attr_chain(call.func)
    if len(chain) < 2 or chain[-1] not in _READ_METHODS:
        return False
    return any(part in _CLIENTISH for part in chain[:-1])


@register
class FrozenMutationRule(Rule):
    """Objects read through ``CachedClient``/the informer cache are
    SHARED and deep-frozen; in-place mutation raises
    ``FrozenObjectError`` at runtime (or, worse, corrupts every other
    reader if the freeze is ever bypassed). Any subscript assignment
    or mutating method call on a variable sourced from a cache-shaped
    read must take a private copy first: ``obj = mutable(obj)``.
    Scope-limited to the cache-fronted layers (controllers/web/
    scheduling); the raw store hands out private copies."""

    id = "frozen-mutation"
    description = (
        "in-place mutation of a cache-sourced object without mutable()"
    )
    dirs = ("controllers", "web", "scheduling", "sessions", "warmup")

    def check(self, src: SourceFile) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(src, node)

    # -- per-function sequential taint walk ---------------------------------

    def _check_function(
        self, src: SourceFile, fn: ast.FunctionDef
    ) -> Iterator[Finding]:
        tainted: set[str] = set()
        yield from self._walk(src, fn.body, tainted)

    def _walk(
        self, src: SourceFile, body: list[ast.stmt], tainted: set[str]
    ) -> Iterator[Finding]:
        for stmt in body:
            yield from self._handle_stmt(src, stmt, tainted)

    def _handle_stmt(
        self, src: SourceFile, stmt: ast.stmt, tainted: set[str]
    ) -> Iterator[Finding]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested function: fresh scope
            yield from self._check_function(src, stmt)
            return
        yield from self._mutations_in(src, stmt, tainted)
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                self._assign(target, stmt.value, tainted)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._assign(stmt.target, stmt.value, tainted)
        elif isinstance(stmt, ast.For):
            if isinstance(stmt.target, ast.Name):
                if isinstance(
                    stmt.iter, ast.Call
                ) and _is_cache_read(stmt.iter):
                    tainted.add(stmt.target.id)
                elif (
                    isinstance(stmt.iter, ast.Name)
                    and stmt.iter.id in tainted
                ):
                    # iterating a tainted list: elements share the taint
                    tainted.add(stmt.target.id)
                else:
                    tainted.discard(stmt.target.id)
            yield from self._walk(src, stmt.body, tainted)
            yield from self._walk(src, stmt.orelse, tainted)
            return
        # recurse into compound statements with the same scope
        for attr in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, attr, None)
            if not sub:
                continue
            if attr == "handlers":
                for h in sub:
                    yield from self._walk(src, h.body, tainted)
            else:
                yield from self._walk(src, sub, tainted)

    def _assign(
        self, target: ast.AST, value: ast.AST, tainted: set[str]
    ) -> None:
        if not isinstance(target, ast.Name):
            return
        if isinstance(value, ast.Call):
            if _is_cache_read(value):
                tainted.add(target.id)
                return
            chain = _attr_chain(value.func)
            if chain and chain[-1] in ("mutable", "deepcopy"):
                tainted.discard(target.id)
                return
            tainted.discard(target.id)
            return
        if isinstance(value, ast.Name) and value.id in tainted:
            tainted.add(target.id)  # alias keeps the taint
            return
        tainted.discard(target.id)

    def _mutations_in(
        self, src: SourceFile, stmt: ast.stmt, tainted: set[str]
    ) -> Iterator[Finding]:
        if not tainted:
            return
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = [
                t
                for t in stmt.targets
                if isinstance(t, (ast.Subscript, ast.Attribute))
            ]
        elif isinstance(stmt, ast.AugAssign) and isinstance(
            stmt.target, (ast.Subscript, ast.Attribute, ast.Name)
        ):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = [
                t for t in stmt.targets if isinstance(t, ast.Subscript)
            ]
        for t in targets:
            root = _root_name(t)
            if root in tainted:
                yield self.finding(
                    src,
                    stmt,
                    f"in-place write to cache-sourced object {root!r} "
                    "(shared, frozen); take a private copy first: "
                    f"{root} = mutable({root})",
                )
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if isinstance(call.func, ast.Attribute) and (
                call.func.attr in _MUTATORS
            ):
                root = _root_name(call.func.value)
                if root in tainted:
                    yield self.finding(
                        src,
                        stmt,
                        f".{call.func.attr}() on cache-sourced object "
                        f"{root!r} (shared, frozen); take a private copy "
                        f"first: {root} = mutable({root})",
                    )


# ---------------------------------------------------------------------------
# interprocedural rules (whole-program: analysis/callgraph.py)

# the concurrency-bearing files whose critical sections the
# interprocedural blocking analysis guards — the intra-procedural
# blocking-under-lock scope, by construction
_CONCURRENCY_FILES = BlockingUnderLockRule.files


@register
class BlockingReachableUnderLockRule(ProgramRule):
    """The through-calls half of ``blocking-under-lock``: a ``with
    lock:`` body that CALLS something which (transitively) sleeps,
    fsyncs, or does socket IO stalls every contender exactly like an
    inline sleep — this is the class of bug the off-lock snapshots
    fixed by hand (the snapshot dump used to serialize under the store
    lock, three calls deep). Findings carry the witness call chain.
    Deliberate designs (the WAL's io_lock exists to serialize fsync
    batches) annotate the call site with a reason."""

    id = "blocking-reachable-under-lock"
    description = (
        "call chain from a with-lock body to sleep/socket IO/fsync in "
        "a callee"
    )

    def check_program(self, program) -> Iterator[Finding]:
        for fn in program.functions.values():
            if fn.src.rel not in _CONCURRENCY_FILES:
                continue
            for region in fn.regions:
                seen: set[str] = set()
                for cs in region.calls:
                    for target in cs.targets:
                        if target == fn.qual:
                            continue
                        for desc, chain in sorted(
                            program.reach_blocking(target).items()
                        ):
                            if desc in seen:
                                continue
                            seen.add(desc)
                            head = callgraph.Step(
                                fn.short, fn.src.rel, cs.node.lineno, cs.label
                            )
                            yield self.finding(
                                fn.src,
                                cs.node,
                                f"{desc} reachable while holding "
                                f"{region.lock!r}: "
                                + callgraph.render_chain((head,) + chain)
                                + "; move the blocking work off the "
                                "critical section or annotate with a "
                                "reason",
                            )


@register
class LockOrderCycleRule(ProgramRule):
    """Static lockdep: every ``with A:`` body that (directly or
    through any resolved call chain) acquires B records the edge A→B;
    a cycle in that graph is a deadlock waiting for the interleaving
    the runtime sanitizer only catches when a test happens to execute
    it. Both witness call paths are reported. Lock ranks come from the
    sanitizer factory names, so the static graph and the
    GRAFT_SANITIZE order graph speak the same language."""

    id = "lock-order-cycle"
    description = (
        "cycle in the static acquires-while-holding graph (potential "
        "deadlock), with witness call paths"
    )

    # the concurrency-bearing sections: lock edges are collected from
    # every function defined here (callees may live anywhere)
    _SECTIONS = ("machinery", "controllers", "scheduling")

    def check_program(self, program) -> Iterator[Finding]:
        # edge (held → wanted) → (witness text, src, anchor node)
        edges: dict[tuple[str, str], tuple[str, Any, Any]] = {}
        for fn in program.functions.values():
            if fn.src.section not in self._SECTIONS:
                continue
            for region in fn.regions:
                for site in region.nested:
                    if site.lock == region.lock:
                        continue
                    edges.setdefault(
                        (region.lock, site.lock),
                        (
                            f"{fn.short} "
                            f"({fn.src.rel}:{site.node.lineno}) acquires "
                            f"{site.lock!r} while holding {region.lock!r}",
                            fn.src,
                            region.node,
                        ),
                    )
                for cs in region.calls:
                    for target in cs.targets:
                        if target == fn.qual:
                            continue
                        for lock, chain in sorted(
                            program.reach_acquires(target).items()
                        ):
                            if lock == region.lock:
                                continue
                            head = callgraph.Step(
                                fn.short,
                                fn.src.rel,
                                cs.node.lineno,
                                cs.label,
                            )
                            edges.setdefault(
                                (region.lock, lock),
                                (
                                    f"holding {region.lock!r}: "
                                    + callgraph.render_chain(
                                        (head,) + chain
                                    ),
                                    fn.src,
                                    region.node,
                                ),
                            )
        adj: dict[str, set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)

        def reaches(src_lock: str, dst: str) -> Optional[list[str]]:
            # DFS path src→…→dst over the edge graph (deterministic
            # order for reproducible witness selection)
            stack = [(src_lock, [src_lock])]
            seen = {src_lock}
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == dst:
                        return path + [nxt]
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append((nxt, path + [nxt]))
            return None

        reported: set[frozenset[str]] = set()
        for (a, b), (witness, src, anchor) in sorted(edges.items()):
            back = reaches(b, a)
            if back is None:
                continue
            cycle = frozenset(back)
            if cycle in reported:
                continue
            reported.add(cycle)
            back_witnesses = [
                edges[(back[i], back[i + 1])][0]
                for i in range(len(back) - 1)
            ]
            yield self.finding(
                src,
                anchor,
                f"lock-order cycle {a!r} → {b!r} → … → {a!r}: "
                f"[forward] {witness}; [back] "
                + "; ".join(back_witnesses),
            )


@register
class AwaitHoldingLockRule(ProgramRule):
    """Coroutines running inline on the event-loop thread multiplex
    EVERY connection: one blocking call — or one acquisition of a lock
    a slow writer might hold — parks the whole serving tier, not one
    request. Nothing blocking and no lock may be reachable from an
    ``async def`` in the event-loop tier; hand such work to the worker
    pool (``run_in_executor``) instead. ``await``-ed calls and
    ``asyncio.sleep`` yield the loop and are exempt."""

    id = "await-holding-lock"
    description = (
        "blocking call or lock acquisition reachable from an event-"
        "loop coroutine"
    )

    _FILES = ("machinery/eventloop.py",)

    def check_program(self, program) -> Iterator[Finding]:
        for fn in program.functions.values():
            if fn.src.rel not in self._FILES or not fn.is_async:
                continue
            for desc, node in fn.blocking:
                yield self.finding(
                    fn.src,
                    node,
                    f"coroutine {fn.short} runs {desc} on the loop "
                    "thread; every connection stalls behind it — use "
                    "run_in_executor or an awaitable",
                )
            for site in fn.acquires:
                yield self.finding(
                    fn.src,
                    site.node,
                    f"coroutine {fn.short} acquires lock {site.lock!r} "
                    "on the loop thread; a slow holder parks every "
                    "connection — dispatch to the worker pool",
                )
            seen: set[tuple[str, str]] = set()
            for cs in fn.calls:
                for target in cs.targets:
                    if target == fn.qual:
                        continue  # self-recursion: the direct scan above owns it
                    head = callgraph.Step(
                        fn.short, fn.src.rel, cs.node.lineno, cs.label
                    )
                    for desc, chain in sorted(
                        program.reach_blocking(target).items()
                    ):
                        if ("b", desc) in seen:
                            continue
                        seen.add(("b", desc))
                        yield self.finding(
                            fn.src,
                            cs.node,
                            f"{desc} reachable from loop coroutine "
                            f"{fn.short}: "
                            + callgraph.render_chain((head,) + chain),
                        )
                    for lock, chain in sorted(
                        program.reach_acquires(target).items()
                    ):
                        if ("l", lock) in seen:
                            continue
                        seen.add(("l", lock))
                        yield self.finding(
                            fn.src,
                            cs.node,
                            f"lock {lock!r} acquisition reachable from "
                            f"loop coroutine {fn.short}: "
                            + callgraph.render_chain((head,) + chain),
                        )


# ---------------------------------------------------------------------------
# exception-flow rules (whole-program: analysis/exceptions.py)

# error-contract / handler-masks-fencing / dead-except self-register on
# import — raise-set inference over the same call graph, see the
# module docstring for the contract table and suppression syntax
from odh_kubeflow_tpu_torch.analysis import exceptions as _exceptions  # noqa: E402,F401

# protocol-surface rules (whole-program): duck-conformance verifies
# every APIServer implementation against the reference protocol (and
# the httpapi↔client error-mapping round trip); protocol-drift keeps
# the kube-metadata contract registry honest against the tree
from odh_kubeflow_tpu_torch.analysis import ducks as _ducks  # noqa: E402,F401
from odh_kubeflow_tpu_torch.analysis import protocol as _protocol  # noqa: E402,F401
