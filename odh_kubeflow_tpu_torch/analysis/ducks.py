"""Duck-conformance inference for the ``APIServer`` protocol surface.

The platform's storage stack is a tower of duck-typed wrappers around
``machinery/store.py``'s ``APIServer`` — the chaos injector, the
informer-cache façade, the HTTP client, the read-split and fanout
shims, the partition router. Nothing makes them conform: a wrapper can
silently miss a verb (``__getattr__`` hides the hole until a caller
needs fault injection on it), drop a keyword the reference grew
(``limit=``), or swallow kwargs through a blind ``*args,
**kwargs`` pass-through that turns a typo'd keyword into silent
mis-routing instead of a loud ``TypeError``.

This module is the ratchet:

- the reference protocol (verb set + per-verb signatures + the
  ``applied_rv``/``kind_version``/``state_digest`` auxiliary surface)
  is EXTRACTED from ``machinery/store.py`` on every run — the rule
  tracks the reference as it evolves, no hand-maintained copy to rot
  (``DEFAULT_REFERENCE`` below is only the fixture-mode fallback, and
  a tier-1 test pins it byte-for-byte to the live extraction);
- every implementation is DECLARED in the ``DUCKS`` inventory with its
  delegation policy (which verbs must be explicit methods, which may
  ride ``__getattr__``), its allowed signature deviations (a remote
  client has no in-process ``inline=`` pump), and its declared extra
  error surface (the chaos injector raises ``Conflict`` on create by
  design) — declared-and-verified, the ``POLICY_ANCHORS`` pattern;
- an auto-discovery sweep over ``machinery/`` catches the NEXT wrapper
  someone writes without declaring it (a ``replica.py`` silently
  shadowed out of a lint scope is exactly this failure);
- the error-translation loop is closed end to end: ``httpapi``'s
  APIError→HTTP-status table and ``client.py``'s status→APIError
  tables must compose to the identity for every wire-protocol error
  class, so a status the server can emit never comes back as the
  wrong exception type (or as a bare ``APIError``) on the client;
- each explicit verb's inferred raise set (the
  ``analysis/exceptions.py`` machinery) must stay inside the declared
  verb model ``VERB_RAISES`` plus the duck's declared extras.

Real findings get FIXED, not baselined — the committed baseline ships
empty, and the tier-1 gate in ``tests/test_torch_ducks.py`` keeps it that
way.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Mapping, Optional

from odh_kubeflow_tpu_torch.analysis.callgraph import FuncInfo, _attr_chain
from odh_kubeflow_tpu_torch.analysis.exceptions import (
    VERB_RAISES,
    mine_hierarchy,
    render_chain,
)
from odh_kubeflow_tpu_torch.analysis.graftlint import (
    Finding,
    ProgramRule,
    register,
)

# ---------------------------------------------------------------------------
# the protocol surface

# the verb set every APIServer duck must serve (explicitly or through a
# declared delegation path)
CORE_VERBS: tuple[str, ...] = (
    "create",
    "get",
    "list",
    "list_chunk",
    "update",
    "update_status",
    "patch",
    "delete",
    "watch",
    "create_or_get",
    "emit_event",
)

# the type-registry / admission surface (broadcast on routers, no-op on
# remote clients — kube parity: you deploy a webhook, you don't
# register Go code into kube-apiserver)
REGISTRY_VERBS: tuple[str, ...] = (
    "register_kind",
    "register_admission_hook",
    "type_info",
    "kind_for_plural",
)

# the replication / bytes-cache / digest-drill surface. Ducks that
# declare it must define it EXPLICITLY: ``__getattr__`` delegation
# makes ``hasattr`` probes always-true, silently bypasses wrapper
# semantics (a chaos wrapper's fault points, a router's fleet
# composition), and leaves nothing for this rule to verify.
AUX_SURFACE: tuple[str, ...] = ("applied_rv", "kind_version", "state_digest")

REFERENCE_FILE = "machinery/store.py"
REFERENCE_CLASS = "APIServer"


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    has_default: bool


@dataclasses.dataclass(frozen=True)
class Sig:
    """A method signature, normalized: positional-or-keyword params
    after ``self`` (with defaultness), keyword-only params, and the
    catch-all flags."""

    params: tuple[Param, ...]
    kwonly: tuple[Param, ...] = ()
    vararg: bool = False
    kwarg: bool = False

    def render(self) -> str:
        parts = [
            f"{p.name}=…" if p.has_default else p.name for p in self.params
        ]
        if self.vararg:
            parts.append("*args")
        if self.kwonly and not self.vararg:
            parts.append("*")
        parts.extend(f"{p.name}=…" for p in self.kwonly)
        if self.kwarg:
            parts.append("**kwargs")
        return "(" + ", ".join(parts) + ")"


def _sig_of(node: ast.FunctionDef) -> Sig:
    a = node.args
    pos = a.posonlyargs + a.args
    if pos and pos[0].arg in ("self", "cls"):
        pos = pos[1:]
    n_default = len(a.defaults)
    params = tuple(
        Param(p.arg, i >= len(pos) - n_default) for i, p in enumerate(pos)
    )
    kwonly = tuple(
        Param(p.arg, a.kw_defaults[i] is not None)
        for i, p in enumerate(a.kwonlyargs)
    )
    return Sig(params, kwonly, a.vararg is not None, a.kwarg is not None)


def _p(*names: str) -> tuple[Param, ...]:
    """Shorthand: ``name`` is required, ``name=`` is optional."""
    return tuple(
        Param(n[:-1], True) if n.endswith("=") else Param(n, False)
        for n in names
    )


# the reference protocol as of machinery/store.py — the fixture-mode
# fallback. Package runs re-extract it from source; the tier-1 test
# pins this copy to the live extraction so it cannot drift.
DEFAULT_REFERENCE: dict[str, Sig] = {
    "create": Sig(_p("obj", "dry_run=")),
    "get": Sig(_p("kind", "name", "namespace=")),
    "list": Sig(
        _p("kind", "namespace=", "label_selector=", "field_matches=", "limit=")
    ),
    "list_chunk": Sig(
        _p(
            "kind",
            "namespace=",
            "label_selector=",
            "field_matches=",
            "limit=",
            "continue_token=",
        )
    ),
    "update": Sig(_p("obj")),
    "update_status": Sig(_p("obj")),
    "patch": Sig(_p("kind", "name", "patch", "namespace=")),
    "delete": Sig(_p("kind", "name", "namespace=")),
    "watch": Sig(
        _p(
            "kind",
            "namespace=",
            "send_initial=",
            "resource_version=",
            "inline=",
        )
    ),
    "create_or_get": Sig(_p("obj")),
    "emit_event": Sig(
        _p("involved", "reason", "message", "event_type=", "component=")
    ),
    "register_kind": Sig(_p("api_version", "kind", "plural", "namespaced=")),
    "register_admission_hook": Sig(_p("kinds", "fn", "mutating=", "name=")),
    "type_info": Sig(_p("kind")),
    "kind_for_plural": Sig(_p("plural")),
    "applied_rv": Sig(()),
    "kind_version": Sig(_p("kind")),
    "state_digest": Sig(()),
}


def reference_protocol(program) -> dict[str, Sig]:
    """The reference verb signatures, extracted from the analyzed
    ``machinery/store.py`` when present (package runs) and falling back
    to :data:`DEFAULT_REFERENCE` per-verb otherwise (fixtures)."""
    out = dict(DEFAULT_REFERENCE)
    src = program.sources.get(REFERENCE_FILE)
    if src is None:
        return out
    for node in src.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == REFERENCE_CLASS:
            for item in node.body:
                if (
                    isinstance(item, ast.FunctionDef)
                    and item.name in DEFAULT_REFERENCE
                ):
                    out[item.name] = _sig_of(item)
    return out


# ---------------------------------------------------------------------------
# the implementation inventory


@dataclasses.dataclass(frozen=True)
class DuckSpec:
    """One declared APIServer implementation and its conformance
    policy. ``explicit`` members must resolve to real method
    definitions (own body or a base class in the analyzed set);
    everything else may ride ``__getattr__`` when ``delegated_ok``.
    ``aux`` names the auxiliary-surface members this duck serves —
    those must ALWAYS be explicit. ``allow_missing`` grants per-verb
    reference parameters this duck deliberately does not accept;
    ``extra_raises`` declares per-verb platform errors beyond the
    ``VERB_RAISES`` model this duck raises by design."""

    file: str
    cls: str
    role: str
    explicit: frozenset[str] = frozenset()
    aux: frozenset[str] = frozenset(AUX_SURFACE)
    delegated_ok: bool = False
    allow_missing: Mapping[str, frozenset[str]] = dataclasses.field(
        default_factory=dict
    )
    extra_raises: Mapping[str, frozenset[str]] = dataclasses.field(
        default_factory=dict
    )
    notes: str = ""


_ALL_VERBS = frozenset(CORE_VERBS) | frozenset(REGISTRY_VERBS)

# a remote wire client has no in-process event pump to inline
_NO_INLINE = {"watch": frozenset({"inline"})}

DUCKS: tuple[DuckSpec, ...] = (
    DuckSpec(
        file="machinery/replica.py",
        cls="ReplicaStore",
        role="follower replica",
        # an APIServer subclass: the whole surface is inherited; the
        # mutation overrides raise NotLeader instead of forwarding
        explicit=_ALL_VERBS | frozenset(AUX_SURFACE),
        notes="inherits APIServer; mutations 307 to the leader",
    ),
    DuckSpec(
        file="machinery/faults.py",
        cls="FaultInjector",
        role="chaos wrapper",
        explicit=frozenset(CORE_VERBS) | frozenset(AUX_SURFACE),
        delegated_ok=True,
        # the injected fault schedule raises beyond the verb model by
        # design: 409 storms on any mutation, generic 5xx on anything
        extra_raises={
            verb: frozenset({"Conflict"})
            for verb in ("create", "delete", "create_or_get", "emit_event")
        },
        notes="every verb must pass a fault point; registry delegates",
    ),
    DuckSpec(
        file="machinery/cache.py",
        cls="CachedClient",
        role="informer read façade",
        explicit=frozenset({"get", "list"}),
        aux=frozenset(),
        delegated_ok=True,
        notes="cache-served reads; writes/watches/registry delegate",
    ),
    DuckSpec(
        file="machinery/client.py",
        cls="RemoteAPIServer",
        role="HTTP client",
        explicit=_ALL_VERBS,
        aux=frozenset({"applied_rv"}),
        allow_missing=_NO_INLINE,
        notes="no __getattr__: the wire surface is the whole surface; "
        "kind_version/state_digest have no wire endpoint",
    ),
    DuckSpec(
        file="machinery/client.py",
        cls="ReplicaFanout",
        role="read fanout over replica endpoints",
        explicit=frozenset(
            {"get", "list", "list_chunk", "watch"}
        )
        | frozenset(REGISTRY_VERBS),
        aux=frozenset({"applied_rv"}),
        delegated_ok=True,
        allow_missing=_NO_INLINE,
        notes="reads fan out with endpoint pinning; writes delegate to "
        "the first endpoint (the runner pairs this with ReadSplitAPI)",
    ),
    DuckSpec(
        file="machinery/replica.py",
        cls="ReadSplitAPI",
        role="read/write splitter",
        explicit=frozenset(
            {"get", "list", "list_chunk", "watch", "register_kind"}
        )
        | frozenset(AUX_SURFACE),
        delegated_ok=True,
        notes="reads replica-served, so the freshness/digest surface "
        "must report the READ arm; writes delegate to the leader",
    ),
    DuckSpec(
        file="machinery/partition.py",
        cls="PartitionRouter",
        role="namespace-sharded router",
        explicit=_ALL_VERBS | frozenset(AUX_SURFACE),
        delegated_ok=True,
        notes="routes by namespace owner; fleet aux surfaces compose "
        "per-partition values",
    ),
)


# ---------------------------------------------------------------------------
# method resolution (MRO-lite over the analyzed file set)


def _resolve_method(
    program, rel: str, cls: str, name: str, _depth: int = 0
) -> Optional[FuncInfo]:
    """The defining :class:`FuncInfo` for ``cls.name``, walking base
    classes through same-file definitions and ``from x import y``
    links. Bases outside the analyzed set simply don't resolve."""
    if _depth > 8:
        return None
    fn = program.functions.get(f"{rel}::{cls}.{name}")
    if fn is not None:
        return fn
    for base in program._bases.get(rel, {}).get(cls, ()):
        if base in program._bases.get(rel, {}):
            found = _resolve_method(program, rel, base, name, _depth + 1)
        else:
            imported = program._from_imports.get(rel, {}).get(base)
            if imported is None:
                continue
            found = _resolve_method(
                program, imported[0], imported[1], name, _depth + 1
            )
        if found is not None:
            return found
    return None


def _derives_from_reference(program, rel: str, cls: str, _depth: int = 0) -> bool:
    if _depth > 8:
        return False
    for base in program._bases.get(rel, {}).get(cls, ()):
        if base == REFERENCE_CLASS:
            return True
        if base in program._bases.get(rel, {}):
            if _derives_from_reference(program, rel, base, _depth + 1):
                return True
        else:
            imported = program._from_imports.get(rel, {}).get(base)
            if imported is not None and _derives_from_reference(
                program, imported[0], imported[1], _depth + 1
            ):
                return True
    return False


# ---------------------------------------------------------------------------
# signature conformance


def _compat_problems(
    ref: Sig, impl: Sig, allow_missing: frozenset[str]
) -> list[str]:
    """Why ``impl`` cannot serve every call shape the reference
    accepts (empty when conformant). A full ``*args, **kwargs``
    catch-all is call-compatible by construction — the blind
    pass-through check reports the forwarding hazard separately."""
    problems: list[str] = []
    impl_by_name = {p.name: p for p in impl.params + impl.kwonly}
    ref_names = [p.name for p in ref.params]
    for p in ref.params:
        got = impl_by_name.get(p.name)
        if got is None:
            if p.name in allow_missing or impl.kwarg:
                continue
            problems.append(f"drops reference parameter `{p.name}`")
        elif p.has_default and not got.has_default:
            problems.append(
                f"makes optional reference parameter `{p.name}` required"
            )
    order = [p.name for p in impl.params if p.name in set(ref_names)]
    expected = [n for n in ref_names if n in set(order)]
    if order != expected:
        problems.append(
            "reorders reference parameters "
            f"({', '.join(order)} vs {', '.join(expected)})"
        )
    for p in impl.params + impl.kwonly:
        if p.name not in set(ref_names) and not p.has_default:
            problems.append(f"adds required parameter `{p.name}`")
    return problems


def _blind_forward(fn: FuncInfo) -> Optional[ast.Call]:
    """The call forwarding this method's own ``*args``/``**kwargs``
    catch-all, when there is one. A catch-all that is merely absorbed
    (a replica's NotLeader-raising mutation stub) is not blind — it
    drops nothing silently; it refuses loudly."""
    a = fn.node.args
    vararg = a.vararg.arg if a.vararg is not None else None
    kwarg = a.kwarg.arg if a.kwarg is not None else None
    if vararg is None and kwarg is None:
        return None
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        star = any(
            isinstance(x, ast.Starred)
            and isinstance(x.value, ast.Name)
            and x.value.id == vararg
            for x in node.args
        )
        dstar = any(
            k.arg is None
            and isinstance(k.value, ast.Name)
            and k.value.id == kwarg
            for k in node.keywords
        )
        if star or dstar:
            return node
    return None


# ---------------------------------------------------------------------------
# error-mapping round trip (httpapi → wire → client)

HTTPAPI_FILE = "machinery/httpapi.py"
CLIENT_FILE = "machinery/client.py"


def _find_dict_assign(tree: ast.AST, name: str) -> Optional[ast.Assign]:
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Dict)
            and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets
            )
        ):
            return node
    return None


def _status_table(tree: ast.AST) -> Optional[list[tuple[str, int]]]:
    """``httpapi._STATUS`` as an ORDERED (class name, code) list —
    ``_err_status`` walks it with ``isinstance`` in dict order, so
    order is semantics."""
    node = _find_dict_assign(tree, "_STATUS")
    if node is None:
        return None
    out: list[tuple[str, int]] = []
    for k, v in zip(node.value.keys, node.value.values):
        chain = _attr_chain(k)
        if chain and isinstance(v, ast.Constant) and isinstance(v.value, int):
            out.append((chain[-1], v.value))
    return out


def _reason_table(tree: ast.AST) -> Optional[dict[str, str]]:
    node = _find_dict_assign(tree, "_REASON_TO_ERR")
    if node is None:
        return None
    out: dict[str, str] = {}
    for k, v in zip(node.value.keys, node.value.values):
        chain = _attr_chain(v)
        if isinstance(k, ast.Constant) and isinstance(k.value, str) and chain:
            out[k.value] = chain[-1]
    return out


def _code_table(tree: ast.AST) -> Optional[dict[int, str]]:
    node = _find_dict_assign(tree, "_ERR_BY_CODE")
    if node is None:
        return None
    out: dict[int, str] = {}
    for k, v in zip(node.value.keys, node.value.values):
        chain = _attr_chain(v)
        if isinstance(k, ast.Constant) and isinstance(k.value, int) and chain:
            out[k.value] = chain[-1]
    return out


# ---------------------------------------------------------------------------
# the rule


@register
class DuckConformanceRule(ProgramRule):
    """Every ``APIServer`` implementation conforms to the reference
    protocol: verb set, per-verb signatures, explicit auxiliary
    surface, no blind kwargs forwarding, declared error surface, and
    an httpapi↔client error mapping that composes to the identity."""

    id = "duck-conformance"
    description = (
        "APIServer duck drifting from the reference protocol "
        "(missing verb, incompatible signature, blind pass-through, "
        "aux gap, error-translation hole)"
    )

    def check_program(self, program) -> Iterator[Finding]:
        ref = reference_protocol(program)
        declared = {(s.file, s.cls) for s in DUCKS}
        for spec in DUCKS:
            yield from self._check_duck(program, spec, ref)
        yield from self._check_discovery(program, declared)
        yield from self._check_round_trip(program)
        yield from self._check_error_surface(program)

    # -- per-duck conformance ------------------------------------------------

    def _check_duck(self, program, spec: DuckSpec, ref) -> Iterator[Finding]:
        src = program.sources.get(spec.file)
        if src is None:
            return  # fixture/scoped run: this duck isn't in the set
        cls_node = next(
            (
                n
                for n in src.tree.body
                if isinstance(n, ast.ClassDef) and n.name == spec.cls
            ),
            None,
        )
        if cls_node is None:
            yield self.finding(
                src,
                src.tree,
                f"DUCKS declares {spec.cls} in {spec.file} but no such "
                "class exists — update the analysis.ducks inventory",
            )
            return
        has_getattr = (
            _resolve_method(program, spec.file, spec.cls, "__getattr__")
            is not None
        )
        for verb in CORE_VERBS + REGISTRY_VERBS + AUX_SURFACE:
            required_explicit = verb in spec.explicit or verb in spec.aux
            fn = _resolve_method(program, spec.file, spec.cls, verb)
            if fn is None:
                if required_explicit:
                    kind = (
                        "auxiliary surface" if verb in AUX_SURFACE else "verb"
                    )
                    yield self.finding(
                        src,
                        cls_node,
                        f"{spec.cls} ({spec.role}) has no explicit "
                        f"`{verb}` — the {kind} is part of its declared "
                        "duck contract and __getattr__ delegation does "
                        "not count (nothing to verify, wrapper "
                        "semantics silently bypassed)",
                    )
                elif not (spec.delegated_ok and has_getattr):
                    if verb in AUX_SURFACE and verb not in spec.aux:
                        continue  # deliberately absent (no wire surface)
                    yield self.finding(
                        src,
                        cls_node,
                        f"{spec.cls} ({spec.role}) serves no `{verb}` — "
                        "no explicit method, no inherited definition, "
                        "no __getattr__ delegation path",
                    )
                continue
            if fn.src.rel != spec.file:
                continue  # inherited from the reference: conformant
            if verb in AUX_SURFACE and verb not in spec.aux:
                continue
            sig = _sig_of(fn.node)
            allow = frozenset(spec.allow_missing.get(verb, frozenset()))
            for problem in _compat_problems(ref[verb], sig, allow):
                yield self.finding(
                    fn.src,
                    fn.node,
                    f"{spec.cls}.{verb}{sig.render()} {problem} — "
                    f"reference is {REFERENCE_CLASS}.{verb}"
                    f"{ref[verb].render()}",
                )
            fwd = _blind_forward(fn)
            if fwd is not None and verb not in AUX_SURFACE:
                yield self.finding(
                    fn.src,
                    fn.node,
                    f"{spec.cls}.{verb} forwards a blind *args/**kwargs "
                    "catch-all — a typo'd keyword silently mis-routes "
                    "instead of raising TypeError; spell out the "
                    f"reference signature {REFERENCE_CLASS}.{verb}"
                    f"{ref[verb].render()}",
                )

    # -- undeclared implementations ------------------------------------------

    def _check_discovery(self, program, declared) -> Iterator[Finding]:
        for src in program.sources.values():
            if src.section != "machinery":
                continue
            for node in src.tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                if (
                    src.rel == REFERENCE_FILE
                    and node.name == REFERENCE_CLASS
                ):
                    continue
                if (src.rel, node.name) in declared:
                    continue
                own_verbs = {
                    n.name
                    for n in node.body
                    if isinstance(n, ast.FunctionDef)
                    and n.name in CORE_VERBS
                }
                if len(own_verbs) >= 3 or _derives_from_reference(
                    program, src.rel, node.name
                ):
                    yield self.finding(
                        src,
                        node,
                        f"{node.name} implements "
                        f"{len(own_verbs)} APIServer verbs "
                        f"({', '.join(sorted(own_verbs))}) but is not "
                        "declared in the analysis.ducks DUCKS "
                        "inventory — declare it with its delegation "
                        "policy so conformance is checked",
                    )

    # -- httpapi ↔ client round trip -----------------------------------------

    def _check_round_trip(self, program) -> Iterator[Finding]:
        httpapi = program.sources.get(HTTPAPI_FILE)
        client = program.sources.get(CLIENT_FILE)
        if httpapi is None or client is None:
            return
        status = _status_table(httpapi.tree)
        reason = _reason_table(client.tree)
        by_code = _code_table(client.tree)
        if status is None or reason is None or by_code is None:
            return
        reason_node = _find_dict_assign(client.tree, "_REASON_TO_ERR")
        hierarchy = mine_hierarchy(program)

        def ancestors(err: str) -> set[str]:
            out = {err}
            cur: Optional[str] = err
            while cur is not None:
                cur = hierarchy.get(cur)
                if cur is not None:
                    out.add(cur)
            return out

        for key, klass in reason.items():
            if key != klass:
                yield self.finding(
                    client,
                    reason_node,
                    f"_REASON_TO_ERR maps reason {key!r} to {klass} — "
                    "the server sets Status.reason to the error class "
                    "name, so key and class must agree",
                )
        wire_classes = {
            n.name
            for n in (program.sources.get(REFERENCE_FILE).tree.body
                      if REFERENCE_FILE in program.sources else ())
            if isinstance(n, ast.ClassDef) and n.name in hierarchy
        }
        for err in sorted(hierarchy):
            if err == "APIError":
                continue
            anc = ancestors(err)
            code = next((c for k, c in status if k in anc), 500)
            mapped = reason.get(err) or by_code.get(code) or "APIError"
            if mapped == err:
                continue
            if err in wire_classes or not wire_classes:
                yield self.finding(
                    client,
                    reason_node,
                    f"round trip is not the identity for {err}: the "
                    f"server emits HTTP {code} with reason {err!r}, "
                    f"the client maps it back to {mapped} — add the "
                    "reason entry (or fix the code table) so the "
                    "caller gets the exception the server raised",
                )
            elif mapped == "APIError" or mapped not in anc:
                yield self.finding(
                    client,
                    reason_node,
                    f"{err} degrades to {mapped} over the wire (HTTP "
                    f"{code}, reason {err!r} unknown to the client) — "
                    "an ad-hoc error class may widen to an ancestor, "
                    "but never sideways or to bare APIError; add a "
                    "reason entry or derive it from the class the "
                    "client should see",
                )

    # -- declared error surface ----------------------------------------------

    def _check_error_surface(self, program) -> Iterator[Finding]:
        if REFERENCE_FILE not in program.sources:
            return
        from odh_kubeflow_tpu_torch.analysis.exceptions import ExceptionAnalysis

        ea = ExceptionAnalysis.of(program)
        hierarchy = ea.hierarchy
        specs = DUCKS + (
            DuckSpec(
                file=REFERENCE_FILE,
                cls=REFERENCE_CLASS,
                role="reference",
                explicit=_ALL_VERBS,
            ),
        )
        for spec in specs:
            if spec.file not in program.sources:
                continue
            for verb in sorted(spec.explicit & set(VERB_RAISES)):
                fn = program.functions.get(f"{spec.file}::{spec.cls}.{verb}")
                if fn is None:
                    continue
                allowed = (
                    VERB_RAISES[verb]
                    | frozenset(spec.extra_raises.get(verb, frozenset()))
                    | {"APIError"}
                )
                res = ea.result_for(fn.qual)
                seen: set[str] = set()
                for err, site, _can, esc in res.sites:
                    if not esc or err not in hierarchy or err in seen:
                        continue
                    seen.add(err)
                    if ea.catches(allowed, err):
                        continue
                    yield self.finding(
                        fn.src,
                        fn.node,
                        f"{spec.cls}.{verb} can raise {err} "
                        f"({render_chain(site.chain)}) which is outside "
                        f"the declared verb model VERB_RAISES[{verb!r}] "
                        "and this duck's declared extras — extend the "
                        "model or the DUCKS declaration so exception-"
                        "flow reasoning stays sound",
                    )
