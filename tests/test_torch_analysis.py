"""The port's graftlint (``analysis/graftlint.py``, ``rules.py``,
``callgraph.py``) and its runtime lock sanitizer
(``analysis/sanitizer.py``), held to the JAX package's.

- **Lint parity.** Every fixture snippet the JAX package's own lint
  tests feed to ``lint_source`` (``tests/test_{analysis,exceptions,
  ducks,protocol}.py``, harvested from their source with ``ast``) goes
  through JAX's ``lint_source`` and the port's; for each rule the
  findings must be identical in rule, path, line, span, severity and
  message, with the package name normalized. The protocol rule reads
  its registry, which differs by design (GPU keys against TPU keys), so
  for the parity run the port's rule reads JAX's registry.
- **The port's tree is lint-clean** against its committed baseline
  (which is empty), through the API and the CLI, and the whole-program
  rules resolve the port's own ``odh_kubeflow_tpu_torch.*`` imports.
- **Sanitizer**: lock-order inversion, re-entry, blocking under a lock,
  the rate limiter's guard, each on the port; the same inversion and
  the same sleep under a lock give the same report shapes on both
  packages; the port's control plane builds the reference's named locks
  at the reference's sites; ``/debug/locks`` serves the live graph.
"""

import ast
import collections
import importlib
import json
import os
import re
import textwrap
import threading
import time

import pytest

from odh_kubeflow_tpu_torch.analysis import (
    active_rules,
    graftlint,
    lint_source,
    main,
    run_package,
    sanitizer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_FILES = (
    "tests/test_analysis.py",
    "tests/test_exceptions.py",
    "tests/test_ducks.py",
    "tests/test_protocol.py",
)


# ---------------------------------------------------------------------------
# the JAX package's lint fixtures, harvested from its test sources


def _literal(node, env):
    """The value of a fixture expression built from literals: string
    constants (implicit concatenation included), names bound to them,
    ``+`` of two such values, ``textwrap.dedent`` and literal lists."""
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Call) and node.args:
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        if name == "dedent":
            v = _literal(node.args[0], env)
            return textwrap.dedent(v) if isinstance(v, str) else None
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _literal(node.left, env), _literal(node.right, env)
        if isinstance(a, str) and isinstance(b, str):
            return a + b
        return None
    if isinstance(node, (ast.List, ast.Tuple)):
        vals = [_literal(e, env) for e in node.elts]
        return None if any(v is None for v in vals) else vals
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        return None


def _assign_target(n):
    if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
        return n.targets[0].id
    return None


def harvest_fixtures() -> list[tuple[str, str, str, str, tuple]]:
    """(test file, test name, source text, package-relative path,
    selected rules) for every ``lint_source`` call of the JAX lint tests
    whose arguments are literal — in source order, deduplicated."""
    out, seen = [], set()
    for rel in FIXTURE_FILES:
        with open(os.path.join(ROOT, rel), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        menv = {}
        for n in tree.body:
            name = _assign_target(n)
            if name is not None:
                v = _literal(n.value, menv)
                if v is not None:
                    menv[name] = v
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            env = dict(menv)
            nodes = sorted(
                (n for n in ast.walk(fn) if isinstance(n, (ast.Assign, ast.Call))),
                key=lambda n: (n.lineno, n.col_offset),
            )
            for n in nodes:
                name = _assign_target(n)
                if name is not None:
                    v = _literal(n.value, env)
                    if v is None:
                        env.pop(name, None)
                    else:
                        env[name] = v
                elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                      and n.func.id == "lint_source"):
                    args = [_literal(a, env) for a in n.args]
                    kw = {k.arg: _literal(k.value, env) for k in n.keywords}
                    if len(args) < 2 or not all(isinstance(a, str) for a in args[:2]):
                        continue
                    sel = args[2] if len(args) > 2 else kw.get("select")
                    key = (args[0], args[1], tuple(sel) if sel else None)
                    if key not in seen:
                        seen.add(key)
                        out.append((rel, fn.name, *key))
    return out


FIXTURES = harvest_fixtures()
_PKG_RE = re.compile(r"odh_kubeflow_tpu(_torch)?\b")


def _norm(findings) -> list[tuple]:
    return [
        (f.rule, f.path, f.line, f.end_line, f.severity, _PKG_RE.sub("<pkg>", f.message))
        for f in findings
    ]


@pytest.fixture(scope="module")
def fixture_findings():
    """Both packages' findings for every harvested fixture (the port's
    protocol rule pointed at JAX's registry for the comparison)."""
    from odh_kubeflow_tpu.analysis import lint_source as jax_lint_source
    from odh_kubeflow_tpu.analysis import protocol as jax_protocol
    from odh_kubeflow_tpu_torch.analysis import protocol as port_protocol

    real = port_protocol.registry_path
    port_protocol.registry_path = jax_protocol.registry_path
    try:
        out = []
        for rel, test, text, path, sel in FIXTURES:
            out.append((
                f"{rel}::{test}",
                _norm(jax_lint_source(text, path, sel)),
                _norm(lint_source(text, path, sel)),
            ))
    finally:
        port_protocol.registry_path = real
    return out


def test_fixtures_are_harvested_from_every_jax_lint_test_file():
    per_file = collections.Counter(rel for rel, *_ in FIXTURES)
    assert set(per_file) == set(FIXTURE_FILES), per_file
    assert len(FIXTURES) >= 120, len(FIXTURES)


RULE_IDS = sorted(r.id for r in active_rules())


@pytest.mark.parametrize("rule", RULE_IDS)
def test_lint_parity_per_rule(rule, fixture_findings):
    fired = 0
    for where, jax_f, port_f in fixture_findings:
        jax_r = [f for f in jax_f if f[0] == rule]
        port_r = [f for f in port_f if f[0] == rule]
        assert port_r == jax_r, where
        fired += len(jax_r)
    # the rule is exercised: some fixture makes it fire in both packages
    assert fired > 0, f"no JAX fixture makes {rule} fire"


def test_rule_catalog_equals_the_references():
    from odh_kubeflow_tpu.analysis import active_rules as jax_rules

    def catalog(rules):
        return sorted(
            (r.id, r.description, tuple(r.dirs or ()), tuple(r.files or ()), r.whole_program)
            for r in rules()
        )

    assert catalog(active_rules) == catalog(jax_rules)


# ---------------------------------------------------------------------------
# framework on the port (suppression, scoping, CLI)


def test_line_and_file_suppression():
    src = 'def f(api):\n    return api.list("Pod")  # graftlint: disable=uncached-list cold path\n'
    assert lint_source(src, "controllers/x.py") == []
    src = 'def f(api):\n    return api.list("Pod")  # graftlint: disable=metric-naming\n'
    assert [f.rule for f in lint_source(src, "controllers/x.py")] == ["uncached-list"]
    src = ("# graftlint: disable-file=uncached-list generated fixture\n"
           'def f(api):\n    return api.list("Pod")\n')
    assert lint_source(src, "controllers/x.py") == []


def test_cli_exit_codes_and_json_format(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text('m = registry.counter("bad_name", "no _total suffix")\n')
    assert main([str(bad)]) == 1
    assert "metric-naming" in capsys.readouterr().out
    assert main(["--format", "json", str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [d["rule"] for d in doc] == ["metric-naming"]
    clean = tmp_path / "clean.py"
    clean.write_text('m = registry.counter("good_total", "fine")\n')
    assert main([str(clean)]) == 0


def test_cli_baseline_absorbs_only_known_findings(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text('m = registry.counter("bad_name", "x")\n')
    base = tmp_path / "baseline.json"
    assert main(["--write-baseline", "--baseline", str(base), str(bad)]) == 0
    assert main(["--baseline", str(base), str(bad)]) == 0
    bad.write_text('m = registry.counter("bad_name", "x")\nn = registry.counter("worse", "y")\n')
    assert main(["--baseline", str(base), str(bad)]) == 1
    assert "worse" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the port's tree


def test_committed_baseline_is_empty():
    path = graftlint.default_baseline_path()
    assert os.path.dirname(path).endswith(os.path.join("odh_kubeflow_tpu_torch", "analysis"))
    assert graftlint.load_baseline(path) == []


def test_the_ports_tree_is_lint_clean():
    findings = run_package()
    findings, absorbed = graftlint.apply_baseline(
        findings, graftlint.load_baseline(graftlint.default_baseline_path())
    )
    assert findings == [], "\n".join(f.render() for f in findings)
    assert absorbed == 0


def test_the_lint_runs_over_the_port_not_the_reference():
    assert graftlint.PACKAGE == "odh_kubeflow_tpu_torch"
    assert os.path.basename(graftlint.package_root()) == "odh_kubeflow_tpu_torch"
    rels = {s.rel for s in graftlint.iter_sources()}
    assert "machinery/partition.py" in rels and "analysis/sanitizer.py" in rels
    assert not any(r.startswith("odh_kubeflow_tpu") for r in rels)


def test_whole_program_rules_resolve_the_ports_imports():
    """A chain that crosses modules through an ``odh_kubeflow_tpu_torch.*``
    import is followed: a store lock held around a call into another
    module that fsyncs is reported with the callee in its witness chain.
    The same program importing by the JAX package's name is not resolved
    (the rules resolve imports by the port's own package name)."""
    from odh_kubeflow_tpu_torch.analysis import graftlint as g

    def run(package):
        helper = g.SourceFile("machinery/helper.py", "machinery/helper.py",
                              "import os\n\ndef pause():\n    os.fsync(3)\n")
        caller = g.SourceFile(
            "machinery/store.py", "machinery/store.py",
            f"from {package}.machinery.helper import pause\n\n"
            "class C:\n"
            "    def run(self):\n"
            "        with self._lock:\n"
            "            pause()\n",
        )
        return g.run_program_rules([helper, caller],
                                   g.active_rules(["blocking-reachable-under-lock"]))

    found = run("odh_kubeflow_tpu_torch")
    assert len(found) == 1 and found[0].path == "machinery/store.py", found
    assert "pause (helper.py:4)" in found[0].message and "os.fsync" in found[0].message
    assert run("odh_kubeflow_tpu") == []


# ---------------------------------------------------------------------------
# runtime sanitizer on the port


@pytest.fixture
def san():
    was_enabled = sanitizer.enabled()
    sanitizer.enable()
    sanitizer.reset()
    yield sanitizer
    sanitizer.reset()
    if not was_enabled:
        sanitizer.disable()


def test_lock_order_inversion_detected(san):
    a, b = san.new_lock("A"), san.new_lock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    reports = san.reports()
    assert len(reports) == 1 and "lock-order inversion" in reports[0]
    assert "'A'" in reports[0] and "'B'" in reports[0]


def test_consistent_and_transitive_orders(san):
    a, b, c = san.new_lock("A"), san.new_lock("B"), san.new_lock("C")
    for _ in range(3):
        with a:
            with b:
                pass
    assert san.reports() == []
    with b:
        with c:
            pass
    with c:
        with a:  # closes A→B→C
            pass
    assert any("lock-order inversion" in r for r in san.reports())


def test_reentry_raises_on_a_lock_and_is_legal_on_an_rlock(san):
    lock = san.new_lock("L")
    with lock:
        with pytest.raises(san.SanitizerError):
            lock.acquire()
    assert any("re-entry" in r for r in san.reports())
    san.reset()
    rlock = san.new_rlock("R")
    with rlock:
        with rlock:
            pass
    assert san.reports() == []


def test_sleep_under_lock_and_condition_wait(san):
    with san.new_lock("S"):
        time.sleep(0)
    assert len(san.reports()) == 1 and "blocking-under-lock" in san.reports()[0]
    time.sleep(0)
    assert len(san.reports()) == 1
    san.reset()
    cv = threading.Condition(san.new_lock("cv-lock"))
    with cv:
        cv.wait(timeout=0.01)  # releases the lock while blocked
    assert san.reports() == []


def test_watch_get_under_the_ports_store_lock_reported(san):
    from odh_kubeflow_tpu_torch.machinery.store import APIServer

    api = APIServer()
    assert isinstance(api._lock, san.SanitizedLock)
    w = api.watch("Pod", send_initial=False)
    with api._lock:
        w.get(timeout=0.01)
    assert any("Watch.get" in r for r in san.reports())
    san.reset()
    w.get(timeout=0.01)
    assert san.reports() == []
    w.stop()


def test_the_ports_rate_limiter_regression_guard(san):
    from odh_kubeflow_tpu_torch.controllers.runtime import Controller, Result, _RateLimiter
    from odh_kubeflow_tpu_torch.machinery.store import APIServer

    api = APIServer()
    clock = [0.0]
    calls = {"n": 0}

    def flaky(req):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return Result()

    ctrl = Controller("probe", api, flaky, "ConfigMap", time_fn=lambda: clock[0])
    assert isinstance(ctrl._limiter._lock, san.SanitizedLock)
    api.create({"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": "a", "namespace": "default"}})
    for _ in range(6):
        ctrl.drain_once()
        clock[0] += 1.0
    assert calls["n"] == 3
    assert not any("ratelimiter" in r for r in san.reports()), san.reports()
    l1, l2 = _RateLimiter(), _RateLimiter()
    with l1._lock:
        with l2._lock:  # two instances sharing a name: no false re-entry
            pass
    assert san.reports() == []
    with l1._lock:
        time.sleep(0)  # the old bug shape
    assert any("blocking-under-lock" in r and "ratelimiter" in r for r in san.reports())


def test_factories_return_raw_primitives_when_disabled():
    was = sanitizer.enabled()
    sanitizer.disable()
    try:
        assert type(sanitizer.new_lock("x")) is type(threading.Lock())
        assert type(sanitizer.new_rlock("y")) is type(threading.RLock())
    finally:
        if was:
            sanitizer.enable()


# ---------------------------------------------------------------------------
# sanitizer parity and the port's hook sites


def _report_shape(report: str) -> str:
    """A report with its acquisition sites (``file.py:NN``) blanked:
    the two packages' witness lines differ only by their file layout."""
    return re.sub(r"[\w.]+\.py:\d+", "<site>", report)


def _violations(san_mod):
    was = san_mod.enabled()
    san_mod.enable()
    san_mod.reset()
    try:
        a, b = san_mod.new_lock("apiserver.store"), san_mod.new_lock("wal.io")
        with a:
            with b:
                pass
        with b:
            with a:  # the inversion
                pass
        with san_mod.new_lock("controller.ratelimiter"):
            time.sleep(0)  # the sleep under a lock
        return [_report_shape(r) for r in san_mod.reports()], sorted(san_mod.order_graph())
    finally:
        san_mod.reset()
        if not was:
            san_mod.disable()


def test_same_violations_give_the_same_report_shapes_in_both_packages():
    from odh_kubeflow_tpu.analysis import sanitizer as jax_sanitizer

    jax_reports, jax_graph = _violations(jax_sanitizer)
    port_reports, port_graph = _violations(sanitizer)
    assert port_reports == jax_reports
    assert [r.split(":")[0] for r in port_reports] == ["lock-order inversion", "blocking-under-lock"]
    assert port_graph == jax_graph == ["apiserver.store", "wal.io"]


def _named_locks(pkg_root: str, tmp_path) -> list[tuple]:
    """Every factory lock the control plane's constructors build, by
    (name, reentrant, allow_blocking), recorded through the factory
    hook (which declines, so the real primitive is still built)."""
    san_mod = importlib.import_module(f"{pkg_root}.analysis.sanitizer")
    store = importlib.import_module(f"{pkg_root}.machinery.store")
    wal = importlib.import_module(f"{pkg_root}.machinery.wal")
    cache = importlib.import_module(f"{pkg_root}.machinery.cache")
    client = importlib.import_module(f"{pkg_root}.machinery.client")
    runtime = importlib.import_module(f"{pkg_root}.controllers.runtime")
    seen = []
    san_mod.set_factory_hook(lambda name, re_, ab: seen.append((name, re_, ab)))
    try:
        w = wal.WriteAheadLog(str(tmp_path / pkg_root))
        api = store.APIServer(wal=w)
        inf = cache.InformerCache(api, kinds=("ConfigMap",))
        cache.SerializedBytesCache()
        remote = client.RemoteAPIServer("http://127.0.0.1:9")
        client.ReplicaFanout([remote])
        runtime.Controller("probe", api, lambda req: None, "ConfigMap")
    finally:
        san_mod.set_factory_hook(None)
    api.close()
    w.close()
    del inf
    return sorted(set(seen))


def test_the_ports_control_plane_builds_the_references_named_locks(tmp_path):
    jax_locks = _named_locks("odh_kubeflow_tpu", tmp_path)
    port_locks = _named_locks("odh_kubeflow_tpu_torch", tmp_path)
    assert port_locks == jax_locks
    assert {n for n, _, _ in port_locks} >= {
        "apiserver.store", "wal.io", "wal.snapshot", "informer.cache", "informer.heal",
        "informer.metrics-flush", "serialized-bytes-cache", "remote-client",
        "replica-fanout", "controller.ratelimiter", "workqueue.probe",
    }


def test_debug_locks_serves_the_live_graph_like_the_reference(san):
    from odh_kubeflow_tpu.analysis import sanitizer as jax_sanitizer
    from odh_kubeflow_tpu.machinery import zpages as jax_zpages
    from odh_kubeflow_tpu_torch.machinery import zpages

    was = jax_sanitizer.enabled()
    jax_sanitizer.enable()
    jax_sanitizer.reset()
    try:
        pages = {}
        for name, san_mod, zp in (("jax", jax_sanitizer, jax_zpages), ("torch", san, zpages)):
            outer, inner = san_mod.new_lock("apiserver.store"), san_mod.new_lock("wal.io")
            with outer:
                with inner:
                    pass
            data = zp.locks_json()
            pages[name] = (data["enabled"], sorted(data["orderGraph"]), data["reports"],
                           _report_shape(zp.locks_text()))
        assert pages["torch"] == pages["jax"]
        assert pages["torch"][:3] == (True, ["apiserver.store"], [])
        assert "apiserver.store -> wal.io" in zpages.locks_text()
    finally:
        jax_sanitizer.reset()
        if not was:
            jax_sanitizer.disable()
