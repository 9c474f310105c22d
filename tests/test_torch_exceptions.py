"""The port's exception-flow analysis (``analysis/exceptions.py``: the
``error-contract``, ``handler-masks-fencing`` and ``dead-except``
rules) over the port's own tree, and the ``UsageMeter`` stand-down it
found, held to the JAX package's.

- **Stand-down.** A meter whose store answers ``FencedOut`` (a deposed
  leader) on ``create``, ``patch`` or ``delete`` raises it out of
  ``flush`` in both packages, and its loop stops. Before the repair the
  port's meter swallowed it (``except APIError``) and kept writing.
- **Raise-set parity.** The interprocedural raise sets inferred for the
  store's verbs are the same in both packages.
- **Drills.** The port's fixes, reverted textually in a copy of the
  port, are re-found with their witness chains: the usage meter's
  stand-down, the runtime's fencing stand-down, the reconcile helper's
  Conflict retry and the client's retry policy.
"""

import importlib
import json
import shutil
import time
import types

import pytest


EXC_RULES = ["error-contract", "handler-masks-fencing", "dead-except"]
ROOTS = {"jax": "odh_kubeflow_tpu", "torch": "odh_kubeflow_tpu_torch"}
T0 = 1_000_200.0  # on the 300 s window grid


def pkg(name):
    mods = {m: importlib.import_module(f"{ROOTS[name]}.{m}") for m in (
        "machinery.store", "machinery.usage", "scheduling", "utils.prometheus")}
    return types.SimpleNamespace(
        name=name, store=mods["machinery.store"], usage=mods["machinery.usage"],
        scheduling=mods["scheduling"], prom=mods["utils.prometheus"])


# ---------------------------------------------------------------------------
# the UsageMeter stand-down


class _Deposed:
    """A store whose chosen verbs answer ``FencedOut`` — the view a
    meter gets after another replica took the leadership epoch."""

    def __init__(self, api, store_mod):
        self.api = api
        self.store = store_mod
        self.fenced: set[str] = set()

    def _call(self, verb, *args, **kwargs):
        if verb in self.fenced:
            raise self.store.FencedOut(f"{verb}: fencing token from a deposed epoch")
        return getattr(self.api, verb)(*args, **kwargs)

    def create(self, *a, **kw):
        return self._call("create", *a, **kw)

    def patch(self, *a, **kw):
        return self._call("patch", *a, **kw)

    def delete(self, *a, **kw):
        return self._call("delete", *a, **kw)

    def __getattr__(self, name):
        return getattr(self.api, name)


def _workload(p):
    if p.name == "torch":
        spec = {"nodes": 1, "gpusPerNode": 4, "acceleratorType": "nvidia-l4"}
    else:
        spec = {"hosts": 1, "chipsPerHost": 4, "acceleratorType": "tpu-v5-lite-podslice",
                "topology": "2x2"}
    return {"apiVersion": "scheduling.kubeflow.org/v1alpha1", "kind": "Workload",
            "metadata": {"name": "nb1", "namespace": "team-a"}, "spec": spec,
            "status": {"state": "Admitted",
                       "admittedAt": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(T0)),
                       "assignment": {"pool": "pool-a", "zone": "zone-a"}}}


def _meter(p, clock, retention=None):
    api = p.store.APIServer()
    p.scheduling.register_scheduling(api)
    p.usage.register_usage(api)
    deposed = _Deposed(api, p.store)
    cfg = p.usage.UsageConfig(enabled=True, sample_seconds=15.0, window_seconds=300.0)
    if retention is not None:
        cfg.retention_seconds = retention
    meter = p.usage.UsageMeter(deposed, cfg, registry=p.prom.Registry(),
                               time_fn=lambda: clock["t"], sample_fn=lambda ns, nb: None)
    meter.workload_admitted(_workload(p), t=T0)
    return deposed, meter


def _flush_outcome(p, verb):
    """What ``flush`` does when ``verb`` is fenced: the exception's class
    name, or ``"returned <n>"``."""
    clock = {"t": T0 + 60.0}
    retention = 600.0 if verb == "delete" else None
    deposed, meter = _meter(p, clock, retention)
    if verb in ("patch", "delete"):
        assert meter.flush() >= 1  # the record exists before the epoch is lost
        clock["t"] += 120.0 if verb == "patch" else 2000.0
    deposed.fenced.add(verb)
    try:
        n = meter.flush()
    except p.store.APIError as e:
        return type(e).__name__
    return f"returned {n}"


@pytest.mark.parametrize("verb", ["create", "patch", "delete"])
def test_a_deposed_meter_raises_fenced_out_from_flush_on_both(verb):
    outcomes = {name: _flush_outcome(pkg(name), verb) for name in ROOTS}
    assert outcomes == {"jax": "FencedOut", "torch": "FencedOut"}, outcomes


def test_a_deposed_meter_loop_stands_down_on_both():
    for name in ROOTS:
        p = pkg(name)
        clock = {"t": T0 + 60.0}
        deposed, meter = _meter(p, clock)
        deposed.fenced.add("create")
        meter.start(interval=0.005)
        try:
            deadline = time.monotonic() + 5.0
            while not meter._stop.is_set() and time.monotonic() < deadline:
                time.sleep(0.005)
            assert meter._stop.is_set(), f"{name}: the deposed meter kept metering"
        finally:
            meter.stop()
        assert meter.m_flush_errors.value() == 0, name  # a stand-down, not a failure


def test_an_ordinary_api_error_still_counts_as_a_failed_write():
    """Only the fencing errors stand down: any other APIError leaves the
    bucket dirty for the next flush, as before."""
    p = pkg("torch")
    clock = {"t": T0 + 60.0}
    deposed, meter = _meter(p, clock)

    def refuse(*a, **kw):
        raise p.store.APIError("transient")

    deposed.create = refuse
    assert meter.flush() == 0
    deposed.create = deposed.api.create
    assert meter.flush() == 1


# ---------------------------------------------------------------------------
# raise-set parity on the store's verbs


def _verb_raise_sets(root):
    g = importlib.import_module(f"{root}.analysis.graftlint")
    cg = importlib.import_module(f"{root}.analysis.callgraph")
    exc = importlib.import_module(f"{root}.analysis.exceptions")
    sources = list(g.iter_sources())
    analysis = exc.ExceptionAnalysis.of(cg.build_program(sources))
    out = {}
    for verb in ("create", "get", "update", "update_status", "patch", "delete", "list"):
        res = analysis.result_for(f"machinery/store.py::APIServer.{verb}")
        out[verb] = sorted({row[0] for row in res.sites})
    return out


def test_store_verb_raise_sets_equal_the_references():
    jax_sets = _verb_raise_sets("odh_kubeflow_tpu")
    port_sets = _verb_raise_sets("odh_kubeflow_tpu_torch")
    assert port_sets == jax_sets
    assert "Conflict" in port_sets["update"] and "NotFound" in port_sets["get"]


# ---------------------------------------------------------------------------
# drills: revert the port's fixes in a copy, the rules must re-find them


def _lint():
    """The port's lint (imported here, so the stand-down tests above
    run on a tree that has no lint)."""
    return importlib.import_module("odh_kubeflow_tpu_torch.analysis.graftlint")


@pytest.fixture(scope="module")
def reverted_tree(tmp_path_factory):
    graftlint = _lint()
    root = tmp_path_factory.mktemp("reverted") / "odh_kubeflow_tpu_torch"
    shutil.copytree(graftlint.package_root(), root,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc", "*.cu", "*.cpp"))

    def edit(rel, old, new):
        p = root / rel
        text = p.read_text()
        assert old in text, f"{rel}: expected fragment not found"
        p.write_text(text.replace(old, new))

    # (1) the usage meter swallows fencing again
    edit("machinery/usage.py",
         "        except (FencedOut, NotLeader):\n"
         "            # deposed leader: the new incumbent's meter owns the ledger\n"
         "            # now — stand down instead of fighting its writes\n"
         "            raise\n",
         "")
    # (2) the runtime's fencing stand-down re-broadened
    edit("controllers/runtime.py", "except (FencedOut, NotLeader) as e:",
         "except (KeyError, IndexError) as e:")
    # (3) the reconcile helper calls the attempt without its Conflict retry
    edit("controllers/reconcilehelper.py",
         "return backoff.retry(\n"
         "        lambda: _reconcile_attempt(api, desired, copier),\n"
         "        retryable=Conflict,\n"
         "        attempts=4,\n"
         "        base=0.01,\n"
         "        cap=0.5,\n"
         "    )",
         "return _reconcile_attempt(api, desired, copier)")
    # (4) the client's retry policy deleted
    edit("machinery/client.py",
         "return backoff.retry(\n"
         "            lambda: self._do_request(method, path, body, query),\n"
         "            retryable=lambda e: self._retry_reason(method, e) is not None,\n"
         "            attempts=self.retries,\n"
         "            base=self.retry_base,\n"
         "            cap=self.retry_cap,\n"
         "            sleep_fn=self._sleep,\n"
         "            on_retry=on_retry,\n"
         "            budget=self._budget,\n"
         "        )",
         "return self._do_request(method, path, body, query)")
    return root


@pytest.fixture(scope="module")
def reverted_findings(reverted_tree):
    return _lint().run_paths([str(reverted_tree)], EXC_RULES)


def test_drill_swallowing_meter_refound(reverted_findings):
    hits = [f for f in reverted_findings
            if f.rule == "handler-masks-fencing" and f.path == "machinery/usage.py"]
    assert hits, "the usage meter's swallowed FencedOut was not re-found"
    assert any("UsageMeter._upsert_record" in f.message and "FencedOut" in f.message
               for f in hits)


def test_drill_rebroadened_runtime_handler_refound(reverted_findings):
    hits = [f for f in reverted_findings
            if f.rule == "handler-masks-fencing" and f.path == "controllers/runtime.py"]
    assert any("broad handler absorbs FencedOut" in f.message
               and "Controller._process" in f.message for f in hits), hits


def test_drill_reverted_retry_site_refound_with_chain(reverted_findings):
    hits = [f for f in reverted_findings
            if f.rule == "error-contract" and "retryable Conflict" in f.message]
    assert hits, "reverted reconcile helper retry not re-found"
    msg = next(f.message for f in hits if f.path == "controllers/notebook.py")
    for part in ("NotebookController.reconcile", "reconcile_object", "_reconcile_attempt",
                 "api.update() can raise Conflict"):
        assert part in msg, msg


def test_drill_reverted_client_policy_reports_anchor_and_escapes(reverted_findings):
    anchor = [f for f in reverted_findings
              if f.rule == "error-contract" and f.path == "machinery/client.py"]
    assert anchor and "retry-policy anchor" in anchor[0].message
    escapes = [f for f in reverted_findings if "retryable TooManyRequests" in f.message]
    assert any("reconcile" in f.message and "can raise TooManyRequests" in f.message
               for f in escapes)


def test_drill_findings_stable_under_json(reverted_tree, capsys):
    lint_main = _lint().main
    argv = ["--select", ",".join(EXC_RULES), "--format=json", str(reverted_tree)]
    assert lint_main(argv) == 1
    first = capsys.readouterr().out
    assert lint_main(argv) == 1
    assert capsys.readouterr().out == first
    assert json.loads(first)


def test_the_ports_tree_has_no_exception_findings():
    graftlint = _lint()
    assert graftlint.run_paths([graftlint.package_root()], EXC_RULES) == []
