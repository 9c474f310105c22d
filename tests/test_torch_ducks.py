"""The port's duck-conformance rule (``analysis/ducks.py``) over the
port's ``APIServer`` wrappers, held to the JAX package's.

- The reference protocol extracted from the port's ``machinery/store.py``
  equals the rule's pinned ``DEFAULT_REFERENCE``, and equals JAX's: the
  port's store serves the same verbs with the same signatures.
- The declared duck inventory (replica, chaos wrapper, informer façade,
  HTTP client, fan-out, read split, partition router) is JAX's, and each
  declared class exists in the port.
- The httpapi ↔ client error-mapping round trip is judged the same way
  in both packages (each fixture in its own package's import names).
- The port's tree is clean; drills on a copy of the port re-find a
  deleted auxiliary verb and a blind ``*args/**kwargs`` forward.
"""

import ast
import os
import shutil

import pytest

from odh_kubeflow_tpu.analysis import ducks as jax_ducks
from odh_kubeflow_tpu.analysis import graftlint as jax_graftlint
from odh_kubeflow_tpu_torch.analysis import active_rules
from odh_kubeflow_tpu_torch.analysis import ducks
from odh_kubeflow_tpu_torch.analysis.callgraph import build_program
from odh_kubeflow_tpu_torch.analysis.graftlint import (
    SourceFile,
    package_root,
    run_package,
    run_paths,
    run_program_rules,
)

RULE = "duck-conformance"


def _store_text(root):
    path = os.path.join(root, *ducks.REFERENCE_FILE.split("/"))
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def test_the_ports_store_extracts_to_the_pinned_reference():
    rel = ducks.REFERENCE_FILE
    text = _store_text(package_root())
    program = build_program([SourceFile(rel, rel, text)])
    assert ducks.reference_protocol(program) == ducks.DEFAULT_REFERENCE
    cls = next(n for n in ast.parse(text).body
               if isinstance(n, ast.ClassDef) and n.name == ducks.REFERENCE_CLASS)
    assert {n.name for n in cls.body if isinstance(n, ast.FunctionDef)} >= set(ducks.DEFAULT_REFERENCE)


def test_the_reference_protocol_equals_the_references():
    rel = ducks.REFERENCE_FILE
    port = ducks.reference_protocol(build_program([SourceFile(rel, rel, _store_text(package_root()))]))
    jax_src = jax_graftlint.SourceFile(rel, rel, _store_text(jax_graftlint.package_root()))
    from odh_kubeflow_tpu.analysis.callgraph import build_program as jax_build

    jax = jax_ducks.reference_protocol(jax_build([jax_src]))
    assert {k: str(v) for k, v in port.items()} == {k: str(v) for k, v in jax.items()}


def test_the_duck_inventory_is_the_references():
    def view(mod):
        return [(d.file, d.cls, d.role, sorted(d.explicit), sorted(d.aux), d.delegated_ok,
                 {k: sorted(v) for k, v in d.allow_missing.items()},
                 {k: sorted(v) for k, v in d.extra_raises.items()})
                for d in mod.DUCKS]

    assert view(ducks) == view(jax_ducks)
    sources = {s.rel: s for s in (SourceFile(p, r, t) for p, r, t in _port_sources())}
    for d in ducks.DUCKS:
        assert any(isinstance(n, ast.ClassDef) and n.name == d.cls
                   for n in sources[d.file].tree.body), (d.file, d.cls)


def _port_sources():
    root = package_root()
    for d in {d.file for d in ducks.DUCKS}:
        path = os.path.join(root, *d.split("/"))
        with open(path, encoding="utf-8") as fh:
            yield path, d, fh.read()


_STORE_FIXTURE = (
    "class APIError(Exception):\n    pass\n"
    "class Conflict(APIError):\n    pass\n"
    "class NotFound(APIError):\n    pass\n"
)
ROUND_TRIP_CLIENTS = {
    "missing-reason": ("from PKG.machinery.store import Conflict\n"
                       "_ERR_BY_CODE = {409: Conflict}\n"
                       "_REASON_TO_ERR = {'Conflict': Conflict}\n"),
    "class-mismatch": ("from PKG.machinery.store import Conflict, NotFound\n"
                       "_ERR_BY_CODE = {409: Conflict, 404: NotFound}\n"
                       "_REASON_TO_ERR = {'Conflict': NotFound, 'NotFound': NotFound}\n"),
    "identity": ("from PKG.machinery.store import Conflict, NotFound\n"
                 "_ERR_BY_CODE = {409: Conflict, 404: NotFound}\n"
                 "_REASON_TO_ERR = {'Conflict': Conflict, 'NotFound': NotFound}\n"),
}


def _round_trip(package, lint, client):
    httpapi = (f"from {package}.machinery.store import Conflict, NotFound\n"
               "_STATUS = {\n    Conflict: 409,\n    NotFound: 404,\n}\n")
    sources = [lint.SourceFile(r, r, t) for r, t in (
        (ducks.REFERENCE_FILE, _STORE_FIXTURE), (ducks.HTTPAPI_FILE, httpapi),
        (ducks.CLIENT_FILE, client.replace("PKG", package)))]
    found = lint.run_program_rules(sources, lint.active_rules([RULE]))
    return [(f.rule, f.path, f.line, f.message) for f in found]


@pytest.mark.parametrize("case", sorted(ROUND_TRIP_CLIENTS))
def test_round_trip_judged_like_the_reference(case):
    from odh_kubeflow_tpu_torch.analysis import graftlint as port_graftlint

    port = _round_trip("odh_kubeflow_tpu_torch", port_graftlint, ROUND_TRIP_CLIENTS[case])
    jax = _round_trip("odh_kubeflow_tpu", jax_graftlint, ROUND_TRIP_CLIENTS[case])
    assert port == jax
    if case == "identity":
        assert not any("round trip" in m for *_, m in port)
    else:
        assert port


def test_the_ports_tree_is_duck_clean():
    assert run_package(select=[RULE]) == []
    assert RULE in {r.id for r in active_rules()}


@pytest.fixture(scope="module")
def broken_findings(tmp_path_factory):
    root = tmp_path_factory.mktemp("ducks") / "odh_kubeflow_tpu_torch"
    shutil.copytree(package_root(), root,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc", "*.cu", "*.cpp"))

    def edit(rel, old, new):
        p = root / rel
        text = p.read_text()
        assert old in text, f"{rel}: expected fragment not found"
        p.write_text(text.replace(old, new))

    edit("machinery/faults.py",
         "    def applied_rv(self) -> Optional[int]:\n        return self.api.applied_rv()\n", "")
    edit("machinery/replica.py",
         "    def get(self, kind: str, name: str, namespace: Optional[str] = None) -> Obj:\n"
         "        from odh_kubeflow_tpu_torch.machinery.store import NotFound\n"
         "\n"
         "        try:\n"
         "            return self.read_api.get(kind, name, namespace)\n"
         "        except NotFound:\n"
         "            return self.write_api.get(kind, name, namespace)\n",
         "    def get(self, *args, **kwargs):\n"
         "        return self.read_api.get(*args, **kwargs)\n")
    return run_paths([str(root)], [RULE])


def test_drill_deleted_aux_surface_refound(broken_findings):
    hits = [f for f in broken_findings
            if f.path == "machinery/faults.py" and "no explicit `applied_rv`" in f.message]
    assert hits and "auxiliary surface" in hits[0].message


def test_drill_blind_forward_refound(broken_findings):
    hits = [f for f in broken_findings
            if f.path == "machinery/replica.py" and "ReadSplitAPI.get" in f.message
            and "blind *args/**kwargs" in f.message]
    assert hits and "APIServer.get" in hits[0].message
