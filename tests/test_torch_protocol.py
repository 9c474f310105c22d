"""The port's metadata-protocol lint (``analysis/protocol.py`` with the
port's own ``analysis/protocol.json``), held to the JAX package's.

- The scanner classifies every metadata touch the same way in both
  packages (key recognition, reads and writes, markers).
- The port's registry carries the port's keys: the GPU resource keys
  and annotations (``nvidia.com/gpu``, ``notebooks.kubeflow.org/
  gpu-count``, …) where JAX's carries the TPU ones, each the image of
  a JAX key through ``apis.ACCELERATOR_MAPPING`` with the same type and
  carrier; every key the two platforms share keeps JAX's type, carrier
  and external note.
- Its rendered appendix sits in the port's guide beside the knob
  table; the live tree has no violation, through the API, the rule and
  the CLI; drills on a copy of the port re-find a dropped marker, a
  reverted uid fence and an unregistered key.
"""

import os
import shutil
import subprocess
import sys

import pytest

from odh_kubeflow_tpu.analysis import protocol as jax_protocol
from odh_kubeflow_tpu_torch.analysis import protocol
from odh_kubeflow_tpu_torch.analysis.graftlint import (
    SourceFile,
    package_root,
    run_package,
    run_paths,
)
from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULE = "protocol-drift"

KEY_CASES = [
    "notebooks.kubeflow.org/last-activity", "nvidia.com/gpu", "app.kubernetes.io/part-of",
    "kubeflow.org/v1beta1", "rbac.authorization.k8s.io/v1", "application/json", "a/b",
    "kubeflow-resource-stopped", "notebooks.kubeflow.org/gpu-count",
]

SCAN_FIXTURES = {
    "subscript": "def f(ann):\n    ann['example.com/k'] = 1\n    return ann.get('example.com/r')\n",
    "suffix-constant": ("OWNER_ANNOTATION = 'owner'\n"
                        "def f(meta):\n    meta['annotations'][OWNER_ANNOTATION] = 'x'\n"),
    "fstring": "GROUP = 'kubeflow.org'\ndef f(m):\n    return m.get(f'{GROUP}/workload')\n",
    "selector": "def f(api):\n    return api.list('Pod', label_selector={'example.com/sel': 'x'})\n",
    "dict-literal": "def f():\n    return {'metadata': {'labels': {'example.com/l': 'v'}}}\n",
    "marker": ("def f(ann):\n"
               "    # protocol-ok: external reader\n"
               "    ann['example.com/ext'] = 1\n"),
}


def _scan_view(mod, text):
    src = SourceFile("controllers/x.py", "controllers/x.py", text)
    scan = mod.scan_sources([src], frozenset())
    return {k: sorted((s.rel, s.line, s.access, s.marked) for s in v)
            for k, v in scan.keys.items()}


def test_key_recognition_equals_the_references():
    for key in KEY_CASES:
        assert protocol.is_protocol_key(key) == jax_protocol.is_protocol_key(key), key


@pytest.mark.parametrize("case", sorted(SCAN_FIXTURES))
def test_scanner_equals_the_references(case):
    got = _scan_view(protocol, SCAN_FIXTURES[case])
    assert got == _scan_view(jax_protocol, SCAN_FIXTURES[case])
    assert got  # every fixture touches a key


def test_the_ports_registry_is_wellformed_and_carries_gpu_keys():
    reg = protocol.load_registry()
    keys = [e["key"] for e in reg["keys"]]
    assert len(keys) == len(set(keys)) and len(keys) >= 45
    for e in reg["keys"]:
        assert e.get("type") in ("annotation", "label", "resource"), e["key"]
        for field in ("rides_on", "description", "writers", "readers"):
            assert field in e, f"{e['key']} missing {field}"
        assert e["writers"] == sorted(e["writers"]) and e["readers"] == sorted(e["readers"])
    assert {"nvidia.com/gpu", "requests.nvidia.com/gpu", "notebooks.kubeflow.org/gpu-accelerator",
            "notebooks.kubeflow.org/gpu-count", "cloud.google.com/gke-accelerator",
            "cloud.google.com/gke-accelerator-count", "gpu-runtime"} <= set(keys)
    assert not [k for k in keys if "tpu" in k]


def test_the_ports_keys_are_the_references_through_the_mapping():
    jax = {e["key"]: e for e in jax_protocol.load_registry()["keys"]}
    port = {e["key"]: e for e in protocol.load_registry()["keys"]}
    mapped = {ACCELERATOR_MAPPING.get(k, k): k for k in jax}
    assert set(port) == set(mapped)
    for key, e in port.items():
        ref = jax[mapped[key]]
        assert (e["type"], e["rides_on"]) == (ref["type"], ref["rides_on"]), key
        assert bool(e.get("external")) == bool(ref.get("external")), key
        if key == mapped[key] and "external" in ref:
            assert e["external"] == ref["external"], key
    jax_fields = {e["field"]: e["rides_on"] for e in jax_protocol.load_registry()["status_fields"]}
    port_fields = {e["field"]: e["rides_on"] for e in protocol.load_registry()["status_fields"]}
    assert port_fields == jax_fields


def test_the_appendix_sits_beside_the_knob_table():
    from odh_kubeflow_tpu_torch.analysis import knobs

    assert protocol.guide_path() == knobs.guide_path()
    with open(protocol.guide_path(), encoding="utf-8") as fh:
        text = fh.read()
    assert protocol.APPENDIX_HEADING in text
    assert protocol.render_appendix() in text
    assert text.index("## Appendix: knob reference") < text.index(protocol.APPENDIX_HEADING)


def test_the_live_tree_is_clean_through_the_rule_and_the_cli():
    """The CLI runs ``protocol_violations`` (code, registry — writers and
    readers lists included — and the guide's appendix) and exits 0; the
    graftlint rule agrees."""
    assert run_package(select=[RULE]) == []
    out = subprocess.run([sys.executable, "-m", "odh_kubeflow_tpu_torch.analysis.protocol"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "protocol-registry: clean" in out.stderr


@pytest.fixture(scope="module")
def drifted_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("proto") / "odh_kubeflow_tpu_torch"
    shutil.copytree(package_root(), root,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc", "*.cu", "*.cpp"))

    def edit(rel, old, new):
        p = root / rel
        text = p.read_text()
        assert old in text, f"{rel}: expected fragment not found"
        p.write_text(text.replace(old, new))

    edit("scheduling/queue.py", "# protocol-ok: operator-set on the quota",
         "# operator-set on the quota")
    edit("sessions/__init__.py",
         '    want = obj_util.meta(notebook).get("uid", "")\n'
         '    have = obj_util.labels_of(ckpt).get(NOTEBOOK_UID_LABEL, "")\n'
         "    if want and have and want != have:\n"
         "        return None\n"
         "    return ckpt\n",
         "    return ckpt\n")
    pool = root / "warmup" / "pool.py"
    pool.write_text(pool.read_text()
                    + '\n\ndef _drill_stamp(meta):\n    meta["example.test/drill-key"] = "1"\n')
    return root


def test_drills_are_refound_on_the_port(drifted_tree):
    out = protocol.protocol_violations(root=str(drifted_tree))
    key = "scheduling.kubeflow.org/oversubscription-factor"
    assert any(f"metadata key {key!r} is marked external" in v for v in out)
    uid = "sessions.kubeflow.org/notebook-uid"
    orphan = [v for v in out if f"orphan metadata key {uid!r}" in v]
    assert orphan and "sessions/__init__.py" in orphan[0]
    assert any("undocumented metadata key 'example.test/drill-key'" in v
               and "warmup/pool.py" in v for v in out)
    hits = [f for f in run_paths([str(drifted_tree)], [RULE])
            if f.path == "warmup/pool.py" and "'example.test/drill-key'" in f.message]
    assert hits and hits[0].rule == RULE
