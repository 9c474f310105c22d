"""The port's knob-registry lint (``analysis/knobs.py`` with the port's
own ``analysis/knobs.json``), held to the JAX package's.

- The scanner reads every env idiom the same way in both packages (the
  JAX knob tests' scanner fixtures, through both scanners).
- The port's registry names the port's knobs: the GPU knobs
  (``QUOTA_GPU_KEY``, ``CULL_CHECK_GPU_DUTY_CYCLE``, …), the analysis
  knobs (``GRAFT_SANITIZE``, ``GRAFT_SCHED``), and no TPU-only knob
  the port does not read.
- The knob table it reads is the port's own guide
  (``odh_kubeflow_tpu_torch/GUIDE.md``), outside ``docs/`` and not
  ``README.md`` (the reference's tokenizer test trains on those).
- The manifest cross-check runs over the port's overlay directory
  (empty until the port ships its deployment files); a fixture YAML
  proves the check is wired.
- The CLI exits 0 on the port's tree.
"""

import os
import subprocess
import sys

import pytest

from odh_kubeflow_tpu.analysis import knobs as jax_knobs
from odh_kubeflow_tpu_torch.analysis import knobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCANNER_FIXTURES = {
    "direct": (
        "import os\n"
        "a = os.environ.get('KNOB_A', 'x')\n"
        "b = os.environ['KNOB_B']\n"
        "c = os.getenv('KNOB_C')\n"
        "os.environ.setdefault('KNOB_D', '1')\n"
    ),
    "alias": "import os\ndef from_env():\n    env = os.environ\n    return env.get('KNOB_E', '')\n",
    "from-import": "from os import environ\nx = environ.get('KNOB_I')\n",
    "constant": "import os\nCHAOS_ENV = 'GRAFT_CHAOS'\nraw = os.environ.get(CHAOS_ENV, '')\n",
    "helpers": (
        "import os\n"
        "def _env_int(name, default):\n"
        "    return int(os.environ.get(name, str(default)))\n"
        "X = _env_int('KNOB_F', 3)\n"
        "def from_env():\n"
        "    env = os.environ\n"
        "    def flag(name, default='false'):\n"
        "        return env.get(name, default) == 'true'\n"
        "    return flag('KNOB_G')\n"
    ),
    "wsgi": (
        "def app(environ, start_response):\n"
        "    n = environ.get('CONTENT_LENGTH')\n"
        "    m = environ['PATH_INFO']\n"
        "    return n, m\n"
    ),
}


@pytest.mark.parametrize("case", sorted(SCANNER_FIXTURES))
def test_scanner_equals_the_references(case):
    src = SCANNER_FIXTURES[case]
    assert knobs.scan_source(src) == jax_knobs.scan_source(src)


def test_scanner_reads_the_expected_knobs():
    assert knobs.scan_source(SCANNER_FIXTURES["direct"]) == {"KNOB_A", "KNOB_B", "KNOB_C", "KNOB_D"}
    assert knobs.scan_source(SCANNER_FIXTURES["helpers"]) == {"KNOB_F", "KNOB_G"}
    assert knobs.scan_source(SCANNER_FIXTURES["wsgi"]) == set()


def _reg(entries, external=()):
    return {"knobs": entries, "manifest_external": list(external)}


def test_cross_check_semantics_equal_the_references(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("import os\nx = os.environ.get('NEW_KNOB')\n")
    cases = [
        dict(registry=_reg([]), guide="", manifests={}),
        dict(registry=_reg([{"name": "NEW_KNOB", "scope": "web", "default": "",
                             "description": "d"}]), guide="", manifests={}),
        dict(registry=_reg([{"name": "GONE_KNOB", "scope": "web", "default": "",
                             "description": "d"}]), guide="", manifests={"MYSTERY_ENV": ["x.yaml"]}),
    ]
    for kw in cases:
        # the messages name each package's own guide
        jax_out = [v.replace("docs/GUIDE.md", "GUIDE.md")
                   for v in jax_knobs.knob_violations(root=str(pkg), **kw)]
        assert knobs.knob_violations(root=str(pkg), **kw) == jax_out


def test_the_ports_registry_names_the_ports_knobs(scanned):
    reg = knobs.load_registry()
    names = [e["name"] for e in reg["knobs"]]
    assert len(names) == len(set(names))
    for e in reg["knobs"]:
        assert e.get("scope") and e.get("description"), e["name"]
    assert {"QUOTA_GPU_KEY", "CULL_CHECK_GPU_DUTY_CYCLE", "ENABLE_GPU_QUEUEING",
            "SIM_GPU_NODES", "ODH_TORCH_KERNEL_CACHE", "GRAFT_SANITIZE", "GRAFT_SCHED"} <= set(names)
    assert not {"QUOTA_TPU_KEY", "CULL_CHECK_TPU_DUTY_CYCLE", "SIM_TPU_NODES",
                "JAX_COMPILATION_CACHE_DIR"} & set(names)
    quota = next(e for e in reg["knobs"] if e["name"] == "QUOTA_GPU_KEY")
    assert quota["default"] == "requests.nvidia.com/gpu"
    assert len(scanned) >= 80


def test_the_knob_table_is_the_ports_own_file():
    guide = knobs.guide_path()
    assert os.path.abspath(guide) == os.path.join(ROOT, "odh_kubeflow_tpu_torch", "GUIDE.md")
    assert os.sep + "docs" + os.sep not in guide and os.path.basename(guide) != "README.md"
    assert jax_knobs.guide_path() != guide
    assert knobs.registry_path() != jax_knobs.registry_path()


@pytest.fixture(scope="module")
def scanned():
    """One scan of the port's tree, shared by the tree-wide checks."""
    return knobs.scan_package()


def test_the_manifest_check_reads_the_ports_overlay_and_is_wired(tmp_path, scanned, monkeypatch):
    monkeypatch.setattr(knobs, "scan_package", lambda root=None: scanned)
    assert knobs.manifests_root() == os.path.join(ROOT, "manifests", "overlays", "gpu")
    assert knobs.manifest_env_names() == {}  # the port ships no overlay yet
    overlay = tmp_path / "gpu"
    overlay.mkdir()
    (overlay / "profile-controller.yaml").write_text(
        "spec:\n"
        "  containers:\n"
        "    - name: manager\n"
        "      env:\n"
        "        - name: QUOTA_GPU_KEY\n"
        "          value: requests.nvidia.com/gpu\n"
        "        - name: QUOTA_TPU_KEY\n"
        "          value: requests.google.com/tpu\n"
    )
    names = knobs.manifest_env_names(str(overlay))
    assert names == {"QUOTA_GPU_KEY": ["profile-controller.yaml"],
                     "QUOTA_TPU_KEY": ["profile-controller.yaml"]}
    out = knobs.knob_violations(manifests=names)
    # the registered knob passes; the TPU one is a stanza nothing reads
    assert out == [knobs.knob_violations(manifests={"QUOTA_TPU_KEY": ["profile-controller.yaml"]})[0]]
    assert "manifest env 'QUOTA_TPU_KEY'" in out[0]


def test_the_ports_tree_has_zero_knob_drift(scanned, monkeypatch):
    monkeypatch.setattr(knobs, "scan_package", lambda root=None: scanned)
    assert knobs.knob_violations() == []


def test_render_appendix_is_in_the_guide_verbatim():
    with open(knobs.guide_path(), encoding="utf-8") as fh:
        text = fh.read()
    assert knobs.render_appendix() in text


def test_cli_exits_zero_on_the_port():
    out = subprocess.run([sys.executable, "-m", "odh_kubeflow_tpu_torch.analysis.knobs"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "knob-registry: clean" in out.stderr
