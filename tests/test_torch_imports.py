"""The PyTorch port stands alone: no JAX, nothing of the JAX package,
and no kernel toolchain touched at import.

An AST scan of every file of ``odh_kubeflow_tpu_torch/`` (its ``native/``
packer loader and the platform's apis, machinery, controllers,
scheduling, webhooks, web, sessions and warmup subpackages included),
of ``tools/dryrun_multichip_torch.py``, of the GPU activity agent
(``images/jupyter-pytorch-cuda/gpu-activity-agent``, a stdlib script) and
of ``chip_smoke.py``, plus a fresh interpreter that imports the whole port
and must end with no JAX module loaded and no library built or loaded.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "odh_kubeflow_tpu_torch").rglob("*.py")) + [
    ROOT / "tools" / "dryrun_multichip_torch.py",
    ROOT / "images" / "jupyter-pytorch-cuda" / "gpu-activity-agent",
    ROOT / "chip_smoke.py",
]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node, node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    # the prefix is shared: odh_kubeflow_tpu_torch is the port itself
    return top in ("jax", "jaxlib", "flax", "optax", "orbax") or top == "odh_kubeflow_tpu"


def _import_time_nodes(tree):
    """Statements run when the module is imported: everything outside
    function bodies (class bodies run at import, so they count)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_builds_nothing_at_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{n.lineno} {m}" for n, m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, bad
    for node in _import_time_nodes(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
            assert not any(n.split(".")[0] == "triton" for n in names), (
                f"{path.name}:{node.lineno} imports triton at module level"
            )
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            assert name not in ("CDLL", "LoadLibrary", "load"), (
                f"{path.name}:{node.lineno} loads a library at module level"
            )


def test_the_scan_covers_the_native_loader_the_dryrun_and_chip_smoke():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"odh_kubeflow_tpu_torch/native/__init__.py", "tools/dryrun_multichip_torch.py",
            "chip_smoke.py"} <= names


def test_the_scan_covers_the_platform_subpackages():
    """Slice 9's control plane: every module of the port's apis,
    machinery, controllers, scheduling, webhooks, web and sessions
    subpackages, the GPU table and the conformance gate."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pkg = "odh_kubeflow_tpu_torch"
    for sub in ("apis", "machinery", "controllers", "scheduling", "webhooks", "web",
                "sessions"):
        files = sorted((ROOT / pkg / sub).glob("*.py"))
        assert files and {str(f.relative_to(ROOT)) for f in files} <= names, sub
    assert {f"{pkg}/conformance.py", f"{pkg}/utils/gpu.py", f"{pkg}/machinery/store.py",
            f"{pkg}/machinery/kubelet.py", f"{pkg}/controllers/notebook.py",
            f"{pkg}/webhooks/poddefault.py", f"{pkg}/webhooks/notebook.py",
            f"{pkg}/webhooks/server.py", f"{pkg}/webhooks/certs.py",
            f"{pkg}/web/microweb.py", f"{pkg}/web/crud_backend.py", f"{pkg}/web/jwa.py",
            f"{pkg}/sessions/__init__.py", f"{pkg}/scheduling/queue.py",
            f"{pkg}/scheduling/scheduler.py"} <= names


def test_the_scan_covers_the_sessions_and_warmup_modules():
    """Slice 9's suspend-to-checkpoint sessions and warm-start subsystem:
    the checkpoint store, the session manager, the compile cache and the
    warm pools."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pkg = "odh_kubeflow_tpu_torch"
    files = sorted((ROOT / pkg / "warmup").glob("*.py"))
    assert files and {str(f.relative_to(ROOT)) for f in files} <= names
    assert {f"{pkg}/sessions/checkpoint.py", f"{pkg}/sessions/manager.py",
            f"{pkg}/warmup/__init__.py", f"{pkg}/warmup/compilecache.py",
            f"{pkg}/warmup/pool.py", f"{pkg}/ops/_build.py"} <= names


def test_the_scan_covers_the_metering_and_durability_modules():
    """Slice 9 part 5: the serializer, the write-ahead log, fault
    injection, the usage meter and the GPU activity agent."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pkg = "odh_kubeflow_tpu_torch"
    assert {f"{pkg}/machinery/serialize.py", f"{pkg}/machinery/wal.py",
            f"{pkg}/machinery/faults.py", f"{pkg}/machinery/usage.py",
            "images/jupyter-pytorch-cuda/gpu-activity-agent"} <= names


def test_the_scan_covers_the_wire_modules():
    """Slice 9 part 6: the overload defense, the event-loop server, the
    zpages, the REST façade and its remote client. ``chip_smoke.py`` is
    scanned whole, its ``--platform-controllers`` and ``--platform-flood``
    modes included; ``tests/test_torch_platform_remote.py`` runs the
    first and checks that the process loaded no reference module."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pkg = "odh_kubeflow_tpu_torch"
    assert {f"{pkg}/machinery/{m}.py" for m in (
        "overload", "eventloop", "zpages", "httpapi", "client")} | {"chip_smoke.py"} <= names
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert {"platform_controllers_main", "platform_flood_main"} <= funcs


def test_forbidden_matches_exact_package_names():
    assert _forbidden("odh_kubeflow_tpu")
    assert _forbidden("odh_kubeflow_tpu.models.quant")
    assert _forbidden("jax.numpy")
    assert not _forbidden("odh_kubeflow_tpu_torch.models.quant")
    assert not _forbidden("jaxtyping")


def test_importing_the_port_loads_no_jax_and_no_kernel():
    code = (
        "import sys, pkgutil, importlib\n"
        "import odh_kubeflow_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from odh_kubeflow_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'odh_kubeflow_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not _build._libs\n"
        "from odh_kubeflow_tpu_torch import native\n"
        "assert native._lib is None and not native._load_failed\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_the_scan_covers_the_high_availability_slice():
    """Slice 9 part 7: leader election, the read replica, the promotion
    watchdog, the split-process runner and the informer cache; and
    ``chip_smoke.py``'s ``--platform-apiserver`` and
    ``--notebook-failover`` modes."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pkg = "odh_kubeflow_tpu_torch"
    assert {f"{pkg}/machinery/{m}.py" for m in (
        "leader", "replica", "promoter", "runner", "cache")} <= names
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert {"platform_apiserver_main", "notebook_failover_main",
            "platform_failover_phase"} <= funcs


def test_the_scan_covers_the_partitioned_write_path_and_the_platform():
    """Slice 9 part 8: the partition router, the cloud IAM clients, the
    all-in-one platform; and ``chip_smoke.py``'s ``platform_partitions``
    phase."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pkg = "odh_kubeflow_tpu_torch"
    assert {f"{pkg}/machinery/partition.py", f"{pkg}/machinery/cloudiam.py",
            f"{pkg}/platform.py"} <= names
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    funcs = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert "platform_partitions_phase" in funcs


def test_control_plane_modules_load_no_torch():
    """The apiserver, replica, controller and flood processes and the
    all-in-one platform (with the partition router and the cloud IAM
    clients) import only host-only modules: a fresh interpreter that imports the control
    plane's entry modules ends with no ``torch`` loaded (the package's
    ``card_label`` / ``resolve_device`` load it on first use)."""
    code = (
        "import sys, importlib\n"
        "for m in ('store', 'httpapi', 'client', 'leader', 'replica', 'promoter',\n"
        "          'runner', 'cache', 'partition', 'cloudiam'):\n"
        "    importlib.import_module('odh_kubeflow_tpu_torch.machinery.' + m)\n"
        "importlib.import_module('odh_kubeflow_tpu_torch.platform')\n"
        "importlib.import_module('odh_kubeflow_tpu_torch.controllers.notebook')\n"
        "importlib.import_module('odh_kubeflow_tpu_torch.scheduling.scheduler')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))\n"
        "assert not bad, bad[:5]\n"
        "import odh_kubeflow_tpu_torch as p\n"
        "assert callable(p.card_label) and 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
