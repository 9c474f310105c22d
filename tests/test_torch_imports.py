"""The PyTorch port stands alone: no JAX, nothing of the JAX package,
and no kernel toolchain touched at import.

An AST scan of every file of ``odh_kubeflow_tpu_torch/`` and of
``chip_smoke.py``, plus a fresh interpreter that imports the whole port
and must end with no JAX module loaded.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "odh_kubeflow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
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
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
