"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so``
under the checkout (or into ``$ODH_TORCH_KERNEL_CACHE`` when set: the
GPU-runtime PodDefault points it at the workspace volume, so a notebook
restarted on the same volume builds nothing), then loaded with
``ctypes``. The hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds and a stale library
is never loaded. Nothing builds at import: the first launch of a kernel
builds it (``library``), or ``build`` builds several at once, one
``nvcc`` process per source, all started together.

The directory is read from the env at import; ``set_build_dir`` moves it
later (``warmup.compilecache.install_process_cache``), before the first
library is loaded. A library whose file name exists counts as built and
is loaded as it is: a directory staged from the compile cache is
trusted because ``CompileCacheService.materialize_dir`` writes only
artifacts whose sha256 matches the cache's receipt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNEL_CACHE_ENV = "ODH_TORCH_KERNEL_CACHE"
BUILD_DIR = Path(
    os.environ.get(KERNEL_CACHE_ENV)
    or Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (with ptxas's register report) per kernel built here
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds its users
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once; raise with the compiler's output on failure."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, t in todo.items():
        # a dot name: a directory scan (the compile cache's ingest_dir)
        # never takes a library that is still being written
        tmp = t.parent / f".{t.name}.{os.getpid()}.tmp"
        procs[n] = (
            tmp,
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def set_build_dir(path) -> Path:
    """Point this process's kernel build directory at ``path`` (created
    if missing). Raises when the directory cannot be made or written
    (``OSError``): a configured cache that cannot be used must not turn
    into a silent cold start. Raises ``RuntimeError`` when a library was
    already loaded from another directory: the process would then hold
    kernels from two places."""
    global BUILD_DIR
    new = Path(path)
    new.mkdir(parents=True, exist_ok=True)
    if not os.access(new, os.W_OK | os.X_OK):
        raise PermissionError(f"kernel build directory {new} is not writable")
    with _lock:
        if new.resolve() == BUILD_DIR.resolve():
            return BUILD_DIR
        if _libs:
            raise RuntimeError(
                f"kernels {sorted(_libs)} are already loaded from {BUILD_DIR}; "
                f"the build directory cannot move to {new} in this process"
            )
        BUILD_DIR = new
        return BUILD_DIR
