"""The port's native (C++) host-side pieces: the document packer
(``packer.cpp``, a plain C ABI loaded with ctypes), the hot loop of
``train/data.py``; and the JSON-tree extension (``jsontree.cpp``, a
CPython extension module), the control plane's ``deepcopy`` and
``dumps`` (``machinery/objects.py``, ``machinery/serialize.py``).

Each library is compiled at first use by the system C++ compiler
(``g++``, else ``c++`` or ``clang++``) into ``build/native/`` under the
checkout, named by a hash of the source and the flags (the extension's
also by the interpreter's headers and ABI suffix), so an edited source
rebuilds and a stale library is never loaded. Without a compiler
``available()`` is False and ``train/data.py`` packs in Python, and
``jsontree_deepcopy()``/``jsontree_dumps()`` return None, so the
control plane serializes with the stdlib.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "packer.cpp"
JSONTREE_SRC = Path(__file__).resolve().parent / "jsontree.cpp"
JSONTREE_MODULE = "_odhkf_torch_jsontree"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_jt_mod = None
_jt_tried = False


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpacker-{digest.hexdigest()[:16]}.so"


def _jsontree_flags() -> tuple[str, ...]:
    return (*CXX_FLAGS, "-I" + sysconfig.get_paths()["include"])


def _jsontree_target() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(
        JSONTREE_SRC.read_bytes() + " ".join(_jsontree_flags()).encode() + suffix.encode()
    )
    return BUILD_DIR / f"{JSONTREE_MODULE}-{digest.hexdigest()[:16]}{suffix}"


def _compile(src: Path, target: Path, flags: tuple[str, ...]) -> Optional[Path]:
    """Compile ``src`` into ``target`` unless it exists; the path, or
    None when no compiler exists. The compiler writes a temporary file
    that is renamed into place, so processes that build it at once race
    benignly."""
    if target.exists():
        return target
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *flags, str(src), "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def build() -> Optional[Path]:
    """Compile the packer unless its library exists; its path, or None
    when no compiler exists."""
    return _compile(SRC, _target(), CXX_FLAGS)


def build_jsontree() -> Optional[Path]:
    """Compile the JSON-tree extension unless it exists; its path, or
    None when no compiler exists. Raises CalledProcessError when the
    compiler refuses it (for example, no Python headers)."""
    return _compile(JSONTREE_SRC, _jsontree_target(), _jsontree_flags())


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            so = build()
            if so is None:
                _load_failed = True
                return None
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            _load_failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.pack_documents_c.restype = ctypes.c_long
        lib.pack_documents_c.argtypes = [
            i32p, ctypes.POINTER(ctypes.c_int64), ctypes.c_long, ctypes.c_long,
            i32p, i32p, i32p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the packer's library built and loaded."""
    return _load() is not None


def _jsontree_module():
    """The lazily built and loaded JSON-tree extension, or None. One
    build and load serves both entry points (deepcopy and dumps)."""
    global _jt_mod, _jt_tried
    if _jt_tried:
        return _jt_mod
    with _lock:
        if _jt_tried:
            return _jt_mod
        try:
            so = build_jsontree()
            if so is not None:
                from importlib.machinery import ExtensionFileLoader
                from importlib.util import module_from_spec, spec_from_loader

                loader = ExtensionFileLoader(JSONTREE_MODULE, str(so))
                mod = module_from_spec(spec_from_loader(JSONTREE_MODULE, loader))
                loader.exec_module(mod)
                _jt_mod = mod
        except (OSError, subprocess.CalledProcessError, ImportError):
            _jt_mod = None
        _jt_tried = True
    return _jt_mod


def jsontree_deepcopy():
    """The C deep copy for JSON-shaped trees (``machinery/objects.py``'s
    hot path; frozen trees come back as plain dicts and lists), or None
    when the extension cannot build or load."""
    mod = _jsontree_module()
    return None if mod is None else mod.deepcopy


def jsontree_dumps():
    """The C serializer for JSON-shaped trees (``machinery/serialize.py``
    fronts it), or None when the extension cannot build or load. The
    callable returned is exactly ``json.dumps(obj).encode()``: the
    extension raises its ``Fallback`` exception for any input it cannot
    prove it serializes identically (non-str dict keys, exotic leaves),
    and this wrapper serializes that input with the stdlib, so output
    bytes and error messages match."""
    mod = _jsontree_module()
    if mod is None:
        return None
    import json as _json

    c_dumps = mod.dumps
    fallback = mod.Fallback

    def dumps(obj):
        try:
            return c_dumps(obj)
        except fallback:
            return _json.dumps(obj).encode()

    return dumps


def pack_rows(
    flat: np.ndarray,  # int32 [total]: the documents concatenated
    doc_lens: np.ndarray,  # int64 [n_docs]
    seq_len: int,
    pad_id: int = 0,
) -> dict:
    """The whole document stream packed into ``[n_rows, seq_len]`` arrays
    (``tokens``, ``targets``, ``segment_ids``, ``loss_mask``) in one native
    pass. Raises RuntimeError when the library is unavailable (the caller
    picks the fallback) and ValueError when ``doc_lens`` does not sum to
    the stream's length."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native packer unavailable (no C++ compiler)")
    flat = np.ascontiguousarray(flat, np.int32)
    doc_lens = np.ascontiguousarray(doc_lens, np.int64)
    total = int(doc_lens.sum())
    if total != flat.size:
        raise ValueError(f"doc_lens sum {total} != flat size {flat.size}")
    max_rows = max((total + seq_len - 1) // seq_len, 1)
    tokens = np.full((max_rows, seq_len), pad_id, np.int32)
    targets = np.full((max_rows, seq_len), pad_id, np.int32)
    seg_ids = np.zeros((max_rows, seq_len), np.int32)
    loss_mask = np.zeros((max_rows, seq_len), np.float32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.pack_documents_c(
        flat.ctypes.data_as(i32p), doc_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(doc_lens), seq_len, tokens.ctypes.data_as(i32p), targets.ctypes.data_as(i32p),
        seg_ids.ctypes.data_as(i32p), loss_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows,
    )
    if n < 0:
        raise RuntimeError("native packer overflowed its row bound (bug)")
    return {"tokens": tokens[:n], "targets": targets[:n], "segment_ids": seg_ids[:n],
            "loss_mask": loss_mask[:n]}
