"""The port's native (C++) host-side pieces, loaded with ctypes: the
document packer (``packer.cpp``), the hot loop of ``train/data.py``.

The library is compiled at first use by the system C++ compiler (``g++``,
else ``c++`` or ``clang++``) into ``build/native/`` under the checkout,
named by a hash of the source and the flags, so an edited source
rebuilds and a stale library is never loaded. Without a compiler
``available()`` is False and ``train/data.py`` packs in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _compiler() -> Optional[str]:
    return shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpacker-{digest.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the packer unless its library exists; its path, or None
    when no compiler exists. The compiler writes a temporary file that is
    renamed into place, so processes that build it at once race benignly."""
    target = _target()
    if target.exists():
        return target
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


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
