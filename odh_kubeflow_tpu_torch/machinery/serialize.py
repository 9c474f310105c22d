"""Canonical JSON serialization for the control plane (the port's copy of
the JAX package's ``machinery/serialize.py``).

``dumps(obj)`` is byte-identical to ``json.dumps(obj).encode()``: the
REST façade's responses, the watch-event framing and the write-ahead
log's record payloads and snapshots are written through it. The native
engine (``native/jsontree.cpp`` ``dumps``) walks the tree with direct
C-API calls, the ``FrozenDict``/``FrozenList`` subclasses the informer
cache hands out included, and hands anything it cannot prove it
serializes identically back to the stdlib, so parity holds by
construction.

Engine resolution mirrors ``objects.deepcopy``: a lazy first-use probe,
and the stdlib where no compiler or extension is available.
``set_engine("python")`` pins the stdlib (a measurement's baseline and
the fallback-parity tests); ``set_engine(None)`` restores the probe.
``dumps_count()`` is the serialize-once instrumentation: tests assert
fan-out and caching contracts by sampling it.
"""

from __future__ import annotations

import json as _json
from typing import Any, Optional

# every tree serialization bumps this (a cheap int add under the GIL)
dumps_calls = 0

_native_dumps = None
_native_tried = False
_forced_engine: Optional[str] = None  # None = auto, "python", "native"


def _py_dumps(obj: Any) -> bytes:
    return _json.dumps(obj).encode()


def _resolve():
    global _native_dumps, _native_tried
    if not _native_tried:
        _native_tried = True
        try:
            from odh_kubeflow_tpu_torch import native

            _native_dumps = native.jsontree_dumps()
        except Exception:  # noqa: BLE001 — any native failure → Python
            _native_dumps = None
    return _native_dumps


def set_engine(name: Optional[str]) -> None:
    """Pin the serialization engine: ``"python"`` (stdlib json),
    ``"native"`` (raise if the extension is unavailable), or ``None``
    to restore the automatic probe."""
    global _forced_engine
    if name not in (None, "python", "native"):
        raise ValueError(f"unknown serialize engine {name!r}")
    if name == "native" and _resolve() is None:
        raise RuntimeError("native serializer unavailable (no C++ compiler)")
    _forced_engine = name


def engine() -> str:
    """The engine ``dumps`` resolves to right now."""
    if _forced_engine is not None:
        return _forced_engine
    return "native" if _resolve() is not None else "python"


def dumps(obj: Any) -> bytes:
    """``json.dumps(obj).encode()`` with exact byte parity, at C speed
    when the native extension is available."""
    global dumps_calls
    dumps_calls += 1
    if _forced_engine == "python":
        return _py_dumps(obj)
    fn = _resolve()
    if fn is not None:
        return fn(obj)
    return _py_dumps(obj)


def dumps_count() -> int:
    """Total ``dumps`` invocations since import (monotonic)."""
    return dumps_calls
