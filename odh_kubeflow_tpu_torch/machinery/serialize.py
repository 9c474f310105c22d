"""Canonical JSON serialization for the control plane (the port's copy of
the JAX package's ``machinery/serialize.py``, its Python engine).

``dumps(obj)`` is byte-identical to ``json.dumps(obj).encode()``: the
write-ahead log's record payloads and snapshots are written through it.
The JAX package also has a C++ engine (``native/jsontree.cpp``) behind
the same contract and a switch between the two; the port keeps the
stdlib engine only, until a measured path needs the other.
``dumps_count()`` is the serialize-once instrumentation: tests assert
fan-out and caching contracts by sampling it.
"""

from __future__ import annotations

import json as _json
from typing import Any

# every tree serialization bumps this (a cheap int add under the GIL)
dumps_calls = 0


def dumps(obj: Any) -> bytes:
    """``json.dumps(obj).encode()``."""
    global dumps_calls
    dumps_calls += 1
    return _json.dumps(obj).encode()


def dumps_count() -> int:
    """Total ``dumps`` invocations since import (monotonic)."""
    return dumps_calls
