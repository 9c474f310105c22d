"""Index lookups for the controllers and the REST façade's
serialized-bytes cache (the port's copies of ``list_by_index`` and
``SerializedBytesCache`` from the JAX package's ``machinery/cache.py``).

The JAX module's informer cache (``InformerCache``, ``CachedClient`` and
the platform's standing indexes) is not ported yet: the port's
controllers read the embedded store directly, so every lookup takes the
selector-list fallback below, as the JAX controllers do on a plain
store.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Iterable, Optional

from odh_kubeflow_tpu_torch.machinery import serialize

Obj = dict[str, Any]


def list_by_index(
    api: Any,
    kind: str,
    index: str,
    key: str,
    namespace: Optional[str] = None,
    fallback_selector: Optional[Obj] = None,
) -> list[Obj]:
    """Index lookup against a client that offers ``by_index``, degrading
    to a selector list on a plain api."""
    fn = getattr(api, "by_index", None)
    if fn is not None:
        out = fn(kind, index, key, namespace=namespace)
        if out is not None:
            return out
    return api.list(kind, namespace=namespace, label_selector=fallback_selector)


class SerializedBytesCache:
    """Bounded LRU of serialized response bytes keyed by on-the-wire
    identity: ``(kind, namespace, name, resourceVersion)``.

    The apiserver's object contents are immutable per resourceVersion
    (every change stamps a fresh rv — deletions included), so the key
    IS the content hash: nothing ever needs explicit invalidation, a
    changed object simply serializes under its new rv while the stale
    entry ages out of the LRU. One instance per serving tier (RestAPI)
    — rv counters are per-store, so a process-global cache could alias
    objects across the independent stores tests create.

    Two views share the underlying object bytes:

    - ``obj_bytes(obj)``: the object itself (single GETs, write
      responses, and the items of a composed list — a cached namespace
      list is a memcpy-join of these on a hit, zero serialization);
    - ``event_bytes(etype, obj)``: the full watch wire line
      ``{"type": ..., "object": ...}\\n``, composed from ``obj_bytes``
      and cached per event type — every subscriber of the same event
      fans out the SAME bytes object, so an event is serialized exactly
      once no matter how many watchers are connected.

    Objects without kind/name/resourceVersion (Status docs, synthetic
    bodies) bypass the cache and serialize directly.
    """

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._data: "OrderedDict[tuple, bytes]" = OrderedDict()
        # plain monotonic ints (same posture as the informer's hot-path
        # counters): a lock+label Counter.inc per response would cost
        # more than the serialization it saves
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(obj: Obj, variant: str = "") -> Optional[tuple]:
        m = obj.get("metadata")
        if not isinstance(m, dict):
            return None
        rv = m.get("resourceVersion")
        name = m.get("name")
        if not rv or not name:
            return None
        return (
            variant,
            obj.get("kind", ""),
            m.get("namespace") or "",
            name,
            rv,
        )

    def _get(self, key: tuple) -> Optional[bytes]:
        with self._lock:
            data = self._data.get(key)
            if data is not None:
                self._data.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return data

    def _put(self, key: tuple, data: bytes) -> None:
        with self._lock:
            self._data[key] = data
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def obj_bytes(self, obj: Obj) -> bytes:
        key = self._key(obj)
        if key is None:
            return serialize.dumps(obj)
        data = self._get(key)
        if data is None:
            data = serialize.dumps(obj)  # outside the lock
            self._put(key, data)
        return data

    def event_bytes(self, etype: str, obj: Obj) -> bytes:
        key = self._key(obj, variant=etype)
        if key is None:
            return (
                b'{"type": ' + serialize.dumps(etype)
                + b', "object": ' + serialize.dumps(obj) + b"}\n"
            )
        data = self._get(key)
        if data is None:
            # composed, not re-serialized: the object bytes are shared
            # with obj_bytes consumers (list items, single GETs)
            data = (
                b'{"type": "' + etype.encode() + b'", "object": '
                + self.obj_bytes(obj) + b"}\n"
            )
            self._put(key, data)
        return data

    def list_bytes(
        self,
        kind: str,
        items: Iterable[Obj],
        continue_token: Optional[str] = None,
    ) -> bytes:
        """The full ``{kind}List`` response payload, byte-identical to
        ``json.dumps({"kind": f"{kind}List", "apiVersion": "v1",
        "items": [...]})``, composed from per-object cached bytes.
        Paginated responses (``continue_token`` not None, may be "")
        additionally carry kube's ListMeta ``metadata.continue``."""
        inner = b", ".join(self.obj_bytes(o) for o in items)
        meta = b""
        if continue_token is not None:
            meta = (
                b'"metadata": {"continue": '
                + serialize.dumps(continue_token)
                + b"}, "
            )
        return (
            b'{"kind": "' + kind.encode() + b'List", "apiVersion": "v1", '
            + meta
            + b'"items": [' + inner + b"]}"
        )
