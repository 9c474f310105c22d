"""Index lookups for the controllers (the port's copy of
``list_by_index`` from the JAX package's ``machinery/cache.py``).

The JAX module's informer cache (``InformerCache``, ``CachedClient`` and
the platform's standing indexes) is not ported yet: the port's
controllers read the embedded store directly, so every lookup takes the
selector-list fallback below, as the JAX controllers do on a plain
store.
"""

from __future__ import annotations

from typing import Any, Optional

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
