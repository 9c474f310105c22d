"""Compilation-cache service: build once, load everywhere (the port's
copy of the JAX package's ``warmup/compilecache.py``, on the kernels'
build directory).

A fresh notebook process builds each CUDA kernel it launches with
``nvcc`` (``ops/_build.py``). A built library is a pure function of its
:class:`CompileKey` — (the library's content fingerprint, the
accelerator it was built for, the compiler version) — so the artifact
is content-addressed and shared across sessions, trainer runs and
engine replicas:

- the artifact is ``lib<name>-<hash>.so``; ``ops/_build.py`` names it by
  a sha256 of the source, the shared headers and the ``nvcc`` flags, so
  its file name is the key's ``fingerprint`` (JAX's is the file name
  its persistent cache derives from the program). The ``topology``
  axis is the accelerator the library was built for (``sm_90a``,
  :func:`build_target`), and :func:`compiler_version` gives the
  ``nvcc`` and torch versions;
- bytes live on a :class:`CompileArtifactStore` (atomic write +
  sha256-digest meta, the ``SessionCheckpointStore`` discipline) or its
  zone-replicated façade :class:`ReplicatedArtifactStore` (write-all
  save, read-from-any-verifying-zone);
- the index is the ``CompileCacheEntry`` kind on the platform API
  (cluster-scoped — libraries are not namespace-local): digest, size,
  zones, lastAccessAt;
- :meth:`CompileCacheService.get_or_compile` is the one entrypoint:
  singleflight dedup (N concurrent builds of the same key collapse
  into ONE; followers block on the leader's result), digest-verified
  loads (a corrupted/truncated artifact is detected and falls back to a
  fresh build — never loaded as garbage), hit/miss/latency metrics,
  and LRU+TTL GC under ``COMPILE_CACHE_MAX_BYTES`` /
  ``COMPILE_CACHE_TTL_SECONDS``;
- :meth:`~CompileCacheService.ingest_dir` /
  :meth:`~CompileCacheService.materialize_dir` bridge the build
  directory: a cold process pointed at a staging directory
  (``ODH_TORCH_KERNEL_CACHE``) builds there, ``ingest_dir`` registers
  its libraries with the service, and ``materialize_dir`` stages
  digest-verified libraries into a fresh directory for the next process
  (notebook kernels get that directory as their
  ``ODH_TORCH_KERNEL_CACHE`` mount). ``ops/_build.py`` loads a library
  whose file exists without rebuilding it, so that digest check is the
  only guard between a corrupted artifact and ``ctypes.CDLL``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import re
import subprocess
import tempfile
import threading
import time
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery import objects as obj_util
from odh_kubeflow_tpu_torch.machinery.store import (
    AlreadyExists,
    Conflict,
    NotFound,
)
from odh_kubeflow_tpu_torch.sessions.checkpoint import parse_zone_spec
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.warmup import WARMUP_API_VERSION

Obj = dict[str, Any]

_LOAD_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
_COMPILE_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 60.0)


def build_target() -> str:
    """The ``topology`` axis of the cache key: the GPU architecture the
    kernels are built for (``code=`` of ``ops/_build.py``'s ``nvcc``
    flags, ``sm_90a``)."""
    from odh_kubeflow_tpu_torch.ops._build import NVCC_FLAGS

    for flag in NVCC_FLAGS:
        if "code=" in flag:
            return flag.rsplit("code=", 1)[1]
    raise ValueError(f"no code= target in {NVCC_FLAGS}")


@functools.lru_cache(maxsize=None)
def compiler_version() -> str:
    """The compiler identity axis of the cache key: libraries from one
    ``nvcc`` (and one torch, whose CUDA runtime loads them) must never
    serve another. Without ``nvcc`` (a host that builds nothing) the
    nvcc part reads ``nvcc-absent``."""
    import torch

    from odh_kubeflow_tpu_torch.ops import _build

    try:
        out = subprocess.run(
            [_build._nvcc(), "--version"], capture_output=True, text=True, check=True
        ).stdout
    except RuntimeError:  # _build._nvcc: no nvcc on this host
        nvcc = "nvcc-absent"
    else:
        m = re.search(r"release [\d.]+, V([\d.]+)", out)
        nvcc = f"nvcc-{m.group(1) if m else out.strip().splitlines()[-1]}"
    return f"{nvcc}+torch-{torch.__version__}"


@dataclasses.dataclass(frozen=True)
class CompileKey:
    """Content address of one built kernel library. ``fingerprint`` is
    its file name, ``lib<name>-<hash>.so``, whose hash ``ops/_build.py``
    takes over the source, the shared headers and the ``nvcc`` flags;
    topology (the GPU architecture) and compiler version complete the
    key — the same source built for another architecture or by another
    ``nvcc`` is a different artifact."""

    fingerprint: str
    topology: str = ""
    compiler_version: str = ""

    @property
    def key_id(self) -> str:
        raw = f"{self.fingerprint}|{self.topology}|{self.compiler_version}"
        return hashlib.sha256(raw.encode()).hexdigest()[:32]

    @property
    def entry_name(self) -> str:
        return f"cc-{self.key_id}"


class CompileArtifactStore:
    """Opaque-bytes artifact store, one file + one meta per key:
    ``<key>.bin`` written via temp-file + ``os.replace`` (never a torn
    artifact), ``<key>.meta.json`` holding the sha256 digest + size so
    every load can verify the bytes it is about to hand to the loader."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _bin(self, key_id: str) -> str:
        return os.path.join(self.root, f"{key_id}.bin")

    def _meta(self, key_id: str) -> str:
        return os.path.join(self.root, f"{key_id}.meta.json")

    @staticmethod
    def digest_of(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    def save(self, key_id: str, data: bytes) -> Obj:
        digest = self.digest_of(data)
        for path, payload in (
            (self._bin(key_id), data),
            (
                self._meta(key_id),
                json.dumps(
                    {"digest": digest, "sizeBytes": len(data)}
                ).encode(),
            ),
        ):
            fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp-")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        return {"digest": digest, "sizeBytes": len(data)}

    def saved_digest(self, key_id: str) -> Optional[str]:
        try:
            with open(self._meta(key_id), "rb") as f:
                return json.loads(f.read()).get("digest")
        except (OSError, ValueError):
            return None

    def load(
        self, key_id: str, expect_digest: Optional[str] = None
    ) -> Optional[tuple[bytes, str]]:
        """The bytes + their ACTUAL digest, or None when missing or —
        with ``expect_digest`` — when the bytes do not verify. The
        digest is always recomputed from the bytes read, not trusted
        from the meta file: a truncated/corrupted artifact must be
        caught here, before ``ctypes`` loads it."""
        try:
            with open(self._bin(key_id), "rb") as f:
                data = f.read()
        except OSError:
            return None
        digest = self.digest_of(data)
        if expect_digest and digest != expect_digest:
            return None
        return data, digest

    def exists(self, key_id: str) -> bool:
        return os.path.exists(self._bin(key_id))

    def delete(self, key_id: str) -> None:
        for path in (self._bin(key_id), self._meta(key_id)):
            try:
                os.unlink(path)
            except OSError:
                pass


class ReplicatedArtifactStore:
    """Zone-replicated façade over N :class:`CompileArtifactStore`
    roots, one per failure domain — the replicated-checkpoint
    discipline applied to compile artifacts:

    - ``save`` is write-all; at least one zone must land or it raises
      (an index entry with zero durable artifacts is a lie); the
      receipt records which zones hold the bytes and whether the write
      degraded;
    - ``load`` prefers a zone whose bytes VERIFY against the expected
      digest, so one zone's bitrot silently falls through to a healthy
      replica;
    - ``fail_zone``/``heal_zone`` simulate/repair domain loss (tests,
      zone drills); ``heal`` re-replicates a degraded key once its
      missing zones return.
    """

    def __init__(self, zones: dict[str, str]):
        if not zones:
            raise ValueError("ReplicatedArtifactStore needs >= 1 zone")
        self.stores = {z: CompileArtifactStore(p) for z, p in zones.items()}
        self._failed: set[str] = set()

    # -- failure-domain control (drills) ------------------------------------

    def fail_zone(self, zone: str) -> None:
        self._failed.add(zone)

    def heal_zone(self, zone: str) -> None:
        self._failed.discard(zone)

    def failed_zones(self) -> set[str]:
        return set(self._failed)

    # -- store duck type ----------------------------------------------------

    def save(self, key_id: str, data: bytes) -> Obj:
        landed: list[str] = []
        receipt: Obj = {}
        for zone, store in self.stores.items():
            if zone in self._failed:
                continue
            try:
                receipt = store.save(key_id, data)
            except OSError:
                continue
            landed.append(zone)
        if not landed:
            raise OSError(
                f"compile artifact {key_id}: no zone accepted the write"
            )
        receipt["zones"] = landed
        receipt["degraded"] = len(landed) < len(self.stores)
        return receipt

    def load(
        self, key_id: str, expect_digest: Optional[str] = None
    ) -> Optional[tuple[bytes, str]]:
        fallback: Optional[tuple[bytes, str]] = None
        for zone, store in self.stores.items():
            if zone in self._failed:
                continue
            got = store.load(key_id, expect_digest=expect_digest)
            if got is not None:
                return got
            if expect_digest and fallback is None:
                fallback = store.load(key_id)
        # no zone verifies: surface nothing rather than unverified
        # bytes — the caller treats it as a corrupt miss and rebuilds
        del fallback
        return None

    def exists(self, key_id: str) -> bool:
        return any(
            s.exists(key_id)
            for z, s in self.stores.items()
            if z not in self._failed
        )

    def saved_digest(self, key_id: str) -> Optional[str]:
        for zone, store in self.stores.items():
            if zone in self._failed:
                continue
            digest = store.saved_digest(key_id)
            if digest:
                return digest
        return None

    def delete(self, key_id: str) -> None:
        for store in self.stores.values():
            store.delete(key_id)

    def heal(self, key_id: str, digest: str) -> Obj:
        """Re-replicate ``key_id`` to every healthy zone missing it,
        sourcing from a zone whose bytes verify."""
        got = self.load(key_id, expect_digest=digest)
        zones: list[str] = []
        if got is not None:
            data, _ = got
            for zone, store in self.stores.items():
                if zone in self._failed:
                    continue
                if store.saved_digest(key_id) != digest:
                    try:
                        store.save(key_id, data)
                    except OSError:
                        continue
                zones.append(zone)
        return {"zones": zones, "degraded": len(zones) < len(self.stores)}


@dataclasses.dataclass
class CompileCacheConfig:
    cache_dir: str = ""
    zones: str = ""
    max_bytes: int = 4 << 30
    ttl_seconds: float = 7 * 24 * 3600.0

    @staticmethod
    def from_env() -> "CompileCacheConfig":
        env = os.environ
        return CompileCacheConfig(
            cache_dir=env.get("COMPILE_CACHE_DIR", ""),
            zones=env.get("COMPILE_CACHE_ZONES", ""),
            max_bytes=int(env.get("COMPILE_CACHE_MAX_BYTES", str(4 << 30))),
            ttl_seconds=float(
                env.get("COMPILE_CACHE_TTL_SECONDS", str(7 * 24 * 3600))
            ),
        )


class _Inflight:
    __slots__ = ("event", "value", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Optional[bytes] = None
        self.error: Optional[BaseException] = None


class CompileCacheService:
    """The platform compilation cache. One instance per control plane;
    every build (notebook kernels, trainers and engine replicas via their
    staged build directory) funnels through :meth:`get_or_compile` or
    the directory bridge."""

    def __init__(
        self,
        api: Any,
        config: Optional[CompileCacheConfig] = None,
        registry: Optional[prometheus.Registry] = None,
        time_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.config = config or CompileCacheConfig()
        self.now = time_fn
        root = self.config.cache_dir or tempfile.mkdtemp(
            prefix="compile-cache-"
        )
        self.root = root
        zones = parse_zone_spec(self.config.zones, root)
        self.store: Any = (
            ReplicatedArtifactStore(zones)
            if zones
            else CompileArtifactStore(root)
        )
        # singleflight table: entry name → the in-flight leader the
        # followers wait on. Compiles and store IO run OUTSIDE the lock
        # — it only guards the table itself.
        self._lock = threading.Lock()
        self._inflight: dict[str, _Inflight] = {}

        reg = registry or prometheus.default_registry
        self.m_hits = reg.counter(
            "compile_cache_hits_total",
            "Builds served from the cache instead of the compiler",
        )
        self.m_misses = reg.counter(
            "compile_cache_misses_total",
            "Cache misses by reason (cold / corrupt / expired)",
            labelnames=("reason",),
        )
        self.m_waits = reg.counter(
            "compile_cache_singleflight_waits_total",
            "Compilers that blocked on another replica's in-flight "
            "compile of the same key instead of compiling themselves",
        )
        self.m_evictions = reg.counter(
            "compile_cache_evictions_total",
            "Entries removed by GC, by reason (ttl / lru)",
            labelnames=("reason",),
        )
        self.m_bytes = reg.gauge(
            "compile_cache_bytes",
            "Total artifact bytes the cache currently retains",
        )
        self.m_load = reg.histogram(
            "compile_cache_load_seconds",
            "Digest-verified artifact load latency",
            buckets=_LOAD_BUCKETS,
        )
        self.m_compile = reg.histogram(
            "compile_cache_compile_seconds",
            "Leader compile latency on cache misses",
            buckets=_COMPILE_BUCKETS,
        )

    # -- index (CompileCacheEntry CRs) --------------------------------------

    def _entry(self, key: CompileKey) -> Optional[Obj]:
        try:
            return self.api.get("CompileCacheEntry", key.entry_name)
        except NotFound:
            return None

    def _ensure_entry(self, key: CompileKey, receipt: Obj) -> None:
        entry = {
            "apiVersion": WARMUP_API_VERSION,
            "kind": "CompileCacheEntry",
            "metadata": {"name": key.entry_name},
            "spec": {
                "fingerprint": key.fingerprint,
                "topology": key.topology,
                "compilerVersion": key.compiler_version,
            },
        }
        try:
            entry = self.api.create(entry)
        except AlreadyExists:
            entry = self._entry(key)
            if entry is None:
                return
        entry = obj_util.mutable(entry)
        now = obj_util.now_rfc3339()
        status = dict(entry.get("status") or {})
        status.update(
            {
                "digest": receipt["digest"],
                "sizeBytes": receipt["sizeBytes"],
                "createdAt": status.get("createdAt") or now,
                "lastAccessAt": now,
            }
        )
        if "zones" in receipt:
            status["zones"] = list(receipt["zones"])
            status["replicationDegraded"] = bool(receipt.get("degraded"))
        entry["status"] = status
        try:
            self.api.update_status(entry)
        except (Conflict, NotFound):
            pass  # another replica's put raced; either status is valid

    def _touch(self, entry: Obj) -> None:
        entry = obj_util.mutable(entry)
        status = dict(entry.get("status") or {})
        status["lastAccessAt"] = obj_util.now_rfc3339()
        entry["status"] = status
        try:
            self.api.update_status(entry)
        except (Conflict, NotFound):
            pass  # LRU ordering is advisory; a lost touch is harmless

    def entries(self) -> list[Obj]:
        try:
            return list(self.api.list("CompileCacheEntry"))
        except NotFound:
            return []

    # -- hot path ------------------------------------------------------------

    def load(self, key: CompileKey) -> Optional[bytes]:
        """Cache lookup only (no compile): digest-verified bytes or
        None. A corrupted artifact (no replica verifies) is dropped so
        the next compiler repopulates it."""
        entry = self._entry(key)
        if entry is None:
            return None
        digest = obj_util.get_path(entry, "status", "digest", default="")
        t0 = self.now()
        got = self.store.load(key.key_id, expect_digest=digest or None)
        if got is None:
            # bytes missing or failed the digest check — never hand
            # garbage to the loader; purge so the index can't keep lying
            self.store.delete(key.key_id)
            try:
                self.api.delete("CompileCacheEntry", key.entry_name)
            except NotFound:
                pass
            return None
        self.m_load.observe(max(self.now() - t0, 0.0))
        self._touch(entry)
        return got[0]

    def get_or_compile(
        self, key: CompileKey, compile_fn: Callable[[], bytes]
    ) -> bytes:
        """THE service entrypoint: a digest-verified cache hit, or the
        singleflight-deduplicated compile. N concurrent callers of the
        same key produce exactly one ``compile_fn`` invocation — the
        leader compiles and publishes, followers block on its result.
        A failed leader propagates its error to that round's followers
        (the next caller starts a fresh round)."""
        name = key.entry_name
        while True:
            with self._lock:
                inflight = self._inflight.get(name)
                if inflight is None:
                    leader = _Inflight()
                    self._inflight[name] = leader
                    break
            self.m_waits.inc()
            inflight.event.wait()
            if inflight.error is not None:
                raise inflight.error
            assert inflight.value is not None
            return inflight.value
        try:
            entry = self._entry(key)
            data = self.load(key)
            if data is None:
                reason = "cold" if entry is None else "corrupt"
                if entry is not None and self._expired(entry):
                    reason = "expired"
                self.m_misses.inc({"reason": reason})
                t0 = self.now()
                data = compile_fn()
                self.m_compile.observe(max(self.now() - t0, 0.0))
                self.put(key, data)
            else:
                self.m_hits.inc()
            leader.value = data
            return data
        except BaseException as e:
            leader.error = e
            raise
        finally:
            with self._lock:
                self._inflight.pop(name, None)
            leader.event.set()

    def put(self, key: CompileKey, data: bytes) -> Obj:
        receipt = self.store.save(key.key_id, data)
        self._ensure_entry(key, receipt)
        self.gc()
        return receipt

    # -- retention -----------------------------------------------------------

    def _expired(self, entry: Obj, now: Optional[float] = None) -> bool:
        if self.config.ttl_seconds <= 0:
            return False
        last = obj_util.get_path(
            entry, "status", "lastAccessAt", default=""
        ) or obj_util.get_path(entry, "status", "createdAt", default="")
        if not last:
            return False
        now = self.now() if now is None else now
        return now - obj_util.parse_rfc3339(last) > self.config.ttl_seconds

    def _drop(self, entry: Obj, reason: str) -> None:
        spec = entry.get("spec") or {}
        key = CompileKey(
            fingerprint=spec.get("fingerprint", ""),
            topology=spec.get("topology", ""),
            compiler_version=spec.get("compilerVersion", ""),
        )
        self.store.delete(key.key_id)
        try:
            self.api.delete(
                "CompileCacheEntry", obj_util.name_of(entry)
            )
        except NotFound:
            pass
        self.m_evictions.inc({"reason": reason})

    def gc(self, now: Optional[float] = None) -> int:
        """TTL-expire, then LRU-evict down to ``max_bytes``. Returns
        the number of entries dropped. Runs after every put and from
        the WarmPool controller's periodic reconcile."""
        now = self.now() if now is None else now
        live: list[Obj] = []
        dropped = 0
        for entry in self.entries():
            if self._expired(entry, now=now):
                self._drop(entry, "ttl")
                dropped += 1
            else:
                live.append(entry)
        total = sum(
            int(
                obj_util.get_path(e, "status", "sizeBytes", default=0) or 0
            )
            for e in live
        )
        if self.config.max_bytes > 0 and total > self.config.max_bytes:
            # oldest access first — the LRU axis
            live.sort(
                key=lambda e: obj_util.get_path(
                    e, "status", "lastAccessAt", default=""
                )
                or ""
            )
            for entry in live:
                if total <= self.config.max_bytes:
                    break
                self._drop(entry, "lru")
                total -= int(
                    obj_util.get_path(
                        entry, "status", "sizeBytes", default=0
                    )
                    or 0
                )
                dropped += 1
        self.m_bytes.set(max(total, 0))
        return dropped

    def heal_pass(self) -> int:
        """Re-replicate degraded entries (a zone was down at put time)
        once their zones heal — the session checkpoint heal loop's
        analog, driven from the WarmPool controller's resync."""
        heal = getattr(self.store, "heal", None)
        if heal is None:
            return 0
        healed = 0
        for entry in self.entries():
            status = entry.get("status") or {}
            if not status.get("replicationDegraded"):
                continue
            digest = status.get("digest", "")
            spec = entry.get("spec") or {}
            key = CompileKey(
                fingerprint=spec.get("fingerprint", ""),
                topology=spec.get("topology", ""),
                compiler_version=spec.get("compilerVersion", ""),
            )
            if not digest:
                continue
            replication = heal(key.key_id, digest)
            if not replication["degraded"]:
                entry = obj_util.mutable(entry)
                merged = dict(entry.get("status") or {})
                merged.update(
                    {
                        "zones": list(replication["zones"]),
                        "replicationDegraded": False,
                    }
                )
                entry["status"] = merged
                try:
                    self.api.update_status(entry)
                except (Conflict, NotFound):
                    continue
                healed += 1
        return healed

    # -- build-directory bridge -----------------------------------------------

    def staging_dir(self, tag: str) -> str:
        """A fresh directory a process can use as its
        ``ODH_TORCH_KERNEL_CACHE`` — cold builds land here, then
        ``ingest_dir`` promotes them into the shared store."""
        path = os.path.join(self.root, "staging", tag)
        os.makedirs(path, exist_ok=True)
        return path

    def ingest_dir(
        self,
        path: str,
        topology: str = "",
        compiler_ver: Optional[str] = None,
    ) -> int:
        """Register every library a build directory holds under
        ``path`` (one ``lib<name>-<hash>.so`` per kernel, the file name
        ``ops/_build.py``'s content fingerprint; dot files are builds
        still being written). Returns how many entered the cache."""
        ver = compiler_version() if compiler_ver is None else compiler_ver
        count = 0
        try:
            names = sorted(os.listdir(path))
        except OSError:
            return 0
        for fn in names:
            full = os.path.join(path, fn)
            if not os.path.isfile(full) or fn.startswith("."):
                continue
            with open(full, "rb") as f:
                data = f.read()
            key = CompileKey(
                fingerprint=fn, topology=topology, compiler_version=ver
            )
            digest = self.store.saved_digest(key.key_id)
            if digest == CompileArtifactStore.digest_of(data):
                continue  # already held, bit-identical
            self.put(key, data)
            count += 1
        return count

    def materialize_dir(
        self,
        path: str,
        topology: str = "",
        compiler_ver: Optional[str] = None,
    ) -> int:
        """Stage every digest-verified artifact matching (topology,
        compiler version) into ``path`` under its original file name —
        the directory a warm process (notebook kernel, engine replica)
        mounts as ``ODH_TORCH_KERNEL_CACHE`` so its first launch is a
        load, not an ``nvcc`` build. Each file is written to a temp name
        and moved into place, so a process reading the directory never
        sees a partial library; an artifact whose bytes fail the digest
        check is never written (``load`` purges it)."""
        ver = compiler_version() if compiler_ver is None else compiler_ver
        os.makedirs(path, exist_ok=True)
        count = 0
        for entry in self.entries():
            spec = entry.get("spec") or {}
            if spec.get("topology", "") != topology:
                continue
            if spec.get("compilerVersion", "") != ver:
                continue
            fingerprint = spec.get("fingerprint", "")
            # the fingerprint becomes a filename — refuse anything that
            # could escape the staging directory
            if (
                not fingerprint
                or os.sep in fingerprint
                or fingerprint != os.path.basename(fingerprint)
                or fingerprint.startswith(".")
            ):
                continue
            key = CompileKey(
                fingerprint=fingerprint,
                topology=spec.get("topology", ""),
                compiler_version=spec.get("compilerVersion", ""),
            )
            data = self.load(key)
            if data is None:
                continue
            fd, tmp = tempfile.mkstemp(dir=path, prefix=".tmp-")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(path, fingerprint))
            count += 1
        return count

    def stats(self) -> Obj:
        entries = self.entries()
        return {
            "entries": len(entries),
            "bytes": sum(
                int(
                    obj_util.get_path(e, "status", "sizeBytes", default=0)
                    or 0
                )
                for e in entries
            ),
            "degraded": sum(
                1
                for e in entries
                if obj_util.get_path(
                    e, "status", "replicationDegraded", default=False
                )
            ),
        }


def install_process_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point THIS process's kernel build directory at ``cache_dir`` (or
    ``$ODH_TORCH_KERNEL_CACHE``) — the in-process half of the service:
    the trainer and the engine call it before their first launch, so a
    staged/materialized directory turns their builds into loads.
    Returns None when no directory is configured. A configured
    directory that cannot be used raises (``ops/_build.set_build_dir``),
    as does a switch after a kernel was loaded from another directory:
    a warm start must not quietly turn into a cold one. (JAX's swallows
    every exception and returns None.)"""
    from odh_kubeflow_tpu_torch.ops import _build

    path = cache_dir or os.environ.get(_build.KERNEL_CACHE_ENV, "")
    if not path:
        return None
    _build.set_build_dir(path)
    return path
