"""The durable byte store behind SessionCheckpoints, keyed by notebook
UID (the port's copy of the JAX package's ``sessions/checkpoint.py``).

Session state is an opaque JSON-able tree (kernel variables, execution
counters — whatever the in-pod snapshot hook hands over). It is
canonically serialized once, digested (sha256 — the bit-identity
receipt the resume path and the property tests verify), and written by
one of two backends with the same layout and receipts:

- ``"torch"``: the payload as a uint8 tensor through the port's
  ``train.checkpoint.CheckpointManager`` — the manager training state
  uses, so session snapshots inherit its atomic step directories and
  ``max_to_keep`` GC. (The JAX package's second backend writes through
  orbax and places the array on ``jax.devices()[0]``, because orbax's
  restore API asks for a sharding. A JSON snapshot has no work for the
  card, so here the payload stays a host tensor.) The manager always
  imports here, so ``"auto"`` resolves to it;
- ``"json"``: plain files, ``state-<step>.json``.

**Zone replication** (:class:`ReplicatedCheckpointStore`): a single
backing store is one failure domain — a zone loss takes every
suspended session with it. The replicated store fans each save out to
N zone-scoped backing stores (write-all) and records which zones hold
the bytes in the receipt; the sha256 digest doubles as the cross-zone
bit-identity check, so a load may be served from ANY surviving zone
and verified against the CR receipt. A save that lands in fewer zones
than configured is *degraded*, surfaced on the SessionCheckpoint
status and re-replicated by the SessionManager once the zone heals.

Checkpoint IO is blocking filesystem work: it must never run under
store locks (the SessionManager only calls the store from reconcile
bodies, which hold none).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional

Obj = dict[str, Any]

_META = "session-meta.json"
BACKENDS = ("auto", "torch", "json")


def _canonical(state: Obj) -> bytes:
    return json.dumps(state, sort_keys=True, separators=(",", ":")).encode()


class SessionCheckpointStore:
    """``save(uid, state) → receipt`` / ``load(uid) → (state, digest)``
    / ``delete(uid)``. One subdirectory per notebook UID; re-suspends
    write monotonically increasing steps and old steps are GC'd."""

    def __init__(self, root: str, *, backend: str = "auto", max_to_keep: int = 2):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.root = root
        self.max_to_keep = max_to_keep
        self._backend = "torch" if backend == "auto" else backend
        self._managers: dict[str, Any] = {}

    @property
    def backend(self) -> str:
        return self._backend

    # -- paths / metadata ----------------------------------------------------

    def _dir(self, uid: str) -> str:
        return os.path.join(self.root, uid)

    def _meta_path(self, uid: str) -> str:
        return os.path.join(self._dir(uid), _META)

    def _read_meta(self, uid: str) -> Optional[Obj]:
        try:
            with open(self._meta_path(uid)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_meta(self, uid: str, meta: Obj) -> None:
        os.makedirs(self._dir(uid), exist_ok=True)
        tmp = self._meta_path(uid) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path(uid))

    # -- torch backend -------------------------------------------------------

    def _manager(self, uid: str):
        mngr = self._managers.get(uid)
        if mngr is None:
            from odh_kubeflow_tpu_torch.train.checkpoint import CheckpointManager

            mngr = self._managers[uid] = CheckpointManager(
                os.path.join(self._dir(uid), "torch"),
                max_to_keep=self.max_to_keep,
                # synchronous: the suspend path needs the snapshot
                # durable before the pods are torn down
                async_save=False,
            )
        return mngr

    # -- API -----------------------------------------------------------------

    def save(self, uid: str, state: Obj) -> Obj:
        """Persist ``state`` for ``uid``; returns the receipt
        ``{"step", "digest", "sizeBytes"}`` the SessionCheckpoint
        status records."""
        payload = _canonical(state)
        digest = hashlib.sha256(payload).hexdigest()
        prev = self._read_meta(uid)
        step = (int(prev["step"]) + 1) if prev else 0
        if self.backend == "torch":
            import torch

            mngr = self._manager(uid)
            mngr.save(
                step, {"session": torch.frombuffer(bytearray(payload), dtype=torch.uint8)},
                force=True,
            )
            mngr.wait_until_finished()
        else:
            os.makedirs(self._dir(uid), exist_ok=True)
            with open(self._step_path(uid, step), "wb") as f:
                f.write(payload)
            for old in self._json_steps(uid)[: -self.max_to_keep]:
                try:
                    os.remove(self._step_path(uid, old))
                except OSError:
                    pass
        meta = {"step": step, "digest": digest, "sizeBytes": len(payload)}
        self._write_meta(uid, meta)
        return dict(meta)

    def load(
        self, uid: str, expect_digest: Optional[str] = None
    ) -> Optional[tuple[Obj, str]]:
        """The latest state for ``uid`` plus the digest of the bytes
        actually read back (callers compare it against the saved
        receipt — the bit-identity check), or None when nothing is
        stored. ``expect_digest`` is accepted for signature parity
        with :class:`ReplicatedCheckpointStore` (a single store has no
        alternative zone to fall back to, so it is ignored here)."""
        meta = self._read_meta(uid)
        if meta is None:
            return None
        step = int(meta["step"])
        if self.backend == "torch":
            import torch

            like = {"session": torch.empty(int(meta["sizeBytes"]), dtype=torch.uint8)}
            try:
                restored = self._manager(uid).restore(like, step=step)
            except FileNotFoundError:
                return None
            payload = restored["session"].numpy().tobytes()
        else:
            try:
                with open(self._step_path(uid, step), "rb") as f:
                    payload = f.read()
            except OSError:
                return None
        digest = hashlib.sha256(payload).hexdigest()
        return json.loads(payload.decode()), digest

    def exists(self, uid: str) -> bool:
        return self._read_meta(uid) is not None

    def delete(self, uid: str) -> bool:
        """Returns whether the delete is complete (duck parity with
        :class:`ReplicatedCheckpointStore` — a single local store's
        rmtree either finished or the leftovers are observable)."""
        mngr = self._managers.pop(uid, None)
        if mngr is not None:
            mngr.close()
        shutil.rmtree(self._dir(uid), ignore_errors=True)
        return not os.path.exists(self._dir(uid))

    def close(self) -> None:
        for uid in list(self._managers):
            self._managers.pop(uid).close()

    # -- json backend helpers ------------------------------------------------

    def _step_path(self, uid: str, step: int) -> str:
        return os.path.join(self._dir(uid), f"state-{step:08d}.json")

    def saved_digest(self, uid: str) -> Optional[str]:
        """The digest of the newest save recorded in this store's own
        metadata (no byte read) — what the replicated store compares
        across zones to find which ones are current."""
        meta = self._read_meta(uid)
        return str(meta["digest"]) if meta and "digest" in meta else None

    def _json_steps(self, uid: str) -> list[int]:
        try:
            names = os.listdir(self._dir(uid))
        except OSError:
            return []
        steps = []
        for n in names:
            if n.startswith("state-") and n.endswith(".json"):
                try:
                    steps.append(int(n[len("state-"):-len(".json")]))
                except ValueError:
                    pass
        return sorted(steps)


# ---------------------------------------------------------------------------
# zone replication


def parse_zone_spec(spec: str, default_root: str) -> dict[str, str]:
    """``SESSION_CHECKPOINT_ZONES`` parser: a comma-separated list of
    ``zone=path`` entries (independent PVCs / buckets, one per zone) or
    bare zone names, which become subdirectories of ``default_root``
    (sim / single-volume dev). Order is preserved — the first zone is
    the preferred read source. Empty spec → no replication."""
    zones: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            zone, _, path = part.partition("=")
            zones[zone.strip()] = path.strip()
        else:
            zones[part] = os.path.join(default_root, part)
    return zones


class ReplicatedCheckpointStore:
    """Zone-replicated façade over N :class:`SessionCheckpointStore`
    backing stores, one per failure domain (``topology.kubernetes.io/
    zone``). Same duck type as the single store — the SessionManager
    swaps it in unchanged — plus the replication surface:

    - ``save`` is **write-all**: the canonical bytes go to every zone;
      the receipt records ``zones`` (where the write actually became
      durable) and ``degraded`` (fewer zones than configured). At
      least one zone must land or the save raises — a checkpoint with
      zero durability receipts must never release the GPUs.
    - ``load`` reads from **any surviving zone**, newest first; when
      the caller passes the CR receipt digest, zones whose bytes read
      back different (stale step, bit rot, torn volume) are skipped in
      favor of a zone that verifies — the sha256 receipt is the
      cross-zone bit-identity rail.
    - ``heal`` re-replicates the newest verified state into zones that
      missed it (the zone-heal half of the degraded contract).

    ``fail_zone``/``heal_zone`` are the deterministic outage hooks the
    drills use; real IO errors on a zone degrade the same way."""

    def __init__(self, zones: dict[str, str], *, backend: str = "auto", max_to_keep: int = 2):
        if not zones:
            raise ValueError("ReplicatedCheckpointStore needs >=1 zone")
        self.stores: dict[str, SessionCheckpointStore] = {
            zone: SessionCheckpointStore(path, backend=backend, max_to_keep=max_to_keep)
            for zone, path in zones.items()
        }
        self._failed: set[str] = set()

    @property
    def zones(self) -> list[str]:
        return list(self.stores)

    # -- outage hooks --------------------------------------------------------

    def fail_zone(self, zone: str) -> None:
        """Take ``zone`` offline: reads and writes against it behave
        exactly like a dead volume (skipped / degraded)."""
        if zone in self.stores:
            self._failed.add(zone)

    def heal_zone(self, zone: str) -> None:
        self._failed.discard(zone)

    def failed_zones(self) -> list[str]:
        return sorted(self._failed)

    # -- the SessionCheckpointStore duck -------------------------------------

    def save(self, uid: str, state: Obj) -> Obj:
        """Write-all with per-zone durability receipts. The returned
        receipt extends the single-store shape with ``zones`` (the
        list that actually landed) and ``degraded``."""
        receipt: Optional[Obj] = None
        landed: list[str] = []
        for zone, store in self.stores.items():
            if zone in self._failed:
                continue
            try:
                zone_receipt = store.save(uid, state)
            except OSError:
                continue  # this zone is down; the receipt records it
            landed.append(zone)
            if receipt is None:
                receipt = zone_receipt
        if receipt is None:
            raise OSError(
                f"checkpoint for {uid} landed in no zone "
                f"(configured: {', '.join(self.stores)})"
            )
        receipt["zones"] = landed
        receipt["degraded"] = len(landed) < len(self.stores)
        return receipt

    def load(
        self, uid: str, expect_digest: Optional[str] = None
    ) -> Optional[tuple[Obj, str]]:
        """The newest stored state from any surviving zone. With
        ``expect_digest`` (the CR receipt) the first zone whose bytes
        verify wins; a zone holding stale or corrupt bytes is skipped
        while ANY zone still verifies. Without it (or when no zone
        verifies) the newest-step zone is served and the caller's own
        digest check decides. Candidate selection reads only each
        zone's metadata; the bytes are read from chosen zones only."""
        candidates: list[tuple[int, str]] = []  # (step, zone), meta-only
        for zone, store in self.stores.items():
            if zone in self._failed:
                continue
            meta = store._read_meta(uid)
            if meta is None:
                continue
            if expect_digest and meta.get("digest") == expect_digest:
                try:
                    loaded = store.load(uid)
                except OSError:
                    continue
                # verify the BYTES too — a meta that matches over torn
                # bytes must not end the scan early
                if loaded is not None and loaded[1] == expect_digest:
                    return loaded
                continue
            candidates.append((int(meta.get("step", 0)), zone))
        for _step, zone in sorted(candidates, reverse=True):
            try:
                loaded = self.stores[zone].load(uid)
            except OSError:
                continue
            if loaded is not None:
                return loaded
        return None

    def exists(self, uid: str) -> bool:
        return any(
            store.exists(uid)
            for zone, store in self.stores.items()
            if zone not in self._failed
        )

    def delete(self, uid: str) -> bool:
        """Delete ``uid``'s bytes from every reachable zone. Returns
        whether the delete is COMPLETE — False while any zone (failed,
        or erroring) may still hold bytes, so the caller keeps the CR
        (the only uid→bytes record) and retries after the zone heals
        instead of orphaning a checkpoint on the dark volume forever."""
        complete = True
        for zone, store in self.stores.items():
            if zone in self._failed:
                complete = False
                continue
            try:
                store.delete(uid)
            except OSError:
                complete = False
                continue
            if store.exists(uid):
                complete = False
        return complete

    def close(self) -> None:
        for store in self.stores.values():
            store.close()

    # -- replication status & heal -------------------------------------------

    def replication_status(self, uid: str, digest: str) -> Obj:
        """Which zones hold bytes verifying against ``digest`` (the CR
        receipt): ``{"zones": [...], "missing": [...], "degraded"}``.
        Zones currently failed count as missing — their bytes are
        unreachable whether or not they exist."""
        holding: list[str] = []
        missing: list[str] = []
        for zone, store in self.stores.items():
            if zone not in self._failed and store.saved_digest(uid) == digest:
                holding.append(zone)
            else:
                missing.append(zone)
        return {"zones": holding, "missing": missing, "degraded": bool(missing) or not holding}

    def heal(self, uid: str, digest: str) -> Obj:
        """Re-replicate after a zone heals: copy the newest VERIFIED
        state (any zone whose read-back matches ``digest``) into every
        reachable zone that lacks it, and return the refreshed
        :meth:`replication_status`. A no-op (current status returned)
        while no verifying source zone is reachable."""
        source: Optional[Obj] = None
        for zone, store in self.stores.items():
            if zone in self._failed:
                continue
            try:
                loaded = store.load(uid)
            except OSError:
                continue
            if loaded is not None and loaded[1] == digest:
                source = loaded[0]
                break
        if source is not None:
            for zone, store in self.stores.items():
                if zone in self._failed or store.saved_digest(uid) == digest:
                    continue
                try:
                    store.save(uid, source)
                except OSError:
                    continue  # still down; next heal pass retries
        return self.replication_status(uid, digest)
