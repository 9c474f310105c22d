"""Write-ahead log + snapshot store for the embedded APIServer (the
port's copy of the JAX package's ``machinery/wal.py``).

The store is an in-process dict; a crash loses every object, every
resourceVersion, and every durable-checkpoint receipt the sessions
subsystem depends on. This module gives it the etcd posture the
reference platform inherits for free:

- every mutation appends one checksummed, length-prefixed record and
  is fsync'd **before the API call returns** (ack-after-durable);
- a periodic snapshot (every ``SNAPSHOT_INTERVAL`` mutations) bounds
  replay time; segments older than the snapshot are GC'd;
- recovery loads the newest snapshot and replays the WAL tail,
  rebuilding objects, the rv counter, and the bounded watch cache so
  informer/client rv resumes keep working across a restart.

Crash consistency holds at any byte:

- a torn tail record (the crash interrupted the final append) is
  detected by its checksum/length and truncated — it can never have
  been acked, because the ack follows the fsync;
- a corrupt record **mid-log** (valid records follow it) cannot be a
  torn write — fsync ordering means everything before the tail was
  durable — so it is disk rot and recovery fails loudly
  (:class:`WALCorruptError`) instead of silently dropping acked
  writes;
- recovery is therefore prefix-consistent: the recovered store is
  exactly the acked history up to the final complete record.

Record framing: ``<u32 length><u32 crc32(payload)><payload>`` with the
payload a canonical JSON document (``machinery.serialize``). Snapshots
use the same framing in a single-record file, written to a temp name,
fsync'd, then atomically renamed.

All file IO goes through a swappable :class:`FileIO` so the fault
drills (``machinery.faults.FaultyFileIO`` / ``KillPointIO``) can
inject torn writes, failed fsyncs, short reads, slow disks, and
process death at randomized commit points. Both locks come from the
lock-order sanitizer's factory (``analysis/sanitizer.py``), raw
``threading.Lock`` objects unless ``GRAFT_SANITIZE=1``.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Iterator, Optional

from odh_kubeflow_tpu_torch.analysis import sanitizer as _sanitizer
from odh_kubeflow_tpu_torch.machinery import serialize

Obj = dict[str, Any]

_HEADER = struct.Struct("<II")  # (payload length, crc32(payload))

# a claimed record length beyond this is a torn/garbage header, not a
# real record (snapshots are single-record files and may be large;
# per-mutation records are single objects)
MAX_RECORD_BYTES = 256 * 1024 * 1024

SNAPSHOT_PREFIX = "snap-"
SEGMENT_PREFIX = "wal-"


class CrashPoint(BaseException):
    """Simulated process death, raised by the drills' fault IO at a
    randomized commit point (mid-write, pre-fsync, pre-ack…). A
    BaseException on purpose: recovery paths that catch ``Exception``
    must not be able to swallow a crash — it propagates to the drill
    harness, which abandons the 'dead' process's store and recovers a
    fresh one from disk."""


class WALCorruptError(Exception):
    """A record failed its checksum *before* the log tail — disk
    corruption, not a torn write. Recovery must stop loudly: silently
    skipping it would drop acked writes mid-history."""


class FileIO:
    """The WAL's entire OS surface, swappable for fault injection.

    Append-path methods (``write``/``fsync``) operate on an open file
    object; read/rename paths take paths. The default implementation
    is the obvious passthrough."""

    def open_append(self, path: str):
        return open(path, "ab")

    def open_trunc(self, path: str):
        return open(path, "wb")

    def write(self, f, data: bytes) -> None:
        f.write(data)

    def fsync(self, f) -> None:
        f.flush()
        os.fsync(f.fileno())

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def fsync_dir(self, path: str) -> None:
        # the rename itself must be durable (POSIX: fsync the directory)
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return  # platform without directory fds
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def truncate(self, path: str, size: int) -> None:
        with open(path, "r+b") as f:
            f.truncate(size)

    def remove(self, path: str) -> None:
        os.remove(path)


def _encode(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def _iter_records(
    data: bytes, *, final_segment: bool, where: str
) -> Iterator[tuple[int, Obj]]:
    """Yield ``(end_offset, record)`` for each complete, checksummed
    record. A parse/checksum failure at the tail of the final segment
    is a torn write (the caller truncates to the last good offset); the
    same failure anywhere else is :class:`WALCorruptError`."""
    off = 0
    n = len(data)
    while off < n:
        torn = None
        if n - off < _HEADER.size:
            torn = "partial header"
        else:
            length, crc = _HEADER.unpack_from(data, off)
            if length > MAX_RECORD_BYTES:
                torn = f"implausible record length {length}"
            elif n - off - _HEADER.size < length:
                torn = "partial payload"
            else:
                start = off + _HEADER.size
                payload = data[start : start + length]
                if zlib.crc32(payload) != crc:
                    # a bad checksum with MORE data after the record is
                    # mid-log corruption; at the very tail it is a torn
                    # write of the final record
                    if start + length < n or not final_segment:
                        raise WALCorruptError(
                            f"{where}: checksum mismatch at offset {off} "
                            f"with {n - start - length} bytes following "
                            "— mid-log corruption, refusing to recover"
                        )
                    torn = "checksum mismatch on final record"
        if torn is not None:
            if not final_segment:
                raise WALCorruptError(
                    f"{where}: {torn} at offset {off} in a sealed "
                    "segment — mid-log corruption, refusing to recover"
                )
            return  # caller truncates to `off`
        off += _HEADER.size + length
        try:
            rec = json.loads(payload.decode())
        except (UnicodeDecodeError, ValueError) as e:
            raise WALCorruptError(
                f"{where}: checksummed record at offset {off} is not "
                f"valid JSON ({e}) — refusing to recover"
            ) from None
        yield off, rec


class WriteAheadLog:
    """Segmented WAL + snapshot store rooted at ``directory``.

    Layout: ``wal-<seq>.log`` append segments and ``snap-<rv>.json``
    snapshot files. :meth:`append` is called by the store under its
    lock (single writer); :meth:`recover` is called before any
    appends. A snapshot seals the current segment, starts the next,
    and GCs everything the snapshot covers.
    """

    def __init__(
        self,
        directory: str,
        io: Optional[FileIO] = None,
        fsync: bool = True,
    ):
        self.dir = directory
        self.io = io or FileIO()
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._f = None  # open append handle for the active segment
        self._seq = 0
        self.records_since_snapshot = 0
        self.bytes_since_snapshot = 0
        self.appended_total = 0
        self.fsync_total = 0
        # segment-file coordination: the group committer's
        # write-batch/fsync vs a snapshot's rotate + GC. The snapshot's
        # own serialization and tmp-file write run OUTSIDE this lock
        # (different file), so appends never stall behind a fleet-sized
        # snapshot dump — only the O(1) rotate excludes them. Built
        # through the sanitizer factory so the runtime order graph and
        # graftlint's static lock ranks share the "wal.io" name (and so
        # the schedule explorer can serialize it).
        self.io_lock = _sanitizer.new_lock("wal.io")
        # one snapshot at a time (the cadence snapshot on the committer
        # and a manual ``snapshot_now`` may overlap)
        self._snap_lock = _sanitizer.new_lock("wal.snapshot")
        # sealed segment seq → max record rv it contains. Snapshot GC
        # may only remove a sealed segment whose every record the
        # snapshot covers (max rv ≤ snapshot rv) — with appends now
        # running CONCURRENTLY with snapshots, position alone no longer
        # proves coverage. Unknown segments are never removed (a leaked
        # file beats lost acked history).
        self._seg_max_rv: dict[int, int] = {}
        self._active_max_rv = 0

    # -- directory scan ------------------------------------------------------

    def _segments(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(SEGMENT_PREFIX) and name.endswith(".log"):
                try:
                    seq = int(name[len(SEGMENT_PREFIX) : -len(".log")])
                except ValueError:
                    continue
                out.append((seq, os.path.join(self.dir, name)))
        return sorted(out)

    def _snapshots(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(SNAPSHOT_PREFIX) and name.endswith(".json"):
                try:
                    rv = int(name[len(SNAPSHOT_PREFIX) : -len(".json")])
                except ValueError:
                    continue
                out.append((rv, os.path.join(self.dir, name)))
        return sorted(out)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{SEGMENT_PREFIX}{seq:08d}.log")

    def _clean_tmp(self) -> None:
        """Unlink orphaned snapshot temp files (a crash or IO failure
        between open_trunc and the atomic rename leaves one behind per
        attempt, each at a unique rv — without this they accumulate
        forever, since the snapshot GC only scans *.json)."""
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                try:
                    self.io.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    # -- append path ---------------------------------------------------------

    def _ensure_open(self) -> None:
        if self._f is None:
            self._f = self.io.open_append(self._segment_path(self._seq))

    def write_record(self, record: Obj) -> None:
        """Write one record to the active segment WITHOUT making it
        durable — the group committer's per-record half. Must be called
        under ``io_lock``; the batch's covering :meth:`sync` follows.
        A raise means the record may be torn on disk; it was never
        acked (acks follow the fsync), so recovery truncates it."""
        self._ensure_open()
        data = _encode(serialize.dumps(record))
        self.io.write(self._f, data)
        try:
            rv = int(record.get("rv", 0))
        except (TypeError, ValueError):
            rv = 0
        if rv > self._active_max_rv:
            self._active_max_rv = rv
        self.records_since_snapshot += 1
        self.bytes_since_snapshot += len(data)
        self.appended_total += 1

    def sync(self) -> None:
        """Make everything written so far durable — ONE fsync covering
        the whole batch of preceding :meth:`write_record` calls (the
        group-commit fsync). Must be called under ``io_lock``."""
        if self._f is None:
            return
        if self.fsync:
            self.io.fsync(self._f)
            self.fsync_total += 1
        else:
            self._f.flush()

    def append(self, record: Obj) -> None:
        """Write one record and make it durable (a batch of one). The
        caller only acks the mutation after this returns — a raise here
        means the write was never acked and must not be applied."""
        with self.io_lock:
            self.write_record(record)
            self.sync()  # graftlint: disable=blocking-reachable-under-lock wal.io exists to serialize fsync batches; nothing else contends it during an append

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    # -- snapshot ------------------------------------------------------------

    def snapshot(self, state: Obj, rv: int) -> None:
        """Atomically persist a full-state snapshot at resourceVersion
        ``rv``, rotate to a fresh segment, and GC covered history.

        The caller hands in a frozen CUT of the store (shallow object
        references collected under the store lock — stored objects are
        immutable once written, so the cut stays consistent); the
        serialization and the snapshot-file IO here run with NO lock
        shared with the append path, so a fleet-sized snapshot never
        stalls mutations for its dump time. Only the O(1) rotate + GC
        at the end takes ``io_lock``, and GC is guarded by per-segment
        max-rv bookkeeping so records appended concurrently with the
        snapshot (rv > snapshot rv) always survive."""
        with self._snap_lock:
            self._clean_tmp()  # orphans from earlier failed attempts
            path = os.path.join(self.dir, f"{SNAPSHOT_PREFIX}{rv:016d}.json")
            tmp = path + ".tmp"
            f = self.io.open_trunc(tmp)
            try:
                self.io.write(f, _encode(serialize.dumps(state)))
                self.io.fsync(f)  # graftlint: disable=blocking-reachable-under-lock wal.snapshot only serializes snapshot attempts; the append path never takes it
            finally:
                f.close()
            self.io.replace(tmp, path)
            self.io.fsync_dir(self.dir)
            with self.io_lock:
                # rotate: seal the active segment (recording its max
                # rv), start the next
                sealed = self._seq
                self._seg_max_rv[sealed] = self._active_max_rv
                self._active_max_rv = 0
                self.close()
                self._seq = sealed + 1
                self.records_since_snapshot = 0
                self.bytes_since_snapshot = 0
                # GC: older snapshots and fully-covered sealed
                # segments. Best-effort — a failed unlink costs disk,
                # never correctness (replay skips rv <= snapshot rv);
                # a segment with any record above the snapshot rv (a
                # concurrent append) is kept.
                for srv, spath in self._snapshots():
                    if srv < rv:
                        try:
                            self.io.remove(spath)
                        except OSError:
                            pass
                for seq, spath in self._segments():
                    if seq <= sealed and self._seg_max_rv.get(seq, rv + 1) <= rv:
                        try:
                            self.io.remove(spath)
                            self._seg_max_rv.pop(seq, None)
                        except OSError:
                            pass

    # -- recovery ------------------------------------------------------------

    def _read_stable(self, path: str) -> bytes:
        """Read until two consecutive reads agree. A transient short
        read (bad cable, injected fault) must NOT be mistaken for a
        torn tail — truncating on one would destroy acked history. A
        read that never stabilizes raises OSError: the operator (or
        drill) retries recovery; a *deterministically* truncated file
        is real corruption and flows into the normal torn/corrupt
        handling."""
        prev = self.io.read_bytes(path)
        for _ in range(5):
            cur = self.io.read_bytes(path)
            if cur == prev:
                return cur
            prev = cur
        raise OSError(
            f"unstable reads of {path} (transient short read?); "
            "retry recovery"
        )

    def recover(self) -> tuple[Optional[Obj], list[Obj]]:
        """Load the newest snapshot (None if there is none) and the
        replayable WAL tail. Torn final records are physically
        truncated so a later recovery sees a clean log; mid-log
        corruption raises :class:`WALCorruptError`. After recovery the
        log is rotated to a fresh segment, ready for appends."""
        self._clean_tmp()  # crash orphans from the previous incarnation
        snap: Optional[Obj] = None
        snaps = self._snapshots()
        if snaps:
            rv, path = snaps[-1]
            data = self._read_stable(path)
            recs = list(
                _iter_records(data, final_segment=False, where=path)
            )
            if len(recs) != 1:
                raise WALCorruptError(
                    f"{path}: snapshot must contain exactly one record "
                    f"(found {len(recs)})"
                )
            snap = recs[0][1]
        records: list[Obj] = []
        segments = self._segments()
        replay_bytes = 0
        for i, (seq, path) in enumerate(segments):
            final = i == len(segments) - 1
            data = self._read_stable(path)
            good_end = 0
            seg_max = 0
            for end, rec in _iter_records(
                data, final_segment=final, where=path
            ):
                good_end = end
                records.append(rec)
                try:
                    seg_max = max(seg_max, int(rec.get("rv", 0)))
                except (TypeError, ValueError):
                    pass
            replay_bytes += good_end
            # every pre-existing segment is sealed from this
            # incarnation's viewpoint (appends go to a fresh seq);
            # record its max rv so the next snapshot's GC can prove
            # coverage
            self._seg_max_rv[seq] = seg_max
            if final and good_end < len(data):
                # torn tail: drop the partial record on disk too, so
                # the next recovery's mid-log rule stays sound
                self.io.truncate(path, good_end)
        self._seq = (segments[-1][0] + 1) if segments else 0
        self._active_max_rv = 0
        self.records_since_snapshot = len(records)
        self.bytes_since_snapshot = replay_bytes
        return snap, records
