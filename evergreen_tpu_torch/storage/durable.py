"""Durable store engine: append-only WAL + snapshot compaction.

A copy of ``evergreen_tpu/storage/durable.py``, with its file names,
record formats and replay rules, so either package opens a data
directory the other wrote. Every write that lands in a collection is
appended to a write-ahead log before the call returns, and recovery
replays ``snapshot.json`` + ``wal.log`` into an ordinary in-memory
store: a process killed mid-run resumes with every document intact.

- Ops are journaled through ``Collection(journal=...)``
  (``storage/store.py``): full-document puts, plus the narrow records of
  the tick's write shapes (``um``, ``u`` with its expected previous
  version, ``pl``, ``qs``). Serialization happens under the collection
  lock, so WAL order is apply order; the append is flushed per op
  (``sync="flush"``: an OS-level write survives SIGKILL) or fsynced
  (``sync="fsync"``: survives power loss).
- Group commit: ``begin_tick()`` opens a tick-scoped buffer; every op
  until ``end_tick()`` serializes at once but lands in one framed line
  ``{"o":"g","n":N,"e":E,"ts":T,"rs":[...]}`` with a single flush. A
  torn write of the frame loses the whole group (the unterminated line
  is repaired into one unparseable line on reopen), never part of a
  tick. ``end_tick_async()`` hands the frame to a flusher thread, so the
  file write of tick *t* overlaps the pack and solve of tick *t+1*; a
  deferred write error surfaces at the next ``sync_persist()`` barrier.
  Non-tick writes landing while a group is open ride in its frame, and
  per-op appends made while frames wait on the flusher queue behind
  them (``_defer_behind_pending``), so WAL order stays apply order.
- Compaction writes a point-in-time snapshot (tmp + rename, its CRC in
  the ``.meta`` sidecar written first) and rotates the WAL to
  ``wal.log.prev``; it runs when the WAL passes ``compact_every_ops``
  and at ``close()``.
- Integrity (``storage/integrity.py``): every WAL line carries a CRC32
  stamp. Replay stops at the first line that fails it (the end of the
  valid prefix), quarantines a snapshot that fails its digest and
  rebuilds from the ``.prev`` generation and both WALs, then writes a
  fresh checkpoint. A commit that meets ENOSPC sheds its group loudly,
  floors the store's overload ladder at RED, and the next accepted frame
  heals with a checkpoint of the in-memory truth. ``scrub()`` runs the
  same detection on a live store.
- Fencing: a store opened with a ``lease`` binds to its epoch, stamps
  every record with it (``"e"``) and writes a fence marker
  ``{"o":"f","e":E}`` at open. A commit re-reads the lease file and, once
  a newer epoch is issued, drops its group, stands the lease down and
  raises ``EpochFencedError``; the store never writes again. Replay
  drops the records of a superseded epoch that land past a newer fence
  point.

Left out, with the scenario trace capture that is their only caller:
the journal taps (``add_journal_tap``); with tracing: the flusher's
``wal.flush`` span and the frame's trace context.
"""
from __future__ import annotations

import errno
import json
import os
import re
import shutil
import threading
import time as _time
from typing import Dict, Optional

from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics
from ..utils.log import get_logger
from . import integrity as _integrity
from .lease import EpochFencedError, FileLease
from .store import Collection, Store, apply_wal_record

SNAPSHOT_FILE = "snapshot.json"
WAL_FILE = "wal.log"
#: sidecar suffix of the checkpoint watermark ``{"seq","epoch","crc"}``,
#: written atomically before the snapshot renames into place
SNAPSHOT_META_SUFFIX = ".meta"

_SEGMENT_RE = re.compile(r"^(?:wal\.shard(\d+)\.log|snapshot\.shard(\d+)\.json)$")


def fleet_segment_ids(data_dir: str) -> list:
    """Shard ids with a WAL segment or snapshot in ``data_dir`` (sorted;
    ``None`` for the unsharded files). Shard k journals to
    ``wal.shard<k>.log`` / ``snapshot.shard<k>.json``
    (``parallel/topology.py``), so one directory holds a whole fleet."""
    ids = set()
    try:
        names = os.listdir(data_dir)
    except OSError:
        return []
    for name in names:
        if name in (WAL_FILE, SNAPSHOT_FILE):
            ids.add(None)
            continue
        m = _SEGMENT_RE.match(name)
        if m:
            ids.add(int(m.group(1) or m.group(2)))
    return sorted(ids, key=lambda k: (k is not None, k))


WAL_STALE_FRAMES_DROPPED = _metrics.counter(
    "wal_stale_frames_dropped_total",
    "Superseded-epoch WAL frames dropped at replay (a deposed holder's "
    "writes landing past the fence point).",
    legacy="wal.stale_frames_dropped",
)
LEASE_FENCED = _metrics.counter(
    "lease_fenced_total",
    "Writers fenced after observing a newer lease epoch; the holder "
    "stands down and refuses every further write.",
    legacy="lease.fenced",
)
WAL_FLUSH_MS = _metrics.histogram(
    "wal_flush_duration_ms",
    "Wall time of one WAL group-frame write+flush (sync commits and "
    "async flusher frames alike).",
)
WAL_FLUSH_BACKLOG = _metrics.gauge(
    "wal_flush_backlog",
    "Frames waiting on (or being written by) the async WAL flusher.",
)
WAL_CORRUPT_FRAMES = _metrics.counter(
    "wal_corrupt_frames_total",
    "CRC-failed WAL lines treated as end-of-valid-prefix (replay and "
    "replica tailer alike): never applied, never halting serving.",
    legacy="storage.wal_corrupt_frames",
)
WAL_ENOSPC_SHEDS = _metrics.counter(
    "wal_enospc_sheds_total",
    "Tick group frames shed because the disk reported ENOSPC at commit; "
    "the overload floor flips to RED and a heal checkpoint re-covers "
    "the shed writes from memory truth once the disk accepts again.",
    legacy="storage.enospc_sheds",
)
SNAPSHOT_QUARANTINED = _metrics.counter(
    "storage_snapshot_quarantined_total",
    "Snapshots whose whole-file digest (or parse) failed and were moved "
    "aside as .corrupt-<ts> instead of being replayed as truth.",
    legacy="storage.snapshot_quarantined",
)
STORAGE_REBUILDS = _metrics.counter(
    "storage_rebuilds_total",
    "Self-heal rebuilds after detected storage rot: recovery or scrub "
    "quarantined something and re-covered state with a fresh verified "
    "checkpoint.",
    legacy="storage.rebuilds",
)


def _read_meta(path: str):
    """A snapshot's ``.meta`` sidecar, or None when missing or unreadable."""
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _keep_corrupt_copy(path: str) -> None:
    """A forensic copy of a rotted WAL beside it (``.corrupt-<ms>``)."""
    try:
        shutil.copyfile(path, "%s.corrupt-%d" % (path, int(_time.time() * 1000)))
    except OSError:
        pass


class _Journal:
    """Append-only op log shared by all collections of one store."""

    def __init__(self, path: str, sync: str = "flush") -> None:
        self.path = path
        self.sync = sync  # "none" | "flush" | "fsync"
        self._lock = _lockcheck.make_lock("wal.journal")
        # repair a torn tail before appending: a crash mid-append leaves
        # an unterminated line, and appending onto it would merge two
        # records into one terminated-but-corrupt line
        try:
            if os.path.getsize(path) > 0:
                with open(path, "rb") as fh:
                    fh.seek(-1, os.SEEK_END)
                    if fh.read(1) != b"\n":
                        with open(path, "a", encoding="utf-8") as repair:
                            repair.write("\n")
        except FileNotFoundError:
            pass
        self._fh = open(path, "a", encoding="utf-8")
        self.ops = 0
        #: monotone count of terminated WAL lines ever written to this log
        #: (across rotations; re-seeded at recovery): each line's ``"s"``
        self.total_lines = 0
        self.suspended = False  # True during recovery replay
        #: writer's fencing epoch (0 = unfenced), stamped on every record
        self.epoch = 0
        #: the open group's serialized records (None: no group open)
        self._group: Optional[list] = None
        #: an injected half-line is waiting for its terminator
        self._torn = False
        #: owner hook (DurableStore._defer_behind_pending), called under
        #: _lock with a serialized line when no group is open: True if
        #: the line was queued behind unflushed frames
        self.deferred = None

    def begin_group(self) -> None:
        """Open the tick-scoped buffer (a nested begin is a no-op)."""
        with self._lock:
            if self._group is None:
                self._group = []

    def append(self, record: dict) -> None:
        if self.suspended:
            return
        if self.epoch:
            record["e"] = self.epoch
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            if self._group is not None:
                self._group.append(line)
                return
            if self.deferred is not None and self.deferred(line):
                return
        # the per-op seam: "torn" writes half a line then raises (a
        # crash mid-append), "short" writes half silently
        from ..utils import faults

        directive = faults.fire("wal.append")
        self._write_line(line, directive, n_ops=1)

    def commit_group(self, records: list, epoch: int = 0) -> None:
        """Write buffered records as one torn-safe frame with one flush,
        stamped with the writer's epoch and the commit's wall time
        (``"ts"``). The ``wal.commit`` seam fires once per frame."""
        if not records:
            return
        from ..utils import faults

        directive = faults.fire("wal.commit")
        ts = round(_time.time(), 3)
        if epoch:
            frame = '{"o":"g","n":%d,"e":%d,"ts":%s,"rs":[%s]}' % (
                len(records), epoch, ts, ",".join(records))
        else:
            frame = '{"o":"g","n":%d,"ts":%s,"rs":[%s]}' % (
                len(records), ts, ",".join(records))
        self._write_line(frame, directive, n_ops=len(records))

    def _write_line(self, line: str, directive, n_ops: int) -> None:
        if directive in ("torn", "short"):
            with self._lock:
                self._fh.write(line[: max(1, len(line) // 2)])
                self._fh.flush()
                self._torn = True
            if directive == "torn":
                raise OSError("injected torn WAL append")
            return
        with self._lock:
            if self._torn:
                # terminate the injected stub: it becomes one unparseable
                # line, every later record stays intact
                self._fh.write("\n")
                self._torn = False
                self.total_lines += 1
            self.total_lines += 1
            # the line's ordinal, then the CRC stamp over all of it
            line = _integrity.stamp_wal_line('%s,"s":%d}' % (line[:-1], self.total_lines))
            self._fh.write(line + "\n")
            if self.sync != "none":
                self._fh.flush()
                if self.sync == "fsync":
                    os.fsync(self._fh.fileno())
            self.ops += n_ops
            if directive == "bitrot":
                # the line committed, then a byte rotted mid-line: the
                # CRC (not the parser) has to catch it
                self._fh.flush()
                nbytes = len(line.encode("utf-8")) + 1
                size = os.path.getsize(self.path)
                _integrity.corrupt_byte(self.path, max(0, size - 1 - nbytes // 2))

    def rotate(self) -> None:
        """Start a fresh log generation (a new inode) after a snapshot;
        the outgoing one is kept as ``<wal>.prev`` for the rebuild
        path."""
        with self._lock:
            self._fh.close()
            try:
                os.replace(self.path, self.path + ".prev")
            except OSError:
                pass
            self._fh = open(self.path, "a", encoding="utf-8")
            self.ops = 0
            self._torn = False

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


class DurableStore(Store):
    """Store whose collections journal every write to a WAL, with
    snapshot + replay recovery from ``data_dir``."""

    def __init__(
        self,
        data_dir: str,
        sync: str = "flush",
        compact_every_ops: int = 500_000,
        lease: Optional[FileLease] = None,
        shard_id: Optional[int] = None,
    ) -> None:
        super().__init__()
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        #: shard k journals to its own fenced WAL segment and snapshot in
        #: the shared directory, under its own lease (None: unsharded)
        self.shard_id = shard_id
        from ..parallel.topology import snapshot_segment_name, wal_segment_name

        self._wal_name = wal_segment_name(shard_id)
        self._snapshot_name = snapshot_segment_name(shard_id)
        self.compact_every_ops = compact_every_ops
        self._compact_lock = _lockcheck.make_lock("durable.compact")
        #: bound to the holder's lease epoch at open; 0 (no lease)
        #: disables stamping and fencing
        self._lease = lease
        self.epoch = lease.epoch if lease is not None else 0
        self._fenced = False
        #: a commit-time ENOSPC shed a frame and floored the ladder at
        #: RED; the next accepted frame heals and releases the floor
        self._enospc_floor = False
        #: what recovery saw
        self.replay_report: Dict[str, int] = {
            "frames": 0, "stale_frames_dropped": 0, "wal_max_epoch": 0,
            "corrupt_frames": 0, "snapshots_quarantined": 0,
        }
        self._corrupt_wal_path: Optional[str] = None
        self._journal = _Journal(os.path.join(data_dir, self._wal_name), sync=sync)
        #: the group-commit flusher (started on the first async commit),
        #: its queue of ("frame", records) / ("op", line) and deferred errors
        self._flush_lock = _lockcheck.make_lock("durable.flush")
        self._flush_cv = threading.Condition(self._flush_lock)
        self._flush_queue: list = []
        self._flush_errors: list = []
        self._flush_busy = False
        self._flusher: Optional[threading.Thread] = None
        # while frames sit in the flusher queue, per-op appends queue
        # behind them (lock order journal._lock → _flush_cv)
        self._journal.deferred = self._defer_behind_pending
        self._recover()
        if (self._lease is not None and self.epoch
                and self.epoch <= self.replay_report["wal_max_epoch"]):
            # the WAL holds frames at or above our lease epoch (the lease
            # file was deleted while the log survived): outrank them
            self._lease.ensure_epoch_at_least(self.replay_report["wal_max_epoch"] + 1)
            self.epoch = self._lease.epoch
        self._journal.epoch = self.epoch
        if self.epoch:
            # the durable fence point: a deposed predecessor's frame that
            # lands after this marker is dropped on the next replay
            self._journal._write_line('{"o":"f","e":%d}' % self.epoch, None, n_ops=0)
        if self.replay_report["stale_frames_dropped"]:
            WAL_STALE_FRAMES_DROPPED.inc(self.replay_report["stale_frames_dropped"])
            get_logger("resilience").warning(
                "stale-epoch-frames-dropped",
                dropped=self.replay_report["stale_frames_dropped"],
                wal_max_epoch=self.replay_report["wal_max_epoch"],
                epoch=self.epoch,
            )
        if (self.replay_report["corrupt_frames"]
                or self.replay_report["snapshots_quarantined"]):
            # recovery stopped at the end of the valid prefix and/or fell
            # back past a quarantined snapshot: keep the rotted log aside
            # and re-cover what was recovered with one fresh checkpoint
            STORAGE_REBUILDS.inc()
            get_logger("resilience").error(
                "storage-integrity-rebuild",
                corrupt_frames=self.replay_report["corrupt_frames"],
                snapshots_quarantined=self.replay_report["snapshots_quarantined"],
                data_dir=self.data_dir,
            )
            if self._corrupt_wal_path and os.path.exists(self._corrupt_wal_path):
                _keep_corrupt_copy(self._corrupt_wal_path)
            try:
                self.checkpoint()
            except Exception:  # noqa: BLE001 — best effort at open: the
                # valid prefix serves, the next checkpoint retries
                pass

    # -- split-brain fence ---------------------------------------------------- #

    @property
    def fenced(self) -> bool:
        return self._fenced or (self._lease is not None and self._lease.lost)

    def _fence(self, reason: str) -> None:
        """Refuse this and every later write; stand the holder down
        through the lease's on_lost path. Idempotent."""
        first = not self._fenced
        self._fenced = True
        if first:
            LEASE_FENCED.inc()
            get_logger("resilience").error("epoch-fenced", epoch=self.epoch, reason=reason)
            if self._lease is not None:
                self._lease.stand_down(reason)
        raise EpochFencedError(
            f"writer epoch {self.epoch} superseded ({reason}); "
            "this holder must stop serving"
        )

    def assert_not_fenced(self, read_lease_file: bool = False) -> None:
        """Raise EpochFencedError once a newer epoch is observed: the flag
        and the renewer's ``lost`` on every journaled write, plus a re-read
        of the lease file with ``read_lease_file`` (the commit boundary's
        check, which catches a steal the renewer has not yet seen)."""
        if self._lease is None:
            return
        if self._fenced:
            self._fence("already fenced")
        if self._lease.lost:
            self._fence("lease lost")
        if not read_lease_file:
            return
        cur = self._lease.peek()
        if cur is None:
            if self.epoch:
                self._fence("lease file missing")
            return
        if self._lease.superseded(cur):
            self._fence("newer epoch issued")

    # -- Store interface ----------------------------------------------------- #

    def collection(self, name: str) -> Collection:
        with self._lock:
            coll = self._collections.get(name)
            if coll is None:
                coll = Collection(name, journal=self._on_op)
                self._collections[name] = coll
            return coll

    def _on_op(self, record: dict) -> None:
        self.assert_not_fenced()
        self._journal.append(record)
        if self._journal.ops >= self.compact_every_ops and not self._journal.suspended:
            self.checkpoint(blocking=False)

    # -- tick-scoped group commit -------------------------------------------- #

    def begin_tick(self) -> None:
        """Open the tick's WAL group: every journaled write until the
        matching ``end_tick*`` lands in one framed append."""
        self._journal.begin_group()

    def end_tick(self) -> None:
        """Commit the tick's group synchronously: one framed append, one
        flush. Raises on a WAL write error."""
        self.end_tick_async()
        self.sync_persist()

    def commit_group_inline(self, records: list) -> None:
        """Write one group frame now (the flusher's and ``end_tick``'s
        write), re-checking the fence at write time."""
        self.assert_not_fenced(read_lease_file=self.epoch > 0)
        try:
            self._journal.commit_group(records, epoch=self.epoch)
        except OSError as exc:
            if exc.errno != errno.ENOSPC:
                raise
            # a full disk: shed the frame loudly and floor the ladder at
            # RED; memory still holds every shed write, and the first
            # accepted frame below re-covers them with a checkpoint
            self._shed_group_enospc(len(records))
            return
        if self._enospc_floor:
            from ..utils import overload as _overload

            if self.heal_durability():
                self._enospc_floor = False
                _overload.monitor_for(self).set_floor(_overload.GREEN)
                get_logger("resilience").warning("wal-enospc-healed", data_dir=self.data_dir)
        if self._journal.ops >= self.compact_every_ops and not self._journal.suspended:
            self.checkpoint(blocking=False)

    def _shed_group_enospc(self, n_ops: int) -> None:
        from ..utils import overload as _overload

        WAL_ENOSPC_SHEDS.inc()
        self._enospc_floor = True
        _overload.monitor_for(self).set_floor(_overload.RED)
        get_logger("resilience").error("wal-enospc-shed", n_ops=n_ops, data_dir=self.data_dir)

    def _defer_behind_pending(self, line: str) -> bool:
        """_Journal hook (under the journal lock): queue a per-op line
        behind unflushed frames so WAL order stays apply order. A busy
        flusher counts as pending (it may have popped a frame without yet
        taking the journal lock). False only when it is fully idle."""
        with self._flush_cv:
            if not self._flush_queue and not self._flush_busy:
                return False
            self._flush_queue.append(("op", line))
            self._flush_cv.notify()
            return True

    def end_tick_async(self) -> None:
        """Commit the tick's group on the flusher thread, so the file
        write overlaps the next tick; an error is deferred to the next
        ``sync_persist()``. The group is detached and queued under the
        journal lock, atomically with appends' queue-behind decision.

        This is the fence point: the lease file is re-read, and on a
        superseded epoch the detached group is dropped and
        ``EpochFencedError`` raised (the ``wal.fence`` seam fires just
        before, so a plan can land a steal mid-commit)."""
        from ..utils import faults

        faults.fire("wal.fence")
        j = self._journal
        with j._lock:
            records, j._group = j._group, None
            # detach first, check second: a fenced group never lands
            self.assert_not_fenced(read_lease_file=self.epoch > 0)
            if not records:
                return
            with self._flush_cv:
                if self._flusher is None or not self._flusher.is_alive():
                    self._flusher = threading.Thread(
                        target=self._flush_loop, daemon=True, name="wal-group-flusher")
                    self._flusher.start()
                self._flush_queue.append(("frame", records))
                self._flush_cv.notify()

    def _flush_loop(self) -> None:
        while True:
            with self._flush_cv:
                while not self._flush_queue:
                    self._flush_busy = False
                    self._flush_cv.notify_all()
                    self._flush_cv.wait()
                kind, payload = self._flush_queue.pop(0)
                self._flush_busy = True
            try:
                if kind == "frame":
                    t0 = _time.perf_counter()
                    self.commit_group_inline(payload)
                    WAL_FLUSH_MS.observe((_time.perf_counter() - t0) * 1e3)
                else:
                    # a queued per-op line stays a plain record and fires
                    # the per-op seam, not the frame's
                    from ..utils import faults

                    directive = faults.fire("wal.append")
                    self._journal._write_line(payload, directive, n_ops=1)
            except BaseException as exc:  # noqa: BLE001 — deferred to the
                # sync_persist barrier
                with self._flush_cv:
                    self._flush_errors.append(exc)

    @property
    def wal_seq(self) -> int:
        """Monotone count of WAL lines ever journaled by this store."""
        return self._journal.total_lines

    def flush_backlog(self) -> int:
        """Frames waiting on (or being written by) the async flusher —
        the overload ladder's ``wal_backlog`` signal."""
        with self._flush_cv:
            backlog = len(self._flush_queue) + (1 if self._flush_busy else 0)
        WAL_FLUSH_BACKLOG.set(float(backlog))
        return backlog

    def _drain_flusher(self) -> None:
        with self._flush_cv:
            while self._flush_queue or self._flush_busy:
                self._flush_cv.wait(timeout=0.1)

    def sync_persist(self) -> None:
        """Barrier: wait until every async group commit has reached the
        WAL, then raise the first deferred write error (once); the rest
        of the window's errors are logged and dropped."""
        self._drain_flusher()
        with self._flush_cv:
            if not self._flush_errors:
                return
            first, rest = self._flush_errors[0], self._flush_errors[1:]
            self._flush_errors.clear()
        for exc in rest:
            get_logger("resilience").error("wal-flush-error-dropped", error=repr(exc)[-300:])
        raise first

    def heal_durability(self) -> bool:
        """Best-effort repair after a failed or torn group commit: a
        checkpoint of the in-memory truth, which holds the lost group's
        writes."""
        try:
            self.checkpoint()
            return True
        except Exception:  # noqa: BLE001 — the disk may still be broken;
            # the next tick's full rewrites are the fallback
            return False

    def scrub(self) -> Dict[str, int]:
        """Re-verify the WAL's stamped lines and the snapshot's digest on
        a live store; any finding (or a silently short-written stub) heals
        with one checkpoint. Returns ``{"wal_corrupt_frames",
        "snapshot_corrupt", "torn_stub", "healed"}``."""
        report = {"wal_corrupt_frames": 0, "snapshot_corrupt": 0, "torn_stub": 0,
                  "healed": 0}
        # settle async commits (their errors stay for sync_persist)
        self._drain_flusher()
        wal_path = self._journal.path
        with self._journal._lock:
            if not self._journal._fh.closed:
                self._journal._fh.flush()
            report["torn_stub"] = int(self._journal._torn)
        try:
            with open(wal_path, "rb") as fh:
                for line in fh:
                    if not line.endswith(b"\n"):
                        break  # an unterminated tail is torn, not rotten
                    if _integrity.verify_wal_line(line) is False:
                        report["wal_corrupt_frames"] += 1
                        WAL_CORRUPT_FRAMES.inc()
                        break
                    try:
                        json.loads(line)
                    except (ValueError, UnicodeDecodeError):
                        # the repaired stub of a silent short write: no
                        # stamp, so only the parse convicts it
                        report["wal_corrupt_frames"] += 1
                        WAL_CORRUPT_FRAMES.inc()
                        break
        except OSError:
            pass
        snap_path = os.path.join(self.data_dir, self._snapshot_name)
        meta = _read_meta(snap_path + SNAPSHOT_META_SUFFIX)
        if (isinstance(meta, dict) and meta.get("crc") and os.path.exists(snap_path)
                and _integrity.file_crc32(snap_path) != meta["crc"]):
            report["snapshot_corrupt"] = 1
            SNAPSHOT_QUARANTINED.inc()
            _integrity.quarantine(snap_path)
        if report["wal_corrupt_frames"] or report["snapshot_corrupt"] or report["torn_stub"]:
            if report["wal_corrupt_frames"]:
                _keep_corrupt_copy(wal_path)
            STORAGE_REBUILDS.inc()
            get_logger("resilience").error(
                "storage-scrub-heal", data_dir=self.data_dir,
                **{k: v for k, v in report.items() if k != "healed"})
            report["healed"] = int(self.heal_durability())
        return report

    # -- recovery / compaction ----------------------------------------------- #

    def _load_trusted_snapshot(self, snap_path: str, meta_path: str):
        """Parse and digest-verify one snapshot generation. One that fails
        its ``.meta`` CRC, or no longer parses, is quarantined and
        counted; returns the payload, or None when missing or
        quarantined. A meta without a digest loads unchecked."""
        if not os.path.exists(snap_path):
            return None
        meta = _read_meta(meta_path)
        bad = False
        if isinstance(meta, dict) and meta.get("crc"):
            bad = _integrity.file_crc32(snap_path) != meta["crc"]
        if not bad:
            try:
                with open(snap_path, encoding="utf-8") as fh:
                    return json.load(fh)
            except (ValueError, UnicodeDecodeError, OSError):
                bad = True
        self.replay_report["snapshots_quarantined"] += 1
        SNAPSHOT_QUARANTINED.inc()
        qpath = _integrity.quarantine(snap_path)
        get_logger("resilience").error(
            "snapshot-quarantined", snapshot=snap_path, quarantined_to=qpath or "",
            digest_mismatch=bool(isinstance(meta, dict) and meta.get("crc")))
        return None

    def _replay_wal_file(self, wal_path: str, state: dict) -> None:
        """Replay one WAL generation, CRC-verifying each terminated line.
        A failed stamp ends the valid prefix: nothing after it (here or in
        a later generation) replays. Unstamped lines replay unchecked."""
        report = self.replay_report
        if state["corrupt_stop"] or not os.path.exists(wal_path):
            return
        # binary: a rotted byte can break the utf-8 encoding itself
        with open(wal_path, "rb") as fh:
            for line in fh:
                if not line.endswith(b"\n"):
                    break  # torn final line from a crash mid-append
                if _integrity.verify_wal_line(line) is False:
                    report["corrupt_frames"] += 1
                    WAL_CORRUPT_FRAMES.inc()
                    state["corrupt_stop"] = True
                    self._corrupt_wal_path = wal_path
                    break
                state["wal_lines"] += 1
                try:
                    rec = json.loads(line)
                except (ValueError, UnicodeDecodeError):
                    # a terminated-but-unparseable line (the repaired stub
                    # of a torn append): that one record is lost
                    report["corrupt_frames"] += 1
                    WAL_CORRUPT_FRAMES.inc()
                    self._corrupt_wal_path = wal_path
                    continue
                s = int(rec.get("s", 0) or 0)
                if s:
                    state["max_line_seq"] = max(state["max_line_seq"], s)
                op = rec.get("o")
                if op == "f":
                    # a holder pinned its epoch at open: older is superseded
                    state["max_epoch"] = max(state["max_epoch"], int(rec.get("e", 0) or 0))
                    continue
                if s and s <= state["snap_seq"]:
                    continue  # already folded into the snapshot base
                if op == "g":
                    report["frames"] += 1
                e = int(rec.get("e", 0) or 0)
                if e:
                    if e < state["max_epoch"]:
                        # a superseded holder's write past the fence point
                        report["stale_frames_dropped"] += 1
                        continue
                    state["max_epoch"] = e
                apply_wal_record(self, rec)

    def _recover(self) -> None:
        snap_path = os.path.join(self.data_dir, self._snapshot_name)
        meta_path = snap_path + SNAPSHOT_META_SUFFIX
        wal_path = self._journal.path
        self._journal.suspended = True
        state = {"max_epoch": 0, "snap_seq": 0, "wal_lines": 0, "max_line_seq": 0,
                 "corrupt_stop": False}
        try:
            snap = self._load_trusted_snapshot(snap_path, meta_path)
            replay_paths = [wal_path]
            if snap is None and self.replay_report["snapshots_quarantined"]:
                # rebuild from the previous checkpoint generation and both
                # log generations
                snap = self._load_trusted_snapshot(snap_path + ".prev", meta_path + ".prev")
                replay_paths = [wal_path + ".prev", wal_path]
            if snap is not None:
                for name, docs in snap.get("collections", {}).items():
                    coll = self.collection(name)
                    for doc in docs:
                        coll.upsert(doc)
                # the fence point and line-seq watermark survive in the
                # snapshot after the WAL rotates
                state["max_epoch"] = int(snap.get("epoch", 0) or 0)
                state["snap_seq"] = int(snap.get("seq", 0) or 0)
            for path in replay_paths:
                self._replay_wal_file(path, state)
            self.replay_report["wal_max_epoch"] = state["max_epoch"]
            # a restarted writer keeps numbering where the last stopped
            self._journal.total_lines = max(state["snap_seq"] + state["wal_lines"],
                                            state["max_line_seq"])
        finally:
            self._journal.suspended = False

    def checkpoint(self, blocking: bool = True) -> None:
        """Write an atomic snapshot of every collection, then rotate the
        WAL. Writers are quiesced by every collection's lock, taken in
        sorted order, so no op lands in memory without being in the
        snapshot or the new WAL; the snapshot renames into place before
        the WAL rotates, so a crash at any point leaves a full state.
        ``blocking=False`` (the inline size trigger, which holds one
        collection's lock) skips if another thread is compacting."""
        # a fenced holder must not rewrite the snapshot a newer epoch owns
        self.assert_not_fenced(read_lease_file=self.epoch > 0)
        if blocking and threading.current_thread() is not self._flusher:
            # drain queued async commits so the rotation cannot orphan a
            # frame enqueued before the cut
            self._drain_flusher()
        if not self._compact_lock.acquire(blocking=blocking):
            return
        acquired: Dict[str, Collection] = {}
        try:
            snap_path = os.path.join(self.data_dir, self._snapshot_name)
            tmp_path = snap_path + ".tmp"
            # quiesce: every collection's lock (never under the store
            # lock); loop because a collection can appear meanwhile
            while True:
                with self._lock:
                    missing = [(n, c) for n, c in sorted(self._collections.items())
                               if n not in acquired]
                if not missing:
                    break
                for name, coll in missing:
                    coll._lock.acquire()
                    acquired[name] = coll
            payload = {
                "collections": {name: list(coll._docs.values())
                                for name, coll in sorted(acquired.items())},
                "epoch": max(self.epoch, self.replay_report["wal_max_epoch"]),
                "seq": self._journal.total_lines,
            }
            from ..utils import faults

            meta_path = snap_path + SNAPSHOT_META_SUFFIX
            try:
                with open(tmp_path, "w", encoding="utf-8") as fh:
                    # the seam fires with the tmp open: an injected
                    # enospc/eio lands mid-write
                    directive = faults.fire("snapshot.write")
                    # one write of the one-shot encoding: json.dump's bytes,
                    # without a write call per token
                    fh.write(json.dumps(payload, separators=(",", ":"), default=str))
                    fh.flush()
                    os.fsync(fh.fileno())
            except BaseException:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
                raise
            # keep the outgoing generation as .prev (hard links) for the
            # rebuild path
            for cur in (meta_path, snap_path):
                try:
                    os.link(cur, cur + ".prevtmp")
                    os.replace(cur + ".prevtmp", cur + ".prev")
                except OSError:
                    pass
            # the meta (with the new snapshot's digest) lands before the
            # snapshot renames
            try:
                with open(meta_path + ".tmp", "w", encoding="utf-8") as fh:
                    json.dump({"seq": payload["seq"], "epoch": payload["epoch"],
                               "crc": _integrity.file_crc32(tmp_path)}, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
            except BaseException:
                for leftover in (meta_path + ".tmp", tmp_path):
                    try:
                        os.unlink(leftover)
                    except OSError:
                        pass
                raise
            os.replace(meta_path + ".tmp", meta_path)
            os.replace(tmp_path, snap_path)
            self._journal.rotate()
            if directive == "bitrot":
                _integrity.corrupt_byte(snap_path)
            elif directive == "short":
                with open(snap_path, "r+b") as fh:
                    fh.truncate(max(1, os.path.getsize(snap_path) // 2))
        finally:
            for coll in acquired.values():
                coll._lock.release()
            self._compact_lock.release()

    def close(self) -> None:
        if self.fenced:
            # a fenced holder owns nothing: no final frame, no snapshot
            self._journal.close()
            return
        # commit a still-open group before the final checkpoint
        try:
            self.end_tick()
        except Exception:  # noqa: BLE001 — close is best-effort; replay
            # covers what the WAL holds
            pass
        try:
            self.checkpoint()
        except EpochFencedError:
            pass  # fenced between the commit and the snapshot
        self._journal.close()
