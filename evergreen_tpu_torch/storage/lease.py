"""File-based lease with fencing epochs, for the solver leader.

The part of ``evergreen_tpu/storage/lease.py`` that the solver-leader
plane needs. The lease is a JSON file created with O_EXCL; its holder
renews it (re-writes it) every ``ttl/3``, and a lease older than ``ttl``
may be stolen. Every steal bumps a monotone ``epoch``: ``os.rename`` of
the stale file to a claimant-private name succeeds for exactly one
stealer, which then O_EXCL-creates the lease at ``epoch + 1`` and
verifies it by re-reading. Renewal is a compare-and-swap (verify owner
and epoch, replace, verify again). A floor file ``<path>.epoch`` records
the highest epoch ever issued, so epochs stay monotone across a release
and unlink.

The payload (``owner``, ``pid``, ``at``, ``epoch`` and the ``"k"`` CRC
stamp), the floor file and the steal protocol are the JAX package's byte
for byte, so a JAX leader and a port leader contend for one lease with
one epoch sequence. ``EpochFencedError`` is the JAX package's error for
a writer bound to a superseded epoch: the durable store
(``storage/durable.py``) raises it once a newer epoch is observed, and
the tick and the sharded plane's handoff read it. Each scheduler shard
holds its own lease (``shard_lease_path``), and the fleet supervisor
(``runtime/supervisor.py``) holds ``supervisor_lease_path``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Callable, Optional

from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics
from . import integrity

LEASE_LOST = _metrics.counter(
    "lease_lost_total",
    "Writer leases lost or stood down (failed renewal, observed steal, "
    "or a fenced commit).",
    legacy="lease.lost",
)


class EpochFencedError(RuntimeError):
    """A writer bound to a superseded lease epoch attempted a commit."""


def shard_lease_path(data_dir: str, shard_id: Optional[int]) -> str:
    """Lease-file path for one scheduler shard: every shard holds its own
    lease (distinct path, independent epoch sequence) over the shared
    data directory; ``None`` is the unsharded writer's lease."""
    from ..parallel.topology import shard_lease_name

    return os.path.join(data_dir, shard_lease_name(shard_id))


def solver_lease_path(data_dir: str) -> str:
    """Lease-file path for the solver-leader scope (runtime/solver.py):
    one process per fleet owns the device and serves the stacked solve;
    its epoch stamps every shared-memory publication and result block."""
    return os.path.join(data_dir, "solver.lease")


def supervisor_lease_path(data_dir: str) -> str:
    """Lease-file path for the FLEET SUPERVISOR scope (process-per-shard
    runtime, runtime/supervisor.py). The supervisor holds no shard data
    — its lease fences the *control plane*: exactly one supervisor may
    command the fleet, every command carries the lease's epoch, and
    workers reject commands stamped with a superseded one
    (``stale_sup``)."""
    return os.path.join(data_dir, "supervisor.lease")


_READ_CHUNK = 65536


def _read_bytes(path: str) -> bytes:
    """A small file's bytes through one ``open``, its reads and one
    ``close``: every commit's fence check reads the lease and floor
    files, and on a remote filesystem each further call a buffered text
    ``open`` makes (``fstat``, ``ioctl``, ``lseek``) is a round trip."""
    fd = os.open(path, os.O_RDONLY)
    try:
        chunks = []
        while True:
            chunk = os.read(fd, _READ_CHUNK)
            chunks.append(chunk)
            # a regular file's short read is its end: no read for the EOF
            if len(chunk) < _READ_CHUNK:
                return b"".join(chunks)
    finally:
        os.close(fd)


class FileLease:
    #: bounded verify-after-rename attempts in the steal path
    _STEAL_ATTEMPTS = 5

    def __init__(self, path: str, ttl_s: float = 10.0) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self.ttl_s = ttl_s
        self.owner_id = uuid.uuid4().hex
        self.lost = False
        #: fencing epoch held (0 = not currently holding)
        self.epoch = 0
        self._renewer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._on_lost: Optional[Callable[[], None]] = None
        self._stood_down = False
        #: serializes renewals against epoch advancement
        self._epoch_lock = _lockcheck.make_lock("lease.epoch")

    # -- core ---------------------------------------------------------------- #

    def _read(self) -> Optional[dict]:
        try:
            doc = json.loads(_read_bytes(self.path))
        except (OSError, ValueError):
            return None
        if integrity.verify_doc(doc) is False:
            # a corrupt lease is treated like an unreadable file: the
            # holder cannot prove ownership, and an old file stays
            # stealable (try_acquire's mtime path)
            return None
        return doc

    def peek(self) -> Optional[dict]:
        """Current lease file content (any holder's), or None."""
        return self._read()

    def _payload(self) -> dict:
        return {
            "owner": self.owner_id,
            "pid": os.getpid(),
            "at": time.time(),
            "epoch": self.epoch,
        }

    def _write(self) -> None:
        integrity.atomic_write_json(
            self.path,
            self._payload(),
            seam="lease.write",
            tmp_tag=self.owner_id,
        )

    # -- epoch floor (monotonicity across unlink cycles) ---------------------- #

    def _floor_path(self) -> str:
        return f"{self.path}.epoch"

    def _epoch_floor(self) -> int:
        try:
            return int(_read_bytes(self._floor_path()).strip() or 0)
        except (OSError, ValueError):
            return 0

    def _bump_epoch_floor(self, epoch: int) -> None:
        """Best-effort monotone record of the highest epoch ever issued
        (tmp + rename, so a crash never leaves a torn floor)."""
        if epoch <= self._epoch_floor():
            return
        tmp = f"{self._floor_path()}.{self.owner_id}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(str(epoch))
            os.replace(tmp, self._floor_path())
        except OSError:
            pass

    # -- acquisition ---------------------------------------------------------- #

    def _create_excl(self, epoch: int) -> bool:
        """O_EXCL create at ``epoch``, the payload written through the
        O_EXCL fd so no reader sees an empty lease file."""
        try:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        self.epoch = epoch
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(integrity.stamped_doc(self._payload()), fh)
        self._bump_epoch_floor(epoch)
        return True

    def try_acquire(self) -> bool:
        """One non-blocking attempt; steals a stale lease at a bumped
        epoch (rename away, O_EXCL create, verify by re-reading)."""
        for _ in range(self._STEAL_ATTEMPTS):
            if self._create_excl(self._epoch_floor() + 1):
                if self._verify_owner():
                    return True
                continue  # clobbered by a stale renewer's replace
            cur = self._read()
            if cur is not None and cur.get("owner") == self.owner_id:
                self.epoch = int(cur.get("epoch", self.epoch) or 0)
                return True
            if cur is None:
                # unreadable: live unless the file itself is old
                try:
                    if time.time() - os.path.getmtime(self.path) <= self.ttl_s:
                        return False
                except OSError:
                    continue  # vanished: loop recreates via O_EXCL
            elif time.time() - cur.get("at", 0) <= self.ttl_s:
                return False  # live holder
            # stale: claim by renaming the file away (one stealer wins)
            claim = f"{self.path}.claim.{self.owner_id}"
            try:
                os.rename(self.path, claim)
            except OSError:
                continue
            try:
                with open(claim, encoding="utf-8") as fh:
                    stale = json.load(fh)
                stale_epoch = int(stale.get("epoch", 0) or 0)
            except (OSError, ValueError):
                stale_epoch = 0
            try:
                os.unlink(claim)
            except OSError:
                pass
            next_epoch = max(stale_epoch, self._epoch_floor()) + 1
            if self._create_excl(next_epoch) and self._verify_owner():
                return True
        return False

    def _verify_owner(self) -> bool:
        cur = self._read()
        return (
            cur is not None
            and cur.get("owner") == self.owner_id
            and int(cur.get("epoch", 0) or 0) == self.epoch
        )

    def acquire(self, timeout_s: Optional[float] = None,
                poll_s: float = 0.5) -> bool:
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            if self.try_acquire():
                return True
            if deadline is not None and time.time() >= deadline:
                return False
            time.sleep(poll_s)

    def superseded(self, cur: Optional[dict] = None) -> bool:
        """True when a newer epoch was issued: the lease file carries one,
        or the floor file records one."""
        if cur is None:
            cur = self._read()
        if cur is not None and int(cur.get("epoch", 0) or 0) > self.epoch:
            return True
        return self._epoch_floor() > self.epoch

    def renew(self) -> bool:
        """Compare-and-swap renewal: verify we still own our epoch, write,
        verify again, then check the epoch floor."""
        from ..utils import faults

        if faults.fire("lease.renew") == "lost":
            return False
        with self._epoch_lock:
            cur = self._read()
            if (
                cur is None
                or cur.get("owner") != self.owner_id
                or int(cur.get("epoch", 0) or 0) != self.epoch
            ):
                return False
            self._write()
            if not self._verify_owner():
                return False
            return self._epoch_floor() <= self.epoch

    def ensure_epoch_at_least(self, epoch: int) -> None:
        """Advance the held epoch to ``epoch`` (recovery found WAL frames
        stamped at or above it, e.g. the lease file was deleted while the
        WAL survived), serialized against the renewer."""
        with self._epoch_lock:
            if self.epoch == 0 or epoch <= self.epoch:
                return
            self.epoch = epoch
            self._write()
            self._bump_epoch_floor(epoch)

    def release(self) -> None:
        """Unlink the lease only if it still carries our owner and epoch."""
        self.stop_renewing()
        cur = self._read()
        if (
            cur is not None
            and cur.get("owner") == self.owner_id
            and int(cur.get("epoch", 0) or 0) == self.epoch
        ):
            try:
                os.unlink(self.path)
            except OSError:
                pass
        self.epoch = 0

    # -- background renewal --------------------------------------------------- #

    def stand_down(self, reason: str = "") -> None:
        """Mark the lease lost and fire ``on_lost`` exactly once."""
        fire = not self._stood_down
        if fire:
            self._stood_down = True
            self.lost = True
        self._stop.set()
        if not fire:
            return
        from ..utils.log import get_logger

        LEASE_LOST.inc()
        get_logger("resilience").error(
            "lease-lost", path=self.path, owner=self.owner_id,
            epoch=self.epoch, reason=reason,
        )
        if self._on_lost is not None:
            self._on_lost()

    def start_renewing(self, on_lost=None) -> None:
        """Renew every ttl/3 in a daemon thread; a failed renewal stands
        the holder down and fires ``on_lost``."""
        self._on_lost = on_lost

        def loop():
            while not self._stop.wait(self.ttl_s / 3.0):
                if not self.renew():
                    self.stand_down("renewal failed")
                    return

        self.lost = False
        self._stood_down = False
        self._stop.clear()
        self._renewer = threading.Thread(target=loop, daemon=True)
        self._renewer.start()

    def stop_renewing(self) -> None:
        self._stop.set()
        if self._renewer is not None:
            self._renewer.join(timeout=2.0)
            self._renewer = None
