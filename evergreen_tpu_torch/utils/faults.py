"""Seam-based deterministic fault injection (tests only).

The part of ``evergreen_tpu/utils/faults.py`` that the port's seams
need. Each instrumented seam calls ``fire("<seam>")``; with no plan
installed that is one global read and a return. A fault fires on one
call index of its seam (``at``) or on every call (``always``); each
firing is counted in ``faults_fired_total{seam}`` and logged. Seams:

  ``scheduler.solve`` the tick's packed solve, inside its deadline
                      (scheduler/wrapper.py ``_solve_bounded``)
  ``capacity.solve``  the capacity plane's whole solve step, whichever
                      rung serves it (scheduler/capacity_plane.py)
  ``capacity.fused``  the capacity plane's fused rung only
  ``solver.round``    the leader's serve_round entry (runtime/solver.py)
  ``solver.publish``  after the leader has collected the publications
  ``solver.solve``    after the stacked solve, before any result write
  ``solver.return``   after the first shard's result block is written
  ``lease.renew``     a lease renewal (storage/lease.py); ``lost``
                      reports the lease stolen
  ``lease.write``     mid-write of a lease file (storage/integrity.py)
  ``manifest.write``  mid-write of a fleet manifest entry
  ``handoff.release`` inside the sharded plane's release leg, after the
                      deletions (scheduler/sharded_plane.py)
  ``handoff.record``  between a handoff's release and its prime
  ``handoff.prime``   between a handoff's prime and its done-mark
  ``wal.append``      a per-op WAL append (storage/durable.py); ``torn``
                      writes half the line and raises, ``short`` writes
                      half and returns, ``bitrot`` flips a byte after
                      the write
  ``wal.commit``      a tick's group-frame write, once per frame, with
                      the same directives
  ``wal.fence``       the commit boundary, just before the fence check
  ``snapshot.write``  mid-write of a checkpoint's snapshot (``short``
                      truncates it after the rename, ``bitrot`` flips a
                      byte of it)
  ``dispatch.assign`` inside the dispatcher's CAS pair, after the host's
                      claim and before the task's dispatched mark
                      (dispatch/assign.py): a crash there leaves the
                      half-assignment the recovery pass releases
  ``recovery.pass``   the startup recovery pass's entry
                      (scheduler/recovery.py): a shard worker's boot kill
                      point (``runtime/worker.py --crash``)
  ``cloud.spawn``     a provider spawn in the create pass
                      (cloud/provisioning.py): charged to the host as a
                      provision attempt
  ``agent.comm``      a whole agent→server call of the REST transport
                      (agent/rest_comm.py), inside its retry policy
  ``agent.request``   one request leg of that call; the directives
                      ``drop`` and ``partition`` lose it before the server
                      sees it, ``half_open`` loses the answer after the
                      server did the work, ``duplicate`` delivers it twice
  ``events.deliver``  one outbox row's delivery in the drain
                      (events/transports.py): a raise costs the row an
                      attempt
  ``ipc.send``        a supervisor command to a shard worker
                      (runtime/supervisor.py ``WorkerHandle.send``), then
                      ``ipc.send.<shard>``; ``drop``, ``partition`` and
                      ``half_open`` black-hole it, ``reorder`` swaps it
                      with the next one, ``duplicate`` sends it twice
  ``ipc.recv``        a message read from a shard worker, then
                      ``ipc.recv.<shard>``, with the same directives
  ``sock.adopt``      the adoption connect to a worker's control socket
                      (runtime/manifest.py): ``drop`` and ``partition``
                      refuse it, ``half_open`` connects to a silent peer
  ``replica.tail``    one poll of a WAL-tailing replica
                      (storage/replica.py); ``drop``, ``partition`` and
                      ``half_open`` make it read nothing, so the applied
                      watermark freezes and the staleness bound grows

Fault kinds: ``raise`` (the configured exception, default FaultError),
``hang``/``delay`` (sleep ``delay_s``), ``crash`` (``os._exit(86)``),
``call`` (run ``fn`` after an optional sleep), ``enospc``/``eio``
(``OSError`` with that errno); any other kind is returned to the seam as
a directive string (``short``, ``bitrot``, ``lost``, ...).

A plan is installed explicitly (``install(plan)``) or from the
``EVG_FAULTS`` environment spec at import time:
``seam:kind@index[,seam:kind@index...]``, e.g.
``EVG_FAULTS=scheduler.solve:raise@2,wal.append:raise@5``. Schedules are
per-seam call indices, so a seeded run replays exactly:
``FaultPlan.seeded(seed, {"wal.append": 0.1})`` derives the firing
indices from one RNG, and the plan records every fired fault in
``fired``.
"""
from __future__ import annotations

import errno
import os
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import lockcheck as _lockcheck
from . import metrics as _metrics
from .log import get_logger

FAULTS_FIRED = _metrics.counter(
    "faults_fired_total",
    "Injected faults fired by the active fault plan, labeled by seam.",
    labels=("seam",),
    legacy="faults.fired",
)


class FaultError(RuntimeError):
    """Default injected failure."""


class Fault:
    """One injected fault: what happens when its schedule slot fires."""

    def __init__(
        self,
        kind: str = "raise",
        exc: Optional[BaseException] = None,
        delay_s: float = 0.0,
        fn: Optional[Callable[[], None]] = None,
    ) -> None:
        self.kind = kind
        self.exc = exc
        self.delay_s = delay_s
        self.fn = fn

    def __repr__(self) -> str:
        return f"Fault({self.kind!r}, delay_s={self.delay_s})"


class FaultPlan:
    """Deterministic schedule of faults keyed by (seam, call index)."""

    def __init__(self) -> None:
        self._lock = _lockcheck.make_lock("faults.plan")
        self._at: Dict[str, Dict[int, Fault]] = {}
        self._always: Dict[str, Fault] = {}
        self._calls: Dict[str, int] = {}
        #: audit trail: (seam, call index, kind) per fired fault
        self.fired: List[Tuple[str, int, str]] = []

    def at(self, seam: str, call_index: int, fault: Fault) -> "FaultPlan":
        """Fire ``fault`` on the seam's ``call_index``-th call (0-based)."""
        self._at.setdefault(seam, {})[call_index] = fault
        return self

    def always(self, seam: str, fault: Fault) -> "FaultPlan":
        """Fire ``fault`` on every call of the seam."""
        self._always[seam] = fault
        return self

    @classmethod
    def seeded(
        cls,
        seed: int,
        rates: Dict[str, float],
        horizon: int = 1000,
        fault: Optional[Fault] = None,
    ) -> "FaultPlan":
        """Seeded random schedule: each seam fires with its rate at every
        call index below ``horizon``. Same seed, same schedule, so a
        failing run replays exactly."""
        plan = cls()
        rng = random.Random(seed)
        for seam in sorted(rates):
            for i in range(horizon):
                if rng.random() < rates[seam]:
                    plan.at(seam, i, fault or Fault("raise"))
        return plan

    def fire(
        self, seam: str, sleep: Callable[[float], None] = time.sleep
    ) -> Optional[str]:
        with self._lock:
            idx = self._calls.get(seam, 0)
            self._calls[seam] = idx + 1
            fault = self._at.get(seam, {}).get(idx) or self._always.get(seam)
            if fault is None:
                return None
            self.fired.append((seam, idx, fault.kind))
        FAULTS_FIRED.inc(seam=seam)
        get_logger("faults").warning(
            "fault-injected", seam=seam, call_index=idx, kind=fault.kind
        )
        if fault.kind == "raise":
            raise fault.exc if fault.exc is not None else FaultError(
                f"injected fault at {seam}"
            )
        if fault.kind in ("hang", "delay"):
            sleep(fault.delay_s)
            return None
        if fault.kind == "crash":
            os._exit(86)
        if fault.kind == "call":
            if fault.delay_s:
                sleep(fault.delay_s)
            if fault.fn is not None:
                fault.fn()
            return None
        if fault.kind == "enospc":
            raise OSError(errno.ENOSPC, f"injected ENOSPC at {seam}")
        if fault.kind == "eio":
            raise OSError(errno.EIO, f"injected EIO at {seam}")
        return fault.kind


_active: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global _active
    _active = plan
    return plan


def active() -> Optional[FaultPlan]:
    """The installed plan, or None."""
    return _active


def uninstall() -> None:
    global _active
    _active = None


def fire(seam: str) -> Optional[str]:
    """The seam hook. No plan installed → one global read and out."""
    plan = _active
    if plan is None:
        return None
    return plan.fire(seam)


def _plan_from_env(spec: str) -> FaultPlan:
    """``seam:kind@index[,...]``: the ``EVG_FAULTS`` install's plan."""
    plan = FaultPlan()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        seam, _, rest = part.partition(":")
        kind, _, idx = rest.partition("@")
        plan.at(seam.strip(), int(idx) if idx else 0, Fault(kind or "raise"))
    return plan


if os.environ.get("EVG_FAULTS"):
    install(_plan_from_env(os.environ["EVG_FAULTS"]))
