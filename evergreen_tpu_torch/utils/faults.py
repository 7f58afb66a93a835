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
  ``recovery.pass``   the startup recovery pass's entry
                      (scheduler/recovery.py): a shard worker's boot kill
                      point (``runtime/worker.py --crash``)

Fault kinds: ``raise`` (the configured exception, default FaultError),
``hang``/``delay`` (sleep ``delay_s``), ``crash`` (``os._exit(86)``),
``call`` (run ``fn`` after an optional sleep), ``enospc``/``eio``
(``OSError`` with that errno); any other kind is returned to the seam as
a directive string (``short``, ``bitrot``, ``lost``, ...).
"""
from __future__ import annotations

import errno
import os
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

    def fire(self, seam: str) -> Optional[str]:
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
            time.sleep(fault.delay_s)
            return None
        if fault.kind == "crash":
            os._exit(86)
        if fault.kind == "call":
            if fault.delay_s:
                time.sleep(fault.delay_s)
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
