"""Circuit breaker: closed → open → half-open with one probe.

A copy of ``evergreen_tpu/utils/circuit.py`` with its default of one
half-open probe fixed. The tick wraps the packed
device solve with one (``scheduler/wrapper.py``) and the capacity plane
wraps each of its rungs with one (``scheduler/capacity_plane.py``).

States:

  ``closed``     calls flow; ``failure_threshold`` consecutive failures
                 trip it open.
  ``open``       calls are refused (``allow()`` is False) until
                 ``cooldown_s`` has passed since the trip.
  ``half-open``  after the cooldown, one probe call is admitted; its
                 success closes the breaker, its failure re-opens it
                 (and restarts the cooldown).

Every transition emits a ``breaker-transition`` structured log record and
bumps ``breaker.<name>.<to-state>`` counters, so soak runs audit the
open → half-open → closed cycle from the log stream alone. Time is an
explicit ``now`` (falling back to ``time.monotonic``) so tick-driven
callers keep the breaker deterministic under test clocks.
"""
from __future__ import annotations

import time as _time
from typing import Optional

from . import lockcheck as _lockcheck
from . import metrics as _metrics
from .log import get_logger

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

BREAKER_TRANSITIONS = _metrics.counter(
    "breaker_transitions_total",
    "Circuit-breaker state transitions, labeled by breaker name and the "
    "state entered.",
    labels=("name", "state"),
    legacy=lambda labels: [f"breaker.{labels['name']}.{labels['state']}"],
)
BREAKER_FAILURES = _metrics.counter(
    "breaker_failures_total",
    "Failures recorded against a circuit breaker (consecutive-failure "
    "accounting; a success resets the streak, not this counter).",
    labels=("name",),
    legacy=lambda labels: [f"breaker.{labels['name']}.failures"],
)


class CircuitBreaker:
    def __init__(
        self,
        name: str,
        failure_threshold: int = 3,
        cooldown_s: float = 60.0,
    ) -> None:
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._lock = _lockcheck.make_lock("circuit.breaker")
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._log = get_logger("resilience")

    # -- state --------------------------------------------------------------- #

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str, now: float, **fields) -> None:
        """Caller holds the lock."""
        if self._state == to:
            return
        frm, self._state = self._state, to
        BREAKER_TRANSITIONS.inc(name=self.name, state=to)
        self._log.warning(
            "breaker-transition",
            breaker=self.name,
            from_state=frm,
            to_state=to,
            at=round(now, 3),
            **fields,
        )

    # -- the protocol --------------------------------------------------------- #

    def allow(self, now: Optional[float] = None) -> bool:
        """May a call proceed? Open breakers refuse until the cooldown,
        then admit one half-open probe call."""
        now = _time.monotonic() if now is None else now
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._transition(HALF_OPEN, now)
                self._probes_in_flight = 0
            # half-open: admit one probe
            if self._probes_in_flight < 1:
                self._probes_in_flight += 1
                return True
            return False

    def record_success(self, now: Optional[float] = None) -> None:
        now = _time.monotonic() if now is None else now
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._transition(CLOSED, now)
            self._probes_in_flight = 0

    def record_failure(
        self, now: Optional[float] = None, error: str = ""
    ) -> None:
        now = _time.monotonic() if now is None else now
        with self._lock:
            self._consecutive_failures += 1
            BREAKER_FAILURES.inc(name=self.name)
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = now
                self._probes_in_flight = 0
                self._transition(
                    OPEN,
                    now,
                    consecutive_failures=self._consecutive_failures,
                    error=error[-300:],
                )
