"""Deadlines, retry backoff and the retry loop.

A copy of ``evergreen_tpu/utils/retry.py``: ``Deadline`` bounds a fleet
worker's boot, its heartbeats and each reply the supervisor waits for;
``RetryPolicy.backoff_s`` paces a crashed worker's respawns
(``runtime/supervisor.py``); ``RetryPolicy.call`` is the retry loop,
with ``deadline_s`` gating retry scheduling (in-flight I/O keeps its own
timeout), ``retry_on`` naming what is retried, and a structured-log line
and the ``retry_exhausted_total`` counter when a call spends its
attempts. Its adopter in the port is the provisioning plane's provider
status read (``cloud/provisioning.py::_STATUS_RETRY``).
"""
from __future__ import annotations

import dataclasses
import random
import time as _time
from typing import Callable, Optional, Tuple, Type

from . import metrics as _metrics
from .log import get_logger

RETRY_EXHAUSTED = _metrics.counter(
    "retry_exhausted_total",
    "Calls that spent every retry attempt (or their deadline) and "
    "re-raised, labeled by the adopter's operation tag.",
    labels=("operation",),
    legacy="retry.exhausted",
)


class DeadlineExceeded(Exception):
    """A per-call time budget ran out before the call succeeded."""


class TransientError(Exception):
    """Wrapper adopters raise around retryable transport failures when the
    natural exception hierarchy can't separate them (HTTPError ⊂ URLError
    ⊂ OSError makes 'retry transport, not protocol' untypeable)."""


class Deadline:
    """An absolute time budget handed down a call chain.

    ``None``-budget deadlines never expire, so callers can thread one
    unconditionally. The clock is injectable for deterministic tests.
    """

    def __init__(
        self,
        budget_s: Optional[float],
        clock: Callable[[], float] = _time.monotonic,
    ) -> None:
        self._clock = clock
        self.budget_s = budget_s
        self._expires = (
            None if budget_s is None else clock() + max(0.0, budget_s)
        )

    @classmethod
    def after(cls, budget_s: Optional[float]) -> "Deadline":
        return cls(budget_s)

    def remaining(self) -> float:
        if self._expires is None:
            return float("inf")
        return self._expires - self._clock()

    def exceeded(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "call") -> None:
        if self.exceeded():
            raise DeadlineExceeded(
                f"{what} exceeded its {self.budget_s}s deadline"
            )


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts + jittered exponential backoff + per-call deadline.

    ``call`` re-raises the LAST error unwrapped, so adopters keep their
    existing exception contracts; exhaustion is still observable through
    the ``retry-exhausted`` structured log line and the
    ``retry.exhausted`` / ``retry.exhausted.<operation>`` counters.
    """

    attempts: int = 3
    base_backoff_s: float = 0.2
    max_backoff_s: float = 10.0
    #: fraction of each backoff randomized (0 = deterministic backoff)
    jitter: float = 0.5
    #: full-jitter mode (AWS "exponential backoff and jitter"): each
    #: pause is uniform in [0, base * 2^attempt] instead of shaving at
    #: most ``jitter`` off the exponential ceiling. Adopters whose
    #: failures are fleet-correlated (every agent sees the same
    #: partition heal at the same instant) need the full spread — a
    #: 50%-band jitter still synchronizes half the fleet's retries
    #: into the same window (thundering-herd storm on heal)
    full_jitter: bool = False
    #: budget gating RETRY SCHEDULING: no backoff sleep or fresh attempt
    #: starts past it. It cannot preempt an attempt already executing —
    #: the called I/O must carry its own timeout (urlopen timeout=,
    #: subprocess timeout=, …)
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff after the given 0-based attempt."""
        base = min(self.max_backoff_s, self.base_backoff_s * (2 ** attempt))
        if self.full_jitter:
            return base * rng.random()
        if self.jitter <= 0:
            return base
        return base * (1.0 - self.jitter * rng.random())

    def call(
        self,
        fn: Callable,
        *args,
        operation: str = "",
        component: str = "retry",
        deadline: Optional[Deadline] = None,
        sleep: Callable[[float], None] = _time.sleep,
        rng: Optional[random.Random] = None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        **kwargs,
    ):
        """Run ``fn`` under this policy. Raises the last error unwrapped
        on exhaustion (attempts spent, or the deadline refusing another
        attempt/sleep — the deadline never interrupts an attempt already
        in flight; see ``deadline_s``).

        ``rng`` makes the jitter replayable; ``sleep`` is injectable so
        tests and soak schedules never wall-wait.
        """
        if deadline is None:
            deadline = Deadline(self.deadline_s or None)
        rng = rng or random
        op = operation or getattr(fn, "__name__", "call")
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.attempts)):
            if attempt and deadline.exceeded():
                break  # the attempt itself outlived the budget
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:
                last = exc
                if attempt + 1 >= max(1, self.attempts):
                    break
                pause = self.backoff_s(attempt, rng)
                if pause >= deadline.remaining():
                    break  # sleeping would outlive the budget: give up now
                if on_retry is not None:
                    on_retry(attempt, exc)
                if pause > 0:
                    sleep(pause)
        RETRY_EXHAUSTED.inc(operation=operation or "")
        get_logger(component).warning(
            "retry-exhausted",
            operation=op,
            attempts=self.attempts,
            error=repr(last),
        )
        assert last is not None
        raise last
