"""Deadlines and retry backoff.

A copy of the part of ``evergreen_tpu/utils/retry.py`` that the fleet
runtime uses: ``Deadline`` bounds a worker's boot, its heartbeats and
each reply the supervisor waits for, and ``RetryPolicy.backoff_s`` paces
a crashed worker's respawns (``runtime/supervisor.py``), with the same
jittered exponential ladder. ``DeadlineExceeded`` and ``TransientError``
keep the JAX package's names. ``RetryPolicy.call`` (the retry loop of the
JAX package's agent, event and cloud adopters), its ``deadline_s`` and
``retry_on`` fields and the ``retry_exhausted_total`` counter come with
those adopters.
"""
from __future__ import annotations

import dataclasses
import random
import time as _time
from typing import Callable, Optional


class DeadlineExceeded(Exception):
    """A per-call time budget ran out before the call succeeded."""


class TransientError(Exception):
    """Wrapper adopters raise around retryable transport failures when the
    natural exception hierarchy can't separate them."""


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
        self._expires = None if budget_s is None else clock() + max(0.0, budget_s)

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
            raise DeadlineExceeded(f"{what} exceeded its {self.budget_s}s deadline")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts and jittered exponential backoff."""

    attempts: int = 3
    base_backoff_s: float = 0.2
    max_backoff_s: float = 10.0
    #: fraction of each backoff randomized (0 = deterministic backoff)
    jitter: float = 0.5
    #: full-jitter mode: each pause is uniform in [0, base * 2^attempt]
    #: instead of shaving at most ``jitter`` off the exponential ceiling
    full_jitter: bool = False

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff after the given 0-based attempt."""
        base = min(self.max_backoff_s, self.base_backoff_s * (2 ** attempt))
        if self.full_jitter:
            return base * rng.random()
        if self.jitter <= 0:
            return base
        return base * (1.0 - self.jitter * rng.random())
