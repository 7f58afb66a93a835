"""Runtime lock-order witness.

Cross-function and cross-thread lock orders (the WAL flusher taking
``durable.flush`` then calling back into the journal, a supervisor
reader thread touching the round lock) are witnessed at runtime:

  * every lock of the package is created through ``make_lock`` /
    ``make_rlock`` / ``make_condition`` with a stable ROLE name
    (``tests/test_torch_lockcheck.py`` rejects a raw
    ``threading.Lock()``, ``RLock()`` or ``Condition()`` anywhere else in
    the package, keeping the inventory complete);
  * with ``EVERGREEN_TPU_LOCKCHECK`` unset the factories return the raw
    ``threading`` primitive: the production hot path pays nothing, not
    even an attribute hop;
  * with ``EVERGREEN_TPU_LOCKCHECK=1`` (set by the crash matrix,
    ``scenarios/crash_matrix.py``, before any package import) each lock
    is wrapped: a per-thread held-stack records acquisition order, every
    observed ``held -> acquired`` pair becomes an edge in one global order
    graph, and an acquisition whose reverse edge was already witnessed is
    an INVERSION: recorded, printed to stderr, and fatal to the harness
    via ``assert_clean()``;
  * ``EVERGREEN_TPU_LOCKCHECK=strict`` additionally raises
    ``LockOrderError`` at the acquisition site (pin-pointing the stack
    that completed the cycle: the debugging mode).

Role names, not instances: two ``DurableStore`` objects share the role
``"durable.flush"``. Same-role pairs are ignored (two stores' journal
locks taken either way around is a sharding pattern, not a deadlock:
each thread only ever holds one), so the witness checks the ordering
DISCIPLINE between roles, which is what deadlocks are made of. The role
names are the JAX package's where it creates the same lock.

The env knob is read at lock-CREATION time: set it before the process
imports ``evergreen_tpu_torch`` (the crash matrix sets it at the top of
its entry point, so child processes inherit it ahead of their first
lock).
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

_ENV = "EVERGREEN_TPU_LOCKCHECK"

#: internal bookkeeping lock — deliberately a RAW primitive (never
#: witnessed: it is a leaf taken only inside the witness itself)
_state_lock = threading.Lock()
#: (held_role, acquired_role) → "thread=… first-seen site" for the first
#: time that ordered pair was observed
_edges: Dict[Tuple[str, str], str] = {}
#: recorded inversions: dicts with held/acquired/thread/first_seen
_violations: List[dict] = []
_tls = threading.local()


class LockOrderError(RuntimeError):
    """A lock acquisition inverted an order the witness already saw."""


def enabled() -> bool:
    """Whether the witness mode is on for THIS process (env at call
    time; factories consult it at lock creation)."""
    return bool(os.environ.get(_ENV))


def _strict() -> bool:
    return os.environ.get(_ENV) == "strict"


def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = []
        _tls.stack = st
    return st


def _check_order(role: str) -> None:
    """Inversion detection for an acquisition ABOUT to happen. Runs
    BEFORE the inner lock is taken so a strict-mode raise can never
    leak a held primitive (the held-stack is thread-local, so checking
    pre-acquire sees exactly the state the acquisition will commit
    under)."""
    st = _stack()
    if role in st:
        return  # reentrant: no new ordering fact
    me = threading.current_thread().name
    with _state_lock:
        for held in dict.fromkeys(st):  # preserve order, dedupe
            if held == role:
                continue
            rev = (role, held)
            if rev in _edges and (held, role) not in _edges:
                rec = {
                    "held": held,
                    "acquired": role,
                    "thread": me,
                    "reverse_seen": _edges[rev],
                }
                _violations.append(rec)
                print(
                    f"lockcheck: ORDER INVERSION thread={me} "
                    f"acquired {role!r} while holding {held!r}; "
                    f"reverse order first seen {_edges[rev]}",
                    file=sys.stderr,
                    flush=True,
                )
                if _strict():
                    raise LockOrderError(
                        f"{role!r} acquired while holding {held!r} "
                        f"(reverse seen {_edges[rev]})"
                    )


def _note_acquired(role: str, record_edges: bool = True) -> None:
    """Commit a SUCCESSFUL acquisition: record the order edges and push
    the held-stack entry (detection already ran in _check_order).
    ``record_edges=False`` for a non-blocking try-lock: a try-lock
    BACKS OFF instead of waiting, so the held→acquired pair it creates
    can never close a deadlock cycle and must not seed the graph —
    but the lock IS now held, so the stack entry (and every later
    blocking edge FROM this role) still records."""
    st = _stack()
    if record_edges and role not in st:
        me = threading.current_thread().name
        with _state_lock:
            for held in dict.fromkeys(st):
                if held != role:
                    _edges.setdefault((held, role), f"thread={me}")
    st.append(role)


def _note_released(role: str) -> None:
    st = _stack()
    # pop the most recent occurrence: releases may be out of LIFO order
    # (condition wait, explicit release) and reentrant locks repeat
    for i in range(len(st) - 1, -1, -1):
        if st[i] == role:
            del st[i]
            return


class _WitnessLock:
    """Order-witnessing wrapper around a ``threading`` lock primitive.
    Duck-types the Lock/RLock surface ``threading.Condition`` needs."""

    __slots__ = ("role", "_inner")

    def __init__(self, role: str, inner) -> None:
        self.role = role
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # a non-blocking try-lock cannot deadlock (it fails instead of
        # waiting — DurableStore.checkpoint's inline-compaction path is
        # the deliberate deadlock-avoidance idiom), so it neither
        # order-checks nor seeds graph edges
        if blocking:
            _check_order(self.role)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self.role, record_edges=bool(blocking))
        return got

    def release(self) -> None:
        _note_released(self.role)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<witness lock {self.role!r} on {self._inner!r}>"


class _WitnessRLock(_WitnessLock):
    __slots__ = ()

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else False

    # Condition(RLock) uses these to fully release a reentrant hold
    # around wait(); mirror the bookkeeping so the held-stack drains.
    def _release_save(self):
        state = self._inner._release_save()
        _note_released(self.role)
        return state

    def _acquire_restore(self, state) -> None:
        _check_order(self.role)
        self._inner._acquire_restore(state)
        _note_acquired(self.role)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def make_lock(role: str):
    """A ``threading.Lock`` — witnessed under ``EVERGREEN_TPU_LOCKCHECK``."""
    inner = threading.Lock()
    return _WitnessLock(role, inner) if enabled() else inner


def make_rlock(role: str):
    """A ``threading.RLock`` — witnessed under ``EVERGREEN_TPU_LOCKCHECK``."""
    inner = threading.RLock()
    return _WitnessRLock(role, inner) if enabled() else inner


def make_condition(role: str, lock=None):
    """A ``threading.Condition`` over a witnessed lock (or an
    already-witnessed ``lock`` the caller shares with plain acquires)."""
    if lock is None:
        lock = make_lock(role)
    return threading.Condition(lock)


def violations() -> List[dict]:
    with _state_lock:
        return list(_violations)


def reset() -> None:
    """Clear the order graph and recorded inversions (test isolation).
    Per-thread held-stacks are left alone: live threads still hold what
    they hold."""
    with _state_lock:
        _edges.clear()
        _violations.clear()


def assert_clean(context: str = "") -> None:
    """Fail loudly if any inversion was recorded in this process — the
    matrix harnesses' end-of-run check."""
    v = violations()
    if v:
        lines = "; ".join(
            f"{r['acquired']!r} while holding {r['held']!r} "
            f"(thread {r['thread']})"
            for r in v
        )
        raise LockOrderError(
            f"lockcheck{': ' + context if context else ''}: "
            f"{len(v)} lock-order inversion(s): {lines}"
        )
