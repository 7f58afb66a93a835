"""Sharded long-poll dispatch hub: agents park instead of re-polling.

A copy of ``evergreen_tpu/dispatch/longpoll.py``. An agent whose pull
came back empty PARKS on a condition variable keyed by its host id and
is woken when its distro's queue plausibly changed — the persister
rewrote/patched/spliced the queue doc, or a dependency wake
(``dispatch/wake.py``) flipped deps-met flags. Between wakes a parked
agent costs nothing.

Anatomy:

* one ``LongPollHub`` per store (``hub_for``), holding ``n_shards``
  condition variables; a waiter parks on ``shard = hash(host_id) % n``
  so a wake never convoys every parked thread over a single mutex;
* a per-distro **generation** counter, bumped by a listener installed on
  the task-queue collections (any journaled write to a distro's queue
  doc counts — the listener only increments an int, per the Collection
  listener contract) and explicitly by ``notify()`` callers that know
  work arrived (the tick's persister, the dependency wake);
* a per-distro **work ledger** (``pending``): ``notify`` credits it, a
  woken waiter claims one credit, an empty pull (``note_empty``) decays
  it;
* ``wait()`` parks until the distro's generation moves past the value
  the caller sampled BEFORE its empty pull (no lost-wakeup window), or
  the timeout expires;
* ``notify(distro, n_hint)`` wakes everything by default; with a hint it
  wakes ~the hinted work spread round-robin across shards.

Lock order: a notifier may hold a Collection lock when the listener
fires; shard condition locks are leaves (waiters never touch store
state while holding one), so collection → shard never cycles.
"""
from __future__ import annotations

import random as _random
import time as _time
from typing import Dict, Optional

from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics

LONGPOLL_WAITERS = _metrics.gauge(
    "dispatch_longpoll_waiters",
    "Agents currently parked on the sharded long-poll dispatch hub "
    "waiting for their distro's queue to change.",
)
LONGPOLL_WAKES = _metrics.counter(
    "dispatch_longpoll_wakes_total",
    "Long-poll waiter wake-ups, by outcome: work (generation moved), "
    "recheck (interval forced a look), timeout (park deadline hit).",
    labels=("outcome",),
)

DEFAULT_SHARDS = 32
#: parked waiters re-check their generation at least this often even
#: without a wake — the starvation bound for hinted (bounded) wakes
DEFAULT_RECHECK_S = 1.0


class LongPollHub:
    def __init__(
        self,
        n_shards: int = DEFAULT_SHARDS,
        recheck_s: float = DEFAULT_RECHECK_S,
    ) -> None:
        self.n_shards = max(1, int(n_shards))
        self.recheck_s = max(0.01, float(recheck_s))
        self._conds = [
            _lockcheck.make_condition("dispatch.longpoll.shard")
            for _ in range(self.n_shards)
        ]
        #: waiters parked per shard (under that shard's lock)
        self._n_waiting = [0] * self.n_shards
        #: distro id -> generation; int bumps are atomic under the GIL
        #: and every read is a snapshot — no extra lock on the hot path
        self._gens: Dict[str, int] = {}
        #: distro id -> plausibly-unclaimed work (the wake LEDGER):
        #: ``notify`` credits it; a waiter CLAIMS one credit on every
        #: wake exit (the sole waiter-side debit — debiting the pull
        #: outcome too systematically halved the woken cohort), and an
        #: empty pull (``note_empty``) decays credit the parked fleet
        #: cannot claim. Re-check timeouts consult it so a generation
        #: bump does NOT sweep every parked agent through a pull —
        #: wake cost scales with the work that arrived, not the fleet
        #: parked.
        self._pending: Dict[str, int] = {}
        #: round-robin cursor for hinted wakes
        self._rr = 0
        self._total_waiting = 0
        self._count_lock = _lockcheck.make_lock("dispatch.longpoll.count")

    # -- generation ------------------------------------------------------ #

    def generation(self, distro_id: str) -> int:
        """Sample BEFORE an empty pull; pass to ``wait`` so a queue
        write landing between the pull and the park still wakes you."""
        return self._gens.get(distro_id, 0)

    def bump(self, distro_id: str) -> None:
        """Generation-only advance (the Collection listener path — must
        stay trivial; it runs under the collection lock). Waiters parked
        on a condition still need ``notify`` to wake before their
        re-check interval."""
        self._gens[distro_id] = self._gens.get(distro_id, 0) + 1

    def note_empty(self, distro_id: str) -> None:
        """A ledger-prompted look found nothing dispatchable: evidence
        the credit was overstated (a hinted queue entry that never
        became a handout) — decay it so re-checks stop looking."""
        cur = self._pending.get(distro_id, 0)
        if cur:
            self._pending[distro_id] = cur - 1

    def pending(self, distro_id: str) -> int:
        return self._pending.get(distro_id, 0)

    # -- wake ------------------------------------------------------------ #

    def notify(self, distro_id: str, n_hint: int = 0) -> None:
        """Bump the distro's generation, credit the work ledger, and
        wake parked waiters: everything by default, ~``n_hint`` spread
        across shards when the caller knows how much work arrived. An
        exact-sized wake is enough to DRAIN the work (an agent that
        takes a task pulls again on completion, sweeping any
        leftovers), and every extra woken agent is a guaranteed-empty
        pull convoying the herd — the ledger-gated re-check is the
        catch-all for stragglers."""
        self.bump(distro_id)
        if n_hint <= 0:
            # unsized wake: anything could have changed — credit the
            # ledger by the parked population so every re-check looks
            self._pending[distro_id] = (
                self._pending.get(distro_id, 0) + max(1, self.waiters)
            )
            for cond in self._conds:
                with cond:
                    cond.notify_all()
            return
        self._pending[distro_id] = (
            self._pending.get(distro_id, 0) + n_hint
        )
        if self._total_waiting == 0:
            # nobody parked: skip the shard sweep entirely (the tick's
            # persister notifies per distro — 200 × 32 lock acquires per
            # tick would tax ticks for zero wakes)
            return
        # 25% headroom over the hint: claim races between exiting
        # waiters can strand one unit of work otherwise (observed as a
        # rare ~30s straggler — the stranded task waited out a re-check
        # window), and a handful of extra empty pulls is noise
        budget = max(1, n_hint + (n_hint + 3) // 4)
        start = self._rr
        self._rr = (self._rr + 1) % self.n_shards
        for k in range(self.n_shards):
            if budget <= 0:
                break
            i = (start + k) % self.n_shards
            with self._conds[i]:
                waiting = self._n_waiting[i]
                if not waiting:
                    continue
                n = min(budget, waiting)
                self._conds[i].notify(n)
                budget -= n

    # -- park ------------------------------------------------------------ #

    def wait(
        self,
        distro_id: str,
        host_id: str,
        gen: int,
        timeout_s: float,
        now: Optional[float] = None,
    ) -> bool:
        """Park until work plausibly arrived for ``distro_id`` or the
        timeout expires. Returns True when the caller should re-pull,
        False on a clean timeout.

        Exits that return True:
          * a DIRECTED wake (cond.notify from a sized ``notify``) with
            the generation moved — the O(work) fast path;
          * a jittered re-check timeout with the generation moved AND
            the work ledger showing unclaimed credit — so a generation
            bump alone does not sweep every parked agent through empty
            pulls. Exiting CLAIMS one credit, so per burst at most
            ~credit waiters exit however many are parked.

        There is deliberately NO unconditional deep re-check: the
        caller's own ``timeout_s`` expiry (the long-poll deadline every
        client re-arms) is the per-agent periodic look, and anything
        faster re-synchronizes with bursty arrivals and sweeps the
        parked fleet through empty pulls every burst.

        A directed wake that lands on a waiter whose generation did NOT
        move (shards mix distros) passes the baton once — one
        ``notify(1)`` on its own shard — so a misdirected wake is not
        silently consumed."""
        if self._gens.get(distro_id, 0) != gen:
            return True
        deadline = _time.monotonic() + max(0.0, timeout_s)
        shard = hash(host_id) % self.n_shards
        cond = self._conds[shard]
        baton_passed = False
        with self._count_lock:
            self._total_waiting += 1
            LONGPOLL_WAITERS.set(float(self._total_waiting))
        try:
            with cond:
                self._n_waiting[shard] += 1
                try:
                    while True:
                        if self._gens.get(distro_id, 0) != gen:
                            # directed wake or first-loop catch-up: only
                            # leave when the ledger says the credit may
                            # be ours
                            credit = self._pending.get(distro_id, 0)
                            if credit > 0:
                                # CLAIM the credit on the way out: at
                                # most ~pending waiters exit per wave,
                                # so the exit herd is O(work arrived),
                                # never O(fleet parked). Best-effort
                                # (GIL-atomic read+write; a rare racing
                                # double-exit is one extra empty pull)
                                self._pending[distro_id] = credit - 1
                                LONGPOLL_WAKES.inc(outcome="work")
                                return True
                            # claimed-out bump: adopt it and re-park
                            gen = self._gens.get(distro_id, 0)
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            LONGPOLL_WAKES.inc(outcome="timeout")
                            return False
                        # jittered re-check: a fleet that parked
                        # together (post-wave drain) must not re-check
                        # together — a synchronized fleet-wide look IS
                        # the convoy the bounded wake exists to avoid.
                        # The cadence also stretches with the parked
                        # population: re-check wakeups cost a context
                        # switch each, and a fleet of them per second is
                        # real scheduler pressure for zero information.
                        recheck = (
                            self.recheck_s + self._total_waiting / 2000.0
                        ) * (0.5 + _random.random())
                        woke = cond.wait(min(remaining, recheck))
                        if (
                            woke
                            and self._gens.get(distro_id, 0) == gen
                            and not baton_passed
                        ):
                            # a directed wake meant for a different
                            # distro's waiter in this shard: pass it on
                            # (once) instead of eating it
                            baton_passed = True
                            cond.notify(1)
                finally:
                    self._n_waiting[shard] -= 1
        finally:
            with self._count_lock:
                self._total_waiting -= 1
                LONGPOLL_WAITERS.set(float(self._total_waiting))

    @property
    def waiters(self) -> int:
        return self._total_waiting


# -- per-store singleton ----------------------------------------------------- #

_hub_lock = _lockcheck.make_lock("dispatch.longpoll.hub")


def hub_for(store, n_shards: Optional[int] = None) -> LongPollHub:
    """Per-store LongPollHub singleton, attached to the store object
    (same lifetime pattern as utils/overload.monitor_for). First call
    installs the queue-collection listeners that feed generations; shard
    count comes from ReadPathConfig unless given explicitly."""
    hub = getattr(store, "_longpoll_hub", None)
    if hub is not None:
        return hub
    with _hub_lock:
        hub = getattr(store, "_longpoll_hub", None)
        if hub is not None:
            return hub
        if n_shards is None:
            try:
                from ..settings import ReadPathConfig

                cfg = ReadPathConfig.get(store)
                n_shards, recheck = cfg.longpoll_shards, cfg.longpoll_recheck_s
            except Exception:  # noqa: BLE001 — a read-only/odd store
                n_shards, recheck = DEFAULT_SHARDS, DEFAULT_RECHECK_S
        else:
            recheck = DEFAULT_RECHECK_S
        hub = LongPollHub(n_shards=n_shards, recheck_s=recheck)
        from ..models import task_queue as tq_mod

        for secondary in (False, True):
            tq_mod.coll(store, secondary).add_listener(hub.bump)
        store._longpoll_hub = hub
        return hub
