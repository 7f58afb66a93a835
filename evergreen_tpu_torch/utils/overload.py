"""Service-wide overload protection: the load ladder the tick reads.

The part of ``evergreen_tpu/utils/overload.py`` the scheduler tick reads
and feeds. A ``LoadMonitor`` fuses health signals into a small ladder of
overload levels; at RED or worse ``run_tick`` sheds its optional work
(stats, then event emission), never planning.

Fused signals (gauges, pushed with ``observe``):

  ``tick_lag_s``        how far the scheduler tick is running past its
                        cadence (``note_tick_start``, at the top of each
                        tick; also derived live from the last tick start,
                        so a stalled tick shows a growing lag)
  ``queue_pending``     job-queue pending-set depth
  ``wal_backlog``       frames waiting on the durable store's async WAL
                        flusher (read from ``store.flush_backlog()`` at
                        each evaluation; 0 on the in-memory store)
  ``outbox_depth``      undelivered notification-outbox rows
  ``store_latency_ms``  EWMA (weight 0.4 on the new sample) of the tick's
                        WAL group commit, fed by ``run_tick``
  ``api_rps``           request rate over the HTTP surface

The port has no job queue, outbox or HTTP surface, so ``queue_pending``,
``outbox_depth`` and ``api_rps`` read 0 unless a caller pushes them, as
they read on an idle JAX store.

Levels (monotone ladder; higher sheds strictly more): GREEN, YELLOW, RED,
BLACK. Upward transitions apply immediately; downward transitions need
``hysteresis_ticks`` consecutive calm evaluations, stepping straight to
the calm level. Every transition bumps a counter, logs a breadcrumb and
emits one admin event.

``fuse_level`` is the sharded plane's fleet fuse over its shards'
ladders; it sets the ``overload_fleet_level`` gauge.

Shedding is never silent: ``record_shed`` counts each dropped unit of
work and updates an aggregate record in the ``overload_sheds``
collection, with an admin event on the first drop and every 100th.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Tuple

from . import lockcheck as _lockcheck
from . import metrics as _metrics

# -- levels ------------------------------------------------------------------ #

GREEN = 0
YELLOW = 1
RED = 2
BLACK = 3

LEVEL_NAMES = {GREEN: "green", YELLOW: "yellow", RED: "red", BLACK: "black"}

LEVEL_CHANGES = _metrics.counter(
    "overload_level_changes_total",
    "Overload-ladder transitions, labeled by the level entered.",
    labels=("level",),
    legacy=lambda labels: [
        "overload.level_change", f"overload.level.{labels['level']}"
    ],
)
SHEDS = _metrics.counter(
    "overload_sheds_total",
    "Units of work dropped or deferred by the overload ladder, labeled "
    "by the shed source kind (job, outbox, tick, api, cron).",
    labels=("kind",),
    legacy="overload.shed",
)


FLEET_LEVEL = _metrics.gauge(
    "overload_fleet_level",
    "Fleet-level overload fuse over the per-shard ladders (sharded "
    "control plane): 0=green 1=yellow 2=red 3=black.",
)


def level_name(level: int) -> str:
    return LEVEL_NAMES.get(level, str(level))


def fuse_level(levels: List[int]) -> int:
    """The fleet-level fuse over per-shard ladder levels (the sharded
    plane, ``scheduler/sharded_plane.py``). One hot shard is the
    rebalancer's job, so a lone outlier lifts the fuse at most to YELLOW
    (or to the second-hottest shard's level); two or more shards at the
    same hot level trip the fuse to that level."""
    if not levels:
        level = GREEN
    else:
        hi = max(levels)
        if hi <= YELLOW or len(levels) == 1:
            level = hi
        elif sum(1 for lvl in levels if lvl >= hi) >= 2:
            level = hi
        else:
            level = max(YELLOW, sorted(levels)[-2])
    FLEET_LEVEL.set(float(level))
    return level


#: aggregate shed records (one doc per (kind, key), bounded by the number
#: of distinct shed sources, not by drop volume)
SHEDS_COLLECTION = "overload_sheds"


class LoadMonitor:
    """Fuses gauges into one overload level with hysteresis; one per
    store (``monitor_for``)."""

    def __init__(self, store) -> None:
        self.store = store
        self._lock = _lockcheck.make_lock("overload.monitor")
        self._level = GREEN
        self._gauges: Dict[str, float] = {}
        #: consecutive calm evaluations (raw < current level)
        self._calm_streak = 0
        self._last_eval = 0.0
        #: logical (caller-clock) and monotonic stamps of the last tick
        #: start — lag between ticks uses the caller's clock, the live
        #: "tick stopped coming" check uses monotonic so harnesses that
        #: drive ticks with a fixed logical ``now`` are not misread
        self._last_tick_start = 0.0
        self._last_tick_mono = 0.0
        #: config snapshot + TTL (a store read per evaluate would tax the
        #: paths that auto-evaluate)
        self._cfg = None
        self._cfg_read_at = 0.0
        self._cfg_ttl_s = 30.0
        #: externally-imposed level floor: every consumer of ``level()``
        #: sees max(own ladder, floor)
        self._floor_level = GREEN

    # -- config --------------------------------------------------------- #

    @property
    def config(self):
        now = _time.monotonic()
        cfg = self._cfg
        if cfg is None or now - self._cfg_read_at > self._cfg_ttl_s:
            from ..settings import OverloadConfig

            cfg = OverloadConfig.get(self.store)
            with self._lock:
                self._cfg = cfg
                self._cfg_read_at = now
        return cfg

    # -- gauge intake ---------------------------------------------------- #

    def observe(self, name: str, value: float, ewma: float = 0.0) -> None:
        """Record a gauge sample. ``ewma`` > 0 blends it with the prior
        value (the weight of the new sample); 0 overwrites."""
        with self._lock:
            if ewma > 0.0 and name in self._gauges:
                value = ewma * value + (1.0 - ewma) * self._gauges[name]
            self._gauges[name] = value
        self._maybe_auto_evaluate()

    def note_tick_start(self, now: Optional[float] = None) -> float:
        """Called at the top of every scheduler tick; derives the
        tick-lag gauge from the gap between tick starts vs the cadence.
        Returns the observed lag."""
        now = _time.time() if now is None else now
        cadence = float(self.config.tick_cadence_s)
        with self._lock:
            prev = self._last_tick_start
            self._last_tick_start = now
            self._last_tick_mono = _time.monotonic()
        lag = max(0.0, (now - prev) - cadence) if prev else 0.0
        self.observe("tick_lag_s", lag)
        return lag

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    # -- evaluation ------------------------------------------------------ #

    def _signal_level(self, value: float, thresholds: List[float]) -> int:
        level = GREEN
        for i, cut in enumerate(thresholds[:3]):
            if cut > 0 and value >= cut:
                level = i + 1
        return level

    def _raw_level(self) -> Tuple[int, Dict[str, int]]:
        cfg = self.config
        with self._lock:
            gauges = dict(self._gauges)
            # live tick lag: a tick that simply stopped coming must show
            # up as growing lag, not a frozen gauge (monotonic clock —
            # harness ticks carry logical timestamps)
            if self._last_tick_mono:
                live = max(
                    0.0,
                    (_time.monotonic() - self._last_tick_mono)
                    - cfg.tick_cadence_s,
                )
                gauges["tick_lag_s"] = max(
                    gauges.get("tick_lag_s", 0.0), live
                )
        # the durable store's flusher backlog: a storm that outruns the
        # disk shows up here first
        backlog = getattr(self.store, "flush_backlog", lambda: 0)()
        gauges["wal_backlog"] = float(backlog)
        with self._lock:
            self._gauges["wal_backlog"] = float(backlog)
        per_signal = {
            "tick_lag_s": self._signal_level(
                gauges.get("tick_lag_s", 0.0), cfg.tick_lag_levels_s
            ),
            "queue_pending": self._signal_level(
                gauges.get("queue_pending", 0.0), cfg.queue_pending_levels
            ),
            "wal_backlog": self._signal_level(
                gauges.get("wal_backlog", 0.0), cfg.wal_backlog_levels
            ),
            "outbox_depth": self._signal_level(
                gauges.get("outbox_depth", 0.0), cfg.outbox_depth_levels
            ),
            "store_latency_ms": self._signal_level(
                gauges.get("store_latency_ms", 0.0),
                cfg.store_latency_ms_levels,
            ),
            "api_rps": self._signal_level(
                gauges.get("api_rps", 0.0), cfg.api_rps_levels
            ),
        }
        return max(per_signal.values()), per_signal

    def evaluate(self) -> int:
        """Recompute the level from current gauges. Upward transitions
        apply immediately; downward ones need ``hysteresis_ticks``
        consecutive calm evaluations."""
        cfg = self.config
        if not cfg.enabled:
            with self._lock:
                self._level = GREEN
            return GREEN
        raw, per_signal = self._raw_level()
        transition = None
        with self._lock:
            self._last_eval = _time.monotonic()
            current = self._level
            if raw > current:
                transition = (current, raw)
                self._level = raw
                self._calm_streak = 0
            elif raw < current:
                self._calm_streak += 1
                if self._calm_streak >= max(1, cfg.hysteresis_ticks):
                    transition = (current, raw)
                    self._level = raw
                    self._calm_streak = 0
            else:
                self._calm_streak = 0
            level = self._level
        if transition is not None:
            self._note_transition(transition[0], transition[1], per_signal)
        return level

    def _maybe_auto_evaluate(self) -> None:
        """Gauge pushes re-evaluate at most once per eval interval, so a
        pushed storm moves the ladder without a tick running."""
        interval = float(self.config.eval_interval_s)
        with self._lock:
            due = _time.monotonic() - self._last_eval >= interval
        if due:
            self.evaluate()

    def _note_transition(
        self, old: int, new: int, per_signal: Dict[str, int]
    ) -> None:
        from ..models import event as event_mod
        from .log import get_logger

        LEVEL_CHANGES.inc(level=level_name(new))
        drivers = sorted(
            s for s, lvl in per_signal.items() if lvl >= new and new > GREEN
        )
        log = get_logger("overload")
        emit = log.warning if new > old else log.info
        emit(
            "overload-level",
            old=level_name(old),
            new=level_name(new),
            drivers=drivers,
            gauges={k: round(v, 2) for k, v in self.gauges().items()},
        )
        try:
            event_mod.log(
                self.store,
                event_mod.RESOURCE_ADMIN,
                "OVERLOAD_LEVEL",
                level_name(new),
                {"old": level_name(old), "drivers": drivers},
            )
        except Exception:  # noqa: BLE001 — level-transition events are
            # advisory: a failing store must not turn the monitor that
            # reports on it into a crash source
            pass

    # -- consumption ------------------------------------------------------ #

    def set_floor(self, level: int) -> None:
        """Impose an external level floor (GREEN clears it). The floor
        shapes what ``level()`` reports, never the hysteresis state the
        monitor's own signals drive, and not ``evaluate()``'s result."""
        with self._lock:
            self._floor_level = max(GREEN, min(BLACK, int(level)))

    def level(self) -> int:
        with self._lock:
            return max(self._level, self._floor_level)


# -- per-store singletons ----------------------------------------------------- #

_monitors_lock = _lockcheck.make_lock("overload.registry")


def monitor_for(store) -> LoadMonitor:
    """Per-store LoadMonitor singleton, attached to the store object so
    their lifetimes are one."""
    monitor = getattr(store, "_overload_monitor", None)
    if monitor is None:
        with _monitors_lock:
            monitor = getattr(store, "_overload_monitor", None)
            if monitor is None:
                monitor = LoadMonitor(store)
                store._overload_monitor = monitor
    return monitor


# -- shed accounting ---------------------------------------------------------- #


def record_shed(store, kind: str, key: str, detail: str = "") -> int:
    """The ONE place a dropped/deferred unit of work is recorded: bump
    the counters and the per-(kind, key) aggregate doc, emit an admin
    event on the first drop and every 100th. Returns the running count
    for this (kind, key)."""
    from ..models import event as event_mod
    from .log import get_logger

    SHEDS.inc(kind=kind)
    now = _time.time()
    doc_id = f"{kind}:{key}"
    coll = store.collection(SHEDS_COLLECTION)
    box = {"n": 1}

    def bump(doc: dict) -> None:
        doc["count"] += 1
        doc["last_at"] = now
        if detail:
            doc["detail"] = detail
        box["n"] = doc["count"]

    if not coll.mutate(doc_id, bump):
        coll.upsert(
            {
                "_id": doc_id,
                "kind": kind,
                "key": key,
                "count": 1,
                "first_at": now,
                "last_at": now,
                "detail": detail,
            }
        )
    n = box["n"]
    if n == 1 or n % 100 == 0:
        get_logger("overload").warning(
            "work-shed", kind=kind, key=key, count=n, detail=detail
        )
        try:
            event_mod.log(
                store,
                event_mod.RESOURCE_ADMIN,
                "WORK_SHED",
                doc_id,
                {"kind": kind, "key": key, "count": n},
            )
        except Exception:  # noqa: BLE001 — the SHEDS record and counter
            # above are the ledger; the event is an advisory mirror
            pass
    return n
