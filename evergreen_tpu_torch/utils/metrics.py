"""Typed metrics: labeled Counter, Gauge and Histogram instruments in one
process-wide registry.

The part of ``evergreen_tpu/utils/metrics.py`` the tick, the capacity
plane, the overload ladder, the breakers, the fault seams and the
durable store (its WAL counters, flush histogram and backlog gauge, under
the JAX package's names) use: instruments are registered once with a
help string and labels from a fixed vocabulary, label sets are bounded
(past ``DEFAULT_MAX_SERIES`` combinations new ones fold into one ``other``
series), histograms are fixed-bucket, and ``state``/``snapshot_delta``
bracket a measurement with a p50/p95/p99 readout of what it observed. A Counter's
``legacy`` names mirror its increments into ``utils/log.py``'s flat
counters. Every instrument registers in the one process-wide registry
with the default series bound and buckets. A Gauge holds the last value
set (or the running sum of ``inc``) per label set; the sharded plane's
fleet fuse and the backend probe set theirs. The Prometheus text
rendering (``GET /metrics``) and the registry's save/restore for test
isolation are not ported.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import lockcheck as _lockcheck
from . import log as _log

# --------------------------------------------------------------------------- #
# label hygiene
# --------------------------------------------------------------------------- #

#: the allowed label vocabulary, the JAX package's: a fixed,
#: low-cardinality set — task ids, host ids, user ids and friends must
#: NEVER be labels
ALLOWED_LABELS = frozenset(
    {
        "seam",        # fault-injection seam (utils/faults.py)
        "distro",      # distro id (bounded by the fleet config)
        "job_class",   # JobQueue priority class: agent/planning/reconcile/stats
        "level",       # overload ladder level: green/yellow/red/black
        "cause",       # failure taxonomy bucket (tick degradation, TPU probe)
        "kind",        # shed source kind (utils/overload.py record_shed)
        "collection",  # outbox collection name
        "populator",   # cron populator name
        "state",       # breaker state: open/closed/half-open
        "name",        # breaker/instrument instance name (bounded set)
        "operation",   # retry-policy operation tag
        "phase",       # tick pipeline phase
        "signal",      # overload monitor gauge name
        "outcome",     # success/failure-ish result buckets
        "mode",        # execution-path selector (fused/two_call/heuristic)
        "shard",       # scheduler shard id (bounded by the shard count)
        "pool",        # provider capacity pool (fixed Provider vocabulary)
        "replica",     # read-replica id (bounded by the replica fleet)
        "endpoint",    # API route pattern (bounded by the route table)
    }
)

#: per-instrument bound on distinct label combinations; combination
#: number DEFAULT_MAX_SERIES+1 and beyond fold into one all-``other`` series
DEFAULT_MAX_SERIES = 256

#: fixed millisecond buckets shared by the duration histograms (tick
#: phases, WAL flush, job runs, API requests) — one vocabulary so
#: dashboards can overlay them
DEFAULT_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


class MetricError(ValueError):
    """Bad registration or bad use of an instrument."""


#: snake_case with a subsystem prefix: at least two underscore-separated
#: segments (``scheduler_tick_duration_ms``, ``jobs_shed_total``)
_NAME_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)+$")


# --------------------------------------------------------------------------- #
# instruments
# --------------------------------------------------------------------------- #


LegacySpec = Optional[object]  # str | Callable[[Dict[str, str]], Iterable[str]]


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()) -> None:
        if not _NAME_RE.match(name):
            raise MetricError(
                f"{name!r}: instrument names are snake_case with a "
                "subsystem prefix (at least two segments)"
            )
        if not help.strip():
            raise MetricError(f"{name}: a help string is required")
        bad = [l for l in labels if l not in ALLOWED_LABELS]
        if bad:
            raise MetricError(
                f"{name}: labels {bad} not in the allowed vocabulary "
                f"{sorted(ALLOWED_LABELS)}"
            )
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labels)
        self._lock = _lockcheck.make_lock("metrics.instrument")
        #: label-values tuple -> series payload (float for counters,
        #: [bucket_counts, sum, count] for histograms)
        self._series: Dict[Tuple[str, ...], object] = {}

    # -- series bookkeeping ------------------------------------------------- #

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(labels[k]) for k in self.labelnames)
        # bounded label sets: an unexpected high-cardinality value folds
        # into ONE 'other' series instead of leaking a series per value
        if key not in self._series and len(self._series) >= DEFAULT_MAX_SERIES:
            return tuple("other" for _ in key)
        return key


class Counter(_Instrument):
    """Monotone counter; ``legacy`` mirrors increments into the flat
    ``utils/log.py`` dict so ``counters_snapshot()`` keeps its historical
    shape (see module docstring)."""

    kind = "counter"

    def __init__(
        self,
        name: str,
        help: str,
        labels: Sequence[str] = (),
        legacy: LegacySpec = None,
    ) -> None:
        super().__init__(name, help, labels)
        self.legacy = legacy

    def _legacy_names(self, labels: Dict[str, object]) -> List[str]:
        if self.legacy is None:
            return []
        if callable(self.legacy):
            return list(self.legacy(dict(labels)))
        names: List[str] = [self.legacy]
        if self.labelnames:
            vals = [str(labels[k]) for k in self.labelnames]
            if all(vals):  # an empty label value never minted a suffix
                names.append(self.legacy + "." + ".".join(vals))
        return names

    def inc(self, by: float = 1, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(self._series.get(key, 0.0)) + by
        for flat in self._legacy_names(labels):
            _log.incr_counter(flat, int(by))

    def value(self, **labels: object) -> float:
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def total(self) -> float:
        with self._lock:
            return sum(float(v) for v in self._series.values())


class Gauge(_Instrument):
    """A value that goes up and down: the last ``set``, moved by ``inc``."""

    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, by: float = 1, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(self._series.get(key, 0.0)) + by

    def value(self, **labels: object) -> float:
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Histogram(_Instrument):
    """Histogram over ``DEFAULT_BUCKETS_MS``. A series holds
    ``(bucket_counts, sum, count)`` where ``bucket_counts[i]`` counts
    observations ≤ ``buckets[i]`` NON-cumulatively; the final implicit
    bucket is +Inf."""

    kind = "histogram"
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS

    def observe(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = series
            counts, _, _ = series
            i = len(self.buckets)  # +Inf slot
            for bi, upper in enumerate(self.buckets):
                if v <= upper:
                    i = bi
                    break
            counts[i] += 1
            series[1] += v
            series[2] += 1

    def state(self, **labels: object) -> Tuple[List[int], float, int]:
        """A copy of one series' raw ``(bucket_counts, sum, count)`` —
        pair with :meth:`snapshot_delta` to read only the observations
        made since."""
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return ([0] * (len(self.buckets) + 1), 0.0, 0)
            return (list(series[0]), series[1], series[2])

    def snapshot_delta(
        self, prev: Tuple[List[int], float, int], **labels: object
    ) -> Dict[str, float]:
        """count/sum/p50/p95/p99 of the observations made AFTER ``prev``
        (a :meth:`state` capture)."""
        cur = self.state(**labels)
        counts = [c - p for c, p in zip(cur[0], prev[0])]
        total_sum = cur[1] - prev[1]
        total_count = cur[2] - prev[2]
        return {
            "count": total_count,
            "sum": round(total_sum, 3),
            "p50": round(self._quantile_from(counts, total_count, 0.50), 3),
            "p95": round(self._quantile_from(counts, total_count, 0.95), 3),
            "p99": round(self._quantile_from(counts, total_count, 0.99), 3),
        }

    def _quantile_from(self, counts: List[int], total: int, q: float) -> float:
        """Linear interpolation inside the crossing bucket — the estimate
        ``histogram_quantile`` makes. The +Inf bucket clamps to the
        largest finite bound (no upper edge to interpolate toward)."""
        if total <= 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * ((rank - prev_cum) / c)
        return self.buckets[-1]

# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = _lockcheck.make_lock("metrics.registry")
        self._instruments: Dict[str, _Instrument] = {}

    def register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            existing = self._instruments.get(inst.name)
            if existing is not None:
                raise MetricError(
                    f"instrument {inst.name!r} registered twice"
                )
            self._instruments[inst.name] = inst
        return inst


_default_registry = MetricsRegistry()


# --------------------------------------------------------------------------- #
# registration helpers: literal snake_case names, labels from
# ALLOWED_LABELS
# --------------------------------------------------------------------------- #


def counter(
    name: str,
    help: str,
    labels: Sequence[str] = (),
    legacy: LegacySpec = None,
) -> Counter:
    inst = Counter(name, help, labels, legacy=legacy)
    _default_registry.register(inst)
    return inst


def gauge(name: str, help: str, labels: Sequence[str] = ()) -> Gauge:
    inst = Gauge(name, help, labels)
    _default_registry.register(inst)
    return inst


def histogram(name: str, help: str, labels: Sequence[str] = ()) -> Histogram:
    inst = Histogram(name, help, labels)
    _default_registry.register(inst)
    return inst
