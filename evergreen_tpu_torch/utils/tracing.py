"""Whole-tick tracing: spans with attributes, explicit context
propagation across threads, a brownout-proof in-memory ring, the
persisted span collection, and the device profiler hook.

A copy of ``evergreen_tpu/utils/tracing.py`` under its names, but for
the span ids of a store held under a writer lease: ``span-e<epoch>-<n>``
there, JAX's ``span-<n>`` elsewhere. JAX's ``<n>`` restarts at 0 in a
restarted process, whose span documents then overwrite the earlier
life's; a restarted writer holds a newer epoch, so the port's ids stay
apart, and the same inputs still give the same ids:

- spans nest via a context manager and carry attributes; the active
  context is a **capturable/attachable token** (``capture_context`` /
  ``attach_context`` / ``detach_context``), so work handed to another
  thread — the solve thread, the WAL flusher, the sharded plane's shard
  threads — parents correctly instead of starting a fresh root;
- every finished span lands in a bounded **ring buffer** beside the
  store sink; RED/BLACK brownout sheds the store write (it is a stats
  write) but the ring keeps the last N traces, so the trace of the tick
  that browned out is exactly the one you can still read
  (``trace_tree``);
- the store's ``spans`` collection is the durable sink; on a durable
  store its writes are journaled with the tick's group.

``set_tracing_enabled(False)`` turns the whole plane into cheap no-ops.

The profiler hook (``maybe_device_profile``) is JAX's
``maybe_xla_profile`` on torch.profiler: when the tracer config names an
``xla_profile_dir`` (the field keeps JAX's name, so one config document
serves both packages) the body runs under ``torch.profiler.profile``
with CPU and, on a CUDA machine, CUDA activities, and writes one Chrome
trace there; once per configured directory per process.

The exporter (``export_spans``, the cron plane's ``span-export`` job)
pushes the ``spans`` collection to an OTLP/HTTP collector when the
tracer config enables it, shaped by ``_otlp_payload`` with ids from
``_stable_id``, and then drops what it pushed; ``recent_traces`` and
``get_spans`` read the ring and the collection. The OTLP scope names
keep the JAX package's ``evergreen_tpu.<component>`` and the resource
its ``evergreen-tpu`` service name, so one collector sees both packages
as one service.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time as _time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

from ..storage.store import Store
from . import lockcheck as _lockcheck
from . import metrics as _metrics

SPANS_COLLECTION = "spans"

_seq = itertools.count()
_seq_lock = _lockcheck.make_lock("trace.seq")
_local = threading.local()

#: process-wide on/off switch; off → span() yields an inert record and
#: touches no sink
_enabled = True

TRACE_STORE_SHED = _metrics.counter(
    "trace_store_writes_shed_total",
    "Span store-writes skipped under RED/BLACK brownout "
    "(the ring buffer still kept the span).",
)
TRACE_RING_DROPPED = _metrics.counter(
    "trace_ring_spans_dropped_total",
    "Spans dropped because their trace hit the per-trace ring cap.",
)


def set_tracing_enabled(on: bool) -> bool:
    """Flip the whole tracing plane; returns the previous value."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


def tracing_enabled() -> bool:
    return _enabled


# --------------------------------------------------------------------------- #
# context propagation
# --------------------------------------------------------------------------- #


class TraceContext(NamedTuple):
    """A capturable parent pointer: hand it to another thread and
    ``attach_context`` there so spans parent into the same trace."""

    trace_id: str
    span_id: str


def capture_context() -> Optional[TraceContext]:
    """The calling thread's active span context (None outside any
    span). Safe to ship across threads."""
    return getattr(_local, "ctx", None)


def attach_context(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Make ``ctx`` the thread's active context; returns a token (the
    previous context) for ``detach_context``. Always pair with a
    try/finally — a leaked attach makes every later span in the thread a
    child of a finished trace."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    return prev


def detach_context(token: Optional[TraceContext]) -> None:
    _local.ctx = token


@contextlib.contextmanager
def attached(ctx: Optional[TraceContext]) -> Iterator[None]:
    """``attach_context`` with the try/finally built in."""
    token = attach_context(ctx)
    try:
        yield
    finally:
        detach_context(token)


def reset_context() -> None:
    """Clear any leaked context on the calling thread (test isolation)."""
    _local.ctx = None


# --------------------------------------------------------------------------- #
# ring buffer sink
# --------------------------------------------------------------------------- #


class TraceRing:
    """Last-N-traces in memory. Brownout sheds stats writes to the
    store; the ring is the sink that never sheds, so the most recent
    ticks' traces survive exactly the storms you want to inspect."""

    def __init__(self, max_traces: int = 64,
                 max_spans_per_trace: int = 512) -> None:
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = _lockcheck.make_lock("trace.sink")
        #: trace id -> [span records], insertion-ordered by first span
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()

    def add(self, record: dict) -> None:
        tid = record.get("trace_root") or record.get("_id", "")
        if not tid:
            return
        # copy: callers keep mutating their record dict after the span
        # closes (attribute updates), the ring must hold the final shape
        span = dict(record)
        span["attributes"] = dict(record.get("attributes") or {})
        with self._lock:
            spans = self._traces.get(tid)
            if spans is None:
                self._traces[tid] = spans = []
                while len(self._traces) > self.max_traces:
                    evicted_tid = next(iter(self._traces))
                    if evicted_tid == tid:
                        break
                    self._traces.pop(evicted_tid)
            if len(spans) >= self.max_spans_per_trace:
                TRACE_RING_DROPPED.inc()
                return
            spans.append(span)

    def trace(self, trace_id: str) -> List[dict]:
        with self._lock:
            return [dict(s) for s in self._traces.get(trace_id, ())]

    def traces(self) -> List[Tuple[str, List[dict]]]:
        """(trace_id, spans) pairs, oldest first."""
        with self._lock:
            return [
                (tid, [dict(s) for s in spans])
                for tid, spans in self._traces.items()
            ]

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_global_ring = TraceRing()
_ring_lock = _lockcheck.make_lock("trace.ring")


def trace_ring_for(store: Optional[Store]) -> TraceRing:
    """Per-store ring (lifetime tied to the store, like the overload
    monitor); storeless spans share one process-global ring."""
    if store is None:
        return _global_ring
    ring = getattr(store, "_trace_ring", None)
    if ring is None:
        with _ring_lock:
            ring = getattr(store, "_trace_ring", None)
            if ring is None:
                ring = TraceRing()
                store._trace_ring = ring
    return ring


def global_ring() -> TraceRing:
    return _global_ring


# --------------------------------------------------------------------------- #
# tracer
# --------------------------------------------------------------------------- #


class Tracer:
    def __init__(self, store: Optional[Store], component: str) -> None:
        self.store = store
        self.component = component

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        ctx: Optional[TraceContext] = None,
        store_write: bool = True,
        **attributes: Any,
    ) -> Iterator[Dict[str, Any]]:
        """One span. Parents under the thread's active context (or an
        explicit ``ctx`` token captured elsewhere); the context is
        attached for the body and detached in a ``finally`` even when
        the body raises, so a raising nested span never leaves a
        finished context attached to re-root every later span in the
        thread. ``store_write=False`` keeps a hot-path span out of the
        store (ring only) regardless of load level."""
        if not _enabled:
            yield {"_id": "", "trace_root": "", "attributes": {}}
            return
        with _seq_lock:
            n = next(_seq)
        # a durable store's lease epoch: a restarted writer's ids start
        # at 0 again, under a newer epoch
        epoch = getattr(self.store, "epoch", 0)
        span_id = f"span-e{epoch}-{n}" if epoch else f"span-{n}"
        parent = ctx if ctx is not None else capture_context()
        trace_id = parent.trace_id if parent is not None else span_id
        record: Dict[str, Any] = {
            "_id": span_id,
            "component": self.component,
            "name": name,
            "parent": parent.span_id if parent is not None else None,
            "trace_root": trace_id,
            "thread": threading.current_thread().name,
            "started_at": _time.time(),
            "attributes": dict(attributes),
        }
        if not store_write:
            record["_ring_only"] = True
        token = attach_context(TraceContext(trace_id, span_id))
        start = _time.perf_counter()
        try:
            yield record
        finally:
            detach_context(token)
            record["duration_ms"] = (_time.perf_counter() - start) * 1e3
            self._sink(record)

    def _sink(self, record: Dict[str, Any]) -> None:
        """Ring always; store unless shedding (brownout) — and a broken
        sink must never take down the traced caller (a fenced store,
        for one, refuses journaled writes by raising)."""
        ring_only = record.pop("_ring_only", False)
        try:
            trace_ring_for(self.store).add(record)
        except Exception:  # noqa: BLE001 — tracing never breaks the caller
            pass
        if self.store is None or ring_only:
            return
        try:
            from . import overload as _overload

            if _overload.monitor_for(self.store).level() >= _overload.RED:
                TRACE_STORE_SHED.inc()
                return
            self.store.collection(SPANS_COLLECTION).upsert(record)
        except Exception:  # noqa: BLE001 — tracing never breaks the caller
            pass


# --------------------------------------------------------------------------- #
# trace reconstruction
# --------------------------------------------------------------------------- #


def _collect_trace_spans(store: Optional[Store], trace_id: str) -> List[dict]:
    spans = {
        s["_id"]: s for s in trace_ring_for(store).trace(trace_id)
    }
    if store is not None:
        try:
            for s in store.collection(SPANS_COLLECTION).find(
                lambda d: d.get("trace_root") == trace_id
            ):
                spans.setdefault(s["_id"], dict(s))
        except Exception:  # noqa: BLE001 — a broken store still serves ring
            pass
    return sorted(spans.values(), key=lambda s: (
        s.get("started_at", 0.0), s.get("_id", "")
    ))


def trace_tree(store: Optional[Store], trace_id: str) -> Optional[dict]:
    """The span tree of one trace, from the ring buffer merged with the
    store sink. Returns ``{trace_id, n_spans, roots: [span…]}`` where
    each span carries ``children`` sorted by start time, or None when
    the trace is unknown to both sinks."""
    spans = _collect_trace_spans(store, trace_id)
    if not spans:
        return None
    nodes = {
        s["_id"]: {**s, "children": []} for s in spans
    }
    roots = []
    for s in spans:
        node = nodes[s["_id"]]
        parent = s.get("parent")
        if parent and parent in nodes:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)
    return {"trace_id": trace_id, "n_spans": len(spans), "roots": roots}


def recent_traces(store: Optional[Store], last: int = 10) -> List[dict]:
    """Newest-last summaries of the ring's traces (falling back to store
    root spans for traces that aged out of the ring)."""
    seen = {}
    for tid, spans in trace_ring_for(store).traces():
        root = next((s for s in spans if not s.get("parent")), spans[0])
        seen[tid] = {
            "trace_id": tid,
            "root": root.get("name", ""),
            "component": root.get("component", ""),
            "started_at": min(s.get("started_at", 0.0) for s in spans),
            "duration_ms": round(root.get("duration_ms", 0.0), 3),
            "n_spans": len(spans),
        }
    if store is not None and len(seen) < last:
        try:
            for s in store.collection(SPANS_COLLECTION).find(
                lambda d: not d.get("parent")
            ):
                tid = s.get("trace_root") or s["_id"]
                seen.setdefault(tid, {
                    "trace_id": tid,
                    "root": s.get("name", ""),
                    "component": s.get("component", ""),
                    "started_at": s.get("started_at", 0.0),
                    "duration_ms": round(s.get("duration_ms", 0.0), 3),
                    "n_spans": 0,
                })
        except Exception:  # noqa: BLE001
            pass
    out = sorted(seen.values(), key=lambda d: d["started_at"])
    return out[-max(1, int(last)):]


def get_spans(store: Store, component: str = "") -> List[dict]:
    spans = store.collection(SPANS_COLLECTION).find(
        (lambda d: d["component"] == component) if component else None
    )
    spans.sort(key=lambda d: d["started_at"])
    return spans


# --------------------------------------------------------------------------- #
# OTLP export (reference config_tracer.go + environment.go:1070 tracer init)
# --------------------------------------------------------------------------- #


def _stable_id(s: str, hex_chars: int) -> str:
    """Process- and restart-stable id digits (sha256, NOT Python's salted
    hash(): parent/child links must survive service restarts)."""
    import hashlib

    return hashlib.sha256(s.encode()).hexdigest()[:hex_chars]


def _otlp_payload(spans: List[dict]) -> dict:
    """Shape store spans as an OTLP/HTTP JSON ExportTraceServiceRequest
    (one resource, one scope per component)."""
    by_component: Dict[str, List[dict]] = {}
    for s in spans:
        by_component.setdefault(s.get("component", ""), []).append(s)
    scope_spans = []
    for component, group in by_component.items():
        otlp_spans = []
        for s in group:
            start_ns = int(s.get("started_at", 0.0) * 1e9)
            end_ns = start_ns + int(s.get("duration_ms", 0.0) * 1e6)
            otlp_spans.append(
                {
                    # the recorded root spans the whole nesting chain, so
                    # grandchildren share the root's trace id
                    "traceId": _stable_id(
                        s.get("trace_root") or s["_id"], 32
                    ),
                    "spanId": _stable_id(s["_id"], 16),
                    "parentSpanId": (
                        _stable_id(s["parent"], 16) if s.get("parent") else ""
                    ),
                    "name": s.get("name", ""),
                    "startTimeUnixNano": str(start_ns),
                    "endTimeUnixNano": str(end_ns),
                    "attributes": [
                        {"key": k, "value": {"stringValue": str(v)}}
                        for k, v in (s.get("attributes") or {}).items()
                    ],
                }
            )
        scope_spans.append(
            {"scope": {"name": f"evergreen_tpu.{component}"},
             "spans": otlp_spans}
        )
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {"key": "service.name",
                         "value": {"stringValue": "evergreen-tpu"}}
                    ]
                },
                "scopeSpans": scope_spans,
            }
        ]
    }


def export_spans(store: Store, endpoint: str = "", batch: int = 512) -> int:
    """Push un-exported spans to an OTLP/HTTP collector (`/v1/traces`),
    then DELETE them locally — once exported, the collector is the span
    store, and keeping them would grow the collection and its per-minute
    scan without bound. No-op unless the tracer config section is enabled
    (reference: tracing is configured from the tracer section,
    config_tracer.go:11-23, and initialized env-wide, environment.go:1070).
    Sampling drops (1 - sample_ratio) of whole traces at export time,
    deterministically by trace root."""
    import json as _json
    import urllib.request

    from ..settings import TracerConfig

    cfg = TracerConfig.get(store)
    endpoint = endpoint or cfg.collector_endpoint
    if not cfg.enabled or not endpoint:
        return 0
    coll = store.collection(SPANS_COLLECTION)
    pending = coll.find()[:batch]
    if cfg.sample_ratio < 1.0:
        keep = []
        for s in pending:
            # stable across restarts (sha256, not salted hash) and keyed
            # on the ROOT so a trace is kept or dropped whole
            bucket = int(_stable_id(s.get("trace_root") or s["_id"], 8), 16)
            if (bucket % 10_000) / 10_000.0 < cfg.sample_ratio:
                keep.append(s)
            else:
                coll.remove(s["_id"])
        pending = keep
    if not pending:
        return 0
    body = _json.dumps(_otlp_payload(pending)).encode()
    req = urllib.request.Request(
        endpoint.rstrip("/") + "/v1/traces",
        data=body,
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10.0):  # a failed POST leaves the spans for the next sweep
        pass
    # the collector owns exported spans now: drop them so the spans
    # collection (and the per-minute not-yet-exported scan) stays bounded
    # on a long-lived service
    for s in pending:
        coll.remove(s["_id"])
    return len(pending)


# --------------------------------------------------------------------------- #
# device profiler hook
# --------------------------------------------------------------------------- #


#: dirs already captured by this process — the hook is one-shot per
#: configured directory so a forgotten config entry cannot tax every tick
#: and fill the disk with traces
_profiled_dirs: set = set()
_profiled_lock = _lockcheck.make_lock("trace.profile")


def profile_trace_path(profile_dir: str) -> str:
    """Where this process's capture into ``profile_dir`` lands."""
    return os.path.join(profile_dir, f"solve.{os.getpid()}.pt.trace.json")


@contextlib.contextmanager
def maybe_device_profile(store: Optional[Store]) -> Iterator[bool]:
    """Run the body under ``torch.profiler.profile`` when the tracer
    config names an ``xla_profile_dir``; yields whether profiling is
    active. The JAX package's ``maybe_xla_profile`` (``jax.profiler``),
    on torch: CPU activity, and CUDA activity when the process sees a
    card (CUPTI records kernels process-wide, so a body on a side thread
    is covered). The Chrome trace (``profile_trace_path``) covers exactly
    ONE solve per configured directory per process: after the capture
    the hook latches off until the operator points it somewhere new. The
    profiler is thread-bound, so the body must run on the calling
    thread, and it closes when the body returns or raises."""
    profile_dir = ""
    if store is not None:
        from ..settings import TracerConfig

        profile_dir = TracerConfig.get(store).xla_profile_dir
    if not profile_dir:
        yield False
        return
    with _profiled_lock:
        if profile_dir in _profiled_dirs:
            first = False
        else:
            _profiled_dirs.add(profile_dir)
            first = True
    if not first:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield True
    prof.export_chrome_trace(profile_trace_path(profile_dir))
