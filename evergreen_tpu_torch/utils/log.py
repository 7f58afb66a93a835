"""Structured logging: leveled field-based records through pluggable sinks,
and the flat process-wide counters that ride beside them.

A copy of the part of ``evergreen_tpu/utils/log.py`` the port calls:
``Logger(component)`` emits ``{ts, level, component, message,
**fields}`` records to every sink registered with ``add_sink`` (none by
default); the counters are the flat names the metrics registry's
``legacy`` mirrors bump. ``env.py::Environment.build`` wires the two
sinks below when it owns the process's writable store
(``reset_sinks(json_line_sink, StoreSink(store))``) and applies the
``logger_config`` section's level (``configure``). The buffered sink
(``BufferedSink``) and the counter snapshots are not ported: nothing in
the port wires or reads them.
"""
from __future__ import annotations

import json
import sys
import time as _time
from typing import Any, Callable, Dict, List

from . import lockcheck as _lockcheck

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

Sink = Callable[[dict], None]

_lock = _lockcheck.make_lock("log.stream")
_sinks: List[Sink] = []
_threshold = LEVELS["info"]

# -- counters ---------------------------------------------------------------- #
# Process-local monotonic counters riding beside the log stream. Resilience
# breadcrumbs (breaker transitions, degraded ticks, injected faults) bump
# these so a run is auditable without parsing every line.

_counter_lock = _lockcheck.make_lock("log.counters")
_counters: Dict[str, int] = {}


def incr_counter(name: str, by: int = 1) -> int:
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + by
        return _counters[name]


def get_counter(name: str) -> int:
    with _counter_lock:
        return _counters.get(name, 0)


def set_level(level: str) -> None:
    global _threshold
    _threshold = LEVELS.get(level, LEVELS["info"])


def add_sink(sink: Sink) -> None:
    with _lock:
        _sinks.append(sink)


def remove_sink(sink: Sink) -> None:
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)


def reset_sinks(*sinks: Sink) -> None:
    """Replace all sinks (tests; service wiring)."""
    with _lock:
        _sinks.clear()
        _sinks.extend(sinks)


def json_line_sink(record: dict) -> None:
    sys.stderr.write(
        json.dumps(record, separators=(",", ":"), default=str) + "\n"
    )


class StoreSink:
    """Capped ring of recent log records in the store's ``log_lines``
    collection (the analog of the reference's stats-log collections)."""

    COLLECTION = "log_lines"

    def __init__(self, store, cap: int = 2000) -> None:
        self.store = store
        self.cap = cap
        # resume after the highest surviving id — with a durable store a
        # fresh process must not overwrite or reorder prior records
        existing = store.collection(self.COLLECTION).key_order()
        self._seq = max(
            (int(k.rsplit("-", 1)[1]) for k in existing), default=0
        )
        self._lock = _lockcheck.make_lock("log.event_writer")

    def __call__(self, record: dict) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        coll = self.store.collection(self.COLLECTION)
        coll.upsert({"_id": f"log-{seq:012d}", **record})
        if seq % 256 == 0:  # amortized trim
            ids = sorted(coll.key_order())
            for doc_id in ids[: max(0, len(ids) - self.cap)]:
                coll.remove(doc_id)


def configure(store) -> None:
    """Apply the runtime-editable logger_config section."""
    from ..settings import LoggerConfig

    cfg = LoggerConfig.get(store)
    set_level(cfg.default_level)


class Logger:
    def __init__(self, component: str) -> None:
        self.component = component

    def _emit(self, level: str, message: str, fields: Dict[str, Any]) -> None:
        if LEVELS[level] < _threshold:
            return
        record = {
            "ts": _time.time(),
            "level": level,
            "component": self.component,
            "message": message,
            **fields,
        }
        with _lock:
            sinks = list(_sinks)
        for sink in sinks:
            try:
                sink(record)
            except Exception:
                # a broken sink must never take down the caller — but a
                # sink that drops every record must not stay invisible
                # either: count the loss
                incr_counter("log.sink_errors")

    def debug(self, message: str, **fields: Any) -> None:
        self._emit("debug", message, fields)

    def info(self, message: str, **fields: Any) -> None:
        self._emit("info", message, fields)

    def warning(self, message: str, **fields: Any) -> None:
        self._emit("warning", message, fields)

    def error(self, message: str, **fields: Any) -> None:
        self._emit("error", message, fields)


def get_logger(component: str) -> Logger:
    return Logger(component)
