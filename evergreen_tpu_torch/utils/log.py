"""Structured logging: leveled field-based records through pluggable sinks,
and the flat process-wide counters that ride beside them.

The part of ``evergreen_tpu/utils/log.py`` the capacity plane, the
breakers and the fault seams call: ``Logger(component)`` emits
``{ts, level, component, message, **fields}`` records to every sink
registered with ``add_sink`` (none by default); the counters are the
flat names the metrics registry's ``legacy`` mirrors bump. The buffered
and store-backed sinks and the ``logger_config`` section are not ported.
"""
from __future__ import annotations

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


def add_sink(sink: Sink) -> None:
    with _lock:
        _sinks.append(sink)


def remove_sink(sink: Sink) -> None:
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)


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
