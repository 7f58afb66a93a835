"""Agent-facing task assignment: the next_task route's core.

A copy of ``evergreen_tpu/dispatch/assign.py``. Reference:
assignNextAvailableTask (rest/route/host_agent.go:219-420) — loop the
dispatcher's FindNextTask until a still-runnable task is found, then
atomically couple it to the host (compare-and-set on the host document)
and mark it dispatched. The CAS pair is the system's dispatch-race
guard; the ``dispatch.assign`` fault seam fires between its two writes.
Each pull is a ring-only ``dispatch_assign`` span parented into the
store's last tick trace (``store._last_tick_trace``), and an empty pull
decays the long-poll hub's work ledger.
"""
from __future__ import annotations

import time as _time
from typing import Optional

from ..models import event as event_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..models.host import Host
from ..models.lifecycle import mark_task_dispatched
from ..models.task import Task
from ..storage.store import Store
from ..utils import lockcheck as _lockcheck
from .dag_dispatcher import DispatcherService, TaskSpec


#: per-store TTL cache of the large-parser task limit: the config-section
#: read (two collection gets + dataclass build + override pass) ran once
#: per assignment — serial work on every pull for a knob that
#: changes at admin cadence
_limit_cache: dict = {}
_limit_cache_lock = _lockcheck.make_lock("dispatch.assign.limits")
_LIMIT_TTL_S = 5.0


def _large_parser_limit(store: Store) -> int:
    key = id(store)
    now = _time.monotonic()
    with _limit_cache_lock:
        entry = _limit_cache.get(key)
        if entry is not None and entry[0] is store and now - entry[1] < _LIMIT_TTL_S:
            return entry[2]
    from ..settings import TaskLimitsConfig

    limit = TaskLimitsConfig.get(
        store
    ).max_concurrent_large_parser_project_tasks
    with _limit_cache_lock:
        _limit_cache[key] = (store, now, limit)
        if len(_limit_cache) > 64:  # short-lived test stores must not pin
            stale = [
                k for k, v in _limit_cache.items()
                if now - v[1] >= _LIMIT_TTL_S
            ]
            for k in stale:
                del _limit_cache[k]
    return limit


class _LargeParserGuard:
    """Per-assignment-call cache of the large-parser concurrency check."""

    def __init__(self, store: Store) -> None:
        self.store = store
        self._limit: Optional[int] = None
        self._in_flight: Optional[int] = None
        self._large_versions: dict = {}

    def _version_is_large(self, version_id: str) -> bool:
        cached = self._large_versions.get(version_id)
        if cached is None:
            doc = self.store.collection("parser_projects").get(version_id)
            cached = bool(doc and doc.get("large"))
            self._large_versions[version_id] = cached
        return cached

    def blocks(self, t: Task) -> bool:
        if self._limit is None:
            self._limit = _large_parser_limit(self.store)
        if self._limit <= 0 or not self._version_is_large(t.version):
            return False
        if self._in_flight is None:
            from ..globals import TASK_IN_PROGRESS_STATUSES

            self._in_flight = task_mod.coll(self.store).count(
                lambda d: d["status"] in TASK_IN_PROGRESS_STATUSES
                and self._version_is_large(d["version"])
            )
        return self._in_flight >= self._limit


def spec_for_host(host: Host) -> TaskSpec:
    """Task-group stickiness comes from the host's last-run context
    (reference host_agent.go builds TaskSpec from the host's LastGroup)."""
    return TaskSpec(
        group=host.last_group,
        build_variant=host.last_build_variant,
        project=host.last_project,
        version=host.last_version,
    )


def assign_next_available_task(
    store: Store,
    svc: DispatcherService,
    host: Host,
    now: Optional[float] = None,
) -> Optional[Task]:
    """Returns the task now assigned to this host, or None if the queue has
    nothing dispatchable."""
    from ..utils import tracing as _tracing

    now = _time.time() if now is None else now
    if not _tracing.tracing_enabled():
        t = _assign_next_available_task(store, svc, host, now)
    else:
        # dispatch is the last leg of the tick's span tree: parent into
        # the most recent tick's trace (captured by run_tick) so one
        # trace reads delta-drain → … → wal-commit → dispatch.
        # Ring-only: assigns run once per agent pull and must never
        # cost a store write.
        with _tracing.attached(getattr(store, "_last_tick_trace", None)), \
                _tracing.Tracer(store, "dispatch").span(
                    "dispatch_assign", store_write=False,
                    distro=host.distro_id,
                ) as _span:
            t = _assign_next_available_task(store, svc, host, now)
            if t is not None:
                _span["attributes"]["task"] = t.id
    # decay the long-poll hub's work ledger on proven absence
    # (dispatch/longpoll.py): an EMPTY pull is evidence outstanding
    # wake credit was overstated. Successful handouts deliberately do
    # NOT debit here — a woken waiter already claimed its credit on
    # exit, and debiting both sides systematically halved the promptly
    # woken cohort (tasks then sat out the long-poll timeout when no
    # instant completer swept them). Credit the fleet can't claim
    # (taken by busy non-parked agents) decays one empty pull at a
    # time, which is the cheap direction.
    if t is None:
        hub = getattr(store, "_longpoll_hub", None)
        if hub is not None:
            hub.note_empty(host.distro_id)
    return t


def assign_next_available_task_fleet(
    plane, host_id: str, now: Optional[float] = None
) -> Optional[Task]:
    """Global agent pull over the sharded control plane's shard-local
    queues (scheduler/sharded_plane.py): agents address ONE fleet — the
    pull locates the host's owning shard (its distro's consistent-hash
    owner, handoff overrides included) and runs the classic CAS-pair
    assignment against that shard's store and dispatcher. The agent
    never knows shards exist."""
    host = plane.find_host(host_id)
    if host is None:
        return None
    return plane.assign_next_task(host, now=now)


def _assign_next_available_task(
    store: Store,
    svc: DispatcherService,
    host: Host,
    now: float,
) -> Optional[Task]:
    if host.running_task:
        # Reference returns the already-assigned task so a crashed agent can
        # resume (host_agent.go:209-216).
        return task_mod.get(store, host.running_task)
    if not host.can_run_tasks():
        return None

    spec = spec_for_host(host)
    dispatcher = svc.get(host.distro_id)
    dispatcher.refresh(now)
    secondary: Optional[object] = None  # lazily-built alias-queue fallback

    large_guard = _LargeParserGuard(store)
    while True:
        item = dispatcher.find_next_task(spec, now)
        if item is None:
            # primary queue exhausted → serve the distro's secondary (alias)
            # queue (reference: separate alias dispatcher,
            # model/task_queue_service.go:61)
            if secondary is None:
                secondary = svc.get(host.distro_id, secondary=True)
                secondary.refresh(now)
            item = secondary.find_next_task(spec, now)
            if item is None:
                return None
        t = task_mod.get(store, item.id)
        if t is None:
            continue
        if large_guard.blocks(t):
            # concurrency cap on large-parser-project tasks (reference
            # checkMaxConcurrentLargeParserProjectTasks,
            # model/task_queue_service_dependency.go:572-594)
            continue
        # Re-validate against the live document: planning ran up to a tick
        # ago (host_agent.go ProjectCanDispatchTask gate).
        if not t.is_dispatchable():
            continue
        if not host_mod.assign_running_task(store, host.id, t, now):
            # Another request raced this host to a task; bail and let the
            # agent re-poll (reference returns nil on CAS failure).
            return None
        # crash seam INSIDE the CAS pair: a death here leaves a host
        # claiming a task that was never marked dispatched — exactly the
        # half-assignment the startup reconciliation pass must heal
        # (scheduler/recovery.py)
        from ..utils import faults

        faults.fire("dispatch.assign")
        if not mark_task_dispatched(store, t.id, host.id, now):
            # Task was concurrently taken (e.g. by another distro's queue
            # via secondary distros): release the host and keep looking.
            host_mod.clear_running_task(store, host.id, t.id, now)
            continue
        event_mod.log(
            store,
            event_mod.RESOURCE_TASK,
            "TASK_DISPATCHED",
            t.id,
            {"host_id": host.id},
            timestamp=now,
        )
        return task_mod.get(store, t.id)
