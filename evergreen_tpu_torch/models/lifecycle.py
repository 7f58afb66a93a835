"""Task lifecycle state transitions: ``mark_end`` and the chain it calls.

A copy of the part of ``evergreen_tpu/models/lifecycle.py`` that the
recovery pass reaches (``units/host_jobs.py::
reset_task_or_mark_system_failed``). Finishing a task propagates to its
dependents (finished flags, transitive unattainable marking, the
dependency wake of ``dispatch/wake.py``), frees the host, logs the event,
blocks or resets a single-host task group, evaluates stepback, rolls the
build and version statuses up and attributes the task's cloud cost
(reference model/task_lifecycle.go:713-1150). With it, the dispatcher's
and the harness agent's transitions ``mark_task_dispatched`` and
``mark_task_started``, and the agent surface's transitions (the REST
agent routes and ``agent/comm.py``): ``finish_agent_task`` (``mark_end``
plus the poisoned-host accounting of ``note_host_task_outcome``) and
``activate_task_with_dependencies``.
"""
from __future__ import annotations

import time as _time
import weakref
from typing import Dict, List, Optional, Tuple

from ..globals import (
    CONSECUTIVE_SYSTEM_FAILURE_THRESHOLD,
    STEPBACK_TASK_ACTIVATOR,
    TASK_COMPLETED_STATUSES,
    BuildStatus,
    HostStatus,
    Provider,
    Requester,
    TaskStatus,
    VersionStatus,
)
from ..storage.store import Store
from ..utils import lockcheck as _lockcheck
from . import build as build_mod
from . import event as event_mod
from . import host as host_mod
from . import task as task_mod
from . import version as version_mod
from .task import DEP_STATUS_ANY, Task


def mark_task_dispatched(
    store: Store, task_id: str, host_id: str, now: Optional[float] = None
) -> bool:
    """Atomic undispatched→dispatched transition (reference
    task.MarkAsHostDispatched via rest/route/host_agent.go:311-420)."""
    now = _time.time() if now is None else now
    return task_mod.coll(store).compare_and_set(
        task_id,
        expect={"status": TaskStatus.UNDISPATCHED.value},
        update={
            "status": TaskStatus.DISPATCHED.value,
            "dispatch_time": now,
            "host_id": host_id,
            "last_heartbeat": now,
        },
    )


def mark_task_started(
    store: Store, task_id: str, now: Optional[float] = None
) -> bool:
    now = _time.time() if now is None else now
    ok = task_mod.coll(store).compare_and_set(
        task_id,
        expect={"status": TaskStatus.DISPATCHED.value},
        update={
            "status": TaskStatus.STARTED.value,
            "start_time": now,
            "last_heartbeat": now,
        },
    )
    if ok:
        event_mod.log(
            store, event_mod.RESOURCE_TASK, "TASK_STARTED", task_id, timestamp=now
        )
    return ok


def _dep_satisfied(dep_status: str, final_status: str) -> bool:
    if dep_status == DEP_STATUS_ANY:
        return True
    return dep_status == final_status


class _TaskIndex:
    """key → ids of the tasks whose documents gave that key (``keys(doc)``)
    when the index last saw them: a superset of the live keys (a key a
    document later drops stays), so a lookup filters its candidates by
    the live documents. Built by one scan of the tasks collection and
    kept by a listener that only records the written ids; they are read
    at the next lookup. One lookup runs at a time: a second caller waits
    until the first has noted every id it took, so no caller looks up
    before a write it could see is noted."""

    def __init__(self, coll, keys) -> None:
        self._keys = keys
        self._ids: Dict[object, set] = {}
        self._pending: set = set()
        #: the written ids' lock: the listener runs under the collection's
        #: lock and takes only this one
        self._pending_lock = _lockcheck.make_lock("lifecycle.index.pending")
        #: one lookup at a time (taken before the collection's lock)
        self._lock = _lockcheck.make_lock("lifecycle.index")
        coll.add_listener(self._written)
        self._note(coll.find())

    def _written(self, doc_id) -> None:
        with self._pending_lock:
            self._pending.add(doc_id)

    def _note(self, docs) -> None:
        for doc in docs:
            for key in self._keys(doc):
                self._ids.setdefault(key, set()).add(doc["_id"])

    def find(self, coll, key, pred) -> List[dict]:
        """``coll.find(pred)`` — the same documents in store order — for a
        ``pred`` that only documents giving ``key`` can pass."""
        with self._lock:
            with self._pending_lock:
                pending, self._pending = self._pending, set()
            if pending:
                self._note(coll.find_ids(pending))
            ids = self._ids.get(key)
            if not ids:
                return []
            order = coll.key_order()
            ranked = sorted((i for i in ids if i in order), key=order.__getitem__)
            return [doc for doc in coll.find_ids(ranked) if pred(doc)]


def _parents(doc: dict) -> List[str]:
    return [dep["task_id"] for dep in doc.get("depends_on") or ()]


def _group(doc: dict) -> list:
    group = doc.get("task_group")
    return [(doc.get("build_id", ""), group)] if group else []


def _variant_group(doc: dict) -> list:
    group = doc.get("task_group")
    return ([(doc.get("version", ""), doc.get("build_variant", ""), group)]
            if group else [])


#: the task indexes read in place of a scan of every task: a finished
#: task's dependents and a build's task group (``mark_end``'s chain), and
#: a version's task group on one variant (the agent's block resolution,
#: ``agent/comm.py::LocalCommunicator.get_task_config``)
_INDEX_KEYS = {"dependents": _parents, "group": _group,
               "variant_group": _variant_group}
#: per-store indexes, keyed weakly: they go with the store
_indexes: "weakref.WeakKeyDictionary[Store, Dict[str, _TaskIndex]]" = (
    weakref.WeakKeyDictionary())
_indexes_lock = _lockcheck.make_lock("lifecycle.indexes")


def _indexed_find(store: Store, index: str, key, pred) -> List[dict]:
    """``tasks.find(pred)`` through the store's ``index`` at ``key``."""
    coll = task_mod.coll(store)
    with _indexes_lock:
        per_store = _indexes.setdefault(store, {})
        idx = per_store.get(index)
        if idx is None:
            idx = per_store[index] = _TaskIndex(coll, _INDEX_KEYS[index])
    return idx.find(coll, key, pred)


def update_dependencies_on_finish(
    store: Store, finished: Task, now: float
) -> List[str]:
    """Propagate a finished task's outcome to its dependents: set the edge's
    finished flag; if unsatisfied, mark it unattainable and transitively
    block downstream tasks (reference UpdateBlockedDependencies +
    MarkDependenciesFinished, model/task_lifecycle.go:775-776).

    Dependents whose every edge is now finished-and-satisfied get a
    dependency WAKE: their queue items flip to dependencies-met in place
    and the distro's dispatcher is invalidated, so they dispatch on the
    next poll instead of after the next planning tick + dispatcher TTL
    (a latency improvement over the reference, which waits for both —
    task_queue_service_dependency.go:316-317).

    Returns the ids of tasks that became blocked.
    """
    coll = task_mod.coll(store)
    newly_ready: List[str] = []
    # Wave of (task id, final-or-blocked status, blocked?) to propagate.
    newly_blocked: List[str] = []
    wave = [(finished.id, finished.status, False)]
    seen: set = set()
    while wave:
        parent_id, parent_status, parent_blocked = wave.pop()
        if parent_id in seen:
            continue
        seen.add(parent_id)

        def affects(doc: dict) -> bool:
            return any(d["task_id"] == parent_id for d in doc.get("depends_on", []))

        for doc in _indexed_find(store, "dependents", parent_id, affects):
            # docs returned by find() alias live store state: mutate a COPY
            # of the edge list and land it via coll.update so concurrent
            # readers never see half-updated edges and the change always
            # fires the dirty-set listener (tick-cache invariant)
            deps = [dict(d) for d in doc["depends_on"]]
            changed = False
            became_blocked = False
            for dep in deps:
                if dep["task_id"] != parent_id:
                    continue
                if parent_blocked:
                    if not dep["unattainable"]:
                        dep["unattainable"] = True
                        changed = became_blocked = True
                else:
                    dep["finished"] = True
                    changed = True
                    if not _dep_satisfied(dep["status"], parent_status):
                        if not dep["unattainable"]:
                            dep["unattainable"] = True
                            became_blocked = True
            if changed:
                coll.update(doc["_id"], {"depends_on": deps})
                if (
                    not became_blocked
                    and doc["status"] == TaskStatus.UNDISPATCHED.value
                    and doc.get("activated")
                    and all(
                        d["finished"] and not d["unattainable"]
                        for d in deps
                    )
                ):
                    newly_ready.append(doc["_id"])
                    if doc.get("dependencies_met_time", 0.0) <= 0.0:
                        coll.update(doc["_id"], {"dependencies_met_time": now})
            if became_blocked and not doc.get("override_dependencies", False):
                newly_blocked.append(doc["_id"])
                wave.append((doc["_id"], "", True))
                event_mod.log(
                    store,
                    event_mod.RESOURCE_TASK,
                    "TASK_BLOCKED",
                    doc["_id"],
                    {"blocked_by": parent_id},
                    timestamp=now,
                )

    if newly_ready:
        from ..dispatch.wake import wake_dependents

        wake_dependents(store, newly_ready, now)
    return newly_blocked


def check_reset_single_host_task_group(
    store: Store, t: Task, now: float
) -> bool:
    """Once every task of a single-host task group is finished (or blocked
    or deactivated), restart the whole group if any member requested it via
    ``reset_when_finished`` (reference model/task_lifecycle.go:2770
    checkResetSingleHostTaskGroup, invoked from MarkEnd). Returns whether a
    reset happened."""
    if not t.is_single_host_task_group():
        return False
    members = [Task.from_doc(d) for d in _indexed_find(
        store, "group", (t.build_id, t.task_group),
        lambda d: d["build_id"] == t.build_id
        and d["task_group"] == t.task_group,
    )]
    if not members:
        return False
    should_reset = False
    for m in members:
        if m.reset_when_finished:
            should_reset = True
        if (
            m.status not in TASK_COMPLETED_STATUSES
            and m.activated
            and not m.blocked()
        ):
            return False  # a member still needs to run
    if not should_reset:
        return False
    from ..units.task_jobs import restart_task

    c = task_mod.coll(store)
    reset_ids: List[str] = []
    for m in members:
        c.update(m.id, {"reset_when_finished": False})
        if m.status in TASK_COMPLETED_STATUSES:
            if restart_task(store, m.id, by="single-host-group-reset",
                            now=now):
                reset_ids.append(m.id)
        else:
            # never ran this round (deactivated or blocked): reactivate so
            # the whole group reruns together (reference resetManyTasks
            # resets every member, model/task_lifecycle.go:2798)
            c.update(m.id, {"activated": True,
                            "activated_by": "single-host-group-reset",
                            "activated_time": now})
            reset_ids.append(m.id)
    event_mod.log(
        store,
        event_mod.RESOURCE_TASK,
        "TASK_GROUP_RESET",
        t.id,
        {"task_group": t.task_group, "build_id": t.build_id,
         "members": reset_ids},
        timestamp=now,
    )
    return True


def block_single_host_task_group(store: Store, t: Task, now: float) -> List[str]:
    """When a single-host task-group member fails, later members of the
    group must not run: they gain an unattainable dependency on the failed
    task (reference: EndTask-side group blocking,
    model/task_lifecycle.go blockTaskGroupTasks; the dispatcher comment at
    task_queue_service_dependency.go:690 'rely on EndTask to block later
    tasks')."""
    if not t.is_single_host_task_group():
        return []
    if t.status == TaskStatus.SUCCEEDED.value:
        return []
    group_key = t.task_group_string()
    blocked: List[str] = []
    c = task_mod.coll(store)
    for doc in c.find(
        lambda d: d["task_group"] == t.task_group
        and d["build_variant"] == t.build_variant
        and d["project"] == t.project
        and d["version"] == t.version
        and d["task_group_order"] > t.task_group_order
        and d["status"] == TaskStatus.UNDISPATCHED.value
    ):
        deps = doc.get("depends_on", [])
        if any(d["task_id"] == t.id for d in deps):
            for d in deps:
                if d["task_id"] == t.id:
                    d["unattainable"] = True
                    d["finished"] = True
        else:
            deps.append(
                {
                    "task_id": t.id,
                    "status": TaskStatus.SUCCEEDED.value,
                    "unattainable": True,
                    "finished": True,
                }
            )
        c.update(doc["_id"], {"depends_on": deps})
        blocked.append(doc["_id"])
        event_mod.log(
            store,
            event_mod.RESOURCE_TASK,
            "TASK_BLOCKED",
            doc["_id"],
            {"blocked_by": t.id, "reason": "single-host task group failure",
             "group": group_key},
            timestamp=now,
        )
    return blocked


def evaluate_stepback(store: Store, t: Task, now: float) -> Optional[str]:
    """Stepback: when a mainline task fails, activate the same task at an
    earlier commit to locate the offending revision — the previous commit
    (linear, reference doLinearStepback model/task_lifecycle.go:464) or the
    midpoint between the last pass and this failure (bisect, :496),
    selected per project ref. Returns the activated task id, if any."""
    if t.status != TaskStatus.FAILED.value:
        return None
    if t.requester != Requester.REPOTRACKER.value:
        return None
    if t.details_type == "system":
        return None  # system failures don't step back

    ref_doc = store.collection("project_refs").get(t.project) or {}
    if ref_doc.get("stepback_disabled"):
        return None
    bisect = bool(ref_doc.get("stepback_bisect"))

    candidates = task_mod.find(
        store,
        lambda doc: doc["project"] == t.project
        and doc["build_variant"] == t.build_variant
        and doc["display_name"] == t.display_name
        and doc["requester"] == Requester.REPOTRACKER.value
        and doc["revision_order_number"] < t.revision_order_number,
    )
    if not candidates:
        return None
    candidates.sort(key=lambda x: x.revision_order_number)

    target: Optional[Task] = None
    if bisect:
        # window: (last passing order, current failing order)
        passing = [
            c for c in candidates if c.status == TaskStatus.SUCCEEDED.value
        ]
        lo = passing[-1].revision_order_number if passing else 0
        window = [
            c
            for c in candidates
            if lo < c.revision_order_number < t.revision_order_number
            and c.status == TaskStatus.UNDISPATCHED.value
            and not c.activated
        ]
        if window:
            target = window[len(window) // 2]
    else:
        prev = candidates[-1]
        if prev.status == TaskStatus.UNDISPATCHED.value and not prev.activated:
            target = prev

    if target is None:
        return None
    task_mod.coll(store).update(
        target.id,
        {
            "activated": True,
            "activated_by": STEPBACK_TASK_ACTIVATOR,
            "activated_time": now,
        },
    )
    event_mod.log(
        store,
        event_mod.RESOURCE_TASK,
        "TASK_ACTIVATED_STEPBACK",
        target.id,
        {"failed_task": t.id, "mode": "bisect" if bisect else "linear"},
        timestamp=now,
    )
    return target.id


def update_build_and_version_status(store: Store, t: Task, now: float) -> None:
    """Roll task status up to its build and version (reference
    UpdateBuildAndVersionStatusForTask, model/task_lifecycle.go)."""
    if not t.build_id:
        return
    b = build_mod.get(store, t.build_id)
    if b is None:
        return
    member_tasks = task_mod.find(store, lambda d: d["build_id"] == t.build_id)
    activated = [x for x in member_tasks if x.activated or x.is_finished()]
    all_finished = activated and all(x.is_finished() for x in activated)
    any_failed = any(x.status == TaskStatus.FAILED.value for x in member_tasks)
    any_active = any(
        x.status in (TaskStatus.DISPATCHED.value, TaskStatus.STARTED.value)
        for x in member_tasks
    )
    if all_finished:
        new_status = (
            BuildStatus.FAILED.value if any_failed else BuildStatus.SUCCEEDED.value
        )
    elif any_active or any(x.is_finished() for x in member_tasks):
        new_status = BuildStatus.STARTED.value
    else:
        new_status = b.status
    if new_status != b.status:
        update: Dict = {"status": new_status}
        if new_status == BuildStatus.STARTED.value and b.start_time == 0.0:
            update["start_time"] = now
        if new_status in (BuildStatus.FAILED.value, BuildStatus.SUCCEEDED.value):
            update["finish_time"] = now
        build_mod.coll(store).update(b.id, update)
        event_mod.log(
            store,
            event_mod.RESOURCE_BUILD,
            f"BUILD_{new_status.upper().replace('-', '_')}",
            b.id,
            timestamp=now,
        )

    if not b.version:
        return
    v = version_mod.get(store, b.version)
    if v is None:
        return
    builds = build_mod.find_by_version(store, b.version)
    statuses = [
        new_status if x.id == b.id else x.status for x in builds
    ]
    if statuses and all(
        s in (BuildStatus.FAILED.value, BuildStatus.SUCCEEDED.value)
        for s in statuses
    ):
        v_status = (
            VersionStatus.FAILED.value
            if any(s == BuildStatus.FAILED.value for s in statuses)
            else VersionStatus.SUCCEEDED.value
        )
    elif any(
        s
        in (
            BuildStatus.STARTED.value,
            BuildStatus.FAILED.value,
            BuildStatus.SUCCEEDED.value,
        )
        for s in statuses
    ):
        v_status = VersionStatus.STARTED.value
    else:
        v_status = v.status
    if v_status != v.status:
        update = {"status": v_status}
        if v_status == VersionStatus.STARTED.value and v.start_time == 0.0:
            update["start_time"] = now
        if v_status in (VersionStatus.FAILED.value, VersionStatus.SUCCEEDED.value):
            update["finish_time"] = now
        version_mod.coll(store).update(v.id, update)
        event_mod.log(
            store,
            event_mod.RESOURCE_VERSION,
            f"VERSION_{v_status.upper()}",
            v.id,
            timestamp=now,
        )


def mark_end(
    store: Store,
    task_id: str,
    status: str,
    now: Optional[float] = None,
    details_type: str = "",
    details_desc: str = "",
    timed_out: bool = False,
) -> Optional[Task]:
    """Finish a task: final status + details, host release, dependency
    propagation, event, stepback, status rollup (reference model.MarkEnd,
    model/task_lifecycle.go:713-1150)."""
    now = _time.time() if now is None else now
    c = task_mod.coll(store)
    doc = c.get(task_id)
    if doc is None:
        return None
    if doc["status"] not in (
        TaskStatus.DISPATCHED.value,
        TaskStatus.STARTED.value,
    ):
        return None
    c.update(
        task_id,
        {
            "status": status,
            "finish_time": now,
            "details_type": details_type,
            "details_desc": details_desc,
            "details_timed_out": timed_out,
        },
    )
    t = task_mod.get(store, task_id)

    if t.host_id:
        host_mod.clear_running_task(store, t.host_id, task_id, now)

    event_mod.log(
        store,
        event_mod.RESOURCE_TASK,
        "TASK_FINISHED",
        task_id,
        {"status": status, "details_type": details_type},
        timestamp=now,
    )

    update_dependencies_on_finish(store, t, now)
    block_single_host_task_group(store, t, now)
    check_reset_single_host_task_group(store, t, now)
    if t.reset_when_finished and not t.is_single_host_task_group():
        # reference SetResetWhenFinished semantics for ordinary tasks: a
        # restart requested while the task ran happens now, automatically.
        # Single-host group members defer to the group reset above, which
        # fires only once every member has finished.
        from ..units.task_jobs import restart_task

        task_mod.coll(store).update(t.id, {"reset_when_finished": False})
        restart_task(store, t.id, by="reset-when-finished", now=now)
    evaluate_stepback(store, t, now)
    update_build_and_version_status(store, t, now)

    # cloud cost attribution (reference model/task_lifecycle.go:754-768)
    from .cost import attribute_task_cost

    attribute_task_cost(store, task_id, now)
    return t


def finish_agent_task(
    store: Store,
    task_id: str,
    status: str,
    details_type: str = "",
    details_desc: str = "",
    timed_out: bool = False,
    now: Optional[float] = None,
) -> Tuple[Optional[Task], bool]:
    """The one agent-facing finish path shared by every transport (HTTP
    route and in-process communicator): MarkEnd plus poisoned-host
    accounting. Returns (finished task or None if not running,
    should_exit)."""
    now = _time.time() if now is None else now
    t = mark_end(
        store,
        task_id,
        status,
        now=now,
        details_type=details_type,
        details_desc=details_desc,
        timed_out=timed_out,
    )
    if t is None:
        return None, False
    return t, note_host_task_outcome(store, t, details_type, now)


def note_host_task_outcome(
    store: Store, t: Task, details_type: str, now: float
) -> bool:
    """Poisoned-host detection (reference rest/route/host_agent.go:32,1454-
    1469): a dynamic host whose last N task finishes were all system
    failures is assumed unhealthy — decommission it and tell the agent to
    exit. Returns should_exit. Static hosts are never auto-disabled."""
    if not t.host_id:
        return False
    hcoll = host_mod.coll(store)
    h = hcoll.get(t.host_id)
    if h is None or h["provider"] == Provider.STATIC.value:
        return False
    system_failed = (
        t.status == TaskStatus.FAILED.value and details_type == "system"
    )
    if not system_failed:
        if h.get("consecutive_system_fails", 0):
            hcoll.update(t.host_id, {"consecutive_system_fails": 0})
        return False
    n = h.get("consecutive_system_fails", 0) + 1
    hcoll.update(t.host_id, {"consecutive_system_fails": n})
    if n < CONSECUTIVE_SYSTEM_FAILURE_THRESHOLD:
        return False
    if h["status"] == HostStatus.RUNNING.value:
        # already-down statuses (quarantined, terminated, decommissioned)
        # are never overwritten: the reference's poison handler no-ops on
        # any non-running host
        hcoll.update(t.host_id, {"status": HostStatus.DECOMMISSIONED.value})
        event_mod.log(
            store,
            event_mod.RESOURCE_HOST,
            "HOST_POISONED",
            t.host_id,
            {"consecutive_system_failures": n, "task_id": t.id},
            timestamp=now,
        )
    return True


def activate_task_with_dependencies(
    store: Store, task_id: str, by: str, now: Optional[float] = None
) -> List[str]:
    """Activate a task AND its unfinished dependency closure (reference
    model.SetActiveState / task.ActivateDeactivatedDependencies).
    Returns every task id activated."""
    now = _time.time() if now is None else now
    c = task_mod.coll(store)
    activated: List[str] = []
    stack = [task_id]
    seen: set = set()
    while stack:
        tid = stack.pop()
        if tid in seen:
            continue
        seen.add(tid)
        doc = c.get(tid)
        if doc is None:
            continue
        if doc["status"] == TaskStatus.UNDISPATCHED.value and not doc["activated"]:
            c.update(
                tid,
                {"activated": True, "activated_by": by, "activated_time": now},
            )
            activated.append(tid)
        stack.extend(d["task_id"] for d in doc.get("depends_on", []))
    if activated:
        event_mod.log(
            store,
            event_mod.RESOURCE_TASK,
            "TASKS_ACTIVATED",
            task_id,
            {"by": by, "count": len(activated)},
            timestamp=now,
        )
    return activated
