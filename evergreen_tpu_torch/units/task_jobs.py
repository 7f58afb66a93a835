"""Task monitoring + restart background jobs.

A copy of ``evergreen_tpu/units/task_jobs.py`` (reference
units/task_monitor_execution_timeout.go:73-143, model/task_lifecycle.go
reset functions + units/tasks_restart.go, stats_task.go, stats_queue.go,
stats_amboy.go, stats_sysinfo.go): the stale-heartbeat monitor, abort
requests, restarts with their execution archive, and the system-stats
sampler.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional

from ..globals import TaskStatus
from ..models import event as event_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..storage.store import Store

#: a dispatched/started task with no heartbeat for this long is presumed
#: dead (reference agent heartbeat cadence + taskExecutionTimeout)
DEFAULT_HEARTBEAT_TIMEOUT_S = 7 * 60.0

ARCHIVE_COLLECTION = "task_archives"


def monitor_stale_heartbeats(
    store: Store,
    now: Optional[float] = None,
    timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
) -> List[str]:
    """Reap in-flight tasks whose heartbeat went stale (reference
    units/task_monitor_execution_timeout.go:73,143): the dead execution
    is archived as a system failure and the task automatically re-runs
    while restart attempts remain — the same
    ``reset_task_or_mark_system_failed`` path startup reconciliation uses
    (scheduler/recovery.py), so a heartbeat lost to a crash and one lost
    to a hung agent converge identically."""
    from .host_jobs import reset_task_or_mark_system_failed

    now = _time.time() if now is None else now
    reaped: List[str] = []
    for doc in task_mod.coll(store).find(
        lambda d: d["status"]
        in (TaskStatus.DISPATCHED.value, TaskStatus.STARTED.value)
        and now - max(d.get("last_heartbeat", 0.0), d.get("dispatch_time", 0.0))
        > timeout_s
    ):
        host_id = doc.get("host_id", "")
        outcome = reset_task_or_mark_system_failed(
            store, doc["_id"], host_id or "<none>", now,
            reason="heartbeat timeout: task presumed dead",
        )
        if outcome:
            reaped.append(doc["_id"])
        # free the host if it still claims this task (mark_end clears a
        # coherent claim; this covers a claim the task doc never knew)
        if host_id:
            host_mod.clear_running_task(store, host_id, doc["_id"], now)
    return reaped


def abort_task(store: Store, task_id: str, by: str = "",
               now: Optional[float] = None) -> bool:
    """Flag a task for abort; the agent observes it at the next heartbeat
    (reference task.SetAborted + agent abort handling)."""
    now = _time.time() if now is None else now
    ok = task_mod.coll(store).update(task_id, {"aborted": True})
    if ok:
        event_mod.log(
            store,
            event_mod.RESOURCE_TASK,
            "TASK_ABORT_REQUESTED",
            task_id,
            {"by": by},
            timestamp=now,
        )
    return ok


def restart_task(
    store: Store, task_id: str, by: str = "", now: Optional[float] = None
) -> bool:
    """Archive the finished execution and reset the task to run again
    (reference model/task_lifecycle.go reset functions; Task.Execution
    archive semantics)."""
    now = _time.time() if now is None else now
    c = task_mod.coll(store)
    doc = c.get(task_id)
    if doc is None:
        return False
    if doc["status"] not in (
        TaskStatus.SUCCEEDED.value,
        TaskStatus.FAILED.value,
    ):
        return False

    # archive current execution
    store.collection(ARCHIVE_COLLECTION).upsert(
        {
            "_id": f"{task_id}:{doc['execution']}",
            "task_id": task_id,
            "execution": doc["execution"],
            "status": doc["status"],
            "details_type": doc.get("details_type", ""),
            "start_time": doc.get("start_time", 0.0),
            "finish_time": doc.get("finish_time", 0.0),
            "host_id": doc.get("host_id", ""),
        }
    )
    # rotate the flat log doc to its per-execution archive so the new
    # execution starts clean and old logs stay queryable
    # (graphql taskLogs(execution:) reads "{taskId}:{execution}")
    log_coll = store.collection("task_logs")
    log_doc = log_coll.get(task_id)
    if log_doc is not None:
        log_coll.upsert(
            {"_id": f"{task_id}:{doc['execution']}",
             "lines": list(log_doc.get("lines", []))}
        )
        log_coll.remove(task_id)

    # reset dependency edges that pointed at this task on dependents
    def reset_dep_edges(dep_doc: dict) -> None:
        changed = False
        for dep in dep_doc.get("depends_on", []):
            if dep["task_id"] == task_id:
                dep["finished"] = False
                dep["unattainable"] = False
                changed = True
        if changed:
            c.update(dep_doc["_id"], {"depends_on": dep_doc["depends_on"]})

    for dep_doc in c.find(
        lambda d: any(x["task_id"] == task_id for x in d.get("depends_on", []))
    ):
        reset_dep_edges(dep_doc)

    c.update(
        task_id,
        {
            "status": TaskStatus.UNDISPATCHED.value,
            "execution": doc["execution"] + 1,
            "activated": True,
            "activated_by": by,
            "activated_time": now,
            "dispatch_time": 0.0,
            "start_time": 0.0,
            "finish_time": 0.0,
            "scheduled_time": 0.0,
            "dependencies_met_time": 0.0,
            "host_id": "",
            "aborted": False,
            "details_type": "",
            "details_desc": "",
            "details_timed_out": False,
            "last_heartbeat": 0.0,
        },
    )
    event_mod.log(
        store,
        event_mod.RESOURCE_TASK,
        "TASK_RESTARTED",
        task_id,
        {"by": by, "execution": doc["execution"] + 1},
        timestamp=now,
    )
    return True


def get_task_execution_archive(store: Store, task_id: str) -> List[dict]:
    out = store.collection(ARCHIVE_COLLECTION).find(
        lambda d: d["task_id"] == task_id
    )
    out.sort(key=lambda d: d["execution"])
    return out


SYSTEM_STATS_COLLECTION = "system_stats"
_SYSTEM_STATS_KEEP = 500


def sample_system_stats(store: Store, now: Optional[float] = None) -> dict:
    """Periodic system samplers: task counts by status, per-distro queue
    length/age, background-job depth and process rusage in one document
    (reference units/stats_task.go, stats_queue.go, stats_amboy.go,
    stats_sysinfo.go — the de-facto metrics the reference emits as
    structured logs; here persisted and served at /rest/v2/stats/system).
    """
    import resource

    now = _time.time() if now is None else now
    task_counts: Dict[str, int] = {}
    for doc in task_mod.coll(store).find():
        task_counts[doc["status"]] = task_counts.get(doc["status"], 0) + 1
    from ..models import task_queue as task_queue_mod

    queues = {}
    for qdoc in task_queue_mod.coll(store).find():
        n = len(task_queue_mod.doc_column(qdoc, "id"))
        queues[qdoc["_id"]] = {
            "length": n,
            "age_s": round(max(0.0, now - qdoc.get("generated_at", now)), 3),
        }
    jobs = store.collection("jobs")
    ru = resource.getrusage(resource.RUSAGE_SELF)
    doc = {
        "_id": f"sys-{now:.3f}",
        "at": now,
        "tasks_by_status": task_counts,
        "queues": queues,
        "jobs_pending": jobs.count(
            lambda d: d["status"] in ("pending", "running")
        ),
        "jobs_failed": jobs.count(lambda d: d["status"] == "failed"),
        "max_rss_kb": ru.ru_maxrss,
        "cpu_user_s": round(ru.ru_utime, 3),
    }
    coll = store.collection(SYSTEM_STATS_COLLECTION)
    coll.upsert(doc)
    # bounded history: drop the oldest samples beyond the window (by the
    # numeric timestamp — string ids don't sort chronologically across
    # digit-width boundaries)
    docs = sorted(coll.find(), key=lambda d: d["at"])
    for stale in docs[:-_SYSTEM_STATS_KEEP]:
        coll.remove(stale["_id"])
    return doc
