"""Task restart: archive the finished execution and run the task again.

A copy of ``evergreen_tpu/units/task_jobs.py``'s ``restart_task`` (and
its archive collection), which the recovery pass and ``mark_end``'s
task-group reset call (reference model/task_lifecycle.go reset
functions; Task.Execution archive semantics). The monitors of that module
(``monitor_stale_heartbeats``, ``abort_task``, the stats samplers) come
with the job plane.
"""
from __future__ import annotations

import time as _time
from typing import Optional

from ..globals import TaskStatus
from ..models import event as event_mod
from ..models import task as task_mod
from ..storage.store import Store

ARCHIVE_COLLECTION = "task_archives"


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
