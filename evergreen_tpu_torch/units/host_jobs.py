"""Stranded-task handling: reset-or-system-fail an in-flight task whose
host cannot be running it.

A copy of ``evergreen_tpu/units/host_jobs.py``'s
``reset_task_or_mark_system_failed``, ``fix_stranded_task``,
``MAX_STRANDED_TASK_RESTARTS`` and the stranded counter, under the JAX
package's names — what the recovery pass calls (reference
units/task_stranded_cleanup.go + model.ResetTaskOrMarkSystemFailed).
The host monitors of that module (``monitor_host_cloud_state``,
``reap_stale_building_hosts``, idle termination, drawdown, auto-tune,
host stats) come with the job plane.
"""
from __future__ import annotations

from ..globals import TaskStatus
from ..models import task as task_mod
from ..models.lifecycle import mark_end
from ..storage.store import Store
from ..utils import metrics as _metrics

RECOVERY_STRANDED = _metrics.counter(
    "recovery_stranded_tasks_total",
    "Stranded in-flight tasks handled by reset-or-system-fail, labeled "
    "by outcome (reset / system_failed).",
    labels=("outcome",),
    legacy=lambda labels: [f"recovery.stranded_{labels['outcome']}"],
)


#: automatic stranded-task restarts before the task STAYS system-failed
#: (reference evergreen.MaxTaskExecution bound inside
#: model.ResetTaskOrMarkSystemFailed; attempt accounting rides the task's
#: num_automatic_restarts field)
MAX_STRANDED_TASK_RESTARTS = 3


def reset_task_or_mark_system_failed(
    store: Store,
    task_id: str,
    host_id: str,
    now: float,
    reason: str = "host terminated while task was running",
    max_restarts: int = MAX_STRANDED_TASK_RESTARTS,
) -> str:
    """The reference's ``ResetTaskOrMarkSystemFailed``: the in-flight
    execution is system-failed (archived with its details), then — if the
    task still has automatic restarts left and was not aborted — it is
    reset to run again, with ``num_automatic_restarts`` accounting the
    attempts.  Returns "reset", "system-failed", or "" (no-op: the task
    was already finished or not in flight)."""
    from ..utils.log import get_logger

    t = task_mod.get(store, task_id)
    if t is None or t.is_finished():
        return ""
    ended = mark_end(
        store,
        task_id,
        TaskStatus.FAILED.value,
        now=now,
        details_type="system",
        details_desc=f"host {host_id}: {reason}",
    )
    if ended is None:
        return ""  # not dispatched/started: nothing in flight to fix
    attempts = t.num_automatic_restarts
    if t.aborted or attempts >= max_restarts:
        RECOVERY_STRANDED.inc(outcome="system_failed")
        get_logger("resilience").warning(
            "stranded-task-system-failed",
            task=task_id,
            host=host_id,
            attempts=attempts,
            reason=reason,
        )
        return "system-failed"
    from .task_jobs import restart_task

    if not restart_task(store, task_id, by="stranded-task-reset", now=now):
        # mark_end already reset it (reset_when_finished — a restart the
        # USER requested): don't charge an automatic-restart credit
        t2 = task_mod.get(store, task_id)
        if t2 is not None and t2.status == TaskStatus.UNDISPATCHED.value:
            return "reset"
        return "system-failed"  # unexpected state: leave it failed
    task_mod.coll(store).update(
        task_id, {"num_automatic_restarts": attempts + 1}
    )
    RECOVERY_STRANDED.inc(outcome="reset")
    get_logger("resilience").info(
        "stranded-task-reset",
        task=task_id,
        host=host_id,
        attempt=attempts + 1,
        reason=reason,
    )
    return "reset"


def fix_stranded_task(
    store: Store, task_id: str, host_id: str, now: float
) -> None:
    """Reset-or-system-fail a task whose host died (reference
    units/task_stranded_cleanup.go + model.ResetTaskOrMarkSystemFailed:
    the stranded execution is archived as a system failure and the task
    re-runs automatically while restart attempts remain)."""
    reset_task_or_mark_system_failed(
        store, task_id, host_id, now,
        reason="host was terminated while task was running",
    )
