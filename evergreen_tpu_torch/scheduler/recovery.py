"""Startup reconciliation: heal derived state after lease acquisition +
WAL replay.

A copy of ``evergreen_tpu/scheduler/recovery.py``, run by each shard
worker (``runtime/worker.py``) after it replays its WAL segment and
before it says hello. Step 3 asks the port's registered providers
(``cloud/mock.py``: ``mock`` and ``docker-mock``); a building host of a
provider the port does not register yet is left alone, as the JAX pass
leaves a provider it has no manager for. Step 4 drops the persister's fingerprints and the
resident plane (``ResidentPlane.invalidate("recovery")``, which drops the
device mirror's buffers too), so the worker's first tick plans against
the reconciled state with a full rebuild and a full upload.

The WAL gives a failed-over holder byte-exact documents, but documents
are not the whole truth: an agent may have died with its task mid-flight,
a cloud instance may have been reaped while no monitor was watching, a
dispatch CAS pair may have been torn by the crash (host claims a task the
task doc never acknowledged), and the previous holder's delta-persist
fingerprints are process-local and gone.  The reference gets the same
healing lazily from its monitor populators (units/task_stranded_cleanup.go,
units/host_monitoring_check.go) because Mongo never went away; with a
real failover we run one explicit pass BEFORE the job plane starts, so
the first tick plans against reconciled state instead of ghosts.

Order matters and is pinned here:

  1. **half-dispatched assignments** — hosts claiming a task that is not
     actually in flight (or that a different host owns) release the
     claim; the dispatcher can re-serve the task immediately.
  2. **stranded tasks** — in-flight tasks whose host is gone/terminated
     or whose heartbeat is stale are reset-or-system-failed with attempt
     accounting (units/host_jobs.py::reset_task_or_mark_system_failed).
  3. **building hosts** — hosts stuck in building/starting/provisioning
     are re-verified against the cloud manager's truth; instances the
     provider no longer reports are terminated (their tasks go through
     step 2's path).
  4. **persister invalidation** — the PersisterState fingerprints and the
     solve-info epoch are dropped so the first post-recovery tick does a
     full rewrite of every queue doc instead of patching a base only the
     dead process remembered.

The ``recovery.pass`` fault seam at its entry is a kill point — dying
INSIDE recovery must leave a store the next recovery pass still heals.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional

from ..globals import HostStatus, TaskStatus
from ..models import event as event_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..storage.store import Store
from ..utils import metrics as _metrics

RECOVERY_RECONCILED = _metrics.counter(
    "recovery_reconciled_tasks_total",
    "Tasks healed by the startup reconciliation pass (released "
    "half-dispatched claims + reset/system-failed stranded tasks).",
    legacy="recovery.reconciled_tasks",
)

RECOVERY_PROVIDER_ERRORS = _metrics.counter(
    "recovery_provider_errors_total",
    "Building-host status probes the cloud provider failed during a "
    "recovery pass (the host is left to the periodic monitor; a spike "
    "here means recovery healed less than it should have).",
    legacy="recovery.provider_errors",
)

#: an in-flight task with no heartbeat for this long at recovery time is
#: presumed dead (same window the periodic monitor uses,
#: units/task_jobs.py::DEFAULT_HEARTBEAT_TIMEOUT_S)
RECOVERY_HEARTBEAT_TIMEOUT_S = 7 * 60.0

#: host states that may legitimately carry a running task
_UP_FOR_TASKS = (
    HostStatus.RUNNING.value,
    HostStatus.PROVISIONING.value,
    HostStatus.STARTING.value,
)

_BUILDING = (
    HostStatus.BUILDING.value,
    HostStatus.STARTING.value,
    HostStatus.PROVISIONING.value,
)


@dataclasses.dataclass
class RecoveryReport:
    """What one reconciliation pass changed (breadcrumbed as the
    ``recovery-pass`` structured-log record)."""

    released_claims: List[str] = dataclasses.field(default_factory=list)
    stranded_reset: List[str] = dataclasses.field(default_factory=list)
    stranded_failed: List[str] = dataclasses.field(default_factory=list)
    hosts_terminated: List[str] = dataclasses.field(default_factory=list)
    #: frames recovery's WAL replay dropped as superseded-epoch writes
    stale_frames_dropped: int = 0
    wal_max_epoch: int = 0
    epoch: int = 0

    @property
    def reconciled_tasks(self) -> int:
        return len(self.stranded_reset) + len(self.stranded_failed)

    def to_doc(self) -> dict:
        return {
            **dataclasses.asdict(self),
            "reconciled_tasks": self.reconciled_tasks,
        }


def _release_half_dispatched(
    store: Store, now: float, report: RecoveryReport
) -> None:
    """Step 1: a crash between the dispatch CAS pair (host claim, then
    task transition — dispatch/assign.py) leaves a host whose
    ``running_task`` points at a task that is not dispatched to it.
    Release the claim so the host is free and the task re-dispatches."""
    c = host_mod.coll(store)
    for doc in c.find(lambda d: bool(d.get("running_task"))):
        task_id = doc["running_task"]
        t = task_mod.coll(store).get(task_id)
        in_flight = t is not None and t["status"] in (
            TaskStatus.DISPATCHED.value,
            TaskStatus.STARTED.value,
        )
        if in_flight and t.get("host_id") == doc["_id"]:
            continue  # a coherent assignment: leave it alone
        # release WITHOUT the last_*-affinity/task_count bookkeeping of
        # clear_running_task: the claimed task never actually ran here
        c.update(doc["_id"], dict(host_mod.RUNNING_TASK_CLEAR_FIELDS))
        report.released_claims.append(doc["_id"])


def _reconcile_stranded_tasks(
    store: Store, now: float, heartbeat_timeout_s: float,
    report: RecoveryReport,
) -> None:
    """Step 2: in-flight tasks whose host cannot be running them — host
    doc gone, host terminated/decommissioned, or heartbeat stale past the
    window — are reset-or-system-failed with attempt accounting."""
    from ..units.host_jobs import reset_task_or_mark_system_failed

    for doc in task_mod.coll(store).find(
        lambda d: d["status"]
        in (TaskStatus.DISPATCHED.value, TaskStatus.STARTED.value)
    ):
        host_id = doc.get("host_id", "")
        hdoc = host_mod.coll(store).get(host_id) if host_id else None
        host_ok = hdoc is not None and hdoc["status"] in _UP_FOR_TASKS
        beat = max(doc.get("last_heartbeat", 0.0),
                   doc.get("dispatch_time", 0.0))
        fresh = now - beat <= heartbeat_timeout_s
        if host_ok and fresh:
            continue
        reason = (
            "host missing at recovery" if hdoc is None
            else "host not up at recovery" if not host_ok
            else "stale heartbeat at recovery"
        )
        outcome = reset_task_or_mark_system_failed(
            store, doc["_id"], host_id or "<none>", now, reason=reason
        )
        if outcome == "reset":
            report.stranded_reset.append(doc["_id"])
        elif outcome == "system-failed":
            report.stranded_failed.append(doc["_id"])


def _reverify_building_hosts(
    store: Store, now: float, report: RecoveryReport
) -> None:
    """Step 3: ask the cloud manager about every host the store believes
    is still coming up; instances the provider calls terminated or
    nonexistent are marked terminated (the monitor would catch these
    eventually — recovery does it before the first tick plans capacity
    around phantoms)."""
    from ..cloud.manager import CloudHostStatus, get_manager
    from ..units.host_jobs import fix_stranded_task

    for h in host_mod.find(store, lambda d: d["status"] in _BUILDING):
        try:
            mgr = get_manager(h.provider)
        except KeyError:
            continue
        try:
            cloud_status = mgr.get_instance_status(store, h)
        except Exception:  # noqa: BLE001 — an unreachable provider must
            # not block recovery; the periodic monitor retries, and the
            # skipped probe is counted so it cannot hide
            RECOVERY_PROVIDER_ERRORS.inc()
            continue
        if cloud_status not in (
            CloudHostStatus.TERMINATED,
            CloudHostStatus.NONEXISTENT,
        ):
            continue
        host_mod.coll(store).update(
            h.id,
            {
                "status": HostStatus.TERMINATED.value,
                "termination_time": now,
            },
        )
        event_mod.log(
            store,
            event_mod.RESOURCE_HOST,
            "HOST_EXTERNALLY_TERMINATED",
            h.id,
            {"cloud_status": cloud_status, "by": "recovery"},
            timestamp=now,
        )
        report.hosts_terminated.append(h.id)
        if h.running_task:
            fix_stranded_task(store, h.running_task, h.id, now)


def run_recovery_pass(
    store: Store,
    now: Optional[float] = None,
    heartbeat_timeout_s: float = RECOVERY_HEARTBEAT_TIMEOUT_S,
) -> RecoveryReport:
    """The full reconciliation pass; runs after lease acquisition + WAL
    replay and before the job plane starts."""
    from ..utils import faults
    from ..utils.log import get_logger

    faults.fire("recovery.pass")
    now = _time.time() if now is None else now
    report = RecoveryReport()
    replay = getattr(store, "replay_report", None)
    if replay:
        report.stale_frames_dropped = replay.get("stale_frames_dropped", 0)
        report.wal_max_epoch = replay.get("wal_max_epoch", 0)
    report.epoch = getattr(store, "epoch", 0)

    _release_half_dispatched(store, now, report)
    _reconcile_stranded_tasks(store, now, heartbeat_timeout_s, report)
    _reverify_building_hosts(store, now, report)

    # step 4: the dead process's delta-persist memory is gone; make the
    # invalidation explicit so an in-process failover (tests, embedded
    # standby) full-rewrites too instead of patching a stale base. The
    # resident state plane's columns are derived state of the SAME kind
    # — recovery's reconciliation writes bypass its delta stream only in
    # part, so it is dropped wholesale and rebuilds on the first tick.
    from .persister import persister_state_for
    from .resident import peek_resident_plane

    persister_state_for(store).reset()
    plane = peek_resident_plane(store)
    if plane is not None:
        plane.invalidate("recovery")

    if report.reconciled_tasks:
        RECOVERY_RECONCILED.inc(report.reconciled_tasks)
    get_logger("resilience").info("recovery-pass", **report.to_doc())
    return report
