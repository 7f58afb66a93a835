"""Host lifecycle background jobs.

A copy of ``evergreen_tpu/units/host_jobs.py`` (reference
units/host_monitoring_check.go:31, host_monitoring_idle_termination.go,
host_termination.go, host_drawdown.go, task_stranded_cleanup.go,
distro_auto_tune.go, stats_host.go): cloud-truth reconciliation
(``monitor_host_cloud_state``), stale building hosts, idle termination
down to the distro minimum, drawdown toward the queue's demand or the
capacity plane's target, host-stats sampling and max-hosts auto-tuning,
with ``reset_task_or_mark_system_failed`` for a task its host can no
longer be running (the recovery pass and the heartbeat monitor call it
too).
"""
from __future__ import annotations

import time as _time
from typing import List, Optional

from ..cloud.manager import CloudHostStatus, get_manager
from ..globals import (
    HostStatus,
    OverallocatedRule,
    TaskStatus,
)
from ..models import distro as distro_mod
from ..models import event as event_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..models import task_queue as tq_mod
from ..models.lifecycle import mark_end
from ..storage.store import Store
from ..utils import metrics as _metrics

HOSTSTATS_COLLECTION = "host_stats"

RECOVERY_STRANDED = _metrics.counter(
    "recovery_stranded_tasks_total",
    "Stranded in-flight tasks handled by reset-or-system-fail, labeled "
    "by outcome (reset / system_failed).",
    labels=("outcome",),
    legacy=lambda labels: [f"recovery.stranded_{labels['outcome']}"],
)
HOSTS_REAP_MISSING_TS = _metrics.counter(
    "hosts_reap_missing_timestamps_total",
    "Building hosts found with neither start nor creation timestamp; "
    "their staleness clock starts at first observation instead of "
    "epoch-0 instant reaping.",
    legacy="hosts.reap_missing_timestamps",
)
CLOUD_SPOT_RECLAIMED = _metrics.counter(
    "cloud_spot_reclaimed_total",
    "Spot/preemptible instances the provider took back while we "
    "considered them live — discovered by the cloud-reconcile monitor; "
    "any running task routes through reset-or-system-fail.",
    legacy="cloud.spot_reclaimed",
)

#: default idle threshold before termination (reference
#: units/host_monitoring_idle_termination.go idleTimeCutoff ~ minutes)
DEFAULT_IDLE_CUTOFF_S = 4 * 60.0


def monitor_host_cloud_state(store: Store, now: Optional[float] = None) -> List[str]:
    """Reconcile host docs against provider truth: externally-terminated
    instances are marked terminated and their running tasks system-failed
    (reference units/host_monitoring_check.go:31 +
    units/task_stranded_cleanup.go)."""
    now = _time.time() if now is None else now
    changed: List[str] = []
    for h in host_mod.find(
        store,
        lambda d: d["status"]
        in (
            HostStatus.RUNNING.value,
            HostStatus.PROVISIONING.value,
            HostStatus.STARTING.value,
        ),
    ):
        try:
            mgr = get_manager(h.provider)
        except KeyError:
            continue
        cloud_status = mgr.get_instance_status(store, h)
        if cloud_status in (
            CloudHostStatus.TERMINATED,
            CloudHostStatus.NONEXISTENT,
            CloudHostStatus.STOPPED,
        ):
            host_mod.coll(store).update(
                h.id,
                {
                    "status": HostStatus.TERMINATED.value,
                    "termination_time": now,
                },
            )
            if h.spot:
                # expected weather on spot capacity, but it must be
                # visible: reclamation rate is a provider-pool signal
                # the capacity plane's preemption cost models
                from ..utils.log import get_logger

                CLOUD_SPOT_RECLAIMED.inc()
                get_logger("cloud").warning(
                    "spot-instance-reclaimed",
                    host=h.id,
                    distro=h.distro_id,
                    running_task=h.running_task,
                )
            event_mod.log(
                store,
                event_mod.RESOURCE_HOST,
                "HOST_EXTERNALLY_TERMINATED",
                h.id,
                {"cloud_status": cloud_status, "spot": h.spot},
                timestamp=now,
            )
            changed.append(h.id)
            if h.running_task:
                fix_stranded_task(store, h.running_task, h.id, now)
                # reset-or-system-fail releases the claim through
                # mark_end → clear_running_task, but a task that was
                # never marked dispatched/started (a half-assignment the
                # recovery pass would heal at startup) no-ops there and
                # would leave the DEAD host holding a claim forever — a
                # stranded dispatch claim no live path clears. Fail
                # closed: a terminated host claims nothing.
                hdoc = host_mod.coll(store).get(h.id)
                if hdoc is not None and hdoc.get("running_task"):
                    host_mod.coll(store).update(
                        h.id, dict(host_mod.RUNNING_TASK_CLEAR_FIELDS)
                    )
    return changed


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


def reap_stale_building_hosts(
    store: Store, now: Optional[float] = None, stale_after_s: float = 15 * 60.0
) -> List[str]:
    """Hosts stuck spawning/provisioning beyond the window are failed and
    terminated so capacity intent doesn't leak (reference
    host.MarkStaleBuildingAsFailed via units/host_allocator.go:127-134 +
    provision-failed handling)."""
    now = _time.time() if now is None else now
    reaped: List[str] = []
    building = (
        HostStatus.BUILDING.value,
        HostStatus.STARTING.value,
        HostStatus.PROVISIONING.value,
    )
    c = host_mod.coll(store)
    for doc in c.find(lambda d: d["status"] in building):
        born = max(doc.get("start_time") or 0.0, doc.get("creation_time") or 0.0)
        if born <= 0.0:
            # a doc missing BOTH timestamps would read as epoch-0 and be
            # reaped instantly: start its staleness clock now instead,
            # stamping the doc so the window eventually elapses
            from ..utils.log import get_logger

            HOSTS_REAP_MISSING_TS.inc()
            get_logger("resilience").warning(
                "building-host-missing-timestamps",
                host=doc["_id"],
                status=doc["status"],
            )
            c.update(doc["_id"], {"creation_time": now})
            continue
        if now - born > stale_after_s:
            _terminate(store, host_mod.Host.from_doc(doc),
                       "stale building/provisioning", now)
            reaped.append(doc["_id"])
    return reaped


def terminate_idle_hosts(store: Store, now: Optional[float] = None) -> List[str]:
    """Reap ephemeral hosts idle beyond the distro's acceptable idle time,
    never dipping below minimum hosts (reference
    units/host_monitoring_idle_termination.go)."""
    now = _time.time() if now is None else now
    reaped: List[str] = []
    # release-mode idle override takes precedence over distro + default
    # (reference model/distro/distro.go:688-692)
    from ..settings import ReleaseModeConfig, ServiceFlags

    idle_override = 0
    if not ServiceFlags.get(store).release_mode_disabled:
        idle_override = ReleaseModeConfig.get(
            store
        ).idle_time_seconds_override
    for d in distro_mod.find_all(store):
        if not d.is_ephemeral():
            continue
        cutoff = (
            idle_override if idle_override > 0
            else (d.host_allocator_settings.acceptable_host_idle_time_s
                  or DEFAULT_IDLE_CUTOFF_S)
        )
        hosts = host_mod.all_active_hosts(store, d.id)
        running = [h for h in hosts if h.status == HostStatus.RUNNING.value]
        min_hosts = d.host_allocator_settings.minimum_hosts
        can_kill = len(hosts) - min_hosts
        if can_kill <= 0:
            continue
        idle = [
            h
            for h in running
            if h.is_free()
            and now - max(h.last_communication_time, h.provision_time, h.start_time)
            > cutoff
        ]
        idle.sort(key=lambda h: h.creation_time)
        for h in idle[:can_kill]:
            _terminate(store, h, "idle", now)
            reaped.append(h.id)
    return reaped


def _terminate(store: Store, h, reason: str, now: float) -> None:
    try:
        mgr = get_manager(h.provider)
        mgr.terminate_instance(store, h, reason)
    except KeyError:
        host_mod.coll(store).update(
            h.id,
            {"status": HostStatus.TERMINATED.value, "termination_time": now},
        )
    event_mod.log(
        store,
        event_mod.RESOURCE_HOST,
        "HOST_TERMINATED",
        h.id,
        {"reason": reason},
        timestamp=now,
    )


#: capacity-plane targets older than this fall back to the queue-demand
#: heuristic (a stale joint solve must not drive terminations)
CAPACITY_TARGET_TTL_S = 10 * 60.0

DRAWDOWN_CAPACITY_TARGETS = _metrics.counter(
    "hosts_drawdown_capacity_targets_total",
    "Drawdown passes where a distro's surplus was computed against the "
    "capacity plane's joint-solve target instead of the per-distro "
    "queue-demand heuristic.",
    legacy="hosts.drawdown_capacity_targets",
)


def host_drawdown(store: Store, now: Optional[float] = None) -> List[str]:
    """Overallocation feedback: when the latest queue needs far fewer hosts
    than exist, terminate free surplus (reference units/host_drawdown.go,
    populated from allocator feedback units/host_allocator.go:327-334).

    Distros managed by the capacity plane shrink toward the JOINT
    solve's target instead of the per-distro queue-demand guess — the
    drawdown side of the same program whose intents grow the fleet, so
    grow and shrink can never fight across a shared pool."""
    now = _time.time() if now is None else now
    from ..scheduler.provenance import capacity_provenance_for

    cap = capacity_provenance_for(store)
    if cap is not None and now - cap.at > CAPACITY_TARGET_TTL_S:
        cap = None
    reaped: List[str] = []
    for d in distro_mod.find_all(store):
        if not d.is_ephemeral():
            continue
        if (
            d.host_allocator_settings.hosts_overallocated_rule
            != OverallocatedRule.TERMINATE.value
        ):
            continue
        hosts = host_mod.all_active_hosts(store, d.id)
        min_hosts = d.host_allocator_settings.minimum_hosts
        # only distros CURRENTLY opted into the joint program follow
        # its target — an opt-out must revert shrink decisions to the
        # queue-demand heuristic immediately, not after the TTL
        target = (
            cap.target_hosts(d.id)
            if cap is not None and d.planner_settings.capacity == "tpu"
            else None
        )
        if target is not None:
            DRAWDOWN_CAPACITY_TARGETS.inc()
            demand = target
        else:
            queue = tq_mod.load(store, d.id)
            demand = queue.info.length_with_dependencies_met if queue else 0
        surplus = len(hosts) - max(demand, min_hosts)
        if surplus <= 0:
            continue
        free = [
            h
            for h in hosts
            if h.status == HostStatus.RUNNING.value and h.is_free()
        ]
        free.sort(key=lambda h: h.creation_time)
        for h in free[:surplus]:
            _terminate(store, h, "overallocated", now)
            reaped.append(h.id)
    return reaped


def sample_host_stats(store: Store, now: Optional[float] = None) -> None:
    """Persist per-distro host usage samples feeding auto-tune (reference
    hoststat writes at units/host_allocator.go:459-472)."""
    now = _time.time() if now is None else now
    coll = store.collection(HOSTSTATS_COLLECTION)
    for d in distro_mod.find_all(store):
        hosts = host_mod.all_active_hosts(store, d.id)
        busy = sum(1 for h in hosts if not h.is_free())
        coll.upsert(
            {
                "_id": f"{d.id}:{int(now)}",
                "distro_id": d.id,
                "at": now,
                "num_hosts": len(hosts),
                "num_busy": busy,
            }
        )


def auto_tune_distro_max_hosts(
    store: Store,
    now: Optional[float] = None,
    window_s: float = 24 * 3600.0,
    headroom: float = 1.25,
) -> List[str]:
    """Tune MaximumHosts per opted-in distro from historical peak usage
    (reference units/distro_auto_tune.go:54-214)."""
    now = _time.time() if now is None else now
    cutoff = now - window_s
    tuned: List[str] = []
    stats = store.collection(HOSTSTATS_COLLECTION).find(
        lambda d: d["at"] >= cutoff
    )
    peak_by_distro = {}
    for s in stats:
        peak_by_distro[s["distro_id"]] = max(
            peak_by_distro.get(s["distro_id"], 0), s["num_busy"]
        )
    for d in distro_mod.find_all(store):
        if not d.host_allocator_settings.auto_tune_maximum_hosts:
            continue
        peak = peak_by_distro.get(d.id)
        if peak is None:
            continue
        new_max = max(
            d.host_allocator_settings.minimum_hosts + 1,
            int(peak * headroom) + 1,
        )
        if new_max != d.host_allocator_settings.maximum_hosts:
            d.host_allocator_settings.maximum_hosts = new_max
            distro_mod.upsert(store, d)
            event_mod.log(
                store,
                event_mod.RESOURCE_DISTRO,
                "DISTRO_MAX_HOSTS_AUTOTUNED",
                d.id,
                {"new_max": new_max, "peak_busy": peak},
                timestamp=now,
            )
            tuned.append(d.id)
    return tuned
