"""Task document.

A copy of ``evergreen_tpu/models/task.py``'s ``Dependency``,
``DurationStats`` and ``Task`` (field for field), the store reads the
tick's gather calls and the two writes of a tick: ``mark_scheduled`` and
``unschedule_stale_underwater``; the dispatcher's ``is_dispatchable``
gate. Times are epoch seconds, durations seconds.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, Iterable, List, Optional

from ..globals import (
    DEFAULT_TASK_DURATION_S,
    MAX_TASK_TIME_IN_QUEUE_S,
    STEPBACK_TASK_ACTIVATOR,
    TASK_COMPLETED_STATUSES,
    TaskStatus,
)
from ..storage.store import Collection, Store

COLLECTION = "tasks"

#: Dependency status wildcard: dependency is met when the parent finishes
#: with any status (reference model/task AllStatuses).
DEP_STATUS_ANY = "*"


@dataclasses.dataclass(slots=True)
class Dependency:
    """One dependency edge (reference model/task/task.go:427-437)."""

    task_id: str
    status: str = TaskStatus.SUCCEEDED.value  # "" in the reference ≡ success
    unattainable: bool = False
    finished: bool = False

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "Dependency":
        return cls(**doc)


@dataclasses.dataclass
class DurationStats:
    """Historical runtime estimate (reference model/task/task.go:3510-3580,
    ``FetchExpectedDuration`` returning average + stddev)."""

    average_s: float = 0.0
    std_dev_s: float = 0.0


@dataclasses.dataclass(slots=True)
class Task:
    """``slots=True``: the snapshot packer (native/evgpack) reads ~10
    attributes per task per tick at 50k-task scale — slot descriptors cut
    that PyObject_GetAttr cost and halve per-instance memory."""

    id: str
    display_name: str = ""
    project: str = ""
    version: str = ""
    build_id: str = ""
    build_variant: str = ""
    distro_id: str = ""
    secondary_distros: List[str] = dataclasses.field(default_factory=list)
    revision: str = ""
    revision_order_number: int = 0

    status: str = TaskStatus.UNDISPATCHED.value
    activated: bool = False
    activated_by: str = ""
    priority: int = 0
    requester: str = ""
    execution: int = 0

    # Scheduling signals
    create_time: float = 0.0
    ingest_time: float = 0.0
    activated_time: float = 0.0
    scheduled_time: float = 0.0
    dependencies_met_time: float = 0.0
    dispatch_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0

    depends_on: List[Dependency] = dataclasses.field(default_factory=list)
    num_dependents: int = 0
    override_dependencies: bool = False

    task_group: str = ""
    task_group_max_hosts: int = 0
    task_group_order: int = 0

    generate_task: bool = False
    generated_by: str = ""

    expected_duration_s: float = 0.0
    duration_std_dev_s: float = 0.0

    host_id: str = ""
    execution_platform: str = "host"
    container: str = ""

    aborted: bool = False
    details_type: str = ""  # "system", "setup", "test", "" — failure class
    details_desc: str = ""
    details_timed_out: bool = False
    results_failed: bool = False

    # Stepback bookkeeping (reference model/task/task.go stepback fields)
    last_heartbeat: float = 0.0
    can_reset: bool = False
    reset_when_finished: bool = False
    num_automatic_restarts: int = 0

    #: per-instance queue_row() memo (slot, since there is no __dict__);
    #: excluded from to_doc/compare, never persisted
    _qrow: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        if self.ingest_time == 0.0 and self.create_time:
            self.ingest_time = self.create_time

    def fetch_expected_duration(self) -> DurationStats:
        """Expected runtime with the no-history default (reference
        model/task/task.go:3510-3580 FetchExpectedDuration: stats rollup,
        falling back to defaultTaskDuration)."""
        if self.expected_duration_s > 0:
            return DurationStats(
                average_s=self.expected_duration_s,
                std_dev_s=self.duration_std_dev_s,
            )
        return DurationStats(average_s=float(DEFAULT_TASK_DURATION_S))

    # -- identity ----------------------------------------------------------- #

    def queue_row(self) -> tuple:
        """The queue-document columns that never change for a
        materialized task, memoized per instance."""
        row = self._qrow
        if row is None:
            row = self._qrow = (
                self.id,
                self.display_name,
                self.build_variant,
                self.project,
                self.version,
                self.requester,
                self.revision_order_number,
                self.priority,
                self.task_group,
                self.task_group_max_hosts,
                self.task_group_order,
                self.expected_duration_s,
                self.num_dependents,
                [d.task_id for d in self.depends_on],
            )
        return row

    def task_group_string(self) -> str:
        """Unit key for task-group members (reference
        model/task/task.go GetTaskGroupString): group _ variant _ project _ version."""
        return f"{self.task_group}_{self.build_variant}_{self.project}_{self.version}"

    # -- predicates ---------------------------------------------------------- #

    def is_single_host_task_group(self) -> bool:
        return self.task_group != "" and self.task_group_max_hosts == 1

    def is_finished(self) -> bool:
        return self.status in TASK_COMPLETED_STATUSES

    def is_dispatchable(self) -> bool:
        return (
            self.status == TaskStatus.UNDISPATCHED.value
            and self.activated
            and self.priority >= 0
        )

    def is_stepback_activated(self) -> bool:
        return self.activated_by == STEPBACK_TASK_ACTIVATOR

    def blocked(self) -> bool:
        """A task is blocked when any dependency is marked unattainable
        (reference model/task/task.go Blocked)."""
        if self.override_dependencies:
            return False
        return any(d.unattainable for d in self.depends_on)

    def dependencies_met(self, cache: Dict[str, "Task"]) -> bool:
        """Reference semantics of task.DependenciesMet
        (model/task/task.go:634): every parent must be finished with the
        required status; missing parents count as unmet."""
        if self.override_dependencies or not self.depends_on:
            return True
        for dep in self.depends_on:
            parent = cache.get(dep.task_id)
            if parent is None:
                return False
            if not parent.is_finished():
                return False
            if dep.status == DEP_STATUS_ANY:
                continue
            if parent.status != dep.status:
                return False
        return True

    def time_in_queue(self, now: Optional[float] = None) -> float:
        """Queue-wait signal used by the planner (reference
        scheduler/planner.go:318-322): prefer activated time, fall back to
        ingest time."""
        now = _time.time() if now is None else now
        if self.activated_time > 0.0:
            return min(max(0.0, now - self.activated_time), MAX_TASK_TIME_IN_QUEUE_S)
        if self.ingest_time > 0.0:
            return min(max(0.0, now - self.ingest_time), MAX_TASK_TIME_IN_QUEUE_S)
        return 0.0

    def wait_since_dependencies_met(self, now: Optional[float] = None) -> float:
        """Overdue-wait signal for the allocator feedback rule (reference
        scheduler/scheduler.go:121-133)."""
        now = _time.time() if now is None else now
        start = max(self.scheduled_time, self.dependencies_met_time)
        if start <= 0.0:
            return 0.0
        return max(0.0, now - start)

    # -- serialization ------------------------------------------------------- #

    def to_doc(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["_id"] = doc.pop("id")
        doc.pop("_qrow", None)  # instance memo, not document state
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "Task":
        doc = dict(doc)
        doc["id"] = doc.pop("_id")
        doc["depends_on"] = [
            d if isinstance(d, Dependency) else Dependency.from_doc(d)
            for d in doc.get("depends_on", [])
        ]
        known = _TASK_FIELDS  # dataclasses.fields() per doc is hot-loop cost
        return cls(**{k: v for k, v in doc.items() if k in known})


_TASK_FIELDS = frozenset(f.name for f in dataclasses.fields(Task))


# --------------------------------------------------------------------------- #
# Queries (reference model/task/db.go query builders)
# --------------------------------------------------------------------------- #


def coll(store: Store) -> Collection:
    return store.collection(COLLECTION)


def insert(store: Store, task: Task) -> None:
    coll(store).insert(task.to_doc())


def insert_many(store: Store, tasks: List[Task]) -> None:
    coll(store).insert_many([t.to_doc() for t in tasks])


def get(store: Store, task_id: str) -> Optional[Task]:
    doc = coll(store).get(task_id)
    return Task.from_doc(doc) if doc else None


def by_ids(store: Store, ids: List[str]) -> List[Task]:
    return [Task.from_doc(d) for d in coll(store).find_ids(ids)]


def find(store: Store, pred=None) -> List[Task]:
    return [Task.from_doc(d) for d in coll(store).find(pred)]


def find_host_runnable(store: Store, distro_id: str = "") -> List[Task]:
    """The finder: undispatched + activated + non-disabled host tasks for a
    distro, including not-yet-dep-met tasks (the revised dispatcher handles
    ordering). Reference: task.FindHostRunnable ($graphLookup pipeline,
    scheduler/task_finder.go:34-36) with IncludesDependencies semantics.
    """

    def pred(doc: dict) -> bool:
        if doc["status"] != TaskStatus.UNDISPATCHED.value or not doc["activated"]:
            return False
        if doc["priority"] < 0:
            return False
        if doc.get("execution_platform", "host") != "host":
            return False
        if distro_id and doc["distro_id"] != distro_id and distro_id not in doc.get(
            "secondary_distros", []
        ):
            return False
        return True

    tasks = find(store, pred)
    # Drop blocked tasks (unattainable dependencies): the reference's
    # $graphLookup pipeline filters these out of the runnable set.
    return [t for t in tasks if not t.blocked()]


def mark_scheduled(
    store: Store, task_ids: List[str], when: float, deps_met_ids: Iterable[str] = ()
) -> int:
    """Stamp scheduled_time for newly planned tasks and
    dependencies_met_time the first time a task is seen with its
    dependencies satisfied (reference SetTasksScheduledAndDepsMetTime via
    scheduler/task_queue_persister.go:17-62 + model/task/task.go:1161-1175;
    the latter keeps the allocator's waits-over-threshold feedback from
    counting pre-dependency wait)."""
    c = coll(store)
    deps_met_set = set(deps_met_ids)
    # check-before-mutate (a steady-state tick must not dirty unchanged
    # tasks), then ONE batched update per stamp kind; the only_if
    # predicate re-checks under the lock so a concurrent stamp can't be
    # double-applied
    docs = c.find_ids(task_ids)
    sched_ids = [
        d["_id"] for d in docs if d.get("scheduled_time", 0.0) <= 0.0
    ]
    dmt_ids = [
        d["_id"]
        for d in docs
        if d["_id"] in deps_met_set
        and d.get("dependencies_met_time", 0.0) <= 0.0
    ]
    n = c.bulk_update(
        sched_ids,
        {"scheduled_time": when},
        only_if=lambda d: d.get("scheduled_time", 0.0) <= 0.0,
    )
    c.bulk_update(
        dmt_ids,
        {"dependencies_met_time": when},
        only_if=lambda d: d.get("dependencies_met_time", 0.0) <= 0.0,
    )
    return n


def unschedule_stale_underwater(
    store: Store, distro_id: str, now: float, threshold_s: float
) -> List[str]:
    """Deactivate tasks stale in the queue beyond the underwater threshold
    and zero their priority (reference task.UnscheduleStaleUnderwaterHostTasks
    via scheduler/scheduler.go:223)."""

    def stale(doc: dict) -> bool:
        if doc["status"] != TaskStatus.UNDISPATCHED.value or not doc["activated"]:
            return False
        if distro_id and doc["distro_id"] != distro_id:
            return False
        activated = doc.get("activated_time", 0.0) or doc.get("ingest_time", 0.0)
        return activated > 0.0 and (now - activated) > threshold_s

    c = coll(store)
    doomed = [d["_id"] for d in c.find(stale)]
    for tid in doomed:
        c.update(tid, {"activated": False, "priority": 0})
    return doomed
