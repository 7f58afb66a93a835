"""Persisted task queue and per-queue aggregate info.

The queue document is what a tick writes for each distro (reference
model/task_queue.go:48-78 DistroQueueInfo;
scheduler/task_queue_persister.go). A copy of
``evergreen_tpu/models/task_queue.py``: the same collections, the same
row-major document layout (``ROW_FIELDS``, an ``order`` permutation over
id-sorted rows), and the same readers, so a document one package writes
reads back the same in the other.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..storage.store import Collection, Store

COLLECTION = "task_queues"
SECONDARY_COLLECTION = "task_secondary_queues"


@dataclasses.dataclass
class TaskGroupInfo:
    """Per-task-group aggregates feeding the allocator (reference
    model/task_queue.go TaskGroupInfo)."""

    name: str = ""
    count: int = 0
    max_hosts: int = 0
    expected_duration_s: float = 0.0
    count_free: int = 0
    count_required: int = 0
    count_duration_over_threshold: int = 0
    count_wait_over_threshold: int = 0
    count_dep_filled_merge_queue: int = 0
    duration_over_threshold_s: float = 0.0


@dataclasses.dataclass
class DistroQueueInfo:
    length: int = 0
    length_with_dependencies_met: int = 0
    count_dep_filled_merge_queue: int = 0
    expected_duration_s: float = 0.0
    max_duration_threshold_s: float = 0.0
    plan_created_at: float = 0.0
    count_duration_over_threshold: int = 0
    duration_over_threshold_s: float = 0.0
    count_wait_over_threshold: int = 0
    task_group_infos: List[TaskGroupInfo] = dataclasses.field(default_factory=list)
    secondary_queue: bool = False


class QueueInfoView:
    """Lazy ``DistroQueueInfo`` equivalent over the batched solve's raw
    host-side output columns.

    The view defers all object construction: ``doc()`` builds the info
    document only when it is read, and its field order matches
    ``DistroQueueInfo``'s byte for byte.
    """

    __slots__ = (
        "secondary_queue", "plan_created_at", "_di", "_seg_ids", "_c",
        "_doc",
    )

    def __init__(self, di: int, seg_ids, cols: dict) -> None:
        self.secondary_queue = False
        self.plan_created_at = 0.0
        self._di = di
        self._seg_ids = seg_ids
        self._c = cols
        self._doc = None

    # the three aggregates the tick driver reads directly
    @property
    def length(self) -> int:
        return int(self._c["d_length"][self._di])

    @property
    def length_with_dependencies_met(self) -> int:
        return int(self._c["d_deps_met"][self._di])

    @property
    def expected_duration_s(self) -> float:
        return float(self._c["d_expected_dur_s"][self._di])

    def doc(self) -> dict:
        d = self._doc
        if d is None:
            c, di = self._c, self._di
            names = c["seg_names"]
            d = self._doc = {
                "length": int(c["d_length"][di]),
                "length_with_dependencies_met": int(c["d_deps_met"][di]),
                "count_dep_filled_merge_queue": int(c["d_merge"][di]),
                "expected_duration_s": float(c["d_expected_dur_s"][di]),
                "max_duration_threshold_s": float(c["d_thresh_s"][di]),
                "plan_created_at": self.plan_created_at,
                "count_duration_over_threshold": int(c["d_over_count"][di]),
                "duration_over_threshold_s": float(c["d_over_dur_s"][di]),
                "count_wait_over_threshold": int(c["d_wait_over"][di]),
                "secondary_queue": self.secondary_queue,
                "task_group_infos": [
                    {
                        "name": names[gi][1],
                        "count": int(c["g_count"][gi]),
                        "max_hosts": int(c["g_max_hosts"][gi]),
                        "expected_duration_s": float(c["g_expected_dur_s"][gi]),
                        "count_free": int(c["g_count_free"][gi]),
                        "count_required": int(c["g_count_required"][gi]),
                        "count_duration_over_threshold": int(c["g_over_count"][gi]),
                        "count_wait_over_threshold": int(c["g_wait_over"][gi]),
                        "count_dep_filled_merge_queue": int(c["g_merge"][gi]),
                        "duration_over_threshold_s": float(c["g_over_dur_s"][gi]),
                    }
                    for gi in self._seg_ids
                ],
            }
        return d


@dataclasses.dataclass
class TaskQueueItem:
    """One planned queue entry — the fields the DAG dispatcher needs
    (reference model/task_queue.go TaskQueueItem)."""

    id: str
    display_name: str = ""
    build_variant: str = ""
    project: str = ""
    version: str = ""
    requester: str = ""
    revision_order_number: int = 0
    priority: int = 0
    sort_value: float = 0.0
    task_group: str = ""
    task_group_max_hosts: int = 0
    task_group_order: int = 0
    expected_duration_s: float = 0.0
    num_dependents: int = 0
    dependencies: List[str] = dataclasses.field(default_factory=list)
    dependencies_met: bool = True


#: column order of the columnar queue doc (matches TaskQueueItem fields)
_ITEM_FIELDS = tuple(
    f.name for f in dataclasses.fields(TaskQueueItem)
)

#: field order of one row in the row-major persist format — exactly
#: Task.queue_row()'s tuple (models/task.py), memoized per task instance.
#: sort_value / dependencies_met ride as separate top-level columns
#: because they are the only per-tick-dynamic fields.
ROW_FIELDS = (
    "id", "display_name", "build_variant", "project", "version",
    "requester", "revision_order_number", "priority", "task_group",
    "task_group_max_hosts", "task_group_order", "expected_duration_s",
    "num_dependents", "dependencies",
)
_ROW_INDEX = {n: i for i, n in enumerate(ROW_FIELDS)}


def doc_column(doc: dict, name: str) -> list:
    """One logical column from a queue doc in ANY persisted format
    (row-major 'rows', columnar 'cols', or legacy item-list 'queue'),
    always in PLAN order. Docs carrying an ``order`` permutation keep
    their rows in the id-sorted canonical layout (so churn persists are
    row splices instead of full rewrites, scheduler/persister.py) and
    this accessor applies the permutation."""
    rows = doc.get("rows")
    if rows is not None:
        if name in ("sort_value", "dependencies_met"):
            col = doc.get(name) or []
            order = doc.get("order")
            return [col[i] for i in order] if order is not None else col
        idx = _ROW_INDEX[name]
        order = doc.get("order")
        if order is not None:
            return [rows[i][idx] for i in order]
        return [r[idx] for r in rows]
    cols = doc.get("cols")
    if cols is not None:
        return cols.get(name, [])
    return [i.get(name) for i in doc.get("queue", [])]


@dataclasses.dataclass
class TaskQueue:
    distro_id: str
    queue: List[TaskQueueItem] = dataclasses.field(default_factory=list)
    info: DistroQueueInfo = dataclasses.field(default_factory=DistroQueueInfo)
    generated_at: float = 0.0

    def length(self) -> int:
        return len(self.queue)

    def to_doc(self) -> dict:
        return {
            "_id": self.distro_id,
            "distro_id": self.distro_id,
            "queue": [dataclasses.asdict(i) for i in self.queue],
            "info": dataclasses.asdict(self.info),
            "generated_at": self.generated_at,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "TaskQueue":
        info_doc = dict(doc.get("info", {}))
        info_doc["task_group_infos"] = [
            TaskGroupInfo(**g) for g in info_doc.get("task_group_infos", [])
        ]
        rows = doc.get("rows")
        cols = doc.get("cols")
        if rows is not None:
            # row-major persist format (scheduler/persister.py): each row
            # is Task.queue_row() in ROW_FIELDS order; the two dynamic
            # columns ride separately. Dependencies are copied — rows are
            # memoized tuples shared across ticks. An ``order``
            # permutation maps row storage order back to plan order.
            sv = doc.get("sort_value") or [0.0] * len(rows)
            dm = doc.get("dependencies_met") or [True] * len(rows)
            order = doc.get("order")
            triples = (
                ((rows[i], sv[i], dm[i]) for i in order)
                if order is not None else zip(rows, sv, dm)
            )
            queue = [
                TaskQueueItem(
                    r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], s,
                    r[8], r[9], r[10], r[11], r[12], list(r[13]), bool(m),
                )
                for r, s, m in triples
            ]
        elif cols is not None:
            names = list(_ITEM_FIELDS)
            queue = [
                TaskQueueItem(**dict(zip(names, values)))
                for values in zip(*(cols[n] for n in names))
            ]
        else:
            queue = [TaskQueueItem(**i) for i in doc.get("queue", [])]
        return cls(
            distro_id=doc["distro_id"],
            queue=queue,
            info=DistroQueueInfo(**info_doc),
            generated_at=doc.get("generated_at", 0.0),
        )


def coll(store: Store, secondary: bool = False) -> Collection:
    return store.collection(SECONDARY_COLLECTION if secondary else COLLECTION)


def save(store: Store, queue: TaskQueue, secondary: bool = False) -> None:
    coll(store, secondary).upsert(queue.to_doc())


def load(store: Store, distro_id: str, secondary: bool = False) -> Optional[TaskQueue]:
    doc = coll(store, secondary).get(distro_id)
    return TaskQueue.from_doc(doc) if doc else None


def load_info(store: Store, distro_id: str) -> Optional[DistroQueueInfo]:
    q = load(store, distro_id)
    return q.info if q else None
