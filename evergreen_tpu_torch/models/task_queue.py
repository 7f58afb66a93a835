"""Per-queue aggregate info: the queue-info views a tick's unpack hands
the capacity plane and, later, the persister.

A copy of ``evergreen_tpu/models/task_queue.py``'s ``TaskGroupInfo``,
``DistroQueueInfo`` and ``QueueInfoView``; ``TaskQueueItem``, ``TaskQueue``
and the queue document's ``save``/``load`` come with the persister.
"""
from __future__ import annotations

import dataclasses
from typing import List


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
