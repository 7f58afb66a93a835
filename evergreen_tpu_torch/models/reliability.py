"""Task reliability scores.

A copy of ``evergreen_tpu/models/reliability.py``, whole (reference
model/reliability/query.go: GetTaskReliabilityScores aggregates task
results by (task, variant, distro, date bucket) and scores each group
with the LOWER bound of the Wilson binomial confidence interval,
query.go:92-108, with the z value derived from a two-tailed significance
level, query.go:145-156 significanceToZ). The filter mirrors
reliability/filter.go: project and task names required, optional
requesters, variants and distros, a date window, the group-by level,
group_num_days bucketing, sort by date, limit.

As in the JAX package, the aggregation runs over the finished task
documents in the store (the reference's daily_task_stats rollup is a
materialization of the same tasks collection), not over the duration
rollups of ``models/taskstats.py``; the scoring runs the same float64
formula on the host, so a score equals the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List, Optional

from ..globals import TaskStatus
from ..storage.store import Store
from .task import COLLECTION as TASKS_COLLECTION

DAY_S = 86400.0

#: group-by levels (reference taskstats GroupByDistro/Variant/Task):
#: each level keeps the named column and everything to its left in
#: (task, variant, distro)
GROUP_BY_TASK = "task"
GROUP_BY_VARIANT = "variant"
GROUP_BY_DISTRO = "distro"

SORT_EARLIEST = "earliest"
SORT_LATEST = "latest"

#: reference reliability.go:27 reliabilityAPIMaxNumTasksLimit
MAX_LIMIT = 1000


def significance_to_z(significance: float) -> float:
    """Two-tailed z score (reference query.go:145-156): the normal
    quantile at 1 - significance/2. The default significance of 0.05
    yields z ≈ 1.96."""
    return NormalDist().inv_cdf(1.0 - significance / 2.0)


def wilson_lower_bound(num_success: int, num_total: int, z: float) -> float:
    """Lower Wilson score interval bound, rounded UP to two decimals
    exactly as the reference does (query.go:92-108
    ``math.Ceil(low*100)/100``)."""
    if num_total == 0:
        return 0.0
    total = float(num_total)
    p = num_success / total
    dist = z * math.sqrt((p * (1.0 - p) + z * z / (4.0 * total)) / total)
    denominator = 1.0 + z * z / total
    c1 = p + z * z / (2.0 * total)
    low = max(0.0, (c1 - dist) / denominator)
    return math.ceil(low * 100) / 100


@dataclasses.dataclass
class TaskReliability:
    """One scored group (reference query.go:71-87)."""

    task_name: str
    build_variant: str
    distro: str
    date: float  # bucket start, unix seconds UTC
    num_total: int = 0
    num_success: int = 0
    num_failed: int = 0
    num_timeout: int = 0
    num_test_failed: int = 0
    num_system_failed: int = 0
    num_setup_failed: int = 0
    avg_duration_success: float = 0.0
    success_rate: float = 0.0
    z: float = 0.0

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ReliabilityFilter:
    """reference reliability/filter.go TaskReliabilityFilter."""

    project: str
    tasks: List[str]
    after_date: float
    before_date: float
    group_by: str = GROUP_BY_TASK
    group_num_days: int = 1
    requesters: Optional[List[str]] = None
    variants: Optional[List[str]] = None
    distros: Optional[List[str]] = None
    significance: float = 0.05
    sort: str = SORT_LATEST
    limit: int = MAX_LIMIT

    def validate(self) -> Optional[str]:
        if not self.project:
            return "missing project"
        if not self.tasks:
            return "missing tasks"
        if self.group_by not in (GROUP_BY_TASK, GROUP_BY_VARIANT,
                                 GROUP_BY_DISTRO):
            return f"invalid 'group by' {self.group_by!r}"
        if not 0.0 <= self.significance <= 1.0:
            return "invalid significance"
        if self.group_num_days < 1:
            return "invalid group_num_days"
        if self.sort not in (SORT_EARLIEST, SORT_LATEST):
            return f"invalid sort {self.sort!r}"
        if self.after_date >= self.before_date:
            return "after_date must precede before_date"
        return None


def _classify(doc: dict) -> Dict[str, int]:
    """Status counters for one finished execution (reference taskstats
    aggregation stages: success / failed split into test, system, setup,
    timeout)."""
    out = {"success": 0, "failed": 0, "timeout": 0, "test_failed": 0,
           "system_failed": 0, "setup_failed": 0}
    status = doc.get("status", "")
    if status == TaskStatus.SUCCEEDED.value:
        out["success"] = 1
        return out
    out["failed"] = 1
    if doc.get("details_timed_out"):
        out["timeout"] = 1
    dtype = doc.get("details_type", "")
    if dtype == "system":
        out["system_failed"] = 1
    elif dtype == "setup":
        out["setup_failed"] = 1
    else:
        out["test_failed"] = 1
    return out


def get_task_reliability_scores(
    store: Store, f: ReliabilityFilter
) -> List[TaskReliability]:
    """Aggregate + score (reference query.go:158-174
    GetTaskReliabilityScores)."""
    err = f.validate()
    if err:
        raise ValueError(err)
    z = significance_to_z(f.significance)
    tasks = set(f.tasks)
    requesters = set(f.requesters or [])
    variants = set(f.variants or [])
    distros = set(f.distros or [])
    bucket_s = f.group_num_days * DAY_S

    groups: Dict[tuple, TaskReliability] = {}
    for doc in store.collection(TASKS_COLLECTION).find(
        lambda d: d.get("project") == f.project
        and d.get("display_name") in tasks
        and d.get("status")
        in (TaskStatus.SUCCEEDED.value, TaskStatus.FAILED.value)
        and f.after_date <= d.get("finish_time", 0.0) < f.before_date
    ):
        if requesters and doc.get("requester") not in requesters:
            continue
        if variants and doc.get("build_variant") not in variants:
            continue
        if distros and doc.get("distro_id") not in distros:
            continue
        # day-truncate, then bucket relative to the window start
        # (reference buckets stats days onto group_num_days boundaries)
        day = math.floor(doc.get("finish_time", 0.0) / DAY_S) * DAY_S
        start_day = math.floor(f.after_date / DAY_S) * DAY_S
        bucket = start_day + math.floor((day - start_day) / bucket_s) * bucket_s
        variant = doc.get("build_variant", "")
        distro = doc.get("distro_id", "")
        key = (
            doc.get("display_name", ""),
            variant if f.group_by in (GROUP_BY_VARIANT, GROUP_BY_DISTRO) else "",
            distro if f.group_by == GROUP_BY_DISTRO else "",
            bucket,
        )
        g = groups.get(key)
        if g is None:
            g = groups[key] = TaskReliability(
                task_name=key[0], build_variant=key[1], distro=key[2],
                date=bucket, z=z,
            )
        c = _classify(doc)
        g.num_total += 1
        g.num_success += c["success"]
        g.num_failed += c["failed"]
        g.num_timeout += c["timeout"]
        g.num_test_failed += c["test_failed"]
        g.num_system_failed += c["system_failed"]
        g.num_setup_failed += c["setup_failed"]
        if c["success"]:
            dur = max(
                0.0,
                doc.get("finish_time", 0.0) - doc.get("start_time", 0.0),
            )
            # running mean over successes only (reference
            # AvgDurationSuccess)
            g.avg_duration_success += (
                dur - g.avg_duration_success
            ) / g.num_success

    out = list(groups.values())
    for g in out:
        g.success_rate = wilson_lower_bound(g.num_success, g.num_total, z)
    out.sort(
        key=lambda g: (g.date, g.task_name, g.build_variant, g.distro),
        reverse=f.sort == SORT_LATEST,
    )
    return out[: min(f.limit, MAX_LIMIT)]
