"""Task duration statistics: historical rollups → expected durations.

A copy of ``evergreen_tpu/models/taskstats.py`` (reference
model/taskstats/ rollups + units/cache_historical_task_data.go feeding
Task.FetchExpectedDuration): rollups keyed (project, build variant,
display name) hold the average and standard deviation of recent
successful runtimes; ``cache_historical_task_data`` is the hourly cron
job that recomputes them, and ``stamp_expected_durations`` stamps new
tasks so the tick reads a plain field.
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Dict, List, Optional, Tuple

from ..globals import TaskStatus
from ..storage.store import Store
from . import task as task_mod

COLLECTION = "task_stats"

#: rollup window (reference uses recent-days windows for duration stats)
DEFAULT_WINDOW_S = 14 * 24 * 3600.0


def _key(project: str, variant: str, name: str) -> str:
    return f"{project}|{variant}|{name}"


@dataclasses.dataclass
class DurationRollup:
    project: str
    build_variant: str
    display_name: str
    average_s: float = 0.0
    std_dev_s: float = 0.0
    count: int = 0
    updated_at: float = 0.0


def get_rollup(
    store: Store, project: str, variant: str, name: str
) -> Optional[DurationRollup]:
    doc = store.collection(COLLECTION).get(_key(project, variant, name))
    if doc is None:
        return None
    doc = {k: v for k, v in doc.items() if k != "_id"}
    return DurationRollup(**doc)


def cache_historical_task_data(
    store: Store, now: Optional[float] = None, window_s: float = DEFAULT_WINDOW_S
) -> int:
    """Recompute rollups from finished tasks in the window (reference
    units/cache_historical_task_data.go). Returns rollups written."""
    now = _time.time() if now is None else now
    cutoff = now - window_s
    sums: Dict[str, Tuple[float, float, int]] = {}
    for doc in task_mod.coll(store).find(
        lambda d: d["status"] == TaskStatus.SUCCEEDED.value
        and d.get("finish_time", 0.0) >= cutoff
        and d.get("start_time", 0.0) > 0.0
    ):
        dur = max(0.0, doc["finish_time"] - doc["start_time"])
        k = _key(doc["project"], doc["build_variant"], doc["display_name"])
        s, s2, n = sums.get(k, (0.0, 0.0, 0))
        sums[k] = (s + dur, s2 + dur * dur, n + 1)

    coll = store.collection(COLLECTION)
    for k, (s, s2, n) in sums.items():
        avg = s / n
        var = max(0.0, s2 / n - avg * avg)
        project, variant, name = k.split("|", 2)
        coll.upsert(
            {
                "_id": k,
                "project": project,
                "build_variant": variant,
                "display_name": name,
                "average_s": avg,
                "std_dev_s": math.sqrt(var),
                "count": n,
                "updated_at": now,
            }
        )
    return len(sums)


def stamp_expected_durations(store: Store, tasks: List) -> int:
    """Stamp newly created tasks with the current rollups (called from
    version creation so the scheduler snapshot reads a plain field)."""
    n = 0
    coll = store.collection(COLLECTION)
    for t in tasks:
        doc = coll.get(_key(t.project, t.build_variant, t.display_name))
        if doc and doc["count"] > 0:
            task_mod.coll(store).update(
                t.id,
                {
                    "expected_duration_s": doc["average_s"],
                    "duration_std_dev_s": doc["std_dev_s"],
                },
            )
            t.expected_duration_s = doc["average_s"]
            t.duration_std_dev_s = doc["std_dev_s"]
            n += 1
    return n
