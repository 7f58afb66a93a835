"""Dependency wake: flip ready dependents' queue flags without a re-plan.

A copy of ``evergreen_tpu/dispatch/wake.py``. ``mark_end`` knows exactly
which dependents became ready, so it updates their persisted queue
items' dependencies-met flags in place (ordering is untouched — exactly
what the next tick would compute) and stamps the queue document dirty
(``dirty_at``). The JAX package then also wakes the long-pollers parked
on that distro's queue (``dispatch/longpoll.py::hub_for``); the port has
no dispatcher and so no parked pollers, and that notify (in memory only,
no document) is left out with dispatch.
"""
from __future__ import annotations

from typing import Dict, List

from ..models import task_queue as tq_mod
from ..storage.store import Store


def wake_dependents(store: Store, ready_ids: List[str], now: float) -> int:
    """Mark ready tasks dependencies-met in their distros' queue docs.
    Returns the number of queue entries updated."""
    by_distro: Dict[str, List[str]] = {}
    task_coll = store.collection("tasks")
    for tid in ready_ids:
        doc = task_coll.get(tid)
        if doc is None:
            continue
        by_distro.setdefault(doc["distro_id"], []).append(tid)
        for sd in doc.get("secondary_distros", []):
            by_distro.setdefault(sd, []).append(tid)

    n = 0
    for distro_id, tids in by_distro.items():
        for secondary in (False, True):
            coll = tq_mod.coll(store, secondary)
            qdoc = coll.get(distro_id)
            if qdoc is None:
                continue
            want = set(tids)
            updated = False
            rows = qdoc.get("rows")
            cols = qdoc.get("cols")
            if rows is not None:
                met = qdoc.get("dependencies_met") or []
                for idx, r in enumerate(rows):
                    if r[0] in want and idx < len(met) and not met[idx]:
                        met[idx] = True
                        updated = True
                        n += 1
            elif cols is not None:
                ids = cols["id"]
                met = cols["dependencies_met"]
                for idx, qid in enumerate(ids):
                    if qid in want and not met[idx]:
                        met[idx] = True
                        updated = True
                        n += 1
            else:  # legacy item-list format
                for item in qdoc.get("queue", []):
                    if item["id"] in want and not item["dependencies_met"]:
                        item["dependencies_met"] = True
                        updated = True
                        n += 1
            if updated:
                # bump the dirty stamp so dispatchers rebuild on next poll
                coll.update(distro_id, {"dirty_at": now})
    return n
