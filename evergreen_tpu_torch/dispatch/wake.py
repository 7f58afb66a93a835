"""Dependency wake: flip ready dependents' queue flags without a re-plan.

A copy of ``evergreen_tpu/dispatch/wake.py``. ``mark_end`` knows exactly
which dependents became ready, so it updates their persisted queue
items' dependencies-met flags in place (ordering is untouched — exactly
what the next tick would compute) and stamps the queue document dirty
(``dirty_at``), so dispatchers rebuild on the next poll instead of
waiting out their TTL, and wakes the long-pollers parked on that
distro's queue (``dispatch/longpoll.py::hub_for``), sized to the entries
that flipped.
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

    from .longpoll import hub_for

    hub = hub_for(store)
    n = 0
    for distro_id, tids in by_distro.items():
        n_start = n
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
        flipped = n - n_start
        if flipped:
            # the stamp write above already bumped the hub's generation
            # (collection listener); this wakes the PARKED long-pollers,
            # sized to the entries that actually flipped (an inflated
            # hint stampedes parked agents and overstates the ledger)
            hub.notify(distro_id, n_hint=flipped)
    return n
