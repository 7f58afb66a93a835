"""Cost accounting: per-task cloud cost attribution.

A copy of ``evergreen_tpu/models/cost.py``'s ``attribute_task_cost``,
which ``mark_end`` calls (reference model/task_lifecycle.go:754-768),
over its ``CostConfig`` section (kept in ``settings.py`` with the
others): a finished task is billed its runtime ×
its host's instance-type rate (on-demand or spot-discounted), plus an EBS
per-hour component. The cost-reporting reader (``project_cost``) is not
ported.
"""
from __future__ import annotations

import time as _time
from typing import Optional

from ..settings import CostConfig
from ..storage.store import Store

TASK_COSTS_COLLECTION = "task_costs"


def hourly_rate(config: CostConfig, instance_type: str, spot: bool) -> float:
    base = config.on_demand_prices.get(
        instance_type, config.default_price_per_hour
    )
    if spot:
        base *= config.spot_discount
    return base + config.ebs_price_per_hour


def attribute_task_cost(
    store: Store, task_id: str, now: Optional[float] = None
) -> Optional[float]:
    """Record the finished task's attributed cost (called from MarkEnd)."""
    now = _time.time() if now is None else now
    t = store.collection("tasks").get(task_id)
    if t is None or t.get("start_time", 0.0) <= 0:
        return None
    duration_s = max(0.0, t.get("finish_time", now) - t["start_time"])
    host = store.collection("hosts").get(t.get("host_id", "")) or {}
    config = CostConfig.get(store)
    distro = store.collection("distros").get(t.get("distro_id", "")) or {}
    spot = bool(
        (distro.get("provider_settings") or {}).get("fleet_use_spot", False)
    )
    rate = hourly_rate(config, host.get("instance_type", ""), spot)
    cost = (duration_s / 3600.0) * rate * config.financial_formula_percentage
    store.collection(TASK_COSTS_COLLECTION).upsert(
        {
            "_id": f"{task_id}:{t.get('execution', 0)}",
            "task_id": task_id,
            "project": t.get("project", ""),
            "duration_s": duration_s,
            "instance_type": host.get("instance_type", ""),
            "hourly_rate": rate,
            "cost_usd": cost,
            "at": now,
        }
    )
    return cost
