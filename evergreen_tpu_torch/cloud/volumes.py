"""Sleep schedules for unexpirable spawn hosts.

A copy of ``evergreen_tpu/cloud/volumes.py``'s sleep schedules
(``SleepSchedule``, ``set_sleep_schedule`` and the cron plane's
``sleep-schedules`` job, ``enforce_sleep_schedules``; reference
config_sleep_schedule.go + units/spawnhost sleep-schedule jobs): daily
off-hours windows during which user hosts are stopped, then started
again. The volume surface comes with the REST spawn-host routes.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional

from ..globals import HostStatus
from ..models import event as event_mod
from ..models import host as host_mod
from ..storage.store import Store
from .manager import get_manager

SLEEP_SCHEDULES_COLLECTION = "sleep_schedules"


@dataclasses.dataclass
class SleepSchedule:
    """Daily off-hours window in whole hours (config_sleep_schedule.go's
    recurring schedule reduced to its common shape)."""

    host_id: str
    stop_hour_utc: int = 22
    start_hour_utc: int = 8
    enabled: bool = True

    def should_be_stopped(self, now: float) -> bool:
        hour = int(now // 3600) % 24
        if self.stop_hour_utc == self.start_hour_utc:
            return False
        if self.stop_hour_utc < self.start_hour_utc:
            return self.stop_hour_utc <= hour < self.start_hour_utc
        return hour >= self.stop_hour_utc or hour < self.start_hour_utc


def set_sleep_schedule(store: Store, schedule: SleepSchedule) -> None:
    doc = dataclasses.asdict(schedule)
    doc["_id"] = schedule.host_id
    store.collection(SLEEP_SCHEDULES_COLLECTION).upsert(doc)


def enforce_sleep_schedules(
    store: Store, now: Optional[float] = None
) -> List[str]:
    """Stop/start unexpirable spawn hosts per their schedules (reference
    units/spawnhost sleep-schedule jobs). Returns host ids acted on."""
    now = _time.time() if now is None else now
    acted: List[str] = []
    for doc in store.collection(SLEEP_SCHEDULES_COLLECTION).find(
        lambda d: d.get("enabled", True)
    ):
        sched = SleepSchedule(
            host_id=doc["host_id"],
            stop_hour_utc=doc["stop_hour_utc"],
            start_hour_utc=doc["start_hour_utc"],
            enabled=doc.get("enabled", True),
        )
        h = host_mod.get(store, sched.host_id)
        if h is None or not h.user_host or not h.no_expiration:
            continue
        want_stopped = sched.should_be_stopped(now)
        try:
            mgr = get_manager(h.provider)
        except KeyError:
            continue
        if want_stopped and h.status == HostStatus.RUNNING.value:
            mgr.stop_instance(store, h)
            acted.append(h.id)
            event_mod.log(
                store, event_mod.RESOURCE_HOST, "HOST_SLEEP", h.id,
                timestamp=now,
            )
        elif not want_stopped and h.status == HostStatus.STOPPED.value:
            mgr.start_instance(store, h)
            acted.append(h.id)
            event_mod.log(
                store, event_mod.RESOURCE_HOST, "HOST_WAKE", h.id,
                timestamp=now,
            )
    return acted
