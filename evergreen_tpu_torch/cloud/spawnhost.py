"""Spawn hosts: the expiration job.

A copy of ``evergreen_tpu/cloud/spawnhost.py``'s ``expire_spawn_hosts``
(reference units/spawnhost_expiration_check.go), which the cron plane's
``spawnhost-expiration`` job runs. Creating, extending, stopping,
starting and terminating spawn hosts come with the REST spawn-host
routes.
"""
from __future__ import annotations

import time as _time
from typing import List, Optional

from ..globals import HostStatus
from ..models import event as event_mod
from ..models import host as host_mod
from ..storage.store import Store
from .manager import get_manager


def expire_spawn_hosts(store: Store, now: Optional[float] = None) -> List[str]:
    """The spawnhost-expiration job (units/spawnhost_expiration_check.go)."""
    now = _time.time() if now is None else now
    expired: List[str] = []
    for h in host_mod.find(
        store,
        lambda d: d["user_host"]
        and not d["no_expiration"]
        and 0 < d["expiration_time"] < now
        and d["status"]
        not in (HostStatus.TERMINATED.value, HostStatus.DECOMMISSIONED.value),
    ):
        try:
            get_manager(h.provider).terminate_instance(store, h, "expired")
        except KeyError:
            host_mod.coll(store).update(
                h.id, {"status": HostStatus.TERMINATED.value}
            )
        event_mod.log(
            store, event_mod.RESOURCE_HOST, "SPAWN_HOST_EXPIRED", h.id,
            timestamp=now,
        )
        expired.append(h.id)
    return expired
