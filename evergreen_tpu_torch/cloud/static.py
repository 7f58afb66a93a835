"""Static provider: pre-existing machines.

A copy of ``evergreen_tpu/cloud/static.py`` (reference cloud/static.go +
scheduler/wrapper.go:133-266 UpdateStaticDistro): hosts come from the
distro's provider settings, are upserted each create pass, never spawned
or terminated (termination just removes the doc), and decommission when
dropped from the settings list.
"""
from __future__ import annotations

import time as _time
import uuid
from typing import List, Optional

from ..globals import HostStatus, Provider
from ..models import distro as distro_mod
from ..models import host as host_mod
from ..models.distro import Distro
from ..models.host import Host
from ..storage.store import Store
from .manager import CloudHostStatus, CloudManager, register_manager


class StaticManager(CloudManager):
    provider = Provider.STATIC.value

    def spawn_host(self, store: Store, host: Host) -> None:
        # static hosts are never spawned; intents shouldn't exist
        host_mod.coll(store).update(
            host.id, {"status": HostStatus.RUNNING.value}
        )

    def get_instance_status(self, store: Store, host: Host) -> str:
        return CloudHostStatus.RUNNING

    def terminate_instance(self, store: Store, host: Host, reason: str) -> None:
        # reference: terminating a static host just removes the document
        host_mod.coll(store).remove(host.id)


def update_static_distro(
    store: Store, d: Distro, now: Optional[float] = None
) -> List[str]:
    """Upsert host docs for the distro's static machine list and
    decommission dropped ones (reference scheduler/wrapper.go:133-230)."""
    now = _time.time() if now is None else now
    names = [
        str(h.get("name", "")) if isinstance(h, dict) else str(h)
        for h in (d.provider_settings or {}).get("hosts", [])
    ]
    names = [n for n in names if n]
    seen = set()
    out: List[str] = []
    for name in names:
        hid = f"static-{d.id}-{name}"
        seen.add(hid)
        existing = host_mod.get(store, hid)
        if existing is None:
            from .provisioning import needs_reprovisioning

            host_mod.insert(
                store,
                Host(
                    id=hid,
                    distro_id=d.id,
                    provider=Provider.STATIC.value,
                    status=HostStatus.RUNNING.value,
                    ip_address=name,
                    provision_time=now,
                    last_communication_time=now,
                    secret=uuid.uuid4().hex,
                    bootstrap_method=d.bootstrap_settings.method,
                    needs_reprovision=needs_reprovisioning(d, None),
                ),
            )
            out.append(hid)
        else:
            from .provisioning import needs_reprovisioning

            update: dict = {}
            if existing.status != HostStatus.RUNNING.value:
                update["status"] = HostStatus.RUNNING.value
            # the reference re-evaluates the bootstrap transition for
            # every static host on each allocator pass
            # (scheduler/wrapper.go:233-266 via UpdateStaticDistro)
            want = needs_reprovisioning(d, existing)
            if want != existing.needs_reprovision:
                update["needs_reprovision"] = want
            if update:
                host_mod.coll(store).update(hid, update)
    # decommission hosts removed from the settings list
    for h in host_mod.find(
        store,
        lambda doc: doc["distro_id"] == d.id
        and doc["provider"] == Provider.STATIC.value
        and doc["_id"] not in seen,
    ):
        host_mod.coll(store).update(
            h.id, {"status": HostStatus.DECOMMISSIONED.value}
        )
    return out


def update_all_static_distros(store: Store, now: Optional[float] = None) -> int:
    n = 0
    for d in distro_mod.find_all(store):
        if d.provider == Provider.STATIC.value:
            n += len(update_static_distro(store, d, now))
    return n


register_manager(Provider.STATIC.value, StaticManager)
