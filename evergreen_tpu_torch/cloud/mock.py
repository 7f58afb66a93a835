"""In-memory cloud provider.

A copy of ``evergreen_tpu/cloud/mock.py``'s status probe, terminate and
stop. Its instance table is class-level and process-local, in the JAX
package too: in a fresh shard worker it is empty, so a ``building`` mock
host (with or without an ``external_id``) reads ``NONEXISTENT`` and the
recovery pass terminates it. Spawning, start and the provisioning steps
(``spawn_host``, ``start_instance``, ``advance``) come with the
provisioning plane.
"""
from __future__ import annotations

import time as _time
from typing import Dict

from ..globals import HostStatus, Provider
from ..models import host as host_mod
from ..models.host import Host
from ..storage.store import Store
from .manager import CloudHostStatus, CloudManager, register_manager


class MockCloudManager(CloudManager):
    provider = Provider.MOCK.value

    #: class-level instance table so independently-constructed managers see
    #: the same cloud truth (the reference mock shares global state too)
    instances: Dict[str, str] = {}

    def get_instance_status(self, store: Store, host: Host) -> str:
        if not host.external_id:
            return CloudHostStatus.NONEXISTENT
        return type(self).instances.get(host.external_id, CloudHostStatus.NONEXISTENT)

    def terminate_instance(self, store: Store, host: Host, reason: str) -> None:
        if host.external_id:
            type(self).instances[host.external_id] = CloudHostStatus.TERMINATED
        host_mod.coll(store).update(
            host.id,
            {
                "status": HostStatus.TERMINATED.value,
                "termination_time": _time.time(),
            },
        )

    def stop_instance(self, store: Store, host: Host) -> None:
        if host.external_id:
            type(self).instances[host.external_id] = CloudHostStatus.STOPPED
        host_mod.coll(store).update(host.id, {"status": HostStatus.STOPPED.value})


register_manager(Provider.MOCK.value, MockCloudManager)
register_manager(Provider.DOCKER_MOCK.value, MockCloudManager)
