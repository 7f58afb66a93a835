"""In-memory cloud provider.

A copy of ``evergreen_tpu/cloud/mock.py`` (reference cloud/mock.go).
Spawned instances move intent → provisioning instantly (default), or
park in STARTING until ``advance()``. The instance table is class-level
and process-local, in the JAX package too: in a fresh process it is
empty, so a ``building`` mock host reads ``NONEXISTENT`` and the
recovery pass terminates it. ``reset`` empties it (tests reset both
packages' tables).
"""
from __future__ import annotations

import time as _time
from typing import Dict, Optional

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
    #: when False, spawned instances park in STARTING until advance()
    instant_up: bool = True

    @classmethod
    def reset(cls, instant_up: bool = True) -> None:
        cls.instances = {}
        cls.instant_up = instant_up

    def spawn_host(self, store: Store, host: Host) -> None:
        ext_id = f"mock-{host.id}"
        status = (
            CloudHostStatus.RUNNING if self.instant_up else CloudHostStatus.STARTING
        )
        type(self).instances[ext_id] = status
        host_mod.coll(store).update(
            host.id,
            {
                "external_id": ext_id,
                "status": HostStatus.STARTING.value
                if not self.instant_up
                else HostStatus.PROVISIONING.value,
                "start_time": _time.time(),
            },
        )

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

    def start_instance(self, store: Store, host: Host) -> None:
        if host.external_id:
            type(self).instances[host.external_id] = CloudHostStatus.RUNNING
        host_mod.coll(store).update(host.id, {"status": HostStatus.RUNNING.value})

    @classmethod
    def advance(cls) -> None:
        """Move all STARTING instances to RUNNING (one provisioning step)."""
        for ext_id, st in list(cls.instances.items()):
            if st == CloudHostStatus.STARTING:
                cls.instances[ext_id] = CloudHostStatus.RUNNING


register_manager(Provider.MOCK.value, MockCloudManager)
register_manager(Provider.DOCKER_MOCK.value, MockCloudManager)
