"""EC2-fleet-shaped provider.

A copy of ``evergreen_tpu/cloud/ec2_fleet.py`` (reference
cloud/ec2_fleet.go, cloud/ec2.go): fleet spawning with spot/on-demand
selection, instance types and subnets from the distro's provider
settings, status from instance state, termination. The EC2 client is the
in-memory ``FakeEC2Client`` (CreateFleet / DescribeInstances /
TerminateInstances semantics), as in the JAX package; registered for
``ec2-fleet`` and ``ec2-ondemand``.
"""
from __future__ import annotations

import itertools
import threading

from ..utils import lockcheck as _lockcheck
import time as _time
from typing import Dict, Optional

from ..globals import HostStatus, Provider
from ..models import host as host_mod
from ..models.host import Host
from ..storage.store import Store
from .manager import CloudHostStatus, CloudManager, register_manager


class FakeEC2Client:
    """In-memory stand-in for the AWS EC2 API (the test seam the reference
    gets from cloud/ec2_client.go's interface + mocks)."""

    _seq = itertools.count(1)
    _lock = _lockcheck.make_lock("cloud.ec2")

    def __init__(self) -> None:
        self.instances: Dict[str, dict] = {}
        #: raw launch specs, newest last (lets tests assert on what the
        #: cloud API was actually asked for, e.g. user data payloads)
        self.fleet_requests: list = []

    def create_fleet(self, launch_spec: dict) -> str:
        with self._lock:
            iid = f"i-{next(self._seq):012x}"
        self.fleet_requests.append(dict(launch_spec))
        self.instances[iid] = {
            "state": "pending",
            "type": launch_spec.get("instance_type", "m5.large"),
            "spot": launch_spec.get("spot", False),
            "launched_at": _time.time(),
            "az": launch_spec.get("availability_zone", "us-east-1a"),
        }
        return iid

    def describe_instance(self, instance_id: str) -> Optional[dict]:
        inst = self.instances.get(instance_id)
        if inst is None:
            return None
        # instances come up on observation (the fake's provisioning model)
        if inst["state"] == "pending":
            inst["state"] = "running"
        return inst

    def terminate_instance(self, instance_id: str) -> bool:
        inst = self.instances.get(instance_id)
        if inst is None:
            return False
        inst["state"] = "terminated"
        return True

    def stop_instance(self, instance_id: str) -> bool:
        inst = self.instances.get(instance_id)
        if inst is None:
            return False
        inst["state"] = "stopped"
        return True

    def start_instance(self, instance_id: str) -> bool:
        inst = self.instances.get(instance_id)
        if inst is None:
            return False
        inst["state"] = "running"
        return True


_STATE_MAP = {
    "pending": CloudHostStatus.STARTING,
    "running": CloudHostStatus.RUNNING,
    "stopping": CloudHostStatus.STOPPING,
    "stopped": CloudHostStatus.STOPPED,
    "shutting-down": CloudHostStatus.STOPPING,
    "terminated": CloudHostStatus.TERMINATED,
}

_default_client: Optional[FakeEC2Client] = None


def default_client() -> FakeEC2Client:
    global _default_client
    if _default_client is None:
        _default_client = FakeEC2Client()
    return _default_client


def reset_default_client() -> None:
    global _default_client
    _default_client = None


class EC2FleetManager(CloudManager):
    provider = Provider.EC2_FLEET.value

    def __init__(self, client: Optional[FakeEC2Client] = None) -> None:
        self.client = client or default_client()

    def _settings(self, store: Store, h: Host) -> dict:
        from ..models import distro as distro_mod

        d = distro_mod.get(store, h.distro_id)
        return dict(d.provider_settings) if d else {}

    def spawn_host(self, store: Store, host: Host) -> None:
        settings = self._settings(store, host)
        iid = self.client.create_fleet(
            {
                "instance_type": settings.get("instance_type", "m5.large"),
                "spot": settings.get("fleet_use_spot", True),
                "availability_zone": settings.get("az", "us-east-1a"),
                "ami": settings.get("ami", ""),
                "subnet": settings.get("subnet_id", ""),
                "key_name": settings.get("key_name", ""),
                "user_data": host.user_data,
            }
        )
        host_mod.coll(store).update(
            host.id,
            {
                "external_id": iid,
                "instance_type": settings.get("instance_type", "m5.large"),
                "zone": settings.get("az", "us-east-1a"),
                # recorded so the monitoring path can tell a spot
                # reclamation from an ordinary external termination
                "spot": bool(settings.get("fleet_use_spot", True)),
                "status": HostStatus.STARTING.value,
                "start_time": _time.time(),
            },
        )

    def get_instance_status(self, store: Store, host: Host) -> str:
        if not host.external_id:
            return CloudHostStatus.NONEXISTENT
        inst = self.client.describe_instance(host.external_id)
        if inst is None:
            return CloudHostStatus.NONEXISTENT
        return _STATE_MAP.get(inst["state"], CloudHostStatus.UNKNOWN)

    def terminate_instance(self, store: Store, host: Host, reason: str) -> None:
        if host.external_id:
            self.client.terminate_instance(host.external_id)
        host_mod.coll(store).update(
            host.id,
            {
                "status": HostStatus.TERMINATED.value,
                "termination_time": _time.time(),
            },
        )

    def stop_instance(self, store: Store, host: Host) -> None:
        if host.external_id:
            self.client.stop_instance(host.external_id)
        host_mod.coll(store).update(host.id, {"status": HostStatus.STOPPED.value})

    def start_instance(self, store: Store, host: Host) -> None:
        if host.external_id:
            self.client.start_instance(host.external_id)
        host_mod.coll(store).update(host.id, {"status": HostStatus.STARTING.value})

    def get_dns_name(self, store: Store, host: Host) -> str:
        return f"ec2-{host.external_id}.compute.internal"


register_manager(Provider.EC2_FLEET.value, EC2FleetManager)
register_manager(Provider.EC2_ONDEMAND.value, EC2FleetManager)
