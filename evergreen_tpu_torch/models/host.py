"""Host document.

A copy of ``evergreen_tpu/models/host.py``'s ``Host`` (field for field)
and the store functions the tick's gather and intent budget call, with
``clear_running_task`` (task end: ``models/lifecycle.py::mark_end``) and
the recovery pass's claim release; ``assign_running_task`` and the other
dispatch writes are not ported.
"""
from __future__ import annotations

import dataclasses
import time as _time
import uuid
from typing import Dict, List, Optional

from ..globals import (
    HOST_ACTIVE_STATUSES,
    HostStatus,
)
from ..storage.store import Collection, Store

COLLECTION = "hosts"

@dataclasses.dataclass(slots=True)
class Host:
    id: str
    distro_id: str = ""
    provider: str = "mock"
    status: str = HostStatus.UNINITIALIZED.value
    started_by: str = "mci"  # "mci" == system-owned; else spawn host user
    user_host: bool = False
    no_expiration: bool = False
    expiration_time: float = 0.0

    creation_time: float = 0.0
    start_time: float = 0.0
    agent_start_time: float = 0.0
    termination_time: float = 0.0
    last_communication_time: float = 0.0

    # Dispatch state (reference host.go RunningTask block)
    running_task: str = ""
    running_task_group: str = ""
    running_task_build_variant: str = ""
    running_task_version: str = ""
    running_task_project: str = ""
    running_task_group_order: int = 0
    last_task: str = ""
    last_group: str = ""
    last_build_variant: str = ""
    last_version: str = ""
    last_project: str = ""
    task_count: int = 0
    task_group_teardown_start_time: float = 0.0

    total_idle_time_s: float = 0.0
    provision_time: float = 0.0
    #: the instance is spot/preemptible capacity (recorded at spawn from
    #: the provider's launch spec): reclamation — the cloud taking it
    #: back mid-task — is expected weather, counted by
    #: ``cloud_spot_reclaimed_total`` when the monitor discovers it
    spot: bool = False
    #: pending bootstrap transition (the JAX package's REPROVISION_*
    #: values, consumed by its cloud/provisioning.reprovision_hosts)
    needs_reprovision: str = ""
    provision_attempts: int = 0
    #: bootstrap method the host was actually provisioned with — compared
    #: against the distro's current BootstrapSettings.method to detect
    #: needed reprovisioning (reference host.Distro.BootstrapSettings
    #: snapshot vs the live distro, scheduler/wrapper.go:233-266)
    bootstrap_method: str = ""
    #: consecutive failed agent (re)deploys; poisons the host at the cap
    agent_deploy_attempts: int = 0
    #: generated cloud-init payload for self-provisioning hosts; attached
    #: to the provider's launch request (reference ec2 LaunchTemplate
    #: UserData)
    user_data: str = ""

    #: per-host agent credential, generated at creation and handed to the
    #: agent at deploy time; agent routes authenticate with it (reference
    #: host.Secret + rest/route middleware host-ID/secret check)
    secret: str = ""

    # Container-pool topology (reference host.go parent/container fields)
    parent_id: str = ""
    has_containers: bool = False
    container_pool_id: str = ""

    instance_type: str = ""
    zone: str = ""
    ip_address: str = ""
    external_id: str = ""  # cloud-provider instance id

    # Spawn-host user surface (reference model/host/host.go DisplayName /
    # InstanceTags / ProvisionOptions; edited via rest/route/host_spawn.go
    # and the editSpawnHost mutation)
    display_name: str = ""
    instance_tags: Dict[str, str] = dataclasses.field(default_factory=dict)
    provision_options: Dict[str, str] = dataclasses.field(
        default_factory=dict
    )
    #: RDP/admin password was set for a Windows spawn host (write-only;
    #: the password itself is never stored)
    service_password_set: bool = False

    def __post_init__(self) -> None:
        if self.creation_time == 0.0:
            self.creation_time = _time.time()

    # -- predicates (reference model/host/host.go:215 IsFree etc.) ----------- #

    def is_tearing_down(self) -> bool:
        return self.task_group_teardown_start_time > 0.0

    def is_free(self) -> bool:
        return self.running_task == "" and not self.is_tearing_down()

    def task_group_string(self) -> str:
        return (
            f"{self.running_task_group}_{self.running_task_build_variant}_"
            f"{self.running_task_project}_{self.running_task_version}"
        )

    def to_doc(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["_id"] = doc.pop("id")
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "Host":
        doc = dict(doc)
        doc["id"] = doc.pop("_id")
        known = _HOST_FIELDS  # fields() per doc is hot-loop cost
        return cls(**{k: v for k, v in doc.items() if k in known})


_HOST_FIELDS = frozenset(f.name for f in dataclasses.fields(Host))


def new_intent(distro_id: str, provider: str) -> Host:
    """Cloud-agnostic placeholder host created by the allocator output
    (reference scheduler/scheduler.go:176-220 CreateIntentHosts +
    host.NewIntent)."""
    return Host(
        id=f"evg-{distro_id}-{uuid.uuid4().hex[:12]}",
        distro_id=distro_id,
        provider=provider,
        status=HostStatus.UNINITIALIZED.value,
        secret=uuid.uuid4().hex,
    )


def coll(store: Store) -> Collection:
    return store.collection(COLLECTION)


def insert(store: Store, h: Host) -> None:
    coll(store).insert(h.to_doc())


def insert_many(store: Store, hosts: List[Host]) -> None:
    coll(store).insert_many([h.to_doc() for h in hosts])


def get(store: Store, host_id: str) -> Optional[Host]:
    doc = coll(store).get(host_id)
    return Host.from_doc(doc) if doc else None


def find(store: Store, pred=None) -> List[Host]:
    return [Host.from_doc(d) for d in coll(store).find(pred)]


def count_intents_in_flight(store: Store) -> int:
    """Intent hosts not yet materialized by the cloud — the ONE
    definition of "in flight" the intent-budget accounting uses, shared
    by the classic per-store path (scheduler/wrapper.py) and the
    sharded driver's fleet split (scheduler/sharded_plane.py) so the
    two deployments can never enforce different fleet caps."""
    return coll(store).count(
        lambda doc: doc["status"] == HostStatus.UNINITIALIZED.value
    )


def is_active_host_doc(doc: dict) -> bool:
    """The allocator's capacity predicate at doc level."""
    return (
        doc["status"] in HOST_ACTIVE_STATUSES and doc["started_by"] == "mci"
    )


def all_active_hosts(store: Store, distro_id: str = "") -> List[Host]:
    """Capacity view for the allocator (reference host.AllActiveHosts via
    units/host_allocator.go:152): system-owned hosts in an active state."""

    def pred(doc: dict) -> bool:
        if not is_active_host_doc(doc):
            return False
        if distro_id and doc["distro_id"] != distro_id:
            return False
        return True

    return find(store, pred)


#: the one definition of "no running task" — shared by task-end clearing
#: below and the recovery pass's half-dispatched-claim release
#: (scheduler/recovery.py)
RUNNING_TASK_CLEAR_FIELDS = {
    "running_task": "",
    "running_task_group": "",
    "running_task_build_variant": "",
    "running_task_version": "",
    "running_task_project": "",
    "running_task_group_order": 0,
}


def clear_running_task(store: Store, host_id: str, task_id: str, now: float) -> bool:
    """Clear assignment at task end, recording last-task affinity state
    (reference host.ClearRunningTask)."""
    c = coll(store)
    doc = c.get(host_id)
    if doc is None or doc.get("running_task") != task_id:
        return False
    return c.compare_and_set(
        host_id,
        expect={"running_task": task_id},
        update={
            **RUNNING_TASK_CLEAR_FIELDS,
            "last_task": task_id,
            "last_group": doc.get("running_task_group", ""),
            "last_build_variant": doc.get("running_task_build_variant", ""),
            "last_version": doc.get("running_task_version", ""),
            "last_project": doc.get("running_task_project", ""),
            "task_count": doc.get("task_count", 0) + 1,
            "last_communication_time": now,
        },
    )
