"""Distro document + tunable scheduler settings.

A copy of ``evergreen_tpu/models/distro.py``: the same dataclasses (field
for field, ``tests/test_torch_layout.py`` holds them equal) and the store
functions the tick's gather calls. The planner/allocator settings become
rows of the packed solve's settings matrix (``scheduler/snapshot.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..globals import (
    EPHEMERAL_PROVIDERS,
    MAX_DURATION_PER_DISTRO_HOST_S,
    DispatcherVersion,
    FeedbackRule,
    FinderVersion,
    OverallocatedRule,
    PlannerVersion,
    Provider,
    RoundingRule,
)
from ..storage.store import Collection, Store

COLLECTION = "distros"


@dataclasses.dataclass
class PlannerSettings:
    """Reference model/distro/distro.go:286-300. Defaults follow the
    reference's resolved defaults (GetPatchFactor et al. fall back to the
    global scheduler config; we bake the commonly-deployed defaults)."""

    version: str = PlannerVersion.TPU.value
    #: host-capacity allocator: "" = the per-distro utilization
    #: heuristic; "tpu" = the joint capacity program over
    #: (distros × provider pools) — ops/capacity.py via
    #: scheduler/capacity_plane.py, breaker-guarded with the heuristic
    #: as its fallback
    capacity: str = ""
    target_time_s: float = 0.0  # 0 → use MAX_DURATION_PER_DISTRO_HOST_S
    group_versions: bool = False
    patch_factor: int = 0
    patch_time_in_queue_factor: int = 0
    commit_queue_factor: int = 0
    mainline_time_in_queue_factor: int = 0
    expected_runtime_factor: int = 0
    generate_task_factor: int = 0
    num_dependents_factor: float = 0.0
    stepback_task_factor: int = 0

    def max_duration_per_host_s(self) -> float:
        return self.target_time_s if self.target_time_s > 0 else float(
            MAX_DURATION_PER_DISTRO_HOST_S
        )


@dataclasses.dataclass
class HostAllocatorSettings:
    """Reference model/distro/distro.go:267-280."""

    version: str = "utilization"
    minimum_hosts: int = 0
    maximum_hosts: int = 0
    auto_tune_maximum_hosts: bool = False
    rounding_rule: str = RoundingRule.DOWN.value
    feedback_rule: str = FeedbackRule.WAITS_OVER_THRESH.value
    hosts_overallocated_rule: str = OverallocatedRule.DEFAULT.value
    acceptable_host_idle_time_s: float = 0.0
    future_host_fraction: float = 0.5


@dataclasses.dataclass
class BootstrapSettings:
    """How a host of this distro acquires a running agent (reference
    model/distro/distro.go BootstrapSettings: method + communication).

    - ``legacy-ssh``/``ssh``: the server pushes the agent over a host
      transport (agent-deploy job) and re-pushes it when it goes silent.
    - ``user-data``: the host self-provisions from generated user data
      (cloud/userdata.py) and phones home; the agent monitor keeps the
      agent alive locally.
    - ``preconfigured-image``: the image already runs an agent monitor;
      no provisioning step beyond the cloud instance coming up.
    """

    METHOD_LEGACY_SSH = "legacy-ssh"
    METHOD_SSH = "ssh"
    METHOD_USER_DATA = "user-data"
    METHOD_PRECONFIGURED = "preconfigured-image"

    method: str = "legacy-ssh"
    communication: str = "legacy-ssh"
    env: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DispatcherSettings:
    version: str = DispatcherVersion.REVISED_WITH_DEPENDENCIES.value


@dataclasses.dataclass
class FinderSettings:
    version: str = FinderVersion.PIPELINE.value


@dataclasses.dataclass
class Distro:
    id: str
    provider: str = Provider.MOCK.value
    arch: str = "linux_amd64"
    work_dir: str = "/data/evg"
    user: str = "evg-user"
    disabled: bool = False
    container_pool: str = ""
    aliases: List[str] = dataclasses.field(default_factory=list)
    setup: str = ""
    provider_settings: dict = dataclasses.field(default_factory=dict)
    planner_settings: PlannerSettings = dataclasses.field(
        default_factory=PlannerSettings
    )
    host_allocator_settings: HostAllocatorSettings = dataclasses.field(
        default_factory=HostAllocatorSettings
    )
    dispatcher_settings: DispatcherSettings = dataclasses.field(
        default_factory=DispatcherSettings
    )
    finder_settings: FinderSettings = dataclasses.field(default_factory=FinderSettings)
    bootstrap_settings: BootstrapSettings = dataclasses.field(
        default_factory=BootstrapSettings
    )
    single_task_distro: bool = False

    def is_ephemeral(self) -> bool:
        return self.provider in EPHEMERAL_PROVIDERS

    def to_doc(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["_id"] = doc.pop("id")
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "Distro":
        doc = dict(doc)
        doc["id"] = doc.pop("_id")
        for key, sub in (
            ("planner_settings", PlannerSettings),
            ("host_allocator_settings", HostAllocatorSettings),
            ("dispatcher_settings", DispatcherSettings),
            ("finder_settings", FinderSettings),
            ("bootstrap_settings", BootstrapSettings),
        ):
            if isinstance(doc.get(key), dict):
                doc[key] = sub(**doc[key])
        known = _DISTRO_FIELDS  # fields() per doc is hot-loop cost
        return cls(**{k: v for k, v in doc.items() if k in known})


_DISTRO_FIELDS = frozenset(f.name for f in dataclasses.fields(Distro))


def coll(store: Store) -> Collection:
    return store.collection(COLLECTION)


def insert(store: Store, d: Distro) -> None:
    coll(store).insert(d.to_doc())


def upsert(store: Store, d: Distro) -> None:
    coll(store).upsert(d.to_doc())


def get(store: Store, distro_id: str) -> Optional[Distro]:
    doc = coll(store).get(distro_id)
    return Distro.from_doc(doc) if doc else None


def find_all(store: Store) -> List[Distro]:
    return [Distro.from_doc(d) for d in coll(store).find()]


def _pool_parent_ids(store: Store) -> set:
    """Distro ids that serve as container-pool PARENT hosts — these are
    managed by the pool-capacity logic, not the normal scheduler/allocator
    fan-out (reference ByNeedsPlanning's $nin over
    config.ContainerPools.Pools[*].Distro, model/distro/db.go:199-212).
    Container distros themselves ARE planned and allocated."""
    doc = store.collection("config").get("container_pools")
    if not doc:
        return set()
    return {p.get("distro", "") for p in doc.get("pools", [])}


def find_needs_planning(store: Store) -> List[Distro]:
    """Distros whose task queues get planned: non-disabled ones, plus static
    distros even when disabled (reference distro.ByNeedsPlanning,
    model/distro/db.go:198-212)."""
    parents = _pool_parent_ids(store)
    return [
        d
        for d in find_all(store)
        if (not d.disabled or d.provider == Provider.STATIC.value)
        and d.id not in parents
    ]


def find_needs_hosts_planning(store: Store) -> List[Distro]:
    """Distros the host allocator runs for: everything except container-pool
    parent distros, including disabled ones — disabled distros still
    maintain their minimum hosts (reference distro.ByNeedsHostsPlanning,
    model/distro/db.go:214-224, and the disabled branch of
    UtilizationBasedHostAllocator :51-67)."""
    parents = _pool_parent_ids(store)
    return [d for d in find_all(store) if d.id not in parents]
