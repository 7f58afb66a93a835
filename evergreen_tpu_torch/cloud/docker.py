"""Docker provider + container pools.

A copy of ``evergreen_tpu/cloud/docker.py`` (reference cloud/docker.go +
config_containerpools.go:10-28): container distros run as containers on
parent hosts; each pool names a parent distro and a max-containers-per-
parent; parents needing more capacity are spawned as intents of the
parent distro (``ensure_parent_capacity``). The Docker daemon client is
the in-memory ``FakeDockerClient``, as in the JAX package; its container
id sequence is class-level (tests reset it with ``reset_default_client``
and a fresh ``_seq`` on both packages).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading

from ..utils import lockcheck as _lockcheck
import time as _time
from typing import Dict, List, Optional

from ..globals import HostStatus, Provider
from ..models import distro as distro_mod
from ..models import host as host_mod
from ..models.host import Host, new_intent
from ..storage.store import Store
from .manager import CloudHostStatus, CloudManager, register_manager

CONTAINER_POOLS_SECTION = "container_pools"


@dataclasses.dataclass
class ContainerPool:
    """reference config_containerpools.go ContainerPool."""

    id: str
    distro: str  # parent-host distro id
    max_containers: int = 1
    port: int = 0


def set_container_pools(store: Store, pools: List[ContainerPool]) -> None:
    store.collection("config").upsert(
        {
            "_id": CONTAINER_POOLS_SECTION,
            "pools": [dataclasses.asdict(p) for p in pools],
        }
    )


def get_container_pools(store: Store) -> Dict[str, ContainerPool]:
    doc = store.collection("config").get(CONTAINER_POOLS_SECTION)
    if doc is None:
        return {}
    return {p["id"]: ContainerPool(**p) for p in doc.get("pools", [])}


class FakeDockerClient:
    _seq = itertools.count(1)
    _lock = _lockcheck.make_lock("cloud.docker")

    def __init__(self) -> None:
        self.containers: Dict[str, dict] = {}

    def create_container(self, parent_host_id: str, image: str) -> str:
        with self._lock:
            cid = f"docker-{next(self._seq):08x}"
        self.containers[cid] = {
            "state": "running",
            "parent": parent_host_id,
            "image": image,
            "started_at": _time.time(),
        }
        return cid

    def get_container(self, cid: str) -> Optional[dict]:
        return self.containers.get(cid)

    def remove_container(self, cid: str) -> bool:
        c = self.containers.get(cid)
        if c is None:
            return False
        c["state"] = "removed"
        return True


_default_client: Optional[FakeDockerClient] = None


def default_client() -> FakeDockerClient:
    global _default_client
    if _default_client is None:
        _default_client = FakeDockerClient()
    return _default_client


def reset_default_client() -> None:
    global _default_client
    _default_client = None


class DockerManager(CloudManager):
    provider = Provider.DOCKER.value

    def __init__(self, client: Optional[FakeDockerClient] = None) -> None:
        self.client = client or default_client()

    def _find_parent(self, store: Store, host: Host) -> Optional[Host]:
        """Least-loaded running parent with spare container capacity
        (reference cloud/docker.go parent selection)."""
        d = distro_mod.get(store, host.distro_id)
        pools = get_container_pools(store)
        pool = pools.get(d.container_pool) if d else None
        if pool is None:
            return None
        parents = host_mod.find(
            store,
            lambda doc: doc["distro_id"] == pool.distro
            and doc["status"] == HostStatus.RUNNING.value
            and doc["has_containers"],
        )
        best, best_load = None, None
        for p in parents:
            load = host_mod.coll(store).count(
                lambda doc: doc.get("parent_id") == p.id
                and doc["status"]
                in (HostStatus.RUNNING.value, HostStatus.STARTING.value,
                    HostStatus.PROVISIONING.value)
            )
            if load < pool.max_containers and (best is None or load < best_load):
                best, best_load = p, load
        return best

    def spawn_host(self, store: Store, host: Host) -> None:
        parent = self._find_parent(store, host)
        if parent is None:
            # no capacity: leave the intent pending; ensure_parent_capacity
            # (the container-pool background job) will add parents
            return
        d = distro_mod.get(store, host.distro_id)
        image = (d.provider_settings or {}).get("image_url", "evg-task:latest")
        cid = self.client.create_container(parent.id, image)
        host_mod.coll(store).update(
            host.id,
            {
                "external_id": cid,
                "parent_id": parent.id,
                "container_pool_id": d.container_pool,
                "status": HostStatus.STARTING.value,
                "start_time": _time.time(),
            },
        )

    def get_instance_status(self, store: Store, host: Host) -> str:
        if not host.external_id:
            # still waiting for parent capacity: report initializing so the
            # intent isn't reaped as dead
            return CloudHostStatus.INITIALIZING
        c = self.client.get_container(host.external_id)
        if c is None:
            return CloudHostStatus.NONEXISTENT
        return (
            CloudHostStatus.RUNNING
            if c["state"] == "running"
            else CloudHostStatus.TERMINATED
        )

    def terminate_instance(self, store: Store, host: Host, reason: str) -> None:
        if host.external_id:
            self.client.remove_container(host.external_id)
        host_mod.coll(store).update(
            host.id,
            {
                "status": HostStatus.TERMINATED.value,
                "termination_time": _time.time(),
            },
        )


def ensure_parent_capacity(store: Store, now: Optional[float] = None) -> List[str]:
    """Spawn parent-host intents when container demand exceeds pool capacity
    (reference units/host_allocator.go container-pool handling +
    units/parent_decommission).  Returns new parent intent ids."""
    now = _time.time() if now is None else now
    pools = get_container_pools(store)
    created: List[str] = []
    for pool in pools.values():
        parent_distro = distro_mod.get(store, pool.distro)
        if parent_distro is None:
            continue
        # demand: container intents without a parent yet
        pending = host_mod.coll(store).count(
            lambda d: d["status"] == HostStatus.UNINITIALIZED.value
            and not d.get("parent_id")
            and _pool_of(store, pools, d.get("distro_id", "")) == pool.id
        )
        if not pending:
            continue
        parents = host_mod.find(
            store,
            lambda d: d["distro_id"] == pool.distro
            and d["status"]
            in (HostStatus.RUNNING.value, HostStatus.STARTING.value,
                HostStatus.UNINITIALIZED.value, HostStatus.PROVISIONING.value)
            and d["has_containers"],
        )
        capacity = sum(
            pool.max_containers
            - host_mod.coll(store).count(
                lambda d, _p=p: d.get("parent_id") == _p.id
                and d["status"] != HostStatus.TERMINATED.value
            )
            for p in parents
            if p.status == HostStatus.RUNNING.value
        ) + sum(
            pool.max_containers
            for p in parents
            if p.status != HostStatus.RUNNING.value
        )
        deficit = pending - capacity
        max_parents = parent_distro.host_allocator_settings.maximum_hosts or 1
        room = max_parents - len(parents)
        n_new = max(0, min(deficit + pool.max_containers - 1, room * pool.max_containers))
        n_parents = min((n_new + pool.max_containers - 1) // pool.max_containers, room)
        for _ in range(n_parents):
            intent = new_intent(pool.distro, parent_distro.provider)
            intent.has_containers = True
            host_mod.insert(store, intent)
            created.append(intent.id)
    return created


def _pool_of(store: Store, pools: Dict[str, ContainerPool], distro_id: str) -> str:
    d = distro_mod.get(store, distro_id)
    return d.container_pool if d else ""


register_manager(Provider.DOCKER.value, DockerManager)
