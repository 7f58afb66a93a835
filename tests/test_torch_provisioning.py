"""The provisioning plane through the port against the JAX package, on the
CPU: user data, the providers, create → provision → running, the
failure and poison accounting, the agent keep-alive and the
reprovisioning transitions.

Each scenario seeds the same documents into each package's store and
runs the same calls with that package's modules (``run_both``). Host ids
and secrets come from ``uuid.uuid4`` and times from ``time.time``: each
package's run draws the same seeded uuid4 stream, reads the same pinned
clock and restarts its event sequence at 0, with its providers' state
reset (the mock cloud table, the docker and EC2 fake clients and their
id sequences, the injected transport). Compared exactly, with nothing
masked: the scenario's return values and every document of ``DOCS``.
User data is compared as the bytes the provider receives.
"""
import itertools
import random
import time
import types
import uuid

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import evergreen_tpu.cloud  # noqa: E402,F401
from evergreen_tpu.cloud import docker as j_docker  # noqa: E402
from evergreen_tpu.cloud import ec2_fleet as j_ec2  # noqa: E402
from evergreen_tpu.cloud import manager as j_manager  # noqa: E402
from evergreen_tpu.cloud import mock as j_mock  # noqa: E402
from evergreen_tpu.cloud import provisioning as j_prov  # noqa: E402
from evergreen_tpu.cloud import spawnhost as j_spawnhost  # noqa: E402
from evergreen_tpu.cloud import static as j_static  # noqa: E402
from evergreen_tpu.cloud import userdata as j_userdata  # noqa: E402
from evergreen_tpu.cloud import volumes as j_volumes  # noqa: E402
from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.models import event as j_event  # noqa: E402
from evergreen_tpu.models import host as j_host  # noqa: E402
from evergreen_tpu.models import taskstats as j_taskstats  # noqa: E402
from evergreen_tpu.models.distro import (  # noqa: E402
    BootstrapSettings,
    Distro,
    HostAllocatorSettings,
)
from evergreen_tpu.models.host import Host  # noqa: E402
from evergreen_tpu.models.task import Task  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.units import host_jobs as j_host_jobs  # noqa: E402
from evergreen_tpu.units import task_jobs as j_task_jobs  # noqa: E402
from evergreen_tpu.utils import faults as j_faults  # noqa: E402

import evergreen_tpu_torch.cloud  # noqa: E402,F401
from evergreen_tpu_torch.cloud import docker as t_docker  # noqa: E402
from evergreen_tpu_torch.cloud import ec2_fleet as t_ec2  # noqa: E402
from evergreen_tpu_torch.cloud import manager as t_manager  # noqa: E402
from evergreen_tpu_torch.cloud import mock as t_mock  # noqa: E402
from evergreen_tpu_torch.cloud import provisioning as t_prov  # noqa: E402
from evergreen_tpu_torch.cloud import spawnhost as t_spawnhost  # noqa: E402
from evergreen_tpu_torch.cloud import static as t_static  # noqa: E402
from evergreen_tpu_torch.cloud import userdata as t_userdata  # noqa: E402
from evergreen_tpu_torch.cloud import volumes as t_volumes  # noqa: E402
from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.models import event as t_event  # noqa: E402
from evergreen_tpu_torch.models import host as t_host  # noqa: E402
from evergreen_tpu_torch.models import taskstats as t_taskstats  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.units import host_jobs as t_host_jobs  # noqa: E402
from evergreen_tpu_torch.units import task_jobs as t_task_jobs  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402

NOW = 1_700_000_000.0
#: every collection the provisioning plane and the monitors write
DOCS = ("hosts", "events", "distros", "tasks", "config", "host_stats", "task_stats",
        "task_archives", "sleep_schedules", "system_stats", "users")

PKG = {
    "jax": types.SimpleNamespace(
        name="jax", store=j_store, prov=j_prov, userdata=j_userdata, mock=j_mock,
        docker=j_docker, ec2=j_ec2, static=j_static, manager=j_manager,
        spawnhost=j_spawnhost, volumes=j_volumes, host=j_host, event=j_event,
        settings=j_settings, faults=j_faults, host_jobs=j_host_jobs,
        task_jobs=j_task_jobs, taskstats=j_taskstats),
    "port": types.SimpleNamespace(
        name="port", store=t_store, prov=t_prov, userdata=t_userdata, mock=t_mock,
        docker=t_docker, ec2=t_ec2, static=t_static, manager=t_manager,
        spawnhost=t_spawnhost, volumes=t_volumes, host=t_host, event=t_event,
        settings=t_settings, faults=t_faults, host_jobs=t_host_jobs,
        task_jobs=t_task_jobs, taskstats=t_taskstats),
}


def reset_cloud(m) -> None:
    """A package's process-wide provider state, as a fresh process has it."""
    m.mock.MockCloudManager.reset()
    m.docker.reset_default_client()
    m.docker.FakeDockerClient._seq = itertools.count(1)
    m.ec2.reset_default_client()
    m.ec2.FakeEC2Client._seq = itertools.count(1)
    m.prov.set_transport(None)
    m.faults.uninstall()


class World:
    """The pinned clock, and ``run_both``: one scenario on each package."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.now = NOW
        monkeypatch.setattr(time, "time", lambda: self.now)

    def restart(self, m) -> None:
        self.now = NOW
        rng = random.Random(20251017)
        self.monkeypatch.setattr(uuid, "uuid4",
                                 lambda: uuid.UUID(int=rng.getrandbits(128)))
        self.monkeypatch.setattr(m.event, "_SEQ", itertools.count())
        reset_cloud(m)

    def run_both(self, docs, scenario, names=DOCS, masks=None):
        """``scenario(m, store)`` on a store of each package seeded with
        ``docs``; asserts the results and the documents equal (without
        the fields ``masks`` names by collection), returns the port's
        (result, documents)."""
        masks = masks or {}
        got = {}
        for name, m in PKG.items():
            self.restart(m)
            store = m.store.Store()
            for coll, ds in docs.items():
                store.collection(coll).insert_many([dict(d) for d in ds])
            try:
                result = scenario(m, store)
            finally:
                reset_cloud(m)
            got[name] = (result, {
                n: [{k: v for k, v in d.items() if k not in masks.get(n, ())}
                    for d in store.collection(n).find()] for n in names})
        for n in names:
            assert got["port"][1][n] == got["jax"][1][n], n
        assert got["port"][0] == got["jax"][0]
        return got["port"]


@pytest.fixture
def world(monkeypatch):
    w = World(monkeypatch)
    yield w
    for m in PKG.values():
        reset_cloud(m)


def distro(did, provider="mock", method="legacy-ssh", **kw):
    return Distro(id=did, provider=provider,
                  bootstrap_settings=BootstrapSettings(method=method), **kw).to_doc()


def intents(did, provider, n, **kw):
    return [Host(id=f"evg-{did}-{k:03d}", distro_id=did, provider=provider,
                 status="initializing", secret=f"s{k:030d}", creation_time=NOW,
                 **kw).to_doc()
            for k in range(n)]


# --------------------------------------------------------------------------- #
# user data: the bytes on the wire
# --------------------------------------------------------------------------- #

USER_DATA_CASES = {
    "linux": dict(arch="linux_amd64", setup="apt-get install -y git", custom=""),
    "linux-no-setup": dict(arch="linux_arm64", setup="", custom=""),
    "shell-custom": dict(arch="linux_amd64", setup="make deps",
                         custom="#!/bin/bash\necho custom first\n"),
    "cloud-config": dict(arch="linux_amd64", setup="",
                         custom="#cloud-config\npackages:\n  - jq\n"),
    "windows": dict(arch="windows_amd64", setup="choco install git", custom=""),
    "windows-custom": dict(arch="windows_amd64", setup="",
                           custom="<powershell>\nWrite-Host hi\n</powershell>"),
    "windows-shell-custom": dict(arch="windows_amd64", setup="",
                                 custom="#!/bin/sh\necho mixed\n"),
    "batch": dict(arch="windows_amd64", setup="",
                  custom="<script>\necho batch\n</script>\n"),
}


@pytest.mark.parametrize("case", sorted(USER_DATA_CASES))
@pytest.mark.parametrize("keys", [(), ("ssh-ed25519 AAAA owner@laptop",)],
                         ids=["no-keys", "keys"])
def test_user_data_is_byte_equal_to_jax(case, keys):
    c = USER_DATA_CASES[case]
    d = Distro(id="d1", arch=c["arch"], setup=c["setup"], work_dir="/data/evg",
               provider_settings={"user_data": c["custom"]} if c["custom"] else {})
    h = Host(id="evg-d1-abc", distro_id="d1", secret="0123abcd")
    got = {}
    for name, m in PKG.items():
        out = m.userdata.for_host(d, h, "https://ci.example:9090", authorized_keys=list(keys))
        part = m.userdata.provisioning_script(d, h, "https://ci.example:9090").render()
        parsed = m.userdata.parse(c["custom"]) if c["custom"] else None
        got[name] = (out.encode(), part.encode(),
                     (parsed.directive, parsed.content, parsed.persist) if parsed else None)
    assert got["port"] == got["jax"]


def test_malformed_custom_user_data_falls_back_like_jax(world):
    docs = {"distros": [distro("d1", method="user-data",
                               provider_settings={"user_data": "no directive"})],
            "hosts": intents("d1", "mock", 2)}
    world.run_both(docs, lambda m, s: m.prov.create_hosts_from_intents(s, NOW))


# --------------------------------------------------------------------------- #
# create → provision → running, by bootstrap method
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", ["legacy-ssh", "ssh", "user-data",
                                    "preconfigured-image"])
def test_create_provision_running_matches_jax(method, world):
    docs = {"distros": [distro("d1", method=method, setup="echo setup")],
            "hosts": intents("d1", "mock", 3),
            "config": [{"_id": "api", "url": "https://ci.example"}]}

    def scenario(m, store):
        transport = m.prov.FakeTransport()
        m.prov.set_transport(transport)
        m.mock.MockCloudManager.reset(instant_up=False)
        steps = [m.prov.create_hosts_from_intents(store, NOW),
                 m.prov.provision_ready_hosts(store, NOW)]  # still starting
        m.mock.MockCloudManager.advance()
        steps.append(m.prov.provision_ready_hosts(store, NOW + 1))
        if method == "user-data":
            # the host phones home; one never does and times out
            steps.append(m.prov.mark_provisioning_done(store, "evg-d1-000", NOW + 2))
            steps.append(m.prov.provision_ready_hosts(
                store, NOW + 2 + m.prov.USER_DATA_DONE_TIMEOUT_S))  # re-stamps
            steps.append(m.prov.provision_ready_hosts(
                store, NOW + 3 + 2 * m.prov.USER_DATA_DONE_TIMEOUT_S))
        return steps, transport.scripts

    (steps, scripts), found = world.run_both(docs, scenario)
    statuses = {h["_id"]: h["status"] for h in found["hosts"]}
    if method == "user-data":
        assert statuses["evg-d1-000"] == "running"
        # poisoned: provision failed, then the provider terminated it
        assert "terminated" in statuses.values()
        assert any(e["event_type"] == "HOST_PROVISION_FAILED" for e in found["events"])
        assert all("user_data" in h and h["user_data"] for h in found["hosts"])
    else:
        assert set(statuses.values()) == {"running"}
    assert bool(scripts) == (method in ("legacy-ssh", "ssh"))


def test_spawn_failure_is_charged_then_poisoned_like_jax(world):
    docs = {"distros": [distro("d1")], "hosts": intents("d1", "mock", 2)}

    def scenario(m, store):
        plan = m.faults.FaultPlan().always("cloud.spawn", m.faults.Fault("raise"))
        out = []
        for k in range(m.prov.MAX_PROVISION_ATTEMPTS):
            m.faults.install(plan)
            try:
                out.append(m.prov.create_hosts_from_intents(store, NOW + k))
            finally:
                m.faults.uninstall()
        return out

    _, found = world.run_both(docs, scenario)
    assert {h["status"] for h in found["hosts"]} == {"terminated"}
    assert sum(e["event_type"] == "HOST_PROVISION_FAILED" for e in found["events"]) == 2
    assert sum(e["event_type"] == "HOST_SPAWN_FAILED" for e in found["events"]) == 6


def test_deploy_retries_then_poisons_on_fake_transport_like_jax(world):
    docs = {"distros": [distro("d1", method="ssh")], "hosts": intents("d1", "mock", 2)}

    def scenario(m, store):
        transport = m.prov.FakeTransport()
        transport.fail_next("evg-d1-000", m.prov.MAX_AGENT_DEPLOY_ATTEMPTS)
        transport.fail_next("evg-d1-001", 2)
        m.prov.set_transport(transport)
        m.prov.create_hosts_from_intents(store, NOW)
        return [m.prov.provision_ready_hosts(store, NOW + k)
                for k in range(m.prov.MAX_AGENT_DEPLOY_ATTEMPTS)]

    _, found = world.run_both(docs, scenario)
    statuses = {h["_id"]: h["status"] for h in found["hosts"]}
    assert statuses == {"evg-d1-000": "terminated", "evg-d1-001": "running"}


def test_keepalive_and_reprovisioning_match_jax(world):
    hosts = [Host(id=f"h{k}", distro_id="d1", provider="mock", status="running",
                  started_by="mci", external_id=f"mock-h{k}", bootstrap_method="legacy-ssh",
                  last_communication_time=NOW - 3600.0 * (k % 2), secret=f"s{k}",
                  running_task="t0" if k == 3 else "").to_doc()
             for k in range(4)]
    docs = {"distros": [distro("d1", method="legacy-ssh")], "hosts": hosts}

    def scenario(m, store):
        transport = m.prov.FakeTransport()
        transport.fail_next("h2", 1)
        m.prov.set_transport(transport)
        out = [m.prov.agent_keepalive(store, NOW)]
        # the distro moves to user data: every up host needs converting;
        # a restart request survives the mark pass
        d = store.collection("distros").get("d1")
        store.collection("distros").update(
            "d1", {"bootstrap_settings": dict(d["bootstrap_settings"], method="user-data")})
        out.append(m.prov.request_agent_restart(store, "h0", NOW))
        out.append(m.prov.mark_hosts_needing_reprovision(store, NOW))
        out.append(m.prov.reprovision_hosts(store, NOW + 1))
        out.append(m.prov.reprovision_hosts(store, NOW + 2))
        return out, [s[0] for s in transport.scripts]

    world.run_both(docs, scenario)


# --------------------------------------------------------------------------- #
# the providers
# --------------------------------------------------------------------------- #


def test_static_pass_matches_jax(world):
    d = distro("ds", provider="static",
               provider_settings={"hosts": [{"name": "10.0.0.1"}, "10.0.0.2"]})
    docs = {"distros": [d, distro("d1")]}

    def scenario(m, store):
        out = [m.static.update_all_static_distros(store, NOW)]
        store.collection("distros").update(
            "ds", {"provider_settings": {"hosts": ["10.0.0.1"]},
                   "bootstrap_settings": dict(d["bootstrap_settings"], method="ssh")})
        out.append(m.static.update_all_static_distros(store, NOW + 1))
        mgr = m.manager.get_manager("static")
        h = m.host.get(store, "static-ds-10.0.0.1")
        out.append(mgr.get_instance_status(store, h))
        mgr.terminate_instance(store, h, "gone")
        return out

    world.run_both(docs, scenario)


def test_docker_pass_and_spawn_match_jax(world):
    docs = {
        "distros": [distro("d-parent", host_allocator_settings=HostAllocatorSettings(
                        maximum_hosts=2)),
                    distro("d-c", provider="docker", container_pool="pool1",
                           provider_settings={"image_url": "ci-image:1"})],
        "hosts": intents("d-c", "docker", 3),
    }

    def scenario(m, store):
        m.docker.set_container_pools(
            store, [m.docker.ContainerPool(id="pool1", distro="d-parent", max_containers=2)])
        out = [m.docker.ensure_parent_capacity(store, NOW)]
        for k in range(3):
            out.append(m.prov.create_hosts_from_intents(store, NOW + k))
            out.append(m.prov.provision_ready_hosts(store, NOW + k))
        mgr = m.manager.get_manager("docker")
        out.append([mgr.get_instance_status(store, h) for h in m.host.find(store)])
        out.append(sorted(m.docker.default_client().containers))
        return out

    _, found = world.run_both(docs, scenario)
    assert sum(h["provider"] == "docker" and h["status"] == "running"
               for h in found["hosts"]) == 3


def test_ec2_fleet_spawn_matches_jax(world):
    docs = {"distros": [distro("d-ec2", provider="ec2-fleet", method="user-data",
                               provider_settings={"instance_type": "c5.xlarge",
                                                  "fleet_use_spot": False, "az": "us-east-1b"}),
                        distro("d-od", provider="ec2-ondemand")],
            "hosts": intents("d-ec2", "ec2-fleet", 2) + intents("d-od", "ec2-ondemand", 1)}

    def scenario(m, store):
        out = [m.prov.create_hosts_from_intents(store, NOW),
               m.prov.provision_ready_hosts(store, NOW),
               m.prov.mark_provisioning_done(store, "evg-d-ec2-000", NOW + 1)]
        client = m.ec2.default_client()
        mgr = m.manager.get_manager("ec2-fleet")
        h = m.host.get(store, "evg-d-ec2-001")
        out.append(mgr.get_dns_name(store, h))
        mgr.stop_instance(store, h)
        mgr.start_instance(store, m.host.get(store, "evg-d-ec2-001"))
        out.append([(r["instance_type"], r["spot"], r["user_data"].encode())
                    for r in client.fleet_requests])
        return out

    world.run_both(docs, scenario)


def test_every_jax_provider_is_registered():
    assert sorted(t_manager._REGISTRY) == sorted(j_manager._REGISTRY)
    for p in j_manager._REGISTRY:
        assert type(t_manager.get_manager(p)).__name__ == type(
            j_manager.get_manager(p)).__name__


def test_transport_from_the_ssh_section_matches_jax(world):
    got = {}
    for name, m in PKG.items():
        store = m.store.Store()
        first = type(m.prov.get_transport(store)).__name__
        m.settings.SshConfig(task_host_key_path="/keys/id", user="evg",
                             options=["StrictHostKeyChecking=no"]).set(store)
        t = m.prov.transport_from_config(store)
        got[name] = (first, type(t).__name__, t.user, t.key_path, t.options,
                     t.connect_timeout_s, t.script_timeout_s)
    assert got["port"] == got["jax"]
