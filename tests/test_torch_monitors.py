"""The job plane's monitors through the port against the JAX package, on
the CPU: the host monitors (cloud-state reconciliation stranding a task,
idle termination down to the distro minimum, stale building hosts,
drawdown, max-hosts auto-tuning from host stats), the heartbeat monitor
with its reset and its system-failed case, task-stats rollups and
stamping, both samplers, spawn-host expiry and sleep schedules.

The harness is ``test_torch_provisioning.World``: the same documents in
each package's store, the same calls with that package's modules, one
pinned clock and uuid4 stream, event ids from 0, providers reset.
Compared exactly: the return values and every document the monitors
write. Masked: a system-stats sample's process readings (``max_rss_kb``,
``cpu_user_s``: the resource usage of this process when each package
sampled it).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.models.distro import HostAllocatorSettings  # noqa: E402
from evergreen_tpu.models.host import Host  # noqa: E402
from evergreen_tpu.models.task import Task  # noqa: E402

from test_torch_provisioning import NOW, distro, intents, world  # noqa: E402,F401

SYSTEM_MASK = {"system_stats": ("max_rss_kb", "cpu_user_s")}


def host(hid, did="d1", **kw):
    base = dict(distro_id=did, provider="mock", status="running", started_by="mci",
                external_id=f"mock-{hid}", secret=f"s-{hid}", creation_time=NOW - 7200.0,
                provision_time=NOW - 7000.0)
    base.update(kw)
    return Host(id=hid, **base).to_doc()


def task(tid, did="d1", **kw):
    base = dict(distro_id=did, project="p", build_variant="bv", display_name=tid,
                version="v1", activated=True, status="undispatched",
                expected_duration_s=600.0)
    base.update(kw)
    return Task(id=tid, **base).to_doc()


def cloud(m, table):
    """Install the mock provider's cloud truth."""
    m.mock.MockCloudManager.instances = dict(table)


def test_cloud_state_reconciliation_strands_a_task_like_jax(world):
    docs = {
        "distros": [distro("d1")],
        "hosts": [host("h0", running_task="t0"), host("h1", spot=True),
                  host("h2", running_task="t2"), host("h3", external_id=""),
                  host("h4", status="starting")],
        "tasks": [task("t0", status="started", host_id="h0", dispatch_time=NOW - 60,
                       start_time=NOW - 50, last_heartbeat=NOW - 10),
                  task("t2", status="started", host_id="h2", dispatch_time=NOW - 60,
                       start_time=NOW - 50, last_heartbeat=NOW - 10,
                       num_automatic_restarts=3)],
    }

    def scenario(m, store):
        cloud(m, {"mock-h0": "terminated", "mock-h1": "stopped", "mock-h2": "terminated",
                  "mock-h4": "running"})
        return m.host_jobs.monitor_host_cloud_state(store, NOW)

    changed, found = world.run_both(docs, scenario)
    assert changed == ["h0", "h1", "h2", "h3"]
    status = {t["_id"]: t["status"] for t in found["tasks"]}
    assert status == {"t0": "undispatched", "t2": "failed"}


def test_idle_termination_stops_at_the_minimum_like_jax(world):
    d = distro("d1", host_allocator_settings=HostAllocatorSettings(
        minimum_hosts=2, acceptable_host_idle_time_s=600.0))
    docs = {
        "distros": [d, distro("ds", provider="static")],
        "hosts": [host(f"h{k}", last_communication_time=NOW - 1000.0 * k,
                       creation_time=NOW - 7200.0 + k) for k in range(6)]
        + [host("h9", running_task="t9", last_communication_time=NOW - 9000.0),
           host("s0", did="ds", provider="static", last_communication_time=0.0)],
    }

    def scenario(m, store):
        cloud(m, {f"mock-h{k}": "running" for k in range(10)})
        return m.host_jobs.terminate_idle_hosts(store, NOW)

    reaped, found = world.run_both(docs, scenario)
    assert reaped == ["h1", "h2", "h3", "h4", "h5"]


def test_stale_building_hosts_like_jax(world):
    docs = {"distros": [distro("d1")],
            "hosts": [host("b0", status="building", start_time=NOW - 3600.0),
                      host("b1", status="provisioning", start_time=NOW - 60.0),
                      host("b2", status="starting", start_time=0.0, creation_time=0.0),
                      host("b3", status="building", start_time=NOW - 901.0)]}

    def scenario(m, store):
        cloud(m, {"mock-b0": "starting", "mock-b3": "starting"})
        first = m.host_jobs.reap_stale_building_hosts(store, NOW)
        # b2's clock started at first observation: stale one window later
        later = m.host_jobs.reap_stale_building_hosts(store, NOW + 15 * 60.0 + 1)
        return first, later

    (first, later), _ = world.run_both(docs, scenario)
    assert first == ["b0", "b3"] and later == ["b1", "b2"]


def test_drawdown_like_jax(world):
    d = distro("d1", host_allocator_settings=HostAllocatorSettings(
        minimum_hosts=1, hosts_overallocated_rule="terminate-hosts-when-overallocated"))
    docs = {"distros": [d, distro("d2")],
            "hosts": [host(f"h{k}", creation_time=NOW - 100.0 * k) for k in range(4)]
            + [host("h9", running_task="t9"), host("x0", did="d2")]}

    def scenario(m, store):
        cloud(m, {})
        return m.host_jobs.host_drawdown(store, NOW)

    reaped, _ = world.run_both(docs, scenario)
    # five hosts, no demand, a minimum of 1: the four free ones, oldest first
    assert reaped == ["h3", "h2", "h1", "h0"]


def test_auto_tune_from_host_stats_like_jax(world):
    tuned = distro("d1", host_allocator_settings=HostAllocatorSettings(
        maximum_hosts=50, auto_tune_maximum_hosts=True, minimum_hosts=1))
    docs = {"distros": [tuned, distro("d2")],
            "hosts": [host(f"h{k}", running_task=f"t{k}" if k < 3 else "") for k in range(5)]
            + [host("x0", did="d2", running_task="tx")]}

    def scenario(m, store):
        out = []
        for k in range(3):
            out.append(m.host_jobs.sample_host_stats(store, NOW - 3600.0 * k))
        store.collection("hosts").update("h4", {"running_task": "t4"})
        m.host_jobs.sample_host_stats(store, NOW + 1)
        out.append(m.host_jobs.auto_tune_distro_max_hosts(store, NOW + 2))
        out.append(m.host_jobs.auto_tune_distro_max_hosts(store, NOW + 3))
        return out

    out, found = world.run_both(docs, scenario)
    assert out[-2] == ["d1"] and out[-1] == []
    assert found["distros"][0]["host_allocator_settings"]["maximum_hosts"] == 6


def test_heartbeat_monitor_resets_and_system_fails_like_jax(world):
    docs = {
        "distros": [distro("d1")],
        "hosts": [host("h0", running_task="t0"), host("h1", running_task="t1"),
                  host("h2", running_task="tx")],
        "tasks": [task("t0", status="started", host_id="h0", dispatch_time=NOW - 3600,
                       start_time=NOW - 3500, last_heartbeat=NOW - 1000),
                  task("t1", status="dispatched", host_id="h1", dispatch_time=NOW - 900,
                       num_automatic_restarts=3),
                  task("t2", status="started", host_id="h2", dispatch_time=NOW - 900,
                       last_heartbeat=NOW - 30),
                  task("t3", status="dispatched", host_id="", dispatch_time=NOW - 9000)],
    }

    def scenario(m, store):
        reaped = m.task_jobs.monitor_stale_heartbeats(store, NOW)
        return reaped, m.task_jobs.get_task_execution_archive(store, "t0"), \
            m.task_jobs.abort_task(store, "t2", by="admin", now=NOW + 1)

    (reaped, archive, aborted), found = world.run_both(docs, scenario)
    assert reaped == ["t0", "t1", "t3"] and aborted
    status = {t["_id"]: t["status"] for t in found["tasks"]}
    assert status == {"t0": "undispatched", "t1": "failed", "t2": "started",
                      "t3": "undispatched"}
    assert archive[0]["status"] == "failed"


def test_taskstats_rollup_and_stamping_like_jax(world):
    done = [task(f"d{k}", status="success", start_time=NOW - 5000 + k,
                 finish_time=NOW - 4000 + 37 * k, display_name="compile")
            for k in range(5)]
    old = [task("old", status="success", start_time=NOW - 30 * 86400,
                finish_time=NOW - 29 * 86400, display_name="compile")]
    fresh = [task(f"n{k}", display_name=name, expected_duration_s=0.0)
             for k, name in enumerate(("compile", "lint"))]
    docs = {"tasks": done + old + fresh}

    def scenario(m, store):
        n = m.taskstats.cache_historical_task_data(store, NOW)
        roll = m.taskstats.get_rollup(store, "p", "bv", "compile")
        tasks = [m.taskstats.task_mod.Task.from_doc(store.collection("tasks").get(f"n{k}"))
                 for k in range(2)]
        stamped = m.taskstats.stamp_expected_durations(store, tasks)
        return n, (roll.average_s, roll.std_dev_s, roll.count), stamped, \
            [(t.expected_duration_s, t.duration_std_dev_s) for t in tasks], \
            m.taskstats.get_rollup(store, "p", "bv", "lint")

    (n, roll, stamped, durations, missing), _ = world.run_both(docs, scenario)
    assert n == 1 and roll[2] == 5 and stamped == 1 and missing is None


def test_samplers_like_jax(world):
    docs = {"distros": [distro("d1"), distro("d2")],
            "hosts": [host("h0", running_task="t0"), host("h1"), host("x0", did="d2")],
            "tasks": [task("t0", status="started", host_id="h0"), task("t1"),
                      task("t2", status="success")],
            "task_queues": [{"_id": "d1", "distro_id": "d1", "generated_at": NOW - 30.0,
                             "cols": {"id": ["t1"]}}],
            "jobs": [{"_id": "j0", "status": "pending"}, {"_id": "j1", "status": "failed"}]}

    def scenario(m, store):
        m.host_jobs.sample_host_stats(store, NOW)
        sample = m.task_jobs.sample_system_stats(store, NOW)
        return {k: v for k, v in sample.items() if k not in SYSTEM_MASK["system_stats"]}

    sample, found = world.run_both(docs, scenario, masks=SYSTEM_MASK)
    assert sample["tasks_by_status"] == {"started": 1, "undispatched": 1, "success": 1}
    assert sample["jobs_pending"] == 1 and sample["jobs_failed"] == 1
    assert len(found["host_stats"]) == 2


def test_spawn_host_expiry_and_sleep_schedules_like_jax(world):
    day = 86400.0
    midnight = NOW - NOW % day
    docs = {
        "distros": [distro("ws")],
        "hosts": [host("sp0", did="ws", user_host=True, started_by="ann",
                       expiration_time=midnight - 1.0),
                  host("sp1", did="ws", user_host=True, started_by="ann",
                       expiration_time=midnight + 10 * day),
                  host("sp2", did="ws", user_host=True, started_by="bob",
                       no_expiration=True),
                  host("sp3", did="ws", user_host=True, started_by="bob",
                       no_expiration=True, status="stopped"),
                  host("sp4", did="ws", user_host=True, started_by="cat",
                       no_expiration=True, provider="gone")],
    }

    def scenario(m, store):
        cloud(m, {f"mock-sp{k}": "running" for k in range(4)})
        for hid, stop, start in (("sp2", 22, 8), ("sp3", 1, 5), ("sp4", 22, 8)):
            m.volumes.set_sleep_schedule(store, m.volumes.SleepSchedule(
                host_id=hid, stop_hour_utc=stop, start_hour_utc=start))
        out = [m.spawnhost.expire_spawn_hosts(store, midnight + 3600.0)]
        out.append(m.volumes.enforce_sleep_schedules(store, midnight + 23 * 3600.0))
        out.append(m.volumes.enforce_sleep_schedules(store, midnight + day + 9 * 3600.0))
        out.append(m.volumes.enforce_sleep_schedules(store, midnight + day + 10 * 3600.0))
        out.append(sorted(m.mock.MockCloudManager.instances.items()))
        return out

    out, _ = world.run_both(docs, scenario)
    assert out[0] == ["sp0"]
    # 23:00 puts sp2 to sleep and wakes sp3 (its window is 01-05); 09:00
    # wakes sp2; 10:00 has nothing to do
    assert out[1] == ["sp2", "sp3"] and out[2] == ["sp2"] and out[3] == []


def test_heartbeat_monitor_beside_an_agent_pass_keeps_the_task_indexes():
    """The cron plane's ``task-exec-timeout`` job and an agent pass call
    ``mark_end`` on one store at once (pool threads): afterwards each of
    ``mark_end``'s task indexes finds what a scan of every task finds."""
    import threading

    from evergreen_tpu_torch.models import lifecycle as t_lifecycle
    from evergreen_tpu_torch.models import task as t_task
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.units import task_jobs as t_task_jobs
    from evergreen_tpu_torch.utils.benchgen import generate_problem

    distros, tbd, hbd, _, _ = generate_problem(4, 400, seed=2, dep_fraction=0.5)
    store = Store()
    docs = [t.to_doc() for ts in tbd.values() for t in ts]
    for k, d in enumerate(docs[:200]):
        # half stale (the monitor's), half live (the agent's)
        d.update(status="started", host_id="", dispatch_time=NOW - (9000 if k % 2 else 5),
                 last_heartbeat=NOW - (9000 if k % 2 else 5))
    t_task.coll(store).insert_many(docs)
    t_lifecycle.mark_end(store, docs[0]["_id"], "success", now=NOW)  # builds the indexes
    live = [d["_id"] for k, d in enumerate(docs[:200]) if k % 2 == 0][1:]
    errors = []

    def monitor():
        try:
            t_task_jobs.monitor_stale_heartbeats(store, NOW)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    thread = threading.Thread(target=monitor)
    thread.start()
    for tid in live:
        t_lifecycle.mark_end(store, tid, "success", now=NOW)
    thread.join(60.0)
    assert errors == [] and not thread.is_alive()
    coll = t_task.coll(store)
    for doc in coll.find():
        def affects(d, parent=doc["_id"]):
            return any(e["task_id"] == parent for e in d.get("depends_on", []))
        assert t_lifecycle._indexed_find(store, "dependents", doc["_id"], affects) == (
            coll.find(affects))
    statuses = {coll.get(d["_id"])["status"] for d in docs[1:200:2]}
    assert statuses == {"undispatched"}
