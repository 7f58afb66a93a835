"""The startup recovery pass, through the port against the JAX package.

Each case builds one store by hand (documents made with the JAX
package's models), inserts it into a JAX ``Store`` and a port ``Store``,
and runs each package's ``run_recovery_pass`` at the same ``now``. The
``world`` fixture of ``test_torch_tick.py`` fixes the clock and gives
both runs the same event sequence. Held equal: the
``RecoveryReport.to_doc()``, every document of every collection (events,
archives, costs, builds and versions included) and the deltas of the
recovery counters. The cases cover every branch of steps 1–3: coherent
and broken claims, stale heartbeats, missing and down hosts, the restart
limit, aborted tasks, ``reset_when_finished``, single-host task groups,
dependency propagation with its queue wake, a stepback candidate (which
a system failure never activates), the build and version rollup, and
building mock hosts with and without an instance, beside a provider
that raises.

The crash copy: a durable directory written by the port and copied
without closing is reopened by each package; each ticks it once with
``use_cache=True`` (a warm plane), runs recovery, and ticks again: the
documents are JAX's after every step, and the port's plane rebuilds once
for the reason ``"recovery"``.
"""
import copy
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.cloud import manager as j_manager  # noqa: E402
from evergreen_tpu.cloud import mock as j_mock  # noqa: E402
from evergreen_tpu.models import host as j_host  # noqa: E402
from evergreen_tpu.models import task as j_task  # noqa: E402
from evergreen_tpu.models.build import Build  # noqa: E402
from evergreen_tpu.models.version import Version  # noqa: E402
from evergreen_tpu.scheduler import recovery as j_recovery  # noqa: E402
from evergreen_tpu.storage import durable as j_durable  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.units import host_jobs as j_host_jobs  # noqa: E402
from evergreen_tpu.utils import benchgen as j_benchgen  # noqa: E402

from evergreen_tpu_torch.cloud import manager as t_manager  # noqa: E402
from evergreen_tpu_torch.cloud import mock as t_mock  # noqa: E402
from evergreen_tpu_torch.scheduler import recovery as t_recovery  # noqa: E402
from evergreen_tpu_torch.scheduler import resident as t_resident  # noqa: E402
from evergreen_tpu_torch.scheduler import wrapper as t_wrapper  # noqa: E402
from evergreen_tpu_torch.storage import durable as t_durable  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.units import host_jobs as t_host_jobs  # noqa: E402

from evergreen_tpu.scheduler import wrapper as j_wrapper  # noqa: E402
from test_torch_solve import x64  # noqa: E402,F401
from test_torch_tick import NOW, world  # noqa: E402,F401

STALE = NOW - j_recovery.RECOVERY_HEARTBEAT_TIMEOUT_S - 60.0
FRESH = NOW - 30.0

PACKAGES = {
    "jax": (j_store, j_recovery, j_host_jobs, j_mock, j_manager),
    "port": (t_store, t_recovery, t_host_jobs, t_mock, t_manager),
}


def task(tid, **kw):
    kw.setdefault("distro_id", "d1")
    kw.setdefault("activated", True)
    kw.setdefault("project", "p")
    kw.setdefault("build_variant", "bv")
    kw.setdefault("version", "v1")
    return j_task.Task(id=tid, **kw).to_doc()


def in_flight(tid, host_id, beat=FRESH, status="started", **kw):
    return task(tid, status=status, host_id=host_id, dispatch_time=beat - 10.0,
                start_time=beat - 10.0 if status == "started" else 0.0,
                last_heartbeat=beat, **kw)


def host(hid, status="running", running_task="", **kw):
    kw.setdefault("distro_id", "d1")
    kw.setdefault("instance_type", "m5.large")
    return j_host.Host(id=hid, status=status, running_task=running_task, **kw).to_doc()


def dep(tid, status="success"):
    return {"task_id": tid, "status": status, "unattainable": False, "finished": False}


def case_claims():
    """Step 1: a coherent assignment beside claims on a missing task, on a
    task not in flight and on a task another host owns."""
    return {
        "tasks": [in_flight("t1", "h1"), task("t3"), in_flight("t4", "h5")],
        "hosts": [host("h1", running_task="t1"), host("h2", running_task="ghost"),
                  host("h3", running_task="t3"), host("h4", running_task="t4"),
                  host("h5", running_task="t4")],
    }


def case_stranded():
    """Step 2: a stale heartbeat, a missing host, a terminated and a
    decommissioned host, the restart limit, an aborted task and a
    ``reset_when_finished`` task; a fresh dispatched task stays."""
    return {
        "tasks": [
            in_flight("t-stale", "h1", beat=STALE),
            in_flight("t-gone", "nohost", status="dispatched"),
            in_flight("t-term", "h2"),
            in_flight("t-decom", "h3"),
            in_flight("t-limit", "h4", beat=STALE, num_automatic_restarts=3),
            in_flight("t-abort", "h5", beat=STALE, aborted=True),
            in_flight("t-rwf", "h6", beat=STALE, reset_when_finished=True),
            in_flight("t-ok", "h7", status="dispatched"),
            task("t-none", status="started", last_heartbeat=STALE),
        ],
        "hosts": [host("h1", running_task="t-stale"), host("h2", status="terminated"),
                  host("h3", status="decommissioned"),
                  host("h4", running_task="t-limit"), host("h5", running_task="t-abort"),
                  host("h6", running_task="t-rwf"), host("h7", running_task="t-ok")],
    }


def case_groups_and_deps():
    """``mark_end``'s chain: a single-host task group whose member is
    system-failed (later members blocked), a group reset requested with
    ``reset_when_finished``, a dependency chain blocked transitively, an
    ``any``-status dependent woken in its queue document, a mainline
    failure with an earlier candidate (no stepback: a system failure),
    and the build and version rollups."""
    g = dict(task_group="g", task_group_max_hosts=1, build_id="b1")
    tasks = [
        in_flight("g1", "h1", beat=STALE, task_group_order=1,
                  num_automatic_restarts=3, **g),
        task("g2", task_group_order=2, **g),
        task("g3", task_group_order=3, depends_on=[dep("g1")], **g),
        in_flight("r1", "h2", beat=STALE, task_group="r", task_group_max_hosts=1,
                  build_id="b2", task_group_order=1, num_automatic_restarts=3),
        task("r2", status="success", task_group="r", task_group_max_hosts=1,
             build_id="b2", task_group_order=2, reset_when_finished=True,
             start_time=NOW - 500, finish_time=NOW - 400, host_id="h9"),
        in_flight("p1", "h3", beat=STALE, num_automatic_restarts=3, build_id="b3",
                  requester="gitter_request", display_name="compile",
                  revision_order_number=10),
        task("p0", requester="gitter_request", display_name="compile",
             revision_order_number=9, activated=False, build_id="b4"),
        task("c1", depends_on=[dep("p1")], build_id="b3"),
        task("c2", depends_on=[dep("c1")], build_id="b3"),
        task("w1", depends_on=[dep("p1", "*")], build_id="b3"),
        in_flight("s1", "h4", beat=STALE, num_automatic_restarts=3, build_id="b5"),
    ]
    builds = [Build(id=b, version="v1", status="started" if b != "b4" else "created",
                    start_time=NOW - 900).to_doc() for b in ("b1", "b2", "b3", "b4", "b5")]
    version = Version(id="v1", status="started", start_time=NOW - 900,
                      build_ids=["b1", "b2", "b3", "b4", "b5"]).to_doc()
    queue = {"_id": "d1", "distro": "d1", "generated_at": NOW - 60,
             "queue": [{"id": "w1", "dependencies_met": False},
                       {"id": "c1", "dependencies_met": False}]}
    return {
        "tasks": tasks,
        "hosts": [host("h1", running_task="g1"), host("h2", running_task="r1"),
                  host("h3", running_task="p1"), host("h4", running_task="s1")],
        "builds": builds, "versions": [version], "task_queues": [queue],
        "project_refs": [{"_id": "p", "stepback_disabled": False}],
    }


def case_building(monkeypatch):
    """Step 3: building mock hosts — one the provider reports running, one
    whose instance it never heard of, one with no external id (running a
    task, which is then stranded), a docker-mock host terminated by the
    provider — and a provider that raises."""
    for mock in (j_mock, t_mock):
        monkeypatch.setattr(mock.MockCloudManager, "instances",
                            {"i-up": "running", "i-dead": "terminated"})
    for pkg_manager in (j_manager, t_manager):
        class Raising(pkg_manager.CloudManager):
            provider = "raising"

            def get_instance_status(self, store, h):
                raise ConnectionError("provider unreachable")

            def terminate_instance(self, store, h, reason):
                raise ConnectionError("provider unreachable")

            def spawn_host(self, store, h):  # the JAX interface's
                raise ConnectionError("provider unreachable")

        monkeypatch.setitem(pkg_manager._REGISTRY, "raising", Raising)
    return {
        "tasks": [in_flight("t-b", "hb3", status="dispatched")],
        "hosts": [host("hb1", status="building", external_id="i-up"),
                  host("hb2", status="starting", external_id="i-unknown"),
                  host("hb3", status="provisioning", running_task="t-b"),
                  host("hb4", status="building", provider="docker-mock",
                       external_id="i-dead"),
                  host("hb5", status="building", provider="raising"),
                  host("hb6", status="running", external_id="i-gone")],
    }


CASES = {"claims": case_claims, "stranded": case_stranded,
         "groups_and_deps": case_groups_and_deps, "building": case_building}


def counters(recovery, host_jobs):
    return (recovery.RECOVERY_RECONCILED.value(),
            recovery.RECOVERY_PROVIDER_ERRORS.value(),
            host_jobs.RECOVERY_STRANDED.value(outcome="reset"),
            host_jobs.RECOVERY_STRANDED.value(outcome="system_failed"))


def all_docs(store):
    return {n: copy.deepcopy(store.collection(n).find())
            for n in sorted(store._collections) if len(store.collection(n))}


def recover(name, docs, world):
    store_mod, recovery, host_jobs, _, _ = PACKAGES[name]
    store = store_mod.Store()
    for coll, ds in docs.items():
        store.collection(coll).insert_many(copy.deepcopy(ds))
    world()
    before = counters(recovery, host_jobs)
    report = recovery.run_recovery_pass(store, now=NOW)
    after = counters(recovery, host_jobs)
    return dict(report=report.to_doc(), docs=all_docs(store),
                counters=[a - b for a, b in zip(after, before)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_recovery_pass_matches_jax(name, world, monkeypatch):
    build = CASES[name]
    docs = build(monkeypatch) if name == "building" else build()
    j, t = (recover(p, docs, world) for p in ("jax", "port"))
    assert t["report"] == j["report"]
    assert t["counters"] == j["counters"]
    assert sorted(t["docs"]) == sorted(j["docs"])
    for coll in j["docs"]:
        assert t["docs"][coll] == j["docs"][coll], coll
    # every case changes something, so the comparison is not vacuous
    report = t["report"]
    assert (report["released_claims"] or report["reconciled_tasks"]
            or report["hosts_terminated"]), report


def test_the_cases_reach_every_branch(world, monkeypatch):
    """What each case does, read from the port's run: the claims released,
    the stranded outcomes, the hosts terminated, the blocked group member,
    the woken queue row, the group reset, the rollups and the provider
    error counted."""
    claims = recover("port", case_claims(), world)
    assert claims["report"]["released_claims"] == ["h2", "h3", "h4"]
    stranded = recover("port", case_stranded(), world)["report"]
    assert sorted(stranded["stranded_reset"]) == ["t-decom", "t-gone", "t-none",
                                                  "t-rwf", "t-stale", "t-term"]
    assert sorted(stranded["stranded_failed"]) == ["t-abort", "t-limit"]
    deps = recover("port", case_groups_and_deps(), world)
    by_id = {d["_id"]: d for d in deps["docs"]["tasks"]}
    assert any(d["task_id"] == "g1" and d["unattainable"]
               for d in by_id["g2"]["depends_on"])
    assert by_id["c2"]["depends_on"][0]["unattainable"]
    assert by_id["r2"]["status"] == "undispatched" and by_id["r2"]["execution"] == 1
    assert not by_id["p0"]["activated"]
    assert deps["docs"]["task_queues"][0]["queue"][0]["dependencies_met"]
    assert {b["_id"]: b["status"] for b in deps["docs"]["builds"]}["b5"] == "failed"
    assert deps["docs"]["task_costs"]
    building = recover("port", case_building(monkeypatch), world)
    assert building["report"]["hosts_terminated"] == ["hb2", "hb3", "hb4"]
    assert building["counters"][1] == 1  # the raising provider


# --------------------------------------------------------------------------- #
# a crash copy, reopened and recovered by each package
# --------------------------------------------------------------------------- #


@pytest.fixture
def no_jax_tracing():
    """Both packages' tracing off: the parity here is of the tick's own
    documents and WAL records (the span trees are held with tracing on
    in tests/test_torch_tracing.py)."""
    from evergreen_tpu.utils import tracing as j_tracing
    from evergreen_tpu_torch.utils import tracing as t_tracing

    prev = j_tracing.set_tracing_enabled(False), t_tracing.set_tracing_enabled(False)
    yield
    j_tracing.set_tracing_enabled(prev[0])
    t_tracing.set_tracing_enabled(prev[1])


def test_crash_copy_recovers_and_ticks_as_jax(tmp_path, world, no_jax_tracing):
    """A port durable directory copied mid-run (no close) — benchgen's
    phantom ``running_task`` claims plus stranded in-flight tasks — is
    reopened by each package, ticked once with ``use_cache=True``,
    recovered and ticked again: documents equal after every step; the
    port's plane rebuilt once for ``"recovery"``."""
    distros, tbd, hbd, _, _ = j_benchgen.generate_problem(6, 600, seed=5,
                                                          hosts_per_distro=4)
    src = str(tmp_path / "live")
    live = t_durable.DurableStore(src)
    live.collection("distros").insert_many([d.to_doc() for d in distros])
    tasks = [t.to_doc() for ts in tbd.values() for t in ts]
    for k, doc in enumerate(tasks[:12]):  # in flight on hosts that are gone
        doc.update(status="dispatched" if k % 2 else "started", host_id=f"gone{k}",
                   dispatch_time=STALE, last_heartbeat=STALE)
    live.collection("tasks").insert_many(tasks)
    live.collection("hosts").insert_many([h.to_doc() for hs in hbd.values() for h in hs])
    live.sync_persist()
    runs = {}
    for name, durable in (("jax", j_durable), ("port", t_durable)):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        store = durable.DurableStore(d)
        recovery = PACKAGES[name][1]
        wrapper = j_wrapper if name == "jax" else t_wrapper
        kw = {} if name == "jax" else {"device": "cpu"}
        world()
        steps = []
        opts = wrapper.TickOptions(use_cache=True)
        wrapper.run_tick(store, opts, now=NOW, **kw)
        steps.append(all_docs(store))
        report = recovery.run_recovery_pass(store, now=NOW + 5)
        steps.append(all_docs(store))
        wrapper.run_tick(store, opts, now=NOW + 15, **kw)
        steps.append(all_docs(store))
        runs[name] = dict(report=report.to_doc(), steps=steps, store=store)
    live._journal.close()
    assert runs["port"]["report"] == runs["jax"]["report"]
    assert runs["port"]["report"]["released_claims"]
    assert runs["port"]["report"]["reconciled_tasks"] == 12
    for k, (t, j) in enumerate(zip(runs["port"]["steps"], runs["jax"]["steps"])):
        assert json.loads(json.dumps(t, sort_keys=True)) == json.loads(
            json.dumps(j, sort_keys=True)), f"step {k}"
    plane = t_resident.peek_resident_plane(runs["port"]["store"])
    assert plane.rebuild_reasons == {"cold": 1, "recovery": 1}
    for run in runs.values():
        run["store"]._journal.close()
    assert os.path.isdir(src)
