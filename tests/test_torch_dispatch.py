"""Dispatch through the port against the JAX package, on the CPU: the DAG
dispatcher, the CAS-pair assignment, the long-poll hub and the loop
tick → agent pass → ``mark_end`` → tick.

Both packages' stores are seeded with the same documents and ticked the
same way (``test_torch_tick.sides`` and its ``world`` fixture: a fixed
clock, the same uuid4 stream and event sequence). An **agent pass** is
what a fleet worker's ``op_agent_sim`` does: finish every task in flight
(``mark_task_started``, then ``mark_end`` with success), then pull for
every free host in id order through a fresh ``DispatcherService``.
Compared after each pass, exactly: the ``(host, task)`` pairs, the
task, host, event and queue documents, and the long-poll hub's
per-distro generations and work ledger. Covered: task groups (single-
host ones among them), dependencies (a dependent woken by ``mark_end``
dispatched on the next pass), the secondary (alias) queue, the
large-parser cap, a host already running a task, a lost CAS race on
either write, a crash at the ``dispatch.assign`` seam (and the recovery
pass releasing the half-assignment), both queue layouts (``rows`` as
the persister writes, ``cols``), the persister's long-poll wake, and the
fleet pull over the in-process plane (2 and 4 shards, after a
``migrate`` too).
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.dispatch import assign as j_assign  # noqa: E402
from evergreen_tpu.dispatch import dag_dispatcher as j_dag  # noqa: E402
from evergreen_tpu.dispatch import longpoll as j_longpoll  # noqa: E402
from evergreen_tpu.models import host as j_host  # noqa: E402
from evergreen_tpu.models import lifecycle as j_lifecycle  # noqa: E402
from evergreen_tpu.models import task as j_task  # noqa: E402
from evergreen_tpu.models import task_queue as j_queue  # noqa: E402
from evergreen_tpu.scheduler import recovery as j_recovery  # noqa: E402
from evergreen_tpu.utils import faults as j_faults  # noqa: E402
from evergreen_tpu.utils import tracing as j_tracing  # noqa: E402

from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.dispatch import assign as t_assign  # noqa: E402
from evergreen_tpu_torch.dispatch import dag_dispatcher as t_dag  # noqa: E402
from evergreen_tpu_torch.dispatch import longpoll as t_longpoll  # noqa: E402
from evergreen_tpu_torch.models import host as t_host  # noqa: E402
from evergreen_tpu_torch.models import lifecycle as t_lifecycle  # noqa: E402
from evergreen_tpu_torch.models import task as t_task  # noqa: E402
from evergreen_tpu_torch.models import task_queue as t_queue  # noqa: E402
from evergreen_tpu_torch.scheduler import recovery as t_recovery  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402
from evergreen_tpu_torch.utils import tracing as t_tracing  # noqa: E402

from test_torch_solve import x64  # noqa: E402,F401
from test_torch_tick import (  # noqa: E402,F401
    NOW,
    generated,
    random_docs,
    sides,
    world,
)

PKG = {
    "jax": dict(assign=j_assign, dag=j_dag, longpoll=j_longpoll, host=j_host,
                lifecycle=j_lifecycle, task=j_task, queue=j_queue,
                recovery=j_recovery, faults=j_faults, settings=j_settings,
                tracing=j_tracing),
    "port": dict(assign=t_assign, dag=t_dag, longpoll=t_longpoll, host=t_host,
                 lifecycle=t_lifecycle, task=t_task, queue=t_queue,
                 recovery=t_recovery, faults=t_faults, settings=t_settings,
                 tracing=t_tracing),
}
#: what a pass writes or reads, compared document for document
DOCS = ("tasks", "hosts", "events", "task_queues", "task_secondary_queues",
        "builds", "versions")
IN_FLIGHT = ("dispatched", "started")


@pytest.fixture(autouse=True)
def no_faults():
    yield
    j_faults.uninstall()
    t_faults.uninstall()


def mods(side):
    return PKG[side.name]


def finish_in_flight(side, now):
    m = mods(side)
    c = side.store.collection("tasks")
    done = sorted(d["_id"] for d in c.find(lambda d: d["status"] in IN_FLIGHT))
    for tid in done:
        m["lifecycle"].mark_task_started(side.store, tid, now=now)
        m["lifecycle"].mark_end(side.store, tid, "success", now=now)
    return done


def dispatch_free_hosts(side, now, svc=None):
    """Pull for every free host in id order; the (host, task) pairs."""
    m = mods(side)
    svc = svc or m["dag"].DispatcherService(side.store)
    hosts = sorted((h for h in m["host"].find(side.store)
                    if h.can_run_tasks() and not h.running_task), key=lambda h: h.id)
    pairs = []
    for h in hosts:
        t = m["assign"].assign_next_available_task(side.store, svc, h, now=now)
        pairs.append((h.id, t.id if t is not None else None))
    return pairs


def agent_pass(side, now):
    finished = finish_in_flight(side, now)
    return finished, dispatch_free_hosts(side, now)


def hub_state(side):
    hub = getattr(side.store, "_longpoll_hub", None)
    if hub is None:
        return None
    return dict(gens=dict(hub._gens), pending=dict(hub._pending),
                waiters=hub.waiters, n_shards=hub.n_shards)


def state(side):
    return dict(docs={c: copy.deepcopy(side.store.collection(c).find()) for c in DOCS},
                hub=hub_state(side))


def assert_same_state(got, want, label=""):
    assert got["hub"] == want["hub"], label
    for c in DOCS:
        assert len(got["docs"][c]) == len(want["docs"][c]), (label, c)
        for g, w in zip(got["docs"][c], want["docs"][c]):
            assert g == w, (label, c, w.get("_id"))


def tick(side, now, **opts):
    res = side.tick(now, **opts)
    assert res.planner_used == "tpu" and res.degraded == ""
    return res


def group_kinds(side, pairs):
    """How the dispatched tasks cover the cases: grouped, single-host
    grouped, with dependencies, on the secondary queue."""
    m = mods(side)
    out = dict(group=0, single_host=0, deps=0, alias=0)
    for hid, tid in pairs:
        if tid is None:
            continue
        t = m["task"].get(side.store, tid)
        h = m["host"].get(side.store, hid)
        out["group"] += bool(t.task_group)
        out["single_host"] += t.task_group_max_hosts == 1
        out["deps"] += bool(t.depends_on)
        out["alias"] += t.distro_id != h.distro_id
    return out


# --------------------------------------------------------------------------- #
# one pass after a tick, and the loop
# --------------------------------------------------------------------------- #


def with_free_hosts(docs, per_distro=6):
    """More free hosts than some queues hold, so pulls reach the
    secondary queue and come back empty."""
    docs = copy.deepcopy(docs)
    for d in docs["distros"]:
        for k in range(per_distro):
            docs["hosts"].append(dict(copy.deepcopy(docs["hosts"][0]), _id=f"{d['_id']}-free{k}",
                                      distro_id=d["_id"], running_task="",
                                      running_task_group="", status="running"))
    return docs


PROBLEMS = {
    "gen": lambda: with_free_hosts(generated(11, n_distros=6, n_tasks=600), 10),
    "random+alias": lambda: with_free_hosts(random_docs(5)),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_pass_after_a_tick_matches_jax(name, world):
    got = {}
    for side in sides(PROBLEMS[name]()):
        world()
        tick(side, NOW)
        pairs = dispatch_free_hosts(side, NOW + 1)
        got[side.name] = (pairs, state(side), group_kinds(side, pairs))
    assert got["port"][0] == got["jax"][0]
    assert_same_state(got["port"][1], got["jax"][1])
    kinds = got["port"][2]
    assert sum(t is not None for _, t in got["port"][0]) > 0
    if name == "gen":
        assert kinds["group"] and kinds["single_host"]
    else:
        assert kinds["alias"], kinds
        assert any(t is None for _, t in got["port"][0])
    assert got["port"][1]["hub"] is not None


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_loop_tick_pass_tick_matches_jax(warm, world):
    """tick → pass → tick → pass → tick: documents, queue orders and the
    hub equal after every step; a dependent whose parent the second
    pass finishes is dispatched in that pass (woken by ``mark_end``)."""
    got = {}
    for side in sides(generated(12, n_distros=6, n_tasks=600)):
        world()
        steps = []
        for k in range(3):
            res = tick(side, NOW + 30 * k, use_cache=warm)
            steps.append(("tick", res.queues, res.new_hosts, state(side)))
            if k < 2:
                finished, pairs = agent_pass(side, NOW + 30 * k + 15)
                steps.append(("pass", finished, pairs, state(side)))
        got[side.name] = steps
    for k, (p, j) in enumerate(zip(got["port"], got["jax"])):
        assert p[:3] == j[:3], k
        assert_same_state(p[3], j[3], k)
    assert len(got["port"]) == len(got["jax"]) == 5
    # the second pass finished the first pass's tasks, which woke
    # dependents the same pass dispatched
    first = {t for _, t in got["port"][1][2] if t}
    second = {t for _, t in got["port"][3][2] if t}
    tasks = {d["_id"]: d for d in got["port"][3][3]["docs"]["tasks"]}
    woken = [t for t in second
             if any(dep["task_id"] in first for dep in tasks[t].get("depends_on", []))]
    assert woken, "no dependent of a finished task was dispatched"
    assert set(got["port"][3][1]) == first


def to_cols(doc):
    """A persisted queue document rewritten in the ``cols`` layout."""
    q = t_queue.TaskQueue.from_doc(doc)
    names = list(t_queue._ITEM_FIELDS)
    out = {k: v for k, v in doc.items()
           if k not in ("rows", "order", "sort_value", "dependencies_met")}
    out["cols"] = {n: [getattr(i, n) for i in q.queue] for n in names}
    return out


def test_dispatcher_reads_both_queue_layouts(world):
    """The same queues persisted in ``rows`` (as the persister writes
    them) and rewritten in ``cols``: each package hands out the same
    pairs from either layout."""
    docs = generated(13, n_distros=4, n_tasks=400)
    got = {}
    for side in sides(docs):
        world()
        tick(side, NOW)
        copy_side = copy.copy(side)
        copy_side.store = type(side.store)()
        for c in ("distros", "tasks", "hosts", "parser_projects", "config"):
            copy_side.store.collection(c).insert_many(
                copy.deepcopy(side.store.collection(c).find()))
        for secondary in (False, True):
            coll = mods(side)["queue"].coll(side.store, secondary)
            dst = mods(side)["queue"].coll(copy_side.store, secondary)
            for doc in coll.find():
                assert "rows" in doc
                dst.insert(to_cols(doc))
        got[side.name] = (dispatch_free_hosts(side, NOW + 1),
                          dispatch_free_hosts(copy_side, NOW + 1))
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][1]
    assert sum(t is not None for _, t in got["port"][0]) > 0


def test_large_parser_cap_matches_jax(world):
    """With a cap on in-flight tasks of large parser projects, pulls skip
    those tasks once the cap is reached, as JAX's guard does."""
    docs = generated(14, n_distros=4, n_tasks=400)
    versions = sorted({d["version"] for d in docs["tasks"]})
    docs["parser_projects"] = [{"_id": v, "large": True} for v in versions[::2]]
    docs["config"] = [dict(dataclasses.asdict(j_settings.TaskLimitsConfig(
        max_concurrent_large_parser_project_tasks=2)), _id="task_limits")]
    got = {}
    for side in sides(docs):
        world()
        tick(side, NOW)
        pairs = dispatch_free_hosts(side, NOW + 1)
        large = {p["_id"] for p in docs["parser_projects"]}
        n_large = sum(1 for _, t in pairs
                      if t and mods(side)["task"].get(side.store, t).version in large)
        got[side.name] = (pairs, state(side), n_large)
    assert got["port"][0] == got["jax"][0]
    assert_same_state(got["port"][1], got["jax"][1])
    assert got["port"][2] == 2


def test_running_host_gets_its_task_back(world):
    """A host whose running task exists is handed that task again (an
    agent that crashed resumes), with nothing written."""
    got = {}
    for side in sides(generated(15, n_distros=3, n_tasks=300)):
        world()
        tick(side, NOW)
        pairs = dispatch_free_hosts(side, NOW + 1)
        hid, tid = next(p for p in pairs if p[1])
        m = mods(side)
        before = state(side)
        again = m["assign"].assign_next_available_task(
            side.store, m["dag"].DispatcherService(side.store),
            m["host"].get(side.store, hid), now=NOW + 2)
        assert again.id == tid
        assert_same_state(state(side), before)
        got[side.name] = (hid, tid)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("race", ["host", "task"])
def test_lost_cas_race_matches_jax(race, monkeypatch, world):
    """``host``: another request claimed the host between the read and
    the CAS — the pull returns nothing. ``task``: another host took the
    task between the host's claim and the task's — the host is released
    and the pull goes on to the next candidate."""
    got = {}
    for side in sides(generated(16, n_distros=3, n_tasks=300)):
        world()
        tick(side, NOW)
        m = mods(side)
        free = sorted((h for h in m["host"].find(side.store)
                       if h.can_run_tasks() and not h.running_task), key=lambda h: h.id)
        host = free[0]
        if race == "host":
            side.store.collection("hosts").update(host.id, {"running_task": "elsewhere"})
            out = m["assign"].assign_next_available_task(
                side.store, m["dag"].DispatcherService(side.store), host, now=NOW + 1)
        else:
            real = m["assign"].mark_task_dispatched
            calls = []

            def racing(store, task_id, host_id, now=None, real=real, calls=calls):
                if not calls:
                    calls.append(task_id)
                    assert real(store, task_id, "other-host", now)
                    return False
                return real(store, task_id, host_id, now)

            monkeypatch.setattr(m["assign"], "mark_task_dispatched", racing)
            out = m["assign"].assign_next_available_task(
                side.store, m["dag"].DispatcherService(side.store), host, now=NOW + 1)
            assert out is not None and out.id != calls[0]
            monkeypatch.setattr(m["assign"], "mark_task_dispatched", real)
        got[side.name] = (out.id if out else None, state(side))
    assert got["port"][0] == got["jax"][0]
    assert_same_state(got["port"][1], got["jax"][1])
    if race == "host":
        assert got["port"][0] is None


def test_crash_at_the_assign_seam_matches_jax(world):
    """A crash between the host's claim and the task's dispatched mark
    (the ``dispatch.assign`` seam) leaves the same half-assignment in
    both packages, and the recovery pass releases it the same way."""
    got = {}
    for side in sides(generated(17, n_distros=3, n_tasks=300)):
        world()
        tick(side, NOW)
        m = mods(side)
        m["faults"].install(m["faults"].FaultPlan().at(
            "dispatch.assign", 1, m["faults"].Fault("raise")))
        with pytest.raises(m["faults"].FaultError):
            dispatch_free_hosts(side, NOW + 1)
        m["faults"].uninstall()
        half = state(side)
        report = m["recovery"].run_recovery_pass(side.store, now=NOW + 2).to_doc()
        got[side.name] = (half, report, state(side))
    assert_same_state(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1]["released_claims"]
    assert_same_state(got["port"][2], got["jax"][2])


def test_dispatch_assign_span_parents_into_the_tick(world):
    """Each pull is a ring-only ``dispatch_assign`` span (``distro``,
    ``task``) in the last tick's trace; an empty pull decays the hub's
    ledger; nothing reaches the spans collection."""
    prev = j_tracing.set_tracing_enabled(True), t_tracing.set_tracing_enabled(True)
    try:
        got = {}
        for side in sides(with_free_hosts(random_docs(6))):
            world()
            res = tick(side, NOW)
            n_docs = len(side.store.collection("spans").find())
            pairs = dispatch_free_hosts(side, NOW + 1)
            tree = mods(side)["tracing"].trace_tree(side.store, res.trace_id)
            assigns = [c for c in tree["roots"][0]["children"]
                       if c["name"] == "dispatch_assign"]
            got[side.name] = (
                sorted((c["attributes"].get("distro"), c["attributes"].get("task"))
                       for c in assigns),
                len(side.store.collection("spans").find()) - n_docs)
            assert len(assigns) == len(pairs)
            assert {c["component"] for c in assigns} == {"dispatch"}
        assert got["port"] == got["jax"]
        assert got["port"][1] == 0
    finally:
        j_tracing.set_tracing_enabled(prev[0])
        t_tracing.set_tracing_enabled(prev[1])


# --------------------------------------------------------------------------- #
# the long-poll hub and the persister's wake
# --------------------------------------------------------------------------- #


def test_persister_wakes_the_hub_like_jax(world):
    """A hub attached before two ticks: the queue writes bump each
    distro's generation (the collection listener) and the persister's
    notify credits the work ledger, as in JAX; a skipped write does
    not."""
    got = {}
    for side in sides(generated(18, n_distros=4, n_tasks=400)):
        world()
        mods(side)["longpoll"].hub_for(side.store)
        tick(side, NOW)
        after_one = hub_state(side)
        tick(side, NOW + 15)
        got[side.name] = (after_one, hub_state(side))
    assert got["port"] == got["jax"]
    assert all(v > 0 for v in got["port"][0]["pending"].values())
    assert got["port"][0]["pending"]


def test_hub_wait_and_notify_like_jax():
    """A waiter parked on a distro is woken by a sized notify (claiming
    one credit); a waiter with a stale generation returns at once; a
    clean timeout returns False; ``note_empty`` decays the ledger."""
    import threading

    got = {}
    for name, m in PKG.items():
        hub = m["longpoll"].LongPollHub(n_shards=4, recheck_s=0.05)
        out = [hub.wait("d1", "h1", gen=hub.generation("d1") + 1, timeout_s=1.0)]
        res = []
        gen = hub.generation("d1")
        th = threading.Thread(target=lambda: res.append(
            hub.wait("d1", "h1", gen=gen, timeout_s=5.0)))
        th.start()
        while hub.waiters == 0:
            pass
        hub.notify("d1", n_hint=2)
        th.join()
        out += res
        out.append(hub.wait("d2", "h2", gen=hub.generation("d2"), timeout_s=0.05))
        hub.note_empty("d1")
        out.append((dict(hub._gens), dict(hub._pending), hub.waiters))
        got[name] = out
    assert got["port"] == got["jax"] == [True, True, False, ({"d1": 1}, {"d1": 0}, 0)]


# --------------------------------------------------------------------------- #
# the fleet pull over the in-process plane
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [2, 4])
def test_fleet_pull_matches_jax(n, world):
    """``assign_next_available_task_fleet`` for every free host (in id
    order across the shards) after a round, then after a ``migrate`` and
    another round: the pairs and every shard's documents equal JAX's."""
    from test_torch_sharded_plane import make_plane, plane_docs

    got = {}
    for pkg in ("jax", "port"):
        world()
        plane = make_plane(pkg, generated(19, n_distros=8, n_tasks=480, capacity=True), n)
        m = PKG[pkg]
        try:
            steps = []
            for r in range(2):
                if r == 1:
                    # the agents finish what they took, then a distro moves
                    for store in plane.stores:
                        for d in store.collection("tasks").find(
                                lambda d: d["status"] in IN_FLIGHT):
                            m["lifecycle"].mark_task_started(store, d["_id"], now=NOW + 15)
                            m["lifecycle"].mark_end(store, d["_id"], "success", now=NOW + 15)
                    src = next(k for k, s in enumerate(plane.stores)
                               if s.collection("distros").find())
                    did = plane.stores[src].collection("distros").find()[0]["_id"]
                    plane.migrate(did, (src + 1) % n, now=NOW + 16)
                plane.tick(now=NOW + 30 * r)
                hids = sorted(d["_id"] for s in plane.stores
                              for d in s.collection("hosts").find()
                              if d["status"] == "running" and not d["running_task"])
                pairs = []
                for hid in hids:
                    t = m["assign"].assign_next_available_task_fleet(
                        plane, hid, now=NOW + 30 * r + 1)
                    pairs.append((hid, t.id if t else None))
                assert m["assign"].assign_next_available_task_fleet(plane, "no-such-host") is None
                steps.append((pairs, plane_docs(plane), dict(plane._host_shard)))
            got[pkg] = steps
        finally:
            plane.close()
    for k, (p, j) in enumerate(zip(got["port"], got["jax"])):
        assert p[0] == j[0], k
        assert p[1] == j[1], k
        assert p[2] == j[2], k
    assert sum(t is not None for _, t in got["port"][1][0]) > 0


# --------------------------------------------------------------------------- #
# the one-card fleet's leader rule, and mark_end's dependents index
# --------------------------------------------------------------------------- #


def test_one_card_service_fleet_elects_no_leader(tmp_path, monkeypatch):
    """``service --shards 4`` builds its supervisor with the sharding
    section's ``solver_leader`` ("auto" by default): on one CUDA device
    that counts 1 against 4 shards and elects no leader, so the deployed
    one-card fleet solves locally in its workers."""
    from evergreen_tpu_torch import cli
    from evergreen_tpu_torch.runtime import supervisor as sup_mod

    built = []

    def start(self, *a, **k):
        built.append(self)
        raise RuntimeError("not starting workers in this test")

    monkeypatch.setattr(sup_mod.FleetSupervisor, "start", start)
    rc = cli.main(["service", "--shards", "4", "--data-dir", str(tmp_path),
                   "--device", "cpu"])
    assert rc == 1 and len(built) == 1
    sup = built[0]
    assert sup.solver_mode == "auto" and sup.n_shards == 4
    sup.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    sup._start_solver()
    assert sup.solver_service is None


def test_task_indexes_find_what_the_scan_finds():
    """``mark_end``'s chain reads a finished task's dependents and its
    build's task group through the store's task indexes; after inserts,
    edge and group rewrites, removals and a removed id inserted again,
    each returns what a scan of every task returns, in store order."""
    import random

    from evergreen_tpu_torch.storage.store import Store

    rng = random.Random(3)
    store = Store()
    coll = t_task.coll(store)
    ids = [f"t{i}" for i in range(60)]
    groups = [("", ""), ("", "tg0"), ("", "tg1"), ("b1", "tg0")]

    def doc(i):
        build, group = rng.choice(groups)
        return {"_id": i, "build_id": build, "task_group": group,
                "depends_on": [{"task_id": p, "status": "success", "finished": False,
                                "unattainable": False}
                               for p in rng.sample(ids, rng.randrange(3))]}

    coll.insert_many([doc(i) for i in ids[:30]])

    def check():
        for parent in ids:
            def affects(d, parent=parent):
                return any(e["task_id"] == parent for e in d.get("depends_on", []))
            assert t_lifecycle._indexed_find(store, "dependents", parent, affects) == (
                coll.find(affects))
        for build, group in groups[1:]:
            def member(d, build=build, group=group):
                return d["build_id"] == build and d["task_group"] == group
            assert t_lifecycle._indexed_find(store, "group", (build, group), member) == (
                coll.find(member))

    check()
    for i in ids[30:]:
        coll.insert(doc(i))
    for i in rng.sample(ids, 20):
        new = doc(i)
        coll.update(i, {k: new[k] for k in ("build_id", "task_group", "depends_on")})
    gone = rng.sample(ids[:30], 5)
    for i in gone:
        coll.remove(i)
    coll.insert(doc(gone[0]))
    check()


def test_two_threads_mark_end_on_one_store(monkeypatch):
    """Two ``mark_end`` calls on one store, in two threads: the second
    looks up its dependents while the first is still noting the written
    ids it took (held there on purpose); the second waits for it, so the
    dependent written after the index was built has both of its edges
    finished and is woken."""
    import threading
    import time

    from evergreen_tpu_torch.models.task import Task
    from evergreen_tpu_torch.storage.store import Store

    store = Store()
    for tid in ("p0", "p1", "p2"):
        t_task.insert(store, Task(id=tid, distro_id="d1", status="started",
                                  activated=True))
    t_lifecycle.mark_end(store, "p0", "success", now=NOW)  # builds the indexes
    edges = [{"task_id": p, "status": "success", "finished": False,
              "unattainable": False} for p in ("p1", "p2")]
    t_task.coll(store).insert({**t_task.coll(store).get("p0"), "_id": "d_new",
                               "status": "undispatched", "depends_on": edges})

    real_note = t_lifecycle._TaskIndex._note
    noting = threading.Event()

    def slow_note(self, docs):
        docs = list(docs)
        if any(d["_id"] == "d_new" for d in docs) and not noting.is_set():
            noting.set()
            time.sleep(0.3)
        real_note(self, docs)

    monkeypatch.setattr(t_lifecycle._TaskIndex, "_note", slow_note)
    errors = []

    def finish(tid):
        try:
            t_lifecycle.mark_end(store, tid, "success", now=NOW + 1)
        except Exception as e:  # surfaced below
            errors.append(e)

    first = threading.Thread(target=finish, args=("p1",))
    first.start()
    assert noting.wait(5.0)
    second = threading.Thread(target=finish, args=("p2",))
    second.start()
    first.join(5.0)
    second.join(5.0)
    assert errors == []
    deps = t_task.coll(store).get("d_new")["depends_on"]
    assert [(e["task_id"], e["finished"]) for e in deps] == [("p1", True), ("p2", True)]
