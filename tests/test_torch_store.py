"""The port's store, models and config sections against the JAX package.

The order in which ``find`` returns documents, and whether reads copy
them, decide the order of the tick's gather, then of the snapshot's
slots, then of queue ties. These tests run the same operations on both
packages' collections and stores and compare every return value and the
documents after each step; the finders return the same ids in the same
order on hand-made and generated problems; and a config section written
through either package reads back the same through the other.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.cloud import manager as j_manager  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402

from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.cloud import manager as t_manager  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402

from test_torch_tick_plan import (  # noqa: E402
    J, NOW, T, make_tasks, seed_generated, seed_spec, seed_tick_problem,
)


def doc(i, **kw):
    return {"_id": i, "v": 0, "n": kw.pop("n", 0), **kw}


def queue_doc(i):
    return {"_id": i, "rows": ["a", "b", "c"], "sort_value": [3.0, 2.0, 1.0],
            "dependencies_met": [True, False, True], "v": 1}


#: each script: (name, op) pairs run in order on a fresh collection; an op
#: returns a value or raises, and both packages must do the same
SCRIPTS = {
    "crud": [
        ("insert", lambda c: c.insert(doc("b"))),
        ("insert", lambda c: c.insert(doc("a", n=2))),
        ("insert dup", lambda c: c.insert(doc("a"))),
        ("upsert new", lambda c: c.upsert(doc("c", n=5))),
        ("upsert old keeps its place", lambda c: c.upsert(doc("b", n=9))),
        ("get", lambda c: c.get("b")),
        ("get missing", lambda c: c.get("zz")),
        ("find_ids in asked order", lambda c: c.find_ids(["c", "zz", "a"])),
        ("key_order", lambda c: dict(c.key_order())),
        ("remove", lambda c: c.remove("a")),
        ("remove missing", lambda c: c.remove("a")),
        ("insert after remove", lambda c: c.insert(doc("a", n=1))),
        ("key_order", lambda c: sorted(c.key_order(), key=c.key_order().get)),
        ("count", lambda c: c.count()),
        ("count pred", lambda c: c.count(lambda d: d["n"] > 1)),
        ("len", len),
        ("iter", list),
    ],
    "bulk": [
        ("insert_many", lambda c: c.insert_many(doc(f"d{i}", n=i) for i in range(6))),
        ("insert_many dup rejects all", lambda c: c.insert_many(
            [doc("x"), doc("d2")])),
        ("insert_many self dup", lambda c: c.insert_many([doc("y"), doc("y")])),
        ("update", lambda c: c.update("d1", {"n": 10})),
        ("update missing", lambda c: c.update("nope", {"n": 1})),
        ("update_where", lambda c: c.update_where(lambda d: d["n"] % 2 == 0,
                                                  {"even": True})),
        ("compare_and_set hit", lambda c: c.compare_and_set(
            "d4", {"n": 4}, {"n": 40})),
        ("compare_and_set miss", lambda c: c.compare_and_set(
            "d4", {"n": 4}, {"n": 41})),
        ("mutate", lambda c: c.mutate("d0", lambda d: d.update(m=1))),
        ("remove_where", lambda c: c.remove_where(lambda d: d.get("even"))),
    ],
    "snapshot": [
        ("insert", lambda c: c.insert(queue_doc("q"))),
        ("insert_many", lambda c: c.insert_many([doc("r"), doc("s", n=4)])),
        ("mutate missing", lambda c: c.mutate("nope", lambda d: d.clear())),
        ("snapshot", lambda c: c.snapshot()),
        ("clear", lambda c: c.clear()),
        ("after clear", lambda c: (c.find(), dict(c.key_order()))),
    ],
}


def run_op(op, coll):
    try:
        return ("ok", op(coll))
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return ("raise", type(exc).__name__, str(exc))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_collection_operations_match_jax(script):
    jc, tc = j_store.Collection("c"), t_store.Collection("c")
    for name, op in SCRIPTS[script]:
        assert run_op(op, tc) == run_op(op, jc), name
        assert tc.find() == jc.find(), name
        assert [d["_id"] for d in tc.find()] == [d["_id"] for d in jc.find()], name


def test_reads_return_the_stored_documents_uncopied():
    for mod in (j_store, t_store):
        c = mod.Collection("c")
        c.insert_many([doc("a"), doc("b")])
        found = c.find()
        assert found[0] is c.get("a") and c.find_ids(["b"])[0] is found[1]
        snap = c.snapshot()
        assert snap == found and snap[0] is not found[0]
        c.upsert(doc("a", n=3))
        assert c.get("a") is not found[0]  # an upsert replaces the dict


def test_store_and_global_store_match_jax():
    for mod in (j_store, t_store):
        s = mod.Store()
        assert s.collection("x") is s["x"]
        s["x"].insert(doc("a"))
        s["y"].insert(doc("b"))
        s.clear_collections("x")
        assert (s["x"].find(), s["y"].count()) == ([], 1)
        s.clear_collections()
        assert s["y"].count() == 0
        g = mod.global_store()
        try:
            assert mod.global_store() is g
            fresh = mod.reset_global_store()
            assert fresh is not g and mod.global_store() is fresh
            assert mod.set_global_store(s) is s and mod.global_store() is s
        finally:
            mod.set_global_store(g)


# --------------------------------------------------------------------------- #
# finders
# --------------------------------------------------------------------------- #


def seed_mixed(m, store):
    """Distros, tasks and hosts on every branch of the finders: disabled
    and static distros, a container-pool parent, tasks by status,
    activation, priority, platform, secondary distros and blocked
    dependencies, hosts by status and owner."""
    D, HAS = m.distro.Distro, m.distro.HostAllocatorSettings
    for d in (
        D(id="z-ec2", provider="ec2-fleet", host_allocator_settings=HAS(
            maximum_hosts=4, minimum_hosts=1)),
        D(id="a-off", disabled=True),
        D(id="static-off", provider="static", disabled=True),
        D(id="parent", provider="docker"),
        D(id="m1", single_task_distro=True),
    ):
        m.distro.insert(store, d)
    store.collection("config").upsert(
        {"_id": "container_pools", "pools": [{"id": "p", "distro": "parent"}]})
    T_ = m.task.Task
    tasks = make_tasks(m, "z-ec2", 4) + make_tasks(m, "m1", 3) + [
        T_(id="t-dispatched", distro_id="m1", status="dispatched", activated=True),
        T_(id="t-inactive", distro_id="m1", activated=False),
        T_(id="t-neg", distro_id="m1", activated=True, priority=-1),
        T_(id="t-container", distro_id="m1", activated=True,
           execution_platform="container"),
        T_(id="t-second", distro_id="a-off", activated=True,
           secondary_distros=["m1", "z-ec2"]),
        T_(id="t-blocked", distro_id="m1", activated=True, depends_on=[
            m.task.Dependency(task_id="z-ec2-t0", unattainable=True)]),
        T_(id="t-override", distro_id="m1", activated=True,
           override_dependencies=True, depends_on=[
               m.task.Dependency(task_id="gone", unattainable=True)]),
        T_(id="t-done", distro_id="m1", status="success", activated=True),
    ]
    m.task.insert_many(store, tasks[:0:-1])
    m.task.insert(store, tasks[0])
    H = m.host.Host
    m.host.insert(store, H(id="h-static", distro_id="static-off",
                           status="running", creation_time=NOW))
    m.host.insert_many(store, [
        H(id="h-run", distro_id="z-ec2", status="running", creation_time=NOW),
        H(id="h-intent", distro_id="z-ec2", creation_time=NOW),
        H(id="h-user", distro_id="m1", status="running", started_by="alice",
          creation_time=NOW),
        H(id="h-dead", distro_id="m1", status="terminated", creation_time=NOW),
        H(id="h-build", distro_id="m1", status="building", creation_time=NOW,
          running_task="t-done", running_task_group="g"),
    ])
    return store


def finder_reads(m, store):
    """Every finder and read the tick calls, as comparable plain values."""
    ids = lambda objs: [o.id for o in objs]  # noqa: E731
    docs = lambda objs: [o.to_doc() for o in objs]  # noqa: E731
    distro_ids = [d["_id"] for d in m.distro.coll(store).find()]
    task_ids = [d["_id"] for d in m.task.coll(store).find()]
    return {
        "distros": docs(m.distro.find_all(store)),
        "needs_planning": ids(m.distro.find_needs_planning(store)),
        "needs_hosts_planning": ids(m.distro.find_needs_hosts_planning(store)),
        "pool_parents": sorted(m.distro._pool_parent_ids(store)),
        "get_distro": [m.distro.get(store, i).to_doc() for i in distro_ids[:3]],
        "runnable": docs(m.task.find_host_runnable(store)),
        "runnable_by_distro": {
            i: ids(m.task.find_host_runnable(store, i)) for i in distro_ids},
        "tasks_found": ids(m.task.find(store, lambda d: d["priority"] >= 0)),
        "by_ids": ids(m.task.by_ids(store, task_ids[::-2] + ["missing"])),
        "get_task": [m.task.get(store, i).to_doc() for i in task_ids[:3]],
        "hosts": docs(m.host.find(store)),
        "active": ids(m.host.all_active_hosts(store)),
        "active_by_distro": {
            i: ids(m.host.all_active_hosts(store, i)) for i in distro_ids},
        "active_docs": [m.host.is_active_host_doc(d)
                        for d in m.host.coll(store).find()],
        "intents": m.host.count_intents_in_flight(store),
    }


def seed_problem(name, m, store):
    if name == "mixed":
        return seed_mixed(m, store)
    if name == "tick":
        seed_tick_problem(m, store)
        return store
    if name == "quota":
        seed_spec(m, store, [("deep", 30), ("shallow", 3)])
        return store
    seed_generated(m, store, 20, 5_000, {"gen1": 1, "gen2": 2}[name],
                   capacity=True)
    return store


@pytest.mark.parametrize("name", ["mixed", "tick", "quota", "gen1", "gen2"])
def test_finders_return_the_same_ids_in_the_same_order(name):
    j = finder_reads(J, seed_problem(name, J, j_store.Store()))
    t = finder_reads(T, seed_problem(name, T, t_store.Store()))
    assert t == j
    if name == "mixed":
        assert j["needs_planning"] == ["z-ec2", "static-off", "m1"]
        assert "t-blocked" not in [d["_id"] for d in j["runnable"]]
        assert j["intents"] == 1


def test_model_documents_round_trip_in_both_packages():
    js = seed_mixed(J, j_store.Store())
    ts = seed_mixed(T, t_store.Store())
    for mod in ("distro", "task", "host"):
        j_docs = getattr(J, mod).coll(js).find()
        t_docs = getattr(T, mod).coll(ts).find()
        assert t_docs == j_docs, mod
        for m, d in ((T, j_docs[0]), (J, t_docs[0])):
            cls = {"distro": m.distro.Distro, "task": m.task.Task,
                   "host": m.host.Host}[mod]
            assert cls.from_doc(d).to_doc() == d, mod
    t_task = T.task.get(ts, "z-ec2-t0")
    j_task = J.task.get(js, "z-ec2-t0")
    assert t_task.queue_row() == j_task.queue_row()
    assert dataclasses.astuple(t_task.fetch_expected_duration()) == (
        dataclasses.astuple(j_task.fetch_expected_duration()))
    assert t_task.time_in_queue(NOW) == j_task.time_in_queue(NOW)


def test_scripted_problems_are_the_test_files_own():
    """The port's seeding helpers seed, through the JAX models, the very
    documents tests/test_tick.py and tests/test_capacity.py seed."""
    from test_capacity import seed as capacity_seed
    from test_tick import seed_problem as tick_seed

    for ours, theirs in (
        (lambda s: seed_tick_problem(J, s), tick_seed),
        (lambda s: seed_spec(J, s, [("deep", 30), ("shallow", 3)]),
         lambda s: capacity_seed(s, [("deep", 30), ("shallow", 3)])),
    ):
        a, b = j_store.Store(), j_store.Store()
        ours(a)
        theirs(b)
        for coll in ("distros", "tasks", "hosts"):
            assert a[coll].find() == b[coll].find(), coll


# --------------------------------------------------------------------------- #
# config sections across the packages
# --------------------------------------------------------------------------- #

SECTIONS = {
    "ServiceFlags": dict(release_mode_disabled=True, scheduler_disabled=True),
    "CapacityConfig": dict(pool_quotas={"mock": 8}, pool_prices={"docker": 0.3},
                           fleet_intent_budget=40, iterations=12,
                           fused="two_call"),
    "OverridesConfig": dict(overrides=[
        {"section_id": "capacity", "field": "iterations", "value": 7}]),
    "ReleaseModeConfig": dict(distro_max_hosts_factor=1.5,
                              target_time_seconds_override=900),
}


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_config_section_reads_the_same_across_packages(section):
    j_cls = getattr(j_settings, section)
    t_cls = getattr(t_settings, section)
    kw = SECTIONS[section]
    for w_cls, r_cls, store in ((j_cls, t_cls, j_store.Store()),
                                (t_cls, j_cls, t_store.Store())):
        w_cls(**kw).set(store)
        got = r_cls.get(store)
        assert dataclasses.asdict(got) == dataclasses.asdict(w_cls(**kw))
        assert store.collection(t_settings.CONFIG_COLLECTION).get(
            t_cls.section_id) == {**dataclasses.asdict(w_cls(**kw)),
                                  "_id": t_cls.section_id}


def test_overrides_apply_in_both_packages():
    ov = [{"section_id": "capacity", "field": "iterations", "value": 7},
          {"section_id": "release_mode", "field": "distro_max_hosts_factor",
           "value": -1.0}]
    for m in (J, T):
        store = m.store.Store()
        m.settings.CapacityConfig(pool_quotas={"mock": 3}).set(store)
        m.settings.ReleaseModeConfig(distro_max_hosts_factor=2.0).set(store)
        m.settings.OverridesConfig(overrides=ov).set(store)
        cap = m.settings.CapacityConfig.get(store)
        assert (cap.iterations, cap.pool_quotas) == (7, {"mock": 3})
        assert m.settings.CapacityConfig.get_base(store).iterations == 48
        # an override the validator rejects falls back to the stored base
        assert m.settings.ReleaseModeConfig.get(
            store).distro_max_hosts_factor == 2.0


@pytest.mark.parametrize("bad", [
    dict(iterations=0), dict(fused="sometimes"), dict(price_weight=-1.0),
    dict(pool_quotas={"mock": -2}), dict(affinity_anneal=0.2),
])
def test_config_validation_matches_jax(bad):
    errors = []
    for cls in (j_settings.CapacityConfig, t_settings.CapacityConfig):
        with pytest.raises(ValueError) as exc:
            cls(**bad).set(j_store.Store())
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_lock_factories_and_intent_hosts_match_jax():
    import threading

    from evergreen_tpu.utils import lockcheck as j_lockcheck
    from evergreen_tpu_torch.utils import lockcheck as t_lockcheck

    for mod in (j_lockcheck, t_lockcheck):
        lock, rlock = mod.make_lock("r"), mod.make_rlock("r")
        with lock:
            assert not lock.acquire(blocking=False)
        with rlock:
            with rlock:  # reentrant
                pass
        cond = mod.make_condition("r")
        with cond:
            assert not cond.wait(timeout=0.01)
    # with the lock-order witness off, the primitives themselves
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EVERGREEN_TPU_LOCKCHECK", raising=False)
        assert isinstance(t_lockcheck.make_lock("r"), type(threading.Lock()))
        assert isinstance(t_lockcheck.make_rlock("r"), type(threading.RLock()))
    j, t = (m.host.new_intent("d1", "ec2-fleet") for m in (J, T))
    assert t.id.startswith("evg-d1-") and len(t.id) == len(j.id)
    assert len(t.secret) == len(j.secret) == 32 and t.secret != j.secret
    blank = {"_id": "", "secret": "", "creation_time": 0.0}
    assert {**t.to_doc(), **blank} == {**j.to_doc(), **blank}
    assert t.creation_time > 0 and t.status == "initializing"


def test_default_pool_prices_are_a_copy():
    prices = t_manager.default_pool_prices()
    assert prices == j_manager.default_pool_prices()
    prices["mock"] = 5.0
    assert t_manager.default_pool_prices()["mock"] == 0.0
