"""The port's TickCache (``evergreen_tpu_torch/scheduler/cache.py``)
against the JAX package's, on twin stores.

The same documents are inserted into a JAX store and a port store, and
the same churn is applied to both through the collection API. After
every step the port's warm gather equals the JAX cache's warm gather and
the port's own cold ``gather_tick_inputs`` (the same tasks per distro in
store order, hosts, running estimates and deps-met flags), and the
cache's side outputs — the persister's stamp candidates and the resident
plane's delta stream — equal the JAX cache's. The store's change listeners, which the cache rides on, fire
on every write path as the JAX store's do.
"""
import copy
import random

import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu.globals import HostStatus, Requester, TaskStatus  # noqa: E402
from evergreen_tpu.models.distro import Distro, HostAllocatorSettings  # noqa: E402
from evergreen_tpu.models.host import Host  # noqa: E402
from evergreen_tpu.models.task import Task  # noqa: E402
from evergreen_tpu.scheduler import cache as j_cache  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402

from evergreen_tpu_torch.scheduler import cache as t_cache  # noqa: E402
from evergreen_tpu_torch.scheduler import wrapper as t_wrapper  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.utils.benchgen import generate_problem  # noqa: E402

NOW = 1_700_000_000.0


def mk_task(i, distro="d1", **kw):
    defaults = dict(
        id=f"t{i:03d}", distro_id=distro, status=TaskStatus.UNDISPATCHED.value,
        activated=True, requester=Requester.REPOTRACKER.value,
        activated_time=NOW - 60, create_time=NOW - 100,
        expected_duration_s=60.0,
    )
    defaults.update(kw)
    return Task(**defaults)


def twin_stores(docs):
    """(JAX store, port store), each holding ``docs`` (collection →
    documents, inserted in order)."""
    out = []
    for mod in (j_store, t_store):
        store = mod.Store()
        for coll, ds in docs.items():
            store.collection(coll).insert_many(copy.deepcopy(ds))
        out.append(store)
    return out


def gather_view(tup):
    """A gather's content as plain values (the two packages' objects are
    different classes)."""
    distros, tasks_by_distro, hosts_by_distro, estimates, deps_met = tup
    return (
        [d.id for d in distros],
        {k: [t.id for t in v] for k, v in tasks_by_distro.items()},
        {k: [(h.id, h.status, h.running_task) for h in v]
         for k, v in hosts_by_distro.items()},
        dict(sorted((k, (e.elapsed_s, e.expected_s, e.std_dev_s, e.start_s))
                    for k, e in estimates.items())),
        dict(sorted(deps_met.items())),
    )


def side_view(cache, distro_ids):
    """What else a cache hands the tick: stamp candidates per distro."""
    return {d: cache.stamp_candidates(d) for d in distro_ids}


def churn_step(rng, step, distro_ids, n_ids=40):
    """One random write through the collection API (the same call on
    both stores when ``rng`` is seeded alike)."""
    op = rng.randrange(10)
    tid = f"t{rng.randrange(n_ids):03d}"
    hid = f"h{rng.randrange(12):03d}"
    if op == 0:
        return lambda s: s.collection("tasks").update(
            tid, {"status": TaskStatus.SUCCEEDED.value})
    if op == 1:
        v = rng.random() < 0.5
        return lambda s: s.collection("tasks").update(tid, {"activated": v})
    if op == 2:
        v = rng.choice([-1, 0, 10])
        return lambda s: s.collection("tasks").update(tid, {"priority": v})
    if op == 3:
        doc = mk_task(100 + step, distro=rng.choice(distro_ids),
                      secondary_distros=[distro_ids[-1]]
                      if rng.random() < 0.4 else []).to_doc()
        return lambda s: s.collection("tasks").insert(copy.deepcopy(doc))
    if op == 4:
        deps = [{"task_id": "t000", "status": "success",
                 "unattainable": rng.random() < 0.3, "finished": False}]
        return lambda s: s.collection("tasks").update(tid, {"depends_on": deps})
    if op == 5:
        return lambda s: s.collection("tasks").remove(tid)
    if op == 6:
        v = rng.choice([HostStatus.RUNNING.value, HostStatus.TERMINATED.value,
                        HostStatus.PROVISIONING.value])
        return lambda s: s.collection("hosts").update(hid, {"status": v})
    if op == 7:
        doc = Host(id=f"h{100 + step:03d}", distro_id=rng.choice(distro_ids),
                   status=HostStatus.RUNNING.value, started_by="mci").to_doc()
        return lambda s: s.collection("hosts").insert(copy.deepcopy(doc))
    if op == 8:
        v = {"running_task": rng.choice(["", tid]),
             "started_by": rng.choice(["mci", "user1"])}
        return lambda s: s.collection("hosts").update(hid, v)
    ts = NOW + step
    return lambda s: s.collection("tasks").bulk_update(
        [tid], {"scheduled_time": ts, "dependencies_met_time": ts})


@pytest.mark.parametrize("seed", [4, 5, 7, 8, 9, 11, 17])
def test_warm_gather_tracks_churn_like_jax(seed):
    rng = random.Random(seed)
    ids = ("d1", "d2")
    docs = {
        "distros": [Distro(id=d, host_allocator_settings=HostAllocatorSettings(
            maximum_hosts=5)).to_doc() for d in ids],
        "tasks": [mk_task(i, distro=ids[i % 2]).to_doc() for i in range(30)],
        "hosts": [Host(id=f"h{i:03d}", distro_id=rng.choice(ids),
                       status=HostStatus.RUNNING.value,
                       started_by="mci").to_doc() for i in range(8)],
    }
    js, ts = twin_stores(docs)
    jc, tc = j_cache.TickCache(js), t_cache.TickCache(ts)
    for step in range(80):
        got = gather_view(tc.gather(NOW))
        assert got == gather_view(jc.gather(NOW)), f"step {step}: JAX differs"
        assert got == gather_view(t_wrapper.gather_tick_inputs(ts, NOW)), (
            f"step {step}: cold gather differs")
        assert side_view(tc, ids) == side_view(jc, ids), f"step {step}"
        jd, td = jc.drain_resident_deltas(), tc.drain_resident_deltas()
        assert td == jd, f"step {step}: resident delta stream"
        write = churn_step(rng, step, list(ids))
        for store in (js, ts):
            try:
                write(store)
            except KeyError:
                pass


def test_generated_problem_gather_matches_jax():
    """A generated problem with groups, dependencies, secondary distros
    and running hosts: the warm gather equals JAX's and the cold one
    before and after a churn of finishes, stamps and inserts, and an
    unchanged distro keeps its task list object across the churn (the
    identity the snapshot memo and the resident plane key on)."""
    distros, tbd, hbd, _, _ = generate_problem(
        8, 600, seed=3, task_group_fraction=0.3, dep_fraction=0.3,
        hosts_per_distro=3)
    docs = {
        "distros": [d.to_doc() for d in distros],
        "tasks": [t.to_doc() for ts in tbd.values() for t in ts],
        "hosts": [h.to_doc() for hs in hbd.values() for h in hs],
    }
    for k, doc in enumerate(docs["tasks"]):
        if k % 9 == 0:
            doc["secondary_distros"] = [distros[(k // 9) % 8].id]
    js, ts = twin_stores(docs)
    jc, tc = j_cache.TickCache(js), t_cache.TickCache(ts)
    before = tc.gather(NOW)
    assert gather_view(before) == gather_view(jc.gather(NOW))
    rng = random.Random(3)
    churned = distros[0].id
    live = [d["_id"] for d in docs["tasks"] if d["distro_id"] == churned]
    done = rng.sample(live, 10)
    for store in (js, ts):
        tasks = store.collection("tasks")
        for tid in done:
            tasks.update(tid, {"status": "success"})
        tasks.bulk_update(live[:5], {"scheduled_time": NOW})
        tasks.insert(dict(copy.deepcopy(tasks.get(live[-1])), _id="fresh-1",
                          depends_on=[]))
    after = tc.gather(NOW + 15)
    assert gather_view(after) == gather_view(jc.gather(NOW + 15))
    assert gather_view(after) == gather_view(
        t_wrapper.gather_tick_inputs(ts, NOW + 15))
    assert after[1][churned] is not before[1][churned]
    for d in distros[1:]:
        assert after[1][d.id] is before[1][d.id], d.id
    ids = [d.id for d in distros]
    assert side_view(tc, ids) == side_view(jc, ids)


def test_requalification_keeps_store_order():
    """Deactivate → reactivate must not move a task to the end of the
    cached order (value ties break by input position in the planner)."""
    docs = {
        "distros": [Distro(id="d1", host_allocator_settings=HostAllocatorSettings(
            maximum_hosts=5)).to_doc()],
        "tasks": [mk_task(i).to_doc() for i in range(6)],
    }
    js, ts = twin_stores(docs)
    jc, tc = j_cache.TickCache(js), t_cache.TickCache(ts)
    for cache in (jc, tc):
        cache.gather(NOW)
    for store in (js, ts):
        store.collection("tasks").update("t002", {"activated": False})
    for cache in (jc, tc):
        cache.gather(NOW)
    for store in (js, ts):
        store.collection("tasks").update("t002", {"activated": True})
    got = gather_view(tc.gather(NOW))
    assert got == gather_view(jc.gather(NOW))
    assert got == gather_view(t_wrapper.gather_tick_inputs(ts, NOW))
    assert got[1]["d1"] == [f"t{i:03d}" for i in range(6)]


def test_tick_cache_for_is_one_cache_per_store():
    a, b = t_store.Store(), t_store.Store()
    assert t_wrapper.tick_cache_for(a) is t_wrapper.tick_cache_for(a)
    assert t_wrapper.tick_cache_for(a) is not t_wrapper.tick_cache_for(b)


WRITES = [
    ("insert", lambda c: c.insert({"_id": "x", "v": 1})),
    ("upsert", lambda c: c.upsert({"_id": "a", "v": 2})),
    ("insert_many", lambda c: c.insert_many([{"_id": "y"}, {"_id": "z"}])),
    ("remove", lambda c: c.remove("a")),
    ("remove missing", lambda c: c.remove("nope")),
    ("remove_where", lambda c: c.remove_where(lambda d: d["_id"] < "b")),
    ("clear", lambda c: c.clear()),
    ("compare_and_set", lambda c: c.compare_and_set("a", {"v": 0}, {"v": 3})),
    ("compare_and_set miss", lambda c: c.compare_and_set("a", {"v": 9}, {"v": 3})),
    ("update", lambda c: c.update("b", {"v": 4})),
    ("update missing", lambda c: c.update("nope", {"v": 4})),
    ("update_where", lambda c: c.update_where(lambda d: True, {"w": 1})),
    ("bulk_update", lambda c: c.bulk_update(["b", "a", "nope"], {"w": 2},
                                            only_if=lambda d: d["_id"] != "a")),
    ("patch", lambda c: c.patch("a", {"w": 5})),
    ("patch_list", lambda c: c.patch_list("q", {"rows": ([0], [9])})),
    ("splice_queue", lambda c: c.splice_queue("q", [0], [(0, 7, 0.5, True)])),
    ("mutate", lambda c: c.mutate("b", lambda d: d.update(w=6))),
]


@pytest.mark.parametrize("name,write", WRITES, ids=[w[0] for w in WRITES])
def test_listeners_fire_like_the_jax_store(name, write):
    """Every write path notifies the collection's listeners with the same
    ids, in the same order, as the JAX store's."""
    seen = {}
    for mod in (j_store, t_store):
        coll = mod.Store().collection("c")
        coll.insert_many([{"_id": "a", "v": 0}, {"_id": "b", "v": 0},
                          {"_id": "q", "rows": [1, 2], "sort_value": [0.0, 0.0],
                           "dependencies_met": [True, True]}])
        got = seen[mod.__name__] = []
        coll.add_listener(got.append)
        write(coll)
    assert seen["evergreen_tpu_torch.storage.store"] == (
        seen["evergreen_tpu.storage.store"])
