"""The service's tick on the durable store, through the port against the
JAX package.

Each package's ``run_tick`` runs on its own ``DurableStore`` (in its own
directory under ``tmp_path``), seeded with the same documents: the JAX
package's on JAX's CPU backend, the port's with ``device="cpu"``, both
with ``use_cache=True`` (the TickCache and the resident plane), as the
service runs them. The ``world`` fixture of ``test_torch_tick.py`` fixes
the clock and gives both runs the same uuid4 stream and event sequence,
so every tick writes the same documents and the WAL holds the same
records (group frames included, ``ts`` too, the clock being fixed). Both
packages' tracing is off (``no_jax_tracing``): span ids come from each
package's own sequence, so span documents riding the tick's frame are
held apart, canonicalised, in ``tests/test_torch_tracing.py``.
Compared after every tick: the documents the tick writes, the
``TickResult``, the persister's write shapes; after the run, the WAL's
records and what each package recovers from the other's directory. A
recovered document is the JSON of the live one (a queue row is a tuple
in memory and a list after replay, in either package), so recovered
documents are compared with the live ones through ``jsonable``.
"""
import copy
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.scheduler import resident as j_resident  # noqa: E402
from evergreen_tpu.storage import durable as j_durable  # noqa: E402
from evergreen_tpu.storage import lease as j_lease  # noqa: E402
from evergreen_tpu.utils import benchgen as j_benchgen  # noqa: E402

from evergreen_tpu_torch.ops import _build, resident_ops, solve  # noqa: E402
from evergreen_tpu_torch.scheduler import resident as t_resident  # noqa: E402
from evergreen_tpu_torch.scheduler import wrapper as t_wrapper  # noqa: E402
from evergreen_tpu_torch.storage import durable as t_durable  # noqa: E402
from evergreen_tpu_torch.storage import lease as t_lease  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402

from test_torch_solve import x64  # noqa: E402,F401
from test_torch_tick import (  # noqa: E402,F401
    COLLECTIONS,
    NOW,
    Side,
    assert_same,
    churn,
    problem_docs,
    record,
    sides,
    world,
)

DURABLE = {"jax": (j_durable, j_lease, j_resident),
           "port": (t_durable, t_lease, t_resident)}


def config_docs(n_distros=20, n_tasks=4000, seed=0):
    """``generate_problem(n_distros, n_tasks)`` as documents, every
    distro in the capacity program (as the service's config 3 cell)."""
    distros, tbd, hbd, _, _ = j_benchgen.generate_problem(n_distros, n_tasks, seed=seed)
    docs = problem_docs(distros, tbd, hbd)
    for doc in docs["distros"]:
        doc["planner_settings"]["capacity"] = "tpu"
    docs["config"] = [{"_id": "capacity", "pool_quotas": {"mock": 20 * n_distros},
                       "fleet_intent_budget": 2 * n_distros}]
    return docs


def durable_sides(tmp_path, docs, leased=False):
    """A JAX side and a port side as ``test_torch_tick.sides`` makes
    them, each on a DurableStore in ``tmp_path/<package>`` holding
    ``docs`` (seeded through the journal, one line per batch)."""
    out = []
    for side in sides({}):
        durable, lease_mod, _ = DURABLE[side.name]
        d = str(tmp_path / side.name)
        lease = None
        if leased:
            lease = lease_mod.FileLease(os.path.join(d, "writer.lease"), ttl_s=60.0)
            assert lease.try_acquire()
        store = durable.DurableStore(d, lease=lease)
        for coll, ds in docs.items():
            store.collection(coll).insert_many(copy.deepcopy(ds))
        side.store, side.lease, side.dir = store, lease, d
        out.append(side)
    return out


def jsonable(x):
    return json.loads(json.dumps(x))


def wal_records(d):
    with open(os.path.join(d, t_durable.WAL_FILE)) as fh:
        return [json.loads(line) for line in fh]


def steal(side):
    _, lease_mod, _ = DURABLE[side.name]
    thief = lease_mod.FileLease(os.path.join(side.dir, "writer.lease"), ttl_s=60.0)
    thief.ttl_s = -1.0  # anything is stale: steal at once
    assert thief.try_acquire()
    thief.ttl_s = 60.0
    return thief


SERVICE = [(NOW, None), (NOW + 15, churn(7)), (NOW + 30, None)]


@pytest.fixture(autouse=True)
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


@pytest.mark.parametrize("async_persist", [False, True], ids=["sync", "async"])
def test_durable_ticks_match_jax(tmp_path, world, async_persist):
    """Prime, churn, quiet at ``generate_problem(20, 4000)``: the port's
    tick on its DurableStore writes JAX's documents, results and WAL
    records (one group frame a tick), and each package recovers the
    other's directory to the same documents in the same order."""
    docs = config_docs()
    opts = dict(use_cache=True, async_persist=async_persist)
    runs, walls = {}, {}
    for side in durable_sides(tmp_path, docs):
        world()
        n0 = len(wal_records(side.dir))
        runs[side.name] = [record(side, now, before, **opts) for now, before in SERVICE]
        side.store.sync_persist()
        recs = wal_records(side.dir)
        frames = [r for r in recs[n0:] if r["o"] == "g"]
        # a tick's writes ride one frame (the quiet tick writes nothing);
        # the churn between is per-op
        assert len(frames) == 2, side.name
        walls[side.name] = recs
        side.store._journal.close()
    assert_same(runs["jax"], runs["port"])
    assert [t["result"]["planner_used"] for t in runs["port"]] == ["tpu"] * 3
    assert runs["port"][1]["shapes"]["rewritten"] == 0
    assert walls["port"] == walls["jax"]
    for reader, writer in (("port", "jax"), ("jax", "port")):
        durable = DURABLE[reader][0]
        got = durable.DurableStore(str(tmp_path / writer))
        for c in COLLECTIONS:
            assert got.collection(c).find() == jsonable(runs[writer][-1]["docs"][c]), (
                reader, c)
        got._journal.close()


def test_async_commit_overlaps_and_the_barrier_orders_it(tmp_path, world):
    """With ``async_persist`` the frame is still queued when the tick
    returns (the flusher holds it at the ``wal.commit`` seam); the next
    tick's barrier waits it out before writing, so its own frame lands
    after it; the ``wal_commit`` phase is observed every tick."""
    import threading

    _, side = durable_sides(tmp_path, config_docs(6, 600))
    world()
    gate = threading.Event()
    t_faults.install(t_faults.FaultPlan().at(
        "wal.commit", 0, t_faults.Fault("call", fn=lambda: gate.wait(10.0))))
    commits0 = t_wrapper.TICK_PHASE_MS.state(phase="wal_commit")[2]
    try:
        res = side.tick(NOW, use_cache=True, async_persist=True)
        assert res.degraded == "" and side.store.flush_backlog() == 1
        threading.Timer(0.05, gate.set).start()
        side.tick(NOW + 15, use_cache=True, async_persist=True)
    finally:
        gate.set()
        t_faults.uninstall()
    side.store.sync_persist()
    assert side.store.flush_backlog() == 0
    frames = [r for r in wal_records(side.dir) if r["o"] == "g"]
    assert len(frames) == 2 and frames[0]["s"] < frames[1]["s"]
    assert t_wrapper.TICK_PHASE_MS.state(phase="wal_commit")[2] == commits0 + 2
    gauges = t_wrapper.overload_mod.monitor_for(side.store).gauges()
    assert "store_latency_ms" in gauges and gauges["wal_backlog"] == 0.0


def test_fenced_tick_writes_nothing_and_drops_the_plane(tmp_path, world):
    """A holder whose lease was stolen between ticks: the tick returns
    ``degraded="fenced"`` with nothing planned, writes no document and
    no WAL byte, and invalidates the resident plane (reason "fenced");
    the new holder's store then ticks to JAX's documents."""
    docs = config_docs(6, 600)
    runs = {}
    for side in durable_sides(tmp_path, docs, leased=True):
        world()
        first = record(side, NOW, None, use_cache=True, async_persist=True)
        side.store.sync_persist()
        before = {c: copy.deepcopy(side.store.collection(c).find()) for c in COLLECTIONS}
        size = os.path.getsize(os.path.join(side.dir, t_durable.WAL_FILE))
        thief = steal(side)
        fenced = side.tick(NOW + 15, use_cache=True, async_persist=True)
        assert (fenced.degraded, fenced.queues, fenced.planner_used) == ("fenced", {}, "")
        assert side.store.fenced and side.lease.lost
        assert os.path.getsize(os.path.join(side.dir, t_durable.WAL_FILE)) == size
        for c in COLLECTIONS:
            assert side.store.collection(c).find() == before[c], c
        plane = DURABLE[side.name][2].peek_resident_plane(side.store)
        assert (plane._ready, plane._pending_reason) == (False, "fenced")
        # a fenced store stays fenced: the next tick is refused too
        assert side.tick(NOW + 30, use_cache=True).degraded == "fenced"
        new = DURABLE[side.name][0].DurableStore(side.dir, lease=thief)
        assert new.epoch == 2
        side.store = new
        runs[side.name] = [first, record(side, NOW + 30, None, use_cache=True,
                                         async_persist=True)]
        new.sync_persist()
        plane = DURABLE[side.name][2].peek_resident_plane(new)
        assert plane.rebuild_reasons == {"cold": 1}
    assert_same(runs["jax"], runs["port"])


def test_epoch_change_rebuilds_the_plane_like_jax(tmp_path, world):
    """A store whose fencing epoch moves between ticks: the next tick's
    plane rebuilds with reason "epoch" and then tracks the new epoch,
    with JAX's counters."""
    stats = {}
    for side in durable_sides(tmp_path, config_docs(6, 600)):
        world()
        record(side, NOW, None, use_cache=True)
        side.store.epoch = 7
        record(side, NOW + 15, churn(3), use_cache=True)
        record(side, NOW + 30, None, use_cache=True)
        plane = DURABLE[side.name][2].peek_resident_plane(side.store)
        assert plane.epoch == 7
        stats[side.name] = {k: v for k, v in plane.stats().items()
                            if not k.startswith("mirror")}
    assert stats["port"] == stats["jax"]
    assert stats["port"]["rebuild_reasons"] == {"cold": 1, "epoch": 1}


@pytest.mark.parametrize("async_persist", [False, True], ids=["sync", "async"])
def test_wal_commit_fault_degrades_to_persist_failed(tmp_path, world, async_persist):
    """A ``wal.commit`` fault on tick 2's frame: sync, tick 2 itself
    degrades to "persist-failed"; async, the error is deferred to tick
    3's barrier. Either way the persister resets (the next tick rewrites
    every queue), a heal checkpoint covers the lost frame, and the
    packages agree on results, shapes and documents; the directory then
    recovers to the in-memory truth."""
    from evergreen_tpu.utils import faults as j_faults

    docs = config_docs(6, 600)
    opts = dict(use_cache=True, async_persist=async_persist)
    runs = {}
    for side in durable_sides(tmp_path, docs):
        world()
        f = j_faults if side.name == "jax" else t_faults
        out = [record(side, NOW, None, **opts)]
        f.install(f.FaultPlan().at("wal.commit", 0, f.Fault("raise")))
        try:
            out.append(record(side, NOW + 15, churn(5), **opts))
            out.append(record(side, NOW + 30, None, **opts))
        finally:
            f.uninstall()
        out.append(record(side, NOW + 45, None, **opts))
        side.store.sync_persist()
        runs[side.name] = out
        side.store._journal.close()
        again = DURABLE[side.name][0].DurableStore(side.dir)
        for c in COLLECTIONS:
            assert again.collection(c).find() == jsonable(out[-1]["docs"][c]), c
    assert_same(runs["jax"], runs["port"])
    degraded = [t["result"]["degraded"] for t in runs["port"]]
    failed = 1 if not async_persist else 2
    assert degraded == ["" if k != failed else "persist-failed" for k in range(4)]
    # the reset persister rewrites every queue on the tick after the loss
    after = runs["port"][failed + 1 if not async_persist else failed]
    assert after["shapes"]["rewritten"] == len(after["result"]["queues"])


@pytest.mark.parametrize("error", ["kernel", "mirror"])
def test_card_fault_raises_out_of_an_async_tick_with_the_group_committed(
        tmp_path, world, monkeypatch, error):
    """A ``KernelError`` or ``MirrorError`` raises out of an
    ``async_persist`` tick as out of any tick — no serial tick, no WAL
    degradation — and the tick's ``finally`` still commits the open
    group: what it buffered (here a write made inside the failing call)
    reaches the WAL as one frame, and the next write is a plain line."""
    _, side = durable_sides(tmp_path, config_docs(6, 600))
    world()
    store = side.store

    if error == "kernel":
        exc, target = _build.KernelError, (solve, "fused_distro_stats")

        def broken(*args, **kwargs):
            store.collection("events").upsert({"_id": "inside-the-solve"})
            raise _build.KernelError("CUDA launch failed with cudaError_t 98")
    else:
        exc, target = resident_ops.MirrorError, (resident_ops, "_upload")
        mirror = resident_ops.DeviceMirror(device="cpu")
        monkeypatch.setitem(t_resident._planes, store,
                            t_resident.ResidentPlane(store, mirror=mirror))

        def broken(buf, dev):
            store.collection("events").upsert({"_id": "inside-the-solve"})
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
    monkeypatch.setattr(*target, broken)
    n0 = len(wal_records(side.dir))
    with pytest.raises(exc):
        side.tick(NOW, use_cache=True, async_persist=True)
    store.sync_persist()
    assert store._journal._group is None
    recs = wal_records(side.dir)[n0:]
    assert [r["o"] for r in recs] == ["g"]
    assert any(op.get("d", {}).get("_id") == "inside-the-solve" for op in recs[0]["rs"])
    assert store.collection("task_queues").find() == []
    store.collection("events").upsert({"_id": "after"})
    assert wal_records(side.dir)[-1]["o"] == "p"
    breaker = t_wrapper.solve_breaker_for(store)
    assert breaker.state == "closed" and breaker._consecutive_failures == 0


def test_replayed_copy_ticks_like_the_live_store(tmp_path, world, monkeypatch):
    """What a SIGKILL after tick 2's barrier leaves (a copy of the
    directory, the store not closed) reopens to the live documents, and
    a churn tick on the reopened store — a cold plane — writes what the
    live store's warm tick writes."""
    _, side = durable_sides(tmp_path, config_docs(6, 600))
    world()
    opts = dict(use_cache=True, async_persist=True)
    record(side, NOW, None, **opts)
    record(side, NOW + 15, churn(2), **opts)
    side.store.sync_persist()
    copy_dir = str(tmp_path / "crashed")
    shutil.copytree(side.dir, copy_dir)
    reopened = t_durable.DurableStore(copy_dir)
    for c in COLLECTIONS + ("distros", "config"):
        assert reopened.collection(c).find() == jsonable(side.store.collection(c).find()), c
    replay = Side("port", reopened, *[getattr(side, k) for k in (
        "wrapper", "persister", "faults", "overload", "settings", "queue")])
    import itertools
    import random
    import uuid

    from evergreen_tpu_torch.models import event as t_event

    ticks = {}
    for name, s in (("live", side), ("replayed", replay)):
        rng = random.Random(99)
        monkeypatch.setattr(uuid, "uuid4", lambda r=rng: uuid.UUID(int=r.getrandbits(128)))
        monkeypatch.setattr(t_event, "_SEQ", itertools.count(1000))
        ticks[name] = record(s, NOW + 30, churn(4), **opts)
    assert ticks["replayed"]["result"] == ticks["live"]["result"]
    for c in COLLECTIONS:
        assert jsonable(ticks["replayed"]["docs"][c]) == jsonable(ticks["live"]["docs"][c]), c
    plane = t_resident.peek_resident_plane(reopened)
    assert plane.rebuild_reasons == {"cold": 1}


def churn_some(distro_ids):
    """A churn that reaches only ``distro_ids``' queues: a tenth of their
    runnable tasks raised in priority."""

    def step(store):
        tasks = store.collection("tasks")
        live = [d["_id"] for d in tasks.find() if d["distro_id"] in distro_ids
                and d["status"] == "undispatched" and d["activated"]]
        for tid in live[::10]:
            tasks.update(tid, {"priority": 90})

    return step


def test_replayed_stores_restamp_like_jax(tmp_path, world):
    """A store reopened from a crash copy has a fresh persister: its first
    tick rewrites the queues that the live store's tick skips, stamping
    each with the tick's time and version. With a churn that reaches a
    quarter of the distros, so that the live tick skips the rest, the
    JAX package's replayed copy and the port's, ticked alike, write the
    same documents, stamps included, the same results and persister
    shapes, and the same WAL records."""
    opts = dict(use_cache=True, async_persist=True)
    some = churn_some({f"d{k:03d}" for k in range(5)})
    runs, walls = {}, {}
    for side in durable_sides(tmp_path, config_docs()):
        world()
        record(side, NOW, None, **opts)
        record(side, NOW + 15, churn(2), **opts)
        side.store.sync_persist()
        copy_dir = str(tmp_path / f"{side.name}-crashed")
        shutil.copytree(side.dir, copy_dir)
        live = record(side, NOW + 30, some, **opts)
        side.store.sync_persist()
        side.store._journal.close()
        side.store = DURABLE[side.name][0].DurableStore(copy_dir)
        n0 = len(wal_records(copy_dir))
        replayed = record(side, NOW + 30, some, **opts)
        side.store.sync_persist()
        runs[side.name] = [live, replayed]
        walls[side.name] = wal_records(copy_dir)[n0:]
        side.store._journal.close()
    assert_same(runs["jax"], runs["port"])
    assert walls["port"] == walls["jax"]
    live, replayed = runs["port"]
    # the live tick skipped queues that the fresh persister stamped anew
    assert live["shapes"]["skipped"] > replayed["shapes"]["skipped"]
    restamped = [d["_id"] for d, e in zip(replayed["docs"]["task_queues"],
                                           live["docs"]["task_queues"])
                 if (d["generated_at"], d["v"]) != (e["generated_at"], e["v"])]
    assert restamped
