"""The port's process fleet against the JAX package, shard segment by
shard segment.

One data directory is seeded (``test_torch_fleet_runtime.seed_fleet``:
benchgen's phantom ``running_task`` claims kept, and some tasks left in
flight on hosts that are gone, so the boot's recovery pass acts) and
copied before any spawn. The port's fleet (``FleetSupervisor(...,
device="cpu", solver="always")``: worker processes on the CPU, the
stacked solve served by the supervisor) boots on the original, ticks
rounds, hands one distro over (``migrate``) and stops. The JAX package
runs the same sequence in-process over the copy: ``DurableStore(shard_id=
k)``, ``run_recovery_pass`` at the supervisor's recovery anchor,
``run_tick`` with the JAX worker's options at the same ``now``s, and the
handoff through its ``apply_release`` / ``apply_prime`` and done-mark.
JAX shard workers cannot tick in this sandbox (JAX 0.9; ROADMAP
"Reference caveats"), so the JAX side stays in one process. After the
stop every shard's documents, read back from its segment, equal JAX's
(intent and event ids, intents' secrets and wall-clock creation times
canonicalised: they come from ``uuid4``, one process-wide event sequence
and the clock), in harness and in service options; the hellos' recovery
counts equal JAX's reports.
"""
import copy
import json
import shutil

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.parallel import topology as j_topology  # noqa: E402
from evergreen_tpu.scheduler import recovery as j_recovery  # noqa: E402
from evergreen_tpu.scheduler import sharded_plane as j_sharded  # noqa: E402
from evergreen_tpu.scheduler import wrapper as j_wrapper  # noqa: E402
from evergreen_tpu.storage import durable as j_durable  # noqa: E402

from evergreen_tpu_torch.storage.durable import DurableStore  # noqa: E402
from evergreen_tpu_torch.utils.benchgen import NOW  # noqa: E402

from test_torch_fleet_runtime import fleet, seed_fleet  # noqa: E402
from test_torch_solve import x64  # noqa: E402,F401

N_SHARDS = 2
TICK_S = 15.0
ROUNDS = 3
#: the handoff lands between rounds 2 and 3
MIGRATE_AFTER = 2

JAX_OPTIONS = {
    # the JAX worker's tick_options (evergreen_tpu/runtime/worker.py:490-507)
    "harness": dict(create_intent_hosts=False, underwater_unschedule=False,
                    use_cache=False),
    "service": dict(create_intent_hosts=True, use_cache=True, solve_deadline_s=10.0,
                    tick_budget_s=12.0, async_persist=True),
}


@pytest.fixture
def no_jax_tracing():
    from evergreen_tpu.utils import tracing as j_tracing

    prev = j_tracing.set_tracing_enabled(False)
    yield
    j_tracing.set_tracing_enabled(prev)


def strand_some_tasks(data_dir):
    """Leave two tasks of each shard in flight on hosts that do not exist,
    written without a lease (epoch 0), so recovery step 2 acts."""
    for k in range(N_SHARDS):
        s = DurableStore(str(data_dir), shard_id=k)
        for j, doc in enumerate(s.collection("tasks").find()[:2]):
            s.collection("tasks").update(doc["_id"], {
                "status": "dispatched" if j else "started", "host_id": f"gone-{k}-{j}",
                "dispatch_time": NOW - 3600.0, "last_heartbeat": NOW - 3600.0})
        s.sync_persist()
        s.close()


def canon(doc):
    doc = copy.deepcopy(doc)
    if str(doc.get("_id", "")).startswith("evt-"):
        doc["_id"] = "evt"
    elif doc.get("status") == "initializing" and str(doc.get("_id", "")).startswith("evg-"):
        doc["_id"] = doc["_id"].rsplit("-", 1)[0]
        doc["secret"] = ""
        doc["creation_time"] = 0.0
    if "payload" in doc:
        doc["payload"] = {c: [canon(d) for d in ds] for c, ds in doc["payload"].items()}
    return doc


def shard_docs(store):
    return json.loads(json.dumps({
        n: [canon(d) for d in store.collection(n).find()]
        for n in sorted(store._collections) if len(store.collection(n))
    }, default=str))


def jax_migrate(stores, distro, src, dst, seq, now):
    """The worker's release / prime / done legs, on JAX's modules."""
    topo = j_topology.ShardTopology(N_SHARDS)
    topo.affinity = j_topology.ShardTopology.affinity_from_store(stores[src])
    rep = topo.placement_key(distro)
    group = sorted(d["_id"] for d in stores[src].collection("distros").find()
                   if topo.placement_key(d["_id"]) == rep)
    payload = j_sharded.handoff_payload(stores[src], group)
    rec = j_sharded.handoff_record(distro, group, src, dst, seq, now, payload)
    j_sharded.apply_release(stores[src], rec)
    j_sharded.apply_prime(stores[dst], json.loads(json.dumps(rec)))
    stores[src].collection(j_sharded.HANDOFFS_COLLECTION).update(rec["_id"],
                                                                 {"state": "done"})


def jax_fleet(data_dir, mode, migration, deadline=True):
    """The JAX package's in-process run of the fleet's sequence."""
    opts = dict(JAX_OPTIONS[mode])
    if not deadline:
        opts["solve_deadline_s"] = 0.0
    opts = j_wrapper.TickOptions(**opts)
    stores = [j_durable.DurableStore(str(data_dir), shard_id=k) for k in range(N_SHARDS)]
    reports = [j_recovery.run_recovery_pass(s, now=NOW).to_doc() for s in stores]
    for r in range(ROUNDS):
        if r == MIGRATE_AFTER:
            jax_migrate(stores, *migration)
        for s in stores:
            res = j_wrapper.run_tick(s, opts, now=NOW + (r + 1) * TICK_S)
            assert res.degraded == "", res.degraded
            s.sync_persist()
    docs = [shard_docs(s) for s in stores]
    for s in stores:
        s.close()
    return reports, docs


@pytest.mark.parametrize("mode", ["harness", "service"])
def test_fleet_writes_the_jax_documents(mode, tmp_path, x64, no_jax_tracing):
    live, twin = tmp_path / "fleet", tmp_path / "jax"
    seed_fleet(live, N_SHARDS, distros=4, tasks=24, claims=True)
    strand_some_tasks(live)
    shutil.copytree(live, twin)
    sup = fleet(live, N_SHARDS, seed=False, harness=mode == "harness",
                solver="always")
    try:
        sup.start()
        hellos = [h.hellos[0] for h in sup.handles.values()]
        modes = []
        for r in range(ROUNDS):
            if r == MIGRATE_AFTER:
                st = sup.broadcast("load", "load")
                src = next(k for k, v in sorted(st.items()) if len(v["reps"]) > 1)
                distro = sorted(st[src]["reps"].values())[0]
                now = NOW + r * TICK_S + 1.0
                rec = sup.migrate(distro, src, 1 - src, now=now)
                assert rec is not None
                migration = (distro, src, 1 - src, rec["seq"], now)
            res = sup.round(now=NOW + (r + 1) * TICK_S)
            assert sorted(res) == [0, 1]
            assert all(v["degraded"] == "" for v in res.values())
            modes.append([res[k]["solve"] for k in (0, 1)])
    finally:
        sup.stop()
    assert modes == [["stacked"] * 2] * ROUNDS
    got = []
    for k in range(N_SHARDS):
        s = DurableStore(str(live), shard_id=k)
        s._journal.close()
        got.append(shard_docs(s))
    # the JAX solve compiles at first use: warm it on a scratch copy with
    # no solve deadline, so the measured run's deadline sees a warm solve
    warm = tmp_path / "warm"
    shutil.copytree(twin, warm)
    jax_fleet(warm, mode, migration, deadline=False)
    reports, want = jax_fleet(twin, mode, migration)
    for k, (hello, report) in enumerate(zip(hellos, reports)):
        assert hello["recovered"] == {
            "released_claims": len(report["released_claims"]),
            "stranded_reset": len(report["stranded_reset"]),
            "stale_frames_dropped": report["stale_frames_dropped"]}, k
        assert report["stranded_reset"] and report["released_claims"], k
    for k in range(N_SHARDS):
        assert sorted(got[k]) == sorted(want[k]), k
        for coll in want[k]:
            assert got[k][coll] == want[k][coll], (k, coll)
    assert any("shard_handoffs" in g for g in got)
