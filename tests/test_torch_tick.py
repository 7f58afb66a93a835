"""The whole scheduler tick through the port against the JAX package.

The same store is seeded into each package (the same documents, inserted
in the same order), then each package's ``run_tick`` runs the same
sequence of ticks and churn: the JAX package's on JAX's CPU backend, the
port's with ``device="cpu"``; both cold (``use_cache=False``) unless a
test asks for the service's warm tick (``use_cache=True``: the TickCache
and the resident state plane). Intent ids and
secrets come from ``uuid.uuid4``, intent creation times and the overload
ladder's shed records from ``time.time``, and event ids from each
package's process-wide sequence; the ``world`` fixture makes all three
the same for both runs (a seeded ``uuid4``, a fixed clock, sequences
restarted at 0).

Compared after every tick, exactly (both sides run on the CPU, so floats
too): every document of the queue collections (primary and secondary),
tasks, hosts (with the intents), events and shed records, in store
order; the ``TickResult`` counts, planner, degradation, shed list and
overload level; the intent hosts; and the moves of the persister's
write-shape counters (skip, patch, splice, rewrite).
"""
import copy
import dataclasses
import itertools
import random
import time
import uuid

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.models import event as j_event  # noqa: E402
from evergreen_tpu.models import task_queue as j_queue  # noqa: E402
from evergreen_tpu.scheduler import persister as j_persister  # noqa: E402
from evergreen_tpu.scheduler import wrapper as j_wrapper  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.utils import benchgen as j_benchgen  # noqa: E402
from evergreen_tpu.utils import faults as j_faults  # noqa: E402
from evergreen_tpu.utils import overload as j_overload  # noqa: E402

from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.models import event as t_event  # noqa: E402
from evergreen_tpu_torch.models import task_queue as t_queue  # noqa: E402
from evergreen_tpu_torch.scheduler import persister as t_persister  # noqa: E402
from evergreen_tpu_torch.scheduler import wrapper as t_wrapper  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402
from evergreen_tpu_torch.utils import overload as t_overload  # noqa: E402

from test_solver_parity import random_problem  # noqa: E402
from test_torch_solve import x64  # noqa: E402,F401

NOW = 1_700_000_000.0
#: the collections a tick writes, compared document for document
COLLECTIONS = ("task_queues", "task_secondary_queues", "tasks", "hosts",
               "events", "overload_sheds")
SHAPES = ("skipped", "patched", "spliced", "rewritten")


class Side:
    """One package's modules, store and tick options."""

    def __init__(self, name, store, wrapper, persister, faults, overload,
                 settings, queue):
        self.name = name
        self.store = store
        self.wrapper = wrapper
        self.persister = persister
        self.faults = faults
        self.overload = overload
        self.settings = settings
        self.queue = queue

    def tick(self, now, **opts):
        if self.name == "jax":
            return self.wrapper.run_tick(
                self.store,
                self.wrapper.TickOptions(**{"use_cache": False, **opts}),
                now=now)
        return self.wrapper.run_tick(
            self.store, self.wrapper.TickOptions(**opts), now=now, device="cpu")


def sides(docs):
    """A JAX side and a port side, each with a store holding ``docs``
    (collection -> documents, inserted in order)."""
    out = []
    for name, st, mods in (
        ("jax", j_store, (j_wrapper, j_persister, j_faults, j_overload,
                          j_settings, j_queue)),
        ("port", t_store, (t_wrapper, t_persister, t_faults, t_overload,
                           t_settings, t_queue)),
    ):
        store = st.Store()
        for coll, ds in docs.items():
            store.collection(coll).insert_many(copy.deepcopy(ds))
        out.append(Side(name, store, *mods))
    return out


@pytest.fixture
def world(monkeypatch, x64):
    """``restart()`` gives the next package's run the same uuid4 stream
    and event sequence; the clock is fixed for the whole test."""
    monkeypatch.setattr(time, "time", lambda: NOW)

    def restart():
        rng = random.Random(20240611)
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=rng.getrandbits(128)))
        monkeypatch.setattr(j_event, "_SEQ", itertools.count())
        monkeypatch.setattr(t_event, "_SEQ", itertools.count())

    return restart


# --------------------------------------------------------------------------- #
# problems as documents
# --------------------------------------------------------------------------- #


def problem_docs(distros, tbd, hbd, extra_tasks=()):
    return {
        "distros": [d.to_doc() for d in distros],
        "tasks": [t.to_doc() for ts in tbd.values() for t in ts]
        + [t.to_doc() for t in extra_tasks],
        "hosts": [h.to_doc() for hs in hbd.values() for h in hs],
    }


def generated(seed, n_distros=6, n_tasks=600, capacity=False, cmp=()):
    distros, tbd, hbd, _, _ = j_benchgen.generate_problem(
        n_distros, n_tasks, seed=seed, hosts_per_distro=4)
    docs = problem_docs(distros, tbd, hbd)
    for doc in docs["distros"]:
        if capacity:
            doc["planner_settings"]["capacity"] = "tpu"
        if doc["_id"] in cmp:
            doc["planner_settings"]["version"] = "cmpbased"
    if capacity:
        docs["config"] = [dict(
            dataclasses.asdict(j_settings.CapacityConfig(
                pool_quotas={"mock": 20 * n_distros},
                fleet_intent_budget=2 * n_distros)),
            _id="capacity")]
    return docs


def random_docs(seed, cmp_every=0):
    """``test_solver_parity.random_problem`` as documents, with its
    finished external parents, some secondary distros, and (every
    ``cmp_every``-th distro) the cmp-based planner."""
    from evergreen_tpu.models.task import Task

    rng = random.Random(seed)
    distros, tbd, hbd, _, _ = random_problem(rng, n_distros=5, max_tasks=40)
    ext = [Task(id=f"ext-{i}", status="success" if i % 2 == 0 else "failed",
                activated=True) for i in range(5)]
    docs = problem_docs(distros, tbd, hbd, ext)
    ids = [d.id for d in distros]
    for doc in docs["tasks"]:
        if doc["distro_id"] and rng.random() < 0.15:
            doc["secondary_distros"] = [rng.choice(ids)]
    if cmp_every:
        for i, doc in enumerate(docs["distros"]):
            if i % cmp_every == 0:
                doc["planner_settings"]["version"] = "cmpbased"
    return docs


# --------------------------------------------------------------------------- #
# runs and comparisons
# --------------------------------------------------------------------------- #


def churn(seed):
    """A churn step between ticks, the same on both stores: some tasks
    dispatched, some finished, some new, some priorities changed."""

    def step(store):
        rng = random.Random(seed)
        tasks = store.collection("tasks")
        live = [d["_id"] for d in tasks.find()
                if d["status"] == "undispatched" and d["activated"]]
        rng.shuffle(live)
        n = max(1, len(live) // 20)
        for tid in live[:n]:
            tasks.update(tid, {"status": "dispatched"})
        for tid in live[n:2 * n]:
            tasks.update(tid, {"status": "success", "finish_time": NOW})
        for tid in live[2 * n:3 * n]:
            tasks.update(tid, {"priority": rng.choice([0, 5, 60])})
        new = []
        for k, tid in enumerate(live[3 * n:4 * n]):
            doc = copy.deepcopy(tasks.get(tid))
            doc.update(_id=f"{tid}-new{k}", scheduled_time=0.0,
                       dependencies_met_time=0.0, depends_on=[],
                       priority=rng.choice([0, 10]))
            new.append(doc)
        tasks.insert_many(new)

    return step


def record(side, now, before=None, **opts):
    """Tick ``side`` at ``now`` (after ``before`` on its store) and read
    back what the tick wrote."""
    if before is not None:
        before(side.store)
    state = side.persister.persister_state_for(side.store)
    shapes0 = [getattr(state, k) for k in SHAPES]
    res = side.tick(now, **opts)
    return dict(
        result=dict(queues=res.queues, new_hosts=res.new_hosts,
                    n_tasks=res.n_tasks, n_distros=res.n_distros,
                    planner_used=res.planner_used, degraded=res.degraded,
                    shed=res.shed, overload=res.overload,
                    intents=[h.to_doc() for h in res.intent_hosts]),
        shapes={k: getattr(state, k) - v for k, v in zip(SHAPES, shapes0)},
        docs={c: copy.deepcopy(side.store.collection(c).find())
              for c in COLLECTIONS},
    )


def run_both(world, docs, script, setup=None):
    """``script``: [(now, before-step or None, options)]; returns the
    JAX and port records, tick by tick."""
    runs = {}
    for side in sides(docs):
        world()
        if setup is not None:
            setup(side)
        runs[side.name] = [record(side, now, before, **opts)
                           for now, before, opts in script]
    return runs["jax"], runs["port"]


def assert_same(jax_ticks, port_ticks):
    assert len(jax_ticks) == len(port_ticks)
    for k, (j, t) in enumerate(zip(jax_ticks, port_ticks)):
        assert t["result"] == j["result"], f"tick {k}: TickResult"
        assert t["shapes"] == j["shapes"], f"tick {k}: persister shapes"
        for c in COLLECTIONS:
            assert len(t["docs"][c]) == len(j["docs"][c]), (k, c)
            for td, jd in zip(t["docs"][c], j["docs"][c]):
                assert td == jd, (k, c, jd.get("_id"))


TWO_TICKS = [(NOW, None, {}), (NOW + 15, churn(7), {})]


# --------------------------------------------------------------------------- #
# two ticks with churn
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["gen1", "gen2", "gen1+cap", "gen2+cap",
                                  "random3", "random8"])
def test_two_ticks_with_churn_match_jax(name, world):
    if name.startswith("gen"):
        docs = generated(int(name[3]), capacity=name.endswith("+cap"))
    else:
        docs = random_docs(int(name[6:]))
    j, t = run_both(world, docs, TWO_TICKS)
    assert_same(j, t)
    assert [x["result"]["planner_used"] for x in t] == ["tpu", "tpu"]
    assert all(x["result"]["degraded"] == "" for x in t)
    # tick 1 writes every queue; tick 2 patches, splices or skips
    assert t[0]["shapes"]["rewritten"] == len(t[0]["result"]["queues"])
    assert t[1]["shapes"]["rewritten"] < len(t[1]["result"]["queues"])
    assert t[1]["shapes"]["patched"] + t[1]["shapes"]["spliced"] > 0
    if name.endswith("+cap"):
        assert t[0]["result"]["intents"]


def test_unchanged_tick_skips_every_queue_like_jax(world):
    """Ticks at one ``now`` with no intents to create: the second patches
    the queues whose tasks the first stamped (their waits moved), the
    third finds nothing changed and skips every queue, in both
    packages."""
    docs = random_docs(8)
    opts = {"create_intent_hosts": False}
    j, t = run_both(world, docs, [(NOW, None, opts)] * 3)
    assert_same(j, t)
    n = len(t[2]["result"]["queues"])
    assert t[1]["shapes"]["patched"] > 0
    assert t[2]["shapes"] == {"skipped": n, "patched": 0, "spliced": 0,
                              "rewritten": 0}


def test_persisted_queue_reads_back_like_jax(world):
    """The queue documents read back through each package's
    ``TaskQueue``/``doc_column`` the same, and the version watermark
    (``fingerprint_version``) moves the same."""
    docs = random_docs(3)
    sides_ = sides(docs)
    for side in sides_:
        world()
        side.tick(NOW)
        churn(7)(side.store)
        side.tick(NOW + 15)
    js, ts = sides_
    ids = [d["_id"] for d in js.store.collection("task_queues").find()]
    assert ids
    for did in ids:
        jq, tq = j_queue.load(js.store, did), t_queue.load(ts.store, did)
        assert dataclasses.asdict(tq) == dataclasses.asdict(jq)
        jd = j_queue.coll(js.store).get(did)
        td = t_queue.coll(ts.store).get(did)
        for col in t_queue.ROW_FIELDS + ("sort_value", "dependencies_met"):
            assert t_queue.doc_column(td, col) == j_queue.doc_column(jd, col)
        assert (t_persister.fingerprint_version(ts.store, did)
                == j_persister.fingerprint_version(js.store, did))
        assert (dataclasses.asdict(t_queue.load_info(ts.store, did))
                == dataclasses.asdict(j_queue.load_info(js.store, did)))


# --------------------------------------------------------------------------- #
# the fallback ladder
# --------------------------------------------------------------------------- #


def fault_setup(kind):
    def setup(side):
        fault = (side.faults.Fault("hang", delay_s=0.3) if kind == "deadline"
                 else side.faults.Fault("raise"))
        side.faults.install(side.faults.FaultPlan().always(
            "scheduler.solve", fault))
    return setup


@pytest.mark.parametrize("kind", ["raise", "deadline", "breaker"])
def test_ladder_degrades_to_the_same_serial_plan(kind, world):
    docs = generated(3, capacity=True)
    opts = {"solve_deadline_s": 0.05} if kind == "deadline" else {}
    if kind == "breaker":
        def setup(side):
            breaker = side.wrapper.solve_breaker_for(side.store)
            for _ in range(side.wrapper.SOLVE_BREAKER_THRESHOLD):
                breaker.record_failure(now=NOW, error="forced")
    else:
        setup = fault_setup(kind)
    try:
        j, t = run_both(world, docs, [(NOW, None, opts),
                                      (NOW + 15, churn(3), opts)], setup)
    finally:
        j_faults.uninstall()
        t_faults.uninstall()
    assert_same(j, t)
    want = {"raise": "solve-failed", "deadline": "solve-deadline",
            "breaker": "breaker-open"}[kind]
    for x in t:
        assert x["result"]["planner_used"] == "serial"
        assert x["result"]["degraded"] in (want, "breaker-open")
    assert t[0]["result"]["degraded"] == want


def test_solve_tick_after_serial_ticks_matches_jax(world):
    """A serial tick clears the persister's info epoch; the solve tick
    after it writes the same documents as JAX's."""
    docs = random_docs(8)

    def heal(store):
        j_faults.uninstall()
        t_faults.uninstall()

    try:
        j, t = run_both(world, docs, [(NOW, None, {}), (NOW + 15, heal, {})],
                        fault_setup("raise"))
    finally:
        j_faults.uninstall()
        t_faults.uninstall()
    assert_same(j, t)
    assert [x["result"]["planner_used"] for x in t] == ["serial", "tpu"]


@pytest.mark.parametrize("seam", ["solve", "capacity"])
def test_kernel_error_raises_out_of_the_tick(seam, monkeypatch, world):
    """A kernel that fails to build or launch is no rung of the ladder:
    the tick raises it instead of planning on the host, the solve and
    capacity breakers record no failure, and no queue is written. The
    plain versions the CPU tick runs stand in for the kernels."""
    from evergreen_tpu_torch.ops import _build, capacity, solve

    def broken(*args, **kwargs):
        raise _build.KernelError("CUDA launch failed with cudaError_t 98")

    docs = generated(3, capacity=True)
    if seam == "solve":
        monkeypatch.setattr(solve, "fused_distro_stats", broken)
    else:
        # the two-call rung: the capacity program's own pool sums
        docs["config"][0]["fused"] = "two_call"
        monkeypatch.setattr(capacity, "segment_sum", broken)
    _, side = sides(docs)
    world()
    with pytest.raises(_build.KernelError, match="cudaError_t 98"):
        side.tick(NOW)
    plane = t_wrapper.capacity_plane_for(side.store)
    for breaker in (t_wrapper.solve_breaker_for(side.store), plane.breaker,
                    plane.fused_breaker):
        assert breaker.state == "closed" and breaker._consecutive_failures == 0
    assert side.store.collection("task_queues").find() == []
    assert len(side.store.collection("hosts").find()) == len(docs["hosts"])


# --------------------------------------------------------------------------- #
# planners, caps and the overload ladder
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["gen", "random"])
def test_cmp_planner_distros_match_jax(name, world):
    if name == "gen":
        docs = generated(4, capacity=True, cmp=("d001", "d004"))
    else:
        docs = random_docs(5, cmp_every=2)
    docs["versions"] = [{"_id": doc["version"], "requester": doc["requester"]}
                        for doc in docs["tasks"][:40:3] if doc["version"]]
    docs["versions"] = list({v["_id"]: v for v in docs["versions"]}.values())
    j, t = run_both(world, docs, TWO_TICKS)
    assert_same(j, t)
    assert t[0]["result"]["planner_used"] == "tpu"


@pytest.mark.parametrize("cap", [1, 5])
def test_max_scheduled_per_distro_matches_jax(cap, world):
    docs = random_docs(3)
    script = [(NOW, None, {"max_scheduled_per_distro": cap}),
              (NOW + 15, churn(2), {"max_scheduled_per_distro": cap})]
    j, t = run_both(world, docs, script)
    assert_same(j, t)
    # the cap cut some queues, and held except where a task group
    # straddles it
    res = t[0]["result"]
    assert sum(res["queues"].values()) < res["n_tasks"]
    assert all(len(d["rows"]) <= cap or any(r[8] for r in d["rows"])
               for d in t[0]["docs"]["task_queues"])


def test_tick_lag_at_red_sheds_events_and_stats_like_jax(world):
    """Two ticks 60 s apart against a 15 s cadence: a 45 s lag puts the
    ladder at RED, and the second tick sheds its events and stats."""
    docs = generated(5, capacity=True)
    j, t = run_both(world, docs, [(NOW, None, {}), (NOW + 60, churn(5), {})])
    assert_same(j, t)
    assert t[0]["result"]["overload"] == "green" and t[0]["result"]["shed"] == []
    assert t[1]["result"]["overload"] == "red"
    assert t[1]["result"]["shed"] == ["events", "stats"]
    assert t[1]["result"]["intents"]
    assert [d["_id"] for d in t[1]["docs"]["overload_sheds"]] == [
        "tick:events", "tick:stats"]


def test_overload_floor_is_what_jax_reports(world):
    """A RED floor shapes ``level()`` only: ``evaluate()`` and so the
    tick stay at the monitor's own level, in both packages."""
    docs = generated(5, capacity=True)

    def setup(side):
        side.overload.monitor_for(side.store).set_floor(side.overload.RED)

    j, t = run_both(world, docs, TWO_TICKS, setup)
    assert_same(j, t)
    assert [x["result"]["overload"] for x in t] == ["green", "green"]
    assert all(x["result"]["shed"] == [] for x in t)


def test_budget_exceeded_sheds_like_jax(world):
    """A tick budget already spent when the first intent is created sheds
    events and stats with reason budget-exceeded in both."""
    docs = generated(6, capacity=True)
    j, t = run_both(world, docs, [(NOW, None, {"tick_budget_s": 1e-9})])
    assert_same(j, t)
    assert t[0]["result"]["shed"] == ["events", "stats"]
    assert t[0]["result"]["overload"] == "green"


def test_run_tick_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    store = t_store.Store()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_wrapper.run_tick(store, now=NOW)
    assert store.collection("task_queues").find() == []


# --------------------------------------------------------------------------- #
# the service's tick: TickCache + resident state plane
# --------------------------------------------------------------------------- #

WARM = {"use_cache": True}


def held_out(docs, did):
    """Split distro ``did`` (its document, tasks and hosts) out of
    ``docs``; returns the held-out part."""
    extra = {}
    for coll, key in (("distros", "_id"), ("tasks", "distro_id"),
                      ("hosts", "distro_id")):
        extra[coll] = [d for d in docs[coll] if d[key] == did]
        docs[coll] = [d for d in docs[coll] if d[key] != did]
    return extra


def service_script(extra, gone, opts):
    """Tick, churn, tick, a tick with a ``scheduler.solve`` fault (the
    serial oracle plans it; the cache's resident deltas accumulate
    across it), a churn that adds one distro and removes another, tick,
    and a quiet tick (the clock only)."""

    def fault(store):
        for f in (j_faults, t_faults):
            f.install(f.FaultPlan().always("scheduler.solve", f.Fault("raise")))

    def distros(store):
        j_faults.uninstall()
        t_faults.uninstall()
        churn(11)(store)
        for coll, ds in extra.items():
            store.collection(coll).insert_many(copy.deepcopy(ds))
        store.collection("distros").remove(gone)

    return [(NOW, None, opts), (NOW + 15, churn(7), opts),
            (NOW + 30, fault, opts), (NOW + 45, distros, opts),
            (NOW + 60, None, opts)]


@pytest.mark.parametrize("name", ["gen3+cap", "random8"])
def test_warm_ticks_match_jax_and_the_cold_tick(name, world):
    """``run_tick(use_cache=True)`` on the CPU writes JAX
    ``run_tick(use_cache=True)``'s documents exactly (resident plane on
    in both) over the service's sequence, and the same documents as the
    port's own cold tick."""
    docs = (generated(3, capacity=True) if name.startswith("gen")
            else random_docs(8))
    ids = [d["_id"] for d in docs["distros"]]
    extra = held_out(docs, ids[-1])
    try:
        j, t = run_both(world, docs, service_script(extra, ids[0], WARM))
        _, port_cold = sides(docs)
        world()
        cold = [record(port_cold, now, before, **opts) for now, before, opts
                in service_script(extra, ids[0], {})]
    finally:
        j_faults.uninstall()
        t_faults.uninstall()
    assert_same(j, t)
    assert [x["result"]["planner_used"] for x in t] == [
        "tpu", "tpu", "serial", "tpu", "tpu"]
    assert [x["result"]["degraded"] for x in t] == [
        "", "", "solve-failed", "", ""]
    for k, (w, c) in enumerate(zip(t, cold)):
        assert w["result"] == c["result"], k
        for coll in COLLECTIONS:
            assert w["docs"][coll] == c["docs"][coll], (k, coll)
    # the churn tick persists as deltas, as the cold one does
    assert t[1]["shapes"]["rewritten"] == 0


def test_warm_tick_plane_and_cache_state_match_jax(world):
    """After the service's sequence the two packages' resident planes
    have the same counters, and the port's caches hand the persister
    the same stamp hints as JAX's."""
    from evergreen_tpu.scheduler import resident as j_resident
    from evergreen_tpu_torch.scheduler import resident as t_resident

    docs = generated(2, capacity=True)
    ids = [d["_id"] for d in docs["distros"]]
    extra = held_out(docs, ids[-1])
    script = service_script(extra, ids[0], WARM)
    stats = {}
    try:
        for side in sides(docs):
            world()
            for now, before, opts in script:
                record(side, now, before, **opts)
            plane = (j_resident if side.name == "jax"
                     else t_resident).peek_resident_plane(side.store)
            cache = side.wrapper.tick_cache_for(side.store)
            stats[side.name] = (
                {k: v for k, v in plane.stats().items()
                 if not k.startswith("mirror")},
                {d: cache.stamp_candidates(d) for d in ids})
    finally:
        j_faults.uninstall()
        t_faults.uninstall()
    assert stats["port"] == stats["jax"]
    counters = stats["port"][0]
    assert counters["fallbacks"] == 0
    assert counters["rebuilds"] + counters["topology_splices"] <= 3
    assert counters["delta_rows"] > 0


def test_warm_tick_raises_a_failed_mirror_upload(monkeypatch, world):
    """A mirror upload that fails raises ``MirrorError`` out of the warm
    tick — no serial tick, no host rebuild: the solve breaker records no
    failure and no queue is written. The plane here publishes through a
    ``DeviceMirror`` on the CPU; on the card that is the default. Once
    the upload works again the next tick rebuilds the plane and runs."""
    from evergreen_tpu_torch.ops import resident_ops
    from evergreen_tpu_torch.scheduler import resident as t_resident

    docs = generated(3, capacity=True)
    _, side = sides(docs)
    mirror = resident_ops.DeviceMirror(device="cpu")
    plane = t_resident.ResidentPlane(side.store, mirror=mirror)
    monkeypatch.setitem(t_resident._planes, side.store, plane)
    assert t_resident.resident_plane_for(side.store, "cpu") is plane

    def broken(buf, dev):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    world()
    upload = resident_ops._upload
    monkeypatch.setattr(resident_ops, "_upload", broken)
    with pytest.raises(resident_ops.MirrorError, match="illegal memory access"):
        side.tick(NOW, **WARM)
    breaker = t_wrapper.solve_breaker_for(side.store)
    assert breaker.state == "closed" and breaker._consecutive_failures == 0
    assert side.store.collection("task_queues").find() == []
    assert plane.fallbacks == 0
    monkeypatch.setattr(resident_ops, "_upload", upload)
    res = side.tick(NOW + 15, **WARM)
    assert res.planner_used == "tpu" and res.degraded == ""
    assert plane.rebuild_reasons == {"cold": 1, "mirror-error": 1}
    assert mirror.full_uploads == 1


def test_warm_tick_raises_a_kernel_error(monkeypatch, world):
    """A kernel that fails to build or launch raises out of the warm tick
    as out of the cold one, with the resident plane serving the solve."""
    from evergreen_tpu_torch.ops import _build, solve

    def broken(*args, **kwargs):
        raise _build.KernelError("CUDA launch failed with cudaError_t 98")

    _, side = sides(generated(3, capacity=True))
    world()
    monkeypatch.setattr(solve, "fused_distro_stats", broken)
    with pytest.raises(_build.KernelError, match="cudaError_t 98"):
        side.tick(NOW, **WARM)
    assert t_wrapper.solve_breaker_for(side.store)._consecutive_failures == 0
    assert side.store.collection("task_queues").find() == []


def test_a_ticked_store_is_released(world):
    """The tick's per-store state (TickCache, snapshot memos and arena
    pool, resident plane, capacity plane, solve breaker, persister
    state) is keyed weakly: once the caller drops a store that warm and
    cold ticks ran on, nothing of the port keeps it or that state."""
    import gc
    import weakref

    from evergreen_tpu_torch.scheduler import capacity_plane as t_capacity
    from evergreen_tpu_torch.scheduler import resident as t_resident

    _, side = sides(generated(3, capacity=True))
    world()
    for k, opts in enumerate((WARM, WARM, {})):
        assert side.tick(NOW + 15 * k, **opts).planner_used == "tpu"
    registries = (t_wrapper._tick_caches, t_wrapper._sched_memos,
                  t_wrapper._solve_breakers, t_resident._planes,
                  t_capacity._planes, t_persister._states)
    assert all(side.store in r for r in registries)
    plane = weakref.ref(t_resident.peek_resident_plane(side.store))
    store = weakref.ref(side.store)
    del side
    gc.collect()
    assert store() is None and plane() is None


def test_gc_tuning_matches_jax():
    """``tune_gc_for_long_lived_heap`` freezes the heap and sets the
    collector's thresholds as the JAX package's does (the interpreter's
    state is restored afterwards)."""
    import gc

    from evergreen_tpu.utils import gctune as j_gctune
    from evergreen_tpu_torch.utils import gctune as t_gctune

    threshold = gc.get_threshold()
    seen = {}
    try:
        for name, mod in (("jax", j_gctune), ("port", t_gctune)):
            gc.unfreeze()
            gc.set_threshold(*threshold)
            mod.tune_gc_for_long_lived_heap()
            seen[name] = (gc.get_threshold(), gc.get_freeze_count() > 0)
    finally:
        gc.unfreeze()
        gc.set_threshold(*threshold)
    assert seen["port"] == seen["jax"] == ((50_000, 25, 25), True)
