"""The port's sharded control plane against the JAX package's.

The same documents are seeded into each package's plane
(``seed_partition`` from one source store, plus the config sections to
every shard store), then both planes run the same rounds with the same
churn between them: the JAX plane with ``stacked="never"`` on JAX's CPU
backend (its ``shard_map`` stacked program does not trace under JAX 0.9,
so it is never the reference), the port's with ``device="cpu"``.

Which shard's intent or event gets which id depends on how the shard
threads interleave (``uuid4`` and the event sequence are process-wide),
so documents are compared with those ids canonicalised: an intent host's
``_id`` keeps its distro and loses its random part, its ``secret`` goes,
and an event loses its ``_id`` — every other field, the documents' order
in each store and the per-distro counts are compared exactly, as is
every other document, byte for byte.
"""
import copy
import dataclasses
import gc
import itertools
import time
import weakref

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.models import task_queue as j_queue  # noqa: E402
from evergreen_tpu.scheduler import sharded_plane as j_plane  # noqa: E402
from evergreen_tpu.scheduler import wrapper as j_wrapper  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.utils import faults as j_faults  # noqa: E402
from evergreen_tpu.utils import overload as j_overload  # noqa: E402

from evergreen_tpu_torch.globals import HostStatus  # noqa: E402
from evergreen_tpu_torch.models import task_queue as t_queue  # noqa: E402
from evergreen_tpu_torch.ops._build import KernelError  # noqa: E402
from evergreen_tpu_torch.ops.resident_ops import MirrorError  # noqa: E402
from evergreen_tpu_torch.scheduler import sharded_plane as t_plane  # noqa: E402
from evergreen_tpu_torch.scheduler import wrapper as t_wrapper  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402
from evergreen_tpu_torch.utils import overload as t_overload  # noqa: E402

from test_torch_solve import x64  # noqa: E402,F401
from test_torch_tick import NOW, churn, generated, world  # noqa: E402,F401

#: what a round writes, plus the handoff records
COLLECTIONS = ("distros", "task_queues", "task_secondary_queues", "tasks",
               "hosts", "events", "overload_sheds", "shard_handoffs")
WARM = dict(use_cache=True)
NO_INTENTS = dict(use_cache=True, create_intent_hosts=False)

PKG = {
    "jax": dict(plane=j_plane, wrapper=j_wrapper, store=j_store,
                faults=j_faults, overload=j_overload, queue=j_queue),
    "port": dict(plane=t_plane, wrapper=t_wrapper, store=t_store,
                 faults=t_faults, overload=t_overload, queue=t_queue),
}


def make_plane(pkg, docs, n, stacked="never", opts=WARM, **kw):
    """``pkg``'s plane over ``n`` in-memory shard stores seeded from
    ``docs``: the distro-scoped documents split by ``seed_partition``,
    the config sections copied to every shard store."""
    m = PKG[pkg]
    src = m["store"].Store()
    for coll, ds in docs.items():
        src.collection(coll).insert_many(copy.deepcopy(ds))
    kw.setdefault("rebalance_enabled", False)
    if pkg == "port":
        kw.setdefault("device", "cpu")
    plane = m["plane"].ShardedScheduler.build(
        n, tick_opts=m["wrapper"].TickOptions(**opts), stacked=stacked, **kw)
    plane.seed_partition(src)
    for s in plane.stores:
        s.collection("config").insert_many(copy.deepcopy(docs.get("config", [])))
    return plane


def canon(doc):
    """A document with its thread-order-dependent ids canonicalised."""
    doc = copy.deepcopy(doc)
    if doc.get("_id", "").startswith("evt-"):
        doc["_id"] = "evt"
    elif (doc.get("status") == HostStatus.UNINITIALIZED.value
          and doc.get("_id", "").startswith("evg-")):
        doc["_id"] = doc["_id"].rsplit("-", 1)[0]
        doc["secret"] = ""
    if "payload" in doc:
        doc["payload"] = {c: [canon(d) for d in ds]
                          for c, ds in doc["payload"].items()}
    return doc


def plane_docs(plane):
    """Every shard store's documents of ``COLLECTIONS``, canonicalised,
    in store order."""
    return [{c: [canon(d) for d in s.collection(c).find()] for c in COLLECTIONS}
            for s in plane.stores]


def assert_same_docs(got, want, label=""):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for c in COLLECTIONS:
            assert len(g[c]) == len(w[c]), (label, k, c)
            for gd, wd in zip(g[c], w[c]):
                assert gd == wd, (label, k, c, wd.get("_id"))


def round_summary(res):
    """The parts of a ShardedTickResult both planes must agree on."""
    return dict(
        n_tasks=res.n_tasks, n_distros=res.n_distros, degraded=res.degraded,
        migrations=res.migrations, fleet_level=res.fleet_level,
        queues={k: r.queues for k, r in res.results.items()},
        new_hosts={k: r.new_hosts for k, r in res.results.items()},
        planner={k: r.planner_used for k, r in res.results.items()},
        intents={k: sorted(h.distro_id for h in r.intent_hosts)
                 for k, r in res.results.items()},
    )


def run_rounds(plane, script):
    """``script``: [(now, before-step or None)]; returns per round the
    result summary, the solve mode and the canonical documents."""
    out = []
    for now, before in script:
        if before is not None:
            for s in plane.stores:
                before(s)
        res = plane.tick(now=now)
        out.append((round_summary(res), res.solve_mode, plane_docs(plane)))
    return out


THREE_ROUNDS = [(NOW, None), (NOW + 15, churn(7)), (NOW + 30, None)]


@pytest.fixture
def planes():
    """Closes every plane a test makes."""
    made = []
    yield made
    for p in made:
        p.close()
    j_faults.uninstall()
    t_faults.uninstall()


# --------------------------------------------------------------------------- #
# (T1) the plane against JAX's; (T2) stacked against local
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [2, 4])
def test_plane_matches_jax_plane(n, world, planes):
    """Three rounds with churn between the second and the first, intents
    on and every distro in the capacity program: each shard store of the
    port's plane holds the JAX plane's documents after every round."""
    docs = generated(n, n_distros=3 * n, n_tasks=240 * n, capacity=True)
    runs = {}
    for pkg in ("jax", "port"):
        world()
        plane = make_plane(pkg, docs, n)
        planes.append(plane)
        runs[pkg] = run_rounds(plane, THREE_ROUNDS)
    for k, ((js, jm, jd), (ts, tm, td)) in enumerate(zip(runs["jax"], runs["port"])):
        assert ts == js, k
        assert tm == jm == "local"
        assert_same_docs(td, jd, f"round {k}")
    assert runs["port"][0][0]["intents"], "no intents were created"


def record_drift(plane):
    """Wrap ``plane._stacked_solve``; returns the list to which each
    stacked solve appends whether it found the shards' dims drifted."""
    drift = []
    real = plane._stacked_solve

    def solve(snaps):
        try:
            out = real(snaps)
        except ValueError:
            drift.append(True)
            raise
        drift.append(False)
        return out

    plane._stacked_solve = solve
    return drift


@pytest.mark.parametrize("n", [2, 4])
def test_stacked_round_matches_local(n, world, planes):
    """The port's ``"always"`` plane discovers the common dims in round
    1 (local), then stacks every block in one ``StackedSolveCache``
    solve; a round whose shard outgrew the dims floor (the intents add
    hosts) goes local and re-seeds the floor, and the next stacks again.
    Its documents equal its ``"never"`` plane's after every round."""
    docs = generated(n + 4, n_distros=3 * n, n_tasks=240 * n, capacity=True)
    script = THREE_ROUNDS + [(NOW + 45, None), (NOW + 60, None)]
    runs = {}
    for stacked in ("never", "always"):
        world()
        plane = make_plane("port", docs, n, stacked=stacked)
        planes.append(plane)
        drift = record_drift(plane)
        runs[stacked] = run_rounds(plane, script)
    modes = [m for _, m, _ in runs["always"]]
    assert modes[:2] == ["local", "stacked"]
    # every round stacked unless its stacked solve saw drift
    assert modes == ["local" if d else "stacked" for d in drift]
    assert modes[-1] == "stacked"
    assert [m for _, m, _ in runs["never"]] == ["local"] * len(script)
    for k, (a, b) in enumerate(zip(runs["always"], runs["never"])):
        assert a[0] == b[0], k
        assert_same_docs(a[2], b[2], f"round {k}")


def test_merged_queues_match_the_single_store_oracle(world, planes):
    """(T3) Without intents, the merged queues of the port's 4-shard
    plane, local and stacked, equal JAX's single-store tick's."""
    docs = generated(5, n_distros=12, n_tasks=1_200)
    oracle = j_store.Store()
    for coll, ds in docs.items():
        oracle.collection(coll).insert_many(copy.deepcopy(ds))
    world()
    for now in (NOW, NOW + 15):
        j_wrapper.run_tick(oracle, j_wrapper.TickOptions(**NO_INTENTS), now=now)

    def queues(store):
        return {(c, d["_id"]): (t_queue.doc_column(d, "id"),
                                list(d.get("sort_value", [])))
                for c in ("task_queues", "task_secondary_queues")
                for d in store.collection(c).find()}

    want = queues(oracle)
    assert want
    for stacked in ("never", "always"):
        world()
        plane = make_plane("port", docs, 4, stacked=stacked, opts=NO_INTENTS)
        planes.append(plane)
        modes = [plane.tick(now=now).solve_mode for now in (NOW, NOW + 15)]
        assert modes == (["local", "stacked"] if stacked == "always"
                         else ["local", "local"])
        assert queues(t_plane.merge_fleet_state(plane.stores)) == want, stacked


def test_binding_intent_budget_splits_like_jax(world, planes):
    """(T4) A fleet intent budget that binds: ``_split_intent_budget``
    and the intents each distro gets equal JAX's, round after round
    (the in-flight intents of the round before netted)."""
    docs = generated(6, n_distros=12, n_tasks=1_200, capacity=True)
    got = {}
    for pkg in ("jax", "port"):
        world()
        plane = make_plane(pkg, docs, 4)
        planes.append(plane)
        opts = PKG[pkg]["wrapper"].TickOptions(use_cache=True, intent_budget=7)
        splits, counts = [], []
        for k, now in enumerate((NOW, NOW + 15)):
            splits.append((plane._split_intent_budget(opts),
                           plane._split_intent_budget(plane.tick_opts)))
            res = plane.tick(now=now, opts=opts if k == 0 else None)
            counts.append({s: sorted(h.distro_id for h in r.intent_hosts)
                           for s, r in res.results.items()})
        got[pkg] = (splits, counts, plane_docs(plane))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0][0][0] == [2, 2, 2, 1]
    assert got["port"][1] == got["jax"][1]
    assert 0 < sum(len(v) for v in got["port"][1][0].values()) <= 7
    assert_same_docs(got["port"][2], got["jax"][2])


# --------------------------------------------------------------------------- #
# (T5) handoffs
# --------------------------------------------------------------------------- #


def both_planes(world, planes, docs, n=2, **kw):
    out = {}
    for pkg in ("jax", "port"):
        world()
        out[pkg] = make_plane(pkg, docs, n, **kw)
        planes.append(out[pkg])
    return out


def first_distro(plane, shard):
    return plane.stores[shard].collection("distros").find()[0]["_id"]


def test_migrate_moves_a_group_like_jax(world, planes):
    """``migrate`` writes JAX's records and documents, the owner moves,
    and the moved distro plans on its new shard next round."""
    docs = generated(7, n_distros=8, n_tasks=480, capacity=True)
    ps = both_planes(world, planes, docs)
    got = {}
    for pkg, plane in ps.items():
        plane.tick(now=NOW)
        did = first_distro(plane, 0)
        hid = next(h["_id"] for h in plane.stores[0].collection("hosts").find()
                   if h["distro_id"] == did)
        assert plane.owner_of(did) == 0
        rec = plane.migrate(did, 1, now=NOW + 1)
        assert plane.owner_of(did) == 1
        # the distro's hosts follow the handoff
        assert plane.stores[0].collection("hosts").get(hid) is None
        assert plane.stores[1].collection("hosts").get(hid)["distro_id"] == did
        assert PKG[pkg]["plane"].fleet_owner_violations(plane.stores) == []
        res = plane.tick(now=NOW + 15)
        got[pkg] = (canon(rec), round_summary(res), plane_docs(plane),
                    dict(plane.topology.overrides))
    assert got["port"][0]["state"] == "done"
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert_same_docs(got["port"][2], got["jax"][2])
    assert got["port"][3] == got["jax"][3]


@pytest.mark.parametrize("seam", ["handoff.record", "handoff.prime"])
def test_failed_handoff_leg_heals_in_process_like_jax(seam, world, planes):
    """A fault after the release (between release and prime, or between
    prime and the done-mark) re-raises out of ``migrate`` after healing:
    the target owns the group, the source's record is done — as JAX."""
    docs = generated(8, n_distros=6, n_tasks=240)
    ps = both_planes(world, planes, docs)
    got = {}
    for pkg, plane in ps.items():
        f = PKG[pkg]["faults"]
        did = first_distro(plane, 0)
        f.install(f.FaultPlan().at(seam, 0, f.Fault("raise")))
        try:
            with pytest.raises(Exception, match="injected"):
                plane.migrate(did, 1, now=NOW)
        finally:
            f.uninstall()
        assert plane.owner_of(did) == 1
        assert plane.stores[1].collection("distros").get(did) is not None
        assert PKG[pkg]["plane"].fleet_owner_violations(plane.stores) == []
        recs = plane.stores[0].collection("shard_handoffs").find()
        assert [r["state"] for r in recs] == ["done"]
        got[pkg] = plane_docs(plane)
    assert_same_docs(got["port"], got["jax"])


def test_reconcile_completes_a_released_handoff_like_jax(world, planes):
    """A released-but-unprimed record (what a crash after the release
    leaves): ``reconcile_handoffs`` re-primes the target and marks the
    record done, once, as JAX does."""
    docs = generated(9, n_distros=6, n_tasks=240)
    ps = both_planes(world, planes, docs)
    got = {}
    for pkg, plane in ps.items():
        m = PKG[pkg]["plane"]
        did = first_distro(plane, 0)
        group = plane._affinity_group(0, did)
        rec = m.handoff_record(did, group, 0, 1, 42, NOW,
                               m.handoff_payload(plane.stores[0], group))
        m.apply_release(plane.stores[0], rec)
        assert plane.stores[1].collection("distros").get(did) is None
        healed = plane.reconcile_handoffs(now=NOW + 1)
        assert healed == [rec["_id"]]
        assert plane.reconcile_handoffs(now=NOW + 2) == []
        assert plane.owner_of(did) == 1
        got[pkg] = plane_docs(plane)
    assert_same_docs(got["port"], got["jax"])


def test_rebalance_off_a_yellow_shard_like_jax(world, planes):
    """Shard 0 held at YELLOW (a ladder floor), its siblings GREEN: the
    round's rebalancing pass migrates one affinity group to the coldest
    sibling, with JAX's record and documents; then ``compact_handoffs``
    drops the reconciled triple and leaves the watermark, as JAX."""
    docs = generated(10, n_distros=12, n_tasks=960, capacity=True)
    ps = both_planes(world, planes, docs, n=4, rebalance_enabled=True)
    got = {}
    for pkg, plane in ps.items():
        ov = PKG[pkg]["overload"]
        r1 = plane.tick(now=NOW)
        assert r1.migrations == []
        ov.monitor_for(plane.stores[0]).set_floor(ov.YELLOW)
        r2 = plane.tick(now=NOW + 15)
        ov.monitor_for(plane.stores[0]).set_floor(ov.GREEN)
        assert len(r2.migrations) == 1 and r2.migrations[0]["from"] == 0
        assert r2.fleet_level == "yellow"
        r3 = plane.tick(now=NOW + 30)
        assert r3.migrations == [] and r3.fleet_level == "green"
        before = plane_docs(plane)
        n = plane.compact_handoffs()
        assert n == 1
        wm = plane.stores[0].collection("shard_handoffs").get(
            PKG[pkg]["plane"].HANDOFF_WATERMARK_ID)
        assert wm["seq"] == 1
        got[pkg] = (round_summary(r2), round_summary(r3), before,
                    plane_docs(plane))
    for j, t in zip(got["jax"][:2], got["port"][:2]):
        assert t == j
    assert_same_docs(got["port"][2], got["jax"][2], "before compaction")
    assert_same_docs(got["port"][3], got["jax"][3], "after compaction")


# --------------------------------------------------------------------------- #
# policies, the fuse and the stacking rule
# --------------------------------------------------------------------------- #


def test_rebalance_plan_and_fuse_match_jax_on_every_level_tuple():
    """``greedy_rebalance_plan`` (caps 1 and 2) and ``fuse_level`` equal
    JAX's on every 4-tuple of ladder levels."""
    loads = {0: {"a": 90, "a2": 80}, 1: {"b": 70}, 2: {"c": 1, "z": 0}, 3: {}}
    round_ms = {0: 100.0, 1: 400.0, 2: 40.0, 3: 100.0}
    cold = {0: 3.0, 1: 1.0, 2: 2.0, 3: 0.0}
    n = 0
    for levels in itertools.product(range(4), repeat=4):
        lv = dict(enumerate(levels))
        for cap in (1, 2):
            for weight in (None, cold):
                assert t_plane.greedy_rebalance_plan(
                    lv, loads, round_ms, cap, cold_weight=weight
                ) == j_plane.greedy_rebalance_plan(
                    lv, loads, round_ms, cap, cold_weight=weight), levels
        assert t_overload.fuse_level(list(levels)) == j_overload.fuse_level(
            list(levels)), levels
        assert t_overload.FLEET_LEVEL.value() == t_overload.fuse_level(list(levels))
        n += 1
    assert n == 256
    assert t_overload.fuse_level([]) == j_overload.fuse_level([]) == 0


def test_fleet_fuse_floors_the_front_store_ladder(world, planes):
    """The fuse over the shards' ladders is set as a floor on an
    attached front store's ladder each round, and released the round the
    fleet calms — as in JAX."""
    docs = generated(11, n_distros=4, n_tasks=160)
    plane = make_plane("port", docs, 2, opts=NO_INTENTS)
    planes.append(plane)
    front = t_store.Store()
    t_plane.attach_sharded_plane(front, plane)
    assert t_plane.peek_sharded_plane(front) is plane
    mon = t_overload.monitor_for(front)
    plane.tick(now=NOW)
    assert mon.level() == t_overload.GREEN
    for s in plane.stores:
        t_overload.monitor_for(s).set_floor(t_overload.RED)
    r = plane.tick(now=NOW + 15)
    assert r.fleet_level == "red" and mon.level() == t_overload.RED
    t_overload.monitor_for(plane.stores[1]).set_floor(t_overload.GREEN)
    r = plane.tick(now=NOW + 30)
    assert r.fleet_level == "yellow" and mon.level() == t_overload.YELLOW
    t_overload.monitor_for(plane.stores[0]).set_floor(t_overload.GREEN)
    plane.tick(now=NOW + 45)
    assert mon.level() == t_overload.GREEN


@pytest.mark.parametrize("n", [1, 2, 4])
def test_use_stacked_rule(n):
    """never: local; auto: JAX's device count rule (1 on the CPU, so
    local from two shards up); always: stacked on the plane's device
    whatever the count — the one departure from JAX, which solves
    locally when it has fewer devices than shards."""
    got = {}
    for stacked in ("never", "auto", "always"):
        plane = t_plane.ShardedScheduler.build(n, stacked=stacked, device="cpu")
        try:
            got[stacked] = plane._use_stacked()
        finally:
            plane.close()
    assert got == {"never": False, "auto": False, "always": n >= 2}


def test_plane_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        plane = t_plane.ShardedScheduler.build(2)
        assert plane.device.type == "cuda"
        plane.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_plane.ShardedScheduler.build(2)


# --------------------------------------------------------------------------- #
# the round's failure paths
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("error", [KernelError, MirrorError])
def test_card_fault_in_the_stacked_solve_raises_out_of_the_round(
        error, world, planes, monkeypatch):
    """A ``KernelError`` or ``MirrorError`` from the stacked solve raises
    out of ``tick()`` — every shard's tick raises it, none solves
    locally, no solve breaker records it, no queue changes."""
    docs = generated(12, n_distros=8, n_tasks=480)
    plane = make_plane("port", docs, 4, stacked="always", opts=NO_INTENTS)
    planes.append(plane)
    assert plane.tick(now=NOW).solve_mode == "local"
    before = plane_docs(plane)
    calls = []

    def broken(blocks):
        calls.append(sorted(blocks))
        raise error("cudaError_t 719")

    monkeypatch.setattr(plane._stacked_cache, "solve_blocks", broken)
    local = []
    real = t_plane.run_solve_packed
    monkeypatch.setattr(t_plane, "run_solve_packed",
                        lambda *a, **k: local.append(1) or real(*a, **k))
    with pytest.raises(error, match="719"):
        plane.tick(now=NOW + 15)
    # one stacked solve over every shard with solver distros; no shard
    # solved locally
    assert calls == [[k for k, s in enumerate(plane.stores)
                      if s.collection("distros").count()]] and local == []
    for s in plane.stores:
        assert t_wrapper.solve_breaker_for(s)._consecutive_failures == 0
    after = plane_docs(plane)
    for k in range(4):
        assert after[k]["task_queues"] == before[k]["task_queues"]


def test_drift_goes_local_and_restacks(world, planes, monkeypatch):
    """A ``ValueError`` from the stacked solve (what shape drift raises)
    downgrades the round to local solves, as in JAX; the documents equal
    the never plane's, and the next round stacks again."""
    docs = generated(13, n_distros=8, n_tasks=480)
    runs = {}
    for stacked in ("never", "always"):
        world()
        plane = make_plane("port", docs, 2, stacked=stacked, opts=NO_INTENTS)
        planes.append(plane)
        modes, out = [], []
        for k, now in enumerate((NOW, NOW + 15, NOW + 30)):
            if stacked == "always" and k == 1:
                real = plane._stacked_cache.solve_blocks
                monkeypatch.setattr(
                    plane._stacked_cache, "solve_blocks",
                    lambda blocks: (_ for _ in ()).throw(ValueError("drift")))
            if stacked == "always" and k == 2:
                monkeypatch.setattr(plane._stacked_cache, "solve_blocks", real)
            modes.append(plane.tick(now=now).solve_mode)
            out.append(plane_docs(plane))
        runs[stacked] = (modes, out)
    assert runs["always"][0] == ["local", "local", "stacked"]
    for a, b in zip(runs["always"][1], runs["never"][1]):
        assert_same_docs(a, b)


def test_barrier_timeout_goes_local(world, planes, monkeypatch):
    """A shard that reaches the barrier after the others' timeout: the
    round goes local for every shard, and writes the never plane's
    documents."""
    docs = generated(14, n_distros=8, n_tasks=480)
    world()
    ref = make_plane("port", docs, 2, opts=NO_INTENTS)
    planes.append(ref)
    want = run_rounds(ref, THREE_ROUNDS[:2])
    world()
    plane = make_plane("port", docs, 2, stacked="always", opts=NO_INTENTS,
                       barrier_timeout_s=0.2)
    planes.append(plane)
    real = t_plane._StackedRound.solve_for

    def slow_for(self, shard_id):
        fn = real(self, shard_id)
        if shard_id == 1:
            return lambda snap: time.sleep(1.0) or fn(snap)
        return fn

    monkeypatch.setattr(t_plane._StackedRound, "solve_for", slow_for)
    got = run_rounds(plane, THREE_ROUNDS[:2])
    assert [m for _, m, _ in got] == ["local", "local"]
    for (gs, _, gd), (ws, _, wd) in zip(got, want):
        assert gs == ws
        assert_same_docs(gd, wd)


def test_a_shard_leaving_early_does_not_hold_the_round(world, planes):
    """A shard whose tick never reaches the solve (its breaker open: the
    serial oracle plans it) leaves the barrier; the other shards stack
    without it, as in JAX."""
    docs = generated(15, n_distros=12, n_tasks=960)
    world()
    plane = make_plane("port", docs, 3, stacked="always", opts=NO_INTENTS)
    planes.append(plane)
    assert plane.tick(now=NOW).solve_mode == "local"
    breaker = t_wrapper.solve_breaker_for(plane.stores[2])
    for _ in range(t_wrapper.SOLVE_BREAKER_THRESHOLD):
        breaker.record_failure(now=NOW + 15, error="held open")
    t0 = time.perf_counter()
    res = plane.tick(now=NOW + 15)
    assert time.perf_counter() - t0 < plane.barrier_timeout_s
    assert res.solve_mode == "stacked"
    assert res.results[2].planner_used == "serial"
    assert [res.results[k].planner_used for k in (0, 1)] == ["tpu", "tpu"]


def test_a_dropped_plane_releases_its_stores(world):
    """A plane dropped without ``close()`` frees its shard stores (and
    with them every per-store cache) and stops its worker threads."""
    docs = generated(16, n_distros=6, n_tasks=240, capacity=True)
    plane = make_plane("port", docs, 2, stacked="always")
    for now in (NOW, NOW + 15):
        plane.tick(now=now)
    refs = [weakref.ref(s) for s in plane.stores]
    pool = plane._pool
    del plane
    gc.collect()
    assert [r() for r in refs] == [None, None]
    deadline = time.monotonic() + 5.0
    while any(t.is_alive() for t in pool._threads) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(t.is_alive() for t in pool._threads)


def test_build_and_seed_partition_match_jax():
    """``build`` names the shards, and ``seed_partition`` places every
    distro-scoped document where JAX's does (alias pairs together)."""
    docs = generated(17, n_distros=12, n_tasks=600)
    tasks = docs["tasks"]
    tasks[0]["secondary_distros"] = [docs["distros"][1]["_id"]]
    got = {}
    for pkg in ("jax", "port"):
        plane = make_plane(pkg, docs, 4)
        try:
            assert [s.shard_id for s in plane.stores] == [0, 1, 2, 3]
            got[pkg] = (
                [{c: [d["_id"] for d in s.collection(c).find()]
                  for c in ("distros", "tasks", "hosts")} for s in plane.stores],
                {d["_id"]: plane.owner_of(d["_id"]) for d in docs["distros"]},
                dict(plane.topology.affinity),
            )
        finally:
            plane.close()
    assert got["port"] == got["jax"]
    owners = got["port"][1]
    assert owners[docs["distros"][0]["_id"]] == owners[docs["distros"][1]["_id"]]


def test_kernel_counts_are_unchanged_without_a_card():
    """On the CPU no wrapper launches a kernel, so the plane's rounds
    leave both launch counts where they were."""
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum

    before = (fused_distro_stats.launches, segment_sum.launches)
    docs = generated(18, n_distros=6, n_tasks=240, capacity=True)
    plane = make_plane("port", docs, 2, stacked="always")
    try:
        for now in (NOW, NOW + 15):
            plane.tick(now=now)
    finally:
        plane.close()
    assert (fused_distro_stats.launches, segment_sum.launches) == before


def test_sharded_result_properties():
    r = t_plane.ShardedTickResult(results={})
    assert (r.n_tasks, r.n_distros, r.degraded, r.solve_mode) == (0, 0, {}, "local")
    assert dataclasses.asdict(r).keys() == dataclasses.asdict(
        j_plane.ShardedTickResult(results={})).keys()


# --------------------------------------------------------------------------- #
# the durable fleet: one DurableStore per shard in one directory
# --------------------------------------------------------------------------- #

#: the cron front end's round options (units/crons.py): async commits
SERVICE_ROUND = dict(use_cache=True, async_persist=True)
#: short shard leases, so a reopened copy steals them within a second
FLEET_TTL_S = 0.3
#: the wall clock, for the lease steal (``world`` fixes ``time.time``)
_REAL_TIME = time.time


def make_durable_plane(pkg, docs, n, data_dir, **kw):
    """``pkg``'s durable plane over ``n`` shard DurableStores in
    ``data_dir``, seeded as ``make_plane`` seeds the in-memory one."""
    m = PKG[pkg]
    src = m["store"].Store()
    for coll, ds in docs.items():
        src.collection(coll).insert_many(copy.deepcopy(ds))
    if pkg == "port":
        kw.setdefault("device", "cpu")
    plane = m["plane"].ShardedScheduler.build(
        n, data_dir=str(data_dir), lease_ttl_s=FLEET_TTL_S,
        tick_opts=m["wrapper"].TickOptions(use_cache=True), stacked="never",
        rebalance_enabled=False, **kw)
    plane.seed_partition(src)
    for s in plane.stores:
        s.collection("config").insert_many(copy.deepcopy(docs.get("config", [])))
    return plane


def service_rounds(plane, pkg, script):
    opts = PKG[pkg]["wrapper"].TickOptions(**SERVICE_ROUND)
    out = []
    for now, before in script:
        if before is not None:
            for s in plane.stores:
                before(s)
        res = plane.tick(now=now, opts=opts)
        out.append((round_summary(res), res.solve_mode, plane_docs(plane)))
    return out


def disk_docs(pkg, data_dir, n):
    """The documents each shard's segment recovers to (opened without a
    lease, read-only use), canonicalised; queue rows come back as lists."""
    import json

    from evergreen_tpu.storage import durable as j_durable
    from evergreen_tpu_torch.storage import durable as t_durable

    durable = j_durable if pkg == "jax" else t_durable
    out = []
    for k in range(n):
        s = durable.DurableStore(str(data_dir), shard_id=k)
        out.append({c: [canon(d) for d in s.collection(c).find()] for c in COLLECTIONS})
        s._journal.close()
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("n", [2, 4])
def test_durable_fleet_matches_jax(n, tmp_path, world, planes):
    """``build(n, data_dir=...)``: one DurableStore per shard, each under
    its own lease and WAL segment. Three rounds with the round options
    of the service (``async_persist``): every shard store holds the JAX
    fleet's documents after every round, each segment recovers to them,
    and ``close()`` releases the leases."""
    import json
    import os

    from evergreen_tpu_torch.storage.durable import fleet_segment_ids

    docs = generated(n, n_distros=3 * n, n_tasks=240 * n, capacity=True)
    runs, dirs = {}, {}
    for pkg in ("jax", "port"):
        world()
        dirs[pkg] = tmp_path / pkg
        plane = make_durable_plane(pkg, docs, n, dirs[pkg])
        runs[pkg] = service_rounds(plane, pkg, THREE_ROUNDS)
        assert [s.epoch for s in plane.stores] == [1] * n
        assert fleet_segment_ids(str(dirs[pkg])) == list(range(n))
        for s in plane.stores:
            s.sync_persist()
        assert disk_docs(pkg, dirs[pkg], n) == json.loads(json.dumps(runs[pkg][-1][2]))
        plane.close()
        assert not [f for f in os.listdir(dirs[pkg]) if f.endswith(".lease")]
    for k, ((js, jm, jd), (ts, tm, td)) in enumerate(zip(runs["jax"], runs["port"])):
        assert ts == js, k
        assert tm == jm == "local"
        assert_same_docs(td, jd, f"round {k}")
    assert runs["port"][0][0]["intents"], "no intents were created"


def test_open_fleet_after_a_crash_mid_handoff_reconciles_like_jax(
        tmp_path, world, planes):
    """A crash between a handoff's release and its prime (a copy of the
    directory taken at the ``handoff.record`` seam, the plane still
    open): ``open_fleet`` on the copy steals the stale shard leases,
    replays each segment, and reconciles the released record — the
    target owns the group, the record is done — as JAX's does; the next
    round writes JAX's documents."""
    import shutil

    docs = generated(21, n_distros=8, n_tasks=480, capacity=True)
    got = {}
    for pkg in ("jax", "port"):
        world()
        m = PKG[pkg]
        plane = make_durable_plane(pkg, docs, 2, tmp_path / pkg)
        service_rounds(plane, pkg, THREE_ROUNDS[:1])
        did = first_distro(plane, 0)
        crashed = tmp_path / f"{pkg}-crashed"
        f = m["faults"]
        f.install(f.FaultPlan().at("handoff.record", 0, f.Fault(
            "call", fn=lambda: shutil.copytree(tmp_path / pkg, crashed))))
        try:
            plane.migrate(did, 1, now=NOW + 1)
        finally:
            f.uninstall()
        plane.close()
        kw = dict(lease_ttl_s=FLEET_TTL_S,
                  tick_opts=m["wrapper"].TickOptions(use_cache=True),
                  stacked="never", rebalance_enabled=False)
        if pkg == "port":
            kw["device"] = "cpu"
        with pytest.MonkeyPatch.context() as mp:
            # the crashed holders' leases carry the fixed clock's stamp:
            # on the wall clock they are stale, and open_fleet steals them
            mp.setattr(time, "time", _REAL_TIME)
            reopened = m["plane"].open_fleet(str(crashed), 2, **kw)
        planes.append(reopened)
        assert [s.epoch for s in reopened.stores] == [2, 2]
        assert reopened.owner_of(did) == 1
        assert m["plane"].fleet_owner_violations(reopened.stores) == []
        recs = reopened.stores[0].collection("shard_handoffs").find()
        assert [r["state"] for r in recs] == ["done"]
        after = service_rounds(reopened, pkg, [(NOW + 15, churn(3))])
        got[pkg] = (after[0][0], plane_docs(reopened), dict(reopened.topology.overrides))
    assert got["port"][0] == got["jax"][0]
    assert_same_docs(got["port"][1], got["jax"][1])
    assert got["port"][2] == got["jax"][2]


def test_a_partial_fleet_releases_what_it_took(tmp_path):
    """A fleet whose shard 1 cannot take its lease (held by someone
    else) fails to build and leaves shard 0's lease free again."""
    import os

    from evergreen_tpu_torch.storage.lease import FileLease, shard_lease_path

    other = FileLease(shard_lease_path(str(tmp_path), 1), ttl_s=60.0)
    assert other.try_acquire()
    real = FileLease.acquire
    try:
        FileLease.acquire = lambda self, timeout_s=None, poll_s=0.1: real(
            self, timeout_s=0.2, poll_s=0.05)
        with pytest.raises(TimeoutError, match="shard 1"):
            t_plane.ShardedScheduler.build(2, data_dir=str(tmp_path), device="cpu")
    finally:
        FileLease.acquire = real
    assert not os.path.exists(shard_lease_path(str(tmp_path), 0))
    assert FileLease(shard_lease_path(str(tmp_path), 0)).try_acquire()
