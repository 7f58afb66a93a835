"""The port's tracing plane and device profiler hook against the JAX
package's ``utils/tracing.py``, on the CPU.

The same calls go through each package's ``Tracer`` on each package's
``Store``; what is compared is the span trees (``trace_tree``) and the
``spans`` documents, with the fields that cannot agree masked: span ids
(each package numbers its spans from its own process-wide sequence, so a
tree is compared by its shape: names, components, parents, attributes
and thread names), start times, durations, and the attributes that are
times (``TIME_ATTRS``). Children are compared as a sorted list, since a
fixed clock (the ``world`` fixture) ties their start times. Then the
tick's span trees: a cold tick, warm resident ticks, an asynchronous
durable tick (whose ``wal.flush`` span the flusher thread parents into
the tick's trace; its WAL records, span records canonicalised, equal to
JAX's), and a round of the in-process plane (each shard thread's
``tick`` is a root, carrying its ``shard``). The profiler hook:
``maybe_device_profile`` writes one Chrome trace per configured
directory per process, and a solve abandoned at its deadline opens no
profiler.
"""
import dataclasses
import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.utils import overload as j_overload  # noqa: E402
from evergreen_tpu.utils import tracing as j_tracing  # noqa: E402

from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402
from evergreen_tpu_torch.utils import overload as t_overload  # noqa: E402
from evergreen_tpu_torch.utils import tracing as t_tracing  # noqa: E402

from test_torch_solve import x64  # noqa: E402,F401
from test_torch_tick import (  # noqa: E402,F401
    NOW,
    churn,
    generated,
    record,
    sides,
    world,
)

PKGS = {"jax": (j_tracing, j_store, j_overload, j_settings),
        "port": (t_tracing, t_store, t_overload, t_settings)}
#: span attributes that are wall times (masked like durations)
TIME_ATTRS = frozenset({"snapshot_ms", "solve_ms", "total_ms"})
#: the fields of a span record, in both packages
SPAN_KEYS = {"_id", "component", "name", "parent", "trace_root", "thread",
             "started_at", "attributes", "duration_ms"}


@pytest.fixture(autouse=True)
def tracing_on():
    """Tracing on in both packages, no context leaked in or out."""
    prev = j_tracing.set_tracing_enabled(True), t_tracing.set_tracing_enabled(True)
    j_tracing.reset_context()
    t_tracing.reset_context()
    yield
    j_tracing.reset_context()
    t_tracing.reset_context()
    j_tracing.set_tracing_enabled(prev[0])
    t_tracing.set_tracing_enabled(prev[1])


def canon_span(s, thread=lambda name: name):
    attrs = {k: ("<time>" if k in TIME_ATTRS else v)
             for k, v in (s.get("attributes") or {}).items()}
    return json.dumps([s["component"], s["name"], thread(s["thread"]), attrs],
                      sort_keys=True, default=str)


def canon_tree(node, thread=lambda name: name):
    """A span tree by its shape: each span masked, children sorted."""
    return [canon_span(node, thread),
            sorted((canon_tree(c, thread) for c in node["children"]),
                   key=json.dumps)]


def tree_of(tracing, store, trace_id, thread=lambda name: name):
    tree = tracing.trace_tree(store, trace_id)
    assert tree is not None and tree["trace_id"] == trace_id
    return dict(n_spans=tree["n_spans"],
                roots=sorted((canon_tree(r, thread) for r in tree["roots"]),
                             key=json.dumps))


def span_docs(store):
    """The ``spans`` documents, each masked to its shape, sorted."""
    return sorted(canon_span(d) for d in store.collection("spans").find())


def names(tree):
    out = []

    def walk(node):
        out.append(json.loads(node[0])[1])
        for c in node[1]:
            walk(c)

    for r in tree["roots"]:
        walk(r)
    return out


def both(fn):
    """``fn(tracing, store_mod, overload, settings)`` for each package."""
    return {pkg: fn(*mods) for pkg, mods in PKGS.items()}


# --------------------------------------------------------------------------- #
# the Tracer against JAX's
# --------------------------------------------------------------------------- #


def test_nested_spans_parent_like_jax():
    def run(tracing, store_mod, *_):
        store = store_mod.Store()
        tr = tracing.Tracer(store, "scheduler")
        with tr.span("tick", planner="tpu") as root:
            with tr.span("pack", mode="rebuild"):
                with tracing.Tracer(store, "resident").span("arena_lease"):
                    pass
            with tr.span("solve", deadline_s=0.0) as rec:
                assert tracing.capture_context() == (
                    root["trace_root"], rec["_id"])
            root["attributes"]["n_tasks"] = 3
        assert tracing.capture_context() is None
        docs = store.collection("spans").find()
        assert all(set(d) == SPAN_KEYS for d in docs)
        assert {d["trace_root"] for d in docs} == {root["_id"]}
        return tree_of(tracing, store, root["trace_root"]), span_docs(store)

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0]["n_spans"] == 4


def test_explicit_context_crosses_a_thread_like_jax():
    """A context captured in one thread parents spans in another, by an
    explicit ``ctx`` token and by ``attached``; the thread is named."""
    def run(tracing, store_mod, *_):
        store = store_mod.Store()
        tr = tracing.Tracer(store, "storage")
        with tr.span("tick") as root:
            ctx = tracing.capture_context()

        def worker():
            with tr.span("by_token", ctx=ctx):
                pass
            with tracing.attached(ctx):
                with tr.span("attached", n_ops=2):
                    pass
            assert tracing.capture_context() is None

        th = threading.Thread(target=worker, name="wal-group-flusher")
        th.start()
        th.join()
        return tree_of(tracing, store, root["trace_root"])

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["n_spans"] == 3


def test_ring_cap_drops_and_counts_like_jax():
    def run(tracing, *_):
        ring = tracing.TraceRing(max_traces=2, max_spans_per_trace=3)
        dropped0 = tracing.TRACE_RING_DROPPED.value()
        for tid in ("t1", "t2", "t3"):
            for k in range(5):
                ring.add({"_id": f"{tid}-{k}", "trace_root": tid,
                          "attributes": {"k": k}})
        ring.add({"_id": "", "trace_root": ""})  # no id: ignored
        return ([(tid, [s["_id"] for s in spans]) for tid, spans in ring.traces()],
                tracing.TRACE_RING_DROPPED.value() - dropped0,
                ring.trace("t1"), ring.trace("t3")[0]["attributes"])

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1] == 6 and [t for t, _ in got["port"][0]] == ["t2", "t3"]
    assert (t_tracing.TRACE_RING_DROPPED.name, j_tracing.TRACE_RING_DROPPED.name) == (
        "trace_ring_spans_dropped_total",) * 2


def test_red_brownout_sheds_the_store_write_like_jax():
    """At RED the span reaches the ring but not the store, and the shed
    is counted; at GREEN it reaches both."""
    def run(tracing, store_mod, overload, _):
        store = store_mod.Store()
        shed0 = tracing.TRACE_STORE_SHED.value()
        overload.monitor_for(store).set_floor(overload.RED)
        with tracing.Tracer(store, "scheduler").span("tick") as rec:
            pass
        overload.monitor_for(store).set_floor(overload.GREEN)
        with tracing.Tracer(store, "scheduler").span("tick") as rec2:
            pass
        ring = tracing.trace_ring_for(store)
        return (tracing.TRACE_STORE_SHED.value() - shed0,
                len(store.collection("spans").find()),
                len(ring.trace(rec["_id"])), len(ring.trace(rec2["_id"])))

    got = both(run)
    assert got["port"] == got["jax"] == (1, 1, 1, 1)


def test_store_write_false_is_ring_only_like_jax():
    def run(tracing, store_mod, *_):
        store = store_mod.Store()
        with tracing.Tracer(store, "dispatch").span(
                "dispatch_assign", store_write=False, distro="d1") as rec:
            rec["attributes"]["task"] = "t1"
        spans = tracing.trace_ring_for(store).trace(rec["_id"])
        return (len(store.collection("spans").find()), [canon_span(s) for s in spans],
                sorted(spans[0]), tree_of(tracing, store, rec["_id"]))

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and "_ring_only" not in got["port"][2]


def test_disabled_tracing_is_a_noop_like_jax():
    def run(tracing, store_mod, *_):
        store = store_mod.Store()
        tracing.set_tracing_enabled(False)
        try:
            with tracing.Tracer(store, "scheduler").span("tick", x=1) as rec:
                inside = tracing.capture_context()
        finally:
            tracing.set_tracing_enabled(True)
        return (rec, inside, store.collection("spans").find(),
                tracing.trace_ring_for(store).traces(), tracing.tracing_enabled())

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"_id": "", "trace_root": "", "attributes": {}}


def test_raising_nested_span_detaches_like_jax():
    """A nested span whose body raises is still recorded and detaches
    its context: the outer span stays the parent of the next child, and
    after the outer span a new span roots a fresh trace."""
    def run(tracing, store_mod, *_):
        store = store_mod.Store()
        tr = tracing.Tracer(store, "scheduler")
        with pytest.raises(RuntimeError):
            with tr.span("tick") as root:
                with pytest.raises(ValueError):
                    with tr.span("solve"):
                        raise ValueError("boom")
                assert tracing.capture_context() == (root["_id"], root["_id"])
                with tr.span("unpack"):
                    raise RuntimeError("escapes")
        assert tracing.capture_context() is None
        with tr.span("next") as nxt:
            pass
        assert nxt["parent"] is None and nxt["trace_root"] == nxt["_id"]
        return tree_of(tracing, store, root["_id"]), tree_of(tracing, store, nxt["_id"])

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0]["n_spans"] == 3


def test_trace_tree_shape_like_jax():
    """``trace_tree`` merges the ring with the store sink (a span only in
    the store, one only in the ring), nests children under parents, and
    is None for an unknown trace."""
    def run(tracing, store_mod, *_):
        store = store_mod.Store()
        tr = tracing.Tracer(store, "scheduler")
        with tr.span("tick") as root:
            with tr.span("dispatch_assign", store_write=False):
                pass
            with tr.span("persist", n_distros=2):
                pass
        tracing.trace_ring_for(store).clear()
        with tracing.attached(tracing.TraceContext(root["_id"], root["_id"])):
            with tr.span("dispatch_assign", store_write=False):
                pass
        tree = tracing.trace_tree(store, root["_id"])
        return (sorted(tree), sorted(tree["roots"][0]), tree_of(tracing, store, root["_id"]),
                tracing.trace_tree(store, "span-unknown"))

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][2]["n_spans"] == 3 and got["port"][3] is None


# --------------------------------------------------------------------------- #
# the device profiler hook
# --------------------------------------------------------------------------- #


def profiled_store(profile_dir):
    store = t_store.Store()
    t_settings.TracerConfig(xla_profile_dir=str(profile_dir)).set(store)
    return store


def test_device_profile_writes_one_trace_per_directory(tmp_path):
    """The first body under a configured directory runs under the
    profiler and leaves one Chrome trace naming its ops; the second call
    into the same directory does not profile; a new directory does; no
    directory configured, nothing."""
    x = torch.arange(8.0)
    with t_tracing.maybe_device_profile(t_store.Store()) as on:
        assert on is False
    with t_tracing.maybe_device_profile(None) as on:
        assert on is False
    first = profiled_store(tmp_path / "a")
    with t_tracing.maybe_device_profile(first) as on:
        assert on is True
        torch.cumsum(x, 0)
    path = t_tracing.profile_trace_path(str(tmp_path / "a"))
    assert os.listdir(tmp_path / "a") == [os.path.basename(path)]
    with open(path) as fh:
        assert "aten::cumsum" in fh.read()
    with t_tracing.maybe_device_profile(profiled_store(tmp_path / "a")) as on:
        assert on is False
        torch.cumsum(x, 0)
    assert os.listdir(tmp_path / "a") == [os.path.basename(path)]
    with t_tracing.maybe_device_profile(profiled_store(tmp_path / "b")) as on:
        assert on is True
    assert os.path.exists(t_tracing.profile_trace_path(str(tmp_path / "b")))


def tracer_doc(profile_dir):
    return dict(dataclasses.asdict(t_settings.TracerConfig(
        xla_profile_dir=str(profile_dir))), _id="tracer")


def test_tick_profiles_its_solve_once(tmp_path, world):
    """``run_tick`` runs its solve under the hook: the trace holds the
    solve's ops, inside the tick's ``solve`` span; the next tick writes
    no second trace."""
    docs = generated(1)
    docs["config"] = [tracer_doc(tmp_path)]
    _, side = sides(docs)
    world()
    res = side.tick(NOW)
    assert res.planner_used == "tpu"
    files = os.listdir(tmp_path)
    assert files == [os.path.basename(t_tracing.profile_trace_path(str(tmp_path)))]
    with open(tmp_path / files[0]) as fh:
        trace = json.load(fh)
    ops = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::index_add_" in ops or "aten::sort" in ops
    side.tick(NOW + 15)
    assert os.listdir(tmp_path) == files


def test_abandoned_solve_opens_no_profiler(tmp_path, world):
    """A solve held at its seam past the deadline degrades the tick and,
    when its thread wakes, solves without the profiler: the directory
    stays unlatched, so the next tick captures it."""
    docs = generated(2)
    docs["config"] = [tracer_doc(tmp_path)]
    _, side = sides(docs)
    world()
    t_faults.install(t_faults.FaultPlan().at(
        "scheduler.solve", 0, t_faults.Fault("delay", delay_s=0.4)))
    try:
        res = side.tick(NOW, solve_deadline_s=0.05)
    finally:
        t_faults.uninstall()
    assert res.degraded == "solve-deadline"
    deadline = time.monotonic() + 10.0
    while (any(t.name == "tick-solve" for t in threading.enumerate())
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert os.listdir(tmp_path) == []
    assert side.tick(NOW + 15).planner_used == "tpu"
    assert len(os.listdir(tmp_path)) == 1


# --------------------------------------------------------------------------- #
# the tick's span trees against JAX's
# --------------------------------------------------------------------------- #

COLD_TICK = ["tick", "delta_drain", "pack", "solve", "unpack", "persist",
             "tick_stats", "wal_commit"]


def tick_trees(side, script, **opts):
    """Tick ``side`` through ``script`` ([(now, before)]) and return each
    tick's tree and the store's span documents after it."""
    tracing = j_tracing if side.name == "jax" else t_tracing
    out = []
    for now, before in script:
        rec = record(side, now, before, **opts)
        trace_id = side.last_trace_id
        out.append((tree_of(tracing, side.store, trace_id), span_docs(side.store),
                    rec["result"]))
    return out


@pytest.fixture
def traced(monkeypatch):
    """Keep each side's last ``TickResult.trace_id`` on the side."""
    from test_torch_tick import Side

    real = Side.tick

    def tick(self, now, **opts):
        res = real(self, now, **opts)
        self.last_trace_id = res.trace_id
        return res

    monkeypatch.setattr(Side, "tick", tick)


def test_cold_tick_span_tree_matches_jax(world, traced):
    runs = {}
    for side in sides(generated(1, capacity=True)):
        world()
        runs[side.name] = tick_trees(side, [(NOW, None), (NOW + 15, churn(3))])
    assert runs["port"] == runs["jax"]
    tree = runs["port"][0][0]
    assert sorted(names(tree)) == sorted(COLD_TICK)
    root = json.loads(tree["roots"][0][0])
    assert root[3]["planner"] == "tpu" and root[3]["planner_used"] == "tpu"
    assert set(root[3]) == {"planner", "n_tasks", "n_distros", "planner_used",
                            "degraded", "overload", "shed"}


def test_warm_resident_tick_span_tree_matches_jax(world, traced):
    """The service's tick: the resident plane's ``resident_apply`` (its
    rebuild reason), ``pack`` (``mode="resident"``) and ``arena_lease``
    under the tick, on the prime and on a delta tick."""
    runs = {}
    for side in sides(generated(2, capacity=True)):
        world()
        runs[side.name] = tick_trees(
            side, [(NOW, None), (NOW + 15, churn(5)), (NOW + 30, None)],
            use_cache=True)
    assert runs["port"] == runs["jax"]
    for tree, _, _ in runs["port"]:
        assert sorted(names(tree)) == sorted(
            ["tick", "delta_drain", "resident_apply", "pack", "arena_lease",
             "solve", "unpack", "persist", "tick_stats", "wal_commit"])


def test_solve_thread_parents_into_the_tick(world):
    """With a solve deadline the solve runs on the ``tick-solve`` thread
    under the caller's context: the solve function sees the tick's
    ``solve`` span as its context, in both packages."""
    from evergreen_tpu.ops.solve import run_solve_packed as j_solve
    from evergreen_tpu_torch.ops.solve import run_solve_packed as t_solve

    seen = {}
    for side in sides(generated(3)):
        tracing = j_tracing if side.name == "jax" else t_tracing
        solve = j_solve if side.name == "jax" else (
            lambda snap: t_solve(snap, device="cpu"))

        def solve_fn(snap, tracing=tracing, solve=solve, name=side.name):
            seen[name] = (tracing.capture_context(), threading.current_thread().name)
            return solve(snap)

        world()
        res = side.tick(NOW, solve_deadline_s=30.0, solve_fn=solve_fn)
        tree = tracing.trace_tree(side.store, res.trace_id)
        solve_span = next(c for c in tree["roots"][0]["children"] if c["name"] == "solve")
        assert seen[side.name] == ((res.trace_id, solve_span["_id"]), "tick-solve")


def test_async_durable_tick_trace_and_wal_match_jax(tmp_path, world, traced):
    """On the durable store with ``async_persist``: the flusher's
    ring-only ``wal.flush`` span (``n_ops``, thread ``wal-group-
    flusher``) parents into the committing tick's ``wal_commit``; the
    span documents ride the tick's frame, and the WAL records equal
    JAX's with the span records canonicalised."""
    from test_torch_durable_tick import config_docs, durable_sides, wal_records

    runs, wals = {}, {}
    for side in durable_sides(tmp_path, config_docs(6, 600)):
        tracing = j_tracing if side.name == "jax" else t_tracing
        world()
        trees = []
        for now, before in [(NOW, None), (NOW + 15, churn(7))]:
            record(side, now, before, use_cache=True, async_persist=True)
            side.store.sync_persist()
            tree = tracing.trace_tree(side.store, side.last_trace_id)
            flush = [c for c in tree["roots"][0]["children"] if c["name"] == "wal_commit"]
            assert [g["name"] for g in flush[0]["children"]] == ["wal.flush"]
            assert flush[0]["children"][0]["thread"] == "wal-group-flusher"
            trees.append(tree_of(tracing, side.store, side.last_trace_id))
        runs[side.name] = trees
        wals[side.name] = canon_wal(wal_records(side.dir))
        side.store._journal.close()
    assert runs["port"] == runs["jax"]
    assert wals["port"] == wals["jax"]
    assert '"tick_stats"' in json.dumps(wals["port"])


def canon_wal(records):
    """WAL records with span ids renamed by first appearance and span
    times masked (the frame's own ``ts`` is the fixed clock), and each
    line's CRC stamp (``k``) masked: it covers the span bytes."""
    ids = {}

    def rename(v):
        if isinstance(v, str) and v.startswith("span-"):
            return ids.setdefault(v, f"span#{len(ids)}")
        return v

    def canon(x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in ("started_at", "duration_ms") or k in TIME_ATTRS:
                    out[k] = "<time>"
                elif k == "k":
                    out[k] = "<crc>"
                else:
                    out[k] = canon(v)
            return out
        if isinstance(x, list):
            return [canon(v) for v in x]
        return rename(x)

    return [canon(r) for r in records]


def test_plane_round_span_trees_match_jax(world):
    """A round of the in-process plane: each shard thread's tick is a
    root ``tick`` span carrying its ``shard``, with its phases under it;
    the trees equal JAX's shard for shard (the pool thread's number is
    masked: which thread takes which shard is the pool's choice)."""
    from test_torch_sharded_plane import make_plane

    def pool_thread(name):
        return name.rsplit("_", 1)[0] if name.startswith("shard-tick") else name

    got = {}
    for pkg, tracing in (("jax", j_tracing), ("port", t_tracing)):
        world()
        plane = make_plane(pkg, generated(4, n_distros=6, capacity=True), 2)
        try:
            per_round = []
            for now in (NOW, NOW + 15):
                res = plane.tick(now=now)
                trees = {}
                for k, r in sorted(res.results.items()):
                    assert r.trace_id
                    trees[k] = tree_of(tracing, plane.stores[k], r.trace_id, pool_thread)
                    root = json.loads(trees[k]["roots"][0][0])
                    assert root[2] == "shard-tick" and root[3]["shard"] == k
                per_round.append(trees)
            got[pkg] = per_round
        finally:
            plane.close()
    assert got["port"] == got["jax"]


def test_span_ids_are_unique_across_processes(tmp_path):
    """A restarted process numbers its spans from 0 again. On a store held
    under a writer lease the port's ids carry the lease epoch, so the
    second life of a durable store's writer keeps the first life's span
    documents (JAX's ``span-<n>`` would overwrite them); the same run
    gives the same ids, and a store with no lease gets JAX's ids."""
    import subprocess
    import sys

    code = (
        "import os, sys\n"
        "from evergreen_tpu_torch.storage.durable import DurableStore\n"
        "from evergreen_tpu_torch.storage.lease import FileLease\n"
        "from evergreen_tpu_torch.utils import tracing as t\n"
        "d = sys.argv[1]\n"
        "lease = FileLease(os.path.join(d, 'writer.lease'), ttl_s=60.0)\n"
        "assert lease.try_acquire()\n"
        "s = DurableStore(d, lease=lease)\n"
        "with t.Tracer(s, 'x').span('a') as r: pass\n"
        "with t.Tracer(None, 'x').span('b') as q: pass\n"
        "print(r['_id'], q['_id'], ','.join(sorted(\n"
        "    x['_id'] for x in s.collection(t.SPANS_COLLECTION).find())))\n"
        "s.close(); lease.release()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def life(d):
        return subprocess.run([sys.executable, "-c", code, str(d)], cwd=root,
                              capture_output=True, text=True, check=True).stdout.split()

    first, second = life(tmp_path / "a"), life(tmp_path / "a")
    assert first == ["span-e1-0", "span-1", "span-e1-0"]
    assert second == ["span-e2-0", "span-1", "span-e1-0,span-e2-0"]
    assert life(tmp_path / "b") == first