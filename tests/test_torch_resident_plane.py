"""The port's resident state plane (``evergreen_tpu_torch/scheduler/
resident.py``) against the JAX package's, on twin stores.

A generated problem (task groups, dependency edges, running hosts) is
inserted into a JAX store and a port store; each store has its own
TickCache and resident plane, and the same churn goes to both: appends,
removals, replacements (stamp storms, priority changes), dependency
edits, deactivations, host lifecycle, a distro added, a distro removed,
a changed capacity page. After every step:

  * the port's published buffers are byte-identical to the JAX plane's,
    and so are the snapshot's segment names and counts;
  * ``canonicalize`` of the port's resident snapshot equals that of a
    cold ``build_snapshot`` of the same gather (and JAX's canonical
    form);
  * the planes' counters (rebuilds and their reasons, fast appends,
    replaces and removes, distro rebuilds, topology splices, fallbacks,
    delta rows) are equal.

It runs once publishing through the arena copy and once through
``DeviceMirror(device="cpu")``. On resident snapshots after churn the
port's solve equals the JAX solve on the JAX plane's snapshot (integer
outputs and the two distro duration sums bit for bit), which needs
``fused_distro_stats``' ranges to follow the slab layout: the old rule,
``cumsum(d_task_count)``, assigns rows to the wrong distros there.
"""
import copy
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.ops import packing as j_packing  # noqa: E402
from evergreen_tpu.ops import solve as j_solve  # noqa: E402
from evergreen_tpu.scheduler import cache as j_cache  # noqa: E402
from evergreen_tpu.scheduler import resident as j_resident  # noqa: E402
from evergreen_tpu.scheduler import snapshot as j_snapshot  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.utils.benchgen import generate_problem  # noqa: E402

from evergreen_tpu_torch.ops import packing as t_packing  # noqa: E402
from evergreen_tpu_torch.ops.distro_stats import (  # noqa: E402
    STAT_NAMES,
    fused_distro_stats_plain,
)
from evergreen_tpu_torch.ops.packing import unpack  # noqa: E402
from evergreen_tpu_torch.ops.resident_ops import DeviceMirror  # noqa: E402
from evergreen_tpu_torch.ops.solve import (  # noqa: E402
    distro_stats_inputs,
    run_solve_packed,
)
from evergreen_tpu_torch.scheduler import cache as t_cache  # noqa: E402
from evergreen_tpu_torch.scheduler import resident as t_resident  # noqa: E402
from evergreen_tpu_torch.scheduler import snapshot as t_snapshot  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402

from test_torch_solve import x64  # noqa: E402,F401

NOW = 1_700_000_000.0
COUNTERS = ("rebuilds", "rebuild_reasons", "fast_appends", "fast_replaces",
            "fast_removes", "distro_rebuilds", "topology_splices", "fallbacks",
            "delta_rows")
#: the held-out distro the churn adds at ADD_STEP
ADD_STEP, REMOVE_STEP = 17, 31


def problem_docs(seed, n_distros=5, n_tasks=300):
    """Documents of a generated problem; the last distro is held out
    (added by the churn)."""
    distros, tbd, hbd, _, _ = generate_problem(
        n_distros, n_tasks, seed=seed, task_group_fraction=0.3,
        dep_fraction=0.3, hosts_per_distro=3)
    held = distros[-1].id
    docs = {"distros": [], "tasks": [], "hosts": []}
    extra = {"distros": [], "tasks": [], "hosts": []}
    for d in distros:
        out = extra if d.id == held else docs
        out["distros"].append(d.to_doc())
        out["tasks"] += [t.to_doc() for t in tbd[d.id]]
        out["hosts"] += [h.to_doc() for h in hbd[d.id]]
    return docs, extra


class Side:
    """One package's store, TickCache and resident plane."""

    def __init__(self, store_mod, cache_mod, plane, docs):
        self.store = store_mod.Store()
        for coll, ds in docs.items():
            self.store.collection(coll).insert_many(copy.deepcopy(ds))
        self.cache = cache_mod.TickCache(self.store)
        self.plane = plane(self.store)

    def sync(self, now, page, pool=None):
        gathered = self.cache.gather(now)
        snap = self.plane.sync(self.cache, *gathered, now, arena_pool=pool,
                               capacity_page=page)
        return gathered, snap


def host_bufs(snap):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in snap.arena.buffers.items()}


def capacity_page(step):
    rng = np.random.default_rng(step)
    if step % 7 == 3:
        return None
    return {"p_price": rng.random(8).astype(np.float32),
            "p_quota": (rng.random(8) * 100).astype(np.float32),
            "c_cfg": np.concatenate([[1.0], rng.random(7)]).astype(np.float32)}


def churn(rng, step, docs, extra, removed):
    """The step's write as a function of a store (the same on both)."""
    task_ids = [d["_id"] for d in docs["tasks"]]
    tid = rng.choice(task_ids)
    op = rng.randrange(10)
    if step == ADD_STEP:
        def add(s):
            for coll, ds in extra.items():
                s.collection(coll).insert_many(copy.deepcopy(ds))
        return "add distro", add
    if step == REMOVE_STEP:
        gone = docs["distros"][0]["_id"]
        removed.append(gone)
        return "remove distro", lambda s: s.collection("distros").remove(gone)
    if op == 0:
        return "complete", lambda s: s.collection("tasks").update(
            tid, {"status": "success"})
    if op in (1, 2):
        base = copy.deepcopy(rng.choice(docs["tasks"]))
        base.update(_id=f"new-{step}", depends_on=[], scheduled_time=0.0,
                    dependencies_met_time=0.0)
        if op == 2:
            base["task_group"] = f"grp-{rng.randrange(3)}"
        return "append", lambda s: s.collection("tasks").insert(
            copy.deepcopy(base))
    if op == 3:
        deps = ([{"task_id": rng.choice(task_ids), "status": "success",
                  "unattainable": rng.random() < 0.3, "finished": False}]
                if rng.random() < 0.7 else [])
        return "deps", lambda s: s.collection("tasks").update(
            tid, {"depends_on": deps})
    if op == 4:
        v = rng.choice([-1, 0, 7, 90])
        return "priority", lambda s: s.collection("tasks").update(
            tid, {"priority": v})
    if op == 5:
        ts, ids = NOW + step, [tid] + rng.sample(task_ids, 20)
        return "stamps", lambda s: s.collection("tasks").bulk_update(
            ids, {"scheduled_time": ts, "dependencies_met_time": ts})
    if op == 6:
        return "remove task", lambda s: s.collection("tasks").remove(tid)
    if op == 7:
        did = rng.choice([d["_id"] for d in docs["distros"]
                          if d["_id"] not in removed])
        doc = {"_id": f"host-{step}", "distro_id": did, "status": "running",
               "started_by": "mci", "provider": "mock"}
        return "host", lambda s: s.collection("hosts").insert(
            copy.deepcopy(doc))
    if op == 8:
        hosts = [d["_id"] for d in docs["hosts"]]
        hid, run = rng.choice(hosts), rng.choice(["", tid])
        return "host runs", lambda s: s.collection("hosts").update(
            hid, {"running_task": run, "running_task_group": ""})
    v = rng.random() < 0.5
    return "activated", lambda s: s.collection("tasks").update(
        tid, {"activated": v})


def check_step(label, jside, tside, jsnap, tsnap, gathered, now):
    assert jsnap is not None and tsnap is not None, label
    jb, tb = host_bufs(jsnap), host_bufs(tsnap)
    assert list(tb) == list(jb), label
    for kind in jb:
        assert tb[kind].dtype == jb[kind].dtype, (label, kind)
        assert tb[kind].tobytes() == jb[kind].tobytes(), (label, kind)
    assert tsnap.arena.layout_key() == jsnap.arena.layout_key(), label
    for name in ("seg_names", "n_tasks", "n_units", "n_hosts", "n_segs",
                 "n_distros", "distro_ids"):
        assert getattr(tsnap, name) == getattr(jsnap, name), (label, name)
    assert [t and t.id for t in tsnap.flat_tasks] == [
        t and t.id for t in jsnap.flat_tasks], label
    cold = t_snapshot.build_snapshot(*gathered, now)
    canon = t_resident.canonicalize(tsnap)
    assert canon == t_resident.canonicalize(cold), label
    assert canon == j_resident.canonicalize(jsnap), label
    for name in COUNTERS:
        assert getattr(tside.plane, name) == getattr(jside.plane, name), (
            label, name)


@pytest.mark.parametrize("seed", [3, 9])
@pytest.mark.parametrize("publish", ["arena", "mirror"])
def test_resident_plane_matches_jax_through_churn(seed, publish):
    docs, extra = problem_docs(seed)
    jside = Side(j_store, j_cache, j_resident.ResidentPlane, docs)
    mirror = DeviceMirror(device="cpu") if publish == "mirror" else None
    tside = Side(t_store, t_cache,
                 lambda st: t_resident.ResidentPlane(st, mirror=mirror), docs)
    pools = (t_packing.ArenaPool(), None)
    rng = random.Random(seed)
    removed, ops = [], set()
    for step in range(40):
        now = NOW + step
        page = capacity_page(step)
        _, jsnap = jside.sync(now, page)
        gathered, tsnap = tside.sync(now, page, pools[step % 2])
        check_step(f"step {step}", jside, tside, jsnap, tsnap, gathered, now)
        if publish == "mirror":
            assert all(isinstance(b, torch.Tensor)
                       for b in tsnap.arena.buffers.values())
        tsnap.arena.close()
        label, write = churn(rng, step, docs, extra, removed)
        ops.add(label)
        for side in (jside, tside):
            try:
                write(side.store)
            except KeyError:
                pass
    plane = tside.plane
    # the run exercised the delta machinery, not rebuilds to parity
    assert plane.rebuilds <= 2, plane.stats()
    assert plane.topology_splices + plane.rebuild_reasons.get("distro-set", 0) == 2
    assert plane.fast_removes and plane.fast_replaces and plane.delta_rows
    assert plane.fast_appends + plane.distro_rebuilds > 0
    assert plane.fallbacks == 0
    assert {"add distro", "remove distro", "append", "remove task",
            "stamps", "deps"} <= ops
    assert pools[0].forced_rotations == 0
    if publish == "mirror":
        stats = plane.stats()
        assert stats["mirror_full_uploads"] <= plane.rebuilds + 2
        assert stats["mirror_slice_rows"] + stats["mirror_delta_rows"] > 0


def test_resident_solve_matches_jax_on_slab_snapshots(x64):
    """After churn (holes, appends, a relayout-free distro rebuild) the
    port's CPU solve of its resident snapshot equals the JAX solve of
    the JAX plane's: every integer output and both distro duration sums
    bit for bit. The distro ranges of ``fused_distro_stats`` follow the
    slabs, not ``cumsum(d_task_count)``."""
    docs, _extra = problem_docs(5)
    jside = Side(j_store, j_cache, j_resident.ResidentPlane, docs)
    tside = Side(t_store, t_cache, t_resident.ResidentPlane, docs)
    rng = random.Random(5)
    task_ids = [d["_id"] for d in docs["tasks"]]
    checked = 0
    for step in range(4):
        now = NOW + 15 * step
        page = capacity_page(step)
        _, jsnap = jside.sync(now, page)
        _, tsnap = tside.sync(now, page)
        assert host_bufs(tsnap)["i32"].tobytes() == host_bufs(jsnap)["i32"].tobytes()
        if step:
            want = j_solve.run_solve_packed(jsnap)
            got = run_solve_packed(tsnap, device="cpu")
            for name, kind, _dim in j_solve.OUTPUT_SPEC:
                g, w = np.asarray(got[name]), np.asarray(want[name])
                if kind == "i32" or name in ("d_expected_dur_s", "d_over_dur_s"):
                    assert g.tobytes() == w.tobytes(), (step, name)
            checked += 1
            # the slab layout really has holes and misplaced cumsum ranges
            a = tsnap.arrays
            counts = np.asarray(a["d_task_count"]).astype(np.int64)
            assert int(np.asarray(a["t_valid"]).sum()) == int(counts.sum())
            assert not np.array_equal(
                np.concatenate([[0], np.cumsum(counts)]),
                distro_stats_inputs(unpack(tsnap.arena.buffers,
                                           tsnap.arena.layout_key(),
                                           "cpu"))[5].numpy())
        for snap in (jsnap, tsnap):
            snap.arena.close()
        done, bumped = rng.sample(task_ids, 25), rng.sample(task_ids, 30)
        for side in (jside, tside):
            tasks = side.store.collection("tasks")
            for tid in done:
                tasks.update(tid, {"status": "success"})
            tasks.bulk_update(bumped, {"priority": 50})
    assert checked == 3
    assert tside.plane.fast_removes > 0 and tside.plane.rebuilds == 1


def slab_stats_reference(a):
    """The seven statistics per distro straight from ``t_distro`` and
    ``t_valid`` with numpy, each duration sum a left fold in row order
    (the JAX lax path's scatter-add over ``t_distro`` on the CPU)."""
    D = len(a["d_valid"])
    valid = np.asarray(a["t_valid"]).astype(bool)
    td = np.asarray(a["t_distro"])
    th = np.asarray(a["d_thresh_s"], np.float32)
    th = np.where(th > 0, th, np.float32(1.0))
    dur = np.asarray(a["t_expected_s"], np.float32)
    wait = np.asarray(a["t_wait_dep_met_s"], np.float32)
    out = {name: np.zeros(D, np.float32) for name in STAT_NAMES}
    for i in np.flatnonzero(valid):
        d = td[i]
        dm = bool(a["t_deps_met"][i])
        over = dm and dur[i] > th[d]
        for name, v in (("d_length", 1.0), ("d_deps_met", float(dm)),
                        ("d_expected_dur_s", dur[i] if dm else 0.0),
                        ("d_over_count", float(over)),
                        ("d_over_dur_s", dur[i] if over else 0.0),
                        ("d_wait_over", float(dm and wait[i] > th[d])),
                        ("d_merge", float(dm and bool(a["t_is_merge"][i])))):
            out[name][d] = np.float32(out[name][d] + np.float32(v))
    return out


def test_cumsum_ranges_are_wrong_on_a_slab_snapshot_with_holes():
    """On a resident snapshot with holes the old rule's offsets,
    ``cumsum(d_task_count)``, give other statistics than the rows of each
    distro; the derived offsets give exactly them."""
    docs, _extra = problem_docs(7)
    tside = Side(t_store, t_cache, t_resident.ResidentPlane, docs)
    tside.sync(NOW, None)[1].arena.close()
    tasks = tside.store.collection("tasks")
    for doc in docs["tasks"][::5]:
        tasks.update(doc["_id"], {"status": "success"})
    _, snap = tside.sync(NOW + 15, None)
    assert tside.plane.fast_removes > 0 and tside.plane.rebuilds == 1
    a = unpack(snap.arena.buffers, snap.arena.layout_key(), "cpu")
    args = distro_stats_inputs(a)
    want = slab_stats_reference(snap.arrays)
    got = fused_distro_stats_plain(*args)
    for name in STAT_NAMES:
        assert got[name].numpy().tobytes() == want[name].tobytes(), name
    old = torch.cat([torch.zeros(1, dtype=torch.int32),
                     torch.cumsum(a["d_task_count"], 0).to(torch.int32)])
    stale = fused_distro_stats_plain(*args[:5], old, args[6])
    assert any(not torch.equal(stale[n], got[n]) for n in STAT_NAMES)
    snap.arena.close()


def test_failed_mirror_upload_raises_and_resets_the_plane(monkeypatch):
    """A copy the mirror cannot make raises ``MirrorError`` out of
    ``sync`` (no fallback to the host rebuild), the plane drops its
    columns, and the next sync after the fault full-rebuilds and
    uploads in full."""
    from evergreen_tpu_torch.ops import resident_ops

    docs, _extra = problem_docs(3)
    mirror = DeviceMirror(device="cpu")
    tside = Side(t_store, t_cache,
                 lambda st: t_resident.ResidentPlane(st, mirror=mirror), docs)
    tside.sync(NOW, None)
    real = resident_ops._upload

    def broken(buf, dev):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(resident_ops, "_upload", broken)
    tside.plane.invalidate("test")
    with pytest.raises(resident_ops.MirrorError, match="illegal memory access"):
        tside.sync(NOW + 1, None)
    assert tside.plane.fallbacks == 0
    monkeypatch.setattr(resident_ops, "_upload", real)
    gathered, snap = tside.sync(NOW + 2, None)
    assert tside.plane.rebuild_reasons.get("mirror-error") == 1
    cold = t_snapshot.build_snapshot(*gathered, NOW + 2)
    assert t_resident.canonicalize(snap) == t_resident.canonicalize(cold)
    assert mirror.full_uploads == 2


def test_resident_plane_for_follows_the_device():
    store = t_store.Store()
    plane = t_resident.resident_plane_for(store, "cpu")
    assert plane is t_resident.resident_plane_for(store, "cpu")
    assert t_resident.peek_resident_plane(store) is plane
    assert plane.device.type == "cpu" and plane._mirror is None
    assert t_resident.peek_resident_plane(t_store.Store()) is None


def test_arena_pool_lease_cycle_and_forced_rotation():
    """The pool as the JAX package's: a closed lease's set is reused, a
    double close frees nothing twice, an exhausted pool rotates its
    oldest lease (counted), and the victim's late close is a no-op."""
    results = {}
    for name, pool_cls, arena_for in (
            ("port", t_packing.ArenaPool, t_snapshot.arena_for_dims),
            ("jax", j_packing.ArenaPool, j_snapshot.arena_for_dims)):
        pool = pool_cls()
        dims = {"N": 16, "M": 16, "U": 16, "G": 8, "H": 8, "D": 8}
        a = arena_for(dims, pool)
        b = arena_for(dims, pool)
        a_buf = a.buffers["f32"]
        a.close()
        c = arena_for(dims, pool)
        reused = c.buffers["f32"] is a_buf
        c.close()
        c.close()
        d = arena_for(dims, pool)
        e = arena_for(dims, pool)
        rotations = pool.forced_rotations  # e reclaimed b's set
        stolen = e.buffers["f32"]
        stolen[0] = 42.0
        b.close()
        f = arena_for(dims, pool)
        results[name] = (reused, rotations, f.buffers["f32"] is not stolen,
                         float(stolen[0]), pool.forced_rotations)
        for x in (d, e, f):
            x.close()
    assert results["port"] == results["jax"] == (True, 1, True, 42.0, 2)


@pytest.mark.parametrize("case", ["gen", "gen-full-D", "forced"])
def test_cold_offsets_equal_the_cumsum_of_task_counts(case):
    """On the cold contiguous layout the derived ranges are
    ``cumsum(d_task_count)`` bit for bit, including a problem whose
    distros fill the D bucket (its padding tail carries the last real
    distro's index) and a build padded to larger forced dims."""
    from evergreen_tpu_torch.utils.benchgen import generate_problem as t_gen

    n_d = {"gen": 6, "gen-full-D": 8, "forced": 5}[case]
    problem = t_gen(n_d, 700, seed=n_d, task_group_fraction=0.2)
    force = {"N": 2048, "D": 16} if case == "forced" else None
    snap = t_snapshot.build_snapshot(*problem, NOW, force_dims=force)
    a = unpack(snap.arena.buffers, snap.arena.layout_key(), "cpu")
    offs = distro_stats_inputs(a)[5]
    want = torch.cat([torch.zeros(1, dtype=torch.int32),
                      torch.cumsum(a["d_task_count"], 0).to(torch.int32)])
    assert offs.dtype == torch.int32
    assert torch.equal(offs, want)
    if case == "gen-full-D":
        assert len(a["d_valid"]) == n_d  # no padding distro: the trap case
        assert int(offs[-1]) == snap.n_tasks < len(a["t_valid"])
