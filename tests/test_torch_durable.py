"""The port's durable store against the JAX package's.

Each test runs the same operations through JAX ``DurableStore`` and the
port's (``evergreen_tpu_torch/storage/durable.py``), each in its own
directory under ``tmp_path``, and compares what they wrote and what they
recover: WAL lines byte for byte (the clock is fixed, so the group
frames' ``ts`` agree), snapshots and their ``.meta`` sidecars, the
recovered collections in key order, and ``replay_report``. Either
package opens a directory the other wrote. Fault plans are installed in
the package under test, through the ``wal.append``, ``wal.commit``,
``wal.fence`` and ``snapshot.write`` seams. Leases are stolen with a
negative TTL, so no test waits on one.
"""
import json
import os
import random
import shutil
import threading
import time

import pytest

pytest.importorskip("torch")

from evergreen_tpu.storage import durable as j_durable  # noqa: E402
from evergreen_tpu.storage import integrity as j_integrity  # noqa: E402
from evergreen_tpu.storage import lease as j_lease  # noqa: E402
from evergreen_tpu.utils import faults as j_faults  # noqa: E402

from evergreen_tpu_torch.storage import durable as t_durable  # noqa: E402
from evergreen_tpu_torch.storage import integrity as t_integrity  # noqa: E402
from evergreen_tpu_torch.storage import lease as t_lease  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402

NOW = 1_700_000_000.0


class Pkg:
    """One package's durable store, lease, integrity and fault modules."""

    def __init__(self, name, durable, lease, integrity, faults):
        self.name = name
        self.durable = durable
        self.lease = lease
        self.integrity = integrity
        self.faults = faults

    def store(self, d, **kw):
        return self.durable.DurableStore(str(d), **kw)

    def holder(self, d, **kw):
        lease = self.lease.FileLease(os.path.join(str(d), "writer.lease"), ttl_s=60.0)
        assert lease.try_acquire()
        return lease, self.store(d, lease=lease, **kw)

    def steal(self, d):
        thief = self.lease.FileLease(os.path.join(str(d), "writer.lease"), ttl_s=60.0)
        thief.ttl_s = -1.0  # anything is stale: steal at once
        assert thief.try_acquire()
        thief.ttl_s = 60.0
        return thief


JAX = Pkg("jax", j_durable, j_lease, j_integrity, j_faults)
PORT = Pkg("port", t_durable, t_lease, t_integrity, t_faults)
PKGS = (JAX, PORT)


@pytest.fixture
def clock(monkeypatch):
    """A fixed wall clock: group frames carry the same ``ts``."""
    monkeypatch.setattr(time, "time", lambda: NOW)


@pytest.fixture(autouse=True)
def _no_fault_plans():
    yield
    j_faults.uninstall()
    t_faults.uninstall()


def dump(store) -> dict:
    """Every non-empty collection, documents in key order."""
    with store._lock:
        names = sorted(store._collections)
    out = {}
    for name in names:
        docs = store.collection(name).find()
        if docs:
            order = store.collection(name).key_order()
            out[name] = (docs, sorted(order, key=order.__getitem__))
    return out


def read(d, name=None):
    with open(os.path.join(str(d), name or t_durable.WAL_FILE), "rb") as fh:
        return fh.read()


def workload(store, seed=7, ops=60, group_every=9, async_commit=False):
    """A mixed workload: per-op puts, updates, compare-and-sets, mutates,
    removals, batches and a clear, and every ``group_every`` ops a tick
    group holding the persister's narrow writes (``um``, ``u`` with its
    version guard, ``pl``, ``qs``)."""
    rng = random.Random(seed)
    names = ["tasks", "hosts", "events"]
    live = {n: [] for n in names}
    queues = store.collection("task_queues")
    if queues.get("q") is None:
        queues.insert({"_id": "q", "rows": list(range(6)), "v": 0,
                       "sort_value": [float(i) for i in range(6)],
                       "dependencies_met": [True] * 6})
    for i in range(ops):
        n = rng.choice(names)
        coll = store.collection(n)
        roll = rng.random()
        if i and i % group_every == 0:
            store.begin_tick()
            tasks = store.collection("tasks")
            ids = live["tasks"][:4]
            tasks.bulk_update(ids, {"scheduled_time": float(i)})
            q = queues.get("q")
            v = q["v"]
            queues.patch("q", {"v": v + 1, "generated_at": float(i)})
            queues.patch_list("q", {"sort_value": ([0, 2], [i + 0.5, i + 0.25])},
                              {"v": v + 2})
            queues.splice_queue("q", [1], [(2, 100 + i, float(i), False)],
                                {"v": v + 3}, {"dependencies_met": ([0], [False])})
            coll.upsert({"_id": f"{n}-g{i}", "v": i})
            live[n].append(f"{n}-g{i}")
            if async_commit:
                store.end_tick_async()
            else:
                store.end_tick()
        elif roll < 0.45 or not live[n]:
            coll.upsert({"_id": f"{n}-{i}", "v": i, "blob": "x" * rng.randrange(20)})
            live[n].append(f"{n}-{i}")
        elif roll < 0.6:
            coll.update(rng.choice(live[n]), {"v": i * 1000})
        elif roll < 0.67:
            doc_id = rng.choice(live[n])
            coll.compare_and_set(doc_id, {"_id": doc_id}, {"cas": i})
        elif roll < 0.74:
            coll.mutate(rng.choice(live[n]), lambda d, i=i: d.setdefault("m", []).append(i))
        elif roll < 0.86:
            doc_id = rng.choice(live[n])
            coll.remove(doc_id)
            live[n].remove(doc_id)
        elif roll < 0.97:
            batch = [{"_id": f"{n}-b{i}-{k}", "v": k} for k in range(3)]
            coll.insert_many(batch)
            live[n] += [d["_id"] for d in batch]
        else:
            coll.clear()
            live[n] = []
    store.sync_persist()


def records(wal: bytes):
    """The WAL's records with ``ts`` and the CRC stamp taken out."""
    out = []
    for line in wal.splitlines():
        rec = json.loads(line)
        rec.pop("ts", None)
        rec.pop("k", None)
        out.append(rec)
    return out


# --------------------------------------------------------------------------- #
# what the two packages write
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("async_commit", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("leased", [False, True], ids=["unleased", "leased"])
def test_wal_lines_are_byte_equal(tmp_path, clock, async_commit, leased):
    """Per-op lines and group frames (epoch, ``ts``, ordinal and CRC
    stamp included) are the JAX package's bytes."""
    wals, dumps = {}, {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.holder(d)[1] if leased else pkg.store(d)
        workload(store, async_commit=async_commit)
        wals[pkg.name], dumps[pkg.name] = read(d), dump(store)
    assert wals["port"] == wals["jax"]
    assert dumps["port"] == dumps["jax"]
    frames = [r for r in records(wals["port"]) if r.get("o") == "g"]
    assert frames and {op["o"] for f in frames for op in f["rs"]} >= {
        "um", "u", "pl", "qs", "p"}
    if leased:
        assert all(r.get("e") == 1 for r in records(wals["port"]))


def test_group_frames_equal_with_ts_masked(tmp_path):
    """On the live clock the frames differ only in ``ts`` (and so in the
    stamp over it)."""
    wals = {}
    for pkg in PKGS:
        store = pkg.store(tmp_path / pkg.name)
        workload(store, seed=3, async_commit=True)
        wals[pkg.name] = read(tmp_path / pkg.name)
    assert records(wals["port"]) == records(wals["jax"])
    assert all(t_integrity.verify_wal_line(line) is True
               for line in wals["port"].splitlines())


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_each_package_opens_the_others_directory(tmp_path, clock, writer, reader):
    """A directory written by one package (a checkpoint, then more
    writes and groups in the WAL) opens in the other with the same
    collections in the same key order and the same replay report; the
    reader's own writes then continue the writer's line numbering."""
    d = tmp_path / "data"
    lease, store = writer.holder(d)
    workload(store, seed=5)
    store.checkpoint()
    workload(store, seed=6, ops=30)
    want = dump(store)
    store._journal.close()
    lease.release()
    again = writer.store(d)
    assert dump(again) == want
    again._journal.close()
    other = reader.store(d)
    assert dump(other) == want
    assert other.replay_report == again.replay_report
    assert other.wal_seq == again.wal_seq
    other.collection("tasks").upsert({"_id": "after"})
    other._journal.close()
    assert dump(writer.store(d))["tasks"][0][-1]["_id"] == "after"


@pytest.mark.parametrize("compact_every_ops", [None, 10, 1])
def test_checkpoint_and_compaction_match_jax(tmp_path, clock, compact_every_ops):
    """An explicit checkpoint, or auto-compaction at a small
    ``compact_every_ops`` (inline, mid-batch and mid-group), writes the
    JAX package's snapshot, meta and WAL generations, and reopens to the
    same state."""
    kw = {} if compact_every_ops is None else {"compact_every_ops": compact_every_ops}
    files = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.store(d, **kw)
        workload(store, seed=9)
        if compact_every_ops is None:
            store.checkpoint()
            assert store._journal.ops == 0
            store.collection("tasks").upsert({"_id": "post-checkpoint"})
        want = dump(store)
        names = sorted(n for n in os.listdir(d) if not n.endswith(".lease"))
        files[pkg.name] = {n: read(d, n) for n in names}
        store._journal.close()
        assert dump(pkg.store(d)) == want
    assert files["port"] == files["jax"]
    assert "snapshot.json" in files["port"] and "snapshot.json.meta" in files["port"]


# --------------------------------------------------------------------------- #
# recovery
# --------------------------------------------------------------------------- #


def test_recovery_at_every_truncation_offset_matches_jax(tmp_path, clock):
    """A WAL of per-op lines and group frames, cut at every line boundary
    (both sides) and densely between: the port recovers exactly what the
    JAX package recovers at each offset, with the same replay report, and
    never part of a group."""
    src = tmp_path / "src"
    store = JAX.store(src)
    workload(store, seed=13, ops=50)
    store._journal.close()
    wal = read(src)
    boundaries = [i + 1 for i, b in enumerate(wal) if b == 0x0A]
    offsets = sorted(set(range(0, len(wal) + 1, 53)) | set(boundaries)
                     | {b - 1 for b in boundaries} | {len(wal)})
    for cut in offsets:
        got = {}
        for pkg in PKGS:
            d = tmp_path / f"cut-{pkg.name}"
            d.mkdir()
            with open(d / t_durable.WAL_FILE, "wb") as fh:
                fh.write(wal[:cut])
            rec = pkg.store(d)
            got[pkg.name] = (dump(rec), rec.replay_report, rec.wal_seq)
            rec._journal.close()
            shutil.rmtree(d)
        assert got["port"] == got["jax"], f"divergence at truncation offset {cut}"


def test_replay_is_idempotent_across_restarts(tmp_path, clock):
    """Recover, recover again, checkpoint, recover: the state never
    drifts, in either package, and the packages agree at every step."""
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.store(d)
        workload(store, seed=11)
        want = dump(store)
        store._journal.close()
        for k in range(3):
            s = pkg.store(d)
            assert dump(s) == want, (pkg.name, k)
            if k == 1:
                s.checkpoint()
            s._journal.close()
    assert read(tmp_path / "port") == read(tmp_path / "jax")


@pytest.mark.parametrize("writer", PKGS, ids=lambda p: p.name)
def test_crash_between_snapshot_rename_and_wal_rotate(tmp_path, clock, writer):
    """A checkpoint's crash window: the new snapshot is in place but the
    full pre-checkpoint WAL is still beside it (and a stranded snapshot
    ``.tmp``). Replay skips every line the snapshot already holds (their
    ordinals), in either package: the same state, the same replay report
    (no frame counted twice) and the same line count."""
    d = tmp_path / "data"
    store = writer.store(d)
    workload(store, seed=23)
    want = dump(store)
    wal_before = read(d)
    store.checkpoint()
    store._journal.close()
    with open(d / t_durable.WAL_FILE, "wb") as fh:
        fh.write(wal_before)
    with open(d / (t_durable.SNAPSHOT_FILE + ".tmp"), "w") as fh:
        fh.write('{"collections": {"tasks": [{"_id": "GARBAGE"}]}}')
    got = {}
    for pkg in PKGS:
        copy_dir = tmp_path / f"open-{pkg.name}"
        shutil.copytree(d, copy_dir)
        recovered = pkg.store(copy_dir)
        got[pkg.name] = (dump(recovered), recovered.replay_report, recovered.wal_seq)
    assert got["port"] == got["jax"]
    assert got["port"][0] == want and got["port"][1]["frames"] == 0


# --------------------------------------------------------------------------- #
# epochs and the fence
# --------------------------------------------------------------------------- #

_FRAME = '{"o":"g","n":1,"e":%d,"rs":[{"c":"k","o":"p","d":{"_id":"%s","by":%d}}]}\n'
STALE_WALS = {
    # a superseded holder's frame past a newer frame is dropped
    "frames": [_FRAME % (1, "a", 1), _FRAME % (2, "b", 2), _FRAME % (1, "c", 1),
               _FRAME % (2, "d", 2)],
    # per-op lines carry the epoch too; the open-time fence marker pins it
    "per-op": ['{"c":"k","o":"p","d":{"_id":"pre"},"e":1}\n', '{"o":"f","e":2}\n',
               '{"c":"k","o":"p","d":{"_id":"stale"},"e":1}\n',
               '{"c":"k","o":"p","d":{"_id":"new"},"e":2}\n'],
    # a stale holder's version of a doc the new holder rewrote
    "same-doc": [_FRAME % (2, "x", 2), _FRAME % (1, "x", 1)],
}


@pytest.mark.parametrize("name", sorted(STALE_WALS))
def test_stale_epoch_records_are_dropped_like_jax(tmp_path, name):
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        d.mkdir()
        with open(d / t_durable.WAL_FILE, "w") as fh:
            fh.writelines(STALE_WALS[name])
        store = pkg.store(d)
        got[pkg.name] = (dump(store), store.replay_report)
    assert got["port"] == got["jax"]
    assert got["port"][1]["stale_frames_dropped"] >= 1


def test_fence_marker_drops_a_late_frame(tmp_path, clock):
    """A deposed holder's frame that lands after the new holder opened,
    before its first commit, is dropped on replay: the new holder's
    open-time marker is the fence point."""
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        _, store = pkg.holder(d)
        thief = pkg.steal(d)
        new_store = pkg.store(d, lease=thief)
        assert new_store.epoch == 2
        with open(d / t_durable.WAL_FILE, "a") as fh:
            fh.write(_FRAME % (1, "late", 1))
        rec = pkg.store(d)
        got[pkg.name] = (dump(rec), rec.replay_report, read(d))
    assert got["port"] == got["jax"]
    assert got["port"][1]["stale_frames_dropped"] == 1


def test_standby_epoch_outranks_orphaned_frames(tmp_path):
    """The lease file is gone but the WAL holds epoch-7 frames: a fresh
    holder is advanced past them at open (``ensure_epoch_at_least``)."""
    for pkg in PKGS:
        d = tmp_path / pkg.name
        d.mkdir()
        with open(d / t_durable.WAL_FILE, "w") as fh:
            fh.write(_FRAME % (7, "x", 7))
        lease, store = pkg.holder(d)
        assert lease.epoch == store.epoch == 8, pkg.name
        assert json.load(open(d / "writer.lease"))["epoch"] == 8


@pytest.mark.parametrize("commit", ["sync", "async"])
@pytest.mark.parametrize("seam", [None, "wal.fence"])
def test_fenced_commit_sheds_its_group_and_stands_down(tmp_path, clock, seam, commit):
    """A steal before the commit (or landing mid-commit, at the
    ``wal.fence`` seam): the commit itself raises — ``end_tick_async``
    too, at the detach, with nothing queued for the flusher — the group
    is dropped, the lease stands down, and every later write, checkpoint
    and close refuses; the two packages leave the same WAL and recover
    the same state."""
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        lease, store = pkg.holder(d)
        store.collection("k").upsert({"_id": "pre", "v": 0})
        store.begin_tick()
        store.collection("k").upsert({"_id": "mid-tick", "v": 1})
        if seam is None:
            pkg.steal(d)
        else:
            pkg.faults.install(pkg.faults.FaultPlan().at(
                seam, 0, pkg.faults.Fault("call", fn=lambda: pkg.steal(d))))
        with pytest.raises(pkg.lease.EpochFencedError):
            store.end_tick() if commit == "sync" else store.end_tick_async()
        assert store.flush_backlog() == 0
        assert store.fenced and lease.lost
        with pytest.raises(pkg.lease.EpochFencedError):
            store.collection("k").upsert({"_id": "after", "v": 2})
        with pytest.raises(pkg.lease.EpochFencedError):
            store.checkpoint()
        store.close()
        assert not os.path.exists(d / t_durable.SNAPSHOT_FILE)
        rec = pkg.store(d)
        got[pkg.name] = (dump(rec), read(d))
    assert got["port"] == got["jax"]
    assert [d["_id"] for d in got["port"][0]["k"][0]] == ["pre"]


# --------------------------------------------------------------------------- #
# integrity and disk faults
# --------------------------------------------------------------------------- #


def ticks(store, lo, hi):
    for t in range(lo, hi):
        store.collection("oplog").upsert({"_id": f"op-{t}", "t": t})
        store.begin_tick()
        try:
            for j in range(3):
                store.collection("jobs").upsert({"_id": f"job-{t}-{j}", "tick": t})
        finally:
            store.end_tick()


def quarantined(d, name):
    return sorted(n.split(".corrupt-")[0] for n in os.listdir(d) if ".corrupt-" in n
                  and n.startswith(name))


def test_crc_prefix_stop_is_jax(tmp_path, clock):
    """A rotted byte in the back half of the WAL ends its valid prefix:
    the rest is never applied, a forensic copy stays beside it, and the
    open heals with a checkpoint that a second open replays whole."""
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.store(d)
        ticks(store, 0, 6)
        store._journal.close()
        wal = d / t_durable.WAL_FILE
        pkg.integrity.corrupt_byte(str(wal), int(os.path.getsize(wal) * 0.75))
        reopened = pkg.store(d)
        assert reopened.replay_report["corrupt_frames"] == 1
        assert quarantined(d, t_durable.WAL_FILE) == [t_durable.WAL_FILE]
        again = pkg.store(d)
        assert again.replay_report["corrupt_frames"] == 0
        got[pkg.name] = (dump(reopened), reopened.replay_report, dump(again))
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][2]


def rot_a_digit(path):
    """Change one digit of a JSON file: it still parses, only its digest
    tells."""
    with open(path, "r+b") as fh:
        data = fh.read()
        at = data.index(b'"t":') + 4
        fh.seek(at)
        fh.write(b"9" if data[at:at + 1] != b"9" else b"8")


@pytest.mark.parametrize("when", ["scrub", "open", "open-parses"])
def test_snapshot_quarantined_and_rebuilt(tmp_path, clock, when):
    """A snapshot that fails its digest is moved aside and rebuilt: by
    ``scrub`` on a live store, or at open from the ``.prev`` generation
    and both WALs — also when the rotted snapshot still parses."""
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.store(d)
        ticks(store, 0, 3)
        store.checkpoint()
        ticks(store, 3, 4)
        truth = dump(store)
        snap = d / t_durable.SNAPSHOT_FILE
        if when == "scrub":
            store.checkpoint()
            pkg.integrity.corrupt_byte(str(snap))
            report = store.scrub()
            assert report["snapshot_corrupt"] == 1 and report["healed"] == 1
            meta = json.load(open(str(snap) + t_durable.SNAPSHOT_META_SUFFIX))
            assert meta["crc"] == pkg.integrity.file_crc32(str(snap))
            got[pkg.name] = (dump(pkg.store(d)), report)
        else:
            store._journal.close()
            if when == "open":
                pkg.integrity.corrupt_byte(str(snap))
            else:
                rot_a_digit(str(snap))
            reopened = pkg.store(d)
            assert reopened.replay_report["snapshots_quarantined"] == 1
            got[pkg.name] = (dump(reopened), reopened.replay_report)
        assert got[pkg.name][0] == truth
        assert quarantined(d, t_durable.SNAPSHOT_FILE) == [t_durable.SNAPSHOT_FILE]
    assert got["port"] == got["jax"]


def test_enospc_shed_then_healed(tmp_path, clock):
    """ENOSPC at a group commit (the ``wal.commit`` seam) sheds the frame
    and floors the store's overload ladder at RED; the next accepted
    frame heals with a checkpoint and lifts the floor. Nothing is lost."""
    from evergreen_tpu.utils import overload as j_overload
    from evergreen_tpu_torch.utils import overload as t_overload

    got = {}
    for pkg, overload in ((JAX, j_overload), (PORT, t_overload)):
        d = tmp_path / pkg.name
        store = pkg.store(d)
        ticks(store, 0, 1)
        pkg.faults.install(pkg.faults.FaultPlan().at(
            "wal.commit", 0, pkg.faults.Fault("enospc")))
        ticks(store, 1, 2)
        pkg.faults.uninstall()
        assert store._enospc_floor
        assert overload.monitor_for(store)._floor_level == overload.RED
        ticks(store, 2, 3)
        store.sync_persist()
        assert not store._enospc_floor
        assert overload.monitor_for(store)._floor_level == overload.GREEN
        got[pkg.name] = (dump(pkg.store(d)), read(d))
        assert got[pkg.name][0] == dump(store)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("seam,kind", [("wal.commit", "torn"), ("wal.append", "torn"),
                                       ("wal.append", "short")])
def test_torn_and_short_writes_recover_like_jax(tmp_path, clock, seam, kind):
    """A torn frame loses its whole group (never part of it); a torn
    per-op line raises to the writer; a silent short write is convicted
    by ``scrub``, which heals. Both packages leave the same files and
    recover the same state."""
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.store(d)
        ticks(store, 0, 1)
        before = dump(store)
        pkg.faults.install(pkg.faults.FaultPlan().at(seam, 0, pkg.faults.Fault(kind)))
        if kind == "torn":
            with pytest.raises(OSError):
                ticks(store, 1, 2)
        else:
            ticks(store, 1, 2)
        pkg.faults.uninstall()
        ticks(store, 2, 3)
        report = store.scrub() if kind == "short" else None
        store._journal.close()
        rec = pkg.store(d)
        got[pkg.name] = (dump(rec), rec.replay_report, report, read(d))
        if seam == "wal.commit":
            # tick 1's group is gone whole: its jobs, not its per-op line
            jobs = {x["_id"] for x in got[pkg.name][0]["jobs"][0]}
            assert not any(j.startswith("job-1-") for j in jobs)
            assert {x["_id"] for x in before["jobs"][0]} <= jobs
        if kind == "short":
            assert report["wal_corrupt_frames"] == 1 and report["healed"] == 1
            assert got[pkg.name][0] == dump(store)
    assert got["port"] == got["jax"]


def test_snapshot_write_fault_leaves_no_tmp(tmp_path):
    """ENOSPC mid-snapshot (the ``snapshot.write`` seam) raises, strands
    no ``.tmp`` and leaves the WAL whole, in both packages."""
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.store(d)
        ticks(store, 0, 2)
        pkg.faults.install(pkg.faults.FaultPlan().at(
            "snapshot.write", 0, pkg.faults.Fault("enospc")))
        with pytest.raises(OSError):
            store.checkpoint()
        pkg.faults.uninstall()
        assert sorted(os.listdir(d)) == [t_durable.WAL_FILE], pkg.name
        assert dump(pkg.store(d)) == dump(store)


def test_concurrent_writes_during_checkpoint(tmp_path):
    """Writers hammer the port's store while checkpoints run: no write is
    lost, and the JAX package reopens the directory to the same state."""
    d = tmp_path / "data"
    s = PORT.store(d)
    c = s.collection("k")
    stop = threading.Event()
    wrote = []

    def writer(wid):
        i = 0
        while not stop.is_set():
            c.upsert({"_id": f"w{wid}-{i}", "v": i})
            wrote.append(f"w{wid}-{i}")
            i += 1

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
    for t in threads:
        t.start()
    for _ in range(5):
        time.sleep(0.02)
        s.checkpoint()
    stop.set()
    for t in threads:
        t.join()
    port = PORT.store(d)
    missing = [i for i in wrote if port.collection("k").get(i) is None]
    assert not missing, f"lost {len(missing)} writes: {missing[:5]}"
    port._journal.close()
    assert dump(JAX.store(d)) == dump(port)


def test_per_op_appends_queue_behind_an_async_frame(tmp_path, clock):
    """While an async frame waits on the flusher, a per-op write queues
    behind it, so the WAL's order is the apply order; the packages write
    the same lines."""
    wals = {}
    for pkg in PKGS:
        d = tmp_path / pkg.name
        store = pkg.store(d)
        gate = threading.Event()
        pkg.faults.install(pkg.faults.FaultPlan().at(
            "wal.commit", 0, pkg.faults.Fault("call", fn=gate.wait)))
        store.begin_tick()
        store.collection("k").upsert({"_id": "in-frame", "v": 1})
        store.end_tick_async()
        store.collection("k").update("in-frame", {"v": 2})
        assert store.flush_backlog() == 2
        gate.set()
        store.sync_persist()
        assert store.flush_backlog() == 0
        wals[pkg.name] = read(d)
        assert dump(pkg.store(d))["k"][0] == [{"_id": "in-frame", "v": 2}]
    assert wals["port"] == wals["jax"]
    assert [r["o"] for r in records(wals["port"])] == ["g", "p"]


def test_fleet_segment_ids_match_jax(tmp_path):
    for name in ("wal.log", "wal.shard0.log", "snapshot.shard3.json", "wal.shard12.log",
                 "writer.shard1.lease", "snapshot.json.meta"):
        (tmp_path / name).write_text("")
    assert t_durable.fleet_segment_ids(str(tmp_path)) == j_durable.fleet_segment_ids(
        str(tmp_path)) == [None, 0, 3, 12]
    assert t_durable.fleet_segment_ids(str(tmp_path / "missing")) == []
