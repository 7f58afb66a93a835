"""Disk-fault matrix: the storage-integrity analogue of the crash matrix.

A port of the JAX repository's ``tools/disk_matrix.py``. Where the
crash matrix kills the process at every durability boundary, this
matrix lets the process LIVE and rots the disk underneath it, then
asserts the detection, quarantine and self-heal contract end to end:

  * resume == rerun: after any single injected disk fault, a cold
    reopen of the store equals both the still-serving in-memory truth
    and an uninterrupted reference run;
  * zero corrupt frames applied: CRC-failed WAL lines end the valid
    prefix at replay, counted and never applied;
  * quarantine accounting: corruption counters move by exactly the
    injected fault, forensic ``.corrupt-<ts>`` copies are kept, and a
    second scrub after the heal is clean;
  * no stranded temp files: every atomic publish either lands or
    vanishes, even under ENOSPC/EIO mid-write.

Four arms, all run by default:

  grid    fault seams x kinds x store configurations {classic,
          durable+lease, 2-shard fleet}, driven in-process against a
          deterministic store workload (no device);
  engine  the same seams driven through the scenario engine's
          ``disk_fault`` event against a scheduling fleet, its ticks on
          ``device`` (work must finish; counters must move; no stranded
          tmp; every tick planned by the device solve);
  cases   bespoke integrity cases: WAL format upgrade-compat (unstamped
          logs, written under ``integrity.set_wal_crc_enabled(False)``,
          replay under a stamping writer), manifest bitrot/ENOSPC, lease
          corruption + TTL-gated steal, replica valid-prefix stop +
          read-repair;
  fuzz    reachability: the weather fuzzer must actually draw
          ``disk_fault`` events, and those cases must run green on
          ``device``.

    python -m evergreen_tpu_torch.scenarios.disk_matrix [--grid-only |
        --engine-only | --cases-only | --fuzz-only | --point C:SEAM:KIND]
        [--device cpu|cuda]

One JSON line per point, a ``TICKS`` line per point that ticks (its
verdicts and counters, its ticks' planners, its card solves and the
kernel counters' deltas, which must be the launches of those solves),
the lock-order inversions, a summary line; exit 1 on any failure or
inversion. Failed points keep their data dir for inspection. Run as a
module it switches the lock-order witness on, as the fault matrix does.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from .crash_matrix import start_device
from .fault_matrix import (
    card_books,
    card_counts,
    device_arg,
    lockcheck_line,
    reexec_with_witness,
)

_MODULE = "evergreen_tpu_torch.scenarios.disk_matrix"

TICKS = 6
#: checkpoint EARLY (before any armed fault): a later checkpoint would
#: rotate a rotted WAL into ``.prev`` and legitimately retire the rot
#: before the scrub could ever see it
#: (tick 0: in the 2-shard config the shared seam counters reach the
#: armed index during tick 1 already)
CHECKPOINT_TICK = 0
CONFIGS = ("classic", "lease", "fleet2")

#: (seam, kind) grid. ``torn`` is WAL-only (a half-written line with
#: the raise surfaced); snapshots instead get ``short`` (truncated
#: publish) and ``bitrot`` (post-rename rot), the two ways a rename
#: target goes bad.
GRID: List[Tuple[str, str]] = [
    ("wal.append", "enospc"),
    ("wal.append", "eio"),
    ("wal.append", "torn"),
    ("wal.append", "short"),
    ("wal.append", "bitrot"),
    ("wal.commit", "enospc"),
    ("wal.commit", "eio"),
    ("wal.commit", "torn"),
    ("wal.commit", "short"),
    ("wal.commit", "bitrot"),
    ("snapshot.write", "enospc"),
    ("snapshot.write", "eio"),
    ("snapshot.write", "bitrot"),
    ("snapshot.write", "short"),
]

#: per-seam call index to arm: mid-workload, past the first tick (so
#: there is a valid prefix to keep) and before the last (so serving
#: continues past the fault).
SEAM_INDEX = {"wal.append": 3, "wal.commit": 2, "snapshot.write": 0}

ENGINE_KINDS = ("enospc", "eio", "bitrot", "short")
ENGINE_TARGETS = ("wal", "snapshot")


# ---------------------------------------------------------------- workload

def _tick_ops(store, t: int, shard: int) -> None:
    jobs = store.collection("jobs")
    for j in range(3):
        jobs.upsert({
            "_id": "job-%d-%d-%d" % (shard, t, j),
            "tick": t, "shard": shard, "payload": "p" * 32,
        })
    store.collection("queues").upsert({
        "_id": "q%d" % shard,
        "rows": ["job-%d-%d" % (shard, i) for i in range(t + 1)],
    })


def _one_tick(store, t: int, shard: int) -> None:
    # one per-op write OUTSIDE the tick group (rides the wal.append
    # seam), then a grouped tick (rides wal.commit)
    store.collection("oplog").upsert({"_id": "op-%d-%d" % (shard, t),
                                      "t": t})
    store.begin_tick()
    try:
        _tick_ops(store, t, shard)
    finally:
        store.end_tick()


def _run_workload(stores) -> None:
    """TICKS deterministic ticks per store. A raised disk fault aborts
    a tick mid-flight; the contract is heal-and-redo: the redo is
    idempotent (upserts) and the one-shot fault is already consumed."""
    from ..utils import faults

    for t in range(TICKS):
        for si, store in enumerate(stores):
            try:
                _one_tick(store, t, si)
            except (OSError, faults.FaultError):
                store.heal_durability()
                _one_tick(store, t, si)
        if t == CHECKPOINT_TICK:
            for store in stores:
                try:
                    store.checkpoint()
                except OSError:
                    # injected ENOSPC/EIO at the publish: the previous
                    # checkpoint (or bare WAL) stays authoritative
                    pass


def canonical(store) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for name in sorted(store._collections):
        out[name] = sorted(
            store.collection(name).find(), key=lambda d: d["_id"]
        )
    return out


def _open_stores(config: str, data_dir: str):
    from ..storage.durable import DurableStore
    from ..storage.lease import FileLease

    if config == "classic":
        return [DurableStore(data_dir)], []
    if config == "lease":
        lease = FileLease(os.path.join(data_dir, "writer.lease"),
                          ttl_s=60.0)
        if not lease.acquire(timeout_s=5.0):
            raise RuntimeError("could not acquire writer lease")
        return [DurableStore(data_dir, lease=lease)], [lease]
    if config == "fleet2":
        stores, leases = [], []
        for k in range(2):
            lease = FileLease(
                os.path.join(data_dir, "writer-%d.lease" % k), ttl_s=60.0
            )
            if not lease.acquire(timeout_s=5.0):
                raise RuntimeError("could not acquire shard %d lease" % k)
            stores.append(DurableStore(data_dir, lease=lease, shard_id=k))
            leases.append(lease)
        return stores, leases
    raise ValueError("unknown config %r" % config)


def _close_all(stores, leases) -> None:
    for store in stores:
        try:
            store.close()
        except Exception:  # noqa: BLE001 — a rotted or fenced store may refuse close work
            pass
    for lease in leases:
        try:
            lease.release()
        except Exception:  # noqa: BLE001
            pass


def _stranded_tmp(data_dir: str) -> List[str]:
    out = []
    for root, _dirs, names in os.walk(data_dir):
        for n in names:
            if n.endswith(".tmp") or n.endswith(".prevtmp"):
                out.append(os.path.relpath(os.path.join(root, n),
                                           data_dir))
    return out


def _counter_deltas(before: Dict[str, int]) -> Dict[str, int]:
    from ..utils.log import counters_snapshot

    after = counters_snapshot()
    return {
        k: v - before.get(k, 0)
        for k, v in after.items()
        if k.startswith("storage.") and v != before.get(k, 0)
    }


def expected_counters(seam: str, kind: str) -> Dict[str, Tuple[int, Optional[int]]]:
    """(min, max) bounds on storage.* counter deltas per grid point.
    Raised faults (eio, torn's surfaced OSError, append enospc) leave
    no rot behind: the harness heals and redoes, nothing to count."""
    wal = seam.startswith("wal.")
    if wal and seam == "wal.commit" and kind == "enospc":
        return {"storage.enospc_sheds": (1, 1)}
    if wal and kind in ("short", "bitrot"):
        return {
            "storage.wal_corrupt_frames": (1, 1),
            "storage.rebuilds": (1, None),
        }
    if seam == "snapshot.write" and kind in ("short", "bitrot"):
        return {
            "storage.snapshot_quarantined": (1, 1),
            "storage.rebuilds": (1, None),
        }
    return {}


# ---------------------------------------------------------------- grid arm

def reference_states(config: str) -> List[Dict[str, List[dict]]]:
    data_dir = tempfile.mkdtemp(prefix="diskref-%s-" % config)
    stores, leases = _open_stores(config, data_dir)
    try:
        _run_workload(stores)
        for store in stores:
            store.sync_persist()
        return [canonical(s) for s in stores]
    finally:
        _close_all(stores, leases)
        shutil.rmtree(data_dir, ignore_errors=True)


def run_grid_point(config: str, seam: str, kind: str,
                   reference: List[Dict[str, List[dict]]]) -> dict:
    from ..storage.durable import DurableStore
    from ..utils import faults
    from ..utils.log import counters_snapshot

    point = "%s:%s:%s" % (config, seam, kind)
    data_dir = tempfile.mkdtemp(
        prefix="diskmx-%s-%s-%s-" % (config, seam.replace(".", "-"), kind)
    )
    problems: List[str] = []
    before = counters_snapshot()
    plan = faults.FaultPlan().at(seam, SEAM_INDEX[seam],
                                 faults.Fault(kind))
    faults.install(plan)
    stores, leases = [], []
    try:
        try:
            stores, leases = _open_stores(config, data_dir)
            _run_workload(stores)
        finally:
            faults.uninstall()
        if len(plan.fired) != 1:
            problems.append(
                "expected exactly one injected fault, fired=%r"
                % (plan.fired,)
            )

        # detection + self-heal while still serving
        for store in stores:
            store.scrub()
            store.sync_persist()
        live = [canonical(s) for s in stores]
        for si, store in enumerate(stores):
            rep = store.scrub()
            dirty = {
                k: rep[k]
                for k in ("wal_corrupt_frames", "snapshot_corrupt",
                          "torn_stub")
                if rep.get(k)
            }
            if dirty:
                problems.append(
                    "store %d: second scrub not clean after heal: %r"
                    % (si, dirty)
                )

        deltas = _counter_deltas(before)
        for name, (lo, hi) in expected_counters(seam, kind).items():
            got = deltas.get(name, 0)
            if got < lo or (hi is not None and got > hi):
                problems.append(
                    "counter %s moved %d, want [%d, %s]"
                    % (name, got, lo, "inf" if hi is None else hi)
                )

        # cold reopen: replay must apply zero corrupt frames and land
        # on the same state as the live store AND an uninterrupted
        # reference run (resume == rerun)
        for si, store in enumerate(stores):
            reopened = DurableStore(data_dir, shard_id=store.shard_id)
            if reopened.replay_report["corrupt_frames"]:
                problems.append(
                    "store %d: cold reopen still sees corrupt frames: %r"
                    % (si, reopened.replay_report)
                )
            got = canonical(reopened)
            if got != live[si]:
                problems.append(
                    "store %d: cold reopen diverged from live state" % si
                )
            if got != reference[si]:
                problems.append(
                    "store %d: resume != rerun (reference mismatch)" % si
                )
            reopened._journal.close()

        stranded = _stranded_tmp(data_dir)
        if stranded:
            problems.append("stranded temp files: %r" % (stranded,))
        if kind in ("short", "bitrot"):
            names = os.listdir(data_dir)
            if not any(".corrupt-" in n for n in names):
                problems.append(
                    "no forensic .corrupt-<ts> copy kept beside the store"
                )
    finally:
        faults.uninstall()
        _close_all(stores, leases)

    ok = not problems
    if ok:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {
        "arm": "grid", "point": point, "ok": ok,
        "fired": [list(f) for f in plan.fired],
        "counters": _counter_deltas(before),
        "problems": problems,
        "data_dir": None if ok else data_dir,
    }


def run_grid(only_point: Optional[str] = None,
             configs: Tuple[str, ...] = CONFIGS) -> List[dict]:
    """The grid over ``configs``; each point's line carries its wall
    (``wall_s``)."""
    results = []
    for config in configs:
        reference = None
        for seam, kind in GRID:
            point = "%s:%s:%s" % (config, seam, kind)
            if only_point is not None and point != only_point:
                continue
            if reference is None:
                reference = reference_states(config)
            t0 = time.perf_counter()
            res = run_grid_point(config, seam, kind, reference)
            res["wall_s"] = round(time.perf_counter() - t0, 4)
            print(json.dumps(res), flush=True)
            results.append(res)
    return results


# -------------------------------------------------------------- engine arm

def _counter_check(name: str, lo: int, hi: Optional[int] = None):
    def check(run) -> Optional[str]:
        got = run.counter_delta(name)
        if got < lo or (hi is not None and got > hi):
            return "%s moved %d, want [%d, %s]" % (
                name, got, lo, "inf" if hi is None else hi
            )
        return None
    return check


def _check_no_stranded_tmp(run) -> Optional[str]:
    stranded = _stranded_tmp(run.data_dir)
    if stranded:
        return "stranded temp files beside the store: %r" % (stranded,)
    return None


def _engine_spec(target: str, kind: str):
    from ..globals import Provider
    from .spec import SLO, Ev, ScenarioSpec

    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dgrid", "provider": Provider.MOCK.value, "hosts": 4},
        ]}),
        Ev(0, "tasks", {"distro": "dgrid", "n": 8, "prefix": "dg-t"}),
        Ev(2, "disk_fault", {"target": target, "kind": kind}),
        Ev(6, "tasks", {"distro": "dgrid", "n": 4, "prefix": "dg-b"}),
    ]
    checks = [("no-stranded-tmp", _check_no_stranded_tmp)]
    if target == "wal":
        if kind == "enospc":
            checks.append(("enospc-shed",
                           _counter_check("storage.enospc_sheds", 1, 1)))
        elif kind in ("bitrot", "short"):
            checks.append(("rot-detected",
                           _counter_check("storage.wal_corrupt_frames",
                                          1)))
            checks.append(("rot-healed",
                           _counter_check("storage.rebuilds", 1)))
    else:
        if kind in ("bitrot", "short"):
            checks.append(("snapshot-quarantined",
                           _counter_check("storage.snapshot_quarantined",
                                          1, 1)))
            checks.append(("rot-healed",
                           _counter_check("storage.rebuilds", 1)))
        else:
            # a FAILED publish (ENOSPC/EIO) is not corruption: the old
            # pair stays live, nothing to quarantine
            checks.append(("nothing-quarantined",
                           _counter_check("storage.snapshot_quarantined",
                                          0, 0)))
    slos = [
        SLO("work-survives", "tasks_unfinished", "==", 0),
        SLO("no-failures", "tasks_failed", "==", 0),
    ]
    return ScenarioSpec(
        name="disk-grid-%s-%s" % (target, kind),
        description="matrix-generated disk weather: %s at the %s seam "
                    "against a scheduling fleet" % (kind, target),
        ticks=12,
        durable=True,
        events=events,
        slos=slos,
        checks=checks,
    )


def engine_points() -> List[str]:
    return ["%s:%s" % (t, k) for t in ENGINE_TARGETS for k in ENGINE_KINDS]


def verdicts(entry: dict) -> dict:
    """An entry's verdicts: each invariant's, check's and SLO's ``ok``."""
    return {sec: {k: v["ok"] for k, v in entry.get(sec, {}).items()}
            for sec in ("invariants", "checks", "slos")}


def run_engine_point(point: str, device=None) -> dict:
    """One engine point (``target:kind``) through ``ScenarioRun`` on
    ``device``. Every tick must be planned by the device solve: a disk
    fault is the store's, never the solve's. Prints its ``TICKS`` line
    (verdicts, counters, planners, the card's books)."""
    from ..device import resolve_device
    from .engine import ScenarioRun

    target, _, kind = point.partition(":")
    dev = resolve_device(device)
    before = card_counts()
    t0 = time.perf_counter()
    run = ScenarioRun(_engine_spec(target, kind), device=dev)
    entry = run.execute()
    wall = time.perf_counter() - t0
    planners = [r.planner_used for r in run.tick_results]
    books = card_books(before, planners, on_card=dev.type == "cuda")
    problems = [] if entry.get("ok") else [json.dumps(entry, default=str)[:2000]]
    if planners.count("tpu") != len(planners):
        problems.append("ticks not planned by the device solve: %r" % (planners,))
    problems += books["problems"]
    line = {"arm": "engine", "point": point, "device": device_arg(device),
            "verdicts": verdicts(entry), "counters": entry.get("counters", {}),
            "planners": planners, "wall_s": round(wall, 4), **books}
    print("TICKS " + json.dumps(line, default=str), flush=True)
    return {"arm": "engine", "point": point, "ok": not problems,
            "problems": problems, "entry": entry, "ticks": line}


def run_engine_grid(device=None, points: Optional[List[str]] = None) -> List[dict]:
    results = []
    for point in points or engine_points():
        res = run_engine_point(point, device)
        print(json.dumps({k: res[k] for k in ("arm", "point", "ok", "problems")}),
              flush=True)
        results.append(res)
    return results


# --------------------------------------------------------------- cases arm

def upgrade_compat_case() -> dict:
    """A WAL written by a pre-stamping writer (no ``"k"`` field) must
    replay cleanly and completely under a stamping writer: CRC is an
    upgrade, not a flag day."""
    from ..storage import integrity
    from ..storage.durable import DurableStore

    problems: List[str] = []
    data_dir = tempfile.mkdtemp(prefix="diskmx-upgrade-")
    prev = integrity.set_wal_crc_enabled(False)
    old = None
    try:
        old = DurableStore(data_dir)
        for t in range(4):
            _one_tick(old, t, 0)
        old.sync_persist()
        live = canonical(old)
        # no close(): close() checkpoints, which would hide the replay
    finally:
        integrity.set_wal_crc_enabled(prev)

    reopened = DurableStore(data_dir)
    if reopened.replay_report["corrupt_frames"]:
        problems.append(
            "unstamped legacy frames rejected as corrupt: %r"
            % (reopened.replay_report,)
        )
    if reopened.replay_report["frames"] == 0:
        problems.append("no legacy frames were replayed at all")
    if canonical(reopened) != live:
        problems.append("legacy WAL replay lost writes under the "
                        "stamping writer")
    rep = reopened.scrub()
    if rep["wal_corrupt_frames"] or rep["snapshot_corrupt"]:
        problems.append("scrub convicted a healthy legacy log: %r"
                        % (rep,))
    if old is not None:
        old._journal.close()
    reopened._journal.close()
    ok = not problems
    if ok:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {"arm": "cases", "point": "upgrade-compat", "ok": ok,
            "problems": problems, "data_dir": None if ok else data_dir}


def manifest_case() -> dict:
    """Manifest entries go through the shared checksummed atomic
    writer: rot is refused at read, a failed publish leaves the old
    entry live with no stranded temp file."""
    from ..runtime import manifest
    from ..storage import integrity
    from ..utils import faults

    problems: List[str] = []
    data_dir = tempfile.mkdtemp(prefix="diskmx-manifest-")

    def write(pid: int) -> None:
        manifest.write_entry(data_dir, 0, pid=pid, sock="/tmp/s0.sock",
                             generation=1, epoch=3)

    write(4242)
    ent = manifest.read_entry(data_dir, 0)
    if not ent or ent.get("pid") != 4242:
        problems.append("manifest round-trip failed: %r" % (ent,))

    integrity.corrupt_byte(manifest.entry_path(data_dir, 0))
    if manifest.read_entry(data_dir, 0) is not None:
        problems.append("bitrotted manifest entry was adopted")

    write(4343)  # the next publish self-heals the rotted entry
    plan = faults.FaultPlan().at("manifest.write", 0,
                                 faults.Fault("enospc"))
    faults.install(plan)
    try:
        try:
            write(5555)
            problems.append("ENOSPC manifest publish did not surface")
        except OSError:
            pass
    finally:
        faults.uninstall()
    ent = manifest.read_entry(data_dir, 0)
    if not ent or ent.get("pid") != 4343:
        problems.append(
            "old manifest entry lost after failed publish: %r" % (ent,)
        )
    stranded = _stranded_tmp(data_dir)
    # the manifest writer's temp files are ``<entry>.<pid>``
    fleet = manifest.fleet_dir(data_dir)
    extras = [
        n for n in (os.listdir(fleet) if os.path.isdir(fleet) else [])
        if not n.endswith(".json")
    ]
    if stranded or extras:
        problems.append("stranded manifest temp files: %r"
                        % (stranded + extras,))

    # a torn publish (short write) must be refused at read, not adopted
    plan = faults.FaultPlan().at("manifest.write", 0,
                                 faults.Fault("short"))
    faults.install(plan)
    try:
        write(7777)
    finally:
        faults.uninstall()
    if manifest.read_entry(data_dir, 0) is not None:
        problems.append("torn manifest publish was adopted")
    write(8888)
    ent = manifest.read_entry(data_dir, 0)
    if not ent or ent.get("pid") != 8888:
        problems.append("manifest did not recover after torn publish")

    ok = not problems
    if ok:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {"arm": "cases", "point": "manifest", "ok": ok,
            "problems": problems, "data_dir": None if ok else data_dir}


def lease_case() -> dict:
    """A corrupt lease file reads as None (never garbage ownership),
    is NOT stealable while fresh (the holder may still be renewing),
    and IS stealable once aged past TTL: rot cannot deadlock the
    writer role forever."""
    from ..storage import integrity
    from ..storage.lease import FileLease

    problems: List[str] = []
    data_dir = tempfile.mkdtemp(prefix="diskmx-lease-")
    path = os.path.join(data_dir, "writer.lease")
    holder = FileLease(path, ttl_s=10.0)
    if not holder.acquire(timeout_s=5.0):
        problems.append("holder could not acquire a fresh lease")
    holder_epoch = holder.epoch

    integrity.corrupt_byte(path)
    if holder.peek() is not None:
        problems.append("corrupt lease file parsed as a document")

    thief = FileLease(path, ttl_s=1.0)
    if thief.try_acquire():
        problems.append("fresh corrupt lease was stolen before TTL")
    old = time.time() - 60
    os.utime(path, (old, old))
    if not thief.try_acquire():
        problems.append("aged corrupt lease was not stealable")
    elif thief.epoch <= holder_epoch:
        problems.append(
            "steal over a corrupt lease did not advance the epoch "
            "(%d -> %d)" % (holder_epoch, thief.epoch)
        )
    thief.release()

    ok = not problems
    if ok:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {"arm": "cases", "point": "lease", "ok": ok,
            "problems": problems, "data_dir": None if ok else data_dir}


def replica_case() -> dict:
    """A read replica tailing a rotted WAL stops at the end of the
    valid prefix (counted, never applied), keeps serving, and
    read-repairs from the primary's next verified checkpoint."""
    from ..storage import integrity
    from ..storage.durable import WAL_FILE, DurableStore
    from ..storage.replica import ReplicaStore
    from ..utils.log import counters_snapshot

    problems: List[str] = []
    data_dir = tempfile.mkdtemp(prefix="diskmx-replica-")
    before = counters_snapshot()
    primary = DurableStore(data_dir)
    replica = None
    try:
        for t in range(3):
            _one_tick(primary, t, 0)
        primary.sync_persist()
        replica = ReplicaStore(data_dir, poll_interval_s=3600.0,
                               replica_id="diskmx")
        replica.poll()
        if canonical(replica) != canonical(primary):
            problems.append("replica != primary before the fault")

        wal = os.path.join(data_dir, WAL_FILE)
        consumed = os.path.getsize(wal)
        for t in range(3, 5):
            _one_tick(primary, t, 0)
        primary.sync_persist()
        # rot a byte in the region the replica has NOT consumed yet
        integrity.corrupt_byte(wal, consumed + 16)

        replica.poll()
        deltas = _counter_deltas(before)
        if deltas.get("storage.wal_corrupt_frames", 0) < 1:
            problems.append(
                "replica did not count the corrupt frame: %r" % (deltas,)
            )
        # serving continues on the valid prefix
        if canonical(replica)["jobs"] == canonical(primary)["jobs"]:
            problems.append(
                "replica somehow applied past the corrupt frame"
            )

        rep = primary.scrub()
        if not rep["wal_corrupt_frames"]:
            problems.append("primary scrub missed the rot: %r" % (rep,))
        replica.poll()
        deltas = _counter_deltas(before)
        if deltas.get("storage.replica_read_repairs", 0) < 1:
            problems.append(
                "no read-repair was counted after the heal: %r"
                % (deltas,)
            )
        if canonical(replica) != canonical(primary):
            problems.append("replica != primary after read-repair")
        staleness = replica.staleness_ms()
        if not staleness < 60_000:
            problems.append(
                "replica staleness unbounded after repair: %r"
                % (staleness,)
            )
    finally:
        if replica is not None:
            replica.close()
        try:
            primary.close()
        except Exception:  # noqa: BLE001
            pass

    ok = not problems
    if ok:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {"arm": "cases", "point": "replica", "ok": ok,
            "problems": problems, "data_dir": None if ok else data_dir}


CASE_FNS = (upgrade_compat_case, manifest_case, lease_case, replica_case)


def run_cases() -> List[dict]:
    results = []
    for fn in CASE_FNS:
        res = fn()
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


# ---------------------------------------------------------------- fuzz arm

def fuzz_reachable(want: int = 3, max_probe: int = 200,
                   kind: str = "disk_fault") -> list:
    """The first ``want`` (seed, spec) of the fuzzer's campaign seeds
    whose weather draws a ``kind`` event (the net matrix asks for
    ``net_fault``), of ``max_probe`` probed."""
    from . import fuzz as fuzz_mod

    found = []
    for seed in range(fuzz_mod.DEFAULT_CAMPAIGN_SEED,
                      fuzz_mod.DEFAULT_CAMPAIGN_SEED + max_probe):
        spec = fuzz_mod.generate_weather(seed)
        if any(e.kind == kind for e in spec.events):
            found.append((seed, spec))
            if len(found) >= want:
                break
    return found


def run_fuzz_reachability(want: int = 3, max_probe: int = 200,
                          device=None) -> List[dict]:
    """The weather fuzzer must actually draw ``disk_fault`` events (the
    vocabulary is reachable, not dead), and drawn cases must run green
    on ``device``."""
    from ..device import resolve_device
    from . import fuzz as fuzz_mod

    dev = resolve_device(device)
    results = []
    found = fuzz_reachable(want, max_probe)
    if len(found) < want:
        res = {
            "arm": "fuzz", "point": "reachability", "ok": False,
            "problems": [
                "only %d/%d probed weathers drew a disk_fault in %d "
                "seeds" % (len(found), want, max_probe)
            ],
        }
        print(json.dumps(res), flush=True)
        return [res]
    for seed, spec in found:
        before = card_counts()
        entry = fuzz_mod.run_case(spec, device=dev)
        books = card_books(before)
        print("TICKS " + json.dumps({"arm": "fuzz", "point": "w%d" % seed,
                                     "device": device_arg(device), **books}),
              flush=True)
        problems = [] if entry.get("ok") else [json.dumps(entry, default=str)[:2000]]
        res = {
            "arm": "fuzz", "point": "w%d" % seed,
            "ok": not problems and not books["problems"],
            "problems": problems + books["problems"],
        }
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


# -------------------------------------------------------------------- main

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + _MODULE,
        description="storage-integrity disk-fault matrix on the port"
    )
    parser.add_argument("--grid-only", action="store_true")
    parser.add_argument("--engine-only", action="store_true")
    parser.add_argument("--cases-only", action="store_true")
    parser.add_argument("--fuzz-only", action="store_true")
    parser.add_argument(
        "--point", default=None,
        help="run one grid point: config:seam:kind "
             "(e.g. classic:wal.commit:enospc)",
    )
    parser.add_argument("--config", action="append", choices=CONFIGS,
                        help="the grid's configs (default: all three)")
    parser.add_argument("--engine-point", action="append",
                        choices=engine_points(),
                        help="the engine arm's points (default: all eight)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    selected = [args.grid_only, args.engine_only, args.cases_only,
                args.fuzz_only]
    run_all = not any(selected)
    ticking = args.point is None and (run_all or args.engine_only or args.fuzz_only)
    device = args.device
    if ticking:
        if device is None:
            from ..utils.torchenv import ensure_usable_backend

            ensure_usable_backend()  # the card, or a RuntimeError
        start_device(device)

    results: List[dict] = []
    if run_all or args.grid_only or args.point:
        results.extend(run_grid(only_point=args.point,
                                configs=tuple(args.config or CONFIGS)))
    if args.point is None:
        if run_all or args.engine_only:
            results.extend(run_engine_grid(device, args.engine_point))
        if run_all or args.cases_only:
            results.extend(run_cases())
        if run_all or args.fuzz_only:
            results.extend(run_fuzz_reachability(device=device))

    failures = [r for r in results if not r["ok"]]
    inversions = lockcheck_line()
    print(json.dumps({
        "disk_matrix_points": len(results),
        "disk_matrix_failures": len(failures),
        "failed": [r["point"] for r in failures],
    }), flush=True)
    return 1 if failures or inversions else 0


if __name__ == "__main__":
    reexec_with_witness(_MODULE)
    sys.exit(main())
