"""Process-level crash/failover matrix: real kills, real recovery.

A port of the JAX repository's ``tools/crash_matrix.py``. The fault
matrix injects failures INSIDE a live process; this harness proves the
other half of the robustness story: the process itself dying at the
worst possible instruction. A child process runs a deterministic
tick+dispatch workload against a temp data dir behind a ``FileLease``,
its solves on ``--device`` (the CUDA card unless ``cpu``); the parent
arranges its death at env-selected crash points (``utils/faults.py`` seam
names with the ``crash`` kind: ``os._exit(86)``, the SIGKILL shape: no
atexit, no finally, no flushes beyond what already hit the OS), restarts
it, and asserts invariants:

  * resume = rerun: the crashed-and-recovered run converges to the same
    final task/queue state as one uninterrupted run of the same workload;
  * monotone lease epochs: every restart steals at a strictly higher
    fencing epoch;
  * no duplicate dispatch: at most one host claims a task, claims and
    task docs stay coherent;
  * no torn group applied: the recovered store passes structural
    invariants (aligned queue columns, legal statuses);
  * no lock-order inversion: every child runs under the runtime
    lock-order witness (``utils/lockcheck.py``); a surviving child with
    an inversion exits 77, and any inversion a child printed fails its
    point;
  * exact launches per life: after each ``TICK-DONE`` line a child prints
    its kernel counters and its card solves (``LAUNCHES``); each life's
    counters must equal the launches of the card solves it reported.

Plus the two-process failover case: the holder is SIGSTOPped mid-commit
(a ``hang`` fault at the ``wal.fence`` seam widens the window), a standby
steals the lease and runs its own ticks, the holder is SIGCONTed: its
resumed commit must be rejected with ``EpochFencedError`` and ZERO frames
with a superseded epoch may survive past the fence point in the WAL.

On the card a child starts CUDA, loads both kernels and solves once
before it takes its lease (``start_device``), so the renewer's short TTL
never covers them; a kernel or CUDA fault in a child fails its point.

    python -m evergreen_tpu_torch.scenarios.crash_matrix [--device cpu]
        [--point SEAM@I | --failover-only | --sharded-only | --sup-only |
         --solver-only] [--ticks N]

Run as a module, it switches the witness on (``EVERGREEN_TPU_LOCKCHECK``,
kept if set) before any package import, re-executing itself once if the
variable was unset; every child inherits it.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time as _time
from typing import Dict, List, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LOCKCHECK_ENV = "EVERGREEN_TPU_LOCKCHECK"
_MODULE = "evergreen_tpu_torch.scenarios.crash_matrix"

#: deterministic workload clock (same anchor the fault matrix uses)
NOW = 1_700_000_000.0
TICK_S = 15.0
#: enough ticks for the 24-task workload to fully drain (every task
#: succeeded, queues empty): resume = rerun is asserted at CONVERGENCE —
#: a crash mid-dispatch-phase legitimately shifts which tick a task
#: finishes on (the dispatch path is per-op incremental, not
#: group-atomic), but the converged state must be identical
DEFAULT_TICKS = 9
LEASE_TTL_S = 0.75

#: the >=12-point kill matrix: (seam, call-index) pairs covering solve,
#: WAL-append, group-flush (commit + fence), dispatch, recovery-pass and
#: lease-renewal seams. Indices are per-seam call counts inside the child.
KILL_POINTS: List[Tuple[str, int]] = [
    ("recovery.pass", 0),     # dies INSIDE the reconciliation pass
    ("wal.commit", 0),        # the seed frame's flush
    ("wal.commit", 1),        # tick 0's group flush
    ("wal.commit", 3),        # a mid-run group flush
    ("wal.fence", 1),         # just before tick 0's fence check
    ("scheduler.solve", 0),   # first device solve
    ("scheduler.solve", 2),   # a warm solve
    ("wal.append", 0),        # first per-op append (dispatch-phase write)
    ("wal.append", 7),        # a later per-op append
    ("dispatch.assign", 0),   # between the dispatch CAS pair
    ("dispatch.assign", 3),   # a later half-assignment
    ("lease.renew", 0),       # the renewer thread's first beat
    ("lease.renew", 1),       # a later renewal
]

#: distro-handoff kill points (sharded control plane,
#: scheduler/sharded_plane.py): the child runs a 2-shard plane with a
#: deterministic mid-run migration; a SIGKILL at any protocol step must
#: converge to exactly-one-owner with zero duplicate dispatch across
#: shards after restart + reconcile_handoffs.
SHARDED_KILL_POINTS: List[Tuple[str, int]] = [
    ("handoff.release", 0),   # inside the source's release WAL group —
    #                           the group never commits; no handoff at all
    ("handoff.record", 0),    # release durable, target NOT primed —
    #                           reconciliation re-primes from the record
    ("handoff.prime", 0),     # target primed, done-mark missing —
    #                           reconciliation completes it idempotently
]
#: which tick of the sharded child triggers the migration
MIGRATE_TICK = 2

#: child exit codes: the kill point fired, the lease was lost, a commit
#: was fenced, a surviving child saw a lock-order inversion
EXIT_CRASHED, EXIT_LOST, EXIT_FENCED, EXIT_INVERSION = 86, 70, 75, 77


# --------------------------------------------------------------------------- #
# child: the deterministic workload
# --------------------------------------------------------------------------- #


def _seed_problem(store) -> None:
    """Small deterministic problem, seeded idempotently (upserts — a
    crash mid-seed must not make the reseed raise on duplicates) and
    committed as ONE WAL group so the seed is crash-atomic."""
    from ..models import distro as distro_mod
    from ..models import host as host_mod
    from ..models import task as task_mod
    from ..utils.benchgen import generate_problem

    distros, tasks_by_distro, hosts_by_distro, _, _ = generate_problem(
        2, 24, seed=11, hosts_per_distro=3, dep_fraction=0.25
    )
    store.begin_tick()
    try:
        for d in distros:
            distro_mod.coll(store).upsert(d.to_doc())
        for ts in tasks_by_distro.values():
            for t in ts:
                task_mod.coll(store).upsert(t.to_doc())
        for hs in hosts_by_distro.values():
            for h in hs:
                # benchgen stamps phantom running tasks for allocator
                # realism; the harness needs free hosts whose every
                # dispatch is a real CAS pair
                h.running_task = ""
                h.running_task_group = ""
                h.running_task_build_variant = ""
                h.running_task_version = ""
                h.running_task_project = ""
                host_mod.coll(store).upsert(h.to_doc())
        store.collection("harness").upsert({"_id": "progress", "ticks": 0})
    finally:
        store.end_tick()


def _agent_sim(store, now: float) -> None:
    """One deterministic agent step: finish everything in flight (tasks
    run exactly one tick), then dispatch every free host from the queues
    the tick just persisted — the real CAS pair, including its crash
    seam."""
    from ..dispatch.assign import assign_next_available_task
    from ..dispatch.dag_dispatcher import DispatcherService
    from ..globals import TaskStatus
    from ..models import host as host_mod
    from ..models import task as task_mod
    from ..models.lifecycle import mark_end, mark_task_started

    c = task_mod.coll(store)
    in_flight = sorted(
        d["_id"] for d in c.find(
            lambda d: d["status"]
            in (TaskStatus.DISPATCHED.value, TaskStatus.STARTED.value)
        )
    )
    for tid in in_flight:
        mark_task_started(store, tid, now=now)
        mark_end(store, tid, TaskStatus.SUCCEEDED.value, now=now)
    svc = DispatcherService(store)  # fresh per step: no TTL staleness
    hosts = sorted(
        (h for h in host_mod.find(store) if h.can_run_tasks()
         and not h.running_task),
        key=lambda h: h.id,
    )
    for h in hosts:
        assign_next_available_task(store, svc, h, now=now)


def start_device(device):
    """The child's device. On the card: both kernels built and loaded and
    one solve of a small problem (CUDA starts with it), all before the
    child takes its lease (the renewer's TTL must not cover them); the
    counters then restart at 0, so a life's ``LAUNCHES`` lines count its
    ticks' solves alone."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import distro_stats, segment
        from ..ops.solve import CARD_SOLVES, run_solve_packed
        from ..scheduler.snapshot import build_snapshot
        from ..utils.benchgen import generate_problem

        distro_stats._launch_fn()
        segment._launch_fn()
        run_solve_packed(build_snapshot(*generate_problem(
            2, 24, seed=11, hosts_per_distro=3, dep_fraction=0.25), NOW), device=dev)
        distro_stats.fused_distro_stats.launches = 0
        segment.segment_sum.launches = 0
        segment.segment_sum.launches_by_plan.clear()
        CARD_SOLVES.update(solves=0, capacity_iters=0)
    return dev


def _print_launches(tick: int, device_ticks: int) -> None:
    """The ``LAUNCHES`` line after tick ``tick``'s ``TICK-DONE``: this
    life's kernel counters and card solves so far, and its ticks (shard
    ticks on the sharded plane) planned by the device solve."""
    from ..ops.distro_stats import fused_distro_stats
    from ..ops.segment import segment_sum
    from ..ops.solve import CARD_SOLVES

    print("LAUNCHES " + json.dumps({
        "tick": tick,
        "device_ticks": device_ticks,
        "launches": {"fused_distro_stats": fused_distro_stats.launches,
                     "segment_sum": segment_sum.launches,
                     **{f"segment_sum[{p}]": n
                        for p, n in sorted(segment_sum.launches_by_plan.items())}},
        "card_solves": dict(CARD_SOLVES),
    }), flush=True)


def _exit_clean() -> None:
    """A surviving child audits the lock-order witness before reporting
    success: an inversion on any of its threads is a failure even though
    the workload converged."""
    from ..utils import lockcheck

    if lockcheck.violations():
        print("LOCK-INVERSION", flush=True)
        os._exit(EXIT_INVERSION)
    os._exit(0)


def child_main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", required=True)
    p.add_argument("--ticks", type=int, default=DEFAULT_TICKS)
    p.add_argument("--crash", default="", help="seam@index kill point")
    p.add_argument("--stall", type=float, default=0.0,
                   help="hang this long at the wal.fence seam each tick")
    p.add_argument("--ttl", type=float, default=LEASE_TTL_S)
    p.add_argument("--hold", action="store_true",
                   help="after the ticks, keep the lease until stdin EOF")
    p.add_argument("--sharded", type=int, default=0,
                   help="run the N-shard control-plane workload instead")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    from ..utils import faults

    plan = faults.FaultPlan()
    if args.crash:
        seam, _, idx = args.crash.partition("@")
        plan.at(seam.strip(), int(idx or 0), faults.Fault("crash"))
    if args.stall > 0:
        plan.always("wal.fence", faults.Fault("hang", delay_s=args.stall))
    if args.crash or args.stall > 0:
        faults.install(plan)

    t0 = _time.perf_counter()
    dev = start_device(args.device)
    boot = {"device_ms": (_time.perf_counter() - t0) * 1e3}
    if args.sharded > 0:
        return sharded_child_main(args, dev, boot)

    from ..scheduler.recovery import run_recovery_pass
    from ..scheduler.wrapper import TickOptions, run_tick
    from ..storage.durable import DurableStore
    from ..storage.lease import EpochFencedError, FileLease

    lease = FileLease(
        os.path.join(args.data_dir, "writer.lease"), ttl_s=args.ttl
    )
    t0 = _time.perf_counter()
    if not lease.acquire(timeout_s=30.0, poll_s=0.1):
        print("LEASE-TIMEOUT", flush=True)
        return 3
    boot["lease_ms"] = (_time.perf_counter() - t0) * 1e3
    t0 = _time.perf_counter()
    store = DurableStore(args.data_dir, lease=lease)
    lease.start_renewing(on_lost=lambda: None)  # loss observed via .lost
    boot["open_ms"] = (_time.perf_counter() - t0) * 1e3

    prog = store.collection("harness").get("progress")
    done = prog["ticks"] if prog else 0
    t0 = _time.perf_counter()
    report = run_recovery_pass(store, now=NOW + done * TICK_S)
    boot["recovery_ms"] = (_time.perf_counter() - t0) * 1e3
    print("EPOCH " + str(lease.epoch), flush=True)
    print("RECOVERY " + json.dumps(report.to_doc()), flush=True)
    print("BOOT " + json.dumps(boot), flush=True)

    if prog is None:
        _seed_problem(store)

    opts = TickOptions(
        create_intent_hosts=False,  # intent ids are uuids: keeping the
        # tick idempotent keeps resume = rerun byte-comparable
        underwater_unschedule=False,
        use_cache=False,
    )
    # a kill point at the renewer's seam: the ticks wait one beat each,
    # so the beat lands mid-run (JAX's child reaches its later beats
    # because its first tick compiles for seconds; these take
    # milliseconds)
    pace_s = args.ttl / 3.0 if args.crash.startswith("lease.renew") else 0.0
    device_ticks = 0
    try:
        for i in range(done, args.ticks):
            _time.sleep(pace_s)
            now = NOW + (i + 1) * TICK_S
            res = run_tick(store, opts, now=now, device=dev)
            device_ticks += res.planner_used == "tpu"
            if res.degraded == "fenced":
                print("FENCED", flush=True)
                os._exit(EXIT_FENCED)
            if lease.lost:
                print("LOST", flush=True)
                os._exit(EXIT_LOST)
            _agent_sim(store, now)
            store.collection("harness").upsert(
                {"_id": "progress", "ticks": i + 1}
            )
            print(f"TICK-DONE {i}", flush=True)
            _print_launches(i, device_ticks)
        store.sync_persist()
    except EpochFencedError:
        # any fenced write rejection (dispatch/progress per-op appends
        # included) stands the stale holder down
        print("FENCED", flush=True)
        os._exit(EXIT_FENCED)
    print("DONE", flush=True)
    if args.hold:
        print("HOLDING", flush=True)
        sys.stdin.readline()  # parent signals; lease stays held meanwhile
    lease.release()
    # no store.close(): the WAL must keep its frames for the parent's
    # epoch scan (everything is already flushed; close() would compact)
    _exit_clean()
    return 0


def sharded_child_main(args, dev, boot) -> int:
    """The 2-shard control-plane workload: per-shard DurableStores (own
    lease + WAL segment in ONE data dir), per-shard recovery + handoff
    reconciliation at startup, deterministic ticks with a forced
    migration of ``d000`` at MIGRATE_TICK, and a global agent pull
    dispatching every shard's hosts each step."""
    from ..models.host import Host
    from ..scheduler.recovery import run_recovery_pass
    from ..scheduler.sharded_plane import ShardedScheduler
    from ..scheduler.wrapper import TickOptions
    from ..storage.store import Store

    n = args.sharded
    t0 = _time.perf_counter()
    plane = ShardedScheduler.build(
        n, data_dir=args.data_dir, lease_ttl_s=args.ttl,
        rebalance_enabled=False, stacked="never", device=dev,
        tick_opts=TickOptions(
            create_intent_hosts=False, underwater_unschedule=False,
            use_cache=False,
        ),
    )
    boot["open_ms"] = (_time.perf_counter() - t0) * 1e3
    for k, s in enumerate(plane.stores):
        s._lease.start_renewing(on_lost=lambda: None)
        print(f"EPOCH{k} {s._lease.epoch}", flush=True)
    print("BOOT " + json.dumps(boot), flush=True)

    prog = plane.stores[0].collection("harness").get("progress")
    done = prog["ticks"] if prog else 0
    for k, s in enumerate(plane.stores):
        report = run_recovery_pass(s, now=NOW + done * TICK_S)
        print(f"RECOVERY{k} " + json.dumps(report.to_doc()), flush=True)
    healed = plane.reconcile_handoffs(now=NOW + done * TICK_S)
    print("RECONCILED " + json.dumps(healed), flush=True)

    if prog is None:
        tmp = Store()
        _seed_problem(tmp)  # includes the progress doc
        tmp.collection("harness").remove("progress")
        plane.seed_partition(tmp)
        plane.stores[0].collection("harness").upsert(
            {"_id": "progress", "ticks": 0}
        )

    # the deterministic migration: d000 moves AWAY from its hash owner
    # (idempotent across restarts — a completed or reconciled handoff
    # already flipped the override, so the re-run skips it)
    mig_src = plane.topology.hash_shard_for("d000")
    mig_dst = (mig_src + 1) % n

    def agent_sim(now: float) -> None:
        from ..globals import TaskStatus
        from ..models import task as task_mod
        from ..models.lifecycle import mark_end, mark_task_started

        for store in plane.stores:
            c = task_mod.coll(store)
            for tid in sorted(
                d["_id"] for d in c.find(
                    lambda d: d["status"] in (
                        TaskStatus.DISPATCHED.value,
                        TaskStatus.STARTED.value,
                    )
                )
            ):
                mark_task_started(store, tid, now=now)
                mark_end(store, tid, TaskStatus.SUCCEEDED.value, now=now)
        plane._dispatchers.clear()  # fresh per step: no TTL staleness
        hosts = sorted(
            (
                Host.from_doc(doc)
                for store in plane.stores
                for doc in store.collection("hosts").find()
            ),
            key=lambda h: h.id,
        )
        for h in hosts:
            if h.can_run_tasks() and not h.running_task:
                plane.assign_next_task(h, now=now)

    from ..storage.lease import EpochFencedError

    device_ticks = 0
    try:
        for i in range(done, args.ticks):
            now = NOW + (i + 1) * TICK_S
            if i == MIGRATE_TICK and plane.owner_of("d000") != mig_dst:
                rec = plane.migrate("d000", mig_dst, now=now)
                print("MIGRATED " + json.dumps(rec["group"]), flush=True)
            res = plane.tick(now=now)
            if any(r.degraded == "fenced" for r in res.results.values()):
                print("FENCED", flush=True)
                os._exit(EXIT_FENCED)
            device_ticks += sum(r.planner_used == "tpu" for r in res.results.values())
            agent_sim(now)
            plane.stores[0].collection("harness").upsert(
                {"_id": "progress", "ticks": i + 1}
            )
            print(f"TICK-DONE {i}", flush=True)
            _print_launches(i, device_ticks)
        for s in plane.stores:
            s.sync_persist()
    except EpochFencedError:
        print("FENCED", flush=True)
        os._exit(EXIT_FENCED)
    print("DONE", flush=True)
    for s in plane.stores:
        s._lease.release()
    # no close(): the WAL segments must keep their frames for inspection
    _exit_clean()
    return 0


# --------------------------------------------------------------------------- #
# parent: orchestration + invariants
# --------------------------------------------------------------------------- #


def _device_arg(device) -> str:
    """``--device``'s value for a child (None: the card)."""
    return "cuda" if device is None else str(device)


def _child_cmd(data_dir: str, ticks: int, crash: str = "",
               stall: float = 0.0, hold: bool = False,
               sharded: int = 0, device=None) -> List[str]:
    cmd = [
        sys.executable, "-m", _MODULE, "--child",
        "--data-dir", data_dir, "--ticks", str(ticks),
        "--device", _device_arg(device),
    ]
    if crash:
        cmd += ["--crash", crash]
    if stall > 0:
        cmd += ["--stall", str(stall)]
    if hold:
        cmd += ["--hold"]
    if sharded:
        cmd += ["--sharded", str(sharded)]
    return cmd


def _child_env() -> dict:
    """The parent's environment, no ``EVG_FAULTS`` plan, and the
    witness on (the parent's setting, ``1`` if it has none)."""
    return {
        **os.environ,
        "EVG_FAULTS": "",
        _LOCKCHECK_ENV: os.environ.get(_LOCKCHECK_ENV) or "1",
    }


def _run_child(data_dir: str, ticks: int, crash: str = "", device=None,
               sharded: int = 0, timeout_s: float = 240.0) -> Tuple[int, str]:
    t0 = _time.perf_counter()
    proc = subprocess.run(
        _child_cmd(data_dir, ticks, crash=crash, sharded=sharded, device=device),
        env=_child_env(), cwd=_REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=timeout_s,
    )
    # the child's wall, for the harness's callers (``WALL`` is never a
    # child's own line)
    wall = "WALL %.3f\n" % (_time.perf_counter() - t0)
    return proc.returncode, proc.stdout.decode(errors="replace") + wall


def wal_frame_epochs(data_dir: str) -> List[int]:
    """The ``e`` stamp of every parseable group frame, in file order."""
    out: List[int] = []
    path = os.path.join(data_dir, "wal.log")
    if not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            if not line.endswith("\n"):
                break
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("o") == "g":
                out.append(int(rec.get("e", 0) or 0))
    return out


def check_invariants(store) -> List[str]:
    """Structural invariants every recovered store must satisfy."""
    from ..globals import TaskStatus

    problems: List[str] = []
    legal = {s.value for s in TaskStatus}
    claims: Dict[str, str] = {}
    for doc in store.collection("hosts").find():
        rt = doc.get("running_task", "")
        if not rt:
            continue
        if rt in claims.values():
            problems.append(f"duplicate claim of task {rt}")
        claims[doc["_id"]] = rt
    for doc in store.collection("tasks").find():
        if doc["status"] not in legal:
            problems.append(f"illegal status {doc['status']} on {doc['_id']}")
        if doc.get("execution", 0) < 0:
            problems.append(f"negative execution on {doc['_id']}")
        if doc["status"] in ("dispatched", "started"):
            hid = doc.get("host_id", "")
            hdoc = store.collection("hosts").get(hid)
            if hdoc is None or hdoc.get("running_task") != doc["_id"]:
                problems.append(
                    f"in-flight task {doc['_id']} not claimed by host {hid!r}"
                )
    for hid, rt in claims.items():
        tdoc = store.collection("tasks").get(rt)
        if tdoc is None or tdoc["status"] not in ("dispatched", "started"):
            problems.append(
                f"host {hid} claims task {rt} that is not in flight"
            )
    for coll_name in ("task_queues", "task_secondary_queues"):
        for doc in store.collection(coll_name).find():
            n = len(doc.get("rows", []))
            for col in ("sort_value", "dependencies_met"):
                if len(doc.get(col, [])) != n:
                    problems.append(
                        f"misaligned {col} in {coll_name}/{doc['_id']}"
                    )
    # duplicate dispatch: two TASK_DISPATCHED events for the same task at
    # the same tick timestamp would mean two hosts won the same CAS
    seen: Dict[tuple, int] = {}
    for doc in store.collection("events").find(
        lambda d: d.get("event_type") == "TASK_DISPATCHED"
    ):
        key = (doc.get("resource_id"), doc.get("timestamp"))
        seen[key] = seen.get(key, 0) + 1
        if seen[key] > 1:
            problems.append(f"duplicate dispatch event {key}")
    return problems


def canonical_state(store) -> dict:
    """The resume = rerun comparison surface: converged task state +
    queue contents (doc versions/timestamps excluded — reruns bump them;
    content must not differ)."""
    from ..models.task_queue import doc_column

    tasks = {
        d["_id"]: [d["status"], d.get("execution", 0)]
        for d in store.collection("tasks").find()
    }
    queues = {
        d["_id"]: doc_column(d, "id")
        for d in store.collection("task_queues").find()
    }
    return {"tasks": tasks, "queues": queues}


def _open_for_inspection(data_dir: str):
    from ..storage.durable import DurableStore

    return DurableStore(data_dir)


def expected_launches(solves: int, capacity_iters: int) -> dict:
    """The kernel launches of ``solves`` card solves whose capacity trip
    counts sum to ``capacity_iters``: one ``fused_distro_stats`` each;
    ``segment_sum`` once on the task plan, once on the host plan, and on
    the pool plan three times plus once per trip."""
    return {"fused_distro_stats": solves,
            "segment_sum": 5 * solves + capacity_iters,
            "segment_sum[task]": solves,
            "segment_sum[host]": solves,
            "segment_sum[pool]": 3 * solves + capacity_iters}


def life_launches(out: str) -> dict:
    """One child's life from its output: its boot split, the ticks it
    reported, its last ``LAUNCHES`` line's counters, card solves and
    device-planned ticks, the lock-order inversions it printed, and the
    problems of holding every ``LAUNCHES`` line to ``expected_launches``
    of its card solves."""
    ticks, last, problems, boot, wall = [], None, [], None, None
    for line in out.splitlines():
        if line.startswith("BOOT "):
            boot = json.loads(line[len("BOOT "):])
        elif line.startswith("WALL "):
            wall = float(line.split()[1])
        elif line.startswith("TICK-DONE "):
            ticks.append(int(line.split()[1]))
        elif line.startswith("LAUNCHES "):
            last = json.loads(line[len("LAUNCHES "):])
            cs = last["card_solves"]
            want = expected_launches(cs["solves"], cs["capacity_iters"])
            got = {k: v for k, v in last["launches"].items() if v}
            if got != {k: v for k, v in want.items() if v}:
                problems.append(f"tick {last['tick']}: launches {got}, "
                                f"expected {want} for card solves {cs}")
    inversions = sum(
        line.startswith("lockcheck: ORDER INVERSION") or line == "LOCK-INVERSION"
        for line in out.splitlines())
    return {"ticks": ticks, "boot": boot, "wall_s": wall,
            "device_ticks": last["device_ticks"] if last else 0,
            "launches": last["launches"] if last else {},
            "card_solves": last["card_solves"] if last else {"solves": 0, "capacity_iters": 0},
            "inversions": inversions, "problems": problems}


def _lives_problems(lives: List[dict]) -> List[str]:
    problems = []
    for i, life in enumerate(lives):
        problems += [f"life {i}: {p}" for p in life["problems"]]
        if life["inversions"]:
            problems.append(f"life {i}: {life['inversions']} lock-order inversion lines")
    return problems


def run_point(seam: str, index: int, ticks: int = DEFAULT_TICKS,
              reference: Optional[dict] = None, device=None) -> dict:
    """One kill point: run-with-crash, restart clean, check everything."""
    data_dir = tempfile.mkdtemp(prefix=f"crash-{seam.replace('.', '-')}-")
    crash = f"{seam}@{index}"
    rc1, out1 = _run_child(data_dir, ticks, crash=crash, device=device)
    crashed = rc1 == EXIT_CRASHED
    rc2, out2 = _run_child(data_dir, ticks, device=device)
    epochs = [
        int(line.split()[1])
        for line in (out1 + out2).splitlines()
        if line.startswith("EPOCH ")
    ]
    lives = [life_launches(out1), life_launches(out2)]
    store = _open_for_inspection(data_dir)
    problems = check_invariants(store)
    prog = store.collection("harness").get("progress")
    if not prog or prog["ticks"] != ticks:
        problems.append(f"workload did not converge: progress={prog}")
    if not crashed and rc1 != 0:
        problems.append(f"first run died unexpectedly: rc={rc1}")
    if rc2 != 0:
        problems.append(f"recovery run failed: rc={rc2}")
    if epochs != sorted(set(epochs)):
        problems.append(f"epochs not strictly increasing: {epochs}")
    problems += _lives_problems(lives)
    parity_ok = True
    if reference is not None:
        parity_ok = canonical_state(store) == reference
        if not parity_ok:
            problems.append("resume != rerun")
    return {
        "point": crash,
        "ok": crashed and not problems,
        "crashed": crashed,
        "rc": (rc1, rc2),
        "epochs": epochs,
        "parity_ok": parity_ok,
        "problems": problems,
        "lives": lives,
        "data_dir": data_dir,
        "out": (out1 + out2) if problems else "",
    }


def reference_state(ticks: int = DEFAULT_TICKS, device=None) -> dict:
    """One uninterrupted run of the same workload — the rerun side of
    resume = rerun."""
    data_dir = tempfile.mkdtemp(prefix="crash-reference-")
    rc, out = _run_child(data_dir, ticks, device=device)
    if rc != 0:
        raise RuntimeError(f"reference run failed rc={rc}:\n{out}")
    state = canonical_state(_open_for_inspection(data_dir))
    undrained = [
        tid for tid, (status, _) in state["tasks"].items()
        if status != "success"
    ]
    if undrained:
        raise RuntimeError(
            f"reference workload did not drain in {ticks} ticks "
            f"({len(undrained)} unfinished: {undrained[:5]}) — parity at "
            "convergence needs every task finished; raise ticks"
        )
    return state


def _open_fleet_for_inspection(data_dir: str, n: int) -> list:
    from ..storage.durable import DurableStore

    return [DurableStore(data_dir, shard_id=k) for k in range(n)]


def run_sharded_point(seam: str, index: int, ticks: int = DEFAULT_TICKS,
                      n: int = 2, reference: Optional[dict] = None,
                      device=None) -> dict:
    """One distro-handoff kill point on the 2-shard plane: crash at the
    protocol seam, restart (per-shard WAL replay + recovery +
    reconcile_handoffs), then assert exactly-one-owner, no duplicate
    dispatch across shards, monotone per-shard epochs, and resume =
    rerun at convergence against an uninterrupted sharded run."""
    from ..scheduler.sharded_plane import (
        fleet_owner_violations,
        merge_fleet_state,
    )

    data_dir = tempfile.mkdtemp(
        prefix=f"crash-{seam.replace('.', '-')}-"
    )
    crash = f"{seam}@{index}"
    rc1, out1 = _run_child(data_dir, ticks, crash=crash, sharded=n, device=device)
    crashed = rc1 == EXIT_CRASHED
    rc2, out2 = _run_child(data_dir, ticks, sharded=n, device=device)
    out = out1 + out2
    lives = [life_launches(out1), life_launches(out2)]
    problems: List[str] = []
    stores = _open_fleet_for_inspection(data_dir, n)
    problems.extend(fleet_owner_violations(stores))
    parity_ok = True
    try:
        merged = merge_fleet_state(stores)
    except ValueError as exc:
        problems.append(str(exc))
        merged = None
    if merged is not None:
        problems.extend(check_invariants(merged))
        prog = stores[0].collection("harness").get("progress")
        if not prog or prog["ticks"] != ticks:
            problems.append(f"workload did not converge: progress={prog}")
        if reference is not None:
            parity_ok = canonical_state(merged) == reference
            if not parity_ok:
                problems.append("resume != rerun")
    # the migration must actually have happened (a kill point that
    # silently skips the handoff proves nothing)
    migrated = any(
        line.startswith("MIGRATED") for line in out.splitlines()
    )
    if not migrated and seam != "handoff.release":
        # release-crash reruns may reconcile instead of re-migrating;
        # every other point re-prints MIGRATED on the run that did it
        migrated = any(
            s.collection("shard_handoffs").count() > 0 for s in stores
        )
    if not migrated:
        problems.append("no migration was attempted")
    # monotone epochs per shard
    epochs: Dict[int, List[int]] = {k: [] for k in range(n)}
    for line in out.splitlines():
        for k in range(n):
            if line.startswith(f"EPOCH{k} "):
                epochs[k].append(int(line.split()[1]))
    for k, es in epochs.items():
        if es != sorted(set(es)):
            problems.append(f"shard {k} epochs not increasing: {es}")
    if not crashed and rc1 != 0:
        problems.append(f"first run died unexpectedly: rc={rc1}")
    if rc2 != 0:
        problems.append(f"recovery run failed: rc={rc2}")
    problems += _lives_problems(lives)
    return {
        "point": f"sharded:{crash}",
        "ok": crashed and not problems,
        "crashed": crashed,
        "rc": (rc1, rc2),
        "epochs": epochs,
        "parity_ok": parity_ok,
        "problems": problems,
        "lives": lives,
        "data_dir": data_dir,
        "out": out if problems else "",
    }


def sharded_reference_state(ticks: int = DEFAULT_TICKS, n: int = 2,
                            device=None) -> dict:
    """One uninterrupted 2-shard run with the same forced migration —
    the rerun side of the sharded resume = rerun."""
    from ..scheduler.sharded_plane import merge_fleet_state

    data_dir = tempfile.mkdtemp(prefix="crash-sharded-reference-")
    rc, out = _run_child(data_dir, ticks, sharded=n, device=device)
    if rc != 0:
        raise RuntimeError(f"sharded reference failed rc={rc}:\n{out}")
    if "MIGRATED" not in out:
        raise RuntimeError("sharded reference never migrated d000")
    merged = merge_fleet_state(_open_fleet_for_inspection(data_dir, n))
    state = canonical_state(merged)
    undrained = [
        tid for tid, (status, _) in state["tasks"].items()
        if status != "success"
    ]
    if undrained:
        raise RuntimeError(
            f"sharded reference did not drain in {ticks} ticks "
            f"({len(undrained)} unfinished)"
        )
    return state


_POINT_KEYS = ("point", "ok", "crashed", "rc", "epochs", "parity_ok", "problems")


def run_sharded_points(ticks: int = DEFAULT_TICKS, device=None) -> int:
    """The distro-handoff kill points against one shared sharded
    reference; prints one JSON line per point, returns the failure
    count (shared by the full matrix and ``--sharded-only``)."""
    ref = sharded_reference_state(ticks, device=device)
    failures = 0
    for seam, idx in SHARDED_KILL_POINTS:
        out = run_sharded_point(seam, idx, ticks=ticks, reference=ref, device=device)
        print(json.dumps({k: out[k] for k in _POINT_KEYS}))
        if not out["ok"]:
            failures += 1
            sys.stderr.write(out["out"] + "\n")
    return failures


def run_sup_points(device=None) -> int:
    """The SUPERVISOR-crash points through the proc backend: SIGKILL
    mid-round fan-out and between the handoff release->prime legs on a
    supervised 2-shard fleet. Each must end in live ADOPTION — zero
    shard-lease epoch bumps, zero recovery passes, exactly-one-owner,
    resume = rerun (the sup_kill weathers)."""
    from .procs import PROC_SCENARIOS, SUP_KILL_SCENARIOS, run_proc_scenario

    failures = 0
    for name in SUP_KILL_SCENARIOS:
        entry = run_proc_scenario(PROC_SCENARIOS[name](), device=device)
        stats = entry.get("stats", {})
        print(json.dumps({
            "point": name,
            "ok": entry["ok"],
            "adoptions": stats.get("adoptions_total", 0),
            "epoch_bumps": stats.get("adoption_epoch_bumps", 0),
            "reconciled": stats.get("reconciled_handoffs", 0),
            "restarts": stats.get("restarts_total", 0),
        }))
        if not entry["ok"]:
            failures += 1
            sys.stderr.write(json.dumps(entry, default=str) + "\n")
    return failures


def run_solver_points(device=None) -> int:
    """The solver-LEADER death points through the proc backend: the
    supervisor (= elected solver leader) dies at each solver seam —
    after collecting publications, after the stacked solve, after
    writing the FIRST shard's result, and at round start — plus a hang
    past the worker timeout. Every shard must degrade to a local solve
    that round (fenced at the shm header, never a torn fleet solve), the
    successor must re-elect the solver lease at a strictly higher epoch,
    stacked rounds must resume, and zero stale results / zero leaked shm
    segments are tolerated."""
    from .procs import PROC_SCENARIOS, SOLVER_SCENARIOS, run_proc_scenario

    failures = 0
    for name in SOLVER_SCENARIOS:
        entry = run_proc_scenario(PROC_SCENARIOS[name](), device=device)
        stats = entry.get("stats", {})
        print(json.dumps({
            "point": name,
            "ok": entry["ok"],
            "stacked": stats.get("solver_stacked_replies", 0),
            "local": stats.get("solver_local_replies", 0),
            "reelections": stats.get("solver_reelections", 0),
            "stale_accepted": stats.get("solver_stale_accepted", 0),
            "shm_leaked": stats.get("shm_leaked", 0),
        }))
        if not entry["ok"]:
            failures += 1
            sys.stderr.write(json.dumps(entry, default=str) + "\n")
    return failures


def failover_case(ticks: int = 4, stall_s: float = 2.0, device=None) -> dict:
    """Two-process failover: holder SIGSTOPped mid-commit, standby steals
    and runs, holder SIGCONTed: its resumed commit is fenced; the WAL
    carries zero superseded-epoch frames past the fence point."""
    data_dir = tempfile.mkdtemp(prefix="crash-failover-")
    problems: List[str] = []
    holder = subprocess.Popen(
        _child_cmd(data_dir, 999, stall=stall_s, device=device),
        env=_child_env(), cwd=_REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    holder_out: List[str] = []
    procs = [holder]
    try:
        # wait until the holder has completed a tick, then freeze it —
        # with the wal.fence stall dominating each tick, the stop lands
        # inside the begin_tick->flush window with high probability
        deadline = _time.time() + 120
        while _time.time() < deadline:
            line = holder.stdout.readline().decode(errors="replace")
            if not line:
                break
            holder_out.append(line)
            if line.startswith("TICK-DONE 0"):
                break
        else:
            problems.append("holder never finished tick 0")
        _time.sleep(stall_s / 2)  # land inside tick 1's fence stall
        os.kill(holder.pid, signal.SIGSTOP)

        # standby steals after the ttl and runs its own ticks, then HOLDS
        # the lease so the resumed holder fences against a live newer
        # epoch (not a missing file)
        standby = subprocess.Popen(
            _child_cmd(data_dir, ticks, hold=True, device=device),
            env=_child_env(), cwd=_REPO_ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        procs.append(standby)
        standby_out: List[str] = []
        deadline = _time.time() + 240
        while _time.time() < deadline:
            line = standby.stdout.readline().decode(errors="replace")
            if not line:
                break
            standby_out.append(line)
            if line.startswith("HOLDING"):
                break
        else:
            problems.append("standby never reached HOLDING")

        # resume the stale holder: its in-flight commit must fence
        os.kill(holder.pid, signal.SIGCONT)
        try:
            holder.wait(timeout=60)
        except subprocess.TimeoutExpired:
            holder.kill()
            problems.append("resumed holder did not stand down")
        holder_out.append(
            holder.stdout.read().decode(errors="replace")
        )
        if holder.returncode not in (EXIT_LOST, EXIT_FENCED):
            problems.append(
                f"holder exit {holder.returncode}, want 70 (lost) or 75 "
                "(EpochFencedError at commit)"
            )

        standby.stdin.close()  # let the standby release and exit
        try:
            standby.wait(timeout=30)
        except subprocess.TimeoutExpired:
            standby.kill()
            problems.append("standby did not exit after release")
        standby_out.append(standby.stdout.read().decode(errors="replace"))
        if standby.returncode != 0:
            problems.append(f"standby exit {standby.returncode}, want 0")
        standby_text = "".join(standby_out)
        holder_text = "".join(holder_out)

        holder_epoch = standby_epoch = 0
        for line in holder_text.splitlines():
            if line.startswith("EPOCH "):
                holder_epoch = int(line.split()[1])
        for line in standby_text.splitlines():
            if line.startswith("EPOCH "):
                standby_epoch = int(line.split()[1])
        if standby_epoch <= holder_epoch:
            problems.append(
                f"standby epoch {standby_epoch} !> holder {holder_epoch}"
            )

        # the acceptance grep: zero frames with a superseded epoch after
        # the fence point
        epochs = wal_frame_epochs(data_dir)
        fence_at = next(
            (i for i, e in enumerate(epochs) if e >= standby_epoch), None
        )
        stale_after_fence = (
            [] if fence_at is None
            else [e for e in epochs[fence_at:] if 0 < e < standby_epoch]
        )
        if standby_epoch and fence_at is None:
            problems.append("standby committed no frames")
        if stale_after_fence:
            problems.append(
                f"stale-epoch frames past the fence: {stale_after_fence}"
            )
        lives = [life_launches(holder_text), life_launches(standby_text)]
        problems += _lives_problems(lives)

        store = _open_for_inspection(data_dir)
        problems.extend(check_invariants(store))
        return {
            "ok": not problems,
            "problems": problems,
            "holder_exit": holder.returncode,
            "holder_epoch": holder_epoch,
            "standby_epoch": standby_epoch,
            "frame_epochs": epochs,
            "stale_after_fence": stale_after_fence,
            "fenced_at_commit": "FENCED" in holder_text,
            "lives": lives,
            "data_dir": data_dir,
            "holder_out": holder_text if problems else "",
            "standby_out": standby_text if problems else "",
        }
    finally:
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.kill(proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                proc.kill()
                proc.wait()


def run_matrix(points: Optional[List[Tuple[str, int]]] = None,
               ticks: int = DEFAULT_TICKS, device=None) -> int:
    """The full matrix. The 13 process-SIGKILL points run THROUGH the
    scenario engine's child-process backend (``procs.run_crash_point``:
    a 1-shard supervised fleet whose worker dies at the seam and is
    restarted fenced by the supervisor); ``run_point`` above is the
    bespoke single-point harness for ``--point`` and the tier-1 sample
    (tests/test_torch_crash_recovery.py); the failover and
    distro-handoff cases stay bespoke (two live processes / a live
    2-shard plane)."""
    from .procs import SOLVER_SCENARIOS, SUP_KILL_SCENARIOS, proc_reference_state, run_crash_point

    points = points if points is not None else KILL_POINTS
    reference = proc_reference_state(ticks, device=device)
    failures = 0
    for seam, idx in points:
        out = run_crash_point(seam, idx, ticks=ticks, reference=reference,
                              device=device)
        print(json.dumps({k: out[k] for k in _POINT_KEYS}))
        if not out["ok"]:
            failures += 1
            sys.stderr.write(
                json.dumps(out.get("entry", {}), default=str) + "\n"
            )
    fo = failover_case(device=device)
    print(json.dumps({
        k: fo[k]
        for k in ("ok", "problems", "holder_exit", "holder_epoch",
                  "standby_epoch", "frame_epochs", "fenced_at_commit")
    }))
    if not fo["ok"]:
        failures += 1
        sys.stderr.write(fo["holder_out"] + "\n" + fo["standby_out"] + "\n")
    # distro-handoff kill points on the 2-shard plane
    failures += run_sharded_points(ticks, device=device)
    # supervisor-crash points: mid-round + mid-handoff SIGKILL of the
    # SUPERVISOR itself, resolved by orphan mode + live adoption
    failures += run_sup_points(device=device)
    # solver-leader death points: the leader dies (or stalls) at each
    # solver seam, resolved by degrade-to-local + re-election
    failures += run_solver_points(device=device)
    print(json.dumps({
        "crash_matrix_failures": failures,
        "points": len(points) + 1 + len(SHARDED_KILL_POINTS)
        + len(SUP_KILL_SCENARIOS) + len(SOLVER_SCENARIOS),
    }))
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--child" in argv:
        return child_main([a for a in argv if a != "--child"])
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m " + _MODULE,
        description="The process crash/failover matrix on the port.")
    p.add_argument("--point", default="",
                   help="run one kill point only (seam@index)")
    p.add_argument("--failover-only", action="store_true")
    p.add_argument("--sharded-only", action="store_true",
                   help="run only the distro-handoff kill points")
    p.add_argument("--sup-only", action="store_true",
                   help="run only the supervisor-crash points")
    p.add_argument("--solver-only", action="store_true",
                   help="run only the solver-leader death points")
    p.add_argument("--ticks", type=int, default=DEFAULT_TICKS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = p.parse_args(argv)
    device = args.device
    if device is None:
        from ..utils.torchenv import ensure_usable_backend

        ensure_usable_backend()  # the card, or a RuntimeError
    if args.solver_only:
        return 1 if run_solver_points(device) else 0
    if args.sup_only:
        return 1 if run_sup_points(device) else 0
    if args.sharded_only:
        return 1 if run_sharded_points(args.ticks, device) else 0
    if args.failover_only:
        out = failover_case(device=device)
        print(json.dumps({k: v for k, v in out.items()
                          if not k.endswith("_out")}))
        return 0 if out["ok"] else 1
    if args.point:
        seam, _, idx = args.point.partition("@")
        out = run_point(seam, int(idx or 0), ticks=args.ticks,
                        reference=reference_state(args.ticks, device), device=device)
        print(json.dumps({k: v for k, v in out.items() if k != "out"}))
        return 0 if out["ok"] else 1
    rc = run_matrix(ticks=args.ticks, device=device)
    # parent-side witness audit: the harness itself runs stores, leases
    # and dispatch in-process; any inversion recorded here is a failure
    from ..utils import lockcheck

    inversions = lockcheck.violations()
    if inversions:
        print(json.dumps({"lockcheck_inversions": len(inversions)}))
        rc = rc or 1
    return rc


if __name__ == "__main__":
    if not os.environ.get(_LOCKCHECK_ENV):
        # the package's module-level locks were created before this
        # module ran: start again with the witness on from the first one
        os.environ[_LOCKCHECK_ENV] = "1"
        os.execv(sys.executable, [sys.executable, "-m", _MODULE, *sys.argv[1:]])
    sys.exit(main())
