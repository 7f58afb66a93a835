"""Fault-matrix soak: every injected fault class must leave the tick
pipeline alive and the store consistent.

A port of the JAX repository's ``tools/fault_matrix.py``. One case per
fault class of the resilience layer (``utils/faults.py`` seams). The
tick-pipeline cases (solve raise, solve hang past its deadline, breaker
cycle, WAL group-commit error, torn group frame, lease steal mid-commit,
tick-budget shed) run as scenario specs through the engine
(``scenarios/matrix.py``) and this module only delegates. The bespoke
cases exercise what the tick replay does not: the async WAL's deferred
barrier, the lease-renewal thread, the agent transport's retries, the
cloud provider's spawn, the event senders and the job quarantine. Each
case returns a dict with ``ok``; ``tests/test_torch_resilience.py``
holds each against JAX's case on the same seed.

A case that ticks does so on ``device`` (the CUDA card when None, which
raises without one; ``"cpu"`` in the tests). It also checks that every
tick it expects planned by the device solve was planned there: a tick
that falls back to the serial oracle where no fault asked for it fails
the case, and a card fault (``KernelError``) raises out of it.

    python -m evergreen_tpu_torch.scenarios.fault_matrix [--seeds N]
        [--case NAME] [--device cpu|cuda]

prints one JSON line per case and seed (``{"case", "seed", "ok"}``),
a ``TICKS`` line per ticking case (its ticks' planners and
degradations, its card solves and the kernel counters' deltas, which
must be the launches of those solves), the lock-order inversions and
the failure count; it exits 1 on any failure or inversion. Run as a
module it switches the lock-order witness on (``EVERGREEN_TPU_LOCKCHECK``,
kept if set) before any package import, re-executing itself once if
the variable was unset; importing it changes nothing.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import threading
from typing import Callable, Dict, List, Optional

from ..globals import HostStatus, Provider
from ..models import distro as distro_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..models.task_queue import COLLECTION as TQ_COLLECTION
from ..models.task_queue import doc_column
from ..scheduler.wrapper import TickOptions, run_tick
from ..storage.store import Store
from ..utils import faults
from ..utils import log as log_mod
from ..utils.benchgen import NOW, generate_problem
from ..utils.faults import Fault, FaultPlan
from .crash_matrix import expected_launches, start_device

_LOCKCHECK_ENV = "EVERGREEN_TPU_LOCKCHECK"
_MODULE = "evergreen_tpu_torch.scenarios.fault_matrix"

OPTS = TickOptions(create_intent_hosts=True, underwater_unschedule=False)


def _seed_store(store, n_distros: int = 3, n_tasks: int = 60, seed: int = 7):
    """A small, fully-plannable problem inserted into ``store``."""
    distros, tasks_by_distro, hosts_by_distro, _, _ = generate_problem(
        n_distros, n_tasks, seed=seed, hosts_per_distro=2
    )
    for d in distros:
        distro_mod.insert(store, d)
    all_tasks = [t for ts in tasks_by_distro.values() for t in ts]
    task_mod.insert_many(store, all_tasks)
    for hs in hosts_by_distro.values():
        host_mod.insert_many(store, hs)
    return distros, tasks_by_distro, hosts_by_distro


def _capture_logs():
    got: List[dict] = []
    log_mod.add_sink(got.append)
    return got, lambda: log_mod.remove_sink(got.append)


# --------------------------------------------------------------------------- #
# the card's books: a ticking case's solves against the kernels' counters
# --------------------------------------------------------------------------- #


def card_counts() -> dict:
    """The kernel counters and the card solves of this process now."""
    from ..ops.distro_stats import fused_distro_stats
    from ..ops.segment import segment_sum
    from ..ops.solve import CARD_SOLVES

    return {
        "launches": {"fused_distro_stats": fused_distro_stats.launches,
                     "segment_sum": segment_sum.launches,
                     **{f"segment_sum[{p}]": n
                        for p, n in segment_sum.launches_by_plan.items()}},
        "card_solves": dict(CARD_SOLVES),
    }


def card_books(before: dict, planners: Optional[List[str]] = None,
               on_card: bool = False) -> dict:
    """What a case did on the card since ``before`` (``card_counts()``):
    the kernel counters' deltas, its card solves, its ticks planned by
    the device solve (``planners``: each tick's ``planner_used``, where
    the case reads them), and the problems of holding the launches to
    ``expected_launches`` of those solves and, ``on_card``, the solves
    to those ticks. A solve abandoned at its tick's deadline runs on, on
    its own thread: it is waited for first."""
    for th in threading.enumerate():
        if th.name == "tick-solve":
            th.join(30)
    now = card_counts()
    launches = {k: v - before["launches"].get(k, 0)
                for k, v in now["launches"].items()
                if v != before["launches"].get(k, 0)}
    solves = {k: v - before["card_solves"][k] for k, v in now["card_solves"].items()}
    want = {k: v for k, v in expected_launches(
        solves["solves"], solves["capacity_iters"]).items() if v}
    problems = []
    if launches != want:
        problems.append(f"launches {launches}, expected {want} for card solves {solves}")
    device_ticks = None
    if planners is not None:
        device_ticks = sum(p == "tpu" for p in planners)
        if on_card and solves["solves"] != device_ticks:
            problems.append(f"{solves['solves']} card solves for {device_ticks} "
                            f"device-planned ticks")
    return {"launches": launches, "card_solves": solves,
            "device_ticks": device_ticks, "problems": problems}


def persisted_queues(store, res) -> dict:
    """The task ids of each queue tick ``res`` planned, in order, as
    ``store`` holds them (None where it holds none)."""
    out = {}
    for did in sorted(res.queues):
        if did.endswith("::alias"):
            continue
        doc = store.collection(TQ_COLLECTION).get(did)
        out[did] = None if doc is None else doc_column(doc, "id")
    return out


# --------------------------------------------------------------------------- #
# cases
#
# The tick-pipeline cases run as scenario specs through the engine
# (scenarios/matrix.py) with their assertions expressed as checks over
# the replay; this module only delegates. The bespoke cases exercise
# non-tick subsystems plus the async WAL's deferred barrier.
# --------------------------------------------------------------------------- #


def _engine_case(name: str):
    def run(seed: int = 0, device=None) -> dict:
        from .matrix import run_matrix_case

        return run_matrix_case("fault", name, seed, device=device)

    run.__name__ = f"case_{name.replace('-', '_')}"
    return run


case_solve_raise = _engine_case("solve-raise")
case_solve_hang = _engine_case("solve-hang")
case_breaker_cycle = _engine_case("breaker-cycle")
case_wal_error = _engine_case("wal-error")
case_wal_torn = _engine_case("wal-torn")
case_tick_budget_shed = _engine_case("tick-budget-shed")
case_lease_steal_mid_commit = _engine_case("lease-steal-mid-commit")

#: the delegates, by name (each the engine's fault case of that name)
ENGINE_CASES = ("solve-raise", "solve-hang", "breaker-cycle", "wal-error",
                "wal-torn", "tick-budget-shed", "lease-steal-mid-commit")


def case_wal_async_deferred(seed: int = 0, device=None) -> dict:
    """Async group commit (the service cadence): tick t's WAL frame fails
    on the background flusher AFTER run_tick returned; the error surfaces
    at tick t+1's barrier as the batched persist-failed degradation, the
    delta fingerprints reset (t+1 full-rewrites), and recovery stays
    consistent. All three ticks are planned by the device solve on
    ``device``."""
    from ..device import resolve_device
    from ..storage.durable import DurableStore

    dev = resolve_device(device)
    data_dir = tempfile.mkdtemp(prefix="fault-walasync-")
    store = DurableStore(data_dir)
    _seed_store(store, seed=seed + 29)
    opts = dataclasses.replace(OPTS, async_persist=True)
    got, stop = _capture_logs()
    faults.install(
        FaultPlan().at("wal.commit", 0, Fault("raise", OSError("disk full")))
    )
    try:
        res1 = run_tick(store, opts, now=NOW, device=dev)   # commit fails off-thread
        res2 = run_tick(store, opts, now=NOW + 1, device=dev)  # barrier surfaces it
    finally:
        faults.uninstall()
        stop()
    res3 = run_tick(store, opts, now=NOW + 2, device=dev)
    store.sync_persist()
    recovered = DurableStore(data_dir)
    queues = persisted_queues(recovered, res3)
    queues_survive = all(q is not None for q in queues.values())
    ticks = (res1, res2, res3)
    planners = [r.planner_used for r in ticks]
    ok = (
        res1.degraded == ""          # the error had not surfaced yet
        and res2.degraded == "persist-failed"
        and res3.degraded == ""
        and sum(res2.queues.values()) > 0
        and queues_survive
        and any(
            r.get("message") == "wal-group-commit-failed"
            and r.get("deferred") is True
            for r in got
        )
        # no hidden fallback: the fault is the WAL's, never the solve's
        and planners == ["tpu"] * 3
    )
    for s in (store, recovered):
        s.close()
    if ok:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {
        "ok": ok,
        "degraded": [r.degraded for r in ticks],
        "planners": planners,
        "queues": queues,
        "logs": got,
    }


def case_lease_loss(seed: int = 0, device=None) -> dict:
    from ..storage.lease import FileLease

    data_dir = tempfile.mkdtemp(prefix="fault-lease-")
    lease = FileLease(os.path.join(data_dir, "lease.json"), ttl_s=0.3)
    assert lease.try_acquire()
    got, stop = _capture_logs()
    lost_evt = threading.Event()
    plan = faults.install(FaultPlan().always("lease.renew", Fault("lost")))
    try:
        lease.start_renewing(on_lost=lost_evt.set)
        fired = lost_evt.wait(timeout=5.0)
    finally:
        lease.stop_renewing()
        faults.uninstall()
        stop()
    shutil.rmtree(data_dir, ignore_errors=True)
    return {
        "ok": (
            fired
            and lease.lost
            and any(r.get("message") == "lease-lost" for r in got)
        ),
        "fired": fired,
        "faults_fired": [list(f) for f in plan.fired[:1]],
        "logs": got,
    }


def case_agent_comm(seed: int = 0, device=None) -> dict:
    from ..agent.rest_comm import RestCommunicator

    got, stop = _capture_logs()
    comm = RestCommunicator(
        "http://127.0.0.1:9", retries=3, backoff_s=0.0
    )
    plan = faults.install(
        FaultPlan().always(
            "agent.comm", Fault("raise", TimeoutError("injected timeout"))
        )
    )
    raised = False
    try:
        try:
            comm.next_task("h1")
        except ConnectionError:
            raised = True
    finally:
        faults.uninstall()
        stop()
    return {
        "ok": (
            raised
            and plan._calls.get("agent.comm") == 3  # bounded attempts
            and any(r.get("message") == "retry-exhausted" for r in got)
        ),
        "calls": plan._calls.get("agent.comm"),
        "faults_fired": [list(f) for f in plan.fired],
        "logs": got,
    }


def case_provider_error(seed: int = 0, device=None) -> dict:
    from ..cloud.provisioning import (
        MAX_PROVISION_ATTEMPTS,
        create_hosts_from_intents,
    )
    from ..models.distro import Distro
    from ..models.host import new_intent

    store = Store()
    distro_mod.insert(store, Distro(id="dp", provider=Provider.MOCK.value))
    intent = new_intent("dp", Provider.MOCK.value)
    host_mod.insert(store, intent)
    got, stop = _capture_logs()
    plan = faults.install(FaultPlan().always("cloud.spawn", Fault("raise")))
    try:
        for k in range(MAX_PROVISION_ATTEMPTS):
            spawned = create_hosts_from_intents(store, now=NOW + k)
    finally:
        faults.uninstall()
        stop()
    h = host_mod.get(store, intent.id)
    # _poison marks PROVISION_FAILED then asks the provider to terminate,
    # which may advance it to TERMINATED: both are poisoned end states
    poisoned = h is not None and h.status in (
        HostStatus.PROVISION_FAILED.value,
        HostStatus.TERMINATED.value,
    )
    return {
        "ok": (
            spawned == []
            and poisoned
            and h.provision_attempts == MAX_PROVISION_ATTEMPTS
            and any(
                r.get("message") == "host-spawn-failed" for r in got
            )
        ),
        "provision_attempts": None if h is None else h.provision_attempts,
        "faults_fired": [list(f) for f in plan.fired],
        "logs": got,
    }


def case_sender_error(seed: int = 0, device=None) -> dict:
    from ..events.senders import OUTBOX, insert_outbox_row
    from ..events.transports import drain_outboxes

    store = Store()
    insert_outbox_row(
        store, OUTBOX["slack"],
        {"channel_type": "slack", "slack_channel": "#x", "text": "hi"},
    )

    class _Recorder:
        def __init__(self):
            self.delivered = []

        def deliver(self, doc):
            self.delivered.append(doc["_id"])

    slack = _Recorder()
    got, stop = _capture_logs()
    plan = faults.install(FaultPlan().always("events.deliver", Fault("raise")))
    try:
        for _ in range(3):
            drain_outboxes(store, transports={"slack": slack}, now=NOW)
    finally:
        faults.uninstall()
        stop()
    row = store.collection(OUTBOX["slack"]).find(lambda d: True)[0]
    # fault cleared: a fresh row delivers, the channel recovered
    insert_outbox_row(
        store, OUTBOX["slack"],
        {"channel_type": "slack", "slack_channel": "#x", "text": "again"},
    )
    drain_outboxes(store, transports={"slack": slack}, now=NOW + 1)
    return {
        "ok": (
            row.get("failed") is True
            and row.get("attempts") == 3
            and len(slack.delivered) == 1
            and any(
                r.get("message") == "outbox-row-abandoned" for r in got
            )
        ),
        "attempts": row.get("attempts"),
        "delivered": len(slack.delivered),
        "faults_fired": [list(f) for f in plan.fired],
        "logs": got,
    }


def case_job_quarantine(seed: int = 0, device=None) -> dict:
    from ..queue.jobs import FnJob, JobQueue

    store = Store()
    q = JobQueue(store, workers=1, poison_threshold=2, quarantine_s=60.0)
    got, stop = _capture_logs()

    def boom(s):
        raise RuntimeError("poison")

    try:
        for i in range(2):
            assert q.put(FnJob(f"poison-{i}", boom, job_type="poison"))
            q.wait_idle(5.0)
        dropped = not q.put(FnJob("poison-2", boom, job_type="poison"))
        other_ok = q.put(FnJob("fine-0", lambda s: None, job_type="fine"))
        q.wait_idle(5.0)
        # cooldown elapses: exactly one probe runs; success lifts it
        with q._lock:
            q._quarantined_until["poison"] = 0.0
        probe_ok = q.put(
            FnJob("probe-0", lambda s: None, job_type="poison")
        )
        q.wait_idle(5.0)
        lifted = q.put(FnJob("after-0", lambda s: None, job_type="poison"))
        q.wait_idle(5.0)
    finally:
        stop()
        q.close()
    return {
        "ok": (
            dropped
            and other_ok
            and probe_ok
            and lifted
            and any(r.get("message") == "job-quarantined" for r in got)
            and any(
                r.get("message") == "job-quarantine-lifted" for r in got
            )
        ),
        "logs": got,
    }


CASES: Dict[str, Callable[..., dict]] = {
    "solve-raise": case_solve_raise,
    "solve-hang": case_solve_hang,
    "breaker-cycle": case_breaker_cycle,
    "wal-error": case_wal_error,
    "wal-torn": case_wal_torn,
    "wal-async-deferred": case_wal_async_deferred,
    "lease-loss": case_lease_loss,
    "lease-steal-mid-commit": case_lease_steal_mid_commit,
    "agent-comm": case_agent_comm,
    "provider-error": case_provider_error,
    "sender-error": case_sender_error,
    "job-quarantine": case_job_quarantine,
    "tick-budget-shed": case_tick_budget_shed,
}

#: the cases that tick (on ``device``)
TICKING = frozenset(ENGINE_CASES) | {"wal-async-deferred"}


def run_case(name: str, seed: int = 0, device=None) -> dict:
    return CASES[name](seed, device=device)


def ticks_line(name: str, seed: int, device, out: dict, before: dict) -> dict:
    """The ``TICKS`` line of a ticking case: its ticks' planners and
    degradations and its persisted queues where the case reads them, and
    its books on the card (``card_books``)."""
    books = card_books(before, out.get("planners"), on_card=device_arg(device) == "cuda")
    line = {"case": name, "seed": seed, "device": device_arg(device),
            **{k: out[k] for k in ("planners", "degraded", "queues") if k in out},
            **books}
    print("TICKS " + json.dumps(line, default=str), flush=True)
    return line


def device_arg(device) -> str:
    """A device's name on a command line (None: the card)."""
    return "cuda" if device is None else str(device)


def lockcheck_line() -> int:
    """Print the lock-order witness's inversions in this process; their
    count."""
    from ..utils import lockcheck

    inversions = lockcheck.violations()
    print(json.dumps({"lockcheck_inversions": len(inversions)}), flush=True)
    return len(inversions)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m " + _MODULE,
                                description="The fault matrix on the port.")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--case", default="", help="run one case only")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = p.parse_args(argv)
    device = args.device
    if device is None:
        from ..utils.torchenv import ensure_usable_backend

        ensure_usable_backend()  # the card, or a RuntimeError
    start_device(device)  # CUDA up before any case's threads or timings
    names = [args.case] if args.case else sorted(CASES)
    failures = 0
    for seed in range(args.seeds):
        for name in names:
            before = card_counts()
            out = run_case(name, seed, device=device)
            ok = bool(out.get("ok"))
            if name in TICKING:
                ok = not ticks_line(name, seed, device, out, before)["problems"] and ok
            failures += 0 if ok else 1
            print(json.dumps({"case": name, "seed": seed, "ok": ok}), flush=True)
    failures += lockcheck_line()
    print(json.dumps({"fault_matrix_failures": failures}), flush=True)
    return 1 if failures else 0


def reexec_with_witness(module: str) -> None:
    """Under ``python -m``: start again with the lock-order witness on if
    it was off. The package's module-level locks were created before the
    module ran, so the witness must be on from the interpreter's start."""
    if not os.environ.get(_LOCKCHECK_ENV):
        os.environ[_LOCKCHECK_ENV] = "1"
        os.execv(sys.executable, [sys.executable, "-m", module, *sys.argv[1:]])


if __name__ == "__main__":
    reexec_with_witness(_MODULE)
    sys.exit(main())
