"""Storm-soak matrix: seeded storms against the overload-protection
layer (``utils/overload.py``), one case per storm class.

A port of the JAX repository's ``tools/overload_matrix.py``. Each case
drives sustained overload through a real seam (a task-churn job flood,
an event/notification storm, an API scrape storm, a slow store injected
at the ``wal.commit`` fault seam) and asserts the brownout invariants:

  * planning ticks never starve: every scheduler tick runs and persists
    queues, storm or no storm;
  * agent-critical work is never shed: agent-class jobs and agent
    protocol requests always get through;
  * the caps hold: the JobQueue pending set and the notification
    outboxes stay bounded under sustained pressure;
  * nothing is shed silently: every drop shows up in the counters AND
    the ``overload_sheds`` aggregate records, and the two books balance;
  * the monitor recovers: after the storm ends the ladder returns to
    GREEN (through its hysteresis) within a bounded number of
    evaluations.

The event-storm and slow-store cases run as scenario specs through the
engine (``scenarios/matrix.py``); this module delegates for those names.
The task-churn and API-scrape storms stay bespoke: they exercise real
worker threads and a live request loop the virtual-clock engine avoids.
The task-churn storm's planning ticks run on ``device`` (the CUDA card
when None) from the job queue's worker threads, and every one must be
planned by the device solve.

    python -m evergreen_tpu_torch.scenarios.overload_matrix [--seeds N]
        [--case NAME] [--device cpu|cuda]

prints one JSON line per case and seed (with the case's fields), a
``TICKS`` line per ticking case (as the fault matrix does), the
lock-order inversions and the failure count; exit 1 on any failure or
inversion. Run as a module it switches the lock-order witness on, as the
fault matrix does.
"""
from __future__ import annotations

import json
import sys
import time as _time
from typing import Callable, Dict, List, Optional

from ..queue.jobs import (
    PRIORITY_AGENT,
    PRIORITY_PLANNING,
    PRIORITY_STATS,
    FnJob,
    JobQueue,
)
from ..scheduler.wrapper import TickOptions, run_tick
from ..settings import OverloadConfig
from ..storage.store import Store
from ..utils import log as log_mod
from ..utils import overload
from ..utils.benchgen import NOW
from .crash_matrix import start_device
from .fault_matrix import (
    _capture_logs,
    _seed_store,
    card_counts,
    lockcheck_line,
    persisted_queues,
    reexec_with_witness,
    ticks_line,
)

_MODULE = "evergreen_tpu_torch.scenarios.overload_matrix"

OPTS = TickOptions(create_intent_hosts=True, underwater_unschedule=False)

#: bounded post-storm recovery: the ladder must be GREEN within this
#: many explicit evaluations after the storm ends
RECOVERY_EVALS = 12


def _counters() -> Dict[str, int]:
    return log_mod.counters_snapshot()


def _delta(before: Dict[str, int], name: str) -> int:
    return log_mod.get_counter(name) - before.get(name, 0)


def _drain_to_green(monitor: overload.LoadMonitor) -> int:
    """Evaluate until GREEN (or the bound); returns evaluations used.
    The sleep gives time-decayed gauges (api_rps) their idle windows."""
    for i in range(RECOVERY_EVALS):
        if monitor.evaluate() == overload.GREEN:
            return i + 1
        _time.sleep(0.15)
    return RECOVERY_EVALS + 1


def _sheds_balance(store: Store, before: Dict[str, int], kind: str,
                   counter: str) -> bool:
    """Zero-silent-discard audit: the counter delta for one shed class
    must equal the sum of its aggregate records (fresh store, so the
    records ARE the delta)."""
    recorded = sum(
        d.get("count", 0)
        for d in store.collection(overload.SHEDS_COLLECTION).find(
            lambda d: d.get("kind") == kind
        )
    )
    return recorded == _delta(before, counter) and recorded > 0


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #


def case_task_churn_storm(seed: int = 0, device=None) -> dict:
    """A flood of stats-class churn jobs against a small bounded queue:
    planning ticks and agent jobs must ride through untouched while the
    lowest class browns out. The planning ticks run on ``device`` from
    the queue's worker threads, each planned by the device solve."""
    from ..device import resolve_device

    dev = resolve_device(device)
    store = Store()
    _seed_store(store, seed=seed + 31)
    OverloadConfig(
        queue_max_pending=24,
        queue_pending_levels=[8.0, 16.0, 24.0],
        hysteresis_ticks=2,
        eval_interval_s=0.0,
        tick_cadence_s=0.05,
    ).set(store)
    monitor = overload.monitor_for(store)
    before = _counters()
    got, stop = _capture_logs()
    q = JobQueue(store, workers=2, name=f"storm-{seed}")

    planning_results: List = []
    agent_runs: List[int] = []
    max_pending = [0]

    def churn(s: Store) -> None:
        _time.sleep(0.004)

    def plan(s: Store) -> None:
        # the tick's queues as it persisted them (the scheduler-tick
        # scope runs one tick at a time)
        res = run_tick(s, OPTS, now=NOW, device=dev)
        planning_results.append((res, persisted_queues(s, res)))

    planning_ok: List[bool] = []
    agent_ok: List[bool] = []
    try:
        for i in range(150):
            q.put(
                FnJob(
                    f"churn-{seed}-{i}",
                    churn,
                    job_type="host-stats",
                    priority=PRIORITY_STATS,
                )
            )
            if i % 25 == 0:
                planning_ok.append(
                    bool(
                        q.put(
                            FnJob(
                                f"tick-{seed}-{i}",
                                plan,
                                scopes=["scheduler-tick"],
                                job_type="scheduler-tick",
                                priority=PRIORITY_PLANNING,
                            )
                        )
                    )
                )
                agent_ok.append(
                    bool(
                        q.put(
                            FnJob(
                                f"keepalive-{seed}-{i}",
                                lambda s, _i=i: agent_runs.append(_i),
                                job_type="agent-keepalive",
                                priority=PRIORITY_AGENT,
                            )
                        )
                    )
                )
            max_pending[0] = max(max_pending[0], q.pending_count())
        peaked = monitor.level() >= overload.YELLOW
        q.wait_idle(30.0)
        evals_to_green = _drain_to_green(monitor)
    finally:
        stop()
        q.close()
    shed_docs = store.collection("jobs").find(
        lambda d: d.get("status") == "shed"
    )
    planned = [q for _, q in planning_results]
    planning_results = [r for r, _ in planning_results]
    planners = [r.planner_used for r in planning_results]
    counters = {name: _delta(before, name) for name in (
        "overload.jobs_shed", "overload.jobs_shed.agent",
        "overload.jobs_shed.planning")}
    return {
        "ok": (
            all(planning_ok)
            and all(agent_ok)
            and len(planning_results) == len(planning_ok)
            and all(sum(r.queues.values()) > 0 for r in planning_results)
            and len(agent_runs) == len(agent_ok)
            # the cap held: agent/planning jobs may ride over it, churn
            # never (6 = the worst-case over-cap critical jobs in flight)
            and max_pending[0] <= 24 + 6
            and peaked
            and counters["overload.jobs_shed"] > 0
            and counters["overload.jobs_shed.agent"] == 0
            and counters["overload.jobs_shed.planning"] == 0
            and len(shed_docs) > 0
            and _sheds_balance(store, before, "job", "overload.jobs_shed")
            and evals_to_green <= RECOVERY_EVALS
            and any(r.get("message") == "job-shed" for r in got)
            # no hidden fallback: every planning tick on the device solve
            and planners == ["tpu"] * len(planning_ok)
        ),
        "max_pending": max_pending[0],
        "peaked": peaked,
        "evals_to_green": evals_to_green,
        "shed": counters["overload.jobs_shed"],
        "counters": counters,
        "planners": planners,
        "queues": planned,
        "logs": got,
    }


def _engine_case(name: str):
    """The case runs as a scenario spec through the engine
    (``scenarios/matrix.py``); this module only delegates."""

    def run(seed: int = 0, device=None) -> dict:
        from .matrix import run_matrix_case

        return run_matrix_case("overload", name, seed, device=device)

    run.__name__ = f"case_{name.replace('-', '_')}"
    return run


#: notification fan-out storm: coalesce at YELLOW, counted drops at the
#: cap, exactly-once send accounting, GREEN after the drain
case_event_storm = _engine_case("event-storm")


def case_api_storm(seed: int = 0, device=None) -> dict:
    """A scrape storm on the HTTP surface: expensive list endpoints 429
    with a level-derived Retry-After while the agent protocol keeps its
    SLO, then the rate gauge decays and service resumes."""
    from ..api.rest import RestApi
    from ..settings import ReadPathConfig

    store = Store()
    _, tasks_by_distro, _ = _seed_store(store, seed=seed + 47)
    task_id = next(iter(tasks_by_distro.values()))[0].id
    OverloadConfig(
        api_rps_levels=[60.0, 120.0, 100000.0],
        hysteresis_ticks=2,
        eval_interval_s=0.02,
        retry_after_red_s=30.0,
    ).set(store)
    # this case exercises the LADDER, not the read cache: cached
    # answers roughly double the storm loop's attack rate, which only
    # raises the rate-EWMA peak the recovery bound then has to decay
    ReadPathConfig(cache_enabled=False).set(store)
    monitor = overload.monitor_for(store)
    before = _counters()
    got, stop = _capture_logs()
    api = RestApi(store)
    shed_status = None
    shed_headers: List = []
    agent_status = None
    cheap_status = None
    try:
        deadline = _time.monotonic() + 5.0
        while monitor.level() < overload.RED:
            api.handle("GET", "/rest/v2/hosts")
            if _time.monotonic() > deadline:
                break
        red = monitor.level() >= overload.RED
        status, payload = api.handle("GET", "/rest/v2/hosts")
        shed_status = status
        shed_headers = list(
            getattr(api._ident, "response_headers", None) or []
        )
        shed_payload = payload
        # agent-critical traffic is never shed
        agent_status, _ = api.handle(
            "POST", f"/rest/v2/tasks/{task_id}/agent/heartbeat"
        )
        # a cheap single-doc read is not an expensive list: at RED it
        # still serves
        cheap_status, _ = api.handle("GET", f"/rest/v2/tasks/{task_id}")
        evals_to_green = _drain_to_green(monitor)
        post_status, _ = api.handle("GET", "/rest/v2/hosts")
    finally:
        stop()
    retry_vals = [v for h, v in shed_headers if h == "Retry-After"]
    return {
        "ok": (
            red
            and shed_status == 429
            and shed_payload.get("level") in ("red", "black")
            and retry_vals == ["30"]
            and agent_status != 429
            and cheap_status != 429
            and _delta(before, "overload.api_shed") > 0
            and evals_to_green <= RECOVERY_EVALS
            and post_status == 200
            and any(r.get("message") == "request-shed" for r in got)
        ),
        "shed_status": shed_status,
        "retry_after": retry_vals,
        "agent_status": agent_status,
        "evals_to_green": evals_to_green,
        "logs": got,
    }


#: crawling WAL (hang at wal.commit): the commit-latency EWMA drives
#: RED, ticks brown out optional work but keep planning, and the level
#: recovers once the store heals
case_slow_store_storm = _engine_case("slow-store-storm")


CASES: Dict[str, Callable[..., dict]] = {
    "task-churn-storm": case_task_churn_storm,
    "event-storm": case_event_storm,
    "api-storm": case_api_storm,
    "slow-store-storm": case_slow_store_storm,
}

#: the delegates, by name (each the engine's overload case of that name)
ENGINE_CASES = ("event-storm", "slow-store-storm")
#: the cases that tick (on ``device``)
TICKING = frozenset(ENGINE_CASES) | {"task-churn-storm"}


def run_case(name: str, seed: int = 0, device=None) -> dict:
    return CASES[name](seed, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m " + _MODULE,
                                description="The overload matrix on the port.")
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
            detail = {
                k: v for k, v in out.items()
                if k not in ("logs", "ok", "entry", "queues", "planners")
            }
            print(
                json.dumps(
                    {"case": name, "seed": seed, "ok": ok, **detail},
                    default=str,
                ),
                flush=True,
            )
    failures += lockcheck_line()
    print(json.dumps({"overload_matrix_failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    reexec_with_witness(_MODULE)
    sys.exit(main())
