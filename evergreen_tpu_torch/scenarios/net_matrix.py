"""Network-chaos matrix: the Jepsen-style partition analogue of the disk
matrix.

A port of the JAX repository's ``tools/net_matrix.py``. Where the disk
matrix rots the bytes under a living process, this matrix cuts the WIRES
between living processes — partition (one-way and symmetric), loss,
duplication, reordering, latency, and half-open connections at every
transport seam (``utils/faults.py``'s network-chaos vocabulary) — and
asserts the detection → bounded-degradation contract end to end:

  * zero duplicate dispatch: at-least-once delivery (retries after drop,
    half-open re-delivery, outright duplication) never double-claims a
    task — the dispatch CAS and the running-task resume path fence every
    copy;
  * exactly-one-owner + monotone epochs: a partitioned worker orphans on
    its command-staleness deadline (never split-brains), heals in place
    when commands resume, and any fenced restart lands at a strictly
    higher epoch;
  * stale-accepted == 0: delayed solver-leader results past the round's
    timeout are fenced at out_seq, never applied;
  * resume == rerun: a run that rode out the chaos converges to the same
    canonical state as an uninterrupted reference replay;
  * degrade-within-one-round: a leader delay past the solve timeout
    degrades exactly the affected round to local solves, then recovers.

Five arms, all run by default; the SABOTAGE self-test runs FIRST — a
deliberately unfenced duplicate delivery (a forged second claim
bypassing the CAS) must be caught red, or the whole matrix refuses to
certify anything:

  sabotage  plant an unfenced duplicate delivery; the invariant plane
            must convict it (the matrix's own smoke detector);
  grid      seam x kind points across three plane configs — classic
            (in-process engine: lossy agent claim storms + replica
            tail), fleet2 (2-shard supervised fleet over real worker
            processes: IPC partition/drop/delay/duplicate/reorder), and
            leader2 (solver-leader fleet: delayed publish/return,
            partitioned worker);
  weathers  the library's and the process backend's net weathers;
  cases     bespoke seam cases: wait_reply reorder/duplication
            hardening, sock.adopt refused + half-open, duplicate
            delivery against the dispatch CAS, full-jitter retry
            spread;
  fuzz      reachability: the weather fuzzer must actually draw
            ``net_fault`` events, drawn cases must run green, and one
            shrunk net_fault timeline must replay deterministically.

    python -m evergreen_tpu_torch.scenarios.net_matrix [--grid-only |
        --weathers-only | --cases-only | --fuzz-only | --point C:SEAM:KIND]
        [--config classic|fleet2|leader2 ...] [--device cpu|cuda]

One JSON line per case; a ``TICKS`` line per run that ticks (the
sabotage, each grid point, each weather, each fuzz case and the shrunk
timeline): an in-process run's verdicts, fingerprint, its ticks'
planners, its card solves and the kernel counters' deltas, which must be
the launches of those solves; a fleet's replies' planners and, per
shard worker life, its last counters against the card solves it
reported (the solver leader's stacked launches, in this process, are
held by the caller that knows its stacked blocks: ``chip_smoke.py``'s
step 5). A tick the run expects planned by the device solve that fell
back to the serial oracle fails it. Then the lock-order inversions and a
summary line; exit 1 on any failure or inversion, and on a sabotage that
is not caught (``"aborted"``, before anything else runs).

**The port's departures.**

- A ticking run takes ``device``: the CUDA card when None (``main``
  without ``--device`` probes the card and raises without one, before
  any case), the CPU with ``"cpu"``; ``main`` starts the device
  (``start_device``) before the first case.
- JAX pins 8 virtual CPU devices at import so that ``leader2`` can elect
  a leader (``force_cpu(n_devices=8)``). The port's leader stacks the
  round on its one device (the proc harness builds the workload's
  ``"auto"`` as ``"always"``), so this module pins nothing.
- JAX's net matrix does not turn the lock-order witness on; run as a
  module, this one switches it on (``EVERGREEN_TPU_LOCKCHECK``, kept if
  set) before any package import, re-executing itself once if the
  variable was unset, as the fault matrix does; importing it changes
  nothing.
- ``--config`` (repeatable) picks the grid's configs; JAX's grid always
  runs all three.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from .crash_matrix import expected_launches, start_device
from .disk_matrix import fuzz_reachable, verdicts
from .fault_matrix import (
    card_books,
    card_counts,
    device_arg,
    lockcheck_line,
    reexec_with_witness,
)

_MODULE = "evergreen_tpu_torch.scenarios.net_matrix"

CONFIGS = ("classic", "fleet2", "leader2")

#: classic (in-process) agent-transport grid: kind x loss rate, each
#: driven through the scenario engine's ``net_fault`` storm + heal
AGENT_KINDS = ("drop", "half_open", "duplicate", "partition")
AGENT_RATES = (0.3, 0.6)

#: classic replica-tail grid: the tail survives every silent-wire shape
REPLICA_KINDS = ("half_open", "drop", "partition")

#: fleet2 (2-shard supervised fleet) grid: (seam, kind, delay_s).
#: ``ipc.send.0`` faults black-hole supervisor→worker commands for ONE
#: shard (the one-way partition: heartbeats still flow back);
#: ``ipc.recv.0`` faults eat worker→supervisor traffic instead, which
#: starves the heartbeat watchdog into a fenced restart — never a
#: split-brain.
FLEET_GRID: List[Tuple[str, str, float]] = [
    ("ipc.send.0", "partition", 0.0),
    ("ipc.send.0", "drop", 0.0),
    ("ipc.send.0", "delay", 0.3),
    ("ipc.send.0", "duplicate", 0.0),
    ("ipc.recv.0", "drop", 0.0),
    ("ipc.recv.0", "duplicate", 0.0),
    ("ipc.recv.0", "reorder", 0.0),
]

#: leader2 (solver-leader fleet) grid: delayed solver legs + a
#: partitioned worker under an elected leader. ``solver.return`` gets a
#: delay PAST the workers' solve timeout (6s): that round must degrade
#: to local solves — and the late result must be fenced, never accepted.
LEADER_GRID: List[Tuple[str, str, float]] = [
    ("solver.publish", "delay", 0.5),
    ("solver.return", "delay", 8.0),
    ("ipc.send.0", "partition", 0.0),
]

WEATHERS = ("net-agent-storm-loss", "net-agent-storm-halfopen",
            "net-replica-halfopen")
PROC_WEATHERS = ("proc-net-oneway-partition",)


def _emit(res: dict) -> dict:
    print(json.dumps(res), flush=True)
    return res


def _entry_result(arm: str, point: str, entry: dict,
                  extra_problems: Optional[List[str]] = None) -> dict:
    problems = list(extra_problems or [])
    if not entry.get("ok"):
        problems.append(json.dumps(entry, default=str)[:2000])
    return {"arm": arm, "point": point, "ok": not problems,
            "problems": problems}


# --------------------------------------------------------------------------- #
# the card's books
# --------------------------------------------------------------------------- #


def _print_ticks(line: dict) -> None:
    print("TICKS " + json.dumps(line, default=str), flush=True)


def run_engine(arm: str, point: str, spec, device=None) -> Tuple[dict, dict]:
    """One in-process replay of ``spec`` on ``device`` through
    ``ScenarioRun``; prints its ``TICKS`` line (verdicts, fingerprint,
    planners, wall, the card's books) and returns (the entry, the line).
    Every tick must be planned by the device solve: a net fault is the
    wire's, never the solve's; the line's ``problems`` say where not."""
    from ..device import resolve_device
    from .engine import ScenarioRun

    dev = resolve_device(device)
    before = card_counts()
    t0 = time.perf_counter()
    run = ScenarioRun(spec, device=dev)
    entry = run.execute()
    wall = time.perf_counter() - t0
    planners = [r.planner_used for r in run.tick_results]
    books = card_books(before, planners, on_card=dev.type == "cuda")
    if planners.count("tpu") != len(planners):
        books["problems"].append(
            "ticks not planned by the device solve: %r" % (planners,))
    line = {"arm": arm, "point": point, "device": device_arg(device),
            "verdicts": verdicts(entry), "fingerprint": entry.get("fingerprint"),
            "planners": planners, "wall_s": round(wall, 4), **books}
    _print_ticks(line)
    return entry, line


def proc_books(run) -> dict:
    """A fleet replay's books: every round reply's planner (a reply from
    a tick that fell back to the serial oracle is a problem) and, for
    each shard worker life (shard, epoch), its last reported kernel
    counters against ``expected_launches`` of the card solves it
    reported."""
    planners, lives, problems = [], {}, []
    for rnd in run.rounds:
        for k, rep in sorted(rnd.items()):
            if "planner" in rep:
                planners.append(rep["planner"])
            if "launches" in rep:
                got = rep["launches"]
                lives[f"{k}.{rep['epoch']}"] = {
                    "launches": {k2: v for k2, v in {
                        "fused_distro_stats": got["fused_distro_stats"],
                        "segment_sum": got["segment_sum"],
                        **{f"segment_sum[{p}]": n
                           for p, n in got["segment_sum_by_plan"].items()},
                    }.items() if v},
                    "card_solves": rep["card_solves"]}
    if planners.count("tpu") != len(planners):
        problems.append("replies not planned by the device solve: %r" % (planners,))
    for life, books in sorted(lives.items()):
        cs = books["card_solves"]
        want = {k: v for k, v in expected_launches(
            cs["solves"], cs["capacity_iters"]).items() if v}
        if books["launches"] != want:
            problems.append(f"worker life {life}: launches {books['launches']}, "
                            f"expected {want} for card solves {cs}")
    return {"planners": planners, "lives": lives, "problems": problems}


def run_proc(arm: str, point: str, spec, device=None) -> Tuple[dict, dict]:
    """One fleet replay of ``spec`` on ``device`` through
    ``ProcScenarioRun``; prints its ``TICKS`` line (verdicts, stats the
    checks read, wall, ``proc_books``) and returns (the entry, the
    line)."""
    from .procs import ProcScenarioRun

    t0 = time.perf_counter()
    run = ProcScenarioRun(spec, device=device)
    entry = run.execute()
    wall = time.perf_counter() - t0
    st = entry.get("stats", {})
    line = {"arm": arm, "point": point, "device": device_arg(device),
            "verdicts": verdicts(entry),
            "stats": {k: st.get(k, 0) for k in (
                "restarts_total", "solver_stacked_replies", "solver_local_replies",
                "solver_stale_accepted")},
            "wall_s": round(wall, 4), **proc_books(run)}
    _print_ticks(line)
    return entry, line


# --------------------------------------------------------------------------- #
# sabotage arm
# --------------------------------------------------------------------------- #


def sabotage_spec():
    """A claim storm under half-open responses PLUS a forged duplicate
    claim that bypasses the dispatch CAS entirely (duplicate delivery
    with the fence ripped out)."""
    from ..globals import Provider
    from .library import _sabotage_duplicate_claim
    from .spec import Ev, ScenarioSpec

    return ScenarioSpec(
        name="net-sabotage-unfenced-duplicate",
        description="half-open claim storm with an UNFENCED duplicate "
                    "delivery spliced in (forged second claim, CAS "
                    "bypassed): the invariant plane must convict it",
        ticks=8,
        events=[
            # 4 hosts, 2 tasks: at tick 1 two hosts are mid-task and
            # two are free — the forged duplicate claim has both sides
            # live (same balance as the library's sabotage weather)
            Ev(0, "fleet", {"distros": [
                {"id": "dsab", "provider": Provider.MOCK.value,
                 "hosts": 4},
            ]}),
            Ev(0, "tasks", {"distro": "dsab", "n": 2,
                            "prefix": "dsab-t"}),
            Ev(1, "net_fault", {"target": "agent", "kind": "half_open",
                                "rate": 0.3, "agents": 4}),
            Ev(1, "call", {"fn": _sabotage_duplicate_claim}),
        ],
        tier1=False,
    )


def run_sabotage(device=None) -> List[dict]:
    """The matrix's own smoke detector, run before anything it would
    certify (``sabotage_spec`` on ``device``). The invariant plane MUST
    score it red with the dispatch-books invariants among the
    convictions — a green here means the matrix is blind and every other
    point is vacuous. The result carries the entry's ``verdicts``."""
    entry, line = run_engine("sabotage", "unfenced-duplicate", sabotage_spec(), device)
    problems: List[str] = list(line["problems"])
    if entry.get("ok"):
        problems.append(
            "the planted unfenced duplicate delivery was NOT caught — "
            "the invariant plane is blind; refusing to certify"
        )
    else:
        # the conviction must come from the dispatch-books invariants
        # (a second live claim → no_duplicate_dispatch; a claim that
        # outlived its task → store_consistent), not from an unrelated
        # SLO that happened to trip
        inv = entry.get("invariants", {})
        books = ("no_duplicate_dispatch", "store_consistent")
        if all(inv.get(k, {}).get("ok", True) for k in books):
            problems.append(
                "sabotage scored red, but not by the dispatch-books "
                "invariants: "
                + json.dumps(entry.get("invariants"), default=str)[:800]
            )
    return [_emit({"arm": "sabotage", "point": "unfenced-duplicate",
                   "ok": not problems, "problems": problems,
                   "verdicts": line["verdicts"]})]


# --------------------------------------------------------------------------- #
# grid arm
# --------------------------------------------------------------------------- #


def _classic_agent_spec(kind: str, rate: float):
    from ..globals import Provider
    from .spec import SLO, Ev, ScenarioSpec

    return ScenarioSpec(
        name="net-grid-agent-%s-%d" % (kind, int(rate * 100)),
        description="matrix-generated agent chaos: %s at %d%% across "
                    "a claim storm" % (kind, int(rate * 100)),
        ticks=12,
        events=[
            Ev(0, "fleet", {"distros": [
                {"id": "dgrid", "provider": Provider.MOCK.value,
                 "hosts": 6},
            ]}),
            Ev(0, "tasks", {"distro": "dgrid", "n": 12,
                            "prefix": "ng-t"}),
            Ev(2, "net_fault", {"target": "agent", "kind": kind,
                                "rate": rate, "agents": 6}),
            Ev(6, "tasks", {"distro": "dgrid", "n": 4,
                            "prefix": "ng-b"}),
        ],
        slos=[
            SLO("work-survives", "tasks_unfinished", "==", 0),
            SLO("no-failures", "tasks_failed", "==", 0),
        ],
    )


def _classic_replica_spec(kind: str):
    import dataclasses

    from .library import _net_replica_halfopen

    spec = _net_replica_halfopen()
    if kind == "half_open":
        return spec
    events = [
        dataclasses.replace(e, args={**e.args, "kind": kind})
        if e.kind == "net_fault" else e
        for e in spec.events
    ]
    return dataclasses.replace(
        spec, name="net-replica-%s" % kind, events=events,
        description=spec.description.replace("half-open", kind),
    )


def classic_points() -> List[Tuple[str, object]]:
    """The classic grid: (point, spec factory) in JAX's order."""
    out = []
    for kind in AGENT_KINDS:
        for rate in AGENT_RATES:
            out.append(("classic:agent.request:%s@%d" % (kind, int(rate * 100)),
                        lambda kind=kind, rate=rate: _classic_agent_spec(kind, rate)))
    for kind in REPLICA_KINDS:
        out.append(("classic:replica.tail:%s" % kind,
                    lambda kind=kind: _classic_replica_spec(kind)))
    return out


def run_classic_point(point: str, factory, device=None) -> dict:
    entry, line = run_engine("grid", point, factory(), device)
    return _emit(_entry_result("grid", point, entry, line["problems"]))


def run_classic_grid(device=None) -> List[dict]:
    return [run_classic_point(point, factory, device)
            for point, factory in classic_points()]


def _proc_net_spec(config: str, seam: str, kind: str, delay_s: float):
    """One proc-backend chaos point: arm the fault at tick 2, heal at
    tick 5, converge under the full proc invariant set (duplicate
    dispatch, exactly-one-owner, monotone epochs, resume == rerun)."""
    from .procs import _SOLVER_WORKLOAD, DEFAULT_PROC_INVARIANTS
    from .spec import SLO, Ev, ScenarioSpec

    if config == "leader2":
        workload = dict(_SOLVER_WORKLOAD)
        workload["round_timeout_s"] = 30.0
        if not seam.startswith("solver."):
            # the command-silence detector is under test only at the
            # IPC seams; solver points run the shipped leader workload
            # so a silence-orphan cannot disengage the stacked plane
            # mid-measurement
            workload["command_silence_s"] = 2.0
    else:
        workload = {"shards": 2, "distros": 4, "tasks": 32, "seed": 11,
                    "hosts_per_distro": 3, "round_timeout_s": 4.0,
                    "command_silence_s": 2.0}
    fault_args: Dict = {"seam": seam, "kind": kind}
    if delay_s:
        fault_args["delay_s"] = delay_s
    if seam.startswith("solver."):
        # one delayed leg (plan index 0 on the freshly armed plan =
        # the seam's next fire): exactly one round degrades
        fault_args["at"] = 0
    slug = "%s-%s" % (seam.replace(".", "-"), kind)
    checks: List = []
    if config == "leader2":
        checks.append(("stale-accepted-zero", _check_stale_zero))
        if seam.startswith("solver."):
            # anti-vacuity: a solver point where the stacked plane
            # never engaged (no device, lease lost) proves nothing
            checks.append(("solver-engaged", _check_solver_engaged))
        if seam == "solver.return":
            checks.append(("degrade-within-one-round",
                           _check_degrade_one_round))
    return ScenarioSpec(
        name="net-%s-%s" % (config, slug),
        description="matrix-generated %s chaos point: %s at %s"
                    % (config, kind, seam),
        ticks=14,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", workload),
            Ev(2, "net_fault", fault_args),
            Ev(5, "net_heal", {"seam": seam}),
        ],
        slos=[
            # a recv-side blackout starves the heartbeat watchdog once
            # per deadline window until the heal: each cycle is a
            # fenced restart by design, so the drop point's bound is
            # the blackout span, not one-off fencing
            SLO("bounded-restarts", "restarts_total", "<=",
                6 if (seam.startswith("ipc.recv") and kind == "drop")
                else 3),
        ],
        checks=checks,
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def _check_solver_engaged(run) -> Optional[str]:
    n = (run.stats.get("solver_stacked_replies", 0)
         + run.stats.get("solver_local_replies", 0))
    if n < 1:
        return ("the solver plane never engaged (no stacked or local "
                "replies) — the point is vacuous")
    return None


def _check_stale_zero(run) -> Optional[str]:
    n = run.stats.get("solver_stale_accepted", 0)
    if n:
        return "a worker accepted a stale solver result: %d" % n
    return None


def _check_degrade_one_round(run) -> Optional[str]:
    """The delayed solver.return must cost at most the round it landed
    in: at least one round degrades to a local solve, and some LATER
    round is fully stacked again (bounded degradation, then recovery)."""
    saw_local = False
    for rnd in run.rounds:
        solves = [r.get("solve") for r in rnd.values()]
        if "local" in solves:
            saw_local = True
        elif saw_local and solves.count("stacked") >= 2:
            return None
    if not saw_local:
        return "the delayed return never degraded any round to local"
    return "no fully stacked round after the degraded one"


def proc_points(config: str) -> List[Tuple[str, Tuple[str, str, float]]]:
    """A proc config's grid: (point, (seam, kind, delay_s))."""
    grid = FLEET_GRID if config == "fleet2" else LEADER_GRID
    return [("%s:%s:%s" % (config, seam, kind), (seam, kind, delay_s))
            for seam, kind, delay_s in grid]


def run_proc_point(config: str, seam: str, kind: str, delay_s: float,
                   device=None) -> dict:
    point = "%s:%s:%s" % (config, seam, kind)
    spec = _proc_net_spec(config, seam, kind, delay_s)
    entry, line = run_proc("grid", point, spec, device)
    res = _entry_result("grid", point, entry, line["problems"])
    if not res["ok"]:
        res["data_dir"] = entry.get("data_dir")
    return _emit(res)


def run_proc_grid(config: str, device=None) -> List[dict]:
    return [run_proc_point(config, *args, device=device)
            for _, args in proc_points(config)]


def run_grid(only_point: Optional[str] = None, device=None,
             configs: Tuple[str, ...] = CONFIGS) -> List[dict]:
    """The grid over ``configs`` on ``device``, or its one proc point
    ``only_point``."""
    if only_point is not None:
        # single-point mode: route to the owning config
        config = only_point.split(":", 1)[0]
        if config == "classic":
            raise SystemExit(
                "--point supports proc configs (fleet2/leader2); "
                "classic points run via --grid-only"
            )
        return [run_proc_point(config, *args, device=device)
                for point, args in proc_points(config) if point == only_point]
    results = []
    if "classic" in configs:
        results.extend(run_classic_grid(device))
    for config in ("fleet2", "leader2"):
        if config in configs:
            results.extend(run_proc_grid(config, device))
    return results


# --------------------------------------------------------------------------- #
# weathers arm
# --------------------------------------------------------------------------- #


def run_weathers(device=None) -> List[dict]:
    from .library import SCENARIOS
    from .procs import PROC_SCENARIOS

    results = []
    for name in WEATHERS:
        entry, line = run_engine("weathers", name, SCENARIOS[name](), device)
        results.append(_emit(_entry_result("weathers", name, entry, line["problems"])))
    for name in PROC_WEATHERS:
        entry, line = run_proc("weathers", name, PROC_SCENARIOS[name](), device)
        results.append(_emit(_entry_result("weathers", name, entry, line["problems"])))
    return results


# --------------------------------------------------------------------------- #
# cases arm
# --------------------------------------------------------------------------- #


def wait_reply_reorder_case() -> dict:
    """A reply reordered past its own wait (delivered after the wait
    timed out and a NEWER request is in flight) must be counted and
    dropped — never matched to the newer wait."""
    from ..runtime.supervisor import IPC_STALE_REPLIES, WorkerHandle

    problems: List[str] = []
    h = WorkerHandle(0, hb_deadline_s=5.0)
    before = IPC_STALE_REPLIES.value(shard=0)

    # request 1 answers normally and completes
    h.replies.put({"op": "round", "req": 1, "body": "first"})
    got = h.wait_reply("round", 1.0, req=1)
    if not got or got.get("body") != "first":
        problems.append("baseline reply lost: %r" % (got,))

    # the reorder: request 1's LATE duplicate arrives ahead of request
    # 2's real answer
    h.replies.put({"op": "round", "req": 1, "body": "late-dup"})
    h.replies.put({"op": "round", "req": 2, "body": "second"})
    got = h.wait_reply("round", 1.0, req=2)
    if not got or got.get("body") != "second":
        problems.append(
            "reordered stale reply satisfied the newer wait: %r"
            % (got,)
        )
    moved = IPC_STALE_REPLIES.value(shard=0) - before
    if moved != 1:
        problems.append(
            "stale-reply counter moved %s, want exactly 1" % moved
        )
    return {"arm": "cases", "point": "wait-reply-reorder",
            "ok": not problems, "problems": problems}


def wait_reply_duplicate_error_case() -> dict:
    """A duplicated ERROR leg carrying a spent request id must not end
    a newer wait either — the error fence only applies to live ids."""
    from ..runtime.supervisor import IPC_STALE_REPLIES, WorkerHandle

    problems: List[str] = []
    h = WorkerHandle(1, hb_deadline_s=5.0)
    before = IPC_STALE_REPLIES.value(shard=1)

    h.replies.put({"op": "round", "req": 7, "body": "a"})
    h.wait_reply("round", 1.0, req=7)
    # the transport duplicates the worker's error for the finished
    # request; a fresh request must still get ITS answer
    h.replies.put({"op": "error", "req": 7})
    h.replies.put({"op": "round", "req": 8, "body": "b"})
    got = h.wait_reply("round", 1.0, req=8)
    if not got or got.get("body") != "b":
        problems.append(
            "a stale duplicated error ended the newer wait: %r" % (got,)
        )
    moved = IPC_STALE_REPLIES.value(shard=1) - before
    if moved != 1:
        problems.append(
            "stale-reply counter moved %s, want exactly 1" % moved
        )
    return {"arm": "cases", "point": "wait-reply-duplicate-error",
            "ok": not problems, "problems": problems}


def sock_adopt_refused_case() -> dict:
    """``drop``/``partition`` at sock.adopt surface as a refused
    connect (OSError) — the supervisor's adoption probe falls back to a
    cold spawn instead of hanging."""
    from ..runtime import manifest
    from ..utils import faults

    problems: List[str] = []
    for kind in ("drop", "partition"):
        plan = faults.FaultPlan().at("sock.adopt", 0, faults.Fault(kind))
        faults.install(plan)
        try:
            try:
                manifest.connect("/tmp/definitely-not-a-socket.sock")
                problems.append("%s did not refuse the connect" % kind)
            except OSError:
                pass
        finally:
            faults.uninstall()
    return {"arm": "cases", "point": "sock-adopt-refused",
            "ok": not problems, "problems": problems}


def sock_adopt_halfopen_case() -> dict:
    """``half_open`` at sock.adopt hands back a connected-looking
    socket whose peer never answers: reads time out instead of erroring
    — exactly the shape _try_adopt's deadline must bound."""
    import socket as _socket

    from ..runtime import manifest
    from ..utils import faults

    problems: List[str] = []
    plan = faults.FaultPlan().at("sock.adopt", 0,
                                 faults.Fault("half_open"))
    faults.install(plan)
    try:
        conn = manifest.connect("/tmp/definitely-not-a-socket.sock")
    finally:
        faults.uninstall()
    try:
        conn.settimeout(0.2)
        try:
            conn.sendall(b'{"op":"adopt"}\n')  # lands in a dead buffer
        except OSError:
            problems.append("half-open socket errored on write")
        try:
            data = conn.recv(64)
            problems.append(
                "half-open socket answered: %r" % (data,)
            )
        except _socket.timeout:
            pass  # the contract: silence, not an error
        except OSError:
            problems.append(
                "half-open socket errored instead of staying silent"
            )
    finally:
        conn.close()
    return {"arm": "cases", "point": "sock-adopt-halfopen",
            "ok": not problems, "problems": problems}


def dispatch_cas_duplicate_case() -> dict:
    """Duplicate delivery against the dispatch CAS, no scenario engine
    in the way: the same next_task claim lands twice (and a third time
    with a STALE host snapshot still claiming to be free). Exactly one
    TASK_DISPATCHED may exist; every redelivery must resolve to the
    SAME task, never a second one."""
    from ..dispatch.assign import assign_next_available_task
    from ..dispatch.dag_dispatcher import DispatcherService
    from ..globals import HostStatus, TaskStatus
    from ..models import host as host_mod
    from ..models import task as task_mod
    from ..models import task_queue as tq_mod
    from ..models.host import Host
    from ..models.task import Task
    from ..models.task_queue import TaskQueue, TaskQueueItem
    from ..storage.store import Store

    problems: List[str] = []
    now = 1_700_000_000.0
    store = Store()
    task_mod.insert(store, Task(
        id="nt1", distro_id="d1",
        status=TaskStatus.UNDISPATCHED.value, activated=True,
    ))
    task_mod.insert(store, Task(
        id="nt2", distro_id="d1",
        status=TaskStatus.UNDISPATCHED.value, activated=True,
    ))
    host_mod.insert(store, Host(
        id="h1", distro_id="d1", status=HostStatus.RUNNING.value,
    ))
    tq_mod.save(store, TaskQueue(
        distro_id="d1",
        queue=[TaskQueueItem(id="nt1", dependencies_met=True),
               TaskQueueItem(id="nt2", dependencies_met=True)],
        generated_at=now,
    ))
    svc = DispatcherService(store)
    stale = host_mod.get(store, "h1")  # pre-claim snapshot

    first = assign_next_available_task(
        store, svc, host_mod.get(store, "h1"), now=now
    )
    if first is None or first.id != "nt1":
        problems.append("baseline claim failed: %r" % (first,))
    second = assign_next_available_task(
        store, svc, host_mod.get(store, "h1"), now=now
    )
    if second is None or second.id != first.id:
        problems.append(
            "duplicate delivery claimed a DIFFERENT task: %r"
            % (second,)
        )
    third = assign_next_available_task(store, svc, stale, now=now)
    if third is not None and third.id != first.id:
        problems.append(
            "stale-snapshot redelivery double-claimed: %r" % (third,)
        )
    dispatched = store.collection("events").find(
        lambda d: d.get("event_type") == "TASK_DISPATCHED"
    )
    if len(dispatched) != 1:
        problems.append(
            "%d TASK_DISPATCHED events for one claim (want 1)"
            % len(dispatched)
        )
    h = host_mod.get(store, "h1")
    if h.running_task != "nt1":
        problems.append(
            "host claim book wrong after redeliveries: %r"
            % (h.running_task,)
        )
    return {"arm": "cases", "point": "dispatch-cas-duplicate",
            "ok": not problems, "problems": problems}


def retry_jitter_spread_case() -> dict:
    """The agent transport's full-jitter backoff must SPREAD a
    correlated retry wave: across a simulated parked fleet, first-retry
    pauses must span most of [0, base] instead of clustering in the
    band-jitter corner — and be replayable from the rng seed."""
    import random

    from ..agent.rest_comm import RestCommunicator

    problems: List[str] = []
    policy = RestCommunicator("http://127.0.0.1:1").policy
    if not policy.full_jitter:
        problems.append("agent transport policy is not full-jitter")
    pauses = [
        policy.backoff_s(0, random.Random(1000 + i)) for i in range(64)
    ]
    base = policy.base_backoff_s
    if not all(0.0 <= p <= base for p in pauses):
        problems.append("a full-jitter pause escaped [0, base]")
    spread = max(pauses) - min(pauses)
    if spread < 0.5 * base:
        problems.append(
            "fleet retry pauses did not spread: span %.4f of base %.4f"
            % (spread, base)
        )
    # the band-jitter default would keep every pause above base/2;
    # full jitter must reach the low half or the fleet still storms
    if min(pauses) >= 0.5 * base:
        problems.append(
            "no pause landed in [0, base/2): the wave stays "
            "synchronized"
        )
    replay = [
        policy.backoff_s(0, random.Random(1000 + i)) for i in range(64)
    ]
    if replay != pauses:
        problems.append("jitter schedule is not seed-replayable")
    return {"arm": "cases", "point": "retry-full-jitter-spread",
            "ok": not problems, "problems": problems}


CASE_FNS = (wait_reply_reorder_case, wait_reply_duplicate_error_case,
            sock_adopt_refused_case, sock_adopt_halfopen_case,
            dispatch_cas_duplicate_case, retry_jitter_spread_case)


def run_cases() -> List[dict]:
    return [_emit(fn()) for fn in CASE_FNS]


# --------------------------------------------------------------------------- #
# fuzz arm
# --------------------------------------------------------------------------- #


def _fuzz_books(point: str, device, before: dict) -> dict:
    """The card's books of a fuzz run (``card_books``: the launches held
    to its card solves), printed as its ``TICKS`` line."""
    books = card_books(before)
    _print_ticks({"arm": "fuzz", "point": point, "device": device_arg(device), **books})
    return books


def run_fuzz_reachability(want: int = 3, max_probe: int = 200,
                          device=None) -> List[dict]:
    """The weather fuzzer must actually draw ``net_fault`` events (the
    vocabulary is reachable, not dead), drawn cases must run green on
    ``device``, and a sabotaged net timeline must shrink to a minimal
    reproduction that replays deterministically."""
    from ..device import resolve_device
    from . import fuzz as fuzz_mod

    dev = resolve_device(device)
    results = []
    found = fuzz_reachable(want, max_probe, kind="net_fault")
    if len(found) < want:
        return [_emit({
            "arm": "fuzz", "point": "reachability", "ok": False,
            "problems": [
                "only %d/%d probed weathers drew a net_fault in %d "
                "seeds" % (len(found), want, max_probe)
            ],
        })]
    for seed, spec in found:
        before = card_counts()
        entry = fuzz_mod.run_case(spec, device=dev)
        books = _fuzz_books("w%d" % seed, device, before)
        results.append(_emit(_entry_result(
            "fuzz", "w%d" % seed, entry, books["problems"]
        )))
    before = card_counts()
    res = shrunk_net_timeline_case(found[0][0], device=dev)
    res["problems"] += _fuzz_books("shrunk-net-timeline", device, before)["problems"]
    res["ok"] = not res["problems"]
    results.append(_emit(res))
    return results


def shrunk_net_timeline_case(seed: int, device=None) -> dict:
    """Plant a sabotage into a weather that drew a net_fault, shrink
    the red timeline, and prove the shrunk reproduction (a) still
    carries the violation and (b) replays fingerprint-identically —
    the fuzzer's net_fault vocabulary round-trips through the whole
    shrink/replay pipeline. Every replay runs on ``device``."""
    import dataclasses

    from . import fuzz as fuzz_mod
    from .library import _sabotage_duplicate_claim
    from .spec import Ev

    problems: List[str] = []
    base = fuzz_mod.generate_weather(seed)
    net_evs = [e for e in base.events if e.kind == "net_fault"]
    if not net_evs:
        return {"arm": "fuzz", "point": "shrunk-net-timeline",
                "ok": False,
                "problems": ["seed %d drew no net_fault" % seed]}
    sab_tick = max(1, net_evs[0].tick)
    spec = dataclasses.replace(
        base,
        name="%s-net-sab" % base.name,
        events=list(base.events) + [
            Ev(sab_tick, "call", {"fn": _sabotage_duplicate_claim})
        ],
    )
    entry = fuzz_mod.run_case(spec, device=device)
    if entry["ok"]:
        problems.append("the sabotaged net timeline was not caught")
        return {"arm": "fuzz", "point": "shrunk-net-timeline",
                "ok": False, "problems": problems}
    red = fuzz_mod.red_keys(entry)
    minimal = fuzz_mod.shrink_spec(
        spec, fails=fuzz_mod.fails_matching(red, device=device), max_runs=60,
    )
    e1 = fuzz_mod.run_case(minimal, device=device)
    e2 = fuzz_mod.run_case(minimal, device=device)
    if not (set(red) & set(fuzz_mod.red_keys(e1))):
        problems.append(
            "the shrunk timeline lost the original violation"
        )
    f1 = e1.get("fingerprint")
    if not f1 or f1 != e2.get("fingerprint"):
        problems.append(
            "the shrunk net timeline did not replay "
            "deterministically: %r != %r" % (f1, e2.get("fingerprint"))
        )
    return {"arm": "fuzz", "point": "shrunk-net-timeline",
            "ok": not problems, "problems": problems,
            "shrunk_events": len(minimal.events),
            "shrunk_ticks": minimal.ticks}


# --------------------------------------------------------------------------- #
# main
# --------------------------------------------------------------------------- #


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + _MODULE,
        description="network-chaos partition matrix on the port"
    )
    parser.add_argument("--grid-only", action="store_true")
    parser.add_argument("--weathers-only", action="store_true")
    parser.add_argument("--cases-only", action="store_true")
    parser.add_argument("--fuzz-only", action="store_true")
    parser.add_argument(
        "--point", default=None,
        help="run one proc grid point: config:seam:kind "
             "(e.g. fleet2:ipc.send.0:partition)",
    )
    parser.add_argument("--config", action="append", choices=CONFIGS,
                        help="the grid's configs (default: all three)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    selected = [args.grid_only, args.weathers_only, args.cases_only,
                args.fuzz_only]
    run_all = not any(selected)
    device = args.device
    if device is None:
        from ..utils.torchenv import ensure_usable_backend

        ensure_usable_backend()  # the card, or a RuntimeError
    start_device(device)  # CUDA up before any case's threads or timings

    results: List[dict] = []
    # the self-test gates EVERYTHING: a matrix that cannot convict a
    # planted violation must not certify a single point
    if args.point is None:
        results.extend(run_sabotage(device))
        if not results[-1]["ok"]:
            print(json.dumps({
                "net_matrix_points": len(results),
                "net_matrix_failures": 1,
                "failed": [results[-1]["point"]],
                "aborted": "sabotage self-test failed",
            }), flush=True)
            return 1
    if args.point is not None:
        results.extend(run_grid(only_point=args.point, device=device))
    else:
        if run_all or args.grid_only:
            results.extend(run_grid(device=device,
                                    configs=tuple(args.config or CONFIGS)))
        if run_all or args.weathers_only:
            results.extend(run_weathers(device))
        if run_all or args.cases_only:
            results.extend(run_cases())
        if run_all or args.fuzz_only:
            results.extend(run_fuzz_reachability(device=device))

    failures = [r for r in results if not r["ok"]]
    inversions = lockcheck_line()
    print(json.dumps({
        "net_matrix_points": len(results),
        "net_matrix_failures": len(failures),
        "failed": [r["point"] for r in failures],
    }), flush=True)
    return 1 if failures or inversions else 0


if __name__ == "__main__":
    reexec_with_witness(_MODULE)
    sys.exit(main())
