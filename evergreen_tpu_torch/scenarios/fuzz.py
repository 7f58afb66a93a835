"""Property-based weather fuzzing over the scenario-engine vocabulary.

The shipped weathers (library.py) and the fault/crash matrices check
the six cross-cutting invariants where a human thought to look; this
module checks them everywhere a seeded generator can reach. A **weather**
is drawn from the existing ``Ev`` vocabulary — task bursts, merge
stacks, dependency DAGs, fleet growth, spot reclamation, notification
storms, clock jumps, fault seams (utils/faults.py), writer lease steals,
disk faults at the storage seams (ENOSPC/EIO/short-write/bitrot against
the WAL or a published snapshot, with the self-heal scrub scheduled
behind them) — as a pure function of one integer seed, replayed
deterministically
under ``DEFAULT_INVARIANTS``. A proc variant composes the child-process
vocabulary (worker SIGKILLs at WAL seams, hangs, supervisor kills) for
the supervised-fleet backend.

Failures shrink automatically: ``shrink_spec`` is a delta-debugging
loop (chunked event removal → single events → numeric arg shrinking →
timeline trim) that re-runs the failure predicate after every candidate
reduction, so any red schedule collapses to a minimal timeline — which
``campaign`` emits as a ready-to-check-in regression ``ScenarioSpec``
(scenarios/trace.py serialization, scenarios/regressions/ corpus).

``campaign`` is the time-boxed soak: seeds are enumerated from a pinned
start so a CI window is reproducible, and the sabotage self-test (a
deliberately corrupted dispatch book, in both in-process and
child-process modes) proves the invariant layer still
bites before any green result is trusted.

A copy of ``evergreen_tpu/scenarios/fuzz.py``; every replay runs its
solves on ``device`` (the card when None), a proc weather's in worker
processes through ``scenarios/procs.py``.

When ``hypothesis`` is installed, ``weather_strategy()`` exposes the
same generator as a strategy; absent the dep, the stdlib-seeded
fallback (utils/proptest.py) keeps every property test running.
"""
from __future__ import annotations

import dataclasses
import random
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from ..globals import Provider
from .procs import DEFAULT_PROC_INVARIANTS
from .spec import (
    DEFAULT_INVARIANTS,
    Ev,
    ScenarioSpec,
    scorecard_entry_fingerprint,
)

#: the pinned campaign anchor (gate runs are reproducible by default;
#: soak runs pass --start-seed to explore)
DEFAULT_CAMPAIGN_SEED = 16_0001

#: fault seams the in-process tick pipeline survives by contract (the
#: fault matrix's migrated cases): solve raises trip the breaker and
#: fall back, WAL group-commit errors shed the tick. Seams whose raise
#: crashes the harness itself (agent transport, dispatch CAS) belong to
#: the proc arm, where the blast radius is a worker process.
SAFE_FAULT_SEAMS = ("scheduler.solve",)
DURABLE_FAULT_SEAMS = ("wal.commit",)

#: the disk-fault vocabulary the generator draws for durable weathers
#: (scenarios/engine.py ev_disk_fault schedules the forced checkpoint
#: and the self-heal scrub behind each one)
DISK_FAULT_TARGETS = ("wal", "snapshot")
DISK_FAULT_KINDS = ("enospc", "bitrot", "short", "eio")

#: seams the proc arm SIGKILLs workers at (crash-matrix vocabulary)
PROC_KILL_SEAMS = ("wal.commit", "wal.append", "lease.renew")

#: the network-chaos vocabulary the generator draws for agent-side
#: lossy windows (scenarios/engine.py ev_net_fault seeds the window,
#: fires the claim storm, and heals it so the weather converges)
NET_FAULT_KINDS = ("drop", "half_open", "duplicate", "partition")


# --------------------------------------------------------------------------- #
# the generator: seed → weather
# --------------------------------------------------------------------------- #


def generate_weather(seed: int, sabotage: bool = False) -> ScenarioSpec:
    """One randomized in-process weather, a pure function of ``seed``.

    With ``sabotage=True`` a deliberate invariant violation (a forged
    duplicate running-task claim, bypassing the dispatch CAS) is
    spliced mid-run — the campaign's self-test weather. Sabotage specs
    carry a live callable, so they serialize only lossily."""
    rng = random.Random(int(seed))
    durable = rng.random() < 0.3
    n_distros = rng.randint(1, 3)
    spot_distro = ""
    spot_hosts = 0
    fleet: List[Dict] = []
    for k in range(n_distros):
        did = f"fz{k}"
        hosts = rng.randint(2, 5)
        if k == n_distros - 1 and n_distros > 1 and rng.random() < 0.4:
            spot_distro, spot_hosts = did, hosts
            fleet.append({
                "id": did, "provider": Provider.EC2_FLEET.value,
                "hosts": hosts,
                "provider_settings": {"fleet_use_spot": True,
                                      "instance_type": "m5.large"},
            })
        else:
            fleet.append({
                "id": did, "provider": Provider.MOCK.value,
                "hosts": hosts,
            })
    events: List[Ev] = [Ev(0, "fleet", {"distros": fleet})]
    n_hosts = sum(f["hosts"] for f in fleet)

    span = rng.randint(4, 10)
    n_tasks = 0
    depth = 0
    task_prefixes: List[str] = []
    lease_stolen = False
    dag_serial = 0
    for t in range(1, span + 1):
        for _ in range(rng.randint(0, 2)):
            d = fleet[rng.randrange(len(fleet))]["id"]
            kind = rng.choices(
                ("tasks", "merge_stack", "dag", "fail_next",
                 "grow_fleet", "spot_reclaim", "outbox", "drain_outbox",
                 "advance_clock", "fault", "lease_steal"),
                weights=(30, 8, 8, 12, 8, 6, 6, 4, 4, 8, 4),
            )[0]
            if kind == "tasks":
                n = rng.randint(2, 10)
                prefix = f"fzt{t}x{len(task_prefixes)}"
                chain = rng.random() < 0.25
                events.append(Ev(t, "tasks", {
                    "distro": d, "n": n, "prefix": prefix,
                    "priority": rng.choice((0, 0, 0, 50)),
                    "dep_chain": chain,
                }))
                task_prefixes.append(prefix)
                n_tasks += n
                if chain:
                    depth = max(depth, n)
            elif kind == "merge_stack":
                n = rng.randint(2, 5)
                dag_serial += 1
                events.append(Ev(t, "merge_stack", {
                    "distro": d, "stack": f"fzm{dag_serial}", "n": n,
                }))
                n_tasks += n
                depth = max(depth, n)
            elif kind == "dag":
                n = rng.randint(2, 4)
                dag_serial += 1
                stem = f"fzd{dag_serial}"
                nodes = []
                for i in range(n):
                    nodes.append({
                        "id": f"{stem}-{i}",
                        "revision_order": i + 1,
                        "deps": [f"{stem}-{i - 1}"] if i else [],
                        "activated": True,
                    })
                events.append(Ev(t, "dag", {"distro": d, "nodes": nodes}))
                n_tasks += n
                depth = max(depth, n)
            elif kind == "fail_next" and task_prefixes:
                events.append(Ev(t, "fail_next", {
                    "match": rng.choice(task_prefixes),
                    "details_type": rng.choice(("test", "system",
                                                "setup")),
                    "count": rng.randint(1, 3),
                }))
            elif kind == "grow_fleet":
                events.append(Ev(t, "grow_fleet", {
                    "distro": d, "n": rng.randint(1, 3),
                }))
            elif kind == "spot_reclaim" and spot_distro and spot_hosts:
                n = rng.randint(1, min(2, spot_hosts))
                spot_hosts -= n
                events.append(Ev(t, "spot_reclaim", {
                    "n": n, "distro": spot_distro,
                }))
            elif kind == "outbox":
                events.append(Ev(t, "outbox", {
                    "n": rng.randint(2, 12),
                    "distinct": rng.random() < 0.7,
                }))
            elif kind == "drain_outbox":
                events.append(Ev(t, "drain_outbox", {}))
            elif kind == "advance_clock":
                events.append(Ev(t, "advance_clock", {
                    "s": float(rng.choice((300, 1800, 3600))),
                }))
            elif kind == "fault":
                seams = SAFE_FAULT_SEAMS + (
                    DURABLE_FAULT_SEAMS if durable else ()
                )
                events.append(Ev(t, "fault", {
                    "seam": rng.choice(seams),
                    "at": rng.randint(0, 2),
                }))
            elif kind == "lease_steal" and durable and not lease_stolen \
                    and t >= 2:
                lease_stolen = True
                events.append(Ev(t, "lease_steal", {}))

    if durable:
        # disk weather rides on its OWN rng stream so its addition left
        # every pre-existing seed's event sequence untouched (the pinned
        # campaign anchor and the checked-in regression corpus replay
        # byte-identically)
        drng = random.Random(int(seed) ^ 0xD15C0)
        if drng.random() < 0.5:
            events.append(Ev(drng.randint(1, span), "disk_fault", {
                "target": drng.choice(DISK_FAULT_TARGETS),
                "kind": drng.choice(DISK_FAULT_KINDS),
            }))

    # network chaos rides its OWN rng stream for the same reason as the
    # disk stream above: every pre-existing seed replays byte-identically
    nrng = random.Random(int(seed) ^ 0x4E4654)
    if nrng.random() < 0.4:
        events.append(Ev(nrng.randint(1, span), "net_fault", {
            "target": "agent",
            "kind": nrng.choice(NET_FAULT_KINDS),
            "rate": round(nrng.uniform(0.15, 0.45), 2),
            "agents": nrng.randint(3, 8),
        }))

    if sabotage:
        from .library import _sabotage_duplicate_claim

        events.append(Ev(
            max(2, span // 2), "call",
            {"fn": _sabotage_duplicate_claim},
        ))

    # converge: arrival span + dependency depth + drain at capacity,
    # then slack — an underestimate would score honest weathers red on
    # starvation, so lean generous (the replay clock is virtual)
    drain = -(-max(1, n_tasks) // max(1, n_hosts))
    ticks = span + 2 * (depth + drain) + 6
    name = f"fuzz-sabotage-{seed}" if sabotage else f"fuzz-w{seed}"
    return ScenarioSpec(
        name=name,
        description=(
            f"generated weather (seed {seed}): {n_tasks} tasks over "
            f"{len(fleet)} distros, {len(events) - 1} events"
            + (", sabotaged dispatch books" if sabotage else "")
        ),
        ticks=ticks,
        events=events,
        seed=int(seed),
        durable=durable,
        invariants=DEFAULT_INVARIANTS,
        tier1=False,
    )


def generate_proc_weather(seed: int,
                          sabotage: bool = False) -> ScenarioSpec:
    """One randomized supervised-fleet weather (child-process backend):
    a seeded workload partitioned across 1–2 real worker processes with
    SIGKILLs at WAL seams, SIGSTOP hangs, or a supervisor kill+restart
    drawn from the proc vocabulary. Sabotage forges a duplicate
    dispatch CAS win directly into the seeded shard stores."""
    rng = random.Random(int(seed) ^ 0x9E3779B9)
    shards = rng.choice((1, 2))
    workload = {
        "shards": shards,
        "distros": rng.choice((2, 4)),
        "tasks": rng.choice((16, 24, 32)),
        "seed": rng.randint(1, 10_000),
        "hosts_per_distro": rng.randint(2, 3),
    }
    if sabotage:
        workload["sabotage_duplicate_claim"] = True
    events: List[Ev] = [Ev(0, "proc_fleet", workload)]
    ticks = 12
    if not sabotage:
        storms = ["kill", "hang", "sup", "none"]
        if shards == 2:
            # solver-leader storms need a real 2-shard fleet: a
            # 1-shard round never elects (stacking one shard is local)
            storms.append("leader")
        storm = rng.choice(tuple(storms))
        if storm == "kill":
            events.append(Ev(rng.randint(1, 3), "proc_kill", {
                "worker": rng.randrange(shards),
                "seam": rng.choice(PROC_KILL_SEAMS),
            }))
        elif storm == "hang":
            events.append(Ev(rng.randint(1, 3), "proc_hang", {
                "worker": rng.randrange(shards),
            }))
        elif storm == "sup":
            at = rng.choice(("idle", "mid_round"))
            t = rng.randint(1, 3)
            events.append(Ev(t, "sup_kill", {"at": at}))
            events.append(Ev(t + 1, "sup_restart", {}))
            ticks = 14
        elif storm == "leader":
            # events[0] holds THIS dict: the solver plane opt-in and
            # the both-shards load floor (the hash topology can land 2
            # distros on one shard, starving the stack) ride along
            workload["distros"] = 6
            workload["tasks"] = 36
            workload["solver"] = "auto"
            workload["solver_timeout_s"] = 6.0
            t = rng.randint(1, 3)
            if rng.random() < 0.5:
                events.append(Ev(t, "leader_kill", {
                    "seam": rng.choice((
                        "solver.round", "solver.publish",
                        "solver.solve", "solver.return",
                    )),
                }))
                events.append(Ev(t + 1, "sup_restart", {}))
            else:
                events.append(Ev(t, "leader_hang", {
                    "seam": "solver.solve", "delay_s": 8.0,
                }))
            ticks = 14
    return ScenarioSpec(
        name=(f"fuzz-proc-sabotage-{seed}" if sabotage
              else f"fuzz-proc-w{seed}"),
        description=(
            f"generated proc weather (seed {seed}): {shards}-shard "
            f"supervised fleet"
            + (", sabotaged dispatch books" if sabotage else "")
        ),
        ticks=ticks,
        seed=int(seed),
        durable=True,
        deterministic=False,
        events=events,
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def weather_strategy(max_seed: int = 2**32 - 1):
    """The generator as a property-testing strategy — hypothesis when
    installed, the seeded stdlib fallback otherwise (never a skip)."""
    try:
        from hypothesis import strategies as st
    except ImportError:
        from ..utils import proptest as st
    return st.builds(
        generate_weather, st.integers(min_value=0, max_value=max_seed)
    )


# --------------------------------------------------------------------------- #
# running + the failure predicate
# --------------------------------------------------------------------------- #


def run_case(spec: ScenarioSpec,
             seed: Optional[int] = None, device=None) -> Dict:
    """Replay one generated weather on the backend its events name; a
    raising replay is a RED entry (the fuzzer treats a crash as a
    failing schedule, never as a skipped one). A missing card or a card
    fault (``KernelError``, ``MirrorError``, a worker's
    ``WorkerExitError``) is no schedule's finding: it raises."""
    from ..device import resolve_device
    from ..ops._build import KernelError
    from ..ops.resident_ops import MirrorError
    from .procs import WorkerExitError

    is_proc = any(e.kind == "proc_fleet" for e in spec.events)
    device = resolve_device(device)
    try:
        from .engine import run_scenario

        if is_proc:
            from .procs import run_proc_scenario

            return run_proc_scenario(spec, seed=seed, device=device)
        return run_scenario(spec, seed=seed, device=device)
    except (KernelError, MirrorError, WorkerExitError):
        raise
    except Exception as exc:  # noqa: BLE001 — the schedule crashed the
        # harness: that IS a finding, and it must shrink like one
        return {
            "name": spec.name,
            "ok": False,
            "seed": spec.seed if seed is None else seed,
            "deterministic": False,
            "error": repr(exc)[:500],
            "invariants": {}, "checks": {}, "slos": {}, "stats": {},
            "fingerprint": "crashed",
        }


def case_fails(spec: ScenarioSpec, device=None) -> bool:
    return not run_case(spec, device=device)["ok"]


def red_keys(entry: Dict) -> List[str]:
    """The failing invariant/check/SLO names of one entry (plus
    "crashed" for a raising replay)."""
    keys = sorted(
        k for sec in ("invariants", "checks", "slos")
        for k, v in entry.get(sec, {}).items() if not v.get("ok")
    )
    if entry.get("error"):
        keys.append("crashed")
    return keys


def fails_matching(keys, device=None) -> Callable[[ScenarioSpec], bool]:
    """A shrink predicate that only accepts reductions reproducing one
    of the ORIGINAL failures — a trimmed timeline that merely starves
    the workload must not replace the finding it was shrunk from."""
    wanted = set(keys)

    def fails(spec: ScenarioSpec) -> bool:
        return bool(wanted & set(red_keys(run_case(spec, device=device))))

    return fails


def proc_fuzz_fingerprint(entry: Dict) -> str:
    """Determinism surface for child-process replays: verdicts and
    converged workload state, not wall-clock shape (round counts and
    dispatch interleavings vary with real scheduling; the contracts the
    fuzzer enforces must not)."""
    return scorecard_entry_fingerprint({
        "name": entry.get("name"),
        "seed": entry.get("seed"),
        "ok": entry.get("ok"),
        "invariants": entry.get("invariants", {}),
        "checks": entry.get("checks", {}),
        "slos": entry.get("slos", {}),
        "unfinished_final": entry.get("stats", {}).get(
            "unfinished_final"
        ),
    })


# --------------------------------------------------------------------------- #
# shrinking
# --------------------------------------------------------------------------- #


def _pinned(ev: Ev) -> bool:
    # the tick-0 fleet/workload IS the world; removing it only proves
    # "no fleet fails differently", never a smaller schedule
    return ev.tick == 0 and ev.kind in ("fleet", "proc_fleet")


class _Budget:
    def __init__(self, max_runs: int) -> None:
        self.left = max_runs

    def spend(self) -> bool:
        if self.left <= 0:
            return False
        self.left -= 1
        return True


def _rebuild(spec: ScenarioSpec, events: List[Ev],
             ticks: Optional[int] = None) -> ScenarioSpec:
    return dataclasses.replace(
        spec, events=list(events),
        ticks=spec.ticks if ticks is None else ticks,
    )


def _ddmin_events(
    spec: ScenarioSpec,
    fails: Callable[[ScenarioSpec], bool],
    budget: _Budget,
) -> List[Ev]:
    """Classic delta debugging over the removable events: drop chunks
    while the failure reproduces, halving granularity until single
    events are irreducible."""
    pinned = [e for e in spec.events if _pinned(e)]
    items = [e for e in spec.events if not _pinned(e)]
    n = 2
    while len(items) >= 1 and n <= len(items) * 2:
        chunk = max(1, len(items) // n)
        reduced = False
        i = 0
        while i < len(items):
            candidate = items[:i] + items[i + chunk:]
            if not budget.spend():
                return pinned + items
            if fails(_rebuild(spec, pinned + candidate)):
                items = candidate
                n = max(2, n - 1)
                reduced = True
            else:
                i += chunk
        if not reduced:
            if n >= len(items):
                break
            n = min(len(items), n * 2)
    return pinned + items


_SHRINKABLE_INTS = ("n", "count", "users")


def _shrink_args(
    spec: ScenarioSpec,
    fails: Callable[[ScenarioSpec], bool],
    budget: _Budget,
) -> ScenarioSpec:
    """Lower numeric event args toward 1 (binary descent) while the
    failure keeps reproducing — a 40-task burst that still fails with 2
    tasks reads like a bug report, not like weather."""
    events = list(spec.events)
    for idx, ev in enumerate(events):
        for key in _SHRINKABLE_INTS:
            val = ev.args.get(key)
            if not isinstance(val, int) or val <= 1:
                continue
            lo, cur = 1, val
            while lo < cur:
                mid = (lo + cur) // 2
                trial = dataclasses.replace(
                    ev, args={**ev.args, key: mid}
                )
                candidate = events[:idx] + [trial] + events[idx + 1:]
                if not budget.spend():
                    return _rebuild(spec, events)
                if fails(_rebuild(spec, candidate)):
                    cur = mid
                    events = candidate
                    ev = trial
                else:
                    lo = mid + 1
    return _rebuild(spec, events)


def _trim_ticks(
    spec: ScenarioSpec,
    fails: Callable[[ScenarioSpec], bool],
    budget: _Budget,
) -> ScenarioSpec:
    last = max((e.tick for e in spec.events), default=0)
    for slack in (2, 4, 8):
        ticks = last + 1 + slack
        if ticks >= spec.ticks:
            break
        if not budget.spend():
            break
        if fails(_rebuild(spec, list(spec.events), ticks=ticks)):
            return _rebuild(spec, list(spec.events), ticks=ticks)
    return spec


def shrink_spec(
    spec: ScenarioSpec,
    fails: Optional[Callable[[ScenarioSpec], bool]] = None,
    max_runs: int = 120,
    device=None,
) -> ScenarioSpec:
    """Reduce a failing weather to a minimal timeline that still fails.

    Runs chunked event removal (ddmin), then numeric arg descent, then
    timeline trimming, re-verifying the failure after every accepted
    step; bounded by ``max_runs`` replays. The result is renamed
    ``<name>-min`` and ready for ``trace.save_regression_spec``. The
    default predicate replays on ``device``."""
    fails = fails or (lambda s: case_fails(s, device=device))
    budget = _Budget(max_runs)
    events = _ddmin_events(spec, fails, budget)
    cur = _rebuild(spec, events)
    cur = _shrink_args(cur, fails, budget)
    cur = _trim_ticks(cur, fails, budget)
    return dataclasses.replace(
        cur,
        name=f"{spec.name}-min",
        description=(
            f"shrunk from {len(spec.events)} events / "
            f"{spec.ticks} ticks to {len(cur.events)} events / "
            f"{cur.ticks} ticks; original: {spec.description}"
        ),
    )


# --------------------------------------------------------------------------- #
# the campaign
# --------------------------------------------------------------------------- #


def campaign(
    time_budget_s: float = 60.0,
    start_seed: int = DEFAULT_CAMPAIGN_SEED,
    max_cases: Optional[int] = None,
    proc: bool = False,
    shrink: bool = True,
    emit_dir: Optional[str] = None,
    progress: Optional[Callable[[Dict], None]] = None,
    device=None,
) -> Dict:
    """Time-boxed randomized-weather soak: enumerate seeds from
    ``start_seed``, replay each weather, shrink any failure and emit it
    as a regression spec. Returns the campaign report; ``ok`` means
    zero invariant violations found (sabotage runs EXPECT failures and
    invert this). Replays run on ``device``."""
    from . import trace

    t0 = _time.monotonic()
    gen = generate_proc_weather if proc else generate_weather
    failures: List[Dict] = []
    cases = 0
    while _time.monotonic() - t0 < time_budget_s:
        if max_cases is not None and cases >= max_cases:
            break
        seed = start_seed + cases
        spec = gen(seed)
        entry = run_case(spec, device=device)
        cases += 1
        if progress is not None:
            progress({"seed": seed, "name": spec.name,
                      "ok": entry["ok"]})
        if entry["ok"]:
            continue
        finding: Dict = {
            "seed": seed,
            "name": spec.name,
            "events": len(spec.events),
            "error": entry.get("error", ""),
            "red": red_keys(entry),
        }
        if shrink:
            minimal = shrink_spec(
                spec, fails=fails_matching(finding["red"], device=device)
            )
            finding["shrunk_events"] = len(minimal.events)
            finding["shrunk_ticks"] = minimal.ticks
            if emit_dir is not None:
                finding["regression_spec"] = trace.save_regression_spec(
                    minimal, out_dir=emit_dir, lossy=True,
                )
        failures.append(finding)
    return {
        "backend": "procs" if proc else "engine",
        "start_seed": start_seed,
        "cases": cases,
        "elapsed_s": round(_time.monotonic() - t0, 2),
        "failures": failures,
        "ok": not failures,
    }


def sabotage_selftest(proc: bool = False,
                      seed: int = DEFAULT_CAMPAIGN_SEED,
                      device=None) -> Dict:
    """The self-test the gate trusts before any green campaign: a
    deliberately seeded invariant violation must be FOUND, shrink to a
    minimal timeline, and replay deterministically (same seed ⇒
    fingerprint-identical scorecard) on its backend. Replays run on
    ``device``."""
    gen = generate_proc_weather if proc else generate_weather
    spec = gen(seed, sabotage=True)
    entry = run_case(spec, device=device)
    caught = not entry["ok"]
    result: Dict = {
        "backend": "procs" if proc else "engine",
        "seed": seed,
        "caught": caught,
        "red": red_keys(entry),
    }
    if not caught:
        result["ok"] = False
        return result
    minimal = shrink_spec(
        spec, fails=fails_matching(result["red"], device=device),
        max_runs=40 if proc else 120,
    )
    result["shrunk_events"] = len(minimal.events)
    result["shrunk_ticks"] = minimal.ticks
    e1 = run_case(minimal, device=device)
    e2 = run_case(minimal, device=device)
    if proc:
        f1, f2 = proc_fuzz_fingerprint(e1), proc_fuzz_fingerprint(e2)
    else:
        f1, f2 = e1.get("fingerprint"), e2.get("fingerprint")
    result["still_caught"] = bool(
        set(result["red"]) & set(red_keys(e1))
    )
    result["deterministic"] = bool(f1) and f1 == f2
    result["fingerprint"] = f1
    result["ok"] = (
        caught and result["still_caught"] and result["deterministic"]
    )
    return result
