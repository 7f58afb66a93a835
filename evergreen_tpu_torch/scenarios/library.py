"""The shipped scenario library: the weathers and one sabotage.

A copy of ``evergreen_tpu/scenarios/library.py``. ``PROC_WEATHERS``
holds the library's one process-backend weather, ``leader-death``, which
runs worker processes under ``scenarios/procs.py`` (``run_proc_scenario``)
and cannot run in the engine.

Each spec is a declarative timeline over the engine's event vocabulary
(scenarios/engine.py) plus named checks for the assertions the SLO
vocabulary cannot express. Every weather is deterministic: same seed ⇒
same scorecard fingerprint.

  merge-queue-storm   conflicting patch stacks racing one project, a
                      mid-stack failure blocking its tail
  dag-stepback        deep dependency DAG, mid-build failure, stepback
                      activation of the prior revision's task
  spot-reclamation    mixed EC2-fleet(spot)/docker/static fleet; spot
                      instances reclaimed mid-task
  region-failover     lease stolen between begin_tick and the group
                      flush; the engine fails over to the thief's epoch
  spawn-burst         interactive spawn-host burst beside CI load, then
                      the expiry sweep reaps the fleet
  seasonality         a week compressed to minutes: arrivals + backlog
                      gauges drive GREEN→…→BLACK→…→GREEN with counted
                      shedding and a green landing
  disk-bitrot-snapshot  a published snapshot silently rots on disk: the
                      scrub detects the digest mismatch, quarantines
                      the file and rebuilds a verified checkpoint while
                      serving never stops
  disk-enospc-commit  the disk fills at a WAL group commit: the frame
                      is shed loudly (RED floor) instead of raising
                      mid-commit, and the first accepted frame heals
                      durability back to GREEN
"""
from __future__ import annotations

from typing import Dict, Optional

from ..globals import HostStatus, Provider, Requester, TaskStatus
from .spec import Ev, SLO, ScenarioSpec

# --------------------------------------------------------------------------- #
# checks
# --------------------------------------------------------------------------- #


def _check_merge_before_patch(run) -> Optional[str]:
    """Merge-queue entries must outrank plain patches: the first merge
    dispatch happens no later than the first patch dispatch."""
    merge_ticks = [
        t for tid, t in run.dispatch_tick.items() if "-stack" in tid
    ]
    patch_ticks = [
        t for tid, t in run.dispatch_tick.items() if "-patch" in tid
    ]
    if not merge_ticks or not patch_ticks:
        return "storm never dispatched both classes"
    if min(merge_ticks) > min(patch_ticks):
        return (
            f"first merge dispatch at tick {min(merge_ticks)} after "
            f"first patch dispatch at tick {min(patch_ticks)}"
        )
    return None


def _check_blocked_tail(run) -> Optional[str]:
    """The failed stack entry's dependents must stay blocked, never
    dispatched over an unattainable dependency."""
    for tid in ("dmq-stackB-02", "dmq-stackB-03"):
        doc = run.store.collection("tasks").get(tid)
        if doc is None:
            return f"{tid} missing"
        if doc["status"] != TaskStatus.UNDISPATCHED.value:
            return f"{tid} ran over a failed dependency: {doc['status']}"
    return None


STEPBACK_TARGET = "dsb-int-09"


def _check_stepback_scheduled(run) -> Optional[str]:
    """The stepback-activated task was scheduled AND the packed solve's
    t_stepback provenance column flagged it (the provenance riding the
    result buffer)."""
    doc = run.store.collection("tasks").get(STEPBACK_TARGET)
    if doc is None or not doc.get("activated"):
        return "stepback target never activated"
    if doc.get("activated_by") != "stepback-activator":
        return f"activated by {doc.get('activated_by')!r}, not stepback"
    if STEPBACK_TARGET not in run.dispatch_tick:
        return "stepback task never dispatched"
    for res in run.tick_results:
        prov = getattr(res, "provenance", None)
        if prov is None:
            continue
        terms = prov.explain("dsb", STEPBACK_TARGET)
        if terms is not None:
            if not terms.get("stepback"):
                return "provenance shows stepback=False for the target"
            if terms.get("rank_term", 0.0) < 10.0:
                return (
                    "stepback rank term missing its factor boost: "
                    f"{terms.get('rank_term')}"
                )
            run.stats["stepback_rank_term"] = terms["rank_term"]
            return None
    return "stepback task never appeared in solve provenance"


def _check_stepback_dedup(run) -> Optional[str]:
    """Re-delivering the failure (a recovery re-run of mark_end's
    stepback evaluation) must not activate a second task."""
    from ..models import task as task_mod
    from ..models.lifecycle import evaluate_stepback

    failed = task_mod.get(run.store, "dsb-int-10")
    if failed is None:
        return "failed task missing"
    evaluate_stepback(run.store, failed, run.now)  # the re-delivery
    n = run.store.collection("events").count(
        lambda d: d.get("event_type") == "TASK_ACTIVATED_STEPBACK"
    )
    if n != 1:
        return f"stepback activated {n} times (dedup broken)"
    return None


def _check_no_stranded_claims(run) -> Optional[str]:
    """A terminated host must never keep a running_task claim (the
    stranded-dispatch-claim gap the reclamation scenario exists to
    catch)."""
    for doc in run.store.collection("hosts").find(
        lambda d: d["status"] == HostStatus.TERMINATED.value
    ):
        if doc.get("running_task"):
            return (
                f"terminated host {doc['_id']} still claims "
                f"{doc['running_task']}"
            )
    return None


def _check_reclaimed_restart_credits(run) -> Optional[str]:
    """Each reclaimed-mid-task execution is archived as a system failure
    and charged exactly one automatic-restart credit."""
    reclaimed = run.counter_delta("cloud.spot_reclaimed")
    reset = run.counter_delta("recovery.stranded_reset")
    if reset != reclaimed:
        return (
            f"{reclaimed} reclamations but {reset} restart-credited "
            "resets"
        )
    return None


def _check_mixed_fleet(run) -> Optional[str]:
    """The fleet really is mixed: ec2-spot, docker containers, and
    static hosts all ran work."""
    for distro in ("dspot", "ddock", "dstatic"):
        if not any(
            tid.startswith(distro) for tid in run.dispatch_tick
        ):
            return f"{distro} never dispatched a task"
    return None


def _check_failover_resumes(run) -> Optional[str]:
    """After the fenced tick, the thief's very next tick must plan
    cleanly at a strictly higher epoch."""
    fenced_at = next(
        (
            i for i, r in enumerate(run.tick_results)
            if r.degraded == "fenced"
        ),
        None,
    )
    if fenced_at is None:
        return "no tick was fenced"
    if fenced_at + 1 >= len(run.tick_results):
        return "run ended at the fenced tick"
    after = run.tick_results[fenced_at + 1]
    if after.degraded:
        return f"post-failover tick degraded: {after.degraded!r}"
    if run.epochs[fenced_at + 1] <= run.epochs[fenced_at]:
        return (
            f"failover did not raise the epoch: "
            f"{run.epochs[fenced_at]} -> {run.epochs[fenced_at + 1]}"
        )
    run.stats["failover_downtime_ticks"] = 1
    return None


def _check_spawn_lifecycle(run) -> Optional[str]:
    """Every spawn host reached RUNNING during the burst and was reaped
    by the expiry sweep after the clock jump."""
    hosts = run.store.collection("hosts").find(
        lambda d: d.get("user_host")
    )
    if len(hosts) != 40:
        return f"expected 40 spawn hosts, found {len(hosts)}"
    ran = sum(1 for d in hosts if d.get("provision_time") or d.get(
        "start_time"
    ))
    run.stats["spawn_hosts_started"] = ran
    not_reaped = [
        d["_id"] for d in hosts
        if d["status"] != HostStatus.TERMINATED.value
    ]
    if not_reaped:
        return (
            f"{len(not_reaped)} spawn hosts survived expiry "
            f"(e.g. {not_reaped[0]})"
        )
    return None


def _check_ladder_cycle(run) -> Optional[str]:
    """The full GREEN→…→BLACK→…→GREEN cycle, in order."""
    levels = [r.overload for r in run.tick_results]
    try:
        i_black = levels.index("black")
    except ValueError:
        return f"never reached BLACK (saw {sorted(set(levels))})"
    if "green" not in levels[:i_black]:
        return "did not start GREEN"
    if "green" not in levels[i_black:]:
        return "never recovered to GREEN after BLACK"
    run.stats["ticks_to_recover_green"] = (
        levels[i_black:].index("green")
    )
    return None


def _check_outbox_cap_held(run) -> Optional[str]:
    undelivered = run.store.collection("slack_outbox").count(
        lambda d: not d.get("delivered") and not d.get("failed")
    )
    if undelivered > 400:
        return f"outbox cap breached: {undelivered} undelivered"
    return None


def _sabotage_duplicate_claim(run) -> None:
    """Deliberately corrupt the dispatch books — duplicate a host's
    running-task claim bypassing the CAS — so the invariant layer must
    catch it (the gate's self-test that a violation fails CI)."""
    hosts = sorted(
        (
            d for d in run.store.collection("hosts").find()
            if d.get("running_task")
        ),
        key=lambda d: d["_id"],
    )
    free = sorted(
        (
            d for d in run.store.collection("hosts").find()
            if not d.get("running_task")
        ),
        key=lambda d: d["_id"],
    )
    if hosts and free:
        run.store.collection("hosts").update(
            free[0]["_id"], {"running_task": hosts[0]["running_task"]}
        )


# --------------------------------------------------------------------------- #
# the six weathers
# --------------------------------------------------------------------------- #


def _merge_queue_storm() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dmq", "provider": Provider.MOCK.value, "hosts": 6},
        ]}),
        Ev(0, "tasks", {
            "distro": "dmq", "n": 12, "prefix": "dmq-patch",
            "requester": Requester.PATCH.value,
        }),
        Ev(0, "merge_stack", {"distro": "dmq", "stack": "stackA", "n": 4}),
        Ev(1, "merge_stack", {"distro": "dmq", "stack": "stackB", "n": 4}),
        Ev(1, "merge_stack", {"distro": "dmq", "stack": "stackC", "n": 4}),
        # the storm's conflict: stackB's second entry breaks mid-merge
        Ev(2, "fail_next", {"match": "dmq-stackB-01", "count": 1}),
    ]
    return ScenarioSpec(
        name="merge-queue-storm",
        description="conflicting merge-queue patch stacks racing one "
                    "project; a mid-stack failure blocks exactly its "
                    "tail while siblings merge through",
        ticks=16,
        events=events,
        slos=[
            SLO("one-conflict-failure", "tasks_failed", "==", 1),
            # everything except the broken stack's 2-entry tail finishes
            SLO("storm-drains", "tasks_unfinished", "==", 2),
            SLO("no-system-failures", "tasks_system_failed", "==", 0),
        ],
        checks=[
            ("merge-prioritized", _check_merge_before_patch),
            ("failed-stack-tail-blocked", _check_blocked_tail),
        ],
    )


def _dag_stepback() -> ScenarioSpec:
    # mainline history: revision 9 (all inactive — already built) and
    # revision 10 (activated), each a 4-deep DAG
    def rev(order: int, activated: bool):
        s = f"{order:02d}"
        return [
            {"id": f"dsb-compile-{s}", "display_name": "compile",
             "revision_order": order, "activated": activated},
            {"id": f"dsb-unit-{s}", "display_name": "unit",
             "revision_order": order, "activated": activated,
             "deps": [f"dsb-compile-{s}"]},
            {"id": f"dsb-int-{s}", "display_name": "integration",
             "revision_order": order, "activated": activated,
             "deps": [] if not activated else [f"dsb-unit-{s}"]},
            {"id": f"dsb-pkg-{s}", "display_name": "package",
             "revision_order": order, "activated": activated,
             "deps": [f"dsb-int-{s}"]},
        ]

    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dsb", "provider": Provider.MOCK.value, "hosts": 4},
        ]}),
        Ev(0, "dag", {"distro": "dsb", "nodes": rev(9, False)}),
        Ev(0, "dag", {"distro": "dsb", "nodes": rev(10, True)}),
        # integration-10 fails mid-build → linear stepback must activate
        # integration-09 (undispatched, inactive, prior revision)
        Ev(0, "fail_next", {"match": "dsb-int-10", "count": 1}),
    ]
    return ScenarioSpec(
        name="dag-stepback",
        description="deep dependency DAG; a mid-build failure triggers "
                    "stepback activation of the prior revision's task, "
                    "prioritized by the packed solve's t_stepback term "
                    "and deduplicated on re-replay",
        ticks=12,
        events=events,
        slos=[
            SLO("one-stepback", "stepback_activations", "==", 1),
            SLO("one-failure", "tasks_failed", "==", 1),
            # pkg-10 blocks on the failed integration; everything else
            # (rev-10 chain + the stepback target) runs
            SLO("dag-progresses", "tasks_unfinished", "<=", 7),
        ],
        checks=[
            ("stepback-scheduled-and-ranked", _check_stepback_scheduled),
            ("stepback-dedup-on-replay", _check_stepback_dedup),
        ],
    )


def _spot_reclamation() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dstatic", "provider": Provider.STATIC.value,
             "hosts": 4},
            # container-pool parents host containers instead of running
            # tasks — their own distro, like production pools
            {"id": "dparent", "provider": Provider.STATIC.value,
             "hosts": 2, "has_containers": True},
            {"id": "dspot", "provider": Provider.EC2_FLEET.value,
             "hosts": 0,
             "provider_settings": {"fleet_use_spot": True,
                                   "instance_type": "m5.large"}},
            {"id": "ddock", "provider": Provider.DOCKER.value,
             "hosts": 0, "container_pool": "pool1"},
        ]}),
        Ev(0, "container_pools", {"pools": [
            {"id": "pool1", "distro": "dparent", "max_containers": 2},
        ]}),
        Ev(0, "grow_fleet", {"distro": "dspot", "n": 6}),
        Ev(0, "grow_fleet", {"distro": "ddock", "n": 3}),
        Ev(1, "tasks", {"distro": "dspot", "n": 18, "prefix": "dspot-t"}),
        Ev(1, "tasks", {"distro": "dstatic", "n": 8,
                        "prefix": "dstatic-t"}),
        Ev(1, "tasks", {"distro": "ddock", "n": 6, "prefix": "ddock-t"}),
        # mid-run, AWS takes three busy spot instances back
        Ev(4, "spot_reclaim", {"n": 3, "distro": "dspot"}),
        # replacement capacity arrives two ticks later
        Ev(6, "grow_fleet", {"distro": "dspot", "n": 3}),
    ]
    return ScenarioSpec(
        name="spot-reclamation",
        description="mixed EC2-fleet(spot)/docker/static fleet; spot "
                    "instances reclaimed mid-task must route through "
                    "reset-or-system-fail with restart credits and no "
                    "stranded dispatch claim",
        ticks=18,
        events=events,
        slos=[
            SLO("reclaimed", "spot_reclaimed", "==", 3),
            SLO("reclaimed-tasks-restarted", "restarts_total", "==", 3),
            SLO("no-credit-exhaustion", "tasks_system_failed", "==", 0),
            SLO("everything-finishes", "tasks_unfinished", "==", 0),
        ],
        checks=[
            ("mixed-fleet-all-ran", _check_mixed_fleet),
            ("no-stranded-claims", _check_no_stranded_claims),
            ("restart-credit-accounting",
             _check_reclaimed_restart_credits),
        ],
    )


def _region_failover() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dreg", "provider": Provider.MOCK.value, "hosts": 4},
        ]}),
        Ev(0, "tasks", {"distro": "dreg", "n": 16, "prefix": "dreg-a"}),
        # the steal lands between begin_tick and the group flush of
        # tick 2's commit (the wal.fence machinery)
        Ev(2, "lease_steal", {}),
        Ev(4, "tasks", {"distro": "dreg", "n": 8, "prefix": "dreg-b"}),
    ]
    return ScenarioSpec(
        name="region-failover",
        description="writer lease stolen mid-tick (region failover): "
                    "the fenced holder sheds its tick, the thief "
                    "resumes at a higher epoch, and the WAL replays to "
                    "the same converged state",
        ticks=12,
        durable=True,
        events=events,
        slos=[
            SLO("one-fenced-tick", "fenced_ticks", "==", 1),
            SLO("one-failover", "failovers", "==", 1),
            SLO("work-survives", "tasks_unfinished", "==", 0),
        ],
        checks=[
            ("failover-resumes-next-tick", _check_failover_resumes),
        ],
    )


def _spawn_burst() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dci", "provider": Provider.MOCK.value, "hosts": 5},
            {"id": "dws", "provider": Provider.EC2_FLEET.value,
             "hosts": 0,
             "provider_settings": {"fleet_use_spot": False,
                                   "instance_type": "c5.xlarge"}},
        ]}),
        Ev(0, "tasks", {"distro": "dci", "n": 20, "prefix": "dci-t"}),
        Ev(1, "spawn_burst", {"distro": "dws", "users": 25}),
        Ev(2, "spawn_burst", {"distro": "dws", "users": 15,
                              "prefix": "late"}),
        # day over: jump past the 24h default expiration; the expiry
        # sweep must reap the whole interactive fleet
        Ev(8, "advance_clock", {"s": 25 * 3600.0}),
    ]
    return ScenarioSpec(
        name="spawn-burst",
        description="interactive spawn-host burst (40 workstations in "
                    "two waves) beside CI load: all provision to "
                    "RUNNING, CI planning is untouched, and the expiry "
                    "sweep reaps them after the compressed day",
        ticks=12,
        events=events,
        slos=[
            SLO("ci-unaffected", "tasks_unfinished", "==", 0),
            SLO("no-failures", "tasks_failed", "==", 0),
        ],
        checks=[
            ("spawn-lifecycle", _check_spawn_lifecycle),
        ],
    )


def _seasonality() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dsea", "provider": Provider.MOCK.value, "hosts": 6},
        ]}),
    ]
    # a commuter week in 36 ticks: (arrivals, queue-backlog gauge,
    # outbox burst) per phase — the backlog gauge is the declarative
    # stand-in for the job plane's pending depth under that traffic
    phases = [
        (range(0, 6), 2, 10.0, 0),      # overnight
        (range(6, 11), 4, 80.0, 0),     # morning ramp → YELLOW
        (range(11, 16), 6, 160.0, 60),  # storm → RED
        (range(16, 19), 4, 300.0, 150),  # peak → BLACK
        (range(19, 25), 2, 100.0, 0),   # decline
        (range(25, 33), 1, 5.0, 0),     # calm
        (range(33, 36), 0, 5.0, 0),     # idle tail → the week drains
    ]
    for ticks, arrivals, backlog, outbox in phases:
        for t in ticks:
            if arrivals:
                events.append(Ev(t, "tasks", {
                    "distro": "dsea", "n": arrivals,
                    "prefix": f"dsea-w{t:02d}",
                }))
            events.append(Ev(t, "gauge", {
                "name": "queue_pending", "value": backlog,
            }))
            if outbox:
                events.append(Ev(t, "outbox", {"n": outbox}))
            if not outbox and t >= 19:
                events.append(Ev(t, "drain_outbox", {}))
    return ScenarioSpec(
        name="seasonality",
        description="a week compressed to minutes: arrivals and backlog "
                    "gauges drive the ladder GREEN→YELLOW→RED→BLACK and "
                    "back, with stats/events shed (and counted) at the "
                    "peak and a green landing",
        ticks=36,
        events=events,
        overload={
            "queue_pending_levels": [50.0, 120.0, 250.0],
            "outbox_depth_levels": [60.0, 150.0, 280.0],
            "outbox_cap": 400,
            "hysteresis_ticks": 2,
        },
        slos=[
            SLO("reaches-black", "max_overload_level", "==", 3),
            SLO("lands-green", "ended_green", "truthy", 1),
            SLO("sheds-are-counted", "sheds_total", ">=", 1),
            SLO("week-drains", "tasks_unfinished", "==", 0),
        ],
        checks=[
            ("full-ladder-cycle", _check_ladder_cycle),
            ("outbox-cap-held", _check_outbox_cap_held),
        ],
    )


# --------------------------------------------------------------------------- #
# capacity-plane weathers
# --------------------------------------------------------------------------- #


def _capacity_recorder(rec):
    """`call` event fn: wrap the (store-cached) CapacityPlane.apply so
    every tick's heuristic-in / decision-out pair lands in ``rec`` —
    including whether the plane fell back by returning the heuristic
    dict ITSELF (the bit-identity the breaker gate pins)."""

    def install(run):
        from ..scheduler.capacity_plane import capacity_plane_for

        plane = capacity_plane_for(run.store)
        orig = plane.apply

        def recording_apply(distros, infos, new_hosts, hosts_by_distro,
                            now, **kw):
            before = dict(new_hosts)
            out = orig(distros, infos, new_hosts, hosts_by_distro, now,
                       **kw)
            rec.append({
                "tick": run.tick,
                "in": before,
                "out": dict(out),
                "identity_fallback": out is new_hosts,
                "existing": {
                    d.id: len(hosts_by_distro.get(d.id, []))
                    for d in distros
                },
            })
            return out

        plane.apply = recording_apply

    return install


def _set_capacity_config(**fields):
    def fn(run):
        from ..settings import CapacityConfig

        cfg = CapacityConfig.get(run.store)
        import dataclasses as _dc

        _dc.replace(cfg, **fields).set(run.store)

    return fn


def _cap_share(entries, distro):
    """``distro``'s share of all capacity intents granted in ``entries``
    (0.0 when no intents were granted at all)."""
    total = sum(sum(e["out"].values()) for e in entries)
    mine = sum(e["out"].get(distro, 0) for e in entries)
    return (mine / total) if total else 0.0


def _capacity_price_spike(spike_tick: int = 6) -> ScenarioSpec:
    rec = []

    def check_solver_ran(run) -> Optional[str]:
        applied = [e for e in rec if not e["identity_fallback"]]
        pre = [e for e in applied if e["tick"] < spike_tick]
        post = [e for e in applied if e["tick"] >= spike_tick]
        if not pre or not post:
            return (f"capacity solve must run on both sides of the "
                    f"spike (pre={len(pre)}, post={len(post)})")
        return None

    def check_retraded(run) -> Optional[str]:
        applied = [e for e in rec if not e["identity_fallback"]]
        pre = _cap_share(
            [e for e in applied if e["tick"] < spike_tick], "dpricey"
        )
        post = _cap_share(
            [e for e in applied if e["tick"] >= spike_tick], "dpricey"
        )
        if pre <= 0.0:
            return "pricey pool got nothing even at par pricing"
        if post >= pre:
            return (f"price spike did not move capacity off the pricey "
                    f"pool (share {pre:.2f} -> {post:.2f})")
        return None

    def check_no_fallbacks(run) -> Optional[str]:
        bad = [e["tick"] for e in rec if e["identity_fallback"]]
        if bad:
            return f"capacity plane fell back on ticks {bad}"
        return None

    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dcheap", "provider": Provider.MOCK.value, "hosts": 2,
             "planner": {"capacity": "tpu"}, "max_hosts": 30},
            {"id": "dpricey", "provider": Provider.EC2_FLEET.value,
             "hosts": 2, "planner": {"capacity": "tpu"}, "max_hosts": 30,
             "provider_settings": {"fleet_use_spot": False}},
        ]}),
        Ev(0, "call", {"fn": _capacity_recorder(rec)}),
        # symmetric steady demand: with pools at par the solver splits
        # the shared intent budget roughly evenly
        *[Ev(t, "tasks", {"distro": d, "n": 8, "expected_s": 1800.0,
                          "prefix": f"{d}-w{t}"})
          for t in (1, 3, 5, 7, 9)
          for d in ("dcheap", "dpricey")],
        # tick `spike_tick`: the pricey pool's $/host-hour jumps 30x —
        # the next solve must re-trade the budget toward the cheap pool
        Ev(spike_tick, "call", {"fn": _set_capacity_config(
            pool_prices={"mock": 1.0, "ec2-fleet": 30.0},
            price_weight=0.2,
        )}),
    ]
    return ScenarioSpec(
        name="capacity-price-spike",
        description="two capacity-opted distros on different provider "
                    "pools under one fleet intent budget; a 30x price "
                    "spike on one pool mid-run must re-trade capacity "
                    "toward the cheap pool with zero solver fallbacks",
        ticks=12,
        events=events,
        slos=[],
        checks=[
            ("solver-ran-both-sides", check_solver_ran),
            ("spike-retrades-pools", check_retraded),
            ("zero-capacity-fallbacks", check_no_fallbacks),
        ],
        tick_options={"create_intent_hosts": True},
        config={"CapacityConfig": {
            "pool_prices": {"mock": 1.0, "ec2-fleet": 1.0},
            "price_weight": 0.2,
            "fleet_intent_budget": 6,
        }},
    )


def _capacity_quota_squeeze(
    squeeze_tick: int = 4, fault_tick: int = 11
) -> ScenarioSpec:
    rec = []
    quota_after = 8
    pool_distros = ("ddeep", "dshallow")

    def _headroom(e):
        return max(
            0, quota_after - sum(e["existing"].get(d, 0)
                                 for d in pool_distros)
        )

    def check_feasible(run) -> Optional[str]:
        # the deliberate capacity.solve fault at `fault_tick` is the ONE
        # allowed fallback; the squeeze itself must never cause one
        bad = [e["tick"] for e in rec
               if e["identity_fallback"] and e["tick"] != fault_tick]
        if bad:
            return f"quota squeeze broke feasibility on ticks {bad}"
        return None

    def check_quota_respected(run) -> Optional[str]:
        # post-squeeze the solver may only grant what the squeezed
        # quota leaves over the EXISTING fleet (hosts the quota change
        # cannot un-spawn drain through drawdown, not through the solve)
        for e in rec:
            if e["tick"] <= squeeze_tick or e["identity_fallback"]:
                continue
            granted = sum(e["out"].get(d, 0) for d in pool_distros)
            if granted > _headroom(e):
                return (f"tick {e['tick']}: granted {granted} new hosts "
                        f"over headroom {_headroom(e)} of the squeezed "
                        f"quota {quota_after}")
        return None

    def check_squeeze_binds(run) -> Optional[str]:
        # the squeeze must be VISIBLE: at least one post-squeeze solve
        # where the heuristic asked for more than the headroom and the
        # solver held the line (otherwise this weather proves nothing)
        for e in rec:
            if e["tick"] <= squeeze_tick or e["identity_fallback"]:
                continue
            asked = sum(e["in"].get(d, 0) for d in pool_distros)
            granted = sum(e["out"].get(d, 0) for d in pool_distros)
            if asked > _headroom(e) and granted <= _headroom(e) < asked:
                return None
        return ("no post-squeeze tick where demand exceeded the "
                "squeezed quota's headroom — the squeeze never bound")

    def check_deep_outbids_shallow(run) -> Optional[str]:
        solved = [e for e in rec if not e["identity_fallback"]]
        deep = sum(e["out"].get("ddeep", 0) for e in solved)
        shallow = sum(e["out"].get("dshallow", 0) for e in solved)
        if deep <= shallow:
            return (f"inside the shared pool the deep backlog must "
                    f"outbid the shallow one (deep={deep}, "
                    f"shallow={shallow})")
        return None

    def check_fallback_bit_identical(run) -> Optional[str]:
        falls = [e for e in rec if e["tick"] == fault_tick]
        if not falls:
            return f"no capacity call recorded on fault tick {fault_tick}"
        e = falls[0]
        if not e["identity_fallback"]:
            return "the injected capacity.solve fault did not fall back"
        if e["out"] != e["in"]:
            return ("fallback altered the heuristic counts — the "
                    "bit-identical contract is broken")
        return None

    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "ddeep", "provider": Provider.MOCK.value, "hosts": 2,
             "planner": {"capacity": "tpu"}, "max_hosts": 40},
            {"id": "dshallow", "provider": Provider.MOCK.value, "hosts": 2,
             "planner": {"capacity": "tpu"}, "max_hosts": 40},
        ]}),
        Ev(0, "call", {"fn": _capacity_recorder(rec)}),
        # asymmetric backlogs inside ONE provider pool: a deep queue of
        # long tasks vs a shallow queue of short ones
        *[Ev(t, "tasks", {"distro": "ddeep", "n": 14,
                          "expected_s": 2400.0, "prefix": f"ddeep-w{t}"})
          for t in (1, 3)],
        *[Ev(t, "tasks", {"distro": "dshallow", "n": 3,
                          "expected_s": 600.0, "prefix": f"dshallow-w{t}"})
          for t in (1, 3)],
        # tick `squeeze_tick`: the shared pool quota collapses 24 -> 8
        # (below the fleet the generous quota already built); the solver
        # must keep every later grant inside the shrunken headroom
        # without ever going infeasible
        Ev(squeeze_tick, "call", {"fn": _set_capacity_config(
            pool_quotas={"mock": quota_after},
        )}),
        # post-squeeze demand storms that the heuristic would chase with
        # new hosts — the squeezed quota must hold the line
        *[Ev(t, "tasks", {"distro": "ddeep", "n": 30,
                          "expected_s": 2400.0, "prefix": f"ddeep-s{t}"})
          for t in (6, 9)],
        # tick `fault_tick`: a raising capacity solve — the plane must
        # hand back the heuristic's counts bit-identically
        Ev(fault_tick, "fault", {"seam": "capacity.solve"}),
    ]
    return ScenarioSpec(
        name="capacity-quota-squeeze",
        description="two capacity-opted distros sharing one provider "
                    "pool; the pool quota collapses mid-run (solver "
                    "keeps trading inside the smaller box, deep backlog "
                    "outbids shallow) and an injected solve fault must "
                    "fall back to bit-identical heuristic counts",
        ticks=12,
        events=events,
        slos=[],
        checks=[
            ("squeeze-stays-feasible", check_feasible),
            ("squeezed-quota-respected", check_quota_respected),
            ("squeeze-binds", check_squeeze_binds),
            ("deep-backlog-outbids-shallow", check_deep_outbids_shallow),
            ("fallback-bit-identical", check_fallback_bit_identical),
        ],
        tick_options={"create_intent_hosts": True},
        config={"CapacityConfig": {
            "pool_quotas": {"mock": 24},
        }},
    )


def _leader_death() -> ScenarioSpec:
    """The shipped solver-leader weather (proc backend, distinct from
    the crash-matrix points): the fleet loses its BRAIN and then a
    HAND in one run. The supervisor (= elected solver-leader) dies at
    the stacked-solve seam; both workers degrade to local and orphan;
    the successor adopts them and re-elects the solver lease at a
    strictly higher epoch; then a worker is SIGKILLed at a WAL seam —
    its fenced replacement must rejoin the shared-memory plane and the
    fleet must return to fully stacked rounds with zero stale results
    and zero leaked segments."""
    from .procs import (
        _SOLVER_WORKLOAD,
        _check_solver_survived,
        DEFAULT_PROC_INVARIANTS,
        ProcScenarioRun,
    )

    def worker_rejoined(run: "ProcScenarioRun") -> Optional[str]:
        # the victim is an ADOPTED process: the successor holds no
        # Popen for it, so its exit code (86) is unobservable — the
        # restart plus its OWN stacked reply after the kill tick are
        # the proof it died and the replacement rejoined the shm plane
        if run.stats.get("restarts_total", 0) < 1:
            return "the killed worker was never restarted"
        if not any(
            rnd.get(1, {}).get("solve") == "stacked"
            for i, rnd in enumerate(run.rounds) if i > 5
        ):
            return (
                "the replacement worker never published into a "
                "stacked round after the kill tick"
            )
        return _check_solver_survived(run)

    return ScenarioSpec(
        name="leader-death",
        description="2-shard solver fleet: the leader dies at the "
                    "stacked solve, the successor adopts and "
                    "re-elects; then a worker is SIGKILLed — its "
                    "fenced replacement rejoins the shm plane and "
                    "stacked rounds resume",
        ticks=16,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", dict(_SOLVER_WORKLOAD)),
            Ev(2, "leader_kill", {"seam": "solver.solve"}),
            Ev(3, "sup_restart", {}),
            Ev(5, "proc_kill", {"worker": 1, "seam": "wal.commit"}),
        ],
        slos=[
            SLO("bounded-restarts", "restarts_total", "<=", 3),
        ],
        checks=[("worker-rejoined-after-leader-death",
                 worker_rejoined)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


#: proc-backed weathers shipped with the library: these run real
#: worker processes (``run_proc_scenario``), replayed alongside
#: PROC_SCENARIOS — the engine cannot host them
PROC_WEATHERS: Dict[str, callable] = {
    "leader-death": _leader_death,
}


def _check_snapshot_healed(run) -> Optional[str]:
    """The rotted snapshot was quarantined (forensics kept), a verified
    checkpoint replaced it, and the published pair passes its digest."""
    import os

    from ..storage import integrity as integrity_mod
    from ..storage.durable import SNAPSHOT_FILE

    if run.counter_delta("storage.snapshot_quarantined") != 1:
        return (
            f"{run.counter_delta('storage.snapshot_quarantined')} "
            "snapshots quarantined (want exactly the injected one)"
        )
    if run.counter_delta("storage.rebuilds") < 1:
        return "no self-heal rebuild was counted"
    if not any(
        name.startswith(SNAPSHOT_FILE + ".corrupt-")
        for name in os.listdir(run.data_dir)
    ):
        return "no .corrupt-<ts> forensic file kept beside the store"
    snap = os.path.join(run.data_dir, SNAPSHOT_FILE)
    meta = _read_json(snap + ".meta")
    if meta is None:
        return "healed snapshot has no .meta sidecar"
    if meta.get("crc") != integrity_mod.file_crc32(snap):
        return "healed snapshot does not match its recorded digest"
    return None


def _read_json(path) -> Optional[dict]:
    import json

    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _check_enospc_shed_healed(run) -> Optional[str]:
    """The full disk shed exactly one group loudly (breadcrumbs both
    ways), and durability healed — shed writes re-covered by checkpoint,
    floor released."""
    if run.counter_delta("storage.enospc_sheds") != 1:
        return (
            f"{run.counter_delta('storage.enospc_sheds')} ENOSPC sheds "
            "(want exactly the injected one)"
        )
    shed = [r for r in run.logs if r.get("message") == "wal-enospc-shed"]
    healed = [
        r for r in run.logs if r.get("message") == "wal-enospc-healed"
    ]
    if not shed:
        return "no wal-enospc-shed breadcrumb"
    if not healed:
        return "durability never healed after the shed"
    return None


def _disk_bitrot_snapshot() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "drot", "provider": Provider.MOCK.value, "hosts": 4},
        ]}),
        Ev(0, "tasks", {"distro": "drot", "n": 8, "prefix": "drot-t"}),
        # arms snapshot.write:bitrot, forces a checkpoint next tick (the
        # rot lands on the PUBLISHED file), and scrubs the tick after
        Ev(2, "disk_fault", {"target": "snapshot", "kind": "bitrot"}),
        Ev(6, "tasks", {"distro": "drot", "n": 4, "prefix": "drot-b"}),
    ]
    return ScenarioSpec(
        name="disk-bitrot-snapshot",
        description="a published snapshot rots on disk after its "
                    "rename: the scrub catches the digest mismatch, "
                    "quarantines the file as .corrupt-<ts> and rebuilds "
                    "a verified checkpoint — serving and scheduling "
                    "never notice",
        ticks=12,
        durable=True,
        events=events,
        slos=[
            SLO("work-survives", "tasks_unfinished", "==", 0),
            SLO("no-failures", "tasks_failed", "==", 0),
            SLO("ends-green", "ended_green", "==", 1),
        ],
        checks=[
            ("snapshot-quarantined-and-healed", _check_snapshot_healed),
        ],
    )


def _disk_enospc_commit() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dfull", "provider": Provider.MOCK.value, "hosts": 4},
        ]}),
        Ev(0, "tasks", {"distro": "dfull", "n": 8, "prefix": "dfull-t"}),
        # the next WAL group commit hits a full disk: SHED + RED floor,
        # never a raise mid-commit; the scrub two ticks later verifies
        # the surviving log still passes its stamps
        Ev(2, "disk_fault", {"target": "wal", "kind": "enospc"}),
        Ev(6, "tasks", {"distro": "dfull", "n": 4, "prefix": "dfull-b"}),
    ]
    return ScenarioSpec(
        name="disk-enospc-commit",
        description="the disk fills at a WAL group commit: the frame is "
                    "shed loudly with the overload floor forced RED, "
                    "in-memory truth keeps every write, and the first "
                    "accepted frame re-covers them durably and heals "
                    "back to GREEN",
        ticks=12,
        durable=True,
        events=events,
        slos=[
            SLO("work-survives", "tasks_unfinished", "==", 0),
            SLO("no-failures", "tasks_failed", "==", 0),
            SLO("ends-green", "ended_green", "==", 1),
        ],
        checks=[
            ("enospc-shed-then-healed", _check_enospc_shed_healed),
        ],
    )


def _check_loss_window_fired(run) -> Optional[str]:
    """The seeded lossy window actually dropped requests (otherwise the
    weather silently tested a perfect network)."""
    if run.counter_delta("faults.fired") < 1:
        return "no transport fault ever fired during the storm"
    return None


def _net_agent_storm(kind: str, slug: str, desc: str) -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "dnet", "provider": Provider.MOCK.value, "hosts": 8},
        ]}),
        Ev(0, "tasks", {"distro": "dnet", "n": 16, "prefix": "dnet-t"}),
        # seeds the lossy window on agent.request, fires the claim
        # storm next tick, heals the tick after (engine ev_net_fault)
        Ev(2, "net_fault", {"target": "agent", "kind": kind,
                            "rate": 0.3, "agents": 8}),
    ]
    return ScenarioSpec(
        name=f"net-agent-storm-{slug}",
        description=desc,
        ticks=12,
        events=events,
        slos=[
            SLO("work-survives", "tasks_unfinished", "==", 0),
            SLO("no-failures", "tasks_failed", "==", 0),
        ],
        checks=[("loss-window-fired", _check_loss_window_fired)],
    )


def _net_agent_storm_loss() -> ScenarioSpec:
    """An agent claim storm under 30% request loss: every drop is
    retried at-least-once, and the no-duplicate-dispatch +
    resume≡rerun invariants prove the retries never double-claim."""
    return _net_agent_storm(
        "drop", "loss",
        "8 agents storm the dispatch claim path under 30% request "
        "loss; at-least-once retries converge the backlog with zero "
        "duplicate dispatch and resume ≡ rerun",
    )


def _net_agent_storm_halfopen() -> ScenarioSpec:
    """The nastier shape: the server processes the claim but the
    RESPONSE black-holes, so the agent's retry is duplicate delivery —
    the dispatch CAS (and the running-task resume path) must fence
    every copy."""
    return _net_agent_storm(
        "half_open", "halfopen",
        "8 agents claim under 30% half-open responses (request "
        "processed, reply lost): each retry is a duplicate delivery "
        "the dispatch CAS must fence — zero duplicate dispatch",
    )


def _replica_halfopen_probe(run) -> None:
    """Tick-2 call: attach a read replica to the run's data dir and
    record the healthy baseline (caught up, usable within a tight
    staleness bound)."""
    from ..storage.durable import DurableStore
    from ..storage.replica import ReplicaStore

    if not isinstance(run.store, DurableStore):
        return
    run.store.checkpoint()
    rep = ReplicaStore(
        run.data_dir, poll_interval_s=3600.0,
        replica_id="net-weather",  # pinned: scorecards must replay
    )
    run._net_replica = rep
    run._net_replica_obs = {
        "baseline_applied": rep.applied_seq,
        "baseline_staleness_ms": rep.staleness_ms(),
    }


def _replica_halfopen_observe(run) -> None:
    """Tick-5 call (seam armed half_open since tick 3): polls return
    nothing and never refresh the caught-up stamp, so the staleness
    bound GROWS past any serving threshold — the read router's
    readiness flip — while the primary keeps committing."""
    import time as _time

    rep = getattr(run, "_net_replica", None)
    if rep is None:
        return
    obs = run._net_replica_obs
    polled = rep.poll()
    _time.sleep(0.06)  # let wall-clock staleness clear the 50ms bound
    obs["faulted_polled"] = polled
    obs["faulted_applied"] = rep.applied_seq
    obs["faulted_staleness_ms"] = rep.staleness_ms()
    obs["primary_seq"] = run.store.wal_seq


def _replica_halfopen_heal(run) -> None:
    """Tick-7 call (seam cleared at tick 6): the reconnected tail
    catches back up to the primary's watermark and readiness returns."""
    rep = getattr(run, "_net_replica", None)
    if rep is None:
        return
    obs = run._net_replica_obs
    rep.poll()
    obs["healed_applied"] = rep.applied_seq
    obs["healed_staleness_ms"] = rep.staleness_ms()
    obs["healed_primary_seq"] = run.store.wal_seq
    rep.close()


def _check_replica_halfopen(run) -> Optional[str]:
    obs = getattr(run, "_net_replica_obs", None)
    if not obs or "healed_applied" not in obs:
        return "the replica probe never ran to completion"
    if obs["baseline_staleness_ms"] == float("inf"):
        return "the replica never caught up before the fault"
    if obs["faulted_polled"] != 0:
        return (
            "the half-open tail still applied "
            f"{obs['faulted_polled']} records"
        )
    if obs["faulted_applied"] != obs["baseline_applied"]:
        return "applied_seq moved while the tail was black-holed"
    if obs["faulted_staleness_ms"] <= 50.0:
        return (
            "staleness did not grow past the 50ms serving bound: "
            f"{obs['faulted_staleness_ms']:.1f}ms (readiness never "
            "flipped)"
        )
    if obs["healed_applied"] < obs["healed_primary_seq"]:
        return (
            "the healed tail never caught up: applied "
            f"{obs['healed_applied']} < primary "
            f"{obs['healed_primary_seq']}"
        )
    # NOTE: staleness_ms right after the heal still carries the worst
    # commit→apply gap of the blackout's backlog (by design — those
    # reads really were that stale), so the heal is proven by the
    # watermark above, not by an instant staleness drop
    return None


def _net_replica_halfopen() -> ScenarioSpec:
    events = [
        Ev(0, "fleet", {"distros": [
            {"id": "drep", "provider": Provider.MOCK.value, "hosts": 4},
        ]}),
        Ev(0, "tasks", {"distro": "drep", "n": 8, "prefix": "drep-t"}),
        Ev(2, "call", {"fn": _replica_halfopen_probe}),
        Ev(3, "net_fault", {"target": "replica", "kind": "half_open",
                            "always": True}),
        Ev(5, "call", {"fn": _replica_halfopen_observe}),
        Ev(6, "clear_faults", {"seam": "replica.tail"}),
        Ev(7, "call", {"fn": _replica_halfopen_heal}),
    ]
    return ScenarioSpec(
        name="net-replica-halfopen",
        description="a read replica's WAL tail goes half-open: polls "
                    "return nothing, the staleness bound grows past "
                    "the serving threshold (readiness flips to the "
                    "primary), and the healed tail catches back up",
        ticks=12,
        durable=True,
        events=events,
        slos=[
            SLO("work-survives", "tasks_unfinished", "==", 0),
            SLO("no-failures", "tasks_failed", "==", 0),
        ],
        checks=[
            ("replica-staleness-bounded", _check_replica_halfopen),
        ],
    )


def _sabotage() -> ScenarioSpec:
    return ScenarioSpec(
        name="sabotage-duplicate-claim",
        description="deliberate invariant violation (a forged duplicate "
                    "running-task claim): the engine must score this "
                    "RED — the gate's self-test",
        ticks=6,
        events=[
            # 4 hosts, 2 tasks: at tick 1 two hosts are mid-task and two
            # are free — the forged duplicate claim has both sides live
            Ev(0, "fleet", {"distros": [
                {"id": "dsab", "provider": Provider.MOCK.value,
                 "hosts": 4},
            ]}),
            Ev(0, "tasks", {"distro": "dsab", "n": 2,
                            "prefix": "dsab-t"}),
            Ev(1, "call", {"fn": _sabotage_duplicate_claim}),
        ],
        slos=[],
        checks=[],
        tier1=False,
    )


#: name → spec factory for the default suite (factories, not instances:
#: specs carry mutable event args and every run deserves a fresh one)
SCENARIOS: Dict[str, callable] = {
    "merge-queue-storm": _merge_queue_storm,
    "dag-stepback": _dag_stepback,
    "spot-reclamation": _spot_reclamation,
    "region-failover": _region_failover,
    "spawn-burst": _spawn_burst,
    "seasonality": _seasonality,
    "capacity-price-spike": _capacity_price_spike,
    "capacity-quota-squeeze": _capacity_quota_squeeze,
    "disk-bitrot-snapshot": _disk_bitrot_snapshot,
    "disk-enospc-commit": _disk_enospc_commit,
    "net-agent-storm-loss": _net_agent_storm_loss,
    "net-agent-storm-halfopen": _net_agent_storm_halfopen,
    "net-replica-halfopen": _net_replica_halfopen,
}

#: deliberately-broken specs the gate's self-test runs EXPECTING failure
SABOTAGE_SCENARIOS: Dict[str, callable] = {
    "sabotage-duplicate-claim": _sabotage,
}
