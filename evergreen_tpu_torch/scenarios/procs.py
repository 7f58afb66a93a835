"""Child-process replay backend for the scenario engine.

A copy of ``evergreen_tpu/scenarios/procs.py``. The in-process engine
(scenarios/engine.py) replays a spec against one store in one process;
this backend replays a spec against a **supervised fleet of real worker
processes** (runtime/supervisor.py + runtime/worker.py over a temp data
dir) — the deployment shape of ``service --shards N`` — so the crash
matrix's process-SIGKILL points and the supervised-fleet weathers run
THROUGH the engine vocabulary with the same invariants.

Proc specs are ordinary ``ScenarioSpec``s using the proc event kinds:

  ``proc_fleet``    (tick 0) the workload: n_shards + a seeded problem
                    partitioned across the shard stores before spawn
  ``proc_kill``     SIGKILL a named worker — immediately, or AT a named
                    fault seam (``arm_fault`` installs a ``crash``
                    kind in the live worker: ``os._exit(86)`` at the
                    seam, the SIGKILL shape — no atexit, no finally)
  ``proc_hang``     SIGSTOP a named worker: heartbeats stop, the
                    supervisor's deadline trips, the worker is killed
                    and restarted — the hang resolves exactly like a
                    crash, fenced at a higher epoch
  ``proc_migrate``  drive one fenced handoff over the control protocol
  ``sup_kill``      crash the SUPERVISOR itself (``at``: "idle", or
                    "mid_round" — kill after the tick fan-out left,
                    before replies — or "mid_handoff" — kill between
                    the release and prime legs of a live migration).
                    Workers observe stdin EOF and go ORPHAN: leases
                    kept, autonomous local ticks, bounded grace
  ``sup_restart``   start a fresh supervisor over the same data dir:
                    it steals the fleet lease at a strictly higher
                    epoch, ADOPTS the orphaned workers via the fleet
                    manifest + control sockets (same pids, same
                    shard-lease epochs, no recovery pass) and runs
                    ``reconcile_handoffs`` first thing

Each virtual tick runs: due events → supervisor round (every live
worker's ``run_tick``) → the deterministic agent step (complete
in-flight, dispatch free hosts — the real CAS pair) → wait for any
killed worker's fenced takeover to land. At the end the fleet drains
and shuts down, the shard stores are reopened cold, and the scorecard
asserts the crash-matrix contracts as engine invariants:

  ``no_duplicate_dispatch`` / ``store_consistent`` — on the merged
  fleet state; ``exactly_one_owner`` — no distro-scoped doc in two
  shard stores; ``monotone_epochs`` — every restart stole its shard's
  lease at a strictly higher fencing epoch; ``resume_equals_rerun`` —
  the crashed-and-recovered fleet converges to the same canonical
  state as an uninterrupted run of the same spec (kills stripped);
  ``converged`` — the workload drained.

``run_crash_point`` runs one classic crash-matrix kill point (seam @
call-index on a 1-shard fleet) through this backend.

**The port's rules.** The supervisor and its workers run on ``device``:
the CUDA card when None (raising without one), the CPU only when the
caller passes ``device="cpu"``; each round's solves run in the workers,
and the stacked ones in the supervisor's solver leader, in this process.
A workload whose ``solver`` is ``"auto"`` builds its supervisor with
``solver="always"``: the port's supervisor elects under ``"auto"`` only
when the device count covers the shards, so one card (or the CPU) would
elect no leader, where the JAX harness forces one host device per shard
to reach its leader; under ``"always"`` the leader stacks the round on
the one device. The specs stay the JAX package's field by field. A
worker exit that is none of 0, 86 (a crash-shaped kill), ``EXIT_FENCED``,
``EXIT_LOST``, the supervisor's ``EXIT_GONE`` or a signal (``EXIT_KERNEL``
is one: a card fault in the worker) raises ``WorkerExitError`` out of
``execute`` once the fleet is torn down, as the in-process engine raises
its card faults. On the card the workers' stderr is this process's (the
kernel's error reaches the log); on the CPU it is silenced, as in the
JAX harness.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time as _time
from typing import Dict, List, Optional

from ..device import resolve_device
from ..runtime.protocol import EXIT_CRASHED, EXIT_FENCED, EXIT_LOST
from ..utils.benchgen import NOW
from .invariants import (
    canonical_state,
    check_duplicate_dispatch,
    check_store_consistent,
)
from .spec import Ev, SLO, ScenarioSpec, scorecard_entry_fingerprint

#: event kinds the proc backend handles (anything else in a proc spec
#: is a spec error — in-process events cannot reach a child's store)
#: ``leader_kill`` / ``leader_hang`` target the SOLVER LEADER
#: (runtime/solver.py SolverService, living inside the supervisor):
#: a fault armed at a named solver seam in the harness process —
#: ``call``-crash for kill, ``hang`` for a stall — so leader death
#: lands exactly at the publish/solve/return seams of a live round
PROC_EVENT_KINDS = ("proc_fleet", "proc_kill", "proc_hang",
                    "proc_migrate", "sup_kill", "sup_restart",
                    "leader_kill", "leader_hang",
                    "net_fault", "net_heal")

#: the proc analog of spec.DEFAULT_INVARIANTS
DEFAULT_PROC_INVARIANTS = (
    "no_duplicate_dispatch",
    "store_consistent",
    "exactly_one_owner",
    "monotone_epochs",
    "resume_equals_rerun",
    "converged",
)

#: deterministic workload clock (the crash matrix's anchor)
TICK_S = 15.0
LEASE_TTL_S = 1.0


class WorkerExitError(RuntimeError):
    """A shard worker of a replay ended with an exit the weathers never
    cause (a card fault's ``EXIT_KERNEL``, a crash of the worker itself):
    no schedule's finding, so it raises instead of scoring."""


def _seed_fleet(data_dir: str, n_shards: int, workload: dict) -> None:
    """Partition one deterministic problem across the shard stores
    BEFORE any worker spawns (epoch-0 frames — the workers' leased
    writes land after them). Same workload shape as the crash matrix:
    phantom running-task stamps cleared so every dispatch is a real
    CAS pair."""
    from ..models import distro as distro_mod
    from ..models import host as host_mod
    from ..models import task as task_mod
    from ..parallel.topology import ShardTopology
    from ..storage.durable import DurableStore
    from ..utils.benchgen import generate_problem

    distros, tasks_by_distro, hosts_by_distro, _, _ = generate_problem(
        workload.get("distros", 2),
        workload.get("tasks", 24),
        seed=workload.get("seed", 11),
        hosts_per_distro=workload.get("hosts_per_distro", 3),
        dep_fraction=workload.get("dep_fraction", 0.25),
    )
    sabotage = bool(workload.get("sabotage_duplicate_claim"))
    topo = ShardTopology(n_shards)
    stores = [
        DurableStore(data_dir, shard_id=k) for k in range(n_shards)
    ]
    try:
        for d in distros:
            store = stores[topo.shard_for(d.id)]
            store.begin_tick()
            try:
                distro_mod.coll(store).upsert(d.to_doc())
                for t in tasks_by_distro[d.id]:
                    task_mod.coll(store).upsert(t.to_doc())
                for h in hosts_by_distro[d.id]:
                    h.running_task = ""
                    h.running_task_group = ""
                    h.running_task_build_variant = ""
                    h.running_task_version = ""
                    h.running_task_project = ""
                    host_mod.coll(store).upsert(h.to_doc())
            finally:
                store.end_tick()
        if sabotage:
            # the fuzzer's self-test: forge two TASK_DISPATCHED events for
            # one (task, timestamp) — two CAS winners — bypassing the
            # dispatch path entirely. The campaign MUST score this fleet
            # red (no_duplicate_dispatch) or the invariant layer is dead.
            store = stores[0]
            store.begin_tick()
            try:
                ev_coll = store.collection("events")
                for i in range(2):
                    ev_coll.upsert({
                        "_id": f"sabotage-dup-{i}",
                        "event_type": "TASK_DISPATCHED",
                        "resource_id": "sabotage-t0",
                        "timestamp": NOW,
                    })
            finally:
                store.end_tick()
    finally:
        for s in stores:
            s.sync_persist()
            s.close()


def _open_fleet_stores(data_dir: str, n_shards: int) -> list:
    from ..storage.durable import DurableStore

    return [
        DurableStore(data_dir, shard_id=k) for k in range(n_shards)
    ]


class ProcScenarioRun:
    """One replay of one proc spec against a supervised fleet."""

    def __init__(self, spec: ScenarioSpec,
                 with_reference: bool = True,
                 seed: Optional[int] = None,
                 keep_data_dir: bool = False,
                 device=None) -> None:
        #: the supervisor's and its workers' device (resolved before any
        #: process starts)
        self.device = resolve_device(device)
        self.spec = spec
        self.with_reference = with_reference
        self.keep_data_dir = keep_data_dir
        fleet_evs = [e for e in spec.events if e.kind == "proc_fleet"]
        if len(fleet_evs) != 1 or fleet_evs[0].tick != 0:
            raise ValueError(
                "a proc spec needs exactly one proc_fleet event at "
                "tick 0"
            )
        self.workload = dict(fleet_evs[0].args)
        # seed flows END TO END: an explicit seed overrides both the
        # spec's stamp and the workload generator's, so a fuzzer-found
        # timeline replays the same seeded problem in process mode that
        # it replayed in-process
        if seed is not None:
            self.workload["seed"] = int(seed)
        # the scorecard reports the EFFECTIVE workload seed (what
        # generate_problem actually consumed), never a dead spec stamp
        self.seed = int(self.workload.get("seed", 11))
        self.n_shards = int(self.workload.get("shards", 2))
        bad = [
            e.kind for e in spec.events
            if e.kind not in PROC_EVENT_KINDS
        ]
        if bad:
            raise ValueError(
                f"proc specs only take {PROC_EVENT_KINDS}; got {bad}"
            )
        late = [
            (e.kind, e.tick) for e in spec.events
            if not (0 <= e.tick < spec.ticks)
        ]
        if late:
            # an event past the timeline would silently never fire —
            # the fault it was meant to inject would score as tested
            raise ValueError(
                f"events outside [0, ticks={spec.ticks}): {late}"
            )
        self.sup = None
        #: previous supervisor incarnations (sup_kill/sup_restart):
        #: scoring aggregates restarts/exits/epochs across ALL of them
        self.sups: List = []
        #: True once a leader_kill/leader_hang installed a fault plan
        #: (process-global — execute()'s finally restores the previous)
        self._armed_faults = False
        self._prev_faults = None
        #: the accumulating net_fault plan (net_fault/net_heal share
        #: one installed plan; a later leader_kill would clobber it —
        #: proc specs never mix the two fault families on one timeline)
        self._net_plan = None
        self.data_dir: Optional[str] = None
        self.rounds: List[Dict[int, dict]] = []
        self.dispatched_total = 0
        self.unfinished = -1
        self.converged_at = -1
        self.fault_exits = 0
        self.stats: Dict = {}
        self.reference_state: Optional[dict] = None

    # -- events ----------------------------------------------------------- #

    def _apply_event(self, ev: Ev, now: float) -> None:
        if ev.kind == "proc_fleet":
            return  # consumed at setup
        if ev.kind == "proc_kill":
            shard = int(ev.args.get("worker", 0))
            seam = ev.args.get("seam", "")
            h = self.sup.handles[shard]
            if seam:
                h.send(op="arm_fault", seam=seam, kind="crash",
                       at=ev.args.get("at"))
                h.wait_reply("armed", 10.0)
            elif h.alive():
                os.kill(h.pid, signal.SIGKILL)
        elif ev.kind == "proc_hang":
            shard = int(ev.args.get("worker", 0))
            seam = ev.args.get("seam", "")
            h = self.sup.handles[shard]
            if seam:
                h.send(op="arm_fault", seam=seam, kind="hang",
                       delay_s=float(ev.args.get("delay_s", 30.0)),
                       always=bool(ev.args.get("always", True)))
                h.wait_reply("armed", 10.0)
            elif h.alive():
                os.kill(h.pid, signal.SIGSTOP)
        elif ev.kind == "proc_migrate":
            distro = ev.args["distro"]
            src = int(ev.args["from"])
            dst = int(ev.args["to"])
            self.sup.migrate(distro, src, dst)
        elif ev.kind == "sup_kill":
            at = ev.args.get("at", "idle")
            if at == "mid_round":
                # fan the tick out, then die before collecting a single
                # reply — the workers execute it into the void
                ready = [
                    h for h in self.sup.handles.values()
                    if h.state == "ready"
                ]
                for h in ready:
                    h.send(op="tick", now=now, req=h.next_req())
                self.sup.simulate_crash()
            elif at == "mid_handoff":
                self._release_then_crash(now)
            else:
                self.sup.simulate_crash()
        elif ev.kind == "sup_restart":
            self._restart_supervisor()
        elif ev.kind == "leader_kill":
            # crash the supervisor AT a solver seam of the NEXT round's
            # serve: the fault plan is process-global (the SolverService
            # runs in this harness process), installed fresh so index 0
            # is the next fire of the seam; execute() restores the
            # previous plan in its finally
            from ..utils import faults

            sup = self.sup
            if sup.solver_service is None:
                # never elected (device-starved host, lease held
                # elsewhere): no solver seam will ever fire — degrade
                # to a plain supervisor kill so the scheduled
                # sup_restart still has a corpse to replace
                sup.simulate_crash()
                return
            seam = ev.args.get("seam", "solver.round")
            plan = faults.FaultPlan().at(
                seam, int(ev.args.get("index", 0)),
                faults.Fault("call", fn=sup.simulate_crash),
            )
            faults.install(plan)
            self._armed_faults = True
        elif ev.kind == "leader_hang":
            from ..utils import faults

            seam = ev.args.get("seam", "solver.solve")
            plan = faults.FaultPlan().at(
                seam, int(ev.args.get("index", 0)),
                faults.Fault(
                    "hang",
                    delay_s=float(ev.args.get("delay_s", 8.0)),
                ),
            )
            faults.install(plan)
            self._armed_faults = True
        elif ev.kind == "net_fault":
            # arm a transport fault at a supervisor-side seam. The
            # seams fire in THIS harness process (the supervisor owns
            # both IPC directions), so shard-scoped aliases like
            # ``ipc.send.0`` partition ONE worker of the fleet while
            # its siblings keep talking — the Jepsen one-way-partition
            # shape. Faults accumulate onto one installed plan until a
            # ``net_heal`` clears the seam (or the run's finally
            # restores the pre-replay plan).
            from ..utils import faults

            seam = ev.args.get("seam", "ipc.send")
            kind = ev.args.get("kind", "partition")
            if self._net_plan is None:
                self._net_plan = faults.FaultPlan()
                faults.install(self._net_plan)
                self._armed_faults = True
            fault = faults.Fault(
                kind, delay_s=float(ev.args.get("delay_s", 0.0))
            )
            if ev.args.get("at") is not None:
                self._net_plan.at(seam, int(ev.args["at"]), fault)
            else:
                self._net_plan.always(seam, fault)
        elif ev.kind == "net_heal":
            # the partition heals: clear one seam (or every armed
            # transport fault) so the degraded side reconnects and the
            # run converges — resume≡rerun compares POST-heal states
            seam = ev.args.get("seam", "")
            plan = self._net_plan
            if plan is not None:
                if seam:
                    plan._at.pop(seam, None)
                    plan._always.pop(seam, None)
                else:
                    plan._at.clear()
                    plan._always.clear()

    def _release_then_crash(self, now: float) -> None:
        """Drive the RELEASE leg of a real migration, then crash the
        supervisor before the prime leg ever leaves: the released
        record is durable on the source, the target knows nothing —
        the successor's post-adoption ``reconcile_handoffs`` must
        converge it to exactly-one-owner."""
        sup = self.sup
        loads = sup.broadcast("load", "load")
        src = dst = None
        distro = None
        for k in sorted(loads):
            reps = loads[k].get("reps") or {}
            if reps:
                src = k
                distro = sorted(reps.values())[0]
                dst = next(
                    j for j in range(self.n_shards) if j != k
                )
                break
        if distro is None:  # nothing to move: degrade to a plain kill
            sup.simulate_crash()
            return
        hs = sup.handles[src]
        sup._seq += 1
        req = hs.next_req()
        hs.send(op="release", distro=distro, target=dst,
                seq=sup._seq, now=now, req=req)
        hs.wait_reply("released", 60.0, req=req)
        sup.simulate_crash()

    def _restart_supervisor(self) -> None:
        """The successor: a fresh supervisor over the same data dir —
        steals the fleet lease at a higher epoch, adopts the orphans,
        reconciles. Adoption quality is scored: zero shard-lease epoch
        bumps, zero pid changes, zero recovery passes."""
        old = self.sup
        pre = {k: (h.pid, h.epoch) for k, h in old.handles.items()}
        self.sups.append(old)
        sup2 = self._build_supervisor()
        sup2.start()
        self.sup = sup2
        adopted = [
            k for k, h in sup2.handles.items() if h.adopted
        ]

        def bump(key: str, by: int) -> None:
            self.stats[key] = self.stats.get(key, 0) + by

        bump("sup_restarts", 1)
        bump("adoptions_total", len(adopted))
        bump("adoption_epoch_bumps", sum(
            1 for k in adopted if sup2.handles[k].epoch != pre[k][1]
        ))
        bump("adoption_pid_changes", sum(
            1 for k in adopted if sup2.handles[k].pid != pre[k][0]
        ))
        # the worker counts every recovery pass it has EVER run; an
        # adopted process must still be at its single boot-time pass
        bump("adoption_recoveries", sum(
            1 for k in adopted
            if sup2.handles[k].adopt_hello.get("recovery_passes", 1)
            > 1
        ))
        bump("orphan_adoptions", sum(
            1 for k in adopted
            if sup2.handles[k].adopt_hello.get("orphaned")
        ))
        # solver-leader re-election: the successor must STEAL
        # solver.lease at a strictly higher epoch than the incarnation
        # it replaced (the dead leader abandoned, never released)
        old_sep = (
            old.solver_service.lease.epoch
            if old.solver_service is not None else 0
        )
        new_sep = (
            sup2.solver_service.lease.epoch
            if sup2.solver_service is not None else 0
        )
        if old_sep or new_sep:
            bump("solver_reelections", 1 if new_sep > old_sep else 0)
            self.stats["solver_epoch_prev"] = max(
                self.stats.get("solver_epoch_prev", 0), old_sep
            )
            self.stats["solver_epoch_last"] = new_sep

    # -- the replay loop -------------------------------------------------- #

    def _build_supervisor(self):
        from ..runtime.supervisor import FleetSupervisor
        from ..utils.retry import RetryPolicy

        solver = self.workload.get("solver", "never")
        return FleetSupervisor(
            self.data_dir,
            self.n_shards,
            ttl_s=self.workload.get("ttl_s", LEASE_TTL_S),
            hb_interval_s=0.25,
            hb_deadline_s=1.5,
            tick_s=self.spec.tick_s,
            # partition weathers shrink this: a black-holed tick
            # command otherwise blocks the round for the full default
            round_timeout_s=float(
                self.workload.get("round_timeout_s", 180.0)
            ),
            harness=True,
            recovery_anchor=NOW,
            restart_policy=RetryPolicy(
                attempts=1_000_000, base_backoff_s=0.25,
                max_backoff_s=2.0, jitter=0.0,
            ),
            # induced crashes would spam the CPU's runs; on the card a
            # kernel's error must reach the log
            worker_stderr=(
                "inherit" if self.device.type == "cuda" else "devnull"
            ),
            # survivability knobs sized for the harness: workers ride
            # out a supervisor kill for a minute (bounded so a leaked
            # orphan still dies), tick locally every second meanwhile,
            # and the successor steals the fleet lease after ~1s
            orphan_grace_s=float(
                self.workload.get("orphan_grace_s", 60.0)
            ),
            orphan_tick_s=1.0,
            # command-staleness deadline (one-way-partition detection):
            # 0 keeps it off unless the weather opts in — a partitioned
            # worker orphans after this many silent seconds and ticks
            # locally until commands resume
            command_silence_s=float(
                self.workload.get("command_silence_s", 0.0)
            ),
            supervisor_lease_ttl_s=1.0,
            # solver-leader plane: the workload opts in ("auto", which
            # elects here as "always": the module docstring); tight
            # TTL/timeout so leader death degrades and re-elects inside
            # the harness's tick cadence
            solver="always" if solver == "auto" else solver,
            solver_lease_ttl_s=1.0,
            solver_timeout_s=float(
                self.workload.get("solver_timeout_s", 6.0)
            ),
            device=self.device,
        )

    def _events_by_tick(self) -> Dict[int, List[Ev]]:
        out: Dict[int, List[Ev]] = {}
        for ev in self.spec.events:
            if ev.kind != "proc_fleet":
                out.setdefault(ev.tick, []).append(ev)
        return out

    def _wait_fleet_healthy(self, timeout_s: float = 60.0) -> None:
        """Let fenced takeovers land before the next virtual tick: any
        worker that died gets restarted by the watchdog (backoff +
        lease-TTL steal) — the round loop must not outrun it forever."""
        from ..utils.retry import Deadline

        deadline = Deadline.after(timeout_s)
        while not deadline.exceeded():
            if self.sup.crashed or self.sup.deposed:
                return  # nobody is coming until sup_restart fires
            if all(
                h.state == "ready" for h in self.sup.handles.values()
            ):
                return
            _time.sleep(0.05)

    def execute(self) -> Dict:
        from ..utils import faults

        t0 = _time.perf_counter()
        self._prev_faults = faults.active()
        self.data_dir = tempfile.mkdtemp(
            prefix=f"proc-{self.spec.name}-"
        )
        try:
            self._replay()
        except BaseException:
            self._teardown()
            raise
        bad = self._fault_exits()
        if bad:
            self._teardown()
            raise WorkerExitError(
                f"{self.spec.name}: shard workers exited {bad}"
            )
        try:
            if (
                self.with_reference
                and self._has_faults()
                and self.reference_state is None
            ):
                self.reference_state = _reference_canonical(
                    self.spec, seed=self.seed, device=self.device
                )
            entry = self._score()
            entry["timing"] = {
                "wall_ms": round((_time.perf_counter() - t0) * 1e3, 1)
            }
            entry["fingerprint"] = scorecard_entry_fingerprint(entry)
        finally:
            # the temp data dir (per-shard WAL segments) must go even
            # when scoring/reference raises — failed runs would
            # otherwise accumulate multi-MB orphans
            self._teardown()
        return entry

    def _replay(self) -> None:
        """Seed the fleet, start it, run the timeline to convergence,
        drain; the fleet stops (and the fault plan is restored) however
        the replay ends. A worker exit no weather causes ends it early."""
        from ..utils import faults

        _seed_fleet(self.data_dir, self.n_shards, self.workload)
        self.sup = self._build_supervisor()
        events = self._events_by_tick()
        try:
            self.sup.start()
            max_ticks = self.spec.ticks * 3  # crash retries headroom
            for i in range(max_ticks):
                now = NOW + (i + 1) * self.spec.tick_s
                for ev in events.pop(i, ()):
                    self._apply_event(ev, now)
                self.rounds.append(self.sup.round(now=now))
                done = self.sup.agent_sim(now=now)
                self.dispatched_total += sum(
                    r.get("dispatched", 0) for r in done.values()
                )
                if done and len(done) == self.n_shards:
                    self.unfinished = sum(
                        r.get("unfinished", 0) for r in done.values()
                    )
                    if self.unfinished == 0 and not events:
                        self.converged_at = i
                        break
                if self._fault_exits():
                    return  # execute raises once the fleet is down
                self._wait_fleet_healthy()
            self.stats["supervisor_epoch"] = self.sup.sup_epoch
            self.sup.drain()
        finally:
            if self._armed_faults:
                # the leader fault plan is process-global: restore
                # whatever was installed before this replay
                if self._prev_faults is not None:
                    faults.install(self._prev_faults)
                else:
                    faults.uninstall()
            self.sup.stop(graceful=True)
            # crashed incarnations still hold the Popen objects for
            # workers the successor adopted: reap the zombies (the
            # successor's stop() already ended the processes)
            for old in self.sups:
                for h in old.handles.values():
                    if h.proc is None:
                        continue
                    if h.proc.poll() is None:
                        try:
                            h.proc.kill()
                        except OSError:
                            pass
                    try:
                        h.proc.wait(timeout=5.0)
                    except Exception:  # noqa: BLE001 — best effort: the
                        # child is SIGKILLed; the wait only reaps it
                        pass

    def _fault_exits(self) -> Dict[int, List[int]]:
        """Each shard's worker exits that no weather causes (the module
        docstring), over every supervisor incarnation."""
        from ..runtime.supervisor import EXIT_GONE

        fine = (0, EXIT_CRASHED, EXIT_FENCED, EXIT_LOST, EXIT_GONE)
        out: Dict[int, List[int]] = {}
        for s in [*self.sups, self.sup]:
            if s is None:
                continue
            for k, h in s.handles.items():
                bad = [rc for rc in h.exits if rc >= 0 and rc not in fine]
                if bad:
                    out.setdefault(k, []).extend(bad)
        return out

    def _has_faults(self) -> bool:
        return any(
            e.kind in ("proc_kill", "proc_hang", "sup_kill",
                       "leader_kill", "leader_hang", "net_fault")
            for e in self.spec.events
        )

    # -- scoring ---------------------------------------------------------- #

    def _score(self) -> Dict:
        from ..scheduler.sharded_plane import (
            fleet_owner_violations,
            merge_fleet_state,
        )

        stores = _open_fleet_stores(self.data_dir, self.n_shards)
        self.stores = stores
        try:
            self.owner_violations = fleet_owner_violations(stores)
            try:
                self.merged = merge_fleet_state(stores)
            except ValueError:
                self.merged = None
            #: the run's own converged canonical state — the rerun side
            #: a later crashed run compares against (captured here,
            #: before the data dir is torn down)
            self.reference_canonical = (
                canonical_state(self.merged)
                if self.merged is not None else None
            )
            # aggregate across EVERY supervisor incarnation: a
            # sup_kill/sup_restart weather's restarts, exits and
            # handoffs are spread over self.sups + the final one
            all_sups = [*self.sups, self.sup]
            solver_stacked = 0
            solver_local = 0
            stale_by_shard: Dict[int, int] = {}
            for rnd in self.rounds:
                for shard, reply in rnd.items():
                    sol = reply.get("solve")
                    if sol == "stacked":
                        solver_stacked += 1
                    elif sol == "local":
                        solver_local += 1
                    # cumulative per-worker counter: the per-round max
                    # is the lifetime total, summing rounds would
                    # double-count
                    stale_by_shard[shard] = max(
                        stale_by_shard.get(shard, 0),
                        int(reply.get("solve_stale_accepted", 0)),
                    )
            if solver_stacked or solver_local or stale_by_shard:
                self.stats["solver_stacked_replies"] = solver_stacked
                self.stats["solver_local_replies"] = solver_local
                self.stats["solver_stale_accepted"] = sum(
                    stale_by_shard.values()
                )
                self.stats["shm_leaked"] = self._count_leaked_segments()
            self.stats = {
                "ticks": len(self.rounds),
                "converged_at": self.converged_at,
                "unfinished_final": self.unfinished,
                "dispatched_total": self.dispatched_total,
                "restarts_total": sum(
                    h.restarts for s in all_sups
                    for h in s.handles.values()
                ),
                "crash_exits": sum(
                    1 for s in all_sups for h in s.handles.values()
                    for rc in h.exits if rc == 86
                ),
                "kill_exits": sum(
                    1 for s in all_sups for h in s.handles.values()
                    for rc in h.exits if rc < 0
                ),
                "max_epoch": max(
                    (h.epoch for s in all_sups
                     for h in s.handles.values()), default=0
                ),
                "migrations": sum(
                    len(s.migrations) for s in all_sups
                ),
                "reconciled_handoffs": sum(
                    len(s.reconciled) for s in all_sups
                ),
                **self.stats,
            }
            invariants = {}
            for name in (self.spec.invariants or ()):
                fn = PROC_INVARIANT_CHECKS.get(name)
                if fn is None:
                    invariants[name] = {
                        "ok": False,
                        "detail": f"unknown proc invariant {name!r}",
                    }
                    continue
                try:
                    problem = fn(self)
                except Exception as exc:  # noqa: BLE001 — a raising
                    # check is a failing check, never a crashed scorecard
                    problem = f"invariant raised: {exc!r}"
                invariants[name] = {
                    "ok": problem is None, "detail": problem or "",
                }
            checks = {}
            for name, fn in self.spec.checks:
                try:
                    problem = fn(self)
                except Exception as exc:  # noqa: BLE001
                    problem = f"check raised: {exc!r}"
                checks[name] = {
                    "ok": problem is None, "detail": problem or "",
                }
            slos = {s.name: s.evaluate(self.stats) for s in self.spec.slos}
            ok = (
                all(v["ok"] for v in invariants.values())
                and all(v["ok"] for v in checks.values())
                and all(v["ok"] for v in slos.values())
            )
            return {
                "name": self.spec.name,
                "ok": ok,
                "seed": self.seed,
                "deterministic": False,  # real processes, real clocks
                "backend": "procs",
                "invariants": invariants,
                "checks": checks,
                "slos": slos,
                "stats": {
                    k: self.stats[k] for k in sorted(self.stats)
                    if isinstance(self.stats[k], (int, float, bool, str))
                },
            }
        finally:
            for s in stores:
                try:
                    s.close()
                except Exception:  # noqa: BLE001 — inspection handles
                    # on a dead fleet's stores
                    pass

    def _count_leaked_segments(self) -> int:
        """Solver shm segments still attachable after the fleet stopped.

        Clean exits unlink their segment; a leaked one means a worker
        (or a crashed leader's reap pass) skipped hygiene — scenarios
        gate on this being zero."""
        from ..runtime.solver import Segment, segment_name

        leaked = 0
        for shard in range(self.n_shards):
            seg = Segment.attach(segment_name(self.data_dir, shard))
            if seg is not None:
                leaked += 1
                seg.close()
        return leaked

    def _teardown(self) -> None:
        import shutil

        from ..runtime.solver import Segment, segment_name

        # leaked solver segments live in /dev/shm, not the data dir:
        # rmtree won't reach them, so force-unlink before the run's
        # evidence disappears (leak already counted by _score)
        if self.data_dir is not None:
            for shard in range(self.n_shards):
                seg = Segment.attach(
                    segment_name(self.data_dir, shard)
                )
                if seg is not None:
                    seg.unlink()
                    seg.close()
        # trace capture reads the per-shard WAL segments after the run:
        # leave the data dir on disk for the caller to harvest (and
        # remove)
        if self.data_dir is not None and not self.keep_data_dir:
            shutil.rmtree(self.data_dir, ignore_errors=True)


# --------------------------------------------------------------------------- #
# proc invariants
# --------------------------------------------------------------------------- #


def _pinv_no_duplicate_dispatch(run: ProcScenarioRun) -> Optional[str]:
    if run.merged is None:
        return "fleet not mergeable (owner violations)"
    problems = check_duplicate_dispatch(run.merged)
    return "; ".join(problems[:3]) if problems else None


def _pinv_store_consistent(run: ProcScenarioRun) -> Optional[str]:
    if run.merged is None:
        return "fleet not mergeable (owner violations)"
    problems = check_store_consistent(run.merged)
    return "; ".join(problems[:3]) if problems else None


def _pinv_exactly_one_owner(run: ProcScenarioRun) -> Optional[str]:
    return (
        "; ".join(run.owner_violations[:3])
        if run.owner_violations else None
    )


def _pinv_monotone_epochs(run: ProcScenarioRun) -> Optional[str]:
    sups = [*run.sups, run.sup]
    for k in range(run.n_shards):
        es = [e for s in sups for e in s.handles[k].epochs]
        # an ADOPTION legitimately re-observes the same epoch (that is
        # the whole point: no bump) — collapse consecutive repeats,
        # then require strictly increasing; a lower epoch appearing
        # later is still caught
        collapsed = [
            e for i, e in enumerate(es) if i == 0 or e != es[i - 1]
        ]
        if collapsed != sorted(set(collapsed)):
            return f"shard {k} epochs not strictly increasing: {es}"
        restarts = sum(s.handles[k].restarts for s in sups)
        if restarts and not es:
            return (
                f"shard {k}: {restarts} restart(s) but no takeover "
                "ever said hello"
            )
        # a crash BEFORE the first hello (e.g. inside the recovery
        # pass) leaves only the successor's epoch observed — strictly-
        # increasing over the observed hellos is the checkable half;
        # the lease's epoch floor guarantees the unobserved half
    return None


def _pinv_resume_equals_rerun(run: ProcScenarioRun) -> Optional[str]:
    """The crashed-and-recovered fleet must converge to the same
    canonical state as an uninterrupted run of the same spec (the
    crash matrix's resume ≡ rerun, fleet-wide)."""
    if run.reference_state is None:
        return None  # no faults in the spec: nothing to compare
    if run.merged is None:
        return "fleet not mergeable (owner violations)"
    live = canonical_state(run.merged)
    if live != run.reference_state:
        diffs = []
        for key in ("tasks", "queues"):
            a = live[key]
            b = run.reference_state[key]
            for k in sorted(set(a) | set(b)):
                if a.get(k) != b.get(k):
                    diffs.append(f"{key}/{k}: {a.get(k)} != {b.get(k)}")
                if len(diffs) >= 3:
                    break
        return "resume != rerun: " + "; ".join(diffs[:3])
    return None


def _pinv_converged(run: ProcScenarioRun) -> Optional[str]:
    if run.unfinished != 0:
        return (
            f"workload did not drain: {run.unfinished} unfinished "
            f"after {len(run.rounds)} rounds"
        )
    return None


PROC_INVARIANT_CHECKS = {
    "no_duplicate_dispatch": _pinv_no_duplicate_dispatch,
    "store_consistent": _pinv_store_consistent,
    "exactly_one_owner": _pinv_exactly_one_owner,
    "monotone_epochs": _pinv_monotone_epochs,
    "resume_equals_rerun": _pinv_resume_equals_rerun,
    "converged": _pinv_converged,
}


def _reference_canonical(spec: ScenarioSpec,
                         seed: Optional[int] = None,
                         device=None) -> dict:
    """The rerun side: the same spec with every proc_kill / proc_hang
    stripped, replayed uninterrupted; returns the merged canonical
    state at convergence. ``seed`` pins the reference to the crashed
    run's effective workload seed — resume ≡ rerun compares the SAME
    seeded problem. The reference fleet runs on ``device``."""
    import dataclasses

    clean = dataclasses.replace(
        spec,
        name=f"{spec.name}-reference",
        events=[
            e for e in spec.events
            if e.kind not in ("proc_kill", "proc_hang",
                              "sup_kill", "sup_restart",
                              "leader_kill", "leader_hang",
                              "net_fault", "net_heal")
        ],
        checks=[],
        slos=[],
        invariants=("converged",),
    )
    run = ProcScenarioRun(clean, with_reference=False, seed=seed,
                          device=device)
    entry = run.execute()
    if not entry["ok"]:
        raise RuntimeError(
            f"proc reference run failed: {entry['invariants']}"
        )
    # the data dir is torn down inside execute(); the canonical state
    # was captured from the merged view at scoring time
    return run.reference_canonical


def run_proc_scenario(spec: ScenarioSpec,
                      seed: Optional[int] = None,
                      device=None) -> Dict:
    """Replay one proc spec; returns its scorecard entry. ``seed``
    overrides the workload seed end-to-end (same contract as
    ``engine.run_scenario(spec, seed)``), so a fuzzer-found timeline
    replays the identical seeded problem in process mode. The fleet runs
    on ``device``: the card when None, the CPU with ``"cpu"``."""
    return ProcScenarioRun(spec, seed=seed, device=device).execute()


# --------------------------------------------------------------------------- #
# the supervised-fleet weathers
# --------------------------------------------------------------------------- #


def _proc_sigkill_spec(seed: int = 0) -> ScenarioSpec:
    """2-shard supervised fleet; worker 0 is killed AT the wal.commit
    seam mid-round (SIGKILL shape) and must come back fenced at a
    strictly higher epoch with zero duplicate dispatch and resume ≡
    rerun state."""

    def restarted(run: ProcScenarioRun) -> Optional[str]:
        if run.stats.get("restarts_total", 0) < 1:
            return "no worker restart happened"
        if run.stats.get("crash_exits", 0) < 1:
            return "no crash-shaped (exit 86) death observed"
        h = run.sup.handles[0]
        if len(h.epochs) < 2 or h.epochs[-1] <= h.epochs[0]:
            return (
                f"shard 0 takeover not at a higher epoch: {h.epochs}"
            )
        return None

    return ScenarioSpec(
        name="proc-fleet-sigkill",
        description="supervised 2-shard fleet: SIGKILL-shaped worker "
                    "death at the wal.commit seam mid-round, fenced "
                    "takeover at a higher epoch, fleet converges",
        ticks=12,
        seed=seed,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", {
                "shards": 2, "distros": 4, "tasks": 32, "seed": 11,
                "hosts_per_distro": 3,
            }),
            Ev(2, "proc_kill", {"worker": 0, "seam": "wal.commit"}),
        ],
        slos=[
            SLO("bounded-restarts", "restarts_total", "<=", 3),
        ],
        checks=[("fenced-restart", restarted)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def _proc_hang_spec(seed: int = 0) -> ScenarioSpec:
    """2-shard fleet; worker 1 is SIGSTOPped: its heartbeats stop, the
    supervisor's missed-heartbeat deadline kills and restarts it, and
    the replacement steals the shard lease at a higher epoch."""

    def hang_resolved(run: ProcScenarioRun) -> Optional[str]:
        if run.stats.get("kill_exits", 0) < 1:
            return "the hung worker was never killed"
        if run.stats.get("restarts_total", 0) < 1:
            return "the hung worker was never restarted"
        h = run.sup.handles[1]
        if len(h.epochs) < 2 or h.epochs[-1] <= h.epochs[0]:
            return f"shard 1 takeover not at a higher epoch: {h.epochs}"
        return None

    return ScenarioSpec(
        name="proc-fleet-hang",
        description="supervised 2-shard fleet: a SIGSTOPped worker "
                    "misses its heartbeat deadline, is killed and "
                    "restarted fenced; the fleet converges",
        ticks=12,
        seed=seed,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", {
                "shards": 2, "distros": 4, "tasks": 32, "seed": 11,
                "hosts_per_distro": 3,
            }),
            Ev(2, "proc_hang", {"worker": 1}),
        ],
        slos=[
            SLO("bounded-restarts", "restarts_total", "<=", 3),
        ],
        checks=[("hang-resolved", hang_resolved)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def _sup_kill_midround_spec(seed: int = 0) -> ScenarioSpec:
    """The supervisor-survival centerpiece: the SUPERVISOR is SIGKILLed
    mid-round fan-out on a 2-shard fleet; both workers go orphan (shard
    leases kept, autonomous local ticks), a restarted supervisor steals
    the fleet lease at a higher epoch and ADOPTS both live workers —
    zero shard-lease epoch bumps, zero recovery passes, same pids
    (resident plane never re-primed) — and rounds resume to
    convergence with zero duplicate dispatch."""

    def adopted_live(run: ProcScenarioRun) -> Optional[str]:
        st = run.stats
        if st.get("sup_restarts", 0) < 1:
            return "the supervisor never restarted"
        if st.get("adoptions_total", 0) < 2:
            return (
                "both live workers must be adopted, got "
                f"{st.get('adoptions_total', 0)}"
            )
        if st.get("orphan_adoptions", 0) < 2:
            return "workers were not adopted FROM orphan mode"
        if st.get("adoption_epoch_bumps", 0):
            return "adoption bumped a shard-lease epoch"
        if st.get("adoption_pid_changes", 0):
            return "adoption changed a worker pid (cold respawn)"
        if st.get("adoption_recoveries", 0):
            return "an adopted worker reported a recovery pass"
        if st.get("restarts_total", 0):
            return "a worker was cold-restarted"
        return None

    return ScenarioSpec(
        name="proc-sup-kill-midround",
        description="2-shard fleet: supervisor killed mid-round "
                    "fan-out; workers orphan, the restarted "
                    "supervisor adopts both live (no epoch bumps, no "
                    "recovery), rounds resume, fleet converges",
        ticks=14,
        seed=seed,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", {
                "shards": 2, "distros": 4, "tasks": 32, "seed": 11,
                "hosts_per_distro": 3,
            }),
            Ev(2, "sup_kill", {"at": "mid_round"}),
            Ev(3, "sup_restart", {}),
        ],
        slos=[
            SLO("no-worker-restarts", "restarts_total", "<=", 0),
        ],
        checks=[("adopted-live", adopted_live)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def _sup_kill_midhandoff_spec(seed: int = 0) -> ScenarioSpec:
    """Supervisor killed BETWEEN the release and prime legs of a live
    migration: the released record is durable on the source, the
    target knows nothing — the successor's post-adoption
    ``reconcile_handoffs`` must converge to exactly-one-owner."""

    def handoff_reconciled(run: ProcScenarioRun) -> Optional[str]:
        st = run.stats
        if st.get("sup_restarts", 0) < 1:
            return "the supervisor never restarted"
        if st.get("adoptions_total", 0) < 2:
            return (
                "both live workers must be adopted, got "
                f"{st.get('adoptions_total', 0)}"
            )
        if st.get("reconciled_handoffs", 0) < 1:
            return (
                "the released-but-unprimed handoff was never "
                "reconciled by the successor"
            )
        return None

    return ScenarioSpec(
        name="proc-sup-kill-midhandoff",
        description="2-shard fleet: supervisor killed between the "
                    "release and prime handoff legs; the restarted "
                    "supervisor adopts the workers and reconciles to "
                    "exactly-one-owner",
        ticks=14,
        seed=seed,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", {
                "shards": 2, "distros": 4, "tasks": 32, "seed": 11,
                "hosts_per_distro": 3,
            }),
            Ev(2, "sup_kill", {"at": "mid_handoff"}),
            Ev(3, "sup_restart", {}),
        ],
        slos=[
            SLO("no-worker-restarts", "restarts_total", "<=", 0),
        ],
        checks=[("handoff-reconciled", handoff_reconciled)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


#: the solver-leader fleets need load on BOTH shards (the topology
#: hash-partitions distros; 2 distros can land on one shard, leaving
#: the other with nothing to publish and the leader declining the
#: single publication as partial) — 6 distros spreads reliably
_SOLVER_WORKLOAD = {
    "shards": 2, "distros": 6, "tasks": 36, "seed": 7,
    "hosts_per_distro": 3, "solver": "auto", "solver_timeout_s": 6.0,
}


def _check_solver_survived(run: "ProcScenarioRun") -> Optional[str]:
    """Shared acceptance for every leader-death weather: the fleet
    degraded to local (never corrupted), the successor re-elected at a
    higher epoch, and stacked rounds RESUMED after the restart."""
    st = run.stats
    if st.get("sup_restarts", 0) < 1:
        return "the supervisor never restarted"
    if st.get("solver_stacked_replies", 0) < 2:
        return (
            "fleet never produced a stacked round, got "
            f"{st.get('solver_stacked_replies', 0)} stacked replies"
        )
    if st.get("solver_reelections", 0) < 1:
        return "the successor never re-elected a solver leader"
    if st.get("solver_stale_accepted", 0):
        return (
            "a worker accepted a stale leader's result: "
            f"{st['solver_stale_accepted']}"
        )
    if st.get("shm_leaked", 0):
        return f"{st['shm_leaked']} solver shm segment(s) leaked"
    for i, rnd in enumerate(run.rounds):
        if i <= 3:
            continue  # pre-restart rounds don't prove recovery
        stacked = sum(
            1 for r in rnd.values() if r.get("solve") == "stacked"
        )
        if stacked >= 2:
            return None
    return "no fully stacked round after the supervisor restart"


def _leader_kill_spec(seam: str, slug: str,
                      seed: int = 0) -> ScenarioSpec:
    """Leader SIGKILL-shaped death at one solver seam on a 2-shard
    durable fleet: workers must degrade to local within the round
    (fenced at the shm header, never a torn fleet solve), orphan, get
    adopted by the successor, and return to stacked rounds under the
    successor's strictly-higher solver epoch."""
    return ScenarioSpec(
        name=f"proc-leader-kill-{slug}",
        description=f"2-shard solver fleet: leader dies at {seam}; "
                    "workers degrade to local, successor re-elects "
                    "and stacked rounds resume",
        ticks=14,
        seed=seed,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", dict(_SOLVER_WORKLOAD)),
            Ev(2, "leader_kill", {"seam": seam}),
            Ev(3, "sup_restart", {}),
        ],
        slos=[
            SLO("no-worker-restarts", "restarts_total", "<=", 0),
        ],
        checks=[("solver-survived", _check_solver_survived)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def _leader_kill_publish_spec(seed: int = 0) -> ScenarioSpec:
    return _leader_kill_spec("solver.publish", "publish", seed)


def _leader_kill_solve_spec(seed: int = 0) -> ScenarioSpec:
    return _leader_kill_spec("solver.solve", "solve", seed)


def _leader_kill_return_spec(seed: int = 0) -> ScenarioSpec:
    """The nastiest point: the leader dies AFTER writing the first
    shard's result — one shard got a solved column, the other must
    fence at out_seq and degrade local, and resume ≡ rerun still
    holds (stacked and local solves are bit-identical)."""
    return _leader_kill_spec("solver.return", "return", seed)


def _leader_kill_midround_spec(seed: int = 0) -> ScenarioSpec:
    return _leader_kill_spec("solver.round", "midround", seed)


def _leader_hang_spec(seed: int = 0) -> ScenarioSpec:
    """The leader stalls INSIDE the stacked solve, past the workers'
    solver timeout: both degrade to local that round; when the stalled
    solve finally lands its out_seq is from a finished round, so
    nobody accepts it, and the next round goes stacked again — no
    restart, no re-election, same leader."""

    def hang_degraded(run: ProcScenarioRun) -> Optional[str]:
        st = run.stats
        if st.get("solver_local_replies", 0) < 1:
            return "no round ever degraded to local solve"
        if st.get("solver_stale_accepted", 0):
            return (
                "a worker accepted the stalled leader's late result: "
                f"{st['solver_stale_accepted']}"
            )
        if st.get("shm_leaked", 0):
            return f"{st['shm_leaked']} solver shm segment(s) leaked"
        saw_local = False
        for rnd in run.rounds:
            solves = [r.get("solve") for r in rnd.values()]
            if "local" in solves:
                saw_local = True
            elif saw_local and solves.count("stacked") >= 2:
                return None
        return "no stacked round after the timeout-degraded one"

    return ScenarioSpec(
        name="proc-leader-hang",
        description="2-shard solver fleet: leader stalls inside the "
                    "stacked solve past the worker timeout; that "
                    "round degrades to local, the late result is "
                    "fenced at out_seq, stacked rounds resume",
        ticks=14,
        seed=seed,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", dict(_SOLVER_WORKLOAD)),
            Ev(2, "leader_hang",
               {"seam": "solver.solve", "delay_s": 8.0}),
        ],
        slos=[
            SLO("no-worker-restarts", "restarts_total", "<=", 0),
        ],
        checks=[("hang-degraded", hang_degraded)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def _net_oneway_partition_spec(seed: int = 0) -> ScenarioSpec:
    """The Jepsen one-way partition: supervisor→worker 0 commands are
    black-holed at the ``ipc.send.0`` seam while worker 0's heartbeats
    keep flowing the other way. The heartbeat watchdog must NOT kill a
    worker it can still hear (no split-brain restart); instead the
    worker's command-staleness deadline fires — it orphans, keeps its
    shard lease, and ticks locally — and when the partition heals the
    next delivered command clears orphan mode in place: zero cold
    restarts, zero epoch bumps, zero duplicate dispatch."""

    def partition_ridden_out(run: ProcScenarioRun) -> Optional[str]:
        h = run.sup.handles[0]
        if h.cmd_silences < 1:
            return (
                "worker 0 never tripped its command-staleness "
                "deadline (cmd_silences == 0)"
            )
        if run.stats.get("restarts_total", 0):
            return "the partitioned worker was cold-restarted"
        if len(h.epochs) != 1:
            return (
                f"worker 0 bumped its shard-lease epoch: {h.epochs}"
            )
        return None

    return ScenarioSpec(
        name="proc-net-oneway-partition",
        description="2-shard fleet: supervisor→worker commands "
                    "black-holed one way (heartbeats still flow); the "
                    "command-staleness deadline orphans the worker, "
                    "the heal un-orphans it in place — no restart, no "
                    "epoch bump, no duplicate dispatch",
        ticks=14,
        seed=seed,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", {
                "shards": 2, "distros": 4, "tasks": 32, "seed": 11,
                "hosts_per_distro": 3,
                # partitioned rounds must go partial FAST, and the
                # silence deadline must fire inside the blackout window
                "round_timeout_s": 4.0, "command_silence_s": 2.0,
            }),
            Ev(2, "net_fault", {"seam": "ipc.send.0",
                                "kind": "partition"}),
            Ev(5, "net_heal", {"seam": "ipc.send.0"}),
        ],
        slos=[
            SLO("no-worker-restarts", "restarts_total", "<=", 0),
        ],
        checks=[("partition-ridden-out", partition_ridden_out)],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


PROC_SCENARIOS: Dict[str, callable] = {
    "proc-fleet-sigkill": _proc_sigkill_spec,
    "proc-fleet-hang": _proc_hang_spec,
    "proc-sup-kill-midround": _sup_kill_midround_spec,
    "proc-sup-kill-midhandoff": _sup_kill_midhandoff_spec,
    "proc-leader-kill-publish": _leader_kill_publish_spec,
    "proc-leader-kill-solve": _leader_kill_solve_spec,
    "proc-leader-kill-return": _leader_kill_return_spec,
    "proc-leader-kill-midround": _leader_kill_midround_spec,
    "proc-leader-hang": _leader_hang_spec,
    "proc-net-oneway-partition": _net_oneway_partition_spec,
}

#: the supervisor-crash subset
SUP_KILL_SCENARIOS = ("proc-sup-kill-midround",
                      "proc-sup-kill-midhandoff")

#: the solver-leader death subset
SOLVER_SCENARIOS = ("proc-leader-kill-publish",
                    "proc-leader-kill-solve",
                    "proc-leader-kill-return",
                    "proc-leader-kill-midround",
                    "proc-leader-hang")


# --------------------------------------------------------------------------- #
# crash-matrix kill points
# --------------------------------------------------------------------------- #


def _crash_point_spec(seam: str, index: int,
                      ticks: int) -> ScenarioSpec:
    return ScenarioSpec(
        name=f"proc-crash-{seam.replace('.', '-')}-{index}",
        description=f"crash-matrix kill point {seam}@{index} through "
                    "the supervised-fleet backend",
        ticks=ticks,
        durable=True,
        deterministic=False,
        events=[
            Ev(0, "proc_fleet", {
                "shards": 1, "distros": 2, "tasks": 24, "seed": 11,
                "hosts_per_distro": 3,
            }),
        ],
        invariants=DEFAULT_PROC_INVARIANTS,
        tier1=False,
    )


def run_crash_point(
    seam: str,
    index: int,
    ticks: int = 9,
    reference: Optional[dict] = None,
    device=None,
) -> dict:
    """One classic crash-matrix kill point through the fleet runtime:
    a 1-shard supervised fleet whose worker is spawned with
    ``--crash seam@index`` (the deterministic kill point — only the
    FIRST spawn carries it; the supervisor's restart comes back clean),
    driven to convergence on ``device``, then checked against the
    crash-matrix contracts. Returns the point-result shape (``point`` /
    ``ok`` / ``crashed`` / ``epochs`` / ``parity_ok`` / ``problems``)."""
    spec = _crash_point_spec(seam, index, ticks)
    run = ProcScenarioRun(spec, with_reference=False, device=device)
    # splice the spawn-time kill point into the supervisor build —
    # only the FIRST spawn carries it; the watchdog's restart is clean
    orig_build = run._build_supervisor

    def build_with_crash():
        sup = orig_build()
        sup.spawn_crash = {0: f"{seam}@{index}"}
        return sup

    run._build_supervisor = build_with_crash
    if seam == "lease.renew":
        # the worker's renewer beats every ttl/3; a fleet whose rounds
        # take milliseconds would end before its later beats, so each
        # round waits one beat and the beat lands mid-run (the JAX
        # package's worker reaches them because its first tick compiles)
        real_wait = run._wait_fleet_healthy

        def paced(*a, **kw):
            real_wait(*a, **kw)
            _time.sleep(LEASE_TTL_S / 3.0)

        run._wait_fleet_healthy = paced
    run.reference_state = reference
    entry = run.execute()
    problems = [
        f"{section}:{name}: {v['detail']}"
        for section in ("invariants", "checks")
        for name, v in entry.get(section, {}).items()
        if not v["ok"]
    ]
    crashed = entry["stats"].get("crash_exits", 0) >= 1
    if not crashed:
        # lease.renew kill points can fire between rounds; a point that
        # never fired at all proves nothing
        problems.append("kill point never fired (no exit-86 death)")
    if reference is not None:
        parity_ok = not any(
            p.startswith("invariants:resume_equals_rerun")
            for p in problems
        )
    else:
        parity_ok = True
    return {
        "point": f"{seam}@{index}",
        "ok": crashed and not problems,
        "crashed": crashed,
        "rc": entry["stats"].get("restarts_total", 0),
        "epochs": [
            h for hd in ([] if run.sup is None else
                         run.sup.handles.values())
            for h in hd.epochs
        ],
        "parity_ok": parity_ok,
        "problems": problems,
        "entry": entry,
    }


def proc_reference_state(ticks: int = 9, device=None) -> dict:
    """The uninterrupted 1-shard fleet run of the crash workload on
    ``device`` — the rerun side every kill point compares against."""
    spec = _crash_point_spec("reference", 0, ticks)
    run = ProcScenarioRun(spec, with_reference=False, device=device)
    entry = run.execute()
    if not entry["ok"]:
        raise RuntimeError(
            f"proc crash reference failed: {entry['invariants']}"
        )
    return run.reference_canonical
