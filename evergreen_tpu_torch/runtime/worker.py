"""Shard worker: one scheduler shard in its own process.

A copy of ``evergreen_tpu/runtime/worker.py``.

    python -m evergreen_tpu_torch.runtime.worker --data-dir D --shard K --shards N [--device cpu]

opens shard K's durability domain inside the shared data dir — its OWN
writer lease (``storage/lease.py shard_lease_path``, fencing epochs and
all), its OWN fenced WAL segment + snapshot (``wal.shardK.log``;
``storage/durable.py`` ``shard_id``), its own TickCache / PersisterState
/ resident plane (per-store registries) — runs the startup recovery pass
(``scheduler/recovery.py``), and then takes commands from the supervisor
over stdin, one newline-JSON message per line (``runtime/protocol.py``):

  * ``tick`` runs ONE ``run_tick`` over the shard's subset on the
    worker's device and replies a ``round`` message with timing,
    degradation, level and, under a solver-leader stamp, how the shard
    met the leader (``stacked`` / ``local``);
  * the fenced-handoff legs (``release`` / ``prime`` / ``done``) move a
    distro's whole affinity group across the process boundary with the
    sharded plane's record shape and fenced-group idiom
    (``scheduler/sharded_plane.py``);
  * ``status`` answers the unfinished-task count, the tick index, the
    lease epoch and, a field of the port's own, this process's kernel
    launch counters (``launches``), which each ``round`` reply also
    carries, with the tick's ``planner`` and the card solves of
    ``ops/solve.py::run_solve_packed`` behind the counters
    (``card_solves``);
  * ``drain`` flushes the async WAL flusher and stops populating;
    ``shutdown`` additionally checkpoints, releases the lease and
    exits 0.

A heartbeat thread beats on the active channel every ``--hb-interval``;
the supervisor treats a missed deadline as a hang and SIGKILLs +
restarts. Any observation of a superseded lease epoch (a fenced commit,
a lost renewal) makes the worker print ``fenced`` and exit 75/70, which
the supervisor turns into a fenced restart at a strictly higher epoch.

**Surviving the supervisor.** stdin EOF (the supervisor died) does not
kill the worker: with ``--orphan-grace G`` > 0 it goes **orphan**, keeps
renewing its shard lease and drives autonomous LOCAL ticks on the
``--orphan-tick-s`` cadence for at most G seconds, then drains and
releases. Meanwhile it listens on a per-shard unix-domain control socket
recorded in the fleet manifest (``runtime/manifest.py``), so a restarted
supervisor can ``adopt`` it — same process, same shard-lease epoch, no
recovery pass, resident plane still warm. Every supervisor command
carries the supervisor-lease fencing epoch (``sup``); anything stamped
older than the highest epoch this worker has observed is answered
``stale_sup`` and NOT executed. ``--command-silence-s`` enters orphan
mode when an attached channel carries no command for that long (a
one-way partition).

**Departures from the JAX worker** (stated in the README and ROADMAP):

  * The worker runs on the card: ``run_tick`` and the solver client's
    local solve take ``device`` (None is the CUDA card, and ``main`` runs
    the backend probe first); ``--device cpu`` puts it on the CPU. The
    JAX supervisor pins its workers to the CPU because one process holds
    a TPU; a CUDA card is shared by processes.
  * A ``KernelError`` or ``MirrorError`` raised out of ``run_tick`` (the
    port's rule: a card fault is not work to move to the host) ends the
    worker: the error goes to stderr and it exits ``EXIT_KERNEL`` (1);
    the supervisor's watchdog restarts it at a higher epoch.
  * Under a solver-leader stamp the tick packs fresh at the stamp's
    common dims (``use_resident=False``, as the in-process plane's
    stacked round does). The JAX worker keeps its resident plane, which
    ignores ``force_dims``, so in service mode its shards' blocks keep
    their own slab dims and, unless those happen to agree, the leader
    declines every round as ``shape-drift``. The port's worker publishes
    by copying into its
    segment; JAX's zero-copy ``SolverClient.arena_backing`` is left out.

``agent_sim`` is the harness agent: it finishes every task in flight
(``mark_task_started``, then ``mark_end`` with success), dispatches
every free host in id order through a fresh ``DispatcherService``, and
replies ``agent_done``. Each tick writes its span tree to the worker's
store (``utils/tracing.py``). Left out (ROADMAP Queue 1): ``--bench``
mode (the benchmark).

``--crash seam@idx`` / ``--hang seam:delay_s`` install a fault plan at
spawn (``utils/faults.py``), and the ``arm_fault`` op installs entries
live mid-run.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
import time as _time
import traceback
from queue import Empty, Queue
from typing import List, Optional

from ..utils import lockcheck as _lockcheck
from . import manifest
from .protocol import EXIT_FENCED, EXIT_KERNEL, EXIT_LOST, parse_line, send_msg


def _launches() -> dict:
    """This process's kernel launch counters."""
    from ..ops.distro_stats import fused_distro_stats
    from ..ops.segment import segment_sum

    return {"fused_distro_stats": fused_distro_stats.launches,
            "segment_sum": segment_sum.launches,
            "segment_sum_by_plan": dict(segment_sum.launches_by_plan)}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evergreen_tpu_torch shard worker")
    p.add_argument("--data-dir", default="")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    p.add_argument("--ttl", type=float, default=10.0,
                   help="shard lease TTL (restart takeover latency)")
    p.add_argument("--lease-timeout", type=float, default=60.0,
                   help="how long to poll for the shard lease at boot")
    p.add_argument("--hb-interval", type=float, default=1.0)
    p.add_argument("--harness", action="store_true",
                   help="deterministic harness options: no intent hosts, "
                        "no underwater unschedule, no cache, sync persist")
    p.add_argument("--recovery-now", type=float, default=0.0,
                   help="virtual clock for the startup recovery pass "
                        "(0 = wall clock)")
    p.add_argument("--crash", default="",
                   help="seam@index fault-plan crash kill point")
    p.add_argument("--hang", default="",
                   help="seam:delay_s always-hang fault")
    p.add_argument("--sup-epoch", type=int, default=0,
                   help="spawning supervisor's fencing epoch; commands "
                        "stamped with an older 'sup' are rejected")
    p.add_argument("--generation", type=int, default=0,
                   help="supervisor spawn generation (recorded in the "
                        "fleet manifest)")
    p.add_argument("--orphan-grace", type=float, default=0.0,
                   help="seconds to keep serving after stdin EOF "
                        "(orphan mode; 0 = release and exit at once)")
    p.add_argument("--orphan-tick-s", type=float, default=15.0,
                   help="autonomous local-tick cadence while orphaned")
    p.add_argument("--command-silence-s", type=float, default=0.0,
                   help="attached-mode command-staleness deadline: after "
                        "this many seconds without an executed supervisor "
                        "command the worker enters orphan mode; 0 = off")
    return p


def _install_spawn_faults(args) -> None:
    from ..utils import faults

    plan = faults.FaultPlan()
    armed = False
    if args.crash:
        seam, _, idx = args.crash.partition("@")
        plan.at(seam.strip(), int(idx or 0), faults.Fault("crash"))
        armed = True
    if args.hang:
        seam, _, delay = args.hang.partition(":")
        plan.always(seam.strip(), faults.Fault("hang", delay_s=float(delay or 1.0)))
        armed = True
    if armed:
        faults.install(plan)


def _live_fault_plan():
    """The installed plan, installing an empty one on demand — the
    ``arm_fault`` op must work whether or not spawn-time faults armed."""
    from ..utils import faults

    plan = faults.active()
    if plan is None:
        plan = faults.install(faults.FaultPlan())
    return plan


class _Channel:
    """One control channel: the spawn-time stdio pair, or an accepted
    control-socket connection (the adoption path)."""

    def __init__(self, name: str, rfile, wfile, sock=None) -> None:
        self.name = name
        self.rfile = rfile
        self.wfile = wfile
        self.sock = sock

    def close(self) -> None:
        for f in (self.rfile, self.wfile, self.sock):
            if f is None:
                continue
            try:
                f.close()
            except (OSError, ValueError):
                pass


class ShardWorker:
    def __init__(self, args, proto_out) -> None:
        self.args = args
        self.device = args.device
        self.out_lock = _lockcheck.make_lock("runtime.worker.out")
        self.stdio = _Channel("stdio", sys.stdin, proto_out)
        #: the channel replies + heartbeats go to; switched by adoption
        self.active = self.stdio
        self.inbox: Queue = Queue()
        self.shard = args.shard
        self.n_shards = args.shards
        self.tick_index = 0
        self.last_round_ms = 0.0
        #: last supervisor-commanded tick 'now' — orphan-mode ticks extend
        #: THIS clock so a harness's virtual timeline stays coherent
        self.last_now = 0.0
        self.draining = False
        self._hb_stop = threading.Event()
        self.store = None
        self.lease = None
        #: highest supervisor fencing epoch observed; commands stamped
        #: older are rejected (split-brain guard)
        self.sup_epoch = int(args.sup_epoch or 0)
        self.stale_rejects = 0
        #: recovery passes this process has EVER run (1 = boot only); the
        #: adoption hello reports it
        self.recovery_passes = 0
        #: orphan-mode state: monotonic entry time (None = attached)
        self.orphaned_at: Optional[float] = None
        self._orphan_deadline = 0.0
        self._next_orphan_tick = 0.0
        self.orphan_ticks = 0
        #: command-staleness detection (one-way partition): monotonic time
        #: of the last EXECUTED supervisor command, and the trips
        self._last_cmd_mono = _time.monotonic()
        self.cmd_silences = 0
        self.listener = None
        self.sock_path = ""
        #: request id of the command being handled, echoed on every reply
        self._req = None
        #: solver-leader plane client (runtime/solver.py): created at the
        #: first tick carrying a solver stamp
        self.solver = None
        self._shm_name = ""
        self._shm_bytes = 0

    # -- lifecycle -------------------------------------------------------- #

    def send(self, **msg) -> bool:
        if self._req is not None and "req" not in msg:
            msg["req"] = self._req
        return send_msg(self.active.wfile, self.out_lock, **msg)

    def open(self) -> None:
        from ..scheduler.recovery import run_recovery_pass
        from ..storage.durable import DurableStore
        from ..storage.lease import FileLease, shard_lease_path

        lease = FileLease(shard_lease_path(self.args.data_dir, self.shard),
                          ttl_s=self.args.ttl)
        if not lease.acquire(timeout_s=self.args.lease_timeout, poll_s=0.1):
            self.send(op="error", detail="lease-timeout", shard=self.shard)
            os._exit(3)
        self.lease = lease
        # renewing starts BEFORE replay: a long boot must not get its lease
        # stolen mid-recovery. A lost lease is a process exit
        lease.start_renewing(on_lost=self._deposed)
        self.store = DurableStore(self.args.data_dir, lease=lease, shard_id=self.shard)
        t0 = _time.perf_counter()
        report = run_recovery_pass(self.store, now=self.args.recovery_now or None)
        recovery_ms = (_time.perf_counter() - t0) * 1e3
        self.recovery_passes += 1
        # re-attachable control socket + manifest entry BEFORE hello: from
        # the first ready moment on, a restarted supervisor can adopt us
        self._start_listener()
        self._write_manifest()
        self.send(
            op="hello", shard=self.shard, pid=os.getpid(), epoch=lease.epoch,
            recovered={
                "released_claims": len(report.released_claims),
                "stranded_reset": len(report.stranded_reset),
                "stale_frames_dropped": report.stale_frames_dropped,
            },
            recovery_ms=round(recovery_ms, 3),
        )

    def _deposed(self) -> None:  # renewer thread
        self.send(op="fenced", shard=self.shard, reason="lease-lost")
        self._cleanup_manifest()
        os._exit(EXIT_LOST)

    def _fenced_exit(self, reason: str) -> None:
        self.send(op="fenced", shard=self.shard, reason=reason)
        self._cleanup_manifest()
        os._exit(EXIT_FENCED)

    def start_heartbeat(self) -> None:
        def beat():
            while not self._hb_stop.wait(self.args.hb_interval):
                # a failed send (dead supervisor) is NOT an exit: the orphan
                # path keeps the worker alive for adoption
                self.send(op="heartbeat", shard=self.shard, ts=_time.time(),
                          stale_rejects=self.stale_rejects,
                          cmd_silences=self.cmd_silences,
                          orphan=self.orphaned_at is not None)

        threading.Thread(target=beat, daemon=True, name=f"shard{self.shard}-hb").start()

    # -- manifest + control socket (runtime/manifest.py) ------------------ #

    def _start_listener(self) -> None:
        import socket as socket_mod

        path = manifest.socket_path(self.args.data_dir, self.shard)
        try:
            os.unlink(path)  # this worker's own stale control socket
        except OSError:
            pass
        srv = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
        srv.bind(path)
        try:
            os.chmod(path, 0o600)
        except OSError:
            pass
        srv.listen(4)
        self.listener = srv
        self.sock_path = path

        def accept_loop():
            n = 0
            while True:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return  # listener closed: shutting down
                n += 1
                chan = _Channel(f"sock{n}", conn.makefile("r", encoding="utf-8"),
                                conn.makefile("w", encoding="utf-8"), sock=conn)
                self._start_channel_reader(chan)

        threading.Thread(target=accept_loop, daemon=True,
                         name=f"shard{self.shard}-accept").start()

    def _write_manifest(self) -> None:
        if not self.sock_path:
            return
        manifest.write_entry(
            self.args.data_dir, self.shard, pid=os.getpid(),
            sock=self.sock_path, generation=self.args.generation,
            epoch=self.lease.epoch if self.lease else 0,
            shm=self._shm_name, shm_bytes=self._shm_bytes,
        )

    def _cleanup_manifest(self) -> None:
        if self.solver is not None:
            # every exit path unlinks this shard's solver segment; what
            # leaks is caught by the supervisor's reap_orphan_segments
            self.solver.close(unlink=True)
            self.solver = None
        if self.listener is not None:
            try:
                self.listener.close()
            except OSError:
                pass
            self.listener = None
        if self.sock_path:
            manifest.remove_entry(self.args.data_dir, self.shard, self.sock_path)

    def _start_channel_reader(self, chan: _Channel) -> None:
        def read():
            try:
                for line in chan.rfile:
                    msg = parse_line(line)
                    if msg is None:
                        continue  # torn/garbage line: skip, never die
                    self.inbox.put(("cmd", msg, chan))
            except (OSError, ValueError):
                pass
            self.inbox.put(("eof", None, chan))

        threading.Thread(target=read, daemon=True,
                         name=f"shard{self.shard}-read-{chan.name}").start()

    # -- supervisor fencing + adoption ------------------------------------ #

    def _reject_stale(self, msg: dict, chan: _Channel, reason: str) -> None:
        """Answer (and count) a command from a superseded — or never
        adopted — supervisor. The command is NOT executed."""
        self.stale_rejects += 1
        send_msg(chan.wfile, self.out_lock, op="stale_sup", shard=self.shard,
                 req=msg.get("req"), rejected_op=msg.get("op"), reason=reason,
                 sup_seen=self.sup_epoch, got=msg.get("sup"))

    def _handle_adopt(self, msg: dict, chan: _Channel) -> None:
        """A (re)connecting supervisor takes this live worker over: no
        respawn, no shard-lease epoch bump, no recovery pass. A NEW channel
        must present a STRICTLY higher supervisor epoch (a successor steals
        the fleet lease at one; a rogue that read the lease file can only
        replay the current epoch); re-adoption over the already-active
        channel may carry the same epoch."""
        sup = int(msg.get("sup", 0) or 0)
        if sup < self.sup_epoch or (chan is not self.active and sup == self.sup_epoch):
            self._reject_stale(msg, chan, reason="stale-epoch")
            return
        self.sup_epoch = sup
        was_orphan = self.orphaned_at is not None
        self.orphaned_at = None
        old = self.active
        self.active = chan
        if old is not None and old is not chan and old is not self.stdio:
            old.close()  # a superseded adoption socket
        self._write_manifest()
        self.send(op="hello", req=msg.get("req"), shard=self.shard,
                  pid=os.getpid(), epoch=self.lease.epoch, adopted=True,
                  orphaned=was_orphan, orphan_ticks=self.orphan_ticks,
                  tick=self.tick_index, stale_rejects=self.stale_rejects,
                  recovery_passes=self.recovery_passes)

    # -- orphan mode ------------------------------------------------------- #

    def _enter_orphan(self, reason: str = "stdin EOF") -> None:
        self.orphaned_at = _time.monotonic()
        self._orphan_deadline = self.orphaned_at + self.args.orphan_grace
        self._next_orphan_tick = self.orphaned_at + self.args.orphan_tick_s
        print(f"shard {self.shard}: supervisor gone ({reason}) — orphan mode "
              f"for {self.args.orphan_grace}s (lease kept, local ticks every "
              f"{self.args.orphan_tick_s}s)", file=sys.stderr)

    def _autonomous_tick(self) -> None:
        """One LOCAL tick while orphaned: no handoffs, no rebalance, no
        stacked rounds — what an orphan has no coordinator for."""
        from ..scheduler.wrapper import run_tick

        if self.draining:
            return
        self.orphan_ticks += 1
        if self.last_now:
            now = self.last_now + self.orphan_ticks * self.args.orphan_tick_s
        else:
            now = _time.time()
        res = run_tick(self.store, self.tick_options(), now=now, device=self.device)
        if res.degraded == "fenced" or self.lease.lost:
            self._fenced_exit("fenced-orphan-tick")
        self.tick_index += 1

    def tick_options(self):
        from ..scheduler.wrapper import TickOptions

        if self.args.harness:
            return TickOptions(create_intent_hosts=False,
                               underwater_unschedule=False, use_cache=False)
        # service mode: the options units/crons.py passes a sharded round
        from ..units.crons import service_tick_options

        return service_tick_options()

    def _solver_options(self, opts, sol: dict):
        """Wire this round's solver-leader stamp into the tick: the
        leader's cross-process solve_fn plus its common-dims floor, so
        every shard publishes at the same padded shape and ONE stacked
        solve serves the round. The tick packs fresh at that floor
        (``use_resident=False``: the resident slabs' layouts are per
        shard). A failing or absent leader degrades to the local
        ``run_solve_packed`` inside the solve_fn."""
        from .solver import SolverClient

        if self.solver is None:
            self.solver = SolverClient(self.args.data_dir, self.shard,
                                       on_segment_change=self._on_shm_change,
                                       device=self.device)
        dims = sol.get("dims")
        force = {k: int(v) for k, v in dims.items()} if dims else opts.force_dims
        # "skipped" survives when the tick never reaches the solve at all
        self.solver.last_solve = "skipped"
        self.solver.last_cause = ""
        return dataclasses.replace(
            opts,
            use_resident=False,
            solve_fn=self.solver.solve_fn(int(sol.get("epoch", 0)),
                                          int(sol.get("seq", 0)),
                                          float(sol.get("timeout_s", 10.0))),
            force_dims=force,
        )

    def _on_shm_change(self, name: str, nbytes: int) -> None:
        self._shm_name = name
        self._shm_bytes = nbytes
        self._write_manifest()

    # -- ops -------------------------------------------------------------- #

    def op_tick(self, msg: dict) -> None:
        from ..scheduler.wrapper import run_tick

        if self.draining:
            self.send(op="round", shard=self.shard, skipped="draining",
                      tick=self.tick_index)
            return
        now = float(msg.get("now") or _time.time())
        self.last_now = now
        opts = self.tick_options()
        sol = msg.get("solver")
        if sol:
            opts = self._solver_options(opts, sol)
        t0 = _time.perf_counter()
        res = run_tick(self.store, opts, now=now, device=self.device)
        ms = (_time.perf_counter() - t0) * 1e3
        self.last_round_ms = ms
        if res.degraded == "fenced" or self.lease.lost:
            self._fenced_exit("fenced-tick")
        reply = dict(op="round", shard=self.shard, tick=self.tick_index,
                     ms=round(ms, 3), n_tasks=res.n_tasks,
                     n_distros=res.n_distros, degraded=res.degraded,
                     level=res.overload, epoch=self.lease.epoch,
                     queued=sum(res.queues.values()))
        if sol and self.solver is not None:
            reply["solve"] = self.solver.last_solve
            reply["solve_cause"] = self.solver.last_cause
            reply["solve_stale_accepted"] = self.solver.stale_accepted
        # the port's own fields: the tick's planner, this process's
        # kernel counters and the card solves behind them
        from ..ops.solve import CARD_SOLVES

        reply["planner"] = res.planner_used
        reply["launches"] = _launches()
        reply["card_solves"] = dict(CARD_SOLVES)
        self.send(**reply)
        self.tick_index += 1

    def op_agent_sim(self, msg: dict) -> None:
        """Deterministic harness agent: finish everything in flight,
        then dispatch every free host from this shard's queues — the
        real CAS pair, including its crash seam."""
        from ..dispatch.assign import assign_next_available_task
        from ..dispatch.dag_dispatcher import DispatcherService
        from ..globals import TaskStatus
        from ..models import host as host_mod
        from ..models import task as task_mod
        from ..models.lifecycle import mark_end, mark_task_started

        now = float(msg.get("now") or _time.time())
        c = task_mod.coll(self.store)
        in_flight = sorted(
            d["_id"] for d in c.find(
                lambda d: d["status"] in (
                    TaskStatus.DISPATCHED.value, TaskStatus.STARTED.value,
                )
            )
        )
        for tid in in_flight:
            mark_task_started(self.store, tid, now=now)
            mark_end(self.store, tid, TaskStatus.SUCCEEDED.value, now=now)
        svc = DispatcherService(self.store)  # fresh: no TTL staleness
        dispatched = 0
        hosts = sorted(
            (h for h in host_mod.find(self.store)
             if h.can_run_tasks() and not h.running_task),
            key=lambda h: h.id,
        )
        for h in hosts:
            if assign_next_available_task(
                self.store, svc, h, now=now
            ) is not None:
                dispatched += 1
        unfinished = c.count(
            lambda d: d["status"] not in (
                TaskStatus.SUCCEEDED.value, TaskStatus.FAILED.value,
            )
        )
        self.send(op="agent_done", shard=self.shard,
                  dispatched=dispatched, unfinished=unfinished)

    def op_status(self, msg: dict) -> None:
        from ..globals import TaskStatus

        unfinished = self.store.collection("tasks").count(
            lambda d: d["status"] not in (TaskStatus.SUCCEEDED.value,
                                          TaskStatus.FAILED.value))
        self.send(op="status", shard=self.shard, unfinished=unfinished,
                  tick=self.tick_index, epoch=self.lease.epoch,
                  launches=_launches())

    def _topology(self):
        from ..parallel.topology import ShardTopology

        topo = ShardTopology(self.n_shards)
        topo.affinity = ShardTopology.affinity_from_store(self.store)
        return topo

    def op_load(self, msg: dict) -> None:
        """Rebalancing input: schedulable-task count per affinity group on
        THIS shard plus the last round's wall time."""
        from ..globals import TaskStatus

        topo = self._topology()
        counts: dict = {}
        for doc in self.store.collection("tasks").find(
            lambda d: d.get("status") == TaskStatus.UNDISPATCHED.value
            and d.get("activated")
        ):
            did = doc.get("distro_id", "")
            if did:
                counts[did] = counts.get(did, 0) + 1
        groups: dict = {}
        reps: dict = {}
        for doc in self.store.collection("distros").find():
            did = doc["_id"]
            rep = topo.placement_key(did)
            groups[rep] = groups.get(rep, 0) + counts.get(did, 0)
            reps.setdefault(rep, did)
        self.send(op="load", shard=self.shard, groups=groups, reps=reps,
                  round_ms=round(self.last_round_ms, 3))

    def op_handoffs(self, msg: dict) -> None:
        from ..scheduler.sharded_plane import HANDOFF_WATERMARK_ID, HANDOFFS_COLLECTION

        records = []
        max_seq = 0
        for d in self.store.collection(HANDOFFS_COLLECTION).find():
            # the seq high-water counts EVERY record, done and watermark
            # included, or a restarted supervisor would mint colliding ids
            max_seq = max(max_seq, int(d.get("seq", 0) or 0))
            if (d.get("state") not in ("done", "watermark")
                    and d.get("_id") != HANDOFF_WATERMARK_ID):
                records.append(dict(d))
        self.send(op="handoffs", shard=self.shard, records=records, max_seq=max_seq)

    def op_release(self, msg: dict) -> None:
        """Handoff leg 1 on the source shard: the sharded plane's record
        shape and fenced group (``apply_release``)."""
        from ..scheduler.sharded_plane import apply_release, handoff_payload, handoff_record
        from ..storage.lease import EpochFencedError

        distro_id = msg["distro"]
        target = int(msg["target"])
        seq = int(msg.get("seq", 1))
        now = float(msg.get("now") or _time.time())
        topo = self._topology()
        rep = topo.placement_key(distro_id)
        group = sorted(doc["_id"] for doc in self.store.collection("distros").find()
                       if topo.placement_key(doc["_id"]) == rep)
        if not group:
            self.send(op="error", detail=f"distro {distro_id!r} not on shard {self.shard}")
            return
        payload = handoff_payload(self.store, group)
        rec = handoff_record(distro_id, group, self.shard, target, seq, now, payload)
        try:
            apply_release(self.store, rec)
        except EpochFencedError:
            self._fenced_exit("fenced-release")
        except Exception as exc:  # noqa: BLE001 — converge durable state to
            # the in-memory truth; the supervisor's reconciliation finishes
            # the handoff
            try:
                self.store.heal_durability()
            except Exception:  # noqa: BLE001 — reconciliation converges anyway
                pass
            self.send(op="error", detail=f"release failed: {exc!r}")
            return
        self.send(op="released", shard=self.shard, record=rec)

    def op_prime(self, msg: dict) -> None:
        """Handoff leg 2 on the target shard (``apply_prime``: idempotent,
        reconciliation re-runs it)."""
        from ..scheduler.sharded_plane import apply_prime
        from ..storage.lease import EpochFencedError

        rec = msg["record"]
        try:
            apply_prime(self.store, rec)
        except EpochFencedError:
            self._fenced_exit("fenced-prime")
        self.send(op="primed", shard=self.shard, handoff=rec["_id"])

    def op_done(self, msg: dict) -> None:
        from ..scheduler.sharded_plane import HANDOFFS_COLLECTION
        from ..storage.lease import EpochFencedError

        hid = msg["handoff"]
        try:
            self.store.collection(HANDOFFS_COLLECTION).update(hid, {"state": "done"})
        except EpochFencedError:
            self._fenced_exit("fenced-done")
        self.send(op="done", shard=self.shard, handoff=hid)

    def op_arm_fault(self, msg: dict) -> None:
        """Install one fault-plan entry live (kind 'crash' dies AT the
        named seam, SIGKILL-shaped)."""
        from ..utils import faults

        plan = _live_fault_plan()
        seam = msg["seam"]
        fault = faults.Fault(msg.get("kind", "crash"),
                             delay_s=float(msg.get("delay_s", 0.0)))
        if msg.get("always"):
            plan.always(seam, fault)
        else:
            at = msg.get("at")
            idx = int(at) if at is not None else plan._calls.get(seam, 0)
            plan.at(seam, idx, fault)
        self.send(op="armed", shard=self.shard, seam=seam, kind=fault.kind)

    def op_drain(self, msg: dict) -> None:
        self.draining = True
        self.store.sync_persist()
        self.send(op="drained", shard=self.shard, epoch=self.lease.epoch)

    def op_shutdown(self, msg: dict) -> None:
        self._hb_stop.set()
        try:
            self.store.sync_persist()
            self.store.close()
        except Exception:  # noqa: BLE001 — a fenced store refuses the final
            # checkpoint; the lease release below still runs
            pass
        self.lease.release()
        self._cleanup_manifest()
        self.send(op="bye", shard=self.shard)
        os._exit(0)

    # -- the command loop ------------------------------------------------- #

    OPS = {
        "tick": op_tick,
        "agent_sim": op_agent_sim,
        "status": op_status,
        "load": op_load,
        "handoffs": op_handoffs,
        "release": op_release,
        "prime": op_prime,
        "done": op_done,
        "arm_fault": op_arm_fault,
        "drain": op_drain,
        "shutdown": op_shutdown,
    }

    def _handle_cmd(self, msg: dict, chan: _Channel) -> None:
        op = msg.get("op")
        if chan is not self.active:
            # only adoption may arrive on a not-yet-adopted channel
            if op == "adopt":
                self._handle_adopt(msg, chan)
            else:
                self._reject_stale(msg, chan, reason="channel-not-adopted")
            return
        sup = msg.get("sup")
        if sup is not None:
            sup = int(sup)
            if sup < self.sup_epoch:
                self._reject_stale(msg, chan, reason="stale-epoch")
                return
            self.sup_epoch = sup
        # an accepted command proves the supervisor reaches us: refresh the
        # silence clock, and a one-way partition's orphan mode ends here
        self._last_cmd_mono = _time.monotonic()
        if self.orphaned_at is not None and op != "adopt":
            self.orphaned_at = None
            print(f"shard {self.shard}: supervisor commands resumed — leaving "
                  "orphan mode (partition healed)", file=sys.stderr)
        if op == "adopt":  # re-adoption over the already-active channel
            self._handle_adopt(msg, chan)
            return
        handler = self.OPS.get(op)
        if handler is None:
            self.send(op="error", req=msg.get("req"), detail=f"unknown op {op!r}")
            return
        self._req = msg.get("req")
        try:
            handler(self, msg)
        finally:
            self._req = None

    def run(self) -> int:
        from ..ops._build import KernelError
        from ..ops.resident_ops import MirrorError
        from ..storage.lease import EpochFencedError

        self.open()
        self.start_heartbeat()
        self._start_channel_reader(self.stdio)
        silence_s = float(self.args.command_silence_s or 0.0)
        while True:
            timeout = None
            if self.orphaned_at is not None:
                due = min(self._orphan_deadline, self._next_orphan_tick)
                timeout = max(0.0, due - _time.monotonic())
            elif silence_s > 0:
                # attached but bounded: wake when the silence deadline would
                # expire instead of blocking on a one-way partitioned channel
                timeout = max(0.0, self._last_cmd_mono + silence_s - _time.monotonic())
            try:
                kind, payload, chan = self.inbox.get(timeout=timeout)
            except Empty:
                kind, payload, chan = None, None, None
            try:
                if kind == "cmd":
                    self._handle_cmd(payload, chan)
                elif kind == "eof":
                    if chan is self.active:
                        if self.args.orphan_grace <= 0:
                            break  # EOF = release and exit
                        if self.orphaned_at is None:
                            self._enter_orphan()
                    elif chan is not self.stdio:
                        chan.close()  # a dropped foreign connection
                if (self.orphaned_at is None and silence_s > 0
                        and self.args.orphan_grace > 0
                        and _time.monotonic() - self._last_cmd_mono >= silence_s):
                    # one-way partition: the channel is open but silent past
                    # the deadline — go orphan; a resumed command heals it
                    self.cmd_silences += 1
                    self._enter_orphan(reason=f"command silence {silence_s:g}s")
                if self.orphaned_at is not None:
                    now_m = _time.monotonic()
                    if now_m >= self._orphan_deadline:
                        break  # grace expired: drain and go
                    if now_m >= self._next_orphan_tick:
                        self._autonomous_tick()
                        self._next_orphan_tick = _time.monotonic() + self.args.orphan_tick_s
            except EpochFencedError:
                self._fenced_exit("fenced-op")
            except (KernelError, MirrorError):
                # a card fault ends the worker; the supervisor restarts it
                # at a higher epoch (never a CPU solve in its place)
                traceback.print_exc(file=sys.stderr)
                sys.stderr.flush()
                self._cleanup_manifest()
                os._exit(EXIT_KERNEL)
        # supervisor gone for good (EOF with orphan mode off, or the orphan
        # grace expired un-adopted) — drain, release, exit
        self._hb_stop.set()
        self.draining = True
        try:
            self.store.close()
        except Exception:  # noqa: BLE001 — a fenced or broken store on the
            # final drain; the lease release + manifest cleanup still run
            pass
        self.lease.release()
        self._cleanup_manifest()
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    from ..utils.torchenv import ensure_usable_backend

    ensure_usable_backend(device=args.device)
    # the protocol channel is a private dup of stdout; anything that still
    # prints to sys.stdout lands on stderr instead of corrupting the stream
    proto_out = os.fdopen(os.dup(1), "w", encoding="utf-8")
    sys.stdout = sys.stderr
    _install_spawn_faults(args)
    if not args.data_dir:
        print("--data-dir is required", file=sys.stderr)
        return 2
    return ShardWorker(args, proto_out).run()


if __name__ == "__main__":
    raise SystemExit(main())
