"""Fleet supervisor: spawn, watch, restart, and drive N shard workers.

A copy of ``evergreen_tpu/runtime/supervisor.py``. One
``FleetSupervisor`` owns the process-per-shard deployment of the sharded
control plane: it spawns one ``runtime/worker.py`` process per shard over
one shared data dir, consumes their heartbeats, and drives fleet rounds
(one ``tick`` command per worker per round) plus ladder-driven
rebalancing via the fenced-handoff control messages (``release`` →
``prime`` → ``done``).

**Crash-restart with fenced takeover.** A worker that exits — or hangs
past its heartbeat deadline and is SIGKILLed — is respawned with
exponential backoff (``utils/retry.py`` ``RetryPolicy.backoff_s``). The
replacement steals the shard's lease at a strictly higher fencing epoch,
so anything the dead worker still had buffered is rejected at the WAL
fence; its startup recovery pass and the supervisor's handoff
reconciliation make the restart convergent.

**Surviving its own death.** The supervisor holds a fleet-scope
``FileLease`` (``supervisor_lease_path``) whose epoch stamps every
command (``sup``); workers reject anything older (``stale_sup``), and a
deposed supervisor stands down without touching the workers. Workers go
orphan on stdin EOF, and a restarted supervisor adopts them over their
control sockets through the fleet manifest (no respawn, no epoch bump,
no recovery pass), then reconciles handoffs first thing.

**The solver leader.** With ``solver`` other than ``"never"`` and two or
more shards, the supervisor elects itself the solver leader
(``runtime/solver.py::SolverService``) and serves one stacked solve per
round over the workers' shared-memory publications.

**Departures from the JAX supervisor** (stated in the README and
ROADMAP):

  * Workers run on the supervisor's device. ``device=None`` is the CUDA
    card (and raises without one); the supervisor passes ``--device
    cpu`` to its workers, and builds its leader on the CPU, only when
    the caller asks for the CPU. The JAX supervisor pins every worker to
    the CPU (``JAX_PLATFORMS=cpu``) because one process holds a TPU; a
    CUDA card is shared by processes.
  * Solver election follows the in-process plane's rule:
    ``solver="always"`` elects the leader and stacks on the one card;
    ``"auto"`` keeps JAX's count (``torch.cuda.device_count()``, 1 on the
    CPU, against the shard count), so one card gives local solves in the
    workers, on the card; ``"never"`` elects no leader.

Left out (ROADMAP Queue 1): ``agent_sim`` (dispatch), the ``fleet.round``
tracing span (tracing), the IPC taps (journal taps), the transport-fault
seams ``ipc.send`` / ``ipc.recv`` / ``sock.adopt``, and
``attach_fleet_supervisor`` / ``peek_fleet_supervisor`` (the REST admin
surface, their caller).
"""
from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time as _time
from queue import Empty, Queue
from typing import Dict, List, Optional

import torch

from ..device import resolve_device
from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics
from ..utils.log import get_logger
from ..utils.retry import Deadline, RetryPolicy
from . import manifest as manifest_mod
from .protocol import EXIT_CRASHED, parse_line, send_msg

#: synthetic exit code for an adopted worker found dead: its real exit
#: status went to the dead supervisor (or init) — unobservable here
EXIT_GONE = 113

FLEET_RESTARTS = _metrics.counter(
    "scheduler_fleet_restarts_total",
    "Shard worker processes respawned by the supervisor after an exit "
    "or a missed-heartbeat kill, labeled by shard.",
    labels=("shard",),
)
FLEET_HB_MISSES = _metrics.counter(
    "scheduler_fleet_heartbeat_misses_total",
    "Workers SIGKILLed for missing their heartbeat deadline (hang or "
    "pipe partition), labeled by shard.",
    labels=("shard",),
)
FLEET_ROUNDS = _metrics.counter(
    "scheduler_fleet_rounds_total",
    "Supervised fleet rounds by outcome: 'full' (every shard replied), "
    "'partial' (a shard was down or timed out), 'empty' (no worker was "
    "ready).",
    labels=("outcome",),
)
FLEET_HANDOFFS = _metrics.counter(
    "scheduler_fleet_handoffs_total",
    "Cross-process fenced-handoff protocol steps driven over worker "
    "control messages, by source shard and step outcome.",
    labels=("shard", "outcome"),
)
FLEET_ROUND_MS = _metrics.histogram(
    "scheduler_fleet_round_duration_ms",
    "Wall time of one supervised fleet round (slowest worker gates).",
)
FLEET_WORKERS_UP = _metrics.gauge(
    "scheduler_fleet_workers_up",
    "1 while the shard's worker process is ready (hello received, "
    "heartbeats current), else 0.",
    labels=("shard",),
)
FLEET_ADOPTIONS = _metrics.counter(
    "scheduler_fleet_adoptions_total",
    "Live shard workers adopted by a (re)starting supervisor over "
    "their control sockets instead of being cold-respawned (no "
    "shard-lease epoch bump, no recovery pass), labeled by shard.",
    labels=("shard",),
)
FLEET_ORPHANED = _metrics.counter(
    "scheduler_fleet_orphaned_workers_total",
    "Adopted workers that had entered orphan mode (supervisor died, "
    "worker kept its lease and ticked locally until adoption), "
    "labeled by shard.",
    labels=("shard",),
)
FLEET_STALE_REJECTS = _metrics.counter(
    "scheduler_fleet_stale_supervisor_rejects_total",
    "Commands a worker rejected because they carried a superseded "
    "supervisor fencing epoch (split-brain guard; reported through "
    "worker heartbeats), labeled by shard.",
    labels=("shard",),
)
FLEET_SUP_EPOCH = _metrics.gauge(
    "scheduler_fleet_supervisor_epoch",
    "This supervisor's fleet-lease fencing epoch (0 until the fleet "
    "lease is acquired; monotone across supervisor restarts).",
)
FLEET_CMD_SILENCE = _metrics.counter(
    "scheduler_fleet_command_silence_total",
    "Workers that stopped hearing supervisor commands past the "
    "command-staleness deadline and entered orphan mode (one-way "
    "partition detection: heartbeats flow out, commands never arrive; "
    "reported through worker heartbeats), labeled by shard.",
    labels=("shard",),
)
IPC_STALE_REPLIES = _metrics.counter(
    "runtime_ipc_stale_replies_total",
    "Late or duplicated control-IPC replies for an already-completed "
    "request id, counted and dropped by wait_reply so a reordered "
    "or duplicated reply can never satisfy a newer wait, labeled by "
    "shard.",
    labels=("shard",),
)

_LEVELS = {"green": 0, "yellow": 1, "red": 2, "black": 3}


class WorkerHandle:
    """One shard's process + protocol state. The reader thread drains
    stdout: heartbeats refresh the deadline in place, everything else
    lands on the reply queue for whoever is mid-request."""

    def __init__(self, shard: int, hb_deadline_s: float) -> None:
        self.shard = shard
        self.proc: Optional[subprocess.Popen] = None
        self.state = "new"  # new|starting|ready|backoff|stopping|stopped
        #: bumped per spawn: a request outstanding against generation g
        #: stops waiting when the watchdog respawns the worker
        self.generation = 0
        self._req_counter = 0
        self.replies: Queue = Queue()
        self.send_lock = _lockcheck.make_lock("runtime.supervisor.send")
        self.hb_deadline_s = hb_deadline_s
        self.hb_deadline = Deadline.after(None)
        self.epochs: List[int] = []
        self.exits: List[int] = []
        #: each boot's hello (recovery summary and ms) in order
        self.hellos: List[dict] = []
        self.restarts = 0
        self.consecutive_failures = 0
        #: monotonic time of the last hello — the failure streak resets
        #: only after a SUSTAINED healthy period, not on hello itself
        self.ready_since = 0.0
        self.next_spawn_at = 0.0
        self.backoffs: List[float] = []
        self.level = "green"
        self.last_round: Dict = {}
        self.garbage_lines = 0
        self.pid = 0
        #: supervisor fencing epoch stamped on every command sent
        self.sup_epoch = 0
        #: adoption transport (no Popen): socket + its file pair
        self.conn = None
        self._conn_w = None
        self._conn_r = None
        self.adopted = False
        self.adopt_hello: Dict = {}
        self.orphan = False
        self.stale_rejects = 0
        self.cmd_silences = 0
        #: completed (answered or timed-out) request ids — a late or
        #: duplicated reply for one of these is counted and dropped
        self._done_reqs: Dict[int, None] = {}

    @property
    def epoch(self) -> int:
        return self.epochs[-1] if self.epochs else 0

    def _pid_gone(self) -> bool:
        """True when the adopted worker's pid is gone (reaping the zombie
        first when we happen to be its parent)."""
        try:
            done, _ = os.waitpid(self.pid, os.WNOHANG)
            if done == self.pid:
                return True
        except (ChildProcessError, OSError):
            pass
        try:
            os.kill(self.pid, 0)
            return False
        except OSError:
            return True

    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        if self.conn is not None and self.pid:
            return not self._pid_gone()
        return False

    def poll_exit(self) -> Optional[int]:
        """Exit code when the worker process is gone, else None. Adopted
        workers report the synthetic ``EXIT_GONE``."""
        if self.proc is not None:
            return self.proc.poll()
        if self.conn is not None and self.pid:
            return EXIT_GONE if self._pid_gone() else None
        return None

    def kill(self) -> None:
        try:
            if self.proc is not None:
                self.proc.kill()
            elif self.pid:
                os.kill(self.pid, signal.SIGKILL)
        except OSError:
            pass

    def close_conn(self) -> None:
        for f in (self._conn_w, self._conn_r, self.conn):
            if f is None:
                continue
            try:
                f.close()
            except (OSError, ValueError):
                pass
        self.conn = self._conn_w = self._conn_r = None
        self.adopted = False

    def send(self, **msg) -> bool:
        if not self.alive():
            return False
        if self.sup_epoch and "sup" not in msg:
            # every command carries the supervisor fencing epoch
            msg["sup"] = self.sup_epoch
        w = self.proc.stdin if self.proc is not None else self._conn_w
        if w is None:
            return False
        return send_msg(w, self.send_lock, **msg)

    def next_req(self) -> int:
        self._req_counter += 1
        return self._req_counter

    def wait_reply(self, op: str, timeout_s: float,
                   req: Optional[int] = None) -> Optional[dict]:
        """Next reply matching ``op`` (and the echoed request id when
        given). Stale/unsolicited ops are dropped; ``fenced`` / ``error``
        / ``stale_sup`` end the wait; so do a worker death or a respawn."""
        gen = self.generation
        deadline = Deadline.after(timeout_s)
        try:
            while not deadline.exceeded():
                try:
                    msg = self.replies.get(
                        timeout=max(0.05, min(0.25, deadline.remaining())))
                except Empty:
                    if not self.alive() or self.generation != gen:
                        return None
                    if self.state == "stopped":
                        return None  # a crashed supervisor closed the handle
                    continue
                mreq = msg.get("req")
                if mreq is not None and mreq in self._done_reqs:
                    # a late reply for a request already answered or timed
                    # out must never satisfy a newer wait
                    IPC_STALE_REPLIES.inc(shard=self.shard)
                    continue
                if msg["op"] == op and (req is None or mreq == req):
                    return msg
                if msg["op"] in ("fenced", "error", "stale_sup") and (
                    req is None or mreq is None or mreq == req
                ):
                    return None
            return None
        finally:
            if req is not None:
                self._done_reqs[req] = None
                if len(self._done_reqs) > 1024:
                    for k in list(self._done_reqs)[:512]:
                        del self._done_reqs[k]


class FleetSupervisor:
    #: the service cadence (``run_background``), and the spacing of the
    #: harness's virtual recovery clock across restarts
    TICK_S = 15.0
    #: per-shard wait on one reply of a round or a handoff leg
    ROUND_TIMEOUT_S = 60.0
    #: a worker that stayed ready this long before dying is treated as
    #: having recovered — its NEXT restart starts the backoff ladder over
    BACKOFF_RESET_AFTER_S = 60.0

    def __init__(
        self,
        data_dir: str,
        n_shards: int,
        ttl_s: float = 5.0,
        hb_interval_s: float = 1.0,
        hb_deadline_s: Optional[float] = None,
        harness: bool = False,
        recovery_anchor: Optional[float] = None,
        restart_policy: Optional[RetryPolicy] = None,
        rebalance_enabled: bool = False,
        max_handoffs_per_pass: int = 1,
        spawn_crash: Optional[Dict[int, str]] = None,
        orphan_grace_s: float = 300.0,
        orphan_tick_s: Optional[float] = None,
        command_silence_s: float = 0.0,
        supervisor_lease_ttl_s: float = 5.0,
        solver: str = "never",
        solver_lease_ttl_s: float = 5.0,
        solver_timeout_s: float = 10.0,
        device=None,
    ) -> None:
        #: the leader's and the workers' device: None is the CUDA card
        #: (raises without one); "cpu" only when the caller asks for it
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.n_shards = n_shards
        self.ttl_s = ttl_s
        self.hb_interval_s = hb_interval_s
        self.hb_deadline_s = (hb_deadline_s if hb_deadline_s is not None
                              else max(4.0 * hb_interval_s, 2.0))
        #: a worker wedged BEFORE its first hello has no heartbeats to
        #: miss — this bounds the whole boot (generous: a replacement
        #: waits out the dead holder's lease TTL and replays its segment)
        self.boot_deadline_s = max(180.0, ttl_s * 12.0)
        self.harness = harness
        self.recovery_anchor = recovery_anchor
        #: backoff_s(consecutive_failures) paces the respawns so a
        #: crash-looping shard cannot hot-spin the box
        self.restart_policy = restart_policy or RetryPolicy(
            attempts=1_000_000, base_backoff_s=0.25, max_backoff_s=30.0,
            jitter=0.25)
        self.rebalance_enabled = rebalance_enabled
        self.max_handoffs_per_pass = max_handoffs_per_pass
        #: first-spawn-only crash kill points (``seam@index``): a
        #: RESTARTED worker comes back clean, or a crash at
        #: recovery.pass would loop forever
        self.spawn_crash = dict(spawn_crash or {})
        #: how long a worker outlives a dead supervisor (orphan mode);
        #: 0 = exit on EOF
        self.orphan_grace_s = orphan_grace_s
        self.orphan_tick_s = (orphan_tick_s if orphan_tick_s is not None
                              else self.TICK_S)
        #: worker-side command-staleness deadline (0 = off; the service
        #: CLI wires ShardingConfig.worker_command_silence_s)
        self.command_silence_s = command_silence_s
        #: fleet-lease TTL = worst-case takeover latency after a
        #: supervisor death
        self.supervisor_lease_ttl_s = supervisor_lease_ttl_s
        #: False always cold-spawns (no manifest adoption)
        self.adopt_enabled = True
        self.fleet_acquire_timeout_s = max(30.0, supervisor_lease_ttl_s * 10.0)
        self.fleet_lease = None
        self.deposed = False
        self.crashed = False
        #: solver-leader plane: "always" / "auto" / "never" (see module
        #: docstring). The solver lease is SEPARATE from the fleet lease
        self.solver_mode = solver
        self.solver_lease_ttl_s = solver_lease_ttl_s
        self.solver_timeout_s = solver_timeout_s
        self.solver_service = None
        self.shm_reaped: List[str] = []
        self.adoptions_total = 0
        self.orphaned_total = 0
        self.handles: Dict[int, WorkerHandle] = {
            k: WorkerHandle(k, self.hb_deadline_s) for k in range(n_shards)}
        self.rounds_done = 0
        self.reconciled: List[str] = []
        self.migrations: List[dict] = []
        self._seq = 0
        self._round_lock = _lockcheck.make_lock("runtime.supervisor.round")
        self._needs_reconcile = False
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._driver: Optional[threading.Thread] = None
        self._rng = random.Random(1337)
        self._repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        self._log = get_logger("scheduler")

    # -- spawning --------------------------------------------------------- #

    def _worker_cmd(self, shard: int, first: bool) -> List[str]:
        h = self.handles[shard]
        cmd = [
            sys.executable, "-m", "evergreen_tpu_torch.runtime.worker",
            "--data-dir", self.data_dir,
            "--shard", str(shard),
            "--shards", str(self.n_shards),
            "--ttl", str(self.ttl_s),
            "--hb-interval", str(self.hb_interval_s),
            # a replacement steals the dead holder's lease after TTL
            "--lease-timeout", str(max(60.0, self.ttl_s * 10.0)),
            "--sup-epoch", str(self.sup_epoch),
            "--generation", str(h.generation),
            "--orphan-grace", str(self.orphan_grace_s),
            "--orphan-tick-s", str(self.orphan_tick_s),
            "--command-silence-s", str(self.command_silence_s),
        ]
        if self.device.type == "cpu":
            cmd += ["--device", "cpu"]
        if self.harness:
            cmd.append("--harness")
        if self.recovery_anchor is not None:
            cmd += ["--recovery-now",
                    str(self.recovery_anchor + self.rounds_done * self.TICK_S)]
        if first and shard in self.spawn_crash:
            cmd += ["--crash", self.spawn_crash[shard]]
        return cmd

    def spawn(self, shard: int, first: bool = False) -> None:
        h = self.handles[shard]
        h.close_conn()  # a respawn replaces any adopted transport
        h.state = "starting"
        h.generation += 1
        # the boot itself is deadlined: a worker wedged before its first
        # hello never heartbeats
        h.hb_deadline = Deadline.after(self.boot_deadline_s)
        h.proc = subprocess.Popen(
            self._worker_cmd(shard, first), cwd=self._repo_root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, encoding="utf-8",
        )
        h.pid = h.proc.pid
        threading.Thread(target=self._reader, args=(h, h.proc.stdout),
                         daemon=True, name=f"fleet-read-{shard}").start()

    def _reader(self, h: WorkerHandle, rfile) -> None:
        """Drain one worker channel (spawn stdout or adoption socket)."""
        try:
            for line in rfile:
                msg = parse_line(line)
                if msg is None:
                    h.garbage_lines += 1
                    continue
                self._handle_recv(h, msg)
        except (OSError, ValueError):
            pass  # channel torn down under us (simulate_crash, stop)

    def _handle_recv(self, h: WorkerHandle, msg: dict) -> None:
        """Heartbeats refresh the deadline in place, everything else lands
        on the reply queue for whoever is mid-request."""
        op = msg["op"]
        if op == "heartbeat":
            h.hb_deadline = Deadline.after(h.hb_deadline_s)
            h.orphan = bool(msg.get("orphan"))
            n = int(msg.get("stale_rejects", 0) or 0)
            if n > h.stale_rejects:
                FLEET_STALE_REJECTS.inc(n - h.stale_rejects, shard=h.shard)
                h.stale_rejects = n
            n = int(msg.get("cmd_silences", 0) or 0)
            if n > h.cmd_silences:
                FLEET_CMD_SILENCE.inc(n - h.cmd_silences, shard=h.shard)
                h.cmd_silences = n
            return
        if op == "hello":
            h.epochs.append(int(msg.get("epoch", 0)))
            h.hellos.append(dict(msg))
            h.hb_deadline = Deadline.after(h.hb_deadline_s)
            if msg.get("adopted"):
                h.adopted = True
                h.adopt_hello = dict(msg)
                h.orphan = False
                h.stale_rejects = int(msg.get("stale_rejects", 0) or 0)
                h.cmd_silences = int(msg.get("cmd_silences", 0) or 0)
                self.adoptions_total += 1
                FLEET_ADOPTIONS.inc(shard=h.shard)
                if msg.get("orphaned"):
                    self.orphaned_total += 1
                    FLEET_ORPHANED.inc(shard=h.shard)
            h.state = "ready"
            h.ready_since = _time.monotonic()
            FLEET_WORKERS_UP.set(1, shard=h.shard)
            self._log.info("fleet-worker-ready", shard=h.shard, epoch=h.epoch,
                           pid=msg.get("pid"), adopted=bool(msg.get("adopted")))
            return
        if op == "stale_sup":
            # a worker answering US with stale_sup has seen a newer
            # supervisor epoch: we have been deposed
            if int(msg.get("sup_seen", 0) or 0) > self.sup_epoch:
                self._fleet_deposed("a worker observed a newer supervisor epoch")
        h.replies.put(msg)

    # -- fleet lease (supervisor fencing) ---------------------------------- #

    @property
    def sup_epoch(self) -> int:
        return self.fleet_lease.epoch if self.fleet_lease is not None else 0

    def _acquire_fleet_lease(self) -> None:
        from ..storage.lease import FileLease, supervisor_lease_path

        if self.fleet_lease is not None:
            return
        lease = FileLease(supervisor_lease_path(self.data_dir),
                          ttl_s=self.supervisor_lease_ttl_s)
        # a dead predecessor's lease goes stale and is stolen at a higher
        # epoch; a LIVE holder keeps renewing and this acquire times out
        if not lease.acquire(timeout_s=self.fleet_acquire_timeout_s, poll_s=0.1):
            raise RuntimeError(
                "another supervisor holds the fleet lease for "
                f"{self.data_dir!r} — refusing to split-brain the fleet")
        lease.start_renewing(on_lost=self._fleet_deposed)
        self.fleet_lease = lease
        for h in self.handles.values():
            h.sup_epoch = lease.epoch
        FLEET_SUP_EPOCH.set(lease.epoch)
        self._log.info("fleet-lease-acquired", epoch=lease.epoch,
                       data_dir=self.data_dir)

    def _fleet_deposed(self, reason: str = "fleet lease lost") -> None:
        """A newer supervisor owns the fleet: stand down WITHOUT touching
        the workers — they belong to the successor now."""
        if self.deposed:
            return
        self.deposed = True
        self._stop.set()
        self._log.error("fleet-supervisor-deposed", reason=reason,
                        epoch=self.sup_epoch)

    # -- adoption ----------------------------------------------------------- #

    def _try_adopt(self, shard: int) -> bool:
        """Adopt a live worker from the fleet manifest instead of
        cold-spawning it: validate the recorded pid, connect to its
        control socket, send ``adopt`` at our fencing epoch, and wait for
        the adoption hello. Any failure falls back to the cold spawn."""
        entry = manifest_mod.read_entry(self.data_dir, shard)
        if entry is None:
            return False
        pid = int(entry.get("pid", 0) or 0)
        sock_path = str(entry.get("sock", "") or "")
        if not pid or not sock_path:
            return False
        try:
            os.kill(pid, 0)
        except OSError:
            # stale entry from a crashed worker: clean it up
            manifest_mod.remove_entry(self.data_dir, shard, sock_path)
            return False
        try:
            conn = manifest_mod.connect(sock_path, timeout_s=5.0)
        except OSError:
            return False
        h = self.handles[shard]
        h.generation += 1
        h.pid = pid
        h.proc = None
        h.conn = conn
        h._conn_w = conn.makefile("w", encoding="utf-8")
        h._conn_r = conn.makefile("r", encoding="utf-8")
        h.sup_epoch = self.sup_epoch
        h.state = "starting"
        h.hb_deadline = Deadline.after(max(self.hb_deadline_s, 5.0))
        threading.Thread(target=self._reader, args=(h, h._conn_r), daemon=True,
                         name=f"fleet-adopt-read-{shard}").start()
        if not h.send(op="adopt", req=h.next_req()):
            h.close_conn()
            h.state = "new"
            return False
        deadline = Deadline.after(10.0)
        while not deadline.exceeded():
            if h.state == "ready" and h.adopted:
                self._log.info("fleet-worker-adopted", shard=shard, pid=pid,
                               epoch=h.epoch,
                               orphan_ticks=h.adopt_hello.get("orphan_ticks", 0))
                return True
            _time.sleep(0.05)
        # the worker may have PROCESSED the adopt without answering (wedged
        # mid-tick): kill it, as the hang deadline would, so the cold
        # spawn steals its lease after one TTL
        h.close_conn()
        self._log.error("fleet-adopt-timeout", shard=shard, pid=pid)
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
        manifest_mod.remove_entry(self.data_dir, shard, sock_path)
        h.state = "new"
        return False

    def start(self, monitor: bool = True, ready_timeout_s: float = 120.0) -> None:
        """Acquire the fleet lease, ADOPT any live workers a dead
        predecessor left behind, spawn the rest, wait for the fleet to
        report ready, then reconcile mid-flight handoffs. ``monitor=True``
        starts the background watchdog."""
        self._acquire_fleet_lease()
        self._reap_shm()
        self._start_solver()
        for k in range(self.n_shards):
            if self.adopt_enabled and self._try_adopt(k):
                continue
            self.spawn(k, first=True)
        self.wait_all_ready(timeout_s=ready_timeout_s)
        self.reconcile_handoffs()
        if monitor:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True, name="fleet-monitor")
            self._monitor.start()

    def _reap_shm(self) -> None:
        """Unlink solver segments whose creating worker died; live
        workers' segments are left for adoption."""
        from .solver import reap_orphan_segments

        try:
            self.shm_reaped = reap_orphan_segments(self.data_dir, self.n_shards)
        except OSError:
            self.shm_reaped = []
        if self.shm_reaped:
            self._log.info("fleet-shm-reaped", segments=len(self.shm_reaped))

    def _start_solver(self) -> None:
        """Elect this supervisor the solver leader when the stacked path
        is wanted (the module docstring's rule). A lease held elsewhere is
        SOFT: workers solve locally."""
        if self.solver_mode == "never" or self.n_shards < 2:
            return
        if self.solver_mode == "auto":
            n_dev = (torch.cuda.device_count() if self.device.type == "cuda"
                     else 1)
            if n_dev < self.n_shards:
                self._log.info("solver-leader-unavailable", reason="devices")
                return
        from .solver import SolverService

        svc = SolverService(self.data_dir, self.n_shards,
                            lease_ttl_s=self.solver_lease_ttl_s,
                            timeout_s=self.solver_timeout_s,
                            device=self.device, supervisor=self)
        if not svc.acquire():
            self._log.info("solver-leader-unavailable", reason="lease-held")
            return
        self.solver_service = svc
        self._log.info("solver-leader-elected", epoch=svc.lease.epoch)

    def wait_all_ready(self, timeout_s: float = 120.0) -> bool:
        """True when every non-crashed worker reached ready (a worker
        armed with a spawn-time crash may die before hello; the monitor
        restarts it)."""
        deadline = Deadline.after(timeout_s)
        while not deadline.exceeded():
            pending = [h for h in self.handles.values()
                       if h.state != "ready" and h.alive()]
            if not pending and all(h.state == "ready" or not h.alive()
                                   for h in self.handles.values()):
                return all(h.state == "ready" for h in self.handles.values())
            _time.sleep(0.05)
        return False

    # -- watchdog --------------------------------------------------------- #

    def _monitor_loop(self) -> None:
        poll_s = max(0.05, min(self.hb_interval_s / 2.0, 0.5))
        while not self._stop.wait(poll_s):
            self.monitor_once()

    def monitor_once(self) -> None:
        """One watchdog pass: reap exits, kill hangs, respawn due workers."""
        if self.deposed or self.crashed:
            return  # the workers belong to our successor
        for h in self.handles.values():
            if h.state in ("stopping", "stopped"):
                continue
            rc = h.poll_exit()
            if h.state == "backoff":
                if _time.monotonic() >= h.next_spawn_at:
                    h.restarts += 1
                    FLEET_RESTARTS.inc(shard=h.shard)
                    self._needs_reconcile = True
                    self.spawn(h.shard, first=False)
                continue
            if rc is not None:
                self._schedule_restart(h, rc)
                continue
            if h.state in ("ready", "starting") and h.hb_deadline.exceeded():
                # hang / heartbeat partition — or a boot wedged before the
                # first hello: kill; the exit path schedules the restart
                FLEET_HB_MISSES.inc(shard=h.shard)
                self._log.error("fleet-worker-hang", shard=h.shard, state=h.state,
                                deadline_s=h.hb_deadline_s)
                h.kill()

    def _schedule_restart(self, h: WorkerHandle, rc: int) -> None:
        h.exits.append(rc)
        h.state = "backoff"
        FLEET_WORKERS_UP.set(0, shard=h.shard)
        if (h.ready_since
                and _time.monotonic() - h.ready_since > self.BACKOFF_RESET_AFTER_S):
            h.consecutive_failures = 0
        h.ready_since = 0.0
        backoff = self.restart_policy.backoff_s(h.consecutive_failures, self._rng)
        h.consecutive_failures += 1
        h.backoffs.append(backoff)
        h.next_spawn_at = _time.monotonic() + backoff
        self._log.error("fleet-worker-exited", shard=h.shard, rc=rc,
                        crashed=rc == EXIT_CRASHED, backoff_s=round(backoff, 3),
                        restarts=h.restarts)

    # -- rounds ----------------------------------------------------------- #

    def round(self, now: Optional[float] = None) -> Dict[int, dict]:
        """One fleet round: ``tick`` to every ready worker, collect the
        ``round`` replies. Shards that are down or time out are absent
        from the result — the fleet degrades to the survivors."""
        if self.deposed or self.crashed:
            return {}  # a stood-down supervisor commands nobody
        now = _time.time() if now is None else now
        with self._round_lock:
            if self._needs_reconcile:
                self._needs_reconcile = False
                self.reconcile_handoffs()
            t0 = _time.perf_counter()
            ready = [h for h in self.handles.values() if h.state == "ready"]
            # solver-leader plane: stamp the round and serve ONE stacked
            # solve over the workers' publications in a side thread; a
            # shard the serve misses times out into its local solve
            stamp = None
            serve = None
            svc = self.solver_service
            if svc is not None and len(ready) >= 2:
                stamp = svc.stamp()
            if stamp is not None:
                serve = threading.Thread(
                    target=svc.serve_round,
                    args=([h.shard for h in ready], stamp["seq"], stamp["timeout_s"]),
                    daemon=True, name="fleet-solver-serve")
                serve.start()
            reqs = {}
            for h in ready:
                reqs[h.shard] = h.next_req()
                msg = dict(op="tick", now=now, req=reqs[h.shard])
                if stamp is not None:
                    msg["solver"] = stamp
                h.send(**msg)
            results: Dict[int, dict] = {}
            for h in ready:
                reply = h.wait_reply("round", self.ROUND_TIMEOUT_S, req=reqs[h.shard])
                if reply is None or reply.get("skipped"):
                    continue
                results[h.shard] = reply
                h.last_round = reply
                h.level = str(reply.get("level", "green"))
            if serve is not None:
                # join so rounds stay strictly serialized (two serve
                # threads on one segment set would race)
                serve.join(timeout=self.ROUND_TIMEOUT_S)
            self.rounds_done += 1
            outcome = ("full" if len(results) == self.n_shards
                       else ("partial" if results else "empty"))
            FLEET_ROUNDS.inc(outcome=outcome)
            FLEET_ROUND_MS.observe((_time.perf_counter() - t0) * 1e3)
            if self.rebalance_enabled and results:
                try:
                    self.rebalance()
                except Exception as exc:  # noqa: BLE001 — rebalancing is
                    # an optimization; a failed pass reconciles
                    self._needs_reconcile = True
                    self._log.error("fleet-rebalance-failed", error=repr(exc)[-200:])
            return results

    def broadcast(self, op: str, reply_op: str, timeout_s: float = 30.0,
                  **fields) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        if self.deposed or self.crashed:
            return out
        ready = [h for h in self.handles.values() if h.state == "ready"]
        reqs = {}
        for h in ready:
            reqs[h.shard] = h.next_req()
            h.send(op=op, req=reqs[h.shard], **fields)
        for h in ready:
            reply = h.wait_reply(reply_op, timeout_s, req=reqs[h.shard])
            if reply is not None:
                out[h.shard] = reply
        return out

    def statuses(self) -> Dict[int, dict]:
        return self.broadcast("status", "status")

    # -- handoffs / rebalancing ------------------------------------------- #

    def migrate(self, distro_id: str, src: int, dst: int,
                now: Optional[float] = None) -> Optional[dict]:
        """One fenced handoff across process boundaries: release on the
        source worker, prime on the target, done-mark on the source —
        each leg one control message and one fenced WAL group inside the
        worker. A crash at any leg leaves state the next reconciliation
        converges (exactly-one-owner)."""
        if src == dst:
            raise ValueError(f"{distro_id} already on shard {dst}")
        if self.deposed or self.crashed:
            return None
        hs, hd = self.handles[src], self.handles[dst]
        if hs.state != "ready" or hd.state != "ready":
            return None
        self._seq += 1
        req = hs.next_req()
        hs.send(op="release", distro=distro_id, target=dst, seq=self._seq,
                now=now or _time.time(), req=req)
        released = hs.wait_reply("released", self.ROUND_TIMEOUT_S, req=req)
        if released is None:
            self._needs_reconcile = True
            FLEET_HANDOFFS.inc(shard=src, outcome="aborted")
            return None
        FLEET_HANDOFFS.inc(shard=src, outcome="released")
        rec = released["record"]
        req = hd.next_req()
        hd.send(op="prime", record=rec, req=req)
        if hd.wait_reply("primed", self.ROUND_TIMEOUT_S, req=req) is None:
            self._needs_reconcile = True
            FLEET_HANDOFFS.inc(shard=src, outcome="aborted")
            return None
        FLEET_HANDOFFS.inc(shard=src, outcome="primed")
        req = hs.next_req()
        hs.send(op="done", handoff=rec["_id"], req=req)
        if hs.wait_reply("done", self.ROUND_TIMEOUT_S, req=req) is None:
            self._needs_reconcile = True
            return None
        FLEET_HANDOFFS.inc(shard=src, outcome="done")
        out = {k: v for k, v in rec.items() if k != "payload"}
        self.migrations.append(out)
        self._log.info("fleet-distro-handoff", handoff=rec["_id"],
                       distros=rec["group"], src=src, dst=dst)
        return out

    def rebalance(self) -> List[dict]:
        """Ladder-driven pass over the greedy policy shared with the
        in-process plane (``greedy_rebalance_plan``): hot workers' loads
        queried over the protocol, at most ``max_handoffs_per_pass``
        migrations."""
        from ..scheduler.sharded_plane import greedy_rebalance_plan

        levels = {k: _LEVELS.get(h.level, 0) for k, h in self.handles.items()
                  if h.state == "ready"}
        hot = [k for k, lvl in levels.items() if lvl >= 1]
        if not hot:
            return []
        loads: Dict[int, dict] = {}
        reps: Dict[int, dict] = {}
        round_ms: Dict[int, float] = {}
        reqs = {}
        for k in hot:
            h = self.handles[k]
            reqs[k] = h.next_req()
            h.send(op="load", req=reqs[k])
        for k in hot:
            reply = self.handles[k].wait_reply("load", self.ROUND_TIMEOUT_S, req=reqs[k])
            if reply is None:
                continue
            loads[k] = dict(reply.get("groups", {}))
            reps[k] = dict(reply.get("reps", {}))
            round_ms[k] = float(reply.get("round_ms", 0.0) or 0.0)
        cold_weight = {k: float(h.last_round.get("n_tasks", 0))
                       for k, h in self.handles.items() if h.state == "ready"}
        plan = greedy_rebalance_plan(levels, loads, round_ms,
                                     self.max_handoffs_per_pass,
                                     cold_weight=cold_weight)
        done = []
        for src, dst, rep in plan:
            distro = reps.get(src, {}).get(rep, rep)
            rec = self.migrate(distro, src, dst)
            if rec is not None:
                done.append(rec)
        return done

    def reconcile_handoffs(self) -> List[str]:
        """Converge mid-flight handoffs across the fleet: every
        released-but-not-done record re-primes its target and completes
        the done-mark (both legs idempotent), and the handoff sequence
        recovers its high-water mark. A pass that could not see or heal
        everything re-arms ``_needs_reconcile`` for the next round."""
        healed: List[str] = []
        deferred = any(h.state not in ("ready", "stopping", "stopped")
                       for h in self.handles.values())
        records = self.broadcast("handoffs", "handoffs")
        for src, msg in records.items():
            self._seq = max(self._seq, int(msg.get("max_seq", 0)))
            for rec in msg.get("records", ()):
                self._seq = max(self._seq, int(rec.get("seq", 0)))
                if rec.get("state") != "released":
                    continue
                dst = int(rec.get("to", -1))
                hd = self.handles.get(dst)
                hs = self.handles[src]
                if hd is None or hd.state != "ready":
                    deferred = True
                    continue
                req = hd.next_req()
                hd.send(op="prime", record=rec, req=req)
                if hd.wait_reply("primed", self.ROUND_TIMEOUT_S, req=req) is None:
                    deferred = True
                    continue
                req = hs.next_req()
                hs.send(op="done", handoff=rec["_id"], req=req)
                if hs.wait_reply("done", self.ROUND_TIMEOUT_S, req=req) is None:
                    deferred = True
                    continue
                FLEET_HANDOFFS.inc(shard=src, outcome="reconciled")
                healed.append(rec["_id"])
        if deferred:
            self._needs_reconcile = True
        if healed:
            self.reconciled.extend(healed)
            self._log.info("fleet-handoffs-reconciled", healed=healed)
        return healed

    # -- service cadence --------------------------------------------------- #

    def run_background(self) -> None:
        """Service mode: drive rounds every ``TICK_S`` until stop()."""
        def loop():
            while not self._stop.wait(self.TICK_S):
                try:
                    self.round()
                except Exception as exc:  # noqa: BLE001 — a failed round
                    # must not kill the driver; the next beat retries
                    self._log.error("fleet-round-failed", error=repr(exc)[-300:])

        self._driver = threading.Thread(target=loop, daemon=True, name="fleet-driver")
        self._driver.start()

    # -- shutdown ---------------------------------------------------------- #

    def drain(self, timeout_s: float = 30.0) -> Dict[int, dict]:
        """Graceful first phase: every worker stops populating and flushes
        its async WAL group."""
        return self.broadcast("drain", "drained", timeout_s=timeout_s)

    def _close_channels(self) -> None:
        for h in self.handles.values():
            h.state = "stopped"
            if h.proc is not None:
                for f in (h.proc.stdin, h.proc.stdout):
                    try:
                        f.close()
                    except (OSError, ValueError):
                        pass
            h.close_conn()

    def simulate_crash(self) -> None:
        """Die the way SIGKILL would: threads stop, worker pipes close
        (workers see stdin EOF and go orphan), and the fleet and solver
        leases are ABANDONED, not released, so the successor must steal
        them at a strictly higher epoch."""
        self.crashed = True
        self._stop.set()
        if self.fleet_lease is not None:
            self.fleet_lease.stop_renewing()
        if self.solver_service is not None:
            self.solver_service.detach()
        self._close_channels()

    def stop(self, graceful: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the fleet: drain + shutdown (workers checkpoint, release
        their shard leases, exit 0), then reap; anything still alive past
        the timeout is killed. A DEPOSED supervisor instead detaches: the
        workers belong to its successor."""
        self._stop.set()
        if self.solver_service is not None:
            self.solver_service.stop()
            self.solver_service = None
        if self.deposed:
            self._close_channels()
            return
        for h in self.handles.values():
            h.state = "stopping"
        if graceful:
            self.handles_shutdown(max(2.0, timeout_s / 2.0))
        deadline = Deadline.after(timeout_s)
        for h in self.handles.values():
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=max(0.1, deadline.remaining()))
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    try:
                        h.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        pass
                for f in (h.proc.stdin, h.proc.stdout):
                    try:
                        f.close()
                    except (OSError, ValueError):
                        pass
            elif h.conn is not None and h.pid:
                # adopted worker: no Popen to wait on — poll the pid
                while not h._pid_gone() and not deadline.exceeded():
                    _time.sleep(0.05)
                if not h._pid_gone():
                    h.kill()
            h.close_conn()
            FLEET_WORKERS_UP.set(0, shard=h.shard)
            h.state = "stopped"
        if self.fleet_lease is not None:
            try:
                self.fleet_lease.release()
            except OSError:
                pass
            self.fleet_lease = None

    def handles_shutdown(self, timeout_s: float) -> None:
        for h in self.handles.values():
            if h.alive():
                h.send(op="drain")
        for h in self.handles.values():
            if h.alive():
                h.wait_reply("drained", timeout_s)
        for h in self.handles.values():
            if h.alive():
                h.send(op="shutdown")

    # -- introspection ------------------------------------------------------ #

    def fleet_state(self) -> dict:
        """Per-worker level / epoch / round timing / restart counts and
        fleet totals (the JAX package serves it at GET
        /rest/v2/admin/fleet; here the service CLI prints it)."""
        workers = {}
        for k, h in self.handles.items():
            workers[str(k)] = {
                "state": h.state,
                "pid": h.pid,
                "epoch": h.epoch,
                "epochs": list(h.epochs),
                "restarts": h.restarts,
                "exits": list(h.exits),
                "level": h.level,
                "last_round_ms": h.last_round.get("ms", 0.0),
                "last_round_tasks": h.last_round.get("n_tasks", 0),
                "heartbeat_overdue": h.state == "ready" and h.hb_deadline.exceeded(),
                "garbage_lines": h.garbage_lines,
                "adopted": h.adopted,
                "orphan": h.orphan,
                "orphan_ticks": h.adopt_hello.get("orphan_ticks", 0),
                "stale_rejects": h.stale_rejects,
            }
        return {
            "n_shards": self.n_shards,
            "data_dir": self.data_dir,
            "rounds": self.rounds_done,
            "workers": workers,
            "migrations": len(self.migrations),
            "reconciled_handoffs": len(self.reconciled),
            "restarts_total": sum(h.restarts for h in self.handles.values()),
            "supervisor_epoch": self.sup_epoch,
            "deposed": self.deposed,
            "adoptions_total": self.adoptions_total,
            "orphaned_total": self.orphaned_total,
            "solver_epoch": (self.solver_service.epoch
                             if self.solver_service is not None else 0),
            "solver_rounds": (dict(self.solver_service.round_outcomes)
                              if self.solver_service is not None else {}),
            "shm_reaped": len(self.shm_reaped),
        }
