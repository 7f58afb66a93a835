"""Background job plane: the amboy-equivalent.

A copy of ``evergreen_tpu/queue/jobs.py`` under its names: jobs are
named, scope-locked, deduplicated units of work run by a worker pool in
``(priority, seq)`` order; the bounded pending set sheds the lowest
class; a job type that fails ``poison_threshold`` runs in a row is
quarantined, then probed; cron populators (``CronRunner``) enqueue jobs
on interval ticks. Job state lives in the store's ``jobs`` collection;
each run is a ring-only ``job.run`` span; the pending depth feeds the
overload ladder (``queue_pending``).

Departure from the JAX package, which catches every exception a job
raises, records it and counts it toward quarantine: a card fault
(``KernelError``, ``MirrorError``) inside a job is recorded as JAX
records a failed job (the ``jobs`` record and the ``JOB_FAILED`` event)
but is never counted toward quarantine, since that would hide a broken
kernel behind a quiet scheduler. It stops the plane instead: the queue
admits nothing more (``put`` refuses with ``"stopped"``),
``JobQueue.wait_idle`` and ``CronRunner.tick`` re-raise it to their
caller, and ``CronRunner.run_background`` hands it to its ``on_fatal``,
which by default ends the process with ``EXIT_KERNEL`` as a fleet worker
does (``runtime/worker.py``). Every other exception keeps JAX's
behaviour.
"""
from __future__ import annotations

import abc
import dataclasses
import threading

from ..utils import lockcheck as _lockcheck
import time as _time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set

from ..models import event as event_mod
from ..ops._build import KernelError
from ..ops.resident_ops import MirrorError
from ..runtime.protocol import EXIT_KERNEL
from ..storage.store import Store
from ..utils import metrics as _metrics

#: the card faults that stop the plane instead of failing one job
CARD_FAULTS = (KernelError, MirrorError)

JOBS_COLLECTION = "jobs"

JOBS_DUPLICATE_DROPPED = _metrics.counter(
    "jobs_duplicate_dropped_total",
    "Enqueues dropped because a job with the same id was already "
    "pending or running (amboy EnqueueUnique semantics).",
    legacy="jobs.duplicate_drop",
)
JOBS_QUARANTINE_DROPPED = _metrics.counter(
    "jobs_quarantine_dropped_total",
    "Enqueues dropped because the job type sat in poison quarantine.",
    legacy="jobs.quarantined_drop",
)
JOBS_QUARANTINED = _metrics.counter(
    "jobs_quarantined_total",
    "Job types entering poison quarantine after consecutive failures.",
    legacy="jobs.quarantined",
)
JOBS_SHED = _metrics.counter(
    "jobs_shed_total",
    "Jobs shed by the overload ladder or the bounded pending set, "
    "labeled by priority class (agent/planning/reconcile/stats).",
    labels=("job_class",),
    legacy="overload.jobs_shed",
)
JOBS_PENDING = _metrics.gauge(
    "jobs_pending",
    "Current JobQueue pending-set depth (admitted, not yet finished).",
)
JOBS_RUN_MS = _metrics.histogram(
    "jobs_run_duration_ms",
    "Wall time of background job runs, labeled by priority class.",
    labels=("job_class",),
)
CRON_SHED = _metrics.counter(
    "cron_populator_shed_total",
    "Populator-produced jobs whose enqueue was shed, labeled by "
    "populator (the per-populator storm-forensics view; the shed "
    "itself is counted by jobs_shed_total inside put()).",
    labels=("populator",),
    legacy=lambda labels: [
        f"overload.cron_shed.{labels['populator']}"
    ],
)

# -- priority classes --------------------------------------------------------- #
# Lower number = more critical. Overload shedding (utils/overload.py
# ladder) removes the HIGHEST-numbered class first and never touches the
# agent-critical or planning classes — the storm-soak invariant.

PRIORITY_AGENT = 0  #: agent-critical (keepalives, dispatch-adjacent)
PRIORITY_PLANNING = 1  #: the scheduler tick and task generation
PRIORITY_RECONCILE = 2  #: host/cloud reconciliation, trackers (default)
PRIORITY_STATS = 3  #: stats sampling, notifications, span export

PRIORITY_NAMES = {
    PRIORITY_AGENT: "agent",
    PRIORITY_PLANNING: "planning",
    PRIORITY_RECONCILE: "reconcile",
    PRIORITY_STATS: "stats",
}


class PutOutcome:
    """Result of ``JobQueue.put``: truthy iff the job was admitted, with
    the rejection reason otherwise ("duplicate" | "closed" |
    "quarantined" | "shed-capacity" | "shed-overload", and the port's
    "stopped" after a card fault). Rejections are
    counted and recorded INSIDE ``put`` — no call site can silently
    discard an enqueue failure by ignoring the return value."""

    __slots__ = ("accepted", "reason")

    def __init__(self, accepted: bool, reason: str = "") -> None:
        self.accepted = accepted
        self.reason = reason

    def __bool__(self) -> bool:
        return self.accepted

    def __repr__(self) -> str:
        return f"PutOutcome({self.accepted}, {self.reason!r})"


class Job(abc.ABC):
    """One unit of background work (reference amboy.Job).

    ``job_id`` deduplicates: enqueueing an id already pending is a no-op
    (amboy's EnqueueUnique). ``scopes`` are exclusive locks: two jobs
    sharing a scope never run concurrently (amboy scope locks,
    units/scheduler.go:48-49). ``priority`` is the overload-shedding
    class (PRIORITY_*): under load the queue sheds stats first, then
    reconcile — never agent or planning work.
    """

    job_type: str = "job"
    max_time_s: float = 0.0
    priority: int = PRIORITY_RECONCILE

    def __init__(
        self,
        job_id: str,
        scopes: Optional[List[str]] = None,
        priority: Optional[int] = None,
    ) -> None:
        self.job_id = job_id
        self.scopes = scopes or []
        if priority is not None:
            self.priority = priority
        #: enqueue sequence for FIFO order within a priority class
        self._seq = 0

    @abc.abstractmethod
    def run(self, store: Store) -> None:
        ...


class FnJob(Job):
    """Adapter for plain functions."""

    def __init__(
        self,
        job_id: str,
        fn: Callable[[Store], None],
        scopes: Optional[List[str]] = None,
        job_type: str = "fn",
        priority: Optional[int] = None,
    ) -> None:
        super().__init__(job_id, scopes, priority=priority)
        self.fn = fn
        self.job_type = job_type

    def run(self, store: Store) -> None:
        self.fn(store)


class JobQueue:
    """Scope-locked worker-pool queue with poison-job quarantine.

    A job type that fails ``poison_threshold`` consecutive runs is
    quarantined: new enqueues of that type are dropped (recorded in the
    jobs collection as ``quarantined``) until ``quarantine_s`` passes,
    then ONE probe job is admitted — success lifts the quarantine, another
    failure re-arms it. A crashing populator-produced job can therefore
    never wedge the cron loop or monopolize the worker pool.
    """

    def __init__(
        self,
        store: Store,
        workers: int = 4,
        name: str = "service",
        poison_threshold: int = 5,
        quarantine_s: float = 300.0,
        max_pending: Optional[int] = None,
    ) -> None:
        self.store = store
        self.name = name
        self.poison_threshold = max(1, poison_threshold)
        self.quarantine_s = quarantine_s
        self._workers = max(1, workers)
        self._executor = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"jobq-{name}"
        )
        self._lock = _lockcheck.make_lock("jobs.queue")
        self._pending: Dict[str, Job] = {}
        self._held_scopes: Set[str] = set()
        #: every admitted-but-not-running job (ready AND scope-blocked);
        #: dispatch picks the best (priority, seq) whose scopes are free
        self._waiting: List[Job] = []
        self._active = 0
        self._next_seq = 0
        self._closed = False
        #: explicit bound (tests/embedders); None = live from the
        #: admin-editable OverloadConfig so operators can retune the cap
        #: mid-incident without a restart (monitor config TTL applies)
        self._max_pending_override = max_pending
        #: job type → consecutive failure count
        self._failures: Dict[str, int] = {}
        #: job type → quarantine expiry (absolute time)
        self._quarantined_until: Dict[str, float] = {}
        #: job type currently running its single post-quarantine probe
        self._probing: Set[str] = set()
        #: the first card fault a job raised: the plane is stopped
        self._fatal: Optional[BaseException] = None

    # -- enqueue ------------------------------------------------------------- #

    def put(self, job: Job) -> PutOutcome:
        """Enqueue unless a job with the same id is already
        pending/running, the job type sits in poison quarantine, or the
        overload ladder says this job's class must shed. Every rejection
        is counted (and for sheds, recorded + evented) inside this
        method — the returned outcome is informational, never the only
        trace."""
        from ..utils import overload
        from ..utils.log import get_logger

        now = _time.time()
        monitor = overload.monitor_for(self.store)
        level = monitor.level()
        with self._lock:
            if self._closed:
                return PutOutcome(False, "closed")
            if self._fatal is not None:
                return PutOutcome(False, "stopped")
            if job.job_id in self._pending:
                JOBS_DUPLICATE_DROPPED.inc()
                return PutOutcome(False, "duplicate")
            until = self._quarantined_until.get(job.job_type)
            if until is not None:
                if now < until or job.job_type in self._probing:
                    # drop, but leave an auditable record
                    self.store.collection(JOBS_COLLECTION).upsert(
                        {
                            "_id": job.job_id,
                            "type": job.job_type,
                            "status": "quarantined",
                            "enqueued_at": now,
                            "scopes": job.scopes,
                            "error": "job type is quarantined",
                        }
                    )
                    JOBS_QUARANTINE_DROPPED.inc()
                    get_logger("amboy").warning(
                        "job-quarantine-drop",
                        job_id=job.job_id,
                        job_type=job.job_type,
                        until=round(until, 3),
                    )
                    return PutOutcome(False, "quarantined")
                # cooldown elapsed: admit exactly one probe
                self._probing.add(job.job_type)
            # overload gating: the ladder sheds the stats/notify class at
            # RED and the reconcile class at BLACK — at enqueue, before
            # the job costs a pending slot (agent/planning never gated)
            if (
                job.priority >= PRIORITY_STATS and level >= overload.RED
            ) or (
                job.priority >= PRIORITY_RECONCILE
                and level >= overload.BLACK
            ):
                self._shed_locked(job, "shed-overload", now)
                return PutOutcome(False, "shed-overload")
            # bounded pending set (0 = unbounded; sheds the lowest
            # sheddable class only, never agent/planning work)
            cap = (
                self._max_pending_override
                if self._max_pending_override is not None
                else monitor.config.queue_max_pending
            )
            if cap and len(self._pending) >= cap:
                victim = self._lowest_class_waiter(below=job.priority)
                if victim is not None:
                    # the incoming job outranks a waiting sheddable job:
                    # that one browns out instead
                    self._waiting.remove(victim)
                    self._pending.pop(victim.job_id, None)
                    self._shed_locked(victim, "shed-capacity", now)
                elif job.priority >= PRIORITY_RECONCILE:
                    self._shed_locked(job, "shed-capacity", now)
                    return PutOutcome(False, "shed-capacity")
                # agent/planning with no evictable waiter: admit over the
                # cap — those classes are never shed, and their volume is
                # naturally bounded by id-dedup and scope locks
            job._seq = self._next_seq
            self._next_seq += 1
            # executor threads must parent their spans into the
            # enqueuer's trace, not start fresh roots (utils/tracing.py
            # context token; regression-tested in test_observability.py)
            from ..utils import tracing as _tracing

            job._trace_ctx = _tracing.capture_context()
            self._pending[job.job_id] = job
            self.store.collection(JOBS_COLLECTION).upsert(
                {
                    "_id": job.job_id,
                    "type": job.job_type,
                    "status": "pending",
                    "enqueued_at": now,
                    "scopes": job.scopes,
                    "error": "",
                }
            )
            self._waiting.append(job)
            self._maybe_dispatch_locked()
            depth = len(self._pending)
        JOBS_PENDING.set(float(depth))
        monitor.observe("queue_pending", float(depth))
        return PutOutcome(True)

    def _lowest_class_waiter(self, below: int) -> Optional[Job]:
        """The newest waiting job of the lowest (highest-numbered)
        sheddable class strictly below ``below``'s criticality — the
        eviction victim when the pending set is full."""
        victim: Optional[Job] = None
        for w in self._waiting:
            if w.priority < max(below + 1, PRIORITY_RECONCILE):
                continue
            if (
                victim is None
                or (w.priority, w._seq) > (victim.priority, victim._seq)
            ):
                victim = w
        return victim

    def _shed_locked(self, job: Job, reason: str, now: float) -> None:
        """Counted, recorded, evented shed — never a silent drop."""
        from ..utils import overload
        from ..utils.log import get_logger

        # a shed job never runs, so it must not keep holding its type's
        # post-quarantine probe slot (a stuck slot would read as
        # quarantined forever); worst case a second probe is admitted
        self._probing.discard(job.job_type)
        cls = PRIORITY_NAMES.get(job.priority, str(job.priority))
        JOBS_SHED.inc(job_class=cls)
        self.store.collection(JOBS_COLLECTION).upsert(
            {
                "_id": job.job_id,
                "type": job.job_type,
                "status": "shed",
                "enqueued_at": now,
                "scopes": job.scopes,
                "error": reason,
            }
        )
        overload.record_shed(
            self.store, "job", job.job_type, detail=reason
        )
        get_logger("amboy").warning(
            "job-shed",
            job_id=job.job_id,
            job_type=job.job_type,
            priority=cls,
            reason=reason,
        )

    def _maybe_dispatch_locked(self) -> None:
        """Fill free worker slots with the best (priority, seq) waiting
        jobs whose scopes are free. O(waiting) per slot — the pending
        set is bounded, and priority dispatch is exactly why a planning
        tick never sits behind a thousand queued stats jobs."""
        while self._active < self._workers and not self._closed:
            best_i = -1
            for i, w in enumerate(self._waiting):
                if any(s in self._held_scopes for s in w.scopes):
                    continue
                if best_i < 0 or (w.priority, w._seq) < (
                    self._waiting[best_i].priority,
                    self._waiting[best_i]._seq,
                ):
                    best_i = i
            if best_i < 0:
                return
            job = self._waiting.pop(best_i)
            self._held_scopes.update(job.scopes)
            self._active += 1
            self._executor.submit(self._run_job, job)

    # -- execution ----------------------------------------------------------- #

    def _run_job(self, job: Job) -> None:
        from ..utils import tracing as _tracing

        coll = self.store.collection(JOBS_COLLECTION)
        coll.update(job.job_id, {"status": "running", "started_at": _time.time()})
        error = ""
        fatal: Optional[BaseException] = None
        t_run = _time.perf_counter()
        try:
            # ring-only span: job runs are frequent and their store
            # record already lives in the jobs collection
            with _tracing.attached(getattr(job, "_trace_ctx", None)), \
                    _tracing.Tracer(self.store, "amboy").span(
                        "job.run", store_write=False,
                        job_type=job.job_type,
                        job_class=PRIORITY_NAMES.get(
                            job.priority, str(job.priority)
                        ),
                    ):
                job.run(self.store)
        except Exception as exc:  # job errors must never kill the worker pool
            if isinstance(exc, CARD_FAULTS):
                fatal = exc
            error = traceback.format_exc()
            event_mod.log(
                self.store,
                event_mod.RESOURCE_ADMIN,
                "JOB_FAILED",
                job.job_id,
                {"type": job.job_type, "error": error[-2000:]},
            )
            from ..utils.log import get_logger

            get_logger("amboy").error(
                "job failed",
                job_id=job.job_id,
                job_type=job.job_type,
                error=error.strip().splitlines()[-1] if error else "",
            )
        coll.update(
            job.job_id,
            {
                "status": "failed" if error else "completed",
                "finished_at": _time.time(),
                "error": error[-2000:],
            },
        )
        JOBS_RUN_MS.observe(
            (_time.perf_counter() - t_run) * 1e3,
            job_class=PRIORITY_NAMES.get(job.priority, str(job.priority)),
        )
        if fatal is not None:
            # a card fault stops the plane and is never a poison count
            with self._lock:
                self._probing.discard(job.job_type)
                if self._fatal is None:
                    self._fatal = fatal
            from ..utils.log import get_logger

            get_logger("amboy").error(
                "job-plane-stopped", job_id=job.job_id,
                job_type=job.job_type, error=repr(fatal),
            )
        else:
            self._account_outcome(job, failed=bool(error))
        with self._lock:
            self._pending.pop(job.job_id, None)
            for s in job.scopes:
                self._held_scopes.discard(s)
            self._active -= 1
            # pull the next-best waiters into the freed slot(s)
            self._maybe_dispatch_locked()
            depth = len(self._pending)
        from ..utils import overload

        JOBS_PENDING.set(float(depth))
        overload.monitor_for(self.store).observe(
            "queue_pending", float(depth)
        )

    def _account_outcome(self, job: Job, failed: bool) -> None:
        """Poison accounting: consecutive failures per job type arm the
        quarantine; one success clears it."""
        from ..utils.log import get_logger

        with self._lock:
            self._probing.discard(job.job_type)
            if not failed:
                self._failures.pop(job.job_type, None)
                if self._quarantined_until.pop(job.job_type, None) is not None:
                    get_logger("amboy").info(
                        "job-quarantine-lifted", job_type=job.job_type
                    )
                return
            n = self._failures.get(job.job_type, 0) + 1
            self._failures[job.job_type] = n
            was_probe = job.job_type in self._quarantined_until
            if n >= self.poison_threshold or was_probe:
                until = _time.time() + self.quarantine_s
                self._quarantined_until[job.job_type] = until
                JOBS_QUARANTINED.inc()
                get_logger("amboy").error(
                    "job-quarantined",
                    job_type=job.job_type,
                    consecutive_failures=n,
                    quarantine_s=self.quarantine_s,
                )

    # -- introspection / lifecycle ------------------------------------------- #

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def fatal(self) -> Optional[BaseException]:
        """The card fault that stopped the plane, or None."""
        with self._lock:
            return self._fatal

    def raise_fatal(self) -> None:
        """Re-raise the card fault that stopped the plane, if any."""
        fatal = self.fatal
        if fatal is not None:
            raise fatal

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """True once nothing is pending, False at the timeout; raises the
        card fault that stopped the plane as soon as one is recorded.
        The timeout runs on the monotonic clock (a caller may pin
        ``time.time``)."""
        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            self.raise_fatal()
            if self.pending_count() == 0:
                return True
            _time.sleep(0.01)
        self.raise_fatal()
        return False

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._executor.shutdown(wait=True)


@dataclasses.dataclass
class IntervalOperation:
    """A cron populator: every ``interval_s``, generate jobs to enqueue
    (reference amboy.IntervalQueueOperation + units/crons.go populators)."""

    name: str
    interval_s: float
    populate: Callable[[Store, float], List[Job]]
    last_run: float = 0.0


class CronRunner:
    """Drives interval operations. ``tick()`` is callable manually (tests,
    single-step CLI) or continuously via ``run_background``."""

    def __init__(self, store: Store, queue: JobQueue) -> None:
        self.store = store
        self.queue = queue
        self.ops: List[IntervalOperation] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, op: IntervalOperation) -> None:
        self.ops.append(op)

    def tick(self, now: Optional[float] = None, force: bool = False) -> int:
        """Populate every due operation (every one with ``force``) and
        enqueue its jobs; returns how many were admitted. Raises the
        card fault that stopped the queue's plane, before populating."""
        self.queue.raise_fatal()
        now = _time.time() if now is None else now
        n = 0
        for op in self.ops:
            if force or now - op.last_run >= op.interval_s:
                op.last_run = now
                for job in op.populate(self.store, now):
                    outcome = self.queue.put(job)
                    if outcome:
                        n += 1
                    elif outcome.reason.startswith("shed"):
                        # the put already counted/recorded the shed; this
                        # adds the per-populator view for storm forensics
                        CRON_SHED.inc(populator=op.name)
        return n

    def run_background(
        self,
        poll_s: float = 1.0,
        on_fatal: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        """Tick every ``poll_s`` on a daemon thread until ``stop``. A card
        fault that stops the plane ends the loop and goes to
        ``on_fatal``; the default prints it and ends the process with
        ``EXIT_KERNEL``."""

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.tick()
                except CARD_FAULTS as exc:
                    (on_fatal or _exit_on_card_fault)(exc)
                    return
                self._stop.wait(poll_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="cron")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


def _exit_on_card_fault(exc: BaseException) -> None:
    """A background plane whose job raised a card fault ends the process
    non-zero, as a fleet worker does: a supervisor restarts it, and it
    never goes on without its kernels."""
    import os
    import sys

    traceback.print_exception(type(exc), exc, exc.__traceback__, file=sys.stderr)
    sys.stderr.flush()
    os._exit(EXIT_KERNEL)
