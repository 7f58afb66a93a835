"""Cron populators: the service's background heartbeat.

A copy of ``evergreen_tpu/units/crons.py`` (reference units/crons.go +
the populators amboy.IntervalQueueOperation drives,
operations/service.go:70-128): every 15 s ONE scope-locked
``scheduler-tick`` job runs the batched solve for all distros (or one
fleet round of an attached ``ShardedScheduler``), ``host-create`` spawns
and provisions the tick's intent hosts, and the monitoring, stats and
hourly populators keep the fleet honest. The tick job's options are
``service_tick_options``: the fleet worker (``runtime/worker.py``) reads
them here too.

The device is an argument (``build_cron_runner``,
``scheduler_tick_jobs``): ``run_tick`` of the tick job runs on the CUDA
card unless the caller passes ``device="cpu"``, and the populator raises
without a card.

Not registered yet, with the modules they call: ``generate-tasks``
(``ingestion/generate.py``), ``activation`` and ``repotracker``
(``ingestion/``), ``event-notifier`` (``events/``); ``hourly_jobs``
leaves out ``merge-queue-recovery`` (``ingestion/merge_queue.py``).
"""
from __future__ import annotations

import functools
import time as _time
from typing import List

from ..cloud.provisioning import (
    agent_keepalive,
    create_hosts_from_intents,
    mark_hosts_needing_reprovision,
    provision_ready_hosts,
    reprovision_hosts,
)
from ..device import resolve_device
from ..models import taskstats
from ..queue.jobs import (
    PRIORITY_AGENT,
    PRIORITY_PLANNING,
    PRIORITY_STATS,
    CronRunner,
    FnJob,
    Job,
    JobQueue,
)
from ..scheduler.wrapper import TickOptions, run_tick
from ..settings import HostInitConfig, ServiceFlags
from ..storage.store import Store
from ..utils import metrics as _metrics
from ..utils import overload
from . import host_jobs, task_jobs

CRON_DEFERRED = _metrics.counter(
    "cron_deferred_total",
    "Whole populator batches deferred for one interval by the overload "
    "ladder, labeled by populator.",
    labels=("populator",),
    legacy="overload.cron_deferred",
)


def _defer_for_overload(store: Store, populator: str, floor: int) -> bool:
    """True when the overload ladder is at ``floor`` or worse: the
    populator defers its whole batch this interval (counted + logged —
    a deferral is a shed-shaped outcome and must be observable)."""
    level = overload.monitor_for(store).level()
    if level < floor:
        return False
    from ..utils.log import get_logger

    CRON_DEFERRED.inc(populator=populator)
    get_logger("overload").info(
        "cron-deferred",
        populator=populator,
        level=overload.level_name(level),
    )
    return True


def service_tick_options(create_intent_hosts: bool = True) -> TickOptions:
    """The service's tick options, for a single store's tick and for every
    shard's tick of a fleet round alike."""
    return TickOptions(
        create_intent_hosts=create_intent_hosts,
        use_cache=True,  # long-lived service: incremental gathering
        # resilience: a solve slower than this degrades the tick to the
        # serial oracle (breaker-counted), and a tick past its budget
        # sheds stats/events — planning always completes before the next
        # 15s tick fires
        solve_deadline_s=10.0,
        tick_budget_s=12.0,
        # WAL group commit of tick t flushes on the background flusher,
        # overlapped with tick t+1's snapshot; a deferred write error
        # degrades the next tick at its barrier
        async_persist=True,
    )


def scheduler_tick_jobs(store: Store, now: float, device=None) -> List[Job]:
    """The 15s tick (crons_remote_fifteen_second.go:42-55): one batched
    planner+allocator solve, scope-locked so ticks never overlap. The
    solve runs on ``device`` (the card unless ``"cpu"``; raises without
    one)."""
    dev = resolve_device(device)
    if getattr(store, "fenced", False):
        # the writer lease was lost/superseded (storage/lease.py on_lost
        # → storage/durable.py fence): a deposed holder must not enqueue
        # another tick while its stand-down is in flight — run_tick would
        # refuse anyway, but not populating keeps the queue quiet
        from ..utils.log import get_logger

        get_logger("resilience").warning(
            "scheduler-tick-skipped", reason="fenced"
        )
        return []
    flags = ServiceFlags.get(store)
    if flags.scheduler_disabled and flags.host_allocator_disabled:
        return []

    # sharded control plane: when a ShardedScheduler is attached to this
    # (front) store, the 15s tick is ONE fleet round — per-shard ticks on
    # the plane's worker pool + the rebalancing pass — instead of a
    # single-store run_tick, on the plane's own device. Scope-locked the
    # same way: rounds never overlap. Every shard's tick runs under the
    # SAME service-mode options as the classic path, and the
    # runtime-tunable ShardingConfig knobs are re-read per populate so
    # admin edits to rebalancing/stacking reach a live plane.
    from ..scheduler.sharded_plane import peek_sharded_plane
    from ..settings import ShardingConfig

    plane = peek_sharded_plane(store)
    sharding = ShardingConfig.get(store)
    if plane is None and sharding.n_shards > 1:
        # configured but not wired: say so loudly instead of silently
        # running the single plane
        from ..utils.log import get_logger

        get_logger("scheduler").warning(
            "sharding-configured-but-not-attached",
            n_shards=sharding.n_shards,
            hint="build a ShardedScheduler and attach_sharded_plane()",
        )
    opts = service_tick_options(
        create_intent_hosts=not flags.host_allocator_disabled
    )
    if plane is not None:
        plane.stacked = sharding.stacked_solve
        plane.rebalance_enabled = sharding.rebalance_enabled
        plane.max_handoffs_per_round = sharding.max_handoffs_per_round
        plane.barrier_timeout_s = sharding.barrier_timeout_s

        def run_round(s: Store) -> None:
            plane.tick(now=_time.time(), opts=opts)

        return [
            FnJob(
                f"scheduler-tick-{now:.3f}",
                run_round,
                scopes=["scheduler-tick"],
                job_type="scheduler-tick",
                priority=PRIORITY_PLANNING,
            )
        ]

    def run(s: Store) -> None:
        run_tick(s, opts, now=_time.time(), device=dev)

    return [
        FnJob(
            f"scheduler-tick-{now:.3f}",
            run,
            scopes=["scheduler-tick"],
            job_type="scheduler-tick",
            priority=PRIORITY_PLANNING,
        )
    ]


def host_creation_jobs(store: Store, now: float) -> List[Job]:
    """Spawn cloud instances for intent hosts, throttled
    (units/provisioning_create_host.go + config_hostinit.go throttle)."""
    flags = ServiceFlags.get(store)
    if flags.host_init_disabled:
        return []
    throttle = HostInitConfig.get(store).host_throttle

    def create_and_provision(s: Store) -> None:
        from ..cloud.docker import ensure_parent_capacity
        from ..cloud.static import update_all_static_distros

        update_all_static_distros(s)
        ensure_parent_capacity(s)
        create_hosts_from_intents(s, limit=throttle)
        provision_ready_hosts(s)

    return [
        FnJob(
            f"host-create-{now:.3f}",
            create_and_provision,
            scopes=["host-create"],
            job_type="host-create",
        )
    ]


def host_monitoring_jobs(store: Store, now: float) -> List[Job]:
    flags = ServiceFlags.get(store)
    if flags.monitor_disabled:
        return []
    # agent keepalives ride the agent-critical class: losing them under
    # load kills healthy task executions, the one thing a brownout must
    # never do
    jobs: List[Job] = [
        FnJob(
            f"agent-keepalive-{now:.3f}",
            lambda s: agent_keepalive(s),
            scopes=["agent-keepalive"],
            job_type="agent-keepalive",
            priority=PRIORITY_AGENT,
        )
    ]
    if _defer_for_overload(store, "host-monitoring", overload.BLACK):
        return jobs
    # urgent reconciliation: cloud-state truth and idle cost control run
    # at every level below BLACK
    jobs += [
        FnJob(
            f"host-monitor-{now:.3f}",
            lambda s: host_jobs.monitor_host_cloud_state(s),
            scopes=["host-monitor"],
            job_type="host-monitor",
        ),
        FnJob(
            f"idle-termination-{now:.3f}",
            lambda s: host_jobs.terminate_idle_hosts(s),
            scopes=["idle-termination"],
            job_type="idle-termination",
        ),
    ]
    # non-urgent reconciliation defers under RED (the level is
    # consulted at the populator so deferred work never costs a slot)
    if _defer_for_overload(store, "host-reconcile", overload.RED):
        return jobs
    jobs += [
        FnJob(
            f"stale-building-{now:.3f}",
            lambda s: host_jobs.reap_stale_building_hosts(s),
            scopes=["stale-building"],
            job_type="stale-building",
        ),
        FnJob(
            f"host-drawdown-{now:.3f}",
            lambda s: host_jobs.host_drawdown(s),
            scopes=["host-drawdown"],
            job_type="host-drawdown",
        ),
        FnJob(
            f"reprovision-{now:.3f}",
            _reprovision_pass,
            scopes=["reprovision"],
            job_type="reprovision",
        ),
        FnJob(
            f"spawnhost-expiration-{now:.3f}",
            _expire_spawn_hosts,
            scopes=["spawnhost-expiration"],
            job_type="spawnhost-expiration",
        ),
        FnJob(
            f"sleep-schedules-{now:.3f}",
            _enforce_sleep_schedules,
            scopes=["sleep-schedules"],
            job_type="sleep-schedules",
        ),
    ]
    return jobs


def _reprovision_pass(s: Store) -> None:
    """Mark bootstrap-method drift, then convert whatever is free (the
    reference's convert_host_to_new/_to_legacy job pair)."""
    mark_hosts_needing_reprovision(s)
    reprovision_hosts(s)


def _expire_spawn_hosts(s: Store) -> None:
    from ..cloud.spawnhost import expire_spawn_hosts

    expire_spawn_hosts(s)


def _enforce_sleep_schedules(s: Store) -> None:
    from ..cloud.volumes import enforce_sleep_schedules

    enforce_sleep_schedules(s)


def task_monitoring_jobs(store: Store, now: float) -> List[Job]:
    flags = ServiceFlags.get(store)
    if flags.monitor_disabled:
        return []
    return [
        FnJob(
            f"task-exec-timeout-{now:.3f}",
            lambda s: task_jobs.monitor_stale_heartbeats(s),
            scopes=["task-exec-timeout"],
            job_type="task-exec-timeout",
        )
    ]


def stats_jobs(store: Store, now: float) -> List[Job]:
    flags = ServiceFlags.get(store)
    if flags.background_stats_disabled:
        return []
    # optional telemetry defers wholesale under RED — cheaper than
    # enqueueing three jobs for the queue to shed one by one
    if _defer_for_overload(store, "stats", overload.RED):
        return []
    return [
        FnJob(
            f"host-stats-{now:.3f}",
            lambda s: host_jobs.sample_host_stats(s),
            scopes=["host-stats"],
            job_type="host-stats",
            priority=PRIORITY_STATS,
        ),
        FnJob(
            f"system-stats-{now:.3f}",
            lambda s: task_jobs.sample_system_stats(s),
            scopes=["system-stats"],
            job_type="system-stats",
            priority=PRIORITY_STATS,
        ),
        FnJob(
            f"span-export-{now:.3f}",
            _export_spans,
            scopes=["span-export"],
            job_type="span-export",
            priority=PRIORITY_STATS,
        ),
    ]


def _export_spans(s: Store) -> None:
    """OTLP push of finished spans when the tracer section is enabled
    (reference environment.go:1070 tracer init + OTLP collector)."""
    from ..utils.tracing import export_spans

    export_spans(s)


def hourly_jobs(store: Store, now: float) -> List[Job]:
    flags = ServiceFlags.get(store)
    jobs: List[Job] = []
    if not flags.cache_stats_job_disabled:
        jobs.append(
            FnJob(
                f"cache-task-stats-{now:.3f}",
                lambda s: taskstats.cache_historical_task_data(s),
                scopes=["cache-task-stats"],
                job_type="cache-task-stats",
                priority=PRIORITY_STATS,
            )
        )
    jobs.append(
        FnJob(
            f"distro-auto-tune-{now:.3f}",
            lambda s: host_jobs.auto_tune_distro_max_hosts(s),
            scopes=["distro-auto-tune"],
            job_type="distro-auto-tune",
        )
    )
    return jobs


def build_cron_runner(store: Store, queue: JobQueue, device=None) -> CronRunner:
    """Wire the background plane (the reference's populator registry,
    operations/service.go:70-128) at the JAX package's intervals, less
    the populators whose modules are not ported (see the module
    docstring). The tick job runs on ``device`` (the card unless
    ``"cpu"``; raises without one)."""
    from ..queue.jobs import IntervalOperation

    dev = resolve_device(device)
    runner = CronRunner(store, queue)
    runner.register(IntervalOperation(
        "scheduler-tick", 15.0,
        functools.partial(scheduler_tick_jobs, device=dev)))
    runner.register(IntervalOperation("host-creation", 15.0, host_creation_jobs))
    runner.register(IntervalOperation("host-monitoring", 60.0, host_monitoring_jobs))
    runner.register(
        IntervalOperation("task-monitoring", 5 * 60.0, task_monitoring_jobs)
    )
    runner.register(IntervalOperation("stats", 60.0, stats_jobs))
    runner.register(IntervalOperation("hourly", 3600.0, hourly_jobs))
    return runner
