"""Store-backed config sections: every section of the JAX package.

A copy of ``evergreen_tpu/settings.py``: ``ConfigSection`` with its
field-level overrides, the registry (``register_section``,
``get_section``, ``all_sections``) and all 37 of the JAX package's
sections, at its defaults and with its validation. The tick's planning
half reads ``service_flags``, ``capacity``, ``overrides``,
``release_mode``, ``overload``, ``sharding``, ``task_limits``,
``read_path`` and ``tracer``; ``models/cost.py`` reads ``cost``; the job plane reads ``host_init``,
``api``, ``auth`` (with ``okta_service``, whose credentials the
user-manager loader falls back to), ``logger_config``, ``amboy``,
``container_pools`` and ``ssh``; the REST surface ``rate_limit``; the
event plane ``notify``, ``slack``, ``jira`` and ``jira_notifications``
(with the ``api`` section's webhook and SNS secrets); the spawn-host
surface ``spawnhost`` and ``sleep_schedule``. The rest (``scheduler``,
``ui``, ``triggers``, ``providers``, ``parameter_store``,
``project_creation``, ``single_task_distro``, ``test_selection``,
``splunk``, ``github_check_run``, ``buckets``) have no reader but the
admin settings routes, which edit every section, as in the JAX package.
Sections live in the same ``config`` collection under the same ``_id``
with the same fields, so a section one package writes reads back the
same in the other (``tests/test_torch_store.py``).

The JAX package registers two classes under ``cost``: its settings
module's and ``models/cost.py``'s, and the one imported last wins (the
model's, once ``mark_end`` has imported it). The port keeps the model's
alone, here beside every other section, so the registry is whole once
this module is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Type

from .storage.store import Store
from .utils import metrics as _metrics

CONFIG_COLLECTION = "config"

CONFIG_STALE_KEYS = _metrics.counter(
    "config_stale_keys_total",
    "Config-section loads that found keys a migration moved elsewhere "
    "(the silent-weakening failure mode; warned loudly on every load).",
    legacy="config.okta_service.stale_keys",
)


class ConfigSection:
    """Subclasses are dataclasses with a ``section_id`` class attr
    (reference ConfigSection interface: SectionId/Get/Set/ValidateAndDefault).
    """

    section_id: str = ""

    @classmethod
    def get_base(cls, store: Store) -> "ConfigSection":
        """The stored section WITHOUT overrides — what admin edits must
        start from, or a get→set round trip would bake override values
        into the base document."""
        doc = store.collection(CONFIG_COLLECTION).get(cls.section_id)
        if doc is None:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})

    @classmethod
    def get(cls, store: Store) -> "ConfigSection":
        section = cls.get_base(store)
        if _apply_overrides(store, section):
            # an override produced an invalid section (e.g. a type the
            # validator rejects): fail safe to the stored base rather
            # than hand consumers a poisoned config
            if section.validate_and_default():
                section = cls.get_base(store)
        return section

    def set(self, store: Store) -> None:
        err = self.validate_and_default()
        if err:
            raise ValueError(f"config section {self.section_id!r}: {err}")
        doc = dataclasses.asdict(self)
        doc["_id"] = self.section_id
        store.collection(CONFIG_COLLECTION).upsert(doc)

    def validate_and_default(self) -> str:
        """Normalize fields and return "" or an error message (reference
        ConfigSection.ValidateAndDefault). Subclasses override as needed;
        a failed validation blocks ``set``."""
        return ""


def _apply_overrides(store: Store, section: "ConfigSection") -> bool:
    """Field-level overrides from the ``overrides`` section (reference
    config_overrides.go: Override{SectionID, Field, Value}), applied on
    every read so the stored base document is never clobbered.  Returns
    True iff any override was applied."""
    if section.section_id == OverridesConfig.section_id:
        return False  # the overrides section itself is never overridden
    doc = store.collection(CONFIG_COLLECTION).get(OverridesConfig.section_id)
    if not doc:
        return False
    known = {f.name for f in dataclasses.fields(section)}
    applied = False
    for ov in doc.get("overrides", []):
        if ov.get("section_id") == section.section_id and ov.get("field") in known:
            setattr(section, ov["field"], ov.get("value"))
            applied = True
    return applied


#: the sections by id; an override must name one of them
_SECTIONS: Dict[str, Type[ConfigSection]] = {}


def register_section(cls: Type[ConfigSection]) -> Type[ConfigSection]:
    assert cls.section_id
    _SECTIONS[cls.section_id] = cls
    return cls


def get_section(store: Store, section_id: str) -> Optional[ConfigSection]:
    cls = all_sections().get(section_id)
    return cls.get(store) if cls else None


def all_sections() -> Dict[str, Type[ConfigSection]]:
    return dict(_SECTIONS)


@register_section
@dataclasses.dataclass
class ServiceFlags(ConfigSection):
    """Per-subsystem kill-switches (reference config_serviceflags.go;
    checked e.g. units/scheduler.go:66, rest/route/host_agent.go:168)."""

    section_id = "service_flags"

    scheduler_disabled: bool = False
    host_allocator_disabled: bool = False
    host_init_disabled: bool = False
    monitor_disabled: bool = False
    agent_start_disabled: bool = False
    repotracker_disabled: bool = False
    task_dispatch_disabled: bool = False
    event_processing_disabled: bool = False
    alerts_disabled: bool = False
    background_stats_disabled: bool = False
    task_logging_disabled: bool = False
    cache_stats_job_disabled: bool = False
    stepback_disabled: bool = False
    patching_disabled: bool = False
    generate_tasks_disabled: bool = False
    release_mode_disabled: bool = False


@register_section
@dataclasses.dataclass
class CapacityConfig(ConfigSection):
    """Capacity-plane knobs (ops/capacity.py program weights + the pool
    vocabulary's prices and quotas; consumed by
    scheduler/capacity_plane.py). Pools are providers — a distro's
    hosts can only come from its own provider — so both dicts are keyed
    by provider name ("ec2-fleet", "docker", …). Per-distro opt-in is
    separate: ``planner_settings.capacity = "tpu"`` on the distro. See
    the JAX package's docs/DEPLOY.md "Capacity plane tuning"."""

    section_id = "capacity"

    #: master switch; off = every distro uses the per-distro heuristic
    enabled: bool = True
    #: relative $/host-hour per pool; empty falls back to the provider
    #: defaults (cloud/manager.py default_pool_prices)
    pool_prices: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: hard per-pool host caps over capacity-managed distros (0/absent =
    #: unlimited)
    pool_quotas: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: weight of the provider-price objective term (0 = drain-only).
    #: Keep both weights small relative to the drain term's marginal
    #: host value (demand/x² in threshold units) or the program pins
    #: every distro to its current fleet — see DEPLOY.md.
    price_weight: float = 0.02
    #: weight of the churn/preemption term penalizing targets far from
    #: the current fleet (spawn storms AND drawdown storms); quadratic
    #: in the host delta, so keep it small — it is a tiebreaker, not a
    #: rival of the drain term
    preemption_cost: float = 0.001
    #: fleet-wide cap on new hosts one capacity solve may request
    #: (0 → globals.MAX_INTENT_HOSTS_IN_FLIGHT)
    fleet_intent_budget: int = 0
    #: damped-Newton + projection sweeps on device
    iterations: int = 48
    #: fused capacity solve (ops/solve.py capacity_affinity): "auto"
    #: rides the capacity program + pool affinity inside the ONE packed
    #: planning solve whenever the tick's preconditions hold (packed
    #: solve succeeded, no cmp-planned distros, fused breaker closed);
    #: "two_call" still packs the capacity page (the device block runs
    #: and its outputs are discarded) but serves from the dedicated
    #: second solve — the A/B knob for the fused-vs-fallback rung
    #: comparison without sabotage faults; "never" skips the page
    #: entirely and pins the classic pre-fused pipeline
    fused: str = "auto"
    #: initial softmax temperature of the annealed task-group→pool
    #: affinity block (higher = softer early assignments)
    affinity_temperature: float = 1.0
    #: per-iteration temperature decay (clipped to [0.5, 1.0] on
    #: device; values near 1 anneal slowly)
    affinity_anneal: float = 0.92

    def validate_and_default(self) -> str:
        if self.price_weight < 0 or self.preemption_cost < 0:
            return "capacity weights must be >= 0"
        if self.fleet_intent_budget < 0:
            return "fleet_intent_budget must be >= 0"
        if not isinstance(self.iterations, int) or not (
            1 <= self.iterations <= 512
        ):
            return "iterations must be an int in [1, 512]"
        if self.fused not in ("auto", "two_call", "never"):
            return "fused must be auto/two_call/never"
        if self.affinity_temperature <= 0:
            return "affinity_temperature must be > 0"
        if not 0.5 <= self.affinity_anneal <= 1.0:
            return "affinity_anneal must be in [0.5, 1.0]"
        for name, d in (("pool_prices", self.pool_prices),
                        ("pool_quotas", self.pool_quotas)):
            if not isinstance(d, dict):
                return f"{name} must be a mapping"
            for k, v in d.items():
                if not isinstance(v, (int, float)) or v < 0:
                    return f"{name}[{k!r}] must be a number >= 0"
        return ""


@register_section
@dataclasses.dataclass
class OverridesConfig(ConfigSection):
    """Field-level overrides over other sections (reference
    config_overrides.go Override{SectionID, Field, Value})."""

    section_id = "overrides"

    #: list of {"section_id": ..., "field": ..., "value": ...}
    overrides: List[Dict] = dataclasses.field(default_factory=list)

    def validate_and_default(self) -> str:
        for ov in self.overrides:
            if not ov.get("section_id") or not ov.get("field"):
                return "every override needs section_id and field"
            if "value" not in ov:
                return f"override of {ov['field']!r} has no value"
            if ov["section_id"] == self.section_id:
                return "the overrides section cannot override itself"
            cls = _SECTIONS.get(ov["section_id"])
            if cls is None:
                return f"unknown section {ov['section_id']!r}"
            if ov["field"] not in {f.name for f in dataclasses.fields(cls)}:
                return (
                    f"section {ov['section_id']!r} has no field "
                    f"{ov['field']!r}"
                )
        return ""


@register_section
@dataclasses.dataclass
class ReleaseModeConfig(ConfigSection):
    """Release-window scheduler overrides (reference
    config_release_mode.go, applied in distro settings resolution
    model/distro/distro.go:680-748): scale auto-tunable distros' max
    hosts, and override planner target time / host idle time. Gated by
    service_flags.release_mode_disabled. Consumed by
    scheduler/wrapper.py (settings resolution) and
    units/host_jobs.py (idle termination)."""

    section_id = "release_mode"

    distro_max_hosts_factor: float = 0.0
    target_time_seconds_override: int = 0
    idle_time_seconds_override: int = 0

    def validate_and_default(self) -> str:
        if self.distro_max_hosts_factor < 0:
            return "distro_max_hosts_factor must be >= 0"
        if self.target_time_seconds_override < 0:
            return "target_time_seconds_override must be >= 0"
        if self.idle_time_seconds_override < 0:
            # a negative cutoff would instantly reap every free host
            return "idle_time_seconds_override must be >= 0"
        return ""


@register_section
@dataclasses.dataclass
class OverloadConfig(ConfigSection):
    """Overload-protection ladder knobs (consumed by
    utils/overload.LoadMonitor; the tick sheds its optional stats and
    event emission at RED or worse).

    Each ``*_levels`` list is the [yellow, red, black] threshold triple
    for one fused signal; a 0 threshold disables that rung for that
    signal. ``queue_max_pending``, ``outbox_cap`` and the Retry-After
    seconds are the JAX package's job-queue, outbox and API knobs: the
    port keeps them so the section's document is the same in both."""

    section_id = "overload"

    enabled: bool = True
    #: the scheduler cadence the tick-lag signal is measured against
    tick_cadence_s: float = 15.0
    #: consecutive calm evaluations before the level steps DOWN
    hysteresis_ticks: int = 3
    #: how often gauge pushes may auto-re-evaluate the ladder
    eval_interval_s: float = 1.0
    #: hard cap on the JobQueue pending set (sheds lowest class only)
    queue_max_pending: int = 1000
    #: hard cap on undelivered rows per notification outbox collection
    outbox_cap: int = 5000
    queue_pending_levels: List[float] = dataclasses.field(
        default_factory=lambda: [200.0, 500.0, 1000.0]
    )
    outbox_depth_levels: List[float] = dataclasses.field(
        default_factory=lambda: [1000.0, 3000.0, 5000.0]
    )
    wal_backlog_levels: List[float] = dataclasses.field(
        default_factory=lambda: [4.0, 16.0, 64.0]
    )
    store_latency_ms_levels: List[float] = dataclasses.field(
        default_factory=lambda: [250.0, 1000.0, 5000.0]
    )
    #: seconds the tick runs PAST its cadence
    tick_lag_levels_s: List[float] = dataclasses.field(
        default_factory=lambda: [10.0, 30.0, 90.0]
    )
    api_rps_levels: List[float] = dataclasses.field(
        default_factory=lambda: [200.0, 500.0, 2000.0]
    )
    #: Retry-After the API sends while shedding at each level
    retry_after_red_s: float = 30.0
    retry_after_black_s: float = 60.0

    def validate_and_default(self) -> str:
        for name in (
            "queue_pending_levels",
            "outbox_depth_levels",
            "wal_backlog_levels",
            "store_latency_ms_levels",
            "tick_lag_levels_s",
            "api_rps_levels",
        ):
            levels = getattr(self, name)
            if not isinstance(levels, list) or len(levels) != 3:
                return f"{name} must be a [yellow, red, black] triple"
            if any(not isinstance(v, (int, float)) or v < 0 for v in levels):
                return f"{name} entries must be numbers >= 0"
            active = [v for v in levels if v > 0]
            if active != sorted(active):
                return f"{name} must be non-decreasing"
        if self.hysteresis_ticks < 1:
            self.hysteresis_ticks = 1
        if self.queue_max_pending < 0 or self.outbox_cap < 0:
            return "caps cannot be negative"
        return ""


@register_section
@dataclasses.dataclass
class ShardingConfig(ConfigSection):
    """Sharded control plane knobs (scheduler/sharded_plane.py +
    parallel/topology.py). ``n_shards`` > 1 turns the 15s tick into a
    fleet round over N scheduler shards — each with its own lease, WAL
    segment and resident plane — partitioned by consistent hash. A copy of the JAX package's section
    (defaults and validation); ``python -m evergreen_tpu_torch service
    --shards N`` reads it off shard 0's segment."""

    section_id = "sharding"

    #: 1 = the classic single-scheduler plane
    n_shards: int = 1
    #: stacked multi-device solve: "auto" (stack when the backend has
    #: >= n_shards devices), "never", "always"
    stacked_solve: str = "auto"
    #: ladder-driven distro migration off YELLOW shards
    rebalance_enabled: bool = True
    #: whole-distro handoffs a single round may initiate (migrations are
    #: cheap but re-prime the target's caches — trickle, don't slosh)
    max_handoffs_per_round: int = 1
    #: stacked-round barrier timeout before per-shard local solves
    barrier_timeout_s: float = 30.0
    # -- process-per-shard runtime (runtime/supervisor.py; `service
    # -- --shards N`) -------------------------------------------------
    #: per-shard lease TTL in process mode — ALSO the worst-case fenced
    #: takeover latency (a replacement steals a dead worker's lease
    #: only after it goes stale)
    worker_lease_ttl_s: float = 5.0
    #: worker heartbeat cadence on the control pipe
    worker_heartbeat_s: float = 1.0
    #: missed-heartbeat deadline after which the supervisor kills +
    #: restarts a worker (hang / pipe-partition detection)
    worker_heartbeat_deadline_s: float = 5.0
    #: exponential restart backoff bounds (PR-1 RetryPolicy shape)
    worker_restart_backoff_s: float = 0.25
    worker_restart_backoff_max_s: float = 30.0
    #: how long a worker outlives a dead supervisor (orphan mode: keeps
    #: its shard lease, ticks locally, waits for adoption on its
    #: control socket), then drains and releases; 0 restores the old
    #: exit-on-EOF behavior. This bounds a supervisor outage's blast
    #: radius: restart within the grace = zero lost work
    orphan_grace_s: float = 300.0
    #: worker-side command-staleness deadline (one-way partition
    #: detection): an ATTACHED worker that hears no supervisor command
    #: for this long — while its own heartbeats may still be getting
    #: through — enters orphan mode (bounded by orphan_grace_s) instead
    #: of trusting the silent channel forever; a resumed command heals
    #: it in place. Must comfortably exceed the round cadence; 0
    #: disables the deadline
    worker_command_silence_s: float = 120.0
    #: fleet-scope supervisor lease TTL — ALSO the worst-case takeover
    #: latency after a supervisor death (the successor steals the
    #: fencing epoch only once the lease goes stale)
    supervisor_lease_ttl_s: float = 5.0
    #: solver-leader plane (runtime/solver.py): "auto" serves one
    #: stacked shard_map solve per fleet round over cross-process
    #: shared-memory arenas when the backend has >= n_shards devices;
    #: "never" keeps every worker on its local solve
    solver_leader: str = "auto"
    #: solver lease TTL — worst-case window a dead leader's rounds
    #: degrade to local solves before a successor steals the lease at
    #: a strictly higher epoch (independent of the supervisor lease:
    #: data plane and control plane re-elect separately)
    solver_lease_ttl_s: float = 5.0
    #: per-round worker wait on the leader's solved block before the
    #: local-solve fallback (see docs/DEPLOY.md "Solver-leader sizing")
    solver_timeout_s: float = 10.0

    def validate_and_default(self) -> str:
        if self.n_shards < 1:
            return "n_shards must be >= 1"
        if self.stacked_solve not in ("auto", "never", "always"):
            return "stacked_solve must be auto/never/always"
        if self.max_handoffs_per_round < 0:
            return "max_handoffs_per_round cannot be negative"
        if self.barrier_timeout_s <= 0:
            return "barrier_timeout_s must be > 0"
        if self.worker_lease_ttl_s <= 0:
            return "worker_lease_ttl_s must be > 0"
        if self.worker_heartbeat_s <= 0:
            return "worker_heartbeat_s must be > 0"
        if self.worker_heartbeat_deadline_s < self.worker_heartbeat_s:
            return (
                "worker_heartbeat_deadline_s must be >= "
                "worker_heartbeat_s"
            )
        if self.worker_restart_backoff_s <= 0:
            return "worker_restart_backoff_s must be > 0"
        if (self.worker_restart_backoff_max_s
                < self.worker_restart_backoff_s):
            return (
                "worker_restart_backoff_max_s must be >= "
                "worker_restart_backoff_s"
            )
        if self.orphan_grace_s < 0:
            return "orphan_grace_s cannot be negative"
        if self.worker_command_silence_s < 0:
            return "worker_command_silence_s cannot be negative"
        if self.supervisor_lease_ttl_s <= 0:
            return "supervisor_lease_ttl_s must be > 0"
        if self.solver_leader not in ("auto", "never"):
            return "solver_leader must be auto/never"
        if self.solver_lease_ttl_s <= 0:
            return "solver_lease_ttl_s must be > 0"
        if self.solver_timeout_s <= 0:
            return "solver_timeout_s must be > 0"
        return ""


@register_section
@dataclasses.dataclass
class TaskLimitsConfig(ConfigSection):
    """reference config_task_limits.go. The dispatcher's large-parser
    guard reads ``max_concurrent_large_parser_project_tasks``
    (``dispatch/assign.py``)."""

    section_id = "task_limits"

    max_tasks_per_version: int = 0
    max_pending_generated_tasks: int = 0
    max_generate_task_json_size_kb: int = 0
    max_concurrent_large_parser_project_tasks: int = 0
    max_hourly_patch_tasks: int = 0
    max_exec_timeout_secs: int = 0
    max_task_execution: int = 9  # max automatic restarts


@register_section
@dataclasses.dataclass
class ReadPathConfig(ConfigSection):
    """Read-serving plane knobs: follower reads off the WAL-tailing
    replica (``storage/replica.py``; ``api/rest.py::RestApi._serve_read``
    and ``healthz_ready`` read the bounds), the fingerprint ETag/response
    cache (``api/readcache.py``) and the long-poll hub
    (``dispatch/longpoll.py::hub_for``; ``RestApi.next_task`` clamps
    ``?wait=`` to its bound)."""

    section_id = "read_path"

    #: master switch for replica-backed follower reads (the ETag cache
    #: and long-poll hub have their own switches below)
    follower_reads_enabled: bool = True
    #: serve a list/read from the replica only when its staleness is
    #: under this bound; above it the primary serves
    staleness_bound_ms: float = 2000.0
    #: at RED, expensive reads degrade to replica serving under this
    #: looser bound (with a Warning header) before falling back to 429
    degraded_staleness_bound_ms: float = 30000.0
    #: readiness probe (GET /healthz/ready): a replica process answers
    #: 503 once its staleness exceeds this (0: staleness_bound_ms);
    #: looser than the serving bound, since a replica a little over it
    #: still forwards its reads to the primary
    readiness_staleness_bound_ms: float = 10000.0
    #: fingerprint ETag + in-process response cache
    cache_enabled: bool = True
    cache_max_entries: int = 256
    #: long-poll dispatch: agents may park on next_task up to this long
    #: (?wait= is clamped to it); 0 disables server-side parking
    longpoll_max_wait_s: float = 30.0
    #: condition-variable shards the parked agents spread across (bounds
    #: the wake-storm convoy on any single mutex)
    longpoll_shards: int = 32
    #: parked waiters re-check their queue generation at least this
    #: often even without a wake (starvation bound for bounded wakes)
    longpoll_recheck_s: float = 1.0

    def validate_and_default(self) -> str:
        if (
            self.staleness_bound_ms < 0
            or self.degraded_staleness_bound_ms < 0
            or self.readiness_staleness_bound_ms < 0
        ):
            return "staleness bounds must be >= 0"
        if self.degraded_staleness_bound_ms < self.staleness_bound_ms:
            return (
                "degraded_staleness_bound_ms must be >= staleness_bound_ms"
            )
        if self.cache_max_entries < 0:
            return "cache_max_entries must be >= 0"
        if self.longpoll_max_wait_s < 0 or self.longpoll_recheck_s <= 0:
            return "long-poll waits must be >= 0 (recheck > 0)"
        if self.longpoll_shards < 1:
            self.longpoll_shards = 1
        return ""


@register_section
@dataclasses.dataclass
class TracerConfig(ConfigSection):
    """OTel-shaped trace export (reference config_tracer.go:11-23). The
    port reads ``xla_profile_dir`` (``utils/tracing.py::
    maybe_device_profile``: a torch.profiler capture of one solve); the
    field keeps the JAX package's name so one document serves both; the
    other fields configure the span exporter
    (``utils/tracing.py::export_spans``)."""

    section_id = "tracer"

    enabled: bool = False
    collector_endpoint: str = ""
    sample_ratio: float = 1.0
    #: when set, one solve per process runs under the device profiler
    #: and writes its trace here
    xla_profile_dir: str = ""

    def validate_and_default(self) -> str:
        if not isinstance(self.sample_ratio, (int, float)) or (
            not 0.0 <= self.sample_ratio <= 1.0
        ):
            return "sample_ratio must be a number within [0, 1]"
        if self.enabled and not self.collector_endpoint:
            return "enabled tracer needs a collector_endpoint"
        return ""


# -- the job plane's sections ------------------------------------------------ #


@register_section
@dataclasses.dataclass
class HostInitConfig(ConfigSection):
    """reference config_hostinit.go. The port reads ``host_throttle``
    (``units/crons.py::host_creation_jobs``: the intent hosts one
    ``host-create`` job spawns); the provisioning throttle, the status
    batch and the dynamic-host cap are the JAX section's, which no code
    of either package reads."""

    section_id = "host_init"

    host_throttle: int = 32
    provisioning_throttle: int = 200
    cloud_status_batch_size: int = 100
    max_total_dynamic_hosts: int = 5000


@register_section
@dataclasses.dataclass
class NotifyConfig(ConfigSection):
    """The event plane's delivery settings (reference config.go
    NotifyConfig): the drain's per-interval budget, the egress switch and
    the SMTP, webhook and GitHub-status transports' settings."""

    section_id = "notify"

    buffer_target_per_interval: int = 20
    buffer_interval_seconds: int = 60
    eventual_consistency_delay_s: float = 0.0
    #: master egress switch: off (the default) leaves deliveries in the
    #: per-channel outboxes; on drains them through the real transports
    #: (events/transports.py)
    egress_enabled: bool = False
    smtp_host: str = ""
    smtp_port: int = 25
    smtp_from: str = "evergreen@localhost"
    webhook_timeout_s: float = 10.0
    github_api_url: str = "https://api.github.com"
    github_status_token: str = ""


@register_section
@dataclasses.dataclass
class ApiConfig(ConfigSection):
    """HTTP surface settings (reference config_api.go + the webhook secret
    the GitHub hook route validates against, rest/route/github.go):
    ``url`` is the server URL baked into user data and deploy scripts
    (``cloud/provisioning.py::resolve_api_url``). The section is JAX's
    whole, so a section one package writes is the other's document;
    nothing reads ``max_request_body_bytes`` in either package."""

    section_id = "api"

    url: str = ""
    github_webhook_secret: str = ""
    #: path token for the SNS intake route /hooks/aws/{token} (reference
    #: sns.go verifies the signed SNS payload; a deployment without egress
    #: cannot fetch the signing cert, so the subscribe URL carries this
    #: secret instead)
    sns_secret: str = ""
    max_request_body_bytes: int = 32 * 1024 * 1024


@register_section
@dataclasses.dataclass
class AuthConfig(ConfigSection):
    """User-manager selection + per-manager settings (reference
    config_auth.go:103-116). Whole: migration
    ``0004-okta-service-gates-to-auth`` (``storage/migrations.py``) reads
    and rewrites the section, and a rewrite with fewer fields would drop
    the others."""

    section_id = "auth"

    #: naive | github | okta | api_only | external | multi
    preferred_type: str = "naive"
    allow_service_users: bool = False
    background_reauth_minutes: int = 0
    #: manager kinds chained in order when preferred_type == "multi"
    multi_managers: List[str] = dataclasses.field(default_factory=list)
    #: naive manager: [{"username", "password"|"sha256:<hex>",
    #: "display_name", "email"}]
    naive_users: List[Dict] = dataclasses.field(default_factory=list)
    github_client_id: str = ""
    github_client_secret: str = ""
    github_organization: str = ""
    #: explicit GitHub allow-list admitted without org membership
    github_users: List[str] = dataclasses.field(default_factory=list)
    okta_client_id: str = ""
    okta_client_secret: str = ""
    okta_issuer: str = ""
    #: the interactive-login gates (an extension of the reference's Okta
    #: config, as in the JAX package)
    okta_user_group: str = ""
    okta_scopes: List[str] = dataclasses.field(default_factory=list)
    okta_expected_email_domains: List[str] = dataclasses.field(
        default_factory=list
    )
    external_validation_url: str = ""
    egress_enabled: bool = False

    def validate_and_default(self) -> str:
        kinds = ("naive", "github", "okta", "api_only", "external")
        if self.preferred_type not in kinds + ("multi",):
            return f"unknown auth manager type {self.preferred_type!r}"
        if self.preferred_type == "multi" and not self.multi_managers:
            return "multi auth needs a multi_managers list"
        for k in self.multi_managers:
            if k not in kinds:
                return f"unknown manager kind {k!r} in multi_managers"
        for u in self.naive_users:
            if not u.get("username"):
                return "every naive auth user needs a username"
        return ""


@register_section
@dataclasses.dataclass
class OktaServiceConfig(ConfigSection):
    """Machine-to-machine Okta/OIDC credentials (reference
    config_okta_service.go:14-19: ClientID, ClientSecret, Scopes,
    Audience, Issuer — used for token-exchange grants, e.g. the spawn
    host workflow). The user-manager loader (api/auth.py
    load_user_manager) falls back to this section when the auth
    section's okta fields are empty — one credential set can serve both
    interactive login and service auth. Unlike the auth section it
    carries no user-group or email-domain fields: those gate
    interactive logins only, and are DELIBERATE EXTENSIONS of the auth
    section beyond config_okta_service.go:14-19 (see
    AuthConfig.okta_user_group / okta_expected_email_domains)."""

    section_id = "okta_service"

    client_id: str = ""
    client_secret: str = ""
    scopes: List[str] = dataclasses.field(default_factory=list)
    audience: str = ""
    issuer: str = ""

    #: legacy keys from when the interactive-login gates lived on THIS
    #: section; migration 0004 copies them into the auth section (where
    #: load_user_manager actually reads them) — a stored doc still
    #: carrying them predates the migration or was written by old code
    STALE_KEYS = ("user_group", "expected_email_domains")

    @classmethod
    def get_base(cls, store: Store) -> "ConfigSection":
        doc = store.collection(CONFIG_COLLECTION).get(cls.section_id)
        if doc:
            stale = [k for k in cls.STALE_KEYS if k in doc]
            if stale:
                # LOUD on every load: an operator who upgraded with
                # these keys set believes a login gate is active that
                # this section no longer enforces (the silent-weakening
                # failure mode) — migration 0004 copies the values to
                # auth.okta_user_group / auth.okta_expected_email_domains
                from .utils.log import get_logger

                CONFIG_STALE_KEYS.inc()
                get_logger("config").warning(
                    "okta_service carries stale login-gate keys — the "
                    "group/email-domain gates are enforced from the "
                    "auth section only (see migration "
                    "0004-okta-service-gates-to-auth)",
                    stale_keys=stale,
                )
        return super().get_base(store)

    def validate(self) -> str:
        """Full-credential check for when the token-exchange flow runs
        (reference config_okta_service.go Validate — deliberately NOT
        part of validate_and_default, which accepts an empty section)."""
        missing = [
            name
            for name, val in (
                ("client_id", self.client_id),
                ("client_secret", self.client_secret),
                ("scopes", self.scopes),
                ("audience", self.audience),
                ("issuer", self.issuer),
            )
            if not val
        ]
        return ", ".join(f"{m} is required" for m in missing)


@register_section
@dataclasses.dataclass
class LoggerConfig(ConfigSection):
    """reference config_logger.go. The port reads ``default_level``
    (``utils/log.py::configure``) and ``request_sample_ratio`` (the REST
    surface's sampled access log, ``api/rest.py``); the buffer knobs
    configure the JAX package's buffered sink, which is not ported, and
    are kept so that the admin settings carry the whole section."""

    section_id = "logger_config"

    buffer_count: int = 100
    buffer_interval_seconds: int = 20
    default_level: str = "info"
    #: fraction of HTTP requests logged as structured records (reference
    #: service/sampled_request_logger.go); 0 disables
    request_sample_ratio: float = 0.0

    def validate_and_default(self) -> str:
        if self.default_level not in ("debug", "info", "warning", "error"):
            return f"unknown log level {self.default_level!r}"
        # overrides arrive untyped — a TypeError here would defeat the
        # fail-safe-to-base path in ConfigSection.get
        if not isinstance(self.request_sample_ratio, (int, float)) or (
            not 0.0 <= self.request_sample_ratio <= 1.0
        ):
            return "request_sample_ratio must be a number within [0, 1]"
        return ""


@register_section
@dataclasses.dataclass
class RateLimitConfig(ConfigSection):
    """Per-surface request budgets (reference config_ratelimit.go;
    consumed by ``RestApi``'s limiter when no explicit limit is passed)."""

    section_id = "rate_limit"

    requests_per_minute: int = 0  # 0 = unlimited
    pre_auth_multiplier: int = 4

    def validate_and_default(self) -> str:
        if self.pre_auth_multiplier <= 0:
            self.pre_auth_multiplier = 4
        return ""


@register_section
@dataclasses.dataclass
class AmboyConfig(ConfigSection):
    """Background job plane sizing (reference config_amboy.go): the
    ``JobQueue`` worker pool ``env.py::Environment.build`` starts. The
    retry and lock knobs have no reader in either package."""

    section_id = "amboy"

    pool_size_local: int = 8
    retry_max_attempts: int = 10
    lock_timeout_minutes: int = 10

    def validate_and_default(self) -> str:
        if self.pool_size_local <= 0:
            self.pool_size_local = 8
        return ""


@register_section
@dataclasses.dataclass
class SpawnHostConfig(ConfigSection):
    """reference config_spawnhost.go: the per-user spawn-host and volume
    caps. In the JAX package only GraphQL's settings view reads them;
    the section is here so a document either package writes reads back
    whole."""

    section_id = "spawnhost"

    unexpirable_hosts_per_user: int = 1
    unexpirable_volumes_per_user: int = 1
    spawn_hosts_per_user: int = 3
    max_volume_size_gb: int = 500

    def validate_and_default(self) -> str:
        if self.spawn_hosts_per_user < 0:
            return "spawn_hosts_per_user cannot be negative"
        return ""


@register_section
@dataclasses.dataclass
class SleepScheduleConfig(ConfigSection):
    """reference config_sleep_schedule.go: hosts the sleep schedules
    never stop (no reader in either package)."""

    section_id = "sleep_schedule"

    permanently_exempt_hosts: List[str] = dataclasses.field(
        default_factory=list
    )


@register_section
@dataclasses.dataclass
class ContainerPoolsConfig(ConfigSection):
    """reference config_containerpools.go:10-28: the pools
    ``cloud/docker.py::get_container_pools`` reads from this document."""

    section_id = "container_pools"

    #: list of {"id": ..., "distro": ..., "max_containers": N, "port": N}
    pools: List[Dict] = dataclasses.field(default_factory=list)

    def validate_and_default(self) -> str:
        seen = set()
        for p in self.pools:
            if not p.get("id"):
                return "every container pool needs an id"
            if p["id"] in seen:
                return f"duplicate container pool id {p['id']!r}"
            seen.add(p["id"])
            if int(p.get("max_containers", 0)) <= 0:
                return f"pool {p['id']!r} needs max_containers > 0"
        return ""


@register_section
@dataclasses.dataclass
class SshConfig(ConfigSection):
    """SSH key pairs + connection options for host transports (reference
    config_ssh.go SSHConfig/SSHKeyPair;
    ``cloud/provisioning.py::transport_from_config``: a task-host key
    selects ``SshTransport``). The key names and the spawn-host key have
    no reader in the port."""

    section_id = "ssh"

    task_host_key_name: str = ""
    #: private-key file path (the reference stores a Secrets Manager ARN;
    #: here the parameter-store seam or a file path)
    task_host_key_path: str = ""
    spawn_host_key_name: str = ""
    spawn_host_key_path: str = ""
    user: str = "ubuntu"
    connect_timeout_s: float = 10.0
    #: bound on one deploy/setup script run — unrelated to connect time
    #: (package installs on first provision can take minutes)
    script_timeout_s: float = 1800.0
    #: extra -o options, e.g. ["StrictHostKeyChecking=no"]
    options: List[str] = dataclasses.field(default_factory=list)


# -- the ingestion plane's section ------------------------------------------- #


@register_section
@dataclasses.dataclass
class RepotrackerConfig(ConfigSection):
    """reference config_repotracker.go:11-15: the polling window
    ``ingestion/repotracker.py::fetch_revisions`` reads."""

    section_id = "repotracker"

    revs_to_fetch: int = 25
    max_revs_to_search: int = 50
    max_concurrent_requests: int = 0

    def validate_and_default(self) -> str:
        if self.revs_to_fetch <= 0:
            self.revs_to_fetch = 25
        if self.max_revs_to_search <= 0:
            self.max_revs_to_search = 2 * self.revs_to_fetch
        return ""


@register_section
@dataclasses.dataclass
class SlackConfig(ConfigSection):
    """reference config.go SlackConfig (notification channel)."""

    section_id = "slack"

    token: str = ""
    level: str = "error"
    name: str = ""
    #: message-post endpoint; configurable so tests aim a local fake
    api_url: str = ""


@register_section
@dataclasses.dataclass
class JiraConfig(ConfigSection):
    """reference config.go JIRAConfig (build-baron ticketing)."""

    section_id = "jira"

    host: str = ""
    default_project: str = ""
    email: str = ""


@register_section
@dataclasses.dataclass
class JiraNotificationsConfig(ConfigSection):
    """Per-project custom fields/components/labels stamped onto created
    Jira issues (reference config_jira_notifications.go; consumed by
    events/transports.py JiraTransport)."""

    section_id = "jira_notifications"

    #: project key → {"fields": {name: value}, "components": [...],
    #: "labels": [...]}
    custom_fields: Dict[str, Dict] = dataclasses.field(default_factory=dict)


# -- the sections only the admin settings routes read ----------------------- #


@register_section
@dataclasses.dataclass
class SchedulerConfig(ConfigSection):
    """Global scheduler knobs (reference config_scheduler.go)."""

    section_id = "scheduler"

    target_time_seconds: int = 0
    patch_factor: int = 0
    patch_time_in_queue_factor: int = 0
    commit_queue_factor: int = 0
    mainline_time_in_queue_factor: int = 0
    expected_runtime_factor: int = 0
    generate_task_factor: int = 0
    num_dependents_factor: float = 0.0
    stepback_task_factor: int = 0
    max_scheduled_tasks_per_distro: int = 0


@register_section
@dataclasses.dataclass
class UiConfig(ConfigSection):
    """reference config_ui.go:18-33."""

    section_id = "ui"

    url: str = ""
    http_listen_addr: str = ""
    secret: str = ""
    default_project: str = ""
    csrf_key: str = ""
    cors_origins: List[str] = dataclasses.field(default_factory=list)
    login_domain: str = ""
    #: site-wide announcement banner (reference admin settings Banner /
    #: BannerTheme)
    banner: str = ""
    banner_theme: str = "ANNOUNCEMENT"

    def validate_and_default(self) -> str:
        if self.csrf_key and len(self.csrf_key) != 32:
            return "csrf_key must be 32 characters"
        return ""


@register_section
@dataclasses.dataclass
class TriggerConfig(ConfigSection):
    """Downstream project triggers (reference config_triggers.go)."""

    section_id = "triggers"

    generate_task_distro: str = ""


@register_section
@dataclasses.dataclass
class CloudProvidersConfig(ConfigSection):
    """Provider credentials/regions (reference config_cloud.go — secrets
    referenced via the parameter store, never inline)."""

    section_id = "providers"

    aws_default_region: str = "us-east-1"
    aws_allowed_regions: List[str] = dataclasses.field(
        default_factory=lambda: ["us-east-1"]
    )
    aws_parameter_prefix: str = ""
    docker_default_registry: str = ""


@register_section
@dataclasses.dataclass
class CostConfig(ConfigSection):
    """reference config_cost.go: the rates ``models/cost.py`` bills a
    finished task at (the JAX package's model's class; see the module)."""

    section_id = "cost"

    #: instance type → USD per hour (on-demand)
    on_demand_prices: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: fraction of on-demand paid for spot capacity
    spot_discount: float = 0.35
    #: default rate for unknown instance types
    default_price_per_hour: float = 0.10
    #: EBS/hour attached-storage component
    ebs_price_per_hour: float = 0.01
    financial_formula_percentage: float = 1.0


@register_section
@dataclasses.dataclass
class ParameterStoreConfig(ConfigSection):
    """reference cloud/parameterstore config section."""

    section_id = "parameter_store"

    prefix: str = ""


@register_section
@dataclasses.dataclass
class ProjectCreationConfig(ConfigSection):
    """reference config_project_creation.go."""

    section_id = "project_creation"

    total_project_limit: int = 0
    repo_project_limit: int = 0
    jira_project: str = ""


@register_section
@dataclasses.dataclass
class SingleTaskDistroConfig(ConfigSection):
    """reference config_single_task_distro.go."""

    section_id = "single_task_distro"

    #: project -> allowed task name patterns
    project_tasks_pairs: List[Dict] = dataclasses.field(default_factory=list)


@register_section
@dataclasses.dataclass
class TestSelectionConfig(ConfigSection):
    """reference config_test_selection.go."""

    section_id = "test_selection"

    url: str = ""
    default_strategies: List[str] = dataclasses.field(default_factory=list)


@register_section
@dataclasses.dataclass
class SplunkConfig(ConfigSection):
    """reference config_splunk.go (log shipping)."""

    section_id = "splunk"

    server_url: str = ""
    token: str = ""
    channel: str = ""


@register_section
@dataclasses.dataclass
class GithubCheckRunConfig(ConfigSection):
    """reference config_github_check_run.go."""

    section_id = "github_check_run"

    check_run_limit: int = 0


@register_section
@dataclasses.dataclass
class BucketsConfig(ConfigSection):
    """Blob-store layout for task output (reference config_buckets.go)."""

    section_id = "buckets"

    log_bucket_name: str = ""
    test_results_bucket_name: str = ""
    long_retention_name: str = ""
