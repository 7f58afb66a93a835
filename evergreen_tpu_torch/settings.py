"""Store-backed config sections: the ones the tick's planning half reads.

A copy of the part of ``evergreen_tpu/settings.py`` the port needs:
``ConfigSection`` with its field-level overrides, and the
``service_flags``, ``capacity``, ``overrides``, ``release_mode``,
``overload``, ``sharding``, ``task_limits``, ``read_path`` and
``tracer`` sections (``models/cost.py`` registers ``cost`` as the JAX
package's model does), and the job plane's: ``host_init``, ``api``,
``auth``, ``logger_config``, ``amboy``, ``container_pools`` and
``ssh``. ``spawnhost`` and ``sleep_schedule`` wait for their reader,
the REST spawn-host surface. Sections live in the same
``config`` collection under the same ``_id`` with the same fields, so a
section one package writes reads back the same in the other
(``tests/test_torch_store.py``). The registry holds these sections only,
so an override of a section the port lacks is refused as unknown; the
other sections are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Type

from .storage.store import Store

CONFIG_COLLECTION = "config"


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


#: the ported sections by id; an override must name one of them
_SECTIONS: Dict[str, Type[ConfigSection]] = {}


def register_section(cls: Type[ConfigSection]) -> Type[ConfigSection]:
    assert cls.section_id
    _SECTIONS[cls.section_id] = cls
    return cls


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
    """Read-serving plane knobs: the long-poll hub's two
    (``dispatch/longpoll.py::hub_for``). The JAX section's other fields
    configure the REST surface's follower reads, response cache and
    long-poll wait, which are not ported: a document JAX writes reads
    back here without them, and an override of one is refused as
    unknown."""

    section_id = "read_path"

    #: condition-variable shards the parked agents spread across (bounds
    #: the wake-storm convoy on any single mutex)
    longpoll_shards: int = 32
    #: parked waiters re-check their queue generation at least this
    #: often even without a wake (starvation bound for bounded wakes)
    longpoll_recheck_s: float = 1.0

    def validate_and_default(self) -> str:
        if self.longpoll_recheck_s <= 0:
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
    ``host-create`` job spawns). The JAX section's provisioning, status
    batch and dynamic-host caps have no reader in either package."""

    section_id = "host_init"

    host_throttle: int = 32


@register_section
@dataclasses.dataclass
class ApiConfig(ConfigSection):
    """HTTP surface settings (reference config_api.go). The port reads
    ``url``: the server URL baked into user data and deploy scripts
    (``cloud/provisioning.py::resolve_api_url``). The JAX section's
    webhook, SNS and body-size fields configure the REST surface, which
    is not ported."""

    section_id = "api"

    url: str = ""


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
class LoggerConfig(ConfigSection):
    """reference config_logger.go. The port reads ``default_level``
    (``utils/log.py::configure``); the JAX section's buffer knobs and
    request sampling configure its buffered sink and REST surface, which
    are not ported."""

    section_id = "logger_config"

    default_level: str = "info"

    def validate_and_default(self) -> str:
        if self.default_level not in ("debug", "info", "warning", "error"):
            return f"unknown log level {self.default_level!r}"
        return ""


@register_section
@dataclasses.dataclass
class AmboyConfig(ConfigSection):
    """Background job plane sizing (reference config_amboy.go): the
    ``JobQueue`` worker pool ``env.py::Environment.build`` starts."""

    section_id = "amboy"

    pool_size_local: int = 8

    def validate_and_default(self) -> str:
        if self.pool_size_local <= 0:
            self.pool_size_local = 8
        return ""


@register_section
@dataclasses.dataclass
class ContainerPoolsConfig(ConfigSection):
    """reference config_containerpools.go:10-28: the pools
    ``cloud/docker.py::get_container_pools`` reads from this document."""

    section_id = "container_pools"

    #: list of {"id": ..., "distro": ..., "max_containers": N, "port": N}
    pools: List[Dict] = dataclasses.field(default_factory=list)


@register_section
@dataclasses.dataclass
class SshConfig(ConfigSection):
    """SSH options for the host transport (reference config_ssh.go;
    ``cloud/provisioning.py::transport_from_config``: a task-host key
    selects ``SshTransport``). The spawn-host key fields are not ported."""

    section_id = "ssh"

    #: private-key file path
    task_host_key_path: str = ""
    user: str = "ubuntu"
    connect_timeout_s: float = 10.0
    #: bound on one deploy/setup script run
    script_timeout_s: float = 1800.0
    #: extra -o options, e.g. ["StrictHostKeyChecking=no"]
    options: List[str] = dataclasses.field(default_factory=list)
