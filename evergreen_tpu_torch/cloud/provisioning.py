"""Host provisioning pipeline: intent → cloud spawn → provisioned agent.

A copy of ``evergreen_tpu/cloud/provisioning.py`` (reference
units/provisioning_create_host.go:121-576, provisioning_setup_host.go,
provisioning_user_data_done.go, provisioning_agent_deploy.go:186-295 and
the reprovisioning state machine of scheduler/wrapper.go:233-266): the
``HostTransport`` seam (``LocalTransport``, ``FakeTransport``,
``SshTransport``, resolved from the ``ssh`` section), the create pass
with its ``cloud.spawn`` fault seam and poison accounting, the
provisioning pass per bootstrap method, the phone-home, the agent
keep-alive, and the reprovisioning transitions. The provider status read
retries under ``_STATUS_RETRY``; spawn is never retried in-call.
"""
from __future__ import annotations

import abc
import time as _time
import weakref as _weakref
from typing import Dict, List, Optional, Tuple

from ..globals import HostStatus
from ..models import distro as distro_mod
from ..models import event as event_mod
from ..models import host as host_mod
from ..models.distro import Distro
from ..models.host import (
    REPROVISION_NONE,
    REPROVISION_RESTART_AGENT,
    REPROVISION_TO_LEGACY,
    REPROVISION_TO_NEW,
    Host,
)
from ..storage.store import Store
from ..utils import metrics as _metrics
from . import userdata as userdata_mod
from .manager import CloudHostStatus, get_manager

CLOUD_SPAWN_FAILED = _metrics.counter(
    "cloud_spawn_failed_total",
    "Provider spawn calls that raised; the host is charged a provision "
    "attempt and the next cron pass retries.",
    legacy="cloud.spawn_failed",
)
CLOUD_STATUS_FAILED = _metrics.counter(
    "cloud_status_failed_total",
    "Provider instance-status checks that raised after retry; the host "
    "holds its state until the next pass.",
    legacy="cloud.status_failed",
)

#: consecutive deploy/convert failures before a host is poisoned
#: (reference agentPutRetries=75 spread over amboy retries; here each
#: attempt is a full deploy pass, so the cap is lower)
MAX_AGENT_DEPLOY_ATTEMPTS = 10
MAX_PROVISION_ATTEMPTS = 3
#: how long a self-provisioning (user-data) host may sit in PROVISIONING
#: before it is declared failed (reference provisioning_user_data_done.go
#: retry window)
USER_DATA_DONE_TIMEOUT_S = 10 * 60.0
#: a RUNNING host whose agent has not talked for this long gets the agent
#: re-deployed (reference host.NeedsNewAgent via MaxUncommunicatedTime)
MAX_UNCOMMUNICATED_S = 10 * 60.0

#: retry for the IDEMPOTENT provider status read. Spawn itself is never
#: retried in-call — a spawn that committed at the provider but raised on
#: the response leg would double-provision; its retry unit is the cron
#: pass (provision_attempts accounting → poison at the cap).
from ..utils.retry import RetryPolicy as _RetryPolicy  # noqa: E402

_STATUS_RETRY = _RetryPolicy(attempts=2, base_backoff_s=0.1, deadline_s=15.0)


# --------------------------------------------------------------------------- #
# Host transport seam (replaces jasper gRPC / SSH)
# --------------------------------------------------------------------------- #


class HostTransport(abc.ABC):
    """Runs a script on a host. The reference reaches hosts via jasper
    gRPC over SSH (units/provisioning_agent_deploy.go RunSSHCommand); in
    this framework the transport is injectable: tests use a fake, the
    in-image deployment runs agents as directly-managed subprocesses so
    the default transport is a no-op success."""

    @abc.abstractmethod
    def run_script(self, store: Store, host: Host, script: str) -> Tuple[bool, str]:
        """Returns (ok, output)."""


class LocalTransport(HostTransport):
    """In-process deployment: agents attach as subprocesses supervised by
    the service (agent/monitor.py), so 'deploying' is a successful no-op
    recorded for observability."""

    def run_script(self, store: Store, host: Host, script: str) -> Tuple[bool, str]:
        return True, ""


class FakeTransport(HostTransport):
    """Test transport: scripts are recorded; failures can be scheduled
    per-host (count of failures to inject before succeeding)."""

    def __init__(self) -> None:
        self.scripts: List[Tuple[str, str]] = []  # (host_id, script)
        self.fail_counts: Dict[str, int] = {}

    def fail_next(self, host_id: str, times: int = 1) -> None:
        self.fail_counts[host_id] = self.fail_counts.get(host_id, 0) + times

    def run_script(self, store: Store, host: Host, script: str) -> Tuple[bool, str]:
        self.scripts.append((host.id, script))
        if self.fail_counts.get(host.id, 0) > 0:
            self.fail_counts[host.id] -= 1
            return False, "injected failure"
        return True, ""


class SshTransport(HostTransport):
    """Real ssh transport: pipes the script to ``bash -s`` on the host
    (reference units/provisioning_agent_deploy.go RunSSHCommand over
    jasper; here plain OpenSSH, configured by the ``ssh`` config section
    — key paths, user, -o options). Selected via transport_from_config
    when a key is configured; the zero-egress image keeps the default
    LocalTransport."""

    def __init__(self, user: str, key_path: str,
                 options: Optional[List[str]] = None,
                 connect_timeout_s: float = 10.0,
                 script_timeout_s: float = 1800.0) -> None:
        self.user = user
        self.key_path = key_path
        self.options = list(options or [])
        self.connect_timeout_s = connect_timeout_s
        self.script_timeout_s = script_timeout_s

    def run_script(self, store: Store, host: Host, script: str) -> Tuple[bool, str]:
        import subprocess

        addr = host.ip_address or host.external_id or host.id
        cmd = ["ssh", "-i", self.key_path,
               "-o", f"ConnectTimeout={int(self.connect_timeout_s)}",
               "-o", "BatchMode=yes"]
        for opt in self.options:
            cmd += ["-o", opt]
        cmd.append(f"{self.user}@{addr}")
        cmd.append("bash -s")
        try:
            proc = subprocess.run(
                cmd, input=script.encode(), capture_output=True,
                timeout=self.script_timeout_s,
            )
        except (subprocess.TimeoutExpired, OSError) as e:
            return False, f"ssh transport error: {e}"
        out = (proc.stdout + proc.stderr).decode(errors="replace")
        return proc.returncode == 0, out


def transport_from_config(store: Store) -> HostTransport:
    """Build the deploy transport from the ``ssh`` config section: a
    task-host key selects SshTransport, otherwise the in-image default
    (agents as supervised subprocesses) stands."""
    from ..settings import SshConfig

    cfg = SshConfig.get(store)
    if cfg.task_host_key_path:
        return SshTransport(
            cfg.user, cfg.task_host_key_path, cfg.options,
            cfg.connect_timeout_s, cfg.script_timeout_s,
        )
    return LocalTransport()


_transport: Optional[HostTransport] = None  # explicit injection (tests)
#: per-store (time, transport) — keyed weakly so two stores in one
#: process never see each other's resolved transport, and dead stores
#: don't pin entries
_config_transport_cache: "weakref.WeakKeyDictionary" = (
    _weakref.WeakKeyDictionary()
)


def set_transport(t: Optional[HostTransport]) -> None:
    """Explicitly inject a transport (tests, embedders). None restores
    config-driven resolution."""
    global _transport
    _transport = t


def get_transport(store: Optional[Store] = None) -> HostTransport:
    """The deploy transport: an explicitly injected one wins; otherwise
    resolve from the ``ssh`` config section at USE time (TTL-cached per
    store) so runtime edits to the section take effect without a
    restart."""
    if _transport is not None:
        return _transport
    if store is None:
        return LocalTransport()
    global _config_transport_cache
    if _config_transport_cache is None:
        # tolerate a nulled-out cache (defensive vs embedders/tests)
        _config_transport_cache = _weakref.WeakKeyDictionary()
    now = _time.monotonic()
    cached = _config_transport_cache.get(store)
    if cached is not None and now - cached[0] < 5.0:
        return cached[1]
    t = transport_from_config(store)
    _config_transport_cache[store] = (now, t)
    return t


# --------------------------------------------------------------------------- #
# Spawn
# --------------------------------------------------------------------------- #


def resolve_api_url(store: Store) -> str:
    """The server URL baked into user data / deploy scripts so hosts can
    reach back (reference Settings.Api.URL consumed by
    host.AgentCommand)."""
    from ..settings import ApiConfig

    return ApiConfig.get(store).url or "http://localhost:9090"


def create_hosts_from_intents(
    store: Store,
    now: Optional[float] = None,
    limit: int = 0,
    api_url: str = "",
) -> List[str]:
    """Spawn cloud instances for intent hosts (reference
    units/provisioning_create_host.go:121,410). Self-provisioning distros
    get generated user data attached to the spawn request (the provider's
    launch payload reads Host.user_data)."""
    now = _time.time() if now is None else now
    api_url = api_url or resolve_api_url(store)
    spawned = []
    intents = host_mod.find(
        store, lambda d: d["status"] == HostStatus.UNINITIALIZED.value
    )
    distros: Dict[str, Optional[Distro]] = {}
    for h in intents:
        if limit and len(spawned) >= limit:
            break
        try:
            mgr = get_manager(h.provider)
        except KeyError:
            continue
        if h.distro_id not in distros:
            distros[h.distro_id] = distro_mod.get(store, h.distro_id)
        d = distros[h.distro_id]
        boot = d.bootstrap_settings if d else None
        update: dict = {}
        if boot is not None:
            # record the method the host is provisioned with so later
            # distro edits can be detected as reprovision transitions
            update["bootstrap_method"] = boot.method
            if d and boot.method == boot.METHOD_USER_DATA:
                keys: List[str] = []
                if h.user_host and h.started_by:
                    # spawn hosts get their owner's SSH keys (reference
                    # cloud/spawn.go authorized_keys injection)
                    from ..models import user as user_mod

                    owner = user_mod.get_user(store, h.started_by)
                    if owner is not None:
                        keys = [k["key"] for k in owner.public_keys]
                try:
                    update["user_data"] = userdata_mod.for_host(
                        d, h, api_url, authorized_keys=keys
                    )
                except userdata_mod.UserDataError as exc:
                    # a distro saved with malformed custom user data must
                    # not stall the whole create pass: fall back to the
                    # framework provisioning part alone and record why
                    update["user_data"] = userdata_mod.provisioning_script(
                        d, h, api_url
                    ).render()
                    event_mod.log(
                        store,
                        event_mod.RESOURCE_HOST,
                        "HOST_USER_DATA_INVALID",
                        h.id,
                        {"distro": d.id, "error": str(exc)},
                        timestamp=now,
                    )
        if update:
            host_mod.coll(store).update(h.id, update)
            fresh = host_mod.get(store, h.id)
            if fresh is None:
                continue
            h = fresh  # spawn must see the user_data payload
        # Cloud-provider errors are steady-state (rate limits, capacity).
        # Spawn is NOT retried in-call (non-idempotent — see
        # _STATUS_RETRY note): a failure charges the host one provision
        # attempt, the next cron pass retries, and the cap poisons it —
        # one sick provider call never aborts the whole create pass.
        from ..utils import faults
        from ..utils.log import get_logger

        try:
            faults.fire("cloud.spawn")
            mgr.spawn_host(store, h)
        except Exception as exc:  # noqa: BLE001 — provider SDKs raise
            # whatever they like; all of it is a failed spawn
            attempts = h.provision_attempts + 1
            host_mod.coll(store).update(
                h.id, {"provision_attempts": attempts}
            )
            CLOUD_SPAWN_FAILED.inc()
            get_logger("cloud").error(
                "host-spawn-failed",
                host=h.id,
                distro=h.distro_id,
                attempts=attempts,
                error=repr(exc)[-300:],
            )
            event_mod.log(
                store,
                event_mod.RESOURCE_HOST,
                "HOST_SPAWN_FAILED",
                h.id,
                {"attempts": attempts, "error": str(exc)[-300:]},
                timestamp=now,
            )
            if attempts >= MAX_PROVISION_ATTEMPTS:
                _poison(
                    store, h,
                    f"failed {attempts} times to spawn cloud instance", now,
                )
            continue
        spawned.append(h.id)
        event_mod.log(
            store, event_mod.RESOURCE_HOST, "HOST_STARTED", h.id, timestamp=now
        )
    return spawned


# --------------------------------------------------------------------------- #
# Provision
# --------------------------------------------------------------------------- #


def _agent_deploy_script(
    d: Distro, h: Host, include_setup: bool, api_url: str
) -> str:
    """The deploy payload pushed over the transport: fetch agent, persist
    the host credential, optionally run the distro setup script, (re)start
    the agent monitor (reference provisioning_agent_deploy.go:246-268
    prepRemoteHost + startAgentOnRemote)."""
    ud = userdata_mod.provisioning_script(
        d if include_setup else _without_setup(d), h, api_url
    )
    return ud.render()


def _without_setup(d: Distro) -> Distro:
    import dataclasses as _dc

    return _dc.replace(d, setup="")


def _poison(store: Store, h: Host, reason: str, now: float) -> None:
    """Terminate a host provisioning can't make healthy (reference
    units/util.go HandlePoisonedHost → DisableAndNotifyPoisonedHost)."""
    try:
        mgr = get_manager(h.provider)
    except KeyError:
        mgr = None
    host_mod.coll(store).update(
        h.id,
        {"status": HostStatus.PROVISION_FAILED.value, "termination_time": now},
    )
    if mgr is not None:
        fresh = host_mod.get(store, h.id)
        if fresh is not None:
            mgr.terminate_instance(store, fresh, reason)
    event_mod.log(
        store,
        event_mod.RESOURCE_HOST,
        "HOST_PROVISION_FAILED",
        h.id,
        {"reason": reason},
        timestamp=now,
    )


def deploy_agent(
    store: Store,
    h: Host,
    d: Distro,
    now: float,
    *,
    first_provision: bool,
    transport: Optional[HostTransport] = None,
) -> bool:
    """One agent-put attempt over the transport. Success resets the
    failure counter and stamps agent liveness; failure increments it and
    poisons the host at the cap (reference
    provisioning_agent_deploy.go:186-295)."""
    transport = transport or get_transport(store)
    ok, output = transport.run_script(
        store,
        h,
        _agent_deploy_script(
            d, h, include_setup=first_provision, api_url=resolve_api_url(store)
        ),
    )
    if ok:
        host_mod.coll(store).update(
            h.id,
            {
                "agent_start_time": now,
                "last_communication_time": now,
                "agent_deploy_attempts": 0,
            },
        )
        event_mod.log(
            store, event_mod.RESOURCE_HOST, "AGENT_DEPLOYED", h.id, timestamp=now
        )
        return True
    attempts = h.agent_deploy_attempts + 1
    host_mod.coll(store).update(h.id, {"agent_deploy_attempts": attempts})
    event_mod.log(
        store,
        event_mod.RESOURCE_HOST,
        "AGENT_DEPLOY_FAILED",
        h.id,
        {"attempts": attempts, "output": output},
        timestamp=now,
    )
    if attempts >= MAX_AGENT_DEPLOY_ATTEMPTS:
        _poison(
            store,
            h,
            f"failed {attempts} times to put agent on host",
            now,
        )
    return False


def provision_ready_hosts(
    store: Store,
    now: Optional[float] = None,
    transport: Optional[HostTransport] = None,
) -> List[str]:
    """Advance hosts whose cloud instance is up through provisioning.

    Reference: provisioning_setup_host.go (server-driven SSH bootstrap),
    provisioning_user_data_done.go (self-provisioning wait). Flow per
    bootstrap method:

    - ``legacy-ssh``/``ssh``: push the agent over the transport; RUNNING on
      success, retry then poison on failure.
    - ``user-data``: the instance is already executing generated user data;
      hold in PROVISIONING until it phones home (mark_provisioning_done),
      fail it after USER_DATA_DONE_TIMEOUT_S.
    - ``preconfigured-image``: RUNNING as soon as the cloud says so.
    """
    now = _time.time() if now is None else now
    ready = []
    pending = host_mod.find(
        store,
        lambda d: d["status"]
        in (
            HostStatus.STARTING.value,
            HostStatus.PROVISIONING.value,
            HostStatus.BUILDING.value,
        ),
    )
    distros: Dict[str, Optional[Distro]] = {}
    for h in pending:
        try:
            mgr = get_manager(h.provider)
        except KeyError:
            continue
        try:
            status = _STATUS_RETRY.call(
                mgr.get_instance_status, store, h,
                operation="cloud-status", component="cloud",
            )
        except Exception as exc:  # noqa: BLE001 — a provider status
            # error holds THIS host where it is; the pass continues
            from ..utils.log import get_logger

            CLOUD_STATUS_FAILED.inc()
            get_logger("cloud").warning(
                "host-status-check-failed",
                host=h.id,
                error=repr(exc)[-300:],
            )
            continue
        if status != CloudHostStatus.RUNNING:
            continue
        if h.distro_id not in distros:
            distros[h.distro_id] = distro_mod.get(store, h.distro_id)
        d = distros[h.distro_id]
        boot = d.bootstrap_settings if d else None
        if boot is not None and boot.method == boot.METHOD_USER_DATA:
            # provision_time doubles as the wait-start stamp; _mark_running
            # (phone-home) overwrites it with the real provision time
            if h.status != HostStatus.PROVISIONING.value or not h.provision_time:
                host_mod.coll(store).update(
                    h.id, {"status": HostStatus.PROVISIONING.value,
                           "provision_time": now}
                )
            elif now - h.provision_time > USER_DATA_DONE_TIMEOUT_S:
                _poison(store, h, "user data never finished provisioning", now)
            continue
        if boot is not None and boot.method == boot.METHOD_PRECONFIGURED:
            _mark_running(store, h.id, now)
            ready.append(h.id)
            continue
        # server-driven bootstrap (legacy-ssh / ssh)
        if d is not None and h.status != HostStatus.PROVISIONING.value:
            host_mod.coll(store).update(
                h.id, {"status": HostStatus.PROVISIONING.value}
            )
            h.status = HostStatus.PROVISIONING.value
        if d is None or deploy_agent(
            store, h, d, now, first_provision=True, transport=transport
        ):
            _mark_running(store, h.id, now)
            ready.append(h.id)
    return ready


def _mark_running(store: Store, host_id: str, now: float) -> None:
    host_mod.coll(store).update(
        host_id,
        {
            "status": HostStatus.RUNNING.value,
            "provision_time": now,
            "agent_start_time": now,
            "last_communication_time": now,
            "provision_attempts": 0,
            "agent_deploy_attempts": 0,
        },
    )
    event_mod.log(
        store, event_mod.RESOURCE_HOST, "HOST_PROVISIONED", host_id, timestamp=now
    )


def mark_provisioning_done(
    store: Store, host_id: str, now: Optional[float] = None
) -> bool:
    """Phone-home endpoint body for self-provisioning hosts (reference
    units/provisioning_user_data_done.go + the host_provisioning REST
    route). Idempotent; only PROVISIONING/STARTING hosts transition."""
    now = _time.time() if now is None else now
    h = host_mod.get(store, host_id)
    if h is None:
        return False
    if h.status == HostStatus.RUNNING.value:
        return True
    if h.status not in (
        HostStatus.PROVISIONING.value,
        HostStatus.STARTING.value,
    ):
        return False
    _mark_running(store, host_id, now)
    return True


# --------------------------------------------------------------------------- #
# Agent keep-alive
# --------------------------------------------------------------------------- #


def agent_keepalive(
    store: Store,
    now: Optional[float] = None,
    transport: Optional[HostTransport] = None,
) -> List[str]:
    """Re-deploy agents that have gone silent (reference: the agent-deploy
    job is re-enqueued for hosts where NeedsNewAgent — stale
    LastCommunicationTime — model/host/host.go:2015 + crons
    PopulateAgentDeployJobs). Only server-bootstrapped (ssh) hosts get
    server-side redeploys; self-provisioning hosts carry an agent monitor
    that respawns locally."""
    now = _time.time() if now is None else now
    redeployed = []
    candidates = host_mod.find(
        store,
        lambda doc: doc["status"] == HostStatus.RUNNING.value
        and doc["started_by"] == "mci"
        and doc.get("running_task", "") == ""
        and now - doc.get("last_communication_time", 0.0) > MAX_UNCOMMUNICATED_S,
    )
    distros: Dict[str, Optional[Distro]] = {}
    for h in candidates:
        if h.distro_id not in distros:
            distros[h.distro_id] = distro_mod.get(store, h.distro_id)
        d = distros[h.distro_id]
        if d is None or d.bootstrap_settings.self_provisions():
            continue
        if deploy_agent(
            store, h, d, now, first_provision=False, transport=transport
        ):
            redeployed.append(h.id)
    return redeployed


# --------------------------------------------------------------------------- #
# Reprovisioning state machine
# --------------------------------------------------------------------------- #


def needs_reprovisioning(d: Distro, h: Optional[Host]) -> str:
    """Port of scheduler/wrapper.go:233-266 needsReprovisioning: decide
    the bootstrap transition for a host given the distro's CURRENT
    settings and the method the host was actually provisioned with."""
    boot = d.bootstrap_settings
    distro_legacy = boot.is_legacy()
    if h is None:
        return REPROVISION_NONE if distro_legacy else REPROVISION_TO_NEW
    # preserve an already-marked transition while it is still consistent;
    # a restart-agent request is method-agnostic here (every bootstrap
    # method runs the same agent runtime) so it always survives the mark
    # pass — unlike the reference's RestartJasper, which only exists on
    # non-legacy hosts
    if h.needs_reprovision != REPROVISION_NONE:
        if h.needs_reprovision == REPROVISION_RESTART_AGENT:
            return h.needs_reprovision
        if distro_legacy and h.needs_reprovision == REPROVISION_TO_LEGACY:
            return h.needs_reprovision
        if not distro_legacy and h.needs_reprovision == REPROVISION_TO_NEW:
            return h.needs_reprovision
        return REPROVISION_NONE
    host_legacy = h.bootstrap_method in ("", "legacy-ssh")
    if host_legacy and not distro_legacy:
        return REPROVISION_TO_NEW
    if not host_legacy and distro_legacy:
        return REPROVISION_TO_LEGACY
    return REPROVISION_NONE


def mark_hosts_needing_reprovision(
    store: Store, now: Optional[float] = None
) -> List[str]:
    """Detect bootstrap-method drift between live hosts and their distro
    and record the pending transition. The reference does this for static
    hosts on every allocator pass (scheduler/wrapper.go UpdateStaticDistro)
    — here it runs for every up host as a monitoring pass, which also
    covers long-lived dynamic hosts after a distro edit."""
    now = _time.time() if now is None else now
    marked = []
    distros = {d.id: d for d in distro_mod.find_all(store)}
    up = host_mod.find(
        store,
        lambda doc: doc["status"]
        in (HostStatus.RUNNING.value, HostStatus.PROVISIONING.value)
        and doc["started_by"] == "mci",
    )
    for h in up:
        d = distros.get(h.distro_id)
        if d is None:
            continue
        want = needs_reprovisioning(d, h)
        if want != h.needs_reprovision:
            host_mod.coll(store).update(h.id, {"needs_reprovision": want})
            if want != REPROVISION_NONE:
                marked.append(h.id)
                event_mod.log(
                    store,
                    event_mod.RESOURCE_HOST,
                    "HOST_REPROVISION_NEEDED",
                    h.id,
                    {"transition": want},
                    timestamp=now,
                )
    return marked


def request_agent_restart(store: Store, host_id: str, now: Optional[float] = None) -> bool:
    """Mark a host's agent runtime for a bounce without changing bootstrap
    method (reference host.SetNeedsJasperRestart, host.go:1573-1619)."""
    now = _time.time() if now is None else now
    h = host_mod.get(store, host_id)
    if h is None or h.needs_reprovision not in (
        REPROVISION_NONE,
        REPROVISION_RESTART_AGENT,
    ):
        return False
    host_mod.coll(store).update(
        host_id, {"needs_reprovision": REPROVISION_RESTART_AGENT}
    )
    return True


def reprovision_hosts(
    store: Store,
    now: Optional[float] = None,
    transport: Optional[HostTransport] = None,
) -> List[str]:
    """Execute pending bootstrap transitions on free hosts (reference
    units/provisioning_convert_host_to_new.go / _to_legacy.go /
    provisioning_restart_jasper.go). A host mid-task is skipped — the
    next_task gate tells its agent to exit first, which frees it."""
    now = _time.time() if now is None else now
    converted = []
    pending = host_mod.find(
        store,
        lambda doc: doc.get("needs_reprovision", "") != ""
        and doc["status"] == HostStatus.RUNNING.value
        and doc.get("running_task", "") == ""
        and doc.get("task_group_teardown_start_time", 0.0) == 0.0,
    )
    distros: Dict[str, Optional[Distro]] = {}
    for h in pending:
        if h.distro_id not in distros:
            distros[h.distro_id] = distro_mod.get(store, h.distro_id)
        d = distros[h.distro_id]
        if d is None:
            continue
        transition = h.needs_reprovision
        host_mod.coll(store).update(
            h.id, {"status": HostStatus.PROVISIONING.value}
        )
        ok = deploy_agent(
            store, h, d, now, first_provision=False, transport=transport
        )
        if not ok:
            # deploy_agent tracked the failure (and may have poisoned the
            # host); a still-alive host returns to RUNNING and retries on
            # the next pass
            fresh = host_mod.get(store, h.id)
            if fresh is not None and fresh.status == HostStatus.PROVISIONING.value:
                host_mod.coll(store).update(
                    h.id, {"status": HostStatus.RUNNING.value}
                )
            continue
        host_mod.coll(store).update(
            h.id,
            {
                "status": HostStatus.RUNNING.value,
                "needs_reprovision": REPROVISION_NONE,
                "bootstrap_method": d.bootstrap_settings.method,
                "provision_time": now,
            },
        )
        converted.append(h.id)
        event_mod.log(
            store,
            event_mod.RESOURCE_HOST,
            "HOST_REPROVISIONED",
            h.id,
            {"transition": transition,
             "method": d.bootstrap_settings.method},
            timestamp=now,
        )
    return converted
