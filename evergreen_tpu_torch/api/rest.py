"""REST v2 API surface: the agent protocol, the task routes, the user's
side, the operator's surface and the event plane's routes.

A copy of the part of ``evergreen_tpu/api/rest.py`` that the agents on
the build hosts and the users speak to (reference rest/route/
host_agent.go, agent.go): a stdlib-only WSGI application served by a
threading HTTP server (``serve``). Each handler is a function (method,
match, body) → (status, payload), as in the JAX package. It does no
device work and imports no ``torch``: the tick that plans what it hands
out, and whose queue documents the queue route serves, runs in the job
plane (``env.py``).

Ported:

- the plumbing: ``ApiError``, the path classes, the
  two-tier rate limit (``RateLimitConfig``), host-credential auth for the
  agent paths and, for the rest, API-key auth or a session token that the
  user manager minted (``_authorize``, ``_session_token``,
  ``_authorize_agent``, ``_rate_limited``; the manager is
  ``api/auth.py::load_user_manager``'s, or the one ``__init__`` is given,
  with ``user_manager`` and ``reload_user_manager``), the overload
  ladder's admission control (``_overload_shed``, which counts every
  request into the ladder's ``api_rps``), ``handle`` with the
  ``api_requests_total`` / ``api_request_duration_ms`` instruments, the
  fingerprint ETag response cache in front of the route table
  (``_serve_read`` over ``api/readcache.py``: ``If-None-Match`` answers
  304 with no store read beyond the change token), ``wsgi_app`` with the
  sampled access log (``LoggerConfig.request_sample_ratio``) and
  ``serve``;
- the agent protocol: ``next_task`` (with ``?wait=`` long-poll parking,
  clamped to ``ReadPathConfig.longpoll_max_wait_s``), ``provisioning_done``,
  ``task_config``, ``resolved_task_config``, ``start``, ``heartbeat``,
  ``end`` (``finish_agent_task``: ``mark_end`` and the poisoned-host
  accounting) and ``logs``;
- the task routes: get, executions, logs, patch (activation cascades to
  the dependencies), abort, restart, ``queue_position``, ``tests``,
  ``artifacts`` and ``select_tests``, and ``POST /rest/v2/artifacts/sign``;
- the ingestion routes (``ingestion/``): the distro list, get and put,
  the project list and put, a pushed revision (``store_revisions``),
  ``validate``, and the patches (create, with ``finalize``; list, get,
  finalize, cancel);
- the read routes: the hosts list and get, a distro's queue, the
  versions list and get, a version's tasks, a build and its display
  tasks, a project's last green version, and ``/rest/v2/status``;
- spawn hosts and volumes (``cloud/spawnhost.py``, ``cloud/volumes.py``):
  ``POST /rest/v2/hosts`` and a spawn host's ``start``, ``stop``,
  ``terminate``, ``extend_expiration`` and ``sleep_schedule``, and the
  volumes' create, list, ``attach`` (to the caller's own spawn host),
  ``detach`` and ``DELETE``, each gated on the resource's owner
  (``_require_owner``; creation on ``_claimed_user``);
- follower reads and replicas (``storage/replica.py``): a follower
  attached with ``attach_read_replica`` (``env.py`` attaches one to a
  durable writer) serves the eligible reads (``_replica_route_ok``:
  ``/rest/v2/`` GETs but the agent protocol, the mutating GETs and the
  ``admin`` and ``stats`` introspection) while ``_replica_usable`` (not
  fence-blocked, under ``ReadPathConfig.staleness_bound_ms``), with
  ``X-Evg-Served-By`` and ``X-Evg-Staleness-Ms``; at RED an expensive
  read degrades to it under the looser bound with a ``Warning: 110``
  header, where BLACK sheds. The handlers read ``self.store``, which is
  the follower for such a request (a thread-local override). The ETag's
  store tag is the serving store's: the follower's or the replica
  process's id, else this API's own (``_etag_tag``), so validators of
  two stores never match. An API built over a ``ReplicaStore`` (``service
  --replica-of``) forwards every write to the primary
  (``_maybe_forward``, ``_forward_to_primary``: the non-GET requests
  but ``_READONLY_POSTS``, and ``_MUTATING_GETS``; the credential, agent
  and GitHub headers relayed, a webhook's raw bytes, ``X-Evg-Forwarded``
  so it never hops again, the hop's timeout stretched past a ``?wait=``,
  one ``poll()`` after it for read-your-writes, 503 with the primary's
  URL when it is unreachable), serves a read itself only while it is
  fresh (fence-blocked: forward or 503; too stale: forward, or serve
  with ``Warning: 110`` when the primary is down), answers a local write
  ``ReplicaReadOnly`` with 503, and ``/healthz/ready`` with its role,
  id and staleness (503 when fence-blocked or past
  ``readiness_staleness_bound_ms``); a primary's answer carries its
  follower's ``follower_staleness_ms``;
- the login routes (``/login``, ``/login/redirect``, ``/login/callback``,
  ``/logout``) and the user's SSH keys (``/rest/v2/keys``);
- the rest of the user and admin routes: a version's ``restart`` and
  ``abort`` (``units/task_jobs.py``), a task's ``annotations`` and
  ``annotation`` (``models/annotations.py``), the admin settings over
  every config section (``get_admin``, ``set_admin``: superuser only,
  through ``_require_superuser`` and ``_ADMIN_PATHS``), a distro's
  ``DELETE`` (409 while a live host references it; its queues cleared),
  a project's ``task_reliability``
  (``models/reliability.py``), the permission routes (the catalog, every
  user's roles, a user's GET, POST and DELETE, over ``models/user.py``'s
  roles), a project's ``copy`` and ``copy/variables``
  (``models/project_vars.py``) and its ``events``. None of them is a
  mutating GET or a read-only POST, and none is cached, as in the JAX
  package: a replica forwards the POSTs, the PUT and the DELETEs, and
  serves the GETs from its own store;
- the operator's surface, shed- and auth-exempt where JAX's is:
  ``admin/overload`` (the ladder's level, gauges, counters and shed
  totals), ``GET /metrics`` (the whole metrics registry in Prometheus
  text v0.0.4, a ``PlainTextResponse`` that ``wsgi_app`` sends as
  ``text/plain; version=0.0.4``), ``/healthz`` and ``/healthz/ready``,
  ``admin/traces`` and ``admin/trace/<id>`` (``utils/tracing.py``),
  ``admin/provenance/<distro>`` and ``admin/capacity[/<distro>]`` (the
  card's last solve and capacity program, ``scheduler/provenance.py``),
  ``admin/fleet`` (an attached ``FleetSupervisor``'s ``fleet_state``;
  404 without one), ``admin/log_lines``, ``stats/spans``,
  ``stats/system`` and ``stats/hosts``;
- the event plane: ``__init__`` builds the GitHub hook handler
  (``api/github_hooks.py``, served at ``POST /hooks/github`` in
  ``wsgi_app`` with the ``webhook_secret``: a flag's value, else the
  ``api`` section's) and installs the outbox senders
  (``events/senders.py``, ``events/github_status.py``); the events,
  resource events, waterfall, subscriptions (create, list, delete),
  ``notifications/slack`` and ``notifications/email`` routes, and the SNS
  intake ``/hooks/aws[/<token>]``.

Departures from the JAX package:

- ``GET /rest/v2/admin/settings`` answers 403 to an authenticated caller
  without the superuser scope (``get_admin``). The sections hold the
  service's credentials (the webhook and SNS secrets, ``naive_users``'
  passwords, the OAuth client secrets, the Slack and Jira tokens, the UI
  secret); the JAX package hands all of them to any authenticated user,
  since its ``_ADMIN_PATHS`` gates only the writes;
- a replica's forwarded write (``X-Evg-Forwarded``) on a durable store
  is answered once it is in the WAL (``_journaled``:
  ``DurableStore.drain``), and a forwarded read is served by the
  writer's own store, never its follower. The JAX package answers a
  forwarded write while it rides an open tick group or waits behind
  frames on the flusher, and may serve a forwarded read from its
  follower, so a replica's read-your-writes can miss the write it
  forwarded;
- the ``/graphql`` surface is not ported, so the ladder's GraphQL rule,
  the follower's GraphQL queries and ``_maybe_forward``'s GraphQL
  mutation test are left out: ``POST /graphql`` answers 404 on a
  primary, and a replica forwards it as any other POST;
- ``end`` keeps the test results and artifact records the agent attached
  (``test_results`` and ``artifact_files`` in the body, which
  ``agent/rest_comm.py`` sends), as ``agent/comm.py::LocalCommunicator``
  does for an agent in process. The JAX package's HTTP agent sends
  neither and its route keeps neither, so a task run over HTTP there
  lists no tests and no artifacts;
- ``serve``'s ``wsgiref`` handler writes no per-request access line to
  stderr (the sampled access log is ported).
"""
from __future__ import annotations

import json
import re
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..dispatch.assign import assign_next_available_task
from ..dispatch.dag_dispatcher import DispatcherService
from ..globals import HostStatus, TaskStatus
from ..ingestion import patches as patch_mod
from ..ingestion import repotracker as repotracker_mod
from ..ingestion.validator import validate_project
from ..models import build as build_mod
from ..models import distro as distro_mod
from ..models import event as event_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..models import version as version_mod
from ..models.lifecycle import mark_task_started
from ..settings import ServiceFlags, all_sections, get_section
from ..storage.replica import ReplicaReadOnly
from ..storage.store import Store
from ..units import task_jobs
from ..utils import metrics as _metrics

API_SHED = _metrics.counter(
    "api_requests_shed_total",
    "Requests 429d by the overload ladder's admission control (RED "
    "sheds expensive reads; BLACK sheds everything but agent, hooks, "
    "login, admin, and telemetry).",
    legacy="overload.api_shed",
)
API_REQUESTS = _metrics.counter(
    "api_requests_total",
    "Handled API requests by status class (2xx/3xx/4xx/5xx).",
    labels=("outcome",),
)
API_REQUEST_MS = _metrics.histogram(
    "api_request_duration_ms",
    "Wall time of API request handling (routing + handler), by status "
    "class.",
    labels=("outcome",),
)

READS_DEGRADED = _metrics.counter(
    "api_reads_degraded_total",
    "Expensive reads served from the bounded-stale follower replica "
    "at overload RED (with a Warning header) instead of 429ing — "
    "shedding is the fallback, not the strategy.",
)

JSON = "application/json"


class ApiError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status
        self.message = message


Handler = Callable[[str, re.Match, dict], Tuple[int, Any]]


def _session_token(headers: Dict[str, str]) -> str:
    """Session credential from Authorization: Bearer … or the evg-token
    cookie (the shapes gimlet's user middleware accepts)."""
    authz = headers.get("authorization", "")
    if authz.lower().startswith("bearer "):
        return authz[7:].strip()
    for part in headers.get("cookie", "").split(";"):
        name, _, value = part.strip().partition("=")
        if name == "evg-token":
            return value
    return ""


#: route prefixes the agent protocol uses (host-credentialed in the
#: reference; exempt from user-key auth)
_AGENT_PATHS = re.compile(r"^/rest/v2/(hosts/[^/]+/agent/|tasks/[^/]+/agent/)")
_ADMIN_PATHS = re.compile(r"^/rest/v2/(admin/|distros/[^/]+$|projects/[^/]+$)")
#: login surface: reachable without credentials (it is how you get them);
#: still behind the pre-auth peer rate limit
_LOGIN_PATHS = re.compile(r"^/(login(/redirect|/callback)?|logout)$")
#: inbound webhook intake: credentialed by its own secret (path token /
#: payload signature), not user keys
_HOOK_PATHS = re.compile(r"^/hooks/aws(/|$)")
#: load-balancer probes: exempt from auth, rate limits, and overload
#: shedding — a probe that 401s or 429s ejects a healthy server
_HEALTH_PATHS = re.compile(r"^/healthz(/ready)?$")
#: expensive read/list surfaces — the FIRST routes the overload ladder
#: sheds at RED; everything the agent protocol needs stays exempt at
#: every level
_EXPENSIVE_READS = re.compile(
    r"^/rest/v2/(hosts|distros|versions|patches|projects|volumes)$"
    r"|^/rest/v2/versions/[^/]+/tasks$"
    r"|^/rest/v2/builds/[^/]+/display_tasks$"
    r"|^/rest/v2/tasks/[^/]+/(tests|logs|executions)$"
    r"|^/rest/v2/distros/[^/]+/queue$"
    r"|^/rest/v2/projects/[^/]+/last_green$"
)
#: GETs that WRITE (login state and session minting, task assignment):
#: a replica forwards them like any other mutation
_MUTATING_GETS = re.compile(
    r"^/login/(redirect|callback)$"
    r"|^/rest/v2/hosts/[^/]+/agent/next_task$"
)
#: POSTs that only read (validation, URL signing, test selection): a
#: replica serves them itself, and keeps serving them with the primary
#: down
_READONLY_POSTS = re.compile(
    r"^/rest/v2/(projects/[^/]+/validate"
    r"|artifacts/sign"
    r"|tasks/[^/]+/select_tests)$"
)


class PlainTextResponse(str):
    """A handler payload served verbatim instead of JSON-encoded —
    ``GET /metrics`` returns Prometheus exposition text. In-process
    callers (tests, matrices) still see an ordinary ``str``."""

    content_type = "text/plain; version=0.0.4; charset=utf-8"


_REASONS = {200: "OK", 201: "Created", 304: "Not Modified",
            400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
            404: "Not Found", 409: "Conflict", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


class RestApi:
    def __init__(
        self,
        store: Store,
        dispatcher_service: Optional[DispatcherService] = None,
        require_auth: bool = False,
        rate_limit_per_min: Optional[int] = None,
        user_manager=None,
        forward_writes: bool = True,
    ) -> None:
        #: per-request state (thread-local: the WSGI server is
        #: threading): the authenticated identity, the request's headers,
        #: the response headers a handler or a gate adds, and the serving
        #: store's override during a follower read (``store`` reads it,
        #: so this comes first)
        self._ident = threading.local()
        self.store = store
        #: a replica process forwards mutations to the primary writer;
        #: False answers them 503 with the primary's URL instead
        self.forward_writes = forward_writes
        self.svc = dispatcher_service or DispatcherService(store)
        self.require_auth = require_auth
        #: the attached follower-read replica (storage/replica.py), see
        #: attach_read_replica
        self.read_replica = None
        #: bounded LRU for the fingerprint ETag response cache
        #: (api/readcache.py); sized lazily from ReadPathConfig
        self._response_cache = None
        #: PROCESS-UNIQUE ETag store tag: generation counters are
        #: process-local, so a restarted writer minting the same constant
        #: tag could falsely 304 a validator from the previous process
        import uuid as _uuid

        self._etag_tag = f"p-{_uuid.uuid4().hex[:8]}"
        #: pluggable login manager (api/auth.py); None → built lazily from
        #: the admin-editable auth config section
        self._user_manager = user_manager
        #: None = per-request default from the ``rate_limit`` config
        #: section (live); 0 = explicitly unlimited; >0 = fixed limit
        self._rate_limit_explicit = rate_limit_per_min
        from ..models.user import RateLimiter

        self._rate_limiter = RateLimiter(store, 0)
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        #: (cfg, read_at) TTL cache of the read_path section
        self._read_cfg: Optional[Tuple[object, float]] = None
        #: (ratio, read_at) — see _sample_request_log
        self._sample_ratio_cache: Optional[Tuple[float, float]] = None
        self._register_routes()
        #: GitHub webhook intake (reference rest/route/github.go); secret +
        #: config fetcher injectable
        from .github_hooks import GithubHookHandler

        self.github_hooks = GithubHookHandler(store)
        self._webhook_secret_override = ""
        from ..events.github_status import install as _install_ghs
        from ..events.senders import install as _install_senders

        _install_ghs(store)
        _install_senders(store)

    @property
    def store(self):
        """The request's serving store: the store this API was built
        over, or during a follower read (``_dispatch_route``'s
        ``serving``) the attached replica, through a thread-local
        override — the handlers read ``self.store`` unchanged."""
        override = getattr(self._ident, "store_override", None)
        return override if override is not None else self._store

    @store.setter
    def store(self, value) -> None:
        self._store = value

    def attach_read_replica(self, replica) -> None:
        """Attach a WAL-tailing ``ReplicaStore`` as this API's
        follower-read target: eligible list/read GETs serve from it
        while its staleness is under ``ReadPathConfig``'s bound and it
        is not fence-blocked; at RED, expensive reads degrade to it
        under the looser bound before 429ing."""
        self.read_replica = replica

    def _read_path_config(self):
        """TTL-cached ReadPathConfig (read per request)."""
        now = _time.monotonic()
        cached = self._read_cfg
        if cached is None or now - cached[1] > 5.0:
            from ..settings import ReadPathConfig

            cached = (ReadPathConfig.get(self.store), now)
            self._read_cfg = cached
        return cached[0]

    @property
    def user_manager(self):
        if self._user_manager is None:
            from .auth import load_user_manager

            self._user_manager = load_user_manager(self.store)
        return self._user_manager

    def reload_user_manager(self) -> None:
        """Drop the cached manager so the next request re-reads the auth
        config section (called after admin edits to it)."""
        self._user_manager = None

    @property
    def webhook_secret(self) -> str:
        """Live view of the hook secret: an explicit override (CLI flag or
        test) wins; otherwise the stored ApiConfig section is consulted per
        delivery so admin edits apply without a restart."""
        if self._webhook_secret_override:
            return self._webhook_secret_override
        from ..settings import ApiConfig

        return ApiConfig.get(self.store).github_webhook_secret

    @webhook_secret.setter
    def webhook_secret(self, value: str) -> None:
        self._webhook_secret_override = value

    def _github_hook(self, raw: bytes, headers: Dict[str, str], body: dict):
        from .github_hooks import verify_signature

        if self.require_auth and not self.webhook_secret:
            # production mode with no secret configured: fail closed rather
            # than accept unsigned payloads that create versions/patches
            return 401, {"error": "github webhook secret not configured"}
        if not verify_signature(
            self.webhook_secret, raw, headers.get("x-hub-signature-256", "")
        ):
            return 401, {"error": "invalid webhook signature"}
        event = headers.get("x-github-event", "")
        return self.github_hooks.handle(event, body)

    def _authorize(
        self, method: str, path: str, headers: Dict[str, str]
    ) -> Optional[Tuple[int, Any]]:
        """API-key auth + role gating (reference: gimlet auth middleware +
        role manager, environment.go:1249; agent routes use host
        credentials instead of user keys).

        Rate limiting is two-tier: a coarse PRE-auth bucket keyed on the
        server-derived peer address (bounds credential brute-forcing),
        then a per-identity bucket AFTER auth. Neither keys on spoofable
        client headers when auth is on."""
        self._ident.user = ""
        self._ident.superuser = False
        self._ident.headers = headers
        limit = self._rate_limit_explicit
        pre_mult = 4
        if limit is None:
            from ..settings import RateLimitConfig

            rl = RateLimitConfig.get(self.store)
            limit = rl.requests_per_minute
            pre_mult = rl.pre_auth_multiplier
        # the scrape and the health probes are exempt from both tiers
        if path == "/metrics" or _HEALTH_PATHS.match(path):
            limit = 0
        if limit:
            peer = headers.get("x-peer-addr") or "anon"
            if not self._rate_limiter.allow(
                f"peer:{peer}", limit=pre_mult * limit
            ):
                return self._rate_limited()
        denied = None
        if self.require_auth and _AGENT_PATHS.match(path):
            denied = self._authorize_agent(path, headers)
        elif self.require_auth and not (
            _LOGIN_PATHS.match(path) or _HOOK_PATHS.match(path)
            or path == "/metrics"
            or _HEALTH_PATHS.match(path)
        ):
            from ..models import user as user_mod

            u = user_mod.user_by_api_key(self.store, headers.get("api-key", ""))
            if u is not None and u.id != headers.get("api-user", u.id):
                u = None
            if u is None:
                # session token minted by the configured user manager
                # (reference: gimlet session cookie auth alongside the
                # api-key middleware)
                u = self.user_manager.get_user_by_token(
                    self.store, _session_token(headers)
                )
            if u is None:
                return 401, {"error": "invalid or missing API credentials"}
            self._ident.user = u.id
            self._ident.superuser = u.has_scope(user_mod.SCOPE_SUPERUSER)
            mutating = method in ("POST", "PUT", "PATCH", "DELETE")
            if mutating and _ADMIN_PATHS.match(path) and not u.has_scope(
                user_mod.SCOPE_SUPERUSER
            ):
                denied = 403, {"error": "admin scope required"}
        if denied is not None:
            return denied
        if limit:
            # without auth there is no trustworthy identity; the api-user
            # header at least keeps well-behaved clients in separate
            # buckets (the peer bucket above still bounds abusers)
            key = (
                getattr(self._ident, "user", "")
                or (not self.require_auth and headers.get("api-user"))
                or headers.get("x-peer-addr")
                or "anon"
            )
            if not self._rate_limiter.allow(key, limit=limit):
                return self._rate_limited()
        return None

    def _rate_limited(self) -> Tuple[int, Any]:
        """Shared 429 for the two rate-limit tiers: Retry-After is the
        limiter window remainder, stretched by the overload ladder when
        the service is also browning out."""
        from ..utils import overload

        retry = max(
            1.0,
            self._rate_limiter.retry_after_s(),
            overload.monitor_for(self.store).retry_after_s(),
        )
        self._ident.response_headers = [
            ("Retry-After", str(int(retry)))
        ]
        return 429, {"error": "rate limit exceeded", "retry_after_s": retry}

    def _authorize_agent(
        self, path: str, headers: Dict[str, str]
    ) -> Optional[Tuple[int, Any]]:
        """Host-credential auth for the agent protocol (reference
        rest/route/host_agent.go middleware: every agent call carries
        Host-Id/Host-Secret; the host doc's secret is set at creation).

        A host may only act as itself: the path's host id must match the
        credential, and task-scoped routes require the task to be
        dispatched to (or running on) the authenticated host."""
        import hmac as _hmac

        host_id = headers.get("host-id", "")
        h = host_mod.get(self.store, host_id) if host_id else None
        if (
            h is None
            or not h.secret
            or not _hmac.compare_digest(h.secret, headers.get("host-secret", ""))
        ):
            return 401, {"error": "invalid or missing host credentials"}
        m = re.match(r"^/rest/v2/hosts/([^/]+)/agent/", path)
        if m and m.group(1) != host_id:
            return 403, {"error": "host credential does not match path host"}
        # task-scoped calls — both /tasks/<t>/agent/* and the host-scoped
        # /hosts/<h>/agent/task_config/<t> — require the task to be bound
        # to the authenticated host (its resolved config carries expansions)
        m = re.match(
            r"^/rest/v2/(?:tasks/([^/]+)/agent/"
            r"|hosts/[^/]+/agent/task_config/([^/]+)$)",
            path,
        )
        if m:
            task_id = m.group(1) or m.group(2)
            t = task_mod.get(self.store, task_id)
            if t is None:
                return 404, {"error": f"no task {task_id!r}"}
            if t.host_id != host_id and h.running_task != t.id:
                return 403, {"error": "task is not assigned to this host"}
        self._ident.user = f"host/{host_id}"
        return None

    # ------------------------------------------------------------------ #
    # plumbing
    # ------------------------------------------------------------------ #

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method, re.compile(f"^{pattern}$"), handler))

    def _overload_shed(
        self, method: str, path: str, body: dict
    ) -> Optional[Tuple[int, Any]]:
        """Overload-adaptive admission control (utils/overload.py): at
        RED the expensive read/list endpoints 429 with a level-derived
        Retry-After; at BLACK every route sheds except the agent
        protocol, webhooks, login, and admin. Agent heartbeat/end-task
        traffic is never shed at any level."""
        from ..utils import overload

        monitor = overload.monitor_for(self.store)
        monitor.note_api_request()
        level = monitor.level()
        if level < overload.RED:
            return None
        if (
            _AGENT_PATHS.match(path)
            or _LOGIN_PATHS.match(path)
            or _HOOK_PATHS.match(path)
            or _ADMIN_PATHS.match(path)
            or path == "/metrics"
            or _HEALTH_PATHS.match(path)
        ):
            return None
        expensive = method == "GET" and _EXPENSIVE_READS.match(path) is not None
        if level < overload.BLACK and not expensive:
            return None
        if (
            level < overload.BLACK
            and self._replica_usable(degraded=True) is not None
            and self._replica_route_ok(method, path, body)
        ):
            # the RED degrade is decided before any shed side effect: a
            # read that will be served (bounded-stale, with a Warning)
            # does not count, log or carry a Retry-After as a shed
            self._ident.degrade_read = True
            return None
        from ..utils.log import get_logger

        retry = monitor.retry_after_s(level)
        API_SHED.inc()
        get_logger("api").warning(
            "request-shed",
            method=method,
            path=path,
            level=overload.level_name(level),
            retry_after_s=retry,
        )
        self._ident.response_headers = [
            ("Retry-After", str(int(retry)))
        ]
        return 429, {
            "error": "service overloaded",
            "level": overload.level_name(level),
            "retry_after_s": retry,
        }

    def handle(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Any]:
        t0 = _time.perf_counter()
        status, payload = self._handle_inner(method, path, body, headers)
        if method != "GET" or _MUTATING_GETS.match(path):
            self._journaled(headers or {})
        outcome = f"{status // 100}xx"
        API_REQUESTS.inc(outcome=outcome)
        API_REQUEST_MS.observe(
            (_time.perf_counter() - t0) * 1e3, outcome=outcome
        )
        return status, payload

    def _handle_inner(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Any]:
        body = body or {}
        headers = headers or {}
        self._ident.response_headers = []
        self._ident.serialized_payload = None
        self._ident.degrade_read = False
        shed = self._overload_shed(method, path, body)
        if shed is not None:
            return shed
        # an expensive RED read _overload_shed chose to degrade to the
        # bounded-stale follower instead of 429ing
        degraded = bool(getattr(self._ident, "degrade_read", False))
        denied = self._authorize(method, path, headers)
        if denied is not None:
            return denied
        forwarded = self._maybe_forward(method, path, body, headers)
        if forwarded is not None:
            return forwarded
        return self._serve_read(method, path, body, headers, degraded)

    def _dispatch_route(
        self, method: str, path: str, body: dict, serving=None
    ) -> Tuple[int, Any]:
        """Run the matching route handler, with the serving store
        overridden to a follower replica for this request when
        ``serving`` is given."""
        if serving is not None:
            self._ident.store_override = serving
        try:
            for m, pattern, handler in self._routes:
                if m != method:
                    continue
                match = pattern.match(path)
                if match:
                    try:
                        return handler(method, match, body)
                    except ApiError as e:
                        return e.status, {"error": e.message}
                    except ReplicaReadOnly as e:
                        # a replica's store took a write: the client
                        # retries it against the primary
                        return 503, {
                            "error": "this server is a read-only replica",
                            "primary": e.primary_url,
                        }
                    except KeyError as e:
                        return 404, {"error": f"not found: {e}"}
                    except (ValueError, TypeError) as e:
                        # malformed client input (?limit=abc, wrong-typed
                        # JSON field) is a 400, not a WSGI stack trace
                        return 400, {"error": f"bad request: {e}"}
            return 404, {"error": f"no route for {method} {path}"}
        finally:
            if serving is not None:
                self._ident.store_override = None

    def _journaled(self, headers: Dict[str, str]) -> None:
        """Answer a replica's forwarded write once it is in the WAL, for
        the replica's read-your-writes poll to find it there: on a
        durable store a write made during a tick rides in the tick's
        group frame, and one made while frames wait on the flusher is
        queued behind them (``DurableStore.drain``). Other writes are
        answered at once, as in the JAX package: a tick's frame can take
        seconds."""
        drain = getattr(self._store, "drain", None)
        if drain is not None and headers.get("x-evg-forwarded"):
            drain()

    # -- follower reads -------------------------------------------------- #

    def _replica_usable(self, degraded: bool = False):
        """The attached replica, when it may serve now: follower reads
        on, not fence-blocked (a failover's pre-recovery state never
        reaches readers), and within the staleness bound — the normal
        one, or with ``degraded`` the looser RED one."""
        replica = self.read_replica
        if replica is None:
            return None
        cfg = self._read_path_config()
        if not cfg.follower_reads_enabled:
            return None
        if not replica.serve_ready():
            return None
        bound = (
            cfg.degraded_staleness_bound_ms
            if degraded else cfg.staleness_bound_ms
        )
        if replica.staleness_ms() > bound:
            return None
        return replica

    def _replica_route_ok(self, method: str, path: str, body: dict) -> bool:
        """Routes a follower replica may serve: the collection-backed
        ``/rest/v2/`` GETs. The agent protocol and the mutating GETs stay
        on the primary; ``admin/*``, ``/metrics`` and ``stats/*`` read
        this process's own state (trace rings, provenance, the ladder)
        and answer about the primary, not about a tailer."""
        if method != "GET" or not path.startswith("/rest/v2/"):
            return False
        return not (
            _AGENT_PATHS.match(path)
            or _MUTATING_GETS.match(path)
            or path.startswith(("/rest/v2/admin/", "/rest/v2/stats/"))
        )

    def _serve_read(
        self,
        method: str,
        path: str,
        body: dict,
        headers: Dict[str, str],
        degraded: bool = False,
    ) -> Tuple[int, Any]:
        """The read-serving plane in front of the route table: pick the
        serving store (this API's, or the attached follower when it is
        usable), then answer from the fingerprint ETag cache —
        ``If-None-Match`` → 304 with no store read beyond the change
        token, a token-matched entry → the cached response without
        re-running the handler — before falling through to the
        handler."""
        from . import readcache
        from ..storage.replica import ReplicaStore

        cfg = self._read_path_config()
        # an API over a replica process's own store holds itself to the
        # same contract: fence-blocked → never serve (forward the read,
        # 503 when the primary is unreachable); too stale → prefer the
        # primary, and serve stale with a Warning only when it is down
        own = self._store
        if (
            isinstance(own, ReplicaStore)
            and self.read_replica is None
            and cfg.follower_reads_enabled
            and self._replica_route_ok(method, path, body)
        ):
            blocked = not own.serve_ready()
            too_stale = own.staleness_ms() > cfg.staleness_bound_ms
            if (blocked or too_stale) and own.primary_url:
                fwd = self._forward_to_primary(method, path, body, headers)
                if fwd[0] < 500 or blocked:
                    return fwd
            elif blocked:
                return 503, {
                    "error": "replica cannot serve: a failover is in "
                             "progress and the new holder's state has "
                             "not arrived",
                    "primary": own.primary_url,
                }
            if too_stale and not blocked:
                self._ident.response_headers = (
                    getattr(self._ident, "response_headers", []) or []
                ) + [
                    ("Warning",
                     '110 - "stale read: replica beyond its staleness '
                     'bound and the primary is unreachable"'),
                    ("X-Evg-Staleness-Ms", str(int(own.staleness_ms()))),
                ]
        serving = None
        # the ETag's store tag: validators minted by different stores
        # (the primary, its follower, a replica process) never match
        tag = (
            own.replica_id if isinstance(own, ReplicaStore)
            else self._etag_tag
        )
        if self._replica_route_ok(method, path, body) and not headers.get(
            "x-evg-forwarded"
        ):
            # a read a replica forwarded (stale or fence-blocked there) is
            # the writer's to answer, not its follower's
            serving = self._replica_usable(degraded=degraded)
            if serving is not None:
                tag = serving.replica_id
        if degraded and serving is None:
            # the follower went stale or fenced between the shed check
            # and here: the 429 the ladder wanted
            from ..utils import overload

            monitor = overload.monitor_for(self._store)
            retry = monitor.retry_after_s(monitor.level())
            self._ident.response_headers = [
                ("Retry-After", str(int(retry)))
            ]
            return 429, {
                "error": "service overloaded",
                "level": monitor.level_label(),
                "retry_after_s": retry,
            }
        extra_headers: List[Tuple[str, str]] = []
        if serving is not None:
            extra_headers.append(("X-Evg-Served-By", tag))
            extra_headers.append(
                ("X-Evg-Staleness-Ms", str(int(serving.staleness_ms())))
            )
            if degraded:
                READS_DEGRADED.inc()
                extra_headers.append(
                    ("Warning",
                     '110 - "stale read: bounded-stale replica serving '
                     'under overload"')
                )
        route = (
            readcache.route_for(path)
            if method == "GET" and cfg.cache_enabled else None
        )
        if route is None:
            status, payload = self._dispatch_route(method, path, body, serving)
            self._ident.response_headers = (
                getattr(self._ident, "response_headers", []) or []
            ) + extra_headers
            return status, payload
        name, match, colls = route
        if self._response_cache is None:
            self._response_cache = readcache.ResponseCache(
                max_entries=cfg.cache_max_entries
            )
        read_store = serving if serving is not None else self._store
        etag = readcache.etag_for(read_store, tag, path, colls, match)
        inm = headers.get("if-none-match", "")
        key = (
            path,
            tuple(sorted((k, str(v)) for k, v in body.items())),
            etag,
        )
        entry = self._response_cache.get(key)
        if entry is not None:
            # the validator only ever certifies a KNOWN-200 answer: a
            # 404'd resource must not 304 (the client would cache the
            # ghost as an unmodified live resource)
            readcache.API_CACHE_HITS.inc(endpoint=name)
            self._ident.response_headers = (
                getattr(self._ident, "response_headers", []) or []
            ) + extra_headers + [("ETag", etag)]
            if inm and inm == etag:
                # an unchanged fingerprint answers with no store reads,
                # no handler, no serialization
                return 304, {}
            status, payload, serialized = entry
            self._ident.serialized_payload = (payload, serialized)
            return status, payload
        status, payload = self._dispatch_route(method, path, body, serving)
        if status == 200:
            readcache.API_CACHE_MISSES.inc(endpoint=name)
            try:
                serialized = json.dumps(payload, default=str)
            except (TypeError, ValueError):
                serialized = None
            if serialized is not None:
                self._response_cache.put(key, (status, payload, serialized))
                self._ident.serialized_payload = (payload, serialized)
            extra_headers.append(("ETag", etag))
            if inm and inm == etag:
                # valid revalidation that had fallen out of the LRU: the
                # handler re-established the answer — skip the body
                self._ident.serialized_payload = None
                self._ident.response_headers = (
                    getattr(self._ident, "response_headers", []) or []
                ) + extra_headers
                return 304, {}
        self._ident.response_headers = (
            getattr(self._ident, "response_headers", []) or []
        ) + extra_headers
        return status, payload

    # -- replica write forwarding ---------------------------------------- #

    def _maybe_forward(
        self, method: str, path: str, body: dict,
        headers: Dict[str, str], raw: bytes = b"",
    ) -> Optional[Tuple[int, Any]]:
        """On a replica process, proxy a mutating request to the primary
        before any local handler runs (no partial local side effects),
        then poll the WAL so this replica serves its own write back at
        once (read-your-writes). Every method but GET mutates, except
        ``_READONLY_POSTS``; the GETs of ``_MUTATING_GETS`` mutate.
        (The JAX package also serves a ``/graphql`` query locally; the
        port has no GraphQL surface.)"""
        from ..storage.replica import ReplicaStore

        if not self.forward_writes:
            return None
        if method == "GET" and not _MUTATING_GETS.match(path):
            return None
        if method == "POST" and _READONLY_POSTS.match(path):
            return None
        store = self.store
        if not isinstance(store, ReplicaStore) or not store.primary_url:
            return None
        if headers.get("x-evg-forwarded"):
            # loop guard: a forwarded request never hops again (a replica
            # pointed at another replica answers 503 instead of
            # ping-ponging)
            return None
        return self._forward_to_primary(method, path, body, headers, raw)

    def _forward_to_primary(
        self, method: str, path: str, body: dict,
        headers: Dict[str, str], raw: bytes = b"",
    ) -> Tuple[int, Any]:
        """One hop to the primary: the client's credentials, agent and
        GitHub headers relayed, ``X-Evg-Forwarded`` set, the raw bytes
        when given (a webhook's HMAC covers the exact body) or the JSON
        body, and the protocol headers of the answer (``Retry-After``,
        ``Location``, ``Set-Cookie``, the rate-limit pair) kept. The
        primary sees this replica's address, so its pre-auth rate-limit
        bucket holds every user funneled through one replica (spurious
        429s at worst, never a bypass); the post-auth bucket keys on the
        identity, which forwards intact."""
        import http.client
        import urllib.error
        import urllib.request

        primary = self.store.primary_url.rstrip("/")
        fwd_headers = {"Content-Type": JSON, "X-Evg-Forwarded": "1"}
        for h in ("api-user", "api-key", "authorization", "cookie",
                  # agent protocol credentials
                  "host-id", "host-secret",
                  # webhook HMAC and delivery metadata
                  "x-hub-signature-256", "x-github-event",
                  "x-github-delivery"):
            if headers.get(h):
                fwd_headers[h] = headers[h]
        req = urllib.request.Request(
            primary + path,
            data=raw or json.dumps(body, default=str).encode(),
            method=method,
            headers=fwd_headers,
        )
        # the hop's timeout stretches past a long-poll ?wait=: a
        # forwarded next_task parks on the primary's dispatch hub up to
        # its clamp, and a fixed 15 s would turn an idle park into a
        # false "primary unreachable" 503
        timeout_s = 15.0
        try:
            wait = float(body.get("wait", 0) or 0)
        except (TypeError, ValueError):
            wait = 0.0
        if wait > 0:
            timeout_s += min(wait, 300.0)
        try:
            # one shot by design: retrying a forwarded write could apply
            # it twice on the primary; unreachable degrades to a 503
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                status, resp_raw = resp.status, resp.read()
                resp_headers = resp.headers
        except urllib.error.HTTPError as e:
            status, resp_raw = e.code, e.read()
            resp_headers = e.headers
        except (OSError, ValueError, http.client.HTTPException):
            return 503, {
                "error": "this server is a read-only replica and the "
                         "primary is unreachable",
                "primary": self.store.primary_url,
            }
        try:
            payload = json.loads(resp_raw or b"{}")
        except json.JSONDecodeError:
            payload = {"error": "primary returned a non-JSON response"}
        if status < 500:
            try:
                # the primary journaled the write before it answered: one
                # poll makes it visible to this replica's reads
                self.store.poll()
            except OSError:
                pass  # a race with the rotation; the tail catches up
        self._ident.response_headers = [
            (h, v) for h, v in (resp_headers or {}).items()
            if h.lower() in (
                "retry-after", "location", "set-cookie",
                "x-ratelimit-limit", "x-ratelimit-remaining",
            )
        ]
        return status, payload

    def wsgi_app(self, environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")
        body = {}
        raw = b""
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        if length:
            raw = environ["wsgi.input"].read(length) or b"{}"
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                start_response("400 Bad Request", [("Content-Type", JSON)])
                return [json.dumps({"error": "invalid JSON body"}).encode()]
        headers = {
            k[5:].replace("_", "-").lower(): v
            for k, v in environ.items()
            if k.startswith("HTTP_")
        }
        # server-derived peer address for rate-limit keying; deliberately
        # set after the dict build so a spoofed X-Peer-Addr header loses
        headers["x-peer-addr"] = environ.get("REMOTE_ADDR", "")
        if path == "/hooks/github":
            # the HMAC signature covers the exact body: the hook reads the
            # raw bytes, outside the route table (no shed, no user auth);
            # a replica forwards those bytes to the primary
            fwd = self._maybe_forward(method, path, body, headers, raw)
            if fwd is not None:
                status, payload = fwd
            else:
                try:
                    status, payload = self._github_hook(raw, headers, body)
                except ReplicaReadOnly as e:
                    status, payload = 503, {
                        "error": "this server is a read-only replica",
                        "primary": e.primary_url,
                    }
                self._journaled(headers)
        else:
            # query-string params merge into the handler body (JSON body
            # keys win) so GET endpoints take ?wait= / ?limit= the way the
            # reference's gimlet routes do. GET only; repeated keys
            # collapse to the last value
            qs = environ.get("QUERY_STRING", "")
            if qs and method == "GET" and isinstance(body, dict):
                from urllib.parse import parse_qs

                for k, vs in parse_qs(qs, keep_blank_values=True).items():
                    body.setdefault(k, vs[-1])
            t0 = _time.perf_counter()
            try:
                status, payload = self.handle(
                    method, path.split("?")[0], body, headers
                )
            except Exception:
                # a handler bug becomes a clean JSON 500 — and an access
                # record, since 5xx is exactly what sampling must catch
                import traceback as _tb

                from ..utils.log import get_logger

                get_logger("api").error(
                    "unhandled handler exception",
                    method=method,
                    path=path.split("?")[0],
                    error=_tb.format_exc().strip().splitlines()[-1],
                )
                status, payload = 500, {"error": "internal server error"}
            self._sample_request_log(
                method, path, status, (_time.perf_counter() - t0) * 1e3,
                headers.get("x-peer-addr", ""),
            )
        extra = getattr(self._ident, "response_headers", None) or []
        self._ident.response_headers = []
        stash = getattr(self._ident, "serialized_payload", None)
        self._ident.serialized_payload = None
        if isinstance(payload, PlainTextResponse):
            start_response(
                f"{status} {_REASONS.get(status, 'OK')}",
                [("Content-Type", payload.content_type), *extra],
            )
            return [str(payload).encode()]
        start_response(
            f"{status} {_REASONS.get(status, 'OK')}",
            [("Content-Type", JSON), *extra],
        )
        if status == 304:
            return [b""]  # a 304 carries no body, only the validators
        if stash is not None and stash[0] is payload:
            # fingerprint-cache hit: the serialized answer rides along,
            # so an unchanged queue is not re-serialized per scrape
            return [stash[1].encode()]
        return [json.dumps(payload, default=str).encode()]

    def _sample_request_log(
        self, method: str, path: str, status: int, duration_ms: float,
        peer: str,
    ) -> None:
        """Sampled structured access log (reference
        service/sampled_request_logger.go); ratio from the logger_config
        section (TTL-cached), errors always logged when sampling is on."""
        import random

        now = _time.monotonic()
        cached = self._sample_ratio_cache
        if cached is None or now - cached[1] > 5.0:
            from ..settings import LoggerConfig

            cached = (
                LoggerConfig.get(self.store).request_sample_ratio, now
            )
            self._sample_ratio_cache = cached
        ratio = cached[0]
        if ratio <= 0.0:
            return
        if status < 500 and random.random() >= ratio:
            return
        from ..utils.log import get_logger

        get_logger("api").info(
            "request",
            method=method,
            path=path.split("?")[0],
            status=status,
            duration_ms=round(duration_ms, 2),
            peer=peer,
        )

    def serve(self, host: str = "127.0.0.1", port: int = 9090):
        """A threading HTTP server over ``wsgi_app`` (CLI ``service``), not
        yet serving: the caller runs ``serve_forever``; ``server_address``
        holds the bound port when ``port`` is 0."""
        from socketserver import ThreadingMixIn
        from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

        class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
            daemon_threads = True

        class QuietHandler(WSGIRequestHandler):
            def log_message(self, format, *args) -> None:
                pass  # the sampled access log (_sample_request_log) stands in

        return make_server(host, port, self.wsgi_app,
                           server_class=ThreadingWSGIServer, handler_class=QuietHandler)

    # ------------------------------------------------------------------ #
    # routes
    # ------------------------------------------------------------------ #

    def _register_routes(self) -> None:
        r = self.route
        # agent protocol (reference rest/route/host_agent.go, agent.go)
        r("GET", r"/rest/v2/hosts/(?P<host>[^/]+)/agent/next_task", self.next_task)
        r(
            "POST",
            r"/rest/v2/hosts/(?P<host>[^/]+)/agent/provisioning_done",
            self.provisioning_done,
        )
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)/agent/config", self.task_config)
        r(
            "GET",
            r"/rest/v2/hosts/(?P<host>[^/]+)/agent/task_config/(?P<task>[^/]+)",
            self.resolved_task_config,
        )
        r("POST", r"/rest/v2/tasks/(?P<task>[^/]+)/agent/start", self.start_task)
        r("POST", r"/rest/v2/tasks/(?P<task>[^/]+)/agent/heartbeat", self.heartbeat)
        r("POST", r"/rest/v2/tasks/(?P<task>[^/]+)/agent/end", self.end_task)
        r("POST", r"/rest/v2/tasks/(?P<task>[^/]+)/agent/logs", self.append_logs)

        # tasks
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)/executions", self.task_executions)
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)", self.get_task)
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)/logs", self.get_logs)
        r("PATCH", r"/rest/v2/tasks/(?P<task>[^/]+)", self.patch_task)
        r("POST", r"/rest/v2/tasks/(?P<task>[^/]+)/abort", self.abort_task)
        r("POST", r"/rest/v2/tasks/(?P<task>[^/]+)/restart", self.restart_task)

        # hosts and distros (reference rest/route/host.go, distro.go,
        # task_queue.go)
        r("GET", r"/rest/v2/hosts", self.list_hosts)
        # spawn hosts and volumes (reference rest/route/host_spawn.go)
        r("POST", r"/rest/v2/hosts", self.spawn_host)
        r("POST", r"/rest/v2/hosts/(?P<host>[^/]+)/start", self.spawn_start)
        r("POST", r"/rest/v2/hosts/(?P<host>[^/]+)/stop", self.spawn_stop)
        r("POST", r"/rest/v2/hosts/(?P<host>[^/]+)/terminate",
          self.spawn_terminate)
        r("POST", r"/rest/v2/hosts/(?P<host>[^/]+)/extend_expiration",
          self.spawn_extend)
        r("POST", r"/rest/v2/hosts/(?P<host>[^/]+)/sleep_schedule",
          self.spawn_sleep_schedule)
        r("POST", r"/rest/v2/volumes", self.create_volume)
        r("GET", r"/rest/v2/volumes", self.list_volumes)
        r("POST", r"/rest/v2/volumes/(?P<volume>[^/]+)/attach",
          self.attach_volume)
        r("POST", r"/rest/v2/volumes/(?P<volume>[^/]+)/detach",
          self.detach_volume)
        r("GET", r"/rest/v2/hosts/(?P<host>[^/]+)", self.get_host)
        r("GET", r"/rest/v2/distros", self.list_distros)
        r("GET", r"/rest/v2/distros/(?P<distro>[^/]+)/queue", self.get_queue)
        r("GET", r"/rest/v2/distros/(?P<distro>[^/]+)", self.get_distro)

        # versions, builds, projects, revisions
        r("GET", r"/rest/v2/versions", self.list_versions)
        r("GET", r"/rest/v2/versions/(?P<version>[^/]+)", self.get_version)
        r("GET", r"/rest/v2/versions/(?P<version>[^/]+)/tasks", self.version_tasks)
        r("POST", r"/rest/v2/versions/(?P<version>[^/]+)/restart", self.restart_version)
        r("POST", r"/rest/v2/versions/(?P<version>[^/]+)/abort", self.abort_version)
        r("GET", r"/rest/v2/builds/(?P<build>[^/]+)", self.get_build)
        r(
            "GET",
            r"/rest/v2/builds/(?P<build>[^/]+)/display_tasks",
            self.build_display_tasks,
        )
        r("GET", r"/rest/v2/projects", self.list_projects)
        r("GET", r"/rest/v2/projects/(?P<project>[^/]+)/last_green",
          self.last_green)
        r("PUT", r"/rest/v2/projects/(?P<project>[^/]+)", self.put_project)
        r("PUT", r"/rest/v2/distros/(?P<distro>[^/]+)", self.put_distro)
        r("POST", r"/rest/v2/projects/(?P<project>[^/]+)/revisions", self.push_revision)
        r("POST", r"/rest/v2/projects/(?P<project>[^/]+)/validate", self.validate)

        # patches
        r("POST", r"/rest/v2/patches", self.create_patch)
        r("GET", r"/rest/v2/patches", self.list_patches)
        r("GET", r"/rest/v2/patches/(?P<patch>[^/]+)", self.get_patch)
        r("POST", r"/rest/v2/patches/(?P<patch>[^/]+)/finalize", self.finalize)
        r("POST", r"/rest/v2/patches/(?P<patch>[^/]+)/cancel",
          self.cancel_patch)

        # a task's place in its queue, its results and its artifacts
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)/queue_position",
          self.queue_position)
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)/tests", self.task_tests)
        r("POST", r"/rest/v2/tasks/(?P<task>[^/]+)/select_tests",
          self.select_tests)
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)/artifacts", self.task_artifacts)
        r("GET", r"/rest/v2/tasks/(?P<task>[^/]+)/annotations", self.get_annotations)
        r("PUT", r"/rest/v2/tasks/(?P<task>[^/]+)/annotation", self.put_annotation)
        r("POST", r"/rest/v2/artifacts/sign", self.sign_artifact)

        # the admin settings over every config section, and the
        # operator's surface: the ladder, the Prometheus exposition, the
        # LB probes and the trace/provenance/fleet views, all shed-exempt
        r("GET", r"/rest/v2/admin/settings", self.get_admin)
        r("POST", r"/rest/v2/admin/settings", self.set_admin)
        r("GET", r"/rest/v2/admin/overload", self.get_overload)
        r("GET", r"/metrics", self.get_metrics)
        r("GET", r"/healthz", self.healthz)
        r("GET", r"/healthz/ready", self.healthz_ready)
        r("GET", r"/rest/v2/admin/traces", self.list_traces)
        r("GET", r"/rest/v2/admin/trace/(?P<trace>[^/]+)", self.get_trace)
        r(
            "GET",
            r"/rest/v2/admin/provenance/(?P<distro>[^/]+)",
            self.get_provenance,
        )
        r("GET", r"/rest/v2/admin/capacity", self.get_capacity_fleet)
        r(
            "GET",
            r"/rest/v2/admin/capacity/(?P<distro>[^/]+)",
            self.get_capacity,
        )
        r("GET", r"/rest/v2/admin/fleet", self.get_fleet)
        r("GET", r"/rest/v2/status", self.status)

        # login surface (api/auth.py)
        r("POST", r"/login", self.login)
        r("GET", r"/login/redirect", self.login_redirect)
        r("GET", r"/login/callback", self.login_callback)
        r("POST", r"/logout", self.logout)
        # the event log's readers
        r("GET", r"/rest/v2/events", self.list_events)
        r(
            "GET",
            r"/rest/v2/resources/(?P<resource>[^/]+)/events",
            self.resource_events,
        )
        r(
            "GET",
            r"/rest/v2/projects/(?P<project>[^/]+)/waterfall",
            self.waterfall,
        )
        # the user's SSH keys
        r("GET", r"/rest/v2/keys", self.list_keys)
        r("POST", r"/rest/v2/keys", self.add_key)
        r("DELETE", r"/rest/v2/keys/(?P<name>[^/]+)", self.delete_key)
        # notification subscriptions (events/triggers.py)
        r("POST", r"/rest/v2/subscriptions", self.create_subscription)
        r("GET", r"/rest/v2/subscriptions", self.list_subscriptions)
        r("DELETE", r"/rest/v2/subscriptions/(?P<sub>[^/]+)",
          self.delete_subscription)
        r("DELETE", r"/rest/v2/distros/(?P<distro>[^/]+)", self.delete_distro)
        r("DELETE", r"/rest/v2/volumes/(?P<volume>[^/]+)", self.delete_volume)
        # log ring and stats samplers
        r("GET", r"/rest/v2/admin/log_lines", self.list_log_lines)
        r("GET", r"/rest/v2/stats/spans", self.list_spans)
        r("GET", r"/rest/v2/stats/hosts", self.host_stats)
        r("GET", r"/rest/v2/stats/system", self.system_stats)
        # task reliability (reference rest/route/reliability.go)
        r(
            "GET",
            r"/rest/v2/projects/(?P<project>[^/]+)/task_reliability",
            self.task_reliability,
        )
        # permissions (reference rest/route/permissions.go)
        r("GET", r"/rest/v2/permissions", self.permissions_catalog)
        r("GET", r"/rest/v2/permissions/users", self.all_users_permissions)
        r("GET", r"/rest/v2/users/(?P<user>[^/]+)/permissions",
          self.get_user_permissions)
        r("POST", r"/rest/v2/users/(?P<user>[^/]+)/permissions",
          self.post_user_permissions)
        r("DELETE", r"/rest/v2/users/(?P<user>[^/]+)/permissions",
          self.delete_user_permissions)
        # project copy and the settings audit (reference project_copy.go,
        # project_events.go)
        r("POST", r"/rest/v2/projects/(?P<project>[^/]+)/copy",
          self.copy_project)
        r("POST", r"/rest/v2/projects/(?P<project>[^/]+)/copy/variables",
          self.copy_project_vars)
        r("GET", r"/rest/v2/projects/(?P<project>[^/]+)/events",
          self.project_events)
        # direct notifications (reference rest/route/notification.go)
        r("POST", r"/rest/v2/notifications/slack", self.notify_slack)
        r("POST", r"/rest/v2/notifications/email", self.notify_email)
        # SNS instance-state intake (reference rest/route/sns.go)
        r("POST", r"/hooks/aws/(?P<token>[^/]+)", self.sns_hook)
        r("POST", r"/hooks/aws", self.sns_hook_no_token)

    # -- login surface --------------------------------------------------- #

    def login(self, method, match, body):
        """Password login (naive manager). Redirect-based managers point
        the client at /login/redirect instead."""
        from .auth import AuthError

        mgr = self.user_manager
        if mgr.is_redirect:
            return 400, {
                "error": "this deployment logs in via an identity provider",
                "redirect": "/login/redirect",
            }
        try:
            token = mgr.create_user_token(
                self.store, body.get("username", ""), body.get("password", "")
            )
        except AuthError as e:
            return 400, {"error": str(e)}
        if not token:
            return 401, {"error": "invalid username or password"}
        return 200, {"token": token}

    def login_redirect(self, method, match, body):
        from .auth import AuthError

        callback = body.get(
            "callback", f"{self._own_url()}/login/callback"
        )
        try:
            url = self.user_manager.login_redirect(self.store, callback)
        except AuthError as e:
            return 400, {"error": str(e)}
        return 200, {"redirect": url}

    def login_callback(self, method, match, body):
        from .auth import AuthError

        try:
            token = self.user_manager.login_callback(self.store, body)
        except AuthError as e:
            return 401, {"error": str(e)}
        return 200, {"token": token}

    def logout(self, method, match, body):
        headers = getattr(self._ident, "headers", {}) or {}
        token = body.get("token", "") or _session_token(headers)
        ok = self.user_manager.clear_user(self.store, token)
        return 200, {"ok": ok}

    def _own_url(self) -> str:
        from ..settings import ApiConfig

        return ApiConfig.get(self.store).url or "http://localhost:9090"


    # -- agent protocol ------------------------------------------------- #

    def next_task(self, method, match, body):
        flags = ServiceFlags.get(self.store)
        if flags.task_dispatch_disabled:
            return 200, {"task_id": "", "should_exit": False}
        h = host_mod.get(self.store, match["host"])
        if h is None:
            raise ApiError(404, f"host {match['host']!r} not found")
        # reference checkHostHealth (rest/route/host_agent.go): an agent
        # on any non-running host exits instead of polling
        if h.status != HostStatus.RUNNING.value:
            return 200, {"task_id": "", "should_exit": True}
        if h.needs_reprovision:
            # the host must change bootstrap method: the agent exits so
            # the reprovision job can convert the freed host (reference
            # host_agent.go:112-160 reprovisioning health check)
            return 200, {"task_id": "", "should_exit": True}
        t = assign_next_available_task(self.store, self.svc, h)
        if t is None:
            # server-side long-poll (dispatch/longpoll.py): ?wait= parks
            # this request on the sharded hub until the host's queue
            # plausibly changed, clamped to the configured bound
            try:
                wait = float(body.get("wait", 0) or 0)
            except (TypeError, ValueError):
                wait = 0.0
            if wait > 0:
                wait = min(wait, self._read_path_config().longpoll_max_wait_s)
            if wait > 0:
                from ..agent.comm import LocalCommunicator

                t = LocalCommunicator(self.store, self.svc).next_task(
                    h.id, wait_s=wait
                )
        # single-task distros run exactly one task per host, then the agent
        # exits and the host is recycled (reference units/host_allocator.go
        # :174-181 + agent single-task-distro exit)
        d = distro_mod.get(self.store, h.distro_id)
        single = bool(d and d.single_task_distro)
        if t is None:
            return 200, {
                "task_id": "",
                "should_exit": single and h.task_count > 0,
            }
        return 200, {
            "task_id": t.id,
            "task_execution": t.execution,
            "version": t.version,
            "build_id": t.build_id,
            "should_exit": False,
        }

    def provisioning_done(self, method, match, body):
        """Phone-home for self-provisioning (user-data) hosts (reference
        rest/route/host_provisioning.go)."""
        from ..cloud.provisioning import mark_provisioning_done

        ok = mark_provisioning_done(self.store, match["host"])
        return 200, {"ok": ok}

    def task_config(self, method, match, body):
        t = task_mod.get(self.store, match["task"])
        if t is None:
            raise ApiError(404, "task not found")
        doc = self.store.collection("parser_projects").get(t.version) or {}
        return 200, {"task": t.to_doc(), "project": doc}

    def resolved_task_config(self, method, match, body):
        """Server-side block resolution (incl. host task-group state:
        setup_group/teardown_group) so the HTTP agent gets final blocks."""
        t = task_mod.get(self.store, match["task"])
        if t is None:
            raise ApiError(404, "task not found")
        from ..agent.comm import LocalCommunicator

        cfg = LocalCommunicator(self.store, self.svc).get_task_config(
            t, match["host"]
        )
        return 200, {
            "task": t.to_doc(),
            "commands": cfg.commands,
            "pre": cfg.pre,
            "post": cfg.post,
            "timeout_handler": cfg.timeout_handler,
            "expansions": cfg.expansions,
            "exec_timeout_s": cfg.exec_timeout_s,
            "idle_timeout_s": cfg.idle_timeout_s,
            "pre_error_fails_task": cfg.pre_error_fails_task,
            "post_error_fails_task": cfg.post_error_fails_task,
            "distro_arch": cfg.distro_arch,
        }

    def start_task(self, method, match, body):
        ok = mark_task_started(self.store, match["task"])
        return 200, {"ok": ok}

    def heartbeat(self, method, match, body):
        now = _time.time()
        task_mod.coll(self.store).update(match["task"], {"last_heartbeat": now})
        t = task_mod.get(self.store, match["task"])
        if t is None:
            raise ApiError(404, "task not found")
        return 200, {"abort": t.aborted}

    def end_task(self, method, match, body):
        from ..models.lifecycle import finish_agent_task

        t, should_exit = finish_agent_task(
            self.store,
            match["task"],
            body.get("status", TaskStatus.FAILED.value),
            details_type=body.get("details_type", ""),
            details_desc=body.get("details_desc", ""),
            timed_out=body.get("timed_out", False),
        )
        if t is None:
            raise ApiError(409, "task is not in a running state")
        gen = body.get("generate_tasks")
        if gen:
            self.store.collection("generate_requests").upsert(
                {"_id": t.id, "task_id": t.id, "payloads": gen,
                 "processed": False}
            )
        # the test results and artifact records the agent attached, kept
        # as an agent in process keeps them (a departure: see the module)
        output = {
            k: body[k] for k in ("test_results", "artifact_files")
            if body.get(k)
        }
        if output:
            from ..agent.comm import LocalCommunicator

            LocalCommunicator(self.store, self.svc)._persist_task_output(
                t.id, output
            )
        return 200, {"status": t.status, "should_exit": should_exit}

    def append_logs(self, method, match, body):
        coll = self.store.collection("task_logs")
        tid = match["task"]
        lines = [str(x) for x in body.get("lines", [])]

        def extend(doc: dict) -> None:
            doc["lines"] = doc["lines"] + lines

        # journaled append (see agent/comm.py send_log): in-place edits
        # bypass the WAL and are lost on restart
        if not coll.mutate(tid, extend):
            coll.upsert({"_id": tid, "lines": lines})
        return 200, {"ok": True}

    # -- tasks ----------------------------------------------------------- #

    def get_task(self, method, match, body):
        t = task_mod.get(self.store, match["task"])
        if t is None:
            raise ApiError(404, "task not found")
        return 200, t.to_doc()

    def task_executions(self, method, match, body):
        """Archived past executions plus the live one (reference
        Task.Execution archive semantics)."""
        t = task_mod.get(self.store, match["task"])
        if t is None:
            raise ApiError(404, "task not found")
        archive = task_jobs.get_task_execution_archive(self.store, match["task"])
        current = {
            "execution": t.execution,
            "status": t.status,
            "start_time": t.start_time,
            "finish_time": t.finish_time,
            "host_id": t.host_id,
            "current": True,
        }
        return 200, archive + [current]

    def get_logs(self, method, match, body):
        doc = self.store.collection("task_logs").get(match["task"])
        return 200, {"lines": doc["lines"] if doc else []}

    def patch_task(self, method, match, body):
        update = {}
        acted = False
        if "priority" in body:
            update["priority"] = int(body["priority"])
        if "activated" in body:
            if bool(body["activated"]):
                from ..models.lifecycle import activate_task_with_dependencies

                activate_task_with_dependencies(
                    self.store, match["task"], body.get("user", "api")
                )
                acted = True
            else:
                update["activated"] = False
        if not update and not acted:
            raise ApiError(400, "nothing to update")
        if update and not task_mod.coll(self.store).update(
            match["task"], update
        ):
            raise ApiError(404, "task not found")
        t = task_mod.get(self.store, match["task"])
        if t is None:
            raise ApiError(404, "task not found")
        return 200, t.to_doc()

    def abort_task(self, method, match, body):
        ok = task_jobs.abort_task(self.store, match["task"], body.get("user", "api"))
        if not ok:
            raise ApiError(404, "task not found")
        return 200, {"ok": True}

    def restart_task(self, method, match, body):
        """Restart a finished task; an in-progress task is flagged
        reset_when_finished instead (reference SetResetWhenFinished), so
        it — or its whole single-host task group — restarts on finish."""
        from ..globals import TASK_IN_PROGRESS_STATUSES

        t = task_mod.get(self.store, match["task"])
        if t is not None and t.status in TASK_IN_PROGRESS_STATUSES:
            task_mod.coll(self.store).update(
                t.id, {"reset_when_finished": True}
            )
            return 200, {"reset_when_finished": True}
        ok = task_jobs.restart_task(self.store, match["task"], body.get("user", "api"))
        if not ok:
            raise ApiError(409, "task is not restartable")
        return 200, task_mod.get(self.store, match["task"]).to_doc()

    # -- distros, projects, revisions ------------------------------------ #

    def list_distros(self, method, match, body):
        return 200, [d.to_doc() for d in distro_mod.find_all(self.store)]

    def get_distro(self, method, match, body):
        """Single distro by id (reference rest/route/distro.go GET)."""
        d = distro_mod.get(self.store, match["distro"])
        if d is None:
            raise ApiError(404, f"distro {match['distro']!r} not found")
        return 200, d.to_doc()

    def list_projects(self, method, match, body):
        return 200, self.store.collection(
            repotracker_mod.PROJECT_REFS_COLLECTION
        ).find()

    def put_project(self, method, match, body):
        """Create/update a project ref (reference rest/route project
        settings routes)."""
        import dataclasses as _dc

        ref = repotracker_mod.get_project_ref(
            self.store, match["project"]
        ) or repotracker_mod.ProjectRef(id=match["project"])
        known = {f.name for f in _dc.fields(ref)} - {"id"}
        for k, v in body.items():
            if k not in known:
                raise ApiError(400, f"unknown project field {k!r}")
            setattr(ref, k, v)
        repotracker_mod.upsert_project_ref(self.store, ref)
        return 200, ref.to_doc()

    def put_distro(self, method, match, body):
        """Create/update a distro (reference rest/route/distro.go)."""
        import dataclasses as _dc

        from ..models.distro import (
            DispatcherSettings,
            FinderSettings,
            HostAllocatorSettings,
            PlannerSettings,
        )

        d = distro_mod.get(self.store, match["distro"]) or distro_mod.Distro(
            id=match["distro"]
        )
        subsections = {
            "planner_settings": PlannerSettings,
            "host_allocator_settings": HostAllocatorSettings,
            "dispatcher_settings": DispatcherSettings,
            "finder_settings": FinderSettings,
        }
        known = {f.name for f in _dc.fields(d)} - {"id"}
        for k, v in body.items():
            if k not in known:
                raise ApiError(400, f"unknown distro field {k!r}")
            if k in subsections and not isinstance(v, dict):
                raise ApiError(400, f"{k} must be an object")
            if k in subsections:
                current = getattr(d, k)
                sub_known = {f.name for f in _dc.fields(current)}
                for sk, sv in v.items():
                    if sk not in sub_known:
                        raise ApiError(
                            400, f"unknown field {sk!r} in {k!r}"
                        )
                    setattr(current, sk, sv)
            else:
                setattr(d, k, v)
        # version-knob validation (reference globals.go:1104-1120, enforced
        # by distro validation before save)
        from ..globals import (
            DispatcherVersion,
            FinderVersion,
            HostAllocatorVersion,
            PlannerVersion,
        )

        for section, valid in (
            ("planner_settings", {v.value for v in PlannerVersion}),
            ("dispatcher_settings", {v.value for v in DispatcherVersion}),
            ("finder_settings", {v.value for v in FinderVersion}),
            ("host_allocator_settings",
             {v.value for v in HostAllocatorVersion}),
        ):
            got = getattr(d, section).version
            if got not in valid:
                raise ApiError(
                    400,
                    f"invalid {section}.version {got!r}; "
                    f"valid: {sorted(valid)}",
                )
        distro_mod.upsert(self.store, d)
        return 200, d.to_doc()

    def push_revision(self, method, match, body):
        created = repotracker_mod.store_revisions(
            self.store,
            match["project"],
            [
                repotracker_mod.Revision(
                    revision=body.get("revision", ""),
                    author=body.get("author", ""),
                    message=body.get("message", ""),
                    config_yaml=body.get("config_yaml", ""),
                )
            ],
        )
        if not created:
            raise ApiError(400, "no version created (project disabled or bad config)")
        return 201, {"version_id": created[0].version.id,
                     "n_tasks": len(created[0].tasks)}

    def validate(self, method, match, body):
        import dataclasses as _dc

        issues = validate_project(
            self.store, body.get("config_yaml", ""), match["project"]
        )
        return 200, {"issues": [_dc.asdict(i) for i in issues]}

    # -- patches ---------------------------------------------------------- #

    def create_patch(self, method, match, body):
        p = patch_mod.Patch(
            id=body.get("id") or f"patch-{int(_time.time() * 1e6)}",
            project=body.get("project", ""),
            author=body.get("author", ""),
            description=body.get("description", ""),
            githash=body.get("githash", ""),
            diff=body.get("diff", ""),
            variants=body.get("variants", []),
            tasks=body.get("tasks", []),
            config_yaml=body.get("config_yaml", ""),
            create_time=_time.time(),
        )
        patch_mod.insert_patch(self.store, p)
        if body.get("finalize"):
            created = patch_mod.finalize_patch(self.store, p.id)
            if created is None:
                raise ApiError(400, "patch could not be finalized")
        return 201, patch_mod.get_patch(self.store, p.id).to_doc()

    def get_patch(self, method, match, body):
        p = patch_mod.get_patch(self.store, match["patch"])
        if p is None:
            raise ApiError(404, "patch not found")
        return 200, p.to_doc()

    def finalize(self, method, match, body):
        created = patch_mod.finalize_patch(self.store, match["patch"])
        if created is None:
            raise ApiError(409, "patch cannot be finalized")
        return 200, {"version_id": created.version.id,
                     "n_tasks": len(created.tasks)}

    def list_patches(self, method, match, body):
        """Recent patches, newest first, summary shape only: full
        documents carry the diff and the config (reference patch_list.go
        projects the same summary)."""
        project = body.get("project", "")
        docs = self.store.collection("patches").find(
            (lambda d: d["project"] == project) if project else None
        )
        docs.sort(key=lambda d: d.get("create_time", 0.0), reverse=True)
        limit = max(1, min(int(body.get("limit", 50)), 500))
        return 200, [
            {
                "_id": d["_id"],
                "project": d.get("project", ""),
                "author": d.get("author", ""),
                "description": d.get("description", ""),
                "status": d.get("status", ""),
                "version": d.get("version", ""),
                "create_time": d.get("create_time", 0.0),
                "activated": d.get("activated", False),
            }
            for d in docs[:limit]
        ]

    def cancel_patch(self, method, match, body):
        ok = patch_mod.cancel_patch(self.store, match["patch"])
        if not ok:
            raise ApiError(404, "patch not found")
        return 200, {"ok": True}

    def select_tests(self, method, match, body):
        """Test-selection recommendation (models/testselection.py;
        reference test_selection.get)."""
        from ..models.testselection import select_tests

        tests = body.get("tests") or []
        if not isinstance(tests, list):
            raise ApiError(400, "tests must be a list")
        return 200, {
            "tests": select_tests(
                self.store, match["task"], [str(x) for x in tests],
                strategies=str(body.get("strategies", "")),
            )
        }

    # -- read routes ------------------------------------------------------ #

    # -- spawn hosts and volumes (reference rest/route/host_spawn.go) -- #

    @staticmethod
    def _spawn_call(fn, *args, **kw):
        from ..cloud.spawnhost import SpawnHostError
        from ..cloud.volumes import VolumeError

        try:
            return fn(*args, **kw)
        except (SpawnHostError, VolumeError) as e:
            raise ApiError(400, str(e))

    def spawn_host(self, method, match, body):
        from ..cloud import spawnhost

        user = self._claimed_user(body)
        distro = body.get("distro", "")
        if not user or not distro:
            raise ApiError(400, "user and distro required")
        h = self._spawn_call(
            spawnhost.create_spawn_host,
            self.store, user, distro,
            no_expiration=bool(body.get("no_expiration", False)),
        )
        return 200, h.to_api_doc()

    def _spawn_host_owner(self, host_id: str):
        """Fetch + validate + ownership-gate a spawn host; returns it."""
        h = host_mod.get(self.store, host_id)
        if h is None or not h.user_host:
            raise ApiError(400, "not a spawn host")
        self._require_owner(h.started_by)
        return h

    def _claimed_user(self, body: dict) -> str:
        """The acting user for resource creation: the authenticated
        identity when auth is on (a body 'user' naming someone else is
        rejected — creation cannot be attributed to another user); the
        body field in dev mode."""
        ident = getattr(self._ident, "user", "")
        claimed = body.get("user", "")
        if ident:
            if claimed and claimed != ident and not getattr(
                self._ident, "superuser", False
            ):
                raise ApiError(403, f"cannot act as {claimed!r}")
            return claimed or ident
        return claimed

    def spawn_start(self, method, match, body):
        from ..cloud import spawnhost

        self._spawn_host_owner(match["host"])
        self._spawn_call(spawnhost.start_spawn_host, self.store, match["host"])
        return 200, {"ok": True}

    def spawn_stop(self, method, match, body):
        from ..cloud import spawnhost

        self._spawn_host_owner(match["host"])
        self._spawn_call(spawnhost.stop_spawn_host, self.store, match["host"])
        return 200, {"ok": True}

    def spawn_terminate(self, method, match, body):
        from ..cloud import spawnhost

        owner = self._spawn_host_owner(match["host"]).started_by
        self._spawn_call(
            spawnhost.terminate_spawn_host, self.store, match["host"],
            by=body.get("user") or owner,
        )
        return 200, {"ok": True}

    def spawn_extend(self, method, match, body):
        from ..cloud import spawnhost

        self._spawn_host_owner(match["host"])
        hours = float(body.get("hours", 0) or 0)
        if hours <= 0:
            raise ApiError(400, "hours must be positive")
        new_exp = self._spawn_call(
            spawnhost.extend_expiration, self.store, match["host"], hours
        )
        return 200, {"expiration_time": new_exp}

    def spawn_sleep_schedule(self, method, match, body):
        from ..cloud.volumes import SleepSchedule, set_sleep_schedule

        h = self._spawn_host_owner(match["host"])
        if not h.no_expiration:
            # enforcement only runs for unexpirable hosts
            # (cloud/volumes.py enforce_sleep_schedules) — storing a
            # schedule here would be silently dead configuration
            raise ApiError(
                400, "sleep schedules apply to no-expiration hosts only"
            )
        stop = int(body.get("stop_hour_utc", 22))
        start = int(body.get("start_hour_utc", 8))
        if not (0 <= stop <= 23 and 0 <= start <= 23):
            raise ApiError(400, "hours must be in 0..23")
        set_sleep_schedule(
            self.store,
            SleepSchedule(
                host_id=match["host"],
                stop_hour_utc=stop,
                start_hour_utc=start,
                enabled=bool(body.get("enabled", True)),
            ),
        )
        return 200, {"ok": True}

    def create_volume(self, method, match, body):
        from ..cloud import volumes

        user = self._claimed_user(body)
        size = int(body.get("size_gb", 0) or 0)
        if not user or size <= 0:
            raise ApiError(400, "user and positive size_gb required")
        v = self._spawn_call(
            volumes.create_volume, self.store, user, size,
            zone=body.get("zone", ""),
        )
        return 200, v.to_doc()

    def list_volumes(self, method, match, body):
        from ..cloud import volumes

        # scope to the caller: an authenticated non-superuser only sees
        # their own volumes regardless of the requested filter
        ident = getattr(self._ident, "user", "")
        superuser = getattr(self._ident, "superuser", False)
        user = body.get("user", "")
        if ident and not superuser:
            user = ident
        if user:
            return 200, [
                v.to_doc() for v in volumes.volumes_for_user(self.store, user)
            ]
        return 200, self.store.collection("volumes").find()

    def _volume_owner(self, volume_id: str) -> str:
        from ..cloud import volumes

        v = volumes.get_volume(self.store, volume_id)
        if v is None:
            raise ApiError(404, "volume not found")
        self._require_owner(v.created_by)
        return v.created_by

    def attach_volume(self, method, match, body):
        from ..cloud import volumes

        self._volume_owner(match["volume"])
        host = body.get("host", "")
        if not host:
            raise ApiError(400, "host required")
        # the target host must be the caller's too — attaching a foreign
        # volume mutates someone else's machine (reference host_spawn.go
        # checks both sides)
        self._spawn_host_owner(host)
        self._spawn_call(
            volumes.attach_volume, self.store, match["volume"], host
        )
        return 200, {"ok": True}

    def detach_volume(self, method, match, body):
        from ..cloud import volumes

        self._volume_owner(match["volume"])
        self._spawn_call(volumes.detach_volume, self.store, match["volume"])
        return 200, {"ok": True}

    def delete_volume(self, method, match, body):
        """DELETE an unattached volume (reference volume delete)."""
        from ..cloud import volumes

        v = volumes.get_volume(self.store, match["volume"])
        if v is None:
            raise ApiError(404, "volume not found")
        self._require_owner(v.created_by)
        if v.host_id:
            raise ApiError(409, f"volume attached to {v.host_id}; detach first")
        self.store.collection("volumes").remove(match["volume"])
        return 200, {"ok": True}

    def list_hosts(self, method, match, body):
        return 200, [h.to_api_doc() for h in host_mod.find(self.store)]

    def get_host(self, method, match, body):
        h = host_mod.get(self.store, match["host"])
        if h is None:
            raise ApiError(404, "host not found")
        return 200, h.to_api_doc()

    def get_queue(self, method, match, body):
        from ..models import task_queue as tq_mod

        q = tq_mod.load(self.store, match["distro"])
        if q is None:
            raise ApiError(404, "no queue for distro")
        return 200, q.to_doc()

    # -- versions / projects ---------------------------------------------- #

    def list_versions(self, method, match, body):
        docs = version_mod.coll(self.store).find()
        docs.sort(key=lambda d: d.get("create_time", 0.0), reverse=True)
        return 200, docs[:50]

    def get_version(self, method, match, body):
        v = version_mod.get(self.store, match["version"])
        if v is None:
            raise ApiError(404, "version not found")
        return 200, v.to_doc()

    def last_green(self, method, match, body):
        """Most recent mainline version whose builds for ALL requested
        variants succeeded (reference GetLastGreen, operations/http.go:352,
        backing the `last-green` CLI command)."""
        from ..globals import BuildStatus, is_mainline_requester
        from ..models import build as build_mod

        raw = body.get("variants", "")
        variants = [
            v for v in (raw if isinstance(raw, list) else raw.split(","))
            if v
        ]
        if not variants:
            raise ApiError(400, "variants required (?variants=a,b)")
        candidates = version_mod.coll(self.store).find(
            lambda d: d["project"] == match["project"]
            and is_mainline_requester(d.get("requester", ""))
        )
        candidates.sort(
            key=lambda d: d.get("revision_order_number", 0), reverse=True
        )
        # one scan of builds grouped by version (not a rescan per
        # candidate — the builds collection dwarfs one project's versions)
        green_by_version: dict = {}
        for b in build_mod.coll(self.store).find(
            lambda d: d["status"] == BuildStatus.SUCCEEDED.value
        ):
            green_by_version.setdefault(b["version"], set()).add(
                b["build_variant"]
            )
        want = set(variants)
        for doc in candidates:
            if want <= green_by_version.get(doc["_id"], set()):
                return 200, doc
        raise ApiError(
            404, f"no green version for variants {sorted(want)}"
        )

    def version_tasks(self, method, match, body):
        ts = task_mod.find(
            self.store, lambda d: d["version"] == match["version"]
        )
        return 200, [t.to_doc() for t in ts]

    def restart_version(self, method, match, body):
        """Restart every finished task of a version (reference
        units/tasks_restart.go / version restart route)."""
        by = body.get("user", "api")
        restarted = []
        for t in task_mod.find(
            self.store, lambda d: d["version"] == match["version"]
        ):
            if t.is_finished() and task_jobs.restart_task(
                self.store, t.id, by=by
            ):
                restarted.append(t.id)
        return 200, {"restarted": restarted}

    def abort_version(self, method, match, body):
        """Flag every in-flight task of a version for abort and deactivate
        the queued ones (reference version abort semantics)."""
        by = body.get("user", "api")
        aborted, deactivated = [], []
        for t in task_mod.find(
            self.store, lambda d: d["version"] == match["version"]
        ):
            if t.status in (TaskStatus.DISPATCHED.value, TaskStatus.STARTED.value):
                task_jobs.abort_task(self.store, t.id, by=by)
                aborted.append(t.id)
            elif t.status == TaskStatus.UNDISPATCHED.value and t.activated:
                task_mod.coll(self.store).update(t.id, {"activated": False})
                deactivated.append(t.id)
        return 200, {"aborted": aborted, "deactivated": deactivated}

    def get_build(self, method, match, body):
        b = build_mod.get(self.store, match["build"])
        if b is None:
            raise ApiError(404, "build not found")
        return 200, b.to_doc()

    def build_display_tasks(self, method, match, body):
        """Display-task groupings with rolled-up status (reference display
        tasks on builds; status = worst member status)."""
        out = []
        for doc in self.store.collection("display_tasks").find(
            lambda d: d["build_id"] == match["build"]
        ):
            members = task_mod.by_ids(self.store, doc["execution_tasks"])
            statuses = [m.status for m in members]
            if any(s == TaskStatus.FAILED.value for s in statuses):
                rollup = TaskStatus.FAILED.value
            elif statuses and all(
                s == TaskStatus.SUCCEEDED.value for s in statuses
            ):
                rollup = TaskStatus.SUCCEEDED.value
            elif any(
                s in (TaskStatus.STARTED.value, TaskStatus.DISPATCHED.value)
                for s in statuses
            ):
                rollup = TaskStatus.STARTED.value
            else:
                rollup = TaskStatus.UNDISPATCHED.value
            out.append(
                {
                    "name": doc["name"],
                    "build_id": doc["build_id"],
                    "execution_tasks": doc["execution_tasks"],
                    "status": rollup,
                }
            )
        return 200, out


    def queue_position(self, method, match, body):
        """Where a task sits in its distro's planned queue + a rough wait
        estimate (reference task queue position surface)."""
        t = task_mod.get(self.store, match["task"])
        if t is None:
            raise ApiError(404, "task not found")
        from ..models import task_queue as tq_mod

        doc = tq_mod.coll(self.store).get(t.distro_id)
        if doc is None:
            return 200, {"position": -1, "queue_length": 0}
        ids = tq_mod.doc_column(doc, "id")
        durs = tq_mod.doc_column(doc, "expected_duration_s")
        try:
            pos = ids.index(t.id)
        except ValueError:
            return 200, {"position": -1, "queue_length": len(ids)}
        hosts = max(
            1,
            host_mod.coll(self.store).count(
                lambda d: d["distro_id"] == t.distro_id
                and d["status"] == "running" and d["started_by"] == "mci"
            ),
        )
        est_wait = sum(durs[:pos]) / hosts
        return 200, {
            "position": pos,
            "queue_length": len(ids),
            "estimated_wait_s": round(est_wait, 1),
        }

    def task_tests(self, method, match, body):
        from ..models.artifact import get_test_results

        import dataclasses as _dc

        return 200, [
            _dc.asdict(r)
            for r in get_test_results(
                self.store, match["task"], int(body.get("execution", 0) or 0)
            )
        ]

    def task_artifacts(self, method, match, body):
        import dataclasses as _dc

        from ..models.artifact import get_artifacts

        return 200, [
            _dc.asdict(f)
            for f in get_artifacts(
                self.store, match["task"], int(body.get("execution", 0) or 0)
            )
        ]

    def get_annotations(self, method, match, body):
        import dataclasses as _dc

        from ..models.annotations import get_annotation

        ann = get_annotation(
            self.store, match["task"], int(body.get("execution", 0) or 0)
        )
        return 200, _dc.asdict(ann) if ann else {}

    def put_annotation(self, method, match, body):
        from ..models.annotations import (
            Annotation,
            IssueLink,
            get_annotation,
            upsert_annotation,
        )

        execution = int(body.get("execution", 0) or 0)
        ann = get_annotation(self.store, match["task"], execution) or Annotation(
            task_id=match["task"], execution=execution
        )
        if "note" in body:
            ann.note = str(body["note"])
        for issue in body.get("issues", []):
            ann.issues.append(
                IssueLink(
                    url=issue.get("url", ""),
                    issue_key=issue.get("issue_key", ""),
                    source="api",
                    added_by=body.get("user", "api"),
                )
            )
        for issue in body.get("suspected_issues", []):
            ann.suspected_issues.append(
                IssueLink(url=issue.get("url", ""), source="api",
                          added_by=body.get("user", "api"))
            )
        upsert_annotation(self.store, ann)
        import dataclasses as _dc

        return 200, _dc.asdict(ann)

    def sign_artifact(self, method, match, body):
        from ..models.artifact import sign_url

        link = body.get("link", "")
        if not link:
            raise ApiError(400, "link is required")
        expires_at = float(body.get("expires_at") or (_time.time() + 3600))
        return 200, {"url": sign_url(link, expires_at)}

    def status(self, method, match, body):
        return 200, {
            "tasks": task_mod.coll(self.store).count(),
            "hosts": host_mod.coll(self.store).count(),
            "distros": distro_mod.coll(self.store).count(),
            "versions": version_mod.coll(self.store).count(),
            "jobs_pending": self.store.collection("jobs").count(
                lambda d: d["status"] in ("pending", "running")
            ),
        }


    # -- the user's SSH keys ---------------------------------------------- #

    def _key_user(self, body: dict) -> str:
        """The authenticated user; without auth (dev mode) the caller
        names themselves."""
        user = getattr(self._ident, "user", "") or body.get("user", "")
        if not user:
            raise ApiError(401, "user identity required for key management")
        return user

    def list_keys(self, method, match, body):
        """reference rest/route keys routes + operations/keys.go list."""
        from ..models import user as user_mod

        u = user_mod.get_user(self.store, self._key_user(body))
        if u is None:
            raise ApiError(404, "user not found")
        return 200, u.public_keys

    def add_key(self, method, match, body):
        from ..models import user as user_mod

        name = body.get("name", "")
        key = body.get("key", "")
        if not name or not key:
            raise ApiError(400, "both name and key are required")
        try:
            ok = user_mod.add_public_key(
                self.store, self._key_user(body), name, key
            )
        except user_mod.PublicKeyError as e:
            raise ApiError(400, str(e))
        if not ok:
            raise ApiError(404, "user not found")
        return 200, {"ok": True}

    def delete_key(self, method, match, body):
        from ..models import user as user_mod

        if not user_mod.delete_public_key(
            self.store, self._key_user(body), match["name"]
        ):
            raise ApiError(404, "no such key")
        return 200, {"ok": True}

    # -- the operator's surface ------------------------------------------ #

    def get_admin(self, method, match, body):
        """Every config section (superuser only when a caller is
        authenticated: the sections hold the service's credentials; a
        departure, see the module)."""
        import dataclasses as _dc

        self._require_superuser()
        out = {}
        for sid in all_sections():
            section = get_section(self.store, sid)
            if section is not None:
                out[sid] = _dc.asdict(section)
        return 200, out

    def set_admin(self, method, match, body):
        """Edit config sections (superuser only: ``_ADMIN_PATHS``). Each
        reader gets the section from the store when it runs, so the
        tick reads an edit of its sections at its next run."""
        import dataclasses as _dc

        updated = []
        for sid, values in body.items():
            cls = all_sections().get(sid)
            if cls is None:
                raise ApiError(400, f"unknown config section {sid!r}")
            # edit the BASE document: get() applies overrides, and a
            # get→set round trip through it would bake them in permanently
            section = cls.get_base(self.store)
            known = {f.name for f in _dc.fields(section)}
            for k, v in values.items():
                if k not in known:
                    raise ApiError(400, f"unknown field {k!r} in section {sid!r}")
                setattr(section, k, v)
            section.set(self.store)
            updated.append(sid)
        if "auth" in updated:
            # the user manager is built from the auth section; a stale
            # cache would keep serving revoked credentials/managers
            self.reload_user_manager()
        return 200, {"updated": updated}

    def get_overload(self, method, match, body):
        """Overload-ladder introspection: current level, fused gauges,
        shed counters, and the aggregate shed records — the operator's
        one-stop brownout view (exempt from shedding itself, like the
        rest of the admin surface)."""
        from ..utils import overload
        from ..utils.log import counters_snapshot

        monitor = overload.monitor_for(self.store)
        monitor.evaluate()
        return 200, {
            "level": monitor.level_label(),
            "gauges": {
                k: round(v, 3) for k, v in monitor.gauges().items()
            },
            "retry_after_s": monitor.retry_after_s(),
            "counters": {
                k: v
                for k, v in counters_snapshot().items()
                if k.startswith(("overload.", "jobs."))
            },
            "sheds": overload.shed_totals(self.store),
        }

    def get_metrics(self, method, match, body):
        """The whole metrics registry in Prometheus text exposition
        format v0.0.4 — counters, gauges, and histograms with their
        cumulative buckets. Shed- and auth-exempt: the scrape must
        survive the storms it measures."""
        from ..utils import metrics as metrics_mod
        from ..utils import overload
        from ..utils.torchenv import refresh_probe_metrics_from_log

        # freshen the pull-style gauges right before rendering: the
        # fused overload signals and the cross-run probe streak.
        # Read-only — a fast scraper must not advance the ladder's
        # downward-hysteresis calm streak (that budget belongs to the
        # tick-cadence evaluate() calls)
        overload.monitor_for(self.store).refresh_gauges()
        refresh_probe_metrics_from_log()
        return 200, PlainTextResponse(metrics_mod.render_prometheus())

    def healthz(self, method, match, body):
        """Liveness: the process answers HTTP. Always 200 — a wedged
        scheduler shows up in /metrics and /healthz/ready, not here."""
        return 200, {"ok": True}

    def healthz_ready(self, method, match, body):
        """Readiness for load-balancer rotation: a replica process
        answers 503 while it is fence-blocked (a failover in progress)
        or once its staleness passes
        ``ReadPathConfig.readiness_staleness_bound_ms`` (0: the serving
        bound), so a balancer stops routing to a lagging follower. A
        primary is always ready; its attached follower's lag only sends
        follower reads back to the primary, and shows as
        ``follower_staleness_ms``."""
        from ..storage.replica import ReplicaStore

        cfg = self._read_path_config()
        bound = float(
            cfg.readiness_staleness_bound_ms or cfg.staleness_bound_ms
        )
        own = self._store
        if not isinstance(own, ReplicaStore):
            payload = {"ready": True, "role": "primary"}
            if self.read_replica is not None:
                payload["follower_staleness_ms"] = round(
                    self.read_replica.staleness_ms(), 1
                )
            return 200, payload
        staleness = own.staleness_ms()
        payload = {
            "role": "replica",
            "replica_id": own.replica_id,
            "staleness_ms": round(staleness, 1),
            "staleness_bound_ms": bound,
        }
        if not own.serve_ready():
            return 503, {
                **payload,
                "ready": False,
                "reason": "fence-blocked: a failover is in progress and "
                          "the new holder's state has not arrived",
            }
        if staleness > bound:
            return 503, {
                **payload,
                "ready": False,
                "reason": "replica staleness exceeds the readiness bound",
            }
        return 200, {**payload, "ready": True}

    def list_traces(self, method, match, body):
        """Newest-last summaries of recent traces (?last=N, default 10)
        from the in-memory ring merged with the store's span sink."""
        from ..utils import tracing

        last = int(body.get("last", 10) or 10)
        return 200, {
            "traces": tracing.recent_traces(self.store, last=last)
        }

    def get_trace(self, method, match, body):
        """One trace's span tree — the anatomy of a tick. Served from
        the ring buffer first (RED/BLACK brownout sheds span STORE
        writes, never the ring), merged with the durable sink."""
        from ..utils import tracing

        tree = tracing.trace_tree(self.store, match["trace"])
        if tree is None:
            raise ApiError(404, f"no trace {match['trace']!r}")
        return 200, tree

    def get_provenance(self, method, match, body):
        """Why is task X at rank Y: the last solve tick's per-task score
        terms for one distro (?task= narrows to one task, ?limit= caps
        the queue-head dump)."""
        from ..scheduler.provenance import provenance_for

        prov = provenance_for(self.store)
        if prov is None:
            raise ApiError(
                404, "no solve provenance yet (no TPU-planned tick)"
            )
        task_id = str(body.get("task", "") or "")
        if task_id:
            doc = prov.explain(match["distro"], task_id)
            if doc is None:
                raise ApiError(
                    404,
                    f"task {task_id!r} is not in {match['distro']!r}'s "
                    "planned queue",
                )
            return 200, doc
        doc = prov.to_doc(match["distro"], limit=int(body.get("limit", 25)))
        if doc is None:
            raise ApiError(
                404, f"no provenance for distro {match['distro']!r}"
            )
        return 200, doc

    def get_capacity_fleet(self, method, match, body):
        """The last applied capacity solve's fleet view: pool usage,
        budget, and the per-distro decomposition head (?limit=)."""
        from ..scheduler.provenance import capacity_provenance_for

        prov = capacity_provenance_for(self.store)
        if prov is None:
            raise ApiError(
                404, "no capacity solve yet (no capacity-managed distro "
                "has planned)"
            )
        return 200, prov.to_doc(limit=int(body.get("limit", 50)))

    def get_capacity(self, method, match, body):
        """Why did distro X get k hosts: the capacity program's term
        decomposition, binding constraints and trade partners."""
        from ..scheduler.provenance import explain_capacity

        doc = explain_capacity(self.store, match["distro"])
        if doc is None:
            raise ApiError(
                404,
                f"no capacity decision for distro {match['distro']!r}",
            )
        return 200, doc

    def get_fleet(self, method, match, body):
        """Process-per-shard fleet runtime state (runtime/supervisor.py
        fleet_state): per-worker state / lease epoch history / round
        timing / restart counts / adoption state plus fleet totals. 404
        when this service runs the single-store plane (no ``--shards N``
        supervisor attached)."""
        from ..runtime.supervisor import peek_fleet_supervisor

        sup = peek_fleet_supervisor(self.store)
        if sup is None:
            raise ApiError(
                404, "no fleet supervisor attached (start the service "
                "with --shards N --data-dir to run the process-per-"
                "shard runtime)"
            )
        return 200, sup.fleet_state()

    def list_log_lines(self, method, match, body):
        """Recent structured log records from the in-store ring
        (utils/log.StoreSink) — operator debugging surface."""
        from ..utils.log import StoreSink

        coll = self.store.collection(StoreSink.COLLECTION)
        docs = coll.find()
        docs.sort(key=lambda d: d["_id"])
        limit = int(body.get("limit", 200))
        level = body.get("level", "")
        if level:
            docs = [d for d in docs if d.get("level") == level]
        return 200, docs[-limit:]

    def list_spans(self, method, match, body):
        from ..utils.tracing import get_spans

        return 200, get_spans(self.store)[-200:]

    def system_stats(self, method, match, body):
        """Recent system samples (tasks by status, queue lengths/age, job
        depth, rusage) — the stats sampler's output
        (units/task_jobs.sample_system_stats)."""
        docs = self.store.collection(
            task_jobs.SYSTEM_STATS_COLLECTION
        ).find()
        docs.sort(key=lambda d: d["at"], reverse=True)
        limit = int(body.get("limit", 20) or 20)  # "" and 0 -> default
        if limit <= 0:  # negative: a limit, not a slice trick
            limit = 20
        return 200, docs[:limit]

    def host_stats(self, method, match, body):
        stats = self.store.collection("host_stats").find()
        stats.sort(key=lambda d: d["at"])
        return 200, stats[-500:]

    # -- task reliability (reference rest/route/reliability.go) --------- #

    @staticmethod
    def _num(body: dict, key: str, default, cast=float):
        """Numeric query/body param → 400 on malformed input (the
        dispatch loop would surface a bare ValueError as a 500)."""
        v = body.get(key)
        if v in (None, ""):
            return default
        try:
            return cast(v)
        except (TypeError, ValueError):
            raise ApiError(400, f"invalid numeric parameter {key!r}")

    def task_reliability(self, method, match, body):
        """GET /projects/{id}/task_reliability — Wilson-scored success
        rates over finished executions (reference reliability.go +
        model/reliability/query.go)."""
        from ..models import reliability as rel_mod

        def _csv(key):
            v = body.get(key, "")
            if isinstance(v, list):
                return [str(x) for x in v]
            return [s for s in str(v).split(",") if s]

        now = _time.time()
        f = rel_mod.ReliabilityFilter(
            project=match["project"],
            tasks=_csv("tasks"),
            after_date=self._num(body, "after_date", now - 28 * 86400),
            before_date=self._num(body, "before_date", now),
            group_by=body.get("group_by") or rel_mod.GROUP_BY_TASK,
            group_num_days=self._num(body, "group_num_days", 1, int),
            requesters=_csv("requesters") or None,
            variants=_csv("variants") or None,
            distros=_csv("distros") or None,
            significance=self._num(body, "significance", 0.05),
            sort=body.get("sort") or rel_mod.SORT_LATEST,
            limit=self._num(body, "limit", rel_mod.MAX_LIMIT, int),
        )
        try:
            scores = rel_mod.get_task_reliability_scores(self.store, f)
        except ValueError as e:
            raise ApiError(400, str(e))
        return 200, [s.to_doc() for s in scores]

    # -- permissions (reference rest/route/permissions.go) -------------- #

    #: the permission catalog the UI renders pickers from (reference
    #: permissionsGetHandler.getAllPermissions — project + distro
    #: permission keys mapped onto this repo's scope model)
    _PERMISSION_CATALOG = {
        "projectPermissions": [
            {"key": "project_settings",
             "name": "Project Settings",
             "levels": ["admin", "view", "none"]},
            {"key": "project_tasks",
             "name": "Tasks (restart/abort/set priority)",
             "levels": ["admin", "view", "none"]},
            {"key": "project_patches",
             "name": "Patches",
             "levels": ["admin", "none"]},
            {"key": "project_logs",
             "name": "Logs",
             "levels": ["view", "none"]},
        ],
        "distroPermissions": [
            {"key": "distro_settings",
             "name": "Distro Settings",
             "levels": ["admin", "edit", "view", "none"]},
            {"key": "distro_hosts",
             "name": "Spawn Hosts",
             "levels": ["edit", "view", "none"]},
        ],
    }

    def _require_superuser(self) -> None:
        """Role-editing gate (reference editRoles middleware). Only
        enforced when an authenticated identity exists (dev mode has no
        verified identity to check)."""
        ident = getattr(self._ident, "user", "")
        if ident and not getattr(self._ident, "superuser", False):
            raise ApiError(403, "superuser scope required")

    def permissions_catalog(self, method, match, body):
        return 200, self._PERMISSION_CATALOG

    def all_users_permissions(self, method, match, body):
        """GET /permissions/users → {user: [roles]} for every user that
        holds any role (reference makeGetAllUsersPermissions)."""
        self._require_superuser()
        from ..models import user as user_mod

        return 200, {
            d["_id"]: d.get("roles", [])
            for d in user_mod.coll(self.store).find(
                lambda d: d.get("roles")
            )
        }

    def get_user_permissions(self, method, match, body):
        from ..models import user as user_mod

        u = user_mod.get_user(self.store, match["user"])
        if u is None:
            raise ApiError(404, f"no user {match['user']!r}")
        return 200, {"user_id": u.id, "roles": list(u.roles)}

    def post_user_permissions(self, method, match, body):
        """POST /users/{id}/permissions {"role": ...} — grant (reference
        makeModifyUserPermissions)."""
        self._require_superuser()
        from ..models import user as user_mod

        role = body.get("role", "")
        if not role:
            raise ApiError(400, "missing role")
        if not user_mod.grant_role(self.store, match["user"], role):
            raise ApiError(404, f"no user {match['user']!r}")
        u = user_mod.get_user(self.store, match["user"])
        return 200, {"user_id": u.id, "roles": list(u.roles)}

    def delete_user_permissions(self, method, match, body):
        """DELETE /users/{id}/permissions — revoke one role when given,
        else all (reference makeDeleteUserPermissions strips all)."""
        self._require_superuser()
        from ..models import user as user_mod

        role = body.get("role", "")
        ok = (
            user_mod.revoke_role(self.store, match["user"], role)
            if role
            else user_mod.revoke_all_roles(self.store, match["user"])
        )
        if not ok:
            raise ApiError(404, f"no user {match['user']!r}")
        return 200, {"ok": True}

    # -- project copy + vars (reference rest/route/project_copy.go) ----- #

    def _require_project_admin(self, project_id: str) -> None:
        """reference requireProjectAdmin middleware: superuser or the
        per-project admin scope."""
        ident = getattr(self._ident, "user", "")
        if not ident or getattr(self._ident, "superuser", False):
            return
        from ..models import user as user_mod

        u = user_mod.get_user(self.store, ident)
        if u is not None and u.has_scope(f"project:{project_id}"):
            return
        raise ApiError(
            403, f"project admin scope required for {project_id!r}"
        )

    def copy_project(self, method, match, body):
        """POST /projects/{id}/copy {"new_project": ...}: duplicate the
        project ref (disabled until reviewed, like the reference) and its
        non-private variables (reference project_copy.go
        makeCopyProject → data.CopyProject)."""
        import dataclasses as _dc

        from ..models import project_vars as pvars_mod

        self._require_project_admin(match["project"])
        new_id = body.get("new_project", "")
        if not new_id:
            raise ApiError(400, "missing new_project")
        src = repotracker_mod.get_project_ref(self.store, match["project"])
        if src is None:
            raise ApiError(404, f"no project {match['project']!r}")
        if repotracker_mod.get_project_ref(self.store, new_id) is not None:
            raise ApiError(400, f"project {new_id!r} already exists")
        dup = _dc.replace(src, id=new_id)
        # the copy starts disabled so it cannot ingest/schedule until a
        # human reviews it (reference data.CopyProject sets Enabled=false)
        dup.enabled = False
        repotracker_mod.upsert_project_ref(self.store, dup)
        pvars_mod.copy_vars(
            self.store, match["project"], new_id, include_private=False
        )
        event_mod.log(
            self.store, event_mod.RESOURCE_PROJECT, "PROJECT_COPIED",
            new_id, {"copied_from": match["project"],
                     "user": getattr(self._ident, "user", "")},
        )
        return 200, dup.to_doc()

    def copy_project_vars(self, method, match, body):
        """POST /projects/{id}/copy/variables (reference
        copyVariablesHandler: copy_to required; dry_run previews with
        private values redacted; include_private; overwrite)."""
        from ..models import project_vars as pvars_mod

        copy_to = body.get("copy_to", "")
        if not copy_to:
            raise ApiError(400, "missing copy_to")
        # BOTH sides need the admin scope (reference: requireProjectAdmin
        # wraps the URL/source project, and Run re-checks settings-edit on
        # the destination) — source-side auth is what keeps a destination
        # admin from exfiltrating another project's private values
        self._require_project_admin(match["project"])
        self._require_project_admin(copy_to)
        if repotracker_mod.get_project_ref(self.store, copy_to) is None:
            raise ApiError(404, f"no project {copy_to!r}")
        dry_run = bool(body.get("dry_run"))
        copied = pvars_mod.copy_vars(
            self.store,
            match["project"],
            copy_to,
            dry_run=dry_run,
            include_private=bool(body.get("include_private")),
            overwrite=bool(body.get("overwrite")),
        )
        if not dry_run:
            event_mod.log(
                self.store, event_mod.RESOURCE_PROJECT,
                "PROJECT_VARS_COPIED", copy_to,
                {"copied_from": match["project"],
                 "keys": sorted(copied),
                 "user": getattr(self._ident, "user", "")},
            )
        return 200, {"vars": copied, "dry_run": dry_run}

    def project_events(self, method, match, body):
        """GET /projects/{id}/events — settings-change audit trail with
        keyed pagination (reference project_events.go projectEventsGet:
        newest-first, ?ts= continues before that timestamp). The cursor
        is (timestamp, id), not timestamp alone — events sharing one
        time.time() tick at a page boundary must not vanish."""
        limit = self._num(body, "limit", 10, int)
        before_ts = self._num(body, "ts", _time.time() + 1)
        before_id = body.get("id", "")

        def seq(event_id: str):
            # ids are "evt-{n}" with a monotonically increasing n; the
            # tiebreak must be NUMERIC ("evt-9" vs "evt-10" would invert
            # lexicographically). Non-conforming ids fall back to
            # lexicographic comparison — collapsing them all to one rank
            # would skip or duplicate same-timestamp events at a page
            # boundary.
            try:
                return (0, int(event_id.rsplit("-", 1)[-1]), "")
            except ValueError:
                return (1, 0, event_id)

        before_key = (before_ts, seq(before_id)) if before_id else None
        evs = [
            e
            for e in event_mod.find_by_resource(
                self.store, match["project"]
            )
            if e.resource_type == event_mod.RESOURCE_PROJECT
            and (
                (e.timestamp, seq(e.id)) < before_key
                if before_key is not None
                else e.timestamp < before_ts
            )
        ]
        evs.sort(key=lambda e: (e.timestamp, seq(e.id)), reverse=True)
        page = evs[:limit]
        import dataclasses as _dc

        out = {"events": [_dc.asdict(e) for e in page]}
        if len(evs) > limit:
            out["next_ts"] = page[-1].timestamp
            out["next_id"] = page[-1].id
        return 200, out

    # -- the event plane ------------------------------------------------- #

    def list_events(self, method, match, body):
        evs = self.store.collection("events").find()
        evs.sort(key=lambda d: d["timestamp"])
        return 200, evs[-200:]

    def resource_events(self, method, match, body):
        """Event timeline for one resource (task/host/version/…) — the
        reference's event-log finders surfaced per entity."""
        import dataclasses as _dc

        return 200, [
            _dc.asdict(e)
            for e in event_mod.find_by_resource(self.store, match["resource"])
        ]

    def waterfall(self, method, match, body):
        """Versions × variants grid for a project (the Spruce waterfall's
        data shape)."""
        versions = version_mod.find(
            self.store, lambda d: d["project"] == match["project"]
        )
        versions.sort(key=lambda v: v.revision_order_number, reverse=True)
        out = []
        for v in versions[: int(body.get("limit", 10) or 10)]:
            variants = {}
            for t in task_mod.find(
                self.store, lambda d: d["version"] == v.id
            ):
                cell = variants.setdefault(
                    t.build_variant, {"total": 0, "success": 0, "failed": 0,
                                      "in_progress": 0}
                )
                cell["total"] += 1
                if t.status == TaskStatus.SUCCEEDED.value:
                    cell["success"] += 1
                elif t.status == TaskStatus.FAILED.value:
                    cell["failed"] += 1
                elif t.status in (TaskStatus.STARTED.value,
                                  TaskStatus.DISPATCHED.value):
                    cell["in_progress"] += 1
            out.append(
                {
                    "version_id": v.id,
                    "revision": v.revision,
                    "message": v.message,
                    "order": v.revision_order_number,
                    "status": v.status,
                    "variants": variants,
                }
            )
        return 200, out

    def _require_owner(self, owner: str) -> None:
        """Ownership gate for user resources (reference host_spawn.go
        checks the authenticated user against host.StartedBy). Enforced
        whenever an authenticated identity exists; without auth
        configured there is no verified identity to compare (dev mode)."""
        ident = getattr(self._ident, "user", "")
        if ident and ident != owner and not getattr(
            self._ident, "superuser", False
        ):
            raise ApiError(403, f"resource belongs to {owner!r}")

    def create_subscription(self, method, match, body):
        """Notification subscriptions (reference rest/route subscriptions)."""
        from ..events.triggers import Subscription, add_subscription

        try:
            sub = Subscription(
                id=body.get("id") or f"sub-{_time.time_ns()}",
                resource_type=body["resource_type"],
                trigger=body["trigger"],
                subscriber_type=body["subscriber_type"],
                subscriber_target=body["subscriber_target"],
                filters=body.get("filters", {}),
                # the authenticated identity owns what it creates; the
                # body field only matters in dev mode (no auth)
                owner=getattr(self._ident, "user", "")
                or body.get("owner", ""),
            )
        except KeyError as e:
            raise ApiError(400, f"missing subscription field {e}")
        from ..events.triggers import _SENDERS

        if sub.subscriber_type not in _SENDERS:
            raise ApiError(
                400,
                f"unknown subscriber type {sub.subscriber_type!r}; "
                f"registered channels: {sorted(_SENDERS)}",
            )
        add_subscription(self.store, sub)
        return 201, sub.to_doc()

    def list_subscriptions(self, method, match, body):
        return 200, self.store.collection("subscriptions").find()

    def delete_subscription(self, method, match, body):
        """DELETE a subscription by id (reference rest/route
        subscriptions DELETE; only the owner or a superuser may)."""
        doc = self.store.collection("subscriptions").get(match["sub"])
        if doc is None:
            raise ApiError(404, "subscription not found")
        owner = doc.get("owner", "")
        if owner:
            self._require_owner(owner)
        elif getattr(self._ident, "user", "") and not getattr(
            self._ident, "superuser", False
        ):
            # unowned (system-created) subscriptions are admin-only to
            # delete — anyone-can-delete would let one user silently
            # destroy another's notifications
            raise ApiError(403, "unowned subscription: admin only")
        self.store.collection("subscriptions").remove(match["sub"])
        return 200, {"ok": True}

    def delete_distro(self, method, match, body):
        """DELETE a distro (reference rest/route/distro.go DELETE; admin
        path — _ADMIN_PATHS gates it when auth is on). Refused while
        hosts still reference it. The tick's next run plans the smaller
        distro set: the TickCache's distro view and the resident plane
        see the removal through the store's listeners."""
        if distro_mod.get(self.store, match["distro"]) is None:
            raise ApiError(404, "distro not found")
        n_hosts = host_mod.coll(self.store).count(
            lambda d: d["distro_id"] == match["distro"]
            and d["status"] not in ("terminated",)
        )
        if n_hosts:
            raise ApiError(
                409, f"distro has {n_hosts} live host(s); drain it first"
            )
        distro_mod.coll(self.store).remove(match["distro"])
        # clear persisted queues so nothing reads phantom demand for a
        # distro that can never run it (reference DeleteDistroById →
        # ClearTaskQueue), and leave an audit event
        from ..models import task_queue as tq_mod

        tq_mod.coll(self.store).remove(match["distro"])
        tq_mod.coll(self.store, secondary=True).remove(match["distro"])
        event_mod.log(
            self.store, event_mod.RESOURCE_HOST, "DISTRO_REMOVED",
            match["distro"], {},
        )
        return 200, {"ok": True}

    def _notify_direct(self, channel: str, doc: dict):
        """Slack/email POST bodies become outbox rows the drain job
        delivers exactly like subscription-driven notifications
        (reference notification.go sends through the env's senders)."""
        from ..events.senders import OUTBOX, insert_outbox_row
        from ..utils import overload

        outcome = insert_outbox_row(
            self.store, OUTBOX[channel], {"channel_type": channel, **doc}
        )
        if outcome.reason == "dropped":
            # discarded at the outbox cap — an explicit caller must be
            # told so it can retry after the brownout
            monitor = overload.monitor_for(self.store)
            retry = max(1.0, monitor.retry_after_s())
            self._ident.response_headers = [
                ("Retry-After", str(int(retry)))
            ]
            return 429, {
                "error": "notification outbox saturated",
                "retry_after_s": retry,
            }
        if outcome.reason == "coalesced":
            # folded into an identical undelivered row: accepted, and
            # WILL be delivered with it
            return 200, {"ok": True, "coalesced": True}
        return 200, {"ok": True}

    def notify_slack(self, method, match, body):
        target = body.get("target", "")
        if not target:
            raise ApiError(400, "missing target")
        return self._notify_direct(
            "slack",
            {"slack_channel": target, "text": body.get("msg", "")},
        )

    def notify_email(self, method, match, body):
        recipients = body.get("recipients") or []
        if isinstance(recipients, str):
            recipients = [r for r in recipients.split(",") if r]
        if not recipients:
            raise ApiError(400, "missing recipients")
        return self._notify_direct(
            "email",
            {
                "to": ",".join(recipients),
                "subject": body.get("subject", ""),
                "body": body.get("body", ""),
            },
        )

    # -- SNS intake (reference rest/route/sns.go) ----------------------- #

    def sns_hook_no_token(self, method, match, body):
        """Token-less /hooks/aws: only acceptable when no secret is
        configured AND auth is off (dev mode); production fails closed."""
        return self.sns_hook(method, _FakeMatch({"token": ""}), body)

    def sns_hook(self, method, match, body):
        """POST /hooks/aws/{token} — EC2 EventBridge notifications via
        SNS (reference sns.go ec2SNS). The path token stands in for the
        reference's signed-payload verification (requireValidSNSPayload
        fetches the SNS signing cert, which a deployment without egress
        cannot). Instance state-changes drive the same host transitions
        as the reference: terminated/stopped → externally-terminated
        reconciliation + stranded-task cleanup; running → agent-start
        bookkeeping."""
        import hmac as _hmac

        from ..settings import ApiConfig

        secret = ApiConfig.get(self.store).sns_secret
        if self.require_auth and not secret:
            return 401, {"error": "sns secret not configured"}
        if secret and not _hmac.compare_digest(
            secret, match["token"] or ""
        ):
            return 401, {"error": "invalid sns token"}

        msg_type = body.get("Type", "")
        if msg_type == "SubscriptionConfirmation":
            # the reference GETs the SubscribeURL; without egress it is
            # logged for the operator to confirm out-of-band
            event_mod.log(
                self.store, event_mod.RESOURCE_ADMIN,
                "SNS_SUBSCRIPTION_REQUESTED", "sns",
                {"subscribe_url": body.get("SubscribeURL", "")},
            )
            return 200, {"ok": True}
        if msg_type == "UnsubscribeConfirmation":
            return 200, {"ok": True}
        if msg_type != "Notification":
            raise ApiError(400, f"unknown SNS message type {msg_type!r}")

        try:
            notification = json.loads(body.get("Message", "") or "{}")
        except ValueError:
            raise ApiError(400, "unparseable SNS message body")
        detail_type = notification.get("detail-type", "")
        if detail_type != "EC2 Instance State-change Notification":
            raise ApiError(400, f"unknown detail type {detail_type!r}")
        instance_id = (notification.get("detail") or {}).get(
            "instance-id", ""
        )
        # an empty instance id must never reach the lookup: hosts not
        # created by a cloud provider carry the default external_id=""
        # and would match — a malformed event could terminate a healthy
        # host
        if not instance_id:
            raise ApiError(400, "notification is missing instance-id")
        state = (notification.get("detail") or {}).get("state", "")
        h = next(
            iter(
                host_mod.find(
                    self.store,
                    lambda d: d["_id"] == instance_id
                    or d.get("external_id") == instance_id,
                )
            ),
            None,
        )
        # unknown host: ack so AWS stops retrying (reference
        # handleInstanceTerminated early return)
        if h is None:
            return 200, {"ok": True, "host": None}
        if state in ("terminated", "stopped", "stopping"):
            if h.status != HostStatus.TERMINATED.value:
                now = _time.time()
                host_mod.coll(self.store).update(
                    h.id,
                    {
                        "status": HostStatus.TERMINATED.value,
                        "termination_time": now,
                    },
                )
                event_mod.log(
                    self.store, event_mod.RESOURCE_HOST,
                    "HOST_EXTERNALLY_TERMINATED", h.id,
                    {"sns_state": state}, timestamp=now,
                )
                if h.running_task:
                    from ..units.host_jobs import fix_stranded_task

                    fix_stranded_task(
                        self.store, h.running_task, h.id, now
                    )
        elif state == "running":
            event_mod.log(
                self.store, event_mod.RESOURCE_HOST,
                "HOST_INSTANCE_RUNNING", h.id, {"sns_state": state},
            )
        return 200, {"ok": True, "host": h.id}


class _FakeMatch:
    """Minimal re.Match stand-in for handler-to-handler delegation."""

    def __init__(self, groups: Dict[str, str]) -> None:
        self._groups = groups

    def __getitem__(self, key: str) -> str:
        return self._groups[key]
