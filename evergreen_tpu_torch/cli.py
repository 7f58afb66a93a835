"""Command line of the port, ``python -m evergreen_tpu_torch <cmd>``:

    solver  [--host] [--port] [--device cpu]
            the solver sidecar (``api/sidecar.py``)
    service [--data-dir D] [--host] [--port] [--workers N] [--require-auth]
            [--rate-limit N] [--github-webhook-secret S] [--device cpu]
            the single-store service (reference ``service web``): the
            environment (``env.py::Environment.build``: the store, a
            durable writer's lease, replay and recovery pass, the job
            plane), its cron populators on their cadence
            (``CronRunner.run_background``: the tick job solves on the
            card, the event notifier turns the event log into
            notifications), and the REST surface (``api/rest.py``: the
            agent protocol, the user's and the operator's routes, and
            ``/hooks/github``, signed with ``--github-webhook-secret`` or
            the ``api`` section's secret) on a socket, with a durable
            writer's in-process follower serving the fresh reads;
            SIGTERM or SIGINT drains it (the crons stop, the WAL
            flushes, the lease is released) and it exits 0. A card fault
            in the tick job ends the process with ``EXIT_KERNEL``
    service --replica-of URL --data-dir D [--host] [--port]
            [--require-auth] [--rate-limit N]
            a read replica (``storage/replica.py``) of the writer at URL:
            it tails D's WAL, serves the reads itself and forwards every
            write to the primary (503 with the primary's URL when it is
            unreachable); no lease, no job plane, no device work: it
            neither probes the card nor imports ``torch``. Without
            ``--data-dir`` it exits 2
    service --shards N --data-dir D [--host] [--port] [--require-auth]
            [--rate-limit N] [--device cpu]
            the process-per-shard fleet (``runtime/supervisor.py``): a
            supervisor in this process, one shard worker process per
            shard, rounds on the 15 s cadence, the solver leader elected
            by ``ShardingConfig.solver_leader``, and a REST front over an
            in-memory store with the supervisor attached
            (``GET /rest/v2/admin/fleet``, ``GET /metrics``); SIGTERM or
            SIGINT stops the front, drains the fleet and releases every
            lease
    agent   --host-id H [--host-secret S] [--api-server URL]
            [--working-dir D] [--once]
            a worker agent on a build host (``agent/agent.py`` over
            ``agent/rest_comm.py``): it long-polls ``next_task``, runs
            the task's commands, posts the logs and ends the task;
            ``--once`` exits when a pull comes back empty
    agent-monitor --host-id H [--host-secret S] [--api-server URL]
            [--working-dir D] [--max-respawns N]
            respawns a crashed agent process (``agent/monitor.py``)
    validate FILE
            checks a project file (``ingestion/validator.py``)
    evaluate FILE [--tasks | --variants]
            prints the parsed project, matrices expanded, as YAML
    list    --file F (--tasks | --variants | --task-groups)
            | (--distros | --projects) [--api-server URL]
            lists a project file's parts, or the server's distros or
            projects
    patch   --project P [--config F] [--variants V,..] [--tasks T,..]
            [--description D] [--author A] [--githash H] [--finalize]
            creates a patch on the server (``POST /rest/v2/patches``),
            finalized into a version with ``--finalize``
    patch-list [--project P]; patch-cancel ID; patch-finalize ID
            the server's patches
    login   --username U [--password P] [--api-server URL]
            password login against the server's user manager
            (``POST /login``); prints the session token
    keys    (list | add | delete) [--name N] [--key K | --file F]
            [--user U]
            the user's SSH public keys (``/rest/v2/keys``)
    user    (create | grant) USER [--roles R]
            creates a user or grants a role, on this process's
            in-memory store (the auth bootstrap, as in the JAX package)
    subscriptions (list | delete) [--sub-id ID]
            the server's notification subscriptions
            (``/rest/v2/subscriptions``)
    status  [--watch S] [--watch-count N]
            the server's counts (``/rest/v2/status``); ``--watch`` polls
            with conditional GETs, which an unchanged store answers 304
    last-green --project P --variants V,..
            the newest mainline version whose builds of those variants
            all succeeded
    fetch   --task T [--dir D] [--source] [--artifacts]
            writes a task's version config and metadata, and copies the
            artifacts whose links are URLs or local paths (a
            blob key is skipped as unreachable, as in the JAX package)
    host    (spawn | list | start | stop | terminate | extend)
            [--id H] [--distro D] [--user U] [--hours N] [--no-expiration]
            a user's spawn hosts (``/rest/v2/hosts``)
    volume  (create | list | attach | detach | delete) [--id V]
            [--user U] [--host H] [--size-gb N]
            a user's volumes (``/rest/v2/volumes``); ``delete`` is the
            port's (the JAX package's command has no delete, its server
            the route)
    admin   (get | set-flag) [--flag F] [--value true|false]
            every config section (``GET /rest/v2/admin/settings``), or one
            ``service_flags`` field set (``POST``, superuser only); the
            answer is printed, an error included, and it exits 0
    version
            prints the package's version

The server commands (``list`` with ``--distros`` or ``--projects``,
``patch``, ``patch-list``, ``patch-cancel``, ``patch-finalize``, ``keys``,
``subscriptions``, ``status``, ``last-green``, ``fetch``, ``host``,
``volume``, ``admin``) take ``--api-server URL`` and,
against a server that requires auth, ``--api-user U --api-key K``, sent
as the ``Api-User`` and ``Api-Key`` headers. The JAX package's client
sends no credentials: against such a server only its ``login`` answers.
The server takes a session token too (``Authorization: Bearer``), which
no client command sends, in either package.

``solver`` and ``service`` run on the CUDA card; without a card they
exit with an error unless ``--device cpu`` is given. Before either
starts, the backend probe (``utils/torchenv.py::ensure_usable_backend``)
checks the card in a fresh interpreter, once (``Environment.build``
does not probe). ``service --replica-of``, ``agent``, ``agent-monitor``
and the client commands never probe and never import ``torch``: a
replica has no device work, and a build host or a developer's machine
has no card.

Not ported: the JAX package's ``bench`` (the port has no benchmark
yet), ``smoke`` (it drives GraphQL, which the port lacks),
``replay-trace`` and ``service --capture-trace`` (the scenario engine's
trace capture and replay).
"""
from __future__ import annotations

import argparse
import json
import sys
import time as _time
from typing import List, Optional


def cmd_solver(args) -> int:
    from .api.sidecar import serve
    from .device import device_name

    server = serve(args.host, args.port, args.device)
    host, port = server.server_address[:2]
    print(
        f"solver sidecar listening on {host}:{port} "
        f"({device_name(server.device)})",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def cmd_service(args) -> int:
    """The app server (reference operations/service.go ``service web``):
    the single-store service, or with ``--shards`` the process-per-shard
    fleet."""
    if args.shards:
        return _cmd_service_fleet(args)
    return _cmd_service_single(args)


def _install_graceful_signals(server) -> None:
    """SIGTERM/SIGINT → graceful drain: stop accepting requests (the
    serve loop returns, so the caller's ``finally`` runs the teardown —
    crons stopped, the WAL flushed, the lease released)."""
    import signal
    import threading

    fired = {"done": False}

    def handler(signum, frame):
        if fired["done"]:
            return
        fired["done"] = True
        print(f"received signal {signum} — draining before exit ...",
              file=sys.stderr, flush=True)
        # shutdown() must not run on the serve_forever thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, handler)


def _cmd_service_replica(args) -> int:
    """A read replica of ``--replica-of``'s writer: it tails
    ``--data-dir``'s WAL, serves the reads itself and forwards the
    writes (``api/rest.py::RestApi._maybe_forward``). No lease, no job
    plane, no device."""
    from .env import Environment

    if not args.data_dir:
        print("--replica-of requires --data-dir", file=sys.stderr)
        return 2
    env = Environment.build(
        data_dir=args.data_dir,
        replica_of=args.replica_of,
        require_auth=args.require_auth,
        rate_limit=args.rate_limit,
    )
    try:
        print("boot ms: " + json.dumps(
            {k: round(v, 1) for k, v in env.boot_ms.items()}), flush=True)
        server = env.api.serve(args.host, args.port)
        _install_graceful_signals(server)
        host, port = server.server_address[:2]
        print(f"evergreen_tpu_torch replica listening on {host}:{port} "
              f"(reads local, writes forward to {args.replica_of})",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        env.close()
    print("replica drained", flush=True)
    return 0


def _cmd_service_single(args) -> int:
    """The single-store service: the counterpart of the JAX package's
    ``cmd_service`` without ``--shards`` (``evergreen_tpu/cli.py``)."""
    from .env import Environment
    from .utils.gctune import tune_gc_for_long_lived_heap

    if args.replica_of:
        return _cmd_service_replica(args)
    if args.data_dir:
        print(f"acquiring writer lease on {args.data_dir} ...", flush=True)
    # main() has probed the card
    env = Environment.build(
        data_dir=args.data_dir or "",
        require_auth=args.require_auth,
        rate_limit=args.rate_limit,
        workers=args.workers,
        webhook_secret=args.github_webhook_secret or "",
        device=args.device,
    )
    try:
        if env.recovery_report is not None:
            r = env.recovery_report
            print(
                f"recovery: epoch={r.epoch} reconciled_tasks="
                f"{r.reconciled_tasks} released_claims="
                f"{len(r.released_claims)} hosts_terminated="
                f"{len(r.hosts_terminated)} stale_frames_dropped="
                f"{r.stale_frames_dropped}", flush=True,
            )
        print("boot ms: " + json.dumps(
            {k: round(v, 1) for k, v in env.boot_ms.items()}), flush=True)
        env.cron_runner.run_background()
        tune_gc_for_long_lived_heap()
        server = env.api.serve(args.host, args.port)
        _install_graceful_signals(server)
        host, port = server.server_address[:2]
        print(f"evergreen_tpu_torch service listening on {host}:{port} "
              f"(tick on {env.device})", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        env.close()
    if env.device.type == "cuda":
        from .ops.distro_stats import fused_distro_stats
        from .ops.segment import segment_sum

        print("kernel launches: " + json.dumps(
            {"fused_distro_stats": fused_distro_stats.launches,
             "segment_sum": segment_sum.launches,
             **{f"segment_sum[{p}]": n
                for p, n in segment_sum.launches_by_plan.items()}}),
            flush=True)
    print("service drained; the writer lease released" if env.lease is not None
          else "service drained", flush=True)
    return 0


def _cmd_service_fleet(args) -> int:
    """The process-per-shard service: the counterpart of the JAX
    package's ``_cmd_service_fleet`` (``evergreen_tpu/cli.py``): the
    supervisor and its workers, and a REST front over an in-memory store
    with the supervisor attached."""
    from .api.rest import RestApi
    from .runtime.supervisor import FleetSupervisor, attach_fleet_supervisor
    from .settings import ShardingConfig
    from .storage.durable import DurableStore
    from .storage.store import Store
    from .utils.retry import RetryPolicy

    if not args.data_dir:
        print("--shards N requires --data-dir", file=sys.stderr)
        return 2
    # the sharding.* knobs live in the durable config: read them off shard
    # 0's segment BEFORE any worker spawns (no lease — the workers own the
    # leases). Inspection-open only: close the journal HANDLE, never
    # store.close(), whose checkpoint and WAL rotation would clobber a
    # still-live holder's segment. A fresh or unreadable data dir falls
    # back to the section defaults.
    sharding = ShardingConfig()
    try:
        cfg_store = DurableStore(args.data_dir, shard_id=0)
        try:
            sharding = ShardingConfig.get(cfg_store)
        finally:
            cfg_store._journal.close()
    except Exception as exc:  # noqa: BLE001 — defaults are a fine boot
        print(f"sharding config read fell back to defaults: {exc!r}", file=sys.stderr)
    sup = FleetSupervisor(
        args.data_dir, args.shards,
        ttl_s=sharding.worker_lease_ttl_s,
        hb_interval_s=sharding.worker_heartbeat_s,
        hb_deadline_s=sharding.worker_heartbeat_deadline_s,
        restart_policy=RetryPolicy(
            attempts=1_000_000,
            base_backoff_s=sharding.worker_restart_backoff_s,
            max_backoff_s=sharding.worker_restart_backoff_max_s,
        ),
        rebalance_enabled=sharding.rebalance_enabled,
        max_handoffs_per_pass=sharding.max_handoffs_per_round,
        orphan_grace_s=sharding.orphan_grace_s,
        command_silence_s=sharding.worker_command_silence_s,
        supervisor_lease_ttl_s=sharding.supervisor_lease_ttl_s,
        solver=sharding.solver_leader,
        solver_lease_ttl_s=sharding.solver_lease_ttl_s,
        solver_timeout_s=sharding.solver_timeout_s,
        device=args.device,
    )
    # the front binds first so that SIGTERM or SIGINT during the start
    # drains the fleet too: a shutdown asked before serve_forever makes it
    # return at once
    front = Store()
    attach_fleet_supervisor(front, sup)
    server = RestApi(
        front,
        require_auth=args.require_auth,
        rate_limit_per_min=args.rate_limit,
    ).serve(args.host, args.port)
    _install_graceful_signals(server)
    print(f"acquiring fleet lease, then adopting/spawning {args.shards} shard "
          f"workers over {args.data_dir} ...", flush=True)
    try:
        try:
            sup.start()
        except RuntimeError as exc:
            # a LIVE supervisor already commands this fleet: refuse to
            # split-brain it (a dead one's lease would have been stolen)
            print(f"cannot start fleet service: {exc}", file=sys.stderr)
            return 1
        try:
            state = sup.fleet_state()
            ready = sum(1 for w in state["workers"].values() if w["state"] == "ready")
            adopted = sum(1 for w in state["workers"].values() if w["adopted"])
            print(f"fleet up: {ready}/{args.shards} workers ready ({adopted} adopted "
                  f"live from a previous supervisor, {args.shards - adopted} spawned; "
                  f"supervisor epoch {state['supervisor_epoch']}; solver leader "
                  f"epoch {state['solver_epoch']})", flush=True)
            sup.run_background()
            host, port = server.server_address[:2]
            print(f"evergreen_tpu_torch fleet service listening on {host}:{port} "
                  f"({args.shards} shard worker processes; GET "
                  f"/rest/v2/admin/fleet for state)", flush=True)
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
        finally:
            print("draining fleet (flush WAL groups, release shard leases, reap "
                  "workers) ...", file=sys.stderr, flush=True)
            sup.stop(graceful=True)
    finally:
        server.server_close()
    return 0


def cmd_agent(args) -> int:
    """Run a worker agent against a server (reference operations/agent.go)."""
    import time as _time

    from .agent.agent import Agent, AgentOptions
    from .agent.rest_comm import RestCommunicator

    comm = RestCommunicator(
        args.api_server, host_id=args.host_id, host_secret=args.host_secret
    )
    agent = Agent(
        comm,
        AgentOptions(host_id=args.host_id, work_dir=args.working_dir or ""),
    )
    print(f"agent for host {args.host_id} polling {args.api_server}", flush=True)
    idle_sleep = agent.options.min_poll_interval_s
    while True:
        # the pull long-polls on the server's dispatch hub: an idle fleet
        # parks on condition waits instead of re-polling; the backoff
        # sleep below is the breather between parks
        tid = agent.run_once(wait_s=agent.options.poll_wait_s)
        if tid:
            print(f"completed task {tid}", flush=True)
            idle_sleep = agent.options.min_poll_interval_s
        else:
            if getattr(comm, "should_exit", False):
                print("the server asked this agent to exit", flush=True)
                return 0
            if args.once:
                return 0
            _time.sleep(idle_sleep)
            idle_sleep = min(idle_sleep * 2, agent.options.max_poll_interval_s)


def cmd_agent_monitor(args) -> int:
    """Supervise an agent process, respawning on crashes (reference
    operations/agent_monitor.go)."""
    from .agent.monitor import AgentMonitor

    AgentMonitor(
        host_id=args.host_id,
        api_server=args.api_server,
        working_dir=args.working_dir,
        max_respawns=args.max_respawns,
        host_secret=args.host_secret,
    ).run()
    return 0


def cmd_validate(args) -> int:
    """Validate a project file (reference operations/validate.go)."""
    from .ingestion.validator import LEVEL_ERROR, validate_project

    text = open(args.file).read()
    issues = validate_project(None, text)
    for issue in issues:
        print(f"{issue.level}: {issue.message}")
    if any(i.level == LEVEL_ERROR for i in issues):
        return 1
    print("valid" if not issues else "valid with warnings")
    return 0


def cmd_list(args) -> int:
    """List tasks / variants / task groups of a local file (matrices
    expanded), or the server's distros / projects (reference
    operations/list.go)."""
    if args.file:
        from .ingestion.matrix import expand_matrices
        from .ingestion.parser import parse_project

        pp = parse_project(open(args.file).read())
        expand_matrices(pp)
        if args.tasks:
            for t in pp.tasks:
                print(t.name)
        elif args.variants:
            for bv in pp.buildvariants:
                print(f"{bv.name}\t{bv.display_name or bv.name}")
        elif args.task_groups:
            for g in pp.task_groups:
                print(f"{g.name}\t(max_hosts={g.max_hosts})")
        else:
            print("choose one of --tasks/--variants/--task-groups "
                  "with --file", file=sys.stderr)
            return 2
        return 0
    call = _client(args)
    if args.distros or args.projects:
        path = "/rest/v2/distros" if args.distros else "/rest/v2/projects"
        out = call("GET", path)
        if not isinstance(out, list):  # auth or error body
            print(json.dumps(out), file=sys.stderr)
            return 1
        for d in out:
            print(d["_id"])
        return 0
    print("need --file or one of --distros/--projects", file=sys.stderr)
    return 2


def cmd_evaluate(args) -> int:
    """Render the fully-parsed project — matrices expanded, tags intact
    (reference operations/evaluate.go)."""
    import dataclasses as _dc

    import yaml as _yaml

    from .ingestion.matrix import expand_matrices
    from .ingestion.parser import parse_project

    pp = parse_project(open(args.file).read())
    expand_matrices(pp)
    doc = _dc.asdict(pp)
    if args.tasks:
        doc = {"tasks": doc["tasks"]}
    elif args.variants:
        doc = {"buildvariants": doc["buildvariants"]}
    print(_yaml.safe_dump(doc, sort_keys=False, default_flow_style=False))
    return 0


def cmd_patch(args) -> int:
    """Create (and optionally finalize) a patch (reference
    operations/patch.go)."""
    call = _client(args)
    body = {
        "project": args.project,
        "description": args.description,
        "author": args.author,
        "githash": args.githash,
        "variants": args.variants.split(",") if args.variants else ["*"],
        "tasks": args.tasks.split(",") if args.tasks else ["*"],
        "config_yaml": open(args.config).read() if args.config else "",
        "finalize": args.finalize,
    }
    out = call("POST", "/rest/v2/patches", body)
    print(json.dumps(out, indent=2))
    return 0


def cmd_patch_list(args) -> int:
    """List recent patches (reference operations/patch_list.go)."""
    from urllib.parse import quote

    call = _client(args)
    path = "/rest/v2/patches"
    if args.project:
        path += f"?project={quote(args.project)}"
    out = call("GET", path)
    if not isinstance(out, list):
        print(json.dumps(out), file=sys.stderr)
        return 1
    for p in out:
        status = p.get("status", "")
        print(f"{p['_id']}\t{p.get('project', '')}\t{status}"
              f"\t{p.get('description', '')[:60]}")
    return 0


def cmd_patch_cancel(args) -> int:
    """Cancel a patch: abort its in-flight tasks and deactivate the rest
    (reference operations/patch_cancel.go)."""
    call = _client(args)
    out = call("POST", f"/rest/v2/patches/{args.patch_id}/cancel")
    print(json.dumps(out, indent=2))
    return 1 if isinstance(out, dict) and "error" in out else 0


def cmd_patch_finalize(args) -> int:
    """Finalize an unfinalized patch into a runnable version (reference
    operations/patch_finalize.go)."""
    call = _client(args)
    out = call("POST", f"/rest/v2/patches/{args.patch_id}/finalize")
    print(json.dumps(out, indent=2))
    return 1 if isinstance(out, dict) and "error" in out else 0


def cmd_login(args) -> int:
    """Password login against the service; prints the session token
    (reference operations/login.go against the naive manager)."""
    import getpass

    call = _client(args)
    password = args.password or getpass.getpass("password: ")
    out = call("POST", "/login",
               {"username": args.username, "password": password})
    if "token" in out:
        print(out["token"])
        return 0
    print(json.dumps(out), file=sys.stderr)
    return 1


def cmd_subscriptions(args) -> int:
    """List / delete notification subscriptions (reference
    operations/subscriptions.go over the REST routes)."""
    call = _client(args)
    if args.action == "list":
        out = call("GET", "/rest/v2/subscriptions")
        if not isinstance(out, list):
            print(json.dumps(out), file=sys.stderr)
            return 1
        for s in out:
            print(f"{s['_id']}\t{s.get('resource_type', '')}"
                  f"\t{s.get('trigger', '')}\t{s.get('subscriber_type', '')}"
                  f"\t{s.get('subscriber_target', '')}")
        return 0
    out = call("DELETE", f"/rest/v2/subscriptions/{args.sub_id}")
    print(json.dumps(out))
    return 1 if isinstance(out, dict) and "error" in out else 0


def cmd_keys(args) -> int:
    """Manage SSH public keys (reference operations/keys.go)."""
    call = _client(args)
    auth = {"user": args.user} if args.user else {}
    if args.action == "list":
        out = call("GET", "/rest/v2/keys", auth or None)
        if not isinstance(out, list):
            print(json.dumps(out), file=sys.stderr)
            return 1
        for k in out:
            print(f"{k['name']}\t{k['key'][:60]}")
        return 0
    if args.action == "add":
        if args.key:
            key_text = args.key
        elif args.file:
            with open(args.file) as fh:
                key_text = fh.read().strip()
        else:
            print("keys add needs --key or --file", file=sys.stderr)
            return 2
        out = call("POST", "/rest/v2/keys",
                   {"name": args.name, "key": key_text, **auth})
    else:  # delete
        from urllib.parse import quote

        out = call("DELETE", f"/rest/v2/keys/{quote(args.name)}",
                   auth or None)
    print(json.dumps(out))
    return 1 if isinstance(out, dict) and "error" in out else 0


def cmd_user(args) -> int:
    """Create users / grant roles (the auth bootstrap; reference admin
    user management)."""
    from .models import user as user_mod
    from .storage.store import global_store

    store = global_store()
    if args.action == "create":
        u = user_mod.create_user(
            store, args.user_id, roles=args.roles.split(",") if args.roles else []
        )
        print(json.dumps({"user": u.id, "api_key": u.api_key,
                          "roles": u.roles}, indent=2))
    elif args.action == "grant":
        if not user_mod.grant_role(store, args.user_id, args.roles):
            print("no such user", file=sys.stderr)
            return 1
        print("granted")
    return 0


def cmd_version(args) -> int:
    from . import __version__

    print(f"evergreen-tpu {__version__}")
    return 0


def cmd_admin(args) -> int:
    """Read every config section, or set one service flag (reference
    operations/admin.go over ``/rest/v2/admin/settings``). As in the JAX
    package it prints the server's answer and exits 0, an error answer
    (a non-superuser's 403) included."""
    call = _client(args)
    if args.action == "get":
        print(json.dumps(call("GET", "/rest/v2/admin/settings"), indent=2))
    elif args.action == "set-flag":
        out = call(
            "POST",
            "/rest/v2/admin/settings",
            {"service_flags": {args.flag: args.value.lower() == "true"}},
        )
        print(json.dumps(out))
    return 0


def cmd_status(args) -> int:
    call = _client(args)
    if not args.watch:
        print(json.dumps(call("GET", "/rest/v2/status"), indent=2))
        return 0
    # polling loop on ONE client: after the first answer every
    # unchanged poll is a conditional GET the server 304s from its
    # fingerprint ETag cache — the CLI exercises the path the
    # scrape-storm bench proves (--watch-count bounds it for scripts)
    n = 0
    while True:
        print(json.dumps(call("GET", "/rest/v2/status"), indent=2))
        n += 1
        if args.watch_count and n >= args.watch_count:
            return 0
        _time.sleep(args.watch)


def cmd_last_green(args) -> int:
    """Most recent successful version for the given variants (reference
    operations/last_green.go)."""
    from urllib.parse import quote, urlencode

    call = _client(args)
    out = call(
        "GET",
        f"/rest/v2/projects/{quote(args.project, safe='')}/last_green"
        f"?{urlencode({'variants': args.variants})}",
    )
    print(json.dumps(out, indent=2))
    return 0 if "error" not in out else 1


def cmd_fetch(args) -> int:
    """Download a task's source config and/or artifacts into a directory
    (reference operations/fetch.go; source here is the version's resolved
    project config + revision metadata — there is no git remote to clone
    in this deployment, the config IS the build recipe)."""
    import os
    import shutil
    import urllib.request
    from urllib.parse import quote

    call = _client(args)
    if not (args.source or args.artifacts):
        print("nothing to do: pass --source and/or --artifacts",
              file=sys.stderr)
        return 1
    task_path = quote(args.task, safe="")
    task = call("GET", f"/rest/v2/tasks/{task_path}")
    if "error" in task:
        print(json.dumps(task), file=sys.stderr)
        return 1
    dest = os.path.join(
        args.dir, f"{task.get('display_name', args.task)}-{args.task}"
    )
    os.makedirs(dest, exist_ok=True)

    if args.source:
        version = call(
            "GET",
            f"/rest/v2/versions/{quote(task.get('version', ''), safe='')}",
        )
        if "error" in version:
            print(f"cannot fetch source: {json.dumps(version)}",
                  file=sys.stderr)
            return 1
        with open(os.path.join(dest, "evergreen.yml"), "w") as f:
            f.write(version.get("config_yaml", ""))
        meta = {
            k: version.get(k)
            for k in ("project", "revision", "revision_order_number",
                      "requester", "message", "author")
        }
        meta["task"] = args.task
        with open(os.path.join(dest, "METADATA.json"), "w") as f:
            json.dump(meta, f, indent=2)
        print(f"source -> {dest}")

    if args.artifacts:
        files = call("GET", f"/rest/v2/tasks/{task_path}/artifacts")
        if isinstance(files, dict) and "error" in files:
            print(f"cannot list artifacts: {json.dumps(files)}",
                  file=sys.stderr)
            return 1
        n = 0
        for entry in files if isinstance(files, list) else []:
            link, name = entry.get("link", ""), entry.get("name", "file")
            target = os.path.join(dest, os.path.basename(name) or "file")
            try:
                if link.startswith(("http://", "https://")):
                    with urllib.request.urlopen(link, timeout=30) as r, open(
                        target, "wb"
                    ) as f:
                        shutil.copyfileobj(r, f)
                elif os.path.exists(link):  # in-image pail/S3 bucket seam
                    shutil.copy(link, target)
                else:
                    print(f"skip {name}: unreachable link {link!r}",
                          file=sys.stderr)
                    continue
                n += 1
            except OSError as e:
                print(f"skip {name}: {e}", file=sys.stderr)
        print(f"{n} artifact(s) -> {dest}")
    return 0


def cmd_host(args) -> int:
    """A user's spawn hosts (reference operations/host.go)."""
    call = _client(args)
    a = args.action
    if a == "spawn":
        out = call("POST", "/rest/v2/hosts", {
            "user": args.user, "distro": args.distro,
            "no_expiration": args.no_expiration,
        })
    elif a == "list":
        hosts = call("GET", "/rest/v2/hosts")
        if args.user and isinstance(hosts, list):
            hosts = [h for h in hosts if h.get("started_by") == args.user]
        out = hosts
    elif a in ("start", "stop", "terminate"):
        out = call("POST", f"/rest/v2/hosts/{args.id}/{a}",
                   {"user": args.user})
    else:  # extend
        out = call("POST", f"/rest/v2/hosts/{args.id}/extend_expiration",
                   {"hours": args.hours})
    print(json.dumps(out, indent=2))
    return 0 if not (isinstance(out, dict) and "error" in out) else 1


def cmd_volume(args) -> int:
    """A user's volumes (reference operations/host.go volume commands)."""
    call = _client(args)
    a = args.action
    if a == "create":
        out = call("POST", "/rest/v2/volumes",
                   {"user": args.user, "size_gb": args.size_gb})
    elif a == "list":
        from urllib.parse import urlencode

        q = f"?{urlencode({'user': args.user})}" if args.user else ""
        out = call("GET", f"/rest/v2/volumes{q}")
    elif a == "attach":
        out = call("POST", f"/rest/v2/volumes/{args.id}/attach",
                   {"host": args.host})
    elif a == "detach":
        out = call("POST", f"/rest/v2/volumes/{args.id}/detach", {})
    else:  # delete
        out = call("DELETE", f"/rest/v2/volumes/{args.id}")
    print(json.dumps(out, indent=2))
    return 0 if not (isinstance(out, dict) and "error" in out) else 1


def _client(args):
    """A JSON caller of ``args.api_server``: an HTTP error's JSON body is
    the answer, and a GET's ETag is sent back on the next GET of the same
    path (a 304 serves the kept copy). With ``--api-key`` each request
    carries the ``Api-User`` and ``Api-Key`` headers."""
    import urllib.error
    import urllib.request

    from .utils.etagcache import ClientEtagCache

    etags = ClientEtagCache()
    creds = {}
    if getattr(args, "api_key", ""):
        creds = {"Api-User": args.api_user, "Api-Key": args.api_key}

    def call(method: str, path: str, body: Optional[dict] = None) -> dict:
        validator = etags.validator(path) if method == "GET" else None
        headers = {"Content-Type": "application/json", **creds}
        if validator is not None:
            headers["If-None-Match"] = validator
        req = urllib.request.Request(
            f"{args.api_server}{path}",
            data=json.dumps(body or {}).encode() if body is not None else None,
            method=method,
            headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = json.loads(resp.read() or b"{}")
                etag = resp.headers.get("ETag")
                if method == "GET" and etag:
                    etags.store(path, etag, payload)
                return payload
        except urllib.error.HTTPError as e:
            if e.code == 304:
                served = etags.serve(path)
                if served is not None:
                    return served
            # 4xx/5xx with a JSON body is a protocol answer the command
            # should print, not a stack trace
            try:
                return json.loads(e.read() or b"{}")
            except json.JSONDecodeError:
                return {"error": f"HTTP {e.code}"}

    return call


#: the commands that run on the card, and so probe it first
PROBED = ("service", "solver")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="evergreen_tpu_torch",
        description="The scheduler's device half on a CUDA card.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    so = sub.add_parser("solver", help="run the CUDA solver sidecar")
    so.add_argument("--host", default="127.0.0.1")
    so.add_argument("--port", type=int, default=9091)
    so.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)",
    )
    so.set_defaults(fn=cmd_solver)
    sv = sub.add_parser(
        "service", help="run the service (REST agent surface and job plane), "
                        "or with --shards the process-per-shard fleet")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=9090,
                    help="REST port (0: any free port; the listening line "
                         "names it)")
    sv.add_argument("--workers", type=int, default=None,
                    help="job-queue workers (default: amboy config section)")
    sv.add_argument("--require-auth", action="store_true",
                    help="require API keys on user routes and host "
                         "credentials on agent routes")
    sv.add_argument("--rate-limit", type=int, default=None,
                    help="requests/min per user (0 = force-unlimited; "
                         "default: the rate_limit config section)")
    sv.add_argument("--github-webhook-secret", default="",
                    help="HMAC secret for /hooks/github (overrides the "
                         "stored api config section)")
    sv.add_argument("--shards", type=int, default=0)
    sv.add_argument("--data-dir", default="",
                    help="durable WAL+snapshot data directory (default: "
                         "in-memory store); required with --shards and "
                         "--replica-of")
    sv.add_argument("--replica-of", default="",
                    help="run as a read replica tailing --data-dir's WAL: "
                         "reads serve locally, writes forward to this "
                         "primary URL (503 with its URL if unreachable)")
    sv.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)",
    )
    sv.set_defaults(fn=cmd_service)
    ag = sub.add_parser("agent", help="run a worker agent")
    ag.add_argument("--host-id", required=True)
    ag.add_argument("--host-secret", default="")
    ag.add_argument("--api-server", default="http://127.0.0.1:9090")
    ag.add_argument("--working-dir", default="")
    ag.add_argument("--once", action="store_true",
                    help="exit when the queue is empty")
    ag.set_defaults(fn=cmd_agent)
    am = sub.add_parser("agent-monitor", help="supervise an agent process")
    am.add_argument("--host-id", required=True)
    am.add_argument("--host-secret", default="")
    am.add_argument("--api-server", default="http://127.0.0.1:9090")
    am.add_argument("--working-dir", default="")
    am.add_argument("--max-respawns", type=int, default=0)
    am.set_defaults(fn=cmd_agent_monitor)

    def server_args(sp):
        sp.add_argument("--api-server", default="http://127.0.0.1:9090")
        sp.add_argument("--api-user", default="")
        sp.add_argument("--api-key", default="")

    v = sub.add_parser("validate", help="validate a project config file")
    v.add_argument("file")
    v.set_defaults(fn=cmd_validate)
    pa = sub.add_parser("patch", help="create a patch build")
    pa.add_argument("--project", required=True)
    pa.add_argument("--description", default="")
    pa.add_argument("--author", default="")
    pa.add_argument("--githash", default="")
    pa.add_argument("--variants", default="")
    pa.add_argument("--tasks", default="")
    pa.add_argument("--config", default="")
    pa.add_argument("--finalize", action="store_true")
    server_args(pa)
    pa.set_defaults(fn=cmd_patch)
    li = sub.add_parser("list", help="list tasks/variants/distros/projects")
    li.add_argument("--file", default="", help="local project file")
    li.add_argument("--tasks", action="store_true")
    li.add_argument("--variants", action="store_true")
    li.add_argument("--task-groups", action="store_true", dest="task_groups")
    li.add_argument("--distros", action="store_true")
    li.add_argument("--projects", action="store_true")
    server_args(li)
    li.set_defaults(fn=cmd_list)
    ev = sub.add_parser("evaluate",
                        help="render the parsed project (matrices expanded)")
    ev.add_argument("file")
    ev.add_argument("--tasks", action="store_true")
    ev.add_argument("--variants", action="store_true")
    ev.set_defaults(fn=cmd_evaluate)
    pl = sub.add_parser("patch-list", help="list recent patches")
    pl.add_argument("--project", default="")
    server_args(pl)
    pl.set_defaults(fn=cmd_patch_list)
    pc = sub.add_parser("patch-cancel", help="cancel a patch")
    pc.add_argument("patch_id")
    server_args(pc)
    pc.set_defaults(fn=cmd_patch_cancel)
    pf = sub.add_parser("patch-finalize", help="finalize a patch")
    pf.add_argument("patch_id")
    server_args(pf)
    pf.set_defaults(fn=cmd_patch_finalize)
    lo = sub.add_parser("login", help="password login; prints session token")
    lo.add_argument("--username", required=True)
    lo.add_argument("--password", default="")
    lo.add_argument("--api-server", default="http://127.0.0.1:9090")
    lo.set_defaults(fn=cmd_login)
    ke = sub.add_parser("keys", help="manage SSH public keys")
    ke.add_argument("action", choices=["list", "add", "delete"])
    ke.add_argument("--name", default="")
    ke.add_argument("--key", default="", help="key text (or use --file)")
    ke.add_argument("--file", default="", help="read key from file")
    ke.add_argument("--user", default="",
                    help="acting user (dev mode without auth)")
    server_args(ke)
    ke.set_defaults(fn=cmd_keys)
    su = sub.add_parser("subscriptions", help="list/delete subscriptions")
    su.add_argument("action", choices=["list", "delete"])
    su.add_argument("--sub-id", default="", dest="sub_id")
    server_args(su)
    su.set_defaults(fn=cmd_subscriptions)
    lg = sub.add_parser(
        "last-green",
        help="most recent successful version for given variants",
    )
    lg.add_argument("--project", required=True)
    lg.add_argument("--variants", required=True,
                    help="comma-separated buildvariant names")
    server_args(lg)
    lg.set_defaults(fn=cmd_last_green)
    fe = sub.add_parser("fetch",
                        help="download a task's source and/or artifacts")
    fe.add_argument("--task", required=True)
    fe.add_argument("--dir", default=".")
    fe.add_argument("--source", action="store_true")
    fe.add_argument("--artifacts", action="store_true")
    server_args(fe)
    fe.set_defaults(fn=cmd_fetch)
    st = sub.add_parser("status", help="service status")
    st.add_argument("--watch", type=float, default=0.0,
                    help="poll every N seconds (conditional GETs: "
                         "unchanged polls are served 304)")
    st.add_argument("--watch-count", type=int, default=0,
                    help="stop after N polls (0 = forever)")
    server_args(st)
    st.set_defaults(fn=cmd_status)
    ho = sub.add_parser("host", help="spawn-host lifecycle")
    ho.add_argument("action",
                    choices=["spawn", "list", "start", "stop", "terminate",
                             "extend"])
    ho.add_argument("--id", default="")
    ho.add_argument("--distro", default="")
    ho.add_argument("--user", default="")
    ho.add_argument("--hours", type=float, default=0.0)
    ho.add_argument("--no-expiration", action="store_true")
    server_args(ho)
    ho.set_defaults(fn=cmd_host)
    vo = sub.add_parser("volume", help="volume management")
    vo.add_argument("action",
                    choices=["create", "list", "attach", "detach", "delete"])
    vo.add_argument("--id", default="")
    vo.add_argument("--user", default="")
    vo.add_argument("--host", default="")
    vo.add_argument("--size-gb", type=int, default=0)
    server_args(vo)
    vo.set_defaults(fn=cmd_volume)
    ve = sub.add_parser("version", help="print the version")
    ve.set_defaults(fn=cmd_version)
    ad = sub.add_parser("admin", help="admin settings")
    ad.add_argument("action", choices=["get", "set-flag"])
    ad.add_argument("--flag", default="")
    ad.add_argument("--value", default="true")
    server_args(ad)
    ad.set_defaults(fn=cmd_admin)
    us = sub.add_parser("user", help="create users / grant roles")
    us.add_argument("action", choices=["create", "grant"])
    us.add_argument("user_id")
    us.add_argument("--roles", default="", help="comma-separated (create) or one role (grant)")
    us.set_defaults(fn=cmd_user)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # a replica service has no device work: it never probes the card
    if args.cmd in PROBED and not getattr(args, "replica_of", ""):
        from .utils.torchenv import ensure_usable_backend

        ensure_usable_backend(device=args.device)
    return args.fn(args)
