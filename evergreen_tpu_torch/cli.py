"""Command line of the port, ``python -m evergreen_tpu_torch <cmd>``:

    solver  [--host] [--port] [--device cpu]
            the solver sidecar (``api/sidecar.py``)
    service --shards N --data-dir D [--device cpu]
            the process-per-shard fleet (``runtime/supervisor.py``): a
            supervisor in this process, one shard worker process per
            shard, rounds on the 15 s cadence, the solver leader elected
            by ``ShardingConfig.solver_leader``; SIGTERM or SIGINT drains
            the fleet and releases every lease

Both run on the CUDA card; without a card they exit with an error unless
``--device cpu`` is given. Before either starts, the backend probe
(``utils/torchenv.py::ensure_usable_backend``) checks the card in a fresh
interpreter, so a card that hangs or is missing fails the command at
once. The JAX package's ``service`` also serves the REST API (and, with
``--shards``, its admin fleet surface); the port has no REST API yet, so
``service`` waits for the signal where JAX serves requests. The classic
single-store service (``service`` without ``--shards``) is not ported
and fails with a message that says so.
"""
from __future__ import annotations

import argparse
import sys
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
    """The process-per-shard service: the counterpart of the JAX
    package's ``_cmd_service_fleet`` (``evergreen_tpu/cli.py``)."""
    import signal
    import threading

    from .runtime.supervisor import FleetSupervisor
    from .settings import ShardingConfig
    from .storage.durable import DurableStore
    from .utils.retry import RetryPolicy

    if not args.shards:
        print("the single-store service is not ported to evergreen_tpu_torch; "
              "run the process-per-shard fleet with --shards N --data-dir D",
              file=sys.stderr)
        return 2
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
    print(f"acquiring fleet lease, then adopting/spawning {args.shards} shard "
          f"workers over {args.data_dir} ...", flush=True)
    stop = threading.Event()

    def on_signal(signum, frame):
        print(f"received signal {signum} — draining before exit ...",
              file=sys.stderr, flush=True)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
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
        stop.wait()
    finally:
        print("draining fleet (flush WAL groups, release shard leases, reap "
              "workers) ...", file=sys.stderr, flush=True)
        sup.stop(graceful=True)
    return 0


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
    sv = sub.add_parser("service", help="run the process-per-shard fleet")
    sv.add_argument("--shards", type=int, default=0)
    sv.add_argument("--data-dir", default="")
    sv.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)",
    )
    sv.set_defaults(fn=cmd_service)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.torchenv import ensure_usable_backend

    ensure_usable_backend(device=args.device)
    return args.fn(args)
