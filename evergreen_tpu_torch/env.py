"""Unified Environment — the one place the service's subsystems are wired.

A copy of ``evergreen_tpu/env.py`` (reference environment.go:233
``NewEnvironment``): ``Environment.build`` picks the store (caller-
supplied, the in-memory global store, or a durable writer under a
renewing ``FileLease``), runs the migrations, wires the log sinks when
it owns the process's writable store, runs the recovery pass for a
durable writer, and starts the job plane (``JobQueue`` sized by
``AmboyConfig.pool_size_local`` unless ``workers`` is given, and
``units/crons.py::build_cron_runner``). ``close`` tears it down in
reverse order and releases the lease.

Departures from the JAX package:

- the device is an argument: ``build(device=None)`` runs the tick job on
  the CUDA card and raises without one; ``device="cpu"`` runs it on the
  CPU. On the card the build probes the backend in a fresh interpreter
  (``utils/torchenv.py``), starts CUDA and builds and loads both kernels
  before the job plane starts, so the first cron tick's solve pays no
  build inside its deadline;
- ``api`` stays None (the REST surface is not ported), and with it the
  accessors that read it (``user_manager``, ``reload_user_manager``,
  ``dispatcher``), the follower-read replica and the build's REST
  options (``require_auth``, ``rate_limit``, ``webhook_secret``); the
  build's ``with_job_plane`` and ``on_lease_lost`` options, which no
  caller of the port sets, are left out too;
- ``replica_of`` raises ``ValueError``: ``storage/replica.py`` is not
  ported (and with it ``is_replica``);
- ``host_transport()`` resolves the store's transport; the JAX
  package's passes ``get_transport`` a distro it does not take, and
  raises.

``boot_ms`` holds the build's split in wall ms: ``lease``,
``open_replay``, ``migrations``, ``recovery``, and on the card ``probe``
and ``kernels`` (CUDA's start and the kernels' build and load).
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, Optional

from .storage.store import Store


@dataclasses.dataclass
class Environment:
    store: Store
    #: the REST surface (not ported: always None)
    api: object = None
    #: background job plane (worker pool; scope-locked jobs)
    queue: object = None
    #: cron populator runner (units/crons.build_cron_runner)
    cron_runner: object = None
    #: writer lease when running durable (None for in-memory)
    lease: object = None
    #: what the startup reconciliation pass healed (durable writers only;
    #: scheduler/recovery.py RecoveryReport)
    recovery_report: object = None
    #: the migrations this build applied: [(name, result)]
    migrations: list = dataclasses.field(default_factory=list)
    #: the device the tick job runs on
    device: object = None
    #: wall ms of each step of the build
    boot_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    _closers: list = dataclasses.field(default_factory=list)

    # -- reference Environment accessors -------------------------------- #

    def settings(self, section_cls):
        """Live config section (reference env.Settings() + GetConfig)."""
        return section_cls.get(self.store)

    @property
    def tick_cache(self):
        """Incremental scheduler gather cache for this store."""
        from .scheduler.wrapper import tick_cache_for

        return tick_cache_for(self.store)

    def tracer(self, component: str):
        from .utils.tracing import Tracer

        return Tracer(self.store, component)

    def host_transport(self):
        """Host control-plane transport (reference env.JasperManager());
        resolved live so ssh config edits apply without restart."""
        from .cloud.provisioning import get_transport

        return get_transport(self.store)

    # -- lifecycle ------------------------------------------------------- #

    def close(self) -> None:
        """Tear down in reverse construction order."""
        if self.cron_runner is not None:
            self.cron_runner.stop()
        if self.queue is not None:
            self.queue.close()
        for fn in reversed(self._closers):
            fn()

    # -- construction ---------------------------------------------------- #

    @classmethod
    def build(
        cls,
        data_dir: str = "",
        replica_of: str = "",
        workers: Optional[int] = None,
        store: Optional[Store] = None,
        device=None,
    ) -> "Environment":
        """The single composition root (reference NewEnvironment,
        environment.go:233): pick the store (durable writer / in-memory /
        caller-supplied), run migrations, wire logging, and the
        background job plane on ``device``."""
        from .device import resolve_device
        from .storage.store import global_store, set_global_store

        if replica_of:
            raise ValueError(
                "replica_of: the WAL-tailing replica (storage/replica.py) "
                "is not ported to evergreen_tpu_torch"
            )
        dev = resolve_device(device)
        boot: Dict[str, float] = {}
        lease = None
        env_store_supplied = store is not None
        closers: list = []
        if env_store_supplied:
            # caller-supplied store (smoke harness, tests): no global
            # registration, no lease — just the composition
            pass
        elif data_dir:
            # durable writer: WAL + snapshot engine behind a renewing
            # lease so a standby can take over the data dir if we die.
            # The store binds to the lease's fencing epoch at open; a
            # steal observed later fences every further write
            # (storage/durable.py EpochFencedError).
            import os as _os

            from .storage.durable import DurableStore
            from .storage.lease import FileLease

            t0 = _time.perf_counter()
            lease = FileLease(_os.path.join(data_dir, "writer.lease"))
            lease.acquire()

            def _deposed():  # pragma: no cover — split-brain guard
                import sys as _sys

                print(
                    "writer lease lost — terminating to avoid split-brain",
                    file=_sys.stderr, flush=True,
                )
                _os._exit(70)

            # renewing starts BEFORE the store opens: a WAL replay longer
            # than the ttl must not let a standby steal the lease out
            # from under a booting writer
            lease.start_renewing(on_lost=_deposed)
            boot["lease"] = (_time.perf_counter() - t0) * 1e3
            t0 = _time.perf_counter()
            try:
                store = DurableStore(data_dir, lease=lease)
            except BaseException:
                lease.release()
                raise
            boot["open_replay"] = (_time.perf_counter() - t0) * 1e3
            set_global_store(store)
            closers.append(lease.release)
            closers.append(store.close)
        else:
            store = global_store()

        owns_global_writable = not env_store_supplied
        from .storage.migrations import apply_migrations

        t0 = _time.perf_counter()
        migrations = apply_migrations(store)
        boot["migrations"] = (_time.perf_counter() - t0) * 1e3
        for name, result in migrations:
            # quiet for caller-supplied stores (the smoke harness owns
            # its own verbosity)
            if not env_store_supplied:
                print(f"migration {name}: {result}")

        # structured logging plane: JSON lines + capped in-store ring.
        # ONLY when this build owns the process's writable global store:
        # a caller-supplied private store (smoke, tests) must not hijack
        # process-global logging.
        if owns_global_writable:
            from .utils import log as log_mod

            log_mod.reset_sinks(
                log_mod.json_line_sink, log_mod.StoreSink(store)
            )
            log_mod.configure(store)

        # startup reconciliation: a durable writer (fresh boot OR a
        # standby that just stole the lease) heals derived state BEFORE
        # the job plane starts, so the first tick plans against
        # reconciled truth
        recovery_report = None
        if lease is not None:
            from .scheduler.recovery import run_recovery_pass

            t0 = _time.perf_counter()
            recovery_report = run_recovery_pass(store)
            boot["recovery"] = (_time.perf_counter() - t0) * 1e3

        if dev.type == "cuda":
            # the card before the job plane: a fresh interpreter must see
            # it, then CUDA starts here and both kernels build and load,
            # so the first tick job's solve pays neither inside its
            # deadline
            import torch

            from .ops import distro_stats, segment
            from .utils.torchenv import ensure_usable_backend

            t0 = _time.perf_counter()
            ensure_usable_backend()
            boot["probe"] = (_time.perf_counter() - t0) * 1e3
            t0 = _time.perf_counter()
            torch.zeros(1, device=dev)
            distro_stats._launch_fn()
            segment._launch_fn()
            boot["kernels"] = (_time.perf_counter() - t0) * 1e3

        env = cls(
            store=store, lease=lease, recovery_report=recovery_report,
            migrations=migrations, device=dev, boot_ms=boot,
            _closers=closers,
        )
        from .queue.jobs import JobQueue
        from .units.crons import build_cron_runner

        if workers is None:
            from .settings import AmboyConfig

            workers = AmboyConfig.get(store).pool_size_local
        env.queue = JobQueue(store, workers=workers)
        env.cron_runner = build_cron_runner(store, env.queue, device=dev)
        return env

