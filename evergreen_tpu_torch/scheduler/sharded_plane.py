"""Sharded control plane: N scheduler shards, one fleet, one tick round.

A copy of the in-process plane of ``evergreen_tpu/scheduler/
sharded_plane.py``. Distros partition across N shard stores by
consistent hash (``parallel/topology.py``); each shard keeps its own
TickCache, persister state, resident plane and overload ladder (all per
store already) and runs the unchanged ``run_tick`` over its subset,
concurrently with its siblings on a worker pool of one thread per shard.
One fleet intent budget is split across the shards, and each shard gets
1/N of the capacity quotas.

**Stacked round.** When the plane stacks, each shard's tick registers
its packed snapshot at a round barrier (``TickOptions.solve_fn``) and
the last shard to arrive runs ONE stacked solve over every shard's
blocks (``parallel/sharded.py::StackedSolveCache``) on the plane's
device; every shard then unpacks its own block. Shards whose padded dims
drift apart solve locally for that round while the common dims are
re-seeded as every shard's floor (``TickOptions.force_dims``), so the
next round stacks again. A barrier timeout, a shard leaving before its
solve, or shape drift falls back to local per-shard solves. Unlike the
JAX package, a kernel or mirror fault on the card (``KernelError``,
``MirrorError``) in the stacked solve is not downgraded: it raises out
of every waiting shard's tick and out of ``ShardedScheduler.tick()``.

**When it stacks** (``_use_stacked``): never with ``stacked="never"`` or
fewer than two shards; with ``"auto"`` when the device count (the CUDA
card count on the card, 1 on the CPU) reaches the shard count, as the
JAX package counts ``jax.devices()``; with ``"always"`` whatever the
count. That last is the one departure from the JAX package, which puts
one block per device with ``shard_map`` and so solves locally with too
few devices: on one card the stacked solve runs every block back to
back, and ``"always"`` runs it there.

**Cross-shard rebalancing.** After each round the plane compares the
shards' overload ladders: a shard at YELLOW or worse with a GREEN
sibling migrates one distro affinity group over a fenced handoff —
*release* (the source writes a ``shard_handoffs`` record with the full
document payload and deletes the group's documents), *prime* (the
target upserts the payload and its own ``primed`` record), *done* (the
source marks its record). A failure between the legs heals in process
(``reconcile_handoffs``). The fleet fuse (``utils/overload.py::
fuse_level``) over the shards' levels is set as a floor on an attached
front store's ladder every round.

**Durable fleet.** ``build(n, data_dir=...)`` opens one
``DurableStore`` per shard in one directory, each journaling to its own
WAL segment (``wal.shard<k>.log``) under its own lease
(``writer.shard<k>.lease``); a fleet that fails to open part-way
releases what it took. ``open_fleet`` reopens (recovers) such a fleet
and reconciles handoffs caught mid-flight; ``close()`` closes the
durable shard stores (final commit and checkpoint) and releases their
leases. The release and prime legs each commit as one WAL group, and
the shard ticks run with the round's ``TickOptions.async_persist``.

Left out, with what brings them: ``assign_next_task`` and the host routing it reads (``store_of``,
``host_shard``, ``find_host``: dispatch); the constructor's
``topology`` and ``max_handoffs_per_round`` options (the cron front
end's sharding settings), fixed here at the shard count's topology and
one handoff per round. ``ShardedScheduler(device=None)`` runs on the
CUDA card and raises without one; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses
import time as _time
import weakref
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Sequence

import torch

from ..device import resolve_device
from ..globals import MAX_INTENT_HOSTS_IN_FLIGHT, TaskStatus
from ..ops._build import KernelError
from ..ops.resident_ops import MirrorError
from ..ops.solve import run_solve_packed
from ..parallel.sharded import StackedSolveCache
from ..parallel.topology import ShardTopology
from ..storage.store import Store
from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics
from ..utils import overload as overload_mod
from ..utils.log import get_logger
from .wrapper import TickOptions, TickResult, run_tick

#: durable handoff records, one collection per shard store
HANDOFFS_COLLECTION = "shard_handoffs"

#: collections a distro's documents live in (the handoff payload set)
_DISTRO_SCOPED = ("distros", "tasks", "hosts", "task_queues",
                  "task_secondary_queues")
#: the distro-scoped collections keyed by the distro id itself (the
#: others carry it in ``distro_id``)
_DISTRO_KEYED = ("distros", "task_queues", "task_secondary_queues")

SHARD_TICK_MS = _metrics.histogram(
    "scheduler_shard_tick_duration_ms",
    "Wall time of one shard's tick inside a sharded round, labeled by "
    "shard id (bounded by the configured shard count).",
    labels=("shard",),
)
SHARD_ROUNDS = _metrics.counter(
    "scheduler_sharded_rounds_total",
    "Sharded tick rounds by solve mode: 'stacked' (one multi-device "
    "shard_map solve for every shard), 'local' (per-shard solves), or "
    "'mixed' (a mid-round fallback).",
    labels=("outcome",),
)
SHARD_HANDOFFS = _metrics.counter(
    "scheduler_shard_handoffs_total",
    "Distro handoff protocol steps by SOURCE shard and step outcome "
    "(released / primed / done / reconciled / aborted).",
    labels=("shard", "outcome"),
)
SHARD_REBALANCES = _metrics.counter(
    "scheduler_shard_rebalance_total",
    "Ladder-driven rebalancing migrations initiated, labeled by the "
    "overloaded source shard.",
    labels=("shard",),
)
SHARD_HANDOFFS_COMPACTED = _metrics.counter(
    "scheduler_shard_handoffs_compacted_total",
    "Fully-reconciled handoff record triples (released→primed→done) "
    "removed from the shard stores at compaction checkpoints, labeled "
    "by the source shard.",
    labels=("shard",),
)

#: floor for the handoff sequence counter once compaction has deleted
#: the records it was recovered from: a sentinel doc (state="watermark")
#: the ownership loader skips
HANDOFF_WATERMARK_ID = "__handoff_watermark__"


def handoff_payload(store: Store, group) -> Dict[str, List[dict]]:
    """Every distro-scoped document of ``group`` on ``store`` — the
    release leg's payload set."""
    group_set = set(group)
    payload: Dict[str, List[dict]] = {}
    for coll_name in _DISTRO_SCOPED:
        docs = store.collection(coll_name).find(
            lambda d, cn=coll_name: (
                d["_id"] in group_set if cn in _DISTRO_KEYED
                else d.get("distro_id", "") in group_set
            )
        )
        payload[coll_name] = [dict(d) for d in docs]
    return payload


def handoff_record(distro_id: str, group, src: int, dst: int,
                   seq: int, now: float,
                   payload: Dict[str, List[dict]]) -> dict:
    """The durable release record (state="released", full payload)."""
    return {
        "_id": f"ho-{distro_id}-{seq:06d}",
        "distro": distro_id,
        "group": sorted(group),
        "from": src,
        "to": dst,
        "seq": seq,
        "state": "released",
        "at": now,
        "payload": payload,
    }


def apply_release(store: Store, rec: dict) -> None:
    """Handoff leg 1: the record and the deletions in one store group
    (the ``handoff.release`` seam fires inside it)."""
    from ..utils import faults

    store.begin_tick()
    try:
        store.collection(HANDOFFS_COLLECTION).upsert(rec)
        for coll_name, docs in rec["payload"].items():
            coll = store.collection(coll_name)
            for d in docs:
                coll.remove(d["_id"])
        faults.fire("handoff.release")
    finally:
        store.end_tick()


def apply_prime(store: Store, rec: dict) -> None:
    """Handoff leg 2: the payload and the target's own 'primed' record
    in one store group (idempotent: reconciliation re-runs it)."""
    store.begin_tick()
    try:
        for coll_name, docs in rec.get("payload", {}).items():
            coll = store.collection(coll_name)
            for d in docs:
                coll.upsert(dict(d))
        store.collection(HANDOFFS_COLLECTION).upsert({
            **{k: v for k, v in rec.items() if k != "payload"},
            "state": "primed",
        })
    finally:
        store.end_tick()


def greedy_rebalance_plan(
    levels: Dict[int, int],
    loads: Dict[int, Dict[str, int]],
    round_ms: Dict[int, float],
    max_handoffs: int,
    cold_weight: Optional[Dict[int, float]] = None,
) -> List[tuple]:
    """Up to ``max_handoffs`` migrations as (src, dst, group_rep). Each
    group g on a hot (YELLOW+) shard s scores ``schedulable(g) ×
    round_ms(s)``; zero-schedulable groups never move. Targets are GREEN
    shards, coldest first (by ``cold_weight``, else their loads), each
    consumed by one pick, and at most one group leaves any source per
    pass."""
    weight = cold_weight or {}
    cold = sorted(
        (k for k, lvl in levels.items() if lvl == overload_mod.GREEN),
        key=lambda k: (
            weight.get(k, sum(loads.get(k, {}).values())), k,
        ),
    )
    candidates = sorted(
        (
            (cnt * max(round_ms.get(s, 0.0), 1.0), s, rep)
            for s, lvl in levels.items()
            if lvl >= overload_mod.YELLOW
            for rep, cnt in (loads.get(s) or {}).items()
            if cnt > 0
        ),
        key=lambda c: (-c[0], c[1], c[2]),
    )
    picks: List[tuple] = []
    moved_from: set = set()
    for _score, src, rep in candidates:
        if len(picks) >= max_handoffs or not cold:
            break
        if src in moved_from:
            continue
        dst = cold.pop(0)
        moved_from.add(src)
        picks.append((src, dst, rep))
    return picks


# --------------------------------------------------------------------------- #
# stacked round barrier
# --------------------------------------------------------------------------- #


class _StackedRound:
    """One tick round's solve barrier. Every participating shard's
    run_tick calls ``solve_for(shard_id)``; the returned callable blocks
    until every still-participating shard has registered its packed
    snapshot (the last arrival runs the ONE stacked solve and wakes the
    others with their blocks), or the round falls back to local solves
    (shape drift, a shard leaving before its solve, a timeout). A card
    fault in the stacked solve is raised to every waiting shard."""

    def __init__(self, plane: "ShardedScheduler", shard_ids: Sequence[int],
                 timeout_s: float = 30.0) -> None:
        self.plane = plane
        self.timeout_s = timeout_s
        self._cv = _lockcheck.make_condition("sharded.round_cv")
        self._participants = set(shard_ids)
        self._snaps: Dict[int, object] = {}
        self._outs: Optional[Dict[int, dict]] = None
        self._local = False  # fall back to per-shard solves
        self._leading = False  # a leader is solving OUTSIDE the lock
        #: the card fault the leader's stacked solve raised
        self._error: Optional[BaseException] = None
        self.mode = "stacked"
        #: how each shard's solve actually ran (a round can be mixed)
        self.stacked_shards: set = set()
        self.local_shards: set = set()

    def final_mode(self) -> str:
        if self.stacked_shards and self.local_shards:
            return "mixed"
        if self.stacked_shards:
            return "stacked"
        return "local"

    def leave(self, shard_id: int) -> None:
        """A shard finished its tick without reaching the solve (no
        solver distros, degraded early, serial path): it will never
        register, so waiting for it would deadlock the round."""
        with self._cv:
            self._participants.discard(shard_id)
            self._cv.notify_all()

    def _ready_locked(self) -> bool:
        waiting = self._participants & self._snaps.keys()
        return bool(waiting) and waiting == self._participants

    def _go_local_locked(self, why: str) -> None:
        if not self._local:
            self._local = True
            self.mode = "local"
            get_logger("scheduler").info(
                "sharded-round-local", reason=why,
            )

    def _try_lead_locked(self) -> Optional[Dict[int, object]]:
        """Claim leadership if every still-participating shard has
        registered, nobody leads, and the round has neither outputs nor
        a fault yet; returns the snapshots to solve, or None."""
        if (
            self._local
            or self._leading
            or self._outs is not None
            or self._error is not None
            or not self._ready_locked()
        ):
            return None
        self._leading = True
        return {k: self._snaps[k] for k in self._participants}

    def solve_for(self, shard_id: int):
        def _solve(snapshot):
            to_solve = None
            with self._cv:
                if self._error is not None:
                    raise self._error
                if self._local:
                    # already downgraded: solve locally OUTSIDE the lock,
                    # in parallel with the other stragglers
                    self.local_shards.add(shard_id)
                else:
                    self._snaps[shard_id] = snapshot
                    to_solve = self._try_lead_locked()
                    if to_solve is None and not self._leading:
                        deadline = _time.monotonic() + self.timeout_s
                        while (self._outs is None and not self._local
                               and self._error is None):
                            remaining = deadline - _time.monotonic()
                            if remaining <= 0:
                                self._go_local_locked("barrier-timeout")
                                self._cv.notify_all()
                                break
                            self._cv.wait(timeout=min(remaining, 0.5))
                            # participants may have shrunk while we
                            # waited and we are now the last: lead
                            to_solve = self._try_lead_locked()
                            if to_solve is not None:
                                break
                    if to_solve is None:
                        if self._error is not None:
                            raise self._error
                        if (
                            self._outs is not None
                            and shard_id in self._outs
                        ):
                            self.stacked_shards.add(shard_id)
                            return self._outs[shard_id]
                        self.local_shards.add(shard_id)

            if to_solve is not None:
                # LEADER: the stacked solve runs outside the barrier lock
                outs = None
                try:
                    outs = self.plane._stacked_solve(to_solve)
                except (KernelError, MirrorError) as exc:
                    # the card cannot run its kernels: every shard of the
                    # round raises it, none solves locally
                    with self._cv:
                        self._error = exc
                        self._leading = False
                        self._cv.notify_all()
                    raise
                except Exception as exc:  # noqa: BLE001 — shape drift
                    # and any other stack failure downgrade the round
                    with self._cv:
                        self._go_local_locked(repr(exc)[-200:])
                        self._leading = False
                        self._cv.notify_all()
                else:
                    with self._cv:
                        self._outs = outs
                        self._leading = False
                        self._cv.notify_all()
                if outs is not None and shard_id in outs:
                    self.stacked_shards.add(shard_id)
                    return outs[shard_id]
                self.local_shards.add(shard_id)
            # local fallback (outside the lock: the solve is the slow part)
            return run_solve_packed(snapshot, device=self.plane.device)

        return _solve


# --------------------------------------------------------------------------- #
# results
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class ShardedTickResult:
    """One fleet round: every shard's TickResult plus round metadata."""

    results: Dict[int, TickResult]
    #: "stacked" | "local" | "mixed" — how the round's solves ran
    solve_mode: str = "local"
    #: handoff records initiated by this round's rebalancing pass
    migrations: List[dict] = dataclasses.field(default_factory=list)
    total_ms: float = 0.0
    fleet_level: str = "green"

    @property
    def n_tasks(self) -> int:
        return sum(r.n_tasks for r in self.results.values())

    @property
    def n_distros(self) -> int:
        return sum(r.n_distros for r in self.results.values())

    @property
    def degraded(self) -> Dict[int, str]:
        return {
            k: r.degraded for k, r in self.results.items() if r.degraded
        }


# --------------------------------------------------------------------------- #
# the plane
# --------------------------------------------------------------------------- #


class ShardedScheduler:
    """Drives N scheduler shards over one fleet. Each shard is a Store
    whose ``shard_id`` names it; the plane owns the tick round, the
    stacked solve, ownership routing and rebalancing — everything else
    (gather, solve, persist, budgets) is the unchanged per-store tick on
    ``device``."""

    #: stacked rounds between downward floor re-probes
    _FLOOR_REPROBE_ROUNDS = 32
    #: tick rounds between handoff-record compaction checkpoints
    _COMPACT_EVERY_ROUNDS = 64
    #: distro affinity groups the rebalancer migrates per round
    _MAX_HANDOFFS_PER_ROUND = 1

    def __init__(
        self,
        stores: Sequence[Store],
        tick_opts: Optional[TickOptions] = None,
        stacked: str = "auto",
        rebalance_enabled: bool = True,
        barrier_timeout_s: float = 30.0,
        device=None,
    ) -> None:
        if not stores:
            raise ValueError("need at least one shard store")
        if stacked not in ("auto", "never", "always"):
            raise ValueError(f"stacked must be auto, never or always, not {stacked!r}")
        self.device = resolve_device(device)
        self.stores: List[Store] = list(stores)
        for k, s in enumerate(self.stores):
            if getattr(s, "shard_id", None) is None:
                s.shard_id = k
        self.n_shards = len(self.stores)
        self.topology = ShardTopology(self.n_shards)
        self.tick_opts = tick_opts or TickOptions(use_cache=True)
        self.stacked = stacked
        self.rebalance_enabled = rebalance_enabled
        self.barrier_timeout_s = barrier_timeout_s
        # one worker PER shard: a stacked round's barrier needs every
        # shard's tick in flight at once
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, self.n_shards),
            thread_name_prefix="shard-tick",
        )
        # a plane dropped without close() still stops its workers
        self._stop_pool = weakref.finalize(self, self._pool.shutdown, wait=False)
        self._lock = _lockcheck.make_lock("sharded.plane")  # serializes rounds + migrations
        self._stacked_cache = StackedSolveCache(device=self.device)
        #: the stacked round's common padded dims (a floor forced into
        #: every shard's build via TickOptions.force_dims)
        self._common_dims: Optional[Dict[str, int]] = None
        #: rounds since the floor was (re)measured: forced dims never
        #: shrink on their own, so the floor is dropped for one
        #: natural-dims round every _FLOOR_REPROBE_ROUNDS
        self._floor_rounds = 0
        #: monotone handoff sequence (recovered from the records and the
        #: compaction watermark)
        self._seq = 0
        #: completed tick rounds (drives the compaction checkpoint)
        self._rounds = 0
        #: the front store whose ladder receives the fleet fuse as a
        #: floor (attach_sharded_plane sets it)
        self.front_store: Optional[Store] = None
        self._load_handoff_state()
        self.refresh_affinity()

    def refresh_affinity(self) -> None:
        """Rebuild the alias-affinity placement map from the documents
        the shard stores hold (called at construction and before
        migrations: tasks can gain secondary distros at any time)."""
        aff: Dict[str, str] = {}
        for s in self.stores:
            aff.update(ShardTopology.affinity_from_store(s))
        self.topology.affinity = aff

    # -- construction helpers ------------------------------------------- #

    @classmethod
    def build(
        cls,
        n_shards: int,
        data_dir: Optional[str] = None,
        sync: str = "flush",
        lease_ttl_s: float = 10.0,
        **kw,
    ) -> "ShardedScheduler":
        """N in-memory shard stores, or, with ``data_dir``, N
        DurableStores sharing one directory, each journaling to its own
        WAL segment under its own lease (``kw`` goes to the
        constructor)."""
        stores: List[Store] = []
        if data_dir is None:
            for k in range(n_shards):
                s = Store()
                s.shard_id = k
                stores.append(s)
            return cls(stores, **kw)
        from ..storage.durable import DurableStore
        from ..storage.lease import FileLease, shard_lease_path

        try:
            for k in range(n_shards):
                lease = FileLease(shard_lease_path(data_dir, k), ttl_s=lease_ttl_s)
                if not lease.acquire(timeout_s=30.0, poll_s=0.1):
                    raise TimeoutError(f"could not acquire shard {k}'s lease")
                stores.append(
                    DurableStore(data_dir, sync=sync, lease=lease, shard_id=k))
        except BaseException:
            # a partial fleet must not leak: close the journals and
            # release the leases already taken, or every later opener
            # waits out their TTLs
            for s in stores:
                try:
                    s._journal.close()
                except Exception:  # noqa: BLE001 — best-effort unwind;
                    # the original failure re-raises below
                    pass
                try:
                    s._lease.release()
                except Exception:  # noqa: BLE001 — as above
                    pass
            raise
        return cls(stores, **kw)

    def seed_partition(self, source: Store) -> Dict[int, int]:
        """Split a seeded single-plane store across the shards by
        topology (alias affinity refreshed from the source first, so
        coupled distros co-locate). Returns shard → distro count."""
        self.topology.affinity.update(
            ShardTopology.affinity_from_store(source)
        )
        counts = {k: 0 for k in range(self.n_shards)}
        for coll_name in _DISTRO_SCOPED:
            for doc in source.collection(coll_name).find():
                did = (
                    doc["_id"] if coll_name in _DISTRO_KEYED
                    else doc.get("distro_id", "")
                )
                shard = self.owner_of(did)
                self.stores[shard].collection(coll_name).upsert(
                    dict(doc)
                )
                if coll_name == "distros":
                    counts[shard] += 1
        return counts

    # -- ownership routing ---------------------------------------------- #

    def owner_of(self, distro_id: str) -> int:
        """The routing owner: hash + overrides, self-healed against the
        documents' actual location (a located divergence is pinned as an
        override so the scan runs once per distro)."""
        shard = self.topology.shard_for(distro_id)
        if (
            self.stores[shard].collection("distros").get(distro_id)
            is not None
        ):
            return shard
        for k, s in enumerate(self.stores):
            if (
                k != shard
                and s.collection("distros").get(distro_id) is not None
            ):
                self.topology.overrides[distro_id] = k
                return k
        return shard  # unplaced (seeding) — the hash owner

    # -- the tick round -------------------------------------------------- #

    def _use_stacked(self) -> bool:
        """Whether this round stacks (see the module docstring): the JAX
        package's device count rule under "auto", and the stack on the
        plane's own device under "always", however many devices."""
        if self.stacked == "never" or self.n_shards < 2:
            return False
        if self.stacked == "always":
            return True
        n_dev = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        return n_dev >= self.n_shards

    def tick(
        self,
        now: Optional[float] = None,
        opts: Optional[TickOptions] = None,
    ) -> ShardedTickResult:
        """One fleet round: every shard's tick runs concurrently on the
        worker pool (through the stacked round when ``_use_stacked``),
        then the rebalancing pass migrates distros off overloaded shards.
        ``opts`` overrides the plane's TickOptions for this round. A
        shard tick that raises (a card fault) raises out of the round
        once every shard's tick has ended."""
        now = _time.time() if now is None else now
        t0 = _time.perf_counter()
        base_opts = opts or self.tick_opts
        # the barrier gives up well before any shard's own solve deadline
        barrier_s = self.barrier_timeout_s
        if base_opts.solve_deadline_s > 0:
            barrier_s = min(barrier_s, base_opts.solve_deadline_s * 0.5)
        # ONE fleet intent budget, netted against every shard's in-flight
        # intents and split per shard; the capacity quotas split the same
        shard_budgets = self._split_intent_budget(base_opts)
        with self._lock:
            round_ = (
                _StackedRound(
                    self, range(self.n_shards), timeout_s=barrier_s,
                )
                if self._use_stacked() else None
            )
            if round_ is not None and self._common_dims is not None:
                self._floor_rounds += 1
                if self._floor_rounds >= self._FLOOR_REPROBE_ROUNDS:
                    # downward re-convergence probe: build at natural
                    # dims this round; the leader re-measures the floor
                    self._common_dims = None
                    self._floor_rounds = 0

            def one(k: int) -> TickResult:
                opts = dataclasses.replace(
                    base_opts,
                    intent_budget=shard_budgets[k],
                    capacity_quota_scale=(
                        base_opts.capacity_quota_scale / self.n_shards
                    ),
                )
                if round_ is not None:
                    # the stacked round packs fresh at the common dims
                    # floor (the resident slabs' layouts are per shard)
                    opts = dataclasses.replace(
                        opts, use_resident=False,
                        solve_fn=round_.solve_for(k),
                        force_dims=self._common_dims,
                    )
                t1 = _time.perf_counter()
                try:
                    res = run_tick(self.stores[k], opts, now=now,
                                   device=self.device)
                finally:
                    if round_ is not None:
                        round_.leave(k)
                SHARD_TICK_MS.observe(
                    (_time.perf_counter() - t1) * 1e3, shard=k
                )
                return res

            futures = [
                self._pool.submit(one, k) for k in range(self.n_shards)
            ]
            wait(futures)
            results = {k: f.result() for k, f in enumerate(futures)}
            mode = round_.final_mode() if round_ is not None else "local"
            SHARD_ROUNDS.inc(outcome=mode)

            migrations: List[dict] = []
            if self.rebalance_enabled:
                migrations = self._rebalance_locked(results, now)
            self._rounds += 1
            if self._rounds % self._COMPACT_EVERY_ROUNDS == 0:
                self.compact_handoffs()

        fleet = self.fleet_level()
        if self.front_store is not None:
            # the fleet fuse is a FLOOR on the front store's ladder
            overload_mod.monitor_for(self.front_store).set_floor(fleet)
        return ShardedTickResult(
            results=results,
            solve_mode=mode,
            migrations=migrations,
            total_ms=(_time.perf_counter() - t0) * 1e3,
            fleet_level=overload_mod.level_name(fleet),
        )

    def _split_intent_budget(self, opts: TickOptions) -> List[Optional[int]]:
        """The fleet intent budget, netted against in-flight intents in
        EVERY shard store, split evenly per shard (remainder to the
        lowest shard ids). All None when intents are off this round."""
        if not opts.create_intent_hosts:
            return [None] * self.n_shards
        from ..models import host as host_mod

        if opts.intent_budget is not None:
            fleet = max(0, int(opts.intent_budget))
        else:
            in_flight = sum(
                host_mod.count_intents_in_flight(s) for s in self.stores
            )
            fleet = max(0, MAX_INTENT_HOSTS_IN_FLIGHT - in_flight)
        share, rem = divmod(fleet, self.n_shards)
        return [share + (1 if k < rem else 0) for k in range(self.n_shards)]

    # -- stacked solve ---------------------------------------------------- #

    def _stacked_solve(
        self, snaps: Dict[int, object]
    ) -> Dict[int, dict]:
        """Every shard's block through one ``StackedSolveCache`` solve on
        the plane's device. Raises ValueError on shape drift, after
        recording the max bucket per axis as the next round's floor."""
        order = sorted(snaps)
        keys = {k: snaps[k].shape_key() for k in order}
        names = ("N", "M", "U", "G", "H", "D")
        if len(set(keys.values())) > 1:
            self._common_dims = {
                name: max(keys[k][i] for k in order)
                for i, name in enumerate(names)
            }
            self._floor_rounds = 0
            raise ValueError(
                f"shard dims drifted: {sorted(set(keys.values()))}"
            )
        if self._common_dims is None:
            self._common_dims = {
                name: keys[order[0]][i] for i, name in enumerate(names)
            }
            self._floor_rounds = 0
        return self._stacked_cache.solve_blocks(
            {k: snaps[k].arrays for k in order}
        )

    # -- fleet overload --------------------------------------------------- #

    def shard_levels(self) -> Dict[int, int]:
        return {
            k: overload_mod.monitor_for(s).level()
            for k, s in enumerate(self.stores)
        }

    def fleet_level(self) -> int:
        """The fleet fuse over the per-shard ladders."""
        return overload_mod.fuse_level(list(self.shard_levels().values()))

    # -- rebalancing ------------------------------------------------------ #

    def _rebalance_locked(
        self, results: Dict[int, TickResult], now: float
    ) -> List[dict]:
        self.refresh_affinity()
        levels = self.shard_levels()
        if not any(
            lvl >= overload_mod.YELLOW for lvl in levels.values()
        ):
            return []
        # group-load scans for the HOT shards only; cold targets rank by
        # the round's task counts
        loads: Dict[int, Dict[str, int]] = {}
        reps: Dict[int, Dict[str, str]] = {}
        for k in range(self.n_shards):
            if levels.get(k, 0) >= overload_mod.YELLOW:
                loads[k], reps[k] = self._group_loads(k)
        round_ms = {
            k: (results[k].total_ms if k in results else 0.0)
            for k in range(self.n_shards)
        }
        cold_weight = {
            k: float(results[k].n_tasks) if k in results else 0.0
            for k in range(self.n_shards)
        }
        plan = greedy_rebalance_plan(
            levels, loads, round_ms, self._MAX_HANDOFFS_PER_ROUND,
            cold_weight=cold_weight,
        )
        migrations: List[dict] = []
        for src, dst, rep in plan:
            did = reps[src].get(rep, rep)
            SHARD_REBALANCES.inc(shard=src)
            try:
                rec = self.migrate(
                    did, dst, now=now, _locked=True,
                    _affinity_fresh=True,
                )
            except Exception as exc:  # noqa: BLE001 — an aborted handoff
                # converges either way (migrate heals in process)
                SHARD_HANDOFFS.inc(shard=src, outcome="aborted")
                get_logger("resilience").error(
                    "handoff-aborted", distro=did, src=src, dst=dst,
                    error=repr(exc)[-300:],
                )
                continue
            migrations.append(rec)
        return migrations

    def _group_loads(self, shard: int) -> tuple:
        """Per-affinity-group schedulable-task counts on one shard plus a
        representative distro per group."""
        store = self.stores[shard]
        by_group: Dict[str, int] = {}
        rep_of: Dict[str, str] = {}
        counts: Dict[str, int] = {}
        for doc in store.collection("tasks").find(
            lambda d: d.get("status") == TaskStatus.UNDISPATCHED.value
            and d.get("activated")
        ):
            did = doc.get("distro_id", "")
            if did:
                counts[did] = counts.get(did, 0) + 1
        for doc in store.collection("distros").find():
            did = doc["_id"]
            rep = self.topology.placement_key(did)
            by_group[rep] = by_group.get(rep, 0) + counts.get(did, 0)
            rep_of.setdefault(rep, did)
        return by_group, rep_of

    # -- fenced handoff ---------------------------------------------------- #

    def _affinity_group(self, shard: int, distro_id: str) -> List[str]:
        rep = self.topology.placement_key(distro_id)
        return [
            doc["_id"]
            for doc in self.stores[shard].collection("distros").find()
            if self.topology.placement_key(doc["_id"]) == rep
        ]

    def migrate(
        self,
        distro_id: str,
        target: int,
        now: Optional[float] = None,
        _locked: bool = False,
        _affinity_fresh: bool = False,
    ) -> dict:
        """Move ``distro_id``'s whole affinity group from its owning
        shard to ``target`` by the handoff protocol (module docstring).
        Never concurrent with a tick round: callers outside the round
        take the plane lock. Returns the record without its payload."""
        if not _locked:
            with self._lock:
                return self.migrate(
                    distro_id, target, now=now, _locked=True,
                    _affinity_fresh=_affinity_fresh,
                )
        now = _time.time() if now is None else now
        if not _affinity_fresh:
            self.refresh_affinity()
        src = self.owner_of(distro_id)
        if src == target:
            raise ValueError(f"{distro_id} already on shard {target}")
        if not (0 <= target < self.n_shards):
            raise ValueError(f"no such shard {target}")
        group = self._affinity_group(src, distro_id)
        if not group:
            raise KeyError(
                f"distro {distro_id!r} not found on shard {src}"
            )
        src_store, tgt_store = self.stores[src], self.stores[target]
        self._seq += 1
        payload = handoff_payload(src_store, group)
        rec = handoff_record(
            distro_id, group, src, target, self._seq, now, payload
        )
        hid = rec["_id"]

        # 1. release: the record and the deletions in one store group
        from ..storage.lease import EpochFencedError
        from ..utils import faults

        try:
            apply_release(src_store, rec)
        except EpochFencedError:
            # shed with a deposed holder: healing would mint a second owner
            raise
        except Exception:
            # the in-memory release already applied: converge ownership
            # from the released record
            try:
                src_store.heal_durability()
                self.reconcile_handoffs(now=now)
            except Exception as heal_exc:  # noqa: BLE001
                get_logger("resilience").error(
                    "handoff-heal-failed",
                    handoff=hid,
                    error=repr(heal_exc)[-300:],
                )
            raise
        SHARD_HANDOFFS.inc(shard=src, outcome="released")
        try:
            # seam between release and prime: reconciliation re-primes
            faults.fire("handoff.record")
            self._prime_target(rec, tgt_store)
            SHARD_HANDOFFS.inc(shard=src, outcome="primed")
            # seam between prime and the done-mark
            faults.fire("handoff.prime")
            src_store.collection(HANDOFFS_COLLECTION).update(
                hid, {"state": "done"}
            )
        except Exception:
            # the release committed but the prime/done leg failed: heal
            # in process so the group is never ownerless
            try:
                self.reconcile_handoffs(now=now)
            except Exception as heal_exc:  # noqa: BLE001
                get_logger("resilience").error(
                    "handoff-heal-failed",
                    handoff=hid,
                    error=repr(heal_exc)[-300:],
                )
            raise
        SHARD_HANDOFFS.inc(shard=src, outcome="done")
        self._apply_ownership(rec)
        get_logger("scheduler").info(
            "distro-handoff", handoff=hid, distros=rec["group"],
            src=src, dst=target,
            n_tasks=len(payload.get("tasks", ())),
        )
        return {k: v for k, v in rec.items() if k != "payload"}

    def _prime_target(self, rec: dict, tgt_store: Store) -> None:
        """Step 2: the target absorbs the payload and its own 'primed'
        record (idempotent: reconciliation re-runs it)."""
        apply_prime(tgt_store, rec)

    def _apply_ownership(self, rec: dict) -> None:
        for did in rec["group"]:
            self.topology.overrides[did] = rec["to"]

    # -- recovery --------------------------------------------------------- #

    def _load_handoff_state(self) -> None:
        """Rebuild ownership overrides and the seq counter from the
        handoff records (any state from released on means the target
        owns the group); the watermark doc only floors the counter."""
        latest: Dict[str, tuple] = {}
        for store in self.stores:
            for doc in store.collection(HANDOFFS_COLLECTION).find():
                self._seq = max(self._seq, int(doc.get("seq", 0)))
                if doc.get("state") == "watermark":
                    continue
                for did in doc.get("group", [doc.get("distro", "")]):
                    cur = latest.get(did)
                    if cur is None or doc["seq"] > cur[0]:
                        latest[did] = (doc["seq"], int(doc["to"]))
        for did, (_seq, to) in latest.items():
            if 0 <= to < self.n_shards:
                self.topology.overrides[did] = to

    def compact_handoffs(self) -> int:
        """Drop fully-reconciled handoff triples (a source record at
        ``done`` whose target holds the matching ``primed`` record); a
        watermark doc keeps the seq counter monotone. Runs at the
        periodic round checkpoint and on ``close()``; returns the number
        of triples compacted."""
        compacted = 0
        for src_id, store in enumerate(self.stores):
            coll = store.collection(HANDOFFS_COLLECTION)
            done = list(coll.find(lambda d: d.get("state") == "done"))
            if not done:
                continue
            high = 0
            for doc in done:
                to = int(doc.get("to", -1))
                if not (0 <= to < self.n_shards):
                    continue
                tgt_coll = self.stores[to].collection(HANDOFFS_COLLECTION)
                primed = tgt_coll.get(doc["_id"])
                if primed is None or primed.get("state") != "primed":
                    continue  # not a reconciled triple yet — keep both
                tgt_coll.remove(doc["_id"])
                coll.remove(doc["_id"])
                high = max(high, int(doc.get("seq", 0)))
                compacted += 1
                SHARD_HANDOFFS_COMPACTED.inc(shard=src_id)
            if high:
                wm = coll.get(HANDOFF_WATERMARK_ID) or {
                    "_id": HANDOFF_WATERMARK_ID,
                    "state": "watermark",
                    "seq": 0,
                }
                if high > int(wm.get("seq", 0)):
                    coll.upsert({**wm, "seq": high})
        if compacted:
            get_logger("scheduler").info(
                "handoffs-compacted", n=compacted
            )
        return compacted

    def reconcile_handoffs(self, now: Optional[float] = None) -> List[str]:
        """Converge every mid-flight handoff to exactly one owner: a
        released-but-unprimed record re-primes the target from its
        payload, and the source's record is marked done. Returns the
        reconciled handoff ids."""
        healed: List[str] = []
        for src_id, store in enumerate(self.stores):
            for doc in store.collection(HANDOFFS_COLLECTION).find(
                lambda d: d.get("state") == "released"
            ):
                to = int(doc["to"])
                if not (0 <= to < self.n_shards):
                    continue
                tgt_store = self.stores[to]
                primed = tgt_store.collection(HANDOFFS_COLLECTION).get(
                    doc["_id"]
                )
                if primed is None:
                    self._prime_target(doc, tgt_store)
                store.collection(HANDOFFS_COLLECTION).update(
                    doc["_id"], {"state": "done"}
                )
                SHARD_HANDOFFS.inc(shard=src_id, outcome="reconciled")
                self._apply_ownership(doc)
                healed.append(doc["_id"])
        if healed:
            get_logger("resilience").info(
                "handoffs-reconciled", healed=healed
            )
        return healed

    def close(self) -> None:
        """Compact the reconciled handoff records, stop the workers, and
        close the durable shard stores (final group commit and
        checkpoint, which then holds the trimmed handoff records) and
        release their leases, so a reopened fleet never waits out stale
        lease TTLs."""
        try:
            self.compact_handoffs()
        except Exception:  # noqa: BLE001 — housekeeping never blocks shutdown
            pass
        self._stop_pool()
        for s in self.stores:
            if getattr(s, "data_dir", None) is not None:
                try:
                    s.close()
                except Exception:  # noqa: BLE001 — best-effort shutdown;
                    # recovery at the next open heals
                    pass
            lease = getattr(s, "_lease", None)
            if lease is not None:
                try:
                    lease.release()
                except Exception:  # noqa: BLE001 — the TTL covers a
                    # failed release
                    pass


# --------------------------------------------------------------------------- #
# fleet-wide views + invariants
# --------------------------------------------------------------------------- #


def fleet_owner_violations(stores: Sequence[Store]) -> List[str]:
    """Exactly-one-owner audit: no distro-scoped document may exist in
    more than one shard store."""
    problems: List[str] = []
    for coll_name in _DISTRO_SCOPED:
        seen: Dict[str, int] = {}
        for k, store in enumerate(stores):
            for doc in store.collection(coll_name).find():
                prev = seen.get(doc["_id"])
                if prev is not None:
                    problems.append(
                        f"{coll_name}/{doc['_id']} owned by shards "
                        f"{prev} and {k}"
                    )
                seen[doc["_id"]] = k
    return problems


def merge_fleet_state(stores: Sequence[Store]) -> Store:
    """Union of every shard store into one plain Store (to compare a
    sharded run against the single-store tick). Handoff records, and
    shared-scope documents that repeat across shards, are kept under
    per-shard ids. Raises if the shards violate exactly-one-owner."""
    problems = fleet_owner_violations(stores)
    if problems:
        raise ValueError(
            "cannot merge a fleet violating exactly-one-owner: "
            + "; ".join(problems[:5])
        )
    merged = Store()
    for k, store in enumerate(stores):
        for coll_name, coll in sorted(
            store._collections.items()  # noqa: SLF001 — same package
        ):
            out = merged.collection(coll_name)
            for doc in coll.find():
                d = dict(doc)
                if coll_name == HANDOFFS_COLLECTION:
                    d["_id"] = f"shard{k}:{d['_id']}"
                elif out.get(d["_id"]) is not None:
                    d["_id"] = f"shard{k}:{d['_id']}"
                out.upsert(d)
    return merged


# -- per-store plane attachment ---------------------------------------------- #


def open_fleet(data_dir: str, n_shards: int, **kw) -> "ShardedScheduler":
    """Open (or recover) a durable sharded plane: each shard store
    replays its own segment, then the cross-shard handoff
    reconciliation converges migrations caught mid-flight."""
    plane = ShardedScheduler.build(n_shards, data_dir=data_dir, **kw)
    plane.reconcile_handoffs()
    return plane


def attach_sharded_plane(store: Store, plane: ShardedScheduler) -> None:
    """Register ``plane`` as the scheduler of the cron plane driven off
    ``store``; the front store's ladder receives the fleet fuse as a
    floor each round."""
    store._sharded_plane = plane
    plane.front_store = store


def peek_sharded_plane(store: Store) -> Optional[ShardedScheduler]:
    return getattr(store, "_sharded_plane", None)
