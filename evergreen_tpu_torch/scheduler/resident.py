"""Resident state plane: the snapshot as a long-lived columnar store
instead of a per-tick rebuild.

A copy of ``evergreen_tpu/scheduler/resident.py``. ``build_snapshot``
re-materializes every column of the scheduling problem each tick — 50k+
task slots of static attributes, memberships, segment tables — even
though a churn tick changes a few hundred rows. This plane keeps those
columns alive across ticks in a slab-per-distro layout and mutates them
in place from the TickCache's delta stream:

  * task slabs   — each solver distro owns a fixed-capacity row range
                   ``[t0, t0 + tcap)``; headroom absorbs churn so layouts
                   stay stable. Holes are ``t_valid=False`` rows, which
                   the solve already sorts last. ``d_task_count`` stays
                   the live count, so a distro's rows are its slab, not
                   the cumulative sum of the counts (``ops/solve.py::
                   distro_stats_inputs`` derives ranges that hold on both
                   layouts).
  * unit / membership / segment slabs — per-distro ranges with the same
                   headroom discipline; unit and segment ids stay local
                   to their slab, so one distro's churn never renumbers
                   another's.
  * time columns — time-in-queue, dependency-wait, the per-unit rank
                   terms and running-host elapsed are the only columns
                   recomputed every tick, as a handful of vectorized
                   passes over resident f64 bases (exactly the arithmetic
                   of the cold build, so values stay bit-identical).

Per-distro delta application picks the cheapest sound path:

  * untouched distro (list identity)      → zero work
  * incremental: removals (rows become holes; sound when each of the
    task's SHARED units — group, version — keeps an earlier surviving
    member, since unit creation order is a solve tie-break; a private
    unit is killed outright together with dependents' closure edges into
    it, and a shared-unit dependency target's removal drops each
    dependent's closure edge into its registered unit exactly when a cold
    rebuild would), replaced instances with equal membership fields
    (repack only those rows), and appended dependency-free tasks at the
    slab's high-water mark → O(changed rows)
  * anything else                         → rebuild THAT distro's slabs
                                            (static columns of surviving
                                            instances are spliced, not
                                            repacked; holes compact)

A delta-stream gap (cache re-primed), a change of the store's fencing
epoch (``store.epoch``: a durable store reopened under a newer lease),
a distro-set change that cannot be spliced, a slab overflow, or an exception inside delta application falls
back to a full rebuild, counted in ``stats()`` and guarded by a circuit
breaker so repeated delta failures stop being attempted until a cooldown
passes. An error inside the plane's host work makes ``sync`` return None:
the tick then takes the full ``build_snapshot`` path.

Publishing a tick hands the solve the truth without letting it alias the
mutable truth. On the CUDA card the plane owns a ``DeviceMirror``
(``ops/resident_ops.py``) that keeps the three arena buffers resident and
ships only the dirty spans the mutators recorded; the snapshot's buffers
are then the card's tensors. A mirror upload that fails raises
``MirrorError`` out of ``sync`` (and out of the tick): it is a fault of
the card, not host work to redo. On the CPU the truth is copied into an
arena leased from the tick's ``ArenaPool``, as the JAX package does over
its CPU client. ``invalidate(reason)`` drops the columns and the
mirror's resident buffers, so the next sync rebuilds (counted under
``reason``) and uploads in full: the tick calls it with ``"fenced"``
when the store's lease epoch is superseded. Left out, with the fleet
planes: the shared-memory publish (``attach_shm_sink``). Each sync
writes the spans ``resident_apply`` (with its ``rebuild_reason``) and
``pack`` (``mode="resident"``), and a publish on the CPU an
``arena_lease``, into the tick's trace (``utils/tracing.py``); the
mirror's publish leases no arena, so a card tick has no
``arena_lease`` span.
"""
from __future__ import annotations

import operator as _operator
import weakref
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..globals import ALIAS_SUFFIX, MAX_TASK_TIME_IN_QUEUE_S
from ..models.distro import Distro
from ..models.task import Task
from ..ops.resident_ops import DeviceMirror, MirrorError
from ..storage.store import Store
from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics
from ..utils.circuit import CircuitBreaker
from ..utils.log import get_logger
from ..utils.native import get_evgpack
from ..utils.tracing import Tracer
from .snapshot import (
    _STATIC_ARENA_COLS,
    FIELD_KINDS,
    Snapshot,
    _bucket,
    _pack_static,
    arena_for_dims,
    pack_capacity_page,
    pack_distro_settings,
    pack_memberships,
)

RESIDENT_EVENTS = _metrics.counter(
    "resident_plane_events_total",
    "Device-resident state-plane lifecycle events, labeled by outcome "
    "(invalidated / delta_failed / fallback / rebuilds).",
    labels=("outcome",),
    legacy=lambda labels: [f"resident.{labels['outcome']}"],
)

#: consecutive delta-application failures before the plane stops trying
#: deltas (full rebuild every tick) until the cooldown passes
DELTA_BREAKER_THRESHOLD = 3
DELTA_BREAKER_COOLDOWN_S = 120.0

_WEEK_S = 7 * 24 * 3600.0

#: the per-tick time columns, rewritten whole on every sync
_TIME_COLS = ("t_time_in_queue_s", "t_wait_dep_met_s", "u_tiq_term",
              "u_mainline_hours", "u_runtime_term", "h_elapsed_s")


class _NeedRelayout(Exception):
    """A slab overflowed its capacity: the plane must re-layout."""


def _cap(n: int, minimum: int = 16) -> int:
    """Slab capacity for a live count: ~6% headroom, multiple-of-8,
    floor ``minimum`` — enough slack that steady churn stays in place,
    small enough that the padded solve stays near the contiguous cost
    (every padded row is sorted by the solve)."""
    want = n + max(8, n // 16)
    return max(minimum, (want + 7) & ~7)


def _fine_bucket(n: int, prev: int = 0) -> int:
    """Resident-arena dim rounding: multiples of 512 instead of the
    snapshot's power-of-two quarter-point grid (the plane re-layouts
    rarely, so it can afford tighter padding). ``prev`` keeps the
    previous layout's dim when the fresh need still fits within it and
    is not wastefully small (≥ 75%), so churn-scale drift keeps the
    layout."""
    want = max(32, (n + 511) & ~511)
    if prev >= want and want * 4 >= prev * 3:
        return prev
    return want


def _memb_fields_equal(a: Task, b: Task) -> bool:
    """Same membership-relevant fields: a replaced instance with only
    stamps/priority/status churn keeps its unit/segment structure."""
    return (
        a.id == b.id
        and a.task_group == b.task_group
        and a.version == b.version
        and a.build_variant == b.build_variant
        and a.project == b.project
        and a.task_group_max_hosts == b.task_group_max_hosts
        and a.depends_on == b.depends_on
    )


class _Slab:
    """Per-solver-distro ranges into the global resident columns.

    ``n``/``nu``/``nm`` are HIGH-WATER row/unit/edge counts — removals
    leave holes below them (``t_valid=0`` rows, ``m_valid=0`` edges)
    that the next distro rebuild compacts. ``rows`` maps list position →
    slab-local row index (identity only while hole-free); ``row_of``
    maps task id → slab-local row index.
    """

    __slots__ = (
        "did", "di", "t0", "tcap", "n", "u0", "ucap", "nu",
        "m0", "mcap", "nm", "g0", "gcap",
        "h0", "hcap", "nh",
        "tasks", "rows", "row_of", "snames", "smax", "hseg_names", "gv",
        "dep_targets", "dobj", "host_objs", "host_named",
        "vers_unit", "grp_unit",
    )

    def __init__(self) -> None:
        self.tasks: List[Task] = []
        self.rows: List[int] = []
        self.row_of: Dict[str, int] = {}
        self.snames: List[str] = []
        self.smax: List[int] = []
        #: host-introduced segment names appended after the task segments
        self.hseg_names: List[str] = []
        self.dep_targets: Set[str] = set()
        self.host_objs: list = []
        self.host_named: List[Tuple[int, str]] = []
        self.n = self.nu = self.nm = self.nh = 0
        #: lazily derived shared-unit maps (version → unit id, group
        #: string → unit id) for the append fast path; None = underived.
        #: Valid across removals/replacements; reset on any membership
        #: rebuild.
        self.vers_unit: Optional[Dict[str, int]] = None
        self.grp_unit: Optional[Dict[str, int]] = None

    @property
    def ng(self) -> int:
        return len(self.snames) + len(self.hseg_names)


def _memberships(d: Distro, tasks: List[Task], n_d: int, di: int,
                 deps_met: Dict[str, bool]) -> tuple:
    """One distro's memberships in LOCAL coordinates — base 0, unit base
    0, segments encoded against ``named_base == n_d`` so an unnamed
    assignment (== di, < n_d) is distinguishable from a named ordinal
    (>= n_d)."""
    n = len(tasks)
    seg_local = np.zeros(max(n, 1), np.int32)
    dm_local = np.ones(max(n, 1), np.uint8)
    nu, mt, mu, snames, smax = pack_memberships(
        get_evgpack(), d, tasks, 0, 0, di, n_d, seg_local, deps_met,
        dm_local,
    )
    return (tasks, bool(d.planner_settings.group_versions), nu, mt, mu,
            snames, smax, seg_local, dm_local)


class ResidentPlane:
    """The resident columns of one store. ``mirror`` (a ``DeviceMirror``)
    publishes each tick as the mirror's resident buffers; without one,
    each tick is a copy of the truth into a pooled arena. The plane
    holds ``store`` weakly (it reads only its fencing epoch), so the
    per-store registry below never keeps a store alive."""

    def __init__(self, store: Store, mirror: Optional[DeviceMirror] = None) -> None:
        self._store = weakref.ref(store)
        #: the store's fencing epoch at the last rebuild
        self.epoch = 0
        self._ready = False
        self._pending_reason = "cold"
        self.prime_gen = -1
        self.distro_ids: List[str] = []
        self._slabs: List[_Slab] = []
        self._slab_by_did: Dict[str, _Slab] = {}
        self.dims: Dict[str, int] = {}
        self._truth = None  # ops.packing.Arena (pool-less, persistent)
        self.cols: Dict[str, np.ndarray] = {}
        self.seg_names: List[Tuple[int, str]] = []
        self.slot_tasks: List[Optional[Task]] = []
        # f64 time bases (the per-tick refresh derives every
        # time-dependent column from these, exactly like the cold build)
        self.t_basis = np.empty(0, np.float64)
        self.t_start = np.empty(0, np.float64)
        self.t_expf = np.empty(0, np.float32)
        self.h_start = np.empty(0, np.float64)
        self.n_valid = 0
        self._breaker = CircuitBreaker(
            "scheduler.resident",
            failure_threshold=DELTA_BREAKER_THRESHOLD,
            cooldown_s=DELTA_BREAKER_COOLDOWN_S,
        )
        #: telemetry
        self.rebuilds = 0
        self.rebuild_reasons: Dict[str, int] = {}
        self.delta_rows = 0
        self.distro_rebuilds = 0
        self.fast_appends = 0
        self.fast_replaces = 0
        self.fast_removes = 0
        self.fallbacks = 0
        #: distro-SET changes absorbed by splicing surviving slabs
        self.topology_splices = 0
        #: dirty spans per dtype kind since the last publish, recorded by
        #: every mutator when the mirror is on (None: a full upload)
        self._mirror = mirror
        self._spans: Optional[Dict[str, List[Tuple[int, int]]]] = None

    @property
    def device(self) -> torch.device:
        """Where the published buffers live."""
        return (resolve_device(self._mirror.device) if self._mirror is not None
                else torch.device("cpu"))

    def _store_epoch(self) -> int:
        return getattr(self._store(), "epoch", 0)

    # ------------------------------------------------------------------ #
    # public surface
    # ------------------------------------------------------------------ #

    def invalidate(self, reason: str) -> None:
        """Drop the resident columns and the mirror's buffers; the next
        sync full-rebuilds (counted under ``reason``) and uploads in full.
        Called on lease fencing and any unexplained inconsistency."""
        self._ready = False
        self._pending_reason = reason
        if self._mirror is not None:
            self._mirror.reset()
        RESIDENT_EVENTS.inc(outcome="invalidated")

    def stats(self) -> dict:
        out = {
            "rebuilds": self.rebuilds,
            "rebuild_reasons": dict(self.rebuild_reasons),
            "delta_rows": self.delta_rows,
            "distro_rebuilds": self.distro_rebuilds,
            "fast_appends": self.fast_appends,
            "fast_replaces": self.fast_replaces,
            "fast_removes": self.fast_removes,
            "fallbacks": self.fallbacks,
            "topology_splices": self.topology_splices,
        }
        if self._mirror is not None:
            out["mirror_delta_rows"] = self._mirror.delta_rows
            out["mirror_slice_rows"] = self._mirror.slice_rows
            out["mirror_full_uploads"] = self._mirror.full_uploads
            out["mirror_bytes_uploaded"] = self._mirror.bytes_uploaded
        return out

    def sync(
        self,
        cache,
        solver_distros: List[Distro],
        tasks_by_distro: Dict[str, List[Task]],
        hosts_by_distro: Dict[str, list],
        running_estimates: Dict[str, object],
        deps_met: Dict[str, bool],
        now: float,
        arena_pool=None,
        capacity_page=None,
    ) -> Optional[Snapshot]:
        """Bring the resident columns up to date and publish a Snapshot.
        Returns None when the plane's host work fails (the caller then
        takes the classic full-rebuild path); a failed mirror upload
        raises ``MirrorError``.

        ``capacity_page`` is the tick's fused-capacity input page
        (``CapacityPlane.build_capacity_page``; None clears it) — a few
        fixed f32 slots refreshed in place every tick, like the time
        columns."""
        _tracer = Tracer(self._store(), "resident")
        try:
            # resident_apply: drain the cache's delta stream and mutate
            # the persistent columns in place (or slab-rebuild on a gap)
            with _tracer.span("resident_apply") as _apply_span:
                prime_gen, dm_dirty, hosts_dirty = cache.drain_resident_deltas()
                reason = self._gap_reason(solver_distros, prime_gen)
                if reason is None and not self._breaker.allow(now=now):
                    reason = "breaker-open"
                if reason is None:
                    try:
                        self._apply_deltas(
                            cache, solver_distros, tasks_by_distro,
                            hosts_by_distro, running_estimates, deps_met,
                            dm_dirty, hosts_dirty,
                        )
                        self._breaker.record_success(now=now)
                    except _NeedRelayout as exc:
                        reason = f"overflow:{exc}"
                    except Exception as exc:  # noqa: BLE001 — any delta bug
                        # degrades to a rebuild, never a wrong snapshot
                        self._breaker.record_failure(now=now, error=repr(exc))
                        RESIDENT_EVENTS.inc(outcome="delta_failed")
                        get_logger("resilience").error(
                            "resident-delta-failed", error=repr(exc)[-300:]
                        )
                        reason = "delta-error"
                if reason == "distro-set":
                    # topology change (enable/disable, a distro added or
                    # removed): splice surviving slabs into the new layout and
                    # pay membership builds only for ADDED distros
                    try:
                        if self._splice_distro_set(
                            solver_distros, tasks_by_distro,
                            hosts_by_distro, running_estimates, deps_met,
                        ):
                            reason = None
                            self.topology_splices += 1
                            RESIDENT_EVENTS.inc(outcome="topology_splice")
                            get_logger("scheduler").info(
                                "resident-topology-splice",
                                n_distros=len(solver_distros),
                            )
                    except Exception as exc:  # noqa: BLE001 — a splice bug
                        # degrades to a rebuild, never a wrong plane; charged
                        # to the breaker like a delta failure
                        self._breaker.record_failure(now=now, error=repr(exc))
                        RESIDENT_EVENTS.inc(outcome="splice_failed")
                        get_logger("resilience").warning(
                            "resident-splice-failed", error=repr(exc)[-300:],
                        )
                if reason is not None:
                    self._rebuild(
                        solver_distros, tasks_by_distro, hosts_by_distro,
                        running_estimates, deps_met, prime_gen, reason,
                    )
                self._refresh_time_columns(now)
                self._set_capacity_page(capacity_page)
                _apply_span["attributes"]["rebuild_reason"] = reason or ""
        except Exception as exc:  # noqa: BLE001 — full fallback: the tick
            # proceeds on build_snapshot; state is dropped so the next
            # sync starts clean
            self.fallbacks += 1
            RESIDENT_EVENTS.inc(outcome="fallback")
            get_logger("resilience").error(
                "resident-fallback", error=repr(exc)[-300:]
            )
            self.invalidate("error")
            return None
        try:
            # pack: ship the dirty spans to the device mirror, or copy the
            # truth into a leased transfer arena
            with _tracer.span("pack", mode="resident"):
                return self._publish(now, arena_pool)
        except MirrorError:
            # the card refused an upload: drop the plane (and the
            # mirror's buffers) so a later sync starts clean, and let the
            # tick raise
            self.invalidate("mirror-error")
            raise

    # ------------------------------------------------------------------ #
    # gap detection
    # ------------------------------------------------------------------ #

    def _gap_reason(
        self, solver_distros: List[Distro], prime_gen: int
    ) -> Optional[str]:
        if not self._ready:
            return self._pending_reason or "cold"
        if prime_gen != self.prime_gen:
            return "delta-gap"
        if self._store_epoch() != self.epoch:
            return "epoch"
        if len(solver_distros) != len(self.distro_ids) or any(
            d.id != did for d, did in zip(solver_distros, self.distro_ids)
        ):
            return "distro-set"
        return None

    # ------------------------------------------------------------------ #
    # span recording (mirror path; no-op without the mirror)
    # ------------------------------------------------------------------ #

    def _mark(self, name: str, lo: int, hi: int) -> None:
        if self._spans is None or hi <= lo:
            return
        kind, off, _size = self._truth.field(name)
        self._spans.setdefault(kind, []).append((off + lo, off + hi))

    def _mark_whole(self, names) -> None:
        if self._spans is None:
            return
        for name in names:
            kind, off, size = self._truth.field(name)
            self._spans.setdefault(kind, []).append((off, off + size))

    # ------------------------------------------------------------------ #
    # full rebuild
    # ------------------------------------------------------------------ #

    def _layout(self, slabs: List[_Slab], n_d: int) -> Dict[str, int]:
        """Arena dims for slabs laid out back to back (the previous
        layout's dims kept while they still fit)."""
        prev = self.dims
        t0 = sum(s.tcap for s in slabs)
        return {
            "N": _fine_bucket(t0, prev.get("N", 0)),
            "M": _fine_bucket(sum(s.mcap for s in slabs), prev.get("M", 0)),
            "U": _fine_bucket(sum(s.ucap for s in slabs), prev.get("U", 0)),
            "G": _fine_bucket(n_d + sum(s.gcap for s in slabs),
                              prev.get("G", 0)),
            "H": _fine_bucket(sum(s.hcap for s in slabs), prev.get("H", 0)),
            "D": _bucket(max(n_d, 1), minimum=8),
        }

    @staticmethod
    def _place(slabs: List[_Slab], n_d: int) -> None:
        """Assign each slab its bases, back to back in distro order (the
        n_d unnamed segments lead: global seg id == distro index)."""
        t0 = u0 = m0 = h0 = 0
        g0 = n_d
        for s in slabs:
            s.t0, s.u0, s.m0, s.g0, s.h0 = t0, u0, m0, g0, h0
            t0 += s.tcap
            u0 += s.ucap
            m0 += s.mcap
            g0 += s.gcap
            h0 += s.hcap

    @staticmethod
    def _new_slab(d: Distro, block: tuple, n_hosts: int) -> _Slab:
        (tasks, gv, nu, mt, _mu, snames, smax, _seg, _dm) = block
        s = _Slab()
        s.did, s.gv, s.dobj = d.id, gv, d
        s.tcap, s.n = _cap(len(tasks)), len(tasks)
        s.ucap, s.nu = _cap(nu), nu
        s.mcap, s.nm = _cap(len(mt)), len(mt)
        s.gcap = _cap(len(smax) + 2, minimum=8)
        s.hcap = _cap(n_hosts, minimum=8)
        s.tasks = tasks
        s.rows = list(range(len(tasks)))
        s.row_of = {t.id: j for j, t in enumerate(tasks)}
        s.snames, s.smax = list(snames), list(smax)
        s.dep_targets = {dep.task_id for t in tasks for dep in t.depends_on}
        return s

    def _fill_block(self, s: _Slab, block: tuple, n_d: int) -> None:
        """Write a freshly built slab's task, membership, unit and
        segment rows from its local membership block."""
        (tasks, _gv, nu, mt, mu, _sn, _sm, seg_local, dm_local) = block
        c = self.cols
        n = s.n
        if n:
            sl = slice(s.t0, s.t0 + n)
            c["t_valid"][sl] = 1
            c["t_distro"][sl] = s.di
            c["t_seg"][sl] = np.where(
                seg_local[:n] < n_d, seg_local[:n],
                seg_local[:n] - np.int32(n_d) + np.int32(s.g0),
            )
            c["t_deps_met"][sl] = dm_local[:n]
            self._pack_static_rows(s.t0, tasks)
            for j, t in enumerate(tasks):
                self.slot_tasks[s.t0 + j] = t
        if len(mt):
            msl = slice(s.m0, s.m0 + len(mt))
            c["m_task"][msl] = mt + np.int32(s.t0)
            c["m_unit"][msl] = mu + np.int32(s.u0)
            c["m_valid"][msl] = 1
        if nu:
            c["u_distro"][s.u0:s.u0 + nu] = s.di
        self._write_seg_slab(s)

    @staticmethod
    def _fresh_truth(dims: Dict[str, int]) -> dict:
        """A zeroed truth arena, its column views and the host scratch
        for ``dims``, as the plane's attribute names."""
        truth = arena_for_dims(dims)
        return dict(
            _truth=truth, dims=dims,
            cols={name: truth.view(name) for name in FIELD_KINDS},
            t_basis=np.zeros(dims["N"], np.float64),
            t_start=np.zeros(dims["N"], np.float64),
            t_expf=np.zeros(dims["N"], np.float32),
            h_start=np.zeros(dims["H"], np.float64),
            slot_tasks=[None] * dims["N"],
        )

    def _rebuild(
        self,
        solver_distros: List[Distro],
        tasks_by_distro: Dict[str, List[Task]],
        hosts_by_distro: Dict[str, list],
        running_estimates: Dict[str, object],
        deps_met: Dict[str, bool],
        prime_gen: int,
        reason: str,
    ) -> None:
        self.rebuilds += 1
        self.rebuild_reasons[reason] = self.rebuild_reasons.get(reason, 0) + 1
        RESIDENT_EVENTS.inc(outcome="rebuilds")
        n_d = len(solver_distros)

        # pass 1: per-distro memberships in local coordinates
        blocks = [
            _memberships(d, tasks_by_distro.get(d.id, []), n_d, di, deps_met)
            for di, d in enumerate(solver_distros)
        ]
        # pass 2: lay out slabs + dims
        slabs = []
        for di, d in enumerate(solver_distros):
            s = self._new_slab(d, blocks[di],
                               len(hosts_by_distro.get(d.id, [])))
            s.di = di
            slabs.append(s)
        self._place(slabs, n_d)
        dims = self._layout(slabs, n_d)

        # pass 3: (re)allocate the truth arena + scratch, then fill
        if self._truth is None or self.dims != dims:
            vars(self).update(self._fresh_truth(dims))
        else:
            for buf in self._truth.buffers.values():
                buf.fill(0)
            self.t_basis.fill(0.0)
            self.t_start.fill(0.0)
            self.t_expf.fill(0.0)
            self.h_start.fill(0.0)
            self.slot_tasks = [None] * dims["N"]
        self._slabs = slabs
        self._slab_by_did = {s.did: s for s in slabs}
        self.distro_ids = [d.id for d in solver_distros]
        self.seg_names = (
            [(di, "") for di in range(n_d)]
            + [(-1, "")] * (dims["G"] - n_d)
        )
        c = self.cols
        # the n_d leading unnamed segments (global seg id == distro index)
        c["g_distro"][:n_d] = np.arange(n_d, dtype=np.int32)
        c["g_unnamed"][:n_d] = 1
        c["g_valid"][:n_d] = 1
        for di, s in enumerate(slabs):
            self._fill_block(s, blocks[di], n_d)
            s.nh = 0
            self._fill_host_rows(
                s, hosts_by_distro.get(s.did, []), running_estimates
            )
            c["d_task_count"][di] = s.n
        c["d_valid"][:n_d] = 1
        pack_distro_settings(self._bool_view_cols(), solver_distros)

        self.n_valid = sum(s.n for s in slabs)
        self.epoch = self._store_epoch()
        self.prime_gen = prime_gen
        self._ready = True
        self._pending_reason = ""
        self._spans = None  # full upload this tick
        get_logger("scheduler").info(
            "resident-rebuild", reason=reason, n_tasks=self.n_valid,
            dims=dict(dims),
        )

    def _bool_view_cols(self) -> Dict[str, np.ndarray]:
        return {
            name: (v.view(np.bool_) if FIELD_KINDS[name] == "u8" else v)
            for name, v in self.cols.items()
        }

    # ------------------------------------------------------------------ #
    # delta-shaped distro-set change
    # ------------------------------------------------------------------ #

    def _splice_distro_set(
        self,
        solver_distros: List[Distro],
        tasks_by_distro: Dict[str, List[Task]],
        hosts_by_distro: Dict[str, list],
        running_estimates: Dict[str, object],
        deps_met: Dict[str, bool],
    ) -> bool:
        """Absorb a pure distro-SET change — distros added, removed,
        enabled or disabled — without a full rebuild: surviving distros'
        slabs (columns, high-water marks, hole structure, membership
        edges) are SPLICED into the new layout with constant-shift index
        fixups, and only ADDED distros pay a membership build + static
        pack.

        Returns False (caller full-rebuilds) when any surviving distro
        churned inside the same gap — its task-list identity changed —
        or its group-versions semantics flipped."""
        if self._truth is None or not self._slabs:
            return False
        old_by_did = self._slab_by_did
        added: List[Tuple[int, Distro]] = []
        for di, d in enumerate(solver_distros):
            s = old_by_did.get(d.id)
            if s is None:
                added.append((di, d))
                continue
            lst = tasks_by_distro.get(d.id)
            if lst is None or lst is not s.tasks:
                return False  # the distro churned in the same gap
            if bool(d.planner_settings.group_versions) != s.gv:
                return False  # membership semantics changed
        if len(added) == len(solver_distros):
            return False  # nothing survives — a rebuild costs the same
        n_d = len(solver_distros)

        # pass 1 (the delta): memberships for ADDED distros only
        blocks = {
            d.id: _memberships(d, tasks_by_distro.get(d.id, []), n_d, di,
                               deps_met)
            for di, d in added
        }
        # pass 2: new layout — surviving slabs keep their caps (and every
        # high-water mark / hole below them), added slabs size exactly
        # like a full rebuild would
        old_pos = {
            s.did: (s.di, s.t0, s.u0, s.m0, s.g0) for s in self._slabs
        }
        new_slabs: List[_Slab] = []
        for di, d in enumerate(solver_distros):
            s = old_by_did.get(d.id)
            if s is None:
                s = self._new_slab(d, blocks[d.id],
                                   len(hosts_by_distro.get(d.id, [])))
            s.di, s.dobj = di, d
            # the cached unit maps hold GLOBAL unit ids — stale once u0
            # shifts; re-derived lazily from the spliced columns
            s.vers_unit = s.grp_unit = None
            new_slabs.append(s)
        self._place(new_slabs, n_d)
        dims = self._layout(new_slabs, n_d)

        # pass 3: fresh truth arena — splice surviving slabs' column
        # ranges (constant-shift fixups on the index-bearing columns);
        # nothing of the plane changes until the commit below
        old_cols = self.cols
        old_slot = self.slot_tasks
        old_tb, old_tst, old_tef = self.t_basis, self.t_start, self.t_expf
        old_seg_names = self.seg_names
        fresh = self._fresh_truth(dims)
        cols = fresh["cols"]
        seg_names: List[Tuple[int, str]] = (
            [(di, "") for di in range(n_d)]
            + [(-1, "")] * (dims["G"] - n_d)
        )
        cols["g_distro"][:n_d] = np.arange(n_d, dtype=np.int32)
        cols["g_unnamed"][:n_d] = 1
        cols["g_valid"][:n_d] = 1

        t_fields = [n for n in FIELD_KINDS if n.startswith("t_")]
        u_fields = [n for n in FIELD_KINDS if n.startswith("u_")]
        g_fields = [n for n in FIELD_KINDS if n.startswith("g_")]
        for s in new_slabs:
            pos = old_pos.get(s.did)
            if pos is None:
                continue
            odi, ot0, ou0, om0, og0 = pos
            hw_t, hw_m, hw_u = s.n, s.nm, s.nu
            for name in t_fields:
                cols[name][s.t0:s.t0 + hw_t] = old_cols[name][ot0:ot0 + hw_t]
            cols["t_distro"][s.t0:s.t0 + s.tcap] = s.di
            if hw_t:
                # a row's segment is either this distro's unnamed id (==
                # the old di) or a named id in [old g0, old g0 + gcap) —
                # both constant shifts; hole rows reset
                seg = cols["t_seg"][s.t0:s.t0 + hw_t]
                valid = old_cols["t_valid"][ot0:ot0 + hw_t].astype(bool)
                np.copyto(
                    seg,
                    np.where(
                        seg == np.int32(odi), np.int32(s.di),
                        seg - np.int32(og0) + np.int32(s.g0),
                    ),
                    where=valid,
                )
                np.copyto(seg, np.int32(s.di), where=~valid)
            fresh["t_basis"][s.t0:s.t0 + hw_t] = old_tb[ot0:ot0 + hw_t]
            fresh["t_start"][s.t0:s.t0 + hw_t] = old_tst[ot0:ot0 + hw_t]
            fresh["t_expf"][s.t0:s.t0 + hw_t] = old_tef[ot0:ot0 + hw_t]
            fresh["slot_tasks"][s.t0:s.t0 + hw_t] = old_slot[ot0:ot0 + hw_t]
            # deps-met can churn without regenerating the task list (a
            # parent finished elsewhere): refill from the live map
            dmcol = cols["t_deps_met"]
            for t in s.tasks:
                dmcol[s.t0 + s.row_of[t.id]] = deps_met.get(t.id, True)
            for name in ("m_task", "m_unit", "m_valid"):
                cols[name][s.m0:s.m0 + hw_m] = old_cols[name][om0:om0 + hw_m]
            if hw_m:
                cols["m_task"][s.m0:s.m0 + hw_m] += np.int32(s.t0 - ot0)
                cols["m_unit"][s.m0:s.m0 + hw_m] += np.int32(s.u0 - ou0)
            for name in u_fields:
                cols[name][s.u0:s.u0 + hw_u] = old_cols[name][ou0:ou0 + hw_u]
            cols["u_distro"][s.u0:s.u0 + hw_u] = s.di
            # named-segment slab: full cap range (tombstones keep their
            # positions so later segment ids never shift)
            for name in g_fields:
                cols[name][s.g0:s.g0 + s.gcap] = (
                    old_cols[name][og0:og0 + s.gcap]
                )
            cols["g_distro"][s.g0:s.g0 + s.gcap] = s.di
            for i in range(s.gcap):
                prev_di, nm = old_seg_names[og0 + i]
                seg_names[s.g0 + i] = (s.di, nm) if prev_di != -1 else (-1, "")

        # commit the new layout, then complete it with the fill paths
        # (added-slab bodies, host rows for every slab)
        vars(self).update(fresh)
        self._slabs = new_slabs
        self._slab_by_did = {s.did: s for s in new_slabs}
        self.distro_ids = [d.id for d in solver_distros]
        self.seg_names = seg_names
        for s in new_slabs:
            block = blocks.get(s.did)
            if block is not None:
                self._fill_block(s, block, n_d)
            # host rows: the cold-equivalent refill for EVERY slab (host
            # churn rides the delta stream, which this gap skipped; the
            # fill also re-registers host-introduced segments)
            self._fill_host_rows(
                s, hosts_by_distro.get(s.did, []), running_estimates
            )
            cols["d_task_count"][s.di] = len(s.tasks)
        cols["d_valid"][:n_d] = 1
        pack_distro_settings(self._bool_view_cols(), solver_distros)

        self.n_valid = sum(len(s.tasks) for s in new_slabs)
        self._spans = None  # layout changed: full upload this tick
        return True

    # ------------------------------------------------------------------ #
    # delta application
    # ------------------------------------------------------------------ #

    def _apply_deltas(
        self,
        cache,
        solver_distros: List[Distro],
        tasks_by_distro: Dict[str, List[Task]],
        hosts_by_distro: Dict[str, list],
        running_estimates: Dict[str, object],
        deps_met: Dict[str, bool],
        dm_dirty: Set[str],
        hosts_dirty: Set[str],
    ) -> None:
        if self._mirror is not None and self._spans is None:
            self._spans = {}
        for di, d in enumerate(solver_distros):
            s = self._slabs[di]
            lst = tasks_by_distro.get(d.id, s.tasks)
            if lst is not s.tasks:
                self._update_distro_tasks(s, d, lst, deps_met)
            if d is not s.dobj:
                self._update_distro_settings(s, d)
        if hosts_dirty:
            # cheap identity sweep: Host instances are re-materialized
            # only when their doc churns, so an unchanged distro's host
            # list passes an all-is() scan
            for di, d in enumerate(solver_distros):
                s = self._slabs[di]
                hs = hosts_by_distro.get(d.id, [])
                if len(hs) == s.nh and all(map(_operator.is_, s.host_objs, hs)):
                    continue
                self._fill_host_rows(s, hs, running_estimates)
        if dm_dirty:
            c_dm = self.cols["t_deps_met"]
            for tid in dm_dirty:
                t = cache.runnable_task(tid)
                if t is None:
                    continue
                flag = deps_met.get(tid, True)
                for did in (t.distro_id,) + tuple(
                        sd + ALIAS_SUFFIX for sd in t.secondary_distros):
                    s = self._slab_by_did.get(did)
                    if s is None:
                        continue
                    j = s.row_of.get(tid)
                    if j is not None:
                        c_dm[s.t0 + j] = flag
                        self._mark("t_deps_met", s.t0 + j, s.t0 + j + 1)

    def _update_distro_tasks(
        self, s: _Slab, d: Distro, new_list: List[Task],
        deps_met: Dict[str, bool],
    ) -> None:
        if not self._try_incremental(s, new_list, deps_met):
            self._rebuild_distro(s, d, new_list, deps_met)

    def _try_incremental(
        self, s: _Slab, new_list: List[Task], deps_met: Dict[str, bool],
    ) -> bool:
        """One pass handling the common churn mix — removals of unshared
        tasks (rows become holes), replaced instances with unchanged
        membership fields (repack those rows), and appended simple tasks
        — in O(changed rows) plus one O(n) survivor walk. Returns False
        (untouched state) when any change needs the distro's memberships
        rebuilt."""
        old = s.tasks
        new_ids = {t.id for t in new_list}
        if len(new_ids) != len(new_list):
            return False  # duplicate ids: the rebuild's layout handles it
        rm_pos = [i for i, t in enumerate(old) if t.id not in new_ids]
        n_surv = len(old) - len(rm_pos)
        if n_surv > len(new_list):
            return False
        fresh = new_list[n_surv:]
        rm_set = set(rm_pos)
        seg_kill: List[str] = []
        edge_kill: Set[int] = set()
        rm_ids: Optional[Set[str]] = None
        dep_of: Optional[Dict[str, List[int]]] = None
        for i in rm_pos:
            t = old[i]
            if not t.task_group and not s.gv:
                continue  # private unit: always removable (unit-killed)
            # the task's unit (group and/or version) is SHARED. Sound
            # only when (a) each dependent's closure edge into the unit
            # registered under the task's id is dropped exactly when a
            # cold rebuild would drop it, and (b) an EARLIER member
            # survives, since unit creation order is a solve tie-break
            # and (for groups) the segment row + its max-hosts must live
            # on.
            if t.id in s.dep_targets:
                if dep_of is None:
                    rm_ids = {old[x].id for x in rm_pos}
                    dep_of = {}
                    for j2, o2 in enumerate(old):
                        for dep in o2.depends_on:
                            dep_of.setdefault(dep.task_id, []).append(j2)
                kills = self._closure_kills(
                    s, t, old, rm_set, rm_ids, dep_of.get(t.id, ()),
                )
                if kills is None:
                    return False
                edge_kill.update(kills)
            if t.task_group:
                k = t.task_group_string()
                mh = t.task_group_max_hosts
                if not any(
                    j not in rm_set
                    and old[j].task_group
                    and old[j].task_group_max_hosts == mh
                    and old[j].task_group_string() == k
                    for j in range(i)
                ):
                    # no earlier equal-capped member keeps the unit's
                    # creation rank. Still sound when NO member at all
                    # survives: the unit goes edgeless with the row mask
                    # and only its segment row must be tombstoned; a host
                    # occupying the segment keeps it alive in a cold
                    # rebuild, so that case rebuilds.
                    if any(
                        j not in rm_set
                        and old[j].task_group
                        and old[j].task_group_string() == k
                        for j in range(len(old))
                    ):
                        return False
                    if any(nm == k for _, nm in s.host_named):
                        return False
                    if any(
                        f.task_group and f.task_group_string() == k
                        for f in fresh
                    ):
                        # the same delta re-populates the group: a cold
                        # rebuild creates its unit at the fresh task's
                        # (late) position
                        return False
                    seg_kill.append(k)
            if s.gv:
                # the version unit is shared by EVERY task of the
                # version: any earlier survivor keeps it alive and ordered
                v = t.version
                if not any(
                    j not in rm_set and old[j].version == v
                    for j in range(i)
                ):
                    return False
        if fresh and not self._fast_append_ok(s, fresh):
            return False
        # survivors must align with the new prefix id-for-id with equal
        # membership fields (stamp/priority churn only)
        replaced: List[Tuple[int, Task]] = []
        j = 0
        for i, a in enumerate(old):
            if i in rm_set:
                continue
            b = new_list[j]
            if a is not b:
                if not _memb_fields_equal(a, b):
                    return False
                replaced.append((j, b))
            j += 1

        # ---- commit: no bail past this point --------------------------- #
        if rm_pos:
            self._fast_remove(s, rm_pos, old, rm_set, seg_kill)
        if edge_kill:
            m_valid = self.cols["m_valid"]
            for e in edge_kill:
                m_valid[e] = 0
                self._mark("m_valid", e, e + 1)
            self.delta_rows += len(edge_kill)
        if replaced:
            rows = [s.t0 + s.rows[k] for k, _ in replaced]
            pack = [b for _, b in replaced]
            c_dm = self.cols["t_deps_met"]
            for (_, b), row in zip(replaced, rows):
                self.slot_tasks[row] = b
                c_dm[row] = deps_met.get(b.id, True)
                self._mark("t_deps_met", row, row + 1)
            self._pack_static_scatter(rows, pack)
            self.delta_rows += len(pack)
            self.fast_replaces += 1
        if fresh:
            self._fast_append(s, fresh, new_list, deps_met)
        else:
            s.tasks = new_list
            self.cols["d_task_count"][s.di] = len(new_list)
            self._mark("d_task_count", s.di, s.di + 1)
        return True

    def _closure_kills(
        self, s: _Slab, t: Task, old: List[Task], rm_set: Set[int],
        rm_ids: Set[str], dependents,
    ) -> Optional[List[int]]:
        """Membership edges (global indices) a cold rebuild would drop
        when dependency target ``t`` leaves the list: each surviving
        dependent's closure edge into ``t``'s REGISTERED unit (group unit
        for a grouped task, version unit for an ungrouped task in a
        group-versions slab), unless the dependent reaches the same unit
        through its own membership or another surviving dependency that
        registers it. ``None`` refuses the fast path with nothing
        mutated."""
        if t.task_group:
            key = t.task_group_string()
            tgt = self._unit_maps(s)[1].get(key)

            def own(d: Task) -> bool:
                return bool(d.task_group) and d.task_group_string() == key

            def registers(y: Task) -> bool:
                return bool(y.task_group) and y.task_group_string() == key
        else:  # gv slab, ungrouped: the version unit is registered
            key = t.version
            tgt = self._unit_maps(s)[0].get(key)

            def own(d: Task) -> bool:
                # every task in a gv slab owns its version's unit
                return d.version == key

            def registers(y: Task) -> bool:
                return not y.task_group and y.version == key

        if tgt is None:
            return None
        kills: List[int] = []
        c = self.cols
        mt = mu = mv = None
        slot = self.slot_tasks
        for j in dependents:
            if j in rm_set:
                continue
            d = old[j]
            if own(d):
                continue
            keep = False
            for dep in d.depends_on:
                yid = dep.task_id
                if yid == t.id or yid in rm_ids:
                    continue
                yrow = s.row_of.get(yid)
                if yrow is None:
                    continue
                y = slot[s.t0 + yrow]
                if y is not None and registers(y):
                    keep = True
                    break
            if keep:
                continue
            if mt is None:
                msl = slice(s.m0, s.m0 + s.nm)
                mt = c["m_task"][msl]
                mu = c["m_unit"][msl]
                mv = c["m_valid"][msl].astype(np.bool_)
            drow = s.t0 + s.row_of[d.id]
            e = np.flatnonzero((mt == drow) & (mu == tgt) & mv)
            if len(e) != 1:
                return None
            kills.append(s.m0 + int(e[0]))
        return kills

    def _fast_remove(
        self, s: _Slab, rm_pos: List[int], old: List[Task],
        rm_set: Set[int], seg_kill: List[str] = (),
    ) -> None:
        """Turn the removed tasks' rows into holes: validity off, time
        bases zeroed, and every edge of the removed tasks' OWN private
        units invalidated (the tasks' own edges AND any dependency-closure
        edges other tasks hold into them). The removed rows' edges to
        OTHER units go with the row mask. Units never die by
        renumbering — an edgeless unit simply stops being referenced."""
        c = self.cols
        rows_local = [s.rows[i] for i in rm_pos]
        garr = np.asarray(rows_local, np.int64) + s.t0
        c["t_valid"][garr] = 0
        self.t_basis[garr] = 0.0
        self.t_start[garr] = 0.0
        self.t_expf[garr] = 0.0
        slot = self.slot_tasks
        for r in garr.tolist():
            slot[r] = None
            self._mark("t_valid", r, r + 1)
        for i in rm_pos:
            s.row_of.pop(old[i].id, None)
        if s.nm:
            msl = slice(s.m0, s.m0 + s.nm)
            mt = c["m_task"][msl]
            mu = c["m_unit"][msl]
            live = c["m_valid"][msl].astype(np.bool_)
            kill = np.isin(mt, garr) & live
            if not s.gv:
                # each PRIVATE-unit task's own unit: the FIRST live edge
                # of its row (emission order is [own unit, closure...]).
                # Shared units survive — the predicate guaranteed earlier
                # members — so those rows get only the row mask.
                own_units = []
                for i, r in zip(rm_pos, garr.tolist()):
                    if old[i].task_group:
                        continue
                    e = np.flatnonzero((mt == r) & live)
                    if len(e):
                        own_units.append(mu[e[0]])
                if own_units:
                    kill |= np.isin(
                        mu, np.asarray(own_units, mu.dtype)
                    ) & live
            if kill.any():
                c["m_valid"][msl][kill] = 0
                self._mark("m_valid", s.m0, s.m0 + s.nm)
        # segments whose LAST member left with this batch: tombstone the
        # row in place (positions of the distro's other segments must not
        # shift — t_seg/h_seg reference them by id)
        for k in set(seg_kill):
            try:
                so = s.snames.index(k)
            except ValueError:
                continue  # already tombstoned
            gi = s.g0 + so
            c["g_valid"][gi] = 0
            c["g_max_hosts"][gi] = 0
            self.seg_names[gi] = (-1, "")
            s.snames[so] = None
            s.smax[so] = 0
            if s.grp_unit is not None:
                s.grp_unit.pop(k, None)
            self._mark("g_valid", gi, gi + 1)
            self._mark("g_max_hosts", gi, gi + 1)
        s.rows = [r for i, r in enumerate(s.rows) if i not in rm_set]
        self.n_valid -= len(rm_pos)
        self.delta_rows += len(rm_pos)
        self.fast_removes += 1

    def _unit_maps(self, s: _Slab) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Derive (version → unit id, group string → unit id) from the
        slab's LIVE edges. Emission order within a task is [group unit?,
        version unit?, closure...] (``build_memberships``), so the first
        live edge of a grouped task is its group unit and — in a gv slab —
        the second is its version unit; an ungrouped gv task leads with
        the version unit."""
        if s.vers_unit is None:
            vers: Dict[str, int] = {}
            grp: Dict[str, int] = {}
            msl = slice(s.m0, s.m0 + s.nm)
            mts = self.cols["m_task"][msl].tolist()
            mus = self.cols["m_unit"][msl].tolist()
            mvs = self.cols["m_valid"][msl].tolist()
            nth: Dict[int, int] = {}
            slot = self.slot_tasks
            for r, u, live in zip(mts, mus, mvs):
                if not live:
                    continue
                k = nth.get(r, 0)
                nth[r] = k + 1
                t = slot[r]
                if t is None:
                    continue
                if t.task_group:
                    if k == 0:
                        grp.setdefault(t.task_group_string(), u)
                    elif k == 1 and s.gv:
                        vers.setdefault(t.version, u)
                elif s.gv and k == 0:
                    vers.setdefault(t.version, u)
            s.vers_unit, s.grp_unit = vers, grp
        return s.vers_unit, s.grp_unit

    def _fast_append_ok(self, s: _Slab, fresh: List[Task]) -> bool:
        n_edges = 0
        need_maps = s.gv or any(t.task_group for t in fresh)
        grp = self._unit_maps(s)[1] if need_maps else {}
        for t in fresh:
            if t.depends_on or t.id in s.dep_targets:
                return False
            if t.task_group:
                if t.task_group_string() not in grp:
                    return False  # new group unit + segment row: rebuild
                so = s.snames.index(t.task_group_string())
                if s.smax[so] == 0 and t.task_group_max_hosts > 0:
                    return False  # would retroactively set the seg cap
                n_edges += 2 if s.gv else 1
            else:
                n_edges += 1
        return not (
            s.n + len(fresh) > s.tcap
            or s.nu + len(fresh) > s.ucap
            or s.nm + n_edges > s.mcap
        )

    def _fast_append(
        self, s: _Slab, fresh: List[Task], new_list: List[Task],
        deps_met: Dict[str, bool],
    ) -> None:
        """Append rows at the slab's high-water mark — exactly the units
        a cold rebuild would form for tasks at the END of the list: join
        the existing group/version unit where one exists, open a new unit
        (ordered last) for a private task or a first-seen version."""
        c = self.cols
        k = len(fresh)
        t0, di = s.t0, s.di
        need_maps = s.gv or any(t.task_group for t in fresh)
        vers, grp = self._unit_maps(s) if need_maps else ({}, {})
        nu, nm = s.nu, s.nm
        for i, t in enumerate(fresh):
            row = t0 + s.n + i
            if t.task_group:
                gk = t.task_group_string()
                units = [grp[gk]]
                if s.gv:
                    uv = vers.get(t.version)
                    if uv is None:
                        uv = vers[t.version] = s.u0 + nu
                        c["u_distro"][uv] = di
                        nu += 1
                    units.append(uv)
                seg = s.g0 + s.snames.index(gk)
            elif s.gv:
                uv = vers.get(t.version)
                if uv is None:
                    uv = vers[t.version] = s.u0 + nu
                    c["u_distro"][uv] = di
                    nu += 1
                units = [uv]
                seg = di
            else:
                u = s.u0 + nu
                c["u_distro"][u] = di
                nu += 1
                units = [u]
                seg = di
            for u in units:
                e = s.m0 + nm
                c["m_task"][e] = row
                c["m_unit"][e] = u
                c["m_valid"][e] = 1
                nm += 1
            c["t_seg"][row] = seg
            c["t_distro"][row] = di
            c["t_valid"][row] = 1
            c["t_deps_met"][row] = deps_met.get(t.id, True)
            s.row_of[t.id] = s.n + i
            self.slot_tasks[row] = t
        self._pack_static_rows(t0 + s.n, fresh)
        for name in ("t_seg", "t_distro", "t_valid", "t_deps_met"):
            self._mark(name, t0 + s.n, t0 + s.n + k)
        for name in ("m_task", "m_unit", "m_valid"):
            self._mark(name, s.m0 + s.nm, s.m0 + nm)
        self._mark("u_distro", s.u0 + s.nu, s.u0 + nu)
        s.rows.extend(range(s.n, s.n + k))
        s.n += k
        s.nu, s.nm = nu, nm
        s.tasks = new_list
        c["d_task_count"][s.di] = len(new_list)
        self._mark("d_task_count", s.di, s.di + 1)
        self.n_valid += k
        self.delta_rows += k
        self.fast_appends += 1

    def _rebuild_distro(
        self, s: _Slab, d: Distro, new_list: List[Task],
        deps_met: Dict[str, bool],
    ) -> None:
        n_new = len(new_list)
        if n_new > s.tcap:
            raise _NeedRelayout(f"tasks:{s.did}")
        gv = bool(d.planner_settings.group_versions)
        c = self.cols
        t0 = s.t0
        seg_slice = c["t_seg"][t0:t0 + n_new] if n_new else np.zeros(
            1, np.int32
        )
        dm_slice = c["t_deps_met"][t0:t0 + n_new] if n_new else np.ones(
            1, np.uint8
        )
        nu, mt_arr, mu_arr, snames, smax = pack_memberships(
            get_evgpack(), d, new_list, t0, s.u0, s.di, s.g0, seg_slice,
            deps_met, dm_slice,
        )
        if nu > s.ucap or len(mt_arr) > s.mcap:
            raise _NeedRelayout(f"units-or-edges:{s.did}")
        if len(snames) + len(s.hseg_names) > s.gcap:
            raise _NeedRelayout(f"segments:{s.did}")

        # static columns: splice surviving instances' rows, repack only
        # replaced/new instances
        keep_src: List[int] = []
        keep_dst: List[int] = []
        pack_tasks: List[Task] = []
        pack_rows: List[int] = []
        old_row_of = s.row_of
        slot = self.slot_tasks
        for j, t in enumerate(new_list):
            r = old_row_of.get(t.id)
            if r is not None and slot[t0 + r] is t:
                if r != j:
                    keep_src.append(t0 + r)
                    keep_dst.append(t0 + j)
            else:
                pack_tasks.append(t)
                pack_rows.append(t0 + j)
        if keep_src:
            src = np.asarray(keep_src, np.int64)
            dst = np.asarray(keep_dst, np.int64)
            for name in _STATIC_ARENA_COLS:
                col = c[name]
                col[dst] = col[src]
            self.t_basis[dst] = self.t_basis[src]
            self.t_start[dst] = self.t_start[src]
            self.t_expf[dst] = self.t_expf[src]
        for j in range(s.n):
            slot[t0 + j] = None
        for j, t in enumerate(new_list):
            slot[t0 + j] = t
        if pack_tasks:
            self._pack_static_scatter(pack_rows, pack_tasks)

        # memberships
        if len(mt_arr):
            msl = slice(s.m0, s.m0 + len(mt_arr))
            c["m_task"][msl] = mt_arr
            c["m_unit"][msl] = mu_arr
            c["m_valid"][msl] = 1
        tail = slice(s.m0 + len(mt_arr), s.m0 + s.nm)
        c["m_valid"][tail] = 0
        c["m_task"][tail] = 0
        c["m_unit"][tail] = 0
        for name in ("m_task", "m_unit", "m_valid"):
            self._mark(name, s.m0, s.m0 + max(len(mt_arr), s.nm))

        # units
        if nu:
            c["u_distro"][s.u0:s.u0 + nu] = s.di
        self._mark("u_distro", s.u0, s.u0 + max(nu, s.nu))

        # validity + row columns
        if n_new:
            c["t_valid"][t0:t0 + n_new] = 1
            c["t_distro"][t0:t0 + n_new] = s.di
        old_hw, old_live = s.n, len(s.tasks)
        if old_hw > n_new:
            tl = slice(t0 + n_new, t0 + old_hw)
            c["t_valid"][tl] = 0
            self.t_basis[tl] = 0.0
            self.t_start[tl] = 0.0
            self.t_expf[tl] = 0.0
        hi = t0 + max(old_hw, n_new)
        for name in ("t_valid", "t_distro", "t_seg", "t_deps_met"):
            self._mark(name, t0, hi)
        for name in _STATIC_ARENA_COLS:
            self._mark(name, t0, hi)

        self.n_valid += n_new - old_live
        self.delta_rows += len(pack_tasks)
        self.distro_rebuilds += 1
        s.n, s.nu, s.nm = n_new, nu, len(mt_arr)
        s.tasks = new_list
        s.rows = list(range(n_new))
        s.row_of = {t.id: j for j, t in enumerate(new_list)}
        s.snames, s.smax = list(snames), list(smax)
        s.gv = gv
        s.vers_unit = s.grp_unit = None  # membership ids changed
        s.dep_targets = {
            dep.task_id for t in new_list for dep in t.depends_on
        }
        # segment slab: task segments first (build order), then any
        # host-introduced segments still referenced by this distro's hosts
        s.hseg_names = []
        self._write_seg_slab(s)
        self._reattach_host_segs(s)
        c["d_task_count"][s.di] = n_new
        self._mark("d_task_count", s.di, s.di + 1)

    # ------------------------------------------------------------------ #
    # segments + hosts
    # ------------------------------------------------------------------ #

    def _write_seg_slab(self, s: _Slab) -> None:
        """(Re)write the distro's named-segment slab rows + the global
        seg_names table from ``s.snames``/``s.hseg_names``. A ``None``
        name is a tombstone: its position is kept — later segments' ids
        must not shift — but the row stays invalid."""
        c = self.cols
        names = list(s.snames) + list(s.hseg_names)
        smax = list(s.smax) + [0] * len(s.hseg_names)
        k = len(names)
        sl = slice(s.g0, s.g0 + k)
        if k:
            c["g_distro"][sl] = s.di
            c["g_unnamed"][sl] = 0
            c["g_max_hosts"][sl] = smax
            c["g_valid"][sl] = np.asarray(
                [nm is not None for nm in names], np.uint8
            )
        tail = slice(s.g0 + k, s.g0 + s.gcap)
        c["g_valid"][tail] = 0
        c["g_max_hosts"][tail] = 0
        for i, nm in enumerate(names):
            self.seg_names[s.g0 + i] = (
                (s.di, nm) if nm is not None else (-1, "")
            )
        for i in range(k, s.gcap):
            self.seg_names[s.g0 + i] = (-1, "")
        for name in ("g_distro", "g_unnamed", "g_max_hosts", "g_valid"):
            self._mark(name, s.g0, s.g0 + s.gcap)

    def _seg_id_for(self, s: _Slab, name: str) -> int:
        """Global segment id for a named group within the distro's slab,
        appending a host-introduced segment row when the name is new."""
        try:
            return s.g0 + s.snames.index(name)
        except ValueError:
            pass
        try:
            return s.g0 + len(s.snames) + s.hseg_names.index(name)
        except ValueError:
            pass
        if s.ng + 1 > s.gcap:
            raise _NeedRelayout(f"segments:{s.did}")
        s.hseg_names.append(name)
        gi = s.g0 + s.ng - 1
        c = self.cols
        c["g_distro"][gi] = s.di
        c["g_unnamed"][gi] = 0
        c["g_max_hosts"][gi] = 0
        c["g_valid"][gi] = 1
        self.seg_names[gi] = (s.di, name)
        for col in ("g_distro", "g_unnamed", "g_max_hosts", "g_valid"):
            self._mark(col, gi, gi + 1)
        return gi

    def _reattach_host_segs(self, s: _Slab) -> None:
        """After a task-segment rewrite, re-register the named segments
        this distro's RUNNING hosts occupy and refresh their h_seg rows."""
        c = self.cols
        for row_local, name in s.host_named:
            c["h_seg"][s.h0 + row_local] = self._seg_id_for(s, name)
            self._mark("h_seg", s.h0 + row_local, s.h0 + row_local + 1)

    def _fill_host_rows(
        self, s: _Slab, hs: list, running_estimates: Dict[str, object]
    ) -> None:
        if len(hs) > s.hcap:
            raise _NeedRelayout(f"hosts:{s.did}")
        c = self.cols
        h0, di = s.h0, s.di
        s.host_named = []
        for i, h in enumerate(hs):
            row = h0 + i
            est = running_estimates.get(h.id) if h.running_task else None
            c["h_valid"][row] = 1
            c["h_distro"][row] = di
            c["h_free"][row] = 1 if h.is_free() else 0
            c["h_running"][row] = 1 if est is not None else 0
            if est is not None:
                c["h_expected_s"][row] = est.expected_s
                c["h_std_s"][row] = est.std_dev_s
                self.h_start[row] = (
                    est.start_s if est.start_s > 0.0 else -est.elapsed_s
                )
                c["h_elapsed_s"][row] = est.elapsed_s
            else:
                c["h_expected_s"][row] = 0.0
                c["h_std_s"][row] = 0.0
                c["h_elapsed_s"][row] = 0.0
                self.h_start[row] = 0.0
            if h.running_task and h.running_task_group:
                name = h.task_group_string()
                s.host_named.append((i, name))
                c["h_seg"][row] = self._seg_id_for(s, name)
            else:
                c["h_seg"][row] = di
        if s.nh > len(hs):
            tail = slice(h0 + len(hs), h0 + s.nh)
            c["h_valid"][tail] = 0
            c["h_running"][tail] = 0
            c["h_free"][tail] = 0
            self.h_start[tail] = 0.0
        hi = h0 + max(len(hs), s.nh)
        for name in (
            "h_valid", "h_distro", "h_free", "h_running", "h_elapsed_s",
            "h_expected_s", "h_std_s", "h_seg",
        ):
            self._mark(name, h0, hi)
        s.nh = len(hs)
        s.host_objs = list(hs)
        # prune orphaned host segments: if a previously host-introduced
        # name is no longer occupied, rewrite the seg slab without it so
        # the plane matches a from-scratch build
        live = {nm for _, nm in s.host_named}
        if any(nm not in live for nm in s.hseg_names):
            s.hseg_names = []
            self._write_seg_slab(s)
            self._reattach_host_segs(s)

    # ------------------------------------------------------------------ #
    # distro settings
    # ------------------------------------------------------------------ #

    def _update_distro_settings(self, s: _Slab, d: Distro) -> None:
        gv = bool(d.planner_settings.group_versions)
        if gv != s.gv:
            # membership semantics changed: unit formation must rerun for
            # the whole distro — the cheapest sound answer is a relayout
            raise _NeedRelayout(f"group-versions:{s.did}")
        # reuse the shared settings fill on a 1-row window of the columns
        view = {
            name: col[s.di:s.di + 1]
            for name, col in self._bool_view_cols().items()
            if name.startswith("d_")
        }
        pack_distro_settings(view, [d])
        s.dobj = d
        for name in view:
            self._mark(name, s.di, s.di + 1)

    # ------------------------------------------------------------------ #
    # per-tick refresh + publish
    # ------------------------------------------------------------------ #

    def _pack_static_rows(self, row0: int, tasks: List[Task]) -> None:
        """Pack static columns for ``tasks`` into rows [row0, row0+n)."""
        if not tasks:
            return
        scols = _pack_static(tasks, get_evgpack())
        sl = slice(row0, row0 + len(tasks))
        c = self.cols
        for name in _STATIC_ARENA_COLS:
            c[name][sl] = scols[name]
            self._mark(name, row0, row0 + len(tasks))
        self.t_expf[sl] = scols["t_expected_floor_s"]
        self.t_basis[sl] = scols["t_basis"]
        self.t_start[sl] = scols["t_start"]

    def _pack_static_scatter(
        self, rows: List[int], tasks: List[Task]
    ) -> None:
        scols = _pack_static(tasks, get_evgpack())
        idx = np.asarray(rows, np.int64)
        c = self.cols
        for name in _STATIC_ARENA_COLS:
            c[name][idx] = scols[name]
        self.t_expf[idx] = scols["t_expected_floor_s"]
        self.t_basis[idx] = scols["t_basis"]
        self.t_start[idx] = scols["t_start"]
        for r in rows:
            for name in _STATIC_ARENA_COLS:
                self._mark(name, r, r + 1)

    def _refresh_time_columns(self, now: float) -> None:
        """The only per-tick recompute: time-in-queue, dependency-wait,
        the three per-unit rank terms, and running-host elapsed — the
        exact arithmetic of build_snapshot (f64 bases, f64 sums, f32
        stores) so resident values stay bit-identical to a cold build."""
        c = self.cols
        basis, start = self.t_basis, self.t_start
        tiq = np.where(
            basis > 0.0,
            np.minimum(
                np.maximum(0.0, now - basis), MAX_TASK_TIME_IN_QUEUE_S
            ),
            0.0,
        )
        np.floor(tiq, out=tiq)
        c["t_time_in_queue_s"][:] = tiq
        c["t_wait_dep_met_s"][:] = np.where(
            start > 0.0, np.maximum(0.0, now - start), 0.0
        )
        U = self.dims["U"]
        mt, mu = c["m_task"], c["m_unit"]
        mv64 = c["m_valid"].astype(np.float64)
        # the f32-rounded column re-upcast to f64 feeds the sums, as in
        # the cold build
        tiq64 = c["t_time_in_queue_s"].astype(np.float64)
        expf64 = self.t_expf.astype(np.float64)
        u_tiq = np.bincount(mu, weights=tiq64[mt] * mv64, minlength=U)[:U]
        u_exp = np.bincount(mu, weights=expf64[mt] * mv64, minlength=U)[:U]
        u_len = np.maximum(np.bincount(mu, weights=mv64, minlength=U)[:U], 1.0)
        c["u_tiq_term"][:] = np.floor((u_tiq / 60.0) / u_len)
        avg = u_tiq / u_len
        c["u_mainline_hours"][:] = np.where(
            avg < _WEEK_S, np.trunc((_WEEK_S - avg) / 3600.0), 0.0
        )
        c["u_runtime_term"][:] = np.floor((u_exp / 60.0) / u_len)
        running = c["h_running"].view(np.bool_)
        c["h_elapsed_s"][:] = np.where(
            running,
            np.where(
                self.h_start > 0.0,
                np.maximum(0.0, now - self.h_start),
                -self.h_start,  # unknown start: keep the sampled elapsed
            ),
            0.0,
        )
        self._mark_whole(_TIME_COLS)

    def _set_capacity_page(self, page) -> None:
        """Refresh (or clear) the fused-capacity page columns in place —
        never a rebuild trigger, and the mirror ships only these spans."""
        pack_capacity_page(self.cols, page)
        self._mark_whole(("p_price", "p_quota", "c_cfg"))

    def _publish(self, now: float, arena_pool) -> Snapshot:
        """Hand the device mirror the dirty spans, or copy the truth into
        a leased arena (the solve must never alias the mutable truth)."""
        if self._mirror is not None:
            dev_bufs = self._mirror.sync(self._truth.buffers, self._spans)
            self._spans = {}
            arena = _MirrorArena(self._truth, dev_bufs)
        else:
            with Tracer(self._store(), "resident").span("arena_lease"):
                arena = arena_for_dims(self.dims, arena_pool)
            for kind, buf in arena.buffers.items():
                np.copyto(buf, self._truth.buffers[kind])
        arrays = {
            name: (
                arena.view(name).view(np.bool_)
                if FIELD_KINDS[name] == "u8" else arena.view(name)
            )
            for name in FIELD_KINDS
        }
        return Snapshot(
            now=now,
            distro_ids=self.distro_ids,
            task_ids=[],
            host_ids=[],
            seg_names=list(self.seg_names),
            n_tasks=self.n_valid,
            n_units=sum(s.nu for s in self._slabs),
            n_hosts=sum(s.nh for s in self._slabs),
            n_segs=sum(s.ng for s in self._slabs) + len(self._slabs),
            n_distros=len(self.distro_ids),
            arrays=arrays,
            arena=arena,
            flat_tasks=self.slot_tasks,
        )


class _MirrorArena:
    """Arena facade for the mirror path: ``buffers`` are the mirror's
    resident tensors (the packed solve consumes them in place), ``view``
    serves host reads from the truth arena."""

    def __init__(self, truth, dev_bufs) -> None:
        self._truth = truth
        self._bufs = dev_bufs

    @property
    def buffers(self):
        return self._bufs

    def layout_key(self):
        return self._truth.layout_key()

    def view(self, name):
        return self._truth.view(name)

    def close(self) -> None:
        pass


#: per-store plane singletons, keyed weakly like the snapshot memos
_planes: "weakref.WeakKeyDictionary[Store, ResidentPlane]" = weakref.WeakKeyDictionary()
_planes_lock = _lockcheck.make_lock("resident.planes")


def resident_plane_for(store: Store, device=None) -> ResidentPlane:
    """The store's plane, publishing on ``device``: None or a CUDA device
    is the card, through a ``DeviceMirror`` there; "cpu" is a pooled
    arena copy. A plane made for another device is replaced (the new one
    starts with a full rebuild)."""
    dev = resolve_device(device)
    with _planes_lock:
        plane = _planes.get(store)
        if plane is None or plane.device != dev:
            mirror = DeviceMirror(dev) if dev.type == "cuda" else None
            plane = _planes[store] = ResidentPlane(store, mirror=mirror)
        return plane


def peek_resident_plane(store: Store) -> Optional[ResidentPlane]:
    """The plane for ``store`` if one exists — never creates one."""
    with _planes_lock:
        return _planes.get(store)


# --------------------------------------------------------------------------- #
# canonical comparison
# --------------------------------------------------------------------------- #


def canonicalize(snapshot: Snapshot) -> dict:
    """Layout-independent view of a snapshot's semantic content: per-task
    columns in (distro, store-order) sequence, segments by name, units by
    per-distro creation order, membership edges per task. A resident
    snapshot and a contiguous rebuild of the same inputs compare equal
    here — and produce identical solve outputs."""
    a = snapshot.arrays
    valid = np.flatnonzero(np.asarray(a["t_valid"]))
    out = {}
    for name in (
        "t_distro", "t_priority", "t_is_merge", "t_is_patch", "t_stepback",
        "t_generate", "t_in_group", "t_group_order", "t_time_in_queue_s",
        "t_expected_s", "t_wait_dep_met_s", "t_num_dependents",
        "t_deps_met",
    ):
        out[name] = np.asarray(a[name])[valid].tolist()
    seg_names = snapshot.seg_names
    out["t_seg"] = [seg_names[g] for g in np.asarray(a["t_seg"])[valid]]
    out["task_ids"] = [
        t.id for t in (snapshot.flat_tasks[i] for i in valid.tolist())
    ]

    # membership edges per task, units as (distro, per-distro rank)
    mv = np.asarray(a["m_valid"])
    mt = np.asarray(a["m_task"])[mv]
    mu = np.asarray(a["m_unit"])[mv]
    live_units = np.unique(mu)
    u_distro = np.asarray(a["u_distro"])[live_units]
    # rank units within their distro by id (creation order in both
    # layouts)
    rank: Dict[int, Tuple[int, int]] = {}
    counters: Dict[int, int] = {}
    for ui, di in zip(live_units.tolist(), u_distro.tolist()):
        r = counters.get(di, 0)
        counters[di] = r + 1
        rank[ui] = (di, r)
    row_pos = {int(r): p for p, r in enumerate(valid.tolist())}
    edges: Dict[int, list] = {}
    for ti, ui in zip(mt.tolist(), mu.tolist()):
        edges.setdefault(row_pos[ti], []).append(rank[ui])
    out["edges"] = [edges.get(p, []) for p in range(len(valid))]
    for name in ("u_tiq_term", "u_mainline_hours", "u_runtime_term"):
        col = np.asarray(a[name])[live_units]
        out[name] = [
            (rank[ui], float(v))
            for ui, v in zip(live_units.tolist(), col.tolist())
        ]

    # segments by (distro, name)
    gidx = np.flatnonzero(np.asarray(a["g_valid"]))
    out["segments"] = sorted(
        (
            seg_names[g],
            bool(np.asarray(a["g_unnamed"])[g]),
            int(np.asarray(a["g_max_hosts"])[g]),
        )
        for g in gidx.tolist()
    )

    # hosts in distro-major slab order
    hvalid = np.flatnonzero(np.asarray(a["h_valid"]))
    for name in (
        "h_distro", "h_free", "h_running", "h_elapsed_s", "h_expected_s",
        "h_std_s",
    ):
        out[name] = np.asarray(a[name])[hvalid].tolist()
    out["h_seg"] = [seg_names[g] for g in np.asarray(a["h_seg"])[hvalid]]

    # distro settings
    n_d = snapshot.n_distros
    for name in FIELD_KINDS:
        if name.startswith("d_") and name != "d_task_count":
            out[name] = np.asarray(a[name])[:n_d].tolist()
    return out
