"""Queue persister — write the ordered plan as a TaskQueue doc per distro.

A copy of ``evergreen_tpu/scheduler/persister.py``. Reference:
scheduler/task_queue_persister.go:17-84 (PersistTaskQueue +
capTaskQueueLength). The cap keeps straddling task groups whole: if the
cut point lands inside a task-group run, the whole group straddling the
boundary is retained.

Delta persistence: the store path scales with CHURN size, not queue
size. A per-distro fingerprint (``PersisterState``) remembers the last
written plan (by task-instance identity), the dynamic columns, and the
doc object itself. Per tick each distro then takes one of four write
shapes:

  * skip         — plan, sort values, deps-met AND info all unchanged: no
                   write at all (``generated_at`` intentionally stays put)
  * column patch — same plan, changed dynamics: a versioned field patch
                   (``Collection.patch`` / ``patch_list``) of only
                   sort_value / dependencies_met / info / generated_at
  * row splice   — plan membership/order changed: removals, inserts and
                   changed rows (``Collection.splice_queue``)
  * full rewrite — no usable fingerprint: the whole-doc upsert.

Every shape but a skip wakes the agents parked on the store's long-poll
hub, when it has one (``dispatch/longpoll.py``).

``reset()`` drops every fingerprint, so the next tick full-rewrites.
"""
from __future__ import annotations

import operator as _operator
import time as _time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..globals import ALIAS_SUFFIX
from ..models import task as task_mod
from ..models import task_queue as tq_mod
from ..models.task import Task
from ..models.task_queue import DistroQueueInfo, QueueInfoView
from ..storage.store import Store
from ..utils import lockcheck as _lockcheck


class _Fingerprint:
    __slots__ = ("plan", "rows_plan", "rows", "row_index", "order",
                 "order_np", "sort", "met", "info_key", "doc", "v", "cand")

    def __init__(self) -> None:
        self.plan: List[Task] = []
        #: row tuples in PLAN order (identity-compared against next tick)
        self.rows_plan: list = []
        #: row tuples in the doc's canonical id-sorted order
        self.rows: list = []
        #: task id -> index into the sorted rows
        self.row_index: Dict[str, int] = {}
        #: plan position -> sorted row index (the doc's ``order`` field)
        self.order: list = []
        self.order_np = None
        #: dynamic columns ALIGNED WITH THE SORTED ROWS (numpy)
        self.sort = None
        self.met = None
        self.info_key = None
        self.doc: Optional[dict] = None
        self.v = -1
        #: last tick's mark-scheduled candidates — reusable whenever the
        #: plan instances AND the deps-met column are unchanged (the scan
        #: reads only those); None = must rescan
        self.cand: Optional[list] = None


class PersisterState:
    """Per-store delta-persist memory: one fingerprint per
    (distro, secondary) queue doc."""

    def __init__(self) -> None:
        self._fps: Dict[Tuple[str, bool], _Fingerprint] = {}
        #: write-shape counters, exposed for tests/bench introspection
        self.skipped = 0
        self.patched = 0
        self.rewritten = 0
        #: row-level splices (membership/order churn persisted as a
        #: delta instead of a full rewrite) — a "patch" in spirit
        self.spliced = 0
        #: current + previous tick's solve info columns, the global
        #: "nothing in any distro's info changed" verdict, and both
        #: ticks' distro/segment index maps (for the per-distro fallback
        #: compare when the global verdict is dirty)
        self._cur_info_cols: Optional[dict] = None
        self._prev_info_cols: Optional[dict] = None
        self._cur_did_index: Dict[str, int] = {}
        self._prev_did_index: Dict[str, int] = {}
        self._cur_seg_ids: Dict[int, list] = {}
        self._prev_seg_ids: Dict[int, list] = {}
        self.infos_static = False

    def reset(self) -> None:
        """Invalidate every fingerprint: the next tick full-rewrites
        every queue doc before patching again."""
        self._fps.clear()
        self._cur_info_cols = None
        self._prev_info_cols = None
        self._cur_did_index = {}
        self._prev_did_index = {}
        self._cur_seg_ids = {}
        self._prev_seg_ids = {}
        self.infos_static = False

    def note_solve_infos(
        self,
        cols: Optional[dict],
        distro_ids: Optional[list] = None,
        seg_ids_by_di: Optional[Dict[int, list]] = None,
    ) -> None:
        """One whole-tick info comparison instead of ~11k per-segment
        fingerprints: the solve's raw info columns (shared by every
        QueueInfoView of the tick) are compared wholesale against the
        previous tick's. Equal ⇒ EVERY distro's info doc is unchanged, so
        per-distro skip decisions reduce to plan/sort/met checks; unequal
        ⇒ ``info_static_for`` falls back to a per-distro compare over the
        kept index maps. A serial-fallback tick (cols=None) clears the
        epoch — the next solve tick trusts nothing."""
        prev = self._cur_info_cols
        self._prev_info_cols = prev
        self._prev_did_index = self._cur_did_index
        self._prev_seg_ids = self._cur_seg_ids
        self._cur_info_cols = cols
        self._cur_did_index = (
            {did: di for di, did in enumerate(distro_ids)}
            if cols is not None and distro_ids is not None else {}
        )
        self._cur_seg_ids = dict(seg_ids_by_di or {})
        if cols is None or prev is None or prev.keys() != cols.keys():
            self.infos_static = False
        else:
            self.infos_static = all(prev[k] == cols[k] for k in cols)

    _D_KEYS = (
        "d_length", "d_deps_met", "d_merge", "d_expected_dur_s",
        "d_thresh_s", "d_over_count", "d_over_dur_s", "d_wait_over",
    )
    _G_KEYS = (
        "g_count", "g_max_hosts", "g_expected_dur_s", "g_count_free",
        "g_count_required", "g_over_count", "g_wait_over", "g_merge",
        "g_over_dur_s",
    )

    def info_static_for(self, view: QueueInfoView, did: str) -> bool:
        """Is this one distro's info unchanged since the previous solve
        tick? Cheap positive answer when the global epoch is clean;
        otherwise an O(segments-of-distro) compare against the previous
        tick's columns (still never builds a doc)."""
        if self.infos_static:
            return True
        prev = self._prev_info_cols
        cur = view._c
        if prev is None or cur is not self._cur_info_cols:
            return False
        pdi = self._prev_did_index.get(did)
        if pdi is None:
            return False
        di = view._di
        for k in self._D_KEYS:
            col = prev[k]
            if pdi >= len(col) or col[pdi] != cur[k][di]:
                return False
        prev_ids = self._prev_seg_ids.get(pdi)
        cur_ids = view._seg_ids
        if prev_ids is None or len(prev_ids) != len(cur_ids):
            return False
        pnames, cnames = prev["seg_names"], cur["seg_names"]
        for pg, cg in zip(prev_ids, cur_ids):
            if pnames[pg][1] != cnames[cg][1]:
                return False
            for k in self._G_KEYS:
                if prev[k][pg] != cur[k][cg]:
                    return False
        return True


#: per-store PersisterState singletons (keyed weakly, like the
#: scheduler's snapshot memos in wrapper.py)
_states: "weakref.WeakKeyDictionary[Store, PersisterState]" = weakref.WeakKeyDictionary()
_states_lock = _lockcheck.make_lock("persister.states")


def persister_state_for(store: Store) -> PersisterState:
    with _states_lock:
        state = _states.get(store)
        if state is None:
            state = _states[store] = PersisterState()
        return state


def fingerprint_version(
    store: Store, distro_id: str, secondary: bool = False
) -> Optional[int]:
    """The delta persister's in-memory version watermark for one queue
    doc, or None when this store has no live fingerprint (the caller
    falls back to the doc's own ``v``). Every content-changing write
    shape bumps it and a skip leaves it, so an unchanged token
    certifies an unchanged document."""
    with _states_lock:
        state = _states.get(store)
    if state is None:
        return None
    fp = state._fps.get((distro_id, secondary))
    return fp.v if fp is not None and fp.v >= 0 else None


def _plan_col(values, rows_plan, default, dtype) -> "np.ndarray":
    """Dynamic column in PLAN order as numpy: id-keyed dict (serial/cmp
    paths) or a positionally aligned sequence (the solve's unpack)."""
    n = len(rows_plan)
    if isinstance(values, dict):
        return np.asarray(
            [values.get(r[0], default) for r in rows_plan], dtype
        )
    arr = np.asarray(values[:n], dtype)
    if len(arr) < n:
        arr = np.concatenate(
            [arr, np.full(n - len(arr), default, dtype)]
        )
    return arr


_ROW_ID = _operator.itemgetter(0)


def persist_task_queue(
    store: Store,
    distro_id: str,
    plan: List[Task],
    sort_values: Union[Dict[str, float], Sequence[float]],
    deps_met: Union[Dict[str, bool], Sequence[bool]],
    info: Union[DistroQueueInfo, QueueInfoView],
    max_scheduled_per_distro: int = 0,
    secondary: bool = False,
    now: Optional[float] = None,
    state: Optional[PersisterState] = None,
    stamp_hint=None,
) -> int:
    """Persist the plan; returns the number of queue items written.

    ``sort_values`` and ``deps_met`` are either id-keyed mappings
    (serial/cmp paths) or sequences positionally aligned with ``plan``
    (the batched solve's unpack, which avoids materializing 50k-entry
    dicts every tick). Passing ``state`` enables delta persistence.

    The doc's canonical layout keeps ``rows`` (and the two dynamic
    columns) sorted by task id with an ``order`` permutation back into
    plan order — stateless, so a resumed delta run and a cold rerun
    write byte-identical docs, and a churn tick's membership/reorder
    changes persist as a row SPLICE + column patch instead of a full
    rewrite. Write shapes per distro per tick:

      * skip          — nothing changed, no write at all
      * column patch  — same rows, changed dynamics: sparse element
                        patch (few changed entries) or whole-field patch
      * row splice    — plan membership/order changed: removals, inserts
                        and changed rows are written as a delta
      * full rewrite  — no usable fingerprint (or the delta would exceed
                        half the doc): the classic whole-doc upsert

    ``stamp_hint`` (the TickCache's per-distro unstamped id set) lets the
    mark-scheduled candidate scan collapse to the handful of fresh tasks.
    """
    now = _time.time() if now is None else now
    n_full = len(plan)
    cut = _cap_cut(plan, max_scheduled_per_distro)
    if cut < n_full:
        plan = plan[:cut]

    c = _coll(store, secondary)
    key = (distro_id, secondary)
    fp = state._fps.get(key) if state is not None else None
    if fp is not None and c.get(distro_id) is not fp.doc:
        # the doc was rewritten/removed behind our back (tests, another
        # writer) — the fingerprint no longer describes it
        fp = None
    same_plan = (
        fp is not None
        and len(fp.plan) == len(plan)
        and all(map(_operator.is_, fp.plan, plan))
    )

    # Row-major persist: each row IS Task.queue_row()'s memoized tuple
    # (models/task_queue.py ROW_FIELDS); an unchanged plan reuses the
    # whole plan-order rows list from the fingerprint.
    rows_plan = (
        fp.rows_plan if same_plan else [t.queue_row() for t in plan]
    )
    if not same_plan and fp is not None and rows_plan == fp.rows_plan:
        # instances were replaced but every queue row is content-identical
        # (the common shape right after mark_scheduled stamps dirty the
        # docs): the doc's rows need no write — adopt the new instances
        # and fall through to the patch/skip paths
        same_plan = True
        fp.plan = plan
        fp.cand = None  # task attributes may have moved — rescan below
        rows_plan = fp.rows_plan
    n_rows = len(rows_plan)

    sort_plan = _plan_col(sort_values, rows_plan, 0.0, np.float64)
    met_plan = _plan_col(deps_met, rows_plan, True, np.bool_)

    is_view = isinstance(info, QueueInfoView)
    # "is the info unchanged?": the view path asks the whole-tick epoch
    # (falling back to a per-distro column compare); the serial/cmp
    # dataclass path compares its flattened doc directly
    if is_view:
        info_doc_dc = None
        info_static = False
        if state is not None and same_plan:
            did = distro_id + ALIAS_SUFFIX if secondary else distro_id
            info_static = state.info_static_for(info, did)
    else:
        info_doc_dc = _info_doc(info)
        info_static = fp is not None and info_doc_dc == fp.info_key

    same_met = False
    handled = False
    skipped_write = False

    if same_plan:
        # project the plan-order columns into the doc's sorted alignment
        sort_sorted = np.empty(n_rows, np.float64)
        met_sorted = np.empty(n_rows, np.bool_)
        if n_rows:
            sort_sorted[fp.order_np] = sort_plan
            met_sorted[fp.order_np] = met_plan
        sort_changed = not np.array_equal(sort_sorted, fp.sort)
        met_changed = not np.array_equal(met_sorted, fp.met)
        same_met = not met_changed
        if not sort_changed and not met_changed and info_static:
            # untouched distro: nothing to write
            if state is not None:
                state.skipped += 1
            handled = True
            skipped_write = True
        else:
            # only dynamic columns moved: a versioned patch of JUST the
            # changed fields — sparse when few entries moved, so the write
            # scales with churn, never with queue size
            new_v = fp.v + 1
            fields = {"generated_at": now, "v": new_v}
            if not info_static:
                fields["info"] = info.doc() if is_view else info_doc_dc
            elems = {}
            for name, changed, new_col, old_col, cast in (
                ("sort_value", sort_changed, sort_sorted, fp.sort, float),
                ("dependencies_met", met_changed, met_sorted, fp.met,
                 bool),
            ):
                if not changed:
                    continue
                diff = np.flatnonzero(new_col != old_col)
                if len(diff) * 3 < n_rows:
                    elems[name] = (
                        [int(i) for i in diff],
                        [cast(new_col[i]) for i in diff],
                    )
                else:
                    fields[name] = new_col.tolist()
            ok = (
                c.patch_list(distro_id, elems, fields)
                if elems else c.patch(distro_id, fields)
            )
            if ok:
                fp.sort = sort_sorted
                fp.met = met_sorted
                if not info_static:
                    fp.info_key = None if is_view else info_doc_dc
                fp.v = new_v
                if state is not None:
                    state.patched += 1
                handled = True
            else:  # doc vanished/diverged between check and patch
                fp = None
                same_met = False

    if not handled and fp is not None and n_rows:
        handled = _persist_splice(
            c, distro_id, fp, plan, rows_plan, sort_plan, met_plan,
            info, is_view, info_doc_dc, info_static, now, state,
        )

    if not handled:
        _persist_rewrite(
            c, distro_id, key, plan, rows_plan, sort_plan, met_plan,
            info, is_view, info_doc_dc, now, state, fp,
        )

    # Candidate pre-filter on the materialized Task attributes: in steady
    # state every planned task is already stamped, so the per-task store
    # get() round (50k/tick at config-3 scale) collapses to zero. The
    # TickCache's ``stamp_hint`` set short-circuits even the scan; with
    # no hint, the scan is skipped whenever plan instances AND the
    # deps-met column are unchanged (the two inputs it reads), reusing
    # last tick's candidates. mark_scheduled re-checks live docs before
    # mutating, so a stale candidate is harmless.
    fp = state._fps.get(key) if state is not None else fp
    if stamp_hint is not None and cut >= n_full and not stamp_hint:
        cand = []
    elif (
        stamp_hint is not None and fp is not None
        and fp.row_index is not None
    ):
        # scan ONLY the hinted ids: met rides in the fingerprint's
        # id-sorted column, membership in row_index doubles as the
        # post-cut plan filter, and mark_scheduled re-checks live docs
        # so over-inclusion is harmless (sorted for a deterministic
        # write order)
        idx, met_col = fp.row_index, fp.met
        cand = [
            (tid, bool(met_col[i]))
            for tid in sorted(stamp_hint)
            for i in (idx.get(tid),)
            if i is not None
        ]
    elif fp is not None and same_met and fp.cand is not None:
        cand = fp.cand
    else:
        met_list = met_plan.tolist()
        cand = [
            (t.id, met)
            for t, met in zip(plan, met_list)
            if t.scheduled_time <= 0.0
            or (met and t.dependencies_met_time <= 0.0)
        ]
        if fp is not None:
            fp.cand = cand
    if cand:
        task_mod.mark_scheduled(
            store, [tid for tid, _ in cand], now,
            deps_met_ids=[tid for tid, met in cand if met],
        )
    if not skipped_write:
        # a persisted content change is the scheduler-side arrival
        # signal for parked long-pollers (dispatch/longpoll.py): wake a
        # BOUNDED probe cohort — the ledger plus the completer sweep
        # (an agent that finishes a task pulls again) drain anything
        # deeper, and under-estimation decays via re-check claims
        hub = getattr(store, "_longpoll_hub", None)
        if hub is not None:
            hub.notify(
                distro_id, n_hint=min(32, max(1, len(plan) // 8))
            )
    return len(plan)


def _sorted_layout(rows_plan: list):
    """Canonical id-sorted layout for plan-order rows: (sorted rows,
    id → sorted index, plan-position → sorted-index order list). Returns
    None when ids are not unique (legacy plan-order layout then)."""
    n = len(rows_plan)
    rows_sorted = sorted(rows_plan, key=_ROW_ID)
    index = {r[0]: i for i, r in enumerate(rows_sorted)}
    if len(index) != n:
        return None
    order = [index[r[0]] for r in rows_plan]
    return rows_sorted, index, order


def _persist_splice(
    c, distro_id, fp, plan, rows_plan, sort_plan, met_plan, info,
    is_view, info_doc_dc, info_static, now, state,
) -> bool:
    """Plan membership/order changed but a fingerprint exists: persist
    the change as a row splice + sparse column patch. Returns False when
    a full rewrite is the better (or only sound) shape. The ``order``
    permutation is written whole: any membership change shifts most
    plan positions."""
    if fp.doc is None or "order" not in fp.doc:
        return False  # legacy plan-order doc (duplicate ids): rewrite
    layout = _sorted_layout(rows_plan)
    if layout is None:
        return False
    rows_sorted, index, order = layout
    n_rows = len(rows_plan)
    old_rows, old_index = fp.rows, fp.row_index
    rm_idx = [
        i for i, r in enumerate(old_rows) if r[0] not in index
    ]
    order_np = np.asarray(order, np.int64)
    sort_sorted = np.empty(n_rows, np.float64)
    met_sorted = np.empty(n_rows, np.bool_)
    sort_sorted[order_np] = sort_plan
    met_sorted[order_np] = met_plan

    inserts = []
    row_elem_idx: List[int] = []
    row_elem_val: list = []
    surv_i: List[int] = []
    surv_j: List[int] = []
    for i, r in enumerate(rows_sorted):
        j = old_index.get(r[0])
        if j is None:
            inserts.append(
                (i, r, float(sort_sorted[i]), bool(met_sorted[i]))
            )
        else:
            old_r = old_rows[j]
            if r is not old_r and r != old_r:
                row_elem_idx.append(i)
                row_elem_val.append(r)
            surv_i.append(i)
            surv_j.append(j)
    # survivors keep their (possibly stale) dynamic values through the
    # splice; anything differing afterwards rides as a sparse patch
    # (gathered as ONE fancy-indexed copy — per-element numpy scalar
    # stores measured ~40% of the splice cost at 50k-task scale)
    exp_sort = sort_sorted.copy()
    exp_met = met_sorted.copy()
    if surv_i:
        si = np.asarray(surv_i, np.int64)
        sj = np.asarray(surv_j, np.int64)
        exp_sort[si] = fp.sort[sj]
        exp_met[si] = fp.met[sj]
    work = len(rm_idx) + len(inserts) + len(row_elem_idx)
    if work * 2 > max(n_rows, 1):
        return False  # the delta IS the doc: a rewrite writes less

    new_v = fp.v + 1
    fields = {"order": order, "generated_at": now, "v": new_v}
    if not info_static:
        fields["info"] = info.doc() if is_view else info_doc_dc
    elems = {}
    if row_elem_idx:
        elems["rows"] = (row_elem_idx, row_elem_val)
    diff = np.flatnonzero(sort_sorted != exp_sort)
    if len(diff):
        elems["sort_value"] = (
            [int(i) for i in diff], [float(sort_sorted[i]) for i in diff]
        )
    diff = np.flatnonzero(met_sorted != exp_met)
    if len(diff):
        elems["dependencies_met"] = (
            [int(i) for i in diff], [bool(met_sorted[i]) for i in diff]
        )
    if not c.splice_queue(distro_id, rm_idx, inserts, fields, elems or None):
        return False
    fp.plan = plan
    fp.rows_plan = rows_plan
    fp.rows = rows_sorted
    fp.row_index = index
    fp.order = order
    fp.order_np = order_np
    fp.sort = sort_sorted
    fp.met = met_sorted
    if not info_static:
        fp.info_key = None if is_view else info_doc_dc
    fp.v = new_v
    fp.cand = None
    if state is not None:
        if rm_idx or inserts or row_elem_idx:
            state.spliced += 1
        else:
            state.patched += 1
    return True


def _persist_rewrite(
    c, distro_id, key, plan, rows_plan, sort_plan, met_plan, info,
    is_view, info_doc_dc, now, state, fp,
) -> None:
    info_doc = info.doc() if is_view else info_doc_dc
    layout = _sorted_layout(rows_plan)
    n_rows = len(rows_plan)
    if layout is None:
        # duplicate ids: keep the legacy plan-order layout (no ``order``)
        rows_sorted, index = rows_plan, None
        order = list(range(n_rows))
        sort_sorted, met_sorted = sort_plan, met_plan
    else:
        rows_sorted, index, order = layout
        order_np = np.asarray(order, np.int64)
        sort_sorted = np.empty(n_rows, np.float64)
        met_sorted = np.empty(n_rows, np.bool_)
        if n_rows:
            sort_sorted[order_np] = sort_plan
            met_sorted[order_np] = met_plan
    live_v = fp.v if fp is not None else _live_version(c, distro_id)
    new_v = live_v + 1
    doc = {
        "_id": distro_id,
        "distro_id": distro_id,
        "rows": rows_sorted,
        "sort_value": sort_sorted.tolist(),
        "dependencies_met": met_sorted.tolist(),
        "info": info_doc,
        "generated_at": now,
        "v": new_v,
    }
    if layout is not None:
        doc["order"] = order
    c.upsert(doc)
    if state is not None:
        fp = state._fps.get(key)
        if fp is None:
            fp = state._fps[key] = _Fingerprint()
        fp.plan = plan
        fp.rows_plan = rows_plan
        fp.rows = rows_sorted
        fp.row_index = (
            index if index is not None
            else {r[0]: i for i, r in enumerate(rows_plan)}
        )
        fp.order = order
        fp.order_np = np.asarray(order, np.int64)
        fp.sort = np.asarray(sort_sorted, np.float64)
        fp.met = np.asarray(met_sorted, np.bool_)
        fp.info_key = None if is_view else info_doc
        fp.doc = doc
        fp.v = new_v
        fp.cand = None
        state.rewritten += 1


def _live_version(c, distro_id: str) -> int:
    doc = c.get(distro_id)
    v = doc.get("v", -1) if doc else -1
    return v if isinstance(v, int) else -1


def _info_doc(info: DistroQueueInfo) -> dict:
    """Flatten a dataclass DistroQueueInfo into the persisted info doc
    (task_group_infos last — the field order QueueInfoView.doc() and the
    byte-identity tests pin)."""
    return {
        **{k: v for k, v in info.__dict__.items() if k != "task_group_infos"},
        "task_group_infos": [dict(g.__dict__) for g in info.task_group_infos],
    }


def _cap_cut(plan: List[Task], max_len: int) -> int:
    """capTaskQueueLength (task_queue_persister.go:66-84): cut at max_len
    but keep a task group straddling the boundary whole."""
    n = len(plan)
    if max_len <= 0 or n <= max_len:
        return n
    cut = max_len
    straddler = plan[cut - 1].task_group
    if straddler:
        while cut < n and plan[cut].task_group == straddler:
            cut += 1
    return cut


def _coll(store: Store, secondary: bool = False):
    return tq_mod.coll(store, secondary)


def save_doc(store: Store, doc: dict, secondary: bool = False):
    c = _coll(store, secondary)
    c.upsert(doc)
    return c
