"""Distro-sharded stacked solve on one card.

Counterpart of ``evergreen_tpu/parallel/sharded.py``. Distros are
independent scheduling problems, so a shard owns whole distros: each
shard's snapshot holds a balanced subset of distros plus exactly their
tasks, units, segments and hosts, padded to dims common to every shard
so the blocks stack on a leading shard axis.

The JAX package runs the stacked blocks as one ``shard_map`` program over
a device mesh, with no collectives. On one card the same program is the
blocks' solves enqueued back to back (``ops/solve.py::
dispatch_stacked_solve``): one upload per arena kind, one download of
every block's result. ``parallel/mesh.py`` has no counterpart here: one
card needs no mesh.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..device import resolve_device
from ..ops.capacity import C_ITERS, C_VALID
from ..ops.packing import _DTYPES
from ..ops.solve import dispatch_stacked_solve, result_to_host, split_outputs
from ..scheduler.snapshot import (
    _DIM_OF_FIELD,
    _FIXED_DIMS,
    FIELD_KINDS,
    Snapshot,
    _bucket,
    build_snapshot,
    layout_for_dims,
)

_IN_KEYS = tuple(FIELD_KINDS)
_OUT_KEYS = (
    "order", "t_value", "t_unit",
    "t_prio", "t_rank", "t_tiq", "t_stepback",
    "d_new_hosts", "d_free_approx", "d_length", "d_deps_met",
    "d_expected_dur_s", "d_over_count", "d_over_dur_s", "d_wait_over",
    "d_merge",
    "g_count", "g_expected_dur_s", "g_count_free", "g_count_required",
    "g_over_count", "g_over_dur_s", "g_wait_over", "g_merge",
    "cap_x", "aff_pool",
)
_DIM_NAMES = ("N", "M", "U", "G", "H", "D")


def partition_distros(distros: List, tasks_by_distro: Dict, n_shards: int):
    """Greedy balanced partition by task count (largest first; ties to
    the first least-loaded shard)."""
    sized = sorted(
        distros, key=lambda d: len(tasks_by_distro.get(d.id, [])), reverse=True
    )
    shards: List[List] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for d in sized:
        i = loads.index(min(loads))
        shards[i].append(d)
        loads[i] += len(tasks_by_distro.get(d.id, [])) + 1
    return shards


def _partition_stale(group_ids: List[List[str]], distros: List,
                     tasks_by_distro: Dict) -> bool:
    """Re-partition when the distro set changed or the kept assignment
    drifted past twice the mean load."""
    cached_ids = {i for g in group_ids for i in g}
    if cached_ids != {d.id for d in distros}:
        return True
    loads = [
        sum(len(tasks_by_distro.get(i, [])) + 1 for i in g)
        for g in group_ids
    ]
    mean = sum(loads) / max(len(loads), 1)
    return mean > 0 and max(loads) > 2.0 * mean


def build_sharded_snapshot(
    distros: List,
    tasks_by_distro: Dict,
    hosts_by_distro: Dict,
    running_estimates: Dict,
    deps_met: Dict,
    now: float,
    n_shards: int,
    memos: Dict = None,
) -> Tuple[List[Snapshot], Dict[str, np.ndarray]]:
    """(per-shard snapshots, stacked arrays with a leading shard axis),
    every shard padded to the same bucket dims.

    ``memos`` (caller-owned, kept across ticks) holds the sticky distro →
    shard assignment as distro ids under "groups" (kept while balanced)
    and one dims memo per shard under "dims", seeded with the common
    dims, so a steady tick builds each shard once at the common dims."""
    if memos is not None:
        group_ids = memos.get("groups")
        if group_ids is None or len(group_ids) != n_shards or (
            _partition_stale(group_ids, distros, tasks_by_distro)
        ):
            fresh_groups = partition_distros(
                distros, tasks_by_distro, n_shards
            )
            group_ids = [[d.id for d in g] for g in fresh_groups]
            memos["groups"] = group_ids
            memos["dims"] = [dict() for _ in range(n_shards)]
        # live Distro objects are resolved every call, so settings edits
        # between ticks reach the build
        by_id = {d.id: d for d in distros}
        groups = [[by_id[i] for i in g] for g in group_ids]
    else:
        groups = partition_distros(distros, tasks_by_distro, n_shards)

    def one(i: int, group: List, force: Dict = None) -> Snapshot:
        return build_snapshot(
            group,
            {d.id: tasks_by_distro.get(d.id, []) for d in group},
            {d.id: hosts_by_distro.get(d.id, []) for d in group},
            running_estimates,
            deps_met,
            now,
            force_dims=force,
            dims_memo=memos["dims"][i] if memos is not None else None,
        )

    subs = [one(i, g) for i, g in enumerate(groups)]
    # common dims: the bucket of the largest real size per axis
    dims = {
        "N": _bucket(max(max(s.n_tasks for s in subs), 1)),
        "M": _bucket(max(max(len(s.arrays["m_task"]) for s in subs), 1)),
        "U": _bucket(max(max(s.n_units for s in subs), 1)),
        "G": _bucket(max(max(s.n_segs for s in subs), 1)),
        "H": _bucket(max(max(s.n_hosts for s in subs), 1)),
        "D": _bucket(max(max(s.n_distros for s in subs), 1), minimum=8),
    }
    # only the shards whose padded dims differ pay the forced rebuild
    subs = [
        s if dict(zip(_DIM_NAMES, s.shape_key())) == dims
        else one(i, groups[i], force=dims)
        for i, s in enumerate(subs)
    ]
    if memos is not None:
        for dm in memos["dims"]:
            dm.update(dims)
    stacked = {
        name: np.stack([s.arrays[name] for s in subs])
        for name in subs[0].arrays
    }
    return subs, stacked


def _blocks_cap_iters(blocks: Dict[int, Dict]) -> int:
    """The capacity trip count of a stack: the largest over every block's
    packed ``c_cfg`` page (0 when no block carries a live page), clamped
    to [0, 512]. Every block runs it; a block with a smaller or no page
    runs the extra steps as no-ops of its own program."""
    iters = 0
    for b in blocks.values():
        c = b.get("c_cfg")
        if c is None:
            continue
        c = np.asarray(c)
        if c.shape[0] > C_ITERS and float(c[C_VALID]) > 0.0:
            iters = max(iters, int(c[C_ITERS]))
    return max(0, min(iters, 512))


def _block_dims(block: Dict) -> Dict[str, int]:
    """A block's (N, M, U, G, H, D, P, C) dims, read off its field lengths."""
    dims = {}
    for name in _IN_KEYS:
        dims.setdefault(_DIM_OF_FIELD[name[:2]], len(block[name]))
    return dims


class StackedSolveCache:
    """The stacked solve the solver leader serves (``runtime/solver.py``):
    ``{shard: named arrays}`` in, one solve per block at the stack's
    capacity trip count, ``{shard: named numpy outputs}`` out.
    ``device=None`` is the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU. (The name is the JAX package's, whose
    class caches the compiled program; there is nothing to cache here.)"""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)

    def solve_blocks(self, blocks: Dict[int, Dict]) -> Dict[int, Dict]:
        """Shards in sorted order on the stack axis. All blocks must share
        one shape; callers enforce dims agreement themselves."""
        order = sorted(blocks)
        cap_iters = _blocks_cap_iters(blocks)
        dims = _block_dims(blocks[order[0]])
        layout = layout_for_dims(dims)
        # the staging copy takes each block out of its source (a shared-
        # memory segment may change once the round is answered)
        staging = {
            kind: np.empty((len(order), n), _DTYPES[kind])
            for kind, n in layout.sizes().items()
        }
        for i, shard in enumerate(order):
            offs = {"f32": 0, "i32": 0, "u8": 0}
            for name, kind, size in layout.layout_key():
                src = np.asarray(blocks[shard][name])
                if kind == "u8":
                    src = src.view(np.uint8)
                staging[kind][i, offs[kind]: offs[kind] + size] = src
                offs[kind] += size
        out = result_to_host(dispatch_stacked_solve(
            staging, layout.layout_key(), cap_iters, self.device
        ))
        key = tuple(dims[d] for d in _DIM_NAMES + tuple(_FIXED_DIMS))
        blocks_out = {}
        for i, shard in enumerate(order):
            named = split_outputs(out[i], key)
            blocks_out[shard] = {name: named[name] for name in _OUT_KEYS}
        return blocks_out
