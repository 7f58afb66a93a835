"""Segment sums whose f32 rounding is the same on every run and device.

``segment_sum(x, plan)`` adds each segment's elements one at a time in
element order, starting from 0 — on the CPU with ``index_add_`` (which
adds in that order), on the card with the hand-written kernel
``csrc/segment_sum.cu``. ``x`` may hold up to four columns ``[k, n]``
summed over one plan in one launch. The solve uses it for the
real-valued sums that it floors or ceils into host counts and for the
capacity program's pool sums; integer-valued sums (counts) are exact in
any order and stay ``index_add_``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

#: the most columns one launch sums over a plan
MAX_COLUMNS = 4
#: elements and segments the kernel indexes in int32, with headroom for
#: the positions it computes past the end of a range
_INDEX_LIMIT = 2**31 - 2**16


class SegmentPlan(NamedTuple):
    """Segment ids of a [n_elem] index column and, on the card, the
    stable order of its live elements by segment with each segment's
    [start, end) in that order. ``name`` labels the plan's launches."""

    seg: torch.Tensor                # int64 [n_elem], values in [0, n)
    n: int
    order: Optional[torch.Tensor]    # int32 [n_elem] (card only)
    offsets: Optional[torch.Tensor]  # int32 [n + 1] (card only)
    name: str = ""


def segment_csr(
    seg: torch.Tensor, n: int, live: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plan, on any device, without a wait on the device:
    ``order`` (int32 [n_elem]), the elements sorted by segment, each
    segment's in ascending element index; ``offsets`` (int32 [n + 1]),
    segment g's [start, end) in ``order``. Elements that are not live
    (``live`` marks the live ones; all when None) — padding rows, which
    only ever add 0 — sort after ``offsets[n]``, outside every segment,
    where the kernel never reads them."""
    n_elem = seg.shape[0]
    if max(n_elem, n) >= _INDEX_LIMIT:
        raise ValueError(f"{n_elem} elements or {n} segments exceed the "
                         f"kernel's int32 indexing")
    key = seg.to(torch.int32)
    if live is not None:
        key = torch.where(live, key, n)
    key_sorted, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        key_sorted, torch.arange(n + 1, dtype=torch.int32, device=seg.device),
        out_int32=True,
    )
    return order.to(torch.int32), offsets


def segment_plan(seg: torch.Tensor, n: int, live=None, name: str = "") -> SegmentPlan:
    """Plan the segment sums over one index column (reused for every sum
    over that column). ``live`` (bool, optional) marks the elements that
    may be nonzero in the summed columns; the card's kernel skips the
    others. On the CPU no order is built: ``index_add_`` needs none."""
    seg = seg.long()
    if seg.device.type == "cpu":
        return SegmentPlan(seg, n, None, None, name)
    order, offsets = segment_csr(seg, n, live)
    return SegmentPlan(seg, n, order, offsets, name)


def segment_sum_plain(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The plain PyTorch version: one 1-D ``index_add_`` into zeros per
    column of ``x`` ([n] or [k, n])."""
    out = torch.zeros(x.shape[:-1] + (plan.n,), dtype=x.dtype, device=x.device)
    k = 1 if x.dim() == 1 else x.shape[0]
    for o, col in zip(out.view(k, plan.n), x.reshape(k, x.shape[-1])):
        o.index_add_(0, plan.seg, col)
    return out


def bind(lib: ctypes.CDLL):
    """The launch function of a build of ``csrc/segment_sum.cu``."""
    fn = lib.segment_sum_launch
    fn.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launch_fn():
    return bind(_build.load("segment_sum"))


def segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """[plan.n] f32 sums of ``x`` [n_elem] per segment, in element order,
    or [k, plan.n] for ``x`` [k, n_elem] with k ≤ ``MAX_COLUMNS``. On a
    CPU tensor this is ``segment_sum_plain``; on a CUDA tensor it makes
    one launch of the kernel or raises."""
    if x.device.type == "cpu":
        return segment_sum_plain(x, plan)
    out = launch(x, plan)
    segment_sum.launches += 1
    segment_sum.launches_by_plan[plan.name] = (
        segment_sum.launches_by_plan.get(plan.name, 0) + 1)
    return out


def launch(x: torch.Tensor, plan: SegmentPlan, fn=None) -> torch.Tensor:
    """``segment_sum`` on a CUDA tensor through ``fn``, a build of the
    kernel bound by ``bind`` (the package's own when None); the launch is
    not counted. Raises on inputs the kernel does not take."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {dev}")
    if (x.dtype != torch.float32 or x.dim() not in (1, 2)
            or not x.is_contiguous()):
        raise ValueError("segment_sum takes a contiguous float32 [n] or [k, n] tensor")
    k = 1 if x.dim() == 1 else x.shape[0]
    if not 1 <= k <= MAX_COLUMNS:
        raise ValueError(f"segment_sum sums 1 to {MAX_COLUMNS} columns, not {k}")
    n_elem = x.shape[-1]
    if (plan.order is None or plan.order.device != dev
            or plan.seg.shape[0] != n_elem):
        raise ValueError("segment plan does not match the input")
    if fn is None:
        fn = _launch_fn()
    out = torch.empty(x.shape[:-1] + (plan.n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), k, n_elem, plan.order.data_ptr(),
                plan.offsets.data_ptr(), plan.n, out.data_ptr(), stream)
    _build.check_launch(rc, "segment_sum")
    return out


#: kernel launches since the count was last set to 0, in all and by plan
#: name (not locked: callers that launch from several threads order their
#: solves, as the sidecar does)
segment_sum.launches = 0
segment_sum.launches_by_plan: Dict[str, int] = {}
