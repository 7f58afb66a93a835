"""The seven per-distro queue statistics in one ragged sweep.

Counterpart of ``evergreen_tpu/ops/pallas_kernels.py``. The snapshot lays
task columns out distro-major, so each per-distro statistic is a
reduction over one contiguous range ``[offs[d], offs[d+1])`` of the task
axis. ``fused_distro_stats`` runs the hand-written Hopper kernel
``csrc/distro_stats.cu`` on a CUDA tensor and the plain PyTorch version
``fused_distro_stats_plain`` on a CPU tensor. The allocator
(``ops/solve.py``) takes all seven statistics from it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import _build

#: stat i lives in column i of the [D, 7] result
N_STATS = 7
STAT_NAMES = (
    "d_length", "d_deps_met", "d_expected_dur_s", "d_over_count",
    "d_over_dur_s", "d_wait_over", "d_merge",
)
#: the two f32 duration sums; the other statistics are counts
STAT_SUMS = ("d_expected_dur_s", "d_over_dur_s")

_FLAG_DTYPES = (torch.bool, torch.uint8)


def _split(out: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {name: out[:, i] for i, name in enumerate(STAT_NAMES)}


def fused_distro_stats_plain(
    t_valid, t_deps_met, t_expected_s, t_wait_dep_met_s, t_is_merge,
    d_task_offset, d_thresh,
) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version: a segment id per task from the offsets,
    then seven ``index_add_`` segment sums. On the CPU ``index_add_`` adds
    in task order, so each duration sum is a left fold in element order,
    as the kernel's is; on a CUDA tensor it adds with atomics, in no
    fixed order."""
    n = t_valid.shape[0]
    D = d_thresh.shape[0]
    offs = d_task_offset.long()
    i = torch.arange(n, device=t_valid.device)
    in_range = (i >= offs[0]) & (i < offs[-1])
    seg = torch.searchsorted(offs[1:].contiguous(), i, right=True)
    seg = torch.where(in_range, seg, D)  # bucket D is dropped below
    th = d_thresh.float()[seg.clamp(max=D - 1)]
    dur = t_expected_s.float()
    valid = in_range & (t_valid != 0)
    deps = valid & (t_deps_met != 0)
    over = deps & (dur > th)
    wait_over = deps & (t_wait_dep_met_s.float() > th)
    merge = deps & (t_is_merge != 0)
    cols = (
        valid.float(), deps.float(), torch.where(deps, dur, 0.0),
        over.float(), torch.where(over, dur, 0.0), wait_over.float(),
        merge.float(),
    )
    out = torch.zeros((D + 1, N_STATS), dtype=torch.float32, device=t_valid.device)
    for k, col in enumerate(cols):
        out[:, k].index_add_(0, seg, col)
    return _split(out[:D])


def _check(name, t, dtypes, n, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def bind(lib: ctypes.CDLL):
    """The launch function of a build of ``csrc/distro_stats.cu``."""
    fn = lib.fused_distro_stats_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launch_fn():
    return bind(_build.load("distro_stats"))


def fused_distro_stats(
    t_valid, t_deps_met, t_expected_s, t_wait_dep_met_s, t_is_merge,
    d_task_offset, d_thresh,
) -> Dict[str, torch.Tensor]:
    """All seven per-distro statistics (``STAT_NAMES``) as [D] f32.

    Inputs: the flat distro-major task columns of length N (flags bool or
    u8, durations f32), the (D+1,) i32 element offsets of each distro's
    range, and the (D,) f32 duration threshold (callers clamp zeros to
    1.0). On a CPU tensor this is ``fused_distro_stats_plain``; on a CUDA
    tensor it launches the kernel or raises."""
    if t_valid.device.type == "cpu":
        return fused_distro_stats_plain(
            t_valid, t_deps_met, t_expected_s, t_wait_dep_met_s, t_is_merge,
            d_task_offset, d_thresh,
        )
    out = launch(
        t_valid, t_deps_met, t_expected_s, t_wait_dep_met_s, t_is_merge,
        d_task_offset, d_thresh,
    )
    fused_distro_stats.launches += 1
    return out


def launch(
    t_valid, t_deps_met, t_expected_s, t_wait_dep_met_s, t_is_merge,
    d_task_offset, d_thresh, fn=None,
) -> Dict[str, torch.Tensor]:
    """``fused_distro_stats`` on CUDA tensors through ``fn``, a build of the
    kernel bound by ``bind`` (the package's own when None); the launch is
    not counted. Raises on inputs the kernel does not take."""
    dev = t_valid.device
    if dev.type != "cuda":
        raise ValueError(f"fused_distro_stats runs on cuda or cpu, not {dev}")
    n = t_valid.shape[0]
    D = d_thresh.shape[0]
    for name, t, dtypes, size in (
        ("t_valid", t_valid, _FLAG_DTYPES, n),
        ("t_deps_met", t_deps_met, _FLAG_DTYPES, n),
        ("t_expected_s", t_expected_s, (torch.float32,), n),
        ("t_wait_dep_met_s", t_wait_dep_met_s, (torch.float32,), n),
        ("t_is_merge", t_is_merge, _FLAG_DTYPES, n),
        ("d_task_offset", d_task_offset, (torch.int32,), D + 1),
        ("d_thresh", d_thresh, (torch.float32,), D),
    ):
        _check(name, t, dtypes, size, dev)
    if n >= 2**31:
        raise ValueError(f"{n} tasks exceed the kernel's int32 indexing")
    if fn is None:
        fn = _launch_fn()
    out = torch.empty((D, N_STATS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            t_valid.data_ptr(), t_deps_met.data_ptr(), t_expected_s.data_ptr(),
            t_wait_dep_met_s.data_ptr(), t_is_merge.data_ptr(),
            d_task_offset.data_ptr(), d_thresh.data_ptr(), n, D,
            out.data_ptr(), stream,
        )
    _build.check_launch(rc, "fused_distro_stats")
    return _split(out)


#: kernel launches since the count was last set to 0 (not locked: callers
#: that launch from several threads order their solves, as the sidecar does)
fused_distro_stats.launches = 0
