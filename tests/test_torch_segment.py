"""The port's ordered segment sums on the CPU: the card kernel's plan and
the order it adds in.

``segment_csr`` builds the plan the card's kernel walks (it runs on any
device), so its invariants are checked here directly. A sequential f32
walk along that plan — numpy, one ``np.float32`` add at a time, which is
what the kernel does — must equal ``segment_sum_plain`` (the CPU's
``index_add_``) bit for bit: that is the contract that lets the card's
integer outputs equal the CPU's. The plans are the solve's three (task →
segment, host → segment, distro → pool) on a config-3-shaped problem cut
to 20 distros × 5,000 tasks, and edge cases: empty segments, an input
that is all padding, and one segment longer than the kernel's staging
tile. The card tests of the kernel itself are in tests/test_torch_card.py.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu_torch.ops.packing import unpack  # noqa: E402
from evergreen_tpu_torch.ops.segment import (  # noqa: E402
    segment_csr,
    segment_plan,
    segment_sum,
    segment_sum_plain,
)
from evergreen_tpu_torch.scheduler.snapshot import build_snapshot  # noqa: E402
from evergreen_tpu_torch.utils.benchgen import NOW, generate_problem  # noqa: E402

#: floats of one staging tile of csrc/segment_sum.cu (kTileFloats)
TILE_FLOATS = 8192


@pytest.fixture(scope="module")
def config3_small():
    snap = build_snapshot(*generate_problem(20, 5_000, seed=0), NOW)
    return unpack(snap.arena.buffers, snap.arena.layout_key(), "cpu")


def solve_plan(a, which):
    """(seg, n_seg, live) of one of the solve's three plans."""
    G = a["g_distro"].shape[0]
    return {
        "task": (a["t_seg"], G, a["t_valid"]),
        "host": (a["h_seg"], G, a["h_valid"]),
        "pool": (a["d_pool"], 8, a["d_valid"]),
    }[which]


def edge_plan(which):
    rng = np.random.default_rng(3)
    if which == "empty":  # segments 1-3 mod 4, and 300..399, hold nothing
        n, n_seg = 4000, 400
        seg = rng.integers(0, 75, n) * 4
        live = rng.random(n) < 0.6
    elif which == "all_padding":
        n, n_seg = 1000, 50
        seg = rng.integers(0, n_seg, n)
        live = np.zeros(n, bool)
    else:  # "long": segment 2 outgrows a one-column staging tile
        n, n_seg = 3 * TILE_FLOATS, 64
        seg = np.where(rng.random(n) < 0.5, 2, rng.integers(0, n_seg, n))
        live = rng.random(n) < 0.95
    return torch.as_tensor(seg), n_seg, torch.as_tensor(live)


PLANS = ["task", "host", "pool", "empty", "all_padding", "long"]


def plan_of(which, a):
    return solve_plan(a, which) if which in ("task", "host", "pool") else edge_plan(which)


def live_values(live, k, seed):
    """[k, n] f32 of mixed magnitudes, +0 off the live elements (what the
    solve's columns hold on padding rows)."""
    rng = np.random.default_rng(seed)
    n = live.shape[0]
    x = (rng.random((k, n)) * 10.0 ** rng.integers(-3, 5, (k, n))).astype(np.float32)
    return torch.as_tensor(np.where(live.numpy(), x, np.float32(0.0)))


@pytest.mark.parametrize("which", PLANS)
def test_plan_is_an_int32_csr_of_the_live_elements(which, config3_small):
    seg, n_seg, live = plan_of(which, config3_small)
    order, offsets = segment_csr(seg, n_seg, live)
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    order, offsets = order.numpy(), offsets.numpy()
    seg, live = seg.numpy(), live.numpy()
    assert offsets.shape == (n_seg + 1,) and offsets[0] == 0
    assert np.all(np.diff(offsets) >= 0)
    assert offsets[-1] == live.sum()
    # the live elements, each once, segment by segment in element order;
    # padding rows sort after offsets[-1], outside every segment
    assert sorted(order.tolist()) == list(range(len(seg)))
    assert live[order[: offsets[-1]]].all() and not live[order[offsets[-1]:]].any()
    for g in range(n_seg):
        elems = order[offsets[g]: offsets[g + 1]]
        assert np.all(seg[elems] == g)
        assert np.all(np.diff(elems) > 0)


@pytest.mark.parametrize("which", PLANS)
def test_ordered_walk_along_the_plan_equals_index_add(which, config3_small):
    """The kernel's arithmetic — per segment, 0 then one f32 add per live
    element in ``order`` — is the CPU's ``index_add_`` bit for bit."""
    seg, n_seg, live = plan_of(which, config3_small)
    x = live_values(live, 2, seed=len(which))
    order, offsets = (t.numpy() for t in segment_csr(seg, n_seg, live))
    xs = x.numpy()
    want = np.zeros((2, n_seg), np.float32)
    for c in range(2):
        for g in range(n_seg):
            acc = np.float32(0.0)
            for e in order[offsets[g]: offsets[g + 1]]:
                acc = np.float32(acc + xs[c, e])
            want[c, g] = acc
    got = segment_sum_plain(x, segment_plan(seg, n_seg))
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_plain_columns_equal_separate_calls(k, config3_small):
    seg, n_seg, live = solve_plan(config3_small, "task")
    plan = segment_plan(seg, n_seg, live)
    x = live_values(live, k, seed=k)
    got = segment_sum(x, plan)
    assert got.shape == (k, n_seg)
    want = torch.stack([segment_sum(row, plan) for row in x])
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert segment_sum(x[0], plan).shape == (n_seg,)


def test_cpu_plan_builds_no_order():
    """On the CPU ``index_add_`` needs no order, so the plan carries none."""
    seg, n_seg, live = edge_plan("empty")
    plan = segment_plan(seg, n_seg, live, name="x")
    assert plan.order is None and plan.offsets is None
    assert plan.seg.dtype == torch.int64 and plan.name == "x"


@pytest.mark.parametrize("kernel", ["segment_sum", "distro_stats"])
def test_uncounted_launch_refuses_a_cpu_tensor(kernel):
    """``launch`` (the wrappers' launch, also used to time other builds)
    takes CUDA tensors only, and refuses others before it builds or
    counts anything."""
    from evergreen_tpu_torch.ops import distro_stats, segment

    if kernel == "segment_sum":
        seg, n_seg, live = edge_plan("empty")
        plan = segment_plan(seg, n_seg, live)
        before = segment.segment_sum.launches
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            segment.launch(torch.zeros(seg.shape[0]), plan)
        assert segment.segment_sum.launches == before
    else:
        before = distro_stats.fused_distro_stats.launches
        args = [torch.zeros(4, dtype=torch.bool)] * 2 + [torch.zeros(4)] * 2 + [
            torch.zeros(4, dtype=torch.bool), torch.tensor([0, 4], dtype=torch.int32),
            torch.ones(1)]
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            distro_stats.launch(*args)
        assert distro_stats.fused_distro_stats.launches == before


def test_each_build_variant_has_its_own_library():
    """A build with ``-D`` defines lands in a library of its own, named
    by the source and the flags, whatever the defines' order."""
    from evergreen_tpu_torch.ops import _build

    own = _build._lib_path("segment_sum", {})
    a = _build._lib_path("segment_sum", {"SEGMENT_SUM_PIECE": 512, "SEGMENT_SUM_THREADS": 128})
    b = _build._lib_path("segment_sum", {"SEGMENT_SUM_THREADS": 128, "SEGMENT_SUM_PIECE": 512})
    c = _build._lib_path("segment_sum", {"SEGMENT_SUM_PIECE": 1024, "SEGMENT_SUM_THREADS": 128})
    assert a == b and len({own, a, c}) == 3
    assert _build._flags({"B": 2, "A": 1}) == ("-DA=1", "-DB=2")


@pytest.mark.parametrize("fault", ["compile", "load", "launch"])
def test_a_kernel_that_fails_raises_kernel_error(fault, monkeypatch, tmp_path):
    """A failed compile, a library that does not load and a launch that
    returns an error each raise ``KernelError``, which the tick lets
    through instead of degrading to the host."""
    from evergreen_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    if fault == "compile":
        monkeypatch.setattr(_build, "_nvcc", lambda: "false")
        with pytest.raises(_build.KernelError, match="nvcc failed for segment_sum"):
            _build.load("segment_sum")
    elif fault == "load":
        with open(_build._lib_path("segment_sum", {}), "wb") as f:
            f.write(b"not a shared library")
        with pytest.raises(_build.KernelError, match="cannot load the segment_sum"):
            _build.load("segment_sum")
    else:
        _build.check_launch(0, "segment_sum")
        with pytest.raises(_build.KernelError, match="cudaError_t 700"):
            _build.check_launch(700, "segment_sum")
    assert issubclass(_build.KernelError, RuntimeError)
    assert _build._libs == {}


def test_sweep_variants_name_the_sources_constants():
    """Every build ``chip_smoke.py --sweep`` asks for overrides macros the
    sources define, starts from the sources' own values, and fits
    segment_sum's staging (its static_assert): a piece plus one window
    in one round of gathers and in a quarter of the tile."""
    import chip_smoke
    from evergreen_tpu_torch.ops import _build

    for name, variants in (("distro_stats", chip_smoke.DS_VARIANTS),
                           ("segment_sum", chip_smoke.SS_VARIANTS)):
        with open(_build.source_path(name)) as f:
            src = f.read()
        for macro, value in variants[0].items():
            assert f"#ifndef {macro}\n#define {macro} {value}\n" in src
        assert all(v.keys() == variants[0].keys() for v in variants)
    for v in chip_smoke.SS_VARIANTS:
        threads, piece = v["SEGMENT_SUM_THREADS"], v["SEGMENT_SUM_PIECE"]
        spec = piece + threads
        assert spec <= threads * v["SEGMENT_SUM_STAGE_UNROLL"] and spec <= TILE_FLOATS // 4


def _stub_compiler(tmp_path, rc):
    """An ``nvcc`` stand-in that counts its runs in ``calls`` and, when
    ``rc`` is 0, writes its ``-o`` output after a pause long enough for a
    second builder to arrive meanwhile."""
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo run >> {tmp_path / 'calls'}\n"
        "echo compiler report $$\n"
        "sleep 1\n"
        f"[ {rc} -eq 0 ] || exit {rc}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n')
    stub.chmod(0o755)
    return str(stub)


def _build_in(tmp_path, stub):
    """A fresh interpreter building ``distro_stats`` into ``tmp_path/build``
    with the stub compiler; returns its process."""
    import subprocess
    import sys

    code = (
        "from evergreen_tpu_torch.ops import _build\n"
        f"_build.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
        f"_build._nvcc = lambda: {stub!r}\n"
        "try:\n"
        "    _build.build(['distro_stats'])\n"
        "except _build.KernelError as exc:\n"
        "    print(exc)\n"
        "    raise SystemExit(3)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=subprocess.PIPE, text=True)


@pytest.mark.parametrize("rc", [0, 1], ids=["built", "failed"])
def test_concurrent_builds_compile_each_source_once(rc, tmp_path):
    """Two processes that build one source at once run the compiler once
    when it succeeds (the second finds the library under the lock), and a
    failed build raises ``KernelError`` in each with that build's own
    compiler report, never another process's."""
    stub = _stub_compiler(tmp_path, rc)
    procs = [_build_in(tmp_path, stub) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    runs = (tmp_path / "calls").read_text().split()
    if rc == 0:
        assert [p.returncode for p in procs] == [0, 0]
        assert len(runs) == 1
        libs = [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
        assert len(libs) == 1
    else:
        assert [p.returncode for p in procs] == [3, 3]
        assert len(runs) == 2  # the second builder found no library
        reports = [line for out in outs for line in out.splitlines()
                   if line.startswith("compiler report")]
        assert len(reports) == 2 and reports[0] != reports[1]
        assert all("nvcc failed for distro_stats" in out for out in outs)
