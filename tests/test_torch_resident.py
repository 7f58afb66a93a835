"""The port's device mirror (``evergreen_tpu_torch/ops/resident_ops.py``)
against the JAX package's, on the CPU.

The port's ``DeviceMirror(device="cpu")`` and the JAX ``DeviceMirror``
are fed the same truth buffers and the same dirty spans at every step;
after each step both hold buffers byte-identical to the truth, and their
counters (``full_uploads``, ``slice_rows``, ``delta_rows``) are equal.
On a snapshot's arena, the spans come from diffing the host buffers
before and after each churn step, and the packed solve fed from the
mirror must be byte-identical to a solve of a fresh upload.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.ops import resident_ops as j_res  # noqa: E402

from evergreen_tpu_torch.ops import resident_ops as t_res  # noqa: E402
from evergreen_tpu_torch.ops.solve import (  # noqa: E402
    _packed_solve,
    capacity_iters,
    run_solve_packed,
    split_outputs,
)
from evergreen_tpu_torch.scheduler.snapshot import build_snapshot  # noqa: E402
from evergreen_tpu_torch.utils.benchgen import (  # noqa: E402
    NOW,
    add_capacity_page,
    generate_problem,
)

COUNTERS = ("full_uploads", "slice_rows", "delta_rows")


class Pair:
    """The two packages' mirrors, synced together and compared."""

    def __init__(self):
        self.port = t_res.DeviceMirror(device="cpu")
        self.jax = j_res.DeviceMirror()

    def sync(self, truth, spans):
        got = self.port.sync(truth, spans)
        want = self.jax.sync(truth, spans)
        assert list(got) == list(truth)
        for kind, src in truth.items():
            g = got[kind].numpy()
            assert g.dtype == src.dtype, kind
            assert g.tobytes() == src.tobytes(), kind
            assert np.asarray(want[kind]).tobytes() == src.tobytes(), kind
        for name in COUNTERS:
            assert getattr(self.port, name) == getattr(self.jax, name), name
        return got


def truth_arrays(rng):
    return {
        "f32": rng.random(97).astype(np.float32),
        "i32": (rng.random(61) * 100).astype(np.int32),
        "u8": (rng.random(41) * 2).astype(np.uint8),
    }


def test_mirror_delta_equals_full_upload():
    """The JAX package's delta sequence (tests/test_resident_state.py):
    overlapping and duplicate spans, a sparse part over half a kind, a
    change of layout."""
    truth = truth_arrays(np.random.default_rng(0))
    m = Pair()
    m.sync(truth, None)
    assert m.port.full_uploads == 1

    truth["f32"][5:9] += 1.0
    truth["f32"][20:22] -= 3.0
    truth["i32"][7] = -1
    m.sync(truth, {"f32": [(5, 9), (6, 8), (20, 22)], "i32": [(7, 8)],
                   "u8": []})
    assert m.port.delta_rows == 7  # 5..9 ∪ 6..8 ∪ 20..22 and one row

    truth["u8"][:30] ^= 1
    m.sync(truth, {"u8": [(0, 30)]})
    assert m.port.full_uploads == 2

    truth2 = truth_arrays(np.random.default_rng(1))
    truth2["f32"] = np.resize(truth2["f32"], 128).astype(np.float32)
    m.sync(truth2, {"f32": [(0, 1)]})
    assert m.port.full_uploads == 3


def test_mirror_long_runs_ship_as_slices():
    rng = np.random.default_rng(2)
    total = t_res.SLICE_RUN_MIN * 3
    truth = {"f32": rng.random(total).astype(np.float32)}
    m = Pair()
    m.sync(truth, None)
    truth["f32"][: t_res.SLICE_RUN_MIN * 2] += 1.0
    truth["f32"][total - 2:] -= 1.0
    m.sync(truth, {"f32": [(0, t_res.SLICE_RUN_MIN * 2), (total - 2, total)]})
    assert m.port.full_uploads == 1
    assert m.port.slice_rows == t_res.SLICE_RUN_MIN * 2
    assert m.port.delta_rows == 2


def test_mirror_updates_in_place_and_copies_the_truth():
    """A delta sync writes into the resident tensors; a full upload
    shares no memory with the host truth."""
    truth = truth_arrays(np.random.default_rng(4))
    m = t_res.DeviceMirror(device="cpu")
    first = m.sync(truth, None)
    truth["i32"][3] = 12345  # not synced yet: the mirror keeps the old value
    assert int(first["i32"][3]) != 12345
    again = m.sync(truth, {"i32": [(3, 4)]})
    assert again["i32"] is first["i32"] and int(first["i32"][3]) == 12345


@pytest.mark.parametrize("seed", range(6))
def test_span_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    total = 500
    spans = []
    for _ in range(int(rng.integers(0, 30))):
        lo = int(rng.integers(0, total))
        spans.append((lo, lo + int(rng.integers(-3, 90))))
    assert t_res.merge_spans(spans) == j_res.merge_spans(spans)
    sparse = [r for r in t_res.merge_spans(spans) if r[1] - r[0] < 64]
    for tot in (total, 10 * total):
        got = t_res.coalesce_spans(sparse, tot)
        want = j_res.coalesce_spans(sparse, tot)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == want.dtype and got.tolist() == want.tolist()
    assert t_res.coalesce_spans([], 10).tolist() == []
    assert t_res.coalesce_spans([(0, 60)], 100) is None


def diff_spans(before, after):
    """Each kind's ``[lo, hi)`` runs of elements whose bytes changed."""
    spans = {}
    for kind, new in after.items():
        old = before[kind]
        width = {1: np.uint8, 4: np.uint32}[new.itemsize]
        idx = np.flatnonzero(old.view(width) != new.view(width))
        if not len(idx):
            spans[kind] = []
            continue
        cuts = np.flatnonzero(np.diff(idx) > 1) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [len(idx)]])
        spans[kind] = [(int(idx[a]), int(idx[b - 1]) + 1)
                       for a, b in zip(starts, ends)]
    return spans


def churn_steps(problem, rng):
    """(label, snapshot) after each churn step of one layout, then one
    of another: a tick's time refresh, scattered rows, a step that dirties
    over half of the f32 kind sparsely, a larger N bucket."""
    snap = add_capacity_page(build_snapshot(*problem, NOW))
    yield "cold", snap
    later = add_capacity_page(build_snapshot(*problem, NOW + 15.0))
    for kind, buf in later.arena.buffers.items():
        snap.arena.buffers[kind][:] = buf
    yield "time refresh", snap
    a, n_t = snap.arrays, snap.n_tasks
    rows = rng.choice(n_t, 40, replace=False)
    a["t_priority"][rows] += 7
    a["t_expected_s"][rows[:20]] *= 1.5
    a["t_deps_met"][rows[20:]] ^= True
    yield "scattered rows", snap
    f32 = snap.arena.buffers["f32"]
    mask = (np.arange(len(f32)) % 4) != 3
    f32[mask] += 1.0
    yield "sparse over half of f32", snap
    yield "layout change", add_capacity_page(build_snapshot(
        *problem, NOW, force_dims={"N": 2 * snap.shape_key()[0]}))


def test_mirror_churn_feeds_the_solve():
    problem = generate_problem(6, 300, seed=3, task_group_fraction=0.3,
                               hosts_per_distro=3)
    m = Pair()
    prev = None
    for label, snap in churn_steps(problem, np.random.default_rng(5)):
        truth = snap.arena.buffers
        same_layout = (prev is not None
                       and {k: len(v) for k, v in prev.items()}
                       == {k: len(v) for k, v in truth.items()})
        spans = diff_spans(prev, truth) if same_layout else None
        bufs = m.sync(truth, spans)
        prev = {k: v.copy() for k, v in truth.items()}
        got = split_outputs(_packed_solve(
            bufs, snap.arena.layout_key(), capacity_iters(snap), "cpu"
        ).numpy(), snap.shape_key())
        want = run_solve_packed(snap, device="cpu")
        for name in want:
            assert got[name].tobytes() == want[name].tobytes(), (label, name)
    # cold + the f32 kind of the dense step + the layout change
    assert m.port.full_uploads == 3
    assert m.port.slice_rows > 0 and m.port.delta_rows > 0
