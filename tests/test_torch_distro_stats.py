"""The port's per-distro statistics and ordered segment sums.

``fused_distro_stats`` (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode on the ragged cases of
tests/test_pallas_kernels.py: counts exact, duration sums at rtol 1e-5
(the Pallas kernel sums per tile, the plain version in task order). The
plain version's duration sums are left folds in element order, as the
JAX lax path's and the card kernel's are. The earlier card order
(lane-strided partial sums and an xor butterfly) rounds the sums of a
generated problem's distros otherwise, and on a constructed tie that
rounding unit moves a capacity target. The card tests of the Hopper
kernels are in tests/test_torch_card.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from evergreen_tpu.ops.pallas_kernels import (  # noqa: E402
    BLOCK as J_BLOCK,
    fused_distro_stats as j_fused_distro_stats,
    k_blocks_for,
)
from evergreen_tpu.ops.solve import _seg_sum as j_seg_sum  # noqa: E402

from evergreen_tpu_torch.ops import capacity as t_cap  # noqa: E402

from evergreen_tpu_torch.ops.distro_stats import (  # noqa: E402
    STAT_NAMES,
    fused_distro_stats,
    fused_distro_stats_plain,
)
from evergreen_tpu_torch.ops.segment import segment_plan, segment_sum  # noqa: E402

from test_torch_card import BLOCK, COUNTS, SUMS, TASK_COLS  # noqa: E402
from test_torch_card import CASES, case, ragged_case, torch_args  # noqa: E402


@pytest.mark.parametrize("which", CASES)
def test_plain_matches_pallas_interpret(which):
    assert BLOCK == J_BLOCK
    cols, offs, th, counts = case(which)
    want = j_fused_distro_stats(
        *(cols[n].astype(np.float32) for n in TASK_COLS),
        jnp.asarray(offs), jnp.asarray(th),
        k_blocks=k_blocks_for(counts), interpret=True,
    )
    got = fused_distro_stats(*torch_args(cols, offs, th))
    assert set(got) == set(STAT_NAMES)
    for name in COUNTS:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), name)
    for name in SUMS:
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), rtol=1e-5, err_msg=name
        )


def test_plain_ignores_tasks_outside_the_offsets():
    """Padded tail tasks (past offs[D]) count toward no distro."""
    cols, offs, th, _ = ragged_case(1)
    n = len(cols["t_valid"])
    padded = {k: np.concatenate([v, v[:37]]) for k, v in cols.items()}
    a = fused_distro_stats_plain(*torch_args(cols, offs, th))
    b = fused_distro_stats_plain(*torch_args(padded, offs, th))
    assert len(padded["t_valid"]) == n + 37
    for name in STAT_NAMES:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("seed", range(3))
def test_segment_sum_adds_in_element_order(seed):
    """The plain version equals an f32 accumulation in element order,
    which is what the card's kernel computes."""
    rng = np.random.default_rng(seed)
    n_seg = int(rng.integers(1, 50))
    seg = rng.integers(0, n_seg, 3000)
    x = (rng.random(3000) * 10.0 ** rng.integers(-3, 4, 3000)).astype(np.float32)
    want = np.zeros(n_seg, np.float32)
    for s, v in zip(seg, x):
        want[s] = np.float32(want[s] + v)
    plan = segment_plan(torch.as_tensor(seg), n_seg)
    got = segment_sum(torch.as_tensor(x), plan)
    assert got.numpy().tobytes() == want.tobytes()


def element_order_sum(vals):
    """((0 + v0) + v1) + ... in f32."""
    acc = np.float32(0.0)
    for v in vals:
        acc = np.float32(acc + v)
    return acc


def butterfly_sum(vals, unroll=8):
    """The order of the card kernel before element-order sums: lane l of
    a warp adds elements l + 32 j + 256 k in turn, then the 32 lane sums
    meet in an xor butterfly (offsets 16, 8, 4, 2, 1)."""
    n = len(vals)
    lanes = []
    for lane in range(32):
        acc = np.float32(0.0)
        for base in range(lane, n, 32 * unroll):
            for j in range(unroll):
                i = base + 32 * j
                acc = np.float32(acc + (vals[i] if i < n else np.float32(0.0)))
        lanes.append(acc)
    for off in (16, 8, 4, 2, 1):
        lanes = [np.float32(lanes[k] + lanes[k ^ off]) for k in range(32)]
    return lanes[0]


def capacity_targets(demands):
    """Integral targets of a two-distro instance whose fractional x is 3
    hosts each under a pool quota of 5: the repair takes one host from the
    distro with the smaller marginal loss (demand / (t (t - 1))), the
    first on a tie."""
    pool = t_cap.pool_index_of("mock")
    quota = np.zeros(t_cap.P_BUCKET)
    quota[pool] = 5.0
    inp = t_cap.CapacityInputs(
        distro_ids=["a", "b"], demand_s=np.asarray(demands, np.float64),
        thresh_s=np.full(2, 1800.0), existing=np.zeros(2), free=np.zeros(2),
        min_hosts=np.zeros(2), max_hosts=np.full(2, 20.0),
        deps_met=np.full(2, 300.0), pool=np.full(2, pool, np.int32),
        elig=np.ones(2, bool), heuristic_new=np.full(2, 3.0),
        price=np.zeros(t_cap.P_BUCKET), quota=quota, fleet_budget=100.0,
    )
    return t_cap.round_allocation(np.array([3.0, 3.0]), inp).tolist()


@pytest.mark.parametrize("seed", range(2))
def test_duration_sums_of_a_generated_tick_are_element_order(seed):
    """The packed solve's own inputs on a generated problem: the plain
    version's two duration sums are each distro's left fold in element
    order, bit for bit what the JAX lax path adds; the old card order
    (emulated) rounds some distro's sum otherwise."""
    from evergreen_tpu_torch.ops.packing import unpack
    from evergreen_tpu_torch.ops.solve import distro_stats_inputs
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.utils.benchgen import NOW, generate_problem

    snap = build_snapshot(*generate_problem(20, 5_000, seed=seed), NOW)
    a = unpack(snap.arena.buffers, snap.arena.layout_key(), torch.device("cpu"))
    args = distro_stats_inputs(a)
    valid, deps, dur, _, _, offs, th = (t.numpy() for t in args)
    got = fused_distro_stats_plain(*args)
    # the distros' ranges cover the tasks; the padding after them is no
    # distro's
    n = offs[-1]
    dm = (valid[:n] != 0) & (deps[:n] != 0)
    dur = dur[:n]
    seg = np.repeat(np.arange(len(th)), np.diff(offs))
    n_old = 0
    for name, vals in (
        ("d_expected_dur_s", np.where(dm, dur, np.float32(0.0))),
        ("d_over_dur_s", np.where(dm & (dur > th[seg]), dur, np.float32(0.0))),
    ):
        lax = np.asarray(j_seg_sum(jnp.asarray(vals), jnp.asarray(seg), len(th)))
        assert got[name].numpy().tobytes() == lax.tobytes(), name
        for d in range(len(th)):
            span = vals[offs[d]:offs[d + 1]]
            assert got[name][d].item() == element_order_sum(span), (name, d)
            n_old += butterfly_sum(span) != element_order_sum(span)
    assert n_old > 0


def test_duration_sums_are_element_order_and_decide_a_capacity_target():
    """A constructed tie between two distros' capacity demands: the old
    card order's sum, one rounding unit off the element-order sum, moves
    a host from one distro to the other. (On generated problems the old
    order changes many sums by a unit, as above, without reaching a
    rounding boundary of the targets.)"""
    rng = np.random.default_rng(1)
    n = 300
    cols = dict(
        t_valid=np.ones(n, bool), t_deps_met=rng.random(n) < 0.8,
        t_expected_s=(rng.random(n) * 3000).astype(np.float32),
        t_wait_dep_met_s=np.zeros(n, np.float32), t_is_merge=np.zeros(n, bool),
    )
    offs = np.array([0, n], np.int32)
    th = np.array([1800.0], np.float32)
    dm = cols["t_valid"] & cols["t_deps_met"]
    dur = cols["t_expected_s"]
    terms = {
        "d_expected_dur_s": np.where(dm, dur, np.float32(0.0)),
        "d_over_dur_s": np.where(dm & (dur > th[0]), dur, np.float32(0.0)),
    }
    got = fused_distro_stats_plain(*torch_args(cols, offs, th))
    for name, vals in terms.items():
        want = element_order_sum(vals)
        lax = np.asarray(j_seg_sum(jnp.asarray(vals), jnp.zeros(n, jnp.int32), 1))
        assert got[name].numpy().tobytes() == want.tobytes(), name
        assert lax.tobytes() == want.tobytes(), name
    elem = element_order_sum(terms["d_expected_dur_s"])
    old = butterfly_sum(terms["d_expected_dur_s"])
    assert old != elem
    # the old sum in the row a larger (smaller) demand keeps (loses) a
    # host from, against the element-order sum in the other row
    row = 0 if old > elem else 1
    demands = [float(elem), float(elem)]
    tied = capacity_targets(demands)
    demands[row] = float(old)
    assert tied == [2, 3]
    assert capacity_targets(demands) == [3, 2]
