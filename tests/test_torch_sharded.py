"""The port's sharded build and stacked solve against the JAX package.

The same problem, generated by each package from one seed, is split by
each package's ``build_sharded_snapshot``: the stacked arrays must be
byte-identical, cold and warm, with the same sticky groups and dims
memos. The port's ``StackedSolveCache(device="cpu")`` is held against the
JAX stacked program's per-shard body, ``solve(block, cap_iters)`` at the
stack's trip count (``_blocks_cap_iters``): the JAX ``shard_map`` program
runs exactly that on each shard, with no collectives, but this JAX
release's shard_map check rejects the program's anneal loop (its carry
does not vary over the shard axis), so the oracle runs the body per
block. Tolerances: integer outputs equal; f32 outputs bit-equal except
``cap_x`` and ``aff_pool``, within 2e-6 relative (``pow`` and
``softmax`` rounding; the measured gap is below 1.4e-6).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.ops import solve as j_solve  # noqa: E402
from evergreen_tpu.parallel import sharded as j_sharded  # noqa: E402
from evergreen_tpu.scheduler import snapshot as j_snapshot  # noqa: E402
from evergreen_tpu.utils import benchgen as j_benchgen  # noqa: E402

from evergreen_tpu_torch.ops import packing as t_packing  # noqa: E402
from evergreen_tpu_torch.ops import solve as t_solve  # noqa: E402
from evergreen_tpu_torch.parallel import sharded as t_sharded  # noqa: E402
from evergreen_tpu_torch.scheduler import snapshot as t_snapshot  # noqa: E402
from evergreen_tpu_torch.utils import benchgen as t_benchgen  # noqa: E402

from test_torch_solve import x64  # noqa: E402,F401

CAP_RTOL = 2e-6
LOOSE = ("cap_x", "aff_pool")


def problems(n_distros, n_tasks, seed, **kw):
    """(JAX problem, port problem) from one seed."""
    return (
        j_benchgen.generate_problem(n_distros, n_tasks, seed=seed, **kw),
        t_benchgen.generate_problem(n_distros, n_tasks, seed=seed, **kw),
    )


def fleet_problems(n_shards, seed=41, n_tasks=400):
    """The solver-leader tests' problem shape."""
    return problems(max(2 * n_shards, 4), n_tasks, seed,
                    task_group_fraction=0.3, hosts_per_distro=3)


def ids(groups):
    return [[d.id for d in g] for g in groups]


def assert_same_stack(t_stacked, j_stacked):
    assert list(t_stacked) == list(j_stacked)
    for name, w in j_stacked.items():
        g = t_stacked[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.tobytes() == w.tobytes(), name


def jax_stacked_oracle(blocks):
    """The JAX stacked program's per-shard body on each block, at the
    stack's trip count."""
    cap = j_sharded._blocks_cap_iters(blocks)
    fn = jax.jit(functools.partial(j_solve.solve, cap_iters=cap))
    with j_solve.x64_scope():
        return {
            k: {n: np.asarray(v) for n, v in fn(blocks[k]).items()}
            for k in sorted(blocks)
        }


def assert_blocks_match(got, want):
    """Integer outputs equal; f32 bit-equal except ``LOOSE`` (rtol
    ``CAP_RTOL``)."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert set(got[k]) == set(want[k])
        for name, w in want[k].items():
            g = got[k][name]
            assert g.shape == w.shape and g.dtype == w.dtype, (k, name)
            if name in LOOSE:
                np.testing.assert_allclose(g, w, rtol=CAP_RTOL, atol=0,
                                           err_msg=f"shard{k}:{name}")
            else:
                assert g.tobytes() == w.tobytes(), f"shard{k}:{name}"


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("shape", [(12, 1200, 5), (10, 500, 41), (3, 40, 2)])
def test_partition_matches_jax(shape, n_shards):
    n_distros, n_tasks, seed = shape
    jp, tp = problems(n_distros, n_tasks, seed)
    assert ids(t_sharded.partition_distros(tp[0], tp[1], n_shards)) == ids(
        j_sharded.partition_distros(jp[0], jp[1], n_shards)
    )


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_build_is_byte_identical_cold_and_warm(n_shards):
    jp, tp = problems(10, 800, 43, task_group_fraction=0.3,
                      hosts_per_distro=3)
    j_subs, j_cold = j_sharded.build_sharded_snapshot(*jp, j_benchgen.NOW,
                                                      n_shards)
    t_subs, t_cold = t_sharded.build_sharded_snapshot(*tp, t_benchgen.NOW,
                                                      n_shards)
    assert_same_stack(t_cold, j_cold)
    assert [s.shape_key() for s in t_subs] == [s.shape_key() for s in j_subs]
    assert [s.task_ids for s in t_subs] == [s.task_ids for s in j_subs]

    j_memos, t_memos = {}, {}
    for _ in range(2):  # prime, then the warm build
        _, j_warm = j_sharded.build_sharded_snapshot(
            *jp, j_benchgen.NOW, n_shards, memos=j_memos)
        _, t_warm = t_sharded.build_sharded_snapshot(
            *tp, t_benchgen.NOW, n_shards, memos=t_memos)
        assert_same_stack(t_warm, j_cold)
        assert t_memos["groups"] == j_memos["groups"]
        assert t_memos["dims"] == j_memos["dims"]
    # the sticky partition is the fresh one, stored as ids
    assert t_memos["groups"] == ids(
        t_sharded.partition_distros(tp[0], tp[1], n_shards))


def test_sharded_memos_repartition_on_imbalance():
    """Churn that skews the kept assignment past twice the mean load
    re-partitions, as in the JAX package; a mild churn keeps it."""
    jp, tp = problems(8, 400, 44)
    memos = {"jax": {}, "port": {}}

    def build(jtbd, ttbd):
        j_sharded.build_sharded_snapshot(jp[0], jtbd, *jp[2:],
                                         j_benchgen.NOW, 4,
                                         memos=memos["jax"])
        t_sharded.build_sharded_snapshot(tp[0], ttbd, *tp[2:],
                                         t_benchgen.NOW, 4,
                                         memos=memos["port"])
        assert memos["port"]["groups"] == memos["jax"]["groups"]
        return [list(g) for g in memos["port"]["groups"]]

    def skew(problem, keep):
        big = problem[0][0].id
        all_tasks = [t for ts in problem[1].values() for t in ts]
        tbd = {d.id: list(problem[1][d.id][:keep]) for d in problem[0]}
        tbd[big] = all_tasks
        return tbd

    before = build(jp[1], tp[1])
    # drop one task of every distro: balanced still, the groups stay
    mild = build({k: v[1:] for k, v in jp[1].items()},
                 {k: v[1:] for k, v in tp[1].items()})
    assert mild == before
    after = build(skew(jp, 0), skew(tp, 0))
    assert after != before


def test_build_snapshot_force_dims_and_dims_memo_match_jax():
    """``force_dims`` is a floor; the dims memo keeps a bucket while the
    count fits and the bucket is at most 4x the natural one."""
    jp, tp = problems(6, 900, 9, hosts_per_distro=4)
    force = {"N": 2048, "M": 64, "D": 16}
    js = j_snapshot.build_snapshot(*jp, j_benchgen.NOW, force_dims=force)
    ts = t_snapshot.build_snapshot(*tp, t_benchgen.NOW, force_dims=force)
    assert ts.shape_key() == js.shape_key()
    assert ts.shape_key()[0] == 2048 and ts.shape_key()[5] == 16
    assert ts.shape_key()[1] > 64  # the natural bucket wins over the floor
    for kind in ("f32", "i32", "u8"):
        assert ts.arena.buffers[kind].tobytes() == js.arena.buffers[kind].tobytes()

    j_memo, t_memo = {}, {}
    for n_tasks in (900, 300, 120, 900):
        jp2, tp2 = problems(6, n_tasks, 9, hosts_per_distro=4)
        js = j_snapshot.build_snapshot(*jp2, j_benchgen.NOW, dims_memo=j_memo)
        ts = t_snapshot.build_snapshot(*tp2, t_benchgen.NOW, dims_memo=t_memo)
        assert t_memo == j_memo, n_tasks
        assert ts.shape_key() == js.shape_key(), n_tasks
        for kind in ("f32", "i32", "u8"):
            assert (ts.arena.buffers[kind].tobytes()
                    == js.arena.buffers[kind].tobytes()), (n_tasks, kind)
    # 900 tasks → bucket 1024 kept at 300 tasks (4x fits), dropped at 120
    assert t_memo["N"] == 1024


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_stacked_solve_matches_jax(n_shards, x64):
    jp, tp = fleet_problems(n_shards)
    j_subs, _ = j_sharded.build_sharded_snapshot(*jp, j_benchgen.NOW, n_shards)
    t_subs, _ = t_sharded.build_sharded_snapshot(*tp, t_benchgen.NOW, n_shards)
    # one shard carries a capacity page, so the stack runs its 48 steps
    t_benchgen.add_capacity_page(j_subs[0])
    t_benchgen.add_capacity_page(t_subs[0])
    got = t_sharded.StackedSolveCache("cpu").solve_blocks(
        {k: s.arrays for k, s in enumerate(t_subs)})
    assert list(got) == list(range(n_shards))
    assert all(list(b) == list(t_sharded._OUT_KEYS) for b in got.values())
    want = jax_stacked_oracle({k: s.arrays for k, s in enumerate(j_subs)})
    assert_blocks_match(got, want)


def test_stacked_trip_count_is_the_block_maximum(x64):
    """Pages of 48 and 24 steps and two shards without one: every shard
    runs 48 steps, as in the JAX stacked program, so each block equals
    its own ``_packed_solve`` at 48 — not its own page's count."""
    jp, tp = fleet_problems(4, seed=7)
    j_subs, _ = j_sharded.build_sharded_snapshot(*jp, j_benchgen.NOW, 4)
    t_subs, _ = t_sharded.build_sharded_snapshot(*tp, t_benchgen.NOW, 4)
    for subs in (j_subs, t_subs):
        t_benchgen.add_capacity_page(subs[0], 48)
        t_benchgen.add_capacity_page(subs[1], 24)
    blocks = {k: s.arrays for k, s in enumerate(t_subs)}
    assert t_sharded._blocks_cap_iters(blocks) == 48
    assert j_sharded._blocks_cap_iters(
        {k: s.arrays for k, s in enumerate(j_subs)}) == 48
    assert [t_solve.capacity_iters(s) for s in t_subs] == [48, 24, 0, 0]

    cache = t_sharded.StackedSolveCache("cpu")
    got = cache.solve_blocks(blocks)
    for k, s in enumerate(t_subs):
        own = t_solve.split_outputs(t_solve._packed_solve(
            s.arena.buffers, s.arena.layout_key(), 48, "cpu").numpy(),
            s.shape_key())
        for name in own:
            assert got[k][name].tobytes() == own[name].tobytes(), (k, name)
    assert_blocks_match(
        got, jax_stacked_oracle({k: s.arrays for k, s in enumerate(j_subs)}))
    # the rule is visible where a page's own count stops short: these
    # problems' Newton steps converge within 24, but a 2-step page also
    # runs 2 anneal sweeps on its own and 12 in the stack
    t_benchgen.add_capacity_page(t_subs[1], 2)
    got = cache.solve_blocks(blocks)
    own2 = t_solve.run_solve_packed(t_subs[1], device="cpu")
    assert own2["aff_pool"].tobytes() != got[1]["aff_pool"].tobytes()
    own48 = t_solve._packed_solve(t_subs[1].arena.buffers,
                                  t_subs[1].arena.layout_key(), 48, "cpu")
    assert np.array_equal(
        got[1]["aff_pool"],
        t_solve.split_outputs(own48.numpy(), t_subs[1].shape_key())["aff_pool"])


def test_unpack_takes_device_tensors_in_place():
    """Tensor buffers already on the device are sliced without a copy;
    numpy buffers go up once each."""
    _, tp = problems(4, 120, 11, hosts_per_distro=3)
    snap = t_snapshot.build_snapshot(*tp, t_benchgen.NOW)
    key = snap.arena.layout_key()
    tens = {k: torch.from_numpy(v.copy()) for k, v in snap.arena.buffers.items()}
    a = t_packing.unpack(tens, key, "cpu")
    for name, kind, _ in key:
        if kind != "u8":
            assert (a[name].untyped_storage().data_ptr()
                    == tens[kind].untyped_storage().data_ptr()), name
    from_np = t_packing.unpack(snap.arena.buffers, key, "cpu")
    for name in a:
        assert torch.equal(a[name], from_np[name]), name
    out = t_solve._packed_solve(tens, key, 0, "cpu")
    want = t_solve._packed_solve(snap.arena.buffers, key, 0, "cpu")
    assert torch.equal(out, want)
