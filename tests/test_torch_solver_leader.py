"""The port's solver-leader plane (``evergreen_tpu_torch/runtime/solver.py``)
on the CPU, against the JAX package's.

Every rung of the JAX package's ladder (tests/test_solver_leader.py,
without the arena-pool backing and the supervisor fleet) is run on the
port: the stacked round and its parity with the in-process stack,
timeout, stale epoch, a torn publication with and without quorum, shape
drift and its recorded floor, a deposed leader, a stale result fenced at
the header, the lease steal, the resident sink and the reaping of orphan
segments. The wire format, the manifest and the lease are the JAX
package's, so the tests also cross the packages: the port's leader
serves JAX workers, the JAX leader serves port workers, and the two
packages' leaders steal one lease from each other at rising epochs.

Port results are held against the port's own ``StackedSolveCache``
byte for byte, and against the JAX stacked program's per-shard body
with the tolerances of tests/test_torch_sharded.py (integer outputs
equal, f32 bit-equal except ``cap_x``/``aff_pool`` within 2e-6
relative). The JAX leader here runs that per-shard body too: its
``shard_map`` program cannot be traced by this JAX release (see
tests/test_torch_sharded.py).

Segment names come from ``tmp_path`` (unique per test) or carry the pid,
so the JAX tests' fixed names never collide with these.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu.parallel import sharded as j_sharded  # noqa: E402
from evergreen_tpu.runtime import manifest as j_manifest  # noqa: E402
from evergreen_tpu.runtime import solver as j_solver  # noqa: E402
from evergreen_tpu.storage import integrity as j_integrity  # noqa: E402
from evergreen_tpu.utils import benchgen as j_benchgen  # noqa: E402

from evergreen_tpu_torch.parallel import sharded as t_sharded  # noqa: E402
from evergreen_tpu_torch.runtime import manifest  # noqa: E402
from evergreen_tpu_torch.runtime.solver import (  # noqa: E402
    H_OUT_EPOCH,
    H_OUT_SEQ,
    H_STATE,
    S_PUBLISHED,
    S_SOLVED,
    Segment,
    SolverClient,
    SolverService,
    input_arrays,
    reap_orphan_segments,
)
from evergreen_tpu_torch.scheduler.snapshot import FIELD_KINDS  # noqa: E402
from evergreen_tpu_torch.storage import integrity  # noqa: E402
from evergreen_tpu_torch.utils import faults  # noqa: E402
from evergreen_tpu_torch.utils.benchgen import (  # noqa: E402
    NOW,
    add_capacity_page,
    generate_problem,
)

from test_torch_sharded import assert_blocks_match, jax_stacked_oracle  # noqa: E402
from test_torch_solve import x64  # noqa: E402,F401

_DIMS = ("N", "M", "U", "G", "H", "D", "P", "C")


def shard_snapshots(n_shards, seed=41, n_distros=None, n_tasks=400,
                    package="port"):
    """Per-shard snapshots from either package's sharded build."""
    gen, build, now = (
        (generate_problem, t_sharded.build_sharded_snapshot, NOW)
        if package == "port" else
        (j_benchgen.generate_problem, j_sharded.build_sharded_snapshot,
         j_benchgen.NOW)
    )
    problem = gen(
        n_distros or max(2 * n_shards, 4), n_tasks, seed=seed,
        task_group_fraction=0.3, hosts_per_distro=3,
    )
    subs, _ = build(*problem, now, n_shards)
    return subs


def register(data_dir, shard, client, writer=manifest, pid=None):
    """The worker-side manifest write a worker makes, through either
    package's manifest module."""
    def on_change(name, nbytes):
        writer.write_entry(
            data_dir, shard, pid=pid or os.getpid(), sock="test",
            generation=1, epoch=1, shm=name, shm_bytes=nbytes,
        )

    client._on_segment_change = on_change


def run_fleet_round(data_dir, subs, svc, timeout_s=60.0, corrupt_shard=None,
                    client_cls=SolverClient, writer=manifest, pid=None):
    """Publish every shard from a thread (the worker's blocking call),
    serve from this thread, return (outcome, clients, results)."""
    clients, results, threads = {}, {}, []
    seq = svc.seq + 1
    svc.seq = seq
    for k, snap in enumerate(subs):
        c = client_cls(data_dir, k)
        register(data_dir, k, c, writer, pid)
        clients[k] = c

        def run(k=k, c=c, snap=snap):
            results[k] = c._try_stacked(snap, svc.lease.epoch, seq, timeout_s)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        threads.append(t)
    try:
        if corrupt_shard is not None:
            # wait for the victim's publication, then tear it
            seg = None
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                seg = clients[corrupt_shard]._seg
                if seg is not None and int(seg.hdr[H_STATE]) == S_PUBLISHED:
                    break
                time.sleep(0.001)
            assert seg is not None
            seg.region("i32", 4)[:] += 1  # the payload no longer matches
        outcome = svc.serve_round(list(clients), seq, timeout_s)
        for t in threads:
            t.join(timeout=timeout_s + 10.0)
            assert not t.is_alive()
    finally:
        for c in clients.values():
            c.close(unlink=True)
    return outcome, clients, results


def assert_equal_blocks(results, oracle, shards):
    for k in shards:
        assert results[k] is not None, k
        assert set(results[k]) == set(oracle[k])
        for name, ref in oracle[k].items():
            got = np.asarray(results[k][name])
            assert got.dtype == ref.dtype, (k, name)
            assert got.tobytes() == ref.tobytes(), f"shard{k}:{name}"


@pytest.fixture
def svc(tmp_path):
    svc = SolverService(str(tmp_path), 8, lease_ttl_s=5.0, timeout_s=60.0,
                        device="cpu")
    assert svc.acquire(timeout_s=10.0)
    yield svc
    svc.stop()


class JaxBlocksCache:
    """The JAX leader's stack: the JAX stacked program's per-shard body
    on each block (its shard_map form is not traceable here)."""

    def solve_blocks(self, blocks):
        return jax_stacked_oracle(blocks)


# --------------------------------------------------------------------------- #
# wire format
# --------------------------------------------------------------------------- #


def test_segment_layout_roundtrip():
    from evergreen_tpu_torch.runtime.solver import sizes_for_dims

    dims = {"N": 16, "M": 16, "U": 8, "G": 8, "H": 8, "D": 8}
    sizes = sizes_for_dims(dims)
    assert sizes == j_solver.sizes_for_dims(dims)
    name = f"evg-sol-torch-layout-{os.getpid()}"
    seg = Segment.create(name, sizes, 64)
    try:
        rng = np.random.default_rng(3)
        for kind, n in sizes.items():
            view = seg.region(kind, n)
            view[:] = (rng.random(n) * 100).astype(view.dtype)
        arrays = input_arrays(seg, dims)
        assert list(arrays) == list(FIELD_KINDS)
        # the JAX package reads the same segment into the same arrays
        j_seg = j_solver.Segment.attach(name)
        assert j_seg is not None
        j_arrays = j_solver.input_arrays(j_seg, dims)
        for name_, arr in arrays.items():
            assert arr.dtype == j_arrays[name_].dtype, name_
            assert arr.tobytes() == j_arrays[name_].tobytes(), name_
        del j_arrays
        j_seg.close()
    finally:
        seg.unlink()
        seg.close()


def test_segment_create_reuses_leftover():
    name = f"evg-sol-torch-reuse-{os.getpid()}"
    caps = {"f32": 64, "i32": 64, "u8": 64}
    seg = Segment.create(name, caps, 32)
    seg.close()  # a killed process: the mapped file is left behind
    again = Segment.create(name, caps, 32)
    try:
        assert not again.created
        assert again.caps == caps
    finally:
        again.unlink()
        again.close()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_cross_process_parity_with_inprocess_oracle(tmp_path, svc, n_shards, x64):
    """A stacked round over shared memory is byte-identical to the
    in-process stack, and within the stated tolerances of the JAX one."""
    subs = shard_snapshots(n_shards)
    add_capacity_page(subs[0])
    blocks = {k: subs[k].arrays for k in range(n_shards)}
    oracle = t_sharded.StackedSolveCache("cpu").solve_blocks(blocks)
    outcome, clients, results = run_fleet_round(str(tmp_path), subs, svc)
    assert outcome == "stacked"
    for k in range(n_shards):
        assert clients[k].last_solve == "stacked", clients[k].last_cause
        assert clients[k].stale_accepted == 0
    assert_equal_blocks(results, oracle, range(n_shards))
    assert_blocks_match(results, jax_stacked_oracle(blocks))
    assert svc.round_outcomes == {"stacked": 1}


def test_restarted_workers_are_served_from_their_new_segments(tmp_path, svc):
    """Workers that exit cleanly (unlinking their segments) and restart
    make new segments under the same names and sizes; the leader maps
    the new ones (it keys a mapping on the registering pid too) and the
    next round is stacked again."""
    subs = shard_snapshots(2)
    oracle = t_sharded.StackedSolveCache("cpu").solve_blocks(
        {k: s.arrays for k, s in enumerate(subs)})
    for pid in (os.getpid(), 2 ** 22 + 3):  # the restart has another pid
        outcome, clients, results = run_fleet_round(
            str(tmp_path), subs, svc, timeout_s=10.0, pid=pid)
        assert outcome == "stacked"
        assert all(c.last_solve == "stacked" for c in clients.values())
        assert_equal_blocks(results, oracle, (0, 1))
    assert svc.round_outcomes == {"stacked": 2}


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_shards", [2, 4])
def test_port_leader_serves_jax_workers(tmp_path, svc, n_shards, x64):
    subs = shard_snapshots(n_shards, package="jax")
    add_capacity_page(subs[1])
    outcome, clients, results = run_fleet_round(
        str(tmp_path), subs, svc, client_cls=j_solver.SolverClient,
        writer=j_manifest,
    )
    assert outcome == "stacked"
    for k in range(n_shards):
        assert clients[k].last_solve == "stacked", clients[k].last_cause
    blocks = {k: s.arrays for k, s in enumerate(subs)}
    assert_equal_blocks(
        results, t_sharded.StackedSolveCache("cpu").solve_blocks(blocks),
        range(n_shards))
    assert_blocks_match(results, jax_stacked_oracle(blocks))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_jax_leader_serves_port_workers(tmp_path, n_shards, x64):
    jsvc = j_solver.SolverService(str(tmp_path), 8, lease_ttl_s=5.0,
                                  timeout_s=60.0)
    jsvc._cache = JaxBlocksCache()
    assert jsvc.acquire(timeout_s=10.0)
    try:
        subs = shard_snapshots(n_shards)
        add_capacity_page(subs[1])
        outcome, clients, results = run_fleet_round(str(tmp_path), subs, jsvc)
    finally:
        jsvc.stop()
    assert outcome == "stacked"
    for k in range(n_shards):
        assert clients[k].last_solve == "stacked", clients[k].last_cause
    blocks = {k: s.arrays for k, s in enumerate(subs)}
    assert_equal_blocks(results, jax_stacked_oracle(blocks), range(n_shards))
    assert_blocks_match(
        results, t_sharded.StackedSolveCache("cpu").solve_blocks(blocks))


def test_lease_steal_across_packages(tmp_path):
    """A JAX leader crashes and the port's steals at a strictly higher
    epoch; then the reverse. Each package reads the other's lease."""
    data = str(tmp_path)
    a = j_solver.SolverService(data, 2, lease_ttl_s=0.4, timeout_s=5.0)
    b = SolverService(data, 2, lease_ttl_s=0.4, timeout_s=5.0, device="cpu")
    c = j_solver.SolverService(data, 2, lease_ttl_s=0.4, timeout_s=5.0)
    try:
        assert a.acquire(timeout_s=5.0)
        first = a.lease.epoch
        doc = b.lease.peek()
        assert doc is not None and doc["owner"] == a.lease.owner_id
        a.detach()  # a crash: abandoned, not released
        assert b.acquire(timeout_s=10.0)
        assert b.lease.epoch > first
        assert a.lease.superseded()
        doc = c.lease.peek()  # the JAX package verifies the port's stamp
        assert doc["owner"] == b.lease.owner_id and doc["epoch"] == b.lease.epoch
        assert j_integrity.verify_doc(doc) is True
        assert sorted(doc) == sorted(j_integrity.stamped_doc(
            a.lease._payload()))
        b.detach()
        assert c.acquire(timeout_s=10.0)
        assert c.lease.epoch > b.lease.epoch
        assert b.lease.superseded()
        with open(f"{b.lease.path}.epoch") as fh:
            assert int(fh.read()) == c.lease.epoch
    finally:
        c.stop()
        b.lease.stop_renewing()
        a.lease.stop_renewing()


def test_manifest_entries_cross_the_packages(tmp_path):
    data = str(tmp_path)
    fields = dict(pid=os.getpid(), sock="s", generation=2, epoch=3,
                  shm="evg-x", shm_bytes=4096)
    manifest.write_entry(data, 0, **fields)
    j_manifest.write_entry(data, 1, **fields)
    assert manifest.read_all(data) == j_manifest.read_all(data)
    assert set(manifest.read_all(data)) == {0, 1}
    # one document is the same bytes from either package
    with open(manifest.entry_path(data, 0), "rb") as fh:
        port_raw = fh.read()
    j_manifest.write_entry(data, 0, **fields)
    with open(manifest.entry_path(data, 0), "rb") as fh:
        assert fh.read() == port_raw
    assert integrity.verify_doc(manifest.read_entry(data, 0)) is True
    manifest.remove_entry(data, 0)
    assert manifest.read_entry(data, 0) is None
    assert j_manifest.read_entry(data, 1) is not None


# --------------------------------------------------------------------------- #
# the degraded ladder: every rung ends in a correct local round
# --------------------------------------------------------------------------- #


def test_no_leader_times_out_to_local(tmp_path):
    subs = shard_snapshots(2)
    c = SolverClient(str(tmp_path), 0, device="cpu")
    try:
        out = c._try_stacked(subs[0], epoch=1, seq=1, timeout_s=0.2)
        assert out is None
        assert c.fallbacks == {"timeout": 1}
        assert c.last_solve == "local" and c.last_cause == "timeout"
        # the public solve function answers with the local solve
        from evergreen_tpu_torch.ops.solve import run_solve_packed

        got = c.solve_fn(2, 2, 0.2)(subs[0])
        want = run_solve_packed(subs[0], device="cpu")
        assert all(got[n].tobytes() == want[n].tobytes() for n in want)
        assert c.fallbacks == {"timeout": 2}
    finally:
        c.close(unlink=True)


def test_stale_epoch_stamp_never_publishes(tmp_path):
    subs = shard_snapshots(2)
    c = SolverClient(str(tmp_path), 0)
    try:
        c.epoch_seen = 7  # a newer leader has been observed already
        out = c._try_stacked(subs[0], epoch=3, seq=9, timeout_s=5.0)
        assert out is None
        assert c.fallbacks == {"stale-epoch": 1}
        assert c._seg is None  # rejected before any segment work
    finally:
        c.close(unlink=True)


def test_torn_publication_declined_other_shard_still_served(tmp_path, svc):
    """A checksum-invalid publication degrades its shard; with fewer
    than two valid publications the round declines everyone."""
    subs = shard_snapshots(2)
    outcome, clients, results = run_fleet_round(
        str(tmp_path), subs, svc, corrupt_shard=0
    )
    assert outcome == "declined"
    assert results[0] is None
    assert clients[0].fallbacks == {"declined:torn-publication": 1}
    assert results[1] is None
    assert clients[1].fallbacks == {"declined:partial": 1}


def test_torn_publication_with_quorum_solves_the_rest(tmp_path, svc):
    subs = shard_snapshots(4)
    outcome, clients, results = run_fleet_round(
        str(tmp_path), subs, svc, corrupt_shard=2
    )
    assert outcome == "stacked"
    assert clients[2].fallbacks == {"declined:torn-publication": 1}
    oracle = t_sharded.StackedSolveCache("cpu").solve_blocks(
        {k: subs[k].arrays for k in (0, 1, 3)}
    )
    for k in (0, 1, 3):
        assert clients[k].last_solve == "stacked"
    assert_equal_blocks(results, oracle, (0, 1, 3))


def test_shape_drift_declines_and_records_floor(tmp_path, svc):
    subs_a = shard_snapshots(2, seed=5, n_tasks=100)
    subs_b = shard_snapshots(2, seed=6, n_tasks=2000)
    mixed = [subs_a[0], subs_b[1]]
    keys = [dict(zip(_DIMS, s.shape_key())) for s in mixed]
    assert keys[0] != keys[1]  # the premise: the shapes drift
    outcome, clients, results = run_fleet_round(str(tmp_path), mixed, svc)
    assert outcome == "declined"
    for k in (0, 1):
        assert results[k] is None
        assert clients[k].fallbacks == {"declined:shape-drift": 1}
    assert svc.common_dims == {
        d: max(keys[0][d], keys[1][d]) for d in _DIMS
    }
    # the floor rides the next stamp so the shards republish at one shape
    assert svc.stamp()["dims"] == svc.common_dims


def test_leader_deposed_mid_round_aborts_without_writes(tmp_path, svc):
    subs = shard_snapshots(2)
    svc._deposed()  # what superseded()/on_lost delivers
    outcome, clients, results = run_fleet_round(
        str(tmp_path), subs, svc, timeout_s=1.0
    )
    assert outcome == "aborted"
    for k in (0, 1):
        assert results[k] is None
        assert clients[k].fallbacks == {"timeout": 1}


def test_lease_stolen_at_the_solve_seam_aborts_the_round(tmp_path, svc):
    """A successor steals the lease while the leader solves (fired at the
    ``solver.solve`` seam): the old leader writes no block."""
    subs = shard_snapshots(2)
    thief = SolverService(str(tmp_path), 2, lease_ttl_s=5.0, device="cpu")

    def steal():
        # an abandoned lease: age it past the TTL, then steal it
        svc.lease.stop_renewing()
        os.utime(svc.lease.path, (0, 0))
        doc = svc.lease.peek()
        doc["at"] = 0
        integrity.atomic_write_json(svc.lease.path, doc)
        assert thief.lease.try_acquire()

    old_epoch = svc.lease.epoch
    faults.install(faults.FaultPlan().at("solver.solve", 0,
                                         faults.Fault("call", fn=steal)))
    try:
        outcome, clients, results = run_fleet_round(
            str(tmp_path), subs, svc, timeout_s=1.5)
        new_epoch = thief.lease.epoch
    finally:
        faults.uninstall()
        thief.stop()
    assert outcome == "aborted"
    assert new_epoch > old_epoch and not svc.leading()
    for k in (0, 1):
        assert results[k] is None
        assert clients[k].fallbacks == {"timeout": 1}


def test_stale_leader_result_fenced_at_header(tmp_path):
    """A result block stamped with an older epoch is rejected, and the
    stale-accepted rail stays 0."""
    subs = shard_snapshots(2)
    c = SolverClient(str(tmp_path), 0)
    register(str(tmp_path), 0, c)
    try:
        done = {}

        def run():
            done["out"] = c._try_stacked(
                subs[0], epoch=5, seq=1, timeout_s=1.5
            )

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if c._seg is not None and int(c._seg.hdr[H_STATE]) == S_PUBLISHED:
                break
            time.sleep(0.001)
        hdr = c._seg.hdr
        hdr[H_OUT_EPOCH] = 3  # a stale leader's write: epoch 3 < 5
        hdr[H_OUT_SEQ] = 1
        hdr[H_STATE] = S_SOLVED
        t.join(timeout=20.0)
        assert not t.is_alive()
        assert done["out"] is None
        assert c.fallbacks == {"timeout": 1}  # rejected, then timed out
        assert c.stale_accepted == 0
        assert int(hdr[H_STATE]) == S_PUBLISHED  # re-armed, not consumed
    finally:
        c.close(unlink=True)


def test_solver_lease_steal_elects_strictly_higher_epoch(tmp_path):
    a = SolverService(str(tmp_path), 2, lease_ttl_s=0.4, timeout_s=5.0,
                      device="cpu")
    assert a.acquire(timeout_s=5.0)
    first = a.lease.epoch
    a.detach()  # a crash: abandoned, not released
    b = SolverService(str(tmp_path), 2, lease_ttl_s=0.4, timeout_s=5.0,
                      device="cpu")
    try:
        assert b.acquire(timeout_s=10.0)
        assert b.lease.epoch > first
    finally:
        b.stop()
        a.lease.stop_renewing()


# --------------------------------------------------------------------------- #
# dirty-span publication (resident sink)
# --------------------------------------------------------------------------- #


def test_resident_sink_publishes_spans_not_repacks(tmp_path):
    c = SolverClient(str(tmp_path), 0)
    sink = c.resident_sink()
    rng = np.random.default_rng(1)
    truth = {
        "f32": rng.random(64).astype(np.float32),
        "i32": rng.integers(0, 50, 64).astype(np.int32),
        "u8": rng.integers(0, 2, 64).astype(np.uint8),
    }
    try:
        bufs = sink.sync(truth, None)  # cold: the one full publication
        assert bufs is not None and sink.full_syncs == 1
        for kind in truth:
            np.testing.assert_array_equal(bufs[kind], truth[kind])
        truth["i32"][10:14] = [-1, -2, -3, -4]
        truth["f32"][3] = 99.5
        bufs2 = sink.sync(truth, {"i32": [(10, 14)], "f32": [(3, 4)]})
        assert bufs2 is bufs  # the same segment views: no repack
        assert sink.full_syncs == 1 and sink.span_syncs == 1
        for kind in truth:
            np.testing.assert_array_equal(bufs[kind], truth[kind])
        before = sink.bytes_synced
        sink.sync(truth, {})  # an unchanged round moves zero bytes
        assert sink.full_syncs == 1 and sink.bytes_synced == before
        assert sink.owns(bufs)
    finally:
        c.close(unlink=True)


def test_resident_sink_publication_is_served(tmp_path, svc):
    """A shard publishing through its sink's views skips the publish
    copy and still gets the stacked block of its truth."""
    subs = shard_snapshots(2)
    blocks = {k: s.arrays for k, s in enumerate(subs)}
    oracle = t_sharded.StackedSolveCache("cpu").solve_blocks(blocks)

    class SinkClient(SolverClient):
        def _try_stacked(self, snap, epoch, seq, timeout_s):
            views = self.resident_sink().sync(snap.arena.buffers, None)
            snap.arena._bufs = views  # the resident plane's arena
            return super()._try_stacked(snap, epoch, seq, timeout_s)

    outcome, clients, results = run_fleet_round(
        str(tmp_path), subs, svc, client_cls=SinkClient)
    assert outcome == "stacked"
    assert all(clients[k].last_solve == "stacked" for k in (0, 1))
    assert_equal_blocks(results, oracle, (0, 1))


# --------------------------------------------------------------------------- #
# shm hygiene
# --------------------------------------------------------------------------- #


def test_reap_orphan_segments_unlinks_dead_pids(tmp_path):
    data = str(tmp_path)
    c = SolverClient(data, 0)
    c.ensure_capacity({"f32": 32, "i32": 32, "u8": 32})
    name = c.name
    c.close(unlink=False)  # a killed worker: the segment outlives its pid
    manifest.write_entry(
        data, 0, pid=2 ** 22 + 1, sock="gone", generation=1, epoch=1,
        shm=name, shm_bytes=1024,
    )
    probe = Segment.attach(name)
    assert probe is not None
    probe.close()
    assert name in reap_orphan_segments(data, 1)
    assert Segment.attach(name) is None


def test_reap_spares_live_pids(tmp_path):
    data = str(tmp_path)
    c = SolverClient(data, 0)
    c.ensure_capacity({"f32": 32, "i32": 32, "u8": 32})
    manifest.write_entry(
        data, 0, pid=os.getpid(), sock="live", generation=1, epoch=1,
        shm=c.name, shm_bytes=1024,
    )
    try:
        assert reap_orphan_segments(data, 1) == []
        probe = Segment.attach(c.name)
        assert probe is not None
        probe.close()
    finally:
        c.close(unlink=True)


def test_reap_probes_deterministic_names_without_manifest(tmp_path):
    data = str(tmp_path)
    c = SolverClient(data, 1)
    c.ensure_capacity({"f32": 8, "i32": 8, "u8": 8})
    name = c.name
    c.close(unlink=False)
    assert name == j_solver.segment_name(data, 1)
    assert reap_orphan_segments(data, 2) == [name]
    assert Segment.attach(name) is None
