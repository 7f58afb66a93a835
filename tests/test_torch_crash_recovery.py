"""The port's split-brain-safe failover and its process crash matrix
(``evergreen_tpu_torch/scenarios/crash_matrix.py``) against the JAX
package's (``tools/crash_matrix.py``, ``tests/test_crash_recovery.py``).

The tests of ``tests/test_crash_recovery.py`` that no other port test
holds run on the port as they are (``twin``: the same source with every
``evergreen_tpu`` import pointed at the port); the three that run a tick,
populate the tick jobs or build an environment, which on the port take a
device, are written out with ``device="cpu"``, and the one that resets
the log's counters reads them as deltas. The crash matrix's tier-1 point converges to JAX's
uninterrupted reference; ``check_invariants`` and ``canonical_state``
read the same data directory as JAX's do; the full 13 points and the
failover are slow, as in JAX's file."""
import json
import os
import tempfile

import pytest

from evergreen_tpu_torch.scenarios import crash_matrix as t_cm
from test_torch_lockcheck import jax_crash_matrix, run_twin

NOW = 1_700_000_000.0

#: the tests another port test already holds: the fenced commit, the
#: stale frames and per-op lines, the same-doc clobber, the fence marker
#: and the orphaned frames (tests/test_torch_durable.py), the bare
#: building host's reap (tests/test_torch_monitors.py); the three below
#: that take a device and the one that resets the log's counters (the
#: port reads them as deltas); the crash matrix's own, below
HELD = (
    "test_fenced_commit_sheds_group_and_stands_down",
    "test_replay_drops_superseded_epoch_frames",
    "test_replay_drops_superseded_per_op_records",
    "test_stale_write_to_same_doc_cannot_clobber",
    "test_fence_marker_drops_late_frame_before_first_commit",
    "test_standby_epoch_outranks_orphaned_wal_frames",
    "test_reap_stale_building_missing_timestamps",
    "test_run_tick_refuses_when_fenced",
    "test_fenced_store_skips_scheduler_tick_population",
    "test_environment_build_runs_recovery_pass",
    "test_recovery_counts_via_structured_log",
    "test_crash_point_dispatch_assign_recovers",
    "test_crash_matrix_full",
    "test_two_process_failover",
)


def _port_store():
    from evergreen_tpu_torch.storage.store import reset_global_store

    return reset_global_store()


def jax_cases():
    import test_crash_recovery

    return [n for n in vars(test_crash_recovery)
            if n.startswith("test_") and n not in HELD]


@pytest.mark.parametrize("name", jax_cases())
def test_jax_crash_recovery_case_on_the_port(name, tmp_path):
    run_twin("test_crash_recovery", name, tmp_path, extra={"store": _port_store})


def test_run_tick_refuses_when_fenced(tmp_path):
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models.distro import Distro
    from evergreen_tpu_torch.scheduler.wrapper import TickOptions, run_tick
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.lease import FileLease

    lease = FileLease(str(tmp_path / "data" / "writer.lease"), ttl_s=60.0)
    assert lease.try_acquire()
    store = DurableStore(str(tmp_path / "data"), lease=lease)
    distro_mod.insert(store, Distro(id="d1"))
    thief = FileLease(str(tmp_path / "data" / "writer.lease"), ttl_s=60.0)
    thief.ttl_s = -1.0  # anything is stale: steal immediately
    assert thief.try_acquire()
    res = run_tick(store, TickOptions(create_intent_hosts=False), now=NOW, device="cpu")
    assert res.degraded == "fenced"
    assert res.queues == {}


def test_fenced_store_skips_scheduler_tick_population(tmp_path):
    """The on_lost path at the populator level: once the renewer observed
    the loss, the cron plane stops enqueueing ticks and per-op writes
    refuse."""
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.lease import EpochFencedError, FileLease
    from evergreen_tpu_torch.units.crons import scheduler_tick_jobs

    lease = FileLease(str(tmp_path / "data" / "writer.lease"), ttl_s=60.0)
    assert lease.try_acquire()
    store = DurableStore(str(tmp_path / "data"), lease=lease)
    thief = FileLease(str(tmp_path / "data" / "writer.lease"), ttl_s=60.0)
    thief.ttl_s = -1.0
    assert thief.try_acquire()
    lease.stand_down("renewal failed")  # what the renewer thread does
    assert store.fenced
    assert scheduler_tick_jobs(store, NOW, device="cpu") == []
    with pytest.raises(EpochFencedError):
        store.collection("poke").upsert({"_id": "x"})


def test_environment_build_runs_recovery_pass(tmp_path):
    """A durable-writer Environment heals the data dir before the job
    plane starts (the standby-takeover entry point)."""
    from evergreen_tpu_torch.env import Environment
    from evergreen_tpu_torch.globals import TaskStatus
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.models.task import Task
    from evergreen_tpu_torch.storage.durable import DurableStore

    d = str(tmp_path / "data")
    seed = DurableStore(d)
    task_mod.insert(
        seed,
        Task(id="t1", distro_id="d1", status=TaskStatus.STARTED.value,
             activated=True, host_id="gone", last_heartbeat=1.0),
    )
    seed.close()
    env = Environment.build(data_dir=d, workers=1, device="cpu")
    try:
        assert env.recovery_report is not None
        assert env.recovery_report.reconciled_tasks == 1
        assert env.store.epoch == env.lease.epoch > 0
    finally:
        env.close()


def test_recovery_counts_via_structured_log():
    from evergreen_tpu_torch.globals import TaskStatus
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.models.task import Task
    from evergreen_tpu_torch.scheduler.recovery import run_recovery_pass
    from evergreen_tpu_torch.utils import log as log_mod

    store = _port_store()
    task_mod.insert(
        store,
        Task(id="t1", distro_id="d1", status=TaskStatus.DISPATCHED.value,
             activated=True, host_id="gone", last_heartbeat=NOW - 10),
    )
    before = log_mod.get_counter("recovery.reconciled_tasks")
    got = []
    log_mod.add_sink(got.append)
    try:
        run_recovery_pass(store, now=NOW)
    finally:
        log_mod.remove_sink(got.append)
    assert log_mod.get_counter("recovery.reconciled_tasks") == before + 1
    recs = [r for r in got if r.get("message") == "recovery-pass"]
    assert recs and recs[0]["reconciled_tasks"] == 1


# --------------------------------------------------------------------------- #
# the crash matrix
# --------------------------------------------------------------------------- #


@pytest.fixture()
def temp_root(tmp_path, monkeypatch):
    """Both harnesses' ``tempfile.mkdtemp`` data dirs under ``tmp_path``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """JAX's uninterrupted run of the workload (a JAX child process)."""
    j_cm = jax_crash_matrix()

    old = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("jax-reference"))
    try:
        return j_cm.reference_state()
    finally:
        tempfile.tempdir = old


def test_the_constants_are_jax_s():
    j_cm = jax_crash_matrix()

    for name in ("NOW", "TICK_S", "DEFAULT_TICKS", "LEASE_TTL_S", "KILL_POINTS",
                 "SHARDED_KILL_POINTS", "MIGRATE_TICK"):
        assert getattr(t_cm, name) == getattr(j_cm, name), name


def test_crash_point_dispatch_assign_recovers(temp_root, jax_reference):
    """The tier-1 reduced sample: one real SIGKILL-shaped death between
    the dispatch CAS pair; the restarted process reconciles and converges
    to the uninterrupted run's state, the port's and JAX's alike."""
    reference = t_cm.reference_state(device="cpu")
    assert reference == jax_reference
    out = t_cm.run_point("dispatch.assign", 0, reference=reference, device="cpu")
    assert out["ok"], out
    assert out["crashed"] and out["rc"] == (86, 0) and out["epochs"] == [1, 2]
    assert t_cm.canonical_state(t_cm._open_for_inspection(out["data_dir"])) == jax_reference
    # the second life reported every tick, and on the CPU launched nothing
    assert out["lives"][1]["ticks"] == list(range(t_cm.DEFAULT_TICKS))
    assert out["lives"][1]["card_solves"]["solves"] == 0
    assert all(life["inversions"] == 0 for life in out["lives"])


@pytest.mark.parametrize("state", ["half-dispatched", "converged"])
def test_invariants_and_canonical_state_read_the_dir_as_jax(state, temp_root):
    """JAX's ``check_invariants`` and ``canonical_state`` and the port's on
    one data directory: a child killed between the dispatch CAS pair (a
    host claims a task that never left ``undispatched``), and a
    converged run."""
    from evergreen_tpu.storage.durable import DurableStore as JStore
    j_cm = jax_crash_matrix()

    data_dir = str(temp_root / "data")
    os.makedirs(data_dir)
    crash = "dispatch.assign@0" if state == "half-dispatched" else ""
    rc, out = t_cm._run_child(data_dir, t_cm.DEFAULT_TICKS, crash=crash, device="cpu")
    assert rc == (86 if crash else 0), out
    port, jax = t_cm._open_for_inspection(data_dir), JStore(data_dir)
    got, want = t_cm.check_invariants(port), j_cm.check_invariants(jax)
    assert got == want
    assert bool(got) == (state == "half-dispatched")
    assert t_cm.canonical_state(port) == j_cm.canonical_state(jax)
    assert t_cm.wal_frame_epochs(data_dir) == j_cm.wal_frame_epochs(data_dir)


def test_a_life_s_launch_lines_are_held_to_its_solves():
    """``life_launches`` holds each ``LAUNCHES`` line to the launches of
    the card solves it reports, and counts inversion lines."""
    def line(tick, fds, ss, solves, iters):
        return "LAUNCHES " + json.dumps({
            "tick": tick, "device_ticks": tick + 1, "launches": {"fused_distro_stats": fds, "segment_sum": ss,
                                       "segment_sum[task]": solves,
                                       "segment_sum[host]": solves,
                                       "segment_sum[pool]": ss - 2 * solves},
            "card_solves": {"solves": solves, "capacity_iters": iters}})

    good = "\n".join(["EPOCH 2", "TICK-DONE 0", line(0, 1, 5, 1, 0),
                      "TICK-DONE 1", line(1, 2, 12, 2, 2)])
    life = t_cm.life_launches(good)
    assert life["ticks"] == [0, 1] and life["problems"] == [] and life["inversions"] == 0
    assert life["card_solves"] == {"solves": 2, "capacity_iters": 2}
    assert life["device_ticks"] == 2
    bad = "\n".join(["TICK-DONE 0", line(0, 1, 6, 1, 0),
                     "lockcheck: ORDER INVERSION thread=t acquired 'a' while holding 'b'"])
    life = t_cm.life_launches(bad)
    assert len(life["problems"]) == 1 and life["inversions"] == 1
    assert t_cm.expected_launches(3, 7) == {
        "fused_distro_stats": 3, "segment_sum": 22, "segment_sum[task]": 3,
        "segment_sum[host]": 3, "segment_sum[pool]": 16}


@pytest.mark.slow
@pytest.mark.parametrize("seam,idx", t_cm.KILL_POINTS)
def test_crash_matrix_full(seam, idx, temp_root):
    out = t_cm.run_point(seam, idx, reference=t_cm.reference_state(device="cpu"),
                         device="cpu")
    assert out["ok"], out


@pytest.mark.slow
def test_two_process_failover(temp_root):
    """Holder SIGSTOPped mid-commit, standby steals + reconciles, holder
    SIGCONTed: the resumed holder's commit is rejected (EpochFencedError
    -> FENCED/exit 75, or the renewer's stand-down), and zero stale-epoch
    frames survive past the fence point."""
    out = t_cm.failover_case(device="cpu")
    assert out["ok"], out
    assert out["standby_epoch"] > out["holder_epoch"]
