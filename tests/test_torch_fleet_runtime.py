"""The port's process-per-shard fleet runtime (evergreen_tpu_torch/runtime/)
on the CPU: workers run with ``--device cpu`` (``FleetSupervisor(...,
device="cpu")``).

The contracts of ``tests/test_fleet_runtime.py``, held on the port:
control-protocol framing byte-equal to the JAX package's, spawn /
heartbeat / rounds, the restart backoff, a worker killed mid-round and
its fenced takeover at a higher epoch with one recovery pass, hang
detection, a handoff over the control protocol, a graceful stop that
releases every lease, orphan mode draining at the end of its grace,
adoption with no epoch bump and no recovery pass, ``stale_sup``
rejection, a second supervisor refused, a deposed supervisor standing
down, the solver-leader election rule, a crash inside the boot's
recovery pass, and a card fault in a tick ending the worker.

Workloads are tiny (2–4 distros, 16–24 tasks) and lease TTLs short, so a
fenced takeover lands in about two seconds; each worker process imports
torch (a few seconds), so these tests live apart from the parity file
(``test_torch_fleet_parity.py``) for ``--dist loadfile`` to spread them.
"""
import io
import json
import os
import signal
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu_torch.models import distro as t_distro  # noqa: E402
from evergreen_tpu_torch.models import host as t_host  # noqa: E402
from evergreen_tpu_torch.models import task as t_task  # noqa: E402
from evergreen_tpu_torch.runtime import manifest  # noqa: E402
from evergreen_tpu_torch.runtime import worker as t_worker  # noqa: E402
from evergreen_tpu_torch.runtime.protocol import parse_line, send_msg  # noqa: E402
from evergreen_tpu_torch.runtime.supervisor import FleetSupervisor  # noqa: E402
from evergreen_tpu_torch.scheduler.sharded_plane import (  # noqa: E402
    HANDOFFS_COLLECTION,
    ShardedScheduler,
    fleet_owner_violations,
)
from evergreen_tpu_torch.storage.durable import DurableStore  # noqa: E402
from evergreen_tpu_torch.storage.lease import shard_lease_path  # noqa: E402
from evergreen_tpu_torch.storage.store import Store  # noqa: E402
from evergreen_tpu_torch.utils.benchgen import NOW, generate_problem  # noqa: E402
from evergreen_tpu_torch.utils.retry import RetryPolicy  # noqa: E402

TICK_S = 15.0


def seed_fleet(data_dir, n_shards, distros=2, tasks=16, seed=11, claims=False):
    """Partition one generated problem over the shard segments at epoch 0,
    before any worker spawns (no lease: the workers' leased writes land
    after these). ``claims`` keeps benchgen's ``running_task`` stamps on
    hosts whose task documents do not exist (recovery step 1 releases
    them); without it they are cleared, as the JAX harness seeds."""
    ds, tbd, hbd, _, _ = generate_problem(distros, tasks, seed=seed,
                                          hosts_per_distro=3)
    src = Store()
    for d in ds:
        t_distro.insert(src, d)
    for ts in tbd.values():
        t_task.insert_many(src, ts)
    for hs in hbd.values():
        for h in hs:
            if not claims:
                for f, v in t_host.RUNNING_TASK_CLEAR_FIELDS.items():
                    setattr(h, f, v)
        t_host.insert_many(src, hs)
    plane = ShardedScheduler([DurableStore(str(data_dir), shard_id=k)
                              for k in range(n_shards)],
                             device="cpu", stacked="never")
    plane.seed_partition(src)
    plane.close()


def policy(base=0.2, cap=2.0):
    return RetryPolicy(attempts=1_000_000, base_backoff_s=base, max_backoff_s=cap,
                       jitter=0.0)


def fleet(data_dir, n_shards, seed=True, workload=None, **kw):
    if seed:
        seed_fleet(data_dir, n_shards, **(workload or {}))
    kw.setdefault("ttl_s", 1.0)
    kw.setdefault("hb_interval_s", 0.2)
    kw.setdefault("hb_deadline_s", 1.2)
    kw.setdefault("harness", True)
    kw.setdefault("recovery_anchor", NOW)
    kw.setdefault("restart_policy", policy())
    kw.setdefault("orphan_grace_s", 30.0)
    kw.setdefault("orphan_tick_s", 0.5)
    kw.setdefault("supervisor_lease_ttl_s", 1.0)
    kw.setdefault("device", "cpu")
    return FleetSupervisor(str(data_dir), n_shards, **kw)


def reap(sup):
    """Wait out a crashed-then-superseded supervisor's Popen handles."""
    for h in sup.handles.values():
        if h.proc is None:
            continue
        if h.proc.poll() is None:
            try:
                h.proc.kill()
            except OSError:
                pass
        try:
            h.proc.wait(timeout=10.0)
        except Exception:  # noqa: BLE001 — best effort
            pass


def wait_until(cond, timeout_s=30.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def open_shards(data_dir, n_shards):
    """Each shard's segment read-only: the inspection idiom (close the
    journal handle, never ``close()``, which would checkpoint)."""
    stores = [DurableStore(str(data_dir), shard_id=k) for k in range(n_shards)]
    for s in stores:
        s._journal.close()
    return stores


# --------------------------------------------------------------------------- #
# control-protocol framing
# --------------------------------------------------------------------------- #


MESSAGES = [
    dict(op="tick", now=NOW, req=3, sup=2,
         solver={"epoch": 1, "seq": 4, "timeout_s": 10.0, "dims": {"N": 64}}),
    dict(op="round", shard=1, tick=0, ms=12.345, n_tasks=16, degraded="",
         level="green", epoch=1, queued=7, solve="stacked", solve_cause=""),
    dict(op="hello", shard=0, pid=123, epoch=2,
         recovered={"released_claims": 1, "stranded_reset": 0,
                    "stale_frames_dropped": 0}),
    dict(op="heartbeat", shard=0, ts=NOW + 0.5, stale_rejects=0, cmd_silences=0,
         orphan=False),
    dict(op="error", detail="unknown op 'x' — ü", obj=object()),
]
LINES = ['{"op":"round","ms":1.5}\n', '{"op":"round","ms"', "some warning text\n",
         "", "   \n", "[1,2,3]\n", '{"no_op_field":1}\n', '{"op":7}\n',
         '  {"op":"status","shard":0}  \n', "{not json}\n"]


def test_framing_is_byte_equal_to_the_jax_package():
    """``send_msg`` writes the JAX package's bytes for every message (one
    compact JSON line, ``default=str``), ``parse_line`` accepts and
    rejects the same lines, and the exit codes are JAX's."""
    jax_protocol = pytest.importorskip("evergreen_tpu.runtime.protocol")
    from evergreen_tpu_torch.runtime import protocol as t_protocol

    for msg in MESSAGES:
        bufs = [io.StringIO(), io.StringIO()]
        assert t_protocol.send_msg(bufs[0], None, **msg)
        assert jax_protocol.send_msg(bufs[1], None, **msg)
        assert bufs[0].getvalue() == bufs[1].getvalue()
        assert bufs[0].getvalue().count("\n") == 1
    for line in LINES:
        assert t_protocol.parse_line(line) == jax_protocol.parse_line(line), line
    assert parse_line(LINES[0]) == {"op": "round", "ms": 1.5}
    assert parse_line(LINES[1]) is None
    buf = io.StringIO()
    buf.close()
    assert send_msg(buf, op="tick") is False  # dead peer: no raise
    for name in ("EXIT_CRASHED", "EXIT_LOST", "EXIT_FENCED"):
        assert getattr(t_protocol, name) == getattr(jax_protocol, name)


def test_worker_skips_garbage_command_lines(tmp_path):
    """Torn or garbage lines on a live worker's stdin are skipped; the
    next well-formed command still executes; an unknown op is answered
    with an error, and the worker lives on."""
    sup = fleet(tmp_path, 1)
    try:
        sup.start(monitor=False)
        h = sup.handles[0]
        assert h.state == "ready"
        h.proc.stdin.write("NOT JSON AT ALL\n")
        h.proc.stdin.write('{"op":"status"\n')
        h.proc.stdin.write('{"no_op": true}\n')
        h.proc.stdin.flush()
        h.send(op="status")
        reply = h.wait_reply("status", 15.0)
        assert reply is not None and reply["shard"] == 0
        assert reply["launches"] == {"fused_distro_stats": 0, "segment_sum": 0,
                                     "segment_sum_by_plan": {}}
        h.send(op="agent_sim")  # not ported: an error, not a death
        assert h.wait_reply("agent_done", 5.0) is None
        assert h.alive()
    finally:
        sup.stop()


# --------------------------------------------------------------------------- #
# spawn / heartbeat / rounds / restarts
# --------------------------------------------------------------------------- #


def test_spawn_heartbeat_and_rounds(tmp_path):
    sup = fleet(tmp_path, 1)
    try:
        sup.start(monitor=False)
        h = sup.handles[0]
        assert h.state == "ready" and h.epochs == [1]
        assert h.hellos[0]["recovered"]["released_claims"] == 0
        time.sleep(0.6)  # a few beats
        assert not h.hb_deadline.exceeded()
        for r in range(3):
            res = sup.round(now=NOW + (r + 1) * TICK_S)
            assert res[0]["epoch"] == 1 and res[0]["degraded"] == ""
            assert res[0]["n_tasks"] == 16 and res[0]["tick"] == r
            assert "solve" not in res[0]  # one shard: no leader
        assert sup.rounds_done == 3
        st = sup.fleet_state()
        assert st["rounds"] == 3 and st["workers"]["0"]["last_round_ms"] > 0
    finally:
        sup.stop()


def test_restart_backoff_grows_exponentially(tmp_path):
    """Consecutive failures widen the respawn pause; a quick hello does
    not reset the streak, a sustained healthy period does."""
    sup = FleetSupervisor(str(tmp_path), 1, restart_policy=policy(base=0.1, cap=10.0),
                          device="cpu")
    h = sup.handles[0]
    sup._schedule_restart(h, 86)
    h.state = "new"
    h.ready_since = time.monotonic()
    sup._schedule_restart(h, 86)
    h.state = "new"
    sup._schedule_restart(h, 86)
    assert h.backoffs == [pytest.approx(0.1), pytest.approx(0.2), pytest.approx(0.4)]
    h.ready_since = time.monotonic() - (FleetSupervisor.BACKOFF_RESET_AFTER_S + 1.0)
    sup._schedule_restart(h, 86)
    assert h.backoffs[-1] == pytest.approx(0.1)


def test_killed_mid_round_fenced_takeover_with_one_recovery_pass(tmp_path):
    """A worker dies AT the ``wal.commit`` seam mid-round; the watchdog
    restarts it; the replacement steals the shard lease at a strictly
    higher epoch, runs one recovery pass (its hello says so) and ticks on;
    every document has one owner."""
    sup = fleet(tmp_path, 2, workload=dict(distros=4, tasks=24, claims=True))
    try:
        sup.start()
        assert [h.hellos[0]["recovered"]["released_claims"]
                for h in sup.handles.values()] != [0, 0]
        sup.round(now=NOW + TICK_S)
        h = sup.handles[0]
        h.send(op="arm_fault", seam="wal.commit", kind="crash")
        assert h.wait_reply("armed", 10.0) is not None
        res = sup.round(now=NOW + 2 * TICK_S)
        assert 0 not in res and 1 in res
        assert wait_until(lambda: h.restarts == 1 and h.state == "ready")
        assert h.exits == [86]
        assert h.epochs == [1, 2]
        assert len(h.hellos) == 2 and "recovered" in h.hellos[1]
        res = sup.round(now=NOW + 3 * TICK_S)
        assert sorted(res) == [0, 1] and res[0]["epoch"] == 2
        assert sup.handles[1].restarts == 0
    finally:
        sup.stop()
    stores = open_shards(tmp_path, 2)
    assert fleet_owner_violations(stores) == []
    for k in range(2):
        assert not os.path.exists(shard_lease_path(str(tmp_path), k))


def test_crash_inside_the_boot_recovery_restarts_clean(tmp_path):
    """A worker killed at the ``recovery.pass`` seam of its first boot
    comes back clean (the spawn-time fault is first-spawn only) at epoch
    2, and its recovery pass then heals the store."""
    sup = fleet(tmp_path, 1, spawn_crash={0: "recovery.pass@0"},
                workload=dict(claims=True))
    try:
        sup.start()
        h = sup.handles[0]
        assert wait_until(lambda: h.state == "ready")
        assert h.exits == [86] and h.epochs == [2]
        assert h.hellos[0]["recovered"]["released_claims"] > 0
        assert sup.round(now=NOW + TICK_S)[0]["epoch"] == 2
    finally:
        sup.stop()


def test_hang_detection_kills_and_restarts(tmp_path):
    """A SIGSTOPped worker stops heartbeating; the missed-heartbeat
    deadline kills it and the restart comes back at a higher epoch."""
    sup = fleet(tmp_path, 1)
    try:
        sup.start()
        h = sup.handles[0]
        os.kill(h.pid, signal.SIGSTOP)
        assert wait_until(lambda: h.restarts == 1 and h.state == "ready")
        assert h.exits and h.exits[0] < 0  # killed, not exited
        assert h.epochs == [1, 2]
        assert sup.round(now=NOW + TICK_S)[0]["epoch"] == 2
    finally:
        sup.stop()


def test_card_fault_in_a_tick_ends_the_worker(tmp_path, monkeypatch, capfd):
    """A ``KernelError`` raised out of ``run_tick`` ends the worker with
    the error on stderr and ``EXIT_KERNEL`` (its supervisor then restarts
    it like any exit): the tick is never finished on the CPU."""
    from evergreen_tpu_torch.ops._build import KernelError
    from evergreen_tpu_torch.scheduler import wrapper

    seed_fleet(tmp_path, 1)
    args = t_worker._build_parser().parse_args(
        ["--data-dir", str(tmp_path), "--device", "cpu", "--hb-interval", "5"])
    out = io.StringIO()
    w = t_worker.ShardWorker(args, out)
    monkeypatch.setattr(w.stdio, "rfile", io.StringIO(
        json.dumps({"op": "tick", "now": NOW}) + "\n"))

    def failing_tick(*a, **k):
        raise KernelError("fused_distro_stats: CUDA launch failed with cudaError_t 700")

    def exit_(code):
        raise SystemExit(code)

    monkeypatch.setattr(wrapper, "run_tick", failing_tick)
    monkeypatch.setattr(t_worker.os, "_exit", exit_)
    try:
        with pytest.raises(SystemExit) as exc:
            w.run()
        assert exc.value.code == t_worker.EXIT_KERNEL
        assert "cudaError_t 700" in capfd.readouterr().err
        assert manifest.read_entry(str(tmp_path), 0) is None
        assert [parse_line(line)["op"] for line in out.getvalue().splitlines()] == ["hello"]
    finally:
        w._hb_stop.set()
        w.lease.release()
        w.store._journal.close()


def test_entry_points_need_a_card_unless_cpu(tmp_path):
    """Without a card the supervisor raises unless given ``device="cpu"``,
    and the worker's ``main`` probes the card first."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetSupervisor(str(tmp_path), 2)
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        t_worker.main(["--data-dir", str(tmp_path)])


# --------------------------------------------------------------------------- #
# handoffs, stop, orphan mode, adoption, supervisor fencing
# --------------------------------------------------------------------------- #


def test_migrate_over_control_protocol(tmp_path):
    sup = fleet(tmp_path, 2, workload=dict(distros=4, tasks=24))
    try:
        sup.start()
        sup.round(now=NOW + TICK_S)
        st = sup.broadcast("load", "load")
        src, reps = next((k, v["reps"]) for k, v in sorted(st.items()) if v["reps"])
        distro = sorted(reps.values())[0]
        dst = (src + 1) % 2
        rec = sup.migrate(distro, src, dst, now=NOW + 16.0)
        assert rec is not None and rec["state"] == "released"
        assert distro in rec["group"] and sup.migrations == [rec]
        res = sup.round(now=NOW + 2 * TICK_S)
        assert sorted(res) == [0, 1]
        sup.drain()
    finally:
        sup.stop()
    stores = open_shards(tmp_path, 2)
    assert fleet_owner_violations(stores) == []
    assert stores[dst].collection("distros").get(distro) is not None
    assert stores[src].collection("distros").get(distro) is None
    assert stores[src].collection(HANDOFFS_COLLECTION).get(rec["_id"])["state"] == "done"
    assert stores[dst].collection(HANDOFFS_COLLECTION).get(rec["_id"])["state"] == "primed"


def test_graceful_stop_releases_all_leases(tmp_path):
    sup = fleet(tmp_path, 2, workload=dict(distros=4, tasks=24), solver="always")
    sup.start()
    for k in range(2):
        assert os.path.exists(shard_lease_path(str(tmp_path), k))
    sup.round(now=NOW + TICK_S)
    sup.stop(graceful=True)
    for k in range(2):
        assert not os.path.exists(shard_lease_path(str(tmp_path), k))
    for name in ("supervisor.lease", "solver.lease"):
        assert not os.path.exists(os.path.join(str(tmp_path), name))
    for h in sup.handles.values():
        assert h.proc.poll() == 0
    assert manifest.read_all(str(tmp_path)) == {}


def _lease_doc(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def test_orphan_keeps_renewing_then_drains_at_grace_expiry(tmp_path):
    """A supervisor crash puts the worker in orphan mode: it keeps its
    shard lease (renewals land), ticks locally, and at grace expiry drains,
    releases the lease and removes its manifest entry."""
    sup = fleet(tmp_path, 1, orphan_grace_s=4.0, orphan_tick_s=0.5)
    sup.start()
    sup.round(now=NOW + TICK_S)
    h = sup.handles[0]
    lease_path = shard_lease_path(str(tmp_path), 0)
    entry = manifest.read_entry(str(tmp_path), 0)
    assert entry is not None and entry["pid"] == h.pid and os.path.exists(entry["sock"])
    sup.simulate_crash()
    time.sleep(1.0)
    assert h.proc.poll() is None, "the worker outlives the supervisor"
    doc1 = _lease_doc(lease_path)
    assert doc1["epoch"] == 1
    time.sleep(0.8)
    assert _lease_doc(lease_path)["at"] > doc1["at"], "an orphan keeps renewing"
    assert h.proc.wait(timeout=30.0) == 0
    assert not os.path.exists(lease_path)
    assert manifest.read_entry(str(tmp_path), 0) is None
    assert not os.path.exists(entry["sock"])


def test_adoption_within_grace_no_epoch_bump_no_recovery(tmp_path):
    """Kill the supervisor, start another: both live workers are ADOPTED —
    same pids, same shard-lease epochs, still at their one boot recovery
    pass, orphan ticks recorded — and the fleet rounds on."""
    sup = fleet(tmp_path, 2, workload=dict(distros=4, tasks=24))
    sup2 = None
    try:
        sup.start()
        sup.round(now=NOW + TICK_S)
        pre = {k: (h.pid, h.epoch) for k, h in sup.handles.items()}
        sup.simulate_crash()
        time.sleep(1.6)  # orphan, and at least one autonomous tick
        sup2 = fleet(tmp_path, 2, seed=False)
        sup2.start()
        assert sup2.sup_epoch > sup.sup_epoch
        for k, h in sup2.handles.items():
            assert h.adopted and h.pid == pre[k][0]
            assert h.epochs == [pre[k][1]]
            assert h.adopt_hello["recovery_passes"] == 1
            assert h.adopt_hello["orphaned"] is True
            assert h.adopt_hello["tick"] >= 1
            assert h.restarts == 0
        assert sup2.adoptions_total == 2 and sup2.orphaned_total == 2
        res = sup2.round(now=NOW + 5 * TICK_S)
        assert sorted(res) == [0, 1]
    finally:
        if sup2 is not None:
            sup2.stop()
        reap(sup)
    assert fleet_owner_violations(open_shards(tmp_path, 2)) == []


def test_stale_supervisor_commands_rejected(tmp_path):
    """Commands carrying a superseded supervisor epoch, or arriving on a
    channel never adopted, come back ``stale_sup`` and do not execute;
    the live supervisor learns the count through heartbeats."""
    sup = fleet(tmp_path, 1)
    try:
        sup.start()
        sup.round(now=NOW + TICK_S)
        pre_tick = sup.statuses()[0]["tick"]
        entry = manifest.read_entry(str(tmp_path), 0)
        conn = manifest.connect(entry["sock"], timeout_s=5.0)
        rf = conn.makefile("r", encoding="utf-8")
        wf = conn.makefile("w", encoding="utf-8")
        lock = threading.Lock()
        try:
            for op, sup_e in (("adopt", sup.sup_epoch), ("adopt", 0),
                              ("tick", 0), ("shutdown", 0)):
                req = f"rogue-{op}-{sup_e}"
                send_msg(wf, lock, op=op, sup=sup_e, req=req, now=NOW + 30.0)
                reply = None
                while reply is None:
                    msg = parse_line(rf.readline())
                    if msg is not None and msg.get("req") == req:
                        reply = msg
                assert reply["op"] == "stale_sup", (op, reply)
        finally:
            for f in (rf, wf, conn):
                f.close()
        assert sup.statuses()[0]["tick"] == pre_tick
        assert sup.round(now=NOW + 2 * TICK_S)
        assert wait_until(lambda: sup.handles[0].stale_rejects >= 4, 5.0)
    finally:
        sup.stop()


def test_second_supervisor_cannot_acquire_held_fleet_lease(tmp_path):
    sup = fleet(tmp_path, 1)
    try:
        sup.start()
        rogue = fleet(tmp_path, 1, seed=False)
        rogue.fleet_acquire_timeout_s = 1.5
        rogue.adopt_enabled = False
        with pytest.raises(RuntimeError, match="fleet lease"):
            rogue.start()
        assert sup.round(now=NOW + TICK_S)
    finally:
        sup.stop()


def test_deposed_supervisor_stands_down_without_killing_workers(tmp_path):
    sup = fleet(tmp_path, 1)
    try:
        sup.start()
        h = sup.handles[0]
        sup._fleet_deposed("test: simulated loss")
        assert sup.round(now=NOW + TICK_S) == {}
        assert sup.broadcast("status", "status") == {}
        sup.stop()
        assert h.proc.poll() is None, "a deposed supervisor leaves the workers"
    finally:
        sup.deposed = False
        sup.crashed = True
        reap(sup)


# --------------------------------------------------------------------------- #
# the solver-leader election rule
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["always", "auto", "never"])
def test_solver_election_rule(mode, tmp_path):
    """``"always"`` elects the leader and every round is stacked on the
    CPU; ``"auto"`` counts devices (1 on the CPU, fewer than the shards:
    no leader, local solves); ``"never"`` elects none. Each shard's
    documents are the same whichever rule solved them."""
    sup = fleet(tmp_path / mode, 2, workload=dict(distros=4, tasks=24), solver=mode)
    try:
        sup.start()
        modes = []
        for r in range(2):
            res = sup.round(now=NOW + (r + 1) * TICK_S)
            assert sorted(res) == [0, 1]
            modes.append(sorted({v.get("solve", "unstamped") for v in res.values()}))
        state = sup.fleet_state()
    finally:
        sup.stop()
    if mode == "always":
        assert state["solver_epoch"] == 1
        assert modes == [["stacked"], ["stacked"]]
        assert state["solver_rounds"] == {"stacked": 2}
    else:
        assert state["solver_epoch"] == 0 and sup.solver_service is None
        assert modes == [["unstamped"], ["unstamped"]]


def test_spawn_crash_argument_and_hang_plan():
    """The worker's ``--crash seam@idx`` and ``--hang seam:delay`` install
    the fault plan they name."""
    from evergreen_tpu_torch.utils import faults

    try:
        t_worker._install_spawn_faults(types.SimpleNamespace(
            crash="recovery.pass@2", hang="wal.commit:0.25"))
        plan = faults.active()
        assert plan._at["recovery.pass"][2].kind == "crash"
        assert plan._always["wal.commit"].kind == "hang"
        assert plan._always["wal.commit"].delay_s == 0.25
    finally:
        faults.uninstall()
