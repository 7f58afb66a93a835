"""The network-chaos plane of the port against the JAX package's.

The counterparts of JAX's ``tests/test_net_chaos.py`` whose subjects the
port has: the transport-fault vocabulary (``utils/faults.py``), the
supervisor's ``wait_reply`` hardening against duplicated and reordered
replies, the command-staleness knob and its heartbeat mirror, the
dispatch CAS under duplicate delivery, the agent transport's full-jitter
retries and bounded partition budget, and the ``sock.adopt`` seam
(refused and half-open). Then the supervisor's own transport seams,
``ipc.send`` and ``ipc.recv`` with their shard-scoped aliases, driven
through each package's ``WorkerHandle`` and reader over in-memory pipes
under the same fault plan: the same messages arrive in the same order.
"""
from __future__ import annotations

import io
import random
import socket
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu.runtime import supervisor as j_supervisor  # noqa: E402
from evergreen_tpu.utils import faults as j_faults  # noqa: E402

from evergreen_tpu_torch.runtime import manifest as t_manifest  # noqa: E402
from evergreen_tpu_torch.runtime import supervisor as t_supervisor  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402

KINDS = ("drop", "duplicate", "reorder", "partition", "half_open")


@pytest.fixture
def faults():
    """The port's fault module, its plan removed afterwards."""
    yield t_faults
    t_faults.uninstall()


# --------------------------------------------------------------------------- #
# the transport-fault vocabulary
# --------------------------------------------------------------------------- #


def test_transport_kinds_surface_as_directives(faults):
    plan = faults.FaultPlan()
    for i, kind in enumerate(KINDS):
        plan.at("x.seam", i, faults.Fault(kind))
    faults.install(plan)
    assert [faults.fire("x.seam") for _ in range(6)] == [*KINDS, None]


def test_transport_plan_counts_fired_per_seam(faults):
    plan = faults.FaultPlan().always("y.seam", faults.Fault("drop"))
    faults.install(plan)
    before = faults.FAULTS_FIRED.value(seam="y.seam")
    for _ in range(3):
        assert faults.fire("y.seam") == "drop"
    assert faults.FAULTS_FIRED.value(seam="y.seam") == before + 3
    assert plan.fired == [("y.seam", 0, "drop"), ("y.seam", 1, "drop"),
                          ("y.seam", 2, "drop")]


def test_delay_kind_sleeps_then_proceeds(faults):
    faults.install(faults.FaultPlan().at("z.seam", 0, faults.Fault("delay", delay_s=0.05)))
    t0 = time.monotonic()
    assert faults.fire("z.seam") is None  # delayed, not dropped
    assert time.monotonic() - t0 >= 0.04
    assert faults.fire("z.seam") is None  # one-shot


# --------------------------------------------------------------------------- #
# wait_reply hardening
# --------------------------------------------------------------------------- #


def _handle(shard):
    return t_supervisor.WorkerHandle(shard, hb_deadline_s=5.0)


def test_wait_reply_rejects_reordered_stale_reply():
    h = _handle(191)
    before = t_supervisor.IPC_STALE_REPLIES.value(shard=191)
    h.replies.put({"op": "round", "req": 1, "body": "first"})
    assert h.wait_reply("round", 1.0, req=1)["body"] == "first"
    h.replies.put({"op": "round", "req": 1, "body": "late"})
    h.replies.put({"op": "round", "req": 2, "body": "second"})
    assert h.wait_reply("round", 1.0, req=2)["body"] == "second"
    assert t_supervisor.IPC_STALE_REPLIES.value(shard=191) == before + 1


def test_wait_reply_rejects_duplicated_error_leg():
    h = _handle(192)
    before = t_supervisor.IPC_STALE_REPLIES.value(shard=192)
    h.replies.put({"op": "round", "req": 5, "body": "a"})
    h.wait_reply("round", 1.0, req=5)
    h.replies.put({"op": "error", "req": 5})
    h.replies.put({"op": "round", "req": 6, "body": "b"})
    assert h.wait_reply("round", 1.0, req=6)["body"] == "b"
    assert t_supervisor.IPC_STALE_REPLIES.value(shard=192) == before + 1


def test_wait_reply_timed_out_request_id_is_spent():
    h = _handle(193)
    h.proc = types.SimpleNamespace(poll=lambda: None)  # "alive"
    before = t_supervisor.IPC_STALE_REPLIES.value(shard=193)
    assert h.wait_reply("round", 0.1, req=11) is None
    h.replies.put({"op": "round", "req": 11, "body": "too-late"})
    h.replies.put({"op": "round", "req": 12, "body": "mine"})
    assert h.wait_reply("round", 1.0, req=12)["body"] == "mine"
    assert t_supervisor.IPC_STALE_REPLIES.value(shard=193) == before + 1


def test_done_req_book_is_bounded():
    h = _handle(0)
    for req in range(1200):
        h.replies.put({"op": "round", "req": req})
        h.wait_reply("round", 1.0, req=req)
    assert len(h._done_reqs) <= 1024


# --------------------------------------------------------------------------- #
# the command-staleness deadline
# --------------------------------------------------------------------------- #


def test_command_silence_knob_validates():
    from evergreen_tpu.settings import ShardingConfig as JConfig
    from evergreen_tpu_torch.settings import ShardingConfig

    assert ShardingConfig().worker_command_silence_s == 120.0
    bad = ShardingConfig(worker_command_silence_s=-1.0).validate_and_default()
    assert "worker_command_silence_s" in bad
    assert bad == JConfig(worker_command_silence_s=-1.0).validate_and_default()


def test_supervisor_mirrors_cmd_silence_delta_from_heartbeats():
    h = _handle(194)
    before = t_supervisor.FLEET_CMD_SILENCE.value(shard=194)
    recv = t_supervisor.FleetSupervisor._handle_recv
    sup = types.SimpleNamespace()  # the heartbeat branch never touches it
    recv(sup, h, {"op": "heartbeat", "cmd_silences": 2})
    recv(sup, h, {"op": "heartbeat", "cmd_silences": 2})  # repeat: no-op
    recv(sup, h, {"op": "heartbeat", "cmd_silences": 3})
    assert t_supervisor.FLEET_CMD_SILENCE.value(shard=194) == before + 3
    assert h.cmd_silences == 3


# --------------------------------------------------------------------------- #
# dispatch CAS vs duplicate delivery
# --------------------------------------------------------------------------- #


def test_duplicate_delivery_resolves_to_same_assignment():
    from evergreen_tpu_torch.dispatch.assign import assign_next_available_task
    from evergreen_tpu_torch.dispatch.dag_dispatcher import DispatcherService
    from evergreen_tpu_torch.globals import HostStatus, TaskStatus
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.models import task_queue as tq_mod
    from evergreen_tpu_torch.models.host import Host
    from evergreen_tpu_torch.models.task import Task
    from evergreen_tpu_torch.models.task_queue import TaskQueue, TaskQueueItem
    from evergreen_tpu_torch.storage.store import Store

    store = Store()
    now = 1_700_000_000.0
    for tid in ("c1", "c2"):
        task_mod.insert(store, Task(id=tid, distro_id="d1",
                                    status=TaskStatus.UNDISPATCHED.value, activated=True))
    host_mod.insert(store, Host(id="h1", distro_id="d1", status=HostStatus.RUNNING.value))
    tq_mod.save(store, TaskQueue(
        distro_id="d1", generated_at=now,
        queue=[TaskQueueItem(id="c1", dependencies_met=True),
               TaskQueueItem(id="c2", dependencies_met=True)]))
    svc = DispatcherService(store)
    stale = host_mod.get(store, "h1")
    first = assign_next_available_task(store, svc, host_mod.get(store, "h1"), now=now)
    dup = assign_next_available_task(store, svc, host_mod.get(store, "h1"), now=now)
    via_stale = assign_next_available_task(store, svc, stale, now=now)
    assert first is not None and first.id == "c1"
    assert dup is not None and dup.id == "c1"  # resume, not a second claim
    assert via_stale is None or via_stale.id == "c1"  # the CAS fences it
    dispatched = store.collection("events").find(
        lambda d: d.get("event_type") == "TASK_DISPATCHED")
    assert len(dispatched) == 1
    assert host_mod.get(store, "h1").running_task == "c1"


# --------------------------------------------------------------------------- #
# the agent transport
# --------------------------------------------------------------------------- #


def test_agent_retry_backoff_is_full_jitter_and_spreads():
    from evergreen_tpu.agent.rest_comm import RestCommunicator as JComm
    from evergreen_tpu_torch.agent.rest_comm import RestCommunicator

    policy = RestCommunicator("http://127.0.0.1:1").policy
    assert policy.full_jitter
    base = policy.base_backoff_s
    pauses = [policy.backoff_s(0, random.Random(i)) for i in range(64)]
    assert all(0.0 <= p <= base for p in pauses)
    assert max(pauses) - min(pauses) > 0.5 * base
    assert min(pauses) < 0.5 * base
    j_policy = JComm("http://127.0.0.1:1").policy
    assert pauses == [j_policy.backoff_s(0, random.Random(i)) for i in range(64)]


def test_agent_request_partition_exhausts_bounded_budget(faults):
    from evergreen_tpu_torch.agent.rest_comm import RestCommunicator

    comm = RestCommunicator("http://127.0.0.1:1", retries=2, backoff_s=0.01)
    faults.install(faults.FaultPlan().always("agent.request", faults.Fault("partition")))
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        comm._call("GET", "/rest/v2/hosts")
    assert time.monotonic() - t0 < 5.0


def test_agent_request_duplication_never_double_claims(faults):
    """JAX's test of the same name on the port: the ``duplicate`` kind
    sends the SAME pull twice over a real server (``RestApi.serve``) from
    ``RestCommunicator``. The second copy resolves to the same assignment
    (the CAS's resume path), never a second task: one ``TASK_DISPATCHED``."""
    from evergreen_tpu_torch.agent.rest_comm import RestCommunicator
    from evergreen_tpu_torch.api.rest import RestApi
    from evergreen_tpu_torch.globals import HostStatus, Provider, TaskStatus
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.models import task_queue as tq_mod
    from evergreen_tpu_torch.models.distro import Distro
    from evergreen_tpu_torch.models.host import Host
    from evergreen_tpu_torch.models.task_queue import TaskQueueItem
    from evergreen_tpu_torch.storage.store import Store

    # tools/bench_dispatch.py's seed(store, 0, 1), then JAX's two tasks
    store = Store()
    distro_mod.insert(store, Distro(id="d1", provider=Provider.MOCK.value))
    host_mod.insert_many(store, [Host(id="h0", distro_id="d1", provider=Provider.MOCK.value,
                                      status=HostStatus.RUNNING.value)])
    for tid in ("dup-t", "dup-u"):
        task_mod.insert(store, task_mod.Task(
            id=tid, distro_id="d1", status=TaskStatus.UNDISPATCHED.value,
            activated=True, project="p", build_variant="bv", version="v"))
    tq_mod.save(store, tq_mod.TaskQueue(
        distro_id="d1", generated_at=time.time(),
        queue=[TaskQueueItem(id=tid, display_name=tid, project="p", build_variant="bv",
                             version="v", dependencies=[], dependencies_met=True)
               for tid in ("dup-t", "dup-u")]))
    srv = RestApi(store).serve("127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    comm = RestCommunicator(f"http://127.0.0.1:{srv.server_address[1]}")
    plan = faults.install(faults.FaultPlan().at("agent.request", 0, faults.Fault("duplicate")))
    try:
        t = comm.next_task("h0")
    finally:
        faults.uninstall()
        srv.shutdown()
        srv.server_close()
    assert plan.fired == [("agent.request", 0, "duplicate")]
    assert t is not None and t.id == "dup-t"
    dispatched = store.collection("events").find(
        lambda d: d.get("event_type") == "TASK_DISPATCHED")
    assert len(dispatched) == 1, [d["resource_id"] for d in dispatched]
    assert host_mod.get(store, "h0").running_task == "dup-t"


# --------------------------------------------------------------------------- #
# socket adoption: refused and half-open
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["drop", "partition"])
def test_adopt_connect_refused(kind, faults):
    faults.install(faults.FaultPlan().at("sock.adopt", 0, faults.Fault(kind)))
    with pytest.raises(OSError, match="sock.adopt"):
        t_manifest.connect("/tmp/no-such-worker.sock")


def test_adopt_halfopen_socket_stays_silent(faults):
    faults.install(faults.FaultPlan().at("sock.adopt", 0, faults.Fault("half_open")))
    conn = t_manifest.connect("/tmp/no-such-worker.sock")
    faults.uninstall()
    try:
        conn.settimeout(0.2)
        conn.sendall(b'{"op":"adopt"}\n')
        with pytest.raises(socket.timeout):
            conn.recv(64)
    finally:
        conn.close()


def test_adopt_without_a_plan_reaches_the_socket():
    """No plan installed: the seam fires nothing and the connect is real
    (a missing socket is the adoption probe's OSError)."""
    with pytest.raises(OSError) as err:
        t_manifest.connect("/tmp/no-such-worker.sock", timeout_s=0.5)
    assert "sock.adopt" not in str(err.value)


# --------------------------------------------------------------------------- #
# the supervisor's transport seams, against the JAX package's
# --------------------------------------------------------------------------- #


class _Pipe(io.StringIO):
    """A worker's stdin that keeps what was written."""

    def close(self):  # the handle's teardown must not lose the record
        pass


def _sent(sup_mod, faults_mod, plan_of, shard, n=4):
    """What a handle of ``sup_mod`` writes for ``n`` commands under the
    plan ``plan_of(faults_mod)``, and what each ``send`` returned."""
    import json

    h = sup_mod.WorkerHandle(shard, hb_deadline_s=5.0)
    pipe = _Pipe()
    h.proc = types.SimpleNamespace(poll=lambda: None, stdin=pipe)
    faults_mod.install(plan_of(faults_mod))
    try:
        oks = [h.send(op="tick", req=i) for i in range(n)]
    finally:
        faults_mod.uninstall()
    return [json.loads(x)["req"] for x in pipe.getvalue().splitlines()], oks


def _received(sup_mod, faults_mod, plan_of, shard, n=4):
    """The messages a ``sup_mod`` reader hands on for ``n`` lines read
    from shard ``shard``, in order, under the plan."""
    import json

    got = []
    sup = types.SimpleNamespace(_handle_recv=lambda h, msg: got.append(msg["req"]))
    h = sup_mod.WorkerHandle(shard, hb_deadline_s=5.0)
    lines = [json.dumps({"op": "round", "req": i}) + "\n" for i in range(n)]
    faults_mod.install(plan_of(faults_mod))
    try:
        sup_mod.FleetSupervisor._reader(sup, h, lines)
    finally:
        faults_mod.uninstall()
    return got


PLANS = {
    "drop 1": lambda f, s: f.FaultPlan().at(s, 1, f.Fault("drop")),
    "partition always": lambda f, s: f.FaultPlan().always(s, f.Fault("partition")),
    "half_open 0": lambda f, s: f.FaultPlan().at(s, 0, f.Fault("half_open")),
    "reorder 1": lambda f, s: f.FaultPlan().at(s, 1, f.Fault("reorder")),
    "reorder 3": lambda f, s: f.FaultPlan().at(s, 3, f.Fault("reorder")),
    "duplicate 2": lambda f, s: f.FaultPlan().at(s, 2, f.Fault("duplicate")),
    "delay 0": lambda f, s: f.FaultPlan().at(s, 0, f.Fault("delay", delay_s=0.01)),
}

WANT_SENT = {
    "drop 1": [0, 2, 3], "partition always": [], "half_open 0": [1, 2, 3],
    "reorder 1": [0, 2, 1, 3], "reorder 3": [0, 1, 2], "duplicate 2": [0, 1, 2, 2, 3],
    "delay 0": [0, 1, 2, 3],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("seam", ["ipc.send", "ipc.send.{k}"])
def test_send_seam_matches_jax(plan, seam):
    """A command black-holed, swapped with the next, or sent twice; the
    shard-scoped seam touches only its shard. The sender sees success
    for a black-holed or held message."""
    make = PLANS[plan]
    for shard in (0, 1):
        def plan_of(f, s=seam.format(k=0)):
            return make(f, s)
        got = _sent(t_supervisor, t_faults, plan_of, shard)
        assert got == _sent(j_supervisor, j_faults, plan_of, shard), (plan, shard)
        scoped_elsewhere = "{k}" in seam and shard == 1
        assert got[0] == ([0, 1, 2, 3] if scoped_elsewhere else WANT_SENT[plan])
        assert got[1] == [True] * 4


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("seam", ["ipc.recv", "ipc.recv.{k}"])
def test_recv_seam_matches_jax(plan, seam):
    """A reply or heartbeat lost, swapped with its successor, or
    delivered twice (``wait_reply``'s request ids reject the copy)."""
    make = PLANS[plan]
    for shard in (0, 1):
        def plan_of(f, s=seam.format(k=0)):
            return make(f, s)
        got = _received(t_supervisor, t_faults, plan_of, shard)
        assert got == _received(j_supervisor, j_faults, plan_of, shard), (plan, shard)
        scoped_elsewhere = "{k}" in seam and shard == 1
        assert got == ([0, 1, 2, 3] if scoped_elsewhere else WANT_SENT[plan])


def test_send_fires_the_generic_seam_before_the_shards():
    """Both seams count a call per command: the generic one first, the
    shard's only when the generic one fired nothing."""
    plan = t_faults.FaultPlan().at("ipc.send", 0, t_faults.Fault("drop"))
    t_faults.install(plan)
    try:
        _sent_plan = _sent(t_supervisor, t_faults, lambda f: plan, 2, n=2)
    finally:
        t_faults.uninstall()
    assert _sent_plan == ([1], [True, True])
    assert plan._calls == {"ipc.send": 2, "ipc.send.2": 1}


def test_reordered_send_releases_with_the_next_command_only():
    """A held command goes out after the next one, from the sending
    thread: nothing leaves while no other command is sent."""
    h = t_supervisor.WorkerHandle(0, hb_deadline_s=5.0)
    pipe = _Pipe()
    h.proc = types.SimpleNamespace(poll=lambda: None, stdin=pipe)
    t_faults.install(t_faults.FaultPlan().at("ipc.send", 0, t_faults.Fault("reorder")))
    try:
        assert h.send(op="tick", req=1)
        assert pipe.getvalue() == "" and h._send_hold["req"] == 1
        done = threading.Event()
        threading.Thread(target=lambda: (h.send(op="tick", req=2), done.set())).start()
        assert done.wait(5.0)
    finally:
        t_faults.uninstall()
    assert [x.count('"req"') for x in pipe.getvalue().splitlines()] == [1, 1]
    assert h._send_hold is None


def test_supervisor_knobs_default_as_jax(tmp_path):
    """``tick_s``, ``round_timeout_s`` and ``worker_stderr`` are arguments
    with the JAX supervisor's defaults; a stderr mode other than
    ``"inherit"`` or ``"devnull"`` is refused."""
    import inspect

    t_params = inspect.signature(t_supervisor.FleetSupervisor).parameters
    j_params = inspect.signature(j_supervisor.FleetSupervisor).parameters
    for name in ("tick_s", "round_timeout_s", "worker_stderr", "orphan_tick_s"):
        assert t_params[name].default == j_params[name].default, name
    sup = t_supervisor.FleetSupervisor(str(tmp_path), 2, tick_s=2.5, round_timeout_s=4.0,
                                       worker_stderr="devnull", device="cpu")
    assert (sup.tick_s, sup.orphan_tick_s, sup.round_timeout_s) == (2.5, 2.5, 4.0)
    assert sup.worker_stderr == "devnull"
    with pytest.raises(ValueError, match="worker_stderr"):
        t_supervisor.FleetSupervisor(str(tmp_path), 2, worker_stderr="pipe", device="cpu")
