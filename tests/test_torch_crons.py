"""The cron front end and the service's environment through the port
against the JAX package, on the CPU.

- every populator's job list (ids, scopes, types, priorities) under each
  kill switch, each overload level and a fenced store, equal to JAX's
  (``hourly_jobs`` without ``merge-queue-recovery``, which the port does
  not run yet), and the runner's registered populators and intervals:
  JAX's less ``generate-tasks``, ``activation``, ``repotracker`` and
  ``event-notifier``;
- a ``ShardingConfig`` edit between two populates reaching an attached
  ``ShardedScheduler`` (2 and 4 shards) as it reaches JAX's;
- the span exporter: the OTLP payload equal to ``_otlp_payload``'s, and
  the body each package pushes to a local HTTP sink on 127.0.0.1;
- ``Environment.build``: on a caller's store, and on copies of one
  seeded durable directory (the lease taken and released, the migration
  results, the recovery report and every document equal);
- the slice whole: a ``benchgen`` problem of mock, docker and ec2-fleet
  distros with tight ``maximum_hosts`` in each package's environment
  (one worker), four cron rounds with an agent pass between rounds,
  every document equal after each round and each pass;
- the device: the job plane's entry points run on the card unless given
  ``device="cpu"``, and raise without one.

Each package runs on the same pinned clock, its own seeded uuid4 stream
(the same seed), its event sequence from 0 and its providers reset.
Masked, as ``chip_smoke.py::canon_span`` masks them: span ids, parents,
trace roots, start times, durations, threads and the time attributes;
and a system-stats sample's process readings (``max_rss_kb``,
``cpu_user_s``), a runtime-stats log record's wall times
(``snapshot_ms``, ``solve_ms``, ``total_ms``) and an overload record's
gauges, all read off this process as each package ran.
"""
import copy
import functools
import http.server
import itertools
import json
import os
import random
import shutil
import threading
import time
import uuid

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu import env as j_env  # noqa: E402
from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.models import event as j_event  # noqa: E402
from evergreen_tpu.queue import jobs as j_jobs  # noqa: E402
from evergreen_tpu.scheduler import sharded_plane as j_plane  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.units import crons as j_crons  # noqa: E402
from evergreen_tpu.utils import benchgen as j_benchgen  # noqa: E402
from evergreen_tpu.utils import log as j_log  # noqa: E402
from evergreen_tpu.utils import overload as j_overload  # noqa: E402
from evergreen_tpu.utils import tracing as j_tracing  # noqa: E402

from evergreen_tpu_torch import env as t_env  # noqa: E402
from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.models import event as t_event  # noqa: E402
from evergreen_tpu_torch.queue import jobs as t_jobs  # noqa: E402
from evergreen_tpu_torch.scheduler import sharded_plane as t_plane  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.storage.durable import DurableStore  # noqa: E402
from evergreen_tpu_torch.storage.lease import FileLease  # noqa: E402
from evergreen_tpu_torch.units import crons as t_crons  # noqa: E402
from evergreen_tpu_torch.utils import log as t_log  # noqa: E402
from evergreen_tpu_torch.utils import overload as t_overload  # noqa: E402
from evergreen_tpu_torch.utils import tracing as t_tracing  # noqa: E402

from test_torch_dispatch import agent_pass  # noqa: E402
from test_torch_provisioning import PKG as CLOUD  # noqa: E402
from test_torch_provisioning import reset_cloud  # noqa: E402
from test_torch_solve import x64  # noqa: E402,F401

NOW = 1_700_000_000.0
#: the JAX runner's populators the port does not register yet
WAITING = ("generate-tasks", "activation", "repotracker", "event-notifier")
WAITING_JOBS = ("merge-queue-recovery",)
SPAN_MASK = ("_id", "parent", "trace_root", "started_at", "duration_ms", "thread")
SPAN_TIME_ATTRS = ("snapshot_ms", "solve_ms", "total_ms")
MASKS = {"system_stats": ("max_rss_kb", "cpu_user_s"),
         "log_lines": SPAN_TIME_ATTRS + ("gauges",)}

PKGS = {
    "jax": dict(name="jax", crons=j_crons, jobs=j_jobs, store=j_store, env=j_env,
                settings=j_settings, overload=j_overload, event=j_event, log=j_log,
                plane=j_plane, tracing=j_tracing),
    "port": dict(name="port", crons=t_crons, jobs=t_jobs, store=t_store, env=t_env,
                 settings=t_settings, overload=t_overload, event=t_event, log=t_log,
                 plane=t_plane, tracing=t_tracing),
}


def canon(name, doc):
    if name == "spans":
        attrs = {k: v for k, v in doc["attributes"].items() if k not in SPAN_TIME_ATTRS}
        return dict({k: v for k, v in doc.items() if k not in SPAN_MASK}, attributes=attrs)
    drop = MASKS.get(name, ())
    return {k: v for k, v in doc.items() if k not in drop}


def all_docs(store):
    """Every non-empty collection of ``store``, masked, as JSON (a store
    replayed from disk holds queue rows as lists, a live one as tuples)."""
    names = sorted(n for n in store._collections if len(store.collection(n)))
    return {n: json.loads(json.dumps([canon(n, d) for d in store.collection(n).find()],
                                     default=str)) for n in names}


def assert_same_docs(got, want, label=""):
    assert sorted(got) == sorted(want), label
    for n in want:
        assert len(got[n]) == len(want[n]), (label, n)
        for g, w in zip(got[n], want[n]):
            assert g == w, (label, n, w.get("_id"))


@pytest.fixture
def pinned(monkeypatch):
    """A pinned clock; ``enter(name)`` installs that package's uuid4 stream
    (one per package, the same seed; ``reseed`` starts it again)."""
    clock = [NOW]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    monkeypatch.setattr(j_event, "_SEQ", itertools.count())
    monkeypatch.setattr(t_event, "_SEQ", itertools.count())
    rngs = {}

    def enter(name, reseed=False):
        if reseed or name not in rngs:
            rngs[name] = random.Random(424242)
        rng = rngs[name]
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128)))

    for m in CLOUD.values():
        reset_cloud(m)
    # a durable build installs its store as the process's global store
    monkeypatch.setattr(j_store, "_GLOBAL_STORE", j_store._GLOBAL_STORE)
    monkeypatch.setattr(t_store, "_GLOBAL_STORE", t_store._GLOBAL_STORE)
    sinks = (list(j_log._sinks), list(t_log._sinks))
    yield clock, enter
    # and wires the process's log sinks: put them back
    j_log.reset_sinks(*sinks[0])
    t_log.reset_sinks(*sinks[1])
    for m in CLOUD.values():
        reset_cloud(m)


# --------------------------------------------------------------------------- #
# the populators
# --------------------------------------------------------------------------- #

POPULATORS = ("scheduler_tick_jobs", "host_creation_jobs", "host_monitoring_jobs",
              "task_monitoring_jobs", "stats_jobs", "hourly_jobs")
FLAGS = ("scheduler_disabled", "host_allocator_disabled", "host_init_disabled",
         "monitor_disabled", "background_stats_disabled", "cache_stats_job_disabled")
SCENARIOS = (["default"] + [f"flag:{f}" for f in FLAGS]
             + ["flag:scheduler_disabled+host_allocator_disabled"]
             + [f"level:{lv}" for lv in ("yellow", "red", "black")] + ["fenced"])


def job_list(p, scenario):
    S = p["store"].Store
    store = type("FencedStore", (S,), {"fenced": True})() if scenario == "fenced" else S()
    if scenario.startswith("flag:"):
        p["settings"].ServiceFlags(**{f: True for f in scenario[5:].split("+")}).set(store)
    if scenario.startswith("level:"):
        O = p["overload"]
        O.monitor_for(store).set_floor({"yellow": O.YELLOW, "red": O.RED,
                                        "black": O.BLACK}[scenario[6:]])
    out = {}
    for name in POPULATORS:
        fn = getattr(p["crons"], name)
        if p["name"] == "port" and name == "scheduler_tick_jobs":
            fn = functools.partial(fn, device="cpu")
        out[name] = [(j.job_id, j.scopes, j.job_type, j.priority) for j in fn(store, NOW)
                     if j.job_type not in WAITING_JOBS]
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_populator_job_lists_match_jax(scenario):
    got = {name: job_list(p, scenario) for name, p in PKGS.items()}
    assert got["port"] == got["jax"]
    if scenario == "default":
        assert sum(len(v) for v in got["port"].values()) == 16


def test_runner_registers_jax_populators_at_jax_intervals():
    j_q = j_jobs.JobQueue(j_store.Store(), workers=1)
    t_q = t_jobs.JobQueue(t_store.Store(), workers=1)
    try:
        j_ops = [(op.name, op.interval_s) for op in
                 j_crons.build_cron_runner(j_q.store, j_q).ops if op.name not in WAITING]
        t_ops = [(op.name, op.interval_s) for op in
                 t_crons.build_cron_runner(t_q.store, t_q, device="cpu").ops]
    finally:
        j_q.close()
        t_q.close()
    assert t_ops == j_ops
    assert t_crons.service_tick_options() == t_crons.TickOptions(
        create_intent_hosts=True, use_cache=True, solve_deadline_s=10.0,
        tick_budget_s=12.0, async_persist=True)


def test_the_job_plane_runs_on_the_card_unless_asked_for_the_cpu():
    store = t_store.Store()
    q = t_jobs.JobQueue(store, workers=1)
    try:
        if torch.cuda.is_available():
            assert t_crons.scheduler_tick_jobs(store, NOW)
            return
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_crons.scheduler_tick_jobs(store, NOW)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_crons.build_cron_runner(store, q)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_env.Environment.build(store=t_store.Store(), workers=1)
        with pytest.raises(ValueError, match="replica"):
            t_env.Environment.build(replica_of="http://127.0.0.1:1", device="cpu")
    finally:
        q.close()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharding_config_edit_reaches_an_attached_plane(n_shards):
    knobs = ("stacked", "rebalance_enabled", "max_handoffs_per_round", "barrier_timeout_s")
    got = {}
    for name, p in PKGS.items():
        kw = dict(device="cpu") if name == "port" else {}
        plane = p["plane"].ShardedScheduler.build(n_shards, **kw)
        front = p["store"].Store()
        p["plane"].attach_sharded_plane(front, plane)
        seen = []
        try:
            for cfg in (dict(stacked_solve="never", rebalance_enabled=False,
                             max_handoffs_per_round=3, barrier_timeout_s=5.0),
                        dict(stacked_solve="always", rebalance_enabled=True,
                             max_handoffs_per_round=2, barrier_timeout_s=7.5)):
                p["settings"].ShardingConfig(n_shards=n_shards, **cfg).set(front)
                fn = p["crons"].scheduler_tick_jobs
                if name == "port":
                    fn = functools.partial(fn, device="cpu")
                jobs = fn(front, NOW)
                seen.append(([(j.job_id, j.scopes, j.job_type, j.priority) for j in jobs],
                             [getattr(plane, k) for k in knobs]))
            if name == "port":
                # the job runs one fleet round of the plane
                rounds0 = t_plane.SHARD_ROUNDS.total()
                jobs[0].run(front)
                assert t_plane.SHARD_ROUNDS.total() == rounds0 + 1
        finally:
            plane.close()
        got[name] = seen
    assert got["port"] == got["jax"]
    assert got["port"][1][1] == ["always", True, 2, 7.5]


# --------------------------------------------------------------------------- #
# the span exporter
# --------------------------------------------------------------------------- #


def span_docs():
    out = []
    for k in range(6):
        root = f"span-{k - k % 3}"
        out.append({"_id": f"span-{k}", "name": f"op{k}", "component": ("scheduler", "amboy")[k % 2],
                    "parent": "" if k % 3 == 0 else root, "trace_root": root,
                    "started_at": NOW + k, "duration_ms": 1.5 * k, "thread": "t",
                    "attributes": {"k": k, "tag": f"x{k}"}})
    return out


class Sink(http.server.BaseHTTPRequestHandler):
    bodies = []

    def do_POST(self):  # noqa: N802 — the handler's name
        n = int(self.headers["Content-Length"])
        Sink.bodies.append((self.path, json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_span_export_matches_jax(ratio):
    assert t_tracing._otlp_payload(span_docs()) == j_tracing._otlp_payload(span_docs())
    assert t_tracing._stable_id("span-3", 16) == j_tracing._stable_id("span-3", 16)
    server = http.server.HTTPServer(("127.0.0.1", 0), Sink)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    got = {}
    try:
        for name, p in PKGS.items():
            Sink.bodies = []
            store = p["store"].Store()
            store.collection("spans").insert_many(span_docs())
            skipped = p["tracing"].export_spans(store)  # tracer section off
            p["settings"].TracerConfig(enabled=True, collector_endpoint=url,
                                       sample_ratio=ratio).set(store)
            n = p["tracing"].export_spans(store)
            got[name] = (skipped, n, list(Sink.bodies), store.collection("spans").find(),
                         [r["root"] for r in p["tracing"].recent_traces(store)])
    finally:
        server.shutdown()
        server.server_close()
    assert got["port"] == got["jax"]
    assert got["port"][2][0][0] == "/v1/traces" and not got["port"][3]


# --------------------------------------------------------------------------- #
# Environment.build
# --------------------------------------------------------------------------- #


def test_environment_on_a_callers_store_matches_jax(pinned):
    clock, enter = pinned
    got = {}
    for name, p in PKGS.items():
        enter(name)
        store = p["store"].Store()
        store.collection("hosts").insert({"_id": "h0", "status": "running"})
        kw = dict(device="cpu") if name == "port" else {}
        env = p["env"].Environment.build(store=store, workers=3, **kw)
        try:
            got[name] = dict(
                docs=all_docs(store), workers=env.queue._workers,
                ops=[(op.name, op.interval_s) for op in env.cron_runner.ops
                     if op.name not in WAITING],
                lease=env.lease, report=env.recovery_report,
                settings=env.settings(p["settings"].AmboyConfig).pool_size_local,
                tracer=env.tracer("x").component,
                tick_cache=env.tick_cache is not None)
        finally:
            env.close()
    assert got["port"] == got["jax"]
    # JAX's accessor hands get_transport a second argument it does not
    # take; the port's resolves the store's transport
    env = t_env.Environment.build(store=t_store.Store(), workers=1, device="cpu")
    try:
        assert type(env.host_transport()).__name__ == "LocalTransport"
    finally:
        env.close()


def seed_durable(root) -> str:
    """A durable directory of a small benchgen problem at epoch 0, whose
    recovery pass has claims to release, tasks to reset and hosts to
    terminate."""
    seed = os.path.join(root, "seed")
    distros, tbd, hbd, _, _ = j_benchgen.generate_problem(4, 200, seed=3, hosts_per_distro=3)
    s = DurableStore(seed)
    s.begin_tick()
    for d in distros:
        s.collection("distros").insert(d.to_doc())
    s.collection("tasks").insert_many([t.to_doc() for ts in tbd.values() for t in ts])
    s.collection("hosts").insert_many([h.to_doc() for hs in hbd.values() for h in hs])
    s.collection("hosts").update(hbd[distros[0].id][0].id, {"status": "building",
                                                            "external_id": ""})
    s.collection("tasks").update(tbd[distros[1].id][0].id, {
        "status": "started", "host_id": "gone", "dispatch_time": NOW - 60.0})
    s.end_tick()
    s.close()
    return seed


def test_environment_on_a_durable_directory_matches_jax(pinned, tmp_path):
    clock, enter = pinned
    seed = seed_durable(str(tmp_path))
    got = {}
    for name, p in PKGS.items():
        d = str(tmp_path / name)
        shutil.copytree(seed, d)
        enter(name)
        kw = dict(device="cpu") if name == "port" else {}
        env = p["env"].Environment.build(data_dir=d, workers=1, **kw)
        try:
            held = FileLease(os.path.join(d, "writer.lease"))
            assert not held.try_acquire()  # the writer holds it
            got[name] = dict(docs=all_docs(env.store), epoch=env.store.epoch,
                             report=env.recovery_report.to_doc(),
                             migrations=[d_["_id"] for d_ in
                                         env.store.collection("migrations").find()])
            if name == "port":
                got[name]["results"] = env.migrations
                assert [type(s).__name__ for s in t_log._sinks] == ["function", "StoreSink"]
        finally:
            env.close()
        free = FileLease(os.path.join(d, "writer.lease"))
        assert free.try_acquire()  # released on close
        free.release()
    results = got["port"].pop("results")
    assert results == [(n, "applied") for n in got["jax"]["migrations"]]
    assert got["port"] == got["jax"]
    report = got["port"]["report"]
    assert report["released_claims"] and report["reconciled_tasks"]
    assert report["hosts_terminated"]


# --------------------------------------------------------------------------- #
# the slice whole
# --------------------------------------------------------------------------- #

ROUNDS = 4


def slice_docs():
    distros, tbd, hbd, _, _ = j_benchgen.generate_problem(
        6, 300, seed=0, hosts_per_distro=2, provider_mix=("mock", "docker", "ec2-fleet"))
    docs = {"distros": [d.to_doc() for d in distros],
            "tasks": [t.to_doc() for ts in tbd.values() for t in ts],
            "hosts": [h.to_doc() for hs in hbd.values() for h in hs]}
    for d in docs["distros"]:
        d["host_allocator_settings"]["maximum_hosts"] = 6
    return docs


def test_cron_rounds_match_jax(pinned, x64):
    """The slice whole: each package's environment on the same documents,
    four cron rounds (``tick(force=True)``, ``wait_idle``) with an agent
    pass between rounds, every document equal after each."""
    clock, enter = pinned
    docs = slice_docs()
    # the JAX side's solve is compiled before its first tick job, whose
    # solve deadline must not meet JAX's compile time
    warm = j_store.Store()
    for coll, ds in docs.items():
        warm.collection(coll).insert_many(copy.deepcopy(ds))
    from evergreen_tpu.scheduler.wrapper import TickOptions, run_tick

    run_tick(warm, TickOptions(), now=NOW)
    j_event._SEQ = itertools.count()  # the warm tick's events drew from it
    sides = {}
    for name, p in PKGS.items():
        store = p["store"].Store()
        for coll, ds in docs.items():
            store.collection(coll).insert_many(copy.deepcopy(ds))
        enter(name)
        kw = dict(device="cpu") if name == "port" else {}
        env = p["env"].Environment.build(store=store, workers=1, **kw)
        if name == "jax":
            runner = env.cron_runner
            runner.ops = [op for op in runner.ops if op.name not in WAITING]
            for op in runner.ops:
                if op.name == "hourly":
                    op.populate = functools.partial(
                        lambda real, s, now: [j for j in real(s, now)
                                              if j.job_type not in WAITING_JOBS],
                        op.populate)
        sides[name] = env
    try:
        for r in range(ROUNDS):
            clock[0] = NOW + 15.0 * r
            state = {}
            for name, env in sides.items():
                # the streams start at the first round: JAX's build draws
                # ids for its REST surface
                enter(name, reseed=not r)
                env.cron_runner.tick(force=True)
                assert env.queue.wait_idle(60.0)
                state[name] = all_docs(env.store)
            assert_same_docs(state["port"], state["jax"], f"round {r + 1}")
            jobs = state["port"]["jobs"]
            assert jobs and {j["status"] for j in jobs} == {"completed"}
            if r + 1 < ROUNDS:
                pairs = {}
                for name, env in sides.items():
                    side = type("Side", (), {"name": name, "store": env.store})
                    pairs[name] = agent_pass(side, clock[0])
                assert pairs["port"] == pairs["jax"]
                assert_same_docs(all_docs(sides["port"].store), all_docs(sides["jax"].store),
                                 f"agent pass {r + 1}")
        hosts = state["port"]["hosts"]
        assert {h["provider"] for h in hosts if h["status"] == "running"} >= {"mock",
                                                                              "ec2-fleet"}
        assert any(h["status"] == "initializing" for h in hosts)  # docker: no pool
    finally:
        for env in sides.values():
            env.close()
