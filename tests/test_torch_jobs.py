"""The job plane's queue and cron runner through the port against the JAX
package, on the CPU.

The same scenario runs once on each package's ``queue/jobs.py`` (with
that package's store, overload ladder and event log): scope locks,
dedupe by id and ``(priority, seq)`` dispatch under one worker; the
bounded pending set shedding the lowest class (``jobs_shed_total`` by
class); poison quarantine, its probe and its lifting; a failing job
recorded, not fatal; ``queue_pending`` moving the overload ladder, and
``units/crons.py::_defer_for_overload`` at YELLOW, RED and BLACK;
``CronRunner`` intervals and ``force``. Compared exactly: the put
outcomes, the run order, the counters' moves, and the ``jobs``,
``events`` and ``overload_sheds`` documents. The clock is pinned
(``time.time``) and event ids restart at 0 for each package. Masked: a
failed job's ``error`` (a traceback, whose file paths name each
package) is compared by its last line.

The port's departure is held on its own: a ``KernelError`` or
``MirrorError`` inside a job is recorded as the JAX package records a
failed job, re-raised from ``wait_idle`` and ``CronRunner.tick``, stops
the runner, and is never counted toward quarantine.
"""
import itertools
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.models import event as j_event  # noqa: E402
from evergreen_tpu.queue import jobs as j_jobs  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.units import crons as j_crons  # noqa: E402
from evergreen_tpu.utils import overload as j_overload  # noqa: E402

from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.models import event as t_event  # noqa: E402
from evergreen_tpu_torch.ops._build import KernelError  # noqa: E402
from evergreen_tpu_torch.ops.resident_ops import MirrorError  # noqa: E402
from evergreen_tpu_torch.queue import jobs as t_jobs  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.units import crons as t_crons  # noqa: E402
from evergreen_tpu_torch.utils import overload as t_overload  # noqa: E402

NOW = 1_700_000_000.0

PKGS = {
    "jax": dict(jobs=j_jobs, store=j_store, event=j_event, overload=j_overload,
                settings=j_settings, crons=j_crons),
    "port": dict(jobs=t_jobs, store=t_store, event=t_event, overload=t_overload,
                 settings=t_settings, crons=t_crons),
}


@pytest.fixture
def clock(monkeypatch):
    """A pinned ``time.time`` the test moves by hand; event ids restart."""
    now = [NOW]
    monkeypatch.setattr(time, "time", lambda: now[0])
    monkeypatch.setattr(j_event, "_SEQ", itertools.count())
    monkeypatch.setattr(t_event, "_SEQ", itertools.count())
    return now


def docs(store, names=("jobs", "events", "overload_sheds")):
    """The compared documents, a failed job's traceback by its last line."""
    out = {}
    for n in names:
        found = []
        for d in store.collection(n).find():
            d = dict(d)
            if n == "jobs" and d.get("error"):
                d["error"] = d["error"].strip().splitlines()[-1]
            if n == "events" and "error" in d.get("data", {}):
                d["data"] = dict(d["data"], error=d["data"]["error"].strip().splitlines()[-1])
            found.append(d)
        out[n] = found
    return out


class Gate:
    """A job body that blocks its worker until ``open()``."""

    def __init__(self):
        self.event = threading.Event()

    def __call__(self, store):
        assert self.event.wait(10.0)

    def open(self):
        self.event.set()


def both(scenario, clock):
    """Run ``scenario(pkg)`` on each package from the same clock reading;
    assert the results equal and return the port's."""
    got = {}
    for name, pkg in PKGS.items():
        clock[0] = NOW
        got[name] = scenario(pkg)
    assert got["port"] == got["jax"]
    return got["port"]


def test_scope_locks_dedupe_and_dispatch_order_match_jax(clock):
    def scenario(p):
        J = p["jobs"]
        store = p["store"].Store()
        q = J.JobQueue(store, workers=1)
        order = []
        gate = Gate()

        def job(jid, scopes, prio=None, jtype="fn"):
            return J.FnJob(jid, lambda s, jid=jid: order.append(jid), scopes=scopes,
                           job_type=jtype, priority=prio)

        outcomes = [repr(q.put(J.FnJob("gate", gate, scopes=["a"])))]
        for j in (job("stats-1", ["s"], J.PRIORITY_STATS),
                  job("recon-1", ["a"]),               # blocked by the gate's scope
                  job("recon-2", ["r"]),
                  job("plan-1", ["p"], J.PRIORITY_PLANNING),
                  job("agent-1", ["k"], J.PRIORITY_AGENT),
                  job("recon-2", ["r"]),               # duplicate id
                  job("plan-2", ["p"], J.PRIORITY_PLANNING)):
            outcomes.append(repr(q.put(j)))
        pending = q.pending_count()
        gate.open()
        assert q.wait_idle(10.0)
        q.close()
        closed = repr(q.put(job("late", [])))
        return dict(outcomes=outcomes, pending=pending, order=order, closed=closed,
                    docs=docs(store))

    got = both(scenario, clock)
    assert got["order"] == ["agent-1", "plan-1", "plan-2", "recon-1", "recon-2",
                            "stats-1"]
    assert "PutOutcome(False, 'duplicate')" in got["outcomes"]


def test_pending_cap_sheds_the_lowest_class_like_jax(clock):
    def scenario(p):
        J = p["jobs"]
        store = p["store"].Store()
        q = J.JobQueue(store, workers=1, max_pending=4)
        gate = Gate()
        shed0 = {c: J.JOBS_SHED.value(job_class=c) for c in J.PRIORITY_NAMES.values()}
        outcomes = [repr(q.put(J.FnJob("gate", gate)))]
        for jid, prio in (("stats-1", J.PRIORITY_STATS), ("recon-1", None),
                          ("stats-2", J.PRIORITY_STATS),
                          ("recon-2", None),          # full: evicts stats-2
                          ("plan-1", J.PRIORITY_PLANNING),  # evicts stats-1
                          ("agent-1", J.PRIORITY_AGENT),    # no victim left: over the cap
                          ("stats-3", J.PRIORITY_STATS)):   # full: shed itself
            outcomes.append(repr(q.put(J.FnJob(jid, lambda s: None, priority=prio))))
        gate.open()
        assert q.wait_idle(10.0)
        q.close()
        shed = {c: J.JOBS_SHED.value(job_class=c) - shed0[c]
                for c in J.PRIORITY_NAMES.values()}
        return dict(outcomes=outcomes, shed=shed, docs=docs(store))

    got = both(scenario, clock)
    assert got["shed"] == {"agent": 0, "planning": 0, "reconcile": 1, "stats": 3}


def test_poison_quarantine_probe_and_lift_like_jax(clock):
    def scenario(p):
        J = p["jobs"]
        store = p["store"].Store()
        q = J.JobQueue(store, workers=1, poison_threshold=2, quarantine_s=10.0)
        fail = {"on": True}
        q0 = J.JOBS_QUARANTINED.value()
        dropped0 = J.JOBS_QUARANTINE_DROPPED.value()

        def body(s):
            if fail["on"]:
                raise RuntimeError("flaky provider")

        def put(k):
            out = repr(q.put(J.FnJob(f"flaky-{k}", body, job_type="flaky")))
            assert q.wait_idle(10.0)
            return out

        steps = [put(0), put(1), put(2)]        # two failures arm the quarantine
        clock[0] += 11.0
        steps.append(put(3))                     # the probe, which fails: re-armed
        steps.append(put(4))                     # dropped
        clock[0] += 11.0
        fail["on"] = False
        steps.append(put(5))                     # the probe succeeds: lifted
        steps.append(put(6))
        ok = repr(q.put(J.FnJob("other", lambda s: None)))
        assert q.wait_idle(10.0)
        q.close()
        return dict(steps=steps, ok=ok, quarantined=J.JOBS_QUARANTINED.value() - q0,
                    dropped=J.JOBS_QUARANTINE_DROPPED.value() - dropped0,
                    docs=docs(store))

    got = both(scenario, clock)
    assert got["quarantined"] == 2 and got["dropped"] == 2
    statuses = [d["status"] for d in got["docs"]["jobs"]]
    assert statuses == ["failed", "failed", "quarantined", "failed", "quarantined",
                        "completed", "completed", "completed"]
    assert sum(e["event_type"] == "JOB_FAILED" for e in got["docs"]["events"]) == 3


def test_queue_pending_moves_the_ladder_like_jax(clock):
    def scenario(p):
        J, O = p["jobs"], p["overload"]
        store = p["store"].Store()
        p["settings"].OverloadConfig(queue_pending_levels=[2, 3, 4], eval_interval_s=0.0,
                                     hysteresis_ticks=1).set(store)
        q = J.JobQueue(store, workers=1, max_pending=0)
        gate = Gate()
        levels = []
        q.put(J.FnJob("gate", gate))
        for k in range(4):
            q.put(J.FnJob(f"w-{k}", lambda s: None, priority=J.PRIORITY_PLANNING))
            levels.append(O.monitor_for(store).level())
        gauge = O.monitor_for(store).gauges()["queue_pending"]
        gate.open()
        assert q.wait_idle(10.0)
        O.monitor_for(store).evaluate()
        after = O.monitor_for(store).level()
        O.monitor_for(store).refresh_gauges()
        q.close()
        return dict(levels=levels, gauge=gauge, after=after,
                    level_gauge=O.OVERLOAD_LEVEL.value(),
                    retry=[O.monitor_for(store).retry_after_s(lv) for lv in range(4)],
                    docs=docs(store))

    got = both(scenario, clock)
    assert got["levels"] == [1, 2, 3, 3] and got["after"] == 0


@pytest.mark.parametrize("level", ["yellow", "red", "black"])
def test_defer_for_overload_like_jax(level, clock):
    def scenario(p):
        O, C = p["overload"], p["crons"]
        store = p["store"].Store()
        O.monitor_for(store).set_floor({"yellow": O.YELLOW, "red": O.RED,
                                        "black": O.BLACK}[level])
        before = {n: C.CRON_DEFERRED.value(populator=n) for n in ("a", "b", "c")}
        out = [C._defer_for_overload(store, n, floor)
               for n, floor in (("a", O.YELLOW), ("b", O.RED), ("c", O.BLACK))]
        moved = {n: C.CRON_DEFERRED.value(populator=n) - v for n, v in before.items()}
        return dict(out=out, moved=moved)

    got = both(scenario, clock)
    n = {"yellow": 1, "red": 2, "black": 3}[level]
    assert got["out"] == [True] * n + [False] * (3 - n)


def test_cron_runner_intervals_and_force_like_jax(clock):
    def scenario(p):
        J = p["jobs"]
        store = p["store"].Store()
        q = J.JobQueue(store, workers=1)
        runner = J.CronRunner(store, q)
        calls = []

        def populator(name):
            def populate(s, now):
                calls.append((name, now))
                return [J.FnJob(f"{name}-{now:.3f}", lambda s_: None, scopes=[name],
                                job_type=name)]
            return populate

        runner.register(J.IntervalOperation("fast", 15.0, populator("fast")))
        runner.register(J.IntervalOperation("slow", 60.0, populator("slow")))
        admitted = []
        for now, force in ((NOW, False), (NOW + 10, False), (NOW + 15, False),
                           (NOW + 20, True), (NOW + 61, False), (NOW + 75, False)):
            admitted.append(runner.tick(now=now, force=force))
            assert q.wait_idle(10.0)
        q.close()
        return dict(calls=calls, admitted=admitted, docs=docs(store))

    got = both(scenario, clock)
    assert got["admitted"] == [2, 0, 1, 2, 1, 0]


@pytest.mark.parametrize("fault", [KernelError, MirrorError],
                         ids=["KernelError", "MirrorError"])
def test_card_fault_stops_the_plane_and_is_never_quarantined(fault, clock):
    """The departure: recorded as JAX records a failed job, re-raised,
    the runner stopped, no quarantine however often it would be hit."""
    store = t_store.Store()
    q = t_jobs.JobQueue(store, workers=1, poison_threshold=1)
    runner = t_jobs.CronRunner(store, q)
    err = fault("launch failed with cudaError_t 719")

    def tick_job(s):
        raise err

    runner.register(t_jobs.IntervalOperation(
        "scheduler-tick", 15.0,
        lambda s, now: [t_jobs.FnJob(f"scheduler-tick-{now:.3f}", tick_job,
                                     scopes=["scheduler-tick"], job_type="scheduler-tick",
                                     priority=t_jobs.PRIORITY_PLANNING)]))
    assert runner.tick(force=True) == 1
    with pytest.raises(fault) as raised:
        q.wait_idle(10.0)
    assert raised.value is err and q.fatal is err
    with pytest.raises(fault):
        runner.tick(force=True)
    assert len(store.collection("jobs")) == 1  # the stopped runner populated nothing
    assert repr(q.put(t_jobs.FnJob("x", lambda s: None))) == "PutOutcome(False, 'stopped')"
    assert not q._quarantined_until and not q._failures
    # the record and the event are what JAX writes for a failed job
    j = j_store.Store()
    jq = j_jobs.JobQueue(j, workers=1)
    jq.put(j_jobs.FnJob(f"scheduler-tick-{NOW:.3f}", tick_job, scopes=["scheduler-tick"],
                        job_type="scheduler-tick", priority=j_jobs.PRIORITY_PLANNING))
    assert jq.wait_idle(10.0)
    jq.close()
    q.close()
    assert docs(store) == docs(j)
    assert docs(store)["jobs"][0]["status"] == "failed"


def test_run_background_hands_a_card_fault_to_on_fatal(clock):
    store = t_store.Store()
    q = t_jobs.JobQueue(store, workers=1)
    runner = t_jobs.CronRunner(store, q)
    runner.register(t_jobs.IntervalOperation(
        "boom", 15.0,
        lambda s, now: [t_jobs.FnJob("boom", lambda s_: (_ for _ in ()).throw(
            KernelError("no kernel")), job_type="boom")]))
    got = []
    done = threading.Event()
    runner.run_background(poll_s=0.01,
                          on_fatal=lambda exc: (got.append(exc), done.set()))
    assert done.wait(10.0)
    runner.stop()
    q.close()
    assert isinstance(got[0], KernelError)
    assert not runner._thread.is_alive()
