"""The port's fault matrix (``evergreen_tpu_torch/scenarios/fault_matrix.py``)
against the JAX package's (``tools/fault_matrix.py``, ``tests/test_resilience.py``).

Each bespoke case runs on the port with ``device="cpu"`` and on JAX (its
tick under the ``x64`` alias) on the same seed: the same verdict, the
same log messages, the same injected faults and the case's own fields.
The seven engine delegates are the port's ``run_matrix_case`` of the same
name (``tests/test_torch_scenario_matrix.py`` runs those cases against
JAX's). The tests of ``tests/test_resilience.py`` run on the port as they
are (``port_twin``: the same source, the JAX package and its tools
pointed at the port) with the port's log counters fresh for each, but
the three that tick, which on the port take a device: they are written
out with ``device="cpu"``.

JAX's ``tools/fault_matrix.py`` switches the lock-order witness on at
import (``EVERGREEN_TPU_LOCKCHECK``); ``jax_module`` imports it, and the
JAX test modules that import it, with the variable as it was before.
"""
from __future__ import annotations

import collections
import contextlib
import importlib
import json
import os
import re
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from evergreen_tpu_torch.scenarios import fault_matrix as t_fm  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402
from evergreen_tpu_torch.utils import log as t_log  # noqa: E402

from test_torch_lockcheck import call_case  # noqa: E402
from test_torch_scenarios import fresh, x64  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCKCHECK_ENV = "EVERGREEN_TPU_LOCKCHECK"

#: the JAX tools a twin points at the port's harnesses
TOOL_SUBS = {
    "tools.fault_matrix": "evergreen_tpu_torch.scenarios.fault_matrix",
    "tools.overload_matrix": "evergreen_tpu_torch.scenarios.overload_matrix",
    "tools.disk_matrix": "evergreen_tpu_torch.scenarios.disk_matrix",
}


@contextlib.contextmanager
def witness_switch_kept():
    """``EVERGREEN_TPU_LOCKCHECK`` as it was before the block."""
    before = os.environ.get(LOCKCHECK_ENV)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(LOCKCHECK_ENV, None)
        else:
            os.environ[LOCKCHECK_ENV] = before


def jax_module(name):
    """A JAX tool or test module, imported without keeping the witness
    switch its ``tools.fault_matrix`` sets at import."""
    with witness_switch_kept():
        return importlib.import_module(name)


_TWINS = {}


def port_twin(modname):
    """The JAX test module ``modname`` on the port: the same source, its
    tools pointed at the port's harnesses and every ``evergreen_tpu``
    import at ``evergreen_tpu_torch``."""
    if modname not in _TWINS:
        jmod = jax_module(modname)
        with open(jmod.__file__, encoding="utf-8") as fh:
            src = fh.read()
        for jax_name, port_name in TOOL_SUBS.items():
            src = src.replace(jax_name, port_name)
        src = re.sub(r"\bevergreen_tpu\b", "evergreen_tpu_torch", src)
        tmod = types.ModuleType(f"{modname}_on_the_port")
        tmod.__file__ = jmod.__file__
        exec(compile(src, jmod.__file__, "exec"), tmod.__dict__)
        _TWINS[modname] = tmod
    return _TWINS[modname]


def jax_case_names(modname, held):
    import inspect

    jmod = jax_module(modname)
    return [n for n, f in vars(jmod).items()
            if n.startswith("test_") and inspect.isfunction(f) and n not in held]


def port_store():
    from evergreen_tpu_torch.storage.store import reset_global_store

    return reset_global_store()


@pytest.fixture
def port_counters(monkeypatch):
    """The port's log counters fresh for the test (JAX's own tests reset
    theirs), its fault plan uninstalled after it."""
    monkeypatch.setattr(t_log, "_counters", {})
    yield
    t_faults.uninstall()


def run_port_twin(modname, name, tmp_path):
    call_case(port_twin(modname), name, tmp_path, extra={"store": port_store})


def messages(logs):
    return collections.Counter(r.get("message") for r in logs)


@contextlib.contextmanager
def jax_plans():
    """Every fault plan JAX's harness installs, recorded."""
    from evergreen_tpu.utils import faults as j_faults

    plans, real = [], j_faults.install

    def install(plan):
        plans.append(plan)
        return real(plan)

    j_faults.install = install
    try:
        yield plans
    finally:
        j_faults.install = real


# --------------------------------------------------------------------------- #
# the bespoke cases against JAX's
# --------------------------------------------------------------------------- #

BESPOKE = ("wal-async-deferred", "lease-loss", "agent-comm", "provider-error",
           "sender-error", "job-quarantine")


def run_pair(name, seed=0):
    """JAX's case and the port's on ``seed``, with each run's installed
    plans' fired faults and calls, and each run's counter deltas."""
    from evergreen_tpu.utils import log as j_log

    j_fm = jax_module("tools.fault_matrix")
    j_before = j_log.counters_snapshot()
    with jax_plans() as plans:
        want = j_fm.run_case(name, seed)
    want["plans"] = [(p.fired, dict(p._calls)) for p in plans]
    want["deltas"] = {k: v - j_before.get(k, 0) for k, v in j_log.counters_snapshot().items()
                      if v != j_before.get(k, 0)}
    t_before = t_log.counters_snapshot()
    got = t_fm.run_case(name, seed, device="cpu")
    got["deltas"] = {k: v - t_before.get(k, 0) for k, v in t_log.counters_snapshot().items()
                     if v != t_before.get(k, 0)}
    return want, got


@pytest.mark.parametrize("name", BESPOKE)
def test_bespoke_case_gives_jax_s_verdict_and_fields(name, x64, fresh):
    want, got = run_pair(name)
    assert want["ok"] and got["ok"], {k: v for k, v in got.items() if k != "logs"}
    assert messages(got["logs"]) == messages(want["logs"])
    # one plan where the case injects a fault (the quarantine's is a job's)
    assert len(want["plans"]) == (name != "job-quarantine")
    fired, calls = want["plans"][0] if want["plans"] else ([], {})
    if "faults_fired" in got:
        assert got["faults_fired"] == [list(f) for f in fired][:len(got["faults_fired"])]
    if name == "agent-comm":
        assert got["calls"] == calls["agent.comm"] == 3
    if name == "sender-error":
        assert (got["attempts"], got["delivered"]) == (3, 1)
    if name == "provider-error":
        assert got["provision_attempts"] == 3
    if name == "lease-loss":
        assert got["fired"] is True
    if name == "wal-async-deferred":
        assert got["degraded"] == ["", "persist-failed", ""]
        assert got["planners"] == ["tpu"] * 3
        (rec,) = [r for r in got["logs"] if r.get("message") == "wal-group-commit-failed"]
        (jrec,) = [r for r in want["logs"] if r.get("message") == "wal-group-commit-failed"]
        assert {k: rec.get(k) for k in ("deferred", "error")} == {
            k: jrec.get(k) for k in ("deferred", "error")}
    # the counters each case's checks name, and every fault counter
    named = {k for k in set(want["deltas"]) | set(got["deltas"])
             if k.startswith(("faults.", "retry.", "lease.", "jobs.", "outbox.", "cloud."))}
    assert {k: got["deltas"].get(k, 0) for k in named} == {
        k: want["deltas"].get(k, 0) for k in named}


def test_wal_async_deferred_plans_jax_s_queues(x64, fresh):
    """The third tick's persisted queues, read from a cold reopen, are
    the ones JAX's same three ticks persist."""
    from evergreen_tpu.models import task_queue as j_tq
    from evergreen_tpu.scheduler.wrapper import run_tick as j_run_tick
    from evergreen_tpu.storage.durable import DurableStore as JDurable
    from evergreen_tpu.utils import faults as j_faults
    from evergreen_tpu.utils.benchgen import NOW as J_NOW
    import dataclasses
    import tempfile

    j_fm = jax_module("tools.fault_matrix")
    d = tempfile.mkdtemp(prefix="fault-walasync-jax-")
    store = JDurable(d)
    j_fm._seed_store(store, seed=29)
    opts = dataclasses.replace(j_fm.OPTS, async_persist=True)
    j_faults.install(j_faults.FaultPlan().at(
        "wal.commit", 0, j_faults.Fault("raise", OSError("disk full"))))
    try:
        j_run_tick(store, opts, now=J_NOW)
        j_run_tick(store, opts, now=J_NOW + 1)
    finally:
        j_faults.uninstall()
    res3 = j_run_tick(store, opts, now=J_NOW + 2)
    store.sync_persist()
    recovered = JDurable(d)
    want = {did: j_tq.doc_column(recovered.collection(j_tq.COLLECTION).get(did), "id")
            for did in sorted(res3.queues) if not did.endswith("::alias")}
    store.close()
    recovered.close()
    got = t_fm.run_case("wal-async-deferred", 0, device="cpu")
    assert got["queues"] == want


# --------------------------------------------------------------------------- #
# the engine delegates
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", t_fm.ENGINE_CASES)
def test_engine_delegate_is_the_port_s_matrix_case(name, monkeypatch):
    from evergreen_tpu_torch.scenarios import matrix as t_matrix

    calls = []
    monkeypatch.setattr(t_matrix, "run_matrix_case",
                        lambda *a, **kw: calls.append((a, kw)) or {"ok": True})
    assert t_fm.run_case(name, 5, device="cpu") == {"ok": True}
    assert calls == [(("fault", name, 5), {"device": "cpu"})]
    assert name in t_matrix.FAULT_SCENARIO_CASES
    assert name in t_fm.TICKING


def test_every_case_is_bespoke_or_a_delegate():
    assert sorted(BESPOKE + t_fm.ENGINE_CASES) == sorted(t_fm.CASES)
    assert t_fm.TICKING == set(t_fm.ENGINE_CASES) | {"wal-async-deferred"}


# --------------------------------------------------------------------------- #
# JAX's tests/test_resilience.py on the port
# --------------------------------------------------------------------------- #

#: the tests another port test holds: the matrix itself (the cases above,
#: the delegates in tests/test_torch_scenario_matrix.py) and the three
#: that tick, written out below with device="cpu"
RESILIENCE_HELD = (
    "test_fault_matrix",
    "test_breaker_fallback_parity_detail",
    "test_unbudgeted_tick_sheds_nothing",
    "test_runtime_stats_line_carries_degradation_fields",
)


@pytest.mark.parametrize("name", jax_case_names("test_resilience", RESILIENCE_HELD))
def test_jax_resilience_case_on_the_port(name, tmp_path, port_counters):
    run_port_twin("test_resilience", name, tmp_path)


def test_breaker_fallback_parity_detail(port_counters):
    """The degraded tick's persisted ordering equals the serial oracle's,
    distro by distro."""
    from evergreen_tpu_torch.models.task_queue import COLLECTION, doc_column
    from evergreen_tpu_torch.scheduler import serial
    from evergreen_tpu_torch.scheduler.wrapper import (
        TickOptions,
        gather_tick_inputs,
        run_tick,
    )
    from evergreen_tpu_torch.utils.benchgen import NOW

    store = port_store()
    t_fm._seed_store(store, n_distros=2, n_tasks=40, seed=3)
    t_faults.install(t_faults.FaultPlan().always("scheduler.solve", t_faults.Fault("raise")))
    res = run_tick(store, TickOptions(underwater_unschedule=False), now=NOW, device="cpu")
    t_faults.uninstall()
    assert res.planner_used == "serial" and res.degraded == "solve-failed"
    distros, tbd, *_ = gather_tick_inputs(store, NOW)
    for d in distros:
        want = [t.id for t in serial.plan_distro_queue(d, tbd.get(d.id, []), NOW)[0]]
        doc = store.collection(COLLECTION).get(d.id)
        assert doc is not None, d.id
        assert doc_column(doc, "id") == want, d.id


def test_unbudgeted_tick_sheds_nothing(port_counters):
    from evergreen_tpu_torch.scheduler.wrapper import TickOptions, run_tick
    from evergreen_tpu_torch.utils.benchgen import NOW

    store = port_store()
    t_fm._seed_store(store, n_distros=2, n_tasks=30, seed=5)
    res = run_tick(store, TickOptions(underwater_unschedule=False), now=NOW, device="cpu")
    assert res.shed == [] and res.degraded == ""
    assert res.planner_used == "tpu"
    # stats ran: the tick span landed
    assert store.collection("spans").find(lambda d: True)


def test_runtime_stats_line_carries_degradation_fields(port_counters):
    from evergreen_tpu_torch.scheduler.wrapper import TickOptions, run_tick
    from evergreen_tpu_torch.utils.benchgen import NOW

    got = []
    t_log.reset_sinks(got.append)
    store = port_store()
    t_fm._seed_store(store, n_distros=2, n_tasks=30, seed=6)
    t_faults.install(t_faults.FaultPlan().always("scheduler.solve", t_faults.Fault("raise")))
    run_tick(store, TickOptions(underwater_unschedule=False), now=NOW, device="cpu")
    t_faults.uninstall()
    t_log.reset_sinks()
    (stats,) = [r for r in got if r.get("message") == "runtime-stats"]
    assert stats["planner_used"] == "serial"
    assert stats["degraded"] == "solve-failed"
    assert any(r.get("message") == "degraded-tick" for r in got)


# --------------------------------------------------------------------------- #
# the harness's entry point and the witness
# --------------------------------------------------------------------------- #


def run_module(module, *args, timeout=300):
    """``python -m module args`` from the repository, with the witness
    variable unset (the module re-executes itself with it on)."""
    env = {k: v for k, v in os.environ.items() if k != LOCKCHECK_ENV}
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    return r.returncode, lines, r.stderr


def test_main_runs_a_ticking_case_under_the_witness():
    rc, lines, err = run_module("evergreen_tpu_torch.scenarios.fault_matrix",
                                "--seeds", "1", "--case", "wal-async-deferred",
                                "--device", "cpu")
    assert rc == 0, err
    ticks = json.loads(lines[0][len("TICKS "):])
    assert ticks["planners"] == ["tpu"] * 3 and ticks["device_ticks"] == 3
    assert ticks["degraded"] == ["", "persist-failed", ""]
    assert ticks["launches"] == {} and ticks["problems"] == []
    assert [json.loads(x) for x in lines[1:]] == [
        {"case": "wal-async-deferred", "seed": 0, "ok": True},
        {"lockcheck_inversions": 0}, {"fault_matrix_failures": 0}]


def test_main_needs_the_card_unless_told_the_cpu():
    """With no ``--device`` the harness asks for the card: here, where
    there is none, it fails before any case runs."""
    rc, lines, _ = run_module("evergreen_tpu_torch.scenarios.fault_matrix",
                              "--seeds", "1", "--case", "agent-comm")
    assert rc != 0
    assert not any('"ok": true' in ln for ln in lines)


def test_the_witness_is_on_only_under_python_m():
    """Importing the three harnesses leaves the witness switch alone; a
    module run sets it (in its re-executed self) and witnesses its
    locks."""
    code = ("import os; from evergreen_tpu_torch.scenarios import fault_matrix, "
            "disk_matrix, overload_matrix; "
            "print(os.environ.get('EVERGREEN_TPU_LOCKCHECK'))")
    env = {k: v for k, v in os.environ.items() if k != LOCKCHECK_ENV}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "None", r.stderr
    code = ("import runpy, sys; sys.argv = ['x', '--seeds', '0', '--device', 'cpu'];"
            "runpy.run_module('evergreen_tpu_torch.scenarios.fault_matrix', "
            "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    # the module re-executed itself as `python -m` with the witness on
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-2:] == ['{"lockcheck_inversions": 0}',
                                          '{"fault_matrix_failures": 0}']


def test_jax_tools_import_leaves_the_witness_switch_alone():
    with witness_switch_kept():
        os.environ.pop(LOCKCHECK_ENV, None)
        jax_module("tools.fault_matrix")
        jax_module("tools.overload_matrix")
        jax_module("tools.disk_matrix")
        assert LOCKCHECK_ENV not in os.environ
