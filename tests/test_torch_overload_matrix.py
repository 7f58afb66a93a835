"""The port's overload matrix (``evergreen_tpu_torch/scenarios/overload_matrix.py``)
against the JAX package's (``tools/overload_matrix.py``, ``tests/test_overload.py``).

The two bespoke storms run on the port with ``device="cpu"`` and on JAX
(its tick under the ``x64`` alias) on the same seed: the same verdict
and the case fields that do not read the wall clock: the cap's bound
on ``max_pending``, the shed classes' counters, the 429 and its
``Retry-After``, the log messages the checks name. The two engine
delegates are the port's ``run_matrix_case`` of the same name. The tests
of ``tests/test_overload.py`` run on the port as they are (``port_twin``)
but the one that ticks, written out with ``device="cpu"``, and the
matrix's own, which the cases here hold.
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from evergreen_tpu_torch.scenarios import overload_matrix as t_om  # noqa: E402

from test_torch_resilience import (  # noqa: E402,F401
    jax_case_names,
    jax_module,
    messages,
    port_counters,
    port_store,
    run_module,
    run_port_twin,
)
from test_torch_scenarios import fresh, x64  # noqa: E402,F401


def run_pair(name, seed=0):
    j_om = jax_module("tools.overload_matrix")
    return j_om.run_case(name, seed), t_om.run_case(name, seed, device="cpu")


def test_task_churn_storm_gives_jax_s_verdict_and_bounds(x64, fresh):
    want, got = run_pair("task-churn-storm")
    assert want["ok"] and got["ok"], {k: v for k, v in got.items() if k != "logs"}
    # the cap's bound (the pending set's peak reads the workers' pace)
    assert want["max_pending"] <= 30 and got["max_pending"] <= 30
    assert want["evals_to_green"] <= t_om.RECOVERY_EVALS
    assert got["evals_to_green"] <= t_om.RECOVERY_EVALS
    assert want["shed"] > 0 and got["shed"] > 0
    assert got["counters"]["overload.jobs_shed"] == got["shed"]
    assert got["counters"]["overload.jobs_shed.agent"] == 0
    assert got["counters"]["overload.jobs_shed.planning"] == 0
    assert got["peaked"] is True
    # every planning tick on the device solve, each with its queues
    assert got["planners"] == ["tpu"] * 6
    assert len(got["queues"]) == 6 and all(
        q and all(ids for ids in q.values()) for q in got["queues"])
    # the messages the checks name, in both
    for m in ("job-shed", "overload-level", "runtime-stats"):
        assert messages(got["logs"])[m] > 0 and messages(want["logs"])[m] > 0, m
    assert messages(got["logs"])["runtime-stats"] == messages(want["logs"])["runtime-stats"]


def test_task_churn_storm_plans_jax_s_queues(x64, fresh):
    """Each planning tick of the storm persists the queues JAX's tick of
    the same store persists (the storm's ticks all plan one store at one
    ``now``)."""
    from evergreen_tpu.models import task_queue as j_tq
    from evergreen_tpu.scheduler.wrapper import run_tick as j_run_tick
    from evergreen_tpu.storage.store import Store as JStore
    from evergreen_tpu.utils.benchgen import NOW as J_NOW

    j_fm = jax_module("tools.fault_matrix")
    store = JStore()
    j_fm._seed_store(store, seed=31)
    res = j_run_tick(store, j_fm.OPTS, now=J_NOW)
    want = {did: j_tq.doc_column(store.collection(j_tq.COLLECTION).get(did), "id")
            for did in sorted(res.queues) if not did.endswith("::alias")}
    got = t_om.run_case("task-churn-storm", 0, device="cpu")
    assert got["queues"] == [want] * 6


def test_api_storm_gives_jax_s_verdict_and_fields(x64, fresh):
    want, got = run_pair("api-storm")
    assert want["ok"] and got["ok"], {k: v for k, v in got.items() if k != "logs"}
    for key in ("shed_status", "retry_after", "agent_status"):
        assert got[key] == want[key], key
    assert (got["shed_status"], got["retry_after"]) == (429, ["30"])
    assert got["evals_to_green"] <= t_om.RECOVERY_EVALS
    assert set(messages(got["logs"])) == set(messages(want["logs"]))


@pytest.mark.parametrize("name", t_om.ENGINE_CASES)
def test_engine_delegate_is_the_port_s_matrix_case(name, monkeypatch):
    from evergreen_tpu_torch.scenarios import matrix as t_matrix

    calls = []
    monkeypatch.setattr(t_matrix, "run_matrix_case",
                        lambda *a, **kw: calls.append((a, kw)) or {"ok": True})
    assert t_om.run_case(name, 2, device="cpu") == {"ok": True}
    assert calls == [(("overload", name, 2), {"device": "cpu"})]
    assert name in t_matrix.OVERLOAD_SCENARIO_CASES
    assert name in t_om.TICKING


def test_every_case_is_bespoke_or_a_delegate():
    assert sorted(("task-churn-storm", "api-storm") + t_om.ENGINE_CASES) == sorted(t_om.CASES)


def test_the_shared_fixture_is_the_fault_matrix_s():
    from evergreen_tpu_torch.scenarios import fault_matrix as t_fm

    assert t_om._seed_store is t_fm._seed_store
    assert t_om._capture_logs is t_fm._capture_logs


# --------------------------------------------------------------------------- #
# JAX's tests/test_overload.py on the port
# --------------------------------------------------------------------------- #

#: the matrix itself (the cases above) and the one that ticks, below
OVERLOAD_HELD = ("test_overload_matrix", "test_tick_sheds_stats_and_events_at_red")


@pytest.mark.parametrize("name", jax_case_names("test_overload", OVERLOAD_HELD))
def test_jax_overload_case_on_the_port(name, tmp_path, port_counters):
    run_port_twin("test_overload", name, tmp_path)


def test_tick_sheds_stats_and_events_at_red(port_counters):
    """JAX's test, its tick on the CPU: at RED the tick sheds stats and
    events, never planning, and records each shed."""
    from test_torch_resilience import port_twin

    from evergreen_tpu_torch.scenarios.fault_matrix import _seed_store
    from evergreen_tpu_torch.scheduler.wrapper import TickOptions, run_tick
    from evergreen_tpu_torch.utils import overload
    from evergreen_tpu_torch.utils.benchgen import NOW

    twin = port_twin("test_overload")
    store = port_store()
    _seed_store(store)
    twin._quiet_config(store)
    twin._force_level(store, overload.RED)
    res = run_tick(
        store,
        TickOptions(create_intent_hosts=True, underwater_unschedule=False),
        now=NOW, device="cpu",
    )
    assert res.overload == "red"
    assert "stats" in res.shed and "events" in res.shed
    # planning is never shed: queues persisted despite the brownout
    assert sum(res.queues.values()) > 0
    assert not store.collection("spans").find(lambda d: True)
    totals = overload.shed_totals(store)
    assert totals.get("tick:stats") == 1 and totals.get("tick:events") == 1


def test_main_runs_the_task_churn_storm_under_the_witness():
    rc, lines, err = run_module("evergreen_tpu_torch.scenarios.overload_matrix",
                                "--seeds", "1", "--case", "task-churn-storm",
                                "--device", "cpu")
    assert rc == 0, err
    ticks = json.loads(lines[0][len("TICKS "):])
    assert ticks["planners"] == ["tpu"] * 6 and ticks["device_ticks"] == 6
    assert ticks["launches"] == {} and ticks["problems"] == []
    case = json.loads(lines[1])
    assert case["case"] == "task-churn-storm" and case["ok"] is True
    assert case["max_pending"] <= 30
    assert [json.loads(x) for x in lines[2:]] == [
        {"lockcheck_inversions": 0}, {"overload_matrix_failures": 0}]
