"""The port's solver-leader weathers on the CPU.

The five ``SOLVER_SCENARIOS`` of ``scenarios/procs.py`` and the library's
``leader-death``: the supervisor, the solver leader, dies or stalls at a
solver seam of a live round. Each replays a two-shard fleet of the
port's worker processes on the CPU and must be ``ok``, with at least two
stacked replies. Their workload says ``"solver": "auto"``, which the
port's harness elects as ``"always"`` (the one device stacks the round),
where JAX's reaches its leader by forcing one host device per shard.

JAX's own leader weathers are no reference here: its stacked program
does not trace on this CPU (``ROADMAP.md``). So each weather's converged
canonical state is held to JAX's uninterrupted fleet of the same
workload under ``solver="never"``, which solves every round locally: the
port's stacked solves and the JAX package's local ones converge to one
state. The port's own uninterrupted fleet (stacked) is the rerun side of
``resume_equals_rerun``, run once.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu.scenarios import procs as j_procs  # noqa: E402

from evergreen_tpu_torch.scenarios import procs as t_procs  # noqa: E402
from evergreen_tpu_torch.scenarios.library import PROC_WEATHERS  # noqa: E402

WEATHERS = t_procs.SOLVER_SCENARIOS + ("leader-death",)


def spec_of(name):
    return (PROC_WEATHERS.get(name) or t_procs.PROC_SCENARIOS[name])()


@pytest.fixture(scope="module")
def references():
    """(JAX's uninterrupted ``_SOLVER_WORKLOAD`` fleet under
    ``solver="never"``, the port's uninterrupted fleet of the weathers'
    own workload on the CPU, stacked)."""
    spec = spec_of("proc-leader-kill-return")
    never = dataclasses.replace(
        j_procs.PROC_SCENARIOS["proc-leader-kill-return"](),
        events=[j_procs.Ev(0, "proc_fleet",
                           {**j_procs._SOLVER_WORKLOAD, "solver": "never"})],
    )
    j_ref = j_procs._reference_canonical(never)
    run = t_procs.ProcScenarioRun(
        dataclasses.replace(spec, name=f"{spec.name}-reference",
                            events=[e for e in spec.events if e.kind == "proc_fleet"],
                            checks=[], slos=[], invariants=("converged",)),
        with_reference=False, device="cpu")
    entry = run.execute()
    assert entry["ok"], entry["invariants"]
    stacked = entry["stats"].get("solver_stacked_replies", 0)
    return j_ref, run.reference_canonical, stacked


def test_the_stacked_reference_equals_the_local_jax_fleet(references):
    j_ref, t_ref, stacked = references
    assert t_ref == j_ref
    assert stacked >= 2, "the port's uninterrupted fleet never stacked"
    assert j_ref["tasks"] and all(s == ["success", 0] for s in j_ref["tasks"].values())


@pytest.mark.parametrize("name", WEATHERS)
def test_leader_weather_is_green_and_converges_to_the_jax_state(name, references):
    j_ref, t_ref, _ = references
    spec = spec_of(name)
    assert next(e for e in spec.events if e.kind == "proc_fleet").args == (
        j_procs._SOLVER_WORKLOAD)
    run = t_procs.ProcScenarioRun(spec, device="cpu")
    run.reference_state = t_ref
    entry = run.execute()
    bad = {f"{s}.{k}": v["detail"] for s in ("invariants", "checks", "slos")
           for k, v in entry[s].items() if not v["ok"]}
    assert entry["ok"], bad
    assert entry["stats"]["solver_stacked_replies"] >= 2
    assert entry["stats"]["solver_stale_accepted"] == 0
    assert entry["stats"]["shm_leaked"] == 0
    assert run.sup.solver_mode == "always"
    assert run.reference_canonical == j_ref
