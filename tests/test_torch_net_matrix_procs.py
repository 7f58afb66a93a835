"""The network-chaos matrix's fleet points on the port, on the CPU.

Each of the ten ``fleet2`` and ``leader2`` points of
``evergreen_tpu_torch/scenarios/net_matrix.py`` replays a two-shard fleet
of the port's worker processes (``device="cpu"``) under its transport
fault and must be ``ok`` with every invariant, check and SLO, its
replies planned by the device solve and each worker life's launches
those of its card solves (``proc_books``). Its converged canonical state
must equal the JAX package's uninterrupted reference fleet of the same
workload, which is also the rerun side of its ``resume_equals_rerun``.

The leader points' workload says ``"solver": "auto"``, which the port
elects as ``"always"`` (the one device stacks the round); JAX's leader
does not run on this CPU (its stacked program does not trace), so their
reference is JAX's fleet of the same workload under ``solver="never"``,
as ``tests/test_torch_procs_leader.py`` holds the leader weathers.

Two points run in tier-1: the one-way partition of ``fleet2`` and the
delayed solver return of ``leader2``, where the card's stacked solve is
the subject (one round degraded to local solves, the late result fenced,
a later round fully stacked). The other eight are marked ``slow``, only
because each replays real worker processes for half a minute or more;
``python -m evergreen_tpu_torch.scenarios.net_matrix --device cpu`` runs
them all. This file is apart from ``tests/test_torch_net_matrix.py`` so
that ``--dist loadfile`` puts it on another worker.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from evergreen_tpu.scenarios import procs as j_procs  # noqa: E402

from evergreen_tpu_torch.scenarios import net_matrix as t_nm  # noqa: E402
from evergreen_tpu_torch.scenarios import procs as t_procs  # noqa: E402

from test_torch_procs import failed, problem_key  # noqa: E402
from test_torch_resilience import jax_module  # noqa: E402

POINTS = {p: (c, args) for c in ("fleet2", "leader2") for p, args in t_nm.proc_points(c)}
TIER1 = ("fleet2:ipc.send.0:partition", "leader2:solver.return:delay")


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's uninterrupted reference fleet of a point's
    workload (``solver="never"`` for the leader's), once per workload."""
    refs = {}

    def reference(config, args):
        spec = jax_module("tools.net_matrix")._proc_net_spec(config, *args)
        key = problem_key(spec)
        if key not in refs:
            fleet = next(e for e in spec.events if e.kind == "proc_fleet")
            workload = dict(fleet.args)
            if workload.get("solver") == "auto":
                workload["solver"] = "never"
            refs[key] = j_procs._reference_canonical(dataclasses.replace(
                spec, events=[j_procs.Ev(0, "proc_fleet", workload)]))
        return refs[key]

    return reference


@pytest.mark.parametrize("point", [
    pytest.param(p, marks=() if p in TIER1 else pytest.mark.slow) for p in POINTS])
def test_fleet_point_is_ok_and_converges_to_the_jax_state(point, jax_reference):
    config, args = POINTS[point]
    spec = t_nm._proc_net_spec(config, *args)
    j_ref = jax_reference(config, args)
    run = t_procs.ProcScenarioRun(spec, device="cpu")
    run.reference_state = j_ref
    entry = run.execute()
    assert entry["ok"], failed(entry)
    assert set(entry["invariants"]) == set(t_procs.DEFAULT_PROC_INVARIANTS)
    assert sorted(entry["checks"]) == sorted(name for name, _ in spec.checks)
    assert run.reference_canonical == j_ref
    assert j_ref["tasks"] and all(s == ["success", 0] for s in j_ref["tasks"].values())
    books = t_nm.proc_books(run)
    assert books["problems"] == [] and books["planners"]
    assert all(b["launches"] == {} for b in books["lives"].values())
    st = entry["stats"]
    if config == "leader2":
        assert st.get("solver_stale_accepted", 0) == 0
    if point == "leader2:solver.return:delay":
        assert set(entry["checks"]) == {"stale-accepted-zero", "solver-engaged",
                                        "degrade-within-one-round"}
        assert st["solver_local_replies"] >= 1 and st["solver_stacked_replies"] >= 2
