"""The port's process backend of the scenario engine against the JAX
package's, on the CPU.

Each weather below replays a supervised fleet of the port's shard worker
processes (``device="cpu"``: ``--device cpu`` workers) and must be ``ok``
with every invariant, check and SLO green. Its converged canonical state
(the merged fleet's task states and queues) must equal the JAX package's
uninterrupted reference fleet for the same workload; the port's own
uninterrupted fleet, the rerun side of ``resume_equals_rerun``, runs once
per workload and is held to the same JAX reference. Then the crash
matrix's ``wal.commit`` kill point against ``proc_reference_state``, the
crash-matrix capture round trip of JAX's ``tests/test_trace_capture.py``,
and a worker that dies of a card fault (``EXIT_KERNEL``).

Shared-memory segment and control-socket names derive from each run's
temporary data directory, so xdist workers never collide.
"""
from __future__ import annotations

import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu.scenarios import procs as j_procs  # noqa: E402

from evergreen_tpu_torch.runtime.supervisor import FleetSupervisor  # noqa: E402
from evergreen_tpu_torch.scenarios import procs as t_procs  # noqa: E402

#: the four weathers on the plain two-shard workload, and the one-way
#: partition (the same problem, with faster round and silence deadlines)
WEATHERS = ("proc-fleet-sigkill", "proc-fleet-hang", "proc-sup-kill-midround",
            "proc-sup-kill-midhandoff", "proc-net-oneway-partition")


def problem_key(spec) -> str:
    """The seeded problem of a proc spec's workload (its timing knobs
    change no converged state)."""
    w = next(e.args for e in spec.events if e.kind == "proc_fleet")
    keep = ("shards", "distros", "tasks", "seed", "hosts_per_distro", "dep_fraction")
    return json.dumps({k: w[k] for k in keep if k in w}, sort_keys=True)


def failed(entry) -> dict:
    return {f"{sec}.{k}": v["detail"] for sec in ("invariants", "checks", "slos")
            for k, v in entry[sec].items() if not v["ok"]}


@pytest.fixture(scope="module")
def references():
    """Per seeded problem: (the JAX package's uninterrupted reference
    fleet's canonical state, the port's on the CPU)."""
    out = {}
    for name in WEATHERS:
        spec = t_procs.PROC_SCENARIOS[name]()
        key = problem_key(spec)
        if key not in out:
            j_spec = j_procs.PROC_SCENARIOS[name]()
            out[key] = (j_procs._reference_canonical(j_spec),
                        t_procs._reference_canonical(spec, device="cpu"))
    return out


def test_the_uninterrupted_fleets_converge_to_the_jax_state(references):
    for key, (j_ref, t_ref) in references.items():
        assert t_ref == j_ref, key
        assert j_ref["tasks"] and all(s == ["success", 0] for s in j_ref["tasks"].values())


@pytest.mark.parametrize("name", WEATHERS)
def test_proc_weather_is_green_and_converges_to_the_jax_state(name, references):
    spec = t_procs.PROC_SCENARIOS[name]()
    j_ref, t_ref = references[problem_key(spec)]
    run = t_procs.ProcScenarioRun(spec, device="cpu")
    run.reference_state = t_ref  # the rerun side, run once per workload
    entry = run.execute()
    assert entry["ok"], failed(entry)
    assert entry["backend"] == "procs" and not entry["deterministic"]
    assert set(entry["invariants"]) == set(t_procs.DEFAULT_PROC_INVARIANTS)
    assert all(v["ok"] for v in entry["checks"].values()) and entry["checks"]
    assert run.reference_canonical == j_ref
    assert entry["stats"]["unfinished_final"] == 0
    assert not os.path.exists(run.data_dir)


def test_run_proc_scenario_replays_with_its_own_reference():
    """The public entry point: the reference fleet runs inside it, on the
    same device, at the spec's effective seed."""
    spec = t_procs.PROC_SCENARIOS["proc-fleet-sigkill"]()
    entry = t_procs.run_proc_scenario(spec, seed=11, device="cpu")
    assert entry["ok"], failed(entry)
    assert entry["seed"] == 11
    assert entry["stats"]["crash_exits"] >= 1 and entry["stats"]["max_epoch"] == 2
    assert entry["invariants"]["resume_equals_rerun"] == {"ok": True, "detail": ""}


def test_crash_point_matches_the_jax_reference():
    ref = t_procs.proc_reference_state(device="cpu")
    assert ref == j_procs.proc_reference_state()
    res = t_procs.run_crash_point("wal.commit", 1, reference=ref, device="cpu")
    assert res["ok"], res["problems"]
    assert res["point"] == "wal.commit@1" and res["crashed"] and res["parity_ok"]
    assert res["epochs"] == [1, 2]
    assert res["entry"]["invariants"]["resume_equals_rerun"]["ok"]


def test_crash_matrix_capture_round_trip():
    """JAX's ``test_trace_capture.py::test_crash_matrix_capture_round_trip``
    on the port: capture a supervised-fleet run that took a real SIGKILL
    at a WAL seam, distill its data dir into a spec, and replay it in
    process: green and deterministic, with the fleet's tasks."""
    import shutil

    from evergreen_tpu_torch.cloud.mock import MockCloudManager
    from evergreen_tpu_torch.scenarios import run_scenario, trace
    from evergreen_tpu_torch.scenarios.spec import scorecard_entry_fingerprint

    spec = t_procs._crash_point_spec("wal.commit", 1, ticks=9)
    run = t_procs.ProcScenarioRun(spec, with_reference=False, keep_data_dir=True,
                                  device="cpu")
    orig_build = run._build_supervisor

    def build_with_crash():
        sup = orig_build()
        sup.spawn_crash = {0: "wal.commit@1"}
        return sup

    run._build_supervisor = build_with_crash
    entry = run.execute()
    assert entry["stats"].get("crash_exits", 0) >= 1, "kill never fired"
    try:
        captured = trace.capture_data_dir(run.data_dir, name="cap-crash")
        MockCloudManager.reset()
        a = run_scenario(captured, device="cpu")
        MockCloudManager.reset()
        b = run_scenario(captured, device="cpu")
        assert a["ok"], failed(a)
        assert scorecard_entry_fingerprint(a) == scorecard_entry_fingerprint(b)
        n_tasks = sum(1 for ev in captured.events if ev.kind == "dag"
                      for _ in ev.args.get("nodes", []))
        assert n_tasks >= 1
    finally:
        shutil.rmtree(run.data_dir, ignore_errors=True)
        MockCloudManager.reset()


def test_a_worker_card_fault_raises_out_of_execute(monkeypatch):
    """Shard 0's first worker dies of a card fault in its first tick (its
    solve raises ``KernelError``, so it exits ``EXIT_KERNEL``): that is
    no weather's finding, so ``execute`` raises ``WorkerExitError`` once
    the fleet is down, and the data directory is gone."""
    from evergreen_tpu_torch.runtime.protocol import EXIT_KERNEL

    real_cmd = FleetSupervisor._worker_cmd

    def cmd(self, shard, first):
        argv = real_cmd(self, shard, first)
        if not (first and shard == 0):
            return argv
        boom = (
            "import runpy, sys\n"
            "from evergreen_tpu_torch.ops._build import KernelError\n"
            "import evergreen_tpu_torch.scheduler.wrapper as w\n"
            "def solve(*a, **k):\n"
            "    raise KernelError('injected card fault')\n"
            "w.run_solve_packed = solve\n"
            f"sys.argv = ['worker'] + {argv[3:]!r}\n"
            "runpy.run_module('evergreen_tpu_torch.runtime.worker', run_name='__main__')\n"
        )
        return [sys.executable, "-c", boom]

    monkeypatch.setattr(FleetSupervisor, "_worker_cmd", cmd)
    run = t_procs.ProcScenarioRun(t_procs.PROC_SCENARIOS["proc-fleet-sigkill"](),
                                  device="cpu")
    with pytest.raises(t_procs.WorkerExitError, match=r"exited \{0: \[1\]\}"):
        run.execute()
    assert EXIT_KERNEL == 1
    assert run.sup.handles[0].exits == [EXIT_KERNEL]
    assert not os.path.exists(run.data_dir)
