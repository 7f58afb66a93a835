"""The port's fuzzer, proc arm, against the JAX package's, on the CPU.

``generate_proc_weather`` draws JAX's supervised-fleet weather for every
seed of the campaign's window (compared through ``spec_to_jsonable``),
with and without sabotage; ``run_case`` sends a proc spec to the process
backend on the caller's device; a four-case proc campaign from the
pinned start seed is green, as ``FUZZCARD_GREEN.json``'s ``procs``
section records; and the proc sabotage self-test returns JAX's result,
fingerprint included.
"""
from __future__ import annotations

import json
import os

import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu.scenarios import fuzz as j_fuzz  # noqa: E402
from evergreen_tpu.scenarios import trace as j_trace  # noqa: E402

from evergreen_tpu_torch.scenarios import fuzz as t_fuzz  # noqa: E402
from evergreen_tpu_torch.scenarios import procs as t_procs  # noqa: E402
from evergreen_tpu_torch.scenarios import trace as t_trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = t_fuzz.DEFAULT_CAMPAIGN_SEED


@pytest.mark.parametrize("sabotage", [False, True])
def test_generate_proc_weather_matches_jax(sabotage):
    kinds = set()
    for seed in range(START, START + 64):
        want = j_trace.spec_to_jsonable(j_fuzz.generate_proc_weather(seed, sabotage=sabotage))
        got = t_trace.spec_to_jsonable(t_fuzz.generate_proc_weather(seed, sabotage=sabotage))
        assert got == want, seed
        kinds.update(e["kind"] for e in got["events"])
    assert kinds <= set(t_procs.PROC_EVENT_KINDS)
    if not sabotage:
        # the window draws every storm: kills, hangs, supervisor and leader deaths
        assert {"proc_kill", "proc_hang", "sup_kill", "sup_restart",
                "leader_kill", "leader_hang"} <= kinds


def test_generate_proc_weather_pure_function_of_seed():
    a, b = t_fuzz.generate_proc_weather(7), t_fuzz.generate_proc_weather(7)
    assert a.events == b.events and (a.ticks, a.seed) == (b.ticks, b.seed)
    assert a.events[0].kind == "proc_fleet"
    assert a.invariants == t_procs.DEFAULT_PROC_INVARIANTS
    assert t_fuzz.generate_proc_weather(7).events != t_fuzz.generate_proc_weather(8).events


def test_proc_fuzz_fingerprint_matches_jax():
    entry = {"name": "fuzz-proc-w7", "seed": 7, "ok": False,
             "invariants": {"no_duplicate_dispatch": {"ok": False, "detail": "x"}},
             "checks": {}, "slos": {}, "stats": {"unfinished_final": 0, "ticks": 9},
             "timing": {"wall_ms": 1.0}}
    assert t_fuzz.proc_fuzz_fingerprint(entry) == j_fuzz.proc_fuzz_fingerprint(entry)
    moved = dict(entry, stats={"unfinished_final": 0, "ticks": 11})
    assert t_fuzz.proc_fuzz_fingerprint(moved) == t_fuzz.proc_fuzz_fingerprint(entry)


def test_run_case_sends_proc_specs_to_the_process_backend(monkeypatch):
    seen = []

    def fake(spec, seed=None, device=None):
        seen.append((spec.name, seed, str(device)))
        return {"ok": True}

    monkeypatch.setattr(t_procs, "run_proc_scenario", fake)
    spec = t_fuzz.generate_proc_weather(START)
    assert t_fuzz.run_case(spec, seed=3, device="cpu") == {"ok": True}
    assert seen == [(spec.name, 3, "cpu")]

    def worker_fault(spec, seed=None, device=None):
        raise t_procs.WorkerExitError("shard workers exited {0: [1]}")

    monkeypatch.setattr(t_procs, "run_proc_scenario", worker_fault)
    with pytest.raises(t_procs.WorkerExitError):
        t_fuzz.run_case(spec, device="cpu")


def test_proc_campaign_is_green_from_the_pinned_seed():
    with open(os.path.join(REPO, "FUZZCARD_GREEN.json")) as fh:
        green = json.load(fh)["procs"]
    seen = []
    rep = t_fuzz.campaign(start_seed=green["start_seed"], max_cases=green["cases"],
                          proc=True, progress=seen.append, device="cpu")
    assert rep["failures"] == [], rep["failures"]
    assert {k: rep[k] for k in ("backend", "cases", "failures", "ok", "start_seed")} == {
        k: green[k] for k in ("backend", "cases", "failures", "ok", "start_seed")}
    assert [s["seed"] for s in seen] == list(range(START, START + green["cases"]))


def test_proc_sabotage_selftest_matches_jax():
    got = t_fuzz.sabotage_selftest(proc=True, device="cpu")
    want = j_fuzz.sabotage_selftest(proc=True)
    assert got == want
    assert got["ok"] and got["red"] == ["no_duplicate_dispatch"]
    assert got["fingerprint"] == "0ef09079e60ec00c"
