"""The port's network-chaos matrix (``evergreen_tpu_torch/scenarios/net_matrix.py``)
against the JAX package's (``tools/net_matrix.py``), on the CPU.

Both packages run every case below on the same seeds: the JAX side is
``tools.net_matrix`` (``tests/conftest.py`` already forces the 8 CPU
devices it pins; its ticks run under the ``x64`` alias of
``tests/test_torch_scenarios.py``), the port with ``device="cpu"``.

- The sabotage: red on both, convicted by the dispatch-books invariants,
  with equal verdicts.
- The classic grid's 11 points: both ok, entries equal in every field but
  ``timing`` (fingerprints included: these specs are deterministic),
  every tick of the port's ``TICKS`` line planned by the device solve on
  ``"cpu"``.
- The six seam cases: both ok, the same fields.
- The fuzz arm: JAX's seeds, drawn cases green, the shrunk timeline of
  JAX's size, replaying to one fingerprint.
- ``main``: the card asked for without ``--device cpu``, the sabotage
  gate, ``--point classic:...``, and the classic grid's lines.

The spec builders and constants are held to JAX's field for field in
``tests/test_torch_layout.py``; the fleet points run in
``tests/test_torch_net_matrix_procs.py`` (another xdist worker).
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from evergreen_tpu_torch.scenarios import disk_matrix as t_dm  # noqa: E402
from evergreen_tpu_torch.scenarios import net_matrix as t_nm  # noqa: E402

from test_torch_resilience import jax_module, run_module  # noqa: E402
from test_torch_scenarios import assert_same_entry, failures, fresh, x64  # noqa: E402,F401

MODULE = "evergreen_tpu_torch.scenarios.net_matrix"
CLASSIC = [p for p, _ in t_nm.classic_points()]


def j_nm():
    return jax_module("tools.net_matrix")


def jax_classic_spec(point):
    """JAX's spec of a classic point."""
    _, seam, arg = point.split(":")
    if seam == "agent.request":
        kind, rate = arg.split("@")
        return j_nm()._classic_agent_spec(kind, int(rate) / 100)
    return j_nm()._classic_replica_spec(arg)


def jax_entries(fn, *args):
    """``fn(*args)`` of JAX's net matrix, and every scorecard entry its
    in-process engine returned meanwhile."""
    from evergreen_tpu.scenarios import engine as j_engine

    seen, real = [], j_engine.run_scenario

    def run_scenario(spec, *a, **kw):
        seen.append(real(spec, *a, **kw))
        return seen[-1]

    j_engine.run_scenario = run_scenario
    try:
        return fn(*args), seen
    finally:
        j_engine.run_scenario = real


def test_the_sabotage_is_red_on_both_by_the_dispatch_books(x64, fresh, capsys):
    (want,), (j_entry,) = jax_entries(j_nm().run_sabotage)
    (got,) = t_nm.run_sabotage(device="cpu")
    assert want["ok"] and got["ok"], got["problems"]
    assert got["verdicts"] == t_dm.verdicts(j_entry)
    inv = got["verdicts"]["invariants"]
    assert not (inv["no_duplicate_dispatch"] and inv["store_consistent"]), inv
    ticks = [json.loads(ln[len("TICKS "):]) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("TICKS ")]
    (line,) = [t for t in ticks if t["arm"] == "sabotage"]
    assert line["planners"] == ["tpu"] * 8 and line["problems"] == []


@pytest.mark.parametrize("point", CLASSIC)
def test_classic_point_is_jax_s(point, x64, fresh):
    from evergreen_tpu.scenarios.engine import run_scenario

    want = run_scenario(jax_classic_spec(point))
    entry, line = t_nm.run_engine("grid", point, dict(t_nm.classic_points())[point](),
                                  device="cpu")
    assert want["ok"], failures(want)
    assert entry["ok"] and entry["deterministic"], failures(entry)
    assert_same_entry(want, entry)
    assert line["verdicts"] == t_dm.verdicts(want)
    assert line["fingerprint"] == want["fingerprint"]
    assert line["device"] == "cpu" and line["planners"] == ["tpu"] * 12
    assert line["device_ticks"] == 12 and line["problems"] == []
    assert line["launches"] == {} and line["card_solves"]["solves"] == 0


@pytest.mark.parametrize("fn", [f.__name__ for f in t_nm.CASE_FNS])
def test_case_is_jax_s(fn):
    got, want = getattr(t_nm, fn)(), getattr(j_nm(), fn)()
    assert got["ok"], got["problems"]
    assert want["ok"], want["problems"]
    assert got == want


def test_fuzz_arm_is_jax_s(x64, fresh):
    """The seeds that draw a ``net_fault`` are JAX's, their cases green on
    the port; the sabotaged timeline shrinks to JAX's size and replays
    to one fingerprint on the port."""
    from evergreen_tpu.scenarios import fuzz as j_fuzz

    got = t_nm.run_fuzz_reachability(device="cpu")
    want = []
    for seed in range(j_fuzz.DEFAULT_CAMPAIGN_SEED, j_fuzz.DEFAULT_CAMPAIGN_SEED + 200):
        if any(e.kind == "net_fault" for e in j_fuzz.generate_weather(seed).events):
            want.append(seed)
            if len(want) == 3:
                break
    assert [r["point"] for r in got] == [f"w{s}" for s in want] + ["shrunk-net-timeline"]
    assert all(r["ok"] for r in got), [r["problems"] for r in got]
    j_shrunk = j_nm().shrunk_net_timeline_case(want[0])
    assert j_shrunk["ok"], j_shrunk["problems"]
    assert (got[-1]["shrunk_events"], got[-1]["shrunk_ticks"]) == (
        j_shrunk["shrunk_events"], j_shrunk["shrunk_ticks"])


# --------------------------------------------------------------------------- #
# the harness's entry point
# --------------------------------------------------------------------------- #


def test_main_needs_the_card_unless_told_the_cpu():
    rc, lines, err = run_module(MODULE, "--cases-only")
    assert rc != 0
    assert "no usable CUDA card" in err
    assert not any(ln.startswith(('{"arm"', "TICKS")) for ln in lines)


def test_an_uncaught_sabotage_aborts_main(monkeypatch, capsys, fresh):
    """A sabotage whose forged claim is gone (the books stay fenced) is
    not caught: ``main`` prints ``"aborted"`` and exits 1 before any other
    arm."""
    import dataclasses

    real = t_nm.sabotage_spec

    def fenced():
        spec = real()
        return dataclasses.replace(spec, events=[e for e in spec.events if e.kind != "call"])

    monkeypatch.setattr(t_nm, "sabotage_spec", fenced)
    assert t_nm.main(["--cases-only", "--device", "cpu"]) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last == {"net_matrix_points": 1, "net_matrix_failures": 1,
                    "failed": ["unfenced-duplicate"],
                    "aborted": "sabotage self-test failed"}


def test_point_mode_refuses_a_classic_point():
    with pytest.raises(SystemExit, match="classic points run via --grid-only"):
        t_nm.main(["--point", CLASSIC[0], "--device", "cpu"])


def test_main_runs_the_classic_grid_under_the_witness():
    rc, lines, err = run_module(MODULE, "--grid-only", "--config", "classic",
                                "--device", "cpu")
    assert rc == 0, err
    ticks = [json.loads(ln[len("TICKS "):]) for ln in lines if ln.startswith("TICKS ")]
    assert [t["arm"] for t in ticks] == ["sabotage"] + ["grid"] * 11
    assert [t["point"] for t in ticks[1:]] == CLASSIC
    assert all(t["device"] == "cpu" and not t["problems"]
               and t["planners"] == ["tpu"] * len(t["planners"]) for t in ticks)
    results = [json.loads(ln) for ln in lines if ln.startswith('{"arm"')]
    assert [(r["point"], r["ok"]) for r in results] == (
        [("unfenced-duplicate", True)] + [(p, True) for p in CLASSIC])
    assert json.loads(lines[-2]) == {"lockcheck_inversions": 0}
    assert json.loads(lines[-1]) == {"net_matrix_points": 12, "net_matrix_failures": 0,
                                     "failed": []}
