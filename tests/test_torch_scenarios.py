"""The port's scenario engine against the JAX package's, on the CPU.

Every library weather and every checked-in regression spec replays once
through each package's engine (the port's with ``device="cpu"``). The
two scorecard entries must be equal in every field but ``timing``:
``counters`` is compared key by key first, so that a counter the port
names or counts otherwise fails by its name; then each other field; then
the fingerprint. The specs that ``SCORECARD_GREEN.json`` names also
equal that file's entries and fingerprints.

The JAX tick solves through ``jax.experimental.enable_x64``; JAX releases
without it get ``jax.enable_x64`` under that name through the ``x64``
fixture. Without the alias JAX's tick degrades to its serial oracle and
the comparison would hold the port against that fallback.

Then JAX's ``tests/test_scenarios.py`` on the port: every weather green,
the whole sweep (weathers, regressions, matrix cases) deterministic,
the fingerprint blind to timing, and the sabotage spec caught.
"""
from __future__ import annotations

import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import evergreen_tpu.scenarios as j_sc  # noqa: E402
from evergreen_tpu.scenarios.trace import load_regression_specs as j_regressions  # noqa: E402

import evergreen_tpu_torch.scenarios as t_sc  # noqa: E402
from evergreen_tpu_torch.scenarios.spec import scorecard_entry_fingerprint  # noqa: E402
from evergreen_tpu_torch.scenarios.trace import load_regression_specs as t_regressions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "SCORECARD_GREEN.json")) as _fh:
    GREEN = json.load(_fh)["scenarios"]

REGRESSIONS = sorted(t_regressions())
WEATHERS = sorted(t_sc.SCENARIOS)


@pytest.fixture
def x64(monkeypatch):
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(
            jax.experimental, "enable_x64", jax.enable_x64, raising=False
        )


@pytest.fixture
def fresh(store):
    """Both packages' process-wide fakes reset (the JAX package's by the
    ``store`` fixture): each engine resets its cloud clients itself, but
    the mock provider's instance table outlives a run."""
    from evergreen_tpu_torch.cloud.mock import MockCloudManager

    MockCloudManager.reset()
    yield
    MockCloudManager.reset()


def spec_pair(name, seed=0):
    """The JAX and the port spec of one weather, regression spec or
    matrix case (``"fault:<case>"``, ``"overload:<case>"``)."""
    out = []
    for pkg, regs in ((j_sc, j_regressions()), (t_sc, t_regressions())):
        if name.startswith("fault:"):
            out.append(pkg.FAULT_SCENARIO_CASES[name[6:]](seed))
        elif name.startswith("overload:"):
            out.append(pkg.OVERLOAD_SCENARIO_CASES[name[9:]](seed))
        else:
            out.append((pkg.SCENARIOS.get(name) or regs[name])())
    return out


def run_both(name, seed=0):
    j_spec, t_spec = spec_pair(name, seed)
    return j_sc.run_scenario(j_spec), t_sc.run_scenario(t_spec, device="cpu")


def assert_same_entry(want, got):
    """Every field but ``timing`` equal: the counters key by key first."""
    for key in sorted(set(want["counters"]) | set(got["counters"])):
        assert got["counters"].get(key) == want["counters"].get(key), key
    assert set(got) == set(want)
    for field in sorted(want):
        if field not in ("timing", "fingerprint"):
            assert got[field] == want[field], field
    assert got["fingerprint"] == want["fingerprint"]


def failures(entry):
    return {f"{sec}.{name}": v for sec in ("invariants", "checks", "slos")
            for name, v in entry.get(sec, {}).items() if not v["ok"]}


def join_abandoned_solves(timeout_s=5.0):
    """A solve abandoned at its deadline finishes on its own thread."""
    for th in threading.enumerate():
        if th.name == "tick-solve":
            th.join(timeout_s)


@pytest.mark.parametrize("name", WEATHERS + REGRESSIONS)
def test_entry_matches_jax(name, x64, fresh):
    want, got = run_both(name)
    assert want["ok"], failures(want)
    assert_same_entry(want, got)
    green = GREEN.get(got["name"])
    if green is not None:
        for field in green:
            if field != "timing":
                assert got[field] == green[field], field


def test_scorecard_green_names_twenty_of_them():
    named = [n for n in WEATHERS + REGRESSIONS if n in GREEN]
    assert len(named) == 12
    assert sorted(set(WEATHERS) - set(GREEN)) == [
        "net-agent-storm-halfopen", "net-agent-storm-loss",
        "net-replica-halfopen"]
    matrix = [s.name for s in (
        [f(0) for f in t_sc.FAULT_SCENARIO_CASES.values()]
        + [f(0) for f in t_sc.OVERLOAD_SCENARIO_CASES.values()])
        if s.deterministic]
    assert len(named) + len([m for m in matrix if m in GREEN]) == 20


@pytest.mark.parametrize("name", WEATHERS)
def test_scenario_green(name, fresh):
    entry = t_sc.run_scenario(t_sc.SCENARIOS[name](), device="cpu")
    assert entry["ok"], failures(entry)


def test_scenario_fingerprint_excludes_timing(fresh):
    a = t_sc.run_scenario(t_sc.SCENARIOS["dag-stepback"](), device="cpu")
    b = t_sc.run_scenario(t_sc.SCENARIOS["dag-stepback"](), device="cpu")
    assert a["fingerprint"] == b["fingerprint"]
    assert a["ok"] and b["ok"]
    slower = dict(a, timing={"wall_ms": a["timing"]["wall_ms"] + 1e6})
    assert scorecard_entry_fingerprint(slower) == a["fingerprint"]


def sweep_specs():
    """Every weather, regression spec and matrix case, by name."""
    specs = {n: f for n, f in t_sc.SCENARIOS.items()}
    specs.update(t_regressions())
    for reg in (t_sc.FAULT_SCENARIO_CASES, t_sc.OVERLOAD_SCENARIO_CASES):
        for n, f in reg.items():
            specs[n] = (lambda f=f: f(0))
    return specs


SWEEP = sweep_specs()

#: replays of a timed case (``deterministic=False``) before it counts as
#: failed: its ladder reads the host's real WAL commit latency (YELLOW
#: from 3 ms), and on a loaded host (the suite's other workers) a
#: recovery tick can read above that in either package, as JAX's own
#: ``tests/test_overload.py`` case shows
TIMED_ATTEMPTS = 3


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_full_sweep_deterministic(name, fresh):
    """One spec of the sweep (every weather, regression spec and matrix
    case) through the port's engine twice: both green, a deterministic
    one fingerprint-equal. A timed one (the ``slow-store-storm`` case)
    gets ``TIMED_ATTEMPTS`` replays of the pair to be green in one."""
    factory = SWEEP[name]
    attempts = 1 if factory().deterministic else TIMED_ATTEMPTS
    seen = []
    for _ in range(attempts):
        a = t_sc.run_scenario(factory(), device="cpu")
        b = t_sc.run_scenario(factory(), device="cpu")
        join_abandoned_solves()
        seen.append((failures(a), failures(b)))
        if a["ok"] and b["ok"]:
            break
    assert a["ok"] and b["ok"], (name, seen)
    if a["deterministic"]:
        assert a["fingerprint"] == b["fingerprint"], name


def test_the_sweep_times_only_the_slow_store_storm():
    assert [n for n, f in sorted(SWEEP.items()) if not f().deterministic] == [
        "slow-store-storm"]
    assert len(SWEEP) == 24


def test_sabotage_duplicate_claim_is_caught(x64, fresh):
    got = t_sc.run_scenario(
        t_sc.SABOTAGE_SCENARIOS["sabotage-duplicate-claim"](), device="cpu")
    assert not got["ok"]
    assert not got["invariants"]["store_consistent"]["ok"]
    want = j_sc.run_scenario(j_sc.SABOTAGE_SCENARIOS["sabotage-duplicate-claim"]())
    assert_same_entry(want, got)


@pytest.mark.parametrize("error", ["KernelError", "MirrorError"])
def test_card_fault_raises_out_of_the_engine(error, monkeypatch, fresh):
    """A card fault in the tick is no degradation: it raises out of
    ``run_scenario``, with the run's process-wide state undone (the
    fault plan, the log sink) and its durable data directory removed."""
    from evergreen_tpu_torch.ops._build import KernelError
    from evergreen_tpu_torch.ops.resident_ops import MirrorError
    from evergreen_tpu_torch.scenarios import engine
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.utils import faults
    from evergreen_tpu_torch.utils import log as log_mod

    exc = {"KernelError": KernelError, "MirrorError": MirrorError}[error]
    real = wrapper.run_tick
    calls = []

    def faulty(store, opts=None, now=None, device=None):
        calls.append(device)
        if len(calls) == 3:
            raise exc("the card failed")
        return real(store, opts, now=now, device=device)

    monkeypatch.setattr(wrapper, "run_tick", faulty)
    sinks = list(log_mod._sinks)
    run = engine.ScenarioRun(t_sc.SCENARIOS["region-failover"](), device="cpu")
    with pytest.raises(exc):
        run.execute()
    assert len(calls) == 3 and {str(d) for d in calls} == {"cpu"}
    assert faults.active() is None and log_mod._sinks == sinks
    assert run.data_dir and not os.path.exists(run.data_dir)
    # an injected solve fault, by contrast, degrades the tick
    entry = t_sc.run_matrix_case("fault", "solve-raise", device="cpu")["entry"]
    assert entry["ok"] and entry["degraded"] == {"solve-failed": 1}
