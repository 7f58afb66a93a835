"""The port's weather fuzzer against the JAX package's, on the CPU.

After JAX's in-process tests in ``tests/test_fuzz_weather.py``: the
generator draws JAX's weather for each seed (compared through
``spec_to_jsonable``), a campaign from the pinned start seed gives JAX's
verdicts and fingerprints, the shrinker reduces a planted violation to
JAX's minimal timeline, the sabotage self-test catches its forged claim,
and ``utils/proptest.py`` draws what JAX's draws. The JAX tick runs with
the ``x64`` alias (``tests/test_torch_scenarios.py``). The proc arm is
``tests/test_torch_fuzz_procs.py``'s.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from evergreen_tpu.scenarios import fuzz as j_fuzz  # noqa: E402
from evergreen_tpu.scenarios import trace as j_trace  # noqa: E402
from evergreen_tpu.scenarios.library import _sabotage_duplicate_claim as j_sabotage  # noqa: E402
from evergreen_tpu.utils import proptest as j_st  # noqa: E402

from evergreen_tpu_torch.scenarios import Ev, ScenarioSpec  # noqa: E402
from evergreen_tpu_torch.scenarios import fuzz as t_fuzz  # noqa: E402
from evergreen_tpu_torch.scenarios import trace as t_trace  # noqa: E402
from evergreen_tpu_torch.scenarios.library import _sabotage_duplicate_claim as t_sabotage  # noqa: E402
from evergreen_tpu_torch.utils import proptest as t_st  # noqa: E402

from test_torch_scenarios import assert_same_entry, fresh, x64  # noqa: E402,F401

SEEDS = range(t_fuzz.DEFAULT_CAMPAIGN_SEED, t_fuzz.DEFAULT_CAMPAIGN_SEED + 16)


def cpu_case(spec, seed=None):
    return t_fuzz.run_case(spec, seed=seed, device="cpu")


def test_generate_weather_matches_jax():
    seeds = list(range(1, 17)) + list(range(
        t_fuzz.DEFAULT_CAMPAIGN_SEED, t_fuzz.DEFAULT_CAMPAIGN_SEED + 32))
    for seed in seeds:
        want = j_trace.spec_to_jsonable(j_fuzz.generate_weather(seed))
        got = t_trace.spec_to_jsonable(t_fuzz.generate_weather(seed))
        assert got == want, seed
    # and the sabotage variant, lossily (its needle is a live callable)
    want = j_trace.spec_to_jsonable(j_fuzz.generate_weather(7, sabotage=True), lossy=True)
    got = t_trace.spec_to_jsonable(t_fuzz.generate_weather(7, sabotage=True), lossy=True)
    assert got == want


def test_generate_weather_pure_function_of_seed():
    for seed in (1, 42, t_fuzz.DEFAULT_CAMPAIGN_SEED):
        a, b = t_fuzz.generate_weather(seed), t_fuzz.generate_weather(seed)
        assert a.events == b.events
        assert (a.ticks, a.durable, a.seed) == (b.ticks, b.durable, b.seed)
    assert t_fuzz.generate_weather(1).events != t_fuzz.generate_weather(2).events


def test_campaign_cases_match_jax(x64, fresh):
    """Sixteen seeds from the pinned start: each replay's entry equals
    JAX's (verdict and fingerprint among its fields), and both campaign
    reports find nothing."""
    for seed in SEEDS:
        want = j_fuzz.run_case(j_fuzz.generate_weather(seed))
        got = cpu_case(t_fuzz.generate_weather(seed))
        assert got["ok"], (seed, t_fuzz.red_keys(got))
        assert_same_entry(want, got)
    want = j_fuzz.campaign(time_budget_s=600.0, max_cases=4)
    got = t_fuzz.campaign(time_budget_s=600.0, max_cases=4, device="cpu")
    for key in ("backend", "start_seed", "cases", "failures", "ok"):
        assert got[key] == want[key], key


def test_generated_weather_runs_green_and_deterministic(fresh):
    spec = t_fuzz.generate_weather(t_fuzz.DEFAULT_CAMPAIGN_SEED)
    a, b = cpu_case(spec), cpu_case(spec)
    assert a["ok"], t_fuzz.red_keys(a)
    assert a["fingerprint"] == b["fingerprint"]


def long_failing_spec(pkg_spec, pkg_ev, sabotage, n_noise=29):
    """JAX's ``_long_failing_spec``: one planted violation among benign
    task bursts, in either package's vocabulary."""
    events = [
        pkg_ev(0, "fleet", {"distros": [{"id": "d0", "provider": "mock", "hosts": 8}]}),
        pkg_ev(3, "tasks", {"distro": "d0", "n": 2, "prefix": "busy-"}),
    ]
    for i in range(n_noise - 1):
        events.append(pkg_ev(5 + (i % 7), "tasks", {
            "distro": "d0", "n": 2, "prefix": f"noise{i}-"}))
    events.append(pkg_ev(4, "call", {"fn": sabotage}))
    return pkg_spec(name="shrink-haystack",
                    description="29 benign events + 1 planted violation",
                    ticks=16, events=events, default_task_ticks=3, tier1=False)


def test_shrink_spec_matches_jax(x64, fresh):
    from evergreen_tpu.scenarios import Ev as JEv, ScenarioSpec as JSpec

    j_spec = long_failing_spec(JSpec, JEv, j_sabotage)
    t_spec = long_failing_spec(ScenarioSpec, Ev, t_sabotage)
    red = t_fuzz.red_keys(cpu_case(t_spec))
    assert red == j_fuzz.red_keys(j_fuzz.run_case(j_spec))
    want = j_fuzz.shrink_spec(j_spec, fails=j_fuzz.fails_matching(red))
    got = t_fuzz.shrink_spec(t_spec, fails=t_fuzz.fails_matching(red, device="cpu"))
    assert (t_trace.spec_to_jsonable(got, lossy=True)
            == j_trace.spec_to_jsonable(want, lossy=True))
    assert [e.kind for e in got.events] == [e.kind for e in want.events]
    assert len(got.events) <= 5
    m1, m2 = cpu_case(got), cpu_case(got)
    assert set(red) & set(t_fuzz.red_keys(m1))
    assert m1["fingerprint"] == m2["fingerprint"]
    # the default predicate replays on the device it was given
    pinned = t_fuzz.shrink_spec(long_failing_spec(ScenarioSpec, Ev, t_sabotage, n_noise=4),
                                device="cpu")
    assert (pinned.events[0].tick, pinned.events[0].kind) == (0, "fleet")


def test_shrinker_keeps_green_spec_unchanged(fresh):
    spec = t_fuzz.generate_weather(t_fuzz.DEFAULT_CAMPAIGN_SEED)
    minimal = t_fuzz.shrink_spec(spec, fails=lambda s: not cpu_case(s)["ok"], max_runs=10)
    assert len(minimal.events) == len(spec.events)


def test_sabotage_selftest_matches_jax(x64, fresh):
    got = t_fuzz.sabotage_selftest(device="cpu")
    assert got["caught"] and got["still_caught"] and got["deterministic"], got
    assert got["ok"] and got["shrunk_events"] <= 5, got
    assert got == j_fuzz.sabotage_selftest()


def test_campaign_emits_shrunk_regression_spec(fresh, tmp_path, monkeypatch):
    real_generate = t_fuzz.generate_weather

    def rigged(seed, sabotage=False):
        spec = real_generate(seed, sabotage=sabotage)
        return dataclasses.replace(spec, events=tuple(spec.events) + (
            Ev(2, "call", {"fn": t_sabotage}),))

    monkeypatch.setattr(t_fuzz, "generate_weather", rigged)
    report = t_fuzz.campaign(time_budget_s=60.0, max_cases=1, emit_dir=str(tmp_path),
                             device="cpu")
    assert not report["ok"] and len(report["failures"]) == 1
    assert report["failures"][0]["red"]
    assert len(list(tmp_path.glob("*.json"))) == 1
    assert len(t_trace.load_regression_specs(str(tmp_path))) == 1


def test_red_keys_and_fails_matching(fresh):
    entry = {
        "ok": False,
        "invariants": {"store_consistent": {"ok": False, "detail": "x"},
                       "monotone_epochs": {"ok": True, "detail": ""}},
        "checks": {"drained": {"ok": False, "detail": "y"}},
        "slos": {},
        "error": "RuntimeError('boom')",
    }
    assert t_fuzz.red_keys(entry) == j_fuzz.red_keys(entry)
    assert set(t_fuzz.red_keys(entry)) == {"store_consistent", "drained", "crashed"}
    haystack = long_failing_spec(ScenarioSpec, Ev, t_sabotage, n_noise=2)
    red = t_fuzz.red_keys(cpu_case(haystack))
    assert red and t_fuzz.fails_matching(red, device="cpu")(haystack)
    green = t_fuzz.generate_weather(t_fuzz.DEFAULT_CAMPAIGN_SEED)
    assert not t_fuzz.fails_matching(red, device="cpu")(green)
    assert not t_fuzz.fails_matching(["planning_never_starves"], device="cpu")(haystack)


def test_run_case_turns_a_crash_red_but_raises_a_card_fault(monkeypatch, fresh):
    from evergreen_tpu_torch.ops._build import KernelError
    from evergreen_tpu_torch.scenarios import engine

    def boom(spec, seed=None, device=None):
        raise ValueError("harness crashed")

    monkeypatch.setattr(engine, "run_scenario", boom)
    entry = cpu_case(t_fuzz.generate_weather(1))
    assert not entry["ok"] and t_fuzz.red_keys(entry) == ["crashed"]

    def card_fault(spec, seed=None, device=None):
        raise KernelError("the kernel did not launch")

    monkeypatch.setattr(engine, "run_scenario", card_fault)
    with pytest.raises(KernelError):
        cpu_case(t_fuzz.generate_weather(1))



def test_proptest_draws_match_jax():
    def strategies(st):
        return [
            st.integers(min_value=-5, max_value=10**6),
            st.floats(min_value=0.0, max_value=1.0),
            st.text(max_size=12),
            st.lists(st.sampled_from(["a", "b", "c"]), max_size=6),
            st.dictionaries(st.text(max_size=3), st.booleans(), max_size=4),
            st.one_of(st.none(), st.just(3), st.integers(0, 9)),
            st.fixed_dictionaries({"k": st.integers(0, 3)}),
            st.integers(0, 100).map(lambda x: x * 2).filter(lambda x: x % 3),
        ]

    import random

    for seed in (0, 1, 160001, 2**31 - 1):
        for j_s, t_s in zip(strategies(j_st), strategies(t_st)):
            j_rng, t_rng = random.Random(seed), random.Random(seed)
            # through repr: a drawn NaN equals itself there
            assert (repr([t_s.example(t_rng) for _ in range(8)])
                    == repr([j_s.example(j_rng) for _ in range(8)]))
    j_rng, t_rng = random.Random(5), random.Random(5)
    want = j_st.builds(j_fuzz.generate_weather, j_st.integers(0, 2**32 - 1)).example(j_rng)
    got = t_st.builds(t_fuzz.generate_weather, t_st.integers(0, 2**32 - 1)).example(t_rng)
    assert t_trace.spec_to_jsonable(got) == j_trace.spec_to_jsonable(want)

    drawn = {}
    for name, st in (("jax", j_st), ("port", t_st)):
        seen = []

        @st.settings(max_examples=5)
        @st.given(st.integers(0, 1000), flag=st.booleans())
        def prop(x, flag, seen=seen):
            seen.append((x, flag))

        prop.__qualname__ = "prop"
        prop()
        drawn[name] = seen
    assert drawn["port"] == drawn["jax"] and len(drawn["port"]) == 5
