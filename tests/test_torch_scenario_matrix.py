"""The port's fault and overload matrix cases against the JAX package's.

Each of the nine cases (``scenarios/matrix.py``) runs once through each
package's engine, the port's on the CPU, with the ``x64`` alias set for
JAX's tick (``tests/test_torch_scenarios.py``). The eight deterministic
cases give entries equal in every field but ``timing``, counters first,
and the fingerprints ``SCORECARD_GREEN.json`` holds. The
``overload-slow-store-storm`` case drives its ladder from the real
commit latency of a hanging WAL (``deterministic=False``): it is held by
its verdicts, checks and invariants.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import evergreen_tpu_torch.scenarios as t_sc  # noqa: E402

from test_torch_scenarios import (  # noqa: E402,F401
    GREEN,
    TIMED_ATTEMPTS,
    assert_same_entry,
    failures,
    fresh,
    join_abandoned_solves,
    run_both,
    x64,
)

CASES = ([f"fault:{n}" for n in sorted(t_sc.FAULT_SCENARIO_CASES)]
         + [f"overload:{n}" for n in sorted(t_sc.OVERLOAD_SCENARIO_CASES)])
TIMED = ("overload:slow-store-storm",)


@pytest.mark.parametrize("name", [c for c in CASES if c not in TIMED])
def test_case_matches_jax(name, x64, fresh):
    want, got = run_both(name)
    join_abandoned_solves()
    assert want["ok"], failures(want)
    assert want["deterministic"] and got["deterministic"]
    assert_same_entry(want, got)
    assert got["fingerprint"] == GREEN[got["name"]]["fingerprint"]


@pytest.mark.parametrize("name", TIMED)
def test_timed_case_matches_jax_by_verdicts(name, x64, fresh):
    """Both packages ok with equal verdicts in one of ``TIMED_ATTEMPTS``
    replays of the pair."""
    seen = []
    for _ in range(TIMED_ATTEMPTS):
        want, got = run_both(name)
        assert not got["deterministic"]
        assert (got["name"], got["seed"]) == (want["name"], want["seed"])
        seen.append((failures(want), failures(got)))
        if want["ok"] and got["ok"]:
            break
    assert want["ok"] and got["ok"], seen
    for field in ("checks", "invariants", "slos"):
        assert got[field] == want[field], field


@pytest.mark.parametrize("name", [c for c in CASES if c not in TIMED])
def test_run_matrix_case_shape(name, fresh):
    kind, case = name.split(":")
    res = t_sc.run_matrix_case(kind, case, device="cpu")
    join_abandoned_solves()
    assert res["ok"] is True, failures(res["entry"])
    assert res["entry"]["name"] == f"{kind}-{case}"
