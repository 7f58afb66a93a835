"""The port's fault plans (``evergreen_tpu_torch/utils/faults.py``) against
the JAX package's: seeded schedules, the ``EVG_FAULTS`` spec and its
install at import, and the firing of a plan built either way."""
import json
import os
import subprocess
import sys

import pytest

from evergreen_tpu.utils import faults as j_faults
from evergreen_tpu_torch.utils import faults as t_faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def schedule(plan) -> dict:
    """A plan's (seam -> sorted (index, kind)) and its always-faults."""
    return {"at": {seam: sorted((i, f.kind) for i, f in by.items())
                   for seam, by in plan._at.items()},
            "always": {seam: f.kind for seam, f in plan._always.items()}}


@pytest.mark.parametrize("seed", [0, 1, 7, 2024])
@pytest.mark.parametrize("rates,horizon", [
    ({"wal.append": 0.1}, 1000),
    ({"scheduler.solve": 0.05, "wal.commit": 0.2, "lease.renew": 0.01}, 500),
    ({"dispatch.assign": 0.5, "agent.request": 0.0}, 64),
])
def test_seeded_plans_are_jax_s(seed, rates, horizon):
    t = t_faults.FaultPlan.seeded(seed, rates, horizon=horizon)
    j = j_faults.FaultPlan.seeded(seed, rates, horizon=horizon)
    assert schedule(t) == schedule(j)
    assert sum(len(v) for v in schedule(t)["at"].values()) > 0 or not any(rates.values())


def test_a_seeded_plan_fires_its_fault_kind_as_jax_s():
    """The same seeded plan of ``hang`` faults fired call by call on both
    packages: the same calls fire, with the same sleeps."""
    got = {}
    for name, mod in (("jax", j_faults), ("port", t_faults)):
        plan = mod.FaultPlan.seeded(3, {"wal.fence": 0.3}, horizon=40,
                                    fault=mod.Fault("hang", delay_s=0.25))
        slept = []
        for _ in range(40):
            plan.fire("wal.fence", sleep=slept.append)
        got[name] = (plan.fired, slept)
    assert got["port"] == got["jax"]
    assert got["port"][1] and set(got["port"][1]) == {0.25}


@pytest.mark.parametrize("spec", [
    "scheduler.solve:raise@2,wal.append:raise@5",
    "wal.commit:torn@1",
    " lease.renew:lost@0 , ,dispatch.assign:crash",
    "recovery.pass:@3",
    "",
])
def test_plan_from_env_is_jax_s(spec):
    assert schedule(t_faults._plan_from_env(spec)) == schedule(j_faults._plan_from_env(spec))


def test_evg_faults_installs_a_plan_at_import():
    """In a fresh interpreter with ``EVG_FAULTS`` set, importing the
    module installs the spec's plan (and without it, none)."""
    code = ("import json; from evergreen_tpu_torch.utils import faults as f; p = f.active();"
            "print(json.dumps(None if p is None else "
            "{s: sorted((i, x.kind) for i, x in by.items()) for s, by in p._at.items()}))")
    out = {}
    for spec in ("wal.append:torn@3,scheduler.solve:raise@0", ""):
        env = {**os.environ, "EVG_FAULTS": spec}
        proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                              capture_output=True, text=True, timeout=120, check=True)
        out[spec] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out[""] is None
    assert out["wal.append:torn@3,scheduler.solve:raise@0"] == {
        "wal.append": [[3, "torn"]], "scheduler.solve": [[0, "raise"]]}
