"""The tick's planning half through the port against the JAX package.

Each problem is seeded into one store of each package, through that
package's own models (``generate_problem`` + ``insert_many`` for the
generated ones). ``plan_tick`` is the chain of the JAX ``run_tick`` body
from the store to the numbers the persister writes, without the cmp
planner, the serial fallback, the persister and intent creation: intent
budget, capacity page, snapshot, bounded solve, unpack, the alias and
single-task rules, the capacity plane. It takes a package's modules as an
argument, so the JAX run and the port run are the same code; the port's
runs on the CPU (``run_solve_packed(device="cpu")`` as the tick's
``solve_fn``, and ``run_capacity_solve`` pinned to the CPU by the
``port_cpu`` fixture: on its own it runs on the card or raises).

Compared: plans (task ids in order) and spawn counts before and after
the capacity plane exactly, the rung that served it, capacity targets
and rounded allocations exactly; sort values exactly (the planner's f32
arithmetic is the same); the f32 sums in the queue info within rtol 1e-5;
the capacity and solve provenance rows' floats within rtol 1e-5 or the
unit they are rounded to (``ROUNDED``).
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from evergreen_tpu import globals as j_globals  # noqa: E402
from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.models import distro as j_distro  # noqa: E402
from evergreen_tpu.models import host as j_host  # noqa: E402
from evergreen_tpu.models import task as j_task  # noqa: E402
from evergreen_tpu.ops import capacity as j_cap  # noqa: E402
from evergreen_tpu.scheduler import capacity_plane as j_plane  # noqa: E402
from evergreen_tpu.scheduler import provenance as j_prov  # noqa: E402
from evergreen_tpu.scheduler import snapshot as j_snapshot  # noqa: E402
from evergreen_tpu.scheduler import wrapper as j_wrapper  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402
from evergreen_tpu.utils import benchgen as j_benchgen  # noqa: E402
from evergreen_tpu.utils import faults as j_faults  # noqa: E402

from evergreen_tpu_torch import globals as t_globals  # noqa: E402
from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.models import distro as t_distro  # noqa: E402
from evergreen_tpu_torch.models import host as t_host  # noqa: E402
from evergreen_tpu_torch.models import task as t_task  # noqa: E402
from evergreen_tpu_torch.ops import capacity as t_cap  # noqa: E402
from evergreen_tpu_torch.ops import solve as t_solve  # noqa: E402
from evergreen_tpu_torch.scheduler import capacity_plane as t_plane  # noqa: E402
from evergreen_tpu_torch.scheduler import provenance as t_prov  # noqa: E402
from evergreen_tpu_torch.scheduler import snapshot as t_snapshot  # noqa: E402
from evergreen_tpu_torch.scheduler import wrapper as t_wrapper  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402
from evergreen_tpu_torch.utils import benchgen as t_benchgen  # noqa: E402
from evergreen_tpu_torch.utils import faults as t_faults  # noqa: E402

from test_torch_solve import x64  # noqa: E402,F401

J = types.SimpleNamespace(
    globals=j_globals, settings=j_settings, distro=j_distro, host=j_host,
    task=j_task, cap=j_cap, plane=j_plane, snapshot=j_snapshot,
    wrapper=j_wrapper, store=j_store, benchgen=j_benchgen, faults=j_faults,
)
T = types.SimpleNamespace(
    globals=t_globals, settings=t_settings, distro=t_distro, host=t_host,
    task=t_task, cap=t_cap, plane=t_plane, snapshot=t_snapshot,
    wrapper=t_wrapper, store=t_store, benchgen=t_benchgen, faults=t_faults,
)
#: the port's solve on the CPU, as the tick's solve_fn
PORT_SOLVE = functools.partial(t_solve.run_solve_packed, device="cpu")
NOW = 1_700_000_000.0
SUM_RTOL = 1e-5
#: provenance floats are rounded to these units before they are kept
ROUNDED = {"demand_s": 0.1, "fractional": 1e-3, "demand_term": 1e-4,
           "price_term": 1e-4, "churn_term": 1e-4, "value": 1e-4,
           "priority_term": 1e-4, "rank_term": 1e-4,
           "time_in_queue_term": 1e-4}
MODES = ("fused", "two_call", "heuristic")


@pytest.fixture
def port_cpu(monkeypatch):
    """The port's two-call capacity program on the CPU (where a caller
    names no device)."""
    run = t_cap.run_capacity_solve
    monkeypatch.setattr(
        t_cap, "run_capacity_solve",
        lambda inp, d_pad=None, device=None: run(
            inp, d_pad=d_pad, device=device or "cpu"))


# --------------------------------------------------------------------------- #
# the chain
# --------------------------------------------------------------------------- #


def plan_tick(m, store, now, solve_fn=None, deadline_s=0.0):
    """The planning chain of ``run_tick`` through package ``m``: returns
    a namespace of its outputs and the capacity counters' moves."""
    fused_solves = m.plane.FUSED_SOLVES
    counts0 = {k: fused_solves.value(mode=k) for k in MODES}
    solves0 = m.plane.CAPACITY_SOLVES.total()
    fallbacks0 = m.plane.CAPACITY_FALLBACKS.total()

    budget = max(0, m.globals.MAX_INTENT_HOSTS_IN_FLIGHT
                 - m.host.count_intents_in_flight(store))
    distros, tbd, hbd, est, deps_met = m.wrapper.gather_tick_inputs(store, now)
    distros = m.wrapper._apply_release_mode(store, distros)
    plane = m.plane.capacity_plane_for(store)
    page = plane.build_capacity_page(quota_scale=1.0, intent_budget=budget)
    snap = m.snapshot.build_snapshot(distros, tbd, hbd, est, deps_met, now)
    m.snapshot.pack_capacity_page(snap.arrays, page)
    breaker = m.wrapper.solve_breaker_for(store)
    assert breaker.allow(now=now)
    try:
        out = m.wrapper._solve_bounded(store, snap, deadline_s, solve_fn=solve_fn)
    except Exception as exc:
        breaker.record_failure(now=now, error=repr(exc))
        raise
    breaker.record_success(now=now)
    plans, sort_values, infos, new_hosts, _met, _epoch, provenance = (
        m.wrapper._unpack_solve(snap, out))
    d_pool, d_cap = snap.arrays["d_pool"], snap.arrays["d_cap_on"]
    packed_cols = {did: (int(d_pool[i]), bool(d_cap[i]))
                   for i, did in enumerate(snap.distro_ids)}
    fused = m.plane.extract_fused_view(snap, out) if page is not None else None
    for k in [k for k in new_hosts if k.endswith(m.globals.ALIAS_SUFFIX)]:
        del new_hosts[k]
    for d in distros:
        if d.single_task_distro and d.id in new_hosts:
            info = infos.get(d.id)
            demand = info.length_with_dependencies_met if info else 0
            existing = len(hbd.get(d.id, []))
            cap = d.host_allocator_settings.maximum_hosts or demand
            new_hosts[d.id] = max(0, min(demand, cap - existing))
    before = dict(new_hosts)
    after = plane.apply(
        distros, infos, new_hosts, hbd, now, degraded=False, quota_scale=1.0,
        intent_budget=budget, packed_cols=packed_cols, fused=fused,
    )
    return types.SimpleNamespace(
        snap=snap, out=out, plans=plans, sort_values=sort_values,
        infos=infos, before=before, after=after, provenance=provenance,
        capacity=getattr(store, "_last_capacity", None), fused=fused,
        rungs={k: fused_solves.value(mode=k) - counts0[k] for k in MODES},
        capacity_solves=m.plane.CAPACITY_SOLVES.total() - solves0,
        fallbacks=m.plane.CAPACITY_FALLBACKS.total() - fallbacks0,
    )


def assert_close_docs(got, want, path=""):
    """Equal documents: ints, strings and lists exact, floats within
    rtol ``SUM_RTOL`` or their rounding unit (``ROUNDED``)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close_docs(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_docs(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        unit = ROUNDED.get(path.rsplit(".", 1)[-1], 0.0)
        # rounded values of f32 inputs within SUM_RTOL may differ by one
        # unit, which is not exact in binary
        assert abs(got - want) <= max(SUM_RTOL * abs(want), unit * (1 + 1e-6)), (
            path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def assert_same_tick(t, j):
    """The port's chain outputs ``t`` against the JAX package's ``j``."""
    assert list(t.plans) == list(j.plans)
    for did in j.plans:
        assert [x.id for x in t.plans[did]] == [x.id for x in j.plans[did]], did
        np.testing.assert_array_equal(t.sort_values[did], j.sort_values[did],
                                      err_msg=did)
        assert_close_docs(t.infos[did].doc(), j.infos[did].doc(), f"info[{did}]")
        assert_close_docs(t.provenance.to_doc(did, limit=10**9),
                          j.provenance.to_doc(did, limit=10**9), f"prov[{did}]")
    assert t.before == j.before
    assert t.after == j.after
    assert t.rungs == j.rungs
    assert (t.capacity_solves, t.fallbacks) == (j.capacity_solves, j.fallbacks)
    assert (t.capacity is None) == (j.capacity is None)
    if j.capacity is not None:
        assert t.capacity.chosen == j.capacity.chosen
        assert t.capacity.stale == j.capacity.stale
        assert_close_docs(t.capacity.to_doc(limit=10**9),
                          j.capacity.to_doc(limit=10**9), "capacity")


# --------------------------------------------------------------------------- #
# problems, seeded through each package's own models
# --------------------------------------------------------------------------- #


def make_tasks(m, did, n, dur=900.0):
    """tests/test_capacity.py::make_tasks."""
    return [
        m.task.Task(
            id=f"{did}-t{j}", distro_id=did, project="p", version="v1",
            build_variant="bv", status="undispatched", activated=True,
            requester="gitter_request", activated_time=NOW - 600,
            create_time=NOW - 700, scheduled_time=NOW - 600,
            expected_duration_s=dur,
        )
        for j in range(n)
    ]


def seed_spec(m, store, spec, capacity="tpu", max_hosts=50, **distro_kw):
    """tests/test_capacity.py::seed: spec [(distro_id, n_tasks), ...]."""
    for did, n in spec:
        m.distro.insert(store, m.distro.Distro(
            id=did, provider="mock",
            planner_settings=m.distro.PlannerSettings(capacity=capacity),
            host_allocator_settings=m.distro.HostAllocatorSettings(
                maximum_hosts=max_hosts),
            **distro_kw,
        ))
        m.task.insert_many(store, make_tasks(m, did, n))


def seed_tick_problem(m, store):
    """tests/test_tick.py::seed_problem."""
    m.distro.insert(store, m.distro.Distro(
        id="d1", provider="mock",
        host_allocator_settings=m.distro.HostAllocatorSettings(maximum_hosts=10),
    ))
    tasks = [
        m.task.Task(
            id=f"t{i}", distro_id="d1", project="p", version="v1",
            build_variant="bv", status="undispatched", activated=True,
            requester="gitter_request", activated_time=NOW - 600,
            create_time=NOW - 700, scheduled_time=NOW - 600,
            expected_duration_s=300.0, priority=i,
        )
        for i in range(5)
    ]
    tasks[0].depends_on = [m.task.Dependency(task_id="t4")]
    tasks[4].num_dependents = 1
    tasks[1].depends_on = [m.task.Dependency(task_id="done1")]
    finished = m.task.Task(id="done1", distro_id="d1", status="success",
                           activated=True)
    m.task.insert_many(store, tasks + [finished])


def seed_generated(m, store, n_distros, n_tasks, seed, capacity=False):
    """``generate_problem`` inserted as bench.py does; with ``capacity``
    every distro opts into the capacity program under a binding quota
    and fleet budget (bench.py's capacity arm, scaled to the fleet)."""
    distros, tbd, hbd, _, _ = m.benchgen.generate_problem(
        n_distros, n_tasks, seed=seed)
    for d in distros:
        m.distro.insert(store, d)
    m.task.insert_many(store, [t for ts in tbd.values() for t in ts])
    for hs in hbd.values():
        m.host.insert_many(store, hs)
    if capacity:
        coll = m.distro.coll(store)
        for doc in coll.find():
            ps = dict(doc["planner_settings"])
            ps["capacity"] = "tpu"
            coll.update(doc["_id"], {"planner_settings": ps})
        m.settings.CapacityConfig(
            pool_quotas={"mock": 27 * n_distros},
            fleet_intent_budget=5 * n_distros // 2,
        ).set(store)


def scenario(name, m, store):
    if name == "tick":
        seed_tick_problem(m, store)
    elif name == "quota":
        seed_spec(m, store, [("deep", 30), ("shallow", 3)])
        m.settings.CapacityConfig(pool_quotas={"mock": 8}).set(store)
    elif name == "alias":
        seed_spec(m, store, [("primary", 12), ("other", 2)])
        for j in range(12):
            m.task.coll(store).update(f"primary-t{j}",
                                      {"secondary_distros": ["other"]})
        m.settings.CapacityConfig(pool_quotas={"mock": 6}).set(store)
    elif name == "single":
        seed_spec(m, store, [("solo", 5)], max_hosts=30, single_task_distro=True)
        seed_spec(m, store, [("bulk", 20)], max_hosts=30)
        m.settings.CapacityConfig(pool_quotas={"mock": 3}).set(store)
    elif name == "autotune":
        seed_spec(m, store, [("d1", 40)], max_hosts=6)
        d = m.distro.get(store, "d1")
        d.host_allocator_settings.auto_tune_maximum_hosts = True
        m.distro.upsert(store, d)
        m.settings.ReleaseModeConfig(distro_max_hosts_factor=1.5).set(store)
    else:
        seed, cap = {"gen1": (1, False), "gen2": (2, False),
                     "gen1+cap": (1, True), "gen2+cap": (2, True)}[name]
        seed_generated(m, store, 20, 5_000, seed, capacity=cap)
    return store


SCENARIOS = ["tick", "quota", "alias", "single", "autotune",
             "gen1", "gen2", "gen1+cap", "gen2+cap"]


def both(name):
    return (scenario(name, J, j_store.Store()),
            scenario(name, T, t_store.Store()))


# --------------------------------------------------------------------------- #
# the chain against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", SCENARIOS)
def test_planning_chain_matches_jax(name, x64, port_cpu):
    js, ts = both(name)
    j = plan_tick(J, js, NOW)
    t = plan_tick(T, ts, NOW, solve_fn=PORT_SOLVE)
    assert_same_tick(t, j)
    # the scenarios do what they are named for
    if name == "alias":
        assert "other::alias" in t.plans and "other::alias" not in t.after
    if name in ("quota", "alias", "single", "autotune", "gen1+cap", "gen2+cap"):
        assert t.rungs == {"fused": 1, "two_call": 0, "heuristic": 0}
        assert t.capacity_solves == 0
    if name == "quota":
        assert sum(t.after.values()) <= 8 < sum(t.before.values())
        for did in ("deep", "shallow", "nope"):
            assert_close_docs(t_prov.explain_capacity(ts, did),
                              j_prov.explain_capacity(js, did), did)
        assert t_prov.capacity_provenance_for(ts) is t.capacity
        assert t_prov.provenance_for(ts) is j_prov.provenance_for(js) is None
    if name == "single":
        assert t.after["solo"] == 5 and t.after["bulk"] <= 3
    if name == "autotune":
        assert 6 < t.snap.arrays["d_max_hosts"][0] == 9


@pytest.mark.parametrize("name", ["tick", "quota", "alias", "single",
                                  "autotune", "gen1+cap"])
def test_jax_chain_is_the_ticks_own(name, x64):
    """The helper's spawn counts are JAX ``run_tick``'s on an identical
    store, so what the port is held to is the tick's own chain."""
    js, ref = (scenario(name, J, j_store.Store()) for _ in range(2))
    j = plan_tick(J, js, NOW)
    res = j_wrapper.run_tick(ref, j_wrapper.TickOptions(
        use_cache=False, underwater_unschedule=False), now=NOW)
    assert res.planner_used == "tpu" and res.degraded == ""
    assert j.after == res.new_hosts


def test_gather_matches_jax_on_explicit_inputs():
    """gather_tick_inputs given the warm sets (runnable tasks, active
    hosts, a deps map that misses a task) reads the same as the JAX one."""
    js, ts = both("alias")
    outs = []
    for m, store in ((J, js), (T, ts)):
        runnable = m.task.find_host_runnable(store)
        hosts = m.host.all_active_hosts(store)
        deps = {x.id: True for x in runnable[1:]}
        distros, tbd, hbd, est, dm = m.wrapper.gather_tick_inputs(
            store, NOW, runnable_tasks=runnable, active_hosts=hosts,
            deps_met=deps)
        outs.append(([d.to_doc() for d in distros],
                     {k: [x.id for x in v] for k, v in tbd.items()},
                     {k: [h.id for h in v] for k, v in hbd.items()},
                     {k: dataclasses.astuple(v) for k, v in est.items()}, dm))
    assert outs[0] == outs[1]
    assert outs[1][4]["primary-t0"] is False


# --------------------------------------------------------------------------- #
# the two-call rung
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["quota", "gen1+cap", "gen2+cap"])
def test_two_call_rung_is_the_fused_rung(name, port_cpu):
    """fused="two_call" serves the same tick as fused="auto": the two-call
    program at the fused padded D gives the packed solve's cap_x bit for
    bit, so targets and rounded allocations are identical."""
    ticks = {}
    for mode in ("auto", "two_call"):
        store = scenario(name, T, t_store.Store())
        cfg = t_settings.CapacityConfig.get(store)
        cfg.fused = mode
        cfg.set(store)
        ticks[mode] = plan_tick(T, store, NOW, solve_fn=PORT_SOLVE)
    f, c = ticks["auto"], ticks["two_call"]
    assert f.rungs == {"fused": 1, "two_call": 0, "heuristic": 0}
    assert c.rungs == {"fused": 0, "two_call": 1, "heuristic": 0}
    assert (f.capacity_solves, c.capacity_solves) == (0, 1)
    assert f.after == c.after and f.before == c.before
    assert f.capacity.to_doc(limit=10**9)["distros"] == (
        c.capacity.to_doc(limit=10**9)["distros"])
    inp = t_plane.build_fused_inputs(f.fused)
    x = t_cap.run_capacity_solve(inp, d_pad=f.fused["d_pad"])
    assert x.tobytes() == f.fused["cap_x"][: inp.n].tobytes()


def two_distro_inputs(cap, quota=10.0, **overrides):
    """tests/test_capacity.py::two_distro_inputs for package ``cap``."""
    pool = cap.pool_index_of("mock")
    q = np.zeros(cap.P_BUCKET)
    q[pool] = quota
    kw = dict(
        distro_ids=["deep", "shallow"],
        demand_s=np.array([30_000.0, 1_800.0]),
        thresh_s=np.full(2, 1800.0),
        existing=np.array([2.0, 2.0]),
        free=np.zeros(2),
        min_hosts=np.ones(2),
        max_hosts=np.full(2, 20.0),
        deps_met=np.array([40.0, 10.0]),
        pool=np.full(2, pool, np.int32),
        elig=np.ones(2, bool),
        heuristic_new=np.array([14.0, 6.0]),
        price=np.zeros(cap.P_BUCKET),
        quota=q,
        fleet_budget=100.0,
    )
    kw.update(overrides)
    return cap.CapacityInputs(**kw)


INSTANCES = {
    "trading": {},
    "uncoupled": dict(quota=0.0),
    "budget": dict(quota=0.0, fleet_budget=5.0),
    "mins-win": dict(quota=4.0, fleet_budget=0.0, min_hosts=np.array([5.0, 3.0]),
                     existing=np.zeros(2), heuristic_new=np.zeros(2)),
    "ineligible": dict(elig=np.array([True, False])),
    "priced": dict(quota=0.0, price=np.linspace(0.0, 1.0, 8), target_time=True),
}


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_run_capacity_solve_matches_jax(name):
    """tests/test_capacity.py's instances (and one with prices and an odd
    target time): the relaxation within rtol 1e-5 / atol 1e-6, the
    targets and the rung exact."""
    kw = dict(INSTANCES[name])
    if kw.pop("target_time", False):
        kw["thresh_s"] = np.array([1234.5678, 987.654321])
    ji = two_distro_inputs(j_cap, **kw)
    ti = two_distro_inputs(t_cap, **kw)
    jx = j_cap.run_capacity_solve(ji)
    jt = j_cap.solve_capacity(ji)
    tx = t_cap.run_capacity_solve(ti, device="cpu")
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-6)
    tt = t_cap.solve_capacity_from_x(ti, tx)
    np.testing.assert_array_equal(tt[0], jt[0])
    assert tt[2] == jt[2]
    assert t_cap.check_feasible(tt[0], ti) == j_cap.check_feasible(jt[0], ji)
    assert t_cap.drain_seconds(tt[0], ti) == j_cap.drain_seconds(jt[0], ji)
    np.testing.assert_array_equal(t_cap.round_allocation(jx, ti),
                                  j_cap.round_allocation(jx, ji))
    np.testing.assert_array_equal(t_cap.heuristic_allocation(ti),
                                  j_cap.heuristic_allocation(ji))


def test_run_capacity_solve_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cap.run_capacity_solve(two_distro_inputs(t_cap))


def test_round_affinity_matches_jax():
    rng = np.random.default_rng(5)
    aff = rng.random((40, 8))
    aff[3] = 0.0
    counts = rng.integers(0, 9, 40)
    np.testing.assert_array_equal(t_cap.round_affinity(aff, counts),
                                  j_cap.round_affinity(aff, counts))


# --------------------------------------------------------------------------- #
# the fault seams: the port degrades as the JAX package does
# --------------------------------------------------------------------------- #


def with_faults(m, seam, fn):
    m.faults.install(m.faults.FaultPlan().always(seam, m.faults.Fault("raise")))
    try:
        return fn()
    finally:
        m.faults.uninstall()


def test_fused_fault_falls_to_two_call(x64, port_cpu):
    js, ts = both("quota")
    j = with_faults(J, "capacity.fused", lambda: plan_tick(J, js, NOW))
    t = with_faults(T, "capacity.fused", lambda: plan_tick(
        T, ts, NOW, solve_fn=PORT_SOLVE))
    assert t.rungs == j.rungs == {"fused": 0, "two_call": 1, "heuristic": 0}
    assert_same_tick(t, j)


def test_capacity_fault_falls_to_the_heuristic_and_opens_the_breaker(x64, port_cpu):
    from evergreen_tpu.utils import log as j_log
    from evergreen_tpu_torch.utils import log as t_log

    js, ts = both("quota")
    records, opened = {}, {}
    for m, log in ((J, j_log), (T, t_log)):
        records[m.store] = []
        opened[m.store] = log.get_counter("breaker.scheduler.capacity.open")
        log.add_sink(records[m.store].append)
    try:
        jt, tt = (
            with_faults(m, "capacity.solve", lambda: [
                plan_tick(m, store, NOW + 15 * k, solve_fn=solve_fn)
                for k in range(3)])
            for m, store, solve_fn in ((J, js, None), (T, ts, PORT_SOLVE))
        )
    finally:
        j_log.remove_sink(records[j_store].append)
        t_log.remove_sink(records[t_store].append)
    # the same breadcrumbs: three failed solves, one breaker transition
    for m, log in ((J, j_log), (T, t_log)):
        assert [(r["message"], r.get("cause")) for r in records[m.store]
                if r["component"] == "resilience"] == (
            [("capacity-solve-failed", "solve_failed")] * 2
            + [("breaker-transition", None), ("capacity-solve-failed", "solve_failed")])
        assert log.get_counter("breaker.scheduler.capacity.open") == (
            opened[m.store] + 1)
    for j, t in zip(jt, tt):
        assert t.after == t.before == j.after == j.before
        assert t.rungs == j.rungs == {"fused": 0, "two_call": 0, "heuristic": 1}
        assert t.fallbacks == j.fallbacks == 1
    assert t_plane.capacity_plane_for(ts).breaker.state == "open"
    assert j_plane.capacity_plane_for(js).breaker.state == "open"
    assert (t_faults.FAULTS_FIRED.value(seam="capacity.solve") >= 3)


def test_solve_fault_raises_out_of_the_bounded_solve():
    js, ts = both("tick")
    for m, store in ((J, js), (T, ts)):
        distros, tbd, hbd, est, dm = m.wrapper.gather_tick_inputs(store, NOW)
        snap = m.snapshot.build_snapshot(distros, tbd, hbd, est, dm, NOW)
        for deadline in (0.0, 30.0):
            with pytest.raises(m.faults.FaultError):
                with_faults(m, "scheduler.solve", lambda: m.wrapper._solve_bounded(
                    store, snap, deadline, solve_fn=dict))
        # a hang past the deadline is a TimeoutError
        m.faults.install(m.faults.FaultPlan().always(
            "scheduler.solve", m.faults.Fault("hang", delay_s=0.5)))
        try:
            with pytest.raises(TimeoutError):
                m.wrapper._solve_bounded(store, snap, 0.05, solve_fn=dict)
        finally:
            m.faults.uninstall()


@pytest.mark.parametrize("flags,release", [
    ({}, dict(distro_max_hosts_factor=1.5)),
    ({}, dict(target_time_seconds_override=900)),
    (dict(release_mode_disabled=True), dict(distro_max_hosts_factor=2.0)),
    ({}, {}),
])
def test_release_mode_resolves_like_jax(flags, release):
    docs = []
    for m in (J, T):
        store = scenario("autotune", m, m.store.Store())
        seed_spec(m, store, [("plain", 3)])
        m.settings.ServiceFlags(**flags).set(store)
        m.settings.ReleaseModeConfig(**release).set(store)
        distros = m.distro.find_needs_hosts_planning(store)
        resolved = m.wrapper._apply_release_mode(store, distros)
        assert (resolved is distros) == (not release or bool(flags))
        docs.append([d.to_doc() for d in resolved])
    assert docs[0] == docs[1]
