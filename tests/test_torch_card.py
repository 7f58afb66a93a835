"""The port on a CUDA card: each Hopper kernel against its plain version,
and the whole solve on the card against the port's CPU run.

Imports nothing of JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -q tests/test_torch_card.py

Without a card every test here skips (a CUDA kernel has no CPU mode),
except the check that the entry points raise without a card unless they
are given ``device="cpu"``; the ragged-case helpers are shared with
tests/test_torch_distro_stats.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evergreen_tpu_torch.ops.distro_stats import (  # noqa: E402
    STAT_NAMES,
    fused_distro_stats,
    fused_distro_stats_plain,
)
from evergreen_tpu_torch.ops.capacity import (  # noqa: E402
    run_capacity_solve,
    solve_capacity_from_x,
)
from evergreen_tpu_torch.ops.segment import segment_plan, segment_sum  # noqa: E402
from evergreen_tpu_torch.ops.resident_ops import DeviceMirror  # noqa: E402
from evergreen_tpu_torch.ops.solve import (  # noqa: E402
    _packed_solve,
    run_solve_packed,
    split_outputs,
)
from evergreen_tpu_torch.parallel.sharded import (  # noqa: E402
    StackedSolveCache,
    build_sharded_snapshot,
)
from evergreen_tpu_torch.runtime.solver import (  # noqa: E402
    SolverClient,
    SolverService,
)
from evergreen_tpu_torch.scheduler.capacity_plane import (  # noqa: E402
    build_fused_inputs,
    extract_fused_view,
)
from evergreen_tpu_torch.scheduler.snapshot import build_snapshot  # noqa: E402
from evergreen_tpu_torch.utils.benchgen import (  # noqa: E402
    NOW,
    add_capacity_page,
    generate_problem,
)

#: the tile edge of the TPU kernel's ragged sweep
BLOCK = 1024
COUNTS = ("d_length", "d_deps_met", "d_over_count", "d_wait_over", "d_merge")
SUMS = ("d_expected_dur_s", "d_over_dur_s")
TASK_COLS = ("t_valid", "t_deps_met", "t_expected_s", "t_wait_dep_met_s",
             "t_is_merge")


def ragged_case(seed):
    """Distros of 0, 1, 7, BLOCK-1, BLOCK, BLOCK+1 and random sizes
    (the case of test_pallas_kernels.test_kernel_matches_numpy)."""
    rng = np.random.default_rng(seed)
    D = int(rng.integers(1, 40))
    counts = rng.choice(
        [0, 1, 7, BLOCK - 1, BLOCK, BLOCK + 1, int(rng.integers(0, 4000))],
        D,
    )
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    N = max(int(offs[-1]), 1)
    cols = dict(
        t_valid=rng.random(N) < 0.9,
        t_deps_met=rng.random(N) < 0.7,
        t_expected_s=(rng.random(N) * 100).astype(np.float32),
        t_wait_dep_met_s=(rng.random(N) * 100).astype(np.float32),
        t_is_merge=rng.random(N) < 0.1,
    )
    th = (rng.random(D) * 50 + 1).astype(np.float32)
    return cols, offs, th, counts


def single_distro_case():
    """One distro owning 3·BLOCK+17 tasks."""
    N = 3 * BLOCK + 17
    cols = dict(
        t_valid=np.ones(N, bool), t_deps_met=np.ones(N, bool),
        t_expected_s=np.full(N, 2.0, np.float32),
        t_wait_dep_met_s=np.full(N, 2.0, np.float32),
        t_is_merge=np.zeros(N, bool),
    )
    return cols, np.array([0, N], np.int32), np.array([1.0], np.float32), [N]


def sizes_case():
    """Distros on and around the Hopper kernel's edges: empty, one task,
    a warp less one, a warp, a warp and one, the 250 tasks of a config-3
    distro, one past a full stride of 256, and 3·BLOCK+17."""
    rng = np.random.default_rng(11)
    counts = np.array([0, 1, 31, 32, 33, 250, 257, 3 * BLOCK + 17])
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    N = int(offs[-1])
    cols = dict(
        t_valid=rng.random(N) < 0.9,
        t_deps_met=rng.random(N) < 0.7,
        t_expected_s=(rng.random(N) * 100).astype(np.float32),
        t_wait_dep_met_s=(rng.random(N) * 100).astype(np.float32),
        t_is_merge=rng.random(N) < 0.1,
    )
    th = (rng.random(len(counts)) * 50 + 1).astype(np.float32)
    return cols, offs, th, counts


CASES = [pytest.param(s, id=f"ragged{s}") for s in range(6)] + [
    pytest.param("single", id="single"), pytest.param("sizes", id="sizes"),
]


def case(which):
    if which == "single":
        return single_distro_case()
    if which == "sizes":
        return sizes_case()
    return ragged_case(which)


def torch_args(cols, offs, th, device="cpu"):
    return [torch.as_tensor(cols[n]).to(device) for n in TASK_COLS] + [
        torch.as_tensor(offs).to(device), torch.as_tensor(th).to(device)
    ]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", CASES)
def test_distro_stats_kernel_matches_plain(which, cuda_device):
    args = torch_args(*case(which)[:3], cuda_device)
    before = fused_distro_stats.launches
    got = fused_distro_stats(*args)
    torch.cuda.synchronize()
    assert fused_distro_stats.launches == before + 1
    # counts and both duration sums bit-equal to the plain version on the
    # CPU: the kernel adds each sum in element order, as index_add_ does
    # there (on the card index_add_ adds with atomics, in no fixed order)
    want = fused_distro_stats_plain(*(x.cpu() for x in args))
    on_card = fused_distro_stats_plain(*args)
    for name in COUNTS + SUMS:
        assert torch.equal(got[name].cpu(), want[name]), name
    for name in COUNTS:
        assert torch.equal(got[name], on_card[name]), name
    for name in SUMS:
        torch.testing.assert_close(got[name], on_card[name], rtol=1e-5, atol=0.0)
    again = fused_distro_stats(*args)
    for name in STAT_NAMES:
        assert torch.equal(got[name], again[name]), name


def segment_case(which, k):
    """(seg, n_seg, live, x [k, n]) with x zero off the live elements:
    random segments with padding rows, one segment longer than the
    kernel's staging tile (8,192 floats over the k columns), one
    200-element segment among 8 (a config-3 pool sum), empty segments
    (every fourth one, and all past the data)."""
    rng = np.random.default_rng(7)
    if which == "random":
        n, n_seg = 20000, 300
        seg = rng.integers(0, n_seg, n)
        live = rng.random(n) < 0.85
    elif which == "long":
        n, n_seg = 30000, 130
        seg = np.where(rng.random(n) < 0.6, 3, rng.integers(0, n_seg, n))
        live = np.ones(n, bool)
    elif which == "pool":
        n, n_seg = 224, 8
        seg = np.full(n, 4)
        live = np.arange(n) < 200
    else:  # "empty"
        n, n_seg = 5000, 400
        seg = rng.integers(0, 100, n) * 4 % 300
        live = rng.random(n) < 0.5
    x = (rng.random((k, n)) * 10.0 ** rng.integers(-3, 4, (k, n))).astype(np.float32)
    x = np.where(live, x, 0.0).astype(np.float32)
    return torch.as_tensor(seg), n_seg, torch.as_tensor(live), torch.as_tensor(x)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("which", ["random", "long", "pool", "empty"])
def test_segment_kernel_matches_cpu_bitwise(which, k, cuda_device):
    seg, n_seg, live, x = segment_case(which, k)
    want = segment_sum(x, segment_plan(seg, n_seg))
    plan = segment_plan(seg.to(cuda_device), n_seg, live.to(cuda_device))
    xd = x.to(cuda_device)
    if k == 1:
        xd, want = xd[0], want[0]
    before = segment_sum.launches
    got = segment_sum(xd, plan)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, segment_sum(xd, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [False, True], ids=["nocap", "cap"])
def test_card_solve_matches_cpu(capacity, cuda_device):
    snap = build_snapshot(
        *generate_problem(17, 2_000, seed=5, task_group_fraction=0.3,
                          patch_fraction=0.5, hosts_per_distro=5),
        NOW,
    )
    if capacity:
        add_capacity_page(snap)
    cpu = run_solve_packed(snap, device="cpu")
    card = run_solve_packed(snap)
    for name, w in cpu.items():
        if name in SUMS + ("g_expected_dur_s", "g_over_dur_s"):
            np.testing.assert_allclose(card[name], w, rtol=1e-5, err_msg=name)
        elif name in ("cap_x", "aff_pool"):
            np.testing.assert_allclose(card[name], w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(card[name], w, err_msg=name)
    again = run_solve_packed(snap)
    for name in card:
        assert card[name].tobytes() == again[name].tobytes(), name


@pytest.mark.cuda
def test_card_mirror_updates_equal_a_full_upload(cuda_device):
    """Slice runs (``copy_``) and the sparse part (``index_copy_``),
    with duplicate and overlapping spans, leave the resident tensors
    equal to the truth and to a fresh upload."""
    rng = np.random.default_rng(6)
    truth = {
        "f32": rng.random(1000).astype(np.float32),
        "i32": (rng.random(700) * 100).astype(np.int32),
        "u8": (rng.random(300) * 2).astype(np.uint8),
    }
    m = DeviceMirror()
    first = m.sync(truth, None)
    assert all(t.device.type == "cuda" for t in first.values())
    truth["f32"][100:400] += 1.0  # a run of 300, given in two overlapping spans
    truth["f32"][5:9] -= 2.0
    truth["i32"][[3, 4, 600]] = -7
    truth["u8"][10:20] ^= 1
    spans = {"f32": [(100, 300), (250, 400), (5, 9), (6, 8), (5, 9)],
             "i32": [(3, 5), (3, 4), (600, 601)], "u8": [(10, 20)]}
    out = m.sync(truth, spans)
    assert m.full_uploads == 1 and m.slice_rows == 300
    assert m.delta_rows == 4 + 3 + 10
    for kind, t in out.items():
        assert t is first[kind]  # updated in place
        assert t.cpu().numpy().tobytes() == truth[kind].tobytes(), kind
        fresh = DeviceMirror().sync(truth, None)[kind]
        assert torch.equal(t, fresh), kind
    # a sparse part over half of u8 (two of every three): a full upload
    truth["u8"][np.arange(300) % 3 != 2] ^= 1
    out = m.sync(truth, {"u8": [(i, i + 2) for i in range(0, 300, 3)] * 2})
    assert m.full_uploads == 2
    assert out["u8"].cpu().numpy().tobytes() == truth["u8"].tobytes()


@pytest.mark.cuda
def test_card_stacked_solve_equals_per_shard_solves(cuda_device):
    """Each block of a stacked solve on the card is byte-identical to its
    own ``_packed_solve`` at the stack's trip count (48: pages of 48 and
    24 steps and two shards without one), and its integer outputs equal
    the CPU stack's."""
    problem = generate_problem(8, 2000, seed=41, task_group_fraction=0.3,
                               hosts_per_distro=3)
    subs, _ = build_sharded_snapshot(*problem, NOW, 4)
    add_capacity_page(subs[0], 48)
    add_capacity_page(subs[1], 24)
    blocks = {k: s.arrays for k, s in enumerate(subs)}
    got = StackedSolveCache().solve_blocks(blocks)
    cpu = StackedSolveCache("cpu").solve_blocks(blocks)
    for k, s in enumerate(subs):
        own = _packed_solve(s.arena.buffers, s.arena.layout_key(), 48,
                            cuda_device).cpu().numpy()
        own = split_outputs(own, s.shape_key())
        for name, w in own.items():
            assert got[k][name].tobytes() == w.tobytes(), (k, name)
            if w.dtype.kind == "i":
                np.testing.assert_array_equal(got[k][name], cpu[k][name])
            else:
                np.testing.assert_allclose(got[k][name], cpu[k][name],
                                           rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_card_two_call_program_is_the_fused_rung(cuda_device):
    """At config 3's padded D, ``run_capacity_solve`` on the card gives
    the packed solve's ``cap_x`` bit for bit (fused ≡ two-call), repeats
    byte for byte, launches ``segment_sum`` 2 + iterations times, and
    equals its CPU run (rtol 1e-5, atol 1e-6; targets exactly)."""
    snap = add_capacity_page(build_snapshot(*generate_problem(200, 50_000, seed=0), NOW))
    fused = extract_fused_view(snap, run_solve_packed(snap))
    inp = build_fused_inputs(fused)
    d_pad = fused["d_pad"]
    before = segment_sum.launches
    x = run_capacity_solve(inp, d_pad=d_pad)
    assert segment_sum.launches == before + 2 + inp.iterations
    assert x.tobytes() == fused["cap_x"][: inp.n].tobytes()
    assert x.tobytes() == run_capacity_solve(inp, d_pad=d_pad).tobytes()
    cpu = run_capacity_solve(inp, d_pad=d_pad, device="cpu")
    np.testing.assert_allclose(x, cpu, rtol=1e-5, atol=1e-6)
    card_t, _, card_chosen = solve_capacity_from_x(inp, x)
    cpu_t, _, cpu_chosen = solve_capacity_from_x(inp, cpu)
    np.testing.assert_array_equal(card_t, cpu_t)
    assert card_chosen == cpu_chosen


@pytest.mark.cuda
def test_card_tick_writes_the_cpu_documents(cuda_device, monkeypatch):
    """Two ``run_tick``s (the second after a churn) on a generated store
    with every distro opted into the capacity program, on the card and
    on the CPU: the same queue, task, host and event documents, the same
    result, and each solve tick launching 1 ``fused_distro_stats`` and
    5 + 48 ``segment_sum``."""
    import itertools
    import random
    import time
    import uuid

    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store

    distros, tbd, hbd, _, _ = generate_problem(12, 2_000, seed=4)
    stores = {}
    for key in ("cuda", "cpu"):
        store = stores[key] = Store()
        for d in distros:
            d = distro_mod.Distro.from_doc(d.to_doc())
            d.planner_settings.capacity = "tpu"
            distro_mod.insert(store, d)
        task_mod.insert_many(store, [t for ts in tbd.values() for t in ts])
        for hs in hbd.values():
            host_mod.insert_many(store, hs)
        CapacityConfig(pool_quotas={"mock": 300}, fleet_intent_budget=40).set(store)
    monkeypatch.setattr(time, "time", lambda: NOW)
    seqs = {k: itertools.count() for k in stores}
    for k, now in enumerate((NOW, NOW + 15)):
        results = {}
        for key, store in stores.items():
            if k == 1:
                tasks = store.collection("tasks")
                for doc in tasks.find()[::17]:
                    tasks.update(doc["_id"], {"status": "dispatched"})
            rng = random.Random(k)
            monkeypatch.setattr(uuid, "uuid4",
                                lambda rng=rng: uuid.UUID(int=rng.getrandbits(128)))
            monkeypatch.setattr(event_mod, "_SEQ", seqs[key])
            fds0, ss0 = fused_distro_stats.launches, segment_sum.launches
            results[key] = wrapper.run_tick(store, wrapper.TickOptions(), now=now,
                                            device=None if key == "cuda" else "cpu")
            if key == "cuda":
                assert (fused_distro_stats.launches - fds0,
                        segment_sum.launches - ss0) == (1, 53)
        r, c = results["cuda"], results["cpu"]
        assert r.planner_used == c.planner_used == "tpu" and r.degraded == ""
        assert (r.queues, r.new_hosts, r.shed) == (c.queues, c.new_hosts, c.shed)
        assert r.intent_hosts and [h.to_doc() for h in r.intent_hosts] == [
            h.to_doc() for h in c.intent_hosts]
        for name in ("task_queues", "tasks", "hosts", "events"):
            assert stores["cuda"].collection(name).find() == (
                stores["cpu"].collection(name).find()), name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["distro_stats", "segment"])
def test_card_tick_raises_a_failed_launch(kernel, cuda_device, monkeypatch):
    """A kernel launch that returns a CUDA error raises ``KernelError``
    out of ``run_tick``: the tick does not fall back to the serial
    oracle on the host, and its solve breaker records no failure."""
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.ops import _build, distro_stats, segment
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.storage.store import Store

    distros, tbd, _, _, _ = generate_problem(4, 200, seed=2)
    store = Store()
    for d in distros:
        distro_mod.insert(store, d)
    task_mod.insert_many(store, [t for ts in tbd.values() for t in ts])
    # cudaErrorLaunchFailure
    monkeypatch.setattr({"distro_stats": distro_stats, "segment": segment}[kernel],
                        "_launch_fn", lambda: (lambda *args: 719))
    with pytest.raises(_build.KernelError, match="cudaError_t 719"):
        wrapper.run_tick(store, wrapper.TickOptions(), now=NOW)
    assert wrapper.solve_breaker_for(store)._consecutive_failures == 0
    assert store.collection("task_queues").find() == []


#: what two runs of one tick cannot agree on in a span document: its ids
#: (each process numbers its spans), times and thread, and the time
#: attributes
_SPAN_MASK = ("_id", "parent", "trace_root", "started_at", "duration_ms", "thread")
_SPAN_TIMES = ("snapshot_ms", "solve_ms", "total_ms")


def _canon_span(doc):
    """A span document with ``_SPAN_MASK`` and the time attributes
    masked; any other document as it is."""
    if "trace_root" not in doc:
        return doc
    return dict({k: v for k, v in doc.items() if k not in _SPAN_MASK},
                attributes={k: v for k, v in doc["attributes"].items()
                            if k not in _SPAN_TIMES})


def _tick_store(distros, tbd, hbd):
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.storage.store import Store

    store = Store()
    for d in distros:
        distro_mod.insert(store, d)
    task_mod.insert_many(store, [t for ts in tbd.values() for t in ts])
    for hs in hbd.values():
        host_mod.insert_many(store, hs)
    return store


@pytest.mark.cuda
def test_card_warm_ticks_write_the_cpu_documents(cuda_device):
    """The service's tick (``use_cache=True``: the TickCache and the
    resident plane, published through the device mirror) on the card and
    on the CPU, three ticks with churn between them: the same queue and
    task documents and results, each solve launching one
    ``fused_distro_stats`` on the slab layout, no resident fallback, and
    the card plane's snapshot buffers on the card."""
    from evergreen_tpu_torch.scheduler import resident, wrapper

    problem = generate_problem(12, 2_000, seed=6, task_group_fraction=0.3,
                               dep_fraction=0.3)
    stores = {"cuda": _tick_store(*problem[:3]), "cpu": _tick_store(*problem[:3])}
    opts = wrapper.TickOptions(use_cache=True, create_intent_hosts=False)
    for k, now in enumerate((NOW, NOW + 15, NOW + 30)):
        results = {}
        for key, store in stores.items():
            if k:
                tasks = store.collection("tasks")
                for doc in tasks.find()[k::23]:
                    tasks.update(doc["_id"], {"status": "success"})
            before = fused_distro_stats.launches
            results[key] = wrapper.run_tick(store, opts, now=now,
                                            device=None if key == "cuda" else "cpu")
            if key == "cuda":
                assert fused_distro_stats.launches - before == 1
        assert results["cuda"].queues == results["cpu"].queues
        assert results["cuda"].planner_used == "tpu" and results["cuda"].degraded == ""
        for name in ("task_queues", "tasks"):
            assert stores["cuda"].collection(name).find() == (
                stores["cpu"].collection(name).find()), name
    planes = {k: resident.peek_resident_plane(s) for k, s in stores.items()}
    assert planes["cuda"].device.type == "cuda" and planes["cpu"].device.type == "cpu"
    stats = {k: {n: v for n, v in p.stats().items() if not n.startswith("mirror")}
             for k, p in planes.items()}
    assert stats["cuda"] == stats["cpu"] and stats["cuda"]["fallbacks"] == 0
    assert planes["cuda"].stats()["mirror_full_uploads"] >= 1


@pytest.mark.cuda
def test_card_warm_tick_raises_a_failed_mirror_upload(cuda_device, monkeypatch):
    """A mirror upload that fails on the card raises ``MirrorError`` out
    of the warm ``run_tick``: no serial tick, no host rebuild, no solve
    breaker failure, no queue written."""
    from evergreen_tpu_torch.ops import resident_ops
    from evergreen_tpu_torch.scheduler import wrapper

    distros, tbd, hbd, _, _ = generate_problem(4, 200, seed=2)
    store = _tick_store(distros, tbd, hbd)

    def broken(buf, dev):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(resident_ops, "_upload", broken)
    with pytest.raises(resident_ops.MirrorError, match="illegal memory access"):
        wrapper.run_tick(store, wrapper.TickOptions(use_cache=True), now=NOW)
    assert wrapper.solve_breaker_for(store)._consecutive_failures == 0
    assert store.collection("task_queues").find() == []


@pytest.mark.cuda
def test_card_durable_async_tick_writes_the_cpu_documents(cuda_device, tmp_path,
                                                          monkeypatch):
    """The service's tick on a ``DurableStore`` under a lease
    (``use_cache=True, async_persist=True``) on the card and on the CPU,
    two ticks with a churn: the same documents, one WAL group frame a
    tick with the same records; then the card store's lease is stolen,
    and its fenced tick launches no kernel, writes no WAL byte and drops
    the resident plane and the mirror's buffers."""
    import json
    import os
    import time

    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.scheduler import resident, wrapper
    from evergreen_tpu_torch.storage.durable import WAL_FILE, DurableStore
    from evergreen_tpu_torch.storage.lease import FileLease

    distros, tbd, hbd, _, _ = generate_problem(12, 2_000, seed=6)
    stores, leases = {}, {}
    for key in ("cuda", "cpu"):
        d = str(tmp_path / key)
        lease = leases[key] = FileLease(os.path.join(d, "writer.lease"), ttl_s=60.0)
        assert lease.try_acquire()
        store = stores[key] = DurableStore(d, lease=lease)
        for dist in distros:
            distro_mod.insert(store, dist)
        task_mod.insert_many(store, [t for ts in tbd.values() for t in ts])
        for hs in hbd.values():
            host_mod.insert_many(store, hs)

    def frames(key):
        """The group frames' records: events without their documents,
        span documents masked (``_canon_span``), and no ``arena_lease``
        span (the CPU publish leases an arena, the card's mirror none)."""
        with open(os.path.join(str(tmp_path / key), WAL_FILE)) as fh:
            recs = [json.loads(line) for line in fh]
        return [[{k: (_canon_span(v) if k == "d" else v) for k, v in r.items()
                  if k != "d" or r["c"] != "events"}
                 for r in f["rs"]
                 if not (r["c"] == "spans" and r["d"]["name"] == "arena_lease")]
                for f in recs if f["o"] == "g"]

    opts = wrapper.TickOptions(use_cache=True, async_persist=True,
                               create_intent_hosts=False)
    real_time = time.time
    monkeypatch.setattr(time, "time", lambda: NOW)
    for k, now in enumerate((NOW, NOW + 15)):
        results = {}
        for key, store in stores.items():
            if k:
                tasks = store.collection("tasks")
                for doc in tasks.find()[::23]:
                    tasks.update(doc["_id"], {"status": "success"})
            before = fused_distro_stats.launches
            results[key] = wrapper.run_tick(store, opts, now=now,
                                            device=None if key == "cuda" else "cpu")
            if key == "cuda":
                assert fused_distro_stats.launches - before == 1
            store.sync_persist()
        assert results["cuda"].queues == results["cpu"].queues
        assert results["cuda"].degraded == "" and results["cuda"].planner_used == "tpu"
        for name in ("task_queues", "tasks"):
            assert stores["cuda"].collection(name).find() == (
                stores["cpu"].collection(name).find()), name
    assert len(frames("cuda")) == 2 and frames("cuda") == frames("cpu")
    # the steal reads the wall clock against the lease's stamp
    monkeypatch.setattr(time, "time", real_time)
    thief = FileLease(leases["cuda"].path, ttl_s=60.0)
    thief.ttl_s = -1.0
    assert thief.try_acquire()
    wal = os.path.join(str(tmp_path / "cuda"), WAL_FILE)
    size = os.path.getsize(wal)
    launches = (fused_distro_stats.launches, segment_sum.launches)
    res = wrapper.run_tick(stores["cuda"], opts, now=NOW + 30)
    assert res.degraded == "fenced" and res.queues == {}
    assert (fused_distro_stats.launches, segment_sum.launches) == launches
    assert os.path.getsize(wal) == size
    plane = resident.peek_resident_plane(stores["cuda"])
    assert plane._pending_reason == "fenced" and plane._mirror._bufs is None


def test_entry_points_need_a_card_unless_cpu(tmp_path):
    """``SolverService``, ``StackedSolveCache``, ``DeviceMirror.sync``
    and ``SolverClient``'s local fallback run on the card by default and
    raise without one; ``device="cpu"`` runs them on the CPU."""
    truth = {"f32": np.zeros(4, np.float32)}
    snap = build_snapshot(*generate_problem(3, 40, seed=1), NOW)
    client = SolverClient(str(tmp_path), 0)
    cpu_client = SolverClient(str(tmp_path), 1, device="cpu")
    try:
        if torch.cuda.is_available():
            svc = SolverService(str(tmp_path), 2)
            assert svc.device.type == "cuda"
            assert StackedSolveCache().device.type == "cuda"
            assert DeviceMirror().sync(truth, None)["f32"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                SolverService(str(tmp_path), 2)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                StackedSolveCache()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DeviceMirror().sync(truth, None)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                client.solve_fn(1, 1, 0.05)(snap)
            assert client.fallbacks == {"timeout": 1}
        assert SolverService(str(tmp_path), 2, device="cpu").device.type == "cpu"
        assert DeviceMirror(device="cpu").sync(truth, None)["f32"].device.type == "cpu"
        out = cpu_client.solve_fn(1, 1, 0.05)(snap)
        want = run_solve_packed(snap, device="cpu")
        assert all(out[n].tobytes() == want[n].tobytes() for n in want)
    finally:
        client.close(unlink=True)
        cpu_client.close(unlink=True)


@pytest.mark.cuda
def test_launch_counts_are_exact_under_threads(cuda_device):
    """Sixteen threads launching ``fused_distro_stats`` and
    ``segment_sum`` at once (as the sharded plane's shard ticks do),
    switching as often as the interpreter allows, leave exact counts, in
    all and per plan. The lock around each increment is defensive: CPython
    3.12 switches threads only at calls and backward jumps, not between
    the load, add and store of ``+= 1`` on a function attribute, so this
    holds the counts exact without reproducing a loss."""
    import sys
    import threading

    cols, offs, th, _ = ragged_case(3)
    args = torch_args(cols, offs, th, cuda_device)
    seg = torch.as_tensor(np.random.default_rng(1).integers(0, 50, 4096)).to(cuda_device)
    plan = segment_plan(seg, 50, name="threads")
    x = torch.rand(2, 4096, device=cuda_device)
    fused_distro_stats(*args)
    segment_sum(x, plan)
    torch.cuda.synchronize()
    n_threads, per_thread = 16, 200
    fused_distro_stats.launches = 0
    segment_sum.launches = 0
    segment_sum.launches_by_plan.clear()
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(per_thread):
            fused_distro_stats(*args)
            segment_sum(x, plan)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    want = n_threads * per_thread
    assert fused_distro_stats.launches == want
    assert segment_sum.launches == want
    assert segment_sum.launches_by_plan == {"threads": want}


def _plane_store_docs(plane):
    """Each shard store's written documents, with the intents' and
    events' ids (which depend on how the shard threads interleave)
    canonicalised."""
    out = []
    for s in plane.stores:
        docs = {}
        for c in ("task_queues", "task_secondary_queues", "tasks", "hosts", "events"):
            rows = []
            for d in s.collection(c).find():
                d = dict(d)
                if d["_id"].startswith("evt-"):
                    d["_id"] = "evt"
                elif d["_id"].startswith("evg-") and d.get("status") == "initializing":
                    d["_id"], d["secret"] = d["_id"].rsplit("-", 1)[0], ""
                rows.append(d)
            docs[c] = rows
        out.append(docs)
    return out


def _card_planes(problem, card_stacked, intents=True):
    from evergreen_tpu_torch.scheduler.sharded_plane import ShardedScheduler
    from evergreen_tpu_torch.scheduler.wrapper import TickOptions
    from evergreen_tpu_torch.settings import CapacityConfig

    src = _tick_store(*problem[:3])
    planes = {}
    for key, device, stacked in (("cuda", None, card_stacked), ("cpu", "cpu", "never")):
        plane = planes[key] = ShardedScheduler.build(
            2, device=device, stacked=stacked, rebalance_enabled=False,
            tick_opts=TickOptions(use_cache=True, create_intent_hosts=intents))
        plane.seed_partition(src)
        for s in plane.stores:
            CapacityConfig(pool_quotas={"mock": 300}, fleet_intent_budget=40).set(s)
            for d in s.collection("distros").find():
                ps = dict(d["planner_settings"], capacity="tpu")
                s.collection("distros").update(d["_id"], {"planner_settings": ps})
    return planes


@pytest.mark.cuda
def test_card_stacked_round_writes_the_cpu_plane_documents(cuda_device, monkeypatch):
    """A 2-shard plane stacking on the card (``stacked="always"``) and a
    local plane on the CPU, three rounds with a churn: the same
    documents in every shard store after every round, round 1 local and
    then stacked, each stacked round launching ``fused_distro_stats``
    once per block."""
    import time

    problem = generate_problem(12, 2_000, seed=8)
    planes = _card_planes(problem, "always")
    try:
        modes = []
        for k, now in enumerate((NOW, NOW + 15, NOW + 30)):
            # intent creation times read the clock
            monkeypatch.setattr(time, "time", lambda now=now: now)
            for key, plane in planes.items():
                if k == 1:
                    for s in plane.stores:
                        tasks = s.collection("tasks")
                        for doc in tasks.find()[::17]:
                            tasks.update(doc["_id"], {"status": "dispatched"})
                before = fused_distro_stats.launches
                res = plane.tick(now=now)
                if key == "cuda":
                    modes.append(res.solve_mode)
                    assert fused_distro_stats.launches - before == 2
                assert not res.degraded
            assert _plane_store_docs(planes["cuda"]) == _plane_store_docs(planes["cpu"]), k
        assert modes[:2] == ["local", "stacked"]
    finally:
        for plane in planes.values():
            plane.close()


@pytest.mark.cuda
def test_card_stacked_round_raises_a_failed_launch(cuda_device, monkeypatch):
    """A kernel launch that fails inside the stacked solve raises
    ``KernelError`` out of ``ShardedScheduler.tick()``; no shard falls
    back to a local solve or the serial oracle."""
    from evergreen_tpu_torch.ops import _build, distro_stats
    from evergreen_tpu_torch.scheduler import sharded_plane, wrapper

    problem = generate_problem(8, 800, seed=9)
    planes = _card_planes(problem, "always", intents=False)
    plane = planes["cuda"]
    try:
        assert plane.tick(now=NOW).solve_mode == "local"
        assert plane.tick(now=NOW + 15).solve_mode == "stacked"
        local = []
        real = sharded_plane.run_solve_packed
        monkeypatch.setattr(sharded_plane, "run_solve_packed",
                            lambda *a, **k: local.append(1) or real(*a, **k))
        monkeypatch.setattr(distro_stats, "_launch_fn", lambda: (lambda *args: 719))
        with pytest.raises(_build.KernelError, match="cudaError_t 719"):
            plane.tick(now=NOW + 30)
        assert local == []
        for s in plane.stores:
            assert wrapper.solve_breaker_for(s)._consecutive_failures == 0
    finally:
        for p in planes.values():
            p.close()


def _seed_fleet_dir(data_dir, n_shards, problem):
    """``problem`` over ``n_shards`` shard segments at epoch 0, each distro
    in the capacity program (a small quota and budget per shard)."""
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.scheduler.sharded_plane import ShardedScheduler
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.store import Store

    distros, tbd, hbd, _, _ = problem
    src = Store()
    for d in distros:
        distro_mod.insert(src, d)
        ps = dict(distro_mod.coll(src).get(d.id)["planner_settings"], capacity="tpu")
        distro_mod.coll(src).update(d.id, {"planner_settings": ps})
    task_mod.insert_many(src, [t for ts in tbd.values() for t in ts])
    for hs in hbd.values():
        host_mod.insert_many(src, hs)
    plane = ShardedScheduler([DurableStore(data_dir, shard_id=k) for k in range(n_shards)],
                             device="cpu", stacked="never")
    plane.seed_partition(src)
    for s in plane.stores:
        CapacityConfig(pool_quotas={"mock": 60}, fleet_intent_budget=8).set(s)
    plane.close()


@pytest.mark.cuda
def test_card_process_fleet_writes_the_cpu_documents(cuda_device, tmp_path):
    """A two-shard process fleet on the card (``FleetSupervisor(...,
    solver="always")``: two worker processes on the card, the leader
    here) and the same fleet on the CPU, two rounds with the service's
    options: every shard's documents equal (intent and event ids,
    intents' secrets and creation times aside; span documents masked by
    ``_canon_span``), and the fleet's launches
    — the leader's here, the workers' from their ``status`` — are one
    ``fused_distro_stats`` per block solved on the card."""
    import json

    from evergreen_tpu_torch.runtime.supervisor import FleetSupervisor
    from evergreen_tpu_torch.storage.durable import DurableStore

    def canon(doc):
        if "payload" in doc:
            return dict(doc, payload={c: [canon(d) for d in ds]
                                      for c, ds in doc["payload"].items()})
        if "trace_root" in doc:
            return _canon_span(doc)
        if doc["_id"].startswith("evt-"):
            return dict(doc, _id="evt")
        if doc["_id"].startswith("evg-") and doc.get("status") == "initializing":
            return dict(doc, _id=doc["_id"].rsplit("-", 1)[0], secret="",
                        creation_time=0.0)
        return doc

    problem = generate_problem(8, 1_600, seed=9)
    docs, launches = {}, {}
    for key, device in (("cuda", None), ("cpu", "cpu")):
        d = str(tmp_path / key)
        _seed_fleet_dir(d, 2, problem)
        sup = FleetSupervisor(d, 2, ttl_s=2.0, hb_interval_s=0.5, hb_deadline_s=10.0,
                              recovery_anchor=NOW, solver="always", device=device)
        before = fused_distro_stats.launches
        try:
            sup.start()
            solves = []
            for r in range(2):
                res = sup.round(now=NOW + 15.0 * (r + 1))
                assert sorted(res) == [0, 1]
                assert all(v["degraded"] == "" for v in res.values())
                solves += [v["solve"] for v in res.values()]
            st = sup.statuses()
            launches[key] = (fused_distro_stats.launches - before + sum(
                v["launches"]["fused_distro_stats"] for v in st.values()), solves)
        finally:
            sup.stop()
        stores = [DurableStore(d, shard_id=k) for k in range(2)]
        for s in stores:
            s._journal.close()
        docs[key] = [json.dumps({n: [canon(x) for x in s.collection(n).find()]
                                 for n in sorted(s._collections) if len(s.collection(n))},
                                sort_keys=True, default=str) for s in stores]
    assert docs["cuda"] == docs["cpu"]
    n, solves = launches["cuda"]
    assert n == len(solves) == 4 and set(solves) <= {"stacked", "local"}
    assert launches["cpu"][0] == 0


@pytest.mark.cuda
def test_card_cron_round_writes_the_cpu_documents(cuda_device, monkeypatch):
    """One cron round of the job plane (``Environment.build`` on a
    caller's store, one worker, ``cron_runner.tick(force=True)``) on the
    card and on the CPU, each on its own uuid4 stream and event sequence
    under one pinned clock: every job completed, the tick job planned by
    the card with its kernels launched once, and every document equal
    (span ids, times and threads masked; a system sample's process
    readings and a runtime-stats record's wall times too)."""
    import itertools
    import random
    import time
    import uuid

    from evergreen_tpu_torch.cloud.mock import MockCloudManager
    from evergreen_tpu_torch.env import Environment
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.storage.store import Store

    distros, tbd, hbd, _, _ = generate_problem(12, 2_000, seed=6)
    monkeypatch.setattr(time, "time", lambda: NOW)
    docs = {}
    for key in ("cuda", "cpu"):
        rng = random.Random(99)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128)))
        monkeypatch.setattr(event_mod, "_SEQ", itertools.count())
        MockCloudManager.reset()
        store = Store()
        for dist in distros:
            distro_mod.insert(store, dist)
        task_mod.insert_many(store, [t for ts in tbd.values() for t in ts])
        for hs in hbd.values():
            host_mod.insert_many(store, hs)
        env = Environment.build(store=store, workers=1,
                                device=None if key == "cuda" else "cpu")
        try:
            before = fused_distro_stats.launches
            assert env.cron_runner.tick(force=True) == 16
            assert env.queue.wait_idle(120.0)
            if key == "cuda":
                assert fused_distro_stats.launches - before == 1
        finally:
            env.close()
        assert {d["status"] for d in store.collection("jobs").find()} == {"completed"}
        tick = [s for s in store.collection("spans").find() if s["name"] == "tick"][-1]
        assert (tick["attributes"]["planner_used"], tick["attributes"]["degraded"]) == (
            "tpu", "")
        masks = {"system_stats": ("max_rss_kb", "cpu_user_s"),
                 "log_lines": ("snapshot_ms", "solve_ms", "total_ms", "gauges")}
        docs[key] = {
            n: [_canon_span(d) if n == "spans" else
                {k: v for k, v in d.items() if k not in masks.get(n, ())}
                for d in store.collection(n).find()
                if n != "spans" or d["name"] != "arena_lease"]
            for n in sorted(store._collections)}
    MockCloudManager.reset()
    assert docs["cuda"] == docs["cpu"]
