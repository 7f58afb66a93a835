#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (evergreen_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile OUT_DIR | --sweep]

from the root of a checkout; it needs one card. Phases (any failure
raises and exits non-zero):

1. card and build: the card's name and power limit, then every kernel of
   the solve built from csrc/ (one nvcc per source, in parallel); the SM
   clock the chain bounds use, and the launch floor (the device time of
   a one-element ``add_``);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the solve gives it on BASELINE config 3 (200 distros × 50k
   tasks × 4,000 hosts) and on ragged cases — ``segment_sum`` on each of
   its three plans at one and two columns, bit-equal to the CPU; then
   its device time, the plain version's, one PyTorch library call's
   (torch.profiler), the plan build's, and the bound: the larger of the
   byte, operation and (for ordered sums) chain bounds;
3. the main path at config 3 (seed 0, seed 0 with a capacity page,
   seed 1): ``run_solve_packed`` on the card, then the same three
   problems as requests to the solver sidecar
   (``serve_background(device="cuda")``) — each reply byte-identical to
   the library call, the integer outputs equal to the port's own CPU
   run, the f32 outputs within their tolerances, and each kernel
   launched exactly as often as the solves call it (in all, and per
   segment plan); then request and solve times and a profile of each
   solve (a chrome trace in OUT_DIR with ``--profile``);
4. stacked rounds: config 3, seed 0, split over four shards by
   ``build_sharded_snapshot`` (cold, and warm with memos: byte-identical),
   one shard with a 48-step capacity page, one with 24, two with none.
   ``StackedSolveCache().solve_blocks`` on the card, each block
   byte-identical to its shard's ``_packed_solve`` at the stack's 48
   steps, integer outputs equal to the CPU stack, and both kernels held
   against their plain versions on each block as in phase 2; then one
   round served by a ``SolverService`` on the card to four
   ``SolverClient``s in ``spawn`` worker processes, three more to them
   and three to clients in threads (seven each until phase 11 needed the
   time), every
   round and client "stacked", every block byte-identical to the
   in-process stack, each round launching 4 ``fused_distro_stats`` and
   4 × (5 + 48) ``segment_sum``; ``serve_round`` wall times, beside the
   in-process stack's and four sequential ``run_solve_packed``;
5. the device mirror: config 3, seed 0, through a churn sequence (a cold
   sync, a tick's time refresh, scattered rows, a step whose sparse part
   covers over half of the f32 buffer, a change of layout), with the
   spans taken by diffing the host buffers; after each step the mirror
   is byte-identical to the host truth, the solve fed from it
   byte-identical to a fresh upload's and launching its kernels once,
   and the counters are as the spans predict; H2D bytes per step;
6. the tick's planning half from a store: config 3, seed 0, inserted
   into the port's ``Store`` with every distro opted into the capacity
   program (quota 5,400 mock hosts, fleet intent budget 500); the chain
   of the tick (intent budget, capacity page, ``build_snapshot``,
   ``_solve_bounded``, ``_unpack_solve``, the alias and single-task
   rules, ``CapacityPlane.apply``) on the card with ``fused="auto"``,
   then twice with ``fused="two_call"`` (once under a solve deadline),
   each run equal to the same chain on the CPU (every float exact but
   the capacity relaxation's ``fractional``), planned by the device
   solve with no fallback counter moving and its kernel launches exact;
   the fused and two-call runs give the same targets, and the two-call
   runs are byte-identical; then wall times of each step and of
   ``run_capacity_solve`` alone;
7. the whole tick from a store: config 3, seed 0, with phase 6's
   capacity settings, in a store for the card and one for the CPU;
   ``run_tick`` at a fixed ``now``, a churn of a few hundred tasks
   (dispatched, finished, new, re-prioritised), ``run_tick`` at
   ``now + 15``, then one tick with a fault at ``scheduler.solve`` and
   one with the solve breaker held open. After each tick every document
   the tick writes (queues, secondary queues, tasks, hosts with the
   intents, events, shed records) equals the CPU's, as do the
   ``TickResult`` counts and the persister's write shapes; the solve
   ticks are planned by the card with no degradation and launch exactly
   1 ``fused_distro_stats`` and 53 ``segment_sum`` each, the two
   degraded ticks fall back to the serial oracle and launch nothing.
   Intent ids and secrets (``uuid.uuid4``), intent creation times
   (``time.time``) and event ids are made the same for both stores;
   then the wall time of each phase of the two solve ticks, and the
   garbage collector's share of it. Each tick follows a full
   ``gc.collect()``, and the phase runs again on fresh stores with the
   CPU's store ticked first at each step, its two solve ticks only;
8. the service's tick (``TickOptions(use_cache=True)``): config 3 in
   three stores (warm on the card, warm on the CPU, cold on the card),
   five ticks with churn, a solve fault and a distro-set change, every
   document equal across the stores after each (``service_phase``);
9. the sharded plane: config 3 split by ``seed_partition`` over four
   shard stores on the one card, in three planes — (a) on the card with
   ``stacked="always"`` (every block of a round in one stacked solve),
   (b) on the card with ``stacked="auto"`` (local on one card: each
   shard ticks through its own resident plane and mirror), (c) on the
   CPU with ``stacked="never"`` — for four rounds (prime, churn, shard
   0 held at YELLOW so one affinity group migrates, and the round after
   the handoff, whose card planes tick under torch.profiler: device busy
   time, idle share and the host's time in CUDA synchronisation; two
   quiet rounds before the profiled one were cut to make room for phase
   10, and the quiet round before the YELLOW one for phase 11). After each round every shard store's
   documents are equal across the planes (intent and event ids
   canonicalised: which shard's tick draws which id depends on thread
   order), no document has two owners, the migrations are equal, plane
   (a)'s mode is ``PLANE_A_MODES``'s (round 1 local, round 2 stacked or
   local where some shard's dims outgrew the floor, stacked from round
   3 on), and each plane launched the kernels once per block solved;
   then, without
   intents, a fresh plane (a)'s merged queues equal a single store's
   card tick, and a failed launch inside its stacked solve raises out of
   ``tick()`` with no local solve;
10. the service's tick as ``units/crons.py`` runs it
   (``TickOptions(use_cache=True, async_persist=True,
   solve_deadline_s=10.0, tick_budget_s=12.0)``) on durable stores
   (``durable_phase``): config 3 less ``d199`` in (a) a ``DurableStore``
   on the card under a renewing ``FileLease``, (b) the same on the CPU,
   (c) the in-memory card store of phase 8; ticks prime, churn, quiet,
   after each every document equal across the three, one WAL group
   frame a tick in (a) and (b) with equal records; then (a)'s and (b)'s
   directories copied without closing (a crash) and replayed, a churn
   tick on (a)'s copy on the card (a cold plane, a full mirror upload),
   on (b)'s on the CPU and on (a), (b), (c): a replayed store's fresh
   persister rewrites the queue documents a live one skips, so the two
   copies are held equal with every field and WAL record, and to the
   live stores without the queue documents' write stamps; a copy whose
   WAL is cut inside tick 4's frame reopens to (a) before tick 4; a
   thief takes (a)'s lease, (a)'s tick is ``"fenced"`` (no launch, no
   WAL byte, no document changed, the plane dropped), and the thief's
   store ticks on the card beside (b) and (c), held to them without the
   queue documents' write stamps (its persister is fresh), then
   checkpoints (the thief's CPU twin on a copy of (b)'s directory was
   cut when phase 11 needed the time); then a
   durable fleet (``ShardedScheduler.build(4, data_dir=...,
   stacked="always")`` on the card, its modes held as plane (a)'s)
   against an in-memory CPU plane, four rounds (a handoff in the
   third), a crash copy reopened by ``open_fleet`` on the card (its CPU
   twin was cut for phase 11's time), and a fifth round, documents
   equal; prints every tick's
   phases with ``wal_commit``, the frame writes, the barrier waits, WAL
   bytes, replay, checkpoint and ``open_fleet`` ms;
11. the process-per-shard fleet (``process_fleet_phase``): config 3
   seeded over four shard segments at epoch 0 (each shard a quarter of
   phase 6's quota and intent budget) with a churn written without a
   lease that each recovery step acts on (benchgen's phantom
   ``running_task`` claims, tasks in flight on hosts with stale
   heartbeats, gone or terminated, mock hosts building);
   ``FleetSupervisor(..., solver="always")`` on the card spawns four
   ``runtime/worker.py`` processes on it (lease, replay, recovery pass,
   hello at epoch 1) and leads their stacked solves; six rounds with the
   service's options: prime, two quiet rounds, ``migrate`` over the
   control protocol, the round after it, shard 2 drained and SIGKILLed,
   the watchdog's restart at epoch 2 (replay and recovery again), two
   more rounds, ``stop(graceful=True)``. Checked: the epochs, each
   recovery's counts against a CPU twin (the same sequence in-process in
   a process of its own on a copy of the seeded directory), the modes
   (``PROC_MODES``), the leader's launches per stacked block and each
   worker's per local solve (its ``status`` counters, the killed worker's
   read before the kill), every shard's documents against the twin's,
   one owner per document, every lease released; prints the start, each
   recovery, each round and shard tick, the leader's serves, the
   takeover and the stop in ms;
12. a JSON line of the kernels (launches: phases 7–11, by path; the
   other phases check theirs on lines of their own), the card's line,
   and the last line ``{"ok": true, "device": {...}}``.

Before phase 1 the backend probe (``utils/torchenv.py``) must find the
card from a fresh interpreter.

``--sweep`` runs phase 1, then, instead of the rest, times both kernels
built with other values of their design constants (``sweep``) and
prints the card's line.

Imports only the port, torch, numpy and the standard library.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM: HBM rate and the f32 rate outside the tensor cores
#: (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: cycles from one dependent f32 add to the next on an SM; an ordered
#: sum of L elements takes at least L of them
FADD_CYCLES = 4

SEED = 0
CONFIG3 = (200, 50_000)
#: shards of the stacked rounds, their capacity pages (steps; 0 = none)
#: and the rounds served to the worker processes after the first and to
#: clients in threads (three since phase 11 came: seven before)
SHARDS = 4
SHARD_PAGES = (48, 24, 0, 0)
THREAD_ROUNDS = 3
ROUND_TIMEOUT_S = 90.0
SUM_RTOL = 1e-5
#: the capacity relaxation (Newton steps with pow and division) and the
#: affinity block are the only f32 outputs the card may round otherwise
#: than the CPU; every duration sum is added in element order on both
CAP_TOL = dict(rtol=1e-5, atol=1e-6)
F32_TOL = {"cap_x": CAP_TOL, "aff_pool": CAP_TOL}

#: ``--sweep``: builds of each kernel with other values of its design
#: constants, the source's own values first. segment_sum's staging holds
#: a piece and one window past it (piece + threads elements) in one
#: round of threads × stage-unroll gathers and in a quarter of its tile
#: (the source's static_assert), which leaves out larger pieces.
DS_VARIANTS = [dict(DISTRO_STATS_THREADS=t, DISTRO_STATS_UNROLL=u)
               for t, u in ((64, 8), (32, 8), (128, 8), (256, 8), (64, 4), (64, 16))]
SS_VARIANTS = [dict(SEGMENT_SUM_THREADS=t, SEGMENT_SUM_PIECE=p,
                    SEGMENT_SUM_STAGE_UNROLL=u, SEGMENT_SUM_WALK_DEPTH=w)
               for t, p, u, w in (
                   (256, 512, 3, 2), (256, 512, 4, 4), (256, 1024, 8, 4), (256, 512, 8, 4),
                   (256, 1536, 8, 4), (256, 1024, 16, 4), (128, 512, 8, 4), (128, 1024, 16, 4),
                   (256, 1024, 8, 1), (256, 1024, 8, 2), (256, 1024, 8, 8), (256, 512, 3, 4),
                   (256, 768, 4, 4), (256, 256, 2, 4), (256, 256, 4, 4), (128, 256, 4, 4),
                   (128, 384, 4, 4), (256, 512, 4, 2), (256, 512, 4, 8), (256, 256, 2, 2),
                   (256, 768, 4, 2), (256, 1024, 5, 4), (256, 1280, 6, 4), (256, 512, 3, 1))]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_cuda(torch, fn, reps: int = 21, inner: int = 20) -> float:
    """Median ms of one call of ``fn`` on the card: ``inner`` calls back to
    back between two CUDA events, ``reps`` times."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 50) -> float:
    """Device time of one call of ``fn``: the summed durations of every
    kernel, copy and memset it puts on the card, from torch.profiler over
    ``calls`` calls, divided by ``calls``. Host time between launches is
    not counted (``time_cuda`` counts it). A profile that sees no device
    work at all (it happened once in a sweep's long run of profiles) is
    taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / calls / 1e3
    raise AssertionError("the profiler saw no device time")


def measure(torch, kernel, plain, library) -> dict:
    """Device ms per call of the kernel's wrapper, its plain version and
    the library call, plus the wrapper's ms per call back to back."""
    return dict(
        ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
        library_ms=device_ms(torch, library), call_ms=time_cuda(torch, kernel),
    )


def bounds(bytes_: int, ops: int, chain_ms) -> dict:
    """The least time of the work: bytes over the HBM rate, operations
    over the f32 rate and, where the function's adds must form one ordered
    chain, ``chain_ms``; ``bound_ms`` is the largest, ``bound_by`` names it."""
    cands = {"bytes": 1e3 * bytes_ / HBM_BYTES_PER_S,
             "operations": 1e3 * ops / F32_OPS_PER_S}
    if chain_ms is not None:
        cands["chain"] = chain_ms
    by = max(cands, key=cands.get)
    return dict(bound_ms=cands[by], bound_by=by, byte_bound_ms=cands["bytes"],
                chain_bound_ms=chain_ms)


def fmt_row(r: dict) -> str:
    chain = ("none" if r["chain_bound_ms"] is None
             else f"{r['chain_bound_ms'] * 1e3:.3f} us")
    return (f"device time per call {r['ms'] * 1e3:.2f} us kernel, "
            f"{r['plain_ms'] * 1e3:.2f} us plain, {r['library_ms'] * 1e3:.2f} us "
            f"library; bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}; "
            f"bytes {r['byte_bound_ms'] * 1e3:.3f} us, chain {chain}); kernel "
            f"calls back to back {r['call_ms'] * 1e3:.2f} us each (host included)")


def ragged_cases(np):
    """Distro sizes that land on and around 1024-task tile edges and the
    kernel's warp and stride edges, empty distros, random sizes, and one
    distro owning 3·1024+17 tasks."""
    rng = np.random.default_rng(99)
    counts = np.array([0, 1, 31, 32, 33, 250, 257, 3 * 1024 + 17, 0])
    n = int(counts.sum())
    cases = [(counts, dict(
        t_valid=rng.random(n) < 0.9, t_deps_met=rng.random(n) < 0.7,
        t_expected_s=(rng.random(n) * 100).astype(np.float32),
        t_wait_dep_met_s=(rng.random(n) * 100).astype(np.float32),
        t_is_merge=rng.random(n) < 0.1,
    ), (rng.random(len(counts)) * 50 + 1).astype(np.float32))]
    for seed in range(6):
        rng = np.random.default_rng(seed)
        D = int(rng.integers(1, 40))
        counts = rng.choice(
            [0, 1, 7, 1023, 1024, 1025, int(rng.integers(0, 4000))], D
        )
        n = max(int(counts.sum()), 1)
        cases.append((counts, dict(
            t_valid=rng.random(n) < 0.9, t_deps_met=rng.random(n) < 0.7,
            t_expected_s=(rng.random(n) * 100).astype(np.float32),
            t_wait_dep_met_s=(rng.random(n) * 100).astype(np.float32),
            t_is_merge=rng.random(n) < 0.1,
        ), (rng.random(D) * 50 + 1).astype(np.float32)))
    n = 3 * 1024 + 17
    cases.append((np.array([n]), dict(
        t_valid=np.ones(n, bool), t_deps_met=np.ones(n, bool),
        t_expected_s=np.full(n, 2.0, np.float32),
        t_wait_dep_met_s=np.full(n, 2.0, np.float32),
        t_is_merge=np.zeros(n, bool),
    ), np.array([1.0], np.float32)))
    return cases


def profile_solve(torch, solve_once, out_dir) -> None:
    """One solve under torch.profiler: device time per kernel name and the
    summed device time against the profiled wall time; a chrome trace
    goes to ``out_dir`` when one is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    log(f"  profile: {launches} device ops, {busy / 1e3:.2f} ms device time in "
        f"{wall_us / 1e3:.2f} ms profiled wall ({100 * busy / wall_us:.1f}% busy)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    ours = [kv for kv in ranked if "distro_stats" in kv[0] or "segment_sum" in kv[0]]
    for name, (n, us) in ranked[:8] + ours:
        log(f"  {us / 1e3:8.3f} ms  {n:5d}x  {name[:100]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "solve_trace.json"))


def segment_inputs(torch, np, a, d_thresh) -> dict:
    """``segment_sum``'s inputs on the solve's three plans (task→segment,
    host→segment, distro→pool) over the unpacked snapshot ``a``: name ->
    (segment ids, segments, live mask, [2, n_elem] columns, the column
    count the solve sums there at once). The task plan takes the
    allocator's two duration columns, the others seeded random values on
    their live elements."""
    rng = np.random.default_rng(1)

    def masked_rand(live, scale):
        x = torch.as_tensor((rng.random(live.shape[0]) * scale).astype(np.float32))
        return torch.where(live, x.to(live.device), 0.0)

    dm = a["t_valid"] & a["t_deps_met"]
    dur = a["t_expected_s"]
    over = dm & (dur > d_thresh[a["t_distro"].long()])
    G = a["g_distro"].shape[0]
    return {
        "task": (a["t_seg"], G, a["t_valid"],
                 torch.stack([torch.where(dm, dur, 0.0), torch.where(over, dur, 0.0)]), 2),
        "host": (a["h_seg"], G, a["h_valid"],
                 torch.stack([masked_rand(a["h_valid"], 1.0),
                              masked_rand(a["h_valid"], 1.0)]), 1),
        "pool": (a["d_pool"], 8, a["d_valid"],
                 torch.stack([masked_rand(a["d_valid"], 100.0),
                              masked_rand(a["d_valid"], 10.0)]), 2),
    }


def hold_distro_stats(torch, args) -> float:
    """``fused_distro_stats`` on card tensors ``args``: bit-equal to its
    plain version on the CPU (counts, and both duration sums: the kernel
    adds them in element order, as ``index_add_`` does there) and to a
    second launch; against the plain version on the card, whose
    ``index_add_`` adds with atomics in no fixed order, counts exact and
    sums within ``SUM_RTOL``. Returns the max abs error against the
    latter."""
    from evergreen_tpu_torch.ops.distro_stats import (
        STAT_NAMES, STAT_SUMS, fused_distro_stats, fused_distro_stats_plain,
    )

    got = fused_distro_stats(*args)
    torch.cuda.synchronize()
    cpu = fused_distro_stats_plain(*(x.cpu() for x in args))
    on_card = fused_distro_stats_plain(*args)
    err = 0.0
    for name in STAT_NAMES:
        g, w = got[name], on_card[name]
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        check(torch.equal(g.cpu(), cpu[name]),
              f"fused_distro_stats {name} differs from plain on the CPU")
        if name in STAT_SUMS:
            torch.testing.assert_close(g, w, rtol=SUM_RTOL, atol=0.0)
        else:
            check(torch.equal(g, w), f"fused_distro_stats {name} differs from plain")
    again = fused_distro_stats(*args)
    for name in STAT_NAMES:
        check(torch.equal(got[name], again[name]), f"{name} not repeatable")
    return err


def hold_segment_sum(torch, pname, seg, n_seg, live, x2):
    """``segment_sum`` on plan ``pname`` at one and two columns against its
    plain version (rtol ``SUM_RTOL``, atol 1e-6), the CPU's order (bit for
    bit) and a second launch; returns the plan and the max abs error."""
    from evergreen_tpu_torch.ops.segment import (
        segment_plan, segment_sum, segment_sum_plain,
    )

    plan = segment_plan(seg, n_seg, live, name=pname)
    cpu_plan = segment_plan(plan.seg.cpu(), n_seg)
    err = 0.0
    for x in (x2[0], x2):
        got = segment_sum(x, plan)
        torch.cuda.synchronize()
        want = segment_sum_plain(x, plan)
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=1e-6)
        check(torch.equal(got.cpu(), segment_sum(x.cpu(), cpu_plan)),
              f"segment_sum[{pname}] differs from the CPU's order")
        check(torch.equal(got, segment_sum(x, plan)),
              f"segment_sum[{pname}] not repeatable")
        err = max(err, float((got - want).abs().max()))
    return plan, err


def sweep(torch, ds_args, plan_inputs) -> None:
    """Both kernels built with other values of their design constants
    (``DS_VARIANTS``, ``SS_VARIANTS``; the first of each is the source's
    own), each result held against the source's own build
    bit for bit, then timed at the config-3 shapes: device
    time per call in two rounds, the second in the reverse order."""
    import ctypes
    import re

    from evergreen_tpu_torch.ops import _build, distro_stats, segment

    jobs = ([("distro_stats", d) for d in DS_VARIANTS]
            + [("segment_sum", d) for d in SS_VARIANTS])
    t0 = time.perf_counter()
    paths = _build.build_variants(jobs)
    log(f"sweep: {len(jobs)} builds in {time.perf_counter() - t0:.2f} s wall")
    fns, notes = [], []
    for (name, defs), path in zip(jobs, paths):
        mod = distro_stats if name == "distro_stats" else segment
        fns.append(mod.bind(ctypes.CDLL(path)))
        with open(path[:-3] + ".log") as f:
            text = f.read()
        regs = "/".join(re.findall(r"Used (\d+) registers", text))
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
        notes.append(f"registers {regs}, spill stores {spills} B")

    def label(defs):
        return " ".join(f"{k.split('_', 2)[-1].lower()}={v}" for k, v in defs.items())

    def rounds(cases):  # label -> fn; two rounds of device_ms, in turn
        times = {lab: [] for lab in cases}
        for order in (list(cases), list(cases)[::-1]):
            for lab in order:
                times[lab].append(device_ms(torch, cases[lab]))
        return times

    n_ds = len(DS_VARIANTS)
    want = distro_stats.launch(*ds_args, fn=fns[0])
    cases = {}
    for defs, fn in zip(DS_VARIANTS, fns[:n_ds]):
        got = distro_stats.launch(*ds_args, fn=fn)
        check(all(torch.equal(got[s_], want[s_]) for s_ in got),
              f"fused_distro_stats {label(defs)}: not bit-equal")
        cases[label(defs)] = lambda fn=fn: distro_stats.launch(*ds_args, fn=fn)
    times = rounds(cases)
    for (lab, ts), note in zip(times.items(), notes[:n_ds]):
        log(f"sweep fused_distro_stats {lab}: "
            + ", ".join(f"{t * 1e3:.3f}" for t in ts) + f" us device time; {note}")

    for pname, (seg, n_seg, live, x2, _) in plan_inputs.items():
        plan = segment.segment_plan(seg, n_seg, live)
        for k, x in ((1, x2[0]), (2, x2)):
            want = segment.launch(x, plan, fn=fns[n_ds])
            cases = {}
            for defs, fn in zip(SS_VARIANTS, fns[n_ds:]):
                check(torch.equal(segment.launch(x, plan, fn=fn), want),
                      f"segment_sum[{pname}] {label(defs)}: not bit-equal")
                cases[label(defs)] = lambda fn=fn, x=x: segment.launch(x, plan, fn=fn)
            times = rounds(cases)
            for (lab, ts), note in zip(times.items(), notes[n_ds:]):
                log(f"sweep segment_sum[{pname}] k={k} {lab}: "
                    + ", ".join(f"{t * 1e3:.3f}" for t in ts)
                    + f" us device time; {note}")
    log("sweep: every build equal to the source's own")


def reset_launches(*kernels) -> None:
    for k in kernels:
        k.launches = 0
        if hasattr(k, "launches_by_plan"):
            k.launches_by_plan.clear()


def read_launches(fds, ss) -> dict:
    out = {"fused_distro_stats": fds.launches, "segment_sum": ss.launches}
    out.update({f"segment_sum[{p}]": c for p, c in ss.launches_by_plan.items()})
    return out


def expected_launches(iters) -> dict:
    """Launches of solves at capacity trip counts ``iters``: one
    fused_distro_stats each; segment_sum once on the task plan (both
    duration columns), once on the host plan, and on the pool plan once
    for the minimum mass, once per projection (the warm start and each
    Newton step) and once for the affinity's pool totals."""
    return {
        "fused_distro_stats": len(iters),
        "segment_sum": sum(5 + c for c in iters),
        "segment_sum[task]": len(iters),
        "segment_sum[host]": len(iters),
        "segment_sum[pool]": sum(3 + c for c in iters),
    }


def digest(out: dict) -> str:
    """One shard's named outputs as a SHA-256 over names, dtypes and bytes."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(out):
        h.update(name.encode() + str(out[name].dtype).encode())
        h.update(out[name].tobytes())
    return h.hexdigest()


def worker_loop(here, data_dir, shard, snap, cmds, replies):
    """One shard's worker process: register its segment in the fleet
    manifest, then for each (epoch, seq, timeout) on ``cmds`` publish
    through ``SolverClient`` and wait for the leader's block, replying
    with the outcome and the block's digest; None ends it. It never
    touches the card: a fallback would solve on the CPU and report
    "local"."""
    sys.path.insert(0, here)
    from evergreen_tpu_torch.runtime import manifest
    from evergreen_tpu_torch.runtime.solver import SolverClient

    def on_change(name, nbytes):
        manifest.write_entry(data_dir, shard, pid=os.getpid(), sock="",
                             generation=1, epoch=0, shm=name,
                             shm_bytes=nbytes)

    client = SolverClient(data_dir, shard, on_segment_change=on_change,
                          device="cpu")
    try:
        while True:
            cmd = cmds.get(timeout=2 * ROUND_TIMEOUT_S)
            if cmd is None:
                break
            out = client.solve_fn(*cmd)(snap)
            replies.put((shard, client.last_solve, client.last_cause,
                         client.stale_accepted, digest(out)))
    finally:
        client.close(unlink=True)
        manifest.remove_entry(data_dir, shard)


def stacked_phase(torch, np, problem, cpu_out_tol, profile_dir) -> None:
    """Phase 4."""
    import multiprocessing
    import shutil
    import tempfile
    import threading

    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.packing import unpack
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.ops.solve import (
        OUTPUT_SPEC, _packed_solve, capacity_iters, distro_stats_inputs,
        result_to_host, run_solve_packed, split_outputs,
    )
    from evergreen_tpu_torch.parallel.sharded import (
        StackedSolveCache, _blocks_cap_iters, build_sharded_snapshot,
    )
    from evergreen_tpu_torch.runtime.manifest import write_entry
    from evergreen_tpu_torch.runtime.solver import (
        SolverClient, SolverService, reap_orphan_segments,
    )
    from evergreen_tpu_torch.utils.benchgen import NOW, add_capacity_page

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _, cold = build_sharded_snapshot(*problem, NOW, SHARDS)
    cold_s = time.perf_counter() - t0
    memos = {}
    build_sharded_snapshot(*problem, NOW, SHARDS, memos=memos)
    t0 = time.perf_counter()
    subs, warm = build_sharded_snapshot(*problem, NOW, SHARDS, memos=memos)
    warm_s = time.perf_counter() - t0
    check(list(warm) == list(cold) and all(
        warm[n].tobytes() == cold[n].tobytes() for n in cold),
        "warm sharded build differs from the cold one")
    for s, steps in zip(subs, SHARD_PAGES):
        if steps:
            add_capacity_page(s, steps)
    blocks = {k: s.arrays for k, s in enumerate(subs)}
    cap = _blocks_cap_iters(blocks)
    check(cap == max(SHARD_PAGES), f"stack trip count {cap}")
    check([capacity_iters(s) for s in subs] == list(SHARD_PAGES),
          "shard pages not as set")
    log(f"stacked: config 3 over {SHARDS} shards, shape key {subs[0].shape_key()}, "
        f"tasks {[s.n_tasks for s in subs]}, distros {[s.n_distros for s in subs]}; "
        f"sharded build cold {cold_s * 1e3:.0f} ms, warm {warm_s * 1e3:.0f} ms "
        f"(host), warm == cold byte for byte; pages {list(SHARD_PAGES)} steps, "
        f"stack trip count {cap}")
    # both kernels held against their plain versions at the shard shapes,
    # on each block unpacked on the card
    ds_err, ss_err = 0.0, {}
    for s in subs:
        a = unpack(s.arena.buffers, s.arena.layout_key(), dev)
        ds_args = distro_stats_inputs(a)
        ds_err = max(ds_err, hold_distro_stats(torch, ds_args))
        for pname, (seg, n_seg, live, x2, _) in segment_inputs(
                torch, np, a, ds_args[6]).items():
            _, err = hold_segment_sum(torch, pname, seg, n_seg, live, x2)
            ss_err[pname] = max(ss_err.get(pname, 0.0), err)
    log(f"stacked: on each of the {SHARDS} blocks, fused_distro_stats bit-equal "
        f"to plain on the CPU (max abs err vs plain on the card {ds_err:.3g}) "
        f"and segment_sum on its task, host and pool plans at k = 1, 2 bit-equal "
        f"to the CPU and within rtol {SUM_RTOL} of plain (max abs err "
        + ", ".join(f"{p} {e:.3g}" for p, e in ss_err.items()) + ")")
    want_round = expected_launches([cap] * SHARDS)

    # (a) the in-process stack on the card
    cache = StackedSolveCache()
    reset_launches(fused_distro_stats, segment_sum)
    stack = cache.solve_blocks(blocks)
    got = read_launches(fused_distro_stats, segment_sum)
    check(got == want_round, f"stacked launches {got}, expected {want_round}")
    for k, s in enumerate(subs):
        own = split_outputs(result_to_host(_packed_solve(
            s.arena.buffers, s.arena.layout_key(), cap, dev)), s.shape_key())
        check(digest(own) == digest(stack[k]),
              f"shard {k}: stacked block differs from its _packed_solve at {cap}")
    cpu = StackedSolveCache("cpu").solve_blocks(blocks)
    gaps = {}
    for k in range(SHARDS):
        for name, kind_, _ in OUTPUT_SPEC:
            c, w = stack[k][name], cpu[k][name]
            if kind_ == "i32":
                check(np.array_equal(c, w), f"shard {k}: {name} differs from the CPU")
            else:
                np.testing.assert_allclose(c, w, err_msg=f"shard {k}: {name}",
                                           **cpu_out_tol.get(name, dict(rtol=0.0, atol=0.0)))
                rel = np.abs(c - w) / np.maximum(np.abs(w), 1e-30)
                gaps[name] = max(gaps.get(name, 0.0), float(rel.max()) if len(c) else 0.0)
        check(bool(all(np.isfinite(stack[k][n]).all() for n in stack[k])),
              f"shard {k}: outputs not finite")
    log(f"stacked (a): StackedSolveCache on the card, launches {got} (exact); "
        f"each block byte-identical to its _packed_solve at {cap} steps; i32 "
        "equal to the CPU stack, f32 max relative gap "
        + ", ".join(f"{k}={v:.3g}" for k, v in gaps.items()))

    # (b) the solver-leader plane: rounds to worker processes, then to
    # clients in threads
    data_dir = tempfile.mkdtemp(prefix="evg-chip-smoke-")
    svc = SolverService(data_dir, SHARDS, lease_ttl_s=5.0,
                        timeout_s=ROUND_TIMEOUT_S)
    procs, cmds, clients = [], [], {}
    want_digest = {k: digest(stack[k]) for k in stack}
    try:
        check(reap_orphan_segments(data_dir, SHARDS) == [], "orphan segments")
        check(svc.acquire(timeout_s=30.0), "solver lease not acquired")
        ctx = multiprocessing.get_context("spawn")
        replies = ctx.Queue()
        cmds = [ctx.Queue() for _ in range(SHARDS)]
        t0 = time.perf_counter()
        procs = [ctx.Process(target=worker_loop, args=(
            HERE, data_dir, k, subs[k], cmds[k], replies)) for k in range(SHARDS)]
        for p in procs:
            p.start()
        spawn_ms = []
        for r in range(1 + THREAD_ROUNDS):
            stamp = svc.stamp()
            for q in cmds:
                q.put((stamp["epoch"], stamp["seq"], stamp["timeout_s"]))
            reset_launches(fused_distro_stats, segment_sum)
            t1 = time.perf_counter()
            outcome = svc.serve_round(list(range(SHARDS)), stamp["seq"])
            spawn_ms.append((time.perf_counter() - t1) * 1e3)
            got = read_launches(fused_distro_stats, segment_sum)
            answers = []
            deadline = time.monotonic() + ROUND_TIMEOUT_S
            while len(answers) < SHARDS and time.monotonic() < deadline:
                try:
                    answers.append(replies.get(timeout=1.0))
                except Exception:  # queue.Empty: see whether a worker died
                    check(all(p.is_alive() for p in procs),
                          f"a worker exited: {[p.exitcode for p in procs]}")
            check(len(answers) == SHARDS, "a worker did not reply")
            check(outcome == "stacked", f"process round {r} ended {outcome!r}")
            check(got == want_round, f"process round launches {got}, expected {want_round}")
            for shard, last, cause, stale, dig in answers:
                check(last == "stacked", f"worker {shard} solved {last}:{cause}")
                check(stale == 0, f"worker {shard} accepted a stale block")
                check(dig == want_digest[shard],
                      f"worker {shard}: block differs from the in-process stack")
            if r == 0:
                log(f"stacked (b): first round to {SHARDS} spawn worker processes "
                    f"ended '{outcome}', every worker 'stacked', blocks "
                    f"byte-identical to (a), launches {got} (exact); "
                    f"{time.perf_counter() - t0:.2f} s wall with the workers' start")
        for q in cmds:
            q.put(None)
        for p in procs:
            p.join(timeout=60.0)
        check(all(p.exitcode == 0 for p in procs), "a worker process failed")
        log(f"stacked (b): {THREAD_ROUNDS} more rounds to the worker processes, "
            f"every round and worker 'stacked', blocks byte-identical to (a), "
            f"launches per round as above (exact); serve_round wall median "
            f"{statistics.median(spawn_ms[1:]):.2f} ms, min {min(spawn_ms[1:]):.2f} ms")

        for k in range(SHARDS):
            def on_change(name, nbytes, k=k):
                write_entry(data_dir, k, pid=os.getpid(), sock="", generation=2,
                            epoch=svc.epoch, shm=name, shm_bytes=nbytes)
            clients[k] = SolverClient(data_dir, k, on_segment_change=on_change)
        round_ms = []
        for _ in range(THREAD_ROUNDS):
            stamp = svc.stamp()
            results, threads = {}, []
            for k, c in clients.items():
                fn = c.solve_fn(stamp["epoch"], stamp["seq"], stamp["timeout_s"])
                t = threading.Thread(
                    target=lambda k=k, fn=fn: results.__setitem__(k, fn(subs[k])),
                    daemon=True)
                t.start()
                threads.append(t)
            reset_launches(fused_distro_stats, segment_sum)
            t0 = time.perf_counter()
            outcome = svc.serve_round(list(clients), stamp["seq"])
            round_ms.append((time.perf_counter() - t0) * 1e3)
            got = read_launches(fused_distro_stats, segment_sum)
            for t in threads:
                t.join(timeout=ROUND_TIMEOUT_S)
            check(not any(t.is_alive() for t in threads), "a client thread hung")
            check(outcome == "stacked", f"thread round ended {outcome!r}")
            check(got == want_round, f"thread round launches {got}, expected {want_round}")
            for k, c in clients.items():
                check(c.last_solve == "stacked", f"client {k}: {c.last_solve}:{c.last_cause}")
                check(digest(results[k]) == digest(stack[k]),
                      f"client {k}: block differs from the in-process stack")
        check(svc.round_outcomes == {"stacked": 1 + 2 * THREAD_ROUNDS},
              f"round outcomes {svc.round_outcomes}")
        check(all(c.stale_accepted == 0 and not c.fallbacks for c in clients.values()),
              "a client fell back or accepted a stale block")
    finally:
        for c in clients.values():
            c.close(unlink=True)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        svc.stop()
        shutil.rmtree(data_dir, ignore_errors=True)
    log(f"stacked (b): {THREAD_ROUNDS} rounds to clients in threads (the leader's "
        f"process), every round and client 'stacked', blocks byte-identical to "
        f"(a), launches per round {want_round} (exact); serve_round wall median "
        f"{statistics.median(round_ms):.2f} ms, min {min(round_ms):.2f} ms "
        f"(collect + stacked solve + return)")

    stack_ms, seq_ms = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        cache.solve_blocks(blocks)
        stack_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for s in subs:
            run_solve_packed(s)
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"stacked: in-process solve_blocks ({SHARDS} x {cap} steps) wall median "
        f"{statistics.median(stack_ms):.2f} ms, min {min(stack_ms):.2f} ms; "
        f"{SHARDS} sequential run_solve_packed (own pages {list(SHARD_PAGES)}) "
        f"median {statistics.median(seq_ms):.2f} ms, min {min(seq_ms):.2f} ms")
    log("stacked: profile of one in-process solve_blocks")
    profile_solve(torch, lambda: cache.solve_blocks(blocks),
                  os.path.join(profile_dir, "stacked") if profile_dir else None)


def diff_spans(np, before, after) -> dict:
    """Each kind's [lo, hi) runs of elements whose bytes changed."""
    spans = {}
    for kind, new in after.items():
        width = {1: np.uint8, 4: np.uint32}[new.itemsize]
        idx = np.flatnonzero(before[kind].view(width) != new.view(width))
        cuts = np.flatnonzero(np.diff(idx) > 1) + 1
        starts = np.concatenate([[0], cuts]) if len(idx) else []
        ends = np.concatenate([cuts, [len(idx)]]) if len(idx) else []
        spans[kind] = [(int(idx[a]), int(idx[b - 1]) + 1)
                       for a, b in zip(starts, ends)]
    return spans


def predict_mirror(spans, shapes, run_min) -> dict:
    """The counter moves a delta sync of disjoint, non-adjacent ``spans``
    should make: runs of ``run_min`` or more ship as slices, the rest
    through the index vector unless it covers half of its kind or more,
    which ships the kind whole."""
    d = {"full_uploads": 0, "slice_rows": 0, "delta_rows": 0}
    for kind, sp in spans.items():
        sparse = sum(hi - lo for lo, hi in sp if hi - lo < run_min)
        if 2 * sparse >= shapes[kind]:
            d["full_uploads"] += 1
        else:
            d["slice_rows"] += sum(hi - lo for lo, hi in sp if hi - lo >= run_min)
            d["delta_rows"] += sparse
    return d


def mirror_phase(torch, np, problem) -> None:
    """Phase 5."""
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.resident_ops import SLICE_RUN_MIN, DeviceMirror
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.ops.solve import (
        _packed_solve, capacity_iters, result_to_host, run_solve_packed,
        split_outputs,
    )
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.utils.benchgen import NOW

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    snap = build_snapshot(*problem, NOW)
    t_f32 = [n for n, kind, _ in snap.arena.layout_key()
             if kind == "f32" and n[:2] in ("t_", "u_")]

    def time_refresh(s):
        later = build_snapshot(*problem, NOW + 15.0)
        for kind, buf in later.arena.buffers.items():
            s.arena.buffers[kind][:] = buf
        return s

    def scattered(s):
        a = s.arrays
        rows = rng.choice(s.n_tasks, 200, replace=False)
        a["t_priority"][rows[:100]] += 7
        a["t_expected_s"][rows[100:]] *= 1.5
        hosts = rng.choice(s.n_hosts, 100, replace=False)
        a["h_free"][hosts] ^= True
        return s

    def dense_f32(s):
        # three of every four elements of the task and unit f32 columns:
        # short runs, over half of the f32 buffer in all
        for name in t_f32:
            col = s.arrays[name]
            col[np.arange(len(col)) % 4 != 3] += 1.0
        return s

    steps = [
        ("cold sync", lambda s: s),
        ("time refresh (NOW + 15 s)", time_refresh),
        ("300 scattered rows", scattered),
        ("sparse part over half of f32", dense_f32),
        ("layout change (N bucket doubled)", lambda s: build_snapshot(
            *problem, NOW, force_dims={"N": 2 * s.shape_key()[0]})),
    ]
    # the first copy_/index_copy_ of each dtype loads its kernels: do it
    # on a small mirror, so the steps' sync times are steady ones
    small = {k: np.zeros(256, v.dtype) for k, v in snap.arena.buffers.items()}
    warm = DeviceMirror()
    warm.sync(small, None)
    warm.sync(small, {k: [(0, 2 * SLICE_RUN_MIN), (200, 201)] for k in small})
    mirror = DeviceMirror()
    full_bytes = sum(v.nbytes for v in snap.arena.buffers.values())
    prev = None
    for label, step in steps:
        snap = step(snap)
        truth = snap.arena.buffers
        shapes = {k: len(v) for k, v in truth.items()}
        same = prev is not None and shapes == {k: len(v) for k, v in prev.items()}
        spans = diff_spans(np, prev, truth) if same else None
        before = {k: getattr(mirror, k) for k in ("full_uploads", "slice_rows",
                                                    "delta_rows", "bytes_uploaded")}
        want = (predict_mirror(spans, shapes, SLICE_RUN_MIN) if spans is not None
                else {"full_uploads": 1, "slice_rows": 0, "delta_rows": 0})
        t0 = time.perf_counter()
        bufs = mirror.sync(truth, spans)
        torch.cuda.synchronize(dev)
        sync_ms = (time.perf_counter() - t0) * 1e3
        moved = {k: getattr(mirror, k) - v for k, v in before.items()}
        check({k: moved[k] for k in want} == want,
              f"mirror {label}: counters moved {moved}, predicted {want}")
        for kind, src in truth.items():
            check(bufs[kind].device == dev
                  and bufs[kind].cpu().numpy().tobytes() == src.tobytes(),
                  f"mirror {label}: {kind} differs from the host truth")
        iters = capacity_iters(snap)
        reset_launches(fused_distro_stats, segment_sum)
        fed = result_to_host(_packed_solve(bufs, snap.arena.layout_key(), iters, dev))
        got = read_launches(fused_distro_stats, segment_sum)
        check(got == expected_launches([iters]),
              f"mirror {label}: launches {got}")
        fresh = run_solve_packed(snap)
        check(digest(split_outputs(fed, snap.shape_key())) == digest(fresh),
              f"mirror {label}: solve differs from a fresh upload's")
        n_spans = sum(len(v) for v in spans.values()) if spans else 0
        log(f"mirror {label}: {n_spans} spans, counters moved "
            f"{ {k: moved[k] for k in want} } (as predicted); H2D "
            f"{moved['bytes_uploaded']} B against a full upload's "
            f"{sum(v.nbytes for v in truth.values())} B; sync {sync_ms:.2f} ms wall; "
            f"mirror == truth, its solve == a fresh upload's (launches {got})")
        prev = {k: v.copy() for k, v in truth.items()}
    # each kind of update ran: slices and an index vector on the time
    # refresh, full uploads cold, for the dense f32 step and the layout
    check(mirror.full_uploads == 3 and mirror.slice_rows > 0 and mirror.delta_rows > 0,
          "the churn sequence did not exercise every kind of update")
    log(f"mirror: totals full_uploads {mirror.full_uploads}, slice_rows "
        f"{mirror.slice_rows}, delta_rows {mirror.delta_rows}, "
        f"{mirror.bytes_uploaded} B H2D over {len(steps)} steps (config 3 "
        f"arena {full_bytes} B)")


#: phase 6: the capacity settings bench.py's capacity arm gives config 3,
#: and the solve deadline of the second two-call run
PLAN_QUOTA = {"mock": 5400}
PLAN_BUDGET = 500
PLAN_DEADLINE_S = 5.0
#: the one float of the planning chain's documents that the card may
#: round otherwise than the CPU: the capacity relaxation's x (from Newton
#: steps with pow and division), rounded to this unit in the provenance
FRACTIONAL_UNIT = 1e-3
RUNGS = ("fused", "two_call", "heuristic")


def plan_tick(store, now, solve_fn=None, deadline_s=0.0, device=None) -> dict:
    """The planning chain of the tick through the port (the JAX
    ``run_tick`` body without the cmp planner, the serial fallback, the
    persister and intent creation): intent budget, capacity page,
    snapshot, bounded solve, unpack, the alias and single-task rules,
    the capacity plane (its two-call rung on ``device``). Returns its
    outputs, the moves of the counters that show a fallback, and each
    step's wall time."""
    from evergreen_tpu_torch.globals import ALIAS_SUFFIX, MAX_INTENT_HOSTS_IN_FLIGHT
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.scheduler import capacity_plane as plane_mod
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot, pack_capacity_page
    from evergreen_tpu_torch.utils.circuit import BREAKER_FAILURES

    fused0 = {k: plane_mod.FUSED_SOLVES.value(mode=k) for k in RUNGS}
    solves0 = plane_mod.CAPACITY_SOLVES.total()
    fallbacks0 = plane_mod.CAPACITY_FALLBACKS.total()
    failures0 = BREAKER_FAILURES.value(name="scheduler.solve")
    ms = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return r

    budget = max(0, MAX_INTENT_HOSTS_IN_FLIGHT - host_mod.count_intents_in_flight(store))
    distros, tbd, hbd, est, deps_met = timed(
        "gather_tick_inputs", wrapper.gather_tick_inputs, store, now)
    distros = wrapper._apply_release_mode(store, distros)
    plane = plane_mod.capacity_plane_for(store)
    page = plane.build_capacity_page(quota_scale=1.0, intent_budget=budget)
    snap = timed("build_snapshot", build_snapshot, distros, tbd, hbd, est, deps_met, now)
    pack_capacity_page(snap.arrays, page)
    breaker = wrapper.solve_breaker_for(store)
    check(breaker.allow(now=now), "the solve breaker is open")
    try:
        out = timed("_solve_bounded", wrapper._solve_bounded, store, snap, deadline_s,
                    solve_fn=solve_fn)
    except Exception as exc:
        breaker.record_failure(now=now, error=repr(exc))
        raise
    breaker.record_success(now=now)
    plans, sort_values, infos, new_hosts, _, _, provenance = timed(
        "_unpack_solve", wrapper._unpack_solve, snap, out)
    d_pool, d_cap = snap.arrays["d_pool"], snap.arrays["d_cap_on"]
    packed_cols = {did: (int(d_pool[i]), bool(d_cap[i]))
                   for i, did in enumerate(snap.distro_ids)}
    fused = plane_mod.extract_fused_view(snap, out) if page is not None else None
    for k in [k for k in new_hosts if k.endswith(ALIAS_SUFFIX)]:
        del new_hosts[k]
    for d in distros:
        if d.single_task_distro and d.id in new_hosts:
            info = infos.get(d.id)
            demand = info.length_with_dependencies_met if info else 0
            existing = len(hbd.get(d.id, []))
            cap = d.host_allocator_settings.maximum_hosts or demand
            new_hosts[d.id] = max(0, min(demand, cap - existing))
    before = dict(new_hosts)
    after = timed("apply", plane.apply, distros, infos, new_hosts, hbd, now,
                  degraded=False, quota_scale=1.0, intent_budget=budget,
                  packed_cols=packed_cols, fused=fused, device=device)
    return dict(
        snap=snap, out=out, plans=plans, sort_values=sort_values, infos=infos,
        before=before, after=after, provenance=provenance, fused=fused,
        capacity=store._last_capacity, ms=ms,
        rungs={k: plane_mod.FUSED_SOLVES.value(mode=k) - fused0[k] for k in RUNGS},
        capacity_solves=plane_mod.CAPACITY_SOLVES.total() - solves0,
        fallbacks=plane_mod.CAPACITY_FALLBACKS.total() - fallbacks0,
        solve_failures=BREAKER_FAILURES.value(name="scheduler.solve") - failures0,
        solve_breaker=breaker.state, fused_breaker=plane.fused_breaker.state,
    )


def close_docs(got, want, path=""):
    """Whether two documents are equal: exactly, but for the capacity
    relaxation's ``fractional``, which may differ by ``SUM_RTOL`` or the
    unit it is rounded to."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{path}: keys differ")
        for k in want:
            close_docs(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{path}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            close_docs(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and path.endswith(".fractional"):
        # values of x within SUM_RTOL may round one unit apart
        check(abs(got - want) <= max(SUM_RTOL * abs(want), FRACTIONAL_UNIT * (1 + 1e-6)),
              f"{path}: {got} != {want}")
    else:
        check(type(got) is type(want) and got == want, f"{path}: {got!r} != {want!r}")


def same_tick(card, cpu, label) -> None:
    """The card's chain outputs against the CPU's: plans, sort values,
    spawn counts, rung, capacity targets, queue info and provenance
    exactly, but for ``fractional`` (``close_docs``)."""
    check(list(card["plans"]) == list(cpu["plans"]), f"{label}: distros differ")
    for did in cpu["plans"]:
        check([t.id for t in card["plans"][did]] == [t.id for t in cpu["plans"][did]],
              f"{label}: plan of {did} differs from the CPU's")
        check(card["sort_values"][did].tobytes() == cpu["sort_values"][did].tobytes(),
              f"{label}: sort values of {did} differ from the CPU's")
        close_docs(card["infos"][did].doc(), cpu["infos"][did].doc(), f"{label}: info[{did}]")
        close_docs(card["provenance"].to_doc(did, limit=10**9),
                   cpu["provenance"].to_doc(did, limit=10**9), f"{label}: prov[{did}]")
    for key in ("before", "after", "rungs", "capacity_solves", "fallbacks"):
        check(card[key] == cpu[key], f"{label}: {key} differs from the CPU's")
    check(card["capacity"].chosen == cpu["capacity"].chosen, f"{label}: chosen differs")
    close_docs(card["capacity"].to_doc(limit=10**9), cpu["capacity"].to_doc(limit=10**9),
               f"{label}: capacity")


def planning_phase(torch, np) -> None:
    """Phase 6."""
    import functools
    import threading

    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.ops import capacity as cap_ops
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.ops.solve import OUTPUT_SPEC, capacity_iters, run_solve_packed
    from evergreen_tpu_torch.scheduler.capacity_plane import build_fused_inputs
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils.benchgen import NOW, generate_problem

    distros, tbd, hbd, _, _ = generate_problem(*CONFIG3, seed=SEED)
    store = Store()
    t0 = time.perf_counter()
    for d in distros:
        distro_mod.insert(store, d)
    task_mod.insert_many(store, [t for ts in tbd.values() for t in ts])
    for hs in hbd.values():
        host_mod.insert_many(store, hs)
    insert_ms = (time.perf_counter() - t0) * 1e3
    coll = distro_mod.coll(store)
    for doc in coll.find():
        ps = dict(doc["planner_settings"])
        ps["capacity"] = "tpu"
        coll.update(doc["_id"], {"planner_settings": ps})
    log(f"planning: config 3 (seed {SEED}) inserted into the port's Store: "
        f"{len(distros)} distros, {task_mod.coll(store).count()} tasks, "
        f"{host_mod.coll(store).count()} hosts in {insert_ms:.0f} ms (host); every "
        f"distro opted into the capacity program, quota {PLAN_QUOTA}, fleet intent "
        f"budget {PLAN_BUDGET}")

    def configure(fused):
        CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET,
                       fused=fused).set(store)

    # the CPU reference runs: the solve and the two-call program on the CPU
    cpu = {}
    for fused in ("auto", "two_call"):
        configure(fused)
        cpu[fused] = plan_tick(store, NOW, solve_fn=functools.partial(
            run_solve_packed, device="cpu"), device="cpu")

    iters = capacity_iters(cpu["auto"]["snap"])
    check(iters == CapacityConfig().iterations, f"capacity page iterations {iters}")
    # launches: the packed solve's, and the two-call program's pool sums —
    # the minimum mass once and each projection (warm start and steps)
    want_fused = expected_launches([iters])
    want_two = dict(want_fused)
    for k in ("segment_sum", "segment_sum[pool]"):
        want_two[k] += 2 + iters
    runs = {}
    for label, fused, deadline in (("fused", "auto", 0.0),
                                   ("two_call", "two_call", 0.0),
                                   ("two_call+deadline", "two_call", PLAN_DEADLINE_S)):
        configure(fused)
        reset_launches(fused_distro_stats, segment_sum)
        r = plan_tick(store, NOW, deadline_s=deadline)
        r["launches"] = read_launches(fused_distro_stats, segment_sum)
        runs[label] = r
        rung = "fused" if fused == "auto" else "two_call"
        check(r["solve_failures"] == 0 and r["solve_breaker"] == "closed",
              f"{label}: the solve breaker saw a failure")
        check(r["fallbacks"] == 0, f"{label}: scheduler_capacity_fallbacks_total moved")
        check(r["fused_breaker"] == "closed", f"{label}: the fused breaker is open")
        check(r["rungs"] == {k: int(k == rung) for k in RUNGS},
              f"{label}: rungs {r['rungs']}, expected one {rung}")
        check(r["capacity_solves"] == (0 if rung == "fused" else 1),
              f"{label}: scheduler_capacity_solves_total moved {r['capacity_solves']}")
        want = want_fused if rung == "fused" else want_two
        check(r["launches"] == want, f"{label}: launches {r['launches']}, expected {want}")
        same_tick(r, cpu[fused], label)
        out = r["out"]
        check(all(np.isfinite(out[n]).all() for n, k_, _ in OUTPUT_SPEC if k_ == "f32"),
              f"{label}: outputs not finite")
        check(sum(len(p) for p in r["plans"].values()) == r["snap"].n_tasks,
              f"{label}: plans do not hold every task once")
        check(min(r["after"].values()) >= 0, f"{label}: negative spawn count")
    check(not any(t.name == "tick-solve" and t.is_alive() for t in threading.enumerate()),
          "the deadline's solve thread outlived its solve")
    f, c, c2 = runs["fused"], runs["two_call"], runs["two_call+deadline"]
    check(f["after"] == c["after"] and f["before"] == c["before"],
          "fused and two-call spawn counts differ")
    check(f["capacity"].to_doc(limit=10**9)["distros"]
          == c["capacity"].to_doc(limit=10**9)["distros"],
          "fused and two-call targets differ")
    check(digest(c["out"]) == digest(c2["out"]) and c["after"] == c2["after"]
          and c["capacity"].to_doc(limit=10**9)["distros"]
          == c2["capacity"].to_doc(limit=10**9)["distros"],
          "the two two-call runs (no deadline, and a deadline) differ")
    moved = sum(1 for d, n in f["after"].items() if n != f["before"][d])
    log(f"planning: planner tpu on every run, no fallback counter moved, breakers "
        f"closed; rungs fused / two_call / two_call as configured; card == CPU (plans, "
        f"sort values, spawn counts, targets, queue info, provenance exact; the "
        f"relaxation's fractional x within rtol {SUM_RTOL} or {FRACTIONAL_UNIT}); "
        f"fused == two-call targets and rounded allocations; the two two-call runs "
        f"(deadline 0 and {PLAN_DEADLINE_S} s) byte-identical; capacity chose "
        f"'{f['capacity'].chosen}', {sum(f['before'].values())} heuristic intents -> "
        f"{sum(f['after'].values())} ({moved} distros moved)")
    log("planning launches: " + json.dumps({k: r["launches"] for k, r in runs.items()}))

    # the two-call program alone, at the fused program's padded D: x is
    # the packed solve's cap_x bit for bit, and repeats byte for byte
    inp = build_fused_inputs(f["fused"])
    d_pad = f["fused"]["d_pad"]
    xs, cap_ms = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        xs.append(cap_ops.run_capacity_solve(inp, d_pad=d_pad))
        cap_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(x.tobytes() == f["fused"]["cap_x"][: inp.n].tobytes() for x in xs),
          "run_capacity_solve differs from the packed solve's cap_x")
    ms = {k: [r["ms"][k] for r in runs.values()] for k in f["ms"]}
    log("planning wall (ms; fused, two_call, two_call+deadline): inserts "
        f"{insert_ms:.1f}; " + "; ".join(
            f"{k} " + ", ".join(f"{v:.2f}" for v in vs) for k, vs in ms.items())
        + f"; run_capacity_solve alone ({inp.n} rows at D {d_pad}, {iters} steps) "
        f"median {statistics.median(cap_ms):.2f} ms, min {min(cap_ms):.2f} ms over 7, "
        f"x == cap_x bit for bit")
    log("planning: profile of one run_capacity_solve")
    profile_solve(torch, lambda: cap_ops.run_capacity_solve(inp, d_pad=d_pad), None)


#: phase 7: the ticks' logical times and how many tasks the churn between
#: the two solve ticks touches in each of its four ways
TICK_STEP_S = 15.0
TICK_CHURN = 300
#: the wall-time phases of a tick (TICK_PHASE_MS labels, in pipeline order)
TICK_PHASES = ("delta_drain", "pack", "solve", "unpack", "cmp", "capacity",
               "persist")
#: the collections a tick writes
TICK_COLLECTIONS = ("task_queues", "task_secondary_queues", "tasks", "hosts",
                    "events", "overload_sheds")
SHAPES = ("skipped", "patched", "spliced", "rewritten")


def seed_tick_store(store, problem, only=None) -> None:
    """Config 3 in ``store`` with phase 6's capacity settings: every
    distro of ``problem`` with its tasks and hosts, or those of the
    distro ids in ``only``."""
    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import host as host_mod
    from evergreen_tpu_torch.models import task as task_mod
    from evergreen_tpu_torch.settings import CapacityConfig

    distros, tbd, hbd, _, _ = problem
    if only is not None:
        distros = [d for d in distros if d.id in only]
    for d in distros:
        distro_mod.insert(store, d)
        coll = distro_mod.coll(store)
        ps = dict(coll.get(d.id)["planner_settings"])
        ps["capacity"] = "tpu"
        coll.update(d.id, {"planner_settings": ps})
    task_mod.insert_many(store, [t for d in distros for t in tbd[d.id]])
    for d in distros:
        host_mod.insert_many(store, hbd[d.id])
    CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET).set(store)


def tick_churn(store, now) -> None:
    """The same churn on any store, in the first half of the distros:
    TICK_CHURN runnable tasks dispatched, as many finished, as many
    re-prioritised, and as many new ones (copies of others, unstamped and
    without dependencies). The other half's queues change only with the
    clock and the intents of the tick before."""
    import copy
    import random

    rng = random.Random(SEED)
    tasks = store.collection("tasks")
    ids = sorted(d["_id"] for d in store.collection("distros").find())
    churned = set(ids[: len(ids) // 2])
    live = [d["_id"] for d in tasks.find()
            if d["status"] == "undispatched" and d["activated"]
            and d["distro_id"] in churned]
    rng.shuffle(live)
    n = TICK_CHURN
    for tid in live[:n]:
        tasks.update(tid, {"status": "dispatched", "dispatch_time": now})
    for tid in live[n:2 * n]:
        tasks.update(tid, {"status": "success", "finish_time": now})
    for tid in live[2 * n:3 * n]:
        tasks.update(tid, {"priority": rng.choice([0, 5, 60])})
    new = []
    for k, tid in enumerate(live[3 * n:4 * n]):
        doc = copy.deepcopy(tasks.get(tid))
        doc.update(_id=f"{tid}-new{k}", scheduled_time=0.0,
                   dependencies_met_time=0.0, depends_on=[], activated_time=now)
        new.append(doc)
    tasks.insert_many(new)


class GcClock:
    """Wall ms the cyclic garbage collector spends while installed in
    ``gc.callbacks``, and how many of its collections were full
    (generation 2)."""

    def __init__(self):
        self.ms = 0.0
        self.full = 0
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2
            self._t0 = None


def tick_phase(torch, np, problem, card="cuda", card_first=True, depth=None) -> dict:
    """Phase 7, ticking the card's store before the CPU's at each step
    when ``card_first``, else after it; ``depth`` runs only the first
    that many ticks. Returns the launches of its ticks on ``card``."""
    import gc
    import itertools
    import random
    import uuid

    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.persister import persister_state_for
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import faults
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    stores = {card: Store(), "cpu": Store()}
    t0 = time.perf_counter()
    for store in stores.values():
        seed_tick_store(store, problem)
    order = (card, "cpu") if card_first else ("cpu", card)
    log(f"tick: config 3 (seed {SEED}) in a store for the card and one for the "
        f"CPU, {time.perf_counter() - t0:.2f} s wall for both; capacity quota "
        f"{PLAN_QUOTA}, fleet intent budget {PLAN_BUDGET}; each step ticks "
        f"{order[0]} first, after a full gc.collect() before each tick")
    seqs = {k: itertools.count() for k in stores}
    real_uuid4, real_time = uuid.uuid4, time.time

    def tick(key, k, now, opts):
        """Tick ``key``'s store; the k-th tick of each store draws the same
        uuid4 stream, reads the same clock and continues its own event
        sequence."""
        rng = random.Random(1000 + k)
        uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128))
        time.time = lambda: now
        event_mod._SEQ = seqs[key]
        try:
            return wrapper.run_tick(stores[key], opts, now=now, device=key)
        finally:
            uuid.uuid4, time.time = real_uuid4, real_time

    def break_solve(store):
        breaker = wrapper.solve_breaker_for(store)
        for _ in range(wrapper.SOLVE_BREAKER_THRESHOLD):
            breaker.record_failure(now=NOW + 3 * TICK_STEP_S, error="held open")

    steps = [
        ("1", NOW, None, None, "tpu", ""),
        ("2 (after churn)", NOW + TICK_STEP_S, tick_churn, None, "tpu", ""),
        ("3 (solve fault)", NOW + 2 * TICK_STEP_S, None,
         faults.FaultPlan().always("scheduler.solve", faults.Fault("raise")),
         "serial", "solve-failed"),
        ("4 (breaker open)", NOW + 3 * TICK_STEP_S, lambda st, now: break_solve(st),
         None, "serial", "breaker-open"),
    ]
    total = {}
    for k, (label, now, before, plan, planner, degraded) in enumerate(steps[:depth]):
        if before is not None:
            for store in stores.values():
                before(store, now)
        results, shapes, phases, gcs = {}, {}, {}, {}
        for key in order:
            state = persister_state_for(stores[key])
            shapes0 = [getattr(state, s_) for s_ in SHAPES]
            phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in TICK_PHASES}
            if plan is not None:
                faults.install(plan)
            gc.collect()
            gcs[key] = GcClock()
            gc.callbacks.append(gcs[key])
            reset_launches(fused_distro_stats, segment_sum)
            try:
                results[key] = tick(key, k, now, wrapper.TickOptions())
            finally:
                gc.callbacks.remove(gcs[key])
                faults.uninstall()
            if key == card:
                launches = read_launches(fused_distro_stats, segment_sum)
            shapes[key] = {s_: getattr(state, s_) - v for s_, v in zip(SHAPES, shapes0)}
            phases[key] = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p]
                           for p in TICK_PHASES}
        r, c = results[card], results["cpu"]
        check(r.planner_used == planner and r.degraded == degraded,
              f"{label}: planner {r.planner_used!r}, degraded {r.degraded!r}")
        for field in ("queues", "new_hosts", "n_tasks", "n_distros", "planner_used",
                      "degraded", "shed", "overload"):
            check(getattr(r, field) == getattr(c, field),
                  f"{label}: TickResult.{field} differs from the CPU's")
        check([h.to_doc() for h in r.intent_hosts] == [h.to_doc() for h in c.intent_hosts],
              f"{label}: intent hosts differ from the CPU's")
        check(shapes[card] == shapes["cpu"], f"{label}: persister shapes "
              f"{shapes[card]} differ from the CPU's {shapes['cpu']}")
        n_docs = 0
        for name in TICK_COLLECTIONS:
            got = stores[card].collection(name).find()
            want = stores["cpu"].collection(name).find()
            check(len(got) == len(want), f"{label}: {name} count differs")
            for g, w in zip(got, want):
                check(g == w, f"{label}: {name} document {w.get('_id')!r} differs "
                      f"from the CPU's")
            n_docs += len(got)
        want_launches = (expected_launches([CapacityConfig().iterations])
                         if planner == "tpu" and on_card else
                         {"fused_distro_stats": 0, "segment_sum": 0})
        check(launches == want_launches, f"{label}: launches {launches}, "
              f"expected {want_launches}")
        for k_, v in launches.items():
            total[k_] = total.get(k_, 0) + v
        log(f"tick {label}: planner {r.planner_used}, degraded {r.degraded!r}, "
            f"overload {r.overload}, shed {r.shed}; {sum(r.queues.values())} queue "
            f"items in {len(r.queues)} queues, {len(r.intent_hosts)} intents; "
            f"persister {shapes[card]}; {n_docs} documents == the CPU's; "
            f"launches {launches} (exact)")
        if planner == "tpu":
            log(f"tick {label} wall ({order[0]} first; ms, card / CPU): " + "; ".join(
                f"{p} {phases[card][p]:.2f} / {phases['cpu'][p]:.2f}"
                for p in TICK_PHASES)
                + f"; whole tick {r.total_ms:.2f} / {c.total_ms:.2f}; of it in "
                f"the garbage collector {gcs[card].ms:.2f} / {gcs['cpu'].ms:.2f} "
                f"({gcs[card].full} / {gcs['cpu'].full} full collections)")
        if k == 0:
            check(shapes[card]["rewritten"] == len(r.queues),
                  f"{label}: not every queue was written")
            check(r.intent_hosts, f"{label}: no intent hosts")
        if k == 1:
            # the churned half splices; the other half patches, or skips
            # where neither the clock nor the intents moved its queue
            check(shapes[card]["rewritten"] == 0 and shapes[card]["spliced"] > 0
                  and shapes[card]["patched"] + shapes[card]["skipped"] > 0,
                  f"{label}: persister shapes {shapes[card]}: expected splices, "
                  f"and patches or skips, and no rewrite")
    return total


#: phase 8: the three stores (name, on the card, TickOptions.use_cache),
#: ticked in this order at each step
SERVICE_STORES = (("card warm", True, True), ("CPU warm", False, True),
                  ("card cold", True, False))


def service_tick_inputs(cls):
    """Wrap ``cls.sync`` (the resident plane's) so that each call records
    its plane, arguments and returned snapshot; returns (records, undo)."""
    real = cls.sync
    records = []

    def sync(self, cache, *args, **kwargs):
        snap = real(self, cache, *args, **kwargs)
        records.append((self, args, snap))
        return snap

    cls.sync = sync
    return records, lambda: setattr(cls, "sync", real)


def mirror_matches_truth(np, snap) -> bool:
    """Whether every field of the mirror's resident buffers on the card
    equals the host truth the snapshot's views read."""
    arena = snap.arena
    bufs = {k: v.cpu().numpy() for k, v in arena.buffers.items()}
    offs = {"f32": 0, "i32": 0, "u8": 0}
    for name, kind, size in arena.layout_key():
        off = offs[kind]
        offs[kind] = off + size
        if bufs[kind][off:off + size].tobytes() != np.asarray(arena.view(name)).tobytes():
            return False
    return True


def slab_stats_row(torch, np, snap, cold, sm_mhz) -> dict:
    """``fused_distro_stats`` on the card at a resident tick's slab
    layout: held against the plain version on the CPU (bit for bit) and
    on the card (counts exact, sums within SUM_RTOL), then its device
    time, the plain version's, the seven ``index_add_``s over
    ``t_distro``, and its bound; the chain is the longest distro range
    the offsets give (slab rows, holes and headroom included). ``cold``
    is a cold build of the same tick's gather (the same live tasks on
    the cold layout): the kernel is held and timed on it too, the two
    layouts alternating, so that a gap between them owes to the layout
    and not to the inputs."""
    from evergreen_tpu_torch.ops.distro_stats import (
        fused_distro_stats,
        fused_distro_stats_plain,
    )
    from evergreen_tpu_torch.ops.packing import unpack
    from evergreen_tpu_torch.ops.solve import distro_stats_inputs

    dev = torch.device("cuda", 0)
    a = unpack(snap.arena.buffers, snap.arena.layout_key(), dev)
    args = distro_stats_inputs(a)
    err = hold_distro_stats(torch, args)
    offs = args[5].cpu().numpy().astype(np.int64)
    counts = np.asarray(snap.arrays["d_task_count"]).astype(np.int64)
    D = len(counts)
    longest = int((offs[1:] - offs[:-1]).max())
    n_ranged = int(offs[-1])
    t_distro = a["t_distro"].long()
    dm = a["t_valid"] & a["t_deps_met"]
    th = args[6][t_distro]
    over = dm & (a["t_expected_s"] > th)
    cols = (a["t_valid"].float(), dm.float(), torch.where(dm, a["t_expected_s"], 0.0),
            over.float(), torch.where(over, a["t_expected_s"], 0.0),
            (dm & (a["t_wait_dep_met_s"] > th)).float(), (dm & a["t_is_merge"]).float())

    def seven_index_adds():
        out = torch.zeros((7, D), dtype=torch.float32, device=dev)
        for k, col in enumerate(cols):
            out[k].index_add_(0, t_distro, col)
        return out

    row = dict(
        name="fused_distro_stats[slab]", route="cuda",
        source="evergreen_tpu_torch/csrc/distro_stats.cu",
        replaces="evergreen_tpu/ops/pallas_kernels.py:71", max_abs_err=err,
        **measure(torch, lambda: fused_distro_stats(*args),
                  lambda: fused_distro_stats_plain(*args), seven_index_adds),
        **bounds(bytes_=11 * n_ranged + 4 * (D + 1) + 4 * D + 4 * 7 * D,
                 ops=9 * n_ranged,
                 chain_ms=1e3 * longest * FADD_CYCLES / (sm_mhz * 1e6)),
    )
    log(f"fused_distro_stats on the slab layout: {int(counts.sum())} live tasks in "
        f"{n_ranged} ranged rows of {len(a['t_valid'])}, {D} distros, longest range "
        f"{longest} (the cold layout's would be {int(counts.max())}); bit-equal to "
        f"plain on the CPU; " + fmt_row(row))
    c_args = distro_stats_inputs(unpack(cold.arena.buffers, cold.arena.layout_key(), dev))
    hold_distro_stats(torch, c_args)
    c_offs = c_args[5].cpu().numpy().astype(np.int64)
    c_longest = int((c_offs[1:] - c_offs[:-1]).max())
    check(int(c_offs[-1]) == int(counts.sum()),
          "the cold build of the slab tick ranges other tasks")
    times = {"slab": [row["ms"]], "cold": []}
    for layout in ("cold", "slab", "cold"):
        a_ = c_args if layout == "cold" else args
        times[layout].append(device_ms(torch, lambda: fused_distro_stats(*a_)))
    log(f"fused_distro_stats on the same tick's cold build: {int(c_offs[-1])} ranged "
        f"rows of {len(c_args[0])}, longest range {c_longest} (chain bound "
        f"{1e6 * c_longest * FADD_CYCLES / (sm_mhz * 1e6):.3f} us); device time per "
        f"call, slab / cold alternating: "
        + ", ".join(f"{layout} {1e3 * t:.2f} us" for layout, t in (
            ("slab", times["slab"][0]), ("cold", times["cold"][0]),
            ("slab", times["slab"][1]), ("cold", times["cold"][1]))))
    return row


def service_phase(torch, np, problem, sm_mhz, card="cuda") -> dict:
    """Phase 8: the service's tick (``TickOptions(use_cache=True)``: the
    TickCache's warm gather and the resident plane, published on the card
    through its device mirror) against the CPU's warm tick and the card's
    cold tick, on three stores. Returns the card stores' launches and
    the slab-layout kernels-line row. ``card="cpu"`` rehearses it on the
    CPU (no launches, no kernels-line row)."""
    import gc
    import itertools
    import random
    import uuid

    from evergreen_tpu_torch.models import distro as distro_mod
    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import resident, wrapper
    from evergreen_tpu_torch.scheduler.persister import persister_state_for
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import faults
    from evergreen_tpu_torch.utils.benchgen import NOW
    from evergreen_tpu_torch.utils.gctune import tune_gc_for_long_lived_heap

    on_card = torch.device(card).type == "cuda"
    distros = problem[0]
    added, removed = distros[-1].id, distros[0].id
    keys = [k for k, _, _ in SERVICE_STORES]
    stores = {k: Store() for k in keys}
    t0 = time.perf_counter()
    for store in stores.values():
        seed_tick_store(store, problem, only={d.id for d in distros[:-1]})
    log(f"service tick: config 3 (seed {SEED}) less {added} in three stores "
        f"({', '.join(keys)}), {time.perf_counter() - t0:.2f} s wall; each step "
        f"ticks them in that order")
    seqs = {k: itertools.count() for k in stores}
    real_uuid4, real_time = uuid.uuid4, time.time
    records, undo = service_tick_inputs(resident.ResidentPlane)

    def distro_churn(store, now):
        tick_churn(store, now)
        seed_tick_store(store, problem, only={added})
        distro_mod.coll(store).remove(removed)

    fault = faults.FaultPlan().always("scheduler.solve", faults.Fault("raise"))
    steps = [
        ("1 (cold prime)", NOW, None, None),
        ("2 (after churn)", NOW + TICK_STEP_S, tick_churn, None),
        ("3 (solve fault)", NOW + 2 * TICK_STEP_S, None, fault),
        (f"4 (+{added}, -{removed}, churn)", NOW + 3 * TICK_STEP_S, distro_churn, None),
        ("5 (quiet)", NOW + 4 * TICK_STEP_S, None, None),
    ]
    total = {k: {} for k in ("card warm", "card cold")}
    slab_row = None
    try:
        for k, (label, now, before, plan) in enumerate(steps):
            if before is not None:
                for store in stores.values():
                    before(store, now)
            results, shapes, phases, gcs, launches = {}, {}, {}, {}, {}
            del records[:]
            for key, card_store, warm in SERVICE_STORES:
                store = stores[key]
                state = persister_state_for(store)
                shapes0 = [getattr(state, s_) for s_ in SHAPES]
                phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in TICK_PHASES}
                plane = resident.peek_resident_plane(store)
                up0 = plane.stats().get("mirror_bytes_uploaded", 0) if plane else 0
                if k == 0:
                    gc.collect()
                gcs[key] = GcClock()
                gc.callbacks.append(gcs[key])
                if plan is not None:
                    faults.install(plan)
                reset_launches(fused_distro_stats, segment_sum)
                rng = random.Random(2000 + k)
                uuid.uuid4 = lambda rng=rng: uuid.UUID(int=rng.getrandbits(128))
                time.time = lambda now=now: now
                event_mod._SEQ = seqs[key]
                try:
                    results[key] = wrapper.run_tick(
                        store, wrapper.TickOptions(use_cache=warm), now=now,
                        device=card if card_store else "cpu")
                finally:
                    uuid.uuid4, time.time = real_uuid4, real_time
                    gc.callbacks.remove(gcs[key])
                    faults.uninstall()
                launches[key] = read_launches(fused_distro_stats, segment_sum)
                shapes[key] = {s_: getattr(state, s_) - v for s_, v in zip(SHAPES, shapes0)}
                phases[key] = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p]
                               for p in TICK_PHASES}
                if key == "card warm":
                    plane = resident.peek_resident_plane(store)
                    uploaded = plane.stats()["mirror_bytes_uploaded"] - up0
            if k == 0:
                tune_gc_for_long_lived_heap()
            r = results["card warm"]
            solve_tick = plan is None
            want = ("tpu", "") if solve_tick else ("serial", "solve-failed")
            for key in keys:
                c = results[key]
                check((c.planner_used, c.degraded) == want,
                      f"tick {label} {key}: planner {c.planner_used!r}, degraded "
                      f"{c.degraded!r}")
                for field in ("queues", "new_hosts", "n_tasks", "n_distros", "shed",
                              "overload"):
                    check(getattr(c, field) == getattr(r, field),
                          f"tick {label}: TickResult.{field} of {key} differs")
                check([h.to_doc() for h in c.intent_hosts]
                      == [h.to_doc() for h in r.intent_hosts],
                      f"tick {label}: intent hosts of {key} differ")
                check(shapes[key] == shapes["card warm"],
                      f"tick {label}: persister shapes of {key} {shapes[key]} differ "
                      f"from {shapes['card warm']}")
            n_docs = 0
            for name in TICK_COLLECTIONS:
                want_docs = stores["card warm"].collection(name).find()
                for key in keys[1:]:
                    got = stores[key].collection(name).find()
                    check(len(got) == len(want_docs), f"tick {label}: {name} count "
                          f"of {key} differs")
                    for g, w in zip(got, want_docs):
                        check(g == w, f"tick {label}: {name} document {w.get('_id')!r} "
                              f"of {key} differs from the card's warm store")
                n_docs += len(want_docs)
            cold_l, warm_l = launches["card cold"], launches["card warm"]
            check(warm_l["fused_distro_stats"] == (1 if solve_tick and on_card else 0)
                  and warm_l == cold_l and launches["CPU warm"]["segment_sum"] == 0,
                  f"tick {label}: launches warm {warm_l}, cold {cold_l}")
            for key in total:
                for k_, v in launches[key].items():
                    total[key][k_] = total[key].get(k_, 0) + v
            planes = {key: resident.peek_resident_plane(stores[key])
                      for key in ("card warm", "CPU warm")}
            stats = {key: {s_: v for s_, v in p.stats().items()
                           if not s_.startswith("mirror")}
                     for key, p in planes.items()}
            check(stats["card warm"] == stats["CPU warm"],
                  f"tick {label}: resident counters card {stats['card warm']} != "
                  f"CPU {stats['CPU warm']}")
            check(stats["card warm"]["fallbacks"] == 0, f"tick {label}: resident fallback")
            check(planes["card warm"].device.type == torch.device(card).type
                  and planes["CPU warm"].device.type == "cpu",
                  f"tick {label}: the planes publish on the wrong devices")
            # the card plane's snapshot of this tick: canonical == a cold
            # build of the same gather, and the mirror == the host truth
            mine = [(args, snap) for plane_, args, snap in records
                    if plane_ is planes["card warm"]]
            check(len(mine) == 1, f"tick {label}: {len(mine)} card-plane syncs")
            args, snap = mine[0]
            t1 = time.perf_counter()
            cold = build_snapshot(*args[:5], args[5])
            check(resident.canonicalize(snap) == resident.canonicalize(cold),
                  f"tick {label}: the card plane's snapshot differs from a cold build")
            check(mirror_matches_truth(np, snap),
                  f"tick {label}: the card's mirror differs from the host truth")
            check_ms = (time.perf_counter() - t1) * 1e3
            full = sum(b.numel() * b.element_size() for b in snap.arena.buffers.values())
            if k == 1 and on_card:
                slab_row = slab_stats_row(torch, np, snap, cold, sm_mhz)
            log(f"tick {label}: planner {r.planner_used}, degraded {r.degraded!r}; "
                f"{sum(r.queues.values())} queue items in {len(r.queues)} queues, "
                f"{len(r.intent_hosts)} intents; persister {shapes['card warm']}; "
                f"{n_docs} documents equal in all three stores; launches warm "
                f"{warm_l} == cold; resident {stats['card warm']}; canonical == cold "
                f"build and mirror == truth ({check_ms:.0f} ms to check)")
            log(f"tick {label} wall (ms; " + " / ".join(keys) + "): " + "; ".join(
                f"{p} " + " / ".join(f"{phases[key][p]:.2f}" for key in keys)
                for p in TICK_PHASES)
                + "; whole tick " + " / ".join(f"{results[key].total_ms:.2f}" for key in keys)
                + "; of it in the garbage collector "
                + " / ".join(f"{gcs[key].ms:.2f}" for key in keys)
                + " (" + " / ".join(str(gcs[key].full) for key in keys)
                + " full collections)")
            log(f"tick {label} mirror: {uploaded} B H2D, a full upload of this "
                f"arena {full} B ({100.0 * uploaded / full:.1f}%)")
    finally:
        undo()
    return dict(launches=total, slab_row=slab_row)


#: phase 9: the sharded plane's shard count, its three planes (name, the
#: plane's device, its stacking rule), the collections compared after
#: each round and the round whose shard 0 is held at YELLOW
PLANE_SHARDS = 4
PLANES = (("a", "cuda", "always"), ("b", "cuda", "auto"), ("c", "cpu", "never"))
PLANE_COLLECTIONS = ("distros",) + TICK_COLLECTIONS + ("shard_handoffs",)
PLANE_ROUNDS = ("1 (prime)", "2 (after churn)", "3 (shard 0 YELLOW)",
                "4 (after the handoff, profiled)")
YELLOW_ROUND = 2
PROFILED_ROUND = 3
#: plane (a)'s modes: round 1 measures the shards' common dims (local);
#: round 2 stacks, or is local only where round 1's intents grew some
#: shard's dims past that floor ("grown"); every later round stacks
PLANE_A_MODES = ("local", "stacked or grown", "stacked", "stacked")


def canon_doc(doc):
    """``doc``, or a copy with the ids that depend on how the shard
    threads interleave canonicalised: an event's id, an intent host's id
    (its distro kept) and secret, and those inside handoff payloads."""
    if doc["_id"].startswith("evt-"):
        return dict(doc, _id="evt")
    if doc["_id"].startswith("evg-") and doc.get("status") == "initializing":
        return dict(doc, _id=doc["_id"].rsplit("-", 1)[0], secret="")
    if "payload" in doc:
        return dict(doc, payload={c: [canon_doc(d) for d in ds]
                                  for c, ds in doc["payload"].items()})
    return doc


def same_plane_docs(planes, label) -> int:
    """Check every shard store's documents equal across ``planes``
    (name -> plane), ids canonicalised; returns how many were compared."""
    names = list(planes)
    n = 0
    for k in range(PLANE_SHARDS):
        for coll in PLANE_COLLECTIONS:
            want = [canon_doc(d) for d in planes[names[0]].stores[k].collection(coll).find()]
            for name in names[1:]:
                got = planes[name].stores[k].collection(coll).find()
                check(len(got) == len(want), f"{label}: shard {k} {coll} count of "
                      f"plane {name} differs from plane {names[0]}'s")
                for g, w in zip(got, want):
                    check(canon_doc(g) == w, f"{label}: shard {k} {coll} document "
                          f"{w['_id']!r} of plane {name} differs from plane {names[0]}'s")
            n += len(want)
    return n


def make_planes(problem, specs, opts, card):
    """One plane per (name, device, stacked) of ``specs`` over
    ``PLANE_SHARDS`` shard stores, each split by ``seed_partition`` from
    its own store of config 3 with phase 6's capacity settings (which
    every shard store gets too)."""
    from evergreen_tpu_torch.scheduler.sharded_plane import ShardedScheduler
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store

    planes = {}
    for name, device, stacked in specs:
        src = Store()
        seed_tick_store(src, problem)
        plane = planes[name] = ShardedScheduler.build(
            PLANE_SHARDS, device=card if device == "cuda" else "cpu",
            stacked=stacked, tick_opts=opts, rebalance_enabled=True)
        plane.seed_partition(src)
        for s in plane.stores:
            CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET).set(s)
    return planes


def timed_stacked_solve(plane):
    """Wrap ``plane._stacked_solve``; returns a list of (ms, drift) per
    call: drift is None when the shards' padded dims agreed, else (the
    floor they were built at, their padded dims in shard order)."""
    calls = []
    real = plane._stacked_solve

    def solve(snaps):
        floor = plane._common_dims
        keys = [snaps[k].shape_key() for k in sorted(snaps)]
        t0 = time.perf_counter()
        try:
            out = real(snaps)
        except ValueError:
            calls.append(((time.perf_counter() - t0) * 1e3, (floor, keys)))
            raise
        calls.append(((time.perf_counter() - t0) * 1e3, None))
        return out

    plane._stacked_solve = solve
    return calls


def grown_past_floor(floor, keys) -> bool:
    """Whether a drift is the one the floor allows: every shard built at
    or above the floor on every axis, and some shard above it."""
    if floor is None:
        return True  # no floor yet: the first round's natural dims
    names = ("N", "M", "U", "G", "H", "D")
    return (all(k[i] >= floor[n] for k in keys for i, n in enumerate(names))
            and any(k[i] > floor[n] for k in keys for i, n in enumerate(names)))


def check_plane_a_mode(r, label, mode, drift, modes=PLANE_A_MODES) -> None:
    """Hold a stacking card plane's mode in round ``r`` to ``modes``
    (phase 9's plane (a): ``PLANE_A_MODES``; phase 10's durable fleet:
    ``FLEET_MODES``)."""
    want = modes[r]
    if want == "stacked or grown" and drift:
        ok = mode == "local" and all(grown_past_floor(f, k) for f, k in drift)
    else:
        ok = mode == want.split()[0] and (not drift or want == "local")
    check(ok, f"round {label}: {mode}, expected {want} (stacked solve drift {drift})")


def profiled_tick(torch, plane, now) -> tuple:
    """One round of ``plane`` under torch.profiler: its result, and the
    round's wall, the device's busy time (every kernel, copy and memset),
    its idle share of the wall, and the host's time in CUDA
    synchronisation calls summed over the shard threads and at most in
    one thread, with the count of kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = plane.tick(now=now)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, sync_us, sync_by_thread, n_launch = 0.0, 0.0, {}, 0
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            busy_us += us
        elif e.name.endswith("Synchronize"):
            sync_us += us
            sync_by_thread[e.thread] = sync_by_thread.get(e.thread, 0.0) + us
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            n_launch += 1
    check(busy_us > 0, "the profiled round saw no device time")
    return res, dict(
        wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / wall_us, sync_ms=sync_us / 1e3,
        sync_max_thread_ms=max(sync_by_thread.values(), default=0.0) / 1e3,
        kernel_launches=n_launch)


def sharded_phase(torch, np, problem, card="cuda") -> dict:
    """Phase 9: the sharded plane at config 3 over four shard stores on
    one card, in three planes ticked round by round. Returns the card
    planes' launches. ``card="cpu"`` rehearses it on the CPU."""
    from evergreen_tpu_torch.ops import distro_stats
    from evergreen_tpu_torch.ops._build import KernelError
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import resident, sharded_plane, wrapper
    from evergreen_tpu_torch.scheduler.sharded_plane import (
        SHARD_TICK_MS,
        fleet_owner_violations,
        merge_fleet_state,
    )
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import overload
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    t0 = time.perf_counter()
    planes = make_planes(problem, PLANES, wrapper.TickOptions(use_cache=True), card)
    counts = [s.collection("distros").count() for s in planes["a"].stores]
    log(f"sharded plane: config 3 (seed {SEED}) split over {PLANE_SHARDS} shard stores "
        f"({counts} distros), three planes: " + ", ".join(
            f"({n}) {d} stacked={st!r}" for n, d, st in PLANES)
        + f"; {time.perf_counter() - t0:.2f} s wall to seed them")
    stacked_calls = timed_stacked_solve(planes["a"])
    iters = CapacityConfig().iterations
    real_time = time.time
    total = {name: {} for name, device, _ in PLANES if device == "cuda"}
    a_modes = []
    try:
        for r, label in enumerate(PLANE_ROUNDS):
            now = NOW + r * TICK_STEP_S
            if r == 1:
                for plane in planes.values():
                    for s in plane.stores:
                        tick_churn(s, now)
            for plane in planes.values():
                overload.monitor_for(plane.stores[0]).set_floor(
                    overload.YELLOW if r == YELLOW_ROUND else overload.GREEN)
            res, launches, shard_ms, phases, mirror, full = {}, {}, {}, {}, 0, 1
            traced = {}
            n_calls = len(stacked_calls)
            for name, plane in planes.items():
                shard0 = [SHARD_TICK_MS.state(shard=k)[1] for k in range(PLANE_SHARDS)]
                phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in TICK_PHASES}
                up0 = sum(resident.peek_resident_plane(s).stats().get("mirror_bytes_uploaded", 0)
                          for s in plane.stores if resident.peek_resident_plane(s))
                reset_launches(fused_distro_stats, segment_sum)
                time.time = lambda: now
                try:
                    if r == PROFILED_ROUND and on_card and plane.device.type == "cuda":
                        res[name], traced[name] = profiled_tick(torch, plane, now)
                    else:
                        res[name] = plane.tick(now=now)
                finally:
                    time.time = real_time
                launches[name] = read_launches(fused_distro_stats, segment_sum)
                shard_ms[name] = [SHARD_TICK_MS.state(shard=k)[1] - shard0[k]
                                  for k in range(PLANE_SHARDS)]
                phases[name] = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p]
                                for p in TICK_PHASES}
                if name == "b":
                    rplanes = [resident.peek_resident_plane(s) for s in plane.stores]
                    mirror = sum(p_.stats().get("mirror_bytes_uploaded", 0)
                                 for p_ in rplanes) - up0
                    full = sum(b.nbytes for p_ in rplanes
                               for b in p_._truth.buffers.values())
            drift = [d for _, d in stacked_calls[n_calls:] if d is not None]
            solve_ms = [ms for ms, d in stacked_calls[n_calls:] if d is None]
            n_docs = same_plane_docs(planes, f"round {label}")
            for name, plane in planes.items():
                check(fleet_owner_violations(plane.stores) == [],
                      f"round {label}: plane {name} violates exactly-one-owner")
                check(not res[name].degraded, f"round {label}: plane {name} degraded "
                      f"{res[name].degraded}")
                check(res[name].migrations == res["a"].migrations,
                      f"round {label}: plane {name}'s migrations differ from (a)'s")
                check(res[name].fleet_level == res["a"].fleet_level,
                      f"round {label}: plane {name}'s fleet level differs")
            modes = {name: res[name].solve_mode for name in planes}
            check_plane_a_mode(r, label, modes["a"], drift)
            check(modes["b"] == modes["c"] == "local", f"round {label}: modes {modes}")
            a_modes.append(modes["a"])
            check((r == YELLOW_ROUND) == bool(res["a"].migrations),
                  f"round {label}: migrations {res['a'].migrations}")
            for name, plane in planes.items():
                blocks = sum(1 for x in res[name].results.values() if x.planner_used == "tpu")
                check(blocks == PLANE_SHARDS, f"round {label}: plane {name} solved "
                      f"{blocks} blocks")
                on = on_card and dict((n, d) for n, d, _ in PLANES)[name] == "cuda"
                want = (expected_launches([iters] * blocks) if on
                        else {"fused_distro_stats": 0, "segment_sum": 0})
                check(launches[name] == want, f"round {label}: plane {name} launches "
                      f"{launches[name]}, expected {want}")
                if name in total:
                    for k_, v in launches[name].items():
                        total[name][k_] = total[name].get(k_, 0) + v
            log(f"sharded round {label}: modes " + ", ".join(
                f"({n}) {m}" for n, m in modes.items())
                + f" (stacked solve drift {drift}); migrations "
                + json.dumps([{k: m[k] for k in ("_id", "group", "from", "to")}
                              for m in res["a"].migrations])
                + f"; fleet {res['a'].fleet_level}; {res['a'].n_tasks} tasks, "
                f"{sum(len(x.intent_hosts) for x in res['a'].results.values())} intents; "
                f"{n_docs} documents equal in the three planes; launches per plane "
                + json.dumps({n: launches[n]['fused_distro_stats'] for n in planes})
                + " fused_distro_stats (exact)")
            log(f"sharded round {label} wall (ms, " + " / ".join(planes) + "): round "
                + " / ".join(f"{res[n].total_ms:.2f}" for n in planes)
                + "; shard ticks " + " / ".join(
                    "[" + ", ".join(f"{v:.2f}" for v in shard_ms[n]) + "]" for n in planes)
                + "; phases summed over shards: " + "; ".join(
                    f"{p} " + " / ".join(f"{phases[n][p]:.2f}" for n in planes)
                    for p in TICK_PHASES)
                + "; stacked solve " + (", ".join(f"{ms:.2f}" for ms in solve_ms)
                                        if solve_ms else "none")
                + f"; plane (b) mirror {mirror} B H2D, a full upload of its four "
                f"arenas {full} B ({100.0 * mirror / full:.1f}%)")
            for name, t in traced.items():
                log(f"sharded round {label} plane ({name}) under torch.profiler: "
                    f"wall {t['wall_ms']:.2f} ms, device busy {t['busy_ms']:.2f} ms "
                    f"(idle share {100 * t['idle_share']:.1f}%), host in CUDA "
                    f"synchronisation {t['sync_ms']:.2f} ms summed over the shard "
                    f"threads ({t['sync_max_thread_ms']:.2f} ms in the most waiting "
                    f"one), {t['kernel_launches']} kernel launches")
    finally:
        time.time = real_time
        for plane in planes.values():
            plane.close()
    del planes
    log(f"sharded plane (a) modes {a_modes}; required {list(PLANE_A_MODES)}")

    # the merged queues of a stacked plane equal a single store's tick
    # (no intents: the fleet budget split is the plane's own), then a
    # failed launch inside its stacked solve raises out of the round
    opts = wrapper.TickOptions(use_cache=True, create_intent_hosts=False)
    planes = make_planes(problem, (("a", "cuda", "always"),), opts, card)
    plane = planes["a"]
    single = Store()
    seed_tick_store(single, problem)
    oracle_modes = []
    try:
        for r in range(2):
            now = NOW + r * TICK_STEP_S
            reset_launches(fused_distro_stats, segment_sum)
            oracle_modes.append(plane.tick(now=now).solve_mode)
            got = read_launches(fused_distro_stats, segment_sum)
            check(got == (expected_launches([0] * PLANE_SHARDS) if on_card else
                          {"fused_distro_stats": 0, "segment_sum": 0}),
                  f"oracle round {r + 1}: launches {got}")
            wrapper.run_tick(single, wrapper.TickOptions(create_intent_hosts=False),
                             now=now, device=card)
            merged = merge_fleet_state(plane.stores)
            for coll in ("task_queues", "task_secondary_queues"):
                want = sorted(single.collection(coll).find(), key=lambda d: d["_id"])
                got_q = sorted(merged.collection(coll).find(), key=lambda d: d["_id"])
                check(got_q == want, f"oracle round {r + 1}: merged {coll} differ from "
                      f"the single store's")
        check(oracle_modes == ["local", "stacked"], f"oracle modes {oracle_modes}")
        local = []
        real_local = sharded_plane.run_solve_packed
        real_launch = distro_stats._launch_fn
        sharded_plane.run_solve_packed = lambda *a, **k: local.append(1) or real_local(*a, **k)
        distro_stats._launch_fn = lambda: (lambda *args: 719)
        raised = None
        try:
            plane.tick(now=NOW + 2 * TICK_STEP_S)
        except KernelError as exc:
            raised = exc
        finally:
            sharded_plane.run_solve_packed = real_local
            distro_stats._launch_fn = real_launch
        if on_card:
            check(raised is not None and local == [],
                  f"a failed launch in the stacked solve: raised {raised!r}, "
                  f"{len(local)} local solves")
    finally:
        plane.close()
    log(f"sharded oracle: a fresh plane (a) without intents, rounds {oracle_modes}, "
        f"merged queues == a single store's card tick after each; a failed launch "
        f"in its stacked solve raised {raised!r} out of tick() with no local solve")
    return total


#: phase 10: the service's tick as ``units/crons.py`` runs it, on durable
#: stores. The stores (name, on the card, durable), ticked in this order
#: at each step: (a) durable on the card, (b) durable on the CPU, (c) the
#: in-memory card store of phase 8, the control
DURABLE_STORES = (("a", True, True), ("b", False, True), ("c", True, False))
#: the writer leases' TTL, and where the data directories live (inside
#: the checkout, gitignored, removed at the end of the phase)
LEASE_TTL_S = 2.0
DATA_ROOT = os.path.join(HERE, "_smoke_data")
#: the fleet's rounds (shard 0 held YELLOW in the third)
FLEET_ROUNDS = ("1 (prime)", "2 (after churn)", "3 (shard 0 YELLOW)", "4 (quiet)")
FLEET_YELLOW = 2
#: the durable card fleet's modes, held as phase 9 holds plane (a)'s; the
#: fifth round is the reopened fleet's first, local (its dims floor cold)
FLEET_MODES = ("local", "stacked or grown", "stacked", "stacked", "local")


def service_opts(wrapper):
    """``units/crons.py``'s tick options, its sharded round's too."""
    return wrapper.TickOptions(use_cache=True, async_persist=True,
                               solve_deadline_s=10.0, tick_budget_s=12.0)


def wal_path(store) -> str:
    return store._journal.path


def wal_lines(path, start=0) -> list:
    """The WAL's terminated lines from byte ``start`` on."""
    with open(path, "rb") as fh:
        fh.seek(start)
        return [line for line in fh.read().split(b"\n") if line]


def canon_record(rec: dict) -> dict:
    """A WAL record without its commit time and stamp (the flusher writes
    a frame whenever its thread runs), documents as ``canon_doc``."""
    rec = {k: v for k, v in rec.items() if k not in ("ts", "k")}
    if "rs" in rec:
        rec["rs"] = [canon_record(r) for r in rec["rs"]]
    if "d" in rec:
        rec["d"] = canon_doc(rec["d"])
    if "ds" in rec:
        rec["ds"] = [canon_doc(d) for d in rec["ds"]]
    return rec


#: the fields a queue document's write stamps (``generated_at``, the
#: version ``v``): a store whose persister is fresh (reopened after a
#: crash, or a new lease holder's) rewrites every queue document once,
#: where a live store skips the unchanged ones
QUEUE_STAMPS = ("generated_at", "v")


def store_json(store, names=None, stamps=True) -> str:
    """Every collection (or ``names``) of ``store`` as canonical JSON: a
    recovered store holds the JSON of the live one (a queue row is a
    tuple in memory and a list after replay). ``stamps=False`` leaves
    out the queue documents' ``QUEUE_STAMPS``."""
    if names is None:  # every collection that holds a document
        names = [n for n in sorted(store._collections) if len(store.collection(n))]

    def docs(n):
        found = store.collection(n).find()
        if stamps or n not in ("task_queues", "task_secondary_queues"):
            return found
        return [{k: v for k, v in d.items() if k not in QUEUE_STAMPS} for d in found]

    return json.dumps({n: docs(n) for n in names},
                      sort_keys=True, separators=(",", ":"), default=str)


def timed_method(store, name) -> list:
    """Wrap ``store``'s method ``name`` (``sync_persist``: the tick's
    persist barrier; ``commit_group_inline``: a frame's write on the
    flusher thread); returns the list each call appends its wall ms to."""
    real = getattr(store, name)
    ms = []

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return real(*args)
        finally:
            ms.append((time.perf_counter() - t0) * 1e3)

    setattr(store, name, timed)
    return ms


def wait_flushed(store) -> float:
    """Wait until ``store``'s flusher is idle without taking its deferred
    errors (the next tick's barrier does); returns the ms waited."""
    t0 = time.perf_counter()
    while store.flush_backlog():
        time.sleep(0.001)
    return (time.perf_counter() - t0) * 1e3


def durable_phase(torch, np, problem, card="cuda", root=DATA_ROOT) -> dict:
    """Phase 10: the service's tick (``service_opts``) on durable stores —
    the WAL group commit on the flusher, replay after a crash, a torn
    frame, the epoch fence — and the durable sharded fleet. Returns the
    card's launches by store. ``card="cpu"`` rehearses it on the CPU."""
    import gc
    import itertools
    import random
    import shutil
    import uuid

    from evergreen_tpu_torch.models import event as event_mod
    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import resident, wrapper
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage import durable
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.lease import FileLease
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    opts = service_opts(wrapper)
    phases = TICK_PHASES + ("wal_commit",)
    iters = CapacityConfig().iterations
    solve_launches = (expected_launches([iters]) if on_card
                      else {"fused_distro_stats": 0, "segment_sum": 0})
    no_launches = {"fused_distro_stats": 0, "segment_sum": 0}
    distros = problem[0]
    keep = {d.id for d in distros[:-1]}
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: os.path.join(root, k) for k in ("a", "b", "fleet")}
    leases, stores, seed_ms = {}, {}, {}
    for key, on, is_durable in DURABLE_STORES:
        t0 = time.perf_counter()
        if is_durable:
            lease = leases[key] = FileLease(os.path.join(dirs[key], "writer.lease"),
                                            ttl_s=LEASE_TTL_S)
            check(lease.try_acquire(), f"store ({key}): lease not acquired")
            lease.start_renewing()
            stores[key] = DurableStore(dirs[key], lease=lease)
        else:
            stores[key] = Store()
        seed_tick_store(stores[key], problem, only=keep)
        seed_ms[key] = (time.perf_counter() - t0) * 1e3
    devices = {k: (card if on else "cpu") for k, on, _ in DURABLE_STORES}
    # the stores reopened later: (a)'s crash copy and its thief on the
    # card, and their comparators, (b)'s, on the CPU
    devices.update({"replayed": card, "thief": card, "replayed-b": "cpu"})
    log(f"durable tick: config 3 (seed {SEED}) less {distros[-1].id} in (a) a DurableStore "
        f"on the card, (b) one on the CPU, (c) the in-memory card store; leases "
        f"{LEASE_TTL_S} s, renewing; seeding ms (a) {seed_ms['a']:.1f}, (b) "
        f"{seed_ms['b']:.1f}, (c) {seed_ms['c']:.1f}; WAL bytes (a) "
        f"{os.path.getsize(wal_path(stores['a']))}, (b) "
        f"{os.path.getsize(wal_path(stores['b']))}")
    barriers, writes = {}, {}

    def watch(key, store):
        """Time ``store``'s barriers and frame writes under ``key``."""
        barriers[key] = timed_method(store, "sync_persist")
        writes[key] = timed_method(store, "commit_group_inline")

    for key in ("a", "b"):
        watch(key, stores[key])
    seqs = {k: itertools.count() for k in stores}
    real_uuid4, real_time = uuid.uuid4, time.time
    launches_by = {"a": {}, "c": {}, "replayed": {}, "thief": {}, "fleet": {}}

    def add(key, got):
        for k_, v in got.items():
            launches_by[key][k_] = launches_by[key].get(k_, 0) + v

    def tick(key, store, k, now, device):
        """One tick of ``store``; the k-th tick of every store draws the
        same uuid4 stream, reads the same clock and continues the event
        sequence of ``key``. Returns (result, launches, phases, gc ms)."""
        phase0 = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] for p in phases}
        clock = GcClock()
        gc.callbacks.append(clock)
        reset_launches(fused_distro_stats, segment_sum)
        rng = random.Random(3000 + k)
        uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128))
        time.time = lambda: now
        event_mod._SEQ = seqs[key]
        try:
            res = wrapper.run_tick(store, opts, now=now, device=device)
        finally:
            uuid.uuid4, time.time = real_uuid4, real_time
            gc.callbacks.remove(clock)
        got = read_launches(fused_distro_stats, segment_sum)
        ph = {p: wrapper.TICK_PHASE_MS.state(phase=p)[1] - phase0[p] for p in phases}
        return res, got, ph, clock.ms

    def mirror_bytes(store):
        plane = resident.peek_resident_plane(store)
        stats = plane.stats() if plane is not None else {}
        full = (sum(b.nbytes for b in plane._truth.buffers.values())
                if plane is not None and plane._truth is not None else 0)
        return stats.get("mirror_bytes_uploaded", 0), full

    def same_docs(keyed, label, fresh=()):
        """Every document of ``TICK_COLLECTIONS`` equal across the stores
        of ``keyed`` (name -> store), as canonical JSON. A store whose persister is
        fresh (``fresh``: reopened after a crash, or a new lease holder's)
        rewrites the queue documents that a live store's tick skips: the
        fresh stores are held to each other with every field, and to the
        live ones without the queue documents' ``QUEUE_STAMPS``. Returns
        the count of documents and of queue documents whose stamps differ
        between the first fresh store and the first live one."""
        full = {k: store_json(s, TICK_COLLECTIONS) for k, s in keyed.items()}
        for group in ([k for k in keyed if k not in fresh], [k for k in keyed if k in fresh]):
            for k in group[1:]:
                check(full[k] == full[group[0]],
                      f"{label}: the documents of {k} differ from {group[0]}'s")
        n_docs = sum(len(next(iter(keyed.values())).collection(n)) for n in TICK_COLLECTIONS)
        if not fresh:
            return n_docs, 0
        bare = {k: store_json(s, TICK_COLLECTIONS, stamps=False) for k, s in keyed.items()}
        live = next(k for k in keyed if k not in fresh)
        for k in fresh:
            check(bare[k] == bare[live], f"{label}: the documents of {k} differ from "
                  f"{live}'s beyond the queue documents' {QUEUE_STAMPS}")
        restamped = sum(
            1 for n in ("task_queues", "task_secondary_queues")
            for d, e in zip(keyed[fresh[0]].collection(n).find(),
                            keyed[live].collection(n).find())
            if any(d.get(f) != e.get(f) for f in QUEUE_STAMPS))
        return n_docs, restamped

    def report(label, step):
        for key, (res, ph, gc_ms, extra, up) in step.items():
            mirror = (f"; mirror {up[0]} B H2D of a full {up[1]} B "
                      f"({100.0 * up[0] / max(1, up[1]):.1f}%)" if up[1] else "")
            log(f"durable tick {label} ({key}) ms: " + "; ".join(
                f"{p} {ph[p]:.2f}" for p in phases)
                + f"; whole tick {res.total_ms:.2f}; collector {gc_ms:.2f}" + extra
                + mirror)

    def durable_extra(key, store, start):
        """The WAL side of a durable store's tick, once its frame is
        written: bytes appended, the frame's write on the flusher, what
        the check waited for it, and the barrier at the tick's start (the
        previous frame's)."""
        waited = wait_flushed(store)
        wal0, n_writes, n_barriers = start
        new_w = writes[key][n_writes:]
        new_b = barriers[key][n_barriers:]
        return (f"; WAL +{os.path.getsize(wal_path(store)) - wal0} B; frame "
                f"write on the flusher " + ", ".join(f"{w:.2f}" for w in new_w)
                + f" (still running when checked: {waited:.2f} ms); barrier at this "
                f"tick's start " + (f"{new_b[0]:.3f}" if new_b else "none"))

    def tick_checked(key, store, k, now, label, step, starts):
        """The k-th tick of ``store`` on ``devices[key]``, held to a clean
        solve (planner tpu, not degraded) and a solve tick's launches; its
        report line goes into ``step`` and, for a durable store, what its
        WAL side is measured from into ``starts``. Returns the result."""
        dev = devices[key]
        if key in writes:
            starts[key] = (os.path.getsize(wal_path(store)), len(writes[key]),
                           len(barriers[key]))
        up0 = mirror_bytes(store)[0]
        res, got, ph, gc_ms = tick(key, store, k, now, dev)
        up = mirror_bytes(store)
        step[key] = [res, ph, gc_ms, "", (up[0] - up0, up[1])]
        check((res.planner_used, res.degraded) == ("tpu", ""),
              f"tick {label} ({key}): planner {res.planner_used!r}, degraded "
              f"{res.degraded!r}")
        want = solve_launches if dev != "cpu" else no_launches
        check(got == want, f"tick {label} ({key}): launches {got}, expected {want}")
        if key in launches_by:
            add(key, got)
        return res

    def wal_side(keyed, step, starts, label, pairs):
        """Each durable store's WAL side of the step, once its frame is
        written, into its report line; each store's records of the step
        held to one group frame, and those of each pair in ``pairs``
        equal (canonical)."""
        frames = {}
        for key, start in starts.items():
            step[key][3] = durable_extra(key, keyed[key], start)
            recs = [json.loads(x) for x in wal_lines(wal_path(keyed[key]), start[0])]
            n_frames = sum(1 for x in recs if x["o"] == "g")
            check(n_frames == 1, f"tick {label} ({key}): {n_frames} group frames")
            frames[key] = [canon_record(x) for x in recs]
        for x, y in pairs:
            check(frames[x] == frames[y], f"tick {label}: the WAL records of ({x}) and "
                  f"({y}) differ")
        return frames

    def crash_copy(key, src):
        """A copy of ``src`` as a SIGKILL leaves it (the store not closed;
        a lease's tmp file, which its renewer may be renaming, left out)."""
        dst = os.path.join(root, key)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.lease.*"))
        return dst

    def replay(key, path, lease=None):
        """``DurableStore(path)`` as ``key``, its barriers and frame writes
        timed; returns the open's ms."""
        t0 = time.perf_counter()
        stores[key] = DurableStore(path, lease=lease)
        ms = (time.perf_counter() - t0) * 1e3
        watch(key, stores[key])
        return ms

    steps = [("1 (prime)", NOW, None), ("2 (after churn)", NOW + TICK_STEP_S, tick_churn),
             ("3 (quiet)", NOW + 2 * TICK_STEP_S, None)]
    try:
        for k, (label, now, before) in enumerate(steps):
            if before is not None:
                for store in stores.values():
                    before(store, now)
            step, starts = {}, {}
            results = {key: tick_checked(key, stores[key], k, now, label, step, starts)
                       for key in ("a", "b", "c")}
            r = results["a"]
            for key in ("b", "c"):
                for field in ("queues", "new_hosts", "n_tasks", "n_distros", "shed"):
                    check(getattr(results[key], field) == getattr(r, field),
                          f"tick {label}: TickResult.{field} of ({key}) differs from (a)'s")
            n_docs, _ = same_docs(stores, f"tick {label}")
            frames = wal_side(stores, step, starts, label, [("a", "b")])
            log(f"durable tick {label}: planner tpu in all three; {sum(r.queues.values())} "
                f"queue items in {len(r.queues)} queues, {len(r.intent_hosts)} intents; "
                f"{n_docs} documents equal in (a), (b), (c); one group frame a durable "
                f"store, records (a) == (b) ({len(frames['a'])} lines); launches "
                f"{solve_launches['fused_distro_stats']} + {solve_launches['segment_sum']} "
                f"in (a) and (c), 0 in (b)")
            report(label, step)

        # ---- crash after tick 3's barrier, and replay ------------------- #
        # (a)'s copy reopens on the card; (b)'s on the CPU is its fresh
        # persister's comparator
        for key in ("a", "b"):
            stores[key].sync_persist()
        replay_ms = replay("replayed", crash_copy("a-crashed", dirs["a"]))
        replay_b_ms = replay("replayed-b", crash_copy("b-crashed", dirs["b"]))
        replayed = stores["replayed"]
        check(store_json(replayed) == store_json(stores["a"]),
              "the replayed copy differs from (a)")
        check(store_json(stores["replayed-b"]) == store_json(stores["b"]),
              "the replayed copy of (b) differs from (b)")
        log(f"durable crash: (a) and (b) copied after tick 3's barrier without closing; "
            f"DurableStore(copy of (a)) replayed in {replay_ms:.2f} ms "
            f"({os.path.getsize(wal_path(replayed))} WAL bytes, report "
            f"{replayed.replay_report}), (b)'s in {replay_b_ms:.2f} ms; every document "
            f"equal to the original's")
        for key, copied in (("a", "replayed"), ("b", "replayed-b")):
            n = next(seqs[key])
            seqs[key], seqs[copied] = itertools.count(n), itertools.count(n)
        label, now = "4 (after churn)", NOW + 3 * TICK_STEP_S
        tick4 = {k: stores[k] for k in ("a", "b", "c", "replayed", "replayed-b")}
        for store in tick4.values():
            tick_churn(store, now)
        before4 = store_json(stores["a"])
        step, starts = {}, {}
        for key, store in tick4.items():
            tick_checked(key, store, 3, now, label, step, starts)
        wal_side(tick4, step, starts, label, [("a", "b"), ("replayed", "replayed-b")])
        n_docs, restamped = same_docs(tick4, f"tick {label}", fresh=("replayed", "replayed-b"))
        plane = resident.peek_resident_plane(replayed)
        check(plane.rebuild_reasons == {"cold": 1},
              f"the replayed store's plane rebuilt {plane.rebuild_reasons}")
        if on_card:
            up, full = step["replayed"][4]
            check(up == full, f"the replayed store's mirror uploaded {up} of {full} B")
        log(f"durable tick {label}: {n_docs} documents equal in (a), (b), (c) and the "
            f"replayed copies, every field in (a), (b), (c) and in the two copies, the "
            f"copies' WAL records equal; between the copies and the live stores "
            f"{restamped} queue documents differ in {QUEUE_STAMPS} alone (the copies' "
            f"fresh persisters rewrote what the live stores skipped); the card copy's "
            f"plane a cold build, its mirror a full upload")
        report(label, step)

        # ---- a torn frame: tick 4's group is lost whole ---------------- #
        for key in ("a", "b"):
            stores[key].sync_persist()
        torn = crash_copy("a-torn", dirs["a"])
        with open(os.path.join(torn, durable.WAL_FILE), "rb") as fh:
            data = fh.read()
        at = data.rfind(b'{"o":"g"')
        check(at >= 0, "no group frame to tear")
        cut = at + (len(data) - at) // 2
        with open(os.path.join(torn, durable.WAL_FILE), "r+b") as fh:
            fh.truncate(cut)
        t0 = time.perf_counter()
        reopened = DurableStore(torn)
        torn_ms = (time.perf_counter() - t0) * 1e3
        check(store_json(reopened) == before4,
              "the torn copy is not (a) as it stood before tick 4's group")
        log(f"durable torn frame: the copy's WAL cut at byte {cut} of {len(data)}, inside "
            f"tick 4's frame; reopened in {torn_ms:.2f} ms to (a)'s documents just "
            f"before tick 4 (its whole group lost, nothing of it applied)")
        reopened._journal.close()
        for key in ("replayed", "replayed-b"):
            stores.pop(key)._journal.close()

        # ---- the fence: a thief takes (a)'s lease ---------------------- #
        leases["a"].stop_renewing()
        time.sleep(LEASE_TTL_S + 0.2)
        thieves = {"thief": FileLease(leases["a"].path, ttl_s=LEASE_TTL_S)}
        for key, owner in (("thief", "a"),):
            lease = thieves[key]
            check(lease.try_acquire() and lease.epoch == leases[owner].epoch + 1,
                  f"{key} did not take the lease (epoch {lease.epoch})")
        label, now = "5 (fenced)", NOW + 4 * TICK_STEP_S
        wal0 = os.path.getsize(wal_path(stores["a"]))
        docs0 = store_json(stores["a"])
        res, got, ph, gc_ms = tick("a", stores["a"], 4, now, card)
        plane = resident.peek_resident_plane(stores["a"])
        check(res.degraded == "fenced" and res.queues == {} and res.planner_used == "",
              f"tick {label} (a): degraded {res.degraded!r}")
        check(got == no_launches, f"tick {label} (a): launches {got}")
        check(os.path.getsize(wal_path(stores["a"])) == wal0, f"tick {label}: (a)'s WAL grew")
        check(store_json(stores["a"]) == docs0, f"tick {label}: (a)'s documents changed")
        check(not plane._ready and plane._pending_reason == "fenced"
              and (plane._mirror is None or plane._mirror._bufs is None),
              f"tick {label}: (a)'s plane was not dropped ({plane._pending_reason!r})")
        log(f"durable tick {label} (a): degraded 'fenced' in {res.total_ms:.2f} ms, no "
            f"launch, WAL {wal0} B unchanged, documents unchanged, plane invalidated "
            f"'fenced' (mirror buffers dropped); thief epoch {thieves['thief'].epoch}")
        n = next(seqs["a"])
        seqs["a"], seqs["thief"] = itertools.count(n), itertools.count(n)
        open_ms = replay("thief", dirs["a"], lease=thieves["thief"])
        tick5 = {k: stores[k] for k in ("thief", "b", "c")}
        step, starts = {}, {}
        for key, store in tick5.items():
            tick_checked(key, store, 4, now, label, step, starts)
        wal_side(tick5, step, starts, label, [])
        n_docs, restamped = same_docs(tick5, f"tick {label}", fresh=("thief",))
        log(f"durable tick {label}: the thief's DurableStore (epoch {stores['thief'].epoch}) "
            f"opened on (a)'s directory in {open_ms:.2f} ms; {n_docs} documents equal in "
            f"the thief, (b) and (c) ({restamped} queue documents differ in "
            f"{QUEUE_STAMPS} alone between the thief's fresh persister and the live "
            f"stores)")
        report(label, step)
        stores["thief"].sync_persist()
        t0 = time.perf_counter()
        stores["thief"].checkpoint()
        ck_ms = (time.perf_counter() - t0) * 1e3
        snap = os.path.join(dirs["a"], durable.SNAPSHOT_FILE)
        log(f"durable checkpoint (thief's store): {ck_ms:.2f} ms, snapshot "
            f"{os.path.getsize(snap)} B")
        stores["thief"].close()
        thieves["thief"].release()
        stores["a"].close()
        stores["b"].close()
        leases["b"].release()
        check(not os.path.exists(leases["b"].path), "(b)'s lease file remains")
    finally:
        uuid.uuid4, time.time = real_uuid4, real_time
        for lease in leases.values():
            lease.stop_renewing()
    del stores

    # ---- the durable fleet ------------------------------------------------ #
    fleet_phase(torch, np, problem, keep, card, dirs["fleet"], launches_by)
    shutil.rmtree(root, ignore_errors=True)
    return launches_by


def fleet_phase(torch, np, problem, keep, card, data_dir, launches_by) -> None:
    """Phase 10's durable fleet: ``ShardedScheduler.build(4, data_dir=...,
    stacked="always")`` on the card against an in-memory CPU plane
    (``stacked="never"``), the cron front end's round options; four rounds,
    a crash copy, ``open_fleet`` and a fifth round, held to the live CPU
    plane without the queue documents' write stamps (its persisters are
    fresh). A second copy reopened on the CPU, the reopened fleet's
    comparator with every field, was cut when phase 11 needed the time."""
    import shutil

    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.sharded_plane import (
        ShardedScheduler,
        fleet_owner_violations,
        open_fleet,
    )
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.store import Store
    from evergreen_tpu_torch.utils import overload
    from evergreen_tpu_torch.utils.benchgen import NOW

    on_card = torch.device(card).type == "cuda"
    opts = service_opts(wrapper)
    iters = CapacityConfig().iterations
    kw = dict(tick_opts=wrapper.TickOptions(use_cache=True), rebalance_enabled=True)
    t0 = time.perf_counter()
    planes = {
        "card": ShardedScheduler.build(PLANE_SHARDS, data_dir=data_dir,
                                       lease_ttl_s=LEASE_TTL_S, device=card,
                                       stacked="always", **kw),
        "cpu": ShardedScheduler.build(PLANE_SHARDS, device="cpu", stacked="never", **kw),
    }
    build_ms = (time.perf_counter() - t0) * 1e3
    for plane in planes.values():
        src = Store()
        seed_tick_store(src, problem, only=keep)
        plane.seed_partition(src)
        for s in plane.stores:
            CapacityConfig(pool_quotas=PLAN_QUOTA, fleet_intent_budget=PLAN_BUDGET).set(s)
    log(f"durable fleet: {PLANE_SHARDS} DurableStores in one directory (build "
        f"{build_ms:.2f} ms, leases {LEASE_TTL_S} s), stacked='always' on the card, "
        f"against an in-memory CPU plane, stacked='never'; rounds with the cron "
        f"front end's options; seeded by seed_partition")
    real_time = time.time
    stacked_calls = {"card": timed_stacked_solve(planes["card"])}
    reopened = {}
    copies = [data_dir + "-crashed"]

    def plane_docs(plane, stamps):
        return json.dumps([[
            [canon_doc(d) if stamps or c not in ("task_queues", "task_secondary_queues")
             else {k: v for k, v in canon_doc(d).items() if k not in QUEUE_STAMPS}
             for d in s.collection(c).find()] for c in PLANE_COLLECTIONS]
            for s in plane.stores], sort_keys=True, default=str)

    def run_round(label, r, now, keyed, fresh=()):
        """One round of every plane of ``keyed``; the card plane's mode held
        to ``FLEET_MODES``; documents equal across the planes, with every
        field within the live planes and within the ``fresh`` ones (fresh
        persisters), and without the queue documents' ``QUEUE_STAMPS``
        between the two."""
        res, launches, drift = {}, {}, []
        for name, plane in keyed.items():
            n_calls = len(stacked_calls.get(name, ()))
            reset_launches(fused_distro_stats, segment_sum)
            time.time = lambda: now
            try:
                res[name] = plane.tick(now=now, opts=opts)
            finally:
                time.time = real_time
            launches[name] = read_launches(fused_distro_stats, segment_sum)
            if name in stacked_calls:
                drift = [d for _, d in stacked_calls[name][n_calls:] if d is not None]
                check_plane_a_mode(r, f"{label} ({name})", res[name].solve_mode, drift,
                                   modes=FLEET_MODES)
        full = {}
        for name, plane in keyed.items():
            check(fleet_owner_violations(plane.stores) == [],
                  f"fleet round {label}: {name} violates exactly-one-owner")
            check(not res[name].degraded, f"fleet round {label}: {name} degraded "
                  f"{res[name].degraded}")
            blocks = sum(1 for x in res[name].results.values() if x.planner_used == "tpu")
            check(blocks == PLANE_SHARDS, f"fleet round {label}: {name} solved {blocks}")
            dev = plane.device.type
            want = (expected_launches([iters] * blocks) if dev == "cuda" and on_card
                    else {"fused_distro_stats": 0, "segment_sum": 0})
            check(launches[name] == want, f"fleet round {label}: {name} launches "
                  f"{launches[name]}, expected {want}")
            if dev == "cuda":
                for k_, v in launches[name].items():
                    launches_by["fleet"][k_] = launches_by["fleet"].get(k_, 0) + v
            full[name] = plane_docs(plane, stamps=True)
        names = list(keyed)
        for group in ([n for n in names if n not in fresh], [n for n in names if n in fresh]):
            for name in group[1:]:
                check(full[name] == full[group[0]], f"fleet round {label}: the documents "
                      f"of {name} differ from {group[0]}'s")
        if fresh:
            bare = {n: plane_docs(keyed[n], stamps=False) for n in names}
            for name in names[1:]:
                check(bare[name] == bare[names[0]], f"fleet round {label}: the documents "
                      f"of {name} differ from {names[0]}'s beyond {QUEUE_STAMPS}")
        for name in names[1:]:
            check(res[name].migrations == res[names[0]].migrations,
                  f"fleet round {label}: migrations differ")
        log(f"durable fleet round {label}: modes " + ", ".join(
            f"{n} {res[n].solve_mode}" for n in names) + f" (card drift {drift}); wall ms "
            + ", ".join(f"{n} {res[n].total_ms:.2f}" for n in names) + f"; migrations "
            + json.dumps([{k: m[k] for k in ("_id", "group", "from", "to")}
                          for m in res[names[0]].migrations])
            + "; documents equal" + (f" (every field between {'/'.join(fresh)}, whose "
                                      f"persisters are fresh; {QUEUE_STAMPS} aside "
                                      f"against the rest)" if fresh else "")
            + "; launches per plane "
            + json.dumps({n: launches[n]["fused_distro_stats"] for n in names}))
        return res

    try:
        for r, label in enumerate(FLEET_ROUNDS):
            now = NOW + r * TICK_STEP_S
            if r == 1:
                for plane in planes.values():
                    for s in plane.stores:
                        tick_churn(s, now)
            for plane in planes.values():
                overload.monitor_for(plane.stores[0]).set_floor(
                    overload.YELLOW if r == FLEET_YELLOW else overload.GREEN)
            res = run_round(label, r, now, planes)
            check((r == FLEET_YELLOW) == bool(res["card"].migrations),
                  f"fleet round {label}: migrations {res['card'].migrations}")
        for s in planes["card"].stores:
            s.sync_persist()
        # a lease's tmp file may be renamed under the copy
        shutil.copytree(data_dir, copies[0], ignore=shutil.ignore_patterns("*.lease.*"))
        t0 = time.perf_counter()
        reopened["reopened"] = open_fleet(copies[0], PLANE_SHARDS, lease_ttl_s=LEASE_TTL_S,
                                          device=card, stacked="always", **kw)
        open_ms = (time.perf_counter() - t0) * 1e3
        stacked_calls["reopened"] = timed_stacked_solve(reopened["reopened"])
        log(f"durable fleet: the directory copied after round 4 without closing; "
            f"open_fleet(copy) in {open_ms:.2f} ms on the card (stale leases stolen, "
            f"epochs {[s.epoch for s in reopened['reopened'].stores]}, handoffs "
            f"reconciled)")
        now = NOW + len(FLEET_ROUNDS) * TICK_STEP_S
        keyed = {**reopened, "cpu": planes["cpu"]}
        for plane in keyed.values():
            overload.monitor_for(plane.stores[0]).set_floor(overload.GREEN)
        run_round("5 (reopened)", len(FLEET_ROUNDS), now, keyed, fresh=tuple(reopened))
    finally:
        time.time = real_time
        for plane in (planes["card"], *reopened.values(), planes["cpu"]):
            plane.close()
    left = [f for d in [data_dir] + copies if os.path.isdir(d)
            for f in os.listdir(d) if f.endswith(".lease")]
    check(left == [], f"durable fleet: lease files left after close(): {left}")
    log("durable fleet: the two durable fleets closed, every shard lease released")


# ---- phase 11: the process-per-shard fleet -------------------------------- #

PROC_SHARDS = 4
#: the fleet's rounds: prime, two quiet rounds, the round after a handoff
#: and, after shard 2 is drained, killed and restarted, two more
PROC_ROUNDS = ("1 (prime)", "2 (quiet)", "3 (quiet)", "4 (after the handoff)",
               "5 (after the restart)", "6 (quiet)")
#: the handoff lands before this round (0-based); shard 2 is killed after it
PROC_MIGRATE, PROC_KILL_AFTER, PROC_KILLED = 3, 3, 2
#: the leader's modes: round 1 measures the floor (local); round 2 stacks
#: or meets a shard whose intents grew it past the floor; the round after
#: the handoff stacks or meets the target grown past the floor; the rest
#: stack
PROC_MODES = ("local", "stacked or grown", "stacked", "stacked or grown", "stacked",
              "stacked")
#: the supervisor's recovery anchor: the boot's recovery pass runs at it,
#: a restart's at it plus the rounds done times the supervisor's TICK_S
PROC_ANCHOR = 1_750_000_000.0 - 15.0
#: tasks the seeded churn leaves in flight, per shard: on hosts whose
#: heartbeat is stale at the anchor, on hosts that are gone, on a
#: terminated host; and mock hosts left building
PROC_STALE, PROC_GONE, PROC_BUILDING = 3, 2, 3


def proc_round_now(r) -> float:
    return PROC_ANCHOR + (r + 1) * TICK_STEP_S


def seed_proc_fleet(problem, data_dir) -> dict:
    """Config 3 with phase 6's capacity settings (each shard's quota and
    intent budget a quarter of the fleet's), split over ``PROC_SHARDS``
    shard segments at epoch 0 (no lease: the workers' writes land after
    these), then a churn written without a lease: benchgen's phantom
    ``running_task`` stamps stay (recovery step 1), some tasks are left in
    flight on hosts that cannot be running them (step 2) and some mock
    hosts building (step 3)."""
    from evergreen_tpu_torch.scheduler.sharded_plane import ShardedScheduler
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.store import Store

    src = Store()
    seed_tick_store(src, problem)
    stores = [DurableStore(data_dir, shard_id=k) for k in range(PROC_SHARDS)]
    for s in stores:  # each segment's seed is one group frame, as JAX seeds
        s.begin_tick()
    plane = ShardedScheduler(stores, device="cpu", stacked="never")
    plane.seed_partition(src)
    quota = {p: q // PROC_SHARDS for p, q in PLAN_QUOTA.items()}
    stale = PROC_ANCHOR - 3600.0
    for k, s in enumerate(stores):
        CapacityConfig(pool_quotas=quota,
                       fleet_intent_budget=PLAN_BUDGET // PROC_SHARDS).set(s)
        tasks, hosts = s.collection("tasks"), s.collection("hosts")
        runnable = sorted(d["_id"] for d in tasks.find()
                          if d["status"] == "undispatched" and d["activated"])
        free = sorted(d["_id"] for d in hosts.find()
                      if d["status"] == "running" and not d["running_task"])
        n = PROC_STALE + PROC_GONE + 1
        picked, on_hosts = runnable[:n], free[:PROC_STALE + 1]
        for tid, hid in zip(picked[:PROC_STALE], on_hosts):
            tasks.update(tid, {"status": "started", "host_id": hid, "dispatch_time": stale,
                               "start_time": stale, "last_heartbeat": stale})
            hosts.update(hid, {"running_task": tid})
        for j, tid in enumerate(picked[PROC_STALE:PROC_STALE + PROC_GONE]):
            tasks.update(tid, {"status": "dispatched", "host_id": f"gone-{k}-{j}",
                               "dispatch_time": PROC_ANCHOR - 60.0,
                               "last_heartbeat": PROC_ANCHOR - 60.0})
        down = on_hosts[PROC_STALE]
        hosts.update(down, {"status": "terminated", "termination_time": stale})
        tasks.update(picked[-1], {"status": "started", "host_id": down,
                                  "dispatch_time": PROC_ANCHOR - 60.0,
                                  "start_time": PROC_ANCHOR - 60.0,
                                  "last_heartbeat": PROC_ANCHOR - 60.0})
        building = free[PROC_STALE + 1:PROC_STALE + 1 + PROC_BUILDING]
        for j, hid in enumerate(building):
            hosts.update(hid, {"status": "building",
                               "external_id": f"mock-{hid}" if j == 0 else ""})
        s.end_tick()
    plane.close()  # each segment's checkpoint; no lease to release


def proc_migration(data_dir) -> tuple:
    """The handoff of ``PROC_MIGRATE``: shard 0's first distro by id that
    is its own affinity group, to shard 1, with its ``now``; read off the
    seeded segments, so the twin knows it before the fleet runs."""
    from evergreen_tpu_torch.parallel.topology import ShardTopology
    from evergreen_tpu_torch.storage.durable import DurableStore

    s = DurableStore(data_dir, shard_id=0)
    s._journal.close()  # inspection: never close() a segment we do not own
    topo = ShardTopology(PROC_SHARDS)
    topo.affinity = ShardTopology.affinity_from_store(s)
    ids = sorted(d["_id"] for d in s.collection("distros").find())
    distro = next(d for d in ids if sum(topo.placement_key(x) == topo.placement_key(d)
                                        for x in ids) == 1)
    return distro, 0, 1, proc_round_now(PROC_MIGRATE) - 1.0


def proc_canon(doc):
    """``canon_doc``, and an intent's creation time, which the clock of the
    process that made it stamps."""
    if "payload" in doc:
        return dict(doc, payload={c: [proc_canon(d) for d in ds]
                                  for c, ds in doc["payload"].items()})
    intent = doc["_id"].startswith("evg-") and doc.get("status") == "initializing"
    doc = canon_doc(doc)
    return dict(doc, creation_time=0.0) if intent else doc


def proc_docs(store) -> str:
    """Every collection of ``store`` that holds a document, canonical."""
    names = [n for n in sorted(store._collections) if len(store.collection(n))]
    return json.dumps({n: [proc_canon(d) for d in store.collection(n).find()]
                       for n in names}, sort_keys=True, separators=(",", ":"),
                      default=str)


def proc_twin(here, data_dir, migration, out_path) -> None:
    """The fleet's CPU twin, in a process of its own (it runs while the
    fleet does): the same sequence in-process on the CPU over a copy of
    the seeded directory — each shard's ``DurableStore`` (no lease),
    ``run_recovery_pass`` at the anchor, ``run_tick`` with the worker's
    service options at each round's ``now``, the handoff through
    ``apply_release`` / ``apply_prime`` and the done-mark, and shard
    ``PROC_KILLED`` reopened after ``PROC_KILL_AFTER`` and recovered
    again, as its restarted worker is. Writes the recovery reports and
    each shard's canonical documents to ``out_path``."""
    sys.path.insert(0, here)
    from evergreen_tpu_torch.parallel.topology import ShardTopology
    from evergreen_tpu_torch.scheduler import sharded_plane as sp
    from evergreen_tpu_torch.scheduler import wrapper
    from evergreen_tpu_torch.scheduler.recovery import run_recovery_pass
    from evergreen_tpu_torch.storage.durable import DurableStore

    opts = wrapper.TickOptions(create_intent_hosts=True, use_cache=True,
                               solve_deadline_s=10.0, tick_budget_s=12.0,
                               async_persist=True)
    t0 = time.perf_counter()
    stores = [DurableStore(data_dir, shard_id=k) for k in range(PROC_SHARDS)]
    reports = {"boot": [run_recovery_pass(s, now=PROC_ANCHOR).to_doc() for s in stores]}
    distro, src, dst, mig_now = migration
    for r in range(len(PROC_ROUNDS)):
        if r == PROC_MIGRATE:
            topo = ShardTopology(PROC_SHARDS)
            topo.affinity = ShardTopology.affinity_from_store(stores[src])
            rep = topo.placement_key(distro)
            group = sorted(d["_id"] for d in stores[src].collection("distros").find()
                           if topo.placement_key(d["_id"]) == rep)
            rec = sp.handoff_record(distro, group, src, dst, 1, mig_now,
                                    sp.handoff_payload(stores[src], group))
            sp.apply_release(stores[src], rec)
            sp.apply_prime(stores[dst], json.loads(json.dumps(rec)))
            stores[src].collection(sp.HANDOFFS_COLLECTION).update(rec["_id"],
                                                                    {"state": "done"})
        for s in stores:
            res = wrapper.run_tick(s, opts, now=proc_round_now(r), device="cpu")
            if res.degraded:
                raise RuntimeError(f"twin round {r + 1}: degraded {res.degraded!r}")
        for s in stores:
            s.sync_persist()
        if r == PROC_KILL_AFTER:
            stores[PROC_KILLED]._journal.close()  # a SIGKILL closes nothing else
            stores[PROC_KILLED] = s2 = DurableStore(data_dir, shard_id=PROC_KILLED)
            reports["restart"] = run_recovery_pass(
                s2, now=PROC_ANCHOR + (r + 1) * TICK_STEP_S).to_doc()
    docs = [proc_docs(s) for s in stores]
    for s in stores:
        s.close()
    with open(out_path, "w") as fh:
        json.dump({"reports": reports, "docs": docs,
                   "ms": (time.perf_counter() - t0) * 1e3}, fh)


def status_launches(msg) -> dict:
    """A worker's ``status`` launch counters, as ``read_launches`` reads
    this process's."""
    got = msg["launches"]
    out = {"fused_distro_stats": got["fused_distro_stats"], "segment_sum": got["segment_sum"]}
    out.update({f"segment_sum[{p}]": c for p, c in got["segment_sum_by_plan"].items()})
    return out


def nonzero(launches) -> dict:
    """``launches`` without its zero counts (a plan never launched has no
    entry in a process's counters, and ``expected_launches`` of no solve
    names every plan at 0)."""
    return {k: v for k, v in launches.items() if v}


def add_launches(total, got) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def process_fleet_phase(torch, np, problem, card="cuda", root=DATA_ROOT) -> dict:
    """Phase 11: the process-per-shard fleet (``FleetSupervisor`` on
    ``card``, four shard worker processes on it, the supervisor the
    solver leader with ``solver="always"``), seeded at config 3 with a
    churn that recovery heals, against a CPU twin in a process of its own.
    Returns the fleet's launches (the leader's here, the workers' from
    their ``status``), as ``read_launches`` reads them. ``card="cpu"`` rehearses it on the CPU."""
    import multiprocessing
    import shutil
    import signal

    from evergreen_tpu_torch.ops.distro_stats import fused_distro_stats
    from evergreen_tpu_torch.ops.segment import segment_sum
    from evergreen_tpu_torch.runtime.supervisor import FleetSupervisor
    from evergreen_tpu_torch.scheduler.sharded_plane import fleet_owner_violations
    from evergreen_tpu_torch.settings import CapacityConfig
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.utils.retry import RetryPolicy

    on_card = torch.device(card).type == "cuda"
    iters = CapacityConfig().iterations
    data_dir = os.path.join(root, "procfleet")
    twin_dir = os.path.join(root, "procfleet-twin")
    for d in (data_dir, twin_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    seed_proc_fleet(problem, data_dir)
    seed_ms = (time.perf_counter() - t0) * 1e3
    migration = proc_migration(data_dir)
    shutil.copytree(data_dir, twin_dir)
    out_path = os.path.join(root, "procfleet-twin.json")
    twin = multiprocessing.get_context("spawn").Process(
        target=proc_twin, args=(HERE, twin_dir, migration, out_path), daemon=True)
    twin.start()
    log(f"process fleet: config 3 (seed {SEED}) seeded over {PROC_SHARDS} shard segments "
        f"at epoch 0 in {seed_ms:.1f} ms, each shard's quota and intent budget a "
        f"quarter of phase 6's; churn written without a lease, per shard: "
        f"{PROC_STALE} tasks started on hosts whose heartbeats are stale at the "
        f"recovery anchor, {PROC_GONE} dispatched on hosts that are gone, 1 on a "
        f"terminated host, {PROC_BUILDING} mock hosts building; the CPU twin started "
        f"on a copy of the directory (pid {twin.pid})")
    sup = FleetSupervisor(
        data_dir, PROC_SHARDS, ttl_s=LEASE_TTL_S, hb_interval_s=1.0, hb_deadline_s=10.0,
        recovery_anchor=PROC_ANCHOR, orphan_grace_s=10.0, supervisor_lease_ttl_s=LEASE_TTL_S,
        restart_policy=RetryPolicy(attempts=1_000_000, base_backoff_s=0.25,
                                   max_backoff_s=2.0, jitter=0.0),
        solver="always", device=card)
    serves, worker_launches, leader = [], {}, {}
    try:
        reset_launches(fused_distro_stats, segment_sum)
        t0 = time.perf_counter()
        sup.start()
        start_ms = (time.perf_counter() - t0) * 1e3
        check(all(h.state == "ready" for h in sup.handles.values()),
              f"process fleet: workers not ready {[h.state for h in sup.handles.values()]}")
        svc = sup.solver_service
        check(svc is not None and svc.epoch == 1, "process fleet: no solver leader")
        real_serve = svc.serve_round

        def serve(shards, seq=None, budget_s=None):
            """The leader's round, timed, with the shape keys it declined
            as drift and the floor they met."""
            floor = dict(svc.common_dims) if svc.common_dims else None
            keys, real_decline = [], svc._decline

            def decline(seg, s_, cause):
                if cause == 1:
                    keys.append(seg.shape_key())
                return real_decline(seg, s_, cause)

            svc._decline = decline
            t1 = time.perf_counter()
            try:
                outcome = real_serve(shards, seq, budget_s)
            finally:
                svc._decline = real_decline
            serves.append(dict(ms=(time.perf_counter() - t1) * 1e3, outcome=outcome,
                               drift=(floor, keys) if keys else None))
            return outcome

        svc.serve_round = serve
        for k, h in sup.handles.items():
            hello = h.hellos[0]
            check(h.epochs == [1], f"process fleet: shard {k} booted at epochs {h.epochs}")
            log(f"process fleet: shard {k} hello at epoch {h.epoch}, recovery pass "
                f"{hello['recovery_ms']:.2f} ms, recovered {hello['recovered']}")
        log(f"process fleet: FleetSupervisor.start() on {card} (fleet lease, solver "
            f"lease, spawn, backend probe, replay, recovery, hello) {start_ms:.2f} ms")
        stacked_blocks = 0
        #: local solves per (shard, process life): the killed shard's second
        #: life starts after PROC_KILL_AFTER
        local_solves = {(k, 1): 0 for k in range(PROC_SHARDS)}
        local_solves[(PROC_KILLED, 2)] = 0
        takeover_ms = None
        for r, label in enumerate(PROC_ROUNDS):
            if r == PROC_MIGRATE:
                distro, src, dst, now = migration
                t1 = time.perf_counter()
                rec = sup.migrate(distro, src, dst, now=now)
                check(rec is not None and rec["seq"] == 1 and rec["state"] == "released",
                      f"process fleet: migrate({distro}) gave {rec}")
                log(f"process fleet: migrate({distro!r}, {src}, {dst}) over the control "
                    f"protocol in {(time.perf_counter() - t1) * 1e3:.2f} ms: group "
                    f"{rec['group']}")
            n_serves = len(serves)
            t1 = time.perf_counter()
            res = sup.round(now=proc_round_now(r))
            wall = (time.perf_counter() - t1) * 1e3
            check(sorted(res) == list(range(PROC_SHARDS)),
                  f"process fleet round {label}: replies from {sorted(res)}")
            for k, rep in res.items():
                check(rep["degraded"] == "", f"round {label}: shard {k} degraded "
                      f"{rep['degraded']!r}")
                check(rep["solve"] in ("stacked", "local"), f"round {label}: shard {k} "
                      f"solve {rep['solve']!r}")
            solves = [res[k]["solve"] for k in range(PROC_SHARDS)]
            mode = "stacked" if set(solves) == {"stacked"} else "local"
            served = serves[n_serves:]
            drift = [x["drift"] for x in served if x["drift"]]
            check_plane_a_mode(r, label, mode, drift, modes=PROC_MODES)
            stacked_blocks += solves.count("stacked")
            for k in range(PROC_SHARDS):
                life = 2 if k == PROC_KILLED and r > PROC_KILL_AFTER else 1
                local_solves[(k, life)] += solves[k] == "local"
            log(f"process fleet round {label}: mode {mode} (shards {solves}, causes "
                f"{[res[k]['solve_cause'] for k in range(PROC_SHARDS)]}; leader "
                + ", ".join(f"{x['outcome']} in {x['ms']:.2f} ms" for x in served)
                + f", drift {drift}); wall {wall:.2f} ms, shard ticks ms "
                + ", ".join(f"{res[k]['ms']:.2f}" for k in range(PROC_SHARDS))
                + f"; epochs {[res[k]['epoch'] for k in range(PROC_SHARDS)]}")
            if r == PROC_KILL_AFTER:
                # every worker's counters before one of them is killed
                for k, st in sup.statuses().items():
                    worker_launches[(k, 1)] = status_launches(st)
                h = sup.handles[PROC_KILLED]
                req = h.next_req()
                h.send(op="drain", req=req)
                check(h.wait_reply("drained", 60.0, req=req) is not None,
                      f"process fleet: shard {PROC_KILLED} did not drain")
                t1 = time.perf_counter()
                os.kill(h.pid, signal.SIGKILL)
                deadline = time.time() + 120.0
                while time.time() < deadline and not (h.restarts == 1 and h.state == "ready"):
                    time.sleep(0.02)
                takeover_ms = (time.perf_counter() - t1) * 1e3
                check(h.state == "ready" and h.epochs == [1, 2] and h.exits == [-9],
                      f"process fleet: shard {PROC_KILLED} restart: state {h.state}, "
                      f"epochs {h.epochs}, exits {h.exits}")
                hello = h.hellos[-1]
                log(f"process fleet: shard {PROC_KILLED} drained, SIGKILLed and restarted "
                    f"by the watchdog at epoch {h.epoch} in {takeover_ms:.2f} ms (SIGKILL "
                    f"to the next hello: backoff {h.backoffs[-1]:.2f} s, lease TTL "
                    f"{LEASE_TTL_S} s, spawn, probe, replay, recovery); its recovery "
                    f"pass {hello['recovery_ms']:.2f} ms, recovered {hello['recovered']}")
        for k, st in sup.statuses().items():
            worker_launches[(k, 2 if k == PROC_KILLED else 1)] = status_launches(st)
        leader = read_launches(fused_distro_stats, segment_sum)
        t1 = time.perf_counter()
        sup.stop(graceful=True)
        stop_ms = (time.perf_counter() - t1) * 1e3
    finally:
        sup.stop(graceful=False)
    check(all(h.proc.returncode == 0 for h in sup.handles.values()),
          f"process fleet: exits {[h.proc.returncode for h in sup.handles.values()]}")
    left = [f for f in os.listdir(data_dir) if f.endswith(".lease")]
    check(left == [], f"process fleet: lease files left after stop(): {left}")
    log(f"process fleet: stop(graceful=True) in {stop_ms:.2f} ms (drain, checkpoint, "
        f"release); every worker exited 0, every lease released")

    # launches: the leader's stacked blocks here, each worker's local solves
    # in its own process (the killed one's counted before the kill)
    want = expected_launches([iters] * stacked_blocks) if on_card else {}
    check(nonzero(leader) == nonzero(want),
          f"process fleet: the leader launched {leader}, expected {want} "
          f"({stacked_blocks} stacked blocks)")
    fleet = dict(leader)
    for key, got in sorted(worker_launches.items()):
        want = expected_launches([iters] * local_solves[key]) if on_card else {}
        check(nonzero(got) == nonzero(want),
              f"process fleet: worker {key[0]} (life {key[1]}) launched "
              f"{got}, expected {want} ({local_solves[key]} local solves)")
        add_launches(fleet, got)
    log(f"process fleet launches: leader {leader} for {stacked_blocks} stacked blocks; "
        f"workers (shard.life: fused_distro_stats, segment_sum for local solves) "
        + json.dumps({f"{k}.{life}": [got["fused_distro_stats"], got["segment_sum"],
                                      local_solves[(k, life)]]
                      for (k, life), got in sorted(worker_launches.items())})
        + " (exact)")

    # the twin's documents and reports against the fleet's segments
    twin.join(timeout=600)
    check(twin.exitcode == 0, f"process fleet: the CPU twin exited {twin.exitcode}")
    with open(out_path) as fh:
        twin_out = json.load(fh)
    for k, h in sup.handles.items():
        for hello, report in zip(h.hellos, [twin_out["reports"]["boot"][k]]
                                 + ([twin_out["reports"]["restart"]]
                                    if k == PROC_KILLED else [])):
            counts = {"released_claims": len(report["released_claims"]),
                      "stranded_reset": len(report["stranded_reset"]),
                      "stale_frames_dropped": report["stale_frames_dropped"]}
            check(hello["recovered"] == counts, f"process fleet: shard {k} recovered "
                  f"{hello['recovered']}, the twin {counts}")
    boot = twin_out["reports"]["boot"]
    check(all(b["released_claims"] and b["stranded_reset"] and b["hosts_terminated"]
              for b in boot), "process fleet: a shard's recovery did not act on each step")
    t0 = time.perf_counter()
    stores = [DurableStore(data_dir, shard_id=k) for k in range(PROC_SHARDS)]
    for s in stores:
        s._journal.close()  # inspection-open: never close() (a checkpoint)
    read_ms = (time.perf_counter() - t0) * 1e3
    check(fleet_owner_violations(stores) == [],
          "process fleet: a document has two owners")
    n_docs = 0
    for k, s in enumerate(stores):
        got = proc_docs(s)
        check(got == twin_out["docs"][k], f"process fleet: shard {k}'s documents differ "
              f"from the CPU twin's")
        n_docs += sum(len(s.collection(n)) for n in s._collections)
    log(f"process fleet: after stop, the four segments (replayed read-only in "
        f"{read_ms:.2f} ms) hold {n_docs} documents, each shard's equal to the CPU "
        f"twin's (twin {twin_out['ms']:.0f} ms in its own process; intent and event ids, "
        f"intents' secrets and creation times canonicalised); one owner per document; "
        f"recovery counts equal the twin's: boot " + json.dumps(
            [{k: len(v) for k, v in b.items() if isinstance(v, list)} for b in boot])
        + ", restart " + json.dumps({k: len(v) for k, v in
                                     twin_out["reports"]["restart"].items()
                                     if isinstance(v, list)}))
    shutil.rmtree(root, ignore_errors=True)
    return fleet


def main() -> int:
    profile_dir = None
    sweep_mode = sys.argv[1:] == ["--sweep"]
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile_dir = sys.argv[2]
    elif len(sys.argv) != 1 and not sweep_mode:
        print("usage: chip_smoke.py [--profile OUT_DIR | --sweep]", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "evergreen_tpu_torch")):
        print("chip_smoke: evergreen_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # the run uses one card: keep only the first visible one, so that the
    # device count in the last line is the count of cards the run used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if visible is None else visible.split(",")[0])
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    check(torch.cuda.device_count() == 1, "expected exactly one visible card")

    # the backend probe: a fresh interpreter must see the card
    from evergreen_tpu_torch.utils.torchenv import ensure_usable_backend

    backend = ensure_usable_backend()  # one probe_backend_detail() in a fresh interpreter
    log(f"backend probe: ensure_usable_backend() = {backend!r}")
    check(backend == "cuda", f"ensure_usable_backend() returned {backend!r}")

    from evergreen_tpu_torch.api.sidecar import SidecarClient, serve_background
    from evergreen_tpu_torch.ops import _build
    from evergreen_tpu_torch.ops.distro_stats import (
        fused_distro_stats,
        fused_distro_stats_plain,
    )
    from evergreen_tpu_torch.ops.packing import unpack
    from evergreen_tpu_torch.ops.segment import (
        segment_plan,
        segment_sum,
        segment_sum_plain,
    )
    from evergreen_tpu_torch.ops.solve import (
        OUTPUT_SPEC,
        _packed_solve,
        capacity_iters,
        distro_stats_inputs,
        result_to_host,
        run_solve_packed,
        split_outputs,
    )
    from evergreen_tpu_torch.scheduler.snapshot import build_snapshot
    from evergreen_tpu_torch.utils.benchgen import (
        NOW,
        add_capacity_page,
        generate_problem,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = last = time.perf_counter()

    def phase_done(name):
        """Log the wall seconds of the phase that just ended."""
        nonlocal last
        now = time.perf_counter()
        log(f"{name}: {now - last:.1f} s wall ({now - t_start:.1f} s since the card "
            f"was set)")
        last = now

    # ---- 1. card and build ------------------------------------------------- #
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    kernels = ("distro_stats", "segment_sum")
    t0 = time.perf_counter()
    build_s = _build.build(kernels)
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        + " ".join(f"{k}={s:.2f}s" for k, s in build_s.items()))
    for k in kernels:
        logf = _build.build_log(k)
        if os.path.exists(logf):
            with open(logf) as f:
                for line in f.read().splitlines():
                    if "registers" in line or "spill" in line:
                        log(f"  ptxas {k}: {line.strip()}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_mhz = float(clock.split()[0])
    # the launch floor: the device time of the smallest kernel there is
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(torch, lambda: one.add_(1.0))
    log(f"SM clock for the chain bounds: {sm_mhz:.0f} MHz (clocks.max.sm "
        f"'{clock}'); launch floor (one-element add_): {floor_ms * 1e3:.2f} us "
        f"device time")

    # ---- config-3 snapshots (host side) ------------------------------------ #
    t0 = time.perf_counter()
    problems = {
        "seed0": generate_problem(*CONFIG3, seed=SEED),
        "seed1": generate_problem(*CONFIG3, seed=SEED + 1),
    }
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snaps = {
        "seed0": build_snapshot(*problems["seed0"], NOW),
        "seed0+cap": add_capacity_page(build_snapshot(*problems["seed0"], NOW)),
        "seed1": build_snapshot(*problems["seed1"], NOW),
    }
    build_snap_s = (time.perf_counter() - t0) / 3
    s0 = snaps["seed0"]
    log(f"config 3: generate {gen_s:.2f} s for two seeds, snapshot build "
        f"{build_snap_s * 1e3:.0f} ms (host, pure Python); shape key "
        f"(N,M,U,G,H,D,P,C) = {s0.shape_key()}; tasks {s0.n_tasks}, hosts "
        f"{s0.n_hosts}, distros {s0.n_distros}, segments {s0.n_segs}")

    # ---- 2. kernels against their plain versions on the card -------------- #
    a = unpack(s0.arena.buffers, s0.arena.layout_key(), dev)
    D = a["d_valid"].shape[0]
    rows = []

    ds_args = distro_stats_inputs(a)
    if sweep_mode:
        sweep(torch, ds_args, segment_inputs(torch, np, a, ds_args[6]))
        print(smi)
        return 0

    # fused_distro_stats at the allocator's inputs + the ragged cases
    ds_cases = [ds_args]
    for counts, cols, th in ragged_cases(np):
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        ds_cases.append(tuple(
            torch.as_tensor(cols[c]).to(dev) for c in (
                "t_valid", "t_deps_met", "t_expected_s", "t_wait_dep_met_s",
                "t_is_merge")
        ) + (torch.as_tensor(offs).to(dev), torch.as_tensor(th).to(dev)))
    ds_err = max(hold_distro_stats(torch, args) for args in ds_cases)
    log(f"fused_distro_stats: bit-equal to plain on the CPU on {len(ds_cases)} "
        f"inputs (counts and both duration sums); against plain on the card "
        f"(atomic index_add_) counts exact, sums within rtol {SUM_RTOL}, max abs "
        f"err {ds_err:.3g}")

    def seven_index_adds():
        out = torch.zeros((7, D), dtype=torch.float32, device=dev)
        for k, col in enumerate(ds_cols):
            out[k].index_add_(0, t_distro, col)
        return out

    t_distro = a["t_distro"].long()
    dm = a["t_valid"] & a["t_deps_met"]
    t_thresh = ds_args[6][t_distro]
    over = dm & (a["t_expected_s"] > t_thresh)
    ds_cols = (
        a["t_valid"].float(), dm.float(), torch.where(dm, a["t_expected_s"], 0.0),
        over.float(), torch.where(over, a["t_expected_s"], 0.0),
        (dm & (a["t_wait_dep_met_s"] > t_thresh)).float(),
        (dm & a["t_is_merge"]).float(),
    )
    # the kernel reads the tasks inside the distros' ranges once (three u8
    # flags, two f32 columns), the offsets and thresholds, and writes [D, 7];
    # each duration sum is one ordered chain over its distro, so the
    # longest distro's adds bound it too
    offs = ds_args[5]
    n_ranged = int(offs[-1])
    longest = int((offs[1:] - offs[:-1]).max())
    log(f"fused_distro_stats: {n_ranged} tasks in {D} distros, longest {longest}")
    rows.append(dict(
        name="fused_distro_stats", route="cuda",
        source="evergreen_tpu_torch/csrc/distro_stats.cu",
        replaces="evergreen_tpu/ops/pallas_kernels.py:71",
        max_abs_err=ds_err,
        **measure(torch, lambda: fused_distro_stats(*ds_args),
                  lambda: fused_distro_stats_plain(*ds_args), seven_index_adds),
        **bounds(bytes_=11 * n_ranged + 4 * (D + 1) + 4 * D + 4 * 7 * D,
                 ops=9 * n_ranged,
                 chain_ms=1e3 * longest * FADD_CYCLES / (sm_mhz * 1e6)),
    ))

    # segment_sum at the solve's three plans, each at one and two columns;
    # the kernels line takes the column count the solve uses most there
    plan_inputs = segment_inputs(torch, np, a, ds_args[6])
    for pname, (seg, n_seg, live, x2, main_k) in plan_inputs.items():
        plan, err = hold_segment_sum(torch, pname, seg, n_seg, live, x2)
        n_live = int(plan.offsets[-1])
        longest = int((plan.offsets[1:] - plan.offsets[:-1]).max())
        plan_ms = device_ms(torch, lambda: segment_plan(seg, n_seg, live))
        chain_ms = 1e3 * longest * FADD_CYCLES / (sm_mhz * 1e6)
        by_k = {}
        for k, x in ((1, x2[0]), (2, x2)):
            library = (
                (lambda x=x: torch.bincount(plan.seg, weights=x, minlength=n_seg))
                if k == 1 else
                (lambda x=x: torch.zeros((k, n_seg), device=dev).index_add_(
                    1, plan.seg, x))
            )
            by_k[k] = dict(
                max_abs_err=err,
                **measure(torch, lambda x=x: segment_sum(x, plan),
                          lambda x=x: segment_sum_plain(x, plan), library),
                # the function needs each live element's k f32 values and
                # i32 segment id once, and writes k f32 per segment; the
                # kernel's order and offsets are its own plan, not the
                # function's bytes
                **bounds(bytes_=(4 * k + 4) * n_live + 4 * k * n_seg,
                         ops=k * n_live, chain_ms=chain_ms),
            )
            log(f"segment_sum[{pname}] k={k}: {n_live} live elements in "
                f"{n_seg} segments, longest {longest}; " + fmt_row(by_k[k]))
        log(f"segment_sum[{pname}] plan build (sort + searchsorted, once per "
            f"solve): {plan_ms * 1e3:.2f} us device time")
        rows.append(dict(
            name=f"segment_sum[{pname}]", route="cuda",
            source="evergreen_tpu_torch/csrc/segment_sum.cu",
            replaces="evergreen_tpu/ops/solve.py:71", k=main_k, plan_ms=plan_ms,
            **by_k[main_k],
        ))
    log(f"segment_sum: bit-equal to the CPU at k = 1, 2 and within rtol "
        f"{SUM_RTOL} of index_add_ on {len(plan_inputs)} plans")
    for r in rows:
        r["floor_ms"] = floor_ms
        log(f"  {r['name']}" + (f" k={r['k']}" if "k" in r else "") + ": "
            + fmt_row(r) + f"; floor {floor_ms * 1e3:.2f} us")
    del a

    # ---- 3. the main path at config 3 ------------------------------------- #
    cpu_out = {name: run_solve_packed(s, device="cpu") for name, s in snaps.items()}
    for name, s in snaps.items():
        log(f"{name}: capacity iterations {capacity_iters(s)}")

    reset_launches(fused_distro_stats, segment_sum)
    lib_out = {name: run_solve_packed(s) for name, s in snaps.items()}
    server, port = serve_background("127.0.0.1", 0, device="cuda")
    client = SidecarClient("127.0.0.1", port)
    try:
        replies = {}
        for name, s in snaps.items():
            i32, f32 = client.solve(s)
            replies[name] = split_outputs(
                np.concatenate([i32, f32.view(np.int32)]), s.shape_key()
            )
        launches = read_launches(fused_distro_stats, segment_sum)
        n_solves = len(lib_out) + len(replies)
        log(f"main path: {n_solves} solves ({len(lib_out)} library calls, "
            f"{len(replies)} sidecar requests); launches {launches}")
        want = expected_launches([capacity_iters(s) for s in snaps.values()] * 2)
        check(launches == want, f"launches {launches}, expected exactly {want}")

        # each reply equals the library call: two card runs, byte for byte
        for name in snaps:
            for k in lib_out[name]:
                check(lib_out[name][k].tobytes() == replies[name][k].tobytes(),
                      f"{name}: sidecar reply {k} differs from the library call")
        log("sidecar replies are byte-identical to the library calls")
        gaps = {}
        for name, card in replies.items():
            for k, kind_, _ in OUTPUT_SPEC:
                c, w = card[k], cpu_out[name][k]
                if kind_ == "i32":
                    check(np.array_equal(c, w), f"{name}: {k} differs from the CPU run")
                else:
                    tol = F32_TOL.get(k, dict(rtol=0.0, atol=0.0))
                    np.testing.assert_allclose(c, w, err_msg=f"{name}: {k}", **tol)
                    rel = np.abs(c - w) / np.maximum(np.abs(w), 1e-30)
                    gaps[k] = max(gaps.get(k, 0.0), float(rel.max()) if len(c) else 0.0)
        log("card vs CPU: i32 outputs equal; f32 max relative gap "
            + ", ".join(f"{k}={v:.3g}" for k, v in gaps.items()))
        # sanity of the result itself: every real task queued exactly once,
        # in distro-major order, values finite
        for name, out in replies.items():
            s = snaps[name]
            order = out["order"]
            check(sorted(order.tolist()) == list(range(len(order))),
                  f"{name}: order is not a permutation")
            real = order[order < s.n_tasks]
            check(len(real) == s.n_tasks and np.array_equal(order[: s.n_tasks], real),
                  f"{name}: real tasks are not queued first")
            td = s.arrays["t_distro"][real]
            check(bool(np.all(np.diff(td) >= 0)), f"{name}: queues not distro-major")
            for k, kind_, _ in OUTPUT_SPEC:
                if kind_ == "f32":
                    check(bool(np.isfinite(out[k]).all()), f"{name}: {k} not finite")
            check(bool((out["d_new_hosts"] >= 0).all()), f"{name}: negative spawn count")
        check(not np.array_equal(replies["seed0+cap"]["cap_x"], replies["seed0"]["cap_x"]),
              "the capacity page did not move the capacity targets")
        log("result: queues are permutations, distro-major, f32 outputs "
            "finite, capacity targets moved by the page")

        # timings: sidecar request wall clock
        req_ms = []
        for _ in range(7):
            t0 = time.perf_counter()
            client.solve(snaps["seed0+cap"])
            req_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        client.close()
        server.shutdown()
        server.server_close()
    log(f"sidecar request (seed0+cap, config 3): median "
        f"{statistics.median(req_ms):.2f} ms wall over 7, min "
        f"{min(req_ms):.2f} ms")
    for name in ("seed0", "seed0+cap"):
        s = snaps[name]
        wall = []
        for _ in range(7):
            t0 = time.perf_counter()
            run_solve_packed(s)
            wall.append((time.perf_counter() - t0) * 1e3)
        log(f"run_solve_packed {name}: median {statistics.median(wall):.2f} ms "
            f"wall over 7 (H2D + solve + sync + D2H), min {min(wall):.2f} ms")
        profile_solve(
            torch,
            lambda: result_to_host(_packed_solve(
                s.arena.buffers, s.arena.layout_key(), capacity_iters(s), dev)),
            os.path.join(profile_dir, name) if profile_dir else None,
        )

    phase_done("phases 1-3")

    # ---- 4. stacked rounds; 5. the device mirror ------------------------- #
    stacked_phase(torch, np, problems["seed0"], F32_TOL, profile_dir)
    phase_done("phase 4")
    mirror_phase(torch, np, problems["seed0"])
    phase_done("phase 5")

    # ---- 6. the tick's planning half --------------------------------------- #
    planning_phase(torch, np)
    phase_done("phase 6")

    # ---- 7. the whole tick ------------------------------------------------- #
    tick_launches = tick_phase(torch, np, problems["seed0"])
    # the two solve ticks again on fresh stores with the CPU's store
    # ticked first at each step, so neither store's phase times owe to
    # the order (the serial ticks 3-4 print no phase times, and launch
    # nothing)
    again = tick_phase(torch, np, problems["seed0"], card_first=False, depth=2)
    check(again == tick_launches, f"tick: launches {again} with the CPU first, "
          f"{tick_launches} with the card first")
    phase_done("phase 7")

    # ---- 8. the service's tick -------------------------------------------- #
    service = service_phase(torch, np, problems["seed0"], sm_mhz)
    phase_done("phase 8")

    # ---- 9. the sharded plane ---------------------------------------------- #
    log(f"sharded plane on {smi}")
    sharded = sharded_phase(torch, np, problems["seed0"])
    phase_done("phase 9")

    # ---- 10. the durable service tick and the durable fleet ----------------- #
    log(f"durable tick on {smi}")
    durable = durable_phase(torch, np, problems["seed0"])
    phase_done("phase 10")

    # ---- 11. the process-per-shard fleet ------------------------------------ #
    log(f"process fleet on {smi}")
    proc = process_fleet_phase(torch, np, problems["seed0"])
    phase_done("phase 11")

    # ---- 12. result -------------------------------------------------------- #
    # launches: phase 7's ticks (card first), phase 8's card stores, phase
    # 9's card planes, phase 10's card stores and fleets ("durable"; its
    # in-memory control store (c) apart, as "durable control") and phase
    # 11's process fleet ("fleet": the leader's and every worker's). The
    # warm card store and plane (b) of phases 8-9, and phase 10's card
    # stores, pack through their resident planes: their fused_distro_stats
    # ran on the slab layout and are the slab row's alone; phase 10's
    # fleet stacks, and phase 11's workers build at the leader's floor
    # (cold builds at the common dims)
    slab_stores = ("a", "replayed", "thief")
    paths = {"tick": tick_launches, **service["launches"]}
    for r in rows:
        slab_only = r["name"] == "fused_distro_stats"
        r["launches_by_path"] = {
            p: c[r["name"]] for p, c in paths.items()
            if not (slab_only and p == "card warm")}
        r["launches_by_path"]["sharded"] = sum(
            c[r["name"]] for p, c in sharded.items() if not (slab_only and p == "b"))
        r["launches_by_path"]["durable"] = sum(
            c.get(r["name"], 0) for p, c in durable.items()
            if p != "c" and not (slab_only and p != "fleet"))
        r["launches_by_path"]["durable control"] = (
            0 if slab_only else durable["c"].get(r["name"], 0))
        r["launches_by_path"]["fleet"] = proc.get(r["name"], 0)
        r["launches"] = sum(r["launches_by_path"].values())
    slab = service["slab_row"]
    slab["floor_ms"] = floor_ms
    slab["launches_by_path"] = {
        "card warm": service["launches"]["card warm"]["fused_distro_stats"],
        "sharded": sharded["b"]["fused_distro_stats"],
        "durable": sum(durable[k].get("fused_distro_stats", 0) for k in slab_stores),
        "durable control": durable["c"].get("fused_distro_stats", 0),
        "fleet": 0}
    slab["launches"] = sum(slab["launches_by_path"].values())
    rows.append(slab)
    # the byte and chain bounds behind bound_ms are in the log lines above
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "floor_ms",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
