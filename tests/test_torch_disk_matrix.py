"""The port's disk-fault matrix (``evergreen_tpu_torch/scenarios/disk_matrix.py``)
and its WAL stamp's switch against the JAX package's (``tools/disk_matrix.py``,
``tests/test_storage_integrity.py``).

- The grid: every point of the three configs runs on the port and on
  JAX, with the same verdict, injected fault and counters; the port's
  uninterrupted reference states are JAX's; the files a point leaves in
  either package replay, verified and whole, to the reference state in
  the other.
- The WAL stamp's switch: an unstamped WAL written by either package
  under ``set_wal_crc_enabled(False)`` replays in both; with the switch
  on the port's WAL bytes are JAX's (``tests/test_torch_durable.py``
  holds the rest of the journal's bytes).
- The engine arm's eight points on the CPU against JAX's entries, the
  cases arm, and the fuzz arm's reachability.
- The tests of ``tests/test_storage_integrity.py`` that no port test
  holds run on the port as they are (``port_twin``), but the engine's,
  written out with ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from evergreen_tpu_torch.scenarios import disk_matrix as t_dm  # noqa: E402
from evergreen_tpu_torch.storage import integrity as t_integrity  # noqa: E402

from test_torch_durable import JAX, PORT, clock  # noqa: E402,F401
from test_torch_resilience import (  # noqa: E402,F401
    jax_case_names,
    jax_module,
    port_counters,
    run_module,
    run_port_twin,
)
from test_torch_scenarios import assert_same_entry, fresh, x64  # noqa: E402,F401


def j_dm():
    return jax_module("tools.disk_matrix")


POINTS = [f"{c}:{seam}:{kind}" for c in t_dm.CONFIGS for seam, kind in t_dm.GRID]
_REFERENCES = {}


def reference(config):
    """The port's uninterrupted reference states of ``config`` (once)."""
    if config not in _REFERENCES:
        _REFERENCES[config] = t_dm.reference_states(config)
    return _REFERENCES[config]


def shard_ids(config):
    return [0, 1] if config == "fleet2" else [None]


@pytest.mark.parametrize("config", t_dm.CONFIGS)
def test_reference_states_are_jax_s(config):
    assert reference(config) == j_dm().reference_states(config)
    assert len(reference(config)) == len(shard_ids(config))


def kept_grid_point(mod, config, seam, kind, ref):
    """``mod``'s grid point (the port's or JAX's ``disk_matrix``) with its
    data dir kept (the module's ``rmtree`` left undone), and that dir."""
    dirs = []

    def mkdtemp(**kw):
        dirs.append(tempfile.mkdtemp(**kw))
        return dirs[-1]

    saved = mod.shutil, mod.tempfile
    mod.shutil = types.SimpleNamespace(rmtree=lambda *a, **kw: None)
    mod.tempfile = types.SimpleNamespace(mkdtemp=mkdtemp)
    try:
        out = mod.run_grid_point(config, seam, kind, ref)
    finally:
        mod.shutil, mod.tempfile = saved
    return out, dirs[-1]


def reopened_in(pkg, data_dir, shard_id):
    """The canonical state ``pkg``'s store replays from ``data_dir``, and
    the corrupt frames it met."""
    store = pkg.durable.DurableStore(data_dir, shard_id=shard_id)
    try:
        return t_dm.canonical(store), store.replay_report["corrupt_frames"]
    finally:
        store._journal.close()


@pytest.mark.parametrize("point", POINTS)
def test_grid_point_is_jax_s_and_its_files_cross(point):
    """The point on both packages: ok, the one armed fault fired, the
    same storage counters; each package's files replay in the other to
    the reference state with no corrupt frame."""
    config, seam, kind = point.split(":")
    ref = reference(config)
    got, t_dir = kept_grid_point(t_dm, config, seam, kind, ref)
    want, j_dir = kept_grid_point(j_dm(), config, seam, kind, ref)
    try:
        assert got["ok"], got["problems"]
        assert want["ok"], want["problems"]
        assert got["fired"] == want["fired"] == [[seam, t_dm.SEAM_INDEX[seam], kind]]
        assert got["counters"] == want["counters"]
        for si, shard in enumerate(shard_ids(config)):
            assert reopened_in(JAX, t_dir, shard) == (ref[si], 0)
            assert reopened_in(PORT, j_dir, shard) == (ref[si], 0)
    finally:
        shutil.rmtree(t_dir, ignore_errors=True)
        shutil.rmtree(j_dir, ignore_errors=True)


def test_grid_is_jax_s():
    jdm = j_dm()
    for name in ("TICKS", "CHECKPOINT_TICK", "CONFIGS", "GRID", "SEAM_INDEX",
                 "ENGINE_KINDS"):
        assert getattr(t_dm, name) == getattr(jdm, name), name
    for seam, kind in t_dm.GRID:
        assert t_dm.expected_counters(seam, kind) == jdm.expected_counters(seam, kind)
    assert len(POINTS) == 42


# --------------------------------------------------------------------------- #
# the WAL stamp's switch
# --------------------------------------------------------------------------- #


def wal_lines(data_dir):
    with open(os.path.join(data_dir, "wal.log"), encoding="utf-8") as fh:
        return fh.read().splitlines()


@pytest.mark.parametrize("writer", [PORT, JAX], ids=["port", "jax"])
def test_an_unstamped_wal_replays_in_both_packages(writer, tmp_path, clock):
    d = str(tmp_path / "data")
    prev = writer.integrity.set_wal_crc_enabled(False)
    try:
        old = writer.store(d)
        for t in range(4):
            t_dm._one_tick(old, t, 0)
        old.sync_persist()
        live = t_dm.canonical(old)
    finally:
        assert writer.integrity.set_wal_crc_enabled(prev) is False
    assert t_integrity.wal_crc_enabled() and JAX.integrity.wal_crc_enabled()
    lines = wal_lines(d)
    assert lines and not any('"k":"' in ln for ln in lines)
    assert all(t_integrity.verify_wal_line(ln) is None for ln in lines)
    old._journal.close()
    for reader in (PORT, JAX):
        store = reader.store(d)
        assert store.replay_report["corrupt_frames"] == 0
        assert store.replay_report["frames"] > 0
        assert t_dm.canonical(store) == live
        rep = store.scrub()
        assert not rep["wal_corrupt_frames"] and not rep["snapshot_corrupt"]
        store._journal.close()


def test_the_port_s_unstamped_wal_is_jax_s_byte_for_byte(tmp_path, clock):
    """Off, both packages write the same unstamped lines; on, the same
    stamped lines (the stamp the only difference between the two)."""
    got = {}
    for on in (False, True):
        for pkg in (PORT, JAX):
            d = str(tmp_path / f"{pkg.name}-{on}")
            prev = pkg.integrity.set_wal_crc_enabled(on)
            try:
                store = pkg.store(d)
                for t in range(3):
                    t_dm._one_tick(store, t, 0)
                store.sync_persist()
                store._journal.close()
            finally:
                pkg.integrity.set_wal_crc_enabled(prev)
            got[pkg.name, on] = wal_lines(d)
    assert got["port", False] == got["jax", False]
    assert got["port", True] == got["jax", True]
    assert [t_integrity.stamp_wal_line(ln) for ln in got["port", False]] == got["port", True]


def test_the_switch_returns_its_previous_setting():
    assert t_integrity.wal_crc_enabled() is True
    assert t_integrity.set_wal_crc_enabled(False) is True
    try:
        assert t_integrity.wal_crc_enabled() is False
        assert t_integrity.set_wal_crc_enabled(False) is False
    finally:
        assert t_integrity.set_wal_crc_enabled(True) is False
    assert t_integrity.wal_crc_enabled() is True


# --------------------------------------------------------------------------- #
# the engine, cases and fuzz arms
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("point", t_dm.engine_points())
def test_engine_point_is_jax_s(point, x64, fresh):
    from evergreen_tpu.scenarios.engine import run_scenario

    target, _, kind = point.partition(":")
    want = run_scenario(j_dm()._engine_spec(target, kind))
    got = t_dm.run_engine_point(point, device="cpu")
    assert got["ok"], got["problems"]
    assert want["ok"]
    assert_same_entry(want, got["entry"])
    assert got["ticks"]["planners"] == ["tpu"] * 12
    assert got["ticks"]["verdicts"] == t_dm.verdicts(want)


@pytest.mark.parametrize("point", t_dm.engine_points())
def test_engine_spec_is_jax_s(point):
    target, _, kind = point.partition(":")
    t_spec, j_spec = t_dm._engine_spec(target, kind), j_dm()._engine_spec(target, kind)
    import dataclasses

    fields = [f.name for f in dataclasses.fields(t_spec)]
    assert fields == [f.name for f in dataclasses.fields(j_spec)]
    for field in fields:
        if field not in ("events", "slos", "checks"):
            assert getattr(t_spec, field) == getattr(j_spec, field), field
    assert [dataclasses.astuple(e) for e in t_spec.events] == [
        dataclasses.astuple(e) for e in j_spec.events]
    assert [dataclasses.astuple(s) for s in t_spec.slos] == [
        dataclasses.astuple(s) for s in j_spec.slos]
    assert [n for n, _ in t_spec.checks] == [n for n, _ in j_spec.checks]


@pytest.mark.parametrize("fn", [f.__name__ for f in t_dm.CASE_FNS])
def test_case_is_ok_as_jax_s(fn):
    got, want = getattr(t_dm, fn)(), getattr(j_dm(), fn)()
    assert got["ok"], got["problems"]
    assert want["ok"], want["problems"]
    assert got["point"] == want["point"]
    assert t_integrity.wal_crc_enabled() is True


def test_fuzz_arm_reaches_jax_s_weathers_and_runs_them_green(x64, fresh):
    from evergreen_tpu.scenarios import fuzz as j_fuzz

    got = t_dm.run_fuzz_reachability(device="cpu")
    assert [r["ok"] for r in got] == [True] * 3, [r["problems"] for r in got]
    want = []
    for seed in range(j_fuzz.DEFAULT_CAMPAIGN_SEED, j_fuzz.DEFAULT_CAMPAIGN_SEED + 200):
        if any(e.kind == "disk_fault" for e in j_fuzz.generate_weather(seed).events):
            want.append(f"w{seed}")
            if len(want) == 3:
                break
    assert [r["point"] for r in got] == want


# --------------------------------------------------------------------------- #
# JAX's tests/test_storage_integrity.py on the port
# --------------------------------------------------------------------------- #

#: held elsewhere: the snapshot's quarantine and rebuild, by scrub and at
#: open, and the ENOSPC shed and heal (tests/test_torch_durable.py:
#: test_snapshot_quarantined_and_rebuilt, test_enospc_shed_then_healed),
#: the replica's valid-prefix stop and read-repair
#: (tests/test_torch_replica.py); the engine's below; perf_guard's clause
#: waits for perf_guard's port
INTEGRITY_HELD = (
    "test_snapshot_bitrot_quarantined_and_rebuilt",
    "test_quarantined_snapshot_at_open_falls_back_to_wal",
    "test_enospc_commit_sheds_then_heals",
    "test_replica_stops_at_rot_then_read_repairs",
    "test_engine_disk_fault_event_runs_green",
    "test_perf_guard_checksum_clause_bites",
)


@pytest.mark.parametrize("name", jax_case_names("test_storage_integrity", INTEGRITY_HELD))
def test_jax_integrity_case_on_the_port(name, tmp_path, port_counters):
    run_port_twin("test_storage_integrity", name, tmp_path)


def test_engine_disk_fault_event_runs_green(fresh):
    from evergreen_tpu_torch.scenarios.engine import run_scenario

    entry = run_scenario(t_dm._engine_spec("wal", "enospc"), device="cpu")
    bad = {f"{sec}.{name}": v for sec in ("invariants", "checks", "slos")
           for name, v in entry.get(sec, {}).items() if not v["ok"]}
    assert entry["ok"], bad


# --------------------------------------------------------------------------- #
# the harness's entry point
# --------------------------------------------------------------------------- #


def test_main_runs_a_config_s_grid_and_an_engine_point_under_the_witness():
    rc, lines, err = run_module("evergreen_tpu_torch.scenarios.disk_matrix",
                                "--grid-only", "--config", "classic", "--device", "cpu")
    assert rc == 0, err
    grid = [json.loads(ln) for ln in lines if ln.startswith('{"arm"')]
    assert [g["point"] for g in grid] == [p for p in POINTS if p.startswith("classic:")]
    assert all(g["ok"] and g["wall_s"] >= 0 for g in grid)
    assert json.loads(lines[-2]) == {"lockcheck_inversions": 0}
    assert json.loads(lines[-1])["disk_matrix_failures"] == 0
    rc, lines, err = run_module("evergreen_tpu_torch.scenarios.disk_matrix",
                                "--engine-only", "--engine-point", "wal:bitrot",
                                "--device", "cpu")
    assert rc == 0, err
    ticks = json.loads(lines[0][len("TICKS "):])
    assert ticks["point"] == "wal:bitrot" and ticks["device_ticks"] == 12
    assert ticks["verdicts"]["checks"] == {"no-stranded-tmp": True, "rot-detected": True,
                                           "rot-healed": True}
    assert ticks["counters"]["storage.wal_corrupt_frames"] == 1
    assert json.loads(lines[-1]) == {"disk_matrix_points": 1, "disk_matrix_failures": 0,
                                     "failed": []}
