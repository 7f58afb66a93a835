"""The port's runtime lock-order witness (``evergreen_tpu_torch/utils/
lockcheck.py``): every test of the JAX package's ``tests/test_lockcheck.py``
run on the port (the same source, every ``evergreen_tpu`` import pointed
at ``evergreen_tpu_torch``: ``twin``), and the port's lock inventory:
no raw ``threading`` lock, rlock or condition outside the witness, and
the roles both packages create held to the same names."""
import contextlib
import importlib
import inspect
import os
import re
import types

import pytest

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "evergreen_tpu_torch")
JAX_DIR = os.path.join(os.path.dirname(PORT_DIR), "evergreen_tpu")


def twin(modname):
    """The JAX package's test module ``modname`` on the port: the same
    source, every ``evergreen_tpu`` import pointed at the port."""
    jmod = importlib.import_module(modname)
    with open(jmod.__file__, encoding="utf-8") as fh:
        src = re.sub(r"\bevergreen_tpu\b", "evergreen_tpu_torch", fh.read())
    tmod = types.ModuleType(f"{modname}_on_the_port")
    tmod.__file__ = jmod.__file__
    exec(compile(src, jmod.__file__, "exec"), tmod.__dict__)
    return tmod


def case_names(modname, skip=()):
    jmod = importlib.import_module(modname)
    return [n for n, f in vars(jmod).items()
            if n.startswith("test_") and inspect.isfunction(f) and n not in skip]


def call_case(mod, name, tmp_path, extra=None):
    """Run test ``name`` of ``mod`` with its fixtures resolved: the
    module's own, else ``monkeypatch``, ``tmp_path`` and ``extra``'s
    factories (name -> callable)."""
    values, teardown = {}, []
    mp = pytest.MonkeyPatch()
    extra = extra or {}

    def resolve(arg):
        if arg in values:
            return values[arg]
        own = getattr(mod, arg, None)
        if hasattr(own, "_get_wrapped_function"):  # a pytest fixture
            fn = own._get_wrapped_function()
            out = fn(**{a: resolve(a) for a in inspect.signature(fn).parameters})
            if inspect.isgenerator(out):
                gen, out = out, next(out)
                teardown.append(gen)
        elif arg == "monkeypatch":
            out = mp
        elif arg == "tmp_path":
            out = tmp_path
        elif arg in extra:
            out = extra[arg]()
        else:
            raise LookupError(f"no fixture {arg}")
        values[arg] = out
        return out

    try:
        fn = getattr(mod, name)
        fn(**{a: resolve(a) for a in inspect.signature(fn).parameters})
    finally:
        for gen in reversed(teardown):
            with contextlib.suppress(StopIteration):
                next(gen)
        mp.undo()


_TWINS = {}


def jax_crash_matrix():
    """The JAX repository's ``tools/crash_matrix.py``, imported without
    keeping the witness switch it sets at import
    (``EVERGREEN_TPU_LOCKCHECK``) in this process, whose later locks
    would all be witnessed."""
    before = os.environ.get("EVERGREEN_TPU_LOCKCHECK")
    from tools import crash_matrix

    if before is None:
        os.environ.pop("EVERGREEN_TPU_LOCKCHECK", None)
    else:
        os.environ["EVERGREEN_TPU_LOCKCHECK"] = before
    return crash_matrix


def run_twin(modname, name, tmp_path, extra=None):
    if modname not in _TWINS:
        _TWINS[modname] = twin(modname)
    call_case(_TWINS[modname], name, tmp_path, extra)


@pytest.mark.parametrize("name", case_names("test_lockcheck"))
def test_jax_lockcheck_case_on_the_port(name, tmp_path):
    run_twin("test_lockcheck", name, tmp_path)


# --------------------------------------------------------------------------- #
# the inventory
# --------------------------------------------------------------------------- #

RAW = re.compile(r"\bthreading\.(Lock|RLock|Condition)\(|"
                 r"from\s+threading\s+import\s+[^\n]*\b(Lock|RLock|Condition)\b")
ROLE = re.compile(r"make_(?:lock|rlock|condition)\(\s*\"([^\"]+)\"")


def sources(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    yield os.path.relpath(path, root), fh.read()


def test_the_port_creates_no_raw_lock_outside_the_witness():
    raw = [(rel, m.group(0)) for rel, text in sources(PORT_DIR)
           if rel != os.path.join("utils", "lockcheck.py")
           for m in RAW.finditer(text)]
    assert raw == []


def roles_by_site(root):
    """(module, role) of every factory call in ``root``."""
    return {(rel, role) for rel, text in sources(root) for role in ROLE.findall(text)}


def test_shared_lock_roles_are_jax_s():
    """Where both packages create a lock in the same module, the port
    uses JAX's role name; the roles only the port has are its own
    modules' locks (the kernels' counters and build, the sidecar, the
    task indexes, the profiler capture), none of them a JAX role."""
    jax_sites, port_sites = roles_by_site(JAX_DIR), roles_by_site(PORT_DIR)
    jax_roles = {r for _, r in jax_sites}
    port_only = {(m, r) for m, r in port_sites if r not in jax_roles}
    assert port_only == {
        ("ops/_build.py", "ops.build"),
        ("ops/distro_stats.py", "ops.distro_stats.launches"),
        ("ops/segment.py", "ops.segment.launches"),
        ("ops/solve.py", "ops.solve.card_solves"),
        ("api/sidecar.py", "sidecar.solve"),
        ("models/lifecycle.py", "lifecycle.index.pending"),
        ("models/lifecycle.py", "lifecycle.index"),
        ("models/lifecycle.py", "lifecycle.indexes"),
        ("utils/tracing.py", "trace.profile"),
    }
    assert ("storage/lease.py", "lease.epoch") in jax_sites & port_sites
    shared_modules = {m for m, _ in jax_sites} & {m for m, _ in port_sites}
    for module in sorted(shared_modules):
        port = {r for m, r in port_sites if m == module and r in jax_roles}
        jax = {r for m, r in jax_sites if m == module}
        assert port <= jax, module


def test_the_witness_wraps_the_port_s_locks_when_on(monkeypatch, tmp_path):
    """Instance locks created with the variable set are witnessed (a
    lease's epoch lock, a durable store's flush condition), and with it
    unset they are the raw primitives."""
    from evergreen_tpu_torch.storage.durable import DurableStore
    from evergreen_tpu_torch.storage.lease import FileLease
    from evergreen_tpu_torch.utils import lockcheck

    monkeypatch.delenv("EVERGREEN_TPU_LOCKCHECK", raising=False)
    raw = FileLease(str(tmp_path / "a.lease"))
    assert not isinstance(raw._epoch_lock, lockcheck._WitnessLock)
    monkeypatch.setenv("EVERGREEN_TPU_LOCKCHECK", "1")
    lockcheck.reset()
    lease = FileLease(str(tmp_path / "b.lease"))
    assert isinstance(lease._epoch_lock, lockcheck._WitnessLock)
    assert lease._epoch_lock.role == "lease.epoch"
    store = DurableStore(str(tmp_path / "d"))
    assert store._flush_cv._lock is store._flush_lock
    assert store._flush_lock.role == "durable.flush"
    store.begin_tick()
    store.collection("k").upsert({"_id": "x"})
    store.end_tick()
    store.close()
    assert lockcheck.violations() == []
    lockcheck.reset()
