"""The rest of the user and admin REST surface through the port against
the JAX package: the admin settings over every config section, a
version's restart and abort, a distro's delete, a task's annotations,
task reliability, the permission routes, project copy and project
events; their models (``models/project_vars.py``,
``cloud/parameterstore.py``, ``models/annotations.py``,
``models/reliability.py``); and the ``admin`` and ``version`` commands.

Each package's ``RestApi`` is built over a store seeded with the same
documents and ticked once (``test_torch_rest.Both``), and the same
requests go to each under the ``world`` fixture's pinned clock, uuid4
stream and event sequences. The statuses and payloads are compared
exactly, and so are the documents the requests leave behind (tasks,
distros, queues, events, config, users, project refs and variables,
annotations). ``wilson_lower_bound`` is compared bit for bit.

The JAX package registers two ``cost`` sections and the one imported
last wins; its ``models/cost.py`` is imported here, so its registry
holds the model's, which is the one the port keeps.

The warm tick: ``test_warm_tick_after_the_admin_routes_matches_jax``
ticks each package's store with the TickCache and the resident plane
(``use_cache=True``) before and after a version's abort, its restart, a
``set_admin`` of the capacity section and a distro's delete, all sent
through each package's ``RestApi``, and holds every tick's outputs and
documents equal (``test_torch_tick.assert_same``).
"""
import contextlib
import copy
import dataclasses
import json
import os
import struct
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import evergreen_tpu.models.cost  # noqa: E402,F401  (the JAX registry's ``cost``)
from evergreen_tpu import settings as j_settings  # noqa: E402
from evergreen_tpu.api import rest as j_rest  # noqa: E402
from evergreen_tpu.cloud import parameterstore as j_params  # noqa: E402
from evergreen_tpu.models import annotations as j_ann  # noqa: E402
from evergreen_tpu.models import project_vars as j_pvars  # noqa: E402
from evergreen_tpu.models import reliability as j_rel  # noqa: E402
from evergreen_tpu.models import user as j_user  # noqa: E402
from evergreen_tpu.storage import durable as j_durable  # noqa: E402
from evergreen_tpu.storage import replica as j_replica  # noqa: E402
from evergreen_tpu.storage import store as j_store  # noqa: E402

from evergreen_tpu_torch import settings as t_settings  # noqa: E402
from evergreen_tpu_torch.api import rest as t_rest  # noqa: E402
from evergreen_tpu_torch.cloud import parameterstore as t_params  # noqa: E402
from evergreen_tpu_torch.models import annotations as t_ann  # noqa: E402
from evergreen_tpu_torch.models import project_vars as t_pvars  # noqa: E402
from evergreen_tpu_torch.models import reliability as t_rel  # noqa: E402
from evergreen_tpu_torch.storage import durable as t_durable  # noqa: E402
from evergreen_tpu_torch.storage import replica as t_replica  # noqa: E402
from evergreen_tpu_torch.storage import store as t_store  # noqa: E402

from test_torch_rest import Both, seeded  # noqa: E402
from test_torch_solve import x64  # noqa: E402,F401
from test_torch_tick import (  # noqa: E402,F401
    NOW,
    WARM,
    assert_same,
    generated,
    run_both,
    world,
)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: what the routes write, compared document for document
DOCS = ("tasks", "distros", "hosts", "task_queues", "task_secondary_queues",
        "events", "config", "users", "project_refs", "project_vars",
        "task_annotations", "task_execution_archive", "task_logs")
ROOT = {"api-user": "root", "api-key": "k-root"}
ALICE = {"api-user": "alice", "api-key": "k-alice"}
#: the sections the port lacked before the admin routes came
NEW_SECTIONS = ("SchedulerConfig", "UiConfig", "TriggerConfig", "CloudProvidersConfig",
                "ParameterStoreConfig", "ProjectCreationConfig",
                "SingleTaskDistroConfig", "TestSelectionConfig", "SplunkConfig",
                "GithubCheckRunConfig", "BucketsConfig")


def store_docs(store):
    return {c: copy.deepcopy(store.collection(c).find()) for c in DOCS}


def same_docs(both):
    got = {s.name: store_docs(s.store) for s in both.sides}
    for c in DOCS:
        assert got["port"][c] == got["jax"][c], c
    return got["port"]


def with_users(world, **kw):
    """``Both`` over the seeded store with two API users: ``alice``
    (no role) and ``root`` (superuser)."""
    both = Both(world, seeded(), **kw)
    for side in both.sides:
        users = side.store.collection("users")
        users.insert(j_user.User(id="alice", api_key="k-alice").to_doc())
        users.insert(j_user.User(id="root", api_key="k-root",
                                 roles=["superuser"]).to_doc())
    return both


def on_both(both, fn):
    """``fn(store)`` on each side's store, in the same order."""
    for side in both.sides:
        fn(side.store)


# --------------------------------------------------------------------------- #
# the admin settings
# --------------------------------------------------------------------------- #


def test_all_sections_are_the_jax_packages():
    t_all, j_all = t_settings.all_sections(), j_settings.all_sections()
    assert sorted(t_all) == sorted(j_all) and len(t_all) == 37
    for sid, j_cls in j_all.items():
        t_cls = t_all[sid]
        assert t_cls.__name__ == j_cls.__name__, sid
        assert dataclasses.asdict(t_cls()) == dataclasses.asdict(j_cls()), sid
        assert [(f.name, str(f.type)) for f in dataclasses.fields(t_cls)] == [
            (f.name, str(f.type)) for f in dataclasses.fields(j_cls)], sid


def test_admin_settings_match_jax(world):
    both = with_users(world, require_auth=True)
    st, out = both.same("GET", "/rest/v2/admin/settings", headers=ROOT)
    assert st == 200 and len(out) == 37
    assert out["capacity"]["fleet_intent_budget"] == 0
    # the tick's sections, an admin-only one and a list field
    edit = {"capacity": {"fleet_intent_budget": 7, "price_weight": 0.5},
            "task_limits": {"max_task_execution": 3},
            "ui": {"banner": "maintenance", "cors_origins": ["https://ci"]},
            "service_flags": {"host_allocator_disabled": True}}
    assert both.same("POST", "/rest/v2/admin/settings", edit, headers=ALICE)[0] == 403
    st, out = both.same("POST", "/rest/v2/admin/settings", edit, headers=ROOT)
    assert st == 200 and out == {"updated": list(edit)}
    st, out = both.same("GET", "/rest/v2/admin/settings", headers=ROOT)
    assert out["capacity"]["fleet_intent_budget"] == 7
    assert out["ui"]["cors_origins"] == ["https://ci"]
    # refusals: an unknown section, an unknown field, and what a
    # section's validation refuses (a ValueError out of set: 500 in both)
    for bad in ({"nope": {"x": 1}}, {"ui": {"nope": 1}},
                {"ui": {"csrf_key": "short"}}, {"capacity": {"iterations": 0}},
                {"container_pools": {"pools": [{"id": "p", "max_containers": 0}]}},
                {"logger_config": {"default_level": "loud"}}):
        assert both.same("POST", "/rest/v2/admin/settings", bad, headers=ROOT)[0] in (400, 500)
    # an override applies on read, and an edit keeps the base document
    ov = {"overrides": {"overrides": [{"section_id": "ui", "field": "banner",
                                       "value": "overridden"}]}}
    assert both.same("POST", "/rest/v2/admin/settings", ov, headers=ROOT)[0] == 200
    st, out = both.same("GET", "/rest/v2/admin/settings", headers=ROOT)
    assert out["ui"]["banner"] == "overridden"
    both.same("POST", "/rest/v2/admin/settings", {"ui": {"login_domain": "x"}}, headers=ROOT)
    assert both.sides[1].store.collection("config").get("ui")["banner"] == "maintenance"
    same_docs(both)


#: a secret of each kind the sections hold
SECRETS = {"auth": {"naive_users": [{"username": "u1", "password": "pw-secret-1"}]},
           "api": {"github_webhook_secret": "hook-secret-2", "sns_secret": "sns-secret-3"},
           "slack": {"token": "xoxb-secret-4"}}


def test_only_a_superuser_reads_the_admin_settings(world):
    """A departure: the port's ``GET admin/settings`` answers 403 to an
    authenticated user without the superuser scope, whose answer would
    carry the service's credentials; the JAX package's answers 200 with
    all of them. Without auth (no verified identity) both answer it."""
    both = with_users(world, require_auth=True)
    assert both.same("POST", "/rest/v2/admin/settings", SECRETS, headers=ROOT)[0] == 200
    got = both.call("GET", "/rest/v2/admin/settings", headers=ALICE)
    st, out, _ = got["port"]
    assert st == 403 and out == {"error": "superuser scope required"}
    leaked = json.dumps(got["jax"][1])
    assert got["jax"][0] == 200 and all(
        v in leaked for v in ("pw-secret-1", "hook-secret-2", "sns-secret-3", "xoxb-secret-4"))
    assert not any(v in json.dumps(out)
                   for v in ("pw-secret-1", "hook-secret-2", "sns-secret-3", "xoxb-secret-4"))
    # without credentials at all: 401 in both
    assert both.same("GET", "/rest/v2/admin/settings")[0] == 401
    # the superuser reads what JAX's reads
    st, out = both.same("GET", "/rest/v2/admin/settings", headers=ROOT)
    assert st == 200 and out["slack"]["token"] == "xoxb-secret-4"
    assert out["auth"]["naive_users"] == SECRETS["auth"]["naive_users"]
    # without auth both serve it
    open_both = with_users(world)
    assert open_both.same("GET", "/rest/v2/admin/settings")[0] == 200


def test_an_auth_edit_reloads_the_user_manager_like_jax(world):
    both = with_users(world, require_auth=True)
    body = {"auth": {"preferred_type": "naive",
                     "naive_users": [{"username": "u1", "password": "p1"}]}}
    st, _ = both.same("POST", "/rest/v2/admin/settings", body, headers=ROOT)
    assert st == 200
    for side in both.sides:
        mgr = both.apis[side.name].user_manager
        assert type(mgr).__name__ == "NaiveUserManager"
    same_docs(both)


# --------------------------------------------------------------------------- #
# a version's restart and abort; a distro's delete
# --------------------------------------------------------------------------- #


def _version_with_states(store):
    """The version with the most tasks, its tasks in every state the two
    routes tell apart: dispatched, started, finished both ways, queued
    and activated, queued and not."""
    tasks = store.collection("tasks")
    counts = {}
    for d in tasks.find():
        counts[d["version"]] = counts.get(d["version"], 0) + 1
    version = min(counts, key=lambda v: (-counts[v], v))
    ids = [d["_id"] for d in tasks.find(lambda d: d["version"] == version)]
    states = [{"status": "dispatched"}, {"status": "started"},
              {"status": "success", "finish_time": NOW - 5},
              {"status": "failed", "finish_time": NOW - 4, "details_type": "test"},
              {"status": "undispatched", "activated": False},
              {"status": "undispatched", "activated": True}]
    assert len(ids) >= len(states)
    for tid, upd in zip(ids, states):
        tasks.update(tid, upd)
    return version


def test_version_abort_and_restart_match_jax(world):
    both = Both(world, seeded())
    versions = [_version_with_states(side.store) for side in both.sides]
    version = versions[1]
    assert versions[0] == version
    st, out = both.same("POST", f"/rest/v2/versions/{version}/abort", {"user": "ops"})
    assert st == 200 and len(out["aborted"]) == 2 and out["deactivated"]
    st, out = both.same("POST", f"/rest/v2/versions/{version}/restart", {"user": "ops"})
    assert st == 200 and len(out["restarted"]) == 2
    assert both.same("POST", f"/rest/v2/versions/{version}/restart")[1] == {"restarted": []}
    assert both.same("POST", "/rest/v2/versions/nope/abort")[1] == {
        "aborted": [], "deactivated": []}
    same_docs(both)


def test_distro_delete_matches_jax(world):
    both = with_users(world, require_auth=True)
    store = both.sides[1].store
    did = store.collection("distros").find()[-1]["_id"]
    assert both.same("DELETE", "/rest/v2/distros/nope", headers=ROOT)[0] == 404
    assert both.same("DELETE", f"/rest/v2/distros/{did}", headers=ALICE)[0] == 403
    st, out = both.same("DELETE", f"/rest/v2/distros/{did}", headers=ROOT)
    assert st == 409 and "live host" in out["error"]

    def drain(s):
        hosts = s.collection("hosts")
        for d in hosts.find(lambda d: d["distro_id"] == did):
            hosts.update(d["_id"], {"status": "terminated"})

    on_both(both, drain)
    assert store.collection("task_queues").get(did) is not None
    assert both.same("DELETE", f"/rest/v2/distros/{did}", headers=ROOT) == (200, {"ok": True})
    assert store.collection("distros").get(did) is None
    assert store.collection("task_queues").get(did) is None
    assert both.same("GET", f"/rest/v2/distros/{did}", headers=ROOT)[0] == 404
    same_docs(both)


# --------------------------------------------------------------------------- #
# annotations
# --------------------------------------------------------------------------- #


def test_annotation_routes_match_jax(world):
    both = Both(world, seeded())
    tid = both.sides[1].store.collection("tasks").find()[3]["_id"]
    assert both.same("GET", f"/rest/v2/tasks/{tid}/annotations") == (200, {})
    st, out = both.same("PUT", f"/rest/v2/tasks/{tid}/annotation", {
        "note": "flaky on d001", "user": "ops",
        "issues": [{"url": "https://jira/EVG-1", "issue_key": "EVG-1"}],
        "suspected_issues": [{"url": "https://jira/EVG-2"}]})
    assert st == 200 and out["note"] == "flaky on d001" and len(out["issues"]) == 1
    assert both.same("PUT", f"/rest/v2/tasks/{tid}/annotation",
                     {"execution": 1, "note": "second run"})[0] == 200
    assert both.same("PUT", f"/rest/v2/tasks/{tid}/annotation",
                     {"issues": [{"url": "https://jira/EVG-3", "issue_key": "EVG-3"}]})[0] == 200
    st, out = both.same("GET", f"/rest/v2/tasks/{tid}/annotations")
    assert [i["issue_key"] for i in out["issues"]] == ["EVG-1", "EVG-3"]
    assert both.same("GET", f"/rest/v2/tasks/{tid}/annotations", {"execution": "1"})[1][
        "note"] == "second run"
    same_docs(both)


def test_annotation_model_functions_match_jax():
    """The model's functions on each package's store: the documents and
    the return values equal (both are pure host code)."""

    def run(ann, st_mod):
        store = st_mod.Store()
        store.collection("tasks").insert({"_id": "t1", "project": "p", "execution": 0})
        store.collection("tasks").insert({"_id": "t2", "project": "q", "execution": 2})
        out = [ann.get_annotation(store, "t1")]
        ann.add_issue(store, "t1", 0, ann.IssueLink(url="u1", issue_key="K1"))
        ann.add_issue(store, "t1", 0, ann.IssueLink(url="u2", issue_key="K2"), suspected=True)
        ann.set_note(store, "t1", 0, "note")
        out += [ann.remove_issue(store, "t1", 0, "nope"),
                ann.move_issue_to_suspected(store, "t1", 0, "K1"),
                ann.move_issue_to_suspected(store, "t1", 0, "K2", to_suspected=False),
                ann.remove_issue(store, "t1", 0, "K1", suspected=True),
                ann.remove_issue(store, "t9", 0, "K1")]
        ann.register_ticket_searcher(
            "p", lambda project, doc: [ann.IssueLink(url=f"bb/{doc['_id']}", issue_key="BB")])
        out += [ann.build_baron_suggest(store, "t1"), ann.build_baron_suggest(store, "t2"),
                ann.build_baron_suggest(store, "t9")]
        out += [dataclasses.asdict(ann.get_annotation(store, "t1"))]
        return json.loads(json.dumps(out, default=dataclasses.asdict)), \
            store.collection(ann.COLLECTION).find()

    import time as _t
    real = _t.time
    _t.time = lambda: NOW
    try:
        j = run(j_ann, j_store)
        t = run(t_ann, t_store)
    finally:
        _t.time = real
    assert t == j and t_ann.COLLECTION == j_ann.COLLECTION


# --------------------------------------------------------------------------- #
# task reliability
# --------------------------------------------------------------------------- #


def test_wilson_lower_bound_is_bit_equal():
    zs = [t_rel.significance_to_z(s) for s in (0.0001, 0.01, 0.05, 0.1, 0.5, 0.99)]
    assert zs == [j_rel.significance_to_z(s) for s in (0.0001, 0.01, 0.05, 0.1, 0.5, 0.99)]
    for z in zs + [0.0, 1.0, 1.96, 3.5]:
        for total in (0, 1, 2, 3, 7, 10, 99, 1000, 12345):
            for succ in sorted({0, 1, total // 3, total // 2, total - 1, total}):
                if not 0 <= succ <= total:
                    continue
                t = t_rel.wilson_lower_bound(succ, total, z)
                j = j_rel.wilson_lower_bound(succ, total, z)
                assert struct.pack("<d", t) == struct.pack("<d", j), (succ, total, z)


def _finished_history(store):
    """Finished executions of three task names over three variants, two
    distros and five days, with every failure kind, under one project."""
    tasks = store.collection("tasks")
    docs = tasks.find()
    day = 86400.0
    kinds = [("success", "", False), ("failed", "test", False),
             ("failed", "system", False), ("failed", "setup", False),
             ("failed", "test", True), ("success", "", False)]
    for k, d in enumerate(docs[:180]):
        status, dtype, timed_out = kinds[k % len(kinds)]
        finish = NOW - (k % 5) * day - 3600.0 * (k % 7)
        tasks.update(d["_id"], {
            "project": "rel", "display_name": ("compile", "lint", "test")[k % 3],
            "build_variant": ("ubuntu", "rhel", "win")[(k // 3) % 3],
            "distro_id": ("da", "db")[(k // 9) % 2],
            "requester": ("gitter_request", "patch_request")[(k // 2) % 2],
            "status": status, "details_type": dtype, "details_timed_out": timed_out,
            "start_time": finish - 60.0 - k, "finish_time": finish})


@pytest.mark.parametrize("query", [
    {"tasks": "compile,lint,test"},
    {"tasks": "compile", "group_by": "variant", "group_num_days": "2"},
    {"tasks": ["lint", "test"], "group_by": "distro", "sort": "earliest"},
    {"tasks": "test", "requesters": "patch_request", "variants": "rhel,win",
     "significance": "0.01"},
    {"tasks": "compile,lint", "distros": "db", "limit": "3",
     "after_date": str(NOW - 3 * 86400), "before_date": str(NOW - 86400)},
    {"tasks": ""},
    {"tasks": "test", "group_by": "nope"},
    {"tasks": "test", "significance": "2"},
    {"tasks": "test", "limit": "many"},
    {"tasks": "test", "after_date": str(NOW), "before_date": str(NOW - 1)},
])
def test_task_reliability_matches_jax(query, world):
    both = Both(world, seeded(n_tasks=240))
    on_both(both, _finished_history)
    st, out = both.same("GET", "/rest/v2/projects/rel/task_reliability", dict(query))
    if st == 200:
        assert out and all(0.0 <= r["success_rate"] <= 1.0 for r in out)
        for r in out:
            assert r["num_total"] == r["num_success"] + r["num_failed"]
    else:
        assert st == 400


def test_reliability_filter_and_classify_match_jax():
    docs = [{"status": "success"}, {"status": "failed", "details_type": "system"},
            {"status": "failed", "details_type": "setup"},
            {"status": "failed", "details_timed_out": True}, {"status": "failed"}]
    assert [t_rel._classify(d) for d in docs] == [j_rel._classify(d) for d in docs]
    for kw in (dict(project="", tasks=["a"]), dict(project="p", tasks=[]),
               dict(project="p", tasks=["a"], group_by="x"),
               dict(project="p", tasks=["a"], significance=-0.1),
               dict(project="p", tasks=["a"], group_num_days=0),
               dict(project="p", tasks=["a"], sort="sideways"),
               dict(project="p", tasks=["a"], after_date=5.0, before_date=5.0),
               dict(project="p", tasks=["a"])):
        base = dict(after_date=0.0, before_date=1.0)
        base.update(kw)
        assert (t_rel.ReliabilityFilter(**base).validate()
                == j_rel.ReliabilityFilter(**base).validate())
    for name in ("DAY_S", "GROUP_BY_TASK", "GROUP_BY_VARIANT", "GROUP_BY_DISTRO",
                 "SORT_EARLIEST", "SORT_LATEST", "MAX_LIMIT"):
        assert getattr(t_rel, name) == getattr(j_rel, name), name
    assert (dataclasses.asdict(t_rel.TaskReliability("a", "b", "c", 1.0))
            == dataclasses.asdict(j_rel.TaskReliability("a", "b", "c", 1.0)))


# --------------------------------------------------------------------------- #
# permissions
# --------------------------------------------------------------------------- #


def test_permission_routes_match_jax(world):
    both = with_users(world, require_auth=True)
    st, cat = both.same("GET", "/rest/v2/permissions", headers=ALICE)
    assert st == 200 and set(cat) == {"projectPermissions", "distroPermissions"}
    assert both.same("GET", "/rest/v2/permissions/users", headers=ALICE)[0] == 403
    assert both.same("GET", "/rest/v2/permissions/users", headers=ROOT) == (
        200, {"root": ["superuser"]})
    assert both.same("GET", "/rest/v2/users/alice/permissions", headers=ALICE) == (
        200, {"user_id": "alice", "roles": []})
    assert both.same("GET", "/rest/v2/users/ghost/permissions", headers=ALICE)[0] == 404
    assert both.same("POST", "/rest/v2/users/alice/permissions", {"role": "project:p1"},
                     headers=ALICE)[0] == 403
    for role in ("project:p1", "project:p2", "project:p1"):
        st, out = both.same("POST", "/rest/v2/users/alice/permissions", {"role": role},
                            headers=ROOT)
        assert st == 200
    assert out == {"user_id": "alice", "roles": ["project:p1", "project:p2"]}
    assert both.same("POST", "/rest/v2/users/alice/permissions", {}, headers=ROOT)[0] == 400
    assert both.same("POST", "/rest/v2/users/ghost/permissions", {"role": "x"},
                     headers=ROOT)[0] == 404
    assert both.same("DELETE", "/rest/v2/users/alice/permissions", {"role": "project:p2"},
                     headers=ROOT) == (200, {"ok": True})
    assert both.same("GET", "/rest/v2/permissions/users", headers=ROOT)[1] == {
        "alice": ["project:p1"], "root": ["superuser"]}
    assert both.same("DELETE", "/rest/v2/users/alice/permissions", headers=ROOT)[0] == 200
    assert both.same("DELETE", "/rest/v2/users/ghost/permissions", headers=ROOT)[0] == 404
    same_docs(both)


# --------------------------------------------------------------------------- #
# project copy, its variables and the project's events
# --------------------------------------------------------------------------- #


def _projects(store, pvars, repotracker):
    for pid in ("src", "dst"):
        repotracker.upsert_project_ref(store, repotracker.ProjectRef(
            id=pid, display_name=pid.upper(), owner="o", repo="r"))
    pvars.upsert(store, pvars.ProjectVars(
        "src", vars={"a": "1", "secret": "s3", "b": "2"}, private_vars={"secret": True}))
    pvars.upsert(store, pvars.ProjectVars("dst", vars={"keep": "k", "a": "old"}))


def test_project_copy_and_events_match_jax(world):
    from evergreen_tpu.ingestion import repotracker as j_repotracker
    from evergreen_tpu_torch.ingestion import repotracker as t_repotracker

    both = with_users(world, require_auth=True)
    for side, pv, rt in zip(both.sides, (j_pvars, t_pvars), (j_repotracker, t_repotracker)):
        _projects(side.store, pv, rt)
        side.store.collection("users").update("alice", {"roles": ["project:src"]})
    path = "/rest/v2/projects/src/copy"
    assert both.same("POST", path, {"new_project": "cp"}, headers={
        "api-user": "nobody", "api-key": "x"})[0] == 401
    assert both.same("POST", "/rest/v2/projects/dst/copy", {"new_project": "cp"},
                     headers=ALICE)[0] == 403
    assert both.same("POST", path, {}, headers=ALICE)[0] == 400
    assert both.same("POST", "/rest/v2/projects/nope/copy", {"new_project": "x"},
                     headers=ROOT)[0] == 404
    assert both.same("POST", path, {"new_project": "dst"}, headers=ROOT)[0] == 400
    st, out = both.same("POST", path, {"new_project": "cp"}, headers=ALICE)
    assert st == 200 and out["_id"] == "cp" and out["enabled"] is False
    # the variables: a dry run previews redacted, a real copy merges or
    # overwrites; both ends need the admin scope
    vpath = "/rest/v2/projects/src/copy/variables"
    assert both.same("POST", vpath, {}, headers=ROOT)[0] == 400
    assert both.same("POST", vpath, {"copy_to": "dst"}, headers=ALICE)[0] == 403
    assert both.same("POST", vpath, {"copy_to": "ghost"}, headers=ROOT)[0] == 404
    st, out = both.same("POST", vpath, {"copy_to": "dst", "dry_run": True,
                                         "include_private": True}, headers=ROOT)
    assert out == {"vars": {"a": "1", "secret": "", "b": "2"}, "dry_run": True}
    assert both.same("POST", vpath, {"copy_to": "dst"}, headers=ROOT)[1]["vars"] == {
        "a": "1", "b": "2"}
    assert both.same("POST", vpath, {"copy_to": "cp", "include_private": True,
                                     "overwrite": True}, headers=ROOT)[0] == 200
    # the events, newest first, paged on (timestamp, id)
    epath = "/rest/v2/projects/cp/events"
    st, page = both.same("GET", epath, {"limit": "1"}, headers=ALICE)
    assert st == 200 and len(page["events"]) == 1 and "next_id" in page
    st, rest = both.same("GET", epath, {"limit": "5", "ts": str(page["next_ts"]),
                                        "id": page["next_id"]}, headers=ALICE)
    assert [e["event_type"] for e in page["events"] + rest["events"]] == [
        "PROJECT_VARS_COPIED", "PROJECT_COPIED"]
    assert both.same("GET", epath, {"limit": "x"}, headers=ALICE)[0] == 400
    assert both.same("GET", "/rest/v2/projects/src/events", headers=ALICE) == (
        200, {"events": []})
    same_docs(both)


@pytest.mark.parametrize("opts", [
    dict(), dict(dry_run=True), dict(include_private=True),
    dict(overwrite=True), dict(include_private=True, overwrite=True),
])
def test_copy_vars_model_matches_jax(opts):
    out = {}
    for name, pv, st in (("jax", j_pvars, j_store), ("port", t_pvars, t_store)):
        store = st.Store()
        pv.upsert(store, pv.ProjectVars("a", vars={"x": "1", "p": "2"},
                                        private_vars={"p": True}))
        pv.upsert(store, pv.ProjectVars("b", vars={"y": "3", "x": "0"},
                                        private_vars={"y": True}))
        got = pv.copy_vars(store, "a", "b", **opts)
        out[name] = (got, store.collection(pv.COLLECTION).find(), pv.get(store, "b").redacted(),
                     pv.get(store, "ghost").to_doc(),
                     pv.ProjectVars.from_doc(pv.get(store, "a").to_doc()).redacted())
    assert out["port"] == out["jax"]


def test_parameter_store_matches_jax(monkeypatch):
    import time as _t

    monkeypatch.setattr(_t, "time", lambda: NOW)
    out = {}
    for name, pm, st in (("jax", j_params, j_store), ("port", t_params, t_store)):
        store = st.Store()
        client = pm.FakeSSMClient(store)
        mgr = pm.ParameterManager(client, prefix="/evg/")
        seq = []
        mgr.put("db/password", "hunter2")
        mgr.put("/abs/key", "v")
        seq += [mgr.get("db/password"), mgr.get("/abs/key"), mgr.get("missing")]
        client.put_parameter("/evg/db/password", "rotated")
        seq += [mgr.get("db/password"), mgr.get("db/password", use_cache=False)]
        seq += [mgr.delete("db/password"), mgr.delete("db/password"),
                mgr.get("db/password", use_cache=False)]
        out[name] = (seq, store.collection(pm.COLLECTION).find(), sorted(mgr._cache))
    assert out["port"] == out["jax"]
    assert issubclass(t_params.FakeSSMClient, t_params.ParameterClient)
    with pytest.raises(TypeError):
        t_params.ParameterClient()


# --------------------------------------------------------------------------- #
# the sections
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", NEW_SECTIONS + (
    "LoggerConfig", "AmboyConfig", "SshConfig", "ContainerPoolsConfig"))
def test_section_reads_back_what_jax_writes(name):
    """A section JAX writes with every field moved off its default reads
    back whole in the port, and the port's validation says what JAX's
    says on the same values."""
    j_cls, t_cls = getattr(j_settings, name), getattr(t_settings, name)
    j_store_, t_store_ = j_store.Store(), t_store.Store()
    moved = {}
    for f in dataclasses.fields(j_cls):
        v = getattr(j_cls(), f.name)
        moved[f.name] = ({True: False, False: True}[v] if isinstance(v, bool)
                         else v + 3 if isinstance(v, (int, float))
                         else v + "x" if isinstance(v, str)
                         else v + ["x"] if isinstance(v, list) else v)
    if name == "UiConfig":
        moved["csrf_key"] = "k" * 32
    if name == "ContainerPoolsConfig":
        moved["pools"] = [{"id": "p1", "distro": "d1", "max_containers": 2, "port": 9}]
    if name == "LoggerConfig":
        moved.update(default_level="debug", request_sample_ratio=0.5)
    j_obj = j_cls(**moved)
    assert j_obj.validate_and_default() == t_cls(**moved).validate_and_default() == ""
    j_obj.set(j_store_)
    t_store_.collection("config").insert(j_store_.collection("config").get(j_cls.section_id))
    assert dataclasses.asdict(t_cls.get(t_store_)) == dataclasses.asdict(j_obj)
    assert t_settings.get_section(t_store_, t_cls.section_id) == t_cls.get(t_store_)


@pytest.mark.parametrize("name,bad", [
    ("UiConfig", dict(csrf_key="short")),
    ("ContainerPoolsConfig", dict(pools=[{"max_containers": 1}])),
    ("ContainerPoolsConfig", dict(pools=[{"id": "a", "max_containers": 1},
                                         {"id": "a", "max_containers": 1}])),
    ("ContainerPoolsConfig", dict(pools=[{"id": "a", "max_containers": 0}])),
    ("AmboyConfig", dict(pool_size_local=-1)),
])
def test_section_validation_matches_jax(name, bad):
    j_obj, t_obj = getattr(j_settings, name)(**bad), getattr(t_settings, name)(**bad)
    assert t_obj.validate_and_default() == j_obj.validate_and_default()
    assert dataclasses.asdict(t_obj) == dataclasses.asdict(j_obj)


# --------------------------------------------------------------------------- #
# forwarding through a replica
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def _serving(api):
    srv = api.serve("127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


#: every mutating route of the slice, sent to a replica
FORWARDED = [
    ("POST", "/rest/v2/admin/settings", {"capacity": {"fleet_intent_budget": 9}}),
    ("POST", "/rest/v2/versions/v1/abort", {}),
    ("POST", "/rest/v2/versions/v1/restart", {}),
    ("PUT", "/rest/v2/tasks/t1/annotation", {"note": "seen"}),
    ("POST", "/rest/v2/users/alice/permissions", {"role": "project:p"}),
    ("DELETE", "/rest/v2/users/alice/permissions", {"role": "project:p"}),
    ("POST", "/rest/v2/projects/p/copy", {"new_project": "p2"}),
    ("POST", "/rest/v2/projects/p/copy/variables", {"copy_to": "p2"}),
    ("DELETE", "/rest/v2/distros/d1", {}),
]
#: the slice's reads, which a replica serves itself
LOCAL = [("/rest/v2/admin/settings", {}), ("/rest/v2/tasks/t1/annotations", {}),
         ("/rest/v2/projects/p/task_reliability", {"tasks": "t"}),
         ("/rest/v2/permissions", {}), ("/rest/v2/permissions/users", {}),
         ("/rest/v2/users/alice/permissions", {}), ("/rest/v2/projects/p2/events", {})]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mutating_routes_forward_through_a_replica(pkg, tmp_path, monkeypatch):
    """Each mutating route of the slice sent to a replica's ``RestApi``
    lands on the primary (the replica then serves it back), and each
    read stays on the replica; the answers equal the JAX package's."""
    import time as _t

    monkeypatch.setattr(_t, "time", lambda: NOW)
    rows = {}
    for name, durable, replica, rest in (
            ("jax", j_durable, j_replica, j_rest),
            ("port", t_durable, t_replica, t_rest)):
        d = tmp_path / name
        d.mkdir()
        primary = durable.DurableStore(str(d))
        primary.collection("distros").insert({"_id": "d1", "provider": "mock"})
        primary.collection("tasks").insert({"_id": "t1", "version": "v1", "project": "p",
                                            "status": "success", "execution": 0,
                                            "depends_on": [], "activated": True,
                                            "distro_id": "d1", "display_name": "t"})
        primary.collection("project_refs").insert({"_id": "p", "enabled": True})
        primary.collection("users").insert(j_user.User(id="alice", api_key="ka").to_doc())
        primary.collection("users").insert(j_user.User(id="root", api_key="kr",
                                                       roles=["superuser"]).to_doc())
        try:
            with _serving(rest.RestApi(primary)) as url:
                rep = replica.ReplicaStore(str(d), primary_url=url)
                rapi = rest.RestApi(rep)
                local = [rapi._maybe_forward("GET", p, b, {}) for p, b in LOCAL]
                out = []
                for method, path, body in FORWARDED:
                    st, payload = rapi.handle(method, path, copy.deepcopy(body),
                                              {"api-user": "root", "api-key": "kr"})
                    out.append((st, json.loads(json.dumps(payload))))
                served = [rapi.handle("GET", p, dict(b), {})[0] for p, b in LOCAL]
                rows[name] = (local, out, served,
                              json.loads(json.dumps(primary.collection("config").find())),
                              rep.collection("distros").get("d1"),
                              rep.collection("task_annotations").count())
                rep.close()
        finally:
            primary.close()
    assert rows["port"] == rows["jax"]
    local, out, served, config, distro, n_ann = rows["port"]
    assert local == [None] * len(LOCAL)
    assert [st for st, _ in out] == [200] * len(FORWARDED)
    assert served == [200] * len(LOCAL)
    assert config and distro is None and n_ann == 1


# --------------------------------------------------------------------------- #
# the commands
# --------------------------------------------------------------------------- #


def _run_cli(*argv):
    env = dict(os.environ, PYTHONPATH=HERE)
    return subprocess.run([sys.executable, "-X", "importtime", "-m", "evergreen_tpu_torch",
                           *argv], capture_output=True, text=True, timeout=60, env=env,
                          cwd=HERE)


def _imports(stderr):
    return {line.rsplit("|", 1)[-1].strip() for line in stderr.splitlines()
            if line.startswith("import time:")}


def test_version_command_prints_jax_s_line_without_torch():
    from evergreen_tpu import __version__ as j_version

    proc = _run_cli("version")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == f"evergreen-tpu {j_version}\n"
    mods = _imports(proc.stderr)
    assert "evergreen_tpu_torch.cli" in mods
    assert not {m for m in mods if m == "torch" or m.startswith("torch.")}


def test_admin_command_gets_and_sets_without_torch(world):
    """``admin get`` prints every section to the superuser, ``admin
    set-flag`` sets one flag through the superuser's key, and a user
    without the scope gets the server's 403 answers printed for both; no
    ``torch`` is imported."""
    store = t_store.Store()
    users = store.collection("users")
    users.insert(j_user.User(id="alice", api_key="ka").to_doc())
    users.insert(j_user.User(id="root", api_key="kr", roles=["superuser"]).to_doc())
    with _serving(t_rest.RestApi(store, require_auth=True)) as url:
        got = _run_cli("admin", "get", "--api-server", url, "--api-user", "root",
                       "--api-key", "kr")
        assert got.returncode == 0, got.stderr[-2000:]
        assert sorted(json.loads(got.stdout)) == sorted(t_settings.all_sections())
        hidden = _run_cli("admin", "get", "--api-server", url, "--api-user", "alice",
                          "--api-key", "ka")
        assert hidden.returncode == 0, hidden.stderr[-2000:]
        assert json.loads(hidden.stdout) == {"error": "superuser scope required"}
        denied = _run_cli("admin", "set-flag", "--flag", "host_allocator_disabled",
                          "--api-server", url, "--api-user", "alice", "--api-key", "ka")
        assert denied.returncode == 0
        assert json.loads(denied.stdout) == {"error": "admin scope required"}
        ok = _run_cli("admin", "set-flag", "--flag", "host_allocator_disabled",
                      "--api-server", url, "--api-user", "root", "--api-key", "kr")
        assert json.loads(ok.stdout) == {"updated": ["service_flags"]}
    assert t_settings.ServiceFlags.get(store).host_allocator_disabled is True
    for proc in (got, hidden, denied, ok):
        mods = _imports(proc.stderr)
        assert not {m for m in mods if m == "torch" or m.startswith("torch.")}


# --------------------------------------------------------------------------- #
# the warm tick after the routes
# --------------------------------------------------------------------------- #


def _api(store):
    rest = j_rest if isinstance(store, j_store.Store) else t_rest
    return rest.RestApi(store)


def _abort(store):
    v = store.collection("tasks").find(lambda d: d["status"] == "undispatched")[0]["version"]
    st, out = _api(store).handle("POST", f"/rest/v2/versions/{v}/abort", {})
    assert st == 200 and out["deactivated"]


def _restart(store):
    tasks = store.collection("tasks")
    done = tasks.find(lambda d: d["status"] in ("success", "failed"))
    v = (done[0] if done else tasks.find()[0])["version"]
    for d in tasks.find(lambda d: d["version"] == v)[:3]:
        tasks.update(d["_id"], {"status": "failed", "finish_time": NOW})
    st, out = _api(store).handle("POST", f"/rest/v2/versions/{v}/restart", {})
    assert st == 200 and out["restarted"]


def _settings(store):
    st, _ = _api(store).handle("POST", "/rest/v2/admin/settings", {
        "capacity": {"fleet_intent_budget": 3},
        "task_limits": {"max_task_execution": 4}})
    assert st == 200


def _delete(store):
    """The distro with the most queued tasks, its hosts drained, deleted."""
    tasks = store.collection("tasks")
    counts = {}
    for d in tasks.find(lambda d: d["status"] == "undispatched" and d["activated"]):
        counts[d["distro_id"]] = counts.get(d["distro_id"], 0) + 1
    did = min(counts, key=lambda k: (-counts[k], k))
    hosts = store.collection("hosts")
    for h in hosts.find(lambda d: d["distro_id"] == did):
        hosts.update(h["_id"], {"status": "terminated"})
    st, _ = _api(store).handle("DELETE", f"/rest/v2/distros/{did}", {})
    assert st == 200


@pytest.mark.parametrize("name", ["gen3+cap", "gen5+cap"])
def test_warm_tick_after_the_admin_routes_matches_jax(name, world):
    """The service's warm tick (TickCache, resident plane) on each
    package's store, with the admin routes between the ticks: a
    version's abort, its restart, ``set_admin`` of the capacity and
    task-limits sections, and a distro's delete. Every tick's result,
    intents and written documents equal JAX's, and the last tick plans
    one distro fewer than the first."""
    seed = int(name[3])
    script = [(NOW, None, WARM), (NOW + 15, _abort, WARM), (NOW + 30, _restart, WARM),
              (NOW + 45, _settings, WARM), (NOW + 60, _delete, WARM),
              (NOW + 75, None, WARM)]
    j, t = run_both(world, generated(seed, capacity=True), script)
    assert_same(j, t)
    res = [x["result"] for x in t]
    assert [r["planner_used"] for r in res] == ["tpu"] * len(script)
    assert [r["degraded"] for r in res] == [""] * len(script)
    assert res[-1]["n_distros"] == res[0]["n_distros"] - 1
    # the budget the settings route wrote bounds the intents after it
    assert all(len(r["intents"]) <= 3 for r in res[3:])
