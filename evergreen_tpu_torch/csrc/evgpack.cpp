// evgpack — native snapshot packer for the scheduling tick.
//
// The per-task column extraction is the hottest host-side loop of a tick
// (~12 Python-level passes over 50k Task objects). This CPython extension
// makes ONE pass, reading attributes through the C API and writing the
// snapshot arena views directly. Semantics mirror
// evergreen_tpu/scheduler/snapshot.py's fill block exactly; the Python
// implementation remains as the fallback and the behavioral reference.
//
// Built with g++ at first use (see evergreen_tpu/utils/native.py); no
// build-system dependency.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// cached attribute-name objects (created once at module init)
PyObject* s_priority;
PyObject* s_requester;
PyObject* s_activated_by;
PyObject* s_generate_task;
PyObject* s_task_group;
PyObject* s_task_group_order;
PyObject* s_activated_time;
PyObject* s_ingest_time;
PyObject* s_scheduled_time;
PyObject* s_dependencies_met_time;
PyObject* s_expected_duration_s;
PyObject* s_num_dependents;

bool StrEquals(PyObject* obj, const char* want) {
  if (!PyUnicode_Check(obj)) return false;
  const char* got = PyUnicode_AsUTF8(obj);
  return got != nullptr && strcmp(got, want) == 0;
}

double AsDouble(PyObject* obj, bool* ok) {
  double v = PyFloat_AsDouble(obj);
  if (v == -1.0 && PyErr_Occurred()) {
    *ok = false;
    return 0.0;
  }
  return v;
}

// pack_task_static_columns(tasks, default_duration_s, out) -> None
//
// The time-INdependent subset of pack_task_columns, plus the f64 time
// bases (t_basis = activated-or-ingest, t_start = max(scheduled,
// deps-met)) from which the per-tick dynamic columns (time-in-queue,
// wait-since-deps-met) are one vectorized numpy expression. Outputs are
// cacheable per unchanged task list (snapshot.py static-column memo):
//   uint8:  t_is_merge, t_is_patch, t_stepback, t_generate, t_in_group
//   int32:  t_priority, t_group_order, t_num_dependents
//   float32: t_expected_s, t_expected_floor_s
//   float64: t_basis, t_start
PyObject* PackTaskStaticColumns(PyObject*, PyObject* args) {
  PyObject* tasks;
  double default_dur;
  PyObject* out;
  if (!PyArg_ParseTuple(args, "OdO", &tasks, &default_dur, &out)) {
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(tasks, "tasks must be a sequence");
  if (seq == nullptr) return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

  auto view = [&](const char* name, Py_ssize_t itemsize,
                  Py_buffer* buf) -> bool {
    PyObject* arr = PyDict_GetItemString(out, name);  // borrowed
    if (arr == nullptr) {
      PyErr_Format(PyExc_KeyError, "missing output column %s", name);
      return false;
    }
    if (PyObject_GetBuffer(arr, buf, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) !=
        0) {
      return false;
    }
    if (buf->itemsize != itemsize || buf->len < n * itemsize) {
      PyBuffer_Release(buf);
      PyErr_Format(PyExc_ValueError, "column %s has wrong shape/dtype", name);
      return false;
    }
    return true;
  };

  Py_buffer b_merge{}, b_patch{}, b_stepback{}, b_generate{}, b_in_group{};
  Py_buffer b_priority{}, b_group_order{}, b_numdep{};
  Py_buffer b_expected{}, b_expected_floor{}, b_basis{}, b_start{};
  Py_buffer* all[] = {&b_merge,       &b_patch,   &b_stepback,
                      &b_generate,    &b_in_group, &b_priority,
                      &b_group_order, &b_numdep,  &b_expected,
                      &b_expected_floor, &b_basis, &b_start};
  int acquired = 0;
  bool ok = view("t_is_merge", 1, &b_merge) && ++acquired &&
            view("t_is_patch", 1, &b_patch) && ++acquired &&
            view("t_stepback", 1, &b_stepback) && ++acquired &&
            view("t_generate", 1, &b_generate) && ++acquired &&
            view("t_in_group", 1, &b_in_group) && ++acquired &&
            view("t_priority", 4, &b_priority) && ++acquired &&
            view("t_group_order", 4, &b_group_order) && ++acquired &&
            view("t_num_dependents", 4, &b_numdep) && ++acquired &&
            view("t_expected_s", 4, &b_expected) && ++acquired &&
            view("t_expected_floor_s", 4, &b_expected_floor) && ++acquired &&
            view("t_basis", 8, &b_basis) && ++acquired &&
            view("t_start", 8, &b_start) && ++acquired;
  if (!ok) {
    for (int i = 0; i < acquired; ++i) PyBuffer_Release(all[i]);
    Py_DECREF(seq);
    return nullptr;
  }

  auto* merge = static_cast<uint8_t*>(b_merge.buf);
  auto* patch = static_cast<uint8_t*>(b_patch.buf);
  auto* stepback = static_cast<uint8_t*>(b_stepback.buf);
  auto* generate = static_cast<uint8_t*>(b_generate.buf);
  auto* in_group = static_cast<uint8_t*>(b_in_group.buf);
  auto* priority = static_cast<int32_t*>(b_priority.buf);
  auto* group_order = static_cast<int32_t*>(b_group_order.buf);
  auto* numdep = static_cast<int32_t*>(b_numdep.buf);
  auto* expected = static_cast<float*>(b_expected.buf);
  auto* expected_floor = static_cast<float*>(b_expected_floor.buf);
  auto* basis_out = static_cast<double*>(b_basis.buf);
  auto* start_out = static_cast<double*>(b_start.buf);

  bool good = true;
  for (Py_ssize_t i = 0; good && i < n; ++i) {
    PyObject* t = PySequence_Fast_GET_ITEM(seq, i);  // borrowed

    PyObject* req = PyObject_GetAttr(t, s_requester);
    PyObject* act_by = PyObject_GetAttr(t, s_activated_by);
    PyObject* gen = PyObject_GetAttr(t, s_generate_task);
    PyObject* tg = PyObject_GetAttr(t, s_task_group);
    PyObject* prio = PyObject_GetAttr(t, s_priority);
    PyObject* tgo = PyObject_GetAttr(t, s_task_group_order);
    PyObject* nd = PyObject_GetAttr(t, s_num_dependents);
    PyObject* at = PyObject_GetAttr(t, s_activated_time);
    PyObject* it = PyObject_GetAttr(t, s_ingest_time);
    PyObject* st = PyObject_GetAttr(t, s_scheduled_time);
    PyObject* dmt = PyObject_GetAttr(t, s_dependencies_met_time);
    PyObject* dur = PyObject_GetAttr(t, s_expected_duration_s);

    if (!req || !act_by || !gen || !tg || !prio || !tgo || !nd || !at || !it ||
        !st || !dmt || !dur) {
      good = false;
    } else {
      const bool is_merge = StrEquals(req, "github_merge_request");
      merge[i] = is_merge ? 1 : 0;
      patch[i] = (!is_merge && (StrEquals(req, "patch_request") ||
                                StrEquals(req, "github_pull_request")))
                     ? 1
                     : 0;
      stepback[i] = StrEquals(act_by, "stepback-activator") ? 1 : 0;
      generate[i] = PyObject_IsTrue(gen) ? 1 : 0;
      const bool grouped = PyUnicode_Check(tg) && PyUnicode_GetLength(tg) > 0;
      in_group[i] = grouped ? 1 : 0;

      priority[i] = static_cast<int32_t>(PyLong_AsLong(prio));
      group_order[i] = static_cast<int32_t>(PyLong_AsLong(tgo));
      numdep[i] = static_cast<int32_t>(PyLong_AsLong(nd));

      const double activated = AsDouble(at, &good);
      const double ingest = AsDouble(it, &good);
      const double sched = AsDouble(st, &good);
      const double deps_met_t = AsDouble(dmt, &good);
      const double duration = AsDouble(dur, &good);
      if (good) {
        basis_out[i] = activated > 0.0 ? activated : ingest;
        start_out[i] = sched > deps_met_t ? sched : deps_met_t;
        const double exp_dur = duration > 0.0 ? duration : default_dur;
        expected[i] = static_cast<float>(exp_dur);
        expected_floor[i] = static_cast<float>(std::floor(exp_dur));
      }
      if (PyErr_Occurred()) good = false;
    }
    Py_XDECREF(req);
    Py_XDECREF(act_by);
    Py_XDECREF(gen);
    Py_XDECREF(tg);
    Py_XDECREF(prio);
    Py_XDECREF(tgo);
    Py_XDECREF(nd);
    Py_XDECREF(at);
    Py_XDECREF(it);
    Py_XDECREF(st);
    Py_XDECREF(dmt);
    Py_XDECREF(dur);
  }

  for (auto* b : all) PyBuffer_Release(b);
  Py_DECREF(seq);
  if (!good) return nullptr;
  Py_RETURN_NONE;
}

// pack_host_columns(hosts, estimates, out) -> [(index, group_string)...]
//
// One native pass over the host fleet: emits h_free / h_running /
// h_elapsed_s / h_expected_s / h_std_s directly into arena views and
// returns the (rare) hosts that are running a task-group task, as
// (flat index, task_group_string) pairs for the caller's segment
// mapping. ``estimates`` maps host id -> RunningTaskEstimate.
PyObject* PackHostColumns(PyObject*, PyObject* args) {
  static PyObject* s_running_task = PyUnicode_InternFromString("running_task");
  static PyObject* s_running_group =
      PyUnicode_InternFromString("running_task_group");
  static PyObject* s_teardown =
      PyUnicode_InternFromString("task_group_teardown_start_time");
  static PyObject* s_host_id = PyUnicode_InternFromString("id");
  static PyObject* s_elapsed = PyUnicode_InternFromString("elapsed_s");
  static PyObject* s_expected = PyUnicode_InternFromString("expected_s");
  static PyObject* s_std = PyUnicode_InternFromString("std_dev_s");
  static PyObject* s_tgs = PyUnicode_InternFromString("task_group_string");

  PyObject* hosts;
  PyObject* estimates;
  PyObject* out;
  if (!PyArg_ParseTuple(args, "OOO", &hosts, &estimates, &out)) {
    return nullptr;
  }
  if (!PyDict_Check(estimates)) {
    PyErr_SetString(PyExc_TypeError, "estimates must be a dict");
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(hosts, "hosts must be a sequence");
  if (seq == nullptr) return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

  auto view = [&](const char* name, Py_ssize_t itemsize,
                  Py_buffer* buf) -> bool {
    PyObject* arr = PyDict_GetItemString(out, name);  // borrowed
    if (arr == nullptr) {
      PyErr_Format(PyExc_KeyError, "missing output column %s", name);
      return false;
    }
    if (PyObject_GetBuffer(arr, buf, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) !=
        0) {
      return false;
    }
    if (buf->itemsize != itemsize || buf->len < n * itemsize) {
      PyBuffer_Release(buf);
      PyErr_Format(PyExc_ValueError, "column %s has wrong shape/dtype", name);
      return false;
    }
    return true;
  };

  Py_buffer b_free{}, b_running{}, b_elapsed{}, b_expected{}, b_std{};
  Py_buffer* all[] = {&b_free, &b_running, &b_elapsed, &b_expected, &b_std};
  int acquired = 0;
  bool ok = view("h_free", 1, &b_free) && ++acquired &&
            view("h_running", 1, &b_running) && ++acquired &&
            view("h_elapsed_s", 4, &b_elapsed) && ++acquired &&
            view("h_expected_s", 4, &b_expected) && ++acquired &&
            view("h_std_s", 4, &b_std) && ++acquired;
  if (!ok) {
    for (int i = 0; i < acquired; ++i) PyBuffer_Release(all[i]);
    Py_DECREF(seq);
    return nullptr;
  }
  auto* hfree = static_cast<uint8_t*>(b_free.buf);
  auto* hrun = static_cast<uint8_t*>(b_running.buf);
  auto* helap = static_cast<float*>(b_elapsed.buf);
  auto* hexp = static_cast<float*>(b_expected.buf);
  auto* hstd = static_cast<float*>(b_std.buf);

  PyObject* named = PyList_New(0);
  if (named == nullptr) {
    for (auto* b : all) PyBuffer_Release(b);
    Py_DECREF(seq);
    return nullptr;
  }

  bool good = true;
  for (Py_ssize_t i = 0; good && i < n; ++i) {
    PyObject* h = PySequence_Fast_GET_ITEM(seq, i);  // borrowed
    PyObject* rt = PyObject_GetAttr(h, s_running_task);
    PyObject* rg = PyObject_GetAttr(h, s_running_group);
    PyObject* td = PyObject_GetAttr(h, s_teardown);
    PyObject* hid = PyObject_GetAttr(h, s_host_id);
    if (!rt || !rg || !td || !hid) {
      good = false;
    } else {
      const bool has_task =
          PyUnicode_Check(rt) && PyUnicode_GetLength(rt) > 0;
      const double teardown = AsDouble(td, &good);
      // Host.is_free: no running task and not tearing down
      hfree[i] = (!has_task && teardown <= 0.0) ? 1 : 0;
      PyObject* est =
          has_task ? PyDict_GetItem(estimates, hid) : nullptr;  // borrowed
      if (est != nullptr && est != Py_None) {
        hrun[i] = 1;
        PyObject* e = PyObject_GetAttr(est, s_elapsed);
        PyObject* x = PyObject_GetAttr(est, s_expected);
        PyObject* sd = PyObject_GetAttr(est, s_std);
        if (!e || !x || !sd) {
          good = false;
        } else {
          helap[i] = static_cast<float>(AsDouble(e, &good));
          hexp[i] = static_cast<float>(AsDouble(x, &good));
          hstd[i] = static_cast<float>(AsDouble(sd, &good));
        }
        Py_XDECREF(e);
        Py_XDECREF(x);
        Py_XDECREF(sd);
      } else {
        hrun[i] = 0;
        helap[i] = 0.0f;
        hexp[i] = 0.0f;
        hstd[i] = 0.0f;
      }
      if (has_task && PyUnicode_Check(rg) && PyUnicode_GetLength(rg) > 0) {
        PyObject* gs = PyObject_CallMethodNoArgs(h, s_tgs);
        if (gs == nullptr) {
          good = false;
        } else {
          PyObject* pair = Py_BuildValue("(nO)", i, gs);
          Py_DECREF(gs);
          if (pair == nullptr || PyList_Append(named, pair) != 0) {
            Py_XDECREF(pair);
            good = false;
          } else {
            Py_DECREF(pair);
          }
        }
      }
      if (PyErr_Occurred()) good = false;
    }
    Py_XDECREF(rt);
    Py_XDECREF(rg);
    Py_XDECREF(td);
    Py_XDECREF(hid);
  }

  for (auto* b : all) PyBuffer_Release(b);
  Py_DECREF(seq);
  if (!good) {
    Py_DECREF(named);
    return nullptr;
  }
  return named;
}

// build_memberships(tasks, group_versions, base) ->
//   (n_units, m_task list, m_unit list, group_keys list)
//
// Mirrors evergreen_tpu/scheduler/snapshot.py::build_memberships exactly,
// including unit creation ORDER (the planner's deterministic tie-break)
// and tolerance for depends_on=None. Task indices in m_task are offset by
// ``base`` (the caller's global flat-task position).
PyObject* BuildMemberships(PyObject*, PyObject* args) {
  PyObject* tasks;
  int group_versions;
  Py_ssize_t base = 0;
  Py_ssize_t unit_base = 0;
  Py_ssize_t di = 0;
  Py_ssize_t named_base = 0;
  PyObject* t_seg_out = nullptr;
  PyObject* deps_met = nullptr;
  PyObject* t_dm_out = nullptr;
  int want_group_keys = 1;
  if (!PyArg_ParseTuple(args, "Op|nnnnOOOp", &tasks, &group_versions, &base,
                        &unit_base, &di, &named_base, &t_seg_out, &deps_met,
                        &t_dm_out, &want_group_keys)) {
    return nullptr;
  }
  if (deps_met == Py_None) deps_met = nullptr;
  if (deps_met != nullptr && !PyDict_Check(deps_met)) {
    // a silent all-met fallback here would schedule blocked tasks;
    // non-dict mappings must go through the Python path instead
    PyErr_SetString(PyExc_TypeError, "deps_met must be a dict or None");
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(tasks, "tasks must be a sequence");
  if (seq == nullptr) return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

  static PyObject* s_id = PyUnicode_InternFromString("id");
  static PyObject* s_version = PyUnicode_InternFromString("version");
  static PyObject* s_build_variant = PyUnicode_InternFromString("build_variant");
  static PyObject* s_project = PyUnicode_InternFromString("project");
  static PyObject* s_depends_on = PyUnicode_InternFromString("depends_on");
  static PyObject* s_task_id = PyUnicode_InternFromString("task_id");
  static PyObject* s_tg_max_hosts =
      PyUnicode_InternFromString("task_group_max_hosts");
  static PyObject* s_empty = PyUnicode_InternFromString("");

  struct Scope {
    PyObject* seq;
    ~Scope() { Py_DECREF(seq); }
  } scope{seq};

  // checked str -> utf8: raises a Python TypeError/UnicodeError instead of
  // crashing on non-str attributes or non-encodable surrogates
  auto as_utf8 = [](PyObject* obj, const char* what,
                    const char** out) -> bool {
    if (obj == nullptr) return false;
    if (!PyUnicode_Check(obj)) {
      PyErr_Format(PyExc_TypeError, "task attribute %s must be str", what);
      return false;
    }
    const char* c = PyUnicode_AsUTF8(obj);
    if (c == nullptr) return false;  // encoding error already set
    *out = c;
    return true;
  };

  std::unordered_map<std::string, int32_t> key_to_unit;
  std::unordered_map<std::string, int32_t> task_unit;
  std::vector<std::vector<int32_t>> mem_by_task(n);
  std::vector<std::string> task_ids(n);
  int32_t n_units = 0;

  // allocator segments: ordinal per distinct group string (first-seen
  // order), final global seg id = named_base + ordinal for grouped tasks
  // and di (the distro's "" segment) for ungrouped ones — the same
  // assignment the snapshot's seg_for loop produced in Python
  std::unordered_map<std::string, int32_t> seg_ord;
  std::vector<PyObject*> seg_name_objs;  // owns one ref each until output
  std::vector<long> seg_max;
  std::vector<int32_t> seg_vec(n);

  // optional dependency-met column: deps_met.get(task.id, True) written
  // straight into the caller's uint8 buffer (folds the snapshot's 50k-item
  // dict-lookup comprehension into this pass)
  uint8_t* dm_buf = nullptr;
  Py_buffer dm_view{};
  if (t_dm_out != nullptr && t_dm_out != Py_None && n > 0) {
    if (PyObject_GetBuffer(t_dm_out, &dm_view,
                           PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) != 0) {
      return nullptr;
    }
    if (dm_view.itemsize != 1 || dm_view.len < n) {
      PyBuffer_Release(&dm_view);
      PyErr_SetString(PyExc_ValueError,
                      "t_dm_out must be a writable uint8 buffer of >= n");
      return nullptr;
    }
    dm_buf = static_cast<uint8_t*>(dm_view.buf);
  }
  struct DmScope {
    Py_buffer* view;
    uint8_t* buf;
    ~DmScope() {
      if (buf != nullptr) PyBuffer_Release(view);
    }
  } dm_scope{&dm_view, dm_buf};

  // group_keys is optional output: the snapshot's production path discards
  // it (segments carry the same information), so skip the n-element list
  // and its per-task increfs unless asked for
  PyObject* group_keys = want_group_keys ? PyList_New(n) : Py_None;
  if (group_keys == nullptr) return nullptr;
  if (!want_group_keys) Py_INCREF(group_keys);

  bool good = true;
  for (Py_ssize_t i = 0; good && i < n; ++i) {
    PyObject* t = PySequence_Fast_GET_ITEM(seq, i);
    PyObject* tg = PyObject_GetAttr(t, s_task_group);
    PyObject* tid = PyObject_GetAttr(t, s_id);
    if (dm_buf != nullptr && tid != nullptr) {
      if (deps_met != nullptr) {
        PyObject* got = PyDict_GetItemWithError(deps_met, tid);  // borrowed
        if (got == nullptr && PyErr_Occurred()) {
          Py_XDECREF(tg);
          Py_DECREF(tid);
          good = false;
          break;
        }
        int truth = 1;
        if (got != nullptr) {
          truth = PyObject_IsTrue(got);
          if (truth < 0) {  // __bool__ raised
            Py_XDECREF(tg);
            Py_DECREF(tid);
            good = false;
            break;
          }
        }
        dm_buf[i] = truth ? 1 : 0;
      } else {
        dm_buf[i] = 1;
      }
    }
    const char* tg_c = nullptr;
    const char* tid_c = nullptr;
    if (!as_utf8(tg, "task_group", &tg_c) || !as_utf8(tid, "id", &tid_c)) {
      Py_XDECREF(tg);
      Py_XDECREF(tid);
      good = false;
      break;
    }
    task_ids[i] = tid_c;
    auto& units_of_t = mem_by_task[i];
    const bool grouped = tg_c[0] != '\0';
    PyObject* group_key_obj = nullptr;
    if (grouped) {
      PyObject* bv = PyObject_GetAttr(t, s_build_variant);
      PyObject* proj = PyObject_GetAttr(t, s_project);
      PyObject* ver = PyObject_GetAttr(t, s_version);
      const char* bv_c = nullptr;
      const char* proj_c = nullptr;
      const char* ver_c = nullptr;
      const bool attrs_ok = as_utf8(bv, "build_variant", &bv_c) &&
                            as_utf8(proj, "project", &proj_c) &&
                            as_utf8(ver, "version", &ver_c);
      if (attrs_ok) {
        // Task.task_group_string(): group _ variant _ project _ version
        std::string key;
        key.reserve(strlen(tg_c) + strlen(bv_c) + strlen(proj_c) +
                    strlen(ver_c) + 3);
        key.append(tg_c).append("_").append(bv_c).append("_")
            .append(proj_c).append("_").append(ver_c);
        auto it = key_to_unit.find(key);
        int32_t u;
        if (it == key_to_unit.end()) {
          u = n_units++;
          key_to_unit.emplace(key, u);
        } else {
          u = it->second;
        }
        units_of_t.push_back(u);
        task_unit.emplace(task_ids[i], u);
        if (group_versions) {
          auto vit = key_to_unit.find(ver_c);
          int32_t v;
          if (vit == key_to_unit.end()) {
            v = n_units++;
            key_to_unit.emplace(ver_c, v);
          } else {
            v = vit->second;
          }
          if (v != u) units_of_t.push_back(v);
        }
        auto sit = seg_ord.find(key);
        int32_t so;
        if (sit == seg_ord.end()) {
          so = static_cast<int32_t>(seg_name_objs.size());
          seg_ord.emplace(key, so);
          PyObject* name_obj = PyUnicode_FromString(key.c_str());
          if (name_obj == nullptr) {
            good = false;
          } else {
            seg_name_objs.push_back(name_obj);
            seg_max.push_back(0);
          }
        } else {
          so = sit->second;
        }
        if (good) {
          seg_vec[i] = static_cast<int32_t>(named_base) + so;
          // first task with a nonzero group max-hosts wins (seg_for)
          if (seg_max[so] == 0) {
            PyObject* mh = PyObject_GetAttr(t, s_tg_max_hosts);
            if (mh == nullptr) {
              good = false;
            } else {
              const long v = PyLong_AsLong(mh);
              if (v == -1 && PyErr_Occurred()) good = false;
              else if (v > 0) seg_max[so] = v;
              Py_DECREF(mh);
            }
          }
        }
        if (good && want_group_keys) {
          group_key_obj = seg_name_objs[so];
          Py_INCREF(group_key_obj);
        }
      } else {
        good = false;
      }
      Py_XDECREF(bv);
      Py_XDECREF(proj);
      Py_XDECREF(ver);
    } else if (group_versions) {
      PyObject* ver = PyObject_GetAttr(t, s_version);
      const char* ver_c = nullptr;
      if (!as_utf8(ver, "version", &ver_c)) {
        Py_XDECREF(ver);
        Py_DECREF(tg);
        Py_DECREF(tid);
        good = false;
        break;
      }
      auto vit = key_to_unit.find(ver_c);
      int32_t v;
      if (vit == key_to_unit.end()) {
        v = n_units++;
        key_to_unit.emplace(ver_c, v);
      } else {
        v = vit->second;
      }
      units_of_t.push_back(v);
      task_unit.emplace(task_ids[i], v);
      Py_DECREF(ver);
    } else {
      const int32_t u = n_units++;
      units_of_t.push_back(u);
      task_unit.emplace(task_ids[i], u);
    }
    if (good && !grouped) {
      seg_vec[i] = static_cast<int32_t>(di);  // the distro's "" segment
      if (want_group_keys) {
        group_key_obj = s_empty;
        Py_INCREF(group_key_obj);
      }
    }
    if (good && want_group_keys) {
      PyList_SET_ITEM(group_keys, i, group_key_obj);  // steals
    } else {
      Py_XDECREF(group_key_obj);
    }
    Py_DECREF(tg);
    Py_DECREF(tid);
  }

  // dependency-closure pass (depends_on may be None: treated as empty,
  // matching the Python fallback's `if t.depends_on:` guard)
  for (Py_ssize_t i = 0; good && i < n; ++i) {
    PyObject* t = PySequence_Fast_GET_ITEM(seq, i);
    PyObject* deps = PyObject_GetAttr(t, s_depends_on);
    if (deps == nullptr) {
      good = false;
      break;
    }
    if (deps == Py_None) {
      Py_DECREF(deps);
      continue;
    }
    PyObject* dep_seq = PySequence_Fast(deps, "depends_on must be a sequence");
    Py_DECREF(deps);
    if (dep_seq == nullptr) {
      good = false;
      break;
    }
    const Py_ssize_t nd = PySequence_Fast_GET_SIZE(dep_seq);
    auto& lst = mem_by_task[i];
    for (Py_ssize_t j = 0; good && j < nd; ++j) {
      PyObject* dep = PySequence_Fast_GET_ITEM(dep_seq, j);
      PyObject* dep_id = PyObject_GetAttr(dep, s_task_id);
      const char* dep_c = nullptr;
      if (!as_utf8(dep_id, "task_id", &dep_c)) {
        Py_XDECREF(dep_id);
        good = false;
        break;
      }
      auto it = task_unit.find(dep_c);
      Py_DECREF(dep_id);
      if (it != task_unit.end()) {
        const int32_t u = it->second;
        bool present = false;
        for (int32_t x : lst) {
          if (x == u) {
            present = true;
            break;
          }
        }
        if (!present) lst.push_back(u);
      }
    }
    Py_DECREF(dep_seq);
  }

  if (!good) {
    Py_DECREF(group_keys);
    for (PyObject* o : seg_name_objs) Py_DECREF(o);
    if (!PyErr_Occurred()) {
      PyErr_SetString(PyExc_TypeError, "malformed task objects");
    }
    return nullptr;
  }

  // final per-task segment ids straight into the caller's int32 buffer
  if (t_seg_out != nullptr && t_seg_out != Py_None && n > 0) {
    Py_buffer buf{};
    if (PyObject_GetBuffer(t_seg_out, &buf,
                           PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) != 0) {
      Py_DECREF(group_keys);
      for (PyObject* o : seg_name_objs) Py_DECREF(o);
      return nullptr;
    }
    if (buf.itemsize != 4 ||
        buf.len < n * static_cast<Py_ssize_t>(sizeof(int32_t))) {
      PyBuffer_Release(&buf);
      Py_DECREF(group_keys);
      for (PyObject* o : seg_name_objs) Py_DECREF(o);
      PyErr_SetString(PyExc_ValueError,
                      "t_seg_out must be a writable int32 buffer of >= n");
      return nullptr;
    }
    memcpy(buf.buf, seg_vec.data(), n * sizeof(int32_t));
    PyBuffer_Release(&buf);
  }

  // memberships as raw int32 little-endian bytes: np.frombuffer on the
  // Python side — no 2×M PyLong allocations crossing the boundary
  size_t total = 0;
  for (auto& lst : mem_by_task) total += lst.size();
  std::vector<int32_t> mt_vec(total);
  std::vector<int32_t> mu_vec(total);
  size_t k = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    for (int32_t u : mem_by_task[i]) {
      mt_vec[k] = static_cast<int32_t>(base + i);
      mu_vec[k] = static_cast<int32_t>(unit_base) + u;
      ++k;
    }
  }
  PyObject* m_task = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(mt_vec.data()),
      static_cast<Py_ssize_t>(total * sizeof(int32_t)));
  PyObject* m_unit = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(mu_vec.data()),
      static_cast<Py_ssize_t>(total * sizeof(int32_t)));
  if (m_task == nullptr || m_unit == nullptr) {
    Py_XDECREF(m_task);
    Py_XDECREF(m_unit);
    Py_DECREF(group_keys);
    for (PyObject* o : seg_name_objs) Py_DECREF(o);
    return nullptr;
  }
  const Py_ssize_t n_segs = static_cast<Py_ssize_t>(seg_name_objs.size());
  PyObject* seg_names = PyList_New(n_segs);
  PyObject* seg_max_out = PyList_New(n_segs);
  if (seg_names == nullptr || seg_max_out == nullptr) {
    Py_XDECREF(seg_names);
    Py_XDECREF(seg_max_out);
    Py_DECREF(m_task);
    Py_DECREF(m_unit);
    Py_DECREF(group_keys);
    for (PyObject* o : seg_name_objs) Py_DECREF(o);
    return nullptr;
  }
  for (Py_ssize_t s = 0; s < n_segs; ++s) {
    PyList_SET_ITEM(seg_names, s, seg_name_objs[s]);  // steals creation ref
  }
  for (Py_ssize_t s = 0; s < n_segs; ++s) {
    PyObject* mh = PyLong_FromLong(seg_max[s]);
    if (mh == nullptr) {
      Py_DECREF(seg_names);  // owns every name ref now
      Py_DECREF(seg_max_out);
      Py_DECREF(m_task);
      Py_DECREF(m_unit);
      Py_DECREF(group_keys);
      return nullptr;
    }
    PyList_SET_ITEM(seg_max_out, s, mh);
  }
  return Py_BuildValue("iNNNNN", n_units, m_task, m_unit, group_keys,
                       seg_names, seg_max_out);
}

// fill_deps_met(tasks, deps_met, out) -> None
//
// out[i] = bool(deps_met.get(tasks[i].id, True)) into a writable uint8
// buffer.  Used by the snapshot's membership-memo hit path, where the
// cached unit grouping is reused but the deps-met column (the only
// dynamic input) must be refreshed each tick.
PyObject* FillDepsMet(PyObject*, PyObject* args) {
  PyObject* tasks;
  PyObject* deps_met;
  PyObject* out;
  if (!PyArg_ParseTuple(args, "OOO", &tasks, &deps_met, &out)) {
    return nullptr;
  }
  if (deps_met == Py_None) deps_met = nullptr;
  if (deps_met != nullptr && !PyDict_Check(deps_met)) {
    PyErr_SetString(PyExc_TypeError, "deps_met must be a dict or None");
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(tasks, "tasks must be a sequence");
  if (seq == nullptr) return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  static PyObject* s_id_attr = PyUnicode_InternFromString("id");
  Py_buffer view{};
  if (PyObject_GetBuffer(out, &view, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS)
      != 0) {
    Py_DECREF(seq);
    return nullptr;
  }
  if (view.itemsize != 1 || view.len < n) {
    PyBuffer_Release(&view);
    Py_DECREF(seq);
    PyErr_SetString(PyExc_ValueError,
                    "out must be a writable uint8 buffer of >= n");
    return nullptr;
  }
  auto* buf = static_cast<uint8_t*>(view.buf);
  bool good = true;
  for (Py_ssize_t i = 0; good && i < n; ++i) {
    PyObject* t = PySequence_Fast_GET_ITEM(seq, i);
    if (deps_met == nullptr) {
      buf[i] = 1;
      continue;
    }
    PyObject* tid = PyObject_GetAttr(t, s_id_attr);
    if (tid == nullptr) {
      good = false;
      break;
    }
    PyObject* got = PyDict_GetItemWithError(deps_met, tid);  // borrowed
    Py_DECREF(tid);
    if (got == nullptr) {
      if (PyErr_Occurred()) {
        good = false;
        break;
      }
      buf[i] = 1;
    } else {
      int truth = PyObject_IsTrue(got);
      if (truth < 0) {
        good = false;
        break;
      }
      buf[i] = truth ? 1 : 0;
    }
  }
  PyBuffer_Release(&view);
  Py_DECREF(seq);
  if (!good) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"pack_task_static_columns", PackTaskStaticColumns, METH_VARARGS,
     "Time-independent task columns + f64 time bases (cacheable)."},
    {"pack_host_columns", PackHostColumns, METH_VARARGS,
     "Host fleet columns in one pass; returns named-group (i, key) pairs."},
    {"build_memberships", BuildMemberships, METH_VARARGS,
     "Planner unit grouping: (n_units, m_task, m_unit, group_keys)."},
    {"fill_deps_met", FillDepsMet, METH_VARARGS,
     "out[i] = deps_met.get(tasks[i].id, True) as uint8."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "evgpack",
    "Native snapshot packer for evergreen_tpu.", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit_evgpack(void) {
  s_priority = PyUnicode_InternFromString("priority");
  s_requester = PyUnicode_InternFromString("requester");
  s_activated_by = PyUnicode_InternFromString("activated_by");
  s_generate_task = PyUnicode_InternFromString("generate_task");
  s_task_group = PyUnicode_InternFromString("task_group");
  s_task_group_order = PyUnicode_InternFromString("task_group_order");
  s_activated_time = PyUnicode_InternFromString("activated_time");
  s_ingest_time = PyUnicode_InternFromString("ingest_time");
  s_scheduled_time = PyUnicode_InternFromString("scheduled_time");
  s_dependencies_met_time = PyUnicode_InternFromString("dependencies_met_time");
  s_expected_duration_s = PyUnicode_InternFromString("expected_duration_s");
  s_num_dependents = PyUnicode_InternFromString("num_dependents");
  return PyModule_Create(&kModule);
}
