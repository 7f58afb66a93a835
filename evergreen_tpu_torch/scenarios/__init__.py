"""Trace-driven scenario engine: one harness that replays every weather.

A copy of ``evergreen_tpu/scenarios/``. Every replay runs the port's
tick, its solves on the CUDA card unless the caller passes
``device="cpu"``. Public surface:

  ``ScenarioSpec`` / ``Ev`` / ``SLO``  — the declarative vocabulary
  ``run_scenario(spec)``               — one seeded replay → scorecard entry
  ``SCENARIOS``                        — the shipped weather library
  ``SABOTAGE_SCENARIOS``               — deliberately-red self-test specs
  ``FAULT_SCENARIO_CASES`` / ``OVERLOAD_SCENARIO_CASES`` /
  ``run_matrix_case``                  — the fault/overload matrix cases
                                         migrated to run THROUGH the engine
  ``PROC_SCENARIOS`` / ``run_proc_scenario`` / ``run_crash_point``
                                       — the child-process replay backend
                                         (scenarios/procs.py): specs with
                                         proc_kill/proc_hang events against
                                         a supervised worker-process fleet
  ``generate_weather`` / ``campaign`` / ``shrink_spec`` /
  ``sabotage_selftest``                — the property-based weather fuzzer
                                         (scenarios/fuzz.py): seeded random
                                         timelines over this vocabulary,
                                         delta-debugging shrinker, soak
                                         campaign + found-bug self-test
  ``TraceRecorder`` / ``trace_to_spec`` / ``save_regression_spec`` /
  ``load_regression_specs``            — trace capture (scenarios/trace.py):
                                         a live plane's WAL journal, log
                                         stream, and supervisor IPC recorded
                                         and distilled back into a replayable
                                         ``ScenarioSpec``; fuzz-found minimal
                                         timelines are checked in under
                                         ``scenarios/regressions/``

``python -m evergreen_tpu_torch replay-trace`` compiles a recorded trace
and replays it; ``service --capture-trace`` records one.
"""
from .engine import EVENT_HANDLERS, ScenarioRun, run_scenario
from .fuzz import (
    campaign,
    generate_proc_weather,
    generate_weather,
    sabotage_selftest,
    shrink_spec,
)
from .library import SABOTAGE_SCENARIOS, SCENARIOS
from .matrix import (
    FAULT_SCENARIO_CASES,
    OVERLOAD_SCENARIO_CASES,
    run_matrix_case,
)
from .procs import (
    PROC_SCENARIOS,
    ProcScenarioRun,
    run_crash_point,
    run_proc_scenario,
)
from .spec import DEFAULT_INVARIANTS, Ev, SLO, ScenarioSpec
from .trace import (
    TraceRecorder,
    capture_data_dir,
    load_regression_specs,
    save_regression_spec,
    spec_from_jsonable,
    spec_to_jsonable,
    trace_to_spec,
)

__all__ = [
    "DEFAULT_INVARIANTS",
    "Ev",
    "EVENT_HANDLERS",
    "FAULT_SCENARIO_CASES",
    "OVERLOAD_SCENARIO_CASES",
    "PROC_SCENARIOS",
    "ProcScenarioRun",
    "SABOTAGE_SCENARIOS",
    "SCENARIOS",
    "SLO",
    "ScenarioRun",
    "ScenarioSpec",
    "TraceRecorder",
    "campaign",
    "capture_data_dir",
    "generate_proc_weather",
    "generate_weather",
    "load_regression_specs",
    "run_crash_point",
    "run_matrix_case",
    "run_proc_scenario",
    "run_scenario",
    "sabotage_selftest",
    "save_regression_spec",
    "shrink_spec",
    "spec_from_jsonable",
    "spec_to_jsonable",
    "trace_to_spec",
]
