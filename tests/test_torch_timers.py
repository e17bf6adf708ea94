"""The port's ``utils/timers.py`` and ``obs/report.py`` (copies of the
JAX package's, the run capture ``run_streaming`` attaches under
``results.observability``): the twins of tests/test_obs.py's timer
cases, the phase windows' attribution, the report's keys against the
JAX package's, and ``device_trace`` on ``torch.profiler``.
"""

import json
import sys
import threading

import pytest

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu import obs as jax_obs  # noqa: E402

from mdanalysis_mpi_tpu_torch import obs  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import spans  # noqa: E402
from mdanalysis_mpi_tpu_torch.utils import timers  # noqa: E402
from mdanalysis_mpi_tpu_torch.utils.timers import (  # noqa: E402
    TIMERS, PhaseTimers, device_trace)


def test_phase_timers_exact_counts_under_thread_hammering():
    """N threads × M phase() entries on ONE PhaseTimers, with a short
    switch interval: the counts must be exact."""
    t = PhaseTimers()
    n_threads, m = 16, 400
    start = threading.Barrier(n_threads)

    def hammer():
        start.wait()
        for _ in range(m):
            with t.phase("hot"):
                pass
            t.add("added", 0.001)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer)
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert t.calls("hot") == n_threads * m
    assert t.calls("added") == n_threads * m
    assert t.seconds("added") == pytest.approx(n_threads * m * 0.001)
    assert t.report()["hot"]["calls"] == n_threads * m


def test_phase_hooks_fire_on_entry_and_swallow_errors():
    seen = []

    def hook(name):
        seen.append(name)
        raise RuntimeError("instrumentation must never fail a run")

    timers.add_phase_hook(hook)
    try:
        with PhaseTimers().phase("stage"):
            pass
    finally:
        timers.remove_phase_hook(hook)
    assert seen == ["stage"]


def test_report_keys_equal_the_jax_package_and_count_this_run():
    """The RunReport's keys are the JAX package's (its profiler summary
    rides only when its sampler is on, and the port has none); the
    phases are this run's deltas of the process-global timers."""
    with TIMERS.phase("before"):
        pass
    cap = obs.start_run_capture()
    with TIMERS.phase("execute"):
        pass
    TIMERS.add("dispatch", 0.0)
    rep = obs.finish_run_capture(cap, analysis="RMSF", backend="torch",
                                 n_frames=8)
    jcap = jax_obs.start_run_capture()
    jrep = jax_obs.finish_run_capture(jcap, analysis="RMSF",
                                      backend="jax", n_frames=8)
    assert set(rep) == set(jrep)
    assert set(rep["phases"]) == {"execute", "dispatch"}
    assert rep["phase_attribution"] == "process"
    assert rep["dispatch_count"] == 1 and rep["scan_k"] == 1
    assert rep["n_frames"] == 8 and rep["wall_s"] >= 0
    json.dumps(rep)


def test_phase_window_attributes_only_its_trace_ids():
    """Under a trace context the report reads the run's own window: a
    phase recorded under another job's ids does not bleed in."""
    with spans.context(trace_id="mine"):
        cap = obs.start_run_capture()
        with TIMERS.phase("stage"):
            pass
    with spans.context(trace_id="other"):
        with TIMERS.phase("foreign"):
            pass
    rep = obs.finish_run_capture(cap, analysis="A", backend="torch",
                                 n_frames=1)
    assert rep["phase_attribution"] == "job"
    assert set(rep["phases"]) == {"stage"}
    assert not timers._WINDOWS


def test_abandoned_capture_closes_its_window():
    with spans.context(trace_id="failing"):
        cap = obs.start_run_capture()
    assert timers._WINDOWS
    obs.abandon_run_capture(cap)
    assert not timers._WINDOWS


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with device_trace(None):
        pass                       # no directory: a no-op
    out = tmp_path / "trace"
    with device_trace(str(out)):
        torch.ones(64).sum()
    with open(out / "trace.json") as f:
        doc = json.load(f)
    assert doc["traceEvents"]
