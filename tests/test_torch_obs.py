"""The port's twin of ``tests/test_obs.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Unified observability layer (obs/ subsystem).

What is pinned here:

- **Thread-safe phase timers** (satellite): the process-global
  ``TIMERS`` is hammered from N threads and the call counts must be
  EXACT — the pre-lock dict read-modify-write lost updates.
- **Trace export schema**: the emitted file is valid Chrome
  trace-event JSON (``ph``/``ts``/``dur``/``tid``/``pid`` fields on
  complete events) that Perfetto loads.
- **Disabled-mode cost**: spans are ONE shared no-op object and
  allocate no events — the near-free-when-disabled contract.
- **The overlap acceptance**: a flagship-shaped AlignedRMSF run with
  tracing on yields staging spans on the prefetch thread whose time
  ranges overlap dispatch spans on the main thread — the double
  buffering the phase timers could only hint at.
- **Coalesced attribution**: a 3-job coalesced pass yields spans
  carrying all three job ids (trace-id propagation through the
  scheduler's execution unit).
- **log_event** (satellite): ts/pid/thread fields, and
  ``MDTPU_LOG_JSON=<path>`` appends the stream to a file.
"""

import datetime
import json
import threading
import time

import numpy as np
import pytest

# deliberately NO module-level torch/analysis imports: the obs layer
# itself (spans, metrics, timers, logging) is torch-free, and the
# PhaseTimers/metrics/log regressions below must run on no-torch
# installs too — only the tests that actually build analyses or drive
# backends skip via the _stack fixture
from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.obs import spans as ospans
from mdanalysis_mpi_tpu_torch.obs.metrics import (
    MetricsRegistry, to_prometheus, unified_snapshot,
)
from mdanalysis_mpi_tpu_torch.utils.log import log_event
from mdanalysis_mpi_tpu_torch.utils.timers import PhaseTimers

#: the device route on the CPU (the port runs on the card by default)
CPU = {"device": "cpu"}

pytestmark = pytest.mark.obs


@pytest.fixture
def stack():
    """The analysis/serving imports (they pull in torch): skip the
    backend-driving tests, not the whole module, when torch is absent."""
    import types

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, RMSF
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
    from mdanalysis_mpi_tpu_torch.service import Scheduler
    from mdanalysis_mpi_tpu_torch.testing import (
        make_protein_topology, make_protein_universe,
    )

    return types.SimpleNamespace(
        AlignedRMSF=AlignedRMSF, RMSF=RMSF, Universe=Universe,
        MemoryReader=MemoryReader, Scheduler=Scheduler,
        make_protein_topology=make_protein_topology,
        make_protein_universe=make_protein_universe)


@pytest.fixture(autouse=True)
def _clean_tracer():
    """Every test starts and ends with tracing off and empty."""
    ospans.disable(discard=True)
    ospans.reset()
    yield
    ospans.disable(discard=True)
    ospans.reset()


def _u(stack, n_frames=24, seed=3):
    return stack.make_protein_universe(n_residues=20, n_frames=n_frames,
                                       noise=0.3, seed=seed)


def _export(tmp_path, name="trace.json"):
    path = str(tmp_path / name)
    ospans.export(path)
    with open(path) as f:
        return json.load(f)


def _complete_events(doc):
    return [e for e in doc["traceEvents"] if e["ph"] == "X"]


# ---- satellite: PhaseTimers thread safety ----


def test_phase_timers_exact_counts_under_thread_hammering():
    """N threads × M phase() entries on ONE PhaseTimers: the counts
    must be exact (the unguarded dict read-modify-write lost updates
    under the scheduler's worker pool)."""
    t = PhaseTimers()
    n_threads, m = 8, 400
    start = threading.Barrier(n_threads)

    def hammer():
        start.wait()
        for _ in range(m):
            with t.phase("hot"):
                pass
            t.add("added", 0.001)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.calls("hot") == n_threads * m
    assert t.calls("added") == n_threads * m
    assert t.seconds("added") == pytest.approx(n_threads * m * 0.001)
    assert t.report()["hot"]["calls"] == n_threads * m


# ---- disabled mode: near-free, allocation-free ----


def test_disabled_spans_are_one_shared_noop_and_record_nothing():
    assert not obs.tracing_enabled()
    s1 = obs.span("a", big="args")
    s2 = obs.span("b")
    assert s1 is s2 is ospans.NOOP
    with s1:
        with obs.span("nested"):
            pass
    obs.span_event("incident", x=1)
    with obs.trace_context(job_ids=[1]):
        pass
    assert ospans.n_events() == 0


def test_spans_drop_cleanly_when_disabled_mid_flight():
    obs.enable_tracing()
    sp = obs.span("open")
    sp.__enter__()
    obs.disable_tracing()
    sp.__exit__(None, None, None)      # must not raise or record
    assert ospans.n_events() == 0


# ---- trace export schema (satellite) ----


def test_trace_export_is_valid_chrome_trace_json(tmp_path, stack):
    obs.enable_tracing()
    u = _u(stack)
    stack.RMSF(u.select_atoms("name CA")).run(backend="torch", device="cpu",
                                              batch_size=8)
    obs.disable_tracing()
    doc = _export(tmp_path)

    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "M", "i")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert isinstance(ev["name"], str)
            assert ev["ts"] >= 0 and ev["dur"] >= 0
        if ev["ph"] == "i":
            assert ev["s"] == "t" and ev["ts"] >= 0
    # thread rows are named for the Perfetto UI
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert meta and all(e["name"] == "thread_name" for e in meta)
    names = {e["name"] for e in _complete_events(doc)}
    # the span model's run-level and block-level members all showed up
    # (the port's staging leaves in place of the JAX package's `read`)
    assert {"run", "prepare", "execute", "conclude", "stage",
            "stage_wait", "gather", "wire", "dispatch"} <= names
    assert "read" not in names
    run = next(e for e in _complete_events(doc) if e["name"] == "run")
    assert run["args"]["analysis"] == "RMSF"
    assert run["args"]["backend"] == "torch"
    # dispatch spans are tagged with the active scan_k
    disp = [e for e in _complete_events(doc) if e["name"] == "dispatch"]
    assert all("scan_k" in e["args"] for e in disp)


def test_trace_events_nest_within_the_run_span(tmp_path, stack):
    """Hierarchy is time containment per tid (the Chrome X-event
    convention): every same-thread phase span lies inside its run."""
    obs.enable_tracing()
    u = _u(stack)
    stack.RMSF(u.select_atoms("name CA")).run(backend="serial")
    obs.disable_tracing()
    doc = _export(tmp_path)
    evs = _complete_events(doc)
    run = next(e for e in evs if e["name"] == "run")
    for name in ("prepare", "execute", "conclude"):
        ev = next(e for e in evs if e["name"] == name)
        assert ev["tid"] == run["tid"]
        assert ev["ts"] >= run["ts"] - 1e-6
        assert ev["ts"] + ev["dur"] <= run["ts"] + run["dur"] + 1e-6


# ---- the overlap acceptance criterion ----


def test_staging_spans_overlap_dispatch_spans_across_threads(
        tmp_path, monkeypatch, stack):
    """The flagship two-pass run with tracing on: staging spans on the
    prefetch thread's tid must overlap dispatch spans on the main
    thread's tid in wall time — the double-buffering overlap the phase
    timers' caveat could only describe (ISSUE acceptance)."""

    class _SlowReader(stack.MemoryReader):
        """Per-block read delay, so staging spans have visible width
        on the prefetch row."""

        def read_block(self, *a, **k):
            time.sleep(0.004)
            return super().read_block(*a, **k)

        def stage_block(self, *a, **k):
            time.sleep(0.004)
            return super().stage_block(*a, **k)

    monkeypatch.setenv("MDTPU_PREFETCH", "1")   # force the real thread
    trace = str(tmp_path / "flagship.json")
    # the acceptance-criterion spelling: the env knob alone enables
    # tracing at run entry AND exports the file after the run
    monkeypatch.setenv("MDTPU_TRACE_OUT", trace)
    rng = np.random.default_rng(7)
    top = stack.make_protein_topology(24)
    frames = rng.normal(scale=10.0,
                        size=(48, top.n_atoms, 3)).astype(np.float32)
    u = stack.Universe(top, _SlowReader(frames))

    stack.AlignedRMSF(u, select="name CA").run(backend="torch", device="cpu",
                                               batch_size=8)
    obs.disable_tracing()
    with open(trace) as f:
        doc = json.load(f)
    evs = _complete_events(doc)
    # the port's trace rows are the kernel's thread ids (native_id)
    main_tid = threading.main_thread().native_id
    stages = [e for e in evs
              if e["name"] == "stage" and e["tid"] != main_tid]
    dispatches = [e for e in evs
                  if e["name"] == "dispatch" and e["tid"] == main_tid]
    assert stages, "no staging spans recorded on a prefetch thread"
    assert dispatches, "no dispatch spans recorded on the main thread"
    overlaps = [
        (s, d) for s in stages for d in dispatches
        if s["ts"] < d["ts"] + d["dur"] and d["ts"] < s["ts"] + s["dur"]]
    assert overlaps, (
        "no prefetch-thread stage span overlapped a main-thread "
        "dispatch span — double buffering invisible in the trace")


# ---- coalesced-pass attribution (satellite + acceptance) ----


def test_coalesced_three_job_pass_spans_carry_all_job_ids(tmp_path,
                                                          stack):
    u = _u(stack)
    obs.enable_tracing()
    sched = stack.Scheduler(n_workers=1, autostart=False)
    handles = [
        sched.submit(stack.RMSF(u.select_atoms("name CA")),
                     backend="serial", tenant="alice"),
        sched.submit(stack.RMSF(u.select_atoms("name CB")),
                     backend="serial", tenant="bob"),
        sched.submit(stack.RMSF(u.select_atoms("protein")),
                     backend="serial", tenant="carol"),
    ]
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    obs.disable_tracing()
    assert all(h.error is None and h.coalesced for h in handles)
    job_ids = [h.job_id for h in handles]
    trace_ids = [h.job.trace_id for h in handles]
    assert trace_ids == [f"job-{j}" for j in job_ids]

    doc = _export(tmp_path)
    evs = _complete_events(doc)
    serve = next(e for e in evs if e["name"] == "serve_job")
    assert serve["args"]["job_ids"] == job_ids
    assert serve["args"]["tenants"] == ["alice", "bob", "carol"]
    assert serve["args"]["trace_ids"] == trace_ids
    assert serve["args"]["coalesced"] is True
    merged = next(e for e in evs if e["name"] == "coalesced_pass")
    assert merged["args"]["job_ids"] == job_ids
    assert merged["args"]["n_jobs"] == 3
    # the thread context stamps the member ids onto the pass's INNER
    # spans too — the run (and its stage/dispatch children) attribute
    # to every member job, not just the claiming one
    run = next(e for e in evs if e["name"] == "run")
    assert run["args"]["job_ids"] == job_ids
    assert run["args"]["trace_ids"] == trace_ids


def test_prefetch_thread_stage_spans_carry_job_attribution(
        tmp_path, monkeypatch, stack):
    """The trace context is thread-local, and staging runs on the
    prefetch thread — the context must be handed off at pool-submit
    time or a multi-tenant pass's staging cost loses its job ids."""
    monkeypatch.setenv("MDTPU_PREFETCH", "1")
    # env-only flow: the SCHEDULER must honor MDTPU_TRACE_OUT before
    # entering its trace context (or this unit's spans would lose
    # attribution) and keep the file current after the unit (the
    # serve_job span closes after the inner run()'s own export)
    trace = str(tmp_path / "served.json")
    monkeypatch.setenv("MDTPU_TRACE_OUT", trace)
    u = _u(stack, n_frames=32)
    with stack.Scheduler(n_workers=1) as sched:
        h = sched.submit(stack.RMSF(u.select_atoms("name CA")),
                         backend="torch", executor_kwargs=CPU, batch_size=8, tenant="t1")
        h.result(timeout=120)
        sched.drain()
    obs.disable_tracing()
    with open(trace) as f:
        doc = json.load(f)
    # the port's trace rows are the kernel's thread ids (native_id)
    main_tid = threading.main_thread().native_id
    stages = [e for e in _complete_events(doc)
              if e["name"] == "stage" and e["tid"] != main_tid]
    assert stages, "no staging spans on a prefetch thread"
    assert all(e["args"]["job_ids"] == [h.job_id] for e in stages)
    assert all(e["args"]["tenants"] == ["t1"] for e in stages)
    # the exported file already carries the serving span itself
    serve = [e for e in _complete_events(doc)
             if e["name"] == "serve_job"]
    assert serve and serve[0]["args"]["tenants"] == ["t1"]


def test_solo_job_spans_carry_their_single_job_id(tmp_path, stack):
    u = _u(stack)
    obs.enable_tracing()
    with stack.Scheduler(n_workers=1) as sched:
        h = sched.submit(stack.RMSF(u.select_atoms("name CA")),
                         backend="serial", coalesce=False, tenant="t9")
        h.result(timeout=120)
    obs.disable_tracing()
    doc = _export(tmp_path)
    serve = [e for e in _complete_events(doc) if e["name"] == "serve_job"]
    assert serve and serve[0]["args"]["job_ids"] == [h.job_id]
    assert serve[0]["args"]["coalesced"] is False


# ---- MDTPU_TRACE_OUT env knob + per-run export ----


def test_trace_out_env_enables_and_exports_per_run(tmp_path,
                                                   monkeypatch, stack):
    path = str(tmp_path / "env_trace.json")
    monkeypatch.setenv("MDTPU_TRACE_OUT", path)
    u = _u(stack)
    stack.RMSF(u.select_atoms("name CA")).run(backend="serial")
    # run() auto-exported: the file is valid and already loadable
    with open(path) as f:
        doc = json.load(f)
    assert any(e["name"] == "run" for e in _complete_events(doc))
    assert obs.trace_path() == path


# ---- run reports ----


def test_run_report_attached_under_results_observability(stack):
    u = _u(stack)
    r = stack.RMSF(u.select_atoms("name CA")).run(backend="serial")
    rep = r.results["observability"]
    assert rep["analysis"] == "RMSF" and rep["backend"] == "serial"
    assert rep["n_frames"] == 24 and rep["wall_s"] > 0
    assert rep["phases"]["execute"]["calls"] == 1
    assert rep["dispatch_count"] == 0       # serial path never dispatches
    assert rep["tracing"] is False and rep["trace_out"] is None
    json.dumps(rep)                          # JSON-friendly by contract

    r2 = stack.RMSF(u.select_atoms("name CA")).run(backend="torch", device="cpu",
                                                   batch_size=8)
    rep2 = r2.results["observability"]
    assert rep2["backend"] == "torch"
    assert rep2["dispatch_count"] >= 1
    assert rep2["phases"]["stage"]["calls"] >= 1
    assert rep2["scan_k"] >= 1

    # the multi-pass flagship surfaces ONE report spanning both passes
    ar = stack.AlignedRMSF(u, select="name CA").run(backend="torch", device="cpu",
                                                    batch_size=8)
    arep = ar.results["observability"]
    assert arep["analysis"] == "AlignedRMSF"
    assert arep["dispatch_count"] >= 2       # at least one per pass
    json.dumps(arep)


# ---- reliability incidents as trace instants ----


def test_retry_and_fault_events_land_on_the_timeline(tmp_path):
    from mdanalysis_mpi_tpu_torch.reliability.faults import (
        InjectedTransientError,
    )
    from mdanalysis_mpi_tpu_torch.reliability.policy import (
        ReliabilityPolicy, ReliabilityRuntime,
    )

    obs.enable_tracing()
    rt = ReliabilityRuntime(ReliabilityPolicy(max_retries=2,
                                              backoff_s=0.0))
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise InjectedTransientError("flaky once")
        return "ok"

    assert rt.op("stage", flaky) == "ok"
    obs.disable_tracing()
    doc = _export(tmp_path)
    retries = [e for e in doc["traceEvents"]
               if e["ph"] == "i" and e["name"] == "retry"]
    assert retries and retries[0]["args"]["site"] == "stage"
    assert rt.report.retries == {"stage": 1}


# ---- metrics registry ----


def test_metrics_registry_counters_gauges_histograms():
    m = MetricsRegistry()
    m.inc("mdtpu_runs_total", backend="torch")
    m.inc("mdtpu_runs_total", backend="torch")
    m.inc("mdtpu_runs_total", backend="serial")
    m.set_gauge("mdtpu_queue_depth", 4)
    for v in (0.003, 0.2, 50.0):
        m.observe("mdtpu_queue_wait_seconds", v)
    snap = m.snapshot()
    assert snap["mdtpu_runs_total"]["type"] == "counter"
    assert snap["mdtpu_runs_total"]["values"]['backend="torch"'] == 2
    assert snap["mdtpu_queue_depth"]["values"][""] == 4
    h = snap["mdtpu_queue_wait_seconds"]["values"][""]
    assert h["count"] == 3 and h["sum"] == pytest.approx(50.203)
    # cumulative le counts, +Inf sees everything
    assert h["buckets"]["0.001"] == 0
    assert h["buckets"]["0.005"] == 1
    assert h["buckets"]["0.5"] == 2
    assert h["buckets"]["+Inf"] == 3
    # a name cannot change type midstream
    with pytest.raises(ValueError):
        m.inc("mdtpu_queue_depth")
    json.dumps(snap)


def test_metrics_prometheus_exposition():
    m = MetricsRegistry()
    m.inc("mdtpu_runs_total", backend="serial")
    m.observe("mdtpu_job_latency_seconds", 0.05)
    text = to_prometheus(m.snapshot())
    assert "# TYPE mdtpu_runs_total counter" in text
    assert 'mdtpu_runs_total{backend="serial"} 1' in text
    assert "# TYPE mdtpu_job_latency_seconds histogram" in text
    assert 'mdtpu_job_latency_seconds_bucket{le="+Inf"} 1' in text
    assert "mdtpu_job_latency_seconds_count 1" in text


def test_unified_snapshot_pulls_private_trackers_together():
    """The unification claim: one document over timers + cache +
    serving telemetry + the live registry."""
    from mdanalysis_mpi_tpu_torch.io.base import BlockCache
    from mdanalysis_mpi_tpu_torch.service import ServiceTelemetry

    timers = PhaseTimers()
    with timers.phase("stage"):
        pass
    cache = BlockCache(max_bytes=100)
    cache.put("k", "v", 10)
    cache.get("k")
    cache.get("missing")
    tel = ServiceTelemetry()
    tel.note_submit()
    reg = MetricsRegistry()
    reg.inc("mdtpu_retries_total", site="stage")

    snap = unified_snapshot(timers=timers, cache=cache, telemetry=tel,
                            registry=reg)
    assert snap["mdtpu_phase_seconds_total"]["values"][
        'phase="stage"'] >= 0
    assert snap["mdtpu_phase_calls_total"]["values"]['phase="stage"'] == 1
    assert snap["mdtpu_cache_hits_total"]["values"][""] == 1
    assert snap["mdtpu_cache_misses_total"]["values"][""] == 1
    assert snap["mdtpu_cache_bytes"]["values"][""] == 10
    assert snap["mdtpu_jobs_submitted_total"]["values"][""] == 1
    assert snap["mdtpu_queue_depth"]["values"][""] == 1
    assert snap["mdtpu_retries_total"]["values"]['site="stage"'] == 1
    json.dumps(snap)
    to_prometheus(snap)          # renders without error


def test_scheduler_feeds_latency_histograms(stack):
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    before = METRICS.snapshot().get("mdtpu_job_latency_seconds")
    n0 = before["values"][""]["count"] if before else 0
    u = _u(stack)
    with stack.Scheduler(n_workers=1) as sched:
        sched.submit(stack.RMSF(u.select_atoms("name CA")),
                     backend="serial").result(timeout=120)
    after = METRICS.snapshot()["mdtpu_job_latency_seconds"]
    assert after["values"][""]["count"] == n0 + 1


# ---- satellite: log_event identity fields + file sink ----


def test_log_event_json_carries_ts_pid_thread(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setenv("MDTPU_LOG_JSON", "1")
    log_event("probe", answer=42)
    err = capsys.readouterr().err
    rec = json.loads(err.strip().splitlines()[-1])
    assert rec["event"] == "probe" and rec["answer"] == 42
    import os
    assert rec["pid"] == os.getpid()
    assert rec["thread"] == threading.current_thread().name
    # ISO-8601 wall clock, parseable and recent
    ts = datetime.datetime.fromisoformat(rec["ts"])
    assert abs((datetime.datetime.now(datetime.timezone.utc)
                - ts).total_seconds()) < 60


def test_log_event_json_zero_means_off_not_a_file(tmp_path,
                                                  monkeypatch):
    """MDTPU_LOG_JSON=0 follows the repo-wide knob convention (off) —
    it must NOT be taken as a file path named '0'."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MDTPU_LOG_JSON", "0")
    log_event("probe", n=1)
    assert not (tmp_path / "0").exists()


def test_log_event_json_appends_to_file(tmp_path, monkeypatch):
    path = str(tmp_path / "events.jsonl")
    monkeypatch.setenv("MDTPU_LOG_JSON", path)
    log_event("first", n=1)
    log_event("second", n=2)
    with open(path) as f:
        lines = [json.loads(ln) for ln in f.read().splitlines()]
    assert [ln["event"] for ln in lines] == ["first", "second"]
    assert all("ts" in ln and "pid" in ln and "thread" in ln
               for ln in lines)
    # append mode: a third event extends, never truncates
    log_event("third")
    with open(path) as f:
        assert len(f.read().splitlines()) == 3


# ---- fleet federation: merge rules + tail interleave + per-job
#      phase attribution (ISSUE 13) ----


def test_unified_snapshot_fleet_merge_rules():
    """unified_snapshot(fleet=): counters/histograms are SUMMED
    across hosts (fleet job counters == the sum of the per-host
    registries), gauges are host-labeled, controller-local series
    stay distinct, and the merged document still renders as
    Prometheus text."""
    from mdanalysis_mpi_tpu_torch.obs.metrics import (
        MetricsRegistry, to_prometheus,
    )

    reg = MetricsRegistry()   # the "controller": its own counter only
    reg.inc("mdtpu_hosts_lost_total", reason="socket_eof")

    def host_snap(completed, depth, lat):
        r = MetricsRegistry()
        r.inc("mdtpu_jobs_completed_total", completed)
        r.set_gauge("mdtpu_queue_depth", depth)
        r.observe("mdtpu_job_latency_seconds", lat)
        r.inc("mdtpu_phase_seconds_total", 0.5, phase="stage")
        return r.snapshot()

    snap = unified_snapshot(registry=reg,
                            fleet={"h0": host_snap(3, 2, 0.01),
                                   "h1": host_snap(4, 7, 0.02)})
    # counters: summed across hosts (controller contributes its
    # zero-injected 0 — the fleet sum IS the per-host sum)
    assert snap["mdtpu_jobs_completed_total"]["values"][""] == 7
    assert snap["mdtpu_phase_seconds_total"]["values"][
        'phase="stage"'] == 1.0
    # controller-local series stay the controller's own
    assert snap["mdtpu_hosts_lost_total"]["values"][
        'reason="socket_eof"'] == 1
    # gauges: one labeled series per host, never summed
    assert snap["mdtpu_queue_depth"]["values"]['host="h0"'] == 2
    assert snap["mdtpu_queue_depth"]["values"]['host="h1"'] == 7
    # histograms: counts/sums/buckets fold (fixed buckets merge)
    h = snap["mdtpu_job_latency_seconds"]["values"][""]
    assert h["count"] == 2
    assert h["sum"] == 0.03
    assert h["buckets"]["+Inf"] == 2
    text = to_prometheus(snap)
    assert 'mdtpu_queue_depth{host="h0"} 2' in text
    assert "mdtpu_jobs_completed_total 7" in text


def test_tail_interleaves_job_spans_with_global_incidents():
    """The quarantine/flight-recorder satellite: tail(trace_id=)
    returns the job's spans AND the globally attributed incidents
    (breaker transitions, fencing, mirrored log lines) in one shared
    monotonic (append) order — another job's attributed events stay
    out."""
    from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

    obs.enable_tracing()
    with obs.trace_context(trace_ids=["job-A"]):
        with TIMERS.phase("stage"):
            pass
        obs.span_event("retry", site="read")
    obs.span_event("breaker_transition", backend="torch",
                   to_state="open")
    log_event("serving", jobs_submitted=3)        # mirrored instant
    with obs.trace_context(trace_ids=["job-B"]):
        obs.span_event("retry", site="stage")
    obs.disable_tracing()

    t = ospans.tail(limit=50, trace_id="job-A")
    names = [ev["name"] for ev in t]
    assert names == ["stage", "retry", "breaker_transition",
                     "serving"]        # append order, job-B excluded
    mirrored = next(ev for ev in t if ev["name"] == "serving")
    assert mirrored["cat"] == "log"
    assert mirrored["args"]["jobs_submitted"] == 3


def test_span_ring_evicts_oldest_and_counts_drops(monkeypatch):
    """The buffer is a RING: overflow evicts the OLDEST events
    (counted, disclosed in the export) so the tail — the flight
    recorder's black box — always holds the most recent window.  The
    port's bound is the module's ``MAX_EVENTS``."""
    obs.enable_tracing()
    monkeypatch.setattr(ospans, "MAX_EVENTS", 5)
    try:
        for i in range(9):
            obs.span_event("tick", i=i)
        t = ospans.tail(limit=10)
        assert [ev["args"]["i"] for ev in t] == [4, 5, 6, 7, 8]
        doc = ospans.document()
        assert doc["otherData"]["dropped_events"] == 4
    finally:
        obs.disable_tracing(discard=True)


def test_flight_dump_black_box_roundtrip(tmp_path):
    """obs.flight.dump: atomic JSON with the recent interleaved
    window, the process attribution, and a full metrics snapshot;
    counted per trigger."""
    obs.enable_tracing()
    ospans.set_process_args(fleet_host="hX")
    try:
        obs.span_event("retry", site="read")
        log_event("serving", jobs_submitted=1)
        before = obs.METRICS.snapshot().get(
            "mdtpu_flight_dumps_total", {"values": {}})["values"].get(
            'trigger="quarantine"', 0)
        path = obs.flight.dump("quarantine", str(tmp_path),
                               extra={"job_id": 7})
        with open(path) as f:
            doc = json.load(f)
        assert doc["trigger"] == "quarantine"
        assert doc["extra"] == {"job_id": 7}
        assert doc["process_args"] == {"fleet_host": "hX"}
        names = [ev["name"] for ev in doc["events"]]
        assert "retry" in names and "serving" in names
        assert "mdtpu_retries_total" in doc["metrics"]
        after = obs.METRICS.snapshot()[
            "mdtpu_flight_dumps_total"]["values"][
            'trigger="quarantine"']
        assert after == before + 1
        # no directory resolvable -> recorder off, never an error
        assert obs.flight.dump("quarantine", None) is None
    finally:
        ospans.set_process_args()
        obs.disable_tracing(discard=True)


def test_run_reports_do_not_bleed_across_concurrent_workers(stack):
    """The PR-5 caveat, fixed (satellite): two jobs overlapping on a
    2-worker scheduler each get phase totals from their OWN
    trace-context window — the slow tenant's staging sleeps must not
    appear in the fast tenant's report.  Tracing stays OFF: the
    attribution rides the always-on trace context, not recording."""

    class _SlowReader(stack.MemoryReader):
        def read_block(self, *a, **k):
            time.sleep(0.04)
            return super().read_block(*a, **k)

        def stage_block(self, *a, **k):
            time.sleep(0.04)
            return super().stage_block(*a, **k)

    assert not obs.tracing_enabled()
    rng = np.random.default_rng(11)
    top = stack.make_protein_topology(16)
    frames = rng.normal(scale=8.0,
                        size=(64, top.n_atoms, 3)).astype(np.float32)
    u_slow = stack.Universe(top, _SlowReader(frames))
    u_fast = _u(stack, n_frames=16)

    sched = stack.Scheduler(n_workers=2, autostart=False)
    h_slow = sched.submit(stack.RMSF(u_slow.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8, tenant="slow")
    h_fast = sched.submit(stack.RMSF(u_fast.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8, tenant="fast")
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert h_slow.error is None and h_fast.error is None

    r_slow = h_slow.job.analysis.results.observability
    r_fast = h_fast.job.analysis.results.observability
    # scheduler runs attribute per job via their trace context
    assert r_slow["phase_attribution"] == "job"
    assert r_fast["phase_attribution"] == "job"

    def staged_seconds(report):
        return sum(report["phases"].get(name, {}).get("seconds", 0.0)
                   for name in ("stage", "read"))

    # the slow tenant really slept in staging (8 blocks x >=0.08 s)
    assert staged_seconds(r_slow) >= 0.3
    # ... and NONE of it bled into the fast tenant's report (the old
    # global-delta slice would book everything the slow job staged
    # inside the fast job's time window)
    assert staged_seconds(r_fast) < 0.15
    # sanity: the fast report still saw its own dispatches
    assert r_fast["dispatch_count"] >= 1


def test_solo_run_report_keeps_process_attribution(stack):
    """Outside any scheduler context the report falls back to the
    process-global delta — exact for a solo run — and says so."""
    u = _u(stack)
    r = stack.RMSF(u.select_atoms("name CA")).run(backend="serial")
    rep = r.results.observability
    assert rep["phase_attribution"] == "process"
    assert "execute" in rep["phases"]


def test_scheduler_status_endpoint_serves_three_routes(stack):
    """Scheduler.serve_status(): /status, /healthz and /metrics off
    the live scheduler, counted per route."""
    import urllib.request

    sched = stack.Scheduler(n_workers=1)
    host, port = sched.serve_status()
    try:
        doc = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/status", timeout=5).read())
        assert doc["role"] == "scheduler"
        assert doc["workers_alive"] >= 1
        assert doc["queue_depth"] == 0
        health = urllib.request.urlopen(
            f"http://{host}:{port}/healthz", timeout=5)
        assert health.status == 200
        text = urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=5).read().decode()
        assert "# TYPE mdtpu_jobs_submitted_total counter" in text
        snap = obs.METRICS.snapshot()["mdtpu_status_requests_total"]
        assert snap["values"]['route="/status"'] >= 1
        assert snap["values"]['route="/metrics"'] >= 1
    finally:
        sched.shutdown()
