"""The port's twin of ``tests/test_alerts.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``); the fleet controller's cases wait for the fleet
tier.

Alert rules engine (obs/alerts.py, docs/OBSERVABILITY.md
"Alerting & profiling"): threshold/rate/burn-rate semantics with an
injected clock, hysteresis both ways, the flight-dump-exactly-once
contract, and the end-to-end burn-rate story through a real
scheduler.
"""

import json
import os
import time

import pytest

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.obs import spans as ospans
from mdanalysis_mpi_tpu_torch.obs.alerts import (
    SEED_RULES, AlertEngine, AlertRule, seed_rules,
)

pytestmark = pytest.mark.service


@pytest.fixture(autouse=True)
def _clean_tracer():
    ospans.disable(discard=True)
    ospans.reset()
    yield
    ospans.disable(discard=True)
    ospans.reset()


def _gauge(name: str, values: dict) -> dict:
    return {name: {"type": "gauge", "values": dict(values)}}


def _counter(name: str, total, labels: str = "") -> dict:
    return {name: {"type": "counter", "values": {labels: total}}}


# ---------------------------------------------------------------------------
# rule validation + catalog
# ---------------------------------------------------------------------------

def test_rule_validation_rejects_bad_specs():
    with pytest.raises(ValueError, match="snake_case"):
        AlertRule({"name": "BadName", "kind": "threshold",
                   "metric": "mdtpu_queue_depth"})
    with pytest.raises(ValueError, match="unknown alert rule kind"):
        AlertRule({"name": "x", "kind": "slope",
                   "metric": "mdtpu_queue_depth"})
    with pytest.raises(ValueError, match="names no metric"):
        AlertRule({"name": "x", "kind": "threshold"})
    with pytest.raises(ValueError, match="unknown fields"):
        AlertRule({"name": "x", "kind": "threshold",
                   "metric": "m", "typo_field": 1})
    with pytest.raises(ValueError, match="duplicate"):
        AlertEngine(rules=[{"name": "x", "kind": "threshold",
                            "metric": "a"},
                           {"name": "x", "kind": "threshold",
                            "metric": "b"}])
    # the shipped catalog validates and stays snake_case-unique
    assert len({r["name"] for r in SEED_RULES}) == len(SEED_RULES)
    assert [r.name for r in seed_rules()] == [r["name"]
                                              for r in SEED_RULES]


# ---------------------------------------------------------------------------
# threshold + hysteresis
# ---------------------------------------------------------------------------

def test_threshold_for_ticks_hysteresis_fires_and_resolves():
    eng = AlertEngine(rules=[{"name": "deep_queue",
                              "kind": "threshold",
                              "metric": "mdtpu_queue_depth",
                              "op": ">=", "threshold": 10,
                              "for_ticks": 3}],
                      clock=lambda: 0.0)
    snap_hot = _gauge("mdtpu_queue_depth", {"": 12})
    snap_cold = _gauge("mdtpu_queue_depth", {"": 1})
    # a 2-tick spike never fires (hysteresis)
    assert eng.evaluate(snap_hot, now=1) == []
    assert eng.evaluate(snap_hot, now=2) == []
    assert eng.evaluate(snap_cold, now=3) == []
    assert eng.firing() == []
    # 3 sustained ticks fire exactly once
    for t in (4, 5):
        assert eng.evaluate(snap_hot, now=t) == []
    trs = eng.evaluate(snap_hot, now=6)
    assert [(t["rule"], t["state"]) for t in trs] == [
        ("deep_queue", "firing")]
    assert eng.evaluate(snap_hot, now=7) == []        # no re-fire
    # resolve needs the SAME sustained clean streak: a 2-tick dip
    # inside a flap keeps it firing
    assert eng.evaluate(snap_cold, now=8) == []
    assert eng.evaluate(snap_cold, now=9) == []
    assert eng.evaluate(snap_hot, now=10) == []       # flap back
    assert eng.firing()[0]["rule"] == "deep_queue"
    for t in (11, 12):
        assert eng.evaluate(snap_cold, now=t) == []
    trs = eng.evaluate(snap_cold, now=13)
    assert [(t["rule"], t["state"]) for t in trs] == [
        ("deep_queue", "resolved")]
    assert eng.firing() == []
    # transitions counted per rule and direction
    snap = obs.METRICS.snapshot()["mdtpu_alert_transitions_total"]
    assert snap["values"].get('rule="deep_queue",to="firing"') == 1
    assert snap["values"].get('rule="deep_queue",to="resolved"') == 1


def test_rate_rule_needs_a_window_and_judges_per_second():
    eng = AlertEngine(rules=[{"name": "shed_fast", "kind": "rate",
                              "metric": "mdtpu_jobs_shed_total",
                              "window_s": 60.0, "threshold": 0.5,
                              "for_ticks": 1}],
                      clock=lambda: 0.0)
    # one sample can never fire (no rate from a single observation)
    assert eng.evaluate(_counter("mdtpu_jobs_shed_total", 100),
                        now=0) == []
    # +30 sheds over 10 s = 3/s > 0.5/s
    trs = eng.evaluate(_counter("mdtpu_jobs_shed_total", 130), now=10)
    assert [(t["rule"], t["state"]) for t in trs] == [
        ("shed_fast", "firing")]
    # flat counter over the next minute → rate decays to 0 → resolves
    trs = []
    for t in (30, 50, 75):
        trs += eng.evaluate(_counter("mdtpu_jobs_shed_total", 130),
                            now=t)
    assert [(t["rule"], t["state"]) for t in trs] == [
        ("shed_fast", "resolved")]


def test_burn_rate_needs_both_windows_and_tracks_series():
    eng = AlertEngine(rules=[{"name": "slo_burn", "kind": "burn_rate",
                              "metric": "mdtpu_slo_attainment",
                              "objective": 0.9,
                              "fast_window_s": 60.0,
                              "slow_window_s": 300.0,
                              "burn_threshold": 2.0, "for_ticks": 2}],
                      clock=lambda: 0.0)

    def snap(att):
        return _gauge("mdtpu_slo_attainment",
                      {'class="interactive"': att,
                       'class="batch"': 1.0})

    # cold start: pure misses in a process's first minute must not
    # fire — until the history spans half the slow window, the two
    # windows would average the same points and the multi-window
    # pattern would degenerate to single-window
    t = 0.0
    for _ in range(3):                        # 60 s of pure misses
        t += 20.0
        assert eng.evaluate(snap(0.0), now=t) == []
    assert eng.firing() == []
    # fresh engine for the main scenario
    eng = AlertEngine(rules=[{"name": "slo_burn", "kind": "burn_rate",
                              "metric": "mdtpu_slo_attainment",
                              "objective": 0.9,
                              "fast_window_s": 60.0,
                              "slow_window_s": 300.0,
                              "burn_threshold": 2.0, "for_ticks": 2}],
                      clock=lambda: 0.0)
    # a fast-window cliff after a LONG healthy history does not fire:
    # the slow window still averages under the burn threshold — the
    # multi-window pattern rejecting a blip
    t = 0.0
    for _ in range(30):                       # 600 s of attainment 1.0
        t += 20.0
        assert eng.evaluate(snap(1.0), now=t) == []
    for _ in range(3):                        # 60 s cliff
        t += 20.0
        assert eng.evaluate(snap(0.2), now=t) == []
    assert eng.firing() == []
    # sustained misses push the slow window over too → fires, and
    # only the interactive series (batch at 1.0 stays quiet)
    fired = []
    for _ in range(20):
        t += 20.0
        fired += eng.evaluate(snap(0.2), now=t)
    assert [(f["rule"], f["series"], f["state"]) for f in fired] == [
        ("slo_burn", 'class="interactive"', "firing")]
    # recovery: attainment back at 1.0 long enough drains both
    # windows → resolves (journal-style history, not a reset)
    resolved = []
    for _ in range(30):
        t += 20.0
        resolved += eng.evaluate(snap(1.0), now=t)
    assert [(f["series"], f["state"]) for f in resolved] == [
        ('class="interactive"', "resolved")]


def test_firing_series_that_vanishes_from_snapshot_resolves():
    """A firing series whose metric disappears (a class with no more
    jobs, a pruned lost-host gauge) must resolve through the same
    clear hysteresis — not fire forever on its last bad reading."""
    eng = AlertEngine(rules=[{"name": "burny", "kind": "burn_rate",
                              "metric": "mdtpu_slo_attainment",
                              "objective": 0.9,
                              "fast_window_s": 60.0,
                              "slow_window_s": 60.0,
                              "burn_threshold": 2.0, "for_ticks": 2}],
                      clock=lambda: 0.0)
    bad = _gauge("mdtpu_slo_attainment", {'class="interactive"': 0.0})
    t = 0.0
    fired = []
    for _ in range(4):
        t += 30.0
        fired += eng.evaluate(bad, now=t)
    assert [f["state"] for f in fired] == ["firing"]
    # the series vanishes entirely (empty snapshot): resolves after
    # for_ticks absent evaluations, value disclosed as None
    resolved = []
    for _ in range(3):
        t += 30.0
        resolved += eng.evaluate({}, now=t)
    assert [(f["series"], f["state"], f["value"])
            for f in resolved] == [
        ('class="interactive"', "resolved", None)]
    assert eng.firing() == []
    # the vanished series' state is evicted (a host-churning fleet
    # mints labeled series forever; retained states must not grow
    # without bound)
    assert eng._state == {}


def test_reappearing_series_rearms_the_cold_start_guard():
    """A series that vanishes and later reappears must not ride its
    stale pre-gap history past the burn cold-start guard: the two
    fresh points alone span nothing, so the windows would degenerate
    to single-window and fire on a blip."""
    eng = AlertEngine(rules=[{"name": "burny", "kind": "burn_rate",
                              "metric": "mdtpu_slo_attainment",
                              "objective": 0.9,
                              "fast_window_s": 60.0,
                              "slow_window_s": 300.0,
                              "burn_threshold": 2.0, "for_ticks": 2}],
                      clock=lambda: 0.0)
    good = _gauge("mdtpu_slo_attainment", {'class="interactive"': 1.0})
    bad = _gauge("mdtpu_slo_attainment", {'class="interactive"': 0.5})
    t = 0.0
    for _ in range(30):                       # long healthy history
        t += 20.0
        assert eng.evaluate(good, now=t) == []
    t += 1200.0                               # 20 min gap: vanished
    eng.evaluate({}, now=t)
    for _ in range(3):                        # fresh bad readings
        t += 1.0
        assert eng.evaluate(bad, now=t) == [], \
            "stale pre-gap history bypassed the cold-start guard"
    assert eng.firing() == []


def test_summed_metrics_rule_fires_on_any_corruption_counter():
    eng = AlertEngine(rules=[AlertRule(s) for s in SEED_RULES
                             if s["name"] == "data_corruption"],
                      clock=lambda: 0.0)
    clean = {}
    assert eng.evaluate(clean, now=1) == []
    dirty = _counter("mdtpu_scrub_corrupt_total", 0)
    dirty.update(_counter("mdtpu_integrity_corrupt_total", 1,
                          'artifact="npz"'))
    trs = eng.evaluate(dirty, now=2)
    assert [(t["rule"], t["state"]) for t in trs] == [
        ("data_corruption", "firing")]


# ---------------------------------------------------------------------------
# flight-recorder-on-alert: exactly once, with the profiler block
# ---------------------------------------------------------------------------

def test_first_firing_dumps_exactly_once_despite_flapping(tmp_path):
    """Satellite: the first transition to firing writes ONE black box;
    a flapping rule (fire → resolve → fire ...) never storms dumps,
    and the dump carries the profiler watermark block."""
    eng = AlertEngine(rules=[{"name": "flappy", "kind": "threshold",
                              "metric": "mdtpu_queue_depth",
                              "op": ">=", "threshold": 5,
                              "for_ticks": 2}],
                      clock=lambda: 0.0,
                      flight_dir=str(tmp_path))
    hot = _gauge("mdtpu_queue_depth", {"": 9})
    cold = _gauge("mdtpu_queue_depth", {"": 0})
    t = 0.0
    fired = 0
    for _ in range(4):                        # four full flap cycles
        for _ in range(3):
            t += 1
            fired += sum(1 for tr in eng.evaluate(hot, now=t)
                         if tr["state"] == "firing")
        for _ in range(3):
            t += 1
            eng.evaluate(cold, now=t)
    assert fired == 4                          # fired every cycle...
    dumps = [p for p in os.listdir(tmp_path)
             if p.startswith("flight_alert_")]
    assert len(dumps) == 1                     # ...dumped exactly once
    with open(tmp_path / dumps[0]) as f:
        doc = json.load(f)
    assert doc["trigger"] == "alert"
    assert doc["extra"]["rule"] == "flappy"
    # the profiler watermark block rides every dump (obs/prof.py):
    # one-shot RSS even when the sampler never ran
    assert "profiler" in doc
    assert doc["profiler"]["rss_bytes"] > 0
    assert "watermarks" in doc["profiler"]
    # counted under its own trigger label
    snap = obs.METRICS.snapshot()["mdtpu_flight_dumps_total"]
    assert snap["values"].get('trigger="alert"', 0) >= 1


# ---------------------------------------------------------------------------
# end-to-end: a real scheduler where one class misses its SLO
# ---------------------------------------------------------------------------

def _stack():
    from mdanalysis_mpi_tpu_torch.analysis import RMSF
    from mdanalysis_mpi_tpu_torch.service import Scheduler
    from mdanalysis_mpi_tpu_torch.service.qos import QosPolicy
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    return RMSF, Scheduler, QosPolicy, make_protein_universe


def test_scheduler_burn_rate_end_to_end_with_injected_clock(
        tmp_path, monkeypatch):
    """Acceptance: interactive jobs miss their SLO target → the
    burn-rate rule trips on the scheduler's snapshot → journaled
    ``alert_fired`` instant, /status alerts block,
    ``mdtpu_alerts_firing{rule=}`` = 1, exactly one flight-recorder
    dump; the rule resolves (journaled) when attainment recovers.
    The engine's burn windows run on the scheduler's injected clock,
    and the jobs' latencies on an injected job clock: a slow job's
    ``_prepare`` advances it past the target, a fast job's run takes
    no time on it, so attainment never depends on the host's load."""
    RMSF, Scheduler, QosPolicy, make_u = _stack()
    import types

    from mdanalysis_mpi_tpu_torch.service import jobs as _jobs

    job_t = [0.0]
    monkeypatch.setattr(_jobs, "time",
                        types.SimpleNamespace(monotonic=lambda: job_t[0]))

    class SlowRMSF(RMSF):
        def _prepare(self):
            job_t[0] += 0.08                  # misses the 20 ms target
            super()._prepare()

    u = make_u(n_residues=20, n_frames=12, noise=0.3, seed=7)
    clock_t = [1000.0]
    journal = str(tmp_path / "jobs.journal")
    flight = tmp_path / "flight"
    ospans.enable()                           # capture the instants
    # the seed burn-rate rule alone: the other seed rules read
    # process-wide counters that earlier tests in this process may have
    # moved (a corruption count, a breaker flip)
    sched = Scheduler(
        n_workers=1, autostart=False, supervise=False,
        clock=lambda: clock_t[0], journal=journal,
        flight_dir=str(flight),
        alerts=[dict(r) for r in SEED_RULES
                if r["name"] == "slo_burn_rate"],
        qos=QosPolicy(slo_targets_s={"interactive": 0.02}))
    try:
        # phase 1: two interactive jobs MISS the 20 ms target
        for i in range(2):
            sched.submit(SlowRMSF(u.select_atoms("name CA")),
                         backend="serial", qos="interactive",
                         coalesce=False, tenant=f"slow{i}")
        sched.start()
        assert sched.drain(timeout=60)
        qos_snap = sched.telemetry.snapshot()["qos"]["interactive"]
        assert qos_snap["slo_attainment"] == 0.0
        # tick the engine across both burn windows on the injected
        # clock — attainment 0 burns 10x the budget, so the rule
        # fires once fast AND slow windows agree (for_ticks=2, after
        # the cold-start guard has half the slow window of coverage)
        fired = []
        for _ in range(8):
            clock_t[0] += 30.0
            fired += sched._alert_tick(force=True)
        fire = [tr for tr in fired if tr["state"] == "firing"
                and tr["rule"] == "slo_burn_rate"]
        assert len(fire) == 1
        assert fire[0]["series"] == 'class="interactive"'
        # /status carries the firing table
        alerts = sched.status()["alerts"]
        assert [a["rule"] for a in alerts["firing"]] == \
            ["slo_burn_rate"]
        # the metric is live
        g = obs.METRICS.snapshot()["mdtpu_alerts_firing"]["values"]
        assert g.get('rule="slo_burn_rate"') == 1
        # exactly one black box, tagged with the rule
        dumps = [p for p in os.listdir(flight)
                 if p.startswith("flight_alert_")]
        assert len(dumps) == 1
        # the instant is on the timeline
        names = [ev["name"] for ev in ospans.tail(limit=200)]
        assert "alert_fired" in names
        # phase 2: recovery — fast interactive jobs lift cumulative
        # attainment over the burn threshold's break-even (0.8)
        handles = [
            sched.submit(RMSF(u.select_atoms("name CA")),
                         backend="serial", qos="interactive",
                         coalesce=False, tenant=f"fast{i}")
            for i in range(18)]
        assert sched.drain(timeout=60)
        assert all(h.latency_s is not None for h in handles)
        att = sched.telemetry.snapshot()["qos"]["interactive"][
            "slo_attainment"]
        assert att >= 0.8, f"fast jobs still missed the SLO ({att})"
        resolved = []
        for _ in range(20):
            clock_t[0] += 30.0
            resolved += sched._alert_tick(force=True)
        res = [tr for tr in resolved if tr["state"] == "resolved"
               and tr["rule"] == "slo_burn_rate"]
        assert len(res) == 1
        assert sched.status()["alerts"]["firing"] == []
        g = obs.METRICS.snapshot()["mdtpu_alerts_firing"]["values"]
        assert g.get('rule="slo_burn_rate"') == 0
        names = [ev["name"] for ev in ospans.tail(limit=400)]
        assert "alert_resolved" in names
        # still exactly one dump (resolution never dumps; a later
        # re-fire of the same rule would not either)
        dumps = [p for p in os.listdir(flight)
                 if p.startswith("flight_alert_")]
        assert len(dumps) == 1
    finally:
        sched.shutdown()
    # both transitions were journaled beside the job lifecycle
    with open(journal) as f:
        text = f.read()
    assert '"alert"' in text
    assert '"slo_burn_rate"' in text
    assert '"firing"' in text and '"resolved"' in text


def test_supervisor_tick_evaluates_rules_without_manual_driving():
    """The wiring itself: a threshold rule fires from the supervisor's
    own telemetry tick (real clock, no manual evaluate calls)."""
    RMSF, Scheduler, QosPolicy, make_u = _stack()
    import threading

    u = make_u(n_residues=20, n_frames=12, noise=0.3, seed=8)
    gate = threading.Event()

    class GatedRMSF(RMSF):
        def _prepare(self):
            gate.wait(30.0)
            super()._prepare()

    sched = Scheduler(
        n_workers=1, autostart=False, supervise=True,
        supervision_interval_s=0.02, alert_interval_s=0.01,
        alerts=[{"name": "any_submission", "kind": "threshold",
                 "metric": "mdtpu_jobs_submitted_total", "op": ">=",
                 "threshold": 1, "for_ticks": 1}])
    try:
        sched.submit(GatedRMSF(u.select_atoms("name CA")),
                     backend="serial", coalesce=False, tenant="gated")
        sched.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not sched.alerts.firing():
            time.sleep(0.02)
        assert [a["rule"] for a in sched.alerts.firing()] == \
            ["any_submission"]
    finally:
        gate.set()
        sched.drain(timeout=60)
        sched.shutdown()

