"""The port's twin of ``tests/test_qos.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``); the fleet controller's cases build it with
``device="cpu"`` and spawn port hosts on the CPU.

QoS classes, weighted-fair admission, load shedding, autoscaling
(docs/RELIABILITY.md §7 "Overload and elasticity").

Differential strategy as everywhere: degradation under overload must
be POLICY, not accident — every drop is typed, journaled and counted,
classes outside the configured shed set are untouchable whatever the
pressure, and jobs that survive a burst produce numbers identical to
their solo oracle runs.
"""

import os
import threading
import time

import pytest


from mdanalysis_mpi_tpu_torch import obs  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis import RMSF  # noqa: E402
from mdanalysis_mpi_tpu_torch.service import (  # noqa: E402
    AdmissionRejectedError, AnalysisJob, JobRuntimeExceeded,
    JobShedError, JobState, QosPolicy, Scheduler,
)
from mdanalysis_mpi_tpu_torch.service import journal as _journal  # noqa: E402
from mdanalysis_mpi_tpu_torch.service import supervision as _supervision  # noqa: E402
from mdanalysis_mpi_tpu_torch.service.qos import (  # noqa: E402
    DEFAULT_WEIGHTS, QOS_CLASSES, StrideScheduler, qos_rank,
    validate_qos,
)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

#: the device route on the CPU (the port runs on the card by default)
CPU = {"device": "cpu"}

pytestmark = pytest.mark.service


def _u(n_frames=24, seed=9):
    return make_protein_universe(n_residues=30, n_frames=n_frames,
                                 noise=0.3, seed=seed)


def _sched(**kw):
    kw.setdefault("supervision_interval_s", 0.02)
    return Scheduler(**kw)


class _GatedRMSF(RMSF):
    """Holds its worker at _prepare until the test opens the gate —
    the deterministic way to keep the pool saturated (the overload
    predicate requires busy workers: depth with idle workers is
    transient, not overload)."""

    gate: threading.Event = None

    def _prepare(self):
        type(self).gate.wait(30.0)
        super()._prepare()


# ---------------------------------------------------------------------------
# policy + stride units
# ---------------------------------------------------------------------------

def test_validate_qos_rejects_typo_at_construction():
    u = _u()
    with pytest.raises(ValueError, match="unknown QoS class"):
        AnalysisJob(RMSF(u.select_atoms("name CA")), qos="interactiv", backend="serial")
    # default is batch, the pre-QoS behavior
    assert AnalysisJob(RMSF(u.select_atoms("name CA")), backend="serial").qos == "batch"
    assert validate_qos(None) == "batch"
    assert [qos_rank(c) for c in QOS_CLASSES] == [0, 1, 2, 3]


def test_qos_policy_validates_and_defaults():
    p = QosPolicy(weights={"interactive": 16})
    assert p.weights["interactive"] == 16
    assert p.weights["batch"] == DEFAULT_WEIGHTS["batch"]
    assert p.shed_classes == ("background",)
    assert p.shed_ladder() == ["background"]
    with pytest.raises(ValueError, match="unknown QoS class"):
        QosPolicy(weights={"interactve": 1})
    with pytest.raises(ValueError, match="> 0"):
        QosPolicy(weights={"batch": 0})
    with pytest.raises(ValueError, match="unknown qos policy fields"):
        QosPolicy.from_spec({"shed_depht": 3})
    # ladder order: LOWEST class first
    p2 = QosPolicy(shed_classes=("batch", "background"))
    assert p2.shed_ladder() == ["background", "batch"]


def test_stride_scheduler_weight_ratio_and_no_starvation():
    # explicit 3-class universe: adding weight-2 "streaming" to the
    # candidate set would shift the 8:3:1 shares this test pins
    classes = ("interactive", "batch", "background")
    s = StrideScheduler({"interactive": 8, "batch": 3,
                         "background": 1})
    picks = [s.pick(classes) for _ in range(1200)]
    counts = {c: picks.count(c) for c in classes}
    # stride converges to the exact weight shares (±1 per boundary)
    assert abs(counts["interactive"] - 800) <= 8
    assert abs(counts["batch"] - 300) <= 3
    assert counts["background"] >= 90          # never starved
    # a lone backlogged class gets every slot (work conservation)
    assert all(s.pick(["background"]) == "background"
               for _ in range(5))
    # ...and cannot claim credit for its idle time afterwards: the
    # re-entering class is floored to the current virtual time
    s2 = StrideScheduler({"interactive": 2, "background": 1})
    for _ in range(50):
        s2.pick(["interactive"])
    follow = [s2.pick(["interactive", "background"])
              for _ in range(9)]
    assert follow.count("background") <= 4
    # the RE-entry shape (review regression): a class picked once,
    # idle while another advances alone, must NOT burst on re-entry —
    # its stale low pass is clamped to vtime, not used as the floor
    s3 = StrideScheduler({"interactive": 2, "background": 1})
    s3.pick(["background"])                  # pass_bg ~ 1.0, then idle
    for _ in range(50):
        s3.pick(["interactive"])             # vtime advances to ~25
    burst = [s3.pick(["interactive", "background"])
             for _ in range(9)]
    assert burst.count("background") <= 4    # fair share, no burst


# ---------------------------------------------------------------------------
# weighted-fair claim ordering
# ---------------------------------------------------------------------------

def test_weighted_fair_claim_order_and_fifo_within_class():
    """Interactive is claimed ahead of earlier-submitted batch work
    (weighted-fair, not strict submission order), FIFO holds WITHIN
    each class, and nothing starves."""
    u = _u()
    order = []
    sched = _sched(n_workers=1, autostart=False,
                   qos=QosPolicy(weights={"interactive": 4,
                                          "batch": 1}))
    handles = []
    # batch submitted FIRST; distinct windows so nothing coalesces
    for i in range(3):
        h = sched.submit(RMSF(u.select_atoms("name CA")),
                         backend="serial", start=i, stop=12 + i,
                         coalesce=False, qos="batch",
                         tenant=f"b{i}")
        h.add_done_callback(
            lambda hh: order.append(hh.job.tenant))
        handles.append(h)
    for i in range(3):
        h = sched.submit(RMSF(u.select_atoms("name CA")),
                         backend="serial", start=i, stop=18 + i,
                         coalesce=False, qos="interactive",
                         tenant=f"i{i}")
        h.add_done_callback(
            lambda hh: order.append(hh.job.tenant))
        handles.append(h)
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert all(h.error is None for h in handles)
    # the first claim goes to interactive despite batch's head start
    assert order[0].startswith("i")
    # FIFO within each class
    assert [t for t in order if t.startswith("i")] == \
        ["i0", "i1", "i2"]
    assert [t for t in order if t.startswith("b")] == \
        ["b0", "b1", "b2"]
    # weight 4:1 → at most one batch job lands inside the first four
    assert sum(1 for t in order[:4] if t.startswith("b")) <= 1


def test_single_class_keeps_priority_fifo_semantics():
    """Every pre-QoS workload is a one-class workload: priority order
    with FIFO ties must be byte-identical to the old scheduler."""
    u = _u()
    order = []
    sched = _sched(n_workers=1, autostart=False)
    for tenant, prio in (("lo", 0), ("hi", 5), ("mid", 3),
                         ("hi2", 5)):
        h = sched.submit(RMSF(u.select_atoms("name CA")),
                         backend="serial",
                         start={"lo": 0, "hi": 1, "mid": 2,
                                "hi2": 3}[tenant],
                         coalesce=False, priority=prio,
                         tenant=tenant)
        h.add_done_callback(lambda hh: order.append(hh.job.tenant))
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert order == ["hi", "hi2", "mid", "lo"]


# ---------------------------------------------------------------------------
# typed admission: backpressure, rate limits, quotas
# ---------------------------------------------------------------------------

def test_bounded_submit_rejects_typed_queue_full():
    u = _u()
    sched = _sched(autostart=False,
                   qos=QosPolicy(max_queue_depth=2))
    sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                 coalesce=False)
    sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                 start=1, coalesce=False)
    with pytest.raises(AdmissionRejectedError) as exc:
        sched.submit(RMSF(u.select_atoms("name CA")),
                     backend="serial", start=2, coalesce=False)
    assert exc.value.reason == "queue_full"
    assert sched.telemetry.admission_rejects == 1
    # the rejected submission left NO side effects: the queue still
    # drains to exactly the two admitted jobs
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert sched.telemetry.completed == 2
    assert sched.telemetry.submitted == 2


def test_tenant_quota_rejects_typed_other_tenants_unaffected():
    u = _u()
    sched = _sched(autostart=False, qos=QosPolicy(tenant_quota=1))
    sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                 tenant="greedy", coalesce=False)
    with pytest.raises(AdmissionRejectedError) as exc:
        sched.submit(RMSF(u.select_atoms("name CA")),
                     backend="serial", start=1, tenant="greedy",
                     coalesce=False)
    assert exc.value.reason == "tenant_quota"
    # another tenant is not charged for greedy's appetite
    sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                 start=2, tenant="polite", coalesce=False)
    sched.start()
    assert sched.drain(timeout=60)
    # the quota frees as jobs finish: greedy may submit again
    h = sched.submit(RMSF(u.select_atoms("name CA")),
                     backend="serial", start=3, tenant="greedy",
                     coalesce=False)
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert h.error is None
    assert sched.telemetry.completed == 3


def test_tenant_rate_limit_token_bucket_with_injected_clock():
    clock_t = [100.0]
    u = _u()
    sched = _sched(autostart=False, clock=lambda: clock_t[0],
                   qos=QosPolicy(tenant_rate_per_s=1.0))
    sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                 tenant="t", coalesce=False)
    with pytest.raises(AdmissionRejectedError) as exc:
        sched.submit(RMSF(u.select_atoms("name CA")),
                     backend="serial", start=1, tenant="t",
                     coalesce=False)
    assert exc.value.reason == "rate_limit"
    clock_t[0] += 1.0          # the bucket refills at 1 token/s
    sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                 start=2, tenant="t", coalesce=False)
    assert sched.telemetry.admission_rejects == 1
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert sched.telemetry.completed == 2


# ---------------------------------------------------------------------------
# the shed ladder
# ---------------------------------------------------------------------------

def test_overload_sheds_lowest_class_first_typed_journaled_counted(
        tmp_path):
    """The acceptance shape, in-process: a saturated worker + a burst
    past the shed depth → background shed first, then batch (both in
    the configured set), interactive NEVER — each shed typed
    (JobShedError, state ``shed``), journaled as a terminal record,
    and counted by class."""
    u = _u()
    journal = str(tmp_path / "j.jsonl")
    _GatedRMSF.gate = threading.Event()
    sched = _sched(n_workers=1, autostart=False, journal=journal,
                   qos=QosPolicy(
                       shed_queue_depth=2,
                       shed_classes=("background", "batch")))
    # the gate job saturates the lone worker; interactive + top
    # priority so the weighted-fair claim picks it first
    gated = sched.submit(_GatedRMSF(u.select_atoms("name CA")),
                         backend="serial", qos="interactive",
                         priority=100, coalesce=False,
                         tenant="gate")
    others = {}
    for i, qos_cls in enumerate(("interactive", "interactive",
                                 "batch", "batch",
                                 "background", "background")):
        others[f"{qos_cls}{i}"] = sched.submit(
            RMSF(u.select_atoms("name CA")), backend="serial",
            start=i, coalesce=False, qos=qos_cls,
            tenant=f"{qos_cls}{i}")
    sched.start()
    try:
        # the supervisor's overload tick engages once the worker is
        # leased: 6 queued > depth 2 → shed ladder drops the 2
        # background, then the 2 batch — never the interactive
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and \
                sched.telemetry.jobs_shed < 4:
            time.sleep(0.02)
    finally:
        _GatedRMSF.gate.set()
    assert sched.drain(timeout=60)
    sched.shutdown()
    shed = {t: h for t, h in others.items()
            if h.state == JobState.SHED}
    assert sorted(shed) == ["background4", "background5", "batch2",
                            "batch3"]
    for h in shed.values():
        assert isinstance(h.error, JobShedError)
        assert h.error.qos in ("background", "batch")
    # zero sheds above the configured set: every interactive ran
    assert gated.error is None
    assert others["interactive0"].state == JobState.DONE
    assert others["interactive1"].state == JobState.DONE
    assert sched.telemetry.jobs_shed == 4
    snap = sched.telemetry.snapshot()
    assert snap["qos"]["background"]["shed"] == 2
    assert snap["qos"]["batch"]["shed"] == 2
    assert snap["qos"]["interactive"]["shed"] == 0
    # the labeled live counter
    mets = obs.METRICS.snapshot()["mdtpu_jobs_shed_total"]["values"]
    assert mets.get('class="background"', 0) >= 2
    assert mets.get('class="batch"', 0) >= 2
    # journaled terminal records: replay sees state "shed", and a
    # recovering batch process re-runs them (shed is NOT settled)
    replayed = _journal.replay(journal)
    for h in shed.values():
        assert replayed[h.job.fingerprint]["state"] == "shed"
    assert "shed" in _journal.TERMINAL_STATES
    assert "shed" not in _journal.SETTLED_STATES


def test_idle_workers_never_shed():
    """Depth alone is not overload: a deep queue with idle workers is
    about to be claimed, and shedding it would drop work the pool can
    absorb.  autostart=False == every worker idle — the submit-time
    and supervisor-tick shed passes must both be no-ops."""
    u = _u()
    sched = _sched(n_workers=2, autostart=False,
                   qos=QosPolicy(shed_queue_depth=1))
    handles = [sched.submit(RMSF(u.select_atoms("name CA")),
                            backend="serial", start=i,
                            coalesce=False, qos="background",
                            tenant=f"t{i}")
               for i in range(5)]
    assert sched._maybe_shed() == []
    assert not sched._overloaded_locked()
    assert all(h.state == JobState.QUEUED for h in handles)
    assert sched.telemetry.jobs_shed == 0
    # (once workers START and saturate, shedding the leftover
    # backlog IS the policy — pinned by the ladder test above)
    sched.shutdown(wait=False)


# ---------------------------------------------------------------------------
# runaway-job lease caps (the ROADMAP item-1 hazard)
# ---------------------------------------------------------------------------

def test_lease_renewal_cap_unit():
    clock_t = [0.0]
    table = _supervision.LeaseTable(clock=lambda: clock_t[0])

    class _H:
        _owner = None

    lease = table.grant([_H()], ttl=1.0, max_renewals=3)
    for _ in range(2):
        clock_t[0] += 0.5
        table.heartbeat("stage")
    assert lease.deadline == clock_t[0] + 1.0    # still renewing
    clock_t[0] += 0.5
    table.heartbeat("stage")                      # 3rd renewal: capped
    capped_deadline = lease.deadline
    clock_t[0] += 0.5
    table.heartbeat("stage")                      # no further renewal
    assert lease.deadline == capped_deadline
    assert lease.capped(clock_t[0])
    # max_runtime_s form: renewals stop once the hard deadline passes
    table.release(lease.worker)
    lease2 = table.grant([_H()], ttl=1.0, max_runtime_s=2.0)
    clock_t[0] += 1.5
    table.heartbeat("stage")
    assert lease2.deadline == clock_t[0] + 1.0
    clock_t[0] += 1.0                             # past hard deadline
    table.heartbeat("stage")
    assert lease2.deadline == clock_t[0] - 1.0 + 1.0
    assert lease2.capped(clock_t[0])


class _RunawayRMSF(RMSF):
    """Renews its lease forever: an infinite loop that keeps entering
    timed phases (the heartbeat channel) without ever finishing — the
    mis-submitted-live-stream shape the lease cap exists for."""

    stop_evt: threading.Event = None

    def _prepare(self):
        from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

        while not type(self).stop_evt.is_set():
            with TIMERS.phase("read"):
                time.sleep(0.01)
        super()._prepare()


def test_runaway_job_capped_typed_host_released_peers_unaffected():
    """A job that heartbeats forever holds its lease indefinitely
    without the cap.  With ``max_runtime_s`` the lease stops renewing,
    the reap fails the job TYPED (JobRuntimeExceeded — never a
    requeue), the fenced runaway thread aborts at its next phase
    entry, the pool respawns, and a queued peer completes
    untouched."""
    u = _u()
    _RunawayRMSF.stop_evt = threading.Event()
    sched = _sched(n_workers=1, lease_ttl_s=0.3, autostart=False,
                   qos=QosPolicy(max_runtime_s=0.6))
    runaway = sched.submit(_RunawayRMSF(u.select_atoms("name CA")),
                           backend="serial", qos="interactive",
                           priority=10, coalesce=False,
                           tenant="runaway")
    # a DISTINCT window: the claim collects same-coalesce-key peers
    # into one lease, and a peer sharing the runaway's lease shares
    # its cap (the lease is batch-granular by design)
    peer = sched.submit(RMSF(u.select_atoms("name CA")),
                        backend="serial", start=1, coalesce=False,
                        tenant="peer")
    sched.start()
    try:
        assert sched.drain(timeout=30), \
            "runaway pinned the pool: the cap never engaged"
    finally:
        _RunawayRMSF.stop_evt.set()
    sched.shutdown()
    assert runaway.state == JobState.FAILED
    assert isinstance(runaway.error, JobRuntimeExceeded)
    with pytest.raises(JobRuntimeExceeded):
        runaway.result()
    # the host (worker) was released: the peer ran to completion
    assert peer.error is None
    assert peer.state == JobState.DONE
    snap = sched.telemetry.snapshot()
    assert snap["lease_expired"] >= 1
    assert snap["jobs_requeued"] == 0       # typed failure, no retry
    mets = obs.METRICS.snapshot()["mdtpu_lease_expired_total"]["values"]
    assert mets.get('reason="runtime_capped"', 0) >= 1


# ---------------------------------------------------------------------------
# prefetch/shed interplay (satellite 2)
# ---------------------------------------------------------------------------

def test_prefetch_skips_jobs_the_overload_controller_will_shed(
        monkeypatch):
    """``prefetch_pending`` must not stage blocks for a sheddable-
    class job while the overload controller is engaged: the staging
    would be wasted work AND a never-evicted entry for a job that
    never runs.  The shed pass itself is held off (monkeypatched) so
    the test pins the prefetch decision, not the race winner."""
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache

    u = _u()
    cache = DeviceBlockCache(max_bytes=64 << 20)
    sched = _sched(autostart=False, supervise=False, cache=cache,
                   qos=QosPolicy(shed_queue_depth=0,
                                 shed_classes=("background",)))
    monkeypatch.setattr(sched, "_maybe_shed", lambda: [])
    batch_h = sched.submit(RMSF(u.select_atoms("name CA")),
                           backend="torch", executor_kwargs=CPU, batch_size=8,
                           coalesce=False, qos="batch", tenant="b")
    bg_h = sched.submit(RMSF(u.select_atoms("name CB")),
                        backend="torch", executor_kwargs=CPU, batch_size=8, start=1,
                        coalesce=False, qos="background",
                        tenant="g")
    # saturate the (unstarted) pool so the overload predicate holds
    sched._active = sched.n_workers
    assert sched._overloaded_locked()
    staged = sched.prefetch_pending()
    assert staged >= 1
    assert batch_h.prefetched is True       # unsheddable class staged
    assert bg_h.prefetched is False         # doomed class skipped
    assert sched.telemetry.prefetch_skipped_shed == 1
    # once the overload clears, the same job prefetches normally
    sched._active = 0
    assert not sched._overloaded_locked()
    sched.prefetch_pending()
    assert bg_h.prefetched is True
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert batch_h.error is None and bg_h.error is None


# ---------------------------------------------------------------------------
# per-class accounting + SLO attainment (satellite 3)
# ---------------------------------------------------------------------------

def test_per_class_deadline_and_latency_accounting():
    u = _u()
    sched = _sched(n_workers=1, autostart=False,
                   qos=QosPolicy(slo_targets_s={"interactive": 60.0}))
    # expire one interactive and two batch on the QUEUE deadline
    expired = [
        sched.submit(RMSF(u.select_atoms("name CA")),
                     backend="serial", start=i, coalesce=False,
                     qos=qos_cls, deadline_s=0.01,
                     tenant=f"e{i}")
        for i, qos_cls in enumerate(("interactive", "batch",
                                     "batch"))]
    ok = sched.submit(RMSF(u.select_atoms("name CA")),
                      backend="serial", start=9, coalesce=False,
                      qos="interactive", tenant="ok")
    time.sleep(0.05)                 # the queue deadlines pass
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert all(h.state == JobState.EXPIRED for h in expired)
    assert ok.state == JobState.DONE
    snap = sched.telemetry.snapshot()
    qos = snap["qos"]
    # deadline expiries broken out by class (was: one pooled counter)
    assert qos["interactive"]["expired"] == 1
    assert qos["batch"]["expired"] == 2
    assert qos["batch"]["completed"] == 0
    # per-class latency percentiles + SLO attainment for the survivor
    assert qos["interactive"]["completed"] == 1
    assert qos["interactive"]["p99_latency_s"] > 0
    assert qos["interactive"]["slo_target_s"] == 60.0
    assert qos["interactive"]["slo_attainment"] == 1.0
    gauge = obs.METRICS.snapshot()["mdtpu_slo_attainment"]["values"]
    assert gauge.get('class="interactive"') == 1.0


def test_batch_cli_qos_fields_policy_block_and_per_class_summary(
        tmp_path, capsys):
    """The job-file schema end to end: per-job ``qos`` fields, the
    top-level ``qos`` policy block (bounded submit → a typed
    ``rejected`` record), and the per-class breakdown in the output
    JSON's ``serving.qos``."""
    import json as _json

    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    u = _u()
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(_json.dumps({
        "defaults": {"backend": "serial", "select": "name CA"},
        "workers": 1,
        "qos": {"max_queue_depth": 2,
                "slo_targets_s": {"interactive": 120.0}},
        "jobs": [
            {"analysis": "rmsf", "tenant": "alice",
             "qos": "interactive"},
            {"analysis": "rmsd", "tenant": "bob", "start": 1,
             "coalesce": False},
            {"analysis": "rgyr", "tenant": "carol", "start": 2,
             "coalesce": False, "qos": "background"},
        ],
    }))
    rc = batch_main([str(jobs_file)], universe=u)
    out = _json.loads(capsys.readouterr().out.strip())
    assert rc == 1                        # one typed reject
    by_tenant = {r["tenant"]: r for r in out["jobs"]}
    assert by_tenant["alice"]["qos"] == "interactive"
    assert by_tenant["alice"]["state"] == "done"
    assert by_tenant["bob"]["qos"] == "batch"
    assert by_tenant["bob"]["state"] == "done"
    # the third submission hit the queue bound: typed, reasoned,
    # never queued — the other tenants finished untouched
    assert by_tenant["carol"]["state"] == "rejected"
    assert by_tenant["carol"]["reject_reason"] == "queue_full"
    assert out["serving"]["admission_rejects"] == 1
    qos = out["serving"]["qos"]
    assert qos["interactive"]["completed"] == 1
    assert qos["interactive"]["slo_target_s"] == 120.0
    assert qos["interactive"]["slo_attainment"] == 1.0
    assert qos["batch"]["completed"] == 1


# ---------------------------------------------------------------------------
# the job file's QoS validation
# ---------------------------------------------------------------------------

def test_unknown_qos_policy_or_class_fails_the_job_file(tmp_path,
                                                        capsys):
    import json as _json

    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    u = _u()
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(_json.dumps({
        "defaults": {"backend": "serial", "select": "name CA"},
        "jobs": [{"analysis": "rmsf", "qos": "interactiv"},
                 {"analysis": "rmsf", "tenant": "fine", "start": 1}],
    }))
    rc = batch_main([str(jobs_file)], universe=u)
    out = _json.loads(capsys.readouterr().out.strip())
    assert rc == 1
    states = {r["tenant"]: r["state"] for r in out["jobs"]}
    assert states["fine"] == "done"
    assert states["default"] == "failed"
    bad = next(r for r in out["jobs"] if r["state"] == "failed")
    assert "unknown QoS class" in bad["error"]


# ---------------------------------------------------------------------------
# the fleet controller's shed ladder
# ---------------------------------------------------------------------------

#: the fleet hosts' environment: one intra-op thread each
FLEET_ENV = {"OMP_NUM_THREADS": "1"}


def test_fleet_shed_requires_capacity_not_just_depth(tmp_path):
    """Depth from ABSENT capacity is not overload: a burst submitted
    before any host joins must PARK, never permanently shed jobs an
    about-to-join host could absorb."""
    from mdanalysis_mpi_tpu_torch.service.fleet import QUEUED as FQUEUED
    from mdanalysis_mpi_tpu_torch.service.fleet import FleetController

    fixture = {"kind": "protein", "n_residues": 6, "n_frames": 8,
               "noise": 0.2, "seed": 2}
    with FleetController(tmp_path, host_ttl_s=5.0, host_slots=1,
                         qos=QosPolicy(shed_queue_depth=5),
                         device="cpu") as ctrl:
        jobs = [ctrl.submit({"analysis": "rmsf", "fixture": fixture,
                             "tenant": f"t{i}",
                             "qos": "background"})
                for i in range(6)]
        assert ctrl._shed_pending() == []
        # a few supervisor ticks (50 ms each) find nothing to shed
        deadline = time.monotonic() + 0.2
        while time.monotonic() < deadline:
            assert ctrl.telemetry.jobs_shed == 0
            time.sleep(0.02)
        assert all(j.state == FQUEUED for j in jobs)
        ctrl.spawn_host(hb_interval_s=0.1, env=FLEET_ENV)
        assert ctrl.drain(timeout=120.0)
        assert all(j.state == "done" for j in jobs)
        assert ctrl.telemetry.jobs_shed == 0


@pytest.mark.reliability
def test_overload_burst_during_host_kill_sheds_migrates_exactly_once(
        tmp_path):
    """A multi-class burst past the shed depth AND a host ``kill -9``
    in one wave: only background sheds (typed, journaled, counted),
    the dead host's work migrates exactly once, every interactive and
    batch tenant matches the serial oracle, and the autoscaler
    journals the scale-up the backlog forced."""
    import numpy as np

    from mdanalysis_mpi_tpu_torch.service import fleet as _fleet
    from mdanalysis_mpi_tpu_torch.service.fleet import (
        DONE, SHED, FleetController,
    )
    from mdanalysis_mpi_tpu_torch.service.journal import replay_fleet

    fixture = {"kind": "protein", "n_residues": 10, "n_frames": 12,
               "noise": 0.25, "seed": 5}
    spawn = {"hb_interval_s": 0.1,
             "env": {"MDTPU_FLEET_RUN_DELAY": "0.5", **FLEET_ENV}}
    policy = QosPolicy(shed_queue_depth=3,
                       shed_classes=("background",))
    with FleetController(tmp_path, host_ttl_s=2.0, host_slots=1,
                         qos=policy, autoscale=True, min_hosts=1,
                         max_hosts=3, scale_up_backlog=2,
                         scale_down_idle_s=30.0,
                         scale_cooldown_s=0.2,
                         autoscale_spawn=spawn, device="cpu") as ctrl:
        for _ in range(2):
            ctrl.spawn_host(**spawn)
        assert ctrl.wait_hosts(2, timeout=60.0)
        interactive = [ctrl.submit({"analysis": "rmsf",
                                    "fixture": fixture,
                                    "tenant": f"i{n}",
                                    "qos": "interactive"})
                       for n in range(3)]
        batch = [ctrl.submit({"analysis": "rmsf",
                              "fixture": fixture,
                              "tenant": f"b{n}", "qos": "batch"})
                 for n in range(3)]
        background = [ctrl.submit({"analysis": "rmsf",
                                   "fixture": fixture,
                                   "tenant": f"g{n}",
                                   "qos": "background"})
                      for n in range(4)]
        victim = sorted(ctrl.placement.hosts())[0]
        assert ctrl.kill_host(victim)
        assert ctrl.drain(timeout=120.0), "drain timed out"
        stats = ctrl.stats()
        snap = ctrl.telemetry.snapshot()
    shed = [j for j in background if j.state == SHED]
    assert shed, "the burst never tripped the shed ladder"
    assert all("shed by the overload controller" in j.error
               for j in shed)
    assert all(j.state == DONE for j in interactive + batch), \
        [(j.fp, j.state, j.error) for j in interactive + batch
         if j.state != DONE]
    assert snap["jobs_shed"] == len(shed)
    assert stats["hosts_lost"] == 1
    assert snap["hosts_scaled_up"] >= 1
    meta = replay_fleet(os.path.join(str(tmp_path),
                                     _fleet.JOURNAL_NAME))
    for j in interactive + batch:
        assert meta["finishes"].get(j.fp) == 1, j.fp
        assert meta["jobs"][j.fp]["state"] == "done"
    for j in shed:
        assert meta["finishes"].get(j.fp) == 1, j.fp
        assert meta["jobs"][j.fp]["state"] == "shed"
    assert [r["ev"] for r in meta["scale_events"]].count(
        "scale_up") >= 1
    kwargs = {k: v for k, v in fixture.items() if k != "kind"}
    u = make_protein_universe(**kwargs)
    oracle = RMSF(u.select_atoms("protein and name CA")).run(
        backend="serial").results.rmsf
    for j in interactive + batch:
        np.testing.assert_allclose(j.result_arrays()["rmsf"],
                                   oracle, atol=1e-6)
