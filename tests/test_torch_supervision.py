"""The port's twin of ``tests/test_supervision.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Serving supervision chaos suite (docs/RELIABILITY.md).

The scheduler-layer counterpart of test_reliability.py: worker-thread
death mid-batch, a dispatch hung past its lease TTL, a poison job
alongside healthy tenants, breaker trip → half-open → recovery, and
journal recovery after ``kill -9`` — every scenario proved against the
same differential standard as everywhere else (a supervised job's
results must match an uninterrupted solo run).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest


from mdanalysis_mpi_tpu_torch.analysis import RMSF  # noqa: E402
from mdanalysis_mpi_tpu_torch.reliability import breaker, faults  # noqa: E402
from mdanalysis_mpi_tpu_torch.service import (  # noqa: E402
    AnalysisJob, JobQuarantinedError, JobState, Scheduler,
    SchedulerShutdownError,
)
from mdanalysis_mpi_tpu_torch.service.journal import JobJournal, replay  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

#: the device route on the CPU (the port runs on the card by default)
CPU = {"device": "cpu"}

pytestmark = pytest.mark.reliability

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u(n_frames=24, seed=9):
    return make_protein_universe(n_residues=30, n_frames=n_frames,
                                 noise=0.3, seed=seed)


def _sched(**kw):
    """Scheduler with test-speed supervision: default TTL stays long
    (worker DEATH reaps by thread liveness, not TTL) but the reap loop
    polls fast."""
    kw.setdefault("supervision_interval_s", 0.02)
    return Scheduler(**kw)


class PoisonAnalysis(RMSF):
    """A poison tenant: kills whatever worker thread claims it, the
    way a segfaulting extension or an OOM kill would — a BaseException
    no run-layer envelope catches."""

    def _prepare(self):
        raise faults.InjectedWorkerDeath("poison tenant took the "
                                         "worker with it")


# ---- worker death mid-batch ----


def test_worker_death_mid_batch_requeues_and_respawns():
    """An injected worker death right after a claim strands the batch;
    the supervisor must reap the dead thread's lease immediately,
    requeue the jobs, respawn the worker, and every job must still
    complete with results matching its solo oracle."""
    u = _u(n_frames=32)
    oracles = {stop: RMSF(u.select_atoms("name CA")).run(
        backend="serial", stop=stop).results.rmsf
        for stop in (16, 24, 32)}
    with faults.inject(faults.FaultSpec("worker", "raise", times=1)):
        sched = _sched(n_workers=2, autostart=False)
        handles = {stop: sched.submit(RMSF(u.select_atoms("name CA")),
                                      backend="serial", stop=stop)
                   for stop in (16, 24, 32)}
        sched.start()
        assert sched.drain(timeout=60)
        sched.shutdown()
    t = sched.telemetry
    assert t.completed == 3 and t.failed == 0 and t.quarantined == 0
    assert t.lease_expired >= 1        # the dead thread's lease reaped
    assert t.jobs_requeued >= 1
    assert t.workers_respawned >= 1    # pool capacity restored
    for stop, h in handles.items():
        assert h.error is None, h.error
        np.testing.assert_allclose(
            np.asarray(h.result().results.rmsf), oracles[stop],
            atol=1e-5)
    # the stranded jobs carry their incident in the fault log
    assert any(h._faults == 1 for h in handles.values())


# ---- hung dispatch past the lease TTL ----


def test_hung_dispatch_past_ttl_fenced_requeued_and_wait_clock_reset():
    """A dispatch stalled past the lease TTL: the supervisor reaps the
    lease and FENCES the wedged worker; when the stall ends, the
    zombie's next phase entry aborts it (WorkerFenced), the job re-runs
    on a respawned worker, and the result still matches the oracle.
    The requeued attempt's queue wait measures from the requeue — not
    from submission (which would book the dead attempt's stall as
    queue-wait and skew the serving p50/p99)."""
    u = _u()
    sel = u.select_atoms("name CA")
    oracle = RMSF(sel).run(backend="serial").results.rmsf
    # prewarm the jit programs: a first-contact compile inside one
    # dispatch phase would outlast the short TTL below on its own
    RMSF(u.select_atoms("name CA")).run(backend="torch", device="cpu", batch_size=8)

    # stall 1.5x the TTL: reaped (and fenced) at ~1x, wakes inside the
    # fence-grace window (reap + 1 TTL), dies at its next phase entry
    with faults.inject(faults.FaultSpec("kernel", "stall", times=1,
                                        stall_s=1.5)):
        sched = _sched(n_workers=1, lease_ttl_s=1.0, autostart=False)
        h = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                         batch_size=8)
        sched.start()
        assert sched.drain(timeout=60)
        sched.shutdown()
    t = sched.telemetry
    assert h.error is None, h.error
    assert t.lease_expired == 1 and t.jobs_requeued == 1
    assert t.completed == 1            # resolved exactly once (the
    #                                    zombie's late completion was
    #                                    discarded by the lease token)
    assert h._faults == 1 and h._solo_only
    np.testing.assert_allclose(np.asarray(h.result().results.rmsf),
                               oracle, atol=1e-4)
    # requeue satellite: wait measured from the requeue, so the 1.5 s
    # dead attempt is not booked as queue wait
    assert h.requeued_t is not None
    assert h.queue_wait_s is not None and h.queue_wait_s < 1.0


def test_heartbeats_keep_slow_but_healthy_run_alive():
    """A stall SHORTER than the TTL (a slow phase, not a hang): the
    phase-entry heartbeats renew the lease and the supervisor must not
    reap it."""
    u = _u()
    RMSF(u.select_atoms("name CA")).run(backend="torch", device="cpu", batch_size=8)
    with faults.inject(faults.FaultSpec("kernel", "stall", times=None,
                                        stall_s=0.2)):
        sched = _sched(n_workers=1, lease_ttl_s=1.0, autostart=False)
        h = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                         batch_size=8)
        sched.start()
        assert sched.drain(timeout=60)
        sched.shutdown()
    assert h.error is None
    assert sched.telemetry.lease_expired == 0
    assert sched.telemetry.jobs_requeued == 0


# ---- poison-job quarantine ----


def test_poison_job_quarantined_healthy_peers_bit_identical(tmp_path):
    """A poison job that kills every worker claiming it must be
    quarantined after poison_threshold incidents (with diagnostics)
    instead of bleeding the pool forever; its coalesced peers re-run
    solo and finish bit-identically to their solo runs."""
    u = _u()
    solo_ca = RMSF(u.select_atoms("name CA")).run(
        backend="serial").results.rmsf
    solo_cb = RMSF(u.select_atoms("name CB")).run(
        backend="serial").results.rmsf
    jpath = str(tmp_path / "journal.jsonl")
    sched = _sched(n_workers=2, poison_threshold=2, autostart=False,
                   journal=jpath)
    # same coalesce key (window/backend): the poison job merges into
    # its peers' pass — and must not sink it twice
    h_poison = sched.submit(AnalysisJob(
        PoisonAnalysis(u.select_atoms("name CA")), backend="serial",
        tenant="poison", fingerprint="poison"))
    h_ca = sched.submit(RMSF(u.select_atoms("name CA")),
                        backend="serial", tenant="good-ca")
    h_cb = sched.submit(RMSF(u.select_atoms("name CB")),
                        backend="serial", tenant="good-cb")
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()

    # healthy tenants: solo re-runs, bit-identical to solo oracles
    assert h_ca.error is None and h_cb.error is None
    assert np.array_equal(np.asarray(h_ca.result().results.rmsf),
                          solo_ca)
    assert np.array_equal(np.asarray(h_cb.result().results.rmsf),
                          solo_cb)

    # the poison tenant: quarantined with its captured diagnostics
    assert h_poison.state == JobState.QUARANTINED
    with pytest.raises(JobQuarantinedError) as ei:
        h_poison.result(timeout=1)
    diag = ei.value.diagnostics
    assert diag["fault_count"] == 2
    assert diag["reason"] == "worker_death"
    assert len(diag["incidents"]) == 2
    assert "InjectedWorkerDeath" in diag["incidents"][-1]["error"]
    assert "poison tenant" in diag["incidents"][-1]["traceback"]
    assert sched.quarantined == [h_poison]
    t = sched.telemetry
    assert t.quarantined == 1 and t.completed == 2
    assert t.workers_respawned >= 2

    # the quarantine landed durably in the journal
    states = replay(jpath)
    assert states["poison"]["state"] == "quarantined"
    rec = Scheduler.recover(jpath)
    assert rec["quarantined"] == {"poison"}
    assert "poison" not in rec["pending"]


# ---- the ISSUE acceptance chaos proof ----


def test_chaos_four_workers_one_death_one_poison_exactly_once(tmp_path):
    """Acceptance: 4 workers, one worker killed mid-batch (injected
    death on the first claim) and one poison job in the mix — every
    non-poison job completes exactly once with results matching the
    uninterrupted serial oracle, and the poison job is quarantined
    with diagnostics."""
    u = _u(n_frames=32)
    stops = (12, 16, 20, 24, 28, 32)
    oracles = {stop: RMSF(u.select_atoms("name CA")).run(
        backend="serial", stop=stop).results.rmsf for stop in stops}
    jpath = str(tmp_path / "journal.jsonl")
    with faults.inject(faults.FaultSpec("worker", "raise", times=1)):
        sched = _sched(n_workers=4, autostart=False, journal=jpath)
        handles = {}
        for stop in stops:
            handles[stop] = sched.submit(AnalysisJob(
                RMSF(u.select_atoms("name CA")), backend="serial",
                stop=stop, coalesce=False, tenant=f"t{stop}",
                fingerprint=f"healthy-{stop}"))
        h_poison = sched.submit(AnalysisJob(
            PoisonAnalysis(u.select_atoms("name CA")),
            backend="serial", coalesce=False, tenant="poison",
            fingerprint="poison"))
        sched.start()
        assert sched.drain(timeout=120)
        sched.shutdown()

    for stop, h in handles.items():
        assert h.error is None, (stop, h.error)
        assert h.state == JobState.DONE
        np.testing.assert_allclose(
            np.asarray(h.result().results.rmsf), oracles[stop],
            atol=1e-5)
    assert h_poison.state == JobState.QUARANTINED
    assert isinstance(h_poison.error, JobQuarantinedError)
    assert h_poison.error.diagnostics["incidents"]

    t = sched.telemetry
    assert t.completed == len(stops)       # exactly once each
    assert t.quarantined == 1 and t.failed == 0
    assert t.lease_expired >= 3            # 1 injected + 2 poison kills
    assert t.workers_respawned >= 3

    # journal-level exactly-once: ONE terminal record per job
    with open(jpath) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    finishes = {}
    for r in recs:
        if r["ev"] in ("finish", "quarantine"):
            finishes[r["fp"]] = finishes.get(r["fp"], 0) + 1
    assert finishes == {f"healthy-{stop}": 1 for stop in stops} | {
        "poison": 1}


# ---- circuit breakers ----


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_breaker_trip_halfopen_probe_recovery_unit():
    clock = _FakeClock()
    br = breaker.CircuitBreaker(("torch", None), threshold=3,
                                cooldown_s=5.0, clock=clock)
    assert br.state == breaker.CLOSED and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == breaker.CLOSED     # below threshold
    br.record_failure()
    assert br.state == breaker.OPEN and not br.allow()
    assert br.trips == 1
    # cooldown not yet spent: still open, probe refused
    clock.t += 4.9
    assert br.state == breaker.OPEN
    assert br.probe(lambda: None) is False
    # past cooldown: half-open; a failing probe re-opens
    clock.t += 0.2
    assert br.state == breaker.HALF_OPEN
    assert br.probe(lambda: (_ for _ in ()).throw(
        faults.DeviceLossError("still dead"))) is False
    assert br.state == breaker.OPEN
    # next half-open probe succeeds: closed, traffic restored
    clock.t += 5.1
    assert br.probe(lambda: None) is True
    assert br.state == breaker.CLOSED and br.allow()
    assert br.probes == 2
    # transitions are mirrored into the pinned obs gauge
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    snap = METRICS.snapshot()
    assert "mdtpu_breaker_state" in snap
    assert snap["mdtpu_breaker_state"]["values"]['backend="torch"'] == 0
    assert "mdtpu_breaker_transitions_total" in snap


def test_breaker_probe_reraises_fencing_base_exceptions():
    """`mdtpu lint` MDT003 regression: a half-open probe that dies on
    BaseException-based control flow (a WorkerFenced fence firing at a
    phase entry inside the probe fn, an injected worker death) must
    record the failure AND keep unwinding the worker thread — the old
    blanket `except BaseException: return False` swallowed the fence,
    so a reaped zombie kept running its loop instead of exiting."""
    from mdanalysis_mpi_tpu_torch.service.supervision import WorkerFenced

    clock = _FakeClock()
    br = breaker.CircuitBreaker(("torch", None), threshold=1,
                                cooldown_s=1.0, clock=clock)
    br.record_failure()
    clock.t += 1.1
    assert br.state == breaker.HALF_OPEN
    with pytest.raises(WorkerFenced):
        br.probe(lambda: (_ for _ in ()).throw(
            WorkerFenced("reaped mid-probe")))
    # the failed attempt still re-opened the breaker on its way out
    assert br.state == breaker.OPEN
    # ordinary Exceptions keep the old contract: swallowed, False
    clock.t += 1.1
    assert br.state == breaker.HALF_OPEN
    assert br.probe(lambda: (_ for _ in ()).throw(
        faults.DeviceLossError("still dead"))) is False
    assert br.state == breaker.OPEN


def test_breaker_routes_claims_off_tripped_backend_then_recovers():
    """K consecutive dispatch faults trip the torch breaker; while open,
    new claims route DOWN to serial (and still complete); after the
    cooldown a half-open probe restores torch traffic."""
    u = _u()
    oracle = RMSF(u.select_atoms("name CA")).run(
        backend="serial").results.rmsf
    clock = _FakeClock()
    board = breaker.BreakerBoard(threshold=2, cooldown_s=30.0,
                                 clock=clock)
    sched = _sched(n_workers=1, breakers=board)
    # two jobs against a persistently faulting kernel: both fail,
    # consecutive degradable faults trip the breaker
    with faults.inject(faults.FaultSpec("kernel", "raise", times=None)):
        h1 = sched.submit(RMSF(u.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8, stop=16)
        h2 = sched.submit(RMSF(u.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8, stop=24)
        assert sched.drain(timeout=60)
    assert h1.error is not None and h2.error is not None
    assert board.get("torch").state == breaker.OPEN

    # while open: a new torch claim is REROUTED to serial and succeeds
    # without touching the dead backend (the kernel fault is disarmed,
    # but a dispatch against torch would also have been a fresh compile
    # of a healthy backend — the reroute is what we assert)
    h3 = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                      batch_size=8)
    assert sched.drain(timeout=60)
    assert h3.error is None
    assert sched.telemetry.breaker_reroutes >= 1
    np.testing.assert_allclose(np.asarray(h3.result().results.rmsf),
                               oracle, atol=1e-4)
    assert board.get("torch").state == breaker.OPEN    # no success credit

    # past the cooldown: the next claim probes half-open, the probe
    # succeeds, the breaker closes, and the job runs on torch again
    clock.t += 31.0
    reroutes = sched.telemetry.breaker_reroutes
    h4 = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                      batch_size=8)
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert h4.error is None
    assert board.get("torch").state == breaker.CLOSED
    assert board.get("torch").probes == 1
    assert sched.telemetry.breaker_reroutes == reroutes   # no reroute
    np.testing.assert_allclose(np.asarray(h4.result().results.rmsf),
                               oracle, atol=1e-4)


def test_breaker_probe_failure_keeps_backend_out_of_rotation():
    """A half-open probe that fails re-opens the breaker and the claim
    keeps routing down — tenant traffic never rides a dead probe."""
    u = _u()
    clock = _FakeClock()
    board = breaker.BreakerBoard(threshold=1, cooldown_s=10.0,
                                 clock=clock)
    sched = _sched(n_workers=1, breakers=board)
    with faults.inject(faults.FaultSpec("kernel", "raise", times=None)):
        h1 = sched.submit(RMSF(u.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8)
        assert sched.drain(timeout=60)
    assert board.get("torch").state == breaker.OPEN
    clock.t += 11.0
    # the half-open probe itself fails (injected at the probe site):
    # breaker re-opens, job reroutes to serial and still completes
    with faults.inject(faults.FaultSpec("probe", "raise", times=None)):
        h2 = sched.submit(RMSF(u.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8)
        assert sched.drain(timeout=60)
    sched.shutdown()
    assert h1.error is not None
    assert h2.error is None
    assert board.get("torch").state == breaker.OPEN
    assert sched.telemetry.breaker_reroutes >= 1


# ---- journal + recovery ----


def test_journal_replay_states_and_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with JobJournal(path, fsync_batch=4) as j:
        j.record("submit", "a")
        j.record("submit", "b")
        j.record("claim", "a", worker="w0")
        j.record("finish", "a", state="done", durable=True)
        j.record("claim", "b", worker="w0")
        j.record("submit", "c")
    # torn final line — the write a crash interrupted
    with open(path, "a") as f:
        f.write('{"ev": "finish", "fp": "b", "sta')
    states = replay(path)
    assert states["a"]["state"] == "done"
    assert states["b"]["state"] == "claimed"    # mid-run at the crash
    assert states["c"]["state"] == "queued"
    rec = Scheduler.recover(path)
    assert rec["done"] == {"a"}
    assert sorted(rec["pending"]) == ["b", "c"]


def test_journal_resubmit_after_abort_is_runnable_again(tmp_path):
    """An aborted job (^C drain) must be resubmittable: the re-run's
    submit record flips its replayed state back to queued, while done/
    quarantined stay settled forever."""
    path = str(tmp_path / "j.jsonl")
    with JobJournal(path) as j:
        j.record("submit", "a")
        j.record("finish", "a", state="aborted", durable=True)
        j.record("submit", "d")
        j.record("finish", "d", state="done", durable=True)
        j.record("submit", "a")            # the restart resubmits a
        j.record("submit", "d")            # ...and d (skipped by CLI,
        #                                    but a submit must not
        #                                    resurrect a settled job)
    states = replay(path)
    assert states["a"]["state"] == "queued"
    assert states["d"]["state"] == "done"


def test_scheduler_journal_end_to_end(tmp_path):
    """A live scheduler with journal= logs every lifecycle transition;
    recover() classifies finished vs pending."""
    u = _u()

    class Exploding(RMSF):
        def _prepare(self):
            raise RuntimeError("boom")

    jpath = str(tmp_path / "j.jsonl")
    sched = _sched(n_workers=1, autostart=False, journal=jpath)
    h_ok = sched.submit(AnalysisJob(RMSF(u.select_atoms("name CA")),
                                    backend="serial",
                                    fingerprint="ok"))
    h_bad = sched.submit(AnalysisJob(Exploding(u.select_atoms("name CB")),
                                     backend="serial", coalesce=False,
                                     fingerprint="bad"))
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert h_ok.error is None and h_bad.error is not None
    states = replay(jpath)
    assert states["ok"]["state"] == "done"
    assert states["ok"]["claims"] >= 1
    assert states["bad"]["state"] == "failed"
    rec = Scheduler.recover(jpath)
    assert rec["done"] == {"ok"} and rec["pending"] == []


# ---- satellite: shutdown(wait=False) fails queued handles ----


def test_shutdown_nowait_fails_unclaimed_handles_typed():
    u = _u()
    sched = _sched(n_workers=1, autostart=False)
    h1 = sched.submit(RMSF(u.select_atoms("name CA")), backend="serial")
    h2 = sched.submit(RMSF(u.select_atoms("name CB")), backend="serial")
    sched.shutdown(wait=False)
    for h in (h1, h2):
        assert h.state == JobState.ABORTED
        with pytest.raises(SchedulerShutdownError, match="never run"):
            h.result(timeout=1)       # resolves instead of hanging
    assert sched.telemetry.aborted == 2
    assert sched.telemetry.queue_depth == 0


def test_shutdown_nowait_inflight_unit_still_finishes():
    """shutdown(wait=False) must not tear the heartbeat channel down
    under an in-flight worker: abort_queued's contract says in-flight
    units are left to finish, so a claimed run that outlasts the lease
    TTL (but heartbeats healthily) must complete with its result — not
    get reaped, fenced, and stranded by a teardown that removed the
    phase hook while the worker was mid-run."""
    u = _u()
    oracle = RMSF(u.select_atoms("name CA")).run(
        backend="torch", device="cpu", batch_size=8).results.rmsf
    # every dispatch stalls 0.45 s: healthy-slow (each phase well
    # under the 1 s TTL) but the whole run (3 blocks at scan_k=1 —
    # no device cache) outlasts the TTL, so only live heartbeats keep
    # the lease from expiring after shutdown returns
    with faults.inject(faults.FaultSpec("kernel", "stall", times=None,
                                        stall_s=0.45)):
        sched = _sched(n_workers=1, lease_ttl_s=1.0, autostart=False)
        h = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                         batch_size=8)
        sched.start()
        deadline = time.monotonic() + 30
        while h.started_t is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h.started_t is not None     # claimed, worker mid-run
        sched.shutdown(wait=False)
        assert h.result(timeout=60) is not None
    assert h.error is None
    assert h.state == JobState.DONE
    assert sched.telemetry.lease_expired == 0
    assert sched.telemetry.jobs_requeued == 0
    np.testing.assert_allclose(np.asarray(h.result().results.rmsf),
                               oracle, atol=1e-5)


# ---- CLI: signal drain + crash-restart recovery ----


def _write_fixture(tmp_path, n_frames=900):
    """GRO + XTC fixture for the subprocess CLI tests."""
    from mdanalysis_mpi_tpu_torch.io.gro import write_gro
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc

    u = _u(n_frames=n_frames)
    frames = np.stack([np.asarray(ts.positions)
                       for ts in u.trajectory])
    gro = str(tmp_path / "top.gro")
    xtc = str(tmp_path / "traj.xtc")
    write_gro(gro, u.topology, frames[0])
    dims = np.array([200.0, 200.0, 200.0, 90.0, 90.0, 90.0])
    write_xtc(xtc, frames, dimensions=dims,
              times=np.arange(n_frames, dtype=np.float32),
              steps=np.arange(n_frames, dtype=np.int32))
    return gro, xtc


def test_cli_sigterm_drains_and_emits_full_summary(tmp_path, capsys):
    """SIGTERM mid-batch: in-flight units drain, queued jobs abort
    with a typed record, and the JSON summary line is still complete —
    not a half-written report."""
    u = _u(n_frames=120)
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps({
        "defaults": {"backend": "serial", "select": "name CA"},
        "workers": 1,
        "jobs": [{"analysis": "rmsf", "stop": 100 + 2 * i,
                  "coalesce": False, "tenant": f"t{i}"}
                 for i in range(6)],
    }))
    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    killer = threading.Timer(
        0.3, lambda: os.kill(os.getpid(), signal.SIGTERM))
    killer.start()
    try:
        # a 5 ms stall per serial frame read makes each job ~0.5 s
        # regardless of host speed: the SIGTERM lands mid-batch
        # deterministically
        with faults.inject(faults.FaultSpec("read", "stall", times=None,
                                            stall_s=0.005)):
            rc = batch_main([str(jobs_file)], universe=u)
    finally:
        killer.cancel()
    out = json.loads(capsys.readouterr().out.strip())
    assert out["interrupted"] is True
    states = [r["state"] for r in out["jobs"]]
    assert len(states) == 6
    assert set(states) <= {"done", "aborted"}
    assert states.count("aborted") >= 1           # the drained queue
    assert rc == 1                                # aborted jobs -> rc 1
    aborted = [r for r in out["jobs"] if r["state"] == "aborted"]
    assert all("SchedulerShutdownError" in r["error"] for r in aborted)
    assert out["serving"]["jobs_aborted"] == len(aborted)


def test_cli_kill9_journal_restart_completes_queue(tmp_path):
    """The acceptance crash proof: ``batch --journal`` killed with
    ``kill -9`` mid-queue, restarted with the same command, finishes
    the remaining jobs — every job completes exactly once (one
    terminal journal record each) and every output matches the
    uninterrupted oracle."""
    gro, xtc = _write_fixture(tmp_path)
    stops = (500, 600, 700, 800, 900)
    jobs = [{"analysis": "rmsf", "stop": stop, "tenant": f"t{stop}",
             "coalesce": False,
             "output": str(tmp_path / f"out_{stop}.npz")}
            for stop in stops]
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps({
        "topology": gro, "trajectory": xtc,
        "defaults": {"backend": "serial", "select": "name CA"},
        "workers": 1, "jobs": jobs,
    }))
    jpath = str(tmp_path / "journal.jsonl")
    cmd = [sys.executable, "-m", "mdanalysis_mpi_tpu_torch", "batch",
           str(jobs_file), "--journal", jpath]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)

    proc = subprocess.Popen(cmd, cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        # kill -9 as soon as the journal shows the first durable
        # finish: at least one job is settled, the rest are queued or
        # mid-claim
        deadline = time.monotonic() + 120
        finished_before_kill = 0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                pytest.fail("batch finished before the kill landed: "
                            + proc.stderr.read().decode()[-2000:])
            try:
                with open(jpath) as f:
                    finished_before_kill = sum(
                        1 for ln in f if '"ev": "finish"' in ln)
            except OSError:
                pass
            if finished_before_kill:
                break
            time.sleep(0.05)
        assert finished_before_kill >= 1, "no job finished within 120s"
        proc.kill()                      # SIGKILL: no cleanup, no drain
        proc.communicate()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    # restart with the SAME command: replays the journal, skips the
    # settled jobs, runs the rest to completion
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    rec = json.loads(out.stdout.decode().strip().splitlines()[-1])
    # >=: a job may have finished between the last poll and the kill
    assert (finished_before_kill <= rec["recovered_skipped"]
            < len(stops))
    assert len(rec["jobs"]) == len(stops)
    assert all(r["state"] == "done" for r in rec["jobs"])

    # exactly-once at the journal level: one terminal record per job
    with open(jpath) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()
                and ln.strip().startswith("{")]
    finishes = {}
    for r in recs:
        if r.get("ev") == "finish":
            finishes[r["fp"]] = finishes.get(r["fp"], 0) + 1
    assert len(finishes) == len(stops)
    assert all(n == 1 for n in finishes.values()), finishes

    # ...and at the results level: every output matches the
    # uninterrupted serial oracle
    from mdanalysis_mpi_tpu_torch import Universe

    u = Universe(gro, xtc)
    for stop in stops:
        oracle = RMSF(u.select_atoms("name CA")).run(
            backend="serial", stop=stop).results.rmsf
        with np.load(tmp_path / f"out_{stop}.npz") as z:
            np.testing.assert_allclose(z["rmsf"], oracle, atol=1e-4)


def test_quarantine_attaches_flight_recorder_dump(tmp_path):
    """ISSUE 13 flight recorder: a quarantined job's diagnostics
    carry the path of an atomically written black-box dump (recent
    events + metrics snapshot), and the dump is counted per
    trigger."""
    from mdanalysis_mpi_tpu_torch import obs

    u = _u()
    sched = _sched(n_workers=1, poison_threshold=1, autostart=False,
                   flight_dir=str(tmp_path))
    h = sched.submit(AnalysisJob(
        PoisonAnalysis(u.select_atoms("name CA")), backend="serial",
        tenant="poison", fingerprint="poison-flight"))
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()

    assert h.state == JobState.QUARANTINED
    with pytest.raises(JobQuarantinedError) as ei:
        h.result(timeout=1)
    path = ei.value.diagnostics.get("flight_recorder")
    assert path and os.path.exists(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["trigger"] == "quarantine"
    assert doc["extra"]["tenant"] == "poison"
    assert doc["extra"]["fingerprint"] == "poison-flight"
    # the dump embeds the full pinned-schema metrics snapshot
    assert doc["metrics"]["mdtpu_jobs_quarantined_total"]
    snap = obs.METRICS.snapshot()["mdtpu_flight_dumps_total"]
    assert snap["values"].get('trigger="quarantine"', 0) >= 1
