"""The port's twin of ``tests/test_service.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Multi-tenant serving layer (service/ subsystem).

Differential strategy as everywhere: a job served through the
scheduler — coalesced, admitted, degraded, or retried — must produce
the same results as a direct solo ``run()``.  The coalescing proof
(ISSUE acceptance): K jobs over the same trajectory complete with
exactly ONE staging pass, counters asserted at both the phase-timer
and the reader-read level.
"""

import json
import threading

import numpy as np
import pytest


from mdanalysis_mpi_tpu_torch.analysis import (  # noqa: E402
    AlignedRMSF, AverageStructure, RMSD, RMSF, RadiusOfGyration,
    UncoalescableAnalysisError,
)
from mdanalysis_mpi_tpu_torch.io.base import BlockCache  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    DeviceBlockCache,
)
from mdanalysis_mpi_tpu_torch.reliability import faults  # noqa: E402
from mdanalysis_mpi_tpu_torch.reliability.policy import (  # noqa: E402
    ReliabilityPolicy,
)
from mdanalysis_mpi_tpu_torch.service import (  # noqa: E402
    AnalysisJob, JobDeadlineExpired, JobState, Scheduler,
    ServiceTelemetry,
)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS  # noqa: E402

#: the device route on the CPU (the port runs on the card by default)
CPU = {"device": "cpu"}

pytestmark = pytest.mark.service


def _u(n_frames=24, seed=9):
    return make_protein_universe(n_residues=30, n_frames=n_frames,
                                 noise=0.3, seed=seed)


# ---- the coalescing proof (ISSUE acceptance) ----


def test_coalescing_one_staging_pass_matches_solo_oracles(monkeypatch):
    """K jobs over the same trajectory cost ONE staged pass — block
    reads and stage-phase entries equal a single run's — and every
    job's results match its own solo serial-oracle run (f32 tol)."""
    u = _u()
    oracle_rmsf_ca = RMSF(u.select_atoms("name CA")).run(backend="serial")
    oracle_rmsf_cb = RMSF(u.select_atoms("name CB")).run(backend="serial")
    oracle_avg = AverageStructure(u, select="name CA",
                                  select_only=True).run(backend="serial")

    reads = []
    cls = type(u.trajectory)
    for name in ("read_block", "stage_cached"):
        orig = getattr(cls, name, None)
        if orig is None:
            continue

        def traced(self, *a, _orig=orig, **k):
            reads.append(a[:2])
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, name, traced)

    # reference: ONE solo batch run's read/stage counts
    RMSF(u.select_atoms("name CA")).run(backend="torch", device="cpu", batch_size=8)
    reads_solo = len(reads)
    stage_solo = None

    sched = Scheduler(n_workers=1, autostart=False)
    handles = [
        sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                     batch_size=8, tenant="t1"),
        sched.submit(RMSF(u.select_atoms("name CB")), backend="torch", executor_kwargs=CPU,
                     batch_size=8, tenant="t2"),
        sched.submit(AverageStructure(u, select="name CA",
                                      select_only=True), backend="torch", executor_kwargs=CPU,
                     batch_size=8, tenant="t3"),
    ]
    reads.clear()
    stage0 = TIMERS.calls("stage")
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    stage_calls = TIMERS.calls("stage") - stage0

    # exactly one staging pass for all K jobs, at both counters
    assert len(reads) == reads_solo > 0
    assert stage_calls == reads_solo

    for h in handles:
        assert h.error is None and h.coalesced
    np.testing.assert_allclose(
        np.asarray(handles[0].result().results.rmsf),
        oracle_rmsf_ca.results.rmsf, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(handles[1].result().results.rmsf),
        oracle_rmsf_cb.results.rmsf, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(handles[2].result().results.positions),
        np.asarray(oracle_avg.results.positions), atol=1e-4)

    snap = sched.telemetry.snapshot()
    assert snap["coalesce_batches"] == 1
    assert snap["coalesced_jobs"] == 3
    assert snap["coalesce_rate"] == 1.0


def test_mixed_families_split_into_two_passes():
    """Reductions and series on a batch backend merge into one pass
    per family (not one crash, not N solo passes)."""
    u = _u()
    sched = Scheduler(n_workers=1, autostart=False)
    hs = [
        sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                     batch_size=8),
        sched.submit(AverageStructure(u, select="name CB",
                                      select_only=True), backend="torch", executor_kwargs=CPU,
                     batch_size=8),
        sched.submit(RMSD(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                     batch_size=8),
        sched.submit(RadiusOfGyration(u.select_atoms("protein")),
                     backend="torch", executor_kwargs=CPU, batch_size=8),
    ]
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert all(h.error is None and h.coalesced for h in hs)
    assert sched.telemetry.coalesce_batches == 2
    s_rmsd = RMSD(u.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(np.asarray(hs[2].result().results.rmsd),
                               s_rmsd.results.rmsd, atol=1e-4)


def test_coalescer_routes_uncoalescable_to_solo_pass():
    """An AlignedRMSF job rides the SAME burst as coalescible jobs:
    the typed UncoalescableAnalysisError routes it to its own pass
    while the rest merge — nothing fails."""
    u = _u()
    sched = Scheduler(n_workers=1, autostart=False)
    h_ca = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                        batch_size=8)
    h_multi = sched.submit(AlignedRMSF(u, select="name CA"),
                           backend="torch", executor_kwargs=CPU, batch_size=8)
    h_cb = sched.submit(RMSF(u.select_atoms("name CB")), backend="torch", executor_kwargs=CPU,
                        batch_size=8)
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert all(h.error is None for h in (h_ca, h_multi, h_cb))
    assert h_ca.coalesced and h_cb.coalesced and not h_multi.coalesced
    assert sched.telemetry.uncoalescable_jobs == 1
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    np.testing.assert_allclose(
        np.asarray(h_multi.result().results.rmsf), s.results.rmsf,
        atol=1e-4)


def test_coalesce_opt_out():
    u = _u()
    sched = Scheduler(n_workers=1, autostart=False)
    h1 = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                      batch_size=8, coalesce=False)
    h2 = sched.submit(RMSF(u.select_atoms("name CB")), backend="torch", executor_kwargs=CPU,
                      batch_size=8)
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert h1.error is None and h2.error is None
    assert not h1.coalesced and not h2.coalesced


# ---- scheduling semantics ----


def test_priority_order_and_fifo_ties():
    """Higher priority first; equal priorities FIFO.  Distinct windows
    keep the jobs from coalescing into one pass."""
    u = _u(n_frames=32)
    sched = Scheduler(n_workers=1, autostart=False)
    h_low = sched.submit(RMSF(u.select_atoms("name CA")),
                         backend="serial", stop=8, priority=0)
    h_high = sched.submit(RMSF(u.select_atoms("name CA")),
                          backend="serial", stop=16, priority=10)
    h_mid = sched.submit(RMSF(u.select_atoms("name CA")),
                         backend="serial", stop=24, priority=5)
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    order = sorted((h_low, h_high, h_mid), key=lambda h: h.finished_t)
    assert [h.job.priority for h in order] == [10, 5, 0]


def test_queue_deadline_expires_instead_of_running():
    u = _u()
    sched = Scheduler(n_workers=1, autostart=False)
    h = sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                     deadline_s=0.0)
    import time

    time.sleep(0.01)
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert h.state == JobState.EXPIRED
    with pytest.raises(JobDeadlineExpired):
        h.result(timeout=1)
    assert sched.telemetry.expired == 1


def test_submit_analysis_job_instance():
    u = _u()
    job = AnalysisJob(RMSF(u.select_atoms("name CA")), backend="serial",
                      tenant="inst")
    with Scheduler(n_workers=1) as sched:
        h = sched.submit(job)
    assert h.result(timeout=60) is job.analysis
    assert h.job.tenant == "inst"


def test_failed_job_raises_from_result():
    u = _u()

    class Exploding(RMSF):
        def _prepare(self):
            raise RuntimeError("boom")

    with Scheduler(n_workers=1) as sched:
        h = sched.submit(Exploding(u.select_atoms("name CA")),
                         backend="serial")
        h_ok = sched.submit(RMSF(u.select_atoms("name CA")),
                            backend="serial")
    assert h.state == JobState.FAILED
    with pytest.raises(RuntimeError, match="boom"):
        h.result(timeout=1)
    assert h_ok.error is None            # failure stays per-job
    assert sched.telemetry.failed == 1 and sched.telemetry.completed == 1


# ---- reliability integration (satellite: fault injection) ----


def test_kernel_fault_degrades_one_job_other_tenants_bit_identical():
    """A persistent kernel-site fault inside tenant A's batch job
    demotes THAT job's executor (torch → serial, recorded in its own
    reliability report); tenants B and C complete bit-identically to
    their solo runs."""
    u = _u()
    solo_b = RMSF(u.select_atoms("name CA")).run(backend="serial")
    solo_c = RMSD(u.select_atoms("name CB")).run(backend="serial")

    pol = ReliabilityPolicy(max_retries=1, backoff_s=0.001,
                            checkpoint=False)
    with faults.inject(faults.FaultSpec("kernel", "raise", times=None)):
        sched = Scheduler(n_workers=1, autostart=False)
        h_a = sched.submit(RMSF(u.select_atoms("name CA")),
                           backend="torch", executor_kwargs=CPU, batch_size=8, resilient=pol,
                           tenant="A")
        h_b = sched.submit(RMSF(u.select_atoms("name CA")),
                           backend="serial", tenant="B")
        h_c = sched.submit(RMSD(u.select_atoms("name CB")),
                           backend="serial", tenant="C")
        sched.start()
        assert sched.drain(timeout=120)
        sched.shutdown()

    assert h_a.error is None and h_b.error is None and h_c.error is None
    rel = h_a.result().results.reliability
    assert [f[:2] for f in rel["fallbacks"]] == [("torch", "serial")]
    # the degradation was per-JOB: the other tenants' serial passes are
    # bit-identical to solo runs (no shared executor state mutated)
    assert np.array_equal(np.asarray(h_b.result().results.rmsf),
                          solo_b.results.rmsf)
    assert np.array_equal(np.asarray(h_c.result().results.rmsd),
                          solo_c.results.rmsd)
    # and A's degraded (serial) result matches the oracle exactly too
    np.testing.assert_allclose(np.asarray(h_a.result().results.rmsf),
                               solo_b.results.rmsf, atol=1e-5)


def test_transient_kernel_fault_heals_by_retry_no_fallback():
    u = _u()
    pol = ReliabilityPolicy(max_retries=2, backoff_s=0.001,
                            checkpoint=False)
    spec = faults.FaultSpec("kernel", "raise", times=1,
                            exc=faults.InjectedTransientError)
    with faults.inject(spec):
        with Scheduler(n_workers=1) as sched:
            h = sched.submit(RMSF(u.select_atoms("name CA")),
                             backend="torch", executor_kwargs=CPU, batch_size=8,
                             resilient=pol, tenant="flaky")
    assert h.error is None
    rel = h.result().results.reliability
    assert rel["retries"].get("kernel") == 1
    assert list(rel["fallbacks"]) == []


def test_resilient_jobs_coalesce_only_with_equal_policies():
    """The reliability policy is part of the coalesce key: one
    tenant's retry budget must not silently govern another's pass."""
    u = _u()
    pol = ReliabilityPolicy(max_retries=1, checkpoint=False)
    j1 = AnalysisJob(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                     batch_size=8, resilient=pol)
    j2 = AnalysisJob(RMSF(u.select_atoms("name CB")), backend="torch", executor_kwargs=CPU,
                     batch_size=8, resilient=pol)
    j3 = AnalysisJob(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                     batch_size=8)
    assert j1.coalesce_key() == j2.coalesce_key()
    assert j1.coalesce_key() != j3.coalesce_key()


# ---- cache admission control ----


def _full_window_bytes(u, n_frames):
    return n_frames * u.trajectory.n_atoms * 3 * 4


def test_admission_never_fitting_job_runs_uncached():
    u = _u()
    cache = DeviceBlockCache(max_bytes=1024)     # nothing fits
    with Scheduler(n_workers=1, cache=cache) as sched:
        h = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                         batch_size=8)
    assert h.error is None
    assert sched.telemetry.admission_uncached == 1
    assert cache._bytes == 0 and cache.hits == 0 and cache.misses == 0


def test_admission_resident_tenant_rides_its_superblocks():
    """A repeat job of a resident tenant is admitted WITHOUT a fresh
    reservation and actually hits its cached superblock."""
    u = _u()
    cache = DeviceBlockCache(
        max_bytes=_full_window_bytes(u, 24) + 1024)
    sched = Scheduler(n_workers=1, cache=cache)
    h1 = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                      batch_size=8, tenant="t")
    assert sched.drain(timeout=120)
    hits0 = cache.hits
    h2 = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                      batch_size=8, tenant="t")
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert h1.error is None and h2.error is None
    assert cache.hits > hits0
    assert sched.telemetry.admission_resident >= 1


def test_admission_evicts_idle_tenant_never_pinned_one():
    """When the budget is gone, entries of a tenant with NO pending
    jobs are reclaimed; a hot (pinned) tenant's survive."""
    u1, u2 = _u(seed=9), _u(seed=10)
    cache = DeviceBlockCache(
        max_bytes=_full_window_bytes(u1, 24) + 1024)
    sched = Scheduler(n_workers=1, cache=cache)
    h1 = sched.submit(RMSF(u1.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                      batch_size=8, tenant="idle-later")
    assert sched.drain(timeout=120)
    assert cache._bytes > 0                      # u1's superblock resident
    # u1 has no pending jobs now → unpinned → evictable for u2
    h2 = sched.submit(RMSF(u2.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                      batch_size=8, tenant="newcomer")
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert h1.error is None and h2.error is None
    assert sched.telemetry.admission_evictions >= 1
    s = RMSF(u2.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(np.asarray(h2.result().results.rmsf),
                               s.results.rmsf, atol=1e-4)


def test_admission_defers_behind_hot_tenant_then_reclaims_idle():
    """A job that cannot reserve while a HOT tenant holds the budget
    is PARKED until the work it deferred behind has actually run (no
    re-claim busy-loop), and the hot tenant's superblocks are evicted
    only once that tenant has gone idle."""
    from mdanalysis_mpi_tpu_torch.service.scheduler import reader_fingerprint

    u1, u2 = _u(seed=9), _u(seed=10)
    cache = DeviceBlockCache(
        max_bytes=_full_window_bytes(u1, 24) + 1024)
    sched = Scheduler(n_workers=1, cache=cache, autostart=False)
    # priorities order the claims: hot1 stages first; cold is claimed
    # while hot2 is still queued (so deferring has runnable work to
    # yield to); hot2's distinct window keeps it from coalescing into
    # hot1's pass
    h_hot = sched.submit(RMSF(u1.select_atoms("name CA")),
                         backend="torch", executor_kwargs=CPU, batch_size=8, tenant="hot",
                         priority=9)
    # cannot fit its reservation while u1 is hot
    h_cold = sched.submit(RMSF(u2.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8, tenant="cold",
                          priority=5)
    h_hot2 = sched.submit(RMSF(u1.select_atoms("name CA")),
                          backend="torch", executor_kwargs=CPU, batch_size=8, stop=16,
                          tenant="hot", priority=1)
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert all(h.error is None for h in (h_hot, h_cold, h_hot2))
    t = sched.telemetry
    # cold was parked (not busy-looped) while hot2 — the runnable work
    # it deferred behind — actually ran first...
    assert t.admission_deferrals == 1
    assert h_cold.started_t > h_hot2.finished_t
    # ...and once the hot tenant went idle, its entries were reclaimed
    # and cold got the cache — never evicted while hot was pinned
    # (hot2 ran against the intact cache AFTER cold's deferral)
    assert t.admission_evictions >= 1
    assert t.admission_uncached == 0
    assert cache.ns_bytes(reader_fingerprint(u2.trajectory)) > 0
    # deferral cycles must not corrupt the gauge or re-count passes:
    # 3 jobs → depth back to 0, exactly one executed pass per job
    assert t.queue_depth == 0
    assert t.solo_jobs == 3 and t.coalesce_batches == 0
    s = RMSF(u2.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(np.asarray(h_cold.result().results.rmsf),
                               s.results.rmsf, atol=1e-4)


# ---- thread-safety audit (satellite) ----


def test_admission_skips_pointless_eviction():
    """Idle tenants' superblocks are reclaimed ONLY when the reclaim
    can actually make the reservation fit — destroying them while a
    pinned tenant still holds the budget buys nothing and forces the
    idle tenant to re-pay decode+stage on return."""
    from mdanalysis_mpi_tpu_torch.service.coalesce import ExecutionUnit
    from mdanalysis_mpi_tpu_torch.service.jobs import JobHandle

    u = _u(seed=10)
    one = _full_window_bytes(u, 24)
    cache = DeviceBlockCache(max_bytes=one + 1024)
    sched = Scheduler(n_workers=1, cache=cache, autostart=False)
    cache.pin("hot-tenant")
    cache.put(("hot-tenant", 0), ("hot",), one // 2)
    cache.put(("idle-tenant", 0), ("idle",), 1000)
    job = AnalysisJob(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU)
    unit = ExecutionUnit([JobHandle(job)], job.analysis)
    run_now, reserved = sched._admit(unit)
    # est (≈ `one`) > available + reclaimable(1000): eviction would be
    # pointless, the idle entry survives, the job runs uncached
    assert run_now and reserved == -1
    assert cache.ns_bytes("idle-tenant") == 1000
    assert sched.telemetry.admission_evictions == 0
    assert sched.telemetry.admission_uncached == 1
    # flip side: once the hot tenant unpins, the reclaim CAN fit the
    # reservation — now eviction happens and the job is admitted
    cache.unpin("hot-tenant")
    run_now, reserved = sched._admit(unit)
    assert run_now and reserved > 0
    assert sched.telemetry.admission_evictions == 2
    assert cache.ns_bytes("idle-tenant") == 0
    sched.shutdown()


def test_blockcache_concurrent_accounting_stress():
    """Interleaved put/get/overwrite from many threads must keep the
    byte accounting exact (the lost-update corruption the lock
    prevents)."""
    cache = BlockCache(max_bytes=1 << 30)
    errs = []

    def worker(tid):
        try:
            for i in range(300):
                key = ("ns", i % 40)             # heavy key contention
                cache.put(key, (tid, i), 1000 + (i % 7))
                cache.get(key)
                cache.get(("ns", "missing"))
        except Exception as e:                   # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert cache._bytes == sum(cache._sizes.values())
    assert set(cache._store) == set(cache._sizes)
    assert cache.hits + cache.misses == 8 * 300 * 2


class _FakeBuffer:
    """Stands in for a staged device tensor: records the release calls
    (the cache's ``_delete_staged``, patched below) so the stress test
    can prove no double-delete and no leak."""

    def __init__(self):
        self.deletes = 0
        self._lock = threading.Lock()

    def delete(self):
        with self._lock:
            self.deletes += 1


def test_device_cache_overwrite_race_no_double_delete_no_leak(
        monkeypatch):
    """Racing same-key puts: every replaced buffer is deleted exactly
    once, the stored one never — the unlocked read-old/insert
    interleaving would double-delete one buffer and leak another."""
    from mdanalysis_mpi_tpu_torch.parallel import executors as _ex

    def release(staged):
        for buf in staged:
            buf.delete()

    monkeypatch.setattr(_ex, "_delete_staged", release)
    cache = DeviceBlockCache(max_bytes=1 << 30)
    created: list[_FakeBuffer] = []
    created_lock = threading.Lock()

    def worker():
        for i in range(200):
            buf = _FakeBuffer()
            with created_lock:
                created.append(buf)
            cache.put(("traj", i % 10), (buf,), 100)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stored = {id(v[0]) for v in cache._store.values()}
    for buf in created:
        if id(buf) in stored:
            assert buf.deletes == 0, "live buffer deleted"
        else:
            assert buf.deletes == 1, (
                f"replaced buffer deleted {buf.deletes}× (≠ 1)")
    assert cache._bytes == sum(cache._sizes.values())


def test_scheduler_workers_share_cache_interleaved_jobs():
    """4 workers × batch jobs × one shared DeviceBlockCache: results
    still match the serial oracle and the accounting stays exact."""
    u1, u2 = _u(n_frames=32, seed=9), _u(n_frames=32, seed=10)
    cache = DeviceBlockCache(max_bytes=1 << 30)
    sched = Scheduler(n_workers=4, cache=cache, autostart=False)
    handles = []
    for u in (u1, u2):
        for stop in (16, 24, 32):
            handles.append(sched.submit(
                RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
                batch_size=8, stop=stop, coalesce=False))
    sched.start()
    assert sched.drain(timeout=240)
    sched.shutdown()
    assert all(h.error is None for h in handles)
    assert cache._bytes == sum(cache._sizes.values())
    assert cache._bytes <= cache.max_bytes
    i = 0
    for u in (u1, u2):
        for stop in (16, 24, 32):
            s = RMSF(u.select_atoms("name CA")).run(backend="serial",
                                                    stop=stop)
            np.testing.assert_allclose(
                np.asarray(handles[i].result().results.rmsf),
                s.results.rmsf, atol=1e-4)
            i += 1


# ---- pin/reserve unit behavior ----


def test_truthy_non_policy_resilient_is_normalized():
    """``resilient=1`` (a natural mistake for a bool-or-policy knob)
    must behave as True — not blow up the worker's coalesce-key
    computation."""
    u = _u()
    job = AnalysisJob(RMSF(u.select_atoms("name CA")),
                      backend="serial", resilient=1)
    assert job.resilient is True
    job.coalesce_key()                    # must not raise
    with Scheduler(n_workers=1) as sched:
        h = sched.submit(job)
    assert h.error is None
    assert "reliability" in h.result().results


def test_submit_rejects_kwargs_with_prebuilt_job():
    u = _u()
    job = AnalysisJob(RMSF(u.select_atoms("name CA")), backend="serial")
    sched = Scheduler(n_workers=1, autostart=False)
    with pytest.raises(TypeError, match="silently discarded"):
        sched.submit(job, priority=5)
    sched.shutdown()


def test_broken_coalesce_key_fails_job_not_worker():
    """A job whose coalesce key cannot be computed (broken trajectory
    attribute) fails ITSELF; the worker survives for other tenants."""
    u = _u()

    class NoTraj(RMSF):
        @property
        def _universe(self):
            raise AttributeError("universe exploded")

        @_universe.setter
        def _universe(self, v):
            pass

    with Scheduler(n_workers=1, autostart=False) as sched:
        h_bad = sched.submit(NoTraj(u.select_atoms("name CA")),
                             backend="serial")
        h_ok = sched.submit(RMSF(u.select_atoms("name CA")),
                            backend="serial")
    assert h_bad.state == JobState.FAILED
    with pytest.raises(AttributeError, match="universe exploded"):
        h_bad.result(timeout=1)
    assert h_ok.error is None


def test_submitted_collection_runs_as_its_own_unit():
    """A user-built AnalysisCollection is a legal job: the planner
    must NOT try to nest it into another collection (which would kill
    the worker with the nest refusal) — it runs as its own pass."""
    from mdanalysis_mpi_tpu_torch.analysis import AnalysisCollection

    u = _u()
    coll = AnalysisCollection(RMSF(u.select_atoms("name CA")),
                              RMSF(u.select_atoms("name CB")))
    with Scheduler(n_workers=1) as sched:
        h = sched.submit(coll, backend="torch", executor_kwargs=CPU, batch_size=8)
        h_peer = sched.submit(RMSF(u.select_atoms("name CA")),
                              backend="serial")
    assert h.error is None and h_peer.error is None
    s = RMSF(u.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(
        np.asarray(h.result().analyses[0].results.rmsf),
        s.results.rmsf, atol=1e-4)


def test_planner_error_fails_handles_not_worker():
    """An exception escaping planning/admission must fail the affected
    jobs — never kill the worker thread (which would strand the queue
    and hang drain())."""
    u = _u()

    class BadFrames(RMSF):
        def _frames(self, *a, **k):      # blows up inside _admit
            raise RuntimeError("bad window")

    cache = DeviceBlockCache(max_bytes=1 << 30)
    with Scheduler(n_workers=1, cache=cache) as sched:
        h_bad = sched.submit(BadFrames(u.select_atoms("name CA")),
                             backend="torch", executor_kwargs=CPU, batch_size=8)
        h_ok = sched.submit(RMSF(u.select_atoms("name CA")),
                            backend="serial")
    assert h_bad.state == JobState.FAILED
    with pytest.raises(RuntimeError, match="bad window"):
        h_bad.result(timeout=1)
    # the worker survived and served the next tenant
    assert h_ok.error is None and h_ok.state == JobState.DONE


def test_submit_after_shutdown_leaves_no_pin_behind():
    """A rejected submission must not pin its tenant's namespace in a
    shared cache — no completion would ever release it, and later
    schedulers sharing the cache could never reclaim those entries."""
    u = _u()
    cache = DeviceBlockCache(max_bytes=1 << 20)
    sched = Scheduler(n_workers=1, cache=cache)
    sched.drain(timeout=10)
    sched.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit(RMSF(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU)
    from mdanalysis_mpi_tpu_torch.service.scheduler import reader_fingerprint

    ns = reader_fingerprint(u.trajectory)
    cache.put((ns, 0), "v", 10)
    assert cache.evict_unpinned() == ["v"]   # tenant ns NOT left pinned


def test_blockcache_reserve_release_and_pinning():
    cache = BlockCache(max_bytes=1000)
    assert cache.reserve(600)
    assert not cache.reserve(600)        # overcommit refused
    assert cache.available_bytes == 400
    cache.release(600)
    assert cache.available_bytes == 1000
    cache.put(("a", 1), "x", 300)
    cache.put(("b", 1), "y", 300)
    cache.pin("a")
    evicted = cache.evict_unpinned()
    assert evicted == ["y"]
    assert ("a", 1) in cache._store and ("b", 1) not in cache._store
    assert cache._bytes == 300
    assert cache.ns_bytes("a") == 300 and cache.ns_bytes("b") == 0
    # eviction un-flips `full` so the freed budget is usable again
    cache.put(("c", 1), "z", 900)        # rejected (300 resident)
    assert cache.full
    cache.unpin("a")
    cache.evict_unpinned()
    assert not cache.full and cache.put(("c", 1), "z", 900)


# ---- telemetry ----


def test_telemetry_snapshot_schema_and_serializability():
    t = ServiceTelemetry()
    snap = t.snapshot()
    for key in ("jobs_submitted", "jobs_completed", "jobs_failed",
                "jobs_expired", "queue_depth", "queue_depth_peak",
                "coalesced_jobs", "coalesce_batches", "solo_jobs",
                "uncoalescable_jobs", "coalesce_fallbacks",
                "admission_reserved", "admission_resident",
                "admission_deferrals", "admission_uncached",
                "admission_evictions", "p50_queue_wait_s",
                "p99_queue_wait_s", "p50_latency_s", "p99_latency_s",
                "coalesce_rate", "cache_hit_rate"):
        assert key in snap, key
    assert snap["p50_latency_s"] is None       # empty-sample guard
    json.dumps(snap)                           # JSON-serializable
    cache = BlockCache(max_bytes=10)
    cache.put(("k",), "v", 5)
    cache.get(("k",))
    cache.get(("nope",))
    snap = t.snapshot(cache=cache)
    assert snap["cache_hit_rate"] == 0.5
    json.dumps(snap)


def test_serving_telemetry_counts_queue_depth_peak():
    u = _u()
    sched = Scheduler(n_workers=1, autostart=False)
    for stop in (8, 16, 24):
        sched.submit(RMSF(u.select_atoms("name CA")), backend="serial",
                     stop=stop)
    assert sched.telemetry.queue_depth_peak == 3
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert sched.telemetry.queue_depth == 0
    assert sched.telemetry.completed == 3


# ---- CLI (batch subcommand) ----


def test_cli_batch_runs_job_file(tmp_path, capsys):
    u = _u()
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps({
        "defaults": {"backend": "serial", "select": "name CA"},
        "workers": 1,
        "jobs": [
            {"analysis": "rmsf", "tenant": "alice", "priority": 5},
            {"analysis": "rgyr", "select": "protein", "tenant": "bob"},
            {"analysis": "rmsd", "tenant": "carol",
             "output": str(tmp_path / "rmsd.npz")},
        ],
    }))
    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    rc = batch_main([str(jobs_file)], universe=u)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert [r["state"] for r in out["jobs"]] == ["done"] * 3
    assert {r["tenant"] for r in out["jobs"]} == {"alice", "bob", "carol"}
    assert out["serving"]["jobs_completed"] == 3
    assert "coalesce_rate" in out["serving"]
    with np.load(tmp_path / "rmsd.npz") as z:
        assert z["rmsd"].shape[0] == u.trajectory.n_frames


def test_cli_batch_reports_per_job_failure(tmp_path, capsys):
    """A malformed request fails ITS job record (rc=1), the healthy
    tenants still complete."""
    u = _u()
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps({
        "defaults": {"backend": "serial", "select": "name CA"},
        "jobs": [
            {"analysis": "rmsf", "tenant": "good"},
            {"analysis": "waterbridge", "tenant": "bad"},  # no select2
        ],
    }))
    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    rc = batch_main([str(jobs_file)], universe=u)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1
    states = {r["tenant"]: r["state"] for r in out["jobs"]}
    assert states == {"good": "done", "bad": "failed"}
    bad = next(r for r in out["jobs"] if r["tenant"] == "bad")
    assert "select2" in bad["error"]
