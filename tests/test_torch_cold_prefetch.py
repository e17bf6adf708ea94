"""The port's twin of ``tests/test_cold_prefetch.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Scheduler-driven prefetch + cold-path pipelining (docs/COLDSTART.md).

Pins the serving half of the cold-path overhaul:

- ``Scheduler.prefetch_pending`` stages a queued job's blocks into the
  shared DeviceBlockCache BEFORE the job is claimed, so its wave-1
  dispatches are cache hits, with results identical to the unprefetched
  run;
- prefetch respects admission control and tenant pinning: it
  reserve-or-skips, and NEVER evicts a pinned tenant's entries;
- ``Scheduler.warmup(jobs)`` precompiles the coalesce-key shapes;
- the double-buffered cold schedule records wire spans on a dedicated
  thread, distinct from (and overlapping) the decode/stage spans.
"""

import json
import threading
import time

import numpy as np
import pytest


from mdanalysis_mpi_tpu_torch import obs  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis import RMSD  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis.rms import RMSF  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    DeviceBlockCache, reader_fingerprint,
)
from mdanalysis_mpi_tpu_torch.service.jobs import AnalysisJob  # noqa: E402
from mdanalysis_mpi_tpu_torch.service.scheduler import Scheduler  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

#: the device route on the CPU (the port runs on the card by default)
CPU = {"device": "cpu"}
MESH = {"devices": ["cpu"] * 4}

pytestmark = pytest.mark.service


def _jobs(u, backend="torch", bs=4):
    kw = MESH if backend == "mesh" else CPU
    return [AnalysisJob(RMSF(u.select_atoms("name CA")), backend=backend,
                        batch_size=bs, executor_kwargs=dict(kw),
                        tenant="a"),
            AnalysisJob(RMSD(u.select_atoms("name CA")), backend=backend,
                        batch_size=bs, executor_kwargs=dict(kw),
                        tenant="b")]


class TestPrefetch:
    def test_blocks_staged_before_claim_and_wave1_hits(self):
        """Queued jobs' blocks land in the cache BEFORE any worker
        starts; the wave-1 run then misses zero times and matches the
        serial oracle."""
        u = make_protein_universe(n_residues=24, n_frames=16, noise=0.3,
                                  seed=5)
        cache = DeviceBlockCache(max_bytes=1 << 30)
        sched = Scheduler(n_workers=1, cache=cache, autostart=False)
        handles = [sched.submit(j) for j in _jobs(u)]
        staged = sched.prefetch_pending()
        # staged before claim: entries exist, workers never ran
        assert staged > 0
        assert len(cache._store) > 0
        assert all(h.state == "queued" for h in handles)
        assert all(h.prefetched for h in handles)
        snap = sched.telemetry.snapshot()
        assert snap["prefetch_blocks"] == staged
        assert snap["prefetch_jobs"] >= 1
        h0, m0 = cache.hits, cache.misses
        sched.start()
        assert sched.drain(timeout=300)
        sched.shutdown()
        assert [h.state for h in handles] == ["done", "done"]
        assert cache.misses == m0, "wave-1 run should be all hits"
        assert cache.hits > h0
        oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
        np.testing.assert_allclose(
            handles[0].result().results.rmsf, oracle.results.rmsf,
            atol=1e-4)

    def test_mesh_backend_prefetch(self):
        u = make_protein_universe(n_residues=24, n_frames=16, noise=0.3,
                                  seed=6)
        cache = DeviceBlockCache(max_bytes=1 << 30)
        sched = Scheduler(n_workers=1, cache=cache, autostart=False)
        handles = [sched.submit(AnalysisJob(
            RMSF(u.select_atoms("name CA")), backend="mesh", executor_kwargs=MESH,
            batch_size=2, tenant="m"))]
        assert sched.prefetch_pending() > 0
        m0 = cache.misses
        sched.start()
        assert sched.drain(timeout=300)
        sched.shutdown()
        assert handles[0].state == "done", handles[0].error
        assert cache.misses == m0

    def test_prefetch_never_evicts_pinned_tenant(self):
        """A full cache pinned by a hot tenant: prefetch must SKIP the
        queued job (reserve fails, no resident entries), never evict —
        the pinned entries survive byte-for-byte."""
        u_hot = make_protein_universe(n_residues=24, n_frames=16,
                                      noise=0.3, seed=7)
        u_cold = make_protein_universe(n_residues=24, n_frames=16,
                                       noise=0.3, seed=8)
        # cache the hot tenant fills via a direct run, then shrink the
        # budget to EXACTLY its usage — a genuinely full cache
        cache = DeviceBlockCache(max_bytes=1 << 20)
        ns_hot = reader_fingerprint(u_hot.trajectory)
        cache.pin(ns_hot)
        RMSF(u_hot.select_atoms("name CA")).run(
            backend="torch", device="cpu", batch_size=4, block_cache=cache)
        entries_before = dict(cache._sizes)
        assert entries_before, "fixture: hot tenant cached nothing"
        cache.max_bytes = cache._bytes
        sched = Scheduler(n_workers=1, cache=cache, autostart=False)
        sched.submit(AnalysisJob(RMSF(u_cold.select_atoms("name CA")),
                                 backend="torch", executor_kwargs=CPU, batch_size=4,
                                 tenant="cold"))
        staged = sched.prefetch_pending()
        assert staged == 0
        assert sched.telemetry.snapshot()["prefetch_skipped"] >= 1
        # pinned entries untouched
        assert dict(cache._sizes) == entries_before
        sched.shutdown()

    def test_background_prefetch_thread(self):
        """prefetch=True: while worker 1 is busy with a slow job, the
        prefetch thread stages the waiting job's blocks so its claim
        starts hit-resident."""
        u = make_protein_universe(n_residues=24, n_frames=24, noise=0.3,
                                  seed=9)
        u2 = make_protein_universe(n_residues=24, n_frames=24, noise=0.3,
                                   seed=10)
        cache = DeviceBlockCache(max_bytes=1 << 30)
        sched = Scheduler(n_workers=1, cache=cache, autostart=False,
                          prefetch=True)

        slow_gate = threading.Event()

        class _SlowAnalysis(RMSF):
            def run(self, *a, **k):
                slow_gate.wait(30)
                return super().run(*a, **k)

        h_slow = sched.submit(AnalysisJob(
            _SlowAnalysis(u.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
            batch_size=4, tenant="slow", coalesce=False))
        h_next = sched.submit(AnalysisJob(
            RMSF(u2.select_atoms("name CA")), backend="torch", executor_kwargs=CPU,
            batch_size=4, tenant="next", coalesce=False))
        sched.start()
        # worker is blocked inside the slow job; the prefetch thread
        # should stage h_next's blocks meanwhile
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not h_next.prefetched:
            time.sleep(0.02)
        assert h_next.prefetched, "background prefetch never ran"
        assert h_next.state == "queued"
        ns_next = reader_fingerprint(u2.trajectory)
        assert cache.ns_bytes(ns_next) > 0
        slow_gate.set()
        assert sched.drain(timeout=300)
        sched.shutdown()
        assert h_slow.state == "done" and h_next.state == "done"

    def test_shutdown_waits_for_held_jobs(self):
        """A prefetch-held handle is still queued work: workers must
        not exit on shutdown while it is held (they would strand it in
        'queued' forever) — they wait for the hold release instead."""
        u = make_protein_universe(n_residues=24, n_frames=8, noise=0.3,
                                  seed=14)
        sched = Scheduler(n_workers=1,
                          cache=DeviceBlockCache(max_bytes=1 << 30),
                          autostart=False)
        h = sched.submit(AnalysisJob(RMSF(u.select_atoms("name CA")),
                                     backend="torch", executor_kwargs=CPU, batch_size=4))
        with sched._cond:
            h._prefetch_hold = True
        sched.start()
        sched._shutdown = True      # shutdown flag with the job held
        with sched._cond:
            sched._cond.notify_all()
        time.sleep(0.3)             # worker must still be waiting
        with sched._cond:           # release, as prefetch's finally does
            h._prefetch_hold = False
            sched._cond.notify_all()
        assert sched.drain(timeout=60)
        sched.shutdown()
        assert h.state == "done", (h.state, h.error)

    def test_scheduler_warmup_returns_stats(self):
        u = make_protein_universe(n_residues=24, n_frames=16, noise=0.3,
                                  seed=11)
        sched = Scheduler(n_workers=1,
                          cache=DeviceBlockCache(max_bytes=1 << 30),
                          autostart=False)
        stats = sched.warmup(_jobs(u))
        assert stats["executables"] >= 2
        assert stats["seconds"] >= 0
        sched.shutdown()


class TestColdPipeline:
    def test_wire_spans_on_dedicated_thread_overlapping_stage(
            self, tmp_path, monkeypatch):
        """The double-buffered cold schedule: wire spans record on the
        mdtpu-wire thread, distinct from the decode/stage spans' thread
        — the stage-vs-wire overlap the tentpole makes visible."""
        monkeypatch.setenv("MDTPU_COLD_PIPELINE", "1")
        trace = str(tmp_path / "cold.json")
        u = make_protein_universe(n_residues=48, n_frames=48, noise=0.3,
                                  seed=12)
        obs.enable_tracing(trace)
        try:
            RMSF(u.select_atoms("name CA")).run(
                backend="torch", device="cpu", batch_size=8, prestage=True,
                block_cache=DeviceBlockCache(max_bytes=1 << 30))
            obs.export_trace(trace)
        finally:
            obs.disable_tracing(discard=True)
        with open(trace) as f:
            evs = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X"]
        wires = [e for e in evs if e["name"] == "wire"]
        stages = [e for e in evs if e["name"] == "stage"]
        assert wires and stages
        wire_tids = {e["tid"] for e in wires}
        stage_tids = {e["tid"] for e in stages}
        assert wire_tids.isdisjoint(stage_tids), (
            "wire spans should live on the dedicated wire thread, "
            f"got wire tids {wire_tids} vs stage tids {stage_tids}")

    def test_pipelined_cold_matches_chunked_cold(self, monkeypatch):
        """Schedule equivalence: pipelined and chunked cold paths
        produce identical results (same staging, same kernels — only
        the wire scheduling differs)."""
        u = make_protein_universe(n_residues=24, n_frames=32, noise=0.3,
                                  seed=13)
        oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
        out = {}
        for mode in ("0", "1"):
            monkeypatch.setenv("MDTPU_COLD_PIPELINE", mode)
            r = RMSF(u.select_atoms("name CA")).run(
                backend="torch", device="cpu", batch_size=8, prestage=True,
                block_cache=DeviceBlockCache(max_bytes=1 << 30))
            out[mode] = np.asarray(r.results.rmsf)
        np.testing.assert_array_equal(out["0"], out["1"])
        np.testing.assert_allclose(out["1"], oracle.results.rmsf,
                                   atol=1e-4)
