"""The port's twin of ``tests/test_prof.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Continuous profiler (obs/prof.py, docs/OBSERVABILITY.md "Alerting
& profiling"): sampling stacks, per-dispatch latency histograms per
program geometry, watermark sources — and the two contracts everything
else leans on: near-free when disabled, bit-compatible when enabled.
"""

import threading
import time

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.obs import prof as oprof
from mdanalysis_mpi_tpu_torch.obs import spans as ospans

pytestmark = pytest.mark.service


@pytest.fixture(autouse=True)
def _clean_prof():
    oprof.disable()
    oprof.reset()
    yield
    oprof.disable()
    oprof.reset()


def _busy_until_samples(n, limit_s=60.0):
    """Spin until the sampler has taken ``n`` samples (or the limit
    passes): a loaded host slows the sampler, never the assertion."""
    t0 = time.perf_counter()
    while (oprof._STATE.n_samples < n
           and time.perf_counter() - t0 < limit_s):
        sum(range(500))


def _wait_samples(k, limit_s=60.0):
    """Wait until the sampler has ticked ``k`` more times (a tick reads
    every watermark source after counting itself), with a limit."""
    target = oprof._STATE.n_samples + k
    deadline = time.monotonic() + limit_s
    while (oprof._STATE.n_samples < target
           and time.monotonic() < deadline):
        time.sleep(0.002)


# ---------------------------------------------------------------------------
# sampler + collapsed stacks
# ---------------------------------------------------------------------------

def test_sampler_collects_collapsed_stacks_and_watermarks():
    oprof.enable(interval_s=0.005)
    t = threading.Thread(target=_busy_until_samples, args=(8,),
                         name="busy")
    t.start()
    t.join()
    oprof.disable()
    rep = oprof.report(top=50)
    assert rep["n_samples"] > 5
    assert rep["rss_bytes"] > 0
    assert rep["rss_peak_bytes"] >= rep["rss_bytes"]
    # flamegraph-collapsed: root-first, ';'-joined module:func frames
    stacks = rep["stacks"]
    assert stacks and all(";" in s or ":" in s for s in stacks)
    assert any("_busy" in s for s in stacks), sorted(stacks)[:5]
    # the live gauges and sample counter are in the snapshot
    snap = obs.unified_snapshot()
    assert snap["mdtpu_prof_samples_total"]["values"][""] >= 5
    assert snap["mdtpu_prof_rss_peak_bytes"]["values"][""] > 0


def test_export_collapsed_writes_flamegraph_format(tmp_path):
    oprof.enable(interval_s=0.005)
    _busy_until_samples(3)
    oprof.disable()
    path = str(tmp_path / "prof.collapsed")
    assert oprof.export_collapsed(path) == path
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    assert lines
    for ln in lines:
        stack, count = ln.rsplit(" ", 1)
        assert int(count) >= 1
        assert stack


def test_disabled_profiler_is_inert():
    assert not oprof.enabled()
    oprof.note_dispatch(5.0, geometry="bs8_scan1")   # no-op
    assert oprof.dispatch_stats() == {}
    rep = oprof.report()
    assert rep["enabled"] is False and rep["n_samples"] == 0
    # the watermark block still carries a one-shot RSS read (the
    # flight recorder embeds it on every dump, sampler or not)
    assert oprof.watermark_block()["rss_bytes"] > 0


def test_enable_disable_idempotent_and_thread_stops():
    oprof.enable(interval_s=0.005)
    oprof.enable(interval_s=0.005)               # second call: no-op
    thread = oprof._STATE.thread
    assert thread is not None and thread.is_alive()
    oprof.disable()
    oprof.disable()
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# dispatch latency per program geometry
# ---------------------------------------------------------------------------

def test_note_dispatch_percentiles_and_histogram_per_geometry():
    oprof.enable(interval_s=10.0)                # sampler idle
    for ms in (1.0, 2.0, 3.0, 4.0, 100.0):
        oprof.note_dispatch(ms, geometry="bs32_scan1")
    oprof.note_dispatch(7.0, geometry="bs32_scan4")
    stats = oprof.dispatch_stats()
    assert set(stats) == {"bs32_scan1", "bs32_scan4"}
    assert stats["bs32_scan1"]["count"] == 5
    assert stats["bs32_scan1"]["p50_ms"] == pytest.approx(3.0)
    assert stats["bs32_scan1"]["p99_ms"] == pytest.approx(100.0)
    assert stats["bs32_scan4"]["count"] == 1
    # the live histogram is labeled by geometry + engine with the ms
    # buckets (engine="generic" is the default dispatch program)
    snap = obs.unified_snapshot()["mdtpu_dispatch_ms"]
    assert snap["type"] == "histogram"
    h = snap["values"]['engine="generic",geometry="bs32_scan1"']
    assert h["count"] == 5
    assert h["buckets"]["5.0"] == 4              # 1..4 ms <= 5 ms


def test_note_dispatch_fused_engine_keys_separately():
    """A fused-program dispatch of the same geometry lands in its own
    sample window (``geometry/engine``) and histogram series, so the
    two programs' latency distributions never mix."""
    oprof.enable(interval_s=10.0)
    oprof.note_dispatch(2.0, geometry="bs32_scan1")
    oprof.note_dispatch(4.0, geometry="bs32_scan1", engine="fused")
    stats = oprof.dispatch_stats()
    assert set(stats) == {"bs32_scan1", "bs32_scan1/fused"}
    assert stats["bs32_scan1"]["count"] == 1
    assert stats["bs32_scan1/fused"]["count"] == 1
    snap = obs.unified_snapshot()["mdtpu_dispatch_ms"]
    assert snap["values"]['engine="fused",geometry="bs32_scan1"'][
        "count"] == 1


def test_jax_dispatch_sites_record_geometry():
    """The executors feed real dispatches while the profiler is on —
    the continuous `ms_per_dispatch` evidence (ROADMAP 5/6b)."""
    from mdanalysis_mpi_tpu_torch.analysis import RMSF
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    u = make_protein_universe(n_residues=20, n_frames=16, noise=0.3,
                              seed=3)
    oprof.enable(interval_s=10.0)
    RMSF(u.select_atoms("name CA")).run(backend="torch", device="cpu", batch_size=8)
    oprof.disable()
    stats = oprof.dispatch_stats()
    assert "bs8_scan1" in stats, stats
    assert stats["bs8_scan1"]["count"] >= 2
    assert stats["bs8_scan1"]["p99_ms"] > 0


# ---------------------------------------------------------------------------
# watermark sources
# ---------------------------------------------------------------------------

def test_registered_watermark_sources_track_peaks():
    vals = {"v": 10.0}
    oprof.register_watermark("test_src", lambda: vals["v"])
    try:
        oprof.enable(interval_s=0.005)
        _wait_samples(2)
        vals["v"] = 99.0
        _wait_samples(2)
        vals["v"] = 5.0
        _wait_samples(2)
        oprof.disable()
        marks = oprof.watermark_block()["watermarks"]
        assert marks["test_src"]["peak"] == 99.0
        assert marks["test_src"]["value"] == 5.0
    finally:
        oprof.unregister_watermark("test_src")


def test_raising_watermark_source_is_dropped_and_disclosed():
    calls = [0]

    def bad():
        calls[0] += 1
        raise RuntimeError("boom")

    before = obs.METRICS.snapshot().get(
        "mdtpu_obs_write_errors_total", {"values": {}})["values"].get(
        'sink="prof"', 0)
    oprof.register_watermark("bad_src", bad)
    oprof.enable(interval_s=0.005)
    _wait_samples(3)
    oprof.disable()
    after = obs.METRICS.snapshot()["mdtpu_obs_write_errors_total"][
        "values"].get('sink="prof"', 0)
    assert after == before + 1        # disclosed once, then dropped
    assert calls[0] == 1              # never polled again
    assert "bad_src" not in oprof._STATE.sources


def test_scheduler_registers_staged_and_cache_sources():
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache
    from mdanalysis_mpi_tpu_torch.service import Scheduler

    cache = DeviceBlockCache(max_bytes=1 << 20)
    sched = Scheduler(n_workers=1, cache=cache, autostart=False,
                      supervise=False)
    sched.start()
    try:
        assert "staged_bytes" in oprof._STATE.sources
        assert "cache_bytes" in oprof._STATE.sources
    finally:
        sched.shutdown()
    assert "staged_bytes" not in oprof._STATE.sources


def test_second_scheduler_keeps_ownership_of_watermark_names():
    """A shut-down scheduler must not yank the source name a later
    scheduler took over (owner-checked unregistration)."""
    from mdanalysis_mpi_tpu_torch.service import Scheduler

    a = Scheduler(n_workers=1, autostart=False, supervise=False)
    a.start()
    b = Scheduler(n_workers=1, autostart=False, supervise=False)
    b.start()                      # takes over "staged_bytes"
    try:
        assert oprof._STATE.sources["staged_bytes"] is \
            b._wm_sources["staged_bytes"]
    finally:
        a.shutdown()               # must NOT remove b's source
    try:
        assert oprof._STATE.sources["staged_bytes"] is \
            b._wm_sources["staged_bytes"]
    finally:
        b.shutdown()
    assert "staged_bytes" not in oprof._STATE.sources


def test_argless_enable_restores_default_interval():
    oprof.enable(interval_s=0.001)
    assert oprof._STATE.interval_s == 0.001
    oprof.disable()
    oprof.enable()                 # must not inherit 0.001
    assert oprof._STATE.interval_s == oprof.DEFAULT_INTERVAL_S
    oprof.disable()


# ---------------------------------------------------------------------------
# parity: observation changes nothing
# ---------------------------------------------------------------------------

def test_profiler_on_changes_no_numerical_result_bit_compat():
    """Acceptance: the flagship host analysis with sampler + dispatch
    histograms + watermark sampling on is BIT-COMPATIBLE with the
    profiler-off run."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    def run():
        u = make_protein_universe(n_residues=30, n_frames=24,
                                  noise=0.3, seed=11)
        return AlignedRMSF(u, select="name CA").run(backend="serial")

    r_off = run()
    oprof.enable(interval_s=0.002)
    r_on = run()
    oprof.disable()
    assert np.array_equal(np.asarray(r_off.results.rmsf),
                          np.asarray(r_on.results.rmsf))
    # the profiled run's report carries the profiler block; the
    # unprofiled one's stays byte-identical to the pre-profiler shape
    assert "profiler" in r_on.results.observability
    assert "profiler" not in r_off.results.observability
    block = r_on.results.observability["profiler"]
    assert block["rss_peak_bytes"] > 0
    assert "dispatch_ms" in block


def test_trace_counter_events_ride_the_timeline(tmp_path):
    """With tracing on, the sampler emits prof_watermarks counter
    events (ph "C") Perfetto renders as an area row."""
    ospans.disable(discard=True)
    ospans.reset()
    ospans.enable()
    oprof.enable(interval_s=0.005)
    _wait_samples(2)
    oprof.disable()
    counters = [ev for ev in ospans.tail(limit=500)
                if ev.get("ph") == "C"
                and ev["name"] == "prof_watermarks"]
    ospans.disable(discard=True)
    assert counters
    assert counters[-1]["args"]["rss_mb"] > 0
