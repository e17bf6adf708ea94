"""The decode-then-wire (prestage) schedules in the port against the JAX
package's (tests/test_prestage.py, and tests/test_cold_prefetch.py's
cold-pipeline cases; the serving scheduler's prefetch is not ported
yet, ROADMAP A10).

``prestage=True`` takes one of two schedules: with
``MDTPU_COLD_PIPELINE`` on (the default on a host with more than one
core) each block's copy runs on an ``mdtpu-wire`` thread while the next
block decodes; otherwise chunks of ``MDTPU_PRESTAGE_CHUNK`` blocks are
staged with no device contact, then copied.  Pinned here: the order of
host stages and copies, results bit-identical to the interleaved
schedule for every chunk/window geometry, cache reuse, the mesh, the
wire thread in the span trace, and the JAX package's results on the
same frames.
"""

import json

import numpy as np
import pytest

from mdanalysis_mpi_tpu import analysis as jax_analysis
from mdanalysis_mpi_tpu import testing as jax_testing
from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.analysis import RMSD, RMSF, AlignedRMSF
from mdanalysis_mpi_tpu_torch.parallel import executors
from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

CPU = dict(backend="torch", device="cpu")


def _traced(u, monkeypatch):
    """Record the order of host stages and device copies."""
    events = []
    reader = u.trajectory
    orig_stage = reader.stage_cached
    orig_block = reader.stage_block
    nested = []

    def stage_wrap(*a, **k):
        events.append("stage")
        nested.append(1)            # stage_cached calls stage_block
        try:
            return orig_stage(*a, **k)
        finally:
            nested.pop()

    def block_wrap(*a, **k):
        if not nested:
            events.append("stage")
        return orig_block(*a, **k)

    reader.stage_cached = stage_wrap
    reader.stage_block = block_wrap
    orig_put = executors._put_staged

    def put_wrap(*a, **k):
        events.append("put")
        return orig_put(*a, **k)

    monkeypatch.setattr(executors, "_put_staged", put_wrap)
    return events


def test_prestage_stages_every_batch_before_first_put(monkeypatch):
    monkeypatch.setenv("MDTPU_COLD_PIPELINE", "0")
    u = make_protein_universe(n_residues=30, n_frames=32, noise=0.2)
    events = _traced(u, monkeypatch)
    RMSD(u.select_atoms("name CA")).run(batch_size=8, prestage=True,
                                        **CPU)
    assert events.count("stage") == 4 and events.count("put") == 4
    assert events[:4] == ["stage"] * 4, events


def test_prestage_chunked_schedule(monkeypatch):
    monkeypatch.setenv("MDTPU_COLD_PIPELINE", "0")
    monkeypatch.setenv("MDTPU_PRESTAGE_CHUNK", "2")
    monkeypatch.setenv("MDTPU_WIRE_WINDOW", "2")
    u = make_protein_universe(n_residues=30, n_frames=32, noise=0.2)
    events = _traced(u, monkeypatch)
    RMSD(u.select_atoms("name CA")).run(batch_size=8, prestage=True,
                                        **CPU)
    assert events == ["stage", "stage", "put", "put"] * 2, events


def test_prestage_parity_and_cache_reuse(monkeypatch):
    u = make_protein_universe(n_residues=30, n_frames=24, noise=0.3)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    interleaved = AlignedRMSF(u, select="name CA").run(
        batch_size=8, transfer_dtype="int16",
        block_cache=DeviceBlockCache(), **CPU)
    cache = DeviceBlockCache()
    events = _traced(u, monkeypatch)
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    pre = AlignedRMSF(u, select="name CA").run(
        batch_size=8, transfer_dtype="int16", block_cache=cache,
        prestage=True, **CPU)
    np.testing.assert_allclose(np.asarray(pre.results.rmsf),
                               s.results.rmsf, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(pre.results.rmsf),
                                  np.asarray(interleaved.results.rmsf))
    n_staged = events.count("stage")
    assert n_staged > 0
    # a second prestaged run over the shared cache re-stages nothing
    m0 = cache.misses
    AlignedRMSF(u, select="name CA").run(
        batch_size=8, transfer_dtype="int16", block_cache=cache,
        prestage=True, **CPU)
    assert cache.misses == m0
    assert cache.hits > 0
    assert events.count("stage") == n_staged
    # the JAX package's prestaged run on the same frames
    ju = jax_testing.make_protein_universe(n_residues=30, n_frames=24,
                                           noise=0.3)
    from mdanalysis_mpi_tpu.parallel.executors import (
        DeviceBlockCache as JaxCache)

    j = jax_analysis.AlignedRMSF(ju, select="name CA").run(
        backend="jax", batch_size=8, transfer_dtype="int16",
        block_cache=JaxCache(), prestage=True)
    np.testing.assert_allclose(np.asarray(pre.results.rmsf),
                               np.asarray(j.results.rmsf), atol=5e-4)


def test_prestage_on_mesh_backend():
    u = make_protein_universe(n_residues=30, n_frames=32, noise=0.3)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    m = AlignedRMSF(u, select="name CA").run(
        backend="mesh", devices=["cpu"] * 4, batch_size=4,
        transfer_dtype="int16", prestage=True)
    np.testing.assert_allclose(np.asarray(m.results.rmsf),
                               s.results.rmsf, atol=1e-3)


@pytest.mark.parametrize("chunk,window", [(1, 1), (2, 1), (4, 3),
                                          (3, 2), (6, 4)])
@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_chunk_window_sweep_bit_identical(monkeypatch, chunk, window,
                                          pipeline):
    """Every chunk/window geometry of both prestage schedules stages the
    same bytes in the same order as the interleaved schedule — the
    schedule knobs are performance, never semantics."""
    monkeypatch.setenv("MDTPU_COLD_PIPELINE", pipeline)
    monkeypatch.setenv("MDTPU_PRESTAGE_CHUNK", str(chunk))
    monkeypatch.setenv("MDTPU_WIRE_WINDOW", str(window))
    u = make_protein_universe(n_residues=24, n_frames=48, noise=0.25)
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    r = AlignedRMSF(u, select="name CA").run(
        batch_size=8, transfer_dtype="int16",
        block_cache=DeviceBlockCache(), prestage=True, **CPU)
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    ref = AlignedRMSF(u, select="name CA").run(
        batch_size=8, transfer_dtype="int16",
        block_cache=DeviceBlockCache(), **CPU)
    np.testing.assert_array_equal(np.asarray(r.results.rmsf),
                                  np.asarray(ref.results.rmsf))


def test_window_exceeding_chunk_is_coerced(monkeypatch):
    """A wire window above the chunk raises the chunk to the window."""
    monkeypatch.setenv("MDTPU_COLD_PIPELINE", "0")
    monkeypatch.setenv("MDTPU_PRESTAGE_CHUNK", "1")
    monkeypatch.setenv("MDTPU_WIRE_WINDOW", "4")
    u = make_protein_universe(n_residues=24, n_frames=32, noise=0.25)
    events = _traced(u, monkeypatch)
    RMSD(u.select_atoms("name CA")).run(batch_size=8, prestage=True,
                                        **CPU)
    assert events == ["stage"] * 4 + ["put"] * 4, events


def test_cold_pipeline_is_the_multicore_default(monkeypatch):
    monkeypatch.delenv("MDTPU_COLD_PIPELINE", raising=False)
    monkeypatch.setattr(executors._os, "cpu_count", lambda: 8)
    assert executors._cold_pipeline_enabled()
    monkeypatch.setattr(executors._os, "cpu_count", lambda: 1)
    assert not executors._cold_pipeline_enabled()
    monkeypatch.setenv("MDTPU_COLD_PIPELINE", "1")
    assert executors._cold_pipeline_enabled()


# ---- the pipelined cold schedule (tests/test_cold_prefetch.py) ----

def test_wire_spans_on_dedicated_thread_overlapping_stage(tmp_path,
                                                          monkeypatch):
    """Wire spans record on the mdtpu-wire thread, distinct from the
    decode/stage spans' thread."""
    monkeypatch.setenv("MDTPU_COLD_PIPELINE", "1")
    trace = str(tmp_path / "cold.json")
    u = make_protein_universe(n_residues=48, n_frames=48, noise=0.3,
                              seed=12)
    obs.enable_tracing(trace)
    try:
        RMSF(u.select_atoms("name CA")).run(
            batch_size=8, prestage=True,
            block_cache=DeviceBlockCache(max_bytes=1 << 30), **CPU)
        obs.export_trace(trace)
    finally:
        obs.disable_tracing(discard=True)
    with open(trace) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X"]
    wires = [e for e in evs if e["name"] == "wire"]
    stages = [e for e in evs if e["name"] == "stage"]
    assert wires and stages
    assert {e["tid"] for e in wires}.isdisjoint({e["tid"] for e in stages})


def test_pipelined_cold_matches_chunked_cold(monkeypatch):
    u = make_protein_universe(n_residues=24, n_frames=32, noise=0.3,
                              seed=13)
    oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("MDTPU_COLD_PIPELINE", mode)
        r = RMSF(u.select_atoms("name CA")).run(
            batch_size=8, prestage=True,
            block_cache=DeviceBlockCache(max_bytes=1 << 30), **CPU)
        out[mode] = np.asarray(r.results.rmsf)
    np.testing.assert_array_equal(out["0"], out["1"])
    np.testing.assert_allclose(out["1"], oracle.results.rmsf, atol=1e-4)
