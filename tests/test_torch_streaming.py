"""``AnalysisBase.run_streaming`` on the store's follow reader: twins of
tests/test_streaming.py's live-writer, killed-writer and end-of-feed
cases (the scheduler cases wait for the serving layer, ROADMAP A10).

A live writer thread (the port's ``LiveIngest``) appends frames while
the port tails the store; its snapshots must be monotone, the final
result within 1e-5 of the closed-file run over the sealed store, and
the middle snapshot within 1e-5 of a run with ``stop=`` at its frame
count (tests/test_streaming.py's tolerances).  The two packages' stores
are byte-identical (tests/test_torch_store.py), so the JAX package's
``run_streaming`` then reads the same store, and the port's snapshots
are held to its snapshots at the same frame counts, within 1e-5.
"""

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu import Universe as JaxUniverse  # noqa: E402
from mdanalysis_mpi_tpu import analysis as jax_analysis  # noqa: E402
from mdanalysis_mpi_tpu.io.store import (  # noqa: E402
    StoreReader as JaxStoreReader)

from mdanalysis_mpi_tpu_torch import Universe, obs, testing  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis import (  # noqa: E402
    RMSD, RMSF, AlignedRMSF)
from mdanalysis_mpi_tpu_torch.analysis.base import (  # noqa: E402
    Results, StreamFeedStalled)
from mdanalysis_mpi_tpu_torch.io.store import (  # noqa: E402
    LiveIngest, StoreEndOfFeed, StoreReader)

N_FRAMES, CHUNK = 24, 8
CPU = dict(backend="torch", device="cpu")


def _fixture(n_frames=N_FRAMES):
    u = testing.make_protein_universe(
        n_residues=6, n_frames=n_frames, noise=0.3, seed=7)
    frames, _ = u.trajectory.read_block(0, n_frames)
    return u, frames


def _live_store(tmp_path, frames, n_atoms):
    """A store fed by a writer thread; returns (store dir, thread)."""
    store = str(tmp_path / "store")
    live = LiveIngest(out=store, n_atoms=n_atoms, chunk_frames=CHUNK)

    def writer():
        for f in frames:
            live.append(f)
            time.sleep(0.002)
        live.seal()

    return store, threading.Thread(target=writer)


def _jax_universe(u, store, follow=True):
    from mdanalysis_mpi_tpu import testing as jax_testing

    uj = jax_testing.make_protein_universe(
        n_residues=6, n_frames=N_FRAMES, noise=0.3, seed=7)
    return JaxUniverse(uj.topology, JaxStoreReader(store, follow=follow))


def _by_frames(snaps):
    return {s["frames"]: s for s in snaps}


STREAMS = {
    "serial": dict(backend="serial"),
    "torch": dict(CPU, batch_size=4),
    "mesh": dict(backend="mesh", devices=["cpu"] * 2, batch_size=2),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_live_writer_monotone_snapshots_converge(tmp_path, name):
    u, frames = _fixture()
    store, t = _live_store(tmp_path, frames, u.atoms.n_atoms)
    t.start()
    try:
        sr = StoreReader(store, follow=True)
        r = RMSF(Universe(u.topology, sr).select_atoms("name CA")) \
            .run_streaming(window=CHUNK, poll_interval_s=0.005,
                           stall_timeout_s=30.0, **STREAMS[name])
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    snaps = r.results.stream_snapshots
    seq = [s["frames"] for s in snaps]
    # monotone, strictly growing, ending at the sealed frame count
    assert seq == sorted(seq)
    assert len(set(seq)) == len(seq)
    assert seq[-1] == N_FRAMES
    assert len(snaps) >= 2
    assert sr.sealed
    # final result == the closed-file run over the sealed store
    oracle = RMSF(Universe(u.topology, StoreReader(store))
                  .select_atoms("name CA")).run(**CPU)
    np.testing.assert_allclose(r.results.rmsf, oracle.results.rmsf,
                               atol=1e-5)
    # every snapshot is the closed-file result over its prefix
    mid = snaps[len(snaps) // 2]
    part = RMSF(Universe(u.topology, StoreReader(store))
                .select_atoms("name CA")).run(stop=mid["frames"], **CPU)
    np.testing.assert_allclose(mid["values"]["rmsf"], part.results.rmsf,
                               atol=1e-5)
    # snapshots are digest-stamped (utils/integrity.py)
    assert all(s["digest"] for s in snaps)
    assert r.results.observability["n_frames"] == N_FRAMES
    # the JAX package streams the same sealed store
    j = jax_analysis.RMSF(_jax_universe(u, store).select_atoms("name CA")) \
        .run_streaming(window=CHUNK, poll_interval_s=0.005)
    jsnaps = _by_frames(j.results.stream_snapshots)
    np.testing.assert_allclose(r.results.rmsf, np.asarray(j.results.rmsf),
                               atol=1e-5)
    for s in snaps:
        if s["frames"] in jsnaps:
            np.testing.assert_allclose(
                s["values"]["rmsf"],
                np.asarray(jsnaps[s["frames"]]["values"]["rmsf"]),
                atol=1e-5)


def test_aligned_rmsf_streams_by_recompute_over_prefix(tmp_path):
    """AlignedRMSF overrides run(): each snapshot re-runs both passes
    over the prefix (fused int16 here), as the JAX package does."""
    u, frames = _fixture()
    store, t = _live_store(tmp_path, frames, u.atoms.n_atoms)
    t.start()
    try:
        r = AlignedRMSF(Universe(u.topology, StoreReader(store, follow=True)),
                        select="name CA", engine="fused").run_streaming(
            window=CHUNK, poll_interval_s=0.005, transfer_dtype="int16",
            batch_size=8, **CPU)
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    seq = [s["frames"] for s in r.results.stream_snapshots]
    assert seq == sorted(set(seq)) and seq[-1] == N_FRAMES
    closed = AlignedRMSF(Universe(u.topology, StoreReader(store)),
                         select="name CA", engine="fused").run(
        transfer_dtype="int16", batch_size=8, **CPU)
    np.testing.assert_allclose(r.results.rmsf, closed.results.rmsf,
                               atol=1e-5)
    j = jax_analysis.AlignedRMSF(_jax_universe(u, store),
                                 select="name CA").run_streaming(
        window=CHUNK, poll_interval_s=0.005, backend="jax",
        transfer_dtype="int16", batch_size=8)
    # the fused kernel against the JAX package's generic route on the
    # same int16 wire: the fused-vs-generic tolerance
    np.testing.assert_allclose(r.results.rmsf, np.asarray(j.results.rmsf),
                               atol=5e-4)


def test_series_stream_concatenates_in_frame_order(tmp_path):
    """RMSD's per-frame series: windows concatenate in frame order.
    RMSD reads its reference frame in ``_prepare``, so the stream opens
    once the first chunk is sealed."""
    u, frames = _fixture()
    store, t = _live_store(tmp_path, frames, u.atoms.n_atoms)
    t.start()
    try:
        sr = StoreReader(store, follow=True)
        sr.wait_frames(1, timeout_s=30.0, poll_interval_s=0.005)
        r = RMSD(Universe(u.topology, sr)
                 .select_atoms("name CA")).run_streaming(
            window=CHUNK, poll_interval_s=0.005, batch_size=3, **CPU)
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    closed = RMSD(Universe(u.topology, StoreReader(store))
                  .select_atoms("name CA")).run(batch_size=3, **CPU)
    assert r.results.rmsd.shape == (N_FRAMES,)
    np.testing.assert_allclose(r.results.rmsd, closed.results.rmsd,
                               atol=1e-5)


def test_killed_writer_degrades_to_valid_shorter_store(tmp_path):
    """A writer killed mid-chunk loses ONLY its buffered partial chunk —
    the sealed prefix stays a valid store a follow reader serves, and a
    streaming pass over it stalls typed with progress intact; calling
    run_streaming again resumes on the same backend."""
    u, frames = _fixture()
    store = str(tmp_path / "store")
    live = LiveIngest(out=store, n_atoms=u.atoms.n_atoms,
                      chunk_frames=CHUNK)
    for f in frames[:19]:        # 2 chunks sealed, 3 frames buffered
        live.append(f)
    del live                     # kill -9: no seal(), buffer lost

    sr = StoreReader(store, follow=True)
    assert sr.n_frames == 16     # the sealed prefix, nothing torn
    assert not sr.sealed
    ana = RMSF(Universe(u.topology, sr).select_atoms("name CA"))
    with pytest.raises(StreamFeedStalled) as exc:
        ana.run_streaming(window=CHUNK, poll_interval_s=0.005,
                          stall_timeout_s=0.2, **CPU)
    assert exc.value.frames_done == 16
    oracle = RMSF(Universe(u.topology, StoreReader(store, follow=True))
                  .select_atoms("name CA")).run(stop=16, **CPU)
    np.testing.assert_allclose(ana.results.rmsf, oracle.results.rmsf,
                               atol=1e-5)
    with pytest.raises(ValueError, match="resume must use it too"):
        ana.run_streaming(window=CHUNK, backend="serial",
                          stall_timeout_s=0.05)
    with pytest.raises(StreamFeedStalled):
        ana.run_streaming(window=CHUNK, poll_interval_s=0.005,
                          stall_timeout_s=0.05, **CPU)
    # the JAX package stalls at the same prefix with the same result
    ja = jax_analysis.RMSF(_jax_universe(u, store).select_atoms("name CA"))
    from mdanalysis_mpi_tpu.analysis.base import (
        StreamFeedStalled as JaxStalled)
    with pytest.raises(JaxStalled) as jexc:
        ja.run_streaming(window=CHUNK, poll_interval_s=0.005,
                         stall_timeout_s=0.2)
    assert jexc.value.frames_done == 16
    np.testing.assert_allclose(ana.results.rmsf, np.asarray(ja.results.rmsf),
                               atol=1e-5)


def test_end_of_feed_vs_stall_are_typed(tmp_path):
    u, frames = _fixture()
    store = str(tmp_path / "store")
    live = LiveIngest(out=store, n_atoms=u.atoms.n_atoms,
                      chunk_frames=CHUNK)
    for f in frames[:CHUNK]:
        live.append(f)
    sr = StoreReader(store, follow=True)
    # open feed that stopped growing: a STALL (TimeoutError)
    with pytest.raises(TimeoutError):
        sr.wait_frames(CHUNK + 1, timeout_s=0.1, poll_interval_s=0.01)
    live.seal()
    # sealed short of the ask: the feed is OVER, typed end-of-feed
    with pytest.raises(StoreEndOfFeed):
        sr.wait_frames(CHUNK + 1, timeout_s=0.1, poll_interval_s=0.01)
    assert sr.sealed and sr.n_frames == CHUNK
    # a stream over the sealed short feed ends cleanly, no stall
    r = RMSF(Universe(u.topology, sr).select_atoms("name CA")) \
        .run_streaming(window=CHUNK, stall_timeout_s=0.05, **CPU)
    assert [s["frames"] for s in r.results.stream_snapshots] == [CHUNK]
    oracle = RMSF(Universe(u.topology, StoreReader(store))
                  .select_atoms("name CA")).run(**CPU)
    np.testing.assert_allclose(r.results.rmsf, oracle.results.rmsf,
                               atol=1e-5)
    # the JAX package reads the same sealed short feed the same way
    from mdanalysis_mpi_tpu.io.store import (
        StoreEndOfFeed as JaxStoreEndOfFeed)

    uj = _jax_universe(u, store)
    with pytest.raises(JaxStoreEndOfFeed):
        uj.trajectory.wait_frames(CHUNK + 1, timeout_s=0.1,
                                  poll_interval_s=0.01)
    j = jax_analysis.RMSF(uj.select_atoms("name CA")).run_streaming(
        window=CHUNK, stall_timeout_s=0.05)
    assert [s["frames"] for s in j.results.stream_snapshots] == [CHUNK]
    np.testing.assert_allclose(r.results.rmsf, np.asarray(j.results.rmsf),
                               atol=1e-5)


def test_stream_counters_and_snapshot_callback(tmp_path):
    u, frames = _fixture()
    store = str(tmp_path / "store")
    live = LiveIngest(out=store, n_atoms=u.atoms.n_atoms,
                      chunk_frames=CHUNK)
    for f in frames:
        live.append(f)
    live.seal()

    def total(name):
        snap = obs.METRICS.snapshot().get(name, {})
        return sum(snap.get("values", {}).values())

    f0, s0 = (total("mdtpu_stream_frames_total"),
              total("mdtpu_stream_snapshots_total"))
    seen = []
    RMSF(Universe(u.topology, StoreReader(store, follow=True))
         .select_atoms("name CA")).run_streaming(
        window=10, snapshot_cb=seen.append, **CPU)
    assert [s["frames"] for s in seen] == [10, 20, 24]
    assert total("mdtpu_stream_frames_total") - f0 == N_FRAMES
    assert total("mdtpu_stream_snapshots_total") - s0 == 3
    with pytest.raises(ValueError, match="window"):
        RMSF(u.select_atoms("name CA")).run_streaming(window=-1, **CPU)


def test_results_materialize_fetches_every_entry():
    inner = Results(x=torch.arange(3))
    r = Results(a=torch.ones(2), nested=inner, n=5)
    assert r.materialize() is r
    assert isinstance(r["a"], np.ndarray)
    assert isinstance(inner["x"], np.ndarray) and r["n"] == 5
