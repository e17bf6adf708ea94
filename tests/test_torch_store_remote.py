"""The port's remote store tier (``io/store/remote.py``) against the JAX
package's: the port's ``ChunkServer`` on 127.0.0.1 serves a store that
the JAX package ingested over HTTP, and a port ``Universe`` opened on
the store's URL stages the same bytes as the port's reader on a local
store of the same frames.  Content addressing makes the port's
re-ingest of the same frames write zero new chunk bytes (so its chunks
are the JAX package's, byte for byte), and a chunk corrupted on the
wire is rejected with the port's typed error and counted.

Inputs are made with numpy from a seed.  No test leaves 127.0.0.1.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402
from mdanalysis_mpi_tpu.io.store import ChunkCache as JChunkCache  # noqa: E402
from mdanalysis_mpi_tpu.io.store import HttpStoreBackend as JHttpStoreBackend  # noqa: E402
from mdanalysis_mpi_tpu.io.store import ingest as jingest  # noqa: E402

from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.store import (  # noqa: E402
    ChunkCache, ChunkServer, HttpStoreBackend, ServerFault, StoreReader,
    ingest, store_meta)
from mdanalysis_mpi_tpu_torch.io.store import codec  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.store.manifest import load_manifest  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import METRICS  # noqa: E402
from mdanalysis_mpi_tpu_torch.utils.integrity import (  # noqa: E402
    StoreCorruptError, StoreUnavailableError)

N_FRAMES, N_ATOMS, CHUNK = 24, 20, 8


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=12.0, size=(N_ATOMS, 3)).astype(np.float32)
    frames = base[None] + rng.normal(
        scale=0.4, size=(N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    dims = np.tile(np.array([40.0, 40, 40, 90, 90, 90],
                            dtype=np.float32), (N_FRAMES, 1))
    times = np.arange(N_FRAMES, dtype=np.float64) * 2.0
    return frames, dims, times


def _counter(name: str) -> float:
    return sum(METRICS.snapshot().get(
        name, {"values": {}})["values"].values())


def _topology():
    names = np.tile(np.array(["CA", "HA"]), N_ATOMS // 2 + 1)[:N_ATOMS]
    return Topology(names=names, resnames=np.full(N_ATOMS, "ALA"),
                    resids=np.arange(N_ATOMS) // 2 + 1)


def _backend(srv, store, **kw):
    kw.setdefault("cache", ChunkCache())
    kw.setdefault("retries", 1)
    kw.setdefault("backoff_s", 0.0)
    kw.setdefault("timeout_s", 5.0)
    return HttpStoreBackend(srv.url, store=store, **kw)


@pytest.fixture
def served(tmp_path):
    """The port's ChunkServer holding a store the JAX package ingested
    through its own HTTP backend: (server, frames)."""
    frames, dims, times = _frames()
    with ChunkServer(str(tmp_path / "srv")) as srv:
        jbe = JHttpStoreBackend(srv.url, store="ref", cache=JChunkCache(),
                                timeout_s=5.0)
        s = jingest(JMemoryReader(frames, dimensions=dims, times=times),
                    backend=jbe, chunk_frames=CHUNK, quant="int16")
        assert s["content_addressed"] is True and s["dedup_chunks"] == 0
        yield srv, frames


def test_universe_on_url_stages_the_local_readers_bytes(served, tmp_path):
    srv, frames = served
    _, dims, times = _frames()
    local = str(tmp_path / "local")
    ingest(MemoryReader(frames, dimensions=dims, times=times), local,
           chunk_frames=CHUNK, quant="int16")
    lr = StoreReader(local)
    u = Universe(_topology(), srv.store_url("ref", retries=1,
                                            timeout_s=5.0))
    rr = u.trajectory
    assert isinstance(rr, StoreReader)
    assert rr.n_frames == N_FRAMES and rr.n_atoms == N_ATOMS
    sel = np.arange(1, N_ATOMS, 2)
    for layout in ("interleaved", "planar"):
        for start, stop, s in ((0, 8, None), (4, 20, sel)):
            got = rr.stage_block(start, stop, s, "int16", layout=layout)
            want = lr.stage_block(start, stop, s, "int16", layout=layout)
            for g, w in zip(got, want):
                assert np.array_equal(np.asarray(g), np.asarray(w))
    g, gb = rr.read_block(0, N_FRAMES)
    w, wb = lr.read_block(0, N_FRAMES)
    assert np.array_equal(g, w) and np.array_equal(gb, wb)
    meta = store_meta(srv.store_url("ref"))
    assert meta["chunk_frames"] == CHUNK and meta["n_frames"] == N_FRAMES
    man = load_manifest(_backend(srv, "ref"))
    for entry in man["chunks"]:
        assert entry["file"] == codec.cas_chunk_name(entry["digest"])


def test_port_reingest_writes_zero_new_chunk_bytes(served):
    srv, frames = served
    _, dims, times = _frames()
    wrote = srv.cas_bytes_written
    assert wrote > 0
    dedup0 = _counter("mdtpu_store_chunks_deduped_total")
    s = ingest(MemoryReader(frames, dimensions=dims, times=times),
               backend=_backend(srv, "port"), chunk_frames=CHUNK,
               quant="int16")
    assert s["content_addressed"] is True
    assert s["dedup_chunks"] == s["n_chunks"] == N_FRAMES // CHUNK
    assert s["dedup_ratio"] == 1.0
    assert srv.cas_bytes_written == wrote            # zero new bytes
    assert _counter("mdtpu_store_chunks_deduped_total") \
        == dedup0 + N_FRAMES // CHUNK
    # both namespaces resolve to the same immutable chunks
    ref = [e["file"] for e in load_manifest(_backend(srv, "ref"))["chunks"]]
    port = [e["file"] for e in load_manifest(_backend(srv, "port"))["chunks"]]
    assert ref == port


def test_corrupt_served_chunk_rejected_typed_and_counted(served):
    srv, _ = served
    be = _backend(srv, "ref", retries=0)
    chunk0 = load_manifest(be)["chunks"][0]["file"]
    srv.inject(ServerFault("corrupt", match=chunk0, times=None))
    rejects0 = _counter("mdtpu_store_chunk_crc_rejects_total")
    with pytest.raises(StoreCorruptError):
        be.get_bytes(chunk0)
    rr = StoreReader(srv.store_url("ref"), backend=be)
    with pytest.raises(StoreCorruptError):
        rr.stage_block(0, CHUNK, None, "int16", layout="planar")
    assert _counter("mdtpu_store_chunk_crc_rejects_total") == rejects0 + 1
    # the bad bytes never entered the cache: once the fault clears the
    # chunk is served and verified
    srv.clear_faults()
    q, _, _ = StoreReader(srv.store_url("ref"), backend=be).stage_block(
        0, CHUNK, None, "int16")
    assert q.shape == (CHUNK, N_ATOMS, 3)


def test_unreachable_remote_is_typed_unavailable():
    be = HttpStoreBackend("http://127.0.0.1:9", store="gone",
                          cache=ChunkCache(), retries=0, timeout_s=1.0,
                          backoff_s=0.0)
    with pytest.raises(StoreUnavailableError):
        be.get_bytes("manifest.json")
    assert store_meta("http://127.0.0.1:9/stores/gone") is None
