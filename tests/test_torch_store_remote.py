"""The port's remote store tier (``io/store/remote.py``) against the JAX
package's: the port's ``ChunkServer`` on 127.0.0.1 serves a store that
the JAX package ingested over HTTP, and a port ``Universe`` opened on
the store's URL stages the same bytes as the port's reader on a local
store of the same frames.  Content addressing makes the port's
re-ingest of the same frames write zero new chunk bytes (so its chunks
are the JAX package's, byte for byte), and a chunk corrupted on the
wire is rejected with the port's typed error and counted.

The chaos leg (the twin of ``tests/test_store_remote.py``'s fleet
wave): a two-host port fleet on the CPU reads a remote store URL that
goes flaky and then hard-down mid-run; every job completes close to the
local-mirror oracle through the cache and mirror rungs, the counters
federate through heartbeats, and the tier serves remotely again once
the faults clear.

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


# ---------------------------------------------------------------------------
# the chaos leg: a fleet wave over a flaky remote
# ---------------------------------------------------------------------------

FIXTURE = {"kind": "protein", "n_residues": 10, "n_frames": 12,
           "noise": 0.25, "seed": 5}


def _fleet_counter(snap: dict, name: str) -> float:
    return sum(snap.get(name, {"values": {}})["values"].values())


def _wait(pred, timeout=30.0, msg="condition"):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


def test_fleet_wave_rides_ladder_through_remote_outage(tmp_path):
    """A two-host port fleet (``device="cpu"``) whose trajectory is a
    remote store URL; the remote goes hard-down mid-run, per-worker
    breakers trip, every job completes within 1e-5 of the JAX
    package's serial run on the mirror via the cache and mirror rungs,
    the counters federate, and the remote serves again afterwards."""
    import os
    import time

    from mdanalysis_mpi_tpu import Universe as JUniverse
    from mdanalysis_mpi_tpu.analysis import RMSD as JRMSD
    from mdanalysis_mpi_tpu.analysis import RMSF as JRMSF
    from mdanalysis_mpi_tpu.io.store import StoreReader as JStoreReader

    from mdanalysis_mpi_tpu_torch.service.fleet import DONE, FleetController
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    u = make_protein_universe(
        **{k: v for k, v in FIXTURE.items() if k != "kind"})
    mirror = str(tmp_path / "mirror")
    ingest(u.trajectory, mirror, chunk_frames=4, quant="f32",
           content_addressed=True)
    with ChunkServer(str(tmp_path / "srv")) as srv:
        be = HttpStoreBackend(srv.url, store="shared",
                              cache=ChunkCache())
        u2 = make_protein_universe(
            **{k: v for k, v in FIXTURE.items() if k != "kind"})
        summary = ingest(u2.trajectory, backend=be, chunk_frames=4,
                         quant="f32")
        assert summary["n_chunks"] == 3
        assert summary["content_addressed"] is True
        for entry in load_manifest(be)["chunks"]:
            assert os.path.exists(os.path.join(mirror, entry["file"]))

        url = srv.store_url(
            "shared", mirror=mirror, retries=1, timeout_s=2.0,
            backoff_s=0.01, breaker_threshold=1,
            breaker_cooldown_s=0.2)
        from mdanalysis_mpi_tpu.testing import (
            make_protein_universe as jmake,
        )

        ju = jmake(**{k: v for k, v in FIXTURE.items() if k != "kind"})
        u_oracle = JUniverse(ju.topology, JStoreReader(mirror))
        sel = "protein and name CA"
        rmsf_oracle = JRMSF(u_oracle.select_atoms(sel)).run(
            backend="serial").results.rmsf
        rmsd_oracle = JRMSD(u_oracle, select=sel).run(
            backend="serial").results.rmsd

        with FleetController(tmp_path, host_ttl_s=5.0,
                             device="cpu") as ctrl:
            for _ in range(2):
                ctrl.spawn_host(hb_interval_s=0.1,
                                env={"OMP_NUM_THREADS": "1"})
            assert ctrl.wait_hosts(2, timeout=60.0)

            def _wave(tag):
                jobs = [ctrl.submit({
                    "analysis": "rmsf", "fixture": FIXTURE,
                    "trajectory": url,
                    "tenant": f"{tag}{i % 3}"}) for i in range(4)]
                sharded = ctrl.submit({
                    "analysis": "rmsd", "fixture": FIXTURE,
                    "trajectory": url, "tenant": f"{tag}0",
                    "shards": 2})
                assert ctrl.drain(timeout=120.0), \
                    f"{tag} wave drain timed out"
                assert all(j.state == DONE for j in jobs), \
                    (tag, [j.error for j in jobs])
                assert sharded.state == DONE, (tag, sharded.error)
                for j in jobs:
                    np.testing.assert_allclose(
                        j.result_arrays()["rmsf"], rmsf_oracle,
                        atol=1e-5)
                np.testing.assert_allclose(
                    sharded.result_arrays()["rmsd"], rmsd_oracle,
                    atol=1e-5)
                return sharded

            sharded = _wave("clean")
            for child in sharded.children:
                assert child.spec["start"] % 4 == 0
            _wait(lambda: _fleet_counter(
                ctrl.fleet_snapshot(),
                "mdtpu_store_remote_requests_total") > 0,
                msg="federated remote request counters")

            srv.inject(
                ServerFault("reset", times=2),
                ServerFault("truncate", times=2),
                ServerFault("corrupt", match="cas-", times=2),
                ServerFault("http_5xx", times=None),
                ServerFault("http_5xx", method="HEAD", times=None))
            snap0 = ctrl.fleet_snapshot()
            errs0 = _fleet_counter(snap0,
                                   "mdtpu_store_remote_errors_total")
            _wave("outage")
            _wait(lambda: (
                _fleet_counter(ctrl.fleet_snapshot(),
                               "mdtpu_store_remote_errors_total")
                > errs0),
                msg="federated remote error counters")
            snap = ctrl.fleet_snapshot()

            def _moved(name):
                return (_fleet_counter(snap, name)
                        - _fleet_counter(snap0, name))

            assert _moved("mdtpu_breaker_transitions_total") > 0
            assert (_moved("mdtpu_store_cache_hits_total")
                    + _moved("mdtpu_store_mirror_reads_total")) > 0
            assert _moved("mdtpu_store_unavailable_total") == 0

            srv.clear_faults()
            # the breaker cooldowns (0.2 s) lapse before the next wave
            time.sleep(0.3)
            req0 = srv.requests
            _wave("recovered")
            assert srv.requests > req0
