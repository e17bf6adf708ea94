"""The port's block store (``mdanalysis_mpi_tpu_torch/io/store``)
against the JAX package's (``mdanalysis_mpi_tpu/io/store``), mirroring
the classes of tests/test_store.py.

Inputs are made with numpy from a seed.  Each package ingests the same
frames (the same MemoryReader arrays, or the same XTC path, so the
manifests' ``source`` fields agree) and the chunk files and manifests
must come out byte-identical; the port's reader on a store the JAX
package ingested must stage the same bytes.  AlignedRMSF's fused engine
runs from a store on the CPU through the kernel's plain version, held
to the JAX package's Pallas kernel in interpret mode (within 5e-4 Å)
and to the serial float64 oracle on the store's own coordinates
(within 1e-3 Å), the tolerances of tests/test_pallas_fused.py.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

# small shapes: one intra-op thread, so these tests leave the CPU to the
# other test workers' timing-sensitive tests
torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis import AlignedRMSF as JAlignedRMSF  # noqa: E402
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402
from mdanalysis_mpi_tpu.io.store import StoreReader as JStoreReader  # noqa: E402
from mdanalysis_mpi_tpu.io.store import ingest as jingest  # noqa: E402

from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.store import (  # noqa: E402
    LiveIngest, LocalDirBackend, StoreEndOfFeed, StoreReader, ingest,
    is_store, store_meta)
from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import METRICS  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    DeviceBlockCache, reader_fingerprint)
from mdanalysis_mpi_tpu_torch.utils.integrity import (  # noqa: E402
    IntegrityError, StoreCorruptError, StoreUnavailableError)


def _counter(name: str) -> float:
    return sum(METRICS.snapshot().get(
        name, {"values": {}})["values"].values())


def _rejects() -> float:
    # reason-labeled (corrupt|unavailable): sum across every reason
    return _counter("mdtpu_store_chunk_crc_rejects_total")


def _topo_kw(n_atoms: int) -> dict:
    names = np.tile(np.array(["CA", "HA"]), n_atoms // 2 + 1)[:n_atoms]
    return dict(names=names, resnames=np.full(n_atoms, "ALA"),
                resids=np.arange(n_atoms) // 2 + 1)


def _frames(n_frames=40, n_atoms=60, seed=0, scale=12.0):
    """(frames, dims, times): a rigid base plus noise, boxed, timed."""
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=scale, size=(n_atoms, 3)).astype(np.float32)
    frames = base[None] + rng.normal(
        scale=0.4, size=(n_frames, n_atoms, 3)).astype(np.float32)
    dims = np.tile(np.array([40.0, 40, 40, 90, 90, 90],
                            dtype=np.float32), (n_frames, 1))
    times = np.arange(n_frames, dtype=np.float64) * 2.0
    return frames, dims, times


def _source(n_frames=40, n_atoms=60, seed=0, scale=12.0):
    frames, dims, times = _frames(n_frames, n_atoms, seed, scale)
    return MemoryReader(frames, dimensions=dims, times=times), frames


def _store_files(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _corrupt(path: str, offset: int, bit: int) -> None:
    blob = bytearray(open(path, "rb").read())
    blob[offset] ^= bit
    with open(path, "wb") as f:
        f.write(bytes(blob))


@pytest.fixture(scope="module")
def ref_stores(tmp_path_factory):
    """Stores the JAX package ingested, one per tier, from the same
    seeded frames: {quant: (dir, frames)}."""
    root = tmp_path_factory.mktemp("ref_stores")
    frames, dims, times = _frames(n_frames=40, n_atoms=60, seed=2)
    out = {}
    for quant in ("int16", "int8", "f32"):
        d = str(root / quant)
        jingest(JMemoryReader(frames, dimensions=dims, times=times), d,
                chunk_frames=16, quant=quant)
        out[quant] = d
    return out, frames


class TestRoundTrip:
    @pytest.mark.parametrize("quant", ["int16", "int8", "f32"])
    def test_memory_ingest_byte_identical_to_jax(self, tmp_path, quant):
        frames, dims, times = _frames(n_frames=40, seed=1)
        a, b = str(tmp_path / "port"), str(tmp_path / "jax")
        s = ingest(MemoryReader(frames, dimensions=dims, times=times), a,
                   chunk_frames=16, quant=quant)
        js = jingest(JMemoryReader(frames, dimensions=dims, times=times),
                     b, chunk_frames=16, quant=quant)
        fa, fb = _store_files(a), _store_files(b)
        assert sorted(fa) == ["chunk-00000000.mdtc", "chunk-00000001.mdtc",
                              "chunk-00000002.mdtc", "manifest.json"]
        assert fa == fb
        for k in ("n_frames", "n_chunks", "bytes", "scale_overflow_chunks"):
            assert s[k] == js[k], k

    def test_xtc_ingest_byte_identical_to_jax(self, tmp_path):
        """Both packages ingest the same XTC path, so the manifests'
        ``source`` fields agree too."""
        rng = np.random.default_rng(5)
        frames = rng.normal(scale=9.0, size=(20, 30, 3)).astype(np.float32)
        xtc = str(tmp_path / "t.xtc")
        write_xtc(xtc, frames,
                  dimensions=np.array([40.0, 40, 40, 90, 90, 90]),
                  times=np.arange(20, dtype=np.float32))
        a, b = str(tmp_path / "port"), str(tmp_path / "jax")
        ingest(xtc, a, chunk_frames=8, quant="int16")
        jingest(xtc, b, chunk_frames=8, quant="int16")
        assert _store_files(a) == _store_files(b)
        assert store_meta(a)["source"] == xtc

    def test_int16_parity_and_metadata(self, tmp_path):
        src, frames = _source()
        out = str(tmp_path / "s16")
        summary = ingest(src, out, chunk_frames=16, quant="int16")
        assert summary["n_chunks"] == 3          # 16+16+8
        sr = StoreReader(out)
        assert sr.n_frames == 40 and sr.n_atoms == 60
        assert sr.quant == "int16" and sr.chunk_frames == 16
        got, boxes = sr.read_block(0, 40)
        tol = float(np.abs(frames).max()) * 1.05 / 32000.0
        assert float(np.abs(got - frames).max()) <= tol + 1e-6
        np.testing.assert_allclose(boxes[0], [40, 40, 40, 90, 90, 90])
        ts = sr[17]
        assert ts.frame == 17 and ts.time == pytest.approx(34.0)
        np.testing.assert_allclose(
            sr.frame_times(range(5, 9)), [10.0, 12.0, 14.0, 16.0])
        sel = np.arange(0, 60, 3)
        got_s, _ = sr.read_block(4, 36, sel=sel, step=4)
        assert got_s.shape == (8, 20, 3)
        assert float(np.abs(got_s - frames[4:36:4][:, sel]).max()) \
            <= tol + 1e-6


class TestStagingParity:
    @pytest.mark.parametrize("quant", ["int16", "int8", "f32"])
    @pytest.mark.parametrize("layout", ["interleaved", "planar"])
    @pytest.mark.parametrize("with_sel", [False, True])
    def test_stage_block_equals_jax_reader(self, ref_stores, quant, layout,
                                           with_sel):
        """The port's reader on a store the JAX package ingested stages
        the same (q, boxes, inv_scale) as the JAX package's reader, on
        a chunk-aligned block and on one that spans chunks."""
        stores, _ = ref_stores
        d = stores[quant]
        sr, jsr = StoreReader(d), JStoreReader(d)
        sel = np.arange(3, 57, 2) if with_sel else None
        # an f32 store stages in the wire format the fused path asks
        # for: int16, through the generic requantize
        request = "int16" if quant == "f32" else quant
        for start, stop in ((16, 32), (8, 40)):
            got = sr.stage_block(start, stop, sel, request, layout=layout)
            want = jsr.stage_block(start, stop, sel, request, layout=layout)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                g, w = np.asarray(g), np.asarray(w)
                assert g.dtype == w.dtype and g.shape == w.shape
                assert np.array_equal(g, w)
            n = 27 if with_sel else 60
            shape = ((3, stop - start, n) if layout == "planar"
                     else (stop - start, n, 3))
            assert got[0].shape == shape
            assert got[0].dtype == np.dtype(request)

    @pytest.mark.parametrize("quant", ["int16", "int8", "f32"])
    def test_float32_staging_and_read_block_equal_jax_reader(
            self, ref_stores, quant):
        stores, frames = ref_stores
        d = stores[quant]
        sr, jsr = StoreReader(d), JStoreReader(d)
        sel = np.arange(0, 60, 4)
        for args in ((0, 40), (5, 37, sel), (0, 40, None, 3)):
            g, gb = sr.read_block(*args)
            w, wb = jsr.read_block(*args)
            assert np.array_equal(g, w) and np.array_equal(gb, wb)
        block, boxes, inv = sr.stage_block(0, 24, sel)
        jblock, jboxes, jinv = jsr.stage_block(0, 24, sel)
        assert inv is None and jinv is None
        assert np.array_equal(block, jblock)
        assert np.array_equal(boxes, jboxes)
        if quant == "f32":
            np.testing.assert_array_equal(block, frames[:24][:, sel])

    def test_raw_slices_served_without_f32_decode(self, tmp_path):
        src, frames = _source()
        out = str(tmp_path / "s")
        ingest(src, out, chunk_frames=16, quant="int16")
        sr = StoreReader(out)
        sel = np.arange(10, 50)
        q, boxes, inv = sr.stage_block(16, 32, sel=sel, quantize="int16")
        assert q.dtype == np.int16 and q.shape == (16, 40, 3)
        assert isinstance(inv, np.float32) and boxes.shape == (16, 6)
        deq = q.astype(np.float32) * inv
        assert float(np.abs(deq - frames[16:32][:, sel]).max()) \
            <= float(inv) / 2 + 1e-6
        q2, _b2, inv2 = sr.stage_block(8, 40, sel=None, quantize=True)
        assert q2.shape == (32, 60, 3) and float(inv2) == float(inv)
        assert not sr._f32

    def test_mixed_scale_chunks_requantize_not_misdequantize(
            self, tmp_path):
        frames = np.zeros((16, 20, 3), dtype=np.float32)
        rng = np.random.default_rng(1)
        frames[:8] = rng.normal(scale=5.0, size=(8, 20, 3))
        frames[8:] = rng.normal(scale=500.0, size=(8, 20, 3))
        out, jout = str(tmp_path / "mixed"), str(tmp_path / "jmixed")
        summary = ingest(MemoryReader(frames), out, chunk_frames=8,
                         quant="int16")
        jingest(JMemoryReader(frames), jout, chunk_frames=8, quant="int16")
        assert summary["scale_overflow_chunks"] == 1
        man = store_meta(out)
        assert man["scale_overflow_chunks"] == 1
        scales = [c["inv_scale"] for c in man["chunks"]]
        assert scales[0] != scales[1]
        sr = StoreReader(out)
        q, _boxes, inv = sr.stage_block(0, 16, quantize="int16")
        assert q.dtype == np.int16
        deq = np.asarray(q, np.float32) * np.asarray(inv, np.float32)
        tol = float(np.abs(frames).max()) / 32000.0
        assert float(np.abs(deq - frames).max()) <= tol + 1e-6
        # the requantized span is the JAX package's, byte for byte
        jq, _jb, jinv = JStoreReader(jout).stage_block(0, 16,
                                                       quantize="int16")
        assert np.array_equal(q, jq) and np.array_equal(inv, jinv)

    def test_exact_slice_fetches(self, tmp_path):
        src, _frames = _source(n_frames=64)
        out = str(tmp_path / "slices")
        ingest(src, out, chunk_frames=8, quant="int16")

        class CountingBackend(LocalDirBackend):
            def __init__(self, root):
                super().__init__(root)
                self.fetched = []

            def get_bytes(self, name):
                self.fetched.append(name)
                return super().get_bytes(name)

        be = CountingBackend(out)
        sr = StoreReader(out, backend=be)
        be.fetched.clear()                       # drop the manifest get
        sr.stage_block(24, 40, quantize="int16")
        assert be.fetched == ["chunk-00000003.mdtc", "chunk-00000004.mdtc"]


class TestVerifiedReads:
    def test_corrupt_payload_rejected_typed_and_counted(self, tmp_path):
        src, _ = _source()
        out = str(tmp_path / "c")
        ingest(src, out, chunk_frames=16, quant="int16")
        _corrupt(os.path.join(out, "chunk-00000001.mdtc"), -5, 0x10)
        sr = StoreReader(out)
        before = _rejects()
        with pytest.raises(StoreCorruptError):
            sr.read_block(16, 32)
        assert _rejects() == before + 1
        # the staging fast path rejects the same bytes, typed
        with pytest.raises(StoreCorruptError):
            StoreReader(out).stage_block(16, 32, quantize="int16",
                                         layout="planar")
        assert _rejects() == before + 2
        assert sr.read_block(0, 16)[0].shape == (16, 60, 3)

    def test_corrupt_header_and_truncation_rejected(self, tmp_path):
        src, _ = _source(n_frames=8)
        out = str(tmp_path / "h")
        ingest(src, out, chunk_frames=8, quant="int16")
        path = os.path.join(out, "chunk-00000000.mdtc")
        orig = open(path, "rb").read()
        _corrupt(path, 20, 0x01)                 # inside the header JSON
        before = _rejects()
        with pytest.raises(IntegrityError):
            StoreReader(out).read_block(0, 8)
        with open(path, "wb") as f:
            f.write(orig[:-100])                 # truncated payload
        with pytest.raises(StoreCorruptError):
            StoreReader(out).read_block(0, 8)
        assert _rejects() == before + 2

    def test_swapped_self_valid_chunks_rejected(self, tmp_path):
        src, _ = _source(n_frames=32)
        out = str(tmp_path / "swap")
        ingest(src, out, chunk_frames=16, quant="int16")
        a = os.path.join(out, "chunk-00000000.mdtc")
        b = os.path.join(out, "chunk-00000001.mdtc")
        da, db = open(a, "rb").read(), open(b, "rb").read()
        with open(a, "wb") as f:
            f.write(db)
        with open(b, "wb") as f:
            f.write(da)
        before = _rejects()
        with pytest.raises(StoreCorruptError):
            StoreReader(out).read_block(0, 16)
        assert _rejects() == before + 1

    def test_missing_chunk_rejected_typed_and_counted(self, tmp_path):
        src, _ = _source(n_frames=32)
        out = str(tmp_path / "gone")
        ingest(src, out, chunk_frames=16, quant="int16")
        os.remove(os.path.join(out, "chunk-00000001.mdtc"))
        before = _rejects()
        with pytest.raises(StoreUnavailableError):
            StoreReader(out).read_block(16, 32)
        assert _rejects() == before + 1
        snap = METRICS.snapshot()["mdtpu_store_chunk_crc_rejects_total"]
        assert any("unavailable" in k for k in snap["values"])

    def test_corrupt_manifest_rejected_and_counted(self, tmp_path):
        src, _ = _source(n_frames=8)
        out = str(tmp_path / "m")
        ingest(src, out, chunk_frames=8, quant="int16")
        mpath = os.path.join(out, "manifest.json")
        man = json.loads(open(mpath).read())
        man["n_frames"] = 9999                   # tampered, CRC stale
        with open(mpath, "w") as f:
            f.write(json.dumps(man))
        before = _counter("mdtpu_integrity_corrupt_total")
        with pytest.raises(StoreCorruptError):
            StoreReader(out)
        assert _counter("mdtpu_integrity_corrupt_total") == before + 1
        assert is_store(out)
        with pytest.raises(StoreCorruptError):
            store_meta(out)
        with pytest.raises(StoreCorruptError):
            Universe(Topology(**_topo_kw(60)), out)

    def test_reingest_kills_manifest_first_and_sweeps_orphans(
            self, tmp_path):
        src, _ = _source(n_frames=16)
        out = str(tmp_path / "reingest")
        ingest(src, out, chunk_frames=4, quant="int16")     # 4 chunks
        assert is_store(out)

        class CrashingReader(MemoryReader):
            def read_block(self, start, stop, sel=None, step=1):
                if start > 0:
                    raise RuntimeError("simulated ingest crash")
                return MemoryReader.read_block(self, start, stop,
                                               sel=sel, step=step)

        crasher = CrashingReader(_frames(n_frames=16, seed=3)[0])
        with pytest.raises(RuntimeError):
            ingest(crasher, out, chunk_frames=8, quant="int16")
        assert not is_store(out)
        ingest(src, out, chunk_frames=8, quant="int16")     # 2 chunks
        names = sorted(f for f in os.listdir(out) if f.startswith("chunk-"))
        assert names == ["chunk-00000000.mdtc", "chunk-00000001.mdtc"]


class TestUniverse:
    def test_universe_opens_store_dir(self, tmp_path):
        src, _ = _source(n_frames=8, n_atoms=20)
        out = str(tmp_path / "u")
        ingest(src, out, chunk_frames=4, quant="int16")
        u = Universe(Topology(**_topo_kw(20)), out)
        assert isinstance(u.trajectory, StoreReader)
        assert u.trajectory.n_frames == 8
        with pytest.raises(ValueError, match="not an ingested block"):
            Universe(Topology(**_topo_kw(20)), str(tmp_path))
        with pytest.raises(ValueError, match="20 atoms"):
            StoreReader(out, n_atoms=21)


@pytest.fixture(scope="module")
def rmsf_store(tmp_path_factory):
    """A 48-frame, 60-atom int16 store the JAX package ingested (chunk
    16, three blocks at batch 16): (dir, source frames)."""
    rng = np.random.default_rng(11)
    base = rng.normal(scale=12.0, size=(60, 3)).astype(np.float32)
    frames = base[None] + rng.normal(
        scale=0.4, size=(48, 60, 3)).astype(np.float32)
    out = str(tmp_path_factory.mktemp("rmsf") / "store16")
    jingest(JMemoryReader(frames), out, chunk_frames=16, quant="int16")
    return out, frames


class TestFusedFromStore:
    def test_store_to_kernel_stages_planar_without_host_f32(self,
                                                            rmsf_store):
        """int16 store chunks → raw-slice planar staging → the fused
        engine (its plain version on the CPU).  The reader's f32 decode
        cache holds at most chunk 0 (the reference frame), while the
        chunk-read, planar-repack and fused-block counters advance."""
        out, frames = rmsf_store
        topo = Topology(**_topo_kw(60))
        u = Universe(topo, out)
        sr = u.trajectory
        chunks0 = _counter("mdtpu_store_chunks_read_total")
        repacks0 = _counter("mdtpu_fused_planar_repacks_total")
        blocks0 = _counter("mdtpu_fused_blocks_total")
        r = AlignedRMSF(u, select="name CA", engine="fused").run(
            backend="torch", device="cpu", batch_size=16,
            transfer_dtype="int16")
        assert _counter("mdtpu_store_chunks_read_total") >= chunks0 + 3
        assert _counter("mdtpu_fused_planar_repacks_total") >= repacks0 + 3
        # 3 blocks in each of the two passes
        assert _counter("mdtpu_fused_blocks_total") == blocks0 + 6
        assert set(sr._f32) <= {0}, (
            f"staged blocks decoded host f32 chunks {sorted(sr._f32)}")
        u_mem = Universe(topo, MemoryReader(frames))
        oracle = AlignedRMSF(u_mem, select="name CA").run(backend="serial")
        np.testing.assert_allclose(r.results.rmsf, oracle.results.rmsf,
                                   atol=1e-2)

    def test_fused_matches_jax_pallas_and_wire_oracle(self, rmsf_store,
                                                      monkeypatch):
        """The port's fused run and the JAX package's Pallas kernel
        (interpret mode on the CPU) over one store directory, each
        through its own package's StoreReader; and the serial float64
        oracle on the store's dequantized coordinates."""
        monkeypatch.setenv("MDTPU_RMSF_PALLAS", "1")
        out, _ = rmsf_store
        run = dict(batch_size=16, transfer_dtype="int16")
        port = AlignedRMSF(Universe(Topology(**_topo_kw(60)), out),
                           select="name CA", engine="fused").run(
            backend="torch", device="cpu", **run)
        ref = JAlignedRMSF(JUniverse(JTopology(**_topo_kw(60)),
                                     JStoreReader(out)),
                           select="name CA", engine="fused").run(
            backend="jax", **run)
        np.testing.assert_allclose(port.results.rmsf,
                                   np.asarray(ref.results.rmsf), atol=5e-4)
        wire = AlignedRMSF(Universe(Topology(**_topo_kw(60)),
                                    StoreReader(out)),
                           select="name CA").run(backend="serial")
        np.testing.assert_allclose(port.results.rmsf, wire.results.rmsf,
                                   atol=1e-3)
        generic = AlignedRMSF(Universe(Topology(**_topo_kw(60)), out),
                              select="name CA").run(
            backend="torch", device="cpu", **run)
        np.testing.assert_allclose(port.results.rmsf,
                                   generic.results.rmsf, atol=5e-4)


class TestExecutorBoundary:
    def test_torch_int16_parity_and_device_cache(self, tmp_path):
        src, frames = _source(n_frames=32, n_atoms=40)
        out = str(tmp_path / "exec")
        ingest(src, out, chunk_frames=8, quant="int16")
        topo = Topology(**_topo_kw(40))
        u_mem = Universe(topo, src)
        u_store = Universe(topo, StoreReader(out))
        # the store dir IS the reader's cache-key namespace
        assert reader_fingerprint(u_store.trajectory) == out
        s = AlignedRMSF(u_mem, select="heavy").run(backend="serial")
        cache = DeviceBlockCache()
        run = dict(backend="torch", device="cpu", batch_size=8,
                   transfer_dtype="int16", block_cache=cache)
        a1 = AlignedRMSF(u_store, select="heavy").run(**run)
        err = float(np.abs(a1.results.rmsf - s.results.rmsf).max())
        assert err < 1e-3, err
        m0 = cache.misses
        a2 = AlignedRMSF(u_store, select="heavy").run(**run)
        assert cache.misses == m0 and cache.hits > 0
        np.testing.assert_array_equal(a2.results.rmsf, a1.results.rmsf)


class TestCLI:
    def test_ingest_cli_roundtrip_and_idempotence(self, tmp_path, capsys):
        from mdanalysis_mpi_tpu_torch.io.store.cli import ingest_main

        rng = np.random.default_rng(5)
        frames = rng.normal(scale=9.0, size=(12, 30, 3)).astype(np.float32)
        xtc = str(tmp_path / "t.xtc")
        write_xtc(xtc, frames)
        out = str(tmp_path / "t.store")
        assert ingest_main([xtc, "--out", out, "--chunk-frames", "4",
                            "--quant", "int16"]) == 0
        rec = json.loads(capsys.readouterr().out.strip())
        assert rec["n_chunks"] == 3 and rec["store_ingest_fps"] > 0
        assert ingest_main([xtc, "--out", out]) == 0
        rec2 = json.loads(capsys.readouterr().out.strip())
        assert rec2["already_ingested"] is True and rec2["n_chunks"] == 3
        # what the command line wrote, the JAX package writes too
        jout = str(tmp_path / "j.store")
        jingest(xtc, jout, chunk_frames=4, quant="int16")
        assert _store_files(out) == _store_files(jout)
        assert ingest_main([]) == 2

    def test_ensemble_ingest_dedups_like_jax(self, tmp_path, capsys):
        """Two replicas of one XTC through ``--out-root``: the second
        member's chunks all come from the shared content-addressed pool,
        and each member store is the JAX package's, byte for byte."""
        from mdanalysis_mpi_tpu.io.store.parallel import (
            ingest_many as jingest_many)

        from mdanalysis_mpi_tpu_torch.io.store.cli import ingest_main
        from mdanalysis_mpi_tpu_torch.io.store.parallel import member_dir

        rng = np.random.default_rng(8)
        frames = rng.normal(scale=9.0, size=(12, 30, 3)).astype(np.float32)
        xtc = str(tmp_path / "r.xtc")
        write_xtc(xtc, frames)
        root, jroot = str(tmp_path / "ens"), str(tmp_path / "jens")
        assert ingest_main([xtc, xtc, "--out-root", root, "--jobs", "1",
                            "--chunk-frames", "4"]) == 0
        rec = json.loads(capsys.readouterr().out.strip())
        assert rec["ok"] is True and rec["n_members"] == 2
        assert rec["dedup_ratio"] == 0.5         # the second copy dedups
        j = jingest_many([xtc, xtc], jroot, jobs=1, chunk_frames=4)
        assert j["dedup_ratio"] == rec["dedup_ratio"]
        for i in range(2):
            assert _store_files(member_dir(root, i)) \
                == _store_files(member_dir(jroot, i))
            got, _ = StoreReader(member_dir(root, i)).read_block(0, 12)
            assert got.shape == (12, 30, 3)

    def test_ingest_smoke_gate(self, capsys):
        from mdanalysis_mpi_tpu_torch.io.store.cli import _smoke

        assert _smoke() == 0
        rec = json.loads(capsys.readouterr().out.strip())
        assert rec["ok"] is True
        assert rec["corrupt_chunk_rejected"] == "StoreCorruptError"
        assert rec["remote_corrupt_rejected"] == "StoreCorruptError"
        assert rec["remote_dedup_ratio"] == 1.0


class TestLiveIngest:
    def test_follow_reader_grows_and_seal_promotes_manifest(self,
                                                           tmp_path):
        frames, _, _ = _frames(n_frames=24, n_atoms=30, seed=7)
        store = str(tmp_path / "live")
        live = LiveIngest(out=store, n_atoms=30, chunk_frames=8)
        for f in frames[:8]:
            live.append(f)
        assert os.path.exists(os.path.join(store, "manifest.tail.json"))
        assert not os.path.exists(os.path.join(store, "manifest.json"))
        sr = StoreReader(store, follow=True)
        assert sr.n_frames == 8 and not sr.sealed
        # an open feed that stopped growing is a stall, not the end
        with pytest.raises(TimeoutError):
            sr.wait_frames(9, timeout_s=0.05, poll_interval_s=0.01)
        live.append(frames[8:19])                # one more chunk + 3
        assert sr.refresh() is True and sr.n_frames == 16
        assert sr.refresh() is False             # nothing new sealed
        live.seal()
        assert sr.wait_frames(19, timeout_s=1.0, poll_interval_s=0.01) \
            == 19
        assert sr.sealed
        with pytest.raises(StoreEndOfFeed):
            sr.wait_frames(20, timeout_s=0.05, poll_interval_s=0.01)
        # the seal promoted the tail to the closed manifest
        assert not os.path.exists(os.path.join(store, "manifest.tail.json"))
        closed = StoreReader(store)
        assert closed.n_frames == 19
        got, _ = closed.read_block(0, 19)
        tol = float(np.abs(frames[:19]).max()) * 1.05 / 32000.0
        assert float(np.abs(got - frames[:19]).max()) <= tol + 1e-6
        # the JAX package's reader reads the port's live-sealed store
        jgot, _ = JStoreReader(store).read_block(0, 19)
        assert np.array_equal(got, jgot)
