"""Twin of ``tests/test_trajio.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Native trajectory I/O tests: XTC/DCD round trips, fuzzing, offset
index, random access, Universe integration (SURVEY.md §4: "XTC/DCD
decode vs hand-built fixtures... we must also write writers")."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.topology import make_protein_topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.dcd import DCDReader, write_dcd
from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


RNG = np.random.default_rng(7)


def _traj(f=6, n=50, scale=20.0):
    return (RNG.normal(scale=scale, size=(f, n, 3))).astype(np.float32)


# ---------------- XTC ----------------

class TestXTC:
    def test_round_trip(self, tmp_path):
        coords = _traj()
        dims = np.array([40.0, 40.0, 40.0, 90.0, 90.0, 90.0])
        path = str(tmp_path / "t.xtc")
        write_xtc(path, coords, dimensions=dims,
                  times=np.arange(6, dtype=np.float32) * 2.0)
        r = XTCReader(path)
        assert r.n_frames == 6
        assert r.n_atoms == 50
        for i in range(6):
            ts = r[i]
            # precision 1000 => 0.01 A resolution
            np.testing.assert_allclose(ts.positions, coords[i], atol=0.02)
            np.testing.assert_allclose(ts.dimensions, dims, atol=1e-3)
            assert ts.time == pytest.approx(2.0 * i)

    def test_small_system_uncompressed(self, tmp_path):
        coords = _traj(f=3, n=5)          # <= 9 atoms: raw float path
        path = str(tmp_path / "s.xtc")
        write_xtc(path, coords)
        r = XTCReader(path)
        np.testing.assert_allclose(r[1].positions, coords[1], atol=1e-4)

    def test_random_access_and_block(self, tmp_path):
        coords = _traj(f=10, n=30)
        path = str(tmp_path / "t.xtc")
        write_xtc(path, coords)
        r = XTCReader(path)
        np.testing.assert_allclose(r[7].positions, coords[7], atol=0.02)
        np.testing.assert_allclose(r[2].positions, coords[2], atol=0.02)
        block, boxes = r.read_block(3, 8)
        assert block.shape == (5, 30, 3)
        assert boxes is None              # no box written
        np.testing.assert_allclose(block, coords[3:8], atol=0.02)
        sel = np.array([0, 5, 7])
        blk, _ = r.read_block(3, 8, sel=sel)
        np.testing.assert_allclose(blk, coords[3:8][:, sel], atol=0.02)

    def test_offset_cache(self, tmp_path):
        coords = _traj(f=4, n=20)
        path = str(tmp_path / "t.xtc")
        write_xtc(path, coords)
        XTCReader(path)
        cache = tmp_path / "t.xtc.mdtpu_offsets.npz"
        assert cache.exists()
        r2 = XTCReader(path)              # second open: cache hit
        assert r2.n_frames == 4
        # stale cache after rewrite is ignored
        write_xtc(path, _traj(f=9, n=20))
        import os
        os.utime(path, (os.path.getmtime(path) + 5,) * 2)
        assert XTCReader(path).n_frames == 9

    def test_fuzz_round_trip(self, tmp_path):
        """Fuzz the 3dfcoord codec: many shapes/scales incl. clustered
        (run-friendly) and scattered coordinates (SURVEY.md §7 hard
        parts: 'fuzz-tested round-trip against our own writer')."""
        for seed in range(12):
            rng = np.random.default_rng(seed)
            n = int(rng.integers(10, 400))
            f = int(rng.integers(1, 4))
            style = seed % 3
            if style == 0:      # scattered
                c = rng.normal(scale=50.0, size=(f, n, 3))
            elif style == 1:    # water-like clusters of 3
                centers = rng.uniform(0, 30, size=(f, (n + 2) // 3, 1, 3))
                c = (centers + rng.normal(scale=0.5, size=(f, (n + 2) // 3, 3, 3)))
                c = c.reshape(f, -1, 3)[:, :n]
            else:               # tight cluster (all-run path)
                c = rng.normal(scale=0.8, size=(f, n, 3)) + 10.0
            c = c.astype(np.float32)
            path = str(tmp_path / f"fuzz{seed}.xtc")
            write_xtc(path, c)
            r = XTCReader(path)
            got = np.stack([r[i].positions for i in range(f)])
            np.testing.assert_allclose(got, c, atol=0.011,
                                       err_msg=f"seed={seed} style={style}")

    def test_precision_knob(self, tmp_path):
        coords = _traj(f=2, n=40)
        path = str(tmp_path / "p.xtc")
        write_xtc(path, coords, precision=10000.0)   # 0.001 A
        r = XTCReader(path)
        np.testing.assert_allclose(r[0].positions, coords[0], atol=2e-3)

    def test_corrupt_file(self, tmp_path):
        path = tmp_path / "bad.xtc"
        path.write_bytes(b"\x00\x01\x02\x03" * 10)
        with pytest.raises(IOError):
            XTCReader(str(path))

    def test_universe_integration(self, tmp_path):
        top = make_protein_topology(10)
        coords = _traj(f=5, n=top.n_atoms)
        path = str(tmp_path / "u.xtc")
        write_xtc(path, coords)
        u = Universe(top, path)
        assert u.trajectory.n_frames == 5
        ca = u.select_atoms("name CA")
        assert ca.positions.shape == (10, 3)
        # copy() reopens an independent cursor (RMSF.py:57 over files)
        ref = u.copy()
        u.trajectory[4]; ref.trajectory[1]
        assert (u.trajectory.ts.frame, ref.trajectory.ts.frame) == (4, 1)


# ---------------- DCD ----------------

class TestDCD:
    def test_round_trip(self, tmp_path):
        coords = _traj(f=7, n=33)
        dims = np.array([25.0, 30.0, 35.0, 90.0, 90.0, 90.0])
        path = str(tmp_path / "t.dcd")
        write_dcd(path, coords, dimensions=dims)
        r = DCDReader(path)
        assert r.n_frames == 7
        assert r.n_atoms == 33
        for i in (0, 3, 6):
            ts = r[i]
            np.testing.assert_allclose(ts.positions, coords[i], atol=1e-5)
            np.testing.assert_allclose(ts.dimensions, dims, atol=1e-5)

    def test_no_box(self, tmp_path):
        coords = _traj(f=3, n=12)
        path = str(tmp_path / "nb.dcd")
        write_dcd(path, coords)
        r = DCDReader(path)
        assert r[0].dimensions is None
        block, boxes = r.read_block(0, 3)
        np.testing.assert_allclose(block, coords, atol=1e-5)
        assert boxes is None

    def test_block_and_selection(self, tmp_path):
        coords = _traj(f=6, n=20)
        path = str(tmp_path / "t.dcd")
        write_dcd(path, coords)
        r = DCDReader(path)
        sel = np.array([1, 3, 19])
        blk, _ = r.read_block(2, 5, sel=sel)
        np.testing.assert_allclose(blk, coords[2:5][:, sel], atol=1e-5)

    def test_cosine_cell_heuristic(self, tmp_path):
        """CHARMM-style cosines decode to the same angles as degrees."""
        coords = _traj(f=1, n=8)
        dims = np.array([20.0, 20.0, 20.0, 60.0, 90.0, 120.0])
        path = str(tmp_path / "cos.dcd")
        write_dcd(path, coords, dimensions=dims)
        # patch the cell record in place to cosines
        import struct
        raw = bytearray(open(path, "rb").read())
        # find the 48-byte cell record: first frame starts after header
        idx = raw.find(struct.pack("<I", 48))
        a, g, b, be, al, c = struct.unpack_from("<6d", raw, idx + 4)
        struct.pack_into("<6d", raw, idx + 4, a,
                         np.cos(np.radians(g)), b,
                         np.cos(np.radians(be)), np.cos(np.radians(al)), c)
        open(path, "wb").write(bytes(raw))
        r = DCDReader(path)
        np.testing.assert_allclose(r[0].dimensions, dims, atol=1e-5)

    def test_corrupt(self, tmp_path):
        path = tmp_path / "bad.dcd"
        path.write_bytes(b"garbage!" * 8)
        with pytest.raises(IOError):
            DCDReader(str(path))

    def test_universe_and_analysis_on_dcd(self, tmp_path):
        """BASELINE config-1 shape: topology + DCD → RMSF pipeline."""
        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF

        top = make_protein_topology(8)
        base = RNG.normal(scale=5.0, size=(top.n_atoms, 3)).astype(np.float32)
        coords = base + RNG.normal(scale=0.2, size=(12, top.n_atoms, 3)).astype(np.float32)
        path = str(tmp_path / "adk.dcd")
        write_dcd(path, coords)
        u = Universe(top, path)
        r = AlignedRMSF(u, select="protein and name CA").run(backend="torch",
                                                             batch_size=4)
        s = AlignedRMSF(u, select="protein and name CA").run(backend="serial")
        np.testing.assert_allclose(r.results.rmsf, s.results.rmsf,
                                   rtol=5e-3, atol=1e-4)


# ---------------- TRR ----------------

class TestTRR:
    def test_round_trip(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.trr import TRRReader, write_trr

        coords = _traj()
        dims = np.array([40.0, 40.0, 40.0, 90.0, 90.0, 90.0])
        path = str(tmp_path / "t.trr")
        write_trr(path, coords, dimensions=dims,
                  times=np.arange(6, dtype=np.float32) * 2.0,
                  steps=np.arange(6) * 100)
        r = TRRReader(path)
        assert r.n_frames == 6
        assert r.n_atoms == 50
        for i in range(6):
            ts = r[i]
            # TRR is uncompressed f32 in nm: only nm->A f32 rounding
            np.testing.assert_allclose(ts.positions, coords[i], atol=1e-4)
            np.testing.assert_allclose(ts.dimensions, dims, atol=1e-3)
            assert ts.time == pytest.approx(2.0 * i)

    def test_boxless(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.trr import TRRReader, write_trr

        path = str(tmp_path / "nb.trr")
        coords = _traj(f=3, n=7)
        write_trr(path, coords)
        r = TRRReader(path)
        assert r[0].dimensions is None
        block, boxes = r.read_block(0, 3)
        assert boxes is None
        np.testing.assert_allclose(block, coords, atol=1e-4)

    def test_read_block_with_selection(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.trr import TRRReader, write_trr

        coords = _traj(f=5, n=30)
        path = str(tmp_path / "sel.trr")
        write_trr(path, coords,
                  dimensions=np.array([50, 50, 50, 90, 90, 90.0]))
        r = TRRReader(path)
        sel = np.array([0, 3, 29])
        block, boxes = r.read_block(1, 4, sel=sel)
        assert block.shape == (3, 3, 3)
        np.testing.assert_allclose(block, coords[1:4][:, sel], atol=1e-4)
        assert boxes.shape == (3, 6)

    def test_offset_cache_reused(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io import trr as trr_mod

        coords = _traj(f=4, n=10)
        path = str(tmp_path / "c.trr")
        trr_mod.write_trr(path, coords)
        r1 = trr_mod.TRRReader(path)
        assert len(r1._offsets) == 4
        import os
        assert os.path.exists(trr_mod._offset_cache_path(path))
        r2 = trr_mod.TRRReader(path)        # loads via cache
        np.testing.assert_array_equal(r1._offsets, r2._offsets)

    def test_double_precision_frames(self, tmp_path):
        """f64 TRR (box_size=72, x_size=24N) decodes through the same
        width-inference path as upstream nFloatSize()."""
        from mdanalysis_mpi_tpu_torch.io.trr import _MAGIC, _TAG, TRRReader

        coords = RNG.normal(scale=2.0, size=(2, 4, 3))
        box = np.diag([4.0, 4.0, 4.0])
        path = str(tmp_path / "d.trr")
        with open(path, "wb") as f:
            for i in range(2):
                head = np.array([_MAGIC, len(_TAG) + 1], dtype=">i4").tobytes()
                head += np.array([len(_TAG)], dtype=">i4").tobytes() + _TAG
                fields = [0, 0, 72, 0, 0, 0, 0, 24 * 4, 0, 0, 4, i, 0]
                head += np.asarray(fields, dtype=">i4").tobytes()
                head += np.asarray([0.5 * i, 0.0], dtype=">f8").tobytes()
                f.write(head)
                f.write(np.asarray(box, dtype=">f8").tobytes())
                f.write(np.asarray(coords[i], dtype=">f8").tobytes())
        r = TRRReader(path)
        assert r.n_frames == 2
        np.testing.assert_allclose(r[1].positions, coords[1] * 10.0,
                                   rtol=1e-6)
        np.testing.assert_allclose(r[1].dimensions[:3], [40, 40, 40],
                                   atol=1e-6)

    def test_universe_integration(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.gro import write_gro
        from mdanalysis_mpi_tpu_torch.io.trr import write_trr

        top = make_protein_topology(n_residues=5)
        coords = _traj(f=4, n=top.n_atoms, scale=5.0)
        gro = str(tmp_path / "u.gro")
        trr = str(tmp_path / "u.trr")
        write_gro(gro, top, coords[0])
        write_trr(trr, coords)
        u = Universe(gro, trr)
        assert u.trajectory.n_frames == 4
        ca = u.select_atoms("name CA")
        assert ca.n_atoms == 5

    def test_bad_magic_rejected(self, tmp_path):
        path = str(tmp_path / "bad.trr")
        with open(path, "wb") as f:
            f.write(b"\x00" * 64)
        from mdanalysis_mpi_tpu_torch.io.trr import TRRReader

        with pytest.raises(IOError, match="magic"):
            TRRReader(path)


class TestHostStageCache:
    """Host staged-block cache (ReaderBase.stage_cached): re-running an
    analysis over the same (trajectory, selection) must not re-pay the
    gather/quantize on the single staging core."""

    def _reader(self):
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        rng = np.random.default_rng(7)
        return MemoryReader(rng.normal(size=(8, 40, 3)).astype(np.float32))

    def test_hit_returns_identical_blocks(self):
        r = self._reader()
        sel = np.array([1, 5, 9, 30])
        a = r.stage_cached(0, 4, sel=sel, quantize=False)
        b = r.stage_cached(0, 4, sel=sel, quantize=False)
        assert b[0] is a[0]  # cached object, no re-gather
        cache = r.__dict__["_host_stage_cache"]
        assert cache.hits == 1 and cache.misses == 1
        ref, _ = r.read_block(0, 4, sel=sel)
        np.testing.assert_array_equal(a[0], ref)

    def test_keys_separate_selection_window_and_dtype(self):
        r = self._reader()
        sel = np.array([1, 5])
        base = r.stage_cached(0, 4, sel=sel)
        assert r.stage_cached(0, 4, sel=np.array([2, 6]))[0] is not base[0]
        assert r.stage_cached(4, 8, sel=sel)[0] is not base[0]
        q = r.stage_cached(0, 4, sel=sel, quantize=True)
        assert q[0].dtype == np.int16 and base[0].dtype == np.float32
        # dequantized cached block matches an uncached quantize pass
        # within resolution (scales may differ: adaptive one-pass path)
        q2 = r.stage_block(0, 4, sel=sel, quantize=True)
        np.testing.assert_allclose(
            q[0].astype(np.float32) * q[2],
            q2[0].astype(np.float32) * q2[2], atol=1e-3)

    def test_env_disables(self, monkeypatch):
        monkeypatch.setenv("MDTPU_HOST_STAGE_CACHE_MB", "0")
        r = self._reader()
        a = r.stage_cached(0, 4)
        b = r.stage_cached(0, 4)
        assert a[0] is not b[0]
        assert "_host_stage_cache" not in r.__dict__

    def test_cap_stops_insertion(self, monkeypatch):
        # cap below one block: nothing is stored, results still correct
        monkeypatch.setenv("MDTPU_HOST_STAGE_CACHE_MB", "0.0001")
        r = self._reader()
        a = r.stage_cached(0, 8)
        b = r.stage_cached(0, 8)
        assert a[0] is not b[0]
        np.testing.assert_array_equal(a[0], b[0])

    def test_executor_path_uses_cache(self):
        """A second torch-backend run over the same universe+selection
        serves staging from the host cache."""
        from mdanalysis_mpi_tpu_torch.analysis import RMSF

        from mdanalysis_mpi_tpu_torch.core.topology import make_protein_topology
        top = make_protein_topology(n_residues=8)
        rng = np.random.default_rng(3)
        coords = rng.normal(size=(6, top.n_atoms, 3)).astype(np.float32)
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
        u = Universe(top, MemoryReader(coords))
        ag = u.select_atoms("name CA")
        r1 = RMSF(ag).run(backend="torch", batch_size=4)
        cache = u.trajectory.__dict__.get("_host_stage_cache")
        assert cache is not None and cache.misses >= 1
        hits_before = cache.hits
        r2 = RMSF(ag).run(backend="torch", batch_size=4)
        assert cache.hits > hits_before
        np.testing.assert_allclose(r1.results.rmsf, r2.results.rmsf)


class TestAdaptiveQuantize:
    """One-pass scaled int16 staging (stage_gather_quantize_i16_scaled):
    later blocks quantize in a single streaming pass against the first
    block's range; range growth falls back to the exact two-pass kernel."""

    def _reader(self, coords):
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        return MemoryReader(coords)

    def test_scaled_path_matches_resolution(self):
        rng = np.random.default_rng(0)
        r = self._reader(rng.normal(scale=10, size=(8, 100, 3)).astype(np.float32))
        sel = np.arange(0, 100, 2)
        q1, _, s1 = r.stage_block(0, 4, sel=sel, quantize=True)  # seeds hint
        assert max(r.__dict__.get("_quant_max_hints", {}).values(),
                   default=0.0) > 0.0
        q2, _, s2 = r.stage_block(4, 8, sel=sel, quantize=True)  # one-pass
        blk2, _ = r.read_block(4, 8, sel=sel)
        err = np.abs(q2.astype(np.float32) * s2 - blk2).max()
        # resolution = max|x| * 1.05 / 32000 ≈ 1e-3 for this range
        assert err < 2e-3

    def test_overflow_requantizes_exactly(self):
        rng = np.random.default_rng(1)
        small = rng.normal(scale=10, size=(4, 100, 3)).astype(np.float32)
        big = rng.normal(scale=300, size=(4, 100, 3)).astype(np.float32)
        r = self._reader(np.concatenate([small, big]))
        sel = np.arange(100)
        r.stage_block(0, 4, sel=sel, quantize=True)
        hints = r.__dict__["_quant_max_hints"]
        hint_before = max(hints.values())
        q, _, s = r.stage_block(4, 8, sel=sel, quantize=True)
        blk, _ = r.read_block(4, 8, sel=sel)
        err = np.abs(q.astype(np.float32) * s - blk).max()
        assert err < 0.05          # exact per-block scale, NOT clipped
        assert max(hints.values()) > hint_before

    def test_hints_scoped_per_selection(self):
        """A wide-coordinate selection must not coarsen the quantization
        resolution of a narrow one on the same reader."""
        rng = np.random.default_rng(3)
        coords = rng.normal(scale=1.0, size=(8, 100, 3)).astype(np.float32)
        coords[:, 50:] *= 1000.0          # atoms 50+ span a huge range
        r = self._reader(coords)
        wide = np.arange(100)
        narrow = np.arange(50)
        r.stage_block(0, 4, sel=wide, quantize=True)    # seeds wide hint
        r.stage_block(0, 4, sel=narrow, quantize=True)  # seeds narrow hint
        q, _, s = r.stage_block(4, 8, sel=narrow, quantize=True)
        blk, _ = r.read_block(4, 8, sel=narrow)
        err = np.abs(q.astype(np.float32) * s - blk).max()
        # resolution follows the narrow selection's own ~5 A range
        # (~2e-4), not the wide selection's ~5000 A range (~0.2)
        assert err < 2e-3

    def test_matches_numpy_fallback_semantics(self):
        """Native exact kernel == NumPy quantize_block bit-for-bit (the
        seeding path); the scaled path dequantizes to the same values
        within its coarser-by-5% resolution."""
        from mdanalysis_mpi_tpu_torch.io import native
        from mdanalysis_mpi_tpu_torch.parallel.executors import quantize_block

        rng = np.random.default_rng(2)
        src = rng.normal(scale=25, size=(3, 64, 3)).astype(np.float32)
        sel = np.arange(0, 64, 4)
        qn, sn = native.stage_gather_quantize(src, sel)
        qp, sp = quantize_block(src[:, sel])
        np.testing.assert_array_equal(qn, qp)
        assert sn == sp


class TestTRRWriteValidation:
    """write_trr validates per-frame metadata lengths up front so a
    mismatch cannot leave a partially written file (ADVICE r1)."""

    def test_short_times_rejected_before_write(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.trr import write_trr

        path = tmp_path / "x.trr"
        coords = np.zeros((4, 3, 3), np.float32)
        with pytest.raises(ValueError, match="times"):
            write_trr(str(path), coords, times=np.zeros(2))
        with pytest.raises(ValueError, match="steps"):
            write_trr(str(path), coords, steps=np.arange(3))
        with pytest.raises(ValueError, match="dimensions"):
            write_trr(str(path), coords, dimensions=np.zeros((2, 6)))
        assert not path.exists()


def test_xtc_decode_thread_count_independent(tmp_path, monkeypatch):
    """Frame-parallel decode (MDTPU_DECODE_THREADS) must be bit-identical
    to the sequential path — workers decode disjoint frame ranges from
    independent file handles."""
    import numpy as np

    from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc

    rng = np.random.default_rng(7)
    frames = rng.normal(scale=8.0, size=(13, 500, 3)).astype(np.float32)
    path = str(tmp_path / "t.xtc")
    write_xtc(path, frames, dimensions=np.array([40.0, 40, 40, 90, 90, 90]))
    r = XTCReader(path)
    seq, seq_box = r.read_block(0, 13)
    for n in ("3", "16"):               # uneven split; threads > frames
        monkeypatch.setenv("MDTPU_DECODE_THREADS", n)
        thr, thr_box = r.read_block(0, 13)
        np.testing.assert_array_equal(seq, thr)
        np.testing.assert_array_equal(seq_box, thr_box)


def test_trr_velocities_forces_roundtrip(tmp_path):
    """TRR frames carrying velocities/forces expose them on the Timestep
    in upstream units (A/ps, kJ/(mol.A)); frames without them read None."""
    import numpy as np

    from mdanalysis_mpi_tpu_torch.io.trr import TRRReader, write_trr

    rng = np.random.default_rng(3)
    x = rng.normal(scale=5.0, size=(4, 60, 3)).astype(np.float32)
    v = rng.normal(scale=0.5, size=x.shape).astype(np.float32)
    fo = rng.normal(scale=50.0, size=x.shape).astype(np.float32)
    path = str(tmp_path / "vf.trr")
    write_trr(path, x, dimensions=np.array([30.0, 30, 30, 90, 90, 90]),
              velocities=v, forces=fo)
    r = TRRReader(path)
    ts = r[2]
    np.testing.assert_allclose(ts.positions, x[2], atol=2e-3)
    np.testing.assert_allclose(ts.velocities, v[2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.forces, fo[2], rtol=1e-5, atol=1e-4)
    # position-only file: attributes stay None
    path2 = str(tmp_path / "xonly.trr")
    write_trr(path2, x)
    ts2 = TRRReader(path2)[0]
    assert ts2.velocities is None and ts2.forces is None
    # copy() carries them
    c = ts.copy()
    np.testing.assert_array_equal(c.velocities, ts.velocities)


class TestCodecHypothesisFuzz:
    """Property-based round-trip fuzz of the XTC 3dfcoord codec — the
    most safety-critical native code (hand-written bit packing).
    Property: any finite coordinate set within the format's 2^21
    fixed-point cap round-trips within half a quantization step, across
    the small-system (lsize <= 9, uncompressed floats) and compressed
    paths, single and multi-frame, including amplitudes driven up near
    the cap."""

    hyp = pytest.importorskip("hypothesis")
    given, settings, st = hyp.given, hyp.settings, hyp.strategies

    @given(
        n_atoms=st.integers(1, 40),
        n_frames=st.integers(1, 3),
        cap_fraction=st.floats(1e-6, 0.9),
        precision=st.sampled_from([100.0, 1000.0, 10000.0]),
        seed=st.integers(0, 2**16),
    )
    @settings(max_examples=40, deadline=None)
    def test_roundtrip_within_precision(self, n_atoms, n_frames,
                                        cap_fraction, precision, seed,
                                        tmp_path_factory):
        from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc

        # amplitude as a fraction of the codec's fixed-point cap
        # (|x_nm * precision| < 2^21), so the fuzz reaches near-cap
        # magnitudes at every precision
        amp = (2 ** 21 / precision) * 10.0 * cap_fraction
        rng = np.random.default_rng(seed)
        frames = (rng.uniform(-amp, amp, size=(n_frames, n_atoms, 3))
                  .astype(np.float32))
        path = str(tmp_path_factory.mktemp("xtcfuzz") / "h.xtc")
        write_xtc(path, frames, precision=precision)
        blk, _ = XTCReader(path).read_block(0, n_frames)
        # half an LSB in A, plus float32 representation slack for
        # near-cap magnitudes (~|x| * 2^-23)
        tol = 10.0 / precision * 0.51 + amp * 2.5e-7 + 1e-4
        assert np.abs(blk - frames).max() <= tol


# ---------------- fused decode→stage (cold path) ----------------

class TestFusedXTCStage:
    """xtc_stage_f32/xtc_stage_i16: decode+gather(+quantize) without
    materializing the full-system block (trajio.cpp)."""

    def _fixture(self, tmp_path, f=9, n=120, box=True):
        coords = _traj(f=f, n=n)
        dims = (np.array([40.0, 40.0, 40.0, 90.0, 90.0, 90.0])
                if box else None)
        path = str(tmp_path / "t.xtc")
        write_xtc(path, coords, dimensions=dims)
        return path, coords

    def test_read_block_selection_matches_full_decode(self, tmp_path):
        path, _ = self._fixture(tmp_path)
        r = XTCReader(path)
        sel = np.array([0, 3, 7, 118], dtype=np.int64)
        full, boxes_full = r.read_block(0, 9)          # sel=None: old path
        got, boxes = r.read_block(0, 9, sel=sel)       # fused path
        np.testing.assert_array_equal(got, full[:, sel])
        np.testing.assert_allclose(boxes, boxes_full, atol=1e-4)

    def test_read_block_selection_strided(self, tmp_path):
        path, _ = self._fixture(tmp_path)
        r = XTCReader(path)
        sel = np.arange(0, 120, 5)
        full, _ = r.read_block(1, 9, step=3)
        got, _ = r.read_block(1, 9, sel=sel, step=3)
        np.testing.assert_array_equal(got, full[:, sel])

    def test_boxless_block_keeps_none_contract(self, tmp_path):
        path, _ = self._fixture(tmp_path, box=False)
        r = XTCReader(path)
        got, boxes = r.read_block(0, 9, sel=np.array([1, 2]))
        assert boxes is None
        assert got.shape == (9, 2, 3)

    def test_stage_block_first_call_bit_identical_to_reference(self, tmp_path):
        """First block (no hint) must match the NumPy exact-scale
        quantizer bit for bit."""
        from mdanalysis_mpi_tpu_torch.parallel.executors import quantize_block

        path, _ = self._fixture(tmp_path)
        r = XTCReader(path)
        sel = np.array([2, 5, 50, 99], dtype=np.int64)
        q, boxes, inv = r.stage_block(0, 9, sel=sel, quantize=True)
        block, _ = XTCReader(path).read_block(0, 9, sel=sel)
        q_ref, inv_ref = quantize_block(block)
        np.testing.assert_array_equal(q, q_ref)
        assert np.float32(inv) == np.float32(inv_ref)

    def test_stage_block_hinted_fused_path_matches_resolution(self, tmp_path):
        """Second block takes the fused decode→int16 kernel; dequantized
        output must agree with the f32 block to quantization resolution."""
        path, coords = self._fixture(tmp_path, f=12)
        r = XTCReader(path)
        sel = np.arange(0, 120, 3)
        r.stage_block(0, 6, sel=sel, quantize=True)          # seeds hint
        assert r.__dict__["_quant_max_hints"]                # hint present
        q, boxes, inv = r.stage_block(6, 12, sel=sel, quantize=True)
        assert q.dtype == np.int16
        block, _ = XTCReader(path).read_block(6, 12, sel=sel)
        np.testing.assert_allclose(q.astype(np.float32) * inv, block,
                                   atol=2.0 * float(inv))
        assert boxes is not None

    def test_stage_block_overflow_requantizes_exactly(self, tmp_path):
        """A later block with much larger coordinates must trip the
        hinted scale and come back at the fresh exact scale."""
        f, n = 4, 64
        small = _traj(f=f, n=n, scale=5.0)
        big = _traj(f=f, n=n, scale=5.0) * 40.0
        path = str(tmp_path / "grow.xtc")
        write_xtc(path, np.concatenate([small, big]))
        r = XTCReader(path)
        sel = np.arange(n)
        r.stage_block(0, f, sel=sel, quantize=True)          # small hint
        q, _, inv = r.stage_block(f, 2 * f, sel=sel, quantize=True)
        block, _ = XTCReader(path).read_block(f, 2 * f, sel=sel)
        # no clipping: the requantized block must cover the true range
        np.testing.assert_allclose(q.astype(np.float32) * inv, block,
                                   atol=2.0 * float(inv))
        assert float(np.abs(block).max()) <= 32767.5 * float(inv)

    def test_stage_block_bounds_checked_on_hinted_path(self, tmp_path):
        path, _ = self._fixture(tmp_path)
        r = XTCReader(path)
        sel = np.array([0, 1])
        r.stage_block(0, 4, sel=sel, quantize=True)      # seeds hint
        with pytest.raises(IndexError):
            r.stage_block(-4, 4, sel=sel, quantize=True)
        with pytest.raises(IndexError):
            r.stage_block(0, 99, sel=sel, quantize=True)

    def test_threaded_fused_stage_identical(self, tmp_path, monkeypatch):
        path, _ = self._fixture(tmp_path, f=11)
        sel = np.arange(0, 120, 2)
        r1 = XTCReader(path)
        r1.stage_block(0, 5, sel=sel, quantize=True)
        q1, _, inv1 = r1.stage_block(5, 11, sel=sel, quantize=True)
        monkeypatch.setenv("MDTPU_DECODE_THREADS", "3")
        r2 = XTCReader(path)
        r2.stage_block(0, 5, sel=sel, quantize=True)
        q2, _, inv2 = r2.stage_block(5, 11, sel=sel, quantize=True)
        np.testing.assert_array_equal(q1, q2)
        assert np.float32(inv1) == np.float32(inv2)


class TestFusedStageFuzz:
    """Fuzz the fused decode→gather(→quantize) kernels against the
    decode-then-gather reference across shapes, scales, strides,
    selections, and thread counts (new C++ paths in trajio.cpp)."""

    def test_fuzz_f32_and_i16(self, tmp_path, monkeypatch):
        for seed in range(10):
            rng = np.random.default_rng(100 + seed)
            n = int(rng.integers(12, 300))
            f = int(rng.integers(2, 9))
            scale = float(rng.choice([0.5, 5.0, 80.0]))
            c = rng.normal(scale=scale, size=(f, n, 3)).astype(np.float32)
            path = str(tmp_path / f"sf{seed}.xtc")
            write_xtc(path, c)
            if seed % 2:
                monkeypatch.setenv("MDTPU_DECODE_THREADS", "3")
            else:
                monkeypatch.delenv("MDTPU_DECODE_THREADS", raising=False)
            r = XTCReader(path)
            sel = np.sort(rng.choice(n, size=int(rng.integers(1, n)),
                                     replace=False))
            step = int(rng.integers(1, 4))
            # f32 fused vs decode-then-gather
            full, _ = r.read_block(0, f, step=step)
            got, _ = r.read_block(0, f, sel=sel, step=step)
            np.testing.assert_array_equal(got, full[:, sel],
                                          err_msg=f"seed={seed}")
            # i16 fused (seed hint with a first window, then fused leg)
            r2 = XTCReader(path)
            mid = max(1, f // 2)
            r2.stage_block(0, mid, sel=sel, quantize=True)
            q, _, inv = r2.stage_block(mid, f, sel=sel, quantize=True)
            ref2, _ = XTCReader(path).read_block(mid, f, sel=sel)
            np.testing.assert_allclose(
                q.astype(np.float32) * inv, ref2,
                atol=2.0 * max(float(inv), 1e-6),
                err_msg=f"seed={seed}")


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


_WRITERS = {
    "xtc": ("io.xtc", "write_xtc", "XTCReader"),
    "dcd": ("io.dcd", "write_dcd", "DCDReader"),
    "trr": ("io.trr", "write_trr", "TRRReader"),
}


@pytest.mark.parametrize("fmt", sorted(_WRITERS))
def test_file_formats_match_jax_package(tmp_path, fmt):
    """The same frames written by each package: byte-identical files,
    and each package's reader reads either file to the same frames,
    times and boxes."""
    sub, write, reader = _WRITERS[fmt]
    rng = np.random.default_rng(5)
    xyz = rng.uniform(0, 30, size=(7, 40, 3)).astype(np.float32)
    dims = np.tile(np.array([30.0, 30, 30, 90, 90, 90], np.float32), (7, 1))

    def case(mod):
        path = str(tmp_path / f"{mod().__name__}.{fmt}")
        getattr(mod(sub), write)(path, xyz, dimensions=dims)
        return path
    paths = both(case)
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f0.read() == f1.read()

    def read(mod):
        r = getattr(mod(sub), reader)(paths[1])
        frames, times = r.read_block(0, r.n_frames)
        return (r.n_frames, r.n_atoms, frames, times,
                [r[i].dimensions for i in range(r.n_frames)])
    assert_same(*both(read))
