"""The port's GROMACS TRR reader and writer (``io/trr.py``): the TRR
cases of the JAX package's tests/test_trajio.py and tests/test_writer.py
translated to the port, then parity with the JAX package on the same
inputs: written bytes equal (one-shot with box, velocities and forces,
and chunk-appended through ``TrajectoryWriter``), each package's reader
giving equal arrays on the same file (float32 and float64 frames), and
the shared offset cache: an index written by the JAX reader is the one
the port reads, and a stale mtime forces a rescan."""

import os

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.topology import make_protein_topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io import _offsets, trajectory_files
from mdanalysis_mpi_tpu_torch.io import trr as trr_mod
from mdanalysis_mpi_tpu_torch.io.trr import (_MAGIC, _TAG, TRRReader,
                                             write_trr)
from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

from mdanalysis_mpi_tpu.io import _offsets as j_offsets
from mdanalysis_mpi_tpu.io import trr as jtrr
from mdanalysis_mpi_tpu.io.writer import TrajectoryWriter as JTrajectoryWriter

RNG = np.random.default_rng(7)
BOX = np.array([40.0, 40.0, 40.0, 90.0, 90.0, 90.0])


def _traj(f=6, n=50, scale=20.0):
    return (RNG.normal(scale=scale, size=(f, n, 3))).astype(np.float32)


def _frames(n=11, atoms=17, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=8.0, size=(n, atoms, 3)).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write_f64(path, coords, box, with_x=True):
    """A double-precision TRR (box_size=72, x_size=24N), written by hand
    as tests/test_trajio.py does; ``with_x=False`` leaves the positions
    out (an energy-only frame)."""
    n = coords.shape[1]
    with open(path, "wb") as f:
        for i in range(len(coords)):
            head = np.array([_MAGIC, len(_TAG) + 1], dtype=">i4").tobytes()
            head += np.array([len(_TAG)], dtype=">i4").tobytes() + _TAG
            fields = [0, 0, 72, 0, 0, 0, 0, 24 * n if with_x else 0, 0, 0,
                      n, i, 0]
            head += np.asarray(fields, dtype=">i4").tobytes()
            head += np.asarray([0.5 * i, 0.0], dtype=">f8").tobytes()
            f.write(head)
            f.write(np.asarray(box, dtype=">f8").tobytes())
            if with_x:
                f.write(np.asarray(coords[i], dtype=">f8").tobytes())


# ---------------- tests/test_trajio.py's TRR cases ----------------

class TestTRR:
    def test_round_trip(self, tmp_path):
        coords = _traj()
        path = str(tmp_path / "t.trr")
        write_trr(path, coords, dimensions=BOX,
                  times=np.arange(6, dtype=np.float32) * 2.0,
                  steps=np.arange(6) * 100)
        r = TRRReader(path)
        assert r.n_frames == 6
        assert r.n_atoms == 50
        for i in range(6):
            ts = r[i]
            # TRR is uncompressed f32 in nm: only nm->A f32 rounding
            np.testing.assert_allclose(ts.positions, coords[i], atol=1e-4)
            np.testing.assert_allclose(ts.dimensions, BOX, atol=1e-3)
            assert ts.time == pytest.approx(2.0 * i)

    def test_boxless(self, tmp_path):
        path = str(tmp_path / "nb.trr")
        coords = _traj(f=3, n=7)
        write_trr(path, coords)
        r = TRRReader(path)
        assert r[0].dimensions is None
        block, boxes = r.read_block(0, 3)
        assert boxes is None
        np.testing.assert_allclose(block, coords, atol=1e-4)

    def test_read_block_with_selection(self, tmp_path):
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
        coords = _traj(f=4, n=10)
        path = str(tmp_path / "c.trr")
        trr_mod.write_trr(path, coords)
        r1 = trr_mod.TRRReader(path)
        assert len(r1._offsets) == 4
        assert os.path.exists(trr_mod._offset_cache_path(path))
        r2 = trr_mod.TRRReader(path)        # loads via cache
        np.testing.assert_array_equal(r1._offsets, r2._offsets)

    def test_double_precision_frames(self, tmp_path):
        """f64 TRR (box_size=72, x_size=24N) decodes through the same
        width-inference path as upstream nFloatSize()."""
        coords = RNG.normal(scale=2.0, size=(2, 4, 3))
        path = str(tmp_path / "d.trr")
        _write_f64(path, coords, np.diag([4.0, 4.0, 4.0]))
        r = TRRReader(path)
        assert r.n_frames == 2
        np.testing.assert_allclose(r[1].positions, coords[1] * 10.0,
                                   rtol=1e-6)
        np.testing.assert_allclose(r[1].dimensions[:3], [40, 40, 40],
                                   atol=1e-6)

    def test_universe_integration(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.gro import write_gro

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
        with pytest.raises(IOError, match="magic"):
            TRRReader(path)


class TestTRRWriteValidation:
    """write_trr validates per-frame metadata lengths up front so a
    mismatch cannot leave a partially written file."""

    def test_short_times_rejected_before_write(self, tmp_path):
        path = tmp_path / "x.trr"
        coords = np.zeros((4, 3, 3), np.float32)
        with pytest.raises(ValueError, match="times"):
            write_trr(str(path), coords, times=np.zeros(2))
        with pytest.raises(ValueError, match="steps"):
            write_trr(str(path), coords, steps=np.arange(3))
        with pytest.raises(ValueError, match="dimensions"):
            write_trr(str(path), coords, dimensions=np.zeros((2, 6)))
        assert not path.exists()


def test_trr_velocities_forces_roundtrip(tmp_path):
    """TRR frames carrying velocities/forces expose them on the Timestep
    in upstream units (A/ps, kJ/(mol.A)); frames without them read None."""
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


# ---------------- tests/test_writer.py's TRR cases ----------------

def test_chunked_trr_write_matches_oneshot(tmp_path):
    coords = _frames()
    dims = np.tile(np.array([40.0, 40, 40, 90, 90, 90], np.float32), (11, 1))
    path = str(tmp_path / "out.trr")
    with TrajectoryWriter(path) as w:
        w.write(coords[:4], dimensions=dims[:4])
        w.write(coords[4:5], dimensions=dims[4:5])
        w.write(coords[5:], dimensions=dims[5:])
        assert w.frames_written == 11
    r = trajectory_files.open(path)
    block, boxes = r.read_block(0, r.n_frames)
    assert block.shape == coords.shape
    np.testing.assert_allclose(block, coords, atol=1e-5)
    np.testing.assert_allclose(boxes, dims, atol=1e-3)


def test_velocities_rejected_for_formats_that_drop_them(tmp_path):
    coords = _frames(2)
    for ext in ("xtc", "dcd"):
        with TrajectoryWriter(str(tmp_path / f"o.{ext}")) as w:
            with pytest.raises(ValueError, match="velocities"):
                w.write(coords, velocities=coords)
    with TrajectoryWriter(str(tmp_path / "o.dcd")) as w:
        with pytest.raises(ValueError, match="times"):
            w.write(coords, times=np.array([1.0, 2.0]))
    with TrajectoryWriter(str(tmp_path / "o.trr")) as w:
        w.write(coords, velocities=coords)     # trr stores them
    r = TRRReader(str(tmp_path / "o.trr"))
    np.testing.assert_allclose(r[0].velocities, coords[0], atol=1e-4)


# ---------------- parity with the JAX package ----------------

def _same_reads(path, sel=None):
    """Both packages' readers on one file: equal blocks, boxes, times,
    velocities and forces."""
    r, j = TRRReader(path), jtrr.TRRReader(path)
    assert (r.n_frames, r.n_atoms) == (j.n_frames, j.n_atoms)
    np.testing.assert_array_equal(r._offsets, j._offsets)
    block, boxes = r.read_block(0, r.n_frames, sel=sel)
    jblock, jboxes = j.read_block(0, j.n_frames, sel=sel)
    np.testing.assert_array_equal(block, jblock)
    assert (boxes is None) == (jboxes is None)
    if boxes is not None:
        np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(r.frame_times(range(r.n_frames)),
                                  j.frame_times(range(j.n_frames)))
    for i in range(r.n_frames):
        ts, jts = r[i], j[i]
        np.testing.assert_array_equal(ts.positions, jts.positions)
        for key in ("velocities", "forces", "dimensions"):
            a, b = getattr(ts, key), getattr(jts, key)
            assert (a is None) == (b is None), key
            if a is not None:
                np.testing.assert_array_equal(a, b)
    return r


@pytest.mark.parametrize("case", ["plain", "box", "velocities_forces",
                                  "triclinic"])
def test_write_trr_bytes_and_reads_equal_jax(tmp_path, case):
    coords = _frames(n=5, atoms=13, seed=31)
    kw = {"times": np.arange(5, dtype=np.float32) * 0.25,
          "steps": np.arange(5) * 50}
    if case in ("box", "velocities_forces"):
        kw["dimensions"] = BOX
    if case == "triclinic":
        kw["dimensions"] = np.array([30.0, 32, 34, 70, 80, 100])
    if case == "velocities_forces":
        kw["velocities"] = _frames(n=5, atoms=13, seed=32)
        kw["forces"] = _frames(n=5, atoms=13, seed=33) * 40.0
    p, jp = str(tmp_path / "port.trr"), str(tmp_path / "jax.trr")
    write_trr(p, coords, **kw)
    jtrr.write_trr(jp, coords, **kw)
    assert _bytes(p) == _bytes(jp)
    _same_reads(p)
    _same_reads(p, sel=np.array([0, 4, 12]))


def test_trajectory_writer_trr_bytes_equal_jax(tmp_path):
    """Chunk-appended TRR with box, velocities and forces: the JAX
    writer's bytes."""
    coords, vel = _frames(seed=34), _frames(seed=35)
    frc = _frames(seed=36)
    paths = {}
    for name, cls in (("port", TrajectoryWriter),
                      ("jax", JTrajectoryWriter)):
        paths[name] = str(tmp_path / f"{name}.trr")
        with cls(paths[name]) as w:
            for lo, hi in ((0, 4), (4, 5), (5, 11)):
                w.write(coords[lo:hi], dimensions=BOX,
                        velocities=vel[lo:hi], forces=frc[lo:hi])
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    assert _same_reads(paths["port"]).n_frames == 11


def test_double_precision_and_positionless_frames_like_jax(tmp_path):
    """float64 frames read the same in both packages; a frame without
    positions is refused by both, on single reads and in read_block."""
    coords = RNG.normal(scale=2.0, size=(3, 6, 3))
    box = np.diag([4.0, 4.5, 5.0])
    p = str(tmp_path / "d.trr")
    _write_f64(p, coords, box)
    _same_reads(p)
    q = str(tmp_path / "e.trr")
    _write_f64(q, coords, box, with_x=False)
    r, j = TRRReader(q), jtrr.TRRReader(q)
    assert r.n_frames == j.n_frames == 3
    for rd in (r, j):
        with pytest.raises(IOError, match="no positions"):
            rd[1]
        with pytest.raises(IOError, match="no positions"):
            rd.read_block(0, 2)


def test_offset_cache_shared_with_jax_and_stale_mtime_rescans(tmp_path):
    """Both packages keep the index in ``<traj>.mdtpu_offsets.npz``: an
    index the JAX reader saved is the one the port loads (shown with a
    planted index under the file's own mtime), and once the file's
    mtime moves the port rescans and saves the true offsets again."""
    coords = _frames(n=6, atoms=9, seed=37)
    p = str(tmp_path / "c.trr")
    write_trr(p, coords, dimensions=BOX)
    j = jtrr.TRRReader(p)                      # the JAX reader scans
    assert os.path.exists(_offsets.cache_path(p))
    assert _offsets.cache_path(p) == j_offsets.cache_path(p)
    np.testing.assert_array_equal(TRRReader(p)._offsets, j._offsets)

    planted = j._offsets[:3].copy()
    j_offsets.save(p, planted, 9, os.path.getmtime(p))
    np.testing.assert_array_equal(TRRReader(p)._offsets, planted)

    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    assert _offsets.load(p) is None            # stale: mtime moved
    r = TRRReader(p)
    np.testing.assert_array_equal(r._offsets, j._offsets)
    assert r.n_frames == 6
    cached = _offsets.load(p)
    assert cached is not None and len(cached[0]) == 6
    np.testing.assert_array_equal(r.read_block(0, 6)[0],
                                  jtrr.TRRReader(p).read_block(0, 6)[0])
