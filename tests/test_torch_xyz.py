"""The port's XYZ text trajectory format (``io/xyz.py``): the JAX
package's tests/test_xyz.py case by case (``backend="torch",
device="cpu"`` for its ``'jax'``): round trips, random access, Universe
dispatch, streaming append, malformed-file refusals; then parity with
the JAX package: the written bytes equal (one-shot and through
``TrajectoryWriter``), both readers giving equal arrays, and the shared
offset cache read across the packages (a stale mtime rescans)."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.xyz import XYZReader, write_xyz
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from mdanalysis_mpi_tpu.io import _offsets as j_offsets
from mdanalysis_mpi_tpu.io import xyz as jxyz
from mdanalysis_mpi_tpu.io.writer import TrajectoryWriter as JTrajectoryWriter


def _frames(f=4, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=6.0, size=(f, n, 3)).astype(np.float32)


def test_round_trip_and_random_access(tmp_path):
    p = str(tmp_path / "t.xyz")
    fr = _frames()
    write_xyz(p, fr, names=["C"] * 7)
    r = XYZReader(p)
    assert r.n_frames == 4 and r.n_atoms == 7
    np.testing.assert_allclose(r[2].positions, fr[2], atol=1e-5)
    np.testing.assert_allclose(r[0].positions, fr[0], atol=1e-5)
    assert r[3].time == 3.0
    block, boxes = r.read_block(1, 3)
    np.testing.assert_allclose(block, fr[1:3], atol=1e-5)
    assert boxes is None                        # the format has no box


def test_universe_and_analysis(tmp_path):
    from mdanalysis_mpi_tpu_torch.analysis import RMSD

    u0 = make_protein_universe(n_residues=6, n_frames=5, noise=0.3,
                               seed=2)
    fr, _ = u0.trajectory.read_block(0, 5)
    p = str(tmp_path / "traj.xyz")
    write_xyz(p, fr)
    u = Universe(u0.topology, p)
    s = RMSD(u.select_atoms("name CA")).run(backend="serial")
    j = RMSD(u.select_atoms("name CA")).run(backend="torch", device="cpu",
                                            batch_size=2)
    np.testing.assert_allclose(np.asarray(j.results.rmsd),
                               s.results.rmsd, atol=1e-4)


def test_streaming_writer_xyz(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

    fr = _frames(f=5, n=4, seed=3)
    out = str(tmp_path / "s.xyz")
    w = TrajectoryWriter(out, n_atoms=4)
    w.write(fr[:2])
    w.write(fr[2:])
    w.close()
    r = XYZReader(out)
    assert r.n_frames == 5
    np.testing.assert_allclose(r[4].positions, fr[4], atol=1e-5)
    with pytest.raises(ValueError, match="times"):
        TrajectoryWriter(str(tmp_path / "x.xyz"),
                         n_atoms=4).write(fr, times=[0.0] * 5)


def test_malformed_refusals(tmp_path):
    bad = tmp_path / "bad.xyz"
    bad.write_text("not a count\nc\n")
    with pytest.raises(ValueError, match="atom-count"):
        XYZReader(str(bad))
    trunc = tmp_path / "trunc.xyz"
    trunc.write_text("3\ncomment\nC 0 0 0\n")
    with pytest.raises(ValueError, match="truncated"):
        XYZReader(str(trunc))
    varying = tmp_path / "var.xyz"
    varying.write_text("1\nc\nC 0 0 0\n2\nc\nC 0 0 0\nC 1 1 1\n")
    with pytest.raises(ValueError, match="previous frames"):
        XYZReader(str(varying))
    empty = tmp_path / "e.xyz"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        XYZReader(str(empty))
    p = str(tmp_path / "ok.xyz")
    write_xyz(p, _frames(f=1, n=3))
    with pytest.raises(ValueError, match="atoms"):
        XYZReader(p, n_atoms=9)
    with pytest.raises(ValueError, match="names"):
        write_xyz(p, _frames(f=1, n=3), names=["C"])


def test_offset_cache_and_comment_numbering(tmp_path):
    from mdanalysis_mpi_tpu_torch.io import _offsets
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

    fr = _frames(f=4, n=3, seed=5)
    p = str(tmp_path / "c.xyz")
    write_xyz(p, fr)
    XYZReader(p)
    import os

    assert os.path.exists(_offsets.cache_path(p))   # index cached
    r2 = XYZReader(p)                               # served from cache
    np.testing.assert_allclose(r2[3].positions, fr[3], atol=1e-5)
    # streamed chunks number their comment lines monotonically
    out = str(tmp_path / "s2.xyz")
    w = TrajectoryWriter(out, n_atoms=3)
    w.write(fr[:2])
    w.write(fr[2:])
    w.close()
    comments = [ln for ln in open(out) if ln.startswith("frame ")]
    assert comments == [f"frame {i}\n" for i in range(4)]
    # explicit dimensions refuse (the format stores no cell)
    w2 = TrajectoryWriter(str(tmp_path / "d.xyz"), n_atoms=3)
    with pytest.raises(ValueError, match="unit cell"):
        w2.write(fr, dimensions=np.array([10.0, 10, 10, 90, 90, 90]))
    w2.close()


# ---------------- parity with the JAX package ----------------

def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_reads(path):
    r, j = XYZReader(path), jxyz.XYZReader(path)
    assert (r.n_frames, r.n_atoms) == (j.n_frames, j.n_atoms)
    block, boxes = r.read_block(0, r.n_frames)
    jblock, jboxes = j.read_block(0, j.n_frames)
    np.testing.assert_array_equal(block, jblock)
    assert boxes is None and jboxes is None
    for i in range(r.n_frames):
        np.testing.assert_array_equal(r[i].positions, j[i].positions)
        assert r[i].time == j[i].time
    return r


@pytest.mark.parametrize("names", [None, ["C", "N", "O", "H", "S"]])
def test_write_xyz_bytes_and_reads_equal_jax(tmp_path, names):
    fr = _frames(f=3, n=5, seed=41)
    p, jp = str(tmp_path / "port.xyz"), str(tmp_path / "jax.xyz")
    write_xyz(p, fr, names=names, start=4)
    jxyz.write_xyz(jp, fr, names=names, start=4)
    assert _bytes(p) == _bytes(jp)
    np.testing.assert_allclose(_same_reads(p).read_block(0, 3)[0], fr,
                               atol=1e-5)


def test_trajectory_writer_xyz_bytes_equal_jax(tmp_path):
    """Chunk-appended XYZ (a Universe's current frame among the
    chunks): the JAX writer's bytes, comment numbering included."""
    from mdanalysis_mpi_tpu.testing import (
        make_protein_universe as jax_make_protein_universe)
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

    kw = dict(n_residues=3, n_frames=4, seed=6)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    fr = _frames(f=5, n=u.atoms.n_atoms, seed=42)
    paths = {}
    for name, cls, uni in (("port", TrajectoryWriter, u),
                           ("jax", JTrajectoryWriter, ju)):
        paths[name] = str(tmp_path / f"{name}.xyz")
        with cls(paths[name]) as w:
            w.write(fr[:2])
            w.write(uni)                      # auto box dropped
            w.write(fr[2:])
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    assert _same_reads(paths["port"]).n_frames == 6


def test_offset_cache_shared_with_jax_and_stale_mtime_rescans(tmp_path):
    import os

    fr = _frames(f=5, n=4, seed=43)
    p = str(tmp_path / "c.xyz")
    write_xyz(p, fr)
    j = jxyz.XYZReader(p)                      # the JAX reader scans
    assert os.path.exists(j_offsets.cache_path(p))
    np.testing.assert_array_equal(XYZReader(p)._offsets, j._offsets)
    planted = j._offsets[:2].copy()
    j_offsets.save(p, planted, 4, os.path.getmtime(p))
    assert XYZReader(p).n_frames == 2          # the JAX package's index
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    r = XYZReader(p)                           # stale: rescanned
    assert r.n_frames == 5
    np.testing.assert_array_equal(r._offsets, j._offsets)
    np.testing.assert_allclose(r[4].positions, fr[4], atol=1e-5)
