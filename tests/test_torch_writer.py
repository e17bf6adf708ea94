"""Twin of ``tests/test_writer.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

TrajectoryWriter (streaming chunk-append) + AlignTraj in_memory=False.

The chunk-append property under test: XTC/TRR frames are self-delimiting
XDR records (byte concatenation is a valid trajectory); DCD needs its
fixed 196-byte header stripped from chunks after the first and the two
frame-count fields patched on close (io/writer.py).  The upstream
workflow this enables is ``align.AlignTraj(..., in_memory=False)`` —
the file-writing default of the oracle API whose in-memory form the
reference docstring pins (RMSF.py:12).
"""

import os

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter, Writer
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    both, port_runs_on_the_cpu)


def _frames(n=11, atoms=17, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=8.0, size=(n, atoms, 3)).astype(np.float32)


def _read_all(path):
    from mdanalysis_mpi_tpu_torch.io import trajectory_files

    r = trajectory_files.open(path)
    block, boxes = r.read_block(0, r.n_frames)
    return block, boxes


@pytest.mark.parametrize("ext,atol", [("xtc", 2e-2), ("trr", 1e-5),
                                      ("dcd", 1e-5)])
def test_chunked_write_matches_oneshot(tmp_path, ext, atol):
    coords = _frames()
    dims = np.tile(np.array([40.0, 40, 40, 90, 90, 90], np.float32), (11, 1))
    path = str(tmp_path / f"out.{ext}")
    with TrajectoryWriter(path) as w:
        w.write(coords[:4], dimensions=dims[:4])
        w.write(coords[4:5], dimensions=dims[4:5])
        w.write(coords[5:], dimensions=dims[5:])
        assert w.frames_written == 11
    block, boxes = _read_all(path)
    assert block.shape == coords.shape
    np.testing.assert_allclose(block, coords, atol=atol)
    np.testing.assert_allclose(boxes, dims, atol=1e-3)


def test_single_frame_and_2d_input(tmp_path):
    coords = _frames(3)
    path = str(tmp_path / "out.dcd")
    with TrajectoryWriter(path) as w:
        for f in coords:
            w.write(f)                      # (N, 3) accepted
    block, _ = _read_all(path)
    np.testing.assert_allclose(block, coords, atol=1e-5)


def test_write_universe_current_frame(tmp_path):
    u = make_protein_universe(n_residues=4, n_frames=5)
    path = str(tmp_path / "snap.xtc")
    with Writer(path, n_atoms=u.atoms.n_atoms) as w:
        for ts in u.trajectory:
            w.write(u)                      # upstream W.write(u) idiom
    block, _ = _read_all(path)
    ref, _ = u.trajectory.read_block(0, 5)
    np.testing.assert_allclose(block, ref, atol=2e-2)


def test_writer_errors(tmp_path):
    path = str(tmp_path / "out.dcd")
    w = TrajectoryWriter(path)
    w.write(_frames(2, atoms=9))
    with pytest.raises(ValueError, match="9"):
        w.write(_frames(1, atoms=8))
    with pytest.raises(ValueError, match="unit cell"):
        w.write(_frames(1, atoms=9),
                dimensions=np.array([30.0, 30, 30, 90, 90, 90]))
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.write(_frames(1, atoms=9))
    with pytest.raises(ValueError, match="format"):
        TrajectoryWriter(str(tmp_path / "out.gro"))


def test_dcd_frame_count_patched(tmp_path):
    """Three chunks -> header must claim 7 frames, not the first chunk's 2."""
    path = str(tmp_path / "out.dcd")
    coords = _frames(7)
    with TrajectoryWriter(path) as w:
        w.write(coords[:2])
        w.write(coords[2:6])
        w.write(coords[6:])
    from mdanalysis_mpi_tpu_torch.io.dcd import DCDReader

    r = DCDReader(path)
    assert r.n_frames == 7
    np.testing.assert_allclose(r.read_block(0, 7)[0], coords, atol=1e-5)


@pytest.mark.parametrize("backend", ["serial", "torch"])
@pytest.mark.parametrize("ext,atol", [("xtc", 3e-2), ("dcd", 1e-4)])
def test_aligntraj_file_output(tmp_path, backend, ext, atol):
    from mdanalysis_mpi_tpu_torch.analysis import AlignTraj

    u = make_protein_universe(n_residues=6, n_frames=10)
    u_mem = make_protein_universe(n_residues=6, n_frames=10)
    AlignTraj(u_mem, select="name CA", in_memory=True).run(backend=backend)
    ref_block, _ = u_mem.trajectory.read_block(0, 10)

    path = str(tmp_path / f"aligned.{ext}")
    r = AlignTraj(u, select="name CA", in_memory=False,
                  filename=path).run(backend=backend, batch_size=4)
    assert r.results.filename == path
    # mobile universe untouched by the file-backed variant
    assert isinstance(u.trajectory, MemoryReader)
    got, _ = r.results.universe.trajectory.read_block(0, 10)
    np.testing.assert_allclose(got, ref_block, atol=atol)


def test_aligntraj_derives_filename_from_source(tmp_path):
    from mdanalysis_mpi_tpu_torch.analysis import AlignTraj
    from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc

    u_mem = make_protein_universe(n_residues=4, n_frames=6)
    block, _ = u_mem.trajectory.read_block(0, 6)
    src = str(tmp_path / "traj.xtc")
    write_xtc(src, block)
    u = Universe(u_mem.topology, XTCReader(src))
    r = AlignTraj(u, select="name CA", in_memory=False).run(backend="serial")
    assert r.filename == str(tmp_path / "rmsfit_traj.xtc")
    assert os.path.exists(r.filename)
    assert r.results.universe.trajectory.n_frames == 6


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
    from mdanalysis_mpi_tpu_torch.io.trr import TRRReader

    r = TRRReader(str(tmp_path / "o.trr"))
    np.testing.assert_allclose(r[0].velocities, coords[0], atol=1e-4)


def test_aligntraj_error_removes_partial_file(tmp_path):
    """A mid-run failure must not leave a self-consistent truncated file."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignTraj

    u = make_protein_universe(n_residues=4, n_frames=8)
    path = str(tmp_path / "out.dcd")

    calls = []
    orig = u.trajectory.__class__._read_frame

    def boom(self, i):
        calls.append(i)
        if len(calls) > 3:
            raise RuntimeError("synthetic read failure")
        return orig(self, i)

    u.trajectory._read_frame = boom.__get__(u.trajectory)
    with pytest.raises(RuntimeError, match="synthetic"):
        AlignTraj(u, select="name CA", in_memory=False,
                  filename=path).run(backend="serial")
    assert not os.path.exists(path)


def test_aligntraj_file_times_match_in_memory_numbering(tmp_path):
    """step=2 output must number frames 0..n-1 like the MemoryReader."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignTraj
    from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader

    u = make_protein_universe(n_residues=4, n_frames=8)
    path = str(tmp_path / "out.xtc")
    AlignTraj(u, select="name CA", in_memory=False,
              filename=path).run(backend="serial", step=2)
    r = XTCReader(path)
    assert r.n_frames == 4
    assert [r[i].frame for i in range(4)] == [0, 1, 2, 3]


def test_aligntraj_file_output_zero_frames_is_clear_error(tmp_path):
    from mdanalysis_mpi_tpu_torch.analysis import AlignTraj

    u = make_protein_universe(n_residues=4, n_frames=4)
    path = str(tmp_path / "out.dcd")
    with pytest.raises(ValueError, match="zero frames"):
        AlignTraj(u, in_memory=False, filename=path).run(start=2, stop=2)
    assert not os.path.exists(path)


def test_aligntraj_refuses_to_overwrite_source(tmp_path):
    from mdanalysis_mpi_tpu_torch.analysis import AlignTraj
    from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc

    u_mem = make_protein_universe(n_residues=4, n_frames=4)
    block, _ = u_mem.trajectory.read_block(0, 4)
    src = str(tmp_path / "traj.xtc")
    write_xtc(src, block)
    u = Universe(u_mem.topology, XTCReader(src))
    with pytest.raises(ValueError, match="source trajectory itself"):
        AlignTraj(u, in_memory=False, filename=src).run(backend="serial")
    assert XTCReader(src).n_frames == 4    # input intact


def test_aligntraj_in_memory_false_needs_name_for_memory_reader():
    from mdanalysis_mpi_tpu_torch.analysis import AlignTraj

    u = make_protein_universe(n_residues=4, n_frames=4)
    with pytest.raises(ValueError, match="filename"):
        AlignTraj(u, select="name CA", in_memory=False)


def test_chunk_temp_path_unique_per_writer(tmp_path):
    """Two writers (or a crashed run's leftover) must not share the
    chunk temp file (ADVICE r3: fixed suffix clobbered in-flight
    chunks)."""
    p1 = str(tmp_path / "a.xtc")
    w1 = TrajectoryWriter(p1)
    w2 = TrajectoryWriter(str(tmp_path / "b.xtc"))
    assert w1._chunk_path != w2._chunk_path
    assert w1._chunk_path != TrajectoryWriter(p1)._chunk_path
    # a crashed run's leftover under the OLD fixed name must survive
    # another writer's write/cleanup cycle
    stale = p1 + ".mdtpu_chunk"
    with open(stale, "wb") as f:
        f.write(b"leftover")
    w1.write(_frames(n=2))
    w1.close()
    assert os.path.exists(stale)
    assert not os.path.exists(w1._chunk_path)
    block, _ = _read_all(p1)
    assert block.shape == (2, 17, 3)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("fmt", ["xtc", "trr", "dcd", "xyz"])
def test_writer_bytes_match_jax_package(tmp_path, fmt):
    """``Writer(path, n_atoms)`` over the same frames in each package:
    byte-identical files."""
    def case(mod):
        u = mod("testing").make_protein_universe(n_residues=4, n_frames=5,
                                                 seed=6)
        path = str(tmp_path / f"{mod().__name__}.{fmt}")
        with mod("io.writer").Writer(path, u.atoms.n_atoms) as w:
            for _ in u.trajectory:
                w.write(u.atoms)
        return open(path, "rb").read()
    ref, port = both(case)
    assert ref == port
