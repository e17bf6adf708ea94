"""The port's DCD, PSF and PDB I/O, multi-file chains and the streaming
trajectory writer, against the JAX package.

Files the port writes are byte-identical to the JAX package's, and each
package reads the other's files to the same arrays.  The rest mirrors
tests/test_chain.py and tests/test_writer.py for XTC and DCD (TRR,
NetCDF and XYZ have files of their own, tests/test_torch_trr.py,
test_torch_netcdf.py and test_torch_xyz.py), and ends
with BASELINE config 1's route at a small size: a PSF/DCD pair through
``AlignedRMSF`` in both packages.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis import AlignedRMSF as JAlignedRMSF  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.chain import ChainReader as JChainReader  # noqa: E402
from mdanalysis_mpi_tpu.io.dcd import DCDReader as JDCDReader  # noqa: E402
from mdanalysis_mpi_tpu.io.dcd import write_dcd as jwrite_dcd  # noqa: E402
from mdanalysis_mpi_tpu.io.pdb import parse_pdb as jparse_pdb  # noqa: E402
from mdanalysis_mpi_tpu.io.pdb import write_pdb as jwrite_pdb  # noqa: E402
from mdanalysis_mpi_tpu.io.psf import parse_psf as jparse_psf  # noqa: E402
from mdanalysis_mpi_tpu.io.psf import write_psf as jwrite_psf  # noqa: E402
from mdanalysis_mpi_tpu.io.writer import (  # noqa: E402
    TrajectoryWriter as JTrajectoryWriter)
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, AlignTraj  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io import trajectory_files  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.chain import ChainReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.dcd import DCDReader, write_dcd  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.pdb import parse_pdb, write_pdb  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.psf import parse_psf, write_psf  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.writer import (  # noqa: E402
    TrajectoryWriter, Writer)
from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

BOX = np.array([40.0, 41.0, 42.0, 90.0, 90.0, 90.0], np.float32)
TOP_KEYS = ("names", "resnames", "resids", "segids", "masses", "charges",
            "bonds", "angles", "dihedrals", "impropers")


def _frames(n=11, atoms=17, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=8.0, size=(n, atoms, 3)).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _read_all(path):
    r = trajectory_files.open(path)
    return r.read_block(0, r.n_frames)


def _topology():
    """12 atoms in 3 residues and 2 segments, with charges, masses and
    every bonded section of a PSF."""
    n = 12
    return Topology(
        names=np.array(["N", "CA", "C", "O"] * 3),
        resnames=np.array(["ALA"] * 4 + ["GLY"] * 4 + ["LYS"] * 4),
        resids=np.repeat([1, 2, 3], 4),
        segids=np.array(["PROA"] * 8 + ["PROB"] * 4),
        charges=np.linspace(-0.5, 0.5, n),
        masses=np.tile([14.007, 12.011, 12.011, 15.999], 3),
        bonds=np.array([[i, i + 1] for i in range(n - 1)]),
        angles=np.array([[i, i + 1, i + 2] for i in range(n - 2)]),
        dihedrals=np.array([[i, i + 1, i + 2, i + 3] for i in range(n - 3)]),
        impropers=np.array([[0, 1, 2, 3], [4, 5, 6, 7]]))


# ---------------- DCD ----------------

@pytest.mark.parametrize("boxed", [False, True])
def test_dcd_byte_identical_and_cross_read(tmp_path, boxed):
    coords = _frames()
    dims = None
    if boxed:
        dims = np.tile(BOX, (11, 1))
        dims[:, 3] = np.linspace(70.0, 110.0, 11)      # triclinic frames
    p, jp = str(tmp_path / "port.dcd"), str(tmp_path / "jax.dcd")
    write_dcd(p, coords, dimensions=dims, dt=2.0)
    jwrite_dcd(jp, coords, dimensions=dims, dt=2.0)
    assert _bytes(p) == _bytes(jp)
    for path in (p, jp):
        mine, theirs = DCDReader(path), JDCDReader(path)
        assert mine.n_frames == theirs.n_frames == 11
        assert mine.n_atoms == theirs.n_atoms == 17
        blk, bx = mine.read_block(0, 11)
        jblk, jbx = theirs.read_block(0, 11)
        np.testing.assert_array_equal(blk, jblk)
        np.testing.assert_array_equal(blk, coords)
        if boxed:
            np.testing.assert_array_equal(bx, jbx)
            np.testing.assert_allclose(bx, dims, atol=1e-4)
        else:
            assert bx is None and jbx is None
        sel = np.array([1, 5, 16])
        np.testing.assert_array_equal(mine.read_block(2, 9, sel=sel,
                                                      step=3)[0],
                                      coords[2:9:3][:, sel])
        ts, jts = mine[7], theirs[7]
        np.testing.assert_array_equal(ts.positions, jts.positions)
        assert ts.frame == jts.frame == 7 and ts.time == jts.time
        if boxed:
            np.testing.assert_array_equal(ts.dimensions, jts.dimensions)


def test_dcd_reader_errors(tmp_path):
    p = str(tmp_path / "a.dcd")
    write_dcd(p, _frames(2, atoms=5))
    with pytest.raises(ValueError, match="atoms"):
        DCDReader(p, n_atoms=6)
    bad = str(tmp_path / "bad.dcd")
    with open(bad, "wb") as f:
        f.write(b"not a dcd")
    with pytest.raises(IOError):
        DCDReader(bad)
    with pytest.raises(ValueError, match="F, N, 3"):
        write_dcd(p, np.zeros((4, 3), np.float32))


# ---------------- PSF / PDB ----------------

def test_psf_byte_identical_and_cross_parse(tmp_path):
    from mdanalysis_mpi_tpu.core.topology import Topology as JTopology

    t = _topology()
    jt = JTopology(**{k: getattr(t, k) for k in TOP_KEYS})
    p, jp = str(tmp_path / "port.psf"), str(tmp_path / "jax.psf")
    write_psf(p, t)
    jwrite_psf(jp, jt)
    assert _bytes(p) == _bytes(jp)
    for path in (p, jp):
        mine, theirs = parse_psf(path), jparse_psf(path)
        for key in TOP_KEYS:
            np.testing.assert_array_equal(getattr(mine, key),
                                          getattr(theirs, key), err_msg=key)
        np.testing.assert_array_equal(mine.bonds, t.bonds)
        np.testing.assert_allclose(mine.masses, t.masses, atol=1e-4)
    with open(p, "w") as f:
        f.write("not a psf\n")
    with pytest.raises(ValueError, match="PSF"):
        parse_psf(p)


@pytest.mark.parametrize("n_frames,boxed", [(1, True), (3, False)])
def test_pdb_byte_identical_and_cross_parse(tmp_path, n_frames, boxed):
    from mdanalysis_mpi_tpu.core.topology import Topology as JTopology

    t = _topology()
    jt = JTopology(**{k: getattr(t, k) for k in TOP_KEYS})
    coords = _frames(n_frames, atoms=12)
    dims = BOX if boxed else None
    p, jp = str(tmp_path / "port.pdb"), str(tmp_path / "jax.pdb")
    write_pdb(p, t, coords, dimensions=dims)
    jwrite_pdb(jp, jt, coords, dimensions=dims)
    assert _bytes(p) == _bytes(jp)
    mine, theirs = parse_pdb(p), jparse_pdb(jp)
    for key in ("names", "resnames", "resids", "segids"):
        np.testing.assert_array_equal(getattr(mine, key),
                                      getattr(theirs, key))
    np.testing.assert_array_equal(mine._coordinates, theirs._coordinates)
    np.testing.assert_allclose(mine._coordinates, coords, atol=1e-3)
    u = Universe(p)
    assert u.trajectory.n_frames == n_frames
    if boxed:
        np.testing.assert_allclose(u.trajectory.ts.dimensions, BOX,
                                   atol=1e-2)


def test_atomgroup_write_pdb_and_psf_like_jax(tmp_path):
    kw = dict(n_residues=4, n_frames=2, seed=1)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    for ext in ("pdb", "psf"):
        p, jp = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
        u.select_atoms("name CA CB").write(p)
        ju.select_atoms("name CA CB").write(jp)
        assert _bytes(p) == _bytes(jp), ext
    back = Universe(str(tmp_path / "p.pdb"))
    np.testing.assert_allclose(back.atoms.positions,
                               u.select_atoms("name CA CB").positions,
                               atol=1e-3)


def test_gro_byte_identical_and_cross_parse(tmp_path):
    """``AtomGroup.write`` of a GRO: the same bytes from both packages,
    title line included, and the port reads its file back."""
    kw = dict(n_residues=5, n_frames=2, seed=1)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    p, jp = str(tmp_path / "x.gro"), str(tmp_path / "j.gro")
    u.atoms.write(p)
    ju.atoms.write(jp)
    assert _bytes(p) == _bytes(jp)
    back = Universe(p)
    assert back.atoms.n_atoms == u.atoms.n_atoms
    np.testing.assert_allclose(back.atoms.positions, u.atoms.positions,
                               atol=5e-3)


# ---------------- TrajectoryWriter ----------------

@pytest.mark.parametrize("ext,atol", [("xtc", 2e-2), ("dcd", 1e-5)])
def test_chunked_write_matches_oneshot_and_jax(tmp_path, ext, atol):
    coords = _frames()
    dims = np.tile(BOX, (11, 1))
    paths = {}
    for name, cls in (("port", TrajectoryWriter), ("jax", JTrajectoryWriter)):
        paths[name] = str(tmp_path / f"{name}.{ext}")
        with cls(paths[name]) as w:
            w.write(coords[:4], dimensions=dims[:4])
            w.write(coords[4:5], dimensions=dims[4:5])
            w.write(coords[5:], dimensions=dims[5:])
            assert w.frames_written == 11
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    block, boxes = _read_all(paths["port"])
    np.testing.assert_allclose(block, coords, atol=atol)
    np.testing.assert_allclose(boxes, dims, atol=1e-3)


def test_single_frame_and_universe_input(tmp_path):
    coords = _frames(3)
    path = str(tmp_path / "out.dcd")
    with TrajectoryWriter(path) as w:
        for f in coords:
            w.write(f)                      # (N, 3) accepted
    np.testing.assert_allclose(_read_all(path)[0], coords, atol=1e-5)
    u = make_protein_universe(n_residues=4, n_frames=5)
    path = str(tmp_path / "snap.xtc")
    with Writer(path, n_atoms=u.atoms.n_atoms) as w:
        for _ in u.trajectory:
            w.write(u)                      # upstream W.write(u) idiom
    ref, _ = u.trajectory.read_block(0, 5)
    np.testing.assert_allclose(_read_all(path)[0], ref, atol=2e-2)


def test_dcd_frame_count_patched(tmp_path):
    """Three chunks -> the header claims 7 frames, not the first 2."""
    path = str(tmp_path / "out.dcd")
    coords = _frames(7)
    with TrajectoryWriter(path) as w:
        w.write(coords[:2])
        w.write(coords[2:6])
        w.write(np.empty((0, 17, 3), np.float32))   # header-only chunk
        w.write(coords[6:])
    r = DCDReader(path)
    assert r.n_frames == 7
    np.testing.assert_allclose(r.read_block(0, 7)[0], coords, atol=1e-5)


def test_writer_errors(tmp_path):
    path = str(tmp_path / "out.dcd")
    w = TrajectoryWriter(path)
    w.write(_frames(2, atoms=9))
    with pytest.raises(ValueError, match="9"):
        w.write(_frames(1, atoms=8))
    with pytest.raises(ValueError, match="unit cell"):
        w.write(_frames(1, atoms=9), dimensions=BOX)
    with pytest.raises(ValueError, match="velocities"):
        w.write(_frames(1, atoms=9), velocities=_frames(1, atoms=9))
    with pytest.raises(ValueError, match="times"):
        w.write(_frames(1, atoms=9), times=np.array([1.0]))
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.write(_frames(1, atoms=9))
    with pytest.raises(ValueError, match="format"):
        TrajectoryWriter(str(tmp_path / "out.gro"))
    # the other streamed formats each round-trip a frame
    frame = _frames(1, atoms=9)
    for ext, atol in (("trr", 1e-5), ("nc", 0.0), ("xyz", 1e-5)):
        out = str(tmp_path / f"out.{ext}")
        with TrajectoryWriter(out) as w:
            w.write(frame)
        block, _ = _read_all(out)
        np.testing.assert_allclose(block, frame, atol=atol)
    # xyz stores no cell and no times, as the JAX writer refuses them
    with TrajectoryWriter(str(tmp_path / "refuse.xyz")) as w:
        with pytest.raises(ValueError, match="unit cell"):
            w.write(frame, dimensions=BOX)
        with pytest.raises(ValueError, match="times"):
            w.write(frame, times=np.array([1.0]))
        assert w.frames_written == 0


def test_chunk_temp_path_unique_per_writer(tmp_path):
    p1 = str(tmp_path / "a.xtc")
    w1 = TrajectoryWriter(p1)
    w2 = TrajectoryWriter(str(tmp_path / "b.xtc"))
    assert w1._chunk_path != w2._chunk_path
    assert w1._chunk_path != TrajectoryWriter(p1)._chunk_path
    stale = p1 + ".mdtpu_chunk"
    with open(stale, "wb") as f:
        f.write(b"leftover")
    w1.write(_frames(n=2))
    w1.close()
    assert os.path.exists(stale)
    assert not os.path.exists(w1._chunk_path)
    assert _read_all(p1)[0].shape == (2, 17, 3)


# ---------------- ChainReader ----------------

@pytest.fixture
def parts(tmp_path):
    """One 14-frame trajectory written as 3 segment files (5+5+4)."""
    u = make_protein_universe(n_residues=5, n_frames=14, noise=0.3)
    block, _ = u.trajectory.read_block(0, 14)
    dims = np.array([30.0, 30, 30, 90, 90, 90])
    paths = []
    for k, (a, b) in enumerate([(0, 5), (5, 10), (10, 14)]):
        p = str(tmp_path / f"part{k}.xtc")
        write_xtc(p, block[a:b], dimensions=dims,
                  times=np.arange(a, b, dtype=np.float32))
        paths.append(p)
    return u, block, paths


def test_chain_frames_blocks_and_jax_parity(parts):
    u, block, paths = parts
    c, jc = ChainReader(paths), JChainReader(paths)
    assert c.n_frames == 14 and c.n_atoms == u.atoms.n_atoms
    assert c.filenames == paths and c.filename is None
    for i in (0, 4, 5, 9, 10, 13):
        ts = c[i]
        assert ts.frame == i                # global numbering
        np.testing.assert_array_equal(ts.positions, jc[i].positions)
        np.testing.assert_allclose(ts.positions, block[i], atol=2e-2)
    got, boxes = c.read_block(3, 12)
    np.testing.assert_array_equal(got, jc.read_block(3, 12)[0])
    np.testing.assert_allclose(boxes[:, :3], 30.0, atol=1e-3)
    sel = np.array([0, 7, 11])
    np.testing.assert_allclose(c.read_block(2, 13, sel=sel)[0],
                               block[2:13][:, sel], atol=2e-2)
    strided, _ = c.read_block(1, 14, step=3)     # crosses both seams
    np.testing.assert_allclose(strided, block[1:14:3], atol=2e-2)
    empty, b0 = c.read_block(6, 6)
    assert empty.shape[0] == 0 and b0 is None
    np.testing.assert_allclose(c.frame_times([0, 5, 13]), [0.0, 5.0, 13.0],
                               atol=1e-5)


def test_chain_universe_and_analysis(parts):
    u, block, paths = parts
    uc = Universe(u.topology, paths)
    assert uc.trajectory.n_frames == 14
    u2 = uc.copy()
    u2.trajectory[8]
    uc.trajectory[1]
    assert u2.trajectory.ts.frame == 8 and uc.trajectory.ts.frame == 1
    whole = AlignedRMSF(u, select="name CA").run(backend="serial")
    chain_s = AlignedRMSF(uc, select="name CA").run(backend="serial")
    chain_t = AlignedRMSF(uc, select="name CA").run(device="cpu",
                                                    batch_size=4)
    np.testing.assert_allclose(chain_s.results.rmsf, whole.results.rmsf,
                               atol=5e-3)
    np.testing.assert_allclose(chain_t.results.rmsf, chain_s.results.rmsf,
                               atol=1e-4)
    ju = JUniverse(_jax_topology(u), paths)
    chain_j = JAlignedRMSF(ju, select="name CA").run(backend="jax",
                                                     batch_size=4)
    np.testing.assert_allclose(chain_t.results.rmsf,
                               np.asarray(chain_j.results.rmsf), atol=1e-5)


def _jax_topology(u):
    from mdanalysis_mpi_tpu.core.topology import Topology as JTopology

    t = u.topology
    return JTopology(names=t.names, resnames=t.resnames, resids=t.resids,
                     segids=t.segids)


def test_chain_staging(parts):
    u, block, paths = parts
    c = ChainReader(paths)
    sel = np.arange(0, c.n_atoms, 2)
    q, _, inv = c.stage_block(3, 12, sel=sel, quantize="int16")
    assert q.dtype == np.int16
    np.testing.assert_allclose(q.astype(np.float32) * inv,
                               block[3:12][:, sel], atol=5e-2)
    # a window inside one segment is the child's own staging
    q1, _, inv1 = c.stage_block(0, 4, sel=sel, quantize="int16")
    q2, _, inv2 = XTCReader(paths[0]).stage_block(0, 4, sel=sel,
                                                  quantize="int16")
    np.testing.assert_array_equal(q1, q2)
    assert np.float32(inv1) == np.float32(inv2)


def _shift(ts):
    ts.positions = ts.positions + np.float32([0.0, 0.0, 2.0])
    return ts


def test_chain_transformations(parts):
    u, block, paths = parts
    r0 = XTCReader(paths[0])
    r0.add_transformations(_shift)
    with pytest.raises(ValueError, match="ChainReader itself"):
        ChainReader([r0, paths[1]])
    c = ChainReader(paths)
    c[0]
    c._readers[0].add_transformations(_shift)
    for call in (lambda: c[0], lambda: c.read_block(0, 2),
                 lambda: c.stage_block(0, 2)):
        with pytest.raises(ValueError, match="ChainReader itself"):
            call()
    c = ChainReader(paths)
    c.add_transformations(_shift)
    per_frame = c[6].positions
    np.testing.assert_allclose(c.read_block(6, 7)[0][0], per_frame,
                               atol=1e-5)
    np.testing.assert_allclose(per_frame, block[6] + [0, 0, 2.0], atol=3e-2)


def test_chain_validation_and_aligntraj_guard(tmp_path, parts):
    u, block, paths = parts
    with pytest.raises(ValueError, match="at least one"):
        ChainReader([])
    other = str(tmp_path / "other.xtc")
    write_xtc(other, np.zeros((2, 7, 3), np.float32))
    with pytest.raises(ValueError, match="atoms"):
        ChainReader([paths[0], other])
    uc = Universe(u.topology, paths)
    with pytest.raises(ValueError, match="part of"):
        AlignTraj(uc, in_memory=False, filename=paths[1]).run(
            backend="serial")
    assert XTCReader(paths[1]).n_frames == 5   # input intact


def test_mixed_format_chain(tmp_path):
    """XTC and DCD segments as one trajectory: each child by its
    extension, block reads across the boundary, arrays and in-memory
    segments too."""
    u0 = make_protein_universe(n_residues=5, n_frames=9, noise=0.3, seed=8)
    fr, _ = u0.trajectory.read_block(0, 9)
    p1, p2 = str(tmp_path / "a.xtc"), str(tmp_path / "b.dcd")
    write_xtc(p1, fr[:3])
    write_dcd(p2, fr[3:6])
    u = Universe(u0.topology, [p1, p2, fr[6:], MemoryReader(fr[:1])])
    assert u.trajectory.n_frames == 10
    np.testing.assert_allclose(u.trajectory[4].positions, fr[4], atol=1e-5)
    np.testing.assert_allclose(u.trajectory[8].positions, fr[8], atol=1e-6)
    block, _ = u.trajectory.read_block(2, 8)      # spans two boundaries
    np.testing.assert_allclose(block, fr[2:8], atol=1e-2)


# ---------------- BASELINE config 1 at a small size ----------------

def test_psf_dcd_universe_runs_config1_like_jax(tmp_path):
    """Config 1's route (chip_smoke.py phase 7) at 24 residues: the
    topology through write_psf, the frames through write_dcd, reopened
    as Universe(psf, dcd) in both packages; AlignedRMSF on the fused
    route (the kernel's plain version on the CPU) and the generic one
    against the JAX package and the serial oracle."""
    kw = dict(n_residues=24, n_frames=20, noise=0.3, seed=1)
    u0 = make_protein_universe(**kw)
    psf, dcd = str(tmp_path / "adk.psf"), str(tmp_path / "adk.dcd")
    write_psf(psf, u0.topology)
    write_dcd(dcd, u0.trajectory.read_block(0, 20)[0])
    u, ju = Universe(psf, dcd), JUniverse(psf, dcd)
    assert isinstance(u.trajectory, DCDReader)
    np.testing.assert_allclose(u.atoms.masses, u0.atoms.masses, atol=1e-4)
    run = dict(device="cpu", batch_size=8, transfer_dtype="int16")
    oracle = AlignedRMSF(u, select="name CA").run(backend="serial")
    fused = AlignedRMSF(u, select="name CA", engine="fused").run(**run)
    generic = AlignedRMSF(u, select="name CA").run(**run)
    ref = JAlignedRMSF(ju, select="name CA").run(
        backend="jax", batch_size=8, transfer_dtype="int16")
    np.testing.assert_allclose(fused.results.rmsf, generic.results.rmsf,
                               atol=5e-4)
    np.testing.assert_allclose(generic.results.rmsf,
                               np.asarray(ref.results.rmsf), atol=1e-5)
    for r in (fused, generic):
        np.testing.assert_allclose(r.results.rmsf, oracle.results.rmsf,
                                   atol=1e-3)
