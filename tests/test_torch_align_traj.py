"""The port's ``AlignTraj``, ``alignto``, ``rotation_matrix`` and
``sequence_alignment`` against the JAX package, on ``device="cpu"``.

Both packages build the same universes from the same seeds.  AlignTraj's
torch backend superposes in float32 like the JAX package's ``jax``
backend: the two agree within 1e-4 Å on the same frames, and each
within 2e-3 Å of its serial float64 path (tests/test_analysis.py's
gate).  The host-side helpers are float64 NumPy in both packages and
agree to 1e-12; ``sequence_alignment`` gives identical strings and
pairs.  The streamed (``in_memory=False``) cases mirror
tests/test_writer.py.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis import AlignTraj as JAlignTraj  # noqa: E402
from mdanalysis_mpi_tpu.analysis import alignto as jalignto  # noqa: E402
from mdanalysis_mpi_tpu.analysis import (  # noqa: E402
    rotation_matrix as jrotation_matrix)
from mdanalysis_mpi_tpu.analysis import (  # noqa: E402
    sequence_alignment as jsequence_alignment)
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.analysis import (AlignTraj, RMSD,  # noqa: E402
                                               alignto, rotation_matrix,
                                               sequence_alignment)
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader, write_xtc  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import (  # noqa: E402
    make_protein_universe, make_solvated_universe, random_rotation_matrices)

CPU = dict(backend="torch", device="cpu")


def _all_frames(u):
    return u.trajectory.read_block(0, u.trajectory.n_frames)[0]


def test_aligntraj_in_memory_matches_jax_and_serial():
    kw = dict(n_residues=6, n_frames=10, noise=0.1, seed=5)
    u, ju, us = (make_protein_universe(**kw), jax_make_protein_universe(**kw),
                 make_protein_universe(**kw))
    ref_frame0 = u.trajectory[0].positions.copy()
    AlignTraj(u, select="name CA").run(**CPU, batch_size=4)
    JAlignTraj(ju, select="name CA").run(backend="jax", batch_size=4)
    AlignTraj(us, select="name CA").run(backend="serial")
    assert u.trajectory.n_frames == 10
    got = _all_frames(u)
    np.testing.assert_allclose(got, _all_frames(ju), atol=1e-4)
    np.testing.assert_allclose(got, _all_frames(us), atol=2e-3)
    # after alignment every frame is close to frame 0 (noise only)
    for i in range(10):
        d = np.linalg.norm(got[i] - ref_frame0, axis=1).mean()
        assert d < 1.0, f"frame {i} misaligned (mean dev {d})"


def test_aligntraj_serial_matches_jax_serial():
    kw = dict(n_residues=6, n_frames=9, noise=0.2, seed=9)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    AlignTraj(u, select="name CA").run(backend="serial")
    JAlignTraj(ju, select="name CA").run(backend="serial")
    np.testing.assert_allclose(_all_frames(u), _all_frames(ju), atol=1e-5)


def test_aligntraj_preserves_per_frame_boxes():
    u = make_protein_universe(n_residues=4, n_frames=6, noise=0.1, box=30.0)
    u.trajectory._dims[:, 0] = 30.0 + np.arange(6)
    expected = u.trajectory._dims.copy()
    AlignTraj(u, select="name CA").run(**CPU, batch_size=4)
    for i in range(6):
        np.testing.assert_array_equal(u.trajectory[i].dimensions, expected[i])


def test_aligntraj_non_contiguous_frames():
    kw = dict(n_residues=5, n_frames=12, noise=0.2, seed=2)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    frames = [0, 3, 4, 9, 11]
    AlignTraj(u, select="name CA").run(frames=frames, **CPU, batch_size=2)
    JAlignTraj(ju, select="name CA").run(frames=frames, backend="jax",
                                         batch_size=2)
    assert u.trajectory.n_frames == 5
    np.testing.assert_allclose(_all_frames(u), _all_frames(ju), atol=1e-4)


@pytest.mark.parametrize("backend", ["serial", "torch"])
@pytest.mark.parametrize("ext,atol", [("xtc", 3e-2), ("dcd", 1e-4)])
def test_aligntraj_file_output(tmp_path, backend, ext, atol):
    run = dict(device="cpu") if backend == "torch" else {}
    u = make_protein_universe(n_residues=6, n_frames=10)
    u_mem = make_protein_universe(n_residues=6, n_frames=10)
    AlignTraj(u_mem, select="name CA", in_memory=True).run(
        backend=backend, **run)
    ref_block = _all_frames(u_mem)
    path = str(tmp_path / f"aligned.{ext}")
    r = AlignTraj(u, select="name CA", in_memory=False,
                  filename=path).run(backend=backend, batch_size=4, **run)
    assert r.results.filename == path
    assert isinstance(u.trajectory, MemoryReader)     # mobile untouched
    got, _ = r.results.universe.trajectory.read_block(0, 10)
    np.testing.assert_allclose(got, ref_block, atol=atol)


def test_aligntraj_streamed_dcd_reads_back_to_the_fitted_rmsd(tmp_path):
    """chip_smoke.py phase 6's check at a small size: the written
    trajectory's plain RMSD equals the fitted RMSD of the source."""
    u = make_protein_universe(n_residues=8, n_frames=12, noise=0.3, seed=4)
    fitted = RMSD(u, select="name CA").run(**CPU, batch_size=5)
    path = str(tmp_path / "fit.dcd")
    r = AlignTraj(u, select="name CA", in_memory=False,
                  filename=path).run(**CPU, batch_size=5)
    back = RMSD(r.results.universe, select="name CA",
                superposition=False).run(**CPU, batch_size=5)
    np.testing.assert_allclose(back.results.rmsd, fitted.results.rmsd,
                               atol=1e-4)


def test_aligntraj_streamed_files_are_byte_identical_to_jax(tmp_path):
    kw = dict(n_residues=5, n_frames=7, noise=0.2, seed=6)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    p, jp = str(tmp_path / "port.dcd"), str(tmp_path / "jax.dcd")
    AlignTraj(u, select="name CA", in_memory=False,
              filename=p).run(backend="serial")
    JAlignTraj(ju, select="name CA", in_memory=False,
               filename=jp).run(backend="serial")
    with open(p, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()


def test_aligntraj_derives_filename_from_source(tmp_path):
    u_mem = make_protein_universe(n_residues=4, n_frames=6)
    src = str(tmp_path / "traj.xtc")
    write_xtc(src, _all_frames(u_mem))
    u = Universe(u_mem.topology, XTCReader(src))
    r = AlignTraj(u, select="name CA", in_memory=False).run(**CPU)
    assert r.filename == str(tmp_path / "rmsfit_traj.xtc")
    assert os.path.exists(r.filename)
    assert r.results.universe.trajectory.n_frames == 6


def test_aligntraj_error_removes_partial_file(tmp_path):
    """A mid-run failure must not leave a self-consistent truncated file."""
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
    """step=2 output numbers its frames 0..n-1 like the MemoryReader."""
    u = make_protein_universe(n_residues=4, n_frames=8)
    path = str(tmp_path / "out.xtc")
    AlignTraj(u, select="name CA", in_memory=False,
              filename=path).run(step=2, **CPU)
    r = XTCReader(path)
    assert r.n_frames == 4
    assert [r[i].frame for i in range(4)] == [0, 1, 2, 3]


def test_aligntraj_errors(tmp_path):
    u = make_protein_universe(n_residues=4, n_frames=4)
    path = str(tmp_path / "out.dcd")
    with pytest.raises(ValueError, match="zero frames"):
        AlignTraj(u, in_memory=False, filename=path).run(start=2, stop=2,
                                                         **CPU)
    assert not os.path.exists(path)
    with pytest.raises(ValueError, match="filename"):
        AlignTraj(u, select="name CA", in_memory=False)
    with pytest.raises(ValueError, match="matched no atoms"):
        AlignTraj(u, select="name ZZ").run(**CPU)
    with pytest.raises(ValueError, match="backend"):
        AlignTraj(u, select="name CA").run(backend="jax")
    src = str(tmp_path / "traj.xtc")
    write_xtc(src, _all_frames(u))
    ux = Universe(u.topology, XTCReader(src))
    with pytest.raises(ValueError, match="source trajectory itself"):
        AlignTraj(ux, in_memory=False, filename=src).run(backend="serial")
    assert XTCReader(src).n_frames == 4    # input intact


# ---------------- rotation_matrix / alignto ----------------

@pytest.mark.parametrize("weighted", [False, True])
def test_rotation_matrix_matches_jax(weighted):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(20, 3))
    a -= a.mean(axis=0)
    b = a @ random_rotation_matrices(1, rng)[0] + rng.normal(
        scale=0.2, size=a.shape)
    b -= b.mean(axis=0)
    w = rng.uniform(0.5, 2.0, size=20) if weighted else None
    r, val = rotation_matrix(a, b, weights=w)
    jr, jval = jrotation_matrix(a, b, weights=w)
    np.testing.assert_allclose(r, jr, atol=1e-12)
    assert abs(val - jval) <= 1e-12
    d2 = (((a @ r.T) - b) ** 2).sum(axis=1)
    wv = np.ones(20) if w is None else w
    np.testing.assert_allclose(val, np.sqrt((wv @ d2) / wv.sum()),
                               rtol=1e-10)
    x = rng.normal(size=(40, 3))
    x -= x.mean(axis=0)
    rot = random_rotation_matrices(1, rng)[0]
    r, val = rotation_matrix(x @ rot, x)
    assert val < 1e-12
    np.testing.assert_allclose((x @ rot) @ r.T, x, atol=1e-12)
    with pytest.raises(ValueError, match="N, 3"):
        rotation_matrix(a, b[:4])


@pytest.mark.parametrize("weights", [None, "mass"])
def test_alignto_matches_jax_in_place(weights):
    kw = dict(n_residues=12, n_frames=3, noise=0.2, seed=4)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    mob, jmob = u.copy(), ju.copy()
    mob.trajectory[0]
    jmob.trajectory[0]
    u.trajectory[2]
    ju.trajectory[2]
    old, new = alignto(mob, u, select="name CA", weights=weights)
    jold, jnew = jalignto(jmob, ju, select="name CA", weights=weights)
    assert new < old
    assert abs(old - jold) <= 1e-12 and abs(new - jnew) <= 1e-12
    np.testing.assert_allclose(mob.trajectory.ts.positions,
                               jmob.trajectory.ts.positions, atol=1e-5)
    if weights is None:
        ca = mob.select_atoms("name CA")
        ref = u.select_atoms("name CA")
        d = np.sqrt(((ca.positions - ref.positions) ** 2).sum(1).mean())
        assert d == pytest.approx(new, abs=1e-3)


def test_alignto_errors():
    u = make_protein_universe(n_residues=4, n_frames=2)
    ref = make_protein_universe(n_residues=4, n_frames=2)
    with pytest.raises(ValueError, match="matched no atoms"):
        alignto(u, ref, select="name ZZ")
    with pytest.raises(ValueError, match="weights"):
        alignto(u, ref, select="name CA", weights="charge")
    with pytest.raises(ValueError, match="sizes differ"):
        alignto(u, make_protein_universe(n_residues=5, n_frames=2),
                select="name CA")
    with pytest.raises(TypeError):
        alignto(u)


def test_alignto_respects_group_membership():
    u = make_solvated_universe(n_residues=5, n_waters=20, n_frames=2, seed=6)
    ref = make_solvated_universe(n_residues=5, n_waters=20, n_frames=2,
                                 seed=6)
    ref.trajectory[1]
    u.trajectory[0]
    # passing protein groups fits on protein only: a reference universe
    # that HAS no waters cannot match sizes under a whole-universe fit
    prot = ref.select_atoms("protein")
    ref_only = Universe(ref.topology.subset(prot.indices),
                        prot.positions[None])
    old, new = alignto(u.select_atoms("protein"), ref_only.atoms)
    assert new <= old


# ---------------- sequence_alignment ----------------

def _chain(resnames, pkg=(Topology, Universe, MemoryReader)):
    top_cls, uni_cls, mem_cls = pkg
    n = len(resnames)
    top = top_cls(names=np.full(n, "CA"), resnames=np.array(resnames),
                  resids=np.arange(1, n + 1))
    return uni_cls(top, mem_cls(np.zeros((1, n, 3), np.float32)))


def _jchain(resnames):
    return _chain(resnames, (JTopology, JUniverse, JMemoryReader))


def test_sequence_alignment_cases():
    a = _chain(["ALA", "GLY", "LYS", "TRP"])
    b = _chain(["ALA", "GLY", "LYS", "TRP"])
    s1, s2, pairs = sequence_alignment(a.atoms, b.atoms)
    assert s1 == s2 == "AGKW"
    np.testing.assert_array_equal(pairs,
                                  np.stack([np.arange(4)] * 2, axis=1))
    c = _chain(["ALA", "GLY", "PHE", "LYS", "TRP"])
    s1, s2, pairs = sequence_alignment(c.atoms, b.atoms)
    assert s1 == "AGFKW" and s2 == "AG-KW"
    np.testing.assert_array_equal(pairs[:, 0], [0, 1, 3, 4])
    np.testing.assert_array_equal(pairs[:, 1], [0, 1, 2, 3])
    with pytest.raises(ValueError, match="residue"):
        sequence_alignment(a.atoms[[]], b.atoms)
    # affine gap: a 3-residue loop opens ONE gap
    d = _chain(["ALA", "GLY", "PHE", "PHE", "PHE", "LYS", "TRP"])
    s1, s2, pairs = sequence_alignment(d.atoms, b.atoms)
    assert s1 == "AGFFFKW" and s2 == "AG---KW"
    np.testing.assert_array_equal(pairs[:, 0], [0, 1, 5, 6])
    # full Gotoh: the X<->Y transition wins over a costly mismatch
    s1, s2, pairs = sequence_alignment(
        _chain(["ALA", "TRP"]).atoms, _chain(["ALA", "VAL"]).atoms,
        mismatch=-10.0, gap_open=-1.0, gap_extend=-0.1)
    assert "-" in s1 and "-" in s2
    assert len(pairs) == 1 and tuple(pairs[0]) == (0, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequence_alignment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    codes = ["ALA", "GLY", "LYS", "TRP", "PHE", "SER", "HSD", "XYZ"]
    ra = list(rng.choice(codes, size=int(rng.integers(5, 30))))
    rb = list(rng.choice(codes, size=int(rng.integers(5, 30))))
    got = sequence_alignment(_chain(ra).atoms, _chain(rb).atoms,
                             gap_open=-1.5)
    want = jsequence_alignment(_jchain(ra).atoms, _jchain(rb).atoms,
                               gap_open=-1.5)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
