"""The port's Dihedral, Ramachandran and Janin (``analysis/
dihedrals.py``) and ``ops/dihedrals.dihedral_batch``: the JAX package's
tests/test_dihedrals.py case by case on ``backend="torch",
device="cpu"`` and a two-shard CPU mesh (angles within the reference
tests' 1e-2° of the serial float64 oracle), and the same seeded frames
through the JAX package's ``backend="jax"`` and the port: the same
quadruples and angles within 1e-2°."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis.dihedrals import Dihedral, Ramachandran
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.ops.dihedrals import dihedral_batch_np
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

#: the port's batch backends on the CPU: ``'torch'`` on one device and
#: the mesh over two CPU shards (the JAX package's ``'jax'`` and
#: ``'mesh'``)
TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
BK = {"jax": TORCH, "torch": TORCH, "mesh": MESH,
      "serial": dict(backend="serial")}


def _angle_fixture(theta_deg):
    """Four atoms with dihedral exactly theta (b2 along z)."""
    th = np.radians(theta_deg)
    return np.array([
        [1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0],
        [0.0, 0.0, 1.0],
        [np.cos(th), np.sin(th), 1.0],
    ], dtype=np.float64)


class TestKernel:
    @pytest.mark.parametrize("theta", [0.0, 45.0, 90.0, 135.0, 180.0,
                                       -60.0, -120.0])
    def test_analytic_angles(self, theta):
        pos = _angle_fixture(theta)[None]
        got = float(dihedral_batch_np(pos, np.array([[0, 1, 2, 3]]))[0, 0])
        want = ((theta + 180.0) % 360.0) - 180.0
        if abs(abs(want) - 180.0) < 1e-9:
            assert abs(abs(got) - 180.0) < 1e-6
        else:
            assert abs(got - want) < 1e-6, (got, want)

    def test_torch_matches_numpy(self):
        import torch

        from mdanalysis_mpi_tpu_torch.ops.dihedrals import dihedral_batch

        rng = np.random.default_rng(2)
        pos = rng.normal(size=(5, 12, 3)).astype(np.float32)
        quads = rng.integers(0, 12, size=(7, 4)).astype(np.int64)
        a = dihedral_batch_np(pos, quads)
        b = dihedral_batch(torch.from_numpy(pos),
                           torch.from_numpy(quads)).numpy()
        np.testing.assert_allclose(a, b, atol=1e-2)


class TestDihedral:
    def _universe(self, n_frames=10):
        return make_protein_universe(n_residues=6, n_frames=n_frames,
                                     noise=0.3)

    def _groups(self, u, k=3):
        rng = np.random.default_rng(1)
        n = u.atoms.n_atoms
        return [AtomGroup(u, rng.choice(n, 4, replace=False))
                for _ in range(k)]

    @pytest.mark.parametrize("backend", ["jax", "mesh"])
    def test_backend_parity(self, backend):
        u = self._universe()
        groups = self._groups(u)
        s = Dihedral(groups).run(backend="serial")
        j = Dihedral(groups).run(**BK[backend], batch_size=4)
        assert s.results.angles.shape == (10, 3)
        np.testing.assert_allclose(j.results.angles, s.results.angles,
                                   atol=0.15)

    def test_validation(self):
        u = self._universe()
        with pytest.raises(ValueError, match="at least one"):
            Dihedral([])
        with pytest.raises(ValueError, match="exactly 4"):
            Dihedral([u.select_atoms("name CA")])


class TestRamachandran:
    def test_shapes_and_termini(self):
        u = make_protein_universe(n_residues=8, n_frames=6, noise=0.2)
        r = Ramachandran(u.select_atoms("protein")).run(backend="serial")
        # interior residues only: 8 - 2 termini
        assert r.results.angles.shape == (6, 6, 2)
        assert len(r.resindices) == 6

    def test_backend_parity(self):
        u = make_protein_universe(n_residues=8, n_frames=8, noise=0.2)
        s = Ramachandran(u.select_atoms("protein")).run(backend="serial")
        j = Ramachandran(u.select_atoms("protein")).run(
            **TORCH, batch_size=4)
        np.testing.assert_allclose(j.results.angles, s.results.angles,
                                   atol=0.15)

    def test_selection_window_pulls_neighbors_from_universe(self):
        """resid 3-6 of an 8-residue chain: all four residues get
        angles (neighbors fetched outside the selection, upstream
        semantics)."""
        u = make_protein_universe(n_residues=8, n_frames=3, noise=0.2)
        r = Ramachandran(
            u.select_atoms("protein and resid 3:6")).run(backend="serial")
        assert r.results.angles.shape == (3, 4, 2)

    def test_resid_gap_breaks_adjacency(self):
        """A chain with resids ...3, 20, 21... must not span the gap."""
        from mdanalysis_mpi_tpu_torch.core.topology import Topology

        per = ("N", "CA", "C")
        resids = [1, 2, 3, 20, 21, 22]
        names = np.array(per * len(resids))
        rr = np.repeat(resids, len(per))
        top = Topology(names=names, resnames=np.full(len(names), "ALA"),
                       resids=rr, segids=np.full(len(names), "A"))
        rng = np.random.default_rng(0)
        pos = rng.normal(scale=5.0,
                         size=(2, top.n_atoms, 3)).astype(np.float32)
        u = Universe(top, MemoryReader(pos))
        r = Ramachandran(u.atoms).run(backend="serial")
        # only resids 2 and 21 are interior AND contiguous
        assert r.results.angles.shape == (2, 2, 2)

    def test_needs_protein(self):
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        w = make_water_universe(n_waters=5, n_frames=2)
        with pytest.raises(ValueError, match="protein"):
            Ramachandran(w.atoms)


class TestJanin:
    def _universe(self, n_frames=2, resnames=("LYS", "LYS"),
                  chi1_deg=-60.0):
        """Residues with N/CA/CB/CG/CD side chains; chi1 constructed at
        a known angle by placing CG off the N-CA-CB plane."""
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        names, rn, rid, coords = [], [], [], []
        phi = np.radians(chi1_deg)
        for i, resname in enumerate(resnames):
            base = np.array([8.0 * i, 0.0, 0.0])
            # N-CA along +x, CB along +y from CA; CG at torsion phi
            # about the CA-CB axis relative to N
            n = base + [0.0, 0.0, 0.0]
            ca = base + [1.5, 0.0, 0.0]
            cb = ca + [0.0, 1.5, 0.0]
            # reference direction for torsion 0 is back toward N (-x);
            # rotate about +y by phi
            cg = cb + 1.5 * np.array([-np.cos(phi), 0.0, np.sin(phi)])
            cd = cg + [0.0, 1.5, 0.0]
            for nm, xyz in (("N", n), ("CA", ca), ("CB", cb),
                            ("CG", cg), ("CD", cd)):
                names.append(nm)
                rn.append(resname)
                rid.append(i + 1)
                coords.append(xyz)
        top = Topology(names=np.array(names), resnames=np.array(rn),
                       resids=np.array(rid))
        pos = np.repeat(np.asarray(coords, np.float32)[None], n_frames,
                        axis=0)
        return Universe(top, MemoryReader(pos))

    def test_chi_angles_and_wrap(self):
        from mdanalysis_mpi_tpu_torch.analysis import Janin

        u = self._universe(chi1_deg=-60.0)
        r = Janin(u.atoms).run(backend="serial")
        assert r.results.angles.shape == (2, 2, 2)
        # chi1 = -60 wraps to 300 (Janin-plot convention [0, 360))
        np.testing.assert_allclose(r.results.angles[:, :, 0], 300.0,
                                   atol=1e-4)
        assert ((0 <= r.results.angles) & (r.results.angles < 360)).all()
        j = Janin(u.atoms).run(**TORCH, batch_size=2)
        np.testing.assert_allclose(j.results.angles, r.results.angles,
                                   atol=1e-3)

    def test_remove_resnames_and_missing_atoms(self):
        from mdanalysis_mpi_tpu_torch.analysis import Janin

        u = self._universe(resnames=("LYS", "ALA"))
        # default removal drops the ALA row
        r = Janin(u.atoms).run(backend="serial")
        assert r.results.angles.shape[1] == 1
        # a surviving residue genuinely MISSING side-chain atoms raises
        # loudly instead of silently skipping (row alignment)
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        names = np.array(["N", "CA", "CB", "CG", "CD", "N", "CA", "CB"])
        top = Topology(names=names,
                       resnames=np.array(["LYS"] * 5 + ["MET"] * 3),
                       resids=np.array([1] * 5 + [2] * 3))
        ut = Universe(top, MemoryReader(
            np.random.default_rng(0).normal(
                size=(1, 8, 3)).astype(np.float32)))
        with pytest.raises(ValueError, match="lacks chi1/chi2"):
            Janin(ut.atoms)
        with pytest.raises(ValueError, match="excluded|protein"):
            Janin(u.select_atoms("resname ALA"),
                  remove_resnames=("ALA", "LYS"))

    def test_cys_wildcard_and_updating_refusal(self):
        from mdanalysis_mpi_tpu_torch.analysis import Janin, Ramachandran

        # CYS2 (a CYS* protonation/disulfide variant) is protein but
        # has no chi2 — the default CYS* wildcard must remove it, not
        # crash on it (upstream's select_remove glob)
        u = self._universe(resnames=("LYS", "CYS2"))
        r = Janin(u.atoms).run(backend="serial")
        assert r.results.angles.shape[1] == 1
        uag = u.select_atoms("resname LYS", updating=True)
        with pytest.raises(TypeError, match="UpdatingAtomGroup"):
            Janin(uag)
        with pytest.raises(TypeError, match="UpdatingAtomGroup"):
            Ramachandran(uag)


def test_merge_keeps_distinct_residues():
    """Merging two copies of a one-residue group must yield TWO
    residues (boundary residues never fuse)."""
    import mdanalysis_mpi_tpu_torch as mdt
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    top = Topology(names=np.array(["C1", "C2"]),
                   resnames=np.full(2, "LIG"), resids=np.full(2, 1))
    u = Universe(top, MemoryReader(np.zeros((1, 2, 3), np.float32)))
    m = mdt.Merge(u.atoms, u.atoms)
    assert m.topology.n_atoms == 4
    np.testing.assert_array_equal(m.topology.resindices, [0, 0, 1, 1])
    assert len(m.residues) == 2


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu import analysis as janalysis  # noqa: E402
from mdanalysis_mpi_tpu.core.groups import AtomGroup as JAtomGroup  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

torch.set_num_threads(1)

_KW = dict(n_residues=8, n_frames=9, noise=0.3, seed=12)


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_dihedral_and_ramachandran_match_jax_package(backend):
    u, ju = make_protein_universe(**_KW), jax_make_protein_universe(**_KW)
    rng = np.random.default_rng(3)
    quads = [rng.choice(u.atoms.n_atoms, 4, replace=False)
             for _ in range(5)]
    p = Dihedral([AtomGroup(u, q) for q in quads]).run(
        **BK[backend], batch_size=4)
    j = janalysis.Dihedral([JAtomGroup(ju, q) for q in quads]).run(
        backend="jax", batch_size=4)
    np.testing.assert_allclose(p.results.angles,
                               np.asarray(j.results.angles), atol=1e-2)
    pr = Ramachandran(u.select_atoms("protein")).run(
        **BK[backend], batch_size=4)
    jr = janalysis.Ramachandran(ju.select_atoms("protein")).run(
        backend="jax", batch_size=4)
    np.testing.assert_array_equal(pr.resindices, jr.resindices)
    np.testing.assert_array_equal(pr._quads_global, jr._quads_global)
    np.testing.assert_allclose(pr.results.angles,
                               np.asarray(jr.results.angles), atol=1e-2)


def test_janin_matches_jax_package():
    from mdanalysis_mpi_tpu_torch.analysis import Janin

    u, ju = make_protein_universe(**_KW), jax_make_protein_universe(**_KW)
    try:
        jr = janalysis.Janin(ju.select_atoms("protein"),
                             remove_resnames=()).run(backend="jax",
                                                     batch_size=4)
    except ValueError:
        # the synthetic protein carries no chi2 side chains: both
        # packages refuse it alike
        with pytest.raises(ValueError, match="chi1/chi2"):
            Janin(u.select_atoms("protein"), remove_resnames=())
        return
    pr = Janin(u.select_atoms("protein"), remove_resnames=()).run(
        **TORCH, batch_size=4)
    np.testing.assert_allclose(pr.results.angles,
                               np.asarray(jr.results.angles), atol=1e-2)


def test_janin_fixture_matches_jax_package():
    """The Janin fixture of this file, built in both packages: angles
    within 1e-2° and wrapped to [0, 360)."""
    from mdanalysis_mpi_tpu.core.topology import Topology as JTopology
    from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
    from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader
    from mdanalysis_mpi_tpu_torch.analysis import Janin

    u = TestJanin()._universe(n_frames=5, resnames=("LYS", "ARG", "GLU"),
                              chi1_deg=-75.0)
    t = u.topology
    frames = u.trajectory.read_block(0, 5)[0]
    ju = JUniverse(JTopology(names=t.names, resnames=t.resnames,
                             resids=t.resids), JMemoryReader(frames))
    p = Janin(u.atoms).run(**TORCH, batch_size=2)
    j = janalysis.Janin(ju.atoms).run(backend="jax", batch_size=2)
    np.testing.assert_allclose(p.results.angles,
                               np.asarray(j.results.angles), atol=1e-2)
    assert (p.results.angles >= 0).all() and (p.results.angles < 360).all()
