"""Twin of ``tests/test_topologyobjects.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

TopologyGroup surface (u.bonds/angles/dihedrals/impropers,
AtomGroup intersection filtering, vectorized values() against analytic
geometry), PSF NTHETA/NPHI/NIMPHI round trips, subset/concatenate
tuple remapping, and the bond-graph guessers."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.topology import Topology, concatenate
from mdanalysis_mpi_tpu_torch.core.topologyobjects import (
    guess_angles, guess_dihedrals, guess_improper_dihedrals)
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.io.psf import parse_psf, write_psf

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


def _butane_like():
    """4-atom chain C0-C1-C2-C3 with exact analytic geometry: 90-degree
    angle at C1, right-handed 90-degree dihedral."""
    top = Topology(
        names=np.array(["C0", "C1", "C2", "C3"]),
        resnames=np.full(4, "BUT"), resids=np.ones(4, np.int64),
        segids=np.full(4, "S"), elements=np.array(["C"] * 4),
        masses=np.full(4, 12.0), charges=np.zeros(4),
        bonds=np.array([[0, 1], [1, 2], [2, 3]]),
        angles=np.array([[0, 1, 2], [1, 2, 3]]),
        dihedrals=np.array([[0, 1, 2, 3]]),
        impropers=np.array([[1, 0, 2, 3]]),
    )
    coords = np.array([[1.5, 0, 0],       # C0
                       [0, 0, 0],         # C1
                       [0, 1.5, 0],       # C2
                       [0, 1.5, 1.5]],    # C3: dihedral 90 deg
                      np.float32)
    return Universe(top, MemoryReader(coords[None]))


def test_universe_groups_and_values():
    u = _butane_like()
    assert len(u.bonds) == 3
    np.testing.assert_allclose(u.bonds.values(), [1.5, 1.5, 1.5],
                               atol=1e-6)
    assert len(u.angles) == 2
    np.testing.assert_allclose(u.angles.values(), [90.0, 90.0],
                               atol=1e-5)
    assert len(u.dihedrals) == 1
    assert abs(abs(u.dihedrals.values()[0]) - 90.0) < 1e-4
    assert len(u.impropers) == 1
    assert np.isfinite(u.impropers.values()).all()


def test_atomgroup_strict_intersection():
    u = _butane_like()
    ag = u.atoms[[0, 1, 2]]
    assert len(ag.bonds) == 2                 # 0-1, 1-2; 2-3 dropped
    assert len(ag.angles) == 1                # only (0,1,2)
    assert len(ag.dihedrals) == 0
    # single-member indexing works like upstream's per-object value
    b0 = u.bonds[0]
    assert len(b0) == 1
    np.testing.assert_allclose(b0.values(), [1.5], atol=1e-6)


def test_missing_connectivity_raises():
    top = Topology(names=np.array(["A"]), resnames=np.array(["R"]),
                   resids=np.array([1]))
    u = Universe(top, MemoryReader(np.zeros((1, 1, 3), np.float32)))
    with pytest.raises(ValueError, match="no angles"):
        u.angles
    with pytest.raises(ValueError, match="no bonds"):
        u.bonds


def test_psf_round_trip_with_all_sections(tmp_path):
    u = _butane_like()
    p = str(tmp_path / "but.psf")
    write_psf(p, u.topology)
    top = parse_psf(p)
    np.testing.assert_array_equal(top.bonds, u.topology.bonds)
    np.testing.assert_array_equal(top.angles, u.topology.angles)
    np.testing.assert_array_equal(top.dihedrals, u.topology.dihedrals)
    np.testing.assert_array_equal(top.impropers, u.topology.impropers)


def test_subset_remaps_tuples():
    u = _butane_like()
    sub = u.topology.subset(np.array([1, 2, 3]))
    np.testing.assert_array_equal(sub.bonds, [[0, 1], [1, 2]])
    np.testing.assert_array_equal(sub.angles, [[0, 1, 2]])
    # atom 0 left the selection: the tuples are KNOWN and zero survive
    # — an empty array, NOT None (None means 'no connectivity info')
    assert sub.dihedrals is not None and len(sub.dihedrals) == 0
    assert sub.impropers is not None and len(sub.impropers) == 0


def test_concatenate_offsets_tuples():
    u = _butane_like()
    t = u.topology
    both = concatenate([t, t])
    assert len(both.angles) == 4
    np.testing.assert_array_equal(both.angles[2:], t.angles + 4)
    np.testing.assert_array_equal(both.dihedrals[1], t.dihedrals[0] + 4)


def test_guessers_on_chain():
    bonds = np.array([[0, 1], [1, 2], [2, 3]])
    angles = guess_angles(bonds, 4)
    np.testing.assert_array_equal(angles, [[0, 1, 2], [1, 2, 3]])
    dih = guess_dihedrals(angles, bonds, 4)
    np.testing.assert_array_equal(dih, [[0, 1, 2, 3]])
    # branched center: improper at the apex
    star = np.array([[0, 1], [0, 2], [0, 3]])
    a = guess_angles(star, 4)
    assert len(a) == 3
    imp = guess_improper_dihedrals(a, star, 4)
    assert len(imp) == 3
    assert all(t[0] == 0 for t in imp)        # apex first


def test_minimum_image_bond_values():
    """A bond crossing the periodic boundary measures the wrapped
    distance."""
    top = Topology(names=np.array(["A", "B"]),
                   resnames=np.full(2, "R"), resids=np.ones(2, np.int64),
                   bonds=np.array([[0, 1]]))
    coords = np.array([[[0.5, 5, 5], [9.5, 5, 5]]], np.float32)
    dims = np.array([10, 10, 10, 90, 90, 90], np.float32)
    u = Universe(top, MemoryReader(coords, dimensions=dims))
    np.testing.assert_allclose(u.bonds.values(), [1.0], atol=1e-5)


def test_dihedral_analysis_accepts_topologygroup():
    """Dihedral(u.dihedrals) runs the batched kernel over every proper
    dihedral and matches the TopologyGroup's own per-frame values."""
    from mdanalysis_mpi_tpu_torch.analysis import Dihedral

    u = _butane_like()
    a = Dihedral(u.dihedrals).run()
    assert np.asarray(a.results.angles).shape == (1, 1)
    tg_val = u.dihedrals.values()[0]
    np.testing.assert_allclose(abs(a.results.angles[0, 0]),
                               abs(tg_val), atol=1e-4)
    with pytest.raises(ValueError, match="4-atom"):
        Dihedral(u.angles)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("n_res", [1, 4, 9])
def test_guessed_terms_match_jax_package(n_res):
    """Angles, dihedrals and impropers guessed from the same bonds."""
    def case(mod):
        u = mod("testing").make_protein_universe(n_residues=n_res,
                                                 n_frames=1)
        bonds = np.asarray(u.atoms.guess_bonds())
        to = mod("core.topologyobjects")
        ang = to.guess_angles(bonds, u.atoms.n_atoms)
        n = u.atoms.n_atoms
        return (bonds, ang, to.guess_dihedrals(ang, bonds, n),
                to.guess_improper_dihedrals(ang, bonds, n))
    assert_same(*both(case))
