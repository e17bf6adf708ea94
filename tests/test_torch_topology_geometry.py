"""What neighbour search unblocks in the port's core, against the JAX
package on the same inputs: ``AtomGroup.guess_bonds`` (every capped-
distance engine, the torch one on ``device="cpu"``, and the cache
invalidation), ``TopologyGroup.values`` (bonds, angles, dihedrals,
impropers; minimum image), ``lib.mdamath.make_whole`` (in place and
not) and ``analysis.distances.contact_matrix(returntype="sparse")``.
Mirrors tests/test_core.py's guess_bonds cases, test_topologyobjects.py
and test_distances.py's make_whole case; the bonds must be EQUAL, the
geometry equal to the float64 reference's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis import distances as jadist  # noqa: E402
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402
from mdanalysis_mpi_tpu.lib.mdamath import make_whole as jmake_whole  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jmake_protein_universe)
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_water_universe as jmake_water_universe)

from mdanalysis_mpi_tpu_torch.analysis import distances as tadist  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.lib.mdamath import make_whole  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import (  # noqa: E402
    make_protein_universe, make_water_universe)

PORT = (Topology, Universe, MemoryReader)
JAX = (JTopology, JUniverse, JMemoryReader)
ENGINES = ["auto", "nsgrid", "bruteforce", "torch"]


def _jax_engine(engine):
    return "jax" if engine == "torch" else engine


def _guess(u, engine, **kw):
    if engine == "torch":
        kw["device"] = "cpu"
    return u.atoms.guess_bonds(engine=engine, **kw)


def _water_grid(pkg):
    """64 waters on a 4 Å lattice in a 16 Å box (tests/test_nsgrid.py)."""
    top_cls, uni_cls, reader_cls = pkg
    rng = np.random.default_rng(12)
    n_w = 64
    cell = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                    -1).reshape(-1, 3) * 4.0
    pos = np.zeros((3 * n_w, 3), np.float32)
    pos[0::3] = cell
    pos[1::3] = cell + [0.96, 0.0, 0.0]
    pos[2::3] = cell + [-0.24, 0.93, 0.0]
    pos += rng.normal(scale=0.02, size=pos.shape).astype(np.float32)
    top = top_cls(names=np.tile(np.array(["OW", "HW1", "HW2"]), n_w),
                  resnames=np.full(3 * n_w, "SOL"),
                  resids=np.repeat(np.arange(1, n_w + 1), 3))
    dims = np.array([16.0, 16, 16, 90, 90, 90], np.float32)
    return uni_cls(top, reader_cls(pos[None], dimensions=dims))


class TestGuessBonds:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_water_grid_equal_to_jax(self, engine):
        u, ju = _water_grid(PORT), _water_grid(JAX)
        got = _guess(u, engine)
        want = ju.atoms.guess_bonds(engine=_jax_engine(engine))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(u.topology.bonds, ju.topology.bonds)
        assert len(got) == 128                  # 2 O-H bonds a water

    @pytest.mark.parametrize("engine", ENGINES)
    def test_water_box_two_bonds_per_water(self, engine):
        u = make_water_universe(n_waters=8, n_frames=1, box=8.0)
        ju = jmake_water_universe(n_waters=8, n_frames=1, box=8.0)
        assert u.topology.bonds is None
        got = _guess(u, engine)
        np.testing.assert_array_equal(got, ju.atoms.guess_bonds())
        assert len(got) == 16
        for o, h in got:
            assert u.topology.resindices[o] == u.topology.resindices[h]

    @pytest.mark.parametrize("engine", ["auto", "torch"])
    def test_protein_equal_to_jax(self, engine):
        u = make_protein_universe(n_residues=12, n_frames=1, seed=2)
        ju = jmake_protein_universe(n_residues=12, n_frames=1, seed=2)
        got = _guess(u, engine, fudge_factor=0.6)
        want = ju.atoms.guess_bonds(fudge_factor=0.6,
                                    engine=_jax_engine(engine))
        np.testing.assert_array_equal(got, want)
        assert len(got) > 0

    def test_enables_bonded_selection_and_busts_cache(self):
        u = make_water_universe(n_waters=4, n_frames=1, box=8.0)
        with pytest.raises(ValueError, match="bond"):
            u.select_atoms("bonded name OW")
        version = u.topology._derived.get("attr_version", 0)
        u.atoms.guess_bonds()
        assert u.topology._derived["attr_version"] == version + 1
        got = u.select_atoms("bonded name OW")
        assert got.n_atoms == 8
        assert u.topology.is_hydrogen[got.indices].all()

    def test_group_scoped_guess_and_small_groups(self):
        u = make_water_universe(n_waters=6, n_frames=1, box=10.0)
        ju = jmake_water_universe(n_waters=6, n_frames=1, box=10.0)
        got = u.select_atoms("resid 1").guess_bonds(engine="torch",
                                                     device="cpu")
        np.testing.assert_array_equal(
            got, ju.select_atoms("resid 1").guess_bonds())
        assert len(got) == 2
        assert u.select_atoms("resid 99").guess_bonds().shape == (0, 2)
        assert u.select_atoms("name OW and resid 1").guess_bonds(
        ).shape == (0, 2)

    def test_invalidates_fragment_cache(self):
        for pkg in (PORT, JAX):
            top = pkg[0](names=np.array(["C", "C"]),
                         resnames=np.array(["MOL"] * 2),
                         resids=np.array([1, 1]),
                         elements=np.array(["C", "C"]))
            pos = np.array([[[0.0, 0, 0], [1.4, 0, 0]]], np.float32)
            u = pkg[1](top, pkg[2](pos))
            top.bonds = np.empty((0, 2), np.int64)
            assert u.topology.n_fragments == 2
            u.atoms.guess_bonds()
            assert u.topology.n_fragments == 1

    def test_unknown_element_raises(self):
        top = Topology(names=np.array(["XQ1", "XQ2"]),
                       resnames=np.array(["UNK", "UNK"]),
                       resids=np.array([1, 1]))
        u = Universe(top, MemoryReader(np.zeros((1, 2, 3), np.float32)))
        with pytest.raises(ValueError, match="radius"):
            u.atoms.guess_bonds()


def _butane(pkg, dims=None):
    top_cls, uni_cls, reader_cls = pkg
    top = top_cls(
        names=np.array(["C0", "C1", "C2", "C3"]),
        resnames=np.full(4, "BUT"), resids=np.ones(4, np.int64),
        segids=np.full(4, "S"), elements=np.array(["C"] * 4),
        masses=np.full(4, 12.0), charges=np.zeros(4),
        bonds=np.array([[0, 1], [1, 2], [2, 3]]),
        angles=np.array([[0, 1, 2], [1, 2, 3]]),
        dihedrals=np.array([[0, 1, 2, 3]]),
        impropers=np.array([[1, 0, 2, 3]]))
    rng = np.random.default_rng(3)
    coords = (np.array([[1.5, 0, 0], [0, 0, 0], [0, 1.5, 0],
                        [0, 1.5, 1.5]])[None]
              + rng.normal(scale=0.2, size=(2, 4, 3))).astype(np.float32)
    if dims is not None:
        coords %= dims[:3]
    return uni_cls(top, reader_cls(coords, dimensions=dims))


class TestTopologyGroupValues:
    @pytest.mark.parametrize("dims", [None, np.array(
        [3.0, 3.2, 3.4, 90, 90, 90], np.float32), np.array(
        [3.0, 3.2, 3.4, 80, 95, 100], np.float32)],
        ids=["nobox", "ortho", "triclinic"])
    @pytest.mark.parametrize("kind", ["bonds", "angles", "dihedrals",
                                      "impropers"])
    def test_values_equal_jax(self, kind, dims):
        u, ju = _butane(PORT, dims), _butane(JAX, dims)
        for frame in (0, 1):
            u.trajectory[frame]
            ju.trajectory[frame]
            got = getattr(u, kind).values()
            np.testing.assert_array_equal(got, getattr(ju, kind).values())
            assert np.isfinite(got).all()

    def test_analytic_butane(self):
        top = Topology(
            names=np.array(["C0", "C1", "C2", "C3"]),
            resnames=np.full(4, "BUT"), resids=np.ones(4, np.int64),
            bonds=np.array([[0, 1], [1, 2], [2, 3]]),
            angles=np.array([[0, 1, 2], [1, 2, 3]]),
            dihedrals=np.array([[0, 1, 2, 3]]))
        coords = np.array([[[1.5, 0, 0], [0, 0, 0], [0, 1.5, 0],
                            [0, 1.5, 1.5]]], np.float32)
        u = Universe(top, MemoryReader(coords))
        np.testing.assert_allclose(u.bonds.values(), [1.5] * 3, atol=1e-6)
        np.testing.assert_allclose(u.angles.values(), [90.0] * 2,
                                   atol=1e-5)
        assert abs(abs(u.dihedrals.values()[0]) - 90.0) < 1e-4
        np.testing.assert_allclose(u.atoms[[0, 1, 2]].bonds.values(),
                                   [1.5, 1.5], atol=1e-6)

    def test_minimum_image_bond_and_guessed_angles(self):
        top = Topology(names=np.array(["A", "B"]),
                       resnames=np.full(2, "R"), resids=np.ones(2, np.int64),
                       bonds=np.array([[0, 1]]))
        coords = np.array([[[0.5, 5, 5], [9.5, 5, 5]]], np.float32)
        dims = np.array([10, 10, 10, 90, 90, 90], np.float32)
        u = Universe(top, MemoryReader(coords, dimensions=dims))
        np.testing.assert_allclose(u.bonds.values(), [1.0], atol=1e-5)
        # guessed bonds feed the angle guesser and its values
        w = make_water_universe(n_waters=6, n_frames=1, box=10.0)
        jw = jmake_water_universe(n_waters=6, n_frames=1, box=10.0)
        w.atoms.guess_bonds(engine="torch", device="cpu")
        jw.atoms.guess_bonds()
        from mdanalysis_mpi_tpu.core.topologyobjects import (
            guess_angles as jguess_angles)

        from mdanalysis_mpi_tpu_torch.core.topologyobjects import (
            guess_angles)

        w.topology.angles = guess_angles(w.topology.bonds, w.topology.n_atoms)
        jw.topology.angles = jguess_angles(jw.topology.bonds,
                                           jw.topology.n_atoms)
        np.testing.assert_array_equal(w.angles.values(),
                                      jw.angles.values())
        assert len(w.angles) == 6


def _chain(pkg, dims):
    """A 3-atom chain whose tail wrapped across the +x boundary."""
    pos = np.array([[[9.0, 5.0, 5.0], [9.8, 5.0, 5.0],
                     [0.6, 5.0, 5.0]]], np.float32)
    top = pkg[0](names=np.array(["C1", "C2", "C3"]),
                 resnames=np.full(3, "MOL"), resids=np.full(3, 1),
                 bonds=np.array([[0, 1], [1, 2]]))
    return pkg[1](top, pkg[2](pos, dimensions=dims))


class TestMakeWhole:
    DIMS = np.array([10.0, 10, 10, 90, 90, 90], np.float32)

    def test_in_place_equal_to_jax(self):
        u, ju = _chain(PORT, self.DIMS), _chain(JAX, self.DIMS)
        out = make_whole(u.atoms)
        np.testing.assert_array_equal(out, jmake_whole(ju.atoms))
        np.testing.assert_allclose(out[2], [10.6, 5.0, 5.0], atol=1e-5)
        np.testing.assert_array_equal(u.trajectory.ts.positions,
                                      ju.trajectory.ts.positions)

    def test_not_in_place_equal_to_jax(self):
        u, ju = _chain(PORT, self.DIMS), _chain(JAX, self.DIMS)
        out = make_whole(u.atoms, inplace=False)
        np.testing.assert_array_equal(out, jmake_whole(ju.atoms,
                                                       inplace=False))
        np.testing.assert_allclose(u.trajectory.ts.positions[2],
                                   [0.6, 5.0, 5.0], atol=1e-6)

    def test_guessed_bonds_then_whole(self):
        """A water box, bonds guessed with the torch engine, every
        molecule made whole: equal to the JAX package's."""
        u = make_water_universe(n_waters=27, n_frames=1, box=9.0, seed=5)
        ju = jmake_water_universe(n_waters=27, n_frames=1, box=9.0, seed=5)
        u.atoms.guess_bonds(engine="torch", device="cpu")
        ju.atoms.guess_bonds()
        np.testing.assert_array_equal(make_whole(u.atoms),
                                      jmake_whole(ju.atoms))

    def test_refusals(self):
        with pytest.raises(ValueError, match="box"):
            make_whole(_chain(PORT, None).atoms)
        bad = np.array([10.0, 0.0, 0.0, 90, 90, 90], np.float32)
        with pytest.raises(ValueError, match="degenerate|volume"):
            make_whole(_chain(PORT, bad).atoms)


class TestSparseContactMatrix:
    @pytest.mark.parametrize("box", [None, np.array(
        [20.0, 20, 20, 90, 90, 90])], ids=["nobox", "ortho"])
    def test_equal_to_jax_and_dense(self, box):
        rng = np.random.default_rng(21)
        x = rng.uniform(0, 20, size=(300, 3))
        sp = tadist.contact_matrix(x, 4.0, returntype="sparse", box=box)
        jsp = jadist.contact_matrix(x, 4.0, returntype="sparse", box=box)
        assert sp.format == "lil"
        np.testing.assert_array_equal(sp.toarray(), jsp.toarray())
        np.testing.assert_array_equal(
            sp.toarray(), tadist.contact_matrix(x, 4.0, box=box))
        assert sp.nnz > len(x)

    def test_returntype_validated(self):
        with pytest.raises(ValueError, match="returntype"):
            tadist.contact_matrix(np.zeros((2, 3)), returntype="csr")
