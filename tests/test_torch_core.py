"""Twin of ``tests/test_core.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Core data-model tests: Topology, Universe, AtomGroup, MemoryReader."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import Universe
from mdanalysis_mpi_tpu_torch.core.topology import Topology, make_protein_topology
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, outcome, port_runs_on_the_cpu)


def test_topology_basics():
    top = make_protein_topology(3)
    assert top.n_atoms == 15
    assert top.n_residues == 3
    assert top.is_protein.all()
    np.testing.assert_array_equal(top.resindices[:6], [0, 0, 0, 0, 0, 1])


def test_topology_length_mismatch():
    with pytest.raises(ValueError):
        Topology(names=np.array(["A", "B"]), resnames=np.array(["X"]),
                 resids=np.array([1, 1]))


def test_universe_ndarray_construction():
    # RMSF.py:113 path: Universe(topology, raw ndarray)
    top = make_protein_topology(2)
    coords = np.arange(top.n_atoms * 3, dtype=np.float32).reshape(1, -1, 3)
    u = Universe(top, coords)
    assert u.trajectory.n_frames == 1
    np.testing.assert_array_equal(u.atoms.positions, coords[0])


def test_memory_reader_random_access_and_isolation():
    coords = np.random.default_rng(0).normal(size=(5, 4, 3)).astype(np.float32)
    r = MemoryReader(coords)
    ts2 = r[2]
    assert ts2.frame == 2
    # In-place mutation must NOT persist (RMSF.py:124 semantics).
    ts2.positions[:] = 0.0
    np.testing.assert_array_equal(r[2].positions, coords[2])
    with pytest.raises(IndexError):
        r[5]
    assert r[-1].frame == 4


def test_read_block():
    coords = np.random.default_rng(1).normal(size=(7, 3, 3)).astype(np.float32)
    dims = np.tile(np.array([10, 10, 10, 90, 90, 90], np.float32), (7, 1))
    r = MemoryReader(coords, dimensions=dims)
    block, boxes = r.read_block(2, 5)
    np.testing.assert_array_equal(block, coords[2:5])
    np.testing.assert_array_equal(boxes, dims[2:5])
    # empty block is legal (Q2 edge case)
    empty, _ = r.read_block(3, 3)
    assert empty.shape == (0, 3, 3)


def test_universe_copy_independent_cursor():
    # RMSF.py:57: the copy seeks independently of the original.
    u = make_protein_universe(n_residues=4, n_frames=6)
    ref = u.copy()
    u.trajectory[3]
    ref.trajectory[0]
    assert u.trajectory.ts.frame == 3
    assert ref.trajectory.ts.frame == 0
    np.testing.assert_array_equal(ref.atoms.positions,
                                  u.copy().trajectory[0].positions)


def test_center_of_mass_mass_weighted():
    top = Topology(names=np.array(["C", "O"]),
                   resnames=np.array(["GLY", "GLY"]),
                   resids=np.array([1, 1]))
    coords = np.array([[[0, 0, 0], [1, 0, 0]]], dtype=np.float32)
    u = Universe(top, coords)
    com = u.atoms.center_of_mass()
    expected = 15.999 / (12.011 + 15.999)
    assert com[0] == pytest.approx(expected)
    cog = u.atoms.center_of_geometry()
    assert cog[0] == pytest.approx(0.5)


def test_atomgroup_positions_setter():
    u = make_protein_universe(n_residues=2, n_frames=2)
    ca = u.select_atoms("name CA")
    ca.positions = np.zeros((ca.n_atoms, 3))
    np.testing.assert_array_equal(ca.positions, 0.0)
    # next read restores
    u.trajectory[0]
    assert not np.allclose(ca.positions, 0.0)


def test_transfer_to_memory():
    """Universe.transfer_to_memory: the upstream in_memory idiom — file
    (or any) trajectory replaced by a RAM copy, frames/boxes intact."""
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=20, n_frames=5, seed=2)
    before = [u.trajectory[i].positions.copy() for i in range(5)]
    dims_before = u.trajectory[0].dimensions.copy()
    u.transfer_to_memory()
    assert isinstance(u.trajectory, MemoryReader)
    assert u.trajectory.n_frames == 5
    for i in range(5):
        np.testing.assert_array_equal(u.trajectory[i].positions, before[i])
    np.testing.assert_allclose(u.trajectory[0].dimensions, dims_before)

    # windowed + strided form preserves per-frame times
    u2 = make_water_universe(n_waters=20, n_frames=6, seed=3)
    expect = [u2.trajectory[i].positions.copy() for i in (1, 3, 5)]
    u2.transfer_to_memory(start=1, stop=6, step=2)
    assert u2.trajectory.n_frames == 3
    for j, (i, x) in enumerate(zip((1, 3, 5), expect)):
        np.testing.assert_array_equal(u2.trajectory[j].positions, x)
        assert u2.trajectory[j].time == pytest.approx(float(i))

    # empty windows fail loudly instead of leaving a 0-frame universe
    u3 = make_water_universe(n_waters=20, n_frames=4, seed=4)
    with pytest.raises(ValueError, match="no .*frames"):
        u3.transfer_to_memory(start=4)
    assert u3.trajectory.n_frames == 4          # untouched


def test_transfer_to_memory_preserves_file_times(tmp_path):
    """XTC frame times survive transfer_to_memory (read from the frame
    headers without a coordinate decode)."""
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    src = make_protein_universe(n_residues=4, n_frames=5, seed=5)
    coords = src.trajectory.read_block(0, 5)[0]
    path = str(tmp_path / "t.xtc")
    times = np.array([0.0, 2.5, 5.0, 7.5, 10.0], np.float32)
    write_xtc(path, coords, times=times)
    u = Universe(src.topology, path)
    u.transfer_to_memory(step=2)
    assert u.trajectory.n_frames == 3
    for j, t in enumerate((0.0, 5.0, 10.0)):
        assert u.trajectory[j].time == pytest.approx(t)


class TestResidues:
    def test_universe_residues(self):
        from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

        u = make_solvated_universe(n_residues=5, n_waters=3, n_frames=1)
        res = u.residues
        assert res.n_residues == 8                  # 5 protein + 3 water
        assert list(res.resnames[:5]) != []         # attribute arrays align
        assert len(res.resids) == 8
        assert res.atoms.n_atoms == u.atoms.n_atoms

    def test_atomgroup_residues_subset(self):
        from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

        u = make_solvated_universe(n_residues=4, n_waters=5, n_frames=1)
        ca = u.select_atoms("protein and name CA")
        res = ca.residues
        assert res.n_residues == 4
        # back to atoms: whole residues, not just the CA atoms
        assert res.atoms.n_atoms == u.select_atoms("protein").n_atoms

    def test_split_by_residue(self):
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=6, n_frames=1)
        parts = u.select_atoms("protein").split("residue")
        assert len(parts) == 6
        assert sum(p.n_atoms for p in parts) == u.atoms.n_atoms
        for p in parts:
            assert len(set(p.resids)) == 1          # one residue per part

    def test_split_by_segment_and_errors(self):
        from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

        u = make_solvated_universe(n_residues=3, n_waters=2, n_frames=1)
        segs = u.atoms.split("segment")
        assert sum(p.n_atoms for p in segs) == u.atoms.n_atoms
        with pytest.raises(ValueError, match="residue' or 'segment"):
            u.atoms.split("chain")

    def test_per_residue_rmsf_aggregation(self):
        """The idiom residues exist for: aggregate atomic RMSF by residue."""
        from mdanalysis_mpi_tpu_torch.analysis import RMSF
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=5, n_frames=8, seed=3)
        prot = u.select_atoms("protein")
        r = RMSF(prot).run(backend="serial")
        resindices = prot.resindices
        per_res = [r.results.rmsf[resindices == i].mean()
                   for i in np.unique(resindices)]
        assert len(per_res) == 5
        assert all(np.isfinite(per_res))


class TestAdviceR1Fixes:
    """Regression pins for the round-1 advisor findings."""

    def test_split_segment_order_of_appearance(self):
        """split('segment') parts follow first occurrence in the group,
        not alphabetical segid order (upstream AtomGroup.split)."""
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        names = np.array(["CA"] * 6)
        segids = np.array(["ZZZ", "ZZZ", "AAA", "AAA", "MMM", "MMM"])
        top = Topology(names=names, resnames=np.full(6, "ALA"),
                       resids=np.array([1, 1, 2, 2, 3, 3]), segids=segids)
        u = Universe(top, MemoryReader(np.zeros((1, 6, 3), np.float32)))
        parts = u.atoms.split("segment")
        assert [p.segids[0] for p in parts] == ["ZZZ", "AAA", "MMM"]

    def test_nonmonotonic_resindices_rejected(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology

        with pytest.raises(ValueError, match="non-decreasing"):
            Topology(names=np.array(["CA", "CB", "CC"]),
                     resnames=np.full(3, "ALA"),
                     resids=np.array([1, 2, 1]),
                     resindices=np.array([0, 1, 0]))

    def test_residue_group_uses_topology_cache(self):
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=4, n_frames=1)
        res = u.select_atoms("protein").residues
        top = u.topology
        np.testing.assert_array_equal(
            res._first_atom, top.residue_first_atom[res.resindices])


class TestTopologySubsetAndWrite:
    def test_subset_remaps_bonds(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology

        top = Topology(names=np.array(["A", "B", "C", "D"]),
                       resnames=np.array(["R"] * 4),
                       resids=np.array([1, 1, 2, 2]),
                       bonds=np.array([[0, 1], [1, 2], [2, 3]]))
        sub = top.subset(np.array([1, 2, 3]))
        assert sub.n_atoms == 3
        assert list(sub.names) == ["B", "C", "D"]
        # bond 0-1 dropped (atom 0 absent); 1-2 -> 0-1; 2-3 -> 1-2
        np.testing.assert_array_equal(sub.bonds, [[0, 1], [1, 2]])

    def test_atomgroup_write_roundtrip(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

        u = make_solvated_universe(n_residues=4, n_waters=6, n_frames=2)
        ca = u.select_atoms("protein and name CA")
        for ext in ("gro", "pdb"):
            path = str(tmp_path / f"ca.{ext}")
            ca.write(path)
            u2 = Universe(path)
            assert u2.atoms.n_atoms == ca.n_atoms
            assert list(u2.atoms.names) == list(ca.names)
            np.testing.assert_allclose(u2.trajectory[0].positions,
                                       ca.positions, atol=2e-2)
        with pytest.raises(ValueError, match="unsupported extension"):
            ca.write(str(tmp_path / "ca.xyz"))

    def test_subset_preserves_distinct_adjacent_residues(self):
        """Wrapped/reused resids: subsetting must not merge residues
        that become adjacent (resindices carried, not recomputed)."""
        from mdanalysis_mpi_tpu_torch.core.topology import Topology

        top = Topology(names=np.array(["A1", "B1", "A2"]),
                       resnames=np.array(["R", "S", "R"]),
                       resids=np.array([1, 2, 1]),       # resid 1 reused
                       resindices=np.array([0, 1, 2]))
        sub = top.subset(np.array([0, 2]))               # drop middle res
        np.testing.assert_array_equal(sub.resindices, [0, 1])
        assert sub.n_residues == 2

    def test_subset_reordered_group(self):
        """Reordered selections (u.atoms[[2, 0]]) subset and write:
        contiguous runs become residues, atom order preserved."""
        from mdanalysis_mpi_tpu_torch.core.topology import Topology

        top = Topology(names=np.array(["A", "B", "C"]),
                       resnames=np.array(["R", "R", "S"]),
                       resids=np.array([1, 1, 2]))
        sub = top.subset(np.array([2, 0, 1]))
        assert list(sub.names) == ["C", "A", "B"]
        np.testing.assert_array_equal(sub.resindices, [0, 1, 1])

    def test_write_gro_carries_velocities(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.gro import write_gro
        from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

        u0 = make_solvated_universe(n_residues=3, n_waters=2, n_frames=1)
        v = np.full((u0.atoms.n_atoms, 3), 1.5, np.float32)
        src = str(tmp_path / "src.gro")
        write_gro(src, u0.topology, u0.trajectory[0].positions,
                  velocities=v)
        u = Universe(src)
        out = str(tmp_path / "sel.gro")
        u.select_atoms("protein").write(out)
        u2 = Universe(out)
        np.testing.assert_allclose(u2.atoms.velocities,
                                   v[u.select_atoms("protein").indices],
                                   atol=2e-3)


def test_segment_group():
    """SegmentGroup completes the Atom/Residue/Segment hierarchy."""
    from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

    u = make_solvated_universe(n_residues=3, n_waters=4, n_frames=1)
    segs = u.segments
    assert segs.n_segments == 2
    assert list(segs.segids) == ["PROT", "WAT"]
    assert segs.atoms.n_atoms == u.atoms.n_atoms
    prot_segs = u.select_atoms("protein").segments
    assert list(prot_segs.segids) == ["PROT"]
    assert prot_segs.residues.n_residues == 3
    # segment-level split already exists on AtomGroup; consistency:
    assert len(u.atoms.split("segment")) == segs.n_segments
    # topology-order normalization: a reversed group reports the same
    # segid order as the topology (zips safely with split("segment"))
    assert list(u.atoms[::-1].segments.segids) == ["PROT", "WAT"]


def test_atomgroup_wrap():
    """ag.wrap(): atoms map into the primary cell; distances to wrapped
    images are preserved under minimum image."""
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

    top = Topology(names=np.array(["A", "B", "C"]),
                   resnames=np.array(["R"] * 3), resids=np.array([1, 2, 3]))
    pos = np.array([[25.0, -3.0, 7.0], [5.0, 5.0, 5.0],
                    [-11.0, 42.0, 19.9]], np.float32)
    dims = np.array([20, 20, 20, 90, 90, 90], np.float32)
    u = Universe(top, pos[None])
    u.trajectory[0].dimensions = dims
    ts = u.trajectory.ts
    before = ts.positions.copy()
    wrapped = u.atoms.wrap()
    assert (wrapped >= 0).all() and (wrapped < 20).all()
    # wrap is a lattice translation: min-image displacement is zero
    d = minimum_image((wrapped - before).astype(np.float64), dims.astype(np.float64))
    assert np.abs(d).max() < 1e-3
    # in place on the Timestep
    np.testing.assert_array_equal(ts.positions, wrapped)
    # boxless frame refuses
    u2 = Universe(top, pos[None])
    with pytest.raises(ValueError, match="box"):
        u2.atoms.wrap()


class TestInertia:
    """moment_of_inertia / principal_axes (analytic rigid bodies)."""

    def _rod_universe(self, axis=2, n=11):
        from mdanalysis_mpi_tpu_torch.core.topology import make_water_topology
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        top = make_water_topology(n)          # 3n atoms
        pos = np.zeros((1, 3 * n, 3), np.float32)
        pos[0, :, axis] = np.linspace(-5, 5, 3 * n)
        return Universe(top, MemoryReader(pos))

    def test_rod_inertia_structure(self):
        u = self._rod_universe(axis=2)
        inertia = u.atoms.moment_of_inertia()
        assert inertia.shape == (3, 3)
        # rod along z: I_zz is (numerically) zero, I_xx == I_yy > 0
        assert abs(inertia[2, 2]) < 1e-8
        np.testing.assert_allclose(inertia[0, 0], inertia[1, 1])
        assert inertia[0, 0] > 0
        # off-diagonals vanish for an axis-aligned rod
        np.testing.assert_allclose(inertia - np.diag(np.diag(inertia)),
                                   0.0, atol=1e-8)

    def test_rod_principal_axes(self):
        u = self._rod_universe(axis=0)        # rod along x
        axes = u.atoms.principal_axes()
        assert axes.shape == (3, 3)
        # lowest-moment axis (row 2) IS the rod direction
        np.testing.assert_allclose(np.abs(axes[2]), [1.0, 0.0, 0.0],
                                   atol=1e-10)
        # rows orthonormal
        np.testing.assert_allclose(axes @ axes.T, np.eye(3), atol=1e-10)

    def test_parallel_axis_consistency(self):
        """Inertia is COM-relative: translating the body changes nothing."""
        u = self._rod_universe()
        i0 = u.atoms.moment_of_inertia()
        u.trajectory.ts.positions += np.float32(17.0)
        np.testing.assert_allclose(u.atoms.moment_of_inertia(), i0,
                                   rtol=1e-10, atol=1e-6)


class TestGuessBonds:
    def test_water_box_bonds(self):
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=8, n_frames=1, box=8.0)
        assert u.topology.bonds is None
        bonds = u.atoms.guess_bonds()
        # exactly two O-H bonds per water, none between molecules
        assert len(bonds) == 16
        assert u.topology.bonds.shape == (16, 2)
        for o, h in bonds:
            assert abs(int(o) - int(h)) <= 2
            assert u.topology.resindices[o] == u.topology.resindices[h]

    def test_enables_bonded_selection_and_busts_cache(self):
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=4, n_frames=1, box=8.0)
        with pytest.raises(ValueError, match="bond"):
            u.select_atoms("bonded name OW")
        # the failed parse must not have poisoned a cache entry
        u.atoms.guess_bonds()
        got = u.select_atoms("bonded name OW")
        assert got.n_atoms == 8            # every hydrogen
        assert u.topology.is_hydrogen[got.indices].all()

    def test_group_scoped_guess(self):
        """Guessing on a subgroup only adds that subgroup's bonds."""
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=6, n_frames=1, box=10.0)
        first = u.select_atoms("resid 1")
        bonds = first.guess_bonds()
        assert len(bonds) == 2
        assert set(np.unique(bonds)) <= set(first.indices.tolist())

    def test_empty_and_single_atom_groups(self):
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=2, n_frames=1, box=8.0)
        assert u.select_atoms("resid 99").guess_bonds().shape == (0, 2)
        assert u.select_atoms("name OW and resid 1").guess_bonds(
        ).shape == (0, 2)

    def test_unknown_element_raises(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        top = Topology(names=np.array(["XQ1", "XQ2"]),
                       resnames=np.array(["UNK", "UNK"]),
                       resids=np.array([1, 1]))
        u = Universe(top, MemoryReader(np.zeros((1, 2, 3), np.float32)))
        with pytest.raises(ValueError, match="radius"):
            u.atoms.guess_bonds()


class TestCompoundCenters:
    def test_per_residue_com_matches_split(self):
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=5, n_frames=2, noise=0.3)
        ag = u.select_atoms("protein")
        per_res = ag.center_of_mass(compound="residues")
        parts = ag.split("residue")
        assert per_res.shape == (5, 3)
        for k, part in enumerate(parts):
            np.testing.assert_allclose(per_res[k], part.center_of_mass())

    def test_per_segment_geometry_order(self):
        """Segments come back in first-occurrence order, not sorted."""
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        top = Topology(names=np.array(["CA"] * 4),
                       resnames=np.array(["ALA"] * 4),
                       resids=np.array([1, 2, 3, 4]),
                       segids=np.array(["Z", "Z", "A", "A"]))
        pos = np.array([[[0, 0, 0], [2, 0, 0],
                         [10, 0, 0], [12, 0, 0]]], np.float32)
        u = Universe(top, MemoryReader(pos))
        c = u.atoms.center_of_geometry(compound="segments")
        np.testing.assert_allclose(c, [[1, 0, 0], [11, 0, 0]])

    def test_group_default_unchanged(self):
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=3, n_frames=1)
        np.testing.assert_allclose(
            u.atoms.center_of_mass(),
            u.atoms.center_of_mass(compound="group"))
        with pytest.raises(ValueError, match="compound"):
            u.atoms.center_of_mass(compound="molecules")


class TestFragments:
    """Bonded connected components (upstream fragments/fragindices)."""

    def _universe(self):
        top = Topology(
            names=np.array(["C1", "C2", "C3", "OW", "HW1", "HW2", "NA"]),
            resnames=np.array(["MOL"] * 3 + ["SOL"] * 3 + ["NA"]),
            resids=np.array([1, 1, 1, 2, 2, 2, 3]),
            bonds=np.array([(0, 1), (1, 2), (3, 4), (3, 5)]))
        pos = np.zeros((1, 7, 3), np.float32)
        return Universe(top, MemoryReader(pos))

    def test_fragindices_dense_first_atom_order(self):
        u = self._universe()
        np.testing.assert_array_equal(
            u.topology.fragindices, [0, 0, 0, 1, 1, 1, 2])
        assert u.topology.n_fragments == 3
        # unbonded ion = singleton fragment
        assert u.atoms[6:].fragindices.tolist() == [2]

    def test_atomgroup_fragments_are_whole_molecules(self):
        u = self._universe()
        # one atom of the water pulls in the WHOLE water (upstream
        # semantics: full fragments, not intersections)
        frags = u.atoms[4:5].fragments
        assert len(frags) == 1
        assert frags[0].indices.tolist() == [3, 4, 5]
        all_frags = u.atoms.fragments
        assert [f.indices.tolist() for f in all_frags] == [
            [0, 1, 2], [3, 4, 5], [6]]
        assert u.atoms.n_fragments == 3

    def test_fragments_need_bonds(self):
        top = Topology(names=np.array(["CA"]),
                       resnames=np.array(["ALA"]),
                       resids=np.array([1]))
        u = Universe(top, MemoryReader(np.zeros((1, 1, 3), np.float32)))
        with pytest.raises(ValueError, match="bonds"):
            u.atoms.fragments

    def test_guess_bonds_invalidates_fragment_cache(self):
        """fragindices derives from the bond graph; guess_bonds must
        bust the cached components (r4 review finding)."""
        top = Topology(names=np.array(["C", "C"]),
                       resnames=np.array(["MOL"] * 2),
                       resids=np.array([1, 1]),
                       elements=np.array(["C", "C"]))
        pos = np.array([[[0.0, 0, 0], [1.4, 0, 0]]], np.float32)
        u = Universe(top, MemoryReader(pos))
        top.bonds = np.empty((0, 2), np.int64)
        assert u.topology.n_fragments == 2       # cached: two singletons
        u.atoms.guess_bonds()
        assert u.topology.n_fragments == 1       # stale cache busted


class TestTopologyAttrAndCharges:
    def _universe(self):
        top = Topology(names=np.array(["OW", "HW1", "HW2"]),
                       resnames=np.array(["SOL"] * 3),
                       resids=np.array([1, 1, 1]))
        pos = np.array([[[0.0, 0, 0], [1.0, 0, 0], [-1.0, 0, 0]]],
                       np.float32)
        return Universe(top, MemoryReader(pos))

    def test_add_topology_attr_charges(self):
        u = self._universe()
        with pytest.raises(AttributeError, match="charges"):
            u.atoms.charges
        u.add_TopologyAttr("charges", [-0.8, 0.4, 0.4])
        np.testing.assert_allclose(u.atoms.charges, [-0.8, 0.4, 0.4])
        assert u.atoms.total_charge() == pytest.approx(0.0)
        # default: zeros (upstream's empty attr)
        u2 = self._universe()
        u2.add_TopologyAttr("charges")
        assert u2.atoms.total_charge() == 0.0
        with pytest.raises(ValueError, match="per-atom"):
            u2.add_TopologyAttr("charges", [1.0])
        with pytest.raises(ValueError, match="settable"):
            u2.add_TopologyAttr("names", ["A", "B", "C"])

    def test_add_topology_attr_busts_prop_selection_cache(self):
        u = self._universe()
        u.add_TopologyAttr("charges", [0.0, 0.0, 0.0])
        assert u.select_atoms("prop charge > 0.1").n_atoms == 0
        u.add_TopologyAttr("charges", [-0.8, 0.4, 0.4])
        assert u.select_atoms("prop charge > 0.1").n_atoms == 2

    def test_dipole_moment(self):
        u = self._universe()
        u.add_TopologyAttr("charges", [-0.8, 0.4, 0.4])
        # symmetric H placement about the O: charge displacements cancel
        # (COM ~ on the O for equal H masses)
        v = u.atoms.dipole_vector()
        np.testing.assert_allclose(v, [0.0, 0.0, 0.0], atol=1e-10)
        # break the symmetry: move one H out
        u.trajectory.ts.positions[1] = [2.0, 0.0, 0.0]
        d = u.atoms.dipole_moment()
        assert d > 0.3

    def test_attr_change_invalidates_copies_too(self):
        """copy() clones share the topology; a mutated attribute must
        bust THEIR memoized selections as well (r4 review finding)."""
        u = self._universe()
        u.add_TopologyAttr("charges", [0.0, 0.0, 0.0])
        u2 = u.copy()
        assert u2.select_atoms("prop charge > 0.1").n_atoms == 0
        u.add_TopologyAttr("charges", [-0.8, 0.4, 0.4])
        assert u2.select_atoms("prop charge > 0.1").n_atoms == 2


class TestMerge:
    def test_merge_snapshots_current_frames(self):
        import mdanalysis_mpi_tpu_torch as mdt
        from mdanalysis_mpi_tpu_torch.testing import (make_protein_universe,
                                                make_water_universe)

        up = make_protein_universe(n_residues=4, n_frames=3, seed=1)
        uw = make_water_universe(n_waters=5, n_frames=2, seed=2)
        up.trajectory[2]                     # snapshot a LATER frame
        ca = up.select_atoms("name CA")
        ow = uw.select_atoms("name OW")
        m = mdt.Merge(ca, ow)
        assert m.topology.n_atoms == ca.n_atoms + ow.n_atoms
        assert m.trajectory.n_frames == 1
        np.testing.assert_allclose(
            m.atoms.positions[:ca.n_atoms], ca.positions, atol=1e-6)
        np.testing.assert_allclose(
            m.atoms.positions[ca.n_atoms:], ow.positions, atol=1e-6)
        # names/resnames carried through the sub-topologies
        assert set(m.select_atoms("name CA").indices.tolist()) \
            == set(range(ca.n_atoms))
        assert m.select_atoms("resname SOL").n_atoms == ow.n_atoms
        # box from the FIRST group's frame (protein fixture: boxless)
        assert m.trajectory.ts.dimensions is None
        # the merged universe is independent: advancing the sources
        # does not move it
        before = m.atoms.positions.copy()
        up.trajectory[0]
        np.testing.assert_array_equal(m.atoms.positions, before)

    def test_merge_validation(self):
        import mdanalysis_mpi_tpu_torch as mdt
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=3, n_frames=1)
        with pytest.raises(ValueError, match="at least one"):
            mdt.Merge()
        with pytest.raises(TypeError, match="AtomGroups"):
            mdt.Merge(u)
        with pytest.raises(ValueError, match="empty"):
            mdt.Merge(u.select_atoms("name ZZ"))

    def test_merge_preserves_bonds_within_groups(self):
        import mdanalysis_mpi_tpu_torch as mdt
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        top = Topology(names=np.array(["A", "B", "C"]),
                       resnames=np.full(3, "MOL"),
                       resids=np.full(3, 1),
                       bonds=np.array([[0, 1], [1, 2]]))
        u = Universe(top, MemoryReader(np.zeros((1, 3, 3), np.float32)))
        m = mdt.Merge(u.atoms[[0, 1]], u.atoms[[2]])
        assert m.topology.bonds is not None
        np.testing.assert_array_equal(m.topology.bonds, [[0, 1]])


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


def _solvated(mod):
    return mod("testing").make_solvated_universe(
        n_residues=6, n_waters=20, n_frames=3, seed=1)


_CORE = {
    "positions": lambda u: u.atoms.positions,
    "masses": lambda u: u.atoms.masses,
    "names": lambda u: list(u.atoms.names),
    "resids": lambda u: u.atoms.resids,
    "resnames": lambda u: list(u.atoms.resnames),
    "counts": lambda u: (u.atoms.n_atoms, u.residues.n_residues,
                         u.trajectory.n_frames),
    "center_of_mass": lambda u: u.select_atoms("protein").center_of_mass(),
    "center_of_geometry": lambda u: u.select_atoms(
        "protein").center_of_geometry(),
    "com_per_residue": lambda u: u.select_atoms("protein").center_of_mass(
        compound="residues"),
    "radius_of_gyration": lambda u: u.select_atoms(
        "protein").radius_of_gyration(),
    "moment_of_inertia": lambda u: u.select_atoms(
        "protein").moment_of_inertia(),
    "principal_axes": lambda u: u.select_atoms("protein").principal_axes(),
    "frame_2": lambda u: u.trajectory[2].positions,
    "dimensions": lambda u: u.trajectory[1].dimensions,
    "read_block": lambda u: u.trajectory.read_block(0, 3)[0],
    "guess_bonds": lambda u: u.atoms.guess_bonds(),
    "copy": lambda u: u.copy().atoms.positions,
    "residues": lambda u: (u.select_atoms("protein").residues.resids,
                           list(u.residues.resnames),
                           u.residues.resindices),
    "segments": lambda u: list(u.residues.segids),
}


@pytest.mark.parametrize("case", sorted(_CORE))
def test_universe_matches_jax_package(case):
    ref, port = both(lambda mod: outcome(lambda: _CORE[case](
        _solvated(mod))))
    assert ref[0] == "ok", ref
    assert_same(ref, port)


def test_merge_matches_jax_package():
    def case(mod):
        u = _solvated(mod)
        m = mod("core.universe").Merge(u.select_atoms("protein"),
                                       u.select_atoms("resname SOL"))
        return m.atoms.positions, list(m.atoms.names), m.atoms.resids
    assert_same(*both(case))
