"""Twin of ``tests/test_selection.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Selection DSL tests — table-driven encoding of upstream's documented
selection semantics (SURVEY.md §7 hard parts: "Selection correctness
without MDAnalysis to compare against offline")."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.selection import SelectionError, select, select_mask
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, outcome, port_runs_on_the_cpu)


@pytest.fixture(scope="module")
def top():
    # 4 residues: GLY (protein), SOL (water), NA ion, DA (nucleic)
    return Topology(
        names=np.array(["N", "CA", "C", "O", "HA",
                        "OW", "HW1", "HW2",
                        "NA",
                        "P", "O5'", "C5'", "C1'"]),
        resnames=np.array(["GLY"] * 5 + ["SOL"] * 3 + ["NA"] + ["DA"] * 4),
        resids=np.array([1] * 5 + [2] * 3 + [3] + [4] * 4),
        segids=np.array(["PROT"] * 5 + ["WAT"] * 3 + ["ION"] + ["NUC"] * 4),
    )


CASES = [
    ("all", list(range(13))),
    ("none", []),
    ("protein", [0, 1, 2, 3, 4]),
    ("water", [5, 6, 7]),
    ("nucleic", [9, 10, 11, 12]),
    ("protein and name CA", [1]),           # the reference's selection, RMSF.py:77
    ("backbone", [0, 1, 2, 3]),
    ("nucleicbackbone", [9, 10, 11]),
    ("hydrogen", [4, 6, 7]),
    ("heavy", [0, 1, 2, 3, 5, 8, 9, 10, 11, 12]),
    ("not protein", [5, 6, 7, 8, 9, 10, 11, 12]),
    ("protein or water", [0, 1, 2, 3, 4, 5, 6, 7]),
    ("name CA C", [1, 2]),
    ("name HW*", [6, 7]),
    ("name O5' C5'", [10, 11]),
    ("resname SOL GLY", [0, 1, 2, 3, 4, 5, 6, 7]),
    ("resid 2", [5, 6, 7]),
    ("resid 1:2", [0, 1, 2, 3, 4, 5, 6, 7]),
    ("resid 2-3", [5, 6, 7, 8]),
    ("segid PROT ION", [0, 1, 2, 3, 4, 8]),
    ("chainID PROT", [0, 1, 2, 3, 4]),     # chainID aliases segid (PDB chains fold there)
    ("chainid NUC", [9, 10, 11, 12]),
    ("element N", [0]),                     # nitrogen only; the NA ion is element NA
    ("index 0:2", [0, 1, 2]),
    ("bynum 1:3", [0, 1, 2]),
    ("(protein or water) and not hydrogen", [0, 1, 2, 3, 5]),
    ("protein and (name CA or name N)", [0, 1]),
    ("prop mass > 20", [8, 9]),             # NA (22.99), P (30.97)
]


@pytest.mark.parametrize("sel,expected", CASES, ids=[c[0] for c in CASES])
def test_selection_table(top, sel, expected):
    np.testing.assert_array_equal(select(top, sel), expected)


def test_na_ion_element_vs_protein_n(top):
    # 'NA' in resname NA is sodium; 'N' in GLY is nitrogen.
    assert top.elements[8] == "NA"
    assert top.elements[0] == "N"
    assert top.masses[8] == pytest.approx(22.98976928)


def test_ca_is_carbon_in_protein(top):
    assert top.elements[1] == "C"
    assert top.masses[1] == pytest.approx(12.011)


def test_errors(top):
    for bad in ["", "name", "frobnicate", "(protein", "protein and",
                "prop mass >", "resid x"]:
        with pytest.raises(SelectionError):
            select_mask(top, bad)


def test_selection_on_solvated_universe():
    u = make_solvated_universe(n_residues=5, n_waters=7, n_frames=2)
    ca = u.select_atoms("protein and name CA")
    assert ca.n_atoms == 5
    assert set(ca.names) == {"CA"}
    water_o = u.select_atoms("water and name OW")
    assert water_o.n_atoms == 7
    heavy = u.select_atoms("protein and heavy")
    assert heavy.n_atoms == 25  # 5 residues x (N,CA,C,O,CB)


def test_subgroup_selection_and_set_ops():
    u = make_solvated_universe(n_residues=4, n_waters=3, n_frames=1)
    prot = u.select_atoms("protein")
    ca = prot.select_atoms("name CA")
    assert ca.n_atoms == 4
    both = ca | u.select_atoms("name N")
    assert both.n_atoms == 8
    assert (ca & prot).n_atoms == 4
    assert (prot - ca).n_atoms == prot.n_atoms - 4


class TestAroundSelection:
    def _universe(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        # 3 "protein" CA atoms at x=0, plus waters at controlled distances
        names = np.array(["CA", "CA", "CA", "OW", "OW", "OW"])
        resnames = np.array(["ALA", "ALA", "ALA", "SOL", "SOL", "SOL"])
        resids = np.array([1, 2, 3, 4, 5, 6])
        top = Topology(names=names, resnames=resnames, resids=resids)
        pos = np.array([
            [0.0, 0.0, 0.0],
            [0.0, 3.0, 0.0],
            [0.0, 6.0, 0.0],
            [2.0, 0.0, 0.0],     # 2 A from CA1 -> inside 3 A
            [5.0, 0.0, 0.0],     # 5 A -> outside 3 A
            [19.0, 0.0, 0.0],    # 19 A, but 1 A via PBC (box 20)
        ], dtype=np.float32)
        dims = np.array([20, 20, 20, 90, 90, 90], np.float32)
        return Universe(top, MemoryReader(pos[None], dimensions=dims))

    def test_around_basic_and_exclusion(self):
        u = self._universe()
        near = u.select_atoms("around 3.0 protein")
        # CA atoms themselves are excluded; OW at 2 A and (via PBC) 1 A hit
        assert list(near.indices) == [3, 5]

    def test_around_respects_minimum_image(self):
        u = self._universe()
        # without the box the 19 A water would be outside; with it, inside
        far = u.select_atoms("around 3.0 protein")
        assert 5 in far.indices

    def test_around_composes_with_booleans(self):
        u = self._universe()
        ag = u.select_atoms("resname SOL and around 3.0 protein")
        assert list(ag.indices) == [3, 5]
        none = u.select_atoms("protein and around 3.0 protein")
        assert none.n_atoms == 0                # exclusion of the inner set

    def test_around_requires_coordinates(self):
        from mdanalysis_mpi_tpu_torch.core.selection import SelectionError, select_mask

        u = self._universe()
        with pytest.raises(SelectionError, match="coordinates"):
            select_mask(u.topology, "around 3.0 protein")

    def test_around_bad_cutoff(self):
        from mdanalysis_mpi_tpu_torch.core.selection import SelectionError

        u = self._universe()
        with pytest.raises(SelectionError, match="numeric cutoff"):
            u.select_atoms("around protein")
        with pytest.raises(SelectionError, match="negative"):
            u.select_atoms("around -1 protein")


def test_radius_of_gyration():
    """Hand-computed fixture: two atoms, masses 1 and 3, 4 A apart.
    COM sits 3 A from the light atom; Rg = sqrt((1*9 + 3*1)/4) = sqrt(3).
    """
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe

    top = Topology(names=np.array(["X1", "X2"]),
                   resnames=np.array(["AAA", "AAA"]),
                   resids=np.array([1, 1]),
                   masses=np.array([1.0, 3.0]))
    pos = np.array([[0.0, 0, 0], [4.0, 0, 0]], np.float32)
    u = Universe(top, pos[None])
    assert u.atoms.radius_of_gyration() == pytest.approx(np.sqrt(3.0))


def test_around_group_scoped_inner():
    """Upstream semantics: a subgroup's 'around' inner selection sees
    only group atoms — waters.select_atoms('around R protein') is empty
    when the group holds no protein."""
    from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

    u = make_solvated_universe(n_residues=6, n_waters=40, n_frames=2, seed=2)
    waters = u.select_atoms("water")
    assert waters.select_atoms("around 5.0 protein").n_atoms == 0
    # whole-universe query still sees the protein
    assert u.select_atoms("water and around 5.0 protein").n_atoms > 0
    # a group that contains protein works scoped
    both = u.select_atoms("protein or water")
    scoped = both.select_atoms("around 5.0 protein")
    globl = u.select_atoms("around 5.0 protein")
    np.testing.assert_array_equal(scoped.indices,
                                  globl.indices[np.isin(globl.indices,
                                                        both.indices)])


# ---- expansion keywords (byres / same..as / sphzone / point / global) ----

BYRES_SAME_CASES = [
    # byres expands to whole residues (upstream ByResSelection)
    ("byres name CA", [0, 1, 2, 3, 4]),           # GLY residue via its CA
    ("byres name OW", [5, 6, 7]),                 # the water residue
    ("byres (name CA or name P)", [0, 1, 2, 3, 4, 9, 10, 11, 12]),
    ("byres none", []),
    # same ATTR as (upstream SameSubSelection)
    ("same resname as name OW", [5, 6, 7]),
    ("same resid as name HA", [0, 1, 2, 3, 4]),
    ("same segid as name P", [9, 10, 11, 12]),
    ("same residue as name C5'", [9, 10, 11, 12]),
    ("same name as index 1", [1]),                # only one CA here
    ("same mass as name HW1", [4, 6, 7]),         # every hydrogen
    ("same resname as none", []),
]


@pytest.mark.parametrize("sel,expected", BYRES_SAME_CASES,
                         ids=[c[0] for c in BYRES_SAME_CASES])
def test_expansion_table(top, sel, expected):
    np.testing.assert_array_equal(select(top, sel), expected)


def test_same_errors(top):
    with pytest.raises(SelectionError, match="unsupported"):
        select(top, "same bogus as name CA")
    with pytest.raises(SelectionError, match="'as'"):
        select(top, "same resid name CA")
    with pytest.raises(SelectionError, match="charges"):
        select(top, "same charge as name CA")


class TestGeometricZones:
    def _universe(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        names = np.array(["CA", "CA", "OW", "OW", "OW"])
        resnames = np.array(["ALA", "ALA", "SOL", "SOL", "SOL"])
        resids = np.array([1, 2, 3, 4, 5])
        top = Topology(names=names, resnames=resnames, resids=resids)
        pos = np.array([
            [1.0, 0.0, 0.0],
            [3.0, 0.0, 0.0],     # protein cog = (2, 0, 0)
            [4.0, 0.0, 0.0],     # 2 A from cog
            [9.0, 0.0, 0.0],     # 7 A from cog
            [19.5, 0.0, 0.0],    # 2.5 A from cog via PBC (box 20)
        ], dtype=np.float32)
        dims = np.array([20, 20, 20, 90, 90, 90], np.float32)
        return Universe(top, MemoryReader(pos[None], dimensions=dims))

    def test_sphzone_inclusive_of_inner(self):
        u = self._universe()
        # sphere of 3 A around protein cog (2,0,0): both CA (1 and 1 A),
        # OW at 2 A, OW at 2.5 A via the periodic image
        got = u.select_atoms("sphzone 3.0 protein")
        assert list(got.indices) == [0, 1, 2, 4]

    def test_sphlayer_annulus(self):
        u = self._universe()
        # distances to protein cog (2,0,0): 1, 1, 2, 7, 2.5 (via PBC)
        got = u.select_atoms("sphlayer 1.5 5 protein")
        assert list(got.indices) == [2, 4]
        # inner bound excludes the 2.0 A atom, keeps the periodic 2.5 A
        got = u.select_atoms("sphlayer 2.2 5 protein")
        assert list(got.indices) == [4]
        with pytest.raises(SelectionError, match="below outer"):
            u.select_atoms("sphlayer 5 2 protein")

    def test_point_fixed_center(self):
        u = self._universe()
        got = u.select_atoms("point 9.0 0.0 0.0 1.5")
        assert list(got.indices) == [3]
        # periodic wrap: point near the box edge reaches across
        got = u.select_atoms("point 0.0 0.0 0.0 2.0")
        assert list(got.indices) == [0, 4]

    def test_sphzone_requires_coordinates(self, ):
        from mdanalysis_mpi_tpu_torch.core.selection import select as bare_select
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        t = Topology(names=np.array(["CA"]), resnames=np.array(["ALA"]),
                     resids=np.array([1]))
        with pytest.raises(SelectionError, match="coordinates"):
            bare_select(t, "sphzone 3.0 name CA")

    def test_global_escapes_group_scope(self):
        u = self._universe()
        waters = u.select_atoms("resname SOL")
        # scoped: no protein inside the group -> empty
        assert waters.select_atoms("around 3.0 protein").n_atoms == 0
        # global: the inner selection sees the whole universe; result is
        # still restricted to the group (upstream semantics)
        got = waters.select_atoms("around 3.0 global protein")
        assert list(got.indices) == [2, 4]

    def test_byres_scoped_to_group(self):
        u = self._universe()
        waters = u.select_atoms("resname SOL")
        # inner 'name CA' matches nothing inside the group
        assert waters.select_atoms("byres name CA").n_atoms == 0
        assert waters.select_atoms("byres global name CA").n_atoms == 0  # CA residues hold no waters
        assert list(waters.select_atoms("byres name OW").indices) == [2, 3, 4]


class TestCylinderBondedProp:
    """Round-3 selection tail (VERDICT r2 next-round #7): cyzone/cylayer,
    bonded, prop x/y/z — table-driven against upstream's documented
    semantics."""

    def _universe(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        names = np.array(["CA", "OW", "OW", "OW", "OW", "OW", "OW"])
        resnames = np.array(["ALA"] + ["SOL"] * 6)
        resids = np.arange(1, 8)
        # bonds: CA-OW1, OW1-OW2 (synthetic; just connectivity)
        top = Topology(names=names, resnames=resnames, resids=resids,
                       bonds=np.array([[0, 1], [1, 2]]))
        pos = np.array([
            [10.0, 10.0, 10.0],   # 0 CA: cylinder axis/center
            [11.0, 10.0, 10.0],   # 1 r=1, z=0
            [1.0, 10.0, 10.0],    # 2 r=3 via PBC (box 12), z=0
            [10.0, 10.0, 14.5],   # 3 r=0, z=+4.5
            [10.0, 10.0, 3.5],    # 4 r=0, z=+5.5 via PBC -> outside
            [14.0, 14.0, 10.0],   # 5 r=sqrt(32) -> outside r_ext=5
            [10.0, 10.0, -2.0],   # 6 r=0, z=0 via PBC (-12 wrap)
        ], dtype=np.float32)
        dims = np.array([12, 12, 12, 90, 90, 90], np.float32)
        return Universe(top, MemoryReader(pos[None], dimensions=dims))

    def test_cyzone(self):
        u = self._universe()
        got = u.select_atoms("cyzone 5 5 -5 name CA")
        # axis atom itself included; PBC wraps idx2 (xy) and idx6 (z) in;
        # idx4 lands at z=+5.5 via the wrap -> out; idx5 out radially
        assert list(got.indices) == [0, 1, 2, 3, 6]

    def test_cylayer_excludes_inner_radius(self):
        u = self._universe()
        got = u.select_atoms("cylayer 2 5 5 -5 name CA")
        assert list(got.indices) == [2]     # only r=3 sits in (2, 5]

    def test_cylinder_errors(self):
        u = self._universe()
        with pytest.raises(SelectionError, match="below outer"):
            u.select_atoms("cylayer 5 2 5 -5 name CA")
        with pytest.raises(SelectionError, match="exceeds zMax"):
            u.select_atoms("cyzone 5 -5 5 name CA")

    def test_bonded(self):
        u = self._universe()
        assert list(u.select_atoms("bonded name CA").indices) == [1]
        assert list(u.select_atoms("bonded index 1").indices) == [0, 2]
        # inner atoms stay only when bonded to another inner atom
        assert list(u.select_atoms("bonded index 0:1").indices) == [0, 1, 2]

    def test_bonded_requires_bonds(self, top):
        with pytest.raises(SelectionError, match="no bonds"):
            select(top, "bonded protein")

    def test_prop_xyz(self):
        u = self._universe()
        assert list(u.select_atoms("prop x >= 11").indices) == [1, 5]
        assert list(u.select_atoms("prop z > 10").indices) == [3]
        assert list(u.select_atoms("prop z < 0").indices) == [6]
        assert list(u.select_atoms("prop abs z <= 2.5").indices) == [6]
        # composes with booleans and other keywords
        assert list(u.select_atoms("name OW and prop y == 14").indices) == [5]

    def test_prop_xyz_requires_coordinates(self, top):
        with pytest.raises(SelectionError, match="coordinates"):
            select(top, "prop x > 0")


class TestSelectionMemoization:
    """Topology-only selections are memoized per Universe; geometric
    (frame-dependent) selections never are (core/groups.py)."""

    def test_topology_only_cached_and_stable(self):
        u = make_solvated_universe(n_frames=4)
        a = u.select_atoms("protein and name CA")
        b = u.select_atoms("protein and name CA")
        np.testing.assert_array_equal(a.indices, b.indices)
        cache = u.__dict__["_selection_cache"]
        # key = (selection, topology attr_version, scope)
        assert ("protein and name CA", 0, None) in cache

    def test_geometric_not_cached(self):
        u = make_solvated_universe(n_frames=4)
        u.select_atoms("around 5.0 protein")
        cache = u.__dict__.get("_selection_cache", {})
        assert all("around" not in k[0] for k in cache)

    def test_scope_insensitive_strings_share_one_entry(self):
        # plain keyword selections ignore scope: a subgroup parse proves
        # it (scope never consulted) and shares the (selection, None)
        # entry instead of burning one cache slot per subgroup
        u = make_solvated_universe(n_frames=4)
        sub = u.select_atoms("protein").select_atoms("name CA")
        whole = u.select_atoms("name CA")
        np.testing.assert_array_equal(whole.indices, sub.indices)
        cache = u.__dict__["_selection_cache"]
        assert [k for k in cache if k[0] == "name CA"] == [
            ("name CA", 0, None)]

    def test_scope_sensitive_strings_keyed_per_subgroup(self):
        # byres consults the scope: a subgroup's mask must NOT be shared
        u = make_solvated_universe(n_frames=4)
        whole = u.select_atoms("byres name OW")
        sub = u.select_atoms("not protein").select_atoms("byres name OW")
        cache = u.__dict__["_selection_cache"]
        keys = [k for k in cache if k[0] == "byres name OW"]
        assert len(keys) == 2           # whole-universe + scoped entry
        assert set(sub.indices) <= set(whole.indices)


def test_same_fragment_as():
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    top = Topology(
        names=np.array(["C1", "C2", "OW", "HW1", "HW2"]),
        resnames=np.array(["MOL", "MOL", "SOL", "SOL", "SOL"]),
        resids=np.array([1, 1, 2, 2, 2]),
        bonds=np.array([(0, 1), (2, 3), (2, 4)]))
    u = Universe(top, MemoryReader(np.zeros((1, 5, 3), np.float32)))
    got = u.select_atoms("same fragment as name HW1")
    assert list(got.indices) == [2, 3, 4]      # the whole water molecule
    assert list(u.select_atoms("same fragment as name C1").indices) == [0, 1]
    # no bonds -> actionable error
    top2 = Topology(names=np.array(["CA"]), resnames=np.array(["ALA"]),
                    resids=np.array([1]))
    u2 = Universe(top2, MemoryReader(np.zeros((1, 1, 3), np.float32)))
    with pytest.raises(SelectionError, match="bonds"):
        u2.select_atoms("same fragment as all")


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


_SELECTIONS = [
    "(protein or water) and not hydrogen", "all", "around -1 protein",
    "around 3.0 global protein", "around 3.0 protein", "around 5.0 protein",
    "around protein", "backbone", "bonded index 0:1", "bonded name CA",
    "bynum 1:3", "byres (name CA or name P)", "byres global name CA",
    "byres name CA", "byres name OW", "byres none", "chainID PROT",
    "cylayer 2 5 5 -5 name CA", "cylayer 5 2 5 -5 name CA",
    "cyzone 5 -5 5 name CA", "cyzone 5 5 -5 name CA", "element N", "heavy",
    "hydrogen", "index 0:2", "name CA", "name CA C", "name HW*", "name N",
    "name OW and prop y == 14", "none", "not protein", "nucleic",
    "nucleicbackbone", "point 0.0 0.0 0.0 2.0", "point 9.0 0.0 0.0 1.5",
    "prop abs z <= 2.5", "prop mass > 20", "prop x >= 11", "prop z < 0",
    "prop z > 10", "protein", "protein and (name CA or name N)",
    "protein and around 3.0 protein", "protein and heavy",
    "protein and name CA", "protein or water", "resid 1:2", "resid 2",
    "resid 2-3", "resname SOL", "resname SOL GLY",
    "resname SOL and around 3.0 protein", "same fragment as all",
    "same fragment as name HW1", "same mass as name HW1",
    "same name as index 1", "same resid as name HA",
    "same resname as name OW", "same resname as none",
    "segid PROT ION", "sphlayer 1.5 5 protein", "sphlayer 2.2 5 protein",
    "sphlayer 5 2 protein", "sphzone 3.0 protein", "water",
    "water and around 5.0 protein", "water and name OW", "nmae CA",
    "around", "resid 1 and", "sphlayer 5 protein",
]


@pytest.mark.parametrize("bonds", [False, True], ids=["nobonds", "bonds"])
@pytest.mark.parametrize("sel", _SELECTIONS)
def test_selection_matches_jax_package(sel, bonds):
    """Every selection string of the reference suite, on each package's
    solvated fixture (the same seed): the same indices, or the same
    error class."""
    def case(mod):
        u = mod("testing").make_solvated_universe(
            n_residues=5, n_waters=20, n_frames=2, seed=2)
        if bonds:
            u.atoms.guess_bonds()
        return outcome(lambda: u.select_atoms(sel).indices)
    ref, port = both(case)
    assert_same(ref, port)
