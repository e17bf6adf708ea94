"""The port's PQR, MOL2 and CHARMM CRD formats (``io/pqr.py``,
``io/mol2.py``, ``io/crd.py``): the JAX package's tests/test_pqr_mol2.py
case by case (hand-built fixtures and round trips through the port's
writers), then parity with the JAX package: each fixture parses to
equal topologies and frames in both packages, and every writer gives
the JAX writer's bytes."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.mol2 import parse_mol2, write_mol2
from mdanalysis_mpi_tpu_torch.io.pqr import parse_pqr, write_pqr

from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
from mdanalysis_mpi_tpu.io import crd as jcrd
from mdanalysis_mpi_tpu.io import mol2 as jmol2
from mdanalysis_mpi_tpu.io import pqr as jpqr

PQR_10 = """\
REMARK   1 PQR file generated by PDB2PQR
ATOM      1  N    MET     1      27.340  24.430   2.614  0.1592 1.8240
ATOM      2  CA   MET     1      26.266  25.413   2.842  0.0221 1.9080
ATOM      3  H    MET    52A     25.112  24.880   3.649  0.2737 0.6000
END
"""

PQR_11 = """\
ATOM      1  N    MET A   1      27.340  24.430   2.614  0.1592 1.8240
ATOM      2  CA   MET A   1      26.266  25.413   2.842  0.0221 1.9080
END
"""

MOL2 = """\
@<TRIPOS>MOLECULE
benzene-ish
 4 3 1 0 0
SMALL
USER_CHARGES
@<TRIPOS>ATOM
      1 C1         1.0000    0.0000    0.0000 C.ar      1 BNZ1       -0.0600
      2 C2         2.3900    0.0000    0.0000 C.ar      1 BNZ1       -0.0600
      3 N1         3.0800    1.2000    0.0000 N.ar      1 BNZ1        0.1200
      4 H1         0.4500   -0.9200    0.0000 H         1 BNZ1        0.0600
@<TRIPOS>BOND
     1    1    2 ar
     2    2    3 ar
     3    1    4 1
@<TRIPOS>MOLECULE
benzene-ish
 4 3 1 0 0
SMALL
USER_CHARGES
@<TRIPOS>ATOM
      1 C1         1.1000    0.1000    0.0000 C.ar      1 BNZ1       -0.0600
      2 C2         2.4900    0.1000    0.0000 C.ar      1 BNZ1       -0.0600
      3 N1         3.1800    1.3000    0.0000 N.ar      1 BNZ1        0.1200
      4 H1         0.5500   -0.8200    0.0000 H         1 BNZ1        0.0600
@<TRIPOS>BOND
     1    1    2 ar
     2    2    3 ar
     3    1    4 1
"""


def test_pqr_parse_10_field(tmp_path):
    p = tmp_path / "x.pqr"
    p.write_text(PQR_10)
    u = Universe(str(p))
    assert u.atoms.n_atoms == 3
    np.testing.assert_allclose(u.atoms.charges, [0.1592, 0.0221, 0.2737])
    np.testing.assert_allclose(u.atoms.radii, [1.824, 1.908, 0.600])
    # glued insertion code: '52A' -> resid 52
    assert u.topology.resids[2] == 52
    np.testing.assert_allclose(
        u.trajectory[0].positions[0], [27.34, 24.43, 2.614], atol=1e-5)


def test_pqr_parse_11_field_chain(tmp_path):
    p = tmp_path / "x.pqr"
    p.write_text(PQR_11)
    u = Universe(str(p))
    assert list(u.topology.segids) == ["A", "A"]


def test_pqr_prop_radius_selection(tmp_path):
    p = tmp_path / "x.pqr"
    p.write_text(PQR_10)
    u = Universe(str(p))
    big = u.select_atoms("prop radius > 1.0")
    assert list(big.names) == ["N", "CA"]


def test_pqr_round_trip(tmp_path):
    p = tmp_path / "x.pqr"
    p.write_text(PQR_10)
    u = Universe(str(p))
    out = tmp_path / "rt.pqr"
    write_pqr(str(out), u)
    v = Universe(str(out))
    np.testing.assert_allclose(v.atoms.charges, u.atoms.charges, atol=1e-4)
    np.testing.assert_allclose(v.atoms.radii, u.atoms.radii, atol=1e-4)
    np.testing.assert_allclose(v.trajectory[0].positions,
                               u.trajectory[0].positions, atol=1e-3)
    assert list(v.atoms.names) == list(u.atoms.names)


def test_pqr_writer_requires_charges_radii(tmp_path):
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    u = make_protein_universe(n_residues=3, n_frames=1)
    with pytest.raises(ValueError, match="radii"):
        write_pqr(str(tmp_path / "x.pqr"), u)


def test_mol2_parse(tmp_path):
    p = tmp_path / "m.mol2"
    p.write_text(MOL2)
    u = Universe(str(p))
    assert u.atoms.n_atoms == 4
    assert u.trajectory.n_frames == 2          # two MOLECULE blocks
    assert list(u.atoms.elements) == ["C", "C", "N", "H"]
    assert list(u.atoms.resnames) == ["BNZ"] * 4   # BNZ1 -> BNZ
    np.testing.assert_allclose(u.atoms.charges,
                               [-0.06, -0.06, 0.12, 0.06])
    assert sorted(map(tuple, u.topology.bonds.tolist())) == [
        (0, 1), (0, 3), (1, 2)]
    np.testing.assert_allclose(u.trajectory[1].positions[0],
                               [1.1, 0.1, 0.0], atol=1e-5)


def test_mol2_fragments_from_bonds(tmp_path):
    p = tmp_path / "m.mol2"
    p.write_text(MOL2)
    u = Universe(str(p))
    # bond graph: {0,1,2,3} all connected -> one fragment
    assert len(np.unique(u.topology.fragindices)) == 1


def test_mol2_round_trip(tmp_path):
    p = tmp_path / "m.mol2"
    p.write_text(MOL2)
    u = Universe(str(p))
    out = tmp_path / "rt.mol2"
    write_mol2(str(out), u, frames=range(u.trajectory.n_frames))
    v = Universe(str(out))
    assert v.trajectory.n_frames == 2
    assert list(v.atoms.names) == list(u.atoms.names)
    np.testing.assert_allclose(np.asarray(v.atoms.charges),
                               np.asarray(u.atoms.charges), atol=1e-4)
    for f in range(2):
        np.testing.assert_allclose(v.trajectory[f].positions,
                                   u.trajectory[f].positions, atol=1e-3)
    assert sorted(map(tuple, v.topology.bonds.tolist())) == sorted(
        map(tuple, u.topology.bonds.tolist()))


def test_mol2_no_charges(tmp_path):
    txt = MOL2.split("@<TRIPOS>MOLECULE")[1].replace(
        "USER_CHARGES", "NO_CHARGES")
    p = tmp_path / "m.mol2"
    p.write_text("@<TRIPOS>MOLECULE" + txt)
    u = Universe(str(p))
    assert u.topology.charges is None


def test_mol2_mismatched_blocks_rejected(tmp_path):
    bad = MOL2 + "@<TRIPOS>MOLECULE\nx\n 1 0 0\nSMALL\nNO_CHARGES\n" \
        "@<TRIPOS>ATOM\n 1 C1 0.0 0.0 0.0 C.3 1 MOL 0.0\n"
    p = tmp_path / "m.mol2"
    p.write_text(bad)
    with pytest.raises(ValueError, match="identical molecules"):
        parse_mol2(str(p))


def test_radii_survive_subset_and_merge(tmp_path):
    p = tmp_path / "x.pqr"
    p.write_text(PQR_10)
    u = Universe(str(p))
    sub = u.topology.subset(np.array([0, 2]))
    np.testing.assert_allclose(sub.radii, [1.824, 0.600])


def test_mol2_resname_strip_only_when_id_matches(tmp_path):
    block = """@<TRIPOS>MOLECULE
m
 2 0 2 0 0
SMALL
USER_CHARGES
@<TRIPOS>ATOM
 1 C1 0.0 0.0 0.0 C.3 1 ALA1 0.1
 2 C2 1.0 0.0 0.0 C.3 1 HIS2 0.2
"""
    p = tmp_path / "m.mol2"
    p.write_text(block)
    u = Universe(str(p))
    # ALA1 with subst_id 1 -> ALA; HIS2 with subst_id 1 stays HIS2
    assert list(u.atoms.resnames) == ["ALA", "HIS2"]


def test_mol2_blank_molecule_name_charge_type(tmp_path):
    block = """@<TRIPOS>MOLECULE

 1 0 1 0 0
SMALL
NO_CHARGES
@<TRIPOS>ATOM
 1 C1 0.0 0.0 0.0 C.3 1 MOL 0.0
"""
    p = tmp_path / "m.mol2"
    p.write_text(block)
    u = Universe(str(p))
    assert u.topology.charges is None


def test_mol2_round_trip_digit_resname(tmp_path):
    block = """@<TRIPOS>MOLECULE
m
 1 0 1 0 0
SMALL
USER_CHARGES
@<TRIPOS>ATOM
 1 C1 0.0 0.0 0.0 C.3 1 A4 0.1
"""
    p = tmp_path / "m.mol2"
    p.write_text(block)
    u = Universe(str(p))
    assert list(u.atoms.resnames) == ["A4"]
    out = tmp_path / "rt.mol2"
    write_mol2(str(out), u)
    v = Universe(str(out))
    assert list(v.atoms.resnames) == ["A4"]



# ---- CRD (CHARMM card) ----

CRD_STD = """\
* Title line
*
    4
    1    1 ALA  N      11.11400   7.36500  -8.34900 PROT 1      0.00000
    2    1 ALA  CA     11.98100   8.34500  -7.91300 PROT 1      0.00000
    3    2 GLY  N      12.73300   7.88100  -6.77900 PROT 2      0.00000
    4    1 TIP3 OH2     3.00000   4.00000   5.00000 WAT  1      0.00000
"""


def test_crd_parse(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.crd import parse_crd

    p = tmp_path / "x.crd"
    p.write_text(CRD_STD)
    u = Universe(str(p))
    assert u.atoms.n_atoms == 4
    assert list(u.atoms.names) == ["N", "CA", "N", "OH2"]
    assert list(u.atoms.resnames) == ["ALA", "ALA", "GLY", "TIP3"]
    assert list(u.topology.segids) == ["PROT", "PROT", "PROT", "WAT"]
    assert list(u.topology.resids) == [1, 1, 2, 1]
    np.testing.assert_allclose(
        u.trajectory[0].positions[0], [11.114, 7.365, -8.349], atol=1e-4)
    # per-(segid,resid) residues: ALA/1, GLY/2, TIP3/1 -> 3 residues
    assert len(np.unique(u.topology.resindices)) == 3


def test_crd_round_trip_std_and_ext(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.crd import parse_crd, write_crd

    p = tmp_path / "x.crd"
    p.write_text(CRD_STD)
    u = Universe(str(p))
    for ext in (False, True):
        out = tmp_path / f"rt{int(ext)}.crd"
        write_crd(str(out), u, extended=ext)
        v = Universe(str(out))
        assert list(v.atoms.names) == list(u.atoms.names)
        assert list(v.topology.segids) == list(u.topology.segids)
        np.testing.assert_allclose(v.trajectory[0].positions,
                                   u.trajectory[0].positions, atol=1e-4)


def test_crd_count_mismatch_rejected(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.crd import parse_crd

    p = tmp_path / "x.crd"
    p.write_text(CRD_STD.replace("    4\n", "    5\n"))
    with pytest.raises(ValueError, match="declares 5"):
        parse_crd(str(p))


def test_crd_touching_fixed_columns(tmp_path):
    """CHARMM f10.5 fields with no separating whitespace (wide boxes
    with negative coordinates) parse via the fixed-column path and
    round-trip exactly."""
    from mdanalysis_mpi_tpu_torch.io.crd import write_crd
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    coords = np.array([[[-100.5, 1234.56789, 0.0],
                        [9999.12345, -250.25, 3.5]]], np.float32)
    top = Topology(names=np.array(["N", "CA"]),
                   resnames=np.array(["ALA", "ALA"]),
                   resids=np.array([1, 1]),
                   segids=np.array(["PROT", "PROT"]))
    u = Universe(top, MemoryReader(coords))
    for ext in (False, True):
        out = tmp_path / f"wide{int(ext)}.crd"
        write_crd(str(out), u, extended=ext)
        v = Universe(str(out))
        np.testing.assert_allclose(v.trajectory[0].positions, coords[0],
                                   atol=1e-3)
        assert list(v.atoms.names) == ["N", "CA"]


# ---------------- parity with the JAX package ----------------

TOP_FIELDS = ("names", "resnames", "resids", "segids", "elements", "masses",
              "charges", "radii", "resindices", "bonds", "angles",
              "dihedrals", "impropers")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_topology(top, jtop):
    """Every Topology attribute equal between the packages."""
    for key in TOP_FIELDS:
        a, b = getattr(top, key), getattr(jtop, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=key)


def assert_same_universe(u, ju):
    """Equal topologies, and every frame and box equal."""
    assert_same_topology(u.topology, ju.topology)
    n = u.trajectory.n_frames
    assert n == ju.trajectory.n_frames
    (a, ab), (b, bb) = (u.trajectory.read_block(0, n),
                        ju.trajectory.read_block(0, n))
    np.testing.assert_array_equal(a, b)
    assert (ab is None) == (bb is None)
    if ab is not None:
        np.testing.assert_array_equal(ab, bb)


FIXTURES = {"pqr10.pqr": PQR_10, "pqr11.pqr": PQR_11, "m.mol2": MOL2,
            "x.crd": CRD_STD}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_universe_like_jax(tmp_path, name):
    p = tmp_path / name
    p.write_text(FIXTURES[name])
    assert_same_universe(Universe(str(p)), JUniverse(str(p)))


@pytest.mark.parametrize("fmt", ["pqr", "mol2", "crd", "crd_ext"])
def test_writer_bytes_equal_jax(tmp_path, fmt):
    src = {"pqr": "pqr10.pqr", "mol2": "m.mol2", "crd": "x.crd",
           "crd_ext": "x.crd"}[fmt]
    p = tmp_path / src
    p.write_text(FIXTURES[src])
    u, ju = Universe(str(p)), JUniverse(str(p))
    ext = fmt.split("_")[0]
    out, jout = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    if fmt == "pqr":
        write_pqr(out, u)
        jpqr.write_pqr(jout, ju)
    elif fmt == "mol2":
        write_mol2(out, u, frames=range(u.trajectory.n_frames))
        jmol2.write_mol2(jout, ju, frames=range(ju.trajectory.n_frames))
    else:
        from mdanalysis_mpi_tpu_torch.io.crd import write_crd

        ext_kw = dict(extended=(fmt == "crd_ext"))
        write_crd(out, u.select_atoms("resname ALA GLY"), **ext_kw)
        jcrd.write_crd(jout, ju.select_atoms("resname ALA GLY"), **ext_kw)
    assert _bytes(out) == _bytes(jout)
    assert_same_universe(Universe(out), JUniverse(out))
