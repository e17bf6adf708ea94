"""The port's GROMACS ITP/TOP parser (``io/itp.py``, and the ``.top``
sniffer of ``io/prmtop.py``): the JAX package's tests/test_itp.py case
by case (moleculetype replication, includes, the ifdef subset,
settles→bonds, angles, dihedrals and impropers, the .top sniffer), then
parity with the JAX package: every fixture parses to equal Topology
attributes in both packages, ``#define``/``#include`` handling and the
``.top`` dispatch included."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.itp import parse_itp

from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
from mdanalysis_mpi_tpu.io.itp import parse_itp as jparse_itp

PROT_ITP = """\
; a tiny protein-like molecule
[ moleculetype ]
PROT   3

[ atoms ]
;  nr type resnr residue atom cgnr charge  mass
    1  N3     1   ALA     N     1  -0.30  14.007
    2  CT     1   ALA    CA     1   0.10  12.011
    3  HC     1   ALA    HA     1   0.20   1.008

[ bonds ]
  1  2  1
  2  3  1
"""

WATER_ITP = """\
[ moleculetype ]
SOL  2

[ atoms ]
 1  OW  1  SOL  OW  1  -0.8476  15.9994
 2  HW  1  SOL  HW1 1   0.4238   1.008
 3  HW  1  SOL  HW2 1   0.4238   1.008

[ settles ]
 1  1  0.1  0.16
"""

TOP = """\
#include "prot.itp"
#include "water.itp"

[ system ]
tiny box

[ molecules ]
PROT   1
SOL    2
"""


def _write(tmp_path):
    (tmp_path / "prot.itp").write_text(PROT_ITP)
    (tmp_path / "water.itp").write_text(WATER_ITP)
    p = tmp_path / "topol.top"
    p.write_text(TOP)
    return p


def test_itp_single_molecule(tmp_path):
    p = tmp_path / "prot.itp"
    p.write_text(PROT_ITP)
    top = parse_itp(str(p))
    assert top.n_atoms == 3
    assert list(top.names) == ["N", "CA", "HA"]
    np.testing.assert_allclose(top.charges, [-0.30, 0.10, 0.20])
    np.testing.assert_allclose(top.masses, [14.007, 12.011, 1.008])
    assert sorted(map(tuple, top.bonds.tolist())) == [(0, 1), (1, 2)]


def test_top_replication_and_includes(tmp_path):
    p = _write(tmp_path)
    top = parse_itp(str(p))
    # PROT(3) + 2x SOL(3) = 9 atoms
    assert top.n_atoms == 9
    assert list(top.names) == ["N", "CA", "HA",
                               "OW", "HW1", "HW2", "OW", "HW1", "HW2"]
    # settles became bonds, replicated with correct offsets
    assert sorted(map(tuple, top.bonds.tolist())) == [
        (0, 1), (1, 2), (3, 4), (3, 5), (6, 7), (6, 8)]
    # three distinct residues (ALA + 2 SOL)
    assert len(np.unique(top.resindices)) == 3
    np.testing.assert_allclose(top.charges[3:6],
                               [-0.8476, 0.4238, 0.4238])


def test_top_extension_sniffer(tmp_path):
    """.top dispatches by content: GROMACS directives vs AMBER %FLAG."""
    p = _write(tmp_path)
    u = Universe(str(p), np.zeros((1, 9, 3), np.float32))
    assert u.select_atoms("resname SOL").n_atoms == 6
    # and an AMBER prmtop under .top still parses
    from tests.test_torch_amber import PRMTOP

    q = tmp_path / "amber.top"
    q.write_text(PRMTOP)
    v = Universe(str(q), np.zeros((1, 5, 3), np.float32))
    assert v.atoms.n_atoms == 5


def test_missing_include_loud(tmp_path):
    p = tmp_path / "topol.top"
    p.write_text('#include "forcefield.itp"\n' + PROT_ITP)
    with pytest.raises(FileNotFoundError, match="forcefield.itp"):
        parse_itp(str(p))


def test_unknown_moleculetype_loud(tmp_path):
    p = tmp_path / "topol.top"
    p.write_text(PROT_ITP + "\n[ system ]\nx\n[ molecules ]\nSOL 3\n")
    with pytest.raises(ValueError, match="SOL"):
        parse_itp(str(p))


def test_ifdef_subset(tmp_path):
    itp = """\
#define FLEXIBLE
[ moleculetype ]
M 1
[ atoms ]
#ifdef FLEXIBLE
 1 X 1 MOL A1 1 0.5 1.0
#else
 1 X 1 MOL B1 1 -0.5 2.0
#endif
#ifndef POSRES
 2 X 1 MOL C2 1 0.0 3.0
#endif
"""
    p = tmp_path / "m.itp"
    p.write_text(itp)
    top = parse_itp(str(p))
    assert list(top.names) == ["A1", "C2"]
    # external define flips the branch
    top2 = parse_itp(str(p.rename(tmp_path / "m2.itp")),
                     defines={"POSRES"})
    assert list(top2.names) == ["A1"]


def test_mass_fallback_when_absent(tmp_path):
    itp = """\
[ moleculetype ]
M 1
[ atoms ]
 1 OW 1 SOL OW 1
 2 HW 1 SOL HW1 1
"""
    p = tmp_path / "m.itp"
    p.write_text(itp)
    top = parse_itp(str(p))
    # no masses given -> element-table fallback via name guessing
    assert top.masses[0] > 10 and top.masses[1] < 2


def test_mixed_masses_fill_gaps_only(tmp_path):
    itp = """\
[ moleculetype ]
M 1
[ atoms ]
 1 DH 1 MOL HD1 1 0.1 2.014
 2 HC 1 MOL HA  1
"""
    p = tmp_path / "m.itp"
    p.write_text(itp)
    top = parse_itp(str(p))
    # explicit isotope mass survives; only the gap is table-guessed
    np.testing.assert_allclose(top.masses, [2.014, 1.008])


def test_unterminated_ifdef_loud(tmp_path):
    p = tmp_path / "m.itp"
    p.write_text("#ifdef POSRES\n" + PROT_ITP)
    with pytest.raises(ValueError, match="unterminated"):
        parse_itp(str(p))


def test_large_replication_fast(tmp_path):
    import time

    (tmp_path / "water.itp").write_text(WATER_ITP)
    p = tmp_path / "topol.top"
    p.write_text('#include "water.itp"\n[ system ]\nbox\n'
                 "[ molecules ]\nSOL 30000\n")
    t0 = time.perf_counter()
    top = parse_itp(str(p))
    wall = time.perf_counter() - t0
    assert top.n_atoms == 90000
    assert len(top.bonds) == 60000
    # residues stay distinct across copies
    assert len(np.unique(top.resindices)) == 30000
    assert wall < 2.0, f"replication took {wall:.2f}s"


def test_redefined_moleculetype_loud(tmp_path):
    p = tmp_path / "m.itp"
    p.write_text(PROT_ITP + "\n" + PROT_ITP)
    with pytest.raises(ValueError, match="redefined"):
        parse_itp(str(p))


def test_itp_angles_dihedrals_impropers(tmp_path):
    """[angles] and [dihedrals] populate the connectivity arrays;
    function types 2/4 become impropers; [molecules] replication
    offsets every tuple."""
    p = tmp_path / "mol.itp"
    p.write_text("""
[ moleculetype ]
BUT 3
[ atoms ]
1 C 1 BUT C1 1 0.0 12.0
2 C 1 BUT C2 2 0.0 12.0
3 C 1 BUT C3 3 0.0 12.0
4 C 1 BUT C4 4 0.0 12.0
[ bonds ]
1 2 1
2 3 1
3 4 1
[ angles ]
1 2 3 1
2 3 4 1
[ dihedrals ]
1 2 3 4 9
2 1 3 4 2
[ system ]
butane
[ molecules ]
BUT 2
""")
    top = parse_itp(str(p))
    assert top.n_atoms == 8
    np.testing.assert_array_equal(top.angles,
                                  [[0, 1, 2], [1, 2, 3],
                                   [4, 5, 6], [5, 6, 7]])
    np.testing.assert_array_equal(top.dihedrals,
                                  [[0, 1, 2, 3], [4, 5, 6, 7]])
    np.testing.assert_array_equal(top.impropers,
                                  [[1, 0, 2, 3], [5, 4, 6, 7]])


# ---------------- parity with the JAX package ----------------

TOP_FIELDS = ("names", "resnames", "resids", "segids", "elements", "masses",
              "charges", "radii", "resindices", "bonds", "angles",
              "dihedrals", "impropers")


def assert_same_topology(top, jtop):
    """Every Topology attribute equal between the packages."""
    for key in TOP_FIELDS:
        a, b = getattr(top, key), getattr(jtop, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=key)



IFDEF_ITP = """\
#define FLEXIBLE
[ moleculetype ]
M 1
[ atoms ]
#ifdef FLEXIBLE
 1 X 1 MOL A1 1 0.5 1.0
#else
 1 X 1 MOL B1 1 -0.5 2.0
#endif
#ifndef POSRES
 2 X 1 MOL C2 1 0.0 3.0
#endif
"""

MASSLESS_ITP = """\
[ moleculetype ]
M 1
[ atoms ]
 1 OW 1 SOL OW 1
 2 HW 1 SOL HW1 1
 3 DH 1 MOL HD1 1 0.1 2.014
"""

BUTANE_TOP = """\
[ moleculetype ]
BUT 3
[ atoms ]
1 C 1 BUT C1 1 0.0 12.0
2 C 1 BUT C2 2 0.0 12.0
3 C 1 BUT C3 3 0.0 12.0
4 C 1 BUT C4 4 0.0 12.0
[ bonds ]
1 2 1
2 3 1
3 4 1
[ angles ]
1 2 3 1
2 3 4 1
[ dihedrals ]
1 2 3 4 9
2 1 3 4 2
[ system ]
butane
[ molecules ]
BUT 3
"""


@pytest.mark.parametrize("case,defines", [
    ("prot", ()), ("topol", ()), ("ifdef", ()), ("ifdef", ("POSRES",)),
    ("massless", ()), ("butane", ())])
def test_parses_like_jax(tmp_path, case, defines):
    if case == "topol":
        p = _write(tmp_path)
    else:
        text = {"prot": PROT_ITP, "ifdef": IFDEF_ITP,
                "massless": MASSLESS_ITP, "butane": BUTANE_TOP}[case]
        p = tmp_path / f"{case}.itp"
        p.write_text(text)
    assert_same_topology(parse_itp(str(p), defines=defines),
                         jparse_itp(str(p), defines=defines))


def test_top_dispatch_like_jax(tmp_path):
    """``.top`` through Universe: the GROMACS topology with includes and
    an AMBER prmtop under the same extension, equal in both packages."""
    from tests.test_torch_amber import PRMTOP

    gmx = _write(tmp_path)
    amber = tmp_path / "amber.top"
    amber.write_text(PRMTOP)
    for path, n in ((gmx, 9), (amber, 5)):
        zeros = np.zeros((1, n, 3), np.float32)
        assert_same_topology(Universe(str(path), zeros).topology,
                             JUniverse(str(path), zeros).topology)
