"""The port's nuclinfo (``analysis/nuclinfo.py``, a copy of the JAX
package's: host NumPy at the Universe's current frame): the JAX
package's tests/test_nuclinfo.py case by case, and every function's
value on the same constructed duplex EQUAL to the JAX package's (the
same code on the same float64 input)."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import nuclinfo
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.lib.distances import calc_dihedrals


def _universe(names, resnames, resids, segids, coords):
    top = Topology(names=np.array(names), resnames=np.array(resnames),
                   resids=np.array(resids), segids=np.array(segids))
    return Universe(top, MemoryReader(
        np.asarray(coords, np.float32)[None]))


def test_pair_distances_gc():
    # G (purine): N1 at origin, C2 at (1,0,0), O6 at (0,2,0)
    # C (pyrimidine): N3 at (3,0,0), O2 at (4,0,0), N4 at (0,5,0)
    u = _universe(
        names=["N1", "C2", "O6", "N3", "O2", "N4"],
        resnames=["G", "G", "G", "C", "C", "C"],
        resids=[1, 1, 1, 2, 2, 2],
        segids=["A", "A", "A", "B", "B", "B"],
        coords=[[0, 0, 0], [1, 0, 0], [0, 2, 0],
                [3, 0, 0], [4, 0, 0], [0, 5, 0]])
    assert nuclinfo.wc_pair(u, 1, 2, "A", "B") == pytest.approx(3.0)
    assert nuclinfo.minor_pair(u, 1, 2, "A", "B") == pytest.approx(3.0)
    assert nuclinfo.major_pair(u, 1, 2, "A", "B") == pytest.approx(3.0)


def test_pair_distances_au():
    # A (purine): N1, C2, N6; U (pyrimidine): N3, O2, O4
    u = _universe(
        names=["N1", "C2", "N6", "N3", "O2", "O4"],
        resnames=["A", "A", "A", "U", "U", "U"],
        resids=[1, 1, 1, 2, 2, 2],
        segids=["X", "X", "X", "X", "X", "X"],
        coords=[[0, 0, 0], [0, 1, 0], [0, 0, 2],
                [2, 0, 0], [0, 4, 0], [0, 0, 6]])
    assert nuclinfo.wc_pair(u, 1, 2, "X", "X") == pytest.approx(2.0)
    assert nuclinfo.minor_pair(u, 1, 2, "X", "X") == pytest.approx(3.0)
    assert nuclinfo.major_pair(u, 1, 2, "X", "X") == pytest.approx(4.0)


def _rna_chain():
    """Two RNA residues with every backbone/sugar/base atom nuclinfo
    touches, at seeded random positions (wiring tests compare against
    direct calc_dihedrals, so geometry need not be physical)."""
    per_res = ["P", "O5'", "C5'", "C4'", "C3'", "O3'", "C1'", "C2'",
               "O2'", "HO2'", "O4'", "N1", "C2", "N3", "C4", "N9"]
    rng = np.random.default_rng(42)
    names, resnames, resids, segids, coords = [], [], [], [], []
    for r in (1, 2, 3):
        for n in per_res:
            names.append(n)
            resnames.append("A")          # purine (has N9/C4)
            resids.append(r)
            segids.append("R")
            coords.append(rng.normal(scale=4.0, size=3))
    return _universe(names, resnames, resids, segids, coords), per_res


def _direct(u, atoms):
    pos = [u.select_atoms(f"segid R and resid {r} and name {n}")
           .positions[0].astype(np.float64) for r, n in atoms]
    d = float(np.degrees(calc_dihedrals(
        pos[0][None], pos[1][None], pos[2][None], pos[3][None])[0]))
    return d % 360.0


def test_torsion_wiring():
    u, _ = _rna_chain()
    assert nuclinfo.tors_alpha(u, "R", 2) == pytest.approx(_direct(
        u, [(1, "O3'"), (2, "P"), (2, "O5'"), (2, "C5'")]))
    assert nuclinfo.tors_beta(u, "R", 1) == pytest.approx(_direct(
        u, [(1, "P"), (1, "O5'"), (1, "C5'"), (1, "C4'")]))
    assert nuclinfo.tors_gamma(u, "R", 1) == pytest.approx(_direct(
        u, [(1, "O5'"), (1, "C5'"), (1, "C4'"), (1, "C3'")]))
    assert nuclinfo.tors_delta(u, "R", 1) == pytest.approx(_direct(
        u, [(1, "C5'"), (1, "C4'"), (1, "C3'"), (1, "O3'")]))
    assert nuclinfo.tors_eps(u, "R", 1) == pytest.approx(_direct(
        u, [(1, "C4'"), (1, "C3'"), (1, "O3'"), (2, "P")]))
    assert nuclinfo.tors_zeta(u, "R", 1) == pytest.approx(_direct(
        u, [(1, "C3'"), (1, "O3'"), (2, "P"), (2, "O5'")]))
    assert nuclinfo.tors_chi(u, "R", 1) == pytest.approx(_direct(
        u, [(1, "O4'"), (1, "C1'"), (1, "N9"), (1, "C4")]))
    assert nuclinfo.hydroxyl(u, "R", 1) == pytest.approx(_direct(
        u, [(1, "C1'"), (1, "C2'"), (1, "O2'"), (1, "HO2'")]))
    # the 7-tuple needs both neighbors -> middle residue of the chain
    seven = nuclinfo.tors(u, "R", 2)
    assert len(seven) == 7
    assert all(0.0 <= t < 360.0 for t in seven)


def _ring_universe(phase_deg, q=0.4):
    """Regular pentagon (ring order O4',C1',C2',C3',C4') with the pure
    CP out-of-plane mode z_j = q·cos(phase + 4πj/5)."""
    order = ["O4'", "C1'", "C2'", "C3'", "C4'"]
    j = np.arange(5)
    xy = np.stack([np.cos(2 * np.pi * j / 5),
                   np.sin(2 * np.pi * j / 5)], axis=1) * 1.4
    z = q * np.cos(np.radians(phase_deg) + 4 * np.pi * j / 5)
    coords = np.concatenate([xy, z[:, None]], axis=1)
    return _universe(order, ["A"] * 5, [1] * 5, ["R"] * 5, coords)


@pytest.mark.parametrize("phase", [18.0, 90.0, 162.0, 250.0])
def test_phase_cp_recovers_constructed_pucker(phase):
    u = _ring_universe(phase)
    got = nuclinfo.phase_cp(u, "R", 1)
    # the fixture's pentagon runs counterclockwise in xy, so the CP
    # mean-plane normal (R'xR'' right-hand rule over the ring
    # traversal) points -z and the constructed +z mode is the CP
    # -mode: recovered phase = constructed + 180 exactly
    assert got == pytest.approx((phase + 180.0) % 360.0, abs=1e-4)


def test_phase_as_distinguishes_puckers():
    p1 = nuclinfo.phase_as(_ring_universe(18.0), "R", 1)
    p2 = nuclinfo.phase_as(_ring_universe(162.0), "R", 1)
    assert 0.0 <= p1 < 360.0 and 0.0 <= p2 < 360.0
    assert abs(p1 - p2) > 30.0


def test_unknown_base_refused():
    u = _universe(["N1"], ["XYZ"], [1], ["A"], [[0, 0, 0]])
    with pytest.raises(ValueError, match="neither"):
        nuclinfo.wc_pair(u, 1, 1, "A", "A")


def test_missing_atom_refused():
    # a G whose N1 is absent: base classification succeeds, the
    # exactly-one-atom contract refuses
    u = _universe(["C2"], ["G"], [1], ["A"], [[0, 0, 0]])
    with pytest.raises(ValueError, match="matched 0"):
        nuclinfo.wc_pair(u, 1, 1, "A", "A")


def test_values_equal_jax_package():
    from mdanalysis_mpi_tpu.analysis import nuclinfo as jn
    from mdanalysis_mpi_tpu.core.topology import Topology as JTop
    from mdanalysis_mpi_tpu.core.universe import Universe as JU
    from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMR

    u, _ = _rna_chain()
    t = u.topology
    uj = JU(JTop(names=t.names, resnames=t.resnames, resids=t.resids,
                 segids=t.segids),
            JMR(u.trajectory.read_block(0, 1)[0]))
    for name in ("tors_alpha", "tors_beta", "tors_gamma", "tors_delta",
                 "tors_eps", "tors_zeta", "tors_chi", "hydroxyl",
                 "phase_as", "phase_cp"):
        assert getattr(nuclinfo, name)(u, "R", 2) == \
            getattr(jn, name)(uj, "R", 2), name
    assert nuclinfo.tors(u, "R", 2) == jn.tors(uj, "R", 2)
