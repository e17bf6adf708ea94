"""Twin of ``tests/test_nucleicacids.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

NucPairDist / WatsonCrickDist (upstream ``analysis.nucleicacids``):
hand-placed N1/N3 geometries, purine/pyrimidine atom choice, backend
parity, and validation."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import NucPairDist, WatsonCrickDist
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    both, mesh_kw, port_runs_on_the_cpu)


def _dna_universe(seps, resnames=("DA", "DT")):
    """Two paired strands of len(seps) base pairs; pair i's N1-N3
    distance is seps[i] at frame 0 and seps[i]+1 at frame 1."""
    n_pairs = len(seps)
    names, rn, rid, pos0, pos1 = [], [], [], [], []
    for i in range(n_pairs):
        y = 10.0 * i
        # strand 1 residue (purine: N1 matters), plus a decoy N3
        names += ["N1", "N3", "C2"]
        rn += [resnames[0]] * 3
        rid += [i + 1] * 3
        pos0 += [[0.0, y, 0.0], [50.0, y, 0.0], [1.0, y, 1.0]]
        pos1 += [[0.0, y, 0.0], [50.0, y, 0.0], [1.0, y, 1.0]]
    for i in range(n_pairs):
        y = 10.0 * i
        names += ["N3", "N1", "C2"]
        rn += [resnames[1]] * 3
        rid += [n_pairs + i + 1] * 3
        pos0 += [[seps[i], y, 0.0], [70.0, y, 0.0], [2.0, y, 0.0]]
        pos1 += [[seps[i] + 1.0, y, 0.0], [70.0, y, 0.0], [2.0, y, 0.0]]
    top = Topology(names=np.array(names), resnames=np.array(rn),
                   resids=np.array(rid))
    frames = np.stack([pos0, pos1]).astype(np.float32)
    return Universe(top, MemoryReader(frames))


def test_watson_crick_hand_computed():
    u = _dna_universe([2.8, 3.0, 3.2])
    s1 = u.select_atoms("resname DA")
    s2 = u.select_atoms("resname DT")
    r = WatsonCrickDist(s1, s2).run(backend="serial")
    np.testing.assert_allclose(r.results.pair_distances,
                               [[2.8, 3.0, 3.2], [3.8, 4.0, 4.2]],
                               atol=1e-5)
    # the older upstream name aliases the same data
    np.testing.assert_allclose(r.results.distances,
                               r.results.pair_distances)


def test_purine_pyrimidine_atom_choice():
    """Swap strand roles: a pyrimidine strand contributes N3 even when
    it also carries an N1 decoy."""
    u = _dna_universe([3.0], resnames=("DG", "DC"))
    r = WatsonCrickDist(u.select_atoms("resname DG"),
                        u.select_atoms("resname DC")).run(
        backend="serial")
    assert r.results.pair_distances[0, 0] == pytest.approx(3.0, abs=1e-5)


def test_backend_parity():
    u = _dna_universe([2.8, 3.0, 3.2, 2.9])
    s1 = u.select_atoms("resname DA")
    s2 = u.select_atoms("resname DT")
    s = WatsonCrickDist(s1, s2).run(backend="serial")
    for backend in ("torch", "mesh"):
        b = WatsonCrickDist(s1, s2).run(**mesh_kw(backend), batch_size=1)
        np.testing.assert_allclose(np.asarray(b.results.pair_distances),
                                   s.results.pair_distances, atol=1e-4)


def test_nucpairdist_generic():
    u = _dna_universe([3.0])
    r = NucPairDist(u, [[0, 3]]).run(backend="serial")
    assert r.results.pair_distances.shape == (2, 1)
    with pytest.raises(ValueError, match="out of range"):
        NucPairDist(u, [[0, 99]])
    with pytest.raises(ValueError, match="at least one"):
        NucPairDist(u, np.empty((0, 2)))


def test_validation():
    u = _dna_universe([3.0, 3.0])
    s1 = u.select_atoms("resname DA")
    s2 = u.select_atoms("resname DT and resid 3")
    with pytest.raises(ValueError, match="residue-by-residue"):
        WatsonCrickDist(s1, s2)
    # a residue missing its WC atom is named
    u2 = _dna_universe([3.0])
    names = u2.topology.names.copy()
    names[3] = "XX"                        # strand 2's N3 gone
    top = Topology(names=names, resnames=u2.topology.resnames,
                   resids=u2.topology.resids)
    u3 = Universe(top, MemoryReader(
        np.zeros((1, len(names), 3), np.float32)))
    with pytest.raises(ValueError, match="lacks atom"):
        WatsonCrickDist(u3.select_atoms("resname DA"),
                        u3.select_atoms("resname DT"))
    with pytest.raises(TypeError, match="strand"):
        WatsonCrickDist("resname DA", s2)


def test_unknown_resname_refused_and_tables_cover_nucleic():
    from mdanalysis_mpi_tpu_torch.core.tables import (
        NUCLEIC_RESNAMES, PURINE_RESNAMES, PYRIMIDINE_RESNAMES,
    )

    # every nucleic resname is classified exactly once
    assert PURINE_RESNAMES | PYRIMIDINE_RESNAMES == NUCLEIC_RESNAMES
    assert not (PURINE_RESNAMES & PYRIMIDINE_RESNAMES)
    # a modified/unknown base refuses instead of silently using N3
    u = _dna_universe([3.0], resnames=("1MA", "DT"))
    with pytest.raises(ValueError, match="purine or pyrimidine"):
        WatsonCrickDist(u.select_atoms("resname 1MA"),
                        u.select_atoms("resname DT"))
    # 5'/3' terminal purine variants classify as purines (RA5 etc.)
    u2 = _dna_universe([3.1], resnames=("RA5", "RU3"))
    r = WatsonCrickDist(u2.select_atoms("resname RA5"),
                        u2.select_atoms("resname RU3")).run(
        backend="serial")
    assert r.results.pair_distances[0, 0] == pytest.approx(3.1, abs=1e-5)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


def test_watson_crick_matches_jax_package():
    """The reference's DNA fixture through both packages: pair distances
    within its 1e-4 Å."""
    def case(mod):
        import numpy as _np

        Topology = mod("core.topology").Topology
        Universe = mod("core.universe").Universe
        MemoryReader = mod("io.memory").MemoryReader
        names = _np.array(["N1", "N6", "N3", "O4"] * 2)
        resnames = _np.array(["DA"] * 2 + ["DT"] * 2 + ["DA"] * 2
                             + ["DT"] * 2)
        resids = _np.array([1, 1, 2, 2, 3, 3, 4, 4])
        rng = _np.random.default_rng(5)
        pos = rng.uniform(0, 12, size=(3, 8, 3)).astype(_np.float32)
        u = Universe(Topology(names=names, resnames=resnames,
                              resids=resids), MemoryReader(pos))
        r = mod("analysis").NucPairDist(u, [[0, 2], [4, 6]]).run(
            backend="jax" if mod().__name__ == "mdanalysis_mpi_tpu"
            else "torch", batch_size=1)
        return np.asarray(r.results.pair_distances)
    ref, port = both(case)
    np.testing.assert_allclose(port, ref, atol=1e-4)
