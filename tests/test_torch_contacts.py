"""The port's ``Contacts``, ``AtomicDistances``, ``NucPairDist`` and
``WatsonCrickDist`` on ``device="cpu"`` against the JAX package's
``backend="jax"`` on the same frames (q(t) and distances within 1e-5)
and the serial float64 oracles (tests/test_contacts.py,
test_atomicdistances.py and test_nucleicacids.py, whose cases this file
mirrors).  The batched minimum image (``torch.vmap`` over per-frame
boxes) is held on orthorhombic, triclinic and box-less frames.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis import (  # noqa: E402
    AtomicDistances as JAtomicDistances)
from mdanalysis_mpi_tpu.analysis import Contacts as JContacts  # noqa: E402
from mdanalysis_mpi_tpu.analysis import NucPairDist as JNucPairDist  # noqa: E402
from mdanalysis_mpi_tpu.analysis import (  # noqa: E402
    WatsonCrickDist as JWatsonCrickDist)
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.analysis import (AtomicDistances,  # noqa: E402
                                               Contacts, NucPairDist,
                                               WatsonCrickDist)
from mdanalysis_mpi_tpu_torch.analysis.contacts import (  # noqa: E402
    hard_cut_q, soft_cut_q)
from mdanalysis_mpi_tpu_torch.core.topology import (  # noqa: E402
    Topology, make_protein_topology)
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

CPU = dict(backend="torch", device="cpu")
PORT = (Topology, Universe, MemoryReader)
JAX = (JTopology, JUniverse, JMemoryReader)


def _contacts(cls, u, **kw):
    u.trajectory[0]
    kw.setdefault("radius", 6.0)
    return cls(u, select=("name CA", "name CB"),
               refgroup=(u.select_atoms("name CA"),
                         u.select_atoms("name CB")), **kw)


def _boxed_pair(pkg, kw, dims):
    """The same protein in both packages, every frame under ``dims``
    ((T, 6) or None)."""
    make = make_protein_universe if pkg is PORT else jax_make_protein_universe
    u0 = make(**kw)
    frames = u0.trajectory.read_block(0, u0.trajectory.n_frames)[0]
    return pkg[1](u0.topology, pkg[2](frames, dimensions=dims))


# ---------------- Contacts ----------------

@pytest.mark.parametrize("method", ["hard_cut", "soft_cut"])
@pytest.mark.parametrize("box", ["none", "ortho", "triclinic"])
def test_contacts_match_jax_and_oracle(method, box):
    kw = dict(n_residues=6, n_frames=12, noise=0.5)
    dims = None
    if box != "none":
        # boxes a little larger than the protein, so some pairs wrap
        dims = np.tile(np.float32([14.0, 15.0, 16.0, 90, 90, 90]), (12, 1))
        dims[:, 0] += np.arange(12, dtype=np.float32) * 0.5
        if box == "triclinic":
            dims[:, 3:] = [75.0, 85.0, 95.0]
    u, ju = _boxed_pair(PORT, kw, dims), _boxed_pair(JAX, kw, dims)
    extra = dict(beta=4.0, lambda_constant=1.6) if method == "soft_cut" else {}
    port = _contacts(Contacts, u, method=method, **extra).run(
        **CPU, batch_size=5)
    ref = _contacts(JContacts, ju, method=method, **extra).run(
        backend="jax", batch_size=5)
    oracle = _contacts(Contacts, u, method=method, **extra).run(
        backend="serial")
    q = port.results.timeseries
    assert q.shape == (12, 2)
    np.testing.assert_array_equal(q[:, 0], np.arange(12))
    np.testing.assert_allclose(q[:, 1], ref.results.timeseries[:, 1],
                               atol=1e-5)
    np.testing.assert_allclose(q[:, 1], oracle.results.timeseries[:, 1],
                               atol=5e-3)
    j_oracle = _contacts(JContacts, ju, method=method, **extra).run(
        backend="serial")
    np.testing.assert_allclose(oracle.results.timeseries,
                               j_oracle.results.timeseries, atol=1e-12)


def test_contacts_reference_frame_scores_one():
    u = make_protein_universe(n_residues=6, n_frames=4, noise=0.0)
    c = _contacts(Contacts, u).run(**CPU, batch_size=3)
    np.testing.assert_allclose(c.results.timeseries[:, 1], 1.0, atol=1e-6)
    assert c.n_initial_contacts > 0


def test_contacts_frame_column_respects_step():
    u = make_protein_universe(n_residues=6, n_frames=12)
    c = _contacts(Contacts, u).run(start=2, stop=12, step=3, **CPU,
                                   batch_size=3)
    np.testing.assert_array_equal(c.results.timeseries[:, 0], [2, 5, 8, 11])


def test_contacts_pbc_contact_across_boundary():
    """Two atoms 1 Å apart through the boundary of a 20 Å box are a
    native contact under PBC."""
    top = make_protein_topology(1, atoms_per_residue=("CA", "CB"))
    pos = np.array([[[0.5, 10.0, 10.0], [19.5, 10.0, 10.0]]], np.float32)
    dims = np.array([20.0, 20, 20, 90, 90, 90], np.float32)
    u = Universe(top, MemoryReader(pos, dimensions=dims))
    c = Contacts(u, select=("name CA", "name CB"),
                 refgroup=(u.select_atoms("name CA"),
                           u.select_atoms("name CB")), radius=4.5)
    assert c.n_initial_contacts == 1
    assert abs(c.r0[0] - 1.0) < 1e-5
    r = c.run(**CPU, batch_size=2)
    np.testing.assert_allclose(r.results.timeseries[:, 1], 1.0)


def test_contacts_callable_and_validation():
    u = make_protein_universe(n_residues=6, n_frames=4)

    def radius_count(r, r0, **kw):
        return r < r0 * 1.5

    c = _contacts(Contacts, u, method=radius_count).run(backend="serial")
    assert c.results.timeseries.shape == (4, 2)
    with pytest.raises(ValueError, match="serial"):
        _contacts(Contacts, u, method=radius_count).run(**CPU)
    with pytest.raises(ValueError, match="method"):
        _contacts(Contacts, u, method="bogus")
    with pytest.raises(TypeError, match="does not accept"):
        _contacts(Contacts, u, method="hard_cut", beta=3.0)
    with pytest.raises(ValueError, match="sizes"):
        Contacts(u, select=("name CA", "name CA"),
                 refgroup=(u.select_atoms("name CA"),
                           u.select_atoms("name CB and resid 1")))
    with pytest.raises(ValueError, match="no native contacts"):
        _contacts(Contacts, u, radius=1e-6)
    upd = u.select_atoms("name CA", updating=True)
    with pytest.raises(TypeError, match="UpdatingAtomGroup"):
        Contacts(u, select=("name CA", "name CB"),
                 refgroup=(upd, u.select_atoms("name CB")))


def test_q_functions():
    r = np.array([1.0, 5.0, 7.0])
    np.testing.assert_array_equal(hard_cut_q(r, r, 6.0), [True, True, False])
    assert (soft_cut_q(r, r) > 0.9).all()
    assert soft_cut_q(np.array([20.0]), np.array([1.0]))[0] < 1e-6


# ---------------- AtomicDistances ----------------

def _pair_universe(pkg, box=10.0):
    """2 pairs: (0<->2) 9 apart along x (minimum image 1), (1<->3) by 3;
    frame 1 moves pair 0 to 8 (image 2)."""
    pos = np.zeros((2, 4, 3), np.float32)
    pos[:, 2, 0] = 9.0
    pos[:, 3, 1] = 3.0
    pos[1, 2, 0] = 8.0
    dims = (np.array([box, box, box, 90, 90, 90], np.float32)
            if box else None)
    top = pkg[0](names=np.array(["A", "B", "C", "D"]),
                 resnames=np.full(4, "X"), resids=np.arange(1, 5))
    return pkg[1](top, pkg[2](pos, dimensions=dims))


def test_atomic_distances_hand_computed_with_pbc():
    u = _pair_universe(PORT)
    ag1, ag2 = u.atoms[[0, 1]], u.atoms[[2, 3]]
    for backend in ({"backend": "serial"}, dict(CPU, batch_size=1)):
        r = AtomicDistances(ag1, ag2).run(**backend)
        np.testing.assert_allclose(r.results.distances,
                                   [[1.0, 3.0], [2.0, 3.0]], atol=1e-6)
        raw = AtomicDistances(ag1, ag2, pbc=False).run(**backend)
        np.testing.assert_allclose(raw.results.distances,
                                   [[9.0, 3.0], [8.0, 3.0]], atol=1e-6)


@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("box", ["none", "ortho", "triclinic"])
def test_atomic_distances_match_jax(pbc, box):
    kw = dict(n_residues=8, n_frames=9, noise=0.4, seed=2)
    dims = None
    if box != "none":
        dims = np.tile(np.float32([12.0, 13.0, 14.0, 90, 90, 90]), (9, 1))
        if box == "triclinic":
            dims[:, 3:] = [80.0, 70.0, 100.0]
    u, ju = _boxed_pair(PORT, kw, dims), _boxed_pair(JAX, kw, dims)
    sel = ("name CA", "name CB")
    port = AtomicDistances(*(u.select_atoms(s) for s in sel), pbc=pbc).run(
        **CPU, batch_size=4)
    ref = JAtomicDistances(*(ju.select_atoms(s) for s in sel),
                           pbc=pbc).run(backend="jax", batch_size=4)
    oracle = AtomicDistances(*(u.select_atoms(s) for s in sel),
                             pbc=pbc).run(backend="serial")
    d = port.results.distances
    assert d.shape == (9, 8)
    np.testing.assert_allclose(d, np.asarray(ref.results.distances),
                               atol=1e-5)
    np.testing.assert_allclose(d, oracle.results.distances, atol=1e-4)


def test_atomic_distances_validation():
    u = _pair_universe(PORT)
    with pytest.raises(ValueError, match="atom-by-atom"):
        AtomicDistances(u.atoms[[0]], u.atoms[[1, 2]])
    with pytest.raises(ValueError, match="empty"):
        AtomicDistances(u.atoms[[]], u.atoms[[]])
    u2 = _pair_universe(PORT)
    with pytest.raises(ValueError, match="universe"):
        AtomicDistances(u.atoms[[0]], u2.atoms[[1]])
    uag = u.select_atoms("name A", updating=True)
    with pytest.raises(TypeError, match="UpdatingAtomGroup"):
        AtomicDistances(uag, u.atoms[[1]])


# ---------------- NucPairDist / WatsonCrickDist ----------------

def _dna_universe(seps, pkg=PORT, resnames=("DA", "DT")):
    """Two paired strands of len(seps) base pairs; pair i's N1-N3
    distance is seps[i] at frame 0 and seps[i]+1 at frame 1."""
    n_pairs = len(seps)
    names, rn, rid, pos0, pos1 = [], [], [], [], []
    for i in range(n_pairs):
        y = 10.0 * i
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
    top = pkg[0](names=np.array(names), resnames=np.array(rn),
                 resids=np.array(rid))
    return pkg[1](top, pkg[2](np.stack([pos0, pos1]).astype(np.float32)))


@pytest.mark.parametrize("resnames", [("DA", "DT"), ("DG", "DC"),
                                      ("RA5", "RU3")])
def test_watson_crick_matches_jax(resnames):
    seps = [2.8, 3.0, 3.2, 2.9]
    u = _dna_universe(seps, PORT, resnames)
    ju = _dna_universe(seps, JAX, resnames)
    pick = [f"resname {r}" for r in resnames]
    r = WatsonCrickDist(*(u.select_atoms(s) for s in pick)).run(
        **CPU, batch_size=1)
    j = JWatsonCrickDist(*(ju.select_atoms(s) for s in pick)).run(
        backend="jax", batch_size=1)
    want = [seps, [s + 1.0 for s in seps]]
    np.testing.assert_allclose(r.results.pair_distances, want, atol=1e-5)
    np.testing.assert_allclose(r.results.pair_distances,
                               np.asarray(j.results.pair_distances),
                               atol=1e-5)
    np.testing.assert_allclose(r.results.distances, r.results.pair_distances)
    s = WatsonCrickDist(*(u.select_atoms(s) for s in pick)).run(
        backend="serial")
    np.testing.assert_allclose(s.results.pair_distances, want, atol=1e-5)


def test_nucpairdist_generic_and_validation():
    u = _dna_universe([3.0])
    ju = _dna_universe([3.0], JAX)
    r = NucPairDist(u, [[0, 3], [1, 4]]).run(**CPU, batch_size=2)
    j = JNucPairDist(ju, [[0, 3], [1, 4]]).run(backend="jax", batch_size=2)
    assert r.results.pair_distances.shape == (2, 2)
    np.testing.assert_allclose(r.results.pair_distances,
                               np.asarray(j.results.pair_distances),
                               atol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        NucPairDist(u, [[0, 99]])
    with pytest.raises(ValueError, match="at least one"):
        NucPairDist(u, np.empty((0, 2)))
    u2 = _dna_universe([3.0, 3.0])
    with pytest.raises(ValueError, match="residue-by-residue"):
        WatsonCrickDist(u2.select_atoms("resname DA"),
                        u2.select_atoms("resname DT and resid 3"))
    with pytest.raises(TypeError, match="strand"):
        WatsonCrickDist("resname DA", u2.select_atoms("resname DT"))
    names = u.topology.names.copy()
    names[3] = "XX"                        # strand 2's N3 gone
    top = Topology(names=names, resnames=u.topology.resnames,
                   resids=u.topology.resids)
    u3 = Universe(top, MemoryReader(np.zeros((1, len(names), 3),
                                             np.float32)))
    with pytest.raises(ValueError, match="lacks atom"):
        WatsonCrickDist(u3.select_atoms("resname DA"),
                        u3.select_atoms("resname DT"))
    u4 = _dna_universe([3.0], resnames=("1MA", "DT"))
    with pytest.raises(ValueError, match="purine or pyrimidine"):
        WatsonCrickDist(u4.select_atoms("resname 1MA"),
                        u4.select_atoms("resname DT"))
