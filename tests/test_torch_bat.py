"""The port's BAT (``analysis/bat.py``): the JAX package's
tests/test_bat.py case by case on ``backend="torch", device="cpu"`` and
a two-shard CPU mesh (within 1e-4 of the serial float64 oracle; the
Cartesian round trip within 1e-6 Å), and the same seeded molecule
through the JAX package's ``backend="jax"`` and the port: the same
torsion tree and BAT vectors within 1e-4."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import BAT
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

#: the port's batch backends on the CPU: ``'torch'`` on one device and
#: the mesh over two CPU shards (the JAX package's ``'jax'`` and
#: ``'mesh'``)
TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
BK = {"jax": TORCH, "torch": TORCH, "mesh": MESH,
      "serial": dict(backend="serial")}


def _mol(n_frames=3, bonds=((0, 1), (1, 2), (2, 3), (2, 4)), n=5,
         seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=2.0, size=(n_frames, n, 3)).astype(np.float32)
    top = Topology(names=np.array([f"C{i}" for i in range(n)]),
                   resnames=np.full(n, "MOL"), resids=np.full(n, 1),
                   bonds=np.asarray(bonds))
    return Universe(top, MemoryReader(pos)), pos


def test_round_trip_exact_branched():
    u, pos = _mol()
    b = BAT(u.atoms)
    r = b.run(backend="serial")
    assert r.results.bat.shape == (3, 15)          # 3N = 15
    for f in range(3):
        rec = b.Cartesian(r.results.bat[f])
        np.testing.assert_allclose(rec, pos[f].astype(np.float64),
                                   atol=1e-6)      # f32 input precision


def test_round_trip_with_ring():
    # cyclopentane-like ring + a tail: the ring-closing bond is not a
    # tree edge but reconstruction must still be exact
    bonds = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (0, 5)]
    u, pos = _mol(bonds=bonds, n=6, seed=1)
    b = BAT(u.atoms)
    r = b.run(backend="serial")
    rec = b.Cartesian(r.results.bat[0])
    np.testing.assert_allclose(rec, pos[0].astype(np.float64), atol=1e-6)


def test_rigid_motion_changes_only_external():
    """A rotated+translated copy keeps every internal coordinate,
    changing only the 6 external ones."""
    from mdanalysis_mpi_tpu_torch.testing import random_rotation_matrices

    u, pos = _mol(n_frames=1)
    rng = np.random.default_rng(7)
    rot = random_rotation_matrices(1, rng)[0]
    moved = (pos[0] @ rot.T + np.array([3.0, -2.0, 5.0])).astype(
        np.float32)
    u2 = Universe(u.topology, MemoryReader(moved[None]))
    b1 = BAT(u.atoms).run(backend="serial").results.bat[0]
    b2 = BAT(u2.atoms).run(backend="serial").results.bat[0]
    np.testing.assert_allclose(b2[9:], b1[9:], atol=1e-5)   # internals
    np.testing.assert_allclose(b2[6:9], b1[6:9], atol=1e-5)  # r01,r12,a012
    assert np.abs(b2[:6] - b1[:6]).max() > 0.1               # externals


def test_backend_parity():
    u, _ = _mol(n_frames=8, seed=3)
    s = BAT(u.atoms).run(backend="serial")
    j = BAT(u.atoms).run(**TORCH, batch_size=4)
    np.testing.assert_allclose(j.results.bat, s.results.bat, atol=1e-4)
    m = BAT(u.atoms).run(**MESH, batch_size=2)
    np.testing.assert_allclose(m.results.bat, s.results.bat, atol=1e-4)


def test_initial_atom_and_validation():
    u, pos = _mol()
    b = BAT(u.atoms, initial_atom=3)
    assert b._root_global[0] == 3
    r = b.run(backend="serial")
    np.testing.assert_allclose(b.Cartesian(r.results.bat[0]),
                               pos[0].astype(np.float64), atol=1e-6)
    with pytest.raises(ValueError, match="not in the group"):
        BAT(u.atoms, initial_atom=99)
    with pytest.raises(ValueError, match="BAT vector"):
        b.Cartesian(np.zeros(7))
    # disconnected group
    bonds = [(0, 1), (1, 2), (3, 4)]
    ud, _ = _mol(bonds=bonds, n=5)
    with pytest.raises(ValueError, match="connected"):
        BAT(ud.atoms)
    # no bonds at all
    top = Topology(names=np.array(["A", "B", "C"]),
                   resnames=np.full(3, "X"), resids=np.full(3, 1))
    un = Universe(top, MemoryReader(np.zeros((1, 3, 3), np.float32)))
    with pytest.raises(ValueError, match="bonds"):
        BAT(un.atoms)
    with pytest.raises(TypeError, match="UpdatingAtomGroup"):
        BAT(u.select_atoms("name C1", updating=True))


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu.analysis import BAT as JBAT  # noqa: E402
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(backend):
    bonds = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (0, 5), (5, 6),
             (2, 7)]
    u, pos = _mol(n_frames=9, bonds=bonds, n=8, seed=4)
    top = u.topology
    ju = JUniverse(JTopology(names=top.names, resnames=top.resnames,
                             resids=top.resids, bonds=np.asarray(bonds)),
                   JMemoryReader(pos))
    p, j = BAT(u.atoms), JBAT(ju.atoms)
    np.testing.assert_array_equal(p._root_global, j._root_global)
    np.testing.assert_array_equal(p._quads_global, j._quads_global)
    p.run(**BK[backend], batch_size=4)
    j.run(backend="jax", batch_size=4)
    np.testing.assert_allclose(p.results.bat, np.asarray(j.results.bat),
                               atol=1e-4)
    np.testing.assert_allclose(p.Cartesian(p.results.bat[2]),
                               j.Cartesian(np.asarray(j.results.bat)[2]),
                               atol=1e-3)
