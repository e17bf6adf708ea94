"""The port's PersistenceLength (``analysis/polymer.py``): the JAX
package's tests/test_polymer.py case by case on ``backend="torch",
device="cpu"`` and a two-shard CPU mesh (the autocorrelation within
1e-4 of the serial float64 oracle), and the same seeded chains through
the JAX package's ``backend="jax"`` and the port within 1e-4 (``lb``,
``lp`` within 1e-4 relative)."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import PersistenceLength
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


def _chain_universe(frames):
    """frames: (T, N, 3) — one chain of N atoms in file order."""
    n = frames.shape[1]
    top = Topology(names=np.full(n, "C"), resnames=np.full(n, "POL"),
                   resids=np.arange(1, n + 1))
    return Universe(top, MemoryReader(frames.astype(np.float32)))


def test_rigid_rod():
    """A straight rod: every bond vector identical -> C(n) = 1."""
    n = 12
    pos = np.zeros((3, n, 3))
    pos[:, :, 0] = np.arange(n) * 1.5
    u = _chain_universe(pos)
    r = PersistenceLength([u.atoms]).run(backend="serial")
    np.testing.assert_allclose(r.results.bond_autocorrelation, 1.0,
                               atol=1e-12)
    assert r.results.lb == pytest.approx(1.5)
    assert r.results.lp == np.inf or r.results.lp > 1e6


def test_right_angle_chain():
    """A zigzag with 90-degree turns: C(1) = 0 exactly; C(2) = 1
    (every second bond parallel)."""
    # bonds alternate +x, +y, +x, +y, ...
    steps = np.array([[1.0, 0, 0], [0, 1.0, 0]] * 5)
    pos = np.concatenate([np.zeros((1, 3)), np.cumsum(steps, axis=0)])
    u = _chain_universe(pos[None])
    r = PersistenceLength([u.atoms]).run(backend="serial")
    c = r.results.bond_autocorrelation
    assert c[0] == pytest.approx(1.0)
    assert c[1] == pytest.approx(0.0, abs=1e-12)
    assert c[2] == pytest.approx(1.0)


def test_backend_parity_multi_chain():
    rng = np.random.default_rng(41)
    t, nchains, length = 10, 4, 9
    pos = np.cumsum(rng.normal(scale=1.0, size=(t, nchains * length, 3)),
                    axis=1)
    u = _chain_universe(pos)
    chains = [u.atoms[i * length:(i + 1) * length] for i in range(nchains)]
    s = PersistenceLength(chains).run(backend="serial")
    j = PersistenceLength(chains).run(**TORCH, batch_size=4)
    np.testing.assert_allclose(j.results.bond_autocorrelation,
                               s.results.bond_autocorrelation, atol=1e-5)
    assert j.results.lb == pytest.approx(s.results.lb, rel=1e-5)
    m = PersistenceLength(chains).run(**MESH, batch_size=2)
    np.testing.assert_allclose(m.results.bond_autocorrelation,
                               s.results.bond_autocorrelation, atol=1e-5)


def test_known_decay_recovers_lp():
    """A worm-like chain sampled with per-bond angular diffusion: the
    fitted lp should be near the construction value lb/(1-<cos>)."""
    rng = np.random.default_rng(42)
    t, length, lb = 60, 40, 1.0
    kappa = 0.3                      # per-step angular noise
    pos = np.zeros((t, length, 3))
    for f in range(t):
        d = np.array([1.0, 0.0, 0.0])
        pts = [np.zeros(3)]
        for _ in range(length - 1):
            d = d + rng.normal(scale=kappa, size=3)
            d /= np.linalg.norm(d)
            pts.append(pts[-1] + lb * d)
        pos[f] = pts
    u = _chain_universe(pos)
    r = PersistenceLength([u.atoms]).run(backend="serial")
    c = r.results.bond_autocorrelation
    # C decays roughly geometrically; fitted lp within a factor ~2 of
    # the discrete estimate -lb/ln(C(1))
    lp_expected = -lb / np.log(c[1])
    assert 0.5 * lp_expected < r.results.lp < 2.0 * lp_expected


def test_validation():
    u = _chain_universe(np.zeros((2, 6, 3)))
    with pytest.raises(ValueError, match="at least one"):
        PersistenceLength([])
    with pytest.raises(ValueError, match="lengths"):
        PersistenceLength([u.atoms[:4], u.atoms[:5]])
    with pytest.raises(ValueError, match="3 atoms"):
        PersistenceLength([u.atoms[:2]])
    uag = u.select_atoms("name C", updating=True)
    with pytest.raises(TypeError, match="UpdatingAtomGroup"):
        PersistenceLength([uag])


def test_minimum_image_bonds():
    """A chain crossing the periodic boundary (atom-wrapped) must give
    the same lb/C(n) as its unwrapped image."""
    box = 10.0
    dims = np.array([box, box, box, 90.0, 90.0, 90.0], np.float32)
    n = 8
    un = np.zeros((2, n, 3))
    un[:, :, 0] = 7.0 + np.arange(n) * 1.5          # crosses x boundary
    wrapped = un % box
    top = Topology(names=np.full(n, "C"), resnames=np.full(n, "POL"),
                   resids=np.arange(1, n + 1))
    uu = Universe(top, MemoryReader(un.astype(np.float32),
                                    dimensions=dims))
    uw = Universe(top, MemoryReader(wrapped.astype(np.float32),
                                    dimensions=dims))
    for backend in ("serial", "jax"):
        ru = PersistenceLength([uu.atoms]).run(**BK[backend],
                                               batch_size=2)
        rw = PersistenceLength([uw.atoms]).run(**BK[backend],
                                               batch_size=2)
        assert rw.results.lb == pytest.approx(ru.results.lb, rel=1e-5)
        assert rw.results.lb == pytest.approx(1.5, rel=1e-5)
        np.testing.assert_allclose(rw.results.bond_autocorrelation,
                                   ru.results.bond_autocorrelation,
                                   atol=1e-5)


def test_no_exponential_regime_refuses_fit():
    """C(1) = 0 (right-angle zigzag): the autocorrelation is readable,
    the FIT raises instead of reporting lp=inf."""
    steps = np.array([[1.0, 0, 0], [0, 1.0, 0]] * 5)
    pos = np.concatenate([np.zeros((1, 3)), np.cumsum(steps, axis=0)])
    u = _chain_universe(pos[None])
    r = PersistenceLength([u.atoms]).run(backend="serial")
    assert r.results.bond_autocorrelation[1] == pytest.approx(0.0,
                                                              abs=1e-12)
    with pytest.raises(ValueError, match="not positive at lag 1"):
        _ = r.results.lp


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu.analysis import (  # noqa: E402
    PersistenceLength as JPersistenceLength)
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("boxed", [False, True])
@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(boxed, backend):
    """Four worm-like chains of 12 beads (a persistent random walk),
    with and without a box the chains cross."""
    rng = np.random.default_rng(21)
    n_ch, n_b, t = 4, 12, 6
    steps = np.empty((t, n_ch, n_b - 1, 3))
    d = rng.normal(size=(t, n_ch, 3))
    for k in range(n_b - 1):
        d = d + 0.6 * rng.normal(size=d.shape)
        steps[:, :, k] = 1.5 * d / np.linalg.norm(d, axis=-1,
                                                  keepdims=True)
    pos = np.concatenate([np.zeros((t, n_ch, 1, 3)),
                          np.cumsum(steps, axis=2)], axis=2)
    pos = (pos + 10.0 * np.arange(n_ch)[None, :, None, None])
    pos = pos.reshape(t, n_ch * n_b, 3).astype(np.float32)
    dims = None
    if boxed:
        dims = np.array([20.0, 20.0, 20.0, 90, 90, 90], np.float32)
        pos = np.mod(pos, 20.0).astype(np.float32)
    n = n_ch * n_b
    names, resn, resi = np.full(n, "C"), np.full(n, "POL"), np.arange(1, n + 1)
    u = Universe(Topology(names=names, resnames=resn, resids=resi),
                 MemoryReader(pos, dimensions=dims))
    ju = JUniverse(JTopology(names=names, resnames=resn, resids=resi),
                   JMemoryReader(pos, dimensions=dims))
    idx = np.arange(n).reshape(n_ch, n_b)
    p = PersistenceLength([u.atoms[i] for i in idx]).run(
        **BK[backend], batch_size=4)
    j = JPersistenceLength([ju.atoms[i] for i in idx]).run(
        backend="jax", batch_size=4)
    np.testing.assert_allclose(p.results.bond_autocorrelation,
                               j.results.bond_autocorrelation, atol=1e-4)
    assert p.results.lb == pytest.approx(j.results.lb, rel=1e-4)
    assert p.results.lp == pytest.approx(j.results.lp, rel=1e-4)
