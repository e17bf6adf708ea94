"""The port's HELANAL (``analysis/helix.py``): the JAX package's
tests/test_helix.py case by case on ``backend="torch", device="cpu"``
and a two-shard CPU mesh (twists within 1e-3°, rises within 1e-4 Å of
the serial float64 oracle), and the same seeded frames through the JAX
package's ``backend="jax"`` and the port within the same bounds."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import HELANAL, helix_analysis
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


def _ideal_helix(n, twist_deg=100.0, rise=1.5, radius=2.3, phase=0.0):
    k = np.arange(n)
    t = np.radians(twist_deg) * k + phase
    return np.stack([radius * np.cos(t), radius * np.sin(t), rise * k],
                    axis=1)


def test_ideal_alpha_helix_geometry():
    r = helix_analysis(_ideal_helix(12))
    np.testing.assert_allclose(r["local_twists"], 100.0, atol=1e-8)
    np.testing.assert_allclose(r["local_rises"], 1.5, atol=1e-8)
    # the local axes all point along +z (helix axis)
    np.testing.assert_allclose(r["local_axes"][:, 2], 1.0, atol=1e-8)
    np.testing.assert_allclose(r["global_axis"], [0, 0, 1], atol=1e-8)


def test_left_handed_helix_flips_axis():
    r = helix_analysis(_ideal_helix(10, twist_deg=-100.0))
    np.testing.assert_allclose(r["local_twists"], 100.0, atol=1e-8)
    np.testing.assert_allclose(r["local_axes"][:, 2], -1.0, atol=1e-8)
    # rise measured along the (flipped) local axis
    np.testing.assert_allclose(r["local_rises"], -1.5, atol=1e-8)


def test_3_10_helix():
    # 3-10 helix: 120 deg twist, ~2.0 A rise
    r = helix_analysis(_ideal_helix(9, twist_deg=120.0, rise=2.0))
    np.testing.assert_allclose(r["local_twists"], 120.0, atol=1e-8)
    np.testing.assert_allclose(r["local_rises"], 2.0, atol=1e-8)


def test_helanal_backends_and_means():
    n, t_frames = 11, 6
    pos = np.empty((t_frames, n, 3), np.float32)
    for f in range(t_frames):
        pos[f] = _ideal_helix(n, phase=0.3 * f) + f * np.array([5.0, 0, 0])
    top = Topology(names=np.full(n, "CA"), resnames=np.full(n, "ALA"),
                   resids=np.arange(1, n + 1))
    u = Universe(top, MemoryReader(pos))
    s = HELANAL(u, select="name CA").run(backend="serial")
    assert s.results.local_twists.shape == (t_frames, n - 3)
    np.testing.assert_allclose(s.results.all_twists, 100.0, atol=1e-4)
    np.testing.assert_allclose(s.results.all_rises, 1.5, atol=1e-4)
    np.testing.assert_allclose(s.results.global_axis, [0, 0, 1],
                               atol=1e-4)
    for backend in ("jax", "mesh"):
        b = HELANAL(u, select="name CA").run(**BK[backend],
                                             batch_size=2)
        np.testing.assert_allclose(b.results.local_twists,
                                   s.results.local_twists, atol=1e-3)
        np.testing.assert_allclose(b.results.local_rises,
                                   s.results.local_rises, atol=1e-4)


def test_validation():
    with pytest.raises(ValueError, match="n>=5"):
        helix_analysis(np.zeros((4, 3)))
    top = Topology(names=np.full(4, "CA"), resnames=np.full(4, "ALA"),
                   resids=np.arange(1, 5))
    u = Universe(top, MemoryReader(np.zeros((1, 4, 3), np.float32)))
    with pytest.raises(ValueError, match=">= 5 atoms"):
        HELANAL(u, select="name CA").run(backend="serial")


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu.analysis import HELANAL as JHELANAL  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(backend):
    kw = dict(n_residues=12, n_frames=7, noise=0.3, seed=8)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    p = HELANAL(u, select="name CA").run(**BK[backend], batch_size=3)
    j = JHELANAL(ju, select="name CA").run(backend="jax", batch_size=3)
    for key, tol in (("local_twists", 1e-3), ("local_rises", 1e-4),
                     ("local_axes", 1e-4), ("all_twists", 1e-3),
                     ("all_rises", 1e-4), ("global_axis", 1e-4)):
        np.testing.assert_allclose(getattr(p.results, key),
                                   np.asarray(getattr(j.results, key)),
                                   atol=tol, err_msg=key)
