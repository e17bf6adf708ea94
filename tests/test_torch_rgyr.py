"""The port's RadiusOfGyration (``analysis/rgyr.py``): the JAX
package's tests/test_analysis.py::TestRadiusOfGyration case by case —
``backend="torch", device="cpu"`` and a two-shard CPU mesh within 1e-5
relative of the serial float64 oracle, the two-atom hand computation
within 1e-6 — and the same seeded protein through the JAX package's
``backend="jax"`` and the port within 1e-5 relative."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis import (  # noqa: E402
    RadiusOfGyration as JRadiusOfGyration)
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.analysis import RadiusOfGyration  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)


def test_backends_agree():
    u = make_protein_universe(n_residues=12, n_frames=9, seed=7)
    ag = u.select_atoms("protein")
    s = RadiusOfGyration(ag).run(backend="serial")
    j = RadiusOfGyration(ag).run(**TORCH, batch_size=4)
    m = RadiusOfGyration(ag).run(**MESH, batch_size=2)
    assert len(s.results.rgyr) == 9
    np.testing.assert_allclose(j.results.rgyr, s.results.rgyr, rtol=1e-5)
    np.testing.assert_allclose(m.results.rgyr, s.results.rgyr, rtol=1e-5)


def test_hand_computed():
    """Two atoms (masses 1 and 3) 4 Å apart → Rg = sqrt(3); second
    frame scaled ×2 → 2·sqrt(3)."""
    top = Topology(names=np.array(["X1", "X2"]),
                   resnames=np.array(["AAA", "AAA"]),
                   resids=np.array([1, 1]),
                   masses=np.array([1.0, 3.0]))
    pos = np.array([[[0.0, 0, 0], [4.0, 0, 0]],
                    [[0.0, 0, 0], [8.0, 0, 0]]], np.float32)
    u = Universe(top, pos)
    r = RadiusOfGyration(u.atoms).run(**TORCH, batch_size=2)
    np.testing.assert_allclose(
        r.results.rgyr, [np.sqrt(3.0), 2 * np.sqrt(3.0)], rtol=1e-6)


def test_matches_atomgroup_method():
    u = make_protein_universe(n_residues=6, n_frames=3, seed=8)
    ag = u.select_atoms("name CA")
    r = RadiusOfGyration(ag).run(backend="serial")
    u.trajectory[2]
    assert r.results.rgyr[2] == pytest.approx(ag.radius_of_gyration())


def test_empty_group_raises():
    u = make_protein_universe(n_residues=3, n_frames=2)
    with pytest.raises(ValueError, match="non-empty"):
        RadiusOfGyration(u.select_atoms("name ZZ")).run(backend="serial")


@pytest.mark.parametrize("kw", [TORCH, MESH], ids=["torch", "mesh"])
def test_port_matches_jax_package(kw):
    args = dict(n_residues=10, n_frames=11, noise=0.4, seed=13)
    u, ju = make_protein_universe(**args), jax_make_protein_universe(**args)
    p = RadiusOfGyration(u.select_atoms("protein")).run(**kw, batch_size=4)
    j = JRadiusOfGyration(ju.select_atoms("protein")).run(
        backend="jax", batch_size=4)
    np.testing.assert_allclose(p.results.rgyr, np.asarray(j.results.rgyr),
                               rtol=1e-5)
    assert p.results.rgyr.dtype == np.float64
