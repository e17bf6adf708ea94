"""The port's DielectricConstant (``analysis/dielectric.py``): the JAX
package's tests/test_dielectric.py case by case with ``backend="torch",
device="cpu"`` and a two-shard CPU mesh for its ``'jax'`` and ``'mesh'``
(their tolerance: eps_mean within 1e-3 relative of serial), the mesh's
merge of the volume sums, and the same charged box through the JAX
package's ``backend="jax"`` and ``"mesh"`` and the port."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import DielectricConstant
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.testing import make_water_universe

TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)


def _charged_waters(n_frames=16, seed=2):
    u = make_water_universe(n_waters=30, n_frames=n_frames, box=12.0,
                            seed=seed)
    u.add_TopologyAttr("charges", np.tile([-0.834, 0.417, 0.417], 30))
    return u                 # bondless fixture: make_whole not required


def test_hand_computed_two_frame_fluctuation():
    """Two frames with dipoles (d, 0, 0) and (-d, 0, 0): <M> = 0 and
    fluct = d², so eps follows the closed-form prefactor."""
    top = Topology(names=np.array(["A", "B"]),
                   resnames=np.array(["ION"] * 2),
                   resids=np.array([1, 2]),
                   charges=np.array([1.0, -1.0]))
    d = 2.0
    pos = np.array([[[d, 0, 0], [0.0, 0, 0]],
                    [[0.0, 0, 0], [d, 0, 0]]], np.float32)
    dims = np.array([10.0, 10, 10, 90, 90, 90], np.float32)
    u = Universe(top, MemoryReader(pos, dimensions=dims))
    r = DielectricConstant(u.atoms, temperature=300.0).run(
        backend="serial")
    np.testing.assert_allclose(r.results.M, [0.0, 0.0, 0.0], atol=1e-12)
    # per-axis results (upstream layout): all fluctuation is along x
    np.testing.assert_allclose(r.results.fluct, [d * d, 0.0, 0.0],
                               rtol=1e-12, atol=1e-12)
    pref = 4 * np.pi * 167100.9972 / (1000.0 * 300.0)
    np.testing.assert_allclose(r.results.eps,
                               [1.0 + pref * d * d, 1.0, 1.0], rtol=1e-9)
    np.testing.assert_allclose(r.results.eps_mean,
                               1.0 + pref * d * d / 3.0, rtol=1e-9)
    np.testing.assert_allclose(r.results.M2, [d * d, 0.0, 0.0],
                               atol=1e-12)


def test_backend_parity():
    u = _charged_waters()
    s = DielectricConstant(u.atoms).run(backend="serial")
    j = DielectricConstant(u.atoms).run(**TORCH, batch_size=4)
    np.testing.assert_allclose(float(j.results.eps_mean),
                               s.results.eps_mean, rtol=1e-3)
    m = DielectricConstant(u.atoms).run(**MESH, batch_size=2)
    np.testing.assert_allclose(float(m.results.eps_mean),
                               s.results.eps_mean, rtol=1e-3)
    assert s.results.eps_mean > 1.0         # fluctuations only add


def test_validation():
    u = _charged_waters()
    with pytest.raises(ValueError, match="temperature"):
        DielectricConstant(u.atoms, temperature=0.0)
    # net-charged selection: origin-dependent dipole is a hard error
    with pytest.raises(ValueError, match="net charge"):
        DielectricConstant(u.select_atoms("name OW")).run(
            backend="serial")
    u2 = make_water_universe(n_waters=4, n_frames=1)
    with pytest.raises(ValueError, match="charges"):
        DielectricConstant(u2.atoms).run(backend="serial")
    boxless = Universe(u.topology, MemoryReader(
        np.zeros((1, u.topology.n_atoms, 3), np.float32)))
    with pytest.raises(ValueError, match="box"):
        DielectricConstant(boxless.atoms).run(backend="serial")


def test_make_whole_contract():
    """Bonded topology + make_whole=True requires the all-backend
    unwrap transformation; attaching it (or opting out) proceeds."""
    from mdanalysis_mpi_tpu_torch import transformations as trf

    u = _charged_waters()
    u.atoms.guess_bonds()
    with pytest.raises(ValueError, match="unwrap"):
        DielectricConstant(u.atoms).run(backend="serial")
    ok = DielectricConstant(u.atoms, make_whole=False).run(
        backend="serial")
    assert float(ok.results.eps_mean) > 1.0
    u2 = _charged_waters(seed=5)
    u2.atoms.guess_bonds()
    u2.trajectory.add_transformations(trf.unwrap(u2.atoms))
    ok2 = DielectricConstant(u2.atoms).run(backend="serial")
    assert float(ok2.results.eps_mean) > 1.0


@pytest.mark.parametrize("run", [TORCH, MESH,
                                 dict(backend="mesh", devices=["cpu"] * 3)],
                         ids=["torch", "mesh2", "mesh3"])
def test_every_result_against_serial(run):
    """All six results, on a batch size that leaves a padded tail: the
    moments within 1e-3 relative, the mean volume (a sum of float32
    volumes) within 1e-5."""
    u = _charged_waters(n_frames=13, seed=7)
    s = DielectricConstant(u.atoms).run(backend="serial").results
    d = DielectricConstant(u.atoms).run(**run, batch_size=2).results
    for key in ("fluct", "eps", "M2"):
        np.testing.assert_allclose(getattr(d, key), getattr(s, key),
                                   rtol=1e-3)
    np.testing.assert_allclose(d.M, s.M, atol=1e-3 * np.abs(s.M).max())
    np.testing.assert_allclose(d.volume, s.volume, rtol=1e-5)
    np.testing.assert_allclose(d.eps_mean, s.eps_mean, rtol=1e-3)


def test_psum_merges_every_leaf():
    """The mesh's merge of per-device partials: the moments by the law
    of total variance, the volume sum and the boxed count by addition
    (the JAX package's psum of the last two leaves)."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis.dielectric import (
        _dielectric_kernel, _dielectric_psum)

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(6, 5, 3)), dtype=torch.float32)
    boxes = torch.tensor([[10.0, 11.0, 12.0, 90.0, 90.0, 90.0]] * 6)
    q = torch.tensor([1.0, -0.5, -0.5, 0.3, -0.3])
    whole = _dielectric_kernel((q,), x, boxes, torch.ones(6))
    parts = [_dielectric_kernel((q,), x[:2], boxes[:2], torch.ones(2)),
             _dielectric_kernel((q,), x[2:], boxes[2:], torch.ones(4))]
    merged = _dielectric_psum(parts)
    for a, b in zip(merged, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


class TestAgainstJaxPackage:
    @pytest.mark.parametrize("backend", ["jax", "mesh"])
    def test_eps(self, backend):
        from mdanalysis_mpi_tpu.analysis import (
            DielectricConstant as JDielectric)
        from mdanalysis_mpi_tpu.testing import make_water_universe as jm

        uj = jm(n_waters=30, n_frames=16, box=12.0, seed=2)
        uj.add_TopologyAttr("charges", np.tile([-0.834, 0.417, 0.417], 30))
        ut = _charged_waters()
        j = JDielectric(uj.atoms).run(backend=backend,
                                      batch_size=4).results
        t = DielectricConstant(ut.atoms).run(
            **(TORCH if backend == "jax" else MESH), batch_size=4).results
        # both float32 Chan moments of the same dipoles: far inside the
        # 1e-3 relative gate of each to serial
        np.testing.assert_allclose(t.eps, j.eps, rtol=1e-4)
        np.testing.assert_allclose(t.eps_mean, j.eps_mean, rtol=1e-4)
        np.testing.assert_allclose(t.volume, j.volume, rtol=1e-6)
