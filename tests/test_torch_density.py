"""The port's DensityAnalysis and Density (``analysis/density.py``):
the JAX package's tests/test_density.py case by case on
``backend="torch", device="cpu"`` and a two-shard CPU mesh (int32
counts: the total exact, the grid equal to the serial oracle's), and
the same seeded waters through the JAX package's ``backend="jax"`` and
the port: the same grid layout and counts equal."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis.density import DensityAnalysis
from mdanalysis_mpi_tpu_torch.core.topology import make_water_topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.testing import make_water_universe

#: the port's batch backends on the CPU: ``'torch'`` on one device and
#: the mesh over two CPU shards (the JAX package's ``'jax'`` and
#: ``'mesh'``)
TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
BK = {"jax": TORCH, "torch": TORCH, "mesh": MESH,
      "serial": dict(backend="serial")}


class TestDensity:
    def test_counts_conserved(self):
        u = make_water_universe(n_waters=30, n_frames=8, box=20.0)
        ow = u.select_atoms("name OW")
        r = DensityAnalysis(ow, delta=2.0).run(backend="serial")
        # every OW is somewhere: mean counts + outside == n_atoms
        total = r.results.grid.sum() + r.results.n_outside
        np.testing.assert_allclose(total, ow.n_atoms, rtol=1e-12)

    @pytest.mark.parametrize("backend", ["jax", "mesh"])
    def test_backend_parity(self, backend):
        u = make_water_universe(n_waters=40, n_frames=12, box=18.0)
        ow = u.select_atoms("name OW")
        s = DensityAnalysis(ow, delta=1.5).run(backend="serial")
        j = DensityAnalysis(ow, delta=1.5).run(**BK[backend],
                                               batch_size=4)
        np.testing.assert_allclose(j.results.grid, s.results.grid,
                                   atol=1e-4)
        np.testing.assert_allclose(j.results.n_outside,
                                   s.results.n_outside, atol=1e-4)

    def test_explicit_grid_and_outside(self):
        top = make_water_topology(2)
        pos = np.zeros((4, 6, 3), np.float32)
        pos[:, 0] = [5.0, 5.0, 5.0]       # OW inside
        pos[:, 3] = [50.0, 50.0, 50.0]    # OW far outside
        u = Universe(top, MemoryReader(pos))
        ow = u.select_atoms("name OW")
        r = DensityAnalysis(ow, delta=1.0, gridcenter=[5.0, 5.0, 5.0],
                            xdim=10, ydim=10, zdim=10).run(**TORCH,
                                                           batch_size=2)
        assert r.results.grid.shape == (10, 10, 10)
        assert r.results.n_outside == 1.0
        np.testing.assert_allclose(r.results.grid.sum(), 1.0)
        # the occupied voxel is the grid center
        assert r.results.grid[5, 5, 5] == 1.0
        # density normalization: counts / delta^3
        np.testing.assert_allclose(r.results.density.sum(), 1.0)

    def test_density_normalization(self):
        u = make_water_universe(n_waters=20, n_frames=4, box=16.0)
        ow = u.select_atoms("name OW")
        r = DensityAnalysis(ow, delta=2.0).run(backend="serial")
        np.testing.assert_allclose(r.results.density,
                                   r.results.grid / 8.0)
        edges = r.results.edges
        assert len(edges) == 3
        assert all(len(e) == s + 1
                   for e, s in zip(edges, r.results.grid.shape))

    def test_grid_stays_centered_with_nondivisible_dims(self):
        """xdim=10, delta=3 -> 4 voxels spanning [-6, 6) around the
        center, not [-5, 7)."""
        top = make_water_topology(1)
        pos = np.zeros((1, 3, 3), np.float32)
        u = Universe(top, MemoryReader(pos))
        r = DensityAnalysis(u.select_atoms("name OW"), delta=3.0,
                            gridcenter=[0.0, 0.0, 0.0],
                            xdim=10, ydim=10, zdim=10).run(backend="serial")
        for e in r.results.edges:
            np.testing.assert_allclose(e[0], -6.0)
            np.testing.assert_allclose(e[-1], 6.0)

    def test_validation(self):
        u = make_water_universe(n_waters=5, n_frames=2)
        ow = u.select_atoms("name OW")
        with pytest.raises(ValueError, match="delta"):
            DensityAnalysis(ow, delta=0.0)
        with pytest.raises(ValueError, match="xdim"):
            DensityAnalysis(ow, gridcenter=[0, 0, 0])
        with pytest.raises(ValueError, match="voxels"):
            DensityAnalysis(ow, delta=0.01).run(stop=1, backend="serial")
        with pytest.raises(ValueError, match="gridcenter"):
            DensityAnalysis(ow, xdim=10, ydim=10, zdim=10)


class TestDensityObject:
    def _density(self):
        from mdanalysis_mpi_tpu_torch.analysis.density import Density
        grid = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
        edges = [np.arange(3) * 2.0, np.arange(4) * 2.0,
                 np.arange(5) * 2.0]
        return Density(grid, edges)

    def test_convert_density_round_trip(self):
        from mdanalysis_mpi_tpu_torch import units
        d = self._density()
        raw = d.grid.copy()
        d.convert_density("Molar")
        factor = units.get_conversion_factor("density", "A^{-3}",
                                             "Molar")
        np.testing.assert_allclose(d.grid, raw * factor)
        assert d.units["density"] == "Molar"
        d.convert_density("A^{-3}")
        np.testing.assert_allclose(d.grid, raw, rtol=1e-12)

    def test_dx_export_import_round_trip(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.analysis.density import Density
        d = self._density()
        p = str(tmp_path / "rho.dx")
        d.export(p)
        back = Density.from_dx(p)
        np.testing.assert_allclose(back.grid, d.grid, rtol=1e-9)
        for a, b in zip(back.edges, d.edges):
            np.testing.assert_allclose(a, b, atol=1e-6)

    def test_dx_header_structure(self, tmp_path):
        d = self._density()
        p = str(tmp_path / "rho.dx")
        d.export(p)
        text = open(p).read()
        assert "object 1 class gridpositions counts 2 3 4" in text
        # the DX origin is the first voxel CENTER (edge 0 + delta/2 =
        # 1.0 for these delta-2 edges) — the gridData/APBS/VMD
        # convention; an edge-origin here would misregister maps by
        # half a voxel in external viewers
        assert "origin 1 1 1" in text
        assert "delta 2 0 0" in text
        assert 'component "data" value 3' in text

    def test_analysis_results_density_object(self):
        from mdanalysis_mpi_tpu_torch.analysis.density import Density
        u = make_water_universe(n_waters=27, n_frames=2, box=9.3)
        a = DensityAnalysis(u.select_atoms("name OW"),
                            delta=3.0).run(**TORCH)
        obj = a.results.density_object
        assert isinstance(obj, Density)
        np.testing.assert_allclose(obj.grid,
                                   np.asarray(a.results.density))
        # conversion does not corrupt the separate plain ndarray
        before = np.asarray(a.results.density).copy()
        obj.convert_density("nm^{-3}")
        assert obj.units["density"] == "nm^{-3}"
        np.testing.assert_array_equal(np.asarray(a.results.density),
                                      before)
        with pytest.raises(ValueError, match="unknown density unit"):
            obj.convert_density("bogus")

    def test_validation(self):
        from mdanalysis_mpi_tpu_torch.analysis.density import Density
        with pytest.raises(ValueError, match="3-D"):
            Density(np.zeros((2, 2)), [np.arange(3)] * 3)
        with pytest.raises(ValueError, match="edges"):
            Density(np.zeros((2, 2, 2)), [np.arange(2)] * 3)
        d = self._density()
        with pytest.raises(ValueError, match="DX"):
            d.export("/tmp/x.cube", type="CUBE")

    def test_from_dx_rejects_sheared_grid(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.analysis.density import Density
        d = self._density()
        p = str(tmp_path / "rho.dx")
        d.export(p)
        text = open(p).read().replace("delta 0 2 0",
                                      "delta 0.7 2 0")
        open(p, "w").write(text)
        with pytest.raises(ValueError, match="off-axis"):
            Density.from_dx(p)


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu.analysis import DensityAnalysis as JDensityAnalysis  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_water_universe as jax_make_water_universe)

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(backend):
    kw = dict(n_waters=60, n_frames=10, box=16.0, seed=4)
    u, ju = make_water_universe(**kw), jax_make_water_universe(**kw)
    p = DensityAnalysis(u.select_atoms("name OW"), delta=1.25).run(
        **BK[backend], batch_size=4)
    j = JDensityAnalysis(ju.select_atoms("name OW"), delta=1.25).run(
        backend="jax", batch_size=4)
    np.testing.assert_array_equal(p.results.origin, j.results.origin)
    np.testing.assert_array_equal(p.results.grid, j.results.grid)
    np.testing.assert_array_equal(p.results.n_outside, j.results.n_outside)
    t, counts = p._last_total
    assert counts.dtype == torch.int32 and t.dtype == torch.int32
    assert int(counts.sum()) == 10 * 60


def test_counts_are_integers_and_repeat_equal():
    u = make_water_universe(n_waters=50, n_frames=9, box=15.0, seed=1)
    ow = u.select_atoms("name OW")
    a = DensityAnalysis(ow, delta=1.0).run(**TORCH, batch_size=4)
    b = DensityAnalysis(ow, delta=1.0).run(**TORCH, batch_size=4)
    assert torch.equal(a._last_total[1], b._last_total[1])
    s = DensityAnalysis(ow, delta=1.0).run(backend="serial")
    np.testing.assert_array_equal(a.results.grid * 9, s.results.grid * 9)
