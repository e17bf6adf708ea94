"""The port's EinsteinMSD (``analysis/msd.py``): the JAX package's
tests/test_msd.py case by case on ``backend="torch", device="cpu"`` and
a two-shard CPU mesh (their tolerance: the MSD within 1e-3 relative and
1e-2 of its largest value), the device FFT (``torch_fft_msd``) against
the float64 algebra, and the same seeded random walk through the JAX
package's ``backend="jax"`` and the port within the same bounds."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import EinsteinMSD
from mdanalysis_mpi_tpu_torch.analysis.msd import _np_fft_msd, _np_windowed_msd
from mdanalysis_mpi_tpu_torch.core.topology import make_water_topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

#: the port's batch backends on the CPU: ``'torch'`` on one device and
#: the mesh over two CPU shards (the JAX package's ``'jax'`` and
#: ``'mesh'``)
TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
BK = {"jax": TORCH, "torch": TORCH, "mesh": MESH,
      "serial": dict(backend="serial")}


def _brownian_universe(n_frames=128, n_mol=40, d=0.5, seed=5):
    """Random-walk particles: MSD(m) ≈ 2*D*dims*m (unwrapped, no box)."""
    rng = np.random.default_rng(seed)
    top = make_water_topology(n_mol)
    n = top.n_atoms
    steps = rng.normal(scale=np.sqrt(2 * d), size=(n_frames, n, 3))
    pos = np.cumsum(steps, axis=0).astype(np.float32)
    return Universe(top, MemoryReader(pos))


class TestMSDAlgebra:
    def test_fft_equals_windowed(self):
        rng = np.random.default_rng(0)
        pos = rng.normal(size=(37, 5, 3))
        np.testing.assert_allclose(
            _np_fft_msd(pos)[1:], _np_windowed_msd(pos)[1:],
            rtol=1e-9, atol=1e-9)
        assert abs(_np_fft_msd(pos)[0]).max() < 1e-9   # msd(0) = 0


class TestEinsteinMSD:
    def test_serial_fft_vs_nofft(self):
        u = _brownian_universe(n_frames=48)
        a = EinsteinMSD(u, fft=True).run(backend="serial")
        b = EinsteinMSD(u, fft=False).run(backend="serial")
        np.testing.assert_allclose(a.results.timeseries,
                                   b.results.timeseries, rtol=1e-8,
                                   atol=1e-9)

    @pytest.mark.parametrize("backend", ["jax", "mesh"])
    def test_backend_parity(self, backend):
        u = _brownian_universe(n_frames=64)
        s = EinsteinMSD(u, select="name OW").run(backend="serial")
        j = EinsteinMSD(u, select="name OW").run(**BK[backend],
                                                 batch_size=16)
        np.testing.assert_allclose(
            j.results.timeseries, s.results.timeseries,
            rtol=1e-3, atol=1e-2 * float(s.results.timeseries.max()))
        assert j.results.msds_by_particle.shape == \
            s.results.msds_by_particle.shape

    def test_brownian_slope(self):
        d = 0.5
        u = _brownian_universe(n_frames=256, n_mol=80, d=d)
        r = EinsteinMSD(u).run(backend="serial")
        ts = r.results.timeseries
        lags = np.arange(len(ts))
        # fit over small lags (good statistics): slope ≈ 2*D*3
        k = 32
        slope = np.polyfit(lags[1:k], ts[1:k], 1)[0]
        assert abs(slope - 6 * d) / (6 * d) < 0.15, slope

    def test_msd_type_dims(self):
        u = _brownian_universe(n_frames=64)
        xyz = EinsteinMSD(u, msd_type="xyz").run(backend="serial")
        x = EinsteinMSD(u, msd_type="x").run(backend="serial")
        xy = EinsteinMSD(u, msd_type="xy").run(backend="serial")
        # independent dimensions: msd_xyz ≈ msd_x + msd_y + msd_z
        assert 0.2 < float(x.results.timeseries[-1]
                           / xyz.results.timeseries[-1]) < 0.5
        assert 0.5 < float(xy.results.timeseries[-1]
                           / xyz.results.timeseries[-1]) < 0.85

    def test_window_and_step(self):
        u = _brownian_universe(n_frames=64)
        r = EinsteinMSD(u).run(start=8, stop=56, step=2, **TORCH,
                               batch_size=8)
        assert r.results.timeseries.shape == (24,)

    def test_guards(self):
        u = _brownian_universe(n_frames=8)
        with pytest.raises(ValueError, match="msd_type"):
            EinsteinMSD(u, msd_type="zz")
        with pytest.raises(ValueError, match="at least 2"):
            EinsteinMSD(u).run(stop=1, backend="serial")
        with pytest.raises(ValueError, match="no atoms"):
            EinsteinMSD(u, select="name XX").run(backend="serial")
        with pytest.raises(ValueError, match="fft"):
            EinsteinMSD(u, fft=False).run(**TORCH, batch_size=4)


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu.analysis import EinsteinMSD as JEinsteinMSD  # noqa: E402
from mdanalysis_mpi_tpu.core.topology import (  # noqa: E402
    make_water_topology as jax_make_water_topology)
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402

torch.set_num_threads(1)


def test_device_fft_matches_float64_algebra():
    """``torch_fft_msd`` (float64 here) equals the NumPy FFT route, and
    the direct windowed sum."""
    from mdanalysis_mpi_tpu_torch.analysis.msd import torch_fft_msd

    rng = np.random.default_rng(0)
    pos = rng.normal(size=(37, 5, 3))
    got = torch_fft_msd(torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, _np_fft_msd(pos), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got[1:], _np_windowed_msd(pos)[1:],
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(backend):
    rng = np.random.default_rng(11)
    steps = rng.normal(scale=1.0, size=(40, 90, 3))
    pos = np.cumsum(steps, axis=0).astype(np.float32)
    u = Universe(make_water_topology(30), MemoryReader(pos))
    ju = JUniverse(jax_make_water_topology(30), JMemoryReader(pos))
    p = EinsteinMSD(u, select="name OW", msd_type="xy").run(
        **BK[backend], batch_size=16)
    j = JEinsteinMSD(ju, select="name OW", msd_type="xy").run(
        backend="jax", batch_size=16)
    jt = np.asarray(j.results.timeseries)
    np.testing.assert_allclose(p.results.timeseries, jt, rtol=1e-3,
                               atol=1e-2 * float(jt.max()))
    np.testing.assert_allclose(
        p.results.msds_by_particle, np.asarray(j.results.msds_by_particle),
        rtol=1e-3, atol=1e-2 * float(jt.max()))


def test_device_fft_holds_at_box_coordinates():
    """Particles diffusing 0.1 Å a step about positions up to 100 Å from
    the origin (a water box's absolute coordinates): the float32 FFT
    route stays within test_msd.py's bounds of the float64 oracle (each
    particle's mean position comes off before the lag algebra)."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0.0, 100.0, size=(1, 300, 3))
    pos = (base + np.cumsum(rng.normal(scale=0.1, size=(64, 300, 3)),
                            axis=0)).astype(np.float32)
    u = Universe(make_water_topology(100), MemoryReader(pos))
    s = EinsteinMSD(u).run(backend="serial")
    d = EinsteinMSD(u).run(**TORCH, batch_size=16)
    w = s.results.timeseries
    np.testing.assert_allclose(d.results.timeseries, w, rtol=1e-3,
                               atol=1e-2 * float(w.max()))
