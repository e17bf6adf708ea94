"""The port's VelocityAutocorr (``analysis/vacf.py``): the JAX
package's tests/test_vacf.py case by case with ``backend="torch",
device="cpu"`` for its ``'jax'`` (their tolerances: FFT against
windowed 1e-9, the device route against serial 1e-3), the float32 device
FFT (``torch_fft_vacf``) at box-scale velocities, and the same
velocities through the JAX package's ``backend="jax"`` and the port."""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.analysis.vacf import (
    VelocityAutocorr, _np_fft_vacf, _np_windowed_vacf, torch_fft_vacf)
from mdanalysis_mpi_tpu_torch.core.topology import make_water_topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

TORCH = dict(backend="torch", device="cpu")


def _vel_universe(n_frames=32, n_mol=10, seed=2, vels=None):
    rng = np.random.default_rng(seed)
    top = make_water_topology(n_mol)
    n = top.n_atoms
    pos = rng.normal(size=(n_frames, n, 3)).astype(np.float32)
    if vels is None:
        vels = rng.normal(size=(n_frames, n, 3)).astype(np.float32)
    return Universe(top, MemoryReader(pos, velocities=vels))


class TestAlgebra:
    def test_fft_equals_windowed(self):
        rng = np.random.default_rng(1)
        v = rng.normal(size=(25, 4, 3))
        np.testing.assert_allclose(_np_fft_vacf(v), _np_windowed_vacf(v),
                                   rtol=1e-9, atol=1e-9)


class TestVACF:
    def test_constant_velocity_is_flat(self):
        n_frames, n_mol = 16, 5
        vels = np.ones((n_frames, 3 * n_mol, 3), np.float32) * 2.0
        u = _vel_universe(n_frames, n_mol, vels=vels)
        r = VelocityAutocorr(u.atoms).run(backend="serial")
        # C(tau) == |v|^2 == 12 for every lag
        np.testing.assert_allclose(r.results.timeseries, 12.0, atol=1e-4)

    def test_white_noise_decorrelates(self):
        u = _vel_universe(n_frames=64, n_mol=30)
        r = VelocityAutocorr(u.atoms).run(backend="serial")
        ts = r.results.timeseries
        assert ts[0] == pytest.approx(3.0, rel=0.1)      # <|v|^2>, unit var
        assert abs(ts[1:16].mean()) < 0.1 * ts[0]        # no memory

    def test_torch_matches_serial(self):
        u = _vel_universe(n_frames=48, n_mol=8)
        a = VelocityAutocorr(u.atoms).run(**TORCH)
        s = VelocityAutocorr(u.atoms).run(backend="serial")
        np.testing.assert_allclose(a.results.timeseries,
                                   s.results.timeseries, atol=1e-3)
        b = VelocityAutocorr(u.atoms, fft=False).run(backend="serial")
        np.testing.assert_allclose(b.results.timeseries,
                                   s.results.timeseries, atol=1e-9)

    def test_trr_velocities_end_to_end(self, tmp_path):
        """The JAX test's route: the velocities written to a TRR by
        ``write_trr`` and read back through ``TRRReader``."""
        from mdanalysis_mpi_tpu_torch.io.trr import TRRReader, write_trr

        u0 = _vel_universe(n_frames=12, n_mol=4)
        pos, _ = u0.trajectory.read_block(0, 12)
        vels = np.stack([u0.trajectory[i].velocities for i in range(12)])
        path = str(tmp_path / "v.trr")
        write_trr(path, pos, velocities=vels)
        u = Universe(u0.topology, TRRReader(path))
        r = VelocityAutocorr(u.select_atoms("name OW")).run(backend="serial")
        ref = VelocityAutocorr(u0.select_atoms("name OW")).run(
            backend="serial")
        np.testing.assert_allclose(r.results.timeseries,
                                   ref.results.timeseries, rtol=1e-3)
        d = VelocityAutocorr(u.select_atoms("name OW")).run(**TORCH)
        np.testing.assert_allclose(d.results.timeseries,
                                   ref.results.timeseries, rtol=1e-3,
                                   atol=1e-5)

    def test_guards(self):
        u = _vel_universe(n_frames=4)
        with pytest.raises(ValueError, match="at least 2"):
            VelocityAutocorr(u.atoms).run(stop=1, **TORCH)
        u2 = Universe(make_water_topology(2),
                      MemoryReader(np.zeros((3, 6, 3), np.float32)))
        with pytest.raises(ValueError, match="velocities"):
            VelocityAutocorr(u2.atoms).run(**TORCH)


class TestDeviceRoute:
    def test_torch_fft_against_float64(self):
        """Thermal velocities (a few Å/ps, centred on zero): the float32
        FFT's error stays within 1e-3 relative of C(0) at every lag."""
        rng = np.random.default_rng(3)
        v = rng.normal(scale=4.0, size=(64, 30, 3))
        want = _np_fft_vacf(v)
        got = torch_fft_vacf(torch.as_tensor(v, dtype=torch.float32))
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-3 * np.abs(want[0]).max()

    def test_backend_names(self):
        u = _vel_universe(n_frames=4)
        with pytest.raises(ValueError, match="backend='torch'"):
            VelocityAutocorr(u.atoms).run(backend="jax")
        with pytest.raises(ValueError, match="backend must be"):
            VelocityAutocorr(u.atoms).run(backend="gpu")
        m = VelocityAutocorr(u.atoms).run(backend="mesh", device="cpu")
        t = VelocityAutocorr(u.atoms).run(**TORCH)
        np.testing.assert_array_equal(m.results.timeseries,
                                      t.results.timeseries)

    def test_against_jax_package(self):
        from mdanalysis_mpi_tpu.analysis.vacf import (
            VelocityAutocorr as JVACF)
        from mdanalysis_mpi_tpu.core.topology import (
            make_water_topology as jtop)
        from mdanalysis_mpi_tpu.core.universe import Universe as JU
        from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMR

        rng = np.random.default_rng(8)
        pos = rng.normal(size=(40, 24, 3)).astype(np.float32)
        vel = rng.normal(size=(40, 24, 3)).astype(np.float32)
        j = JVACF(JU(jtop(8), JMR(pos, velocities=vel)).atoms).run(
            backend="jax")
        t = VelocityAutocorr(Universe(make_water_topology(8), MemoryReader(
            pos, velocities=vel)).atoms).run(**TORCH)
        s = VelocityAutocorr(Universe(make_water_topology(8), MemoryReader(
            pos, velocities=vel)).atoms).run(backend="serial")
        # two float32 FFTs of the same series: within 1e-5 of each other,
        # and each within the 1e-3 gate of serial
        np.testing.assert_allclose(t.results.timeseries,
                                   j.results.timeseries, atol=1e-5)
        np.testing.assert_allclose(t.results.timeseries,
                                   s.results.timeseries, rtol=1e-3,
                                   atol=1e-5)
