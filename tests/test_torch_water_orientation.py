"""Twin of ``tests/test_water_orientation.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

WaterOrientationalRelaxation / AngularDistribution (upstream
``analysis.waterdynamics``) and HydrogenBondAnalysis.lifetime.

Analytic fixtures: scripted water geometries whose orientation vectors
and bond presence are known exactly; batch backends differential-tested
against the serial oracle.
"""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import (
    AngularDistribution, HydrogenBondAnalysis, WaterOrientationalRelaxation,
)
from mdanalysis_mpi_tpu_torch.analysis.waterdynamics import _water_triplets
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.testing import make_water_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, mesh_kw, port_runs_on_the_cpu)


def _water_topology(n):
    names = np.tile(np.array(["OW", "HW1", "HW2"]), n)
    resnames = np.full(3 * n, "SOL")
    resids = np.repeat(np.arange(1, n + 1), 3)
    return Topology(names=names, resnames=resnames, resids=resids)


def _frozen_universe(n_frames=5):
    """One rigid water, never moving: every orientation correlation is
    exactly 1 at every lag."""
    pos = np.zeros((n_frames, 3, 3), np.float32)
    pos[:, 1] = [0.76, 0.59, 0.0]
    pos[:, 2] = [-0.76, 0.59, 0.0]
    return Universe(_water_topology(1), MemoryReader(pos))


def _rotating_universe():
    """One water whose OH/HH/dipole frame rotates 90° about x between
    frame 0 and frame 1: P2(cos 90°) = -0.5 exactly."""
    pos = np.zeros((2, 3, 3), np.float32)
    pos[0, 1] = [0.76, 0.59, 0.0]
    pos[0, 2] = [-0.76, 0.59, 0.0]
    # rotate (x, y, z) -> (x, 0, y) about the x axis
    pos[1, 1] = [0.76, 0.0, 0.59]
    pos[1, 2] = [-0.76, 0.0, 0.59]
    return Universe(_water_topology(1), MemoryReader(pos))


def test_wor_frozen_water_is_one():
    u = _frozen_universe()
    r = WaterOrientationalRelaxation(u, "name OW", dtmax=3).run(
        backend="serial")
    np.testing.assert_array_equal(r.results.tau_timeseries, [0, 1, 2, 3])
    np.testing.assert_allclose(r.results.timeseries, 1.0, atol=1e-12)


def test_wor_right_angle_rotation():
    u = _rotating_universe()
    r = WaterOrientationalRelaxation(u, "name OW", dtmax=1).run(
        backend="serial")
    # τ=0: P2(1)=1 for all three vectors; τ=1: OH rotated 90°-ish?
    # OH vector frame0 = unit(0.76,0.59,0), frame1 = unit(0.76,0,0.59):
    # cos = (0.76² )/(0.926²)... compute directly instead of guessing
    a = np.array([0.76, 0.59, 0.0]); a /= np.linalg.norm(a)
    b = np.array([0.76, 0.0, 0.59]); b /= np.linalg.norm(b)
    p2_oh = 1.5 * (a @ b) ** 2 - 0.5
    # HH is ±x in both frames -> cos=1 -> P2=1; dipole +y -> +z -> P2=-0.5
    np.testing.assert_allclose(r.results.timeseries[0], 1.0, atol=1e-12)
    np.testing.assert_allclose(r.results.OH[1], p2_oh, atol=1e-6)
    np.testing.assert_allclose(r.results.HH[1], 1.0, atol=1e-6)
    np.testing.assert_allclose(r.results.dip[1], -0.5, atol=1e-6)


def test_wor_backend_parity():
    u = make_water_universe(n_waters=30, n_frames=12, seed=11)
    s = WaterOrientationalRelaxation(u, "name OW", dtmax=6).run(
        backend="serial")
    j = WaterOrientationalRelaxation(u, "name OW", dtmax=6).run(
        backend="torch", batch_size=4)
    np.testing.assert_allclose(j.results.timeseries, s.results.timeseries,
                               atol=1e-5)
    m = WaterOrientationalRelaxation(u, "name OW", dtmax=6).run(
        **mesh_kw("mesh"), batch_size=2)
    np.testing.assert_allclose(m.results.timeseries, s.results.timeseries,
                               atol=1e-5)


def test_angular_distribution_analytic_and_parity():
    # frozen water: dipole exactly +y, HH exactly ±x, OH fixed — the z
    # projections are all 0 -> all density lands in the cos=0 bin
    u = _frozen_universe()
    r = AngularDistribution(u, "name OW", bins=4, axis="z").run(
        backend="serial")
    for key in ("OH", "HH", "dip"):
        hist = getattr(r.results, key)
        assert hist.argmax() in (1, 2)          # the bins straddling 0
    # dipole along y: axis='y' puts everything in the last bin (cos=1)
    ry = AngularDistribution(u, "name OW", bins=4, axis="y").run(
        backend="serial")
    assert ry.results.dip.argmax() == 3
    # backend parity on a random box
    w = make_water_universe(n_waters=25, n_frames=8, seed=12)
    s = AngularDistribution(w, "name OW", bins=16).run(backend="serial")
    j = AngularDistribution(w, "name OW", bins=16).run(
        backend="torch", batch_size=4)
    for key in ("OH", "HH", "dip"):
        np.testing.assert_allclose(getattr(j.results, key),
                                   getattr(s.results, key), atol=1e-4)


def test_water_triplets_validation():
    u = make_water_universe(n_waters=4, n_frames=1)
    o, h1, h2 = _water_triplets(u, "name OW")
    assert len(o) == len(h1) == len(h2) == 4
    with pytest.raises(ValueError, match="OXYGEN"):
        _water_triplets(u, "name HW1")
    with pytest.raises(ValueError, match="matches no atoms"):
        _water_triplets(u, "name XX")
    with pytest.raises(ValueError, match="axis"):
        AngularDistribution(u, "name OW", axis="w")
    with pytest.raises(ValueError, match="dtmax"):
        WaterOrientationalRelaxation(u, "name OW", dtmax=-1)


def _hbond_universe(bonded_frames, n_frames):
    """Two waters: A at the origin donates to B's oxygen when B sits at
    2.8 Å (D-H-A angle 180°); in unbonded frames B sits at 6 Å."""
    pos = np.zeros((n_frames, 6, 3), np.float32)
    for f in range(n_frames):
        d = 2.8 if f in bonded_frames else 6.0
        pos[f, 0] = [0.0, 0.0, 0.0]          # O_A
        pos[f, 1] = [0.96, 0.0, 0.0]         # H_A1 -> points at O_B
        pos[f, 2] = [-0.3, 0.9, 0.0]         # H_A2 elsewhere
        pos[f, 3] = [d, 0.0, 0.0]            # O_B
        pos[f, 4] = [d + 0.96, 0.0, 0.0]     # H_B1 points away
        pos[f, 5] = [d + 0.3, -0.9, 0.0]     # H_B2
    return Universe(_water_topology(2), MemoryReader(pos))


def test_hbond_lifetime_hand_computed():
    u = _hbond_universe(bonded_frames={0, 1, 3}, n_frames=4)
    h = HydrogenBondAnalysis(u).run(backend="serial")
    np.testing.assert_array_equal(h.results.count, [1, 1, 0, 1])
    taus, c = h.lifetime(tau_max=2)
    # presence b = [1,1,0,1] (one pair), CONTINUOUS survival:
    # C(0)=1; C(1) = mean(t0: 1/1, t1: 0/1; t2 has no bonds) = 1/2
    # C(2) = mean(t0: b0&b1&b2 = 0, t1: b1&b2&b3 = 0) = 0 — the gap
    # kills every window crossing it (break-and-reform ≠ survival)
    np.testing.assert_array_equal(taus, [0, 1, 2])
    np.testing.assert_allclose(c, [1.0, 0.5, 0.0])
    # intermittency=1 fills the single-frame gap: b = [1,1,1,1]
    _, ci = h.lifetime(tau_max=2, intermittency=1)
    np.testing.assert_allclose(ci, [1.0, 1.0, 1.0])


def test_hbond_lifetime_needs_serial_table():
    u = _hbond_universe(bonded_frames={0}, n_frames=2)
    h = HydrogenBondAnalysis(u).run(backend="torch", batch_size=2)
    with pytest.raises(ValueError, match="serial"):
        h.lifetime()
    hs = HydrogenBondAnalysis(u).run(backend="serial")
    with pytest.raises(ValueError, match="tau_max"):
        hs.lifetime(tau_max=-1)
    with pytest.raises(ValueError, match="intermittency"):
        hs.lifetime(intermittency=-1)


def test_hbond_lifetime_mean_of_ratios():
    """Normalization is the mean of per-origin ratios (upstream
    lib.correlations), NOT ratio-of-sums — they diverge when the bond
    count varies across origins."""
    u = _hbond_universe(bonded_frames={0}, n_frames=3)
    h = HydrogenBondAnalysis(u).run(backend="serial")
    # synthetic table: frame 0 has pair A; frame 1 has pairs A..J (10);
    # frame 2 has pair A only -> C(1) = mean(1/1, 1/10) = 0.55
    rows = [(0, 0, 1, 3, 2.8, 180.0)]
    rows += [(1, 0, 1, 3 + k, 2.8, 180.0) for k in range(10)]
    rows += [(2, 0, 1, 3, 2.8, 180.0)]
    h.results["hbonds"] = np.array(rows, dtype=np.float64)
    h._frame_indices = [0, 1, 2]
    _, c = h.lifetime(tau_max=1)
    np.testing.assert_allclose(c, [1.0, (1.0 + 0.1) / 2])


def test_hbond_rerun_clears_stale_table():
    """A later run() must not leave the previous run's bond table for
    lifetime() to consume against the new frame window."""
    u = _hbond_universe(bonded_frames={0, 1, 3}, n_frames=4)
    h = HydrogenBondAnalysis(u)
    h.run(backend="serial")
    assert "hbonds" in h.results
    h.run(backend="torch", batch_size=2, stop=2)
    assert "hbonds" not in h.results
    with pytest.raises(ValueError, match="serial"):
        h.lifetime()


def test_wor_minimum_image_wrapped_water():
    """A water split across the periodic boundary (atom-wrapped
    trajectory) must produce the same orientation vectors as its
    unwrapped image."""
    box = 18.6
    dims = np.array([box, box, box, 90.0, 90.0, 90.0], np.float32)
    n_frames = 2
    wrapped = np.zeros((n_frames, 3, 3), np.float32)
    unwrapped = np.zeros((n_frames, 3, 3), np.float32)
    for f in range(n_frames):
        o = np.array([box - 0.1, 1.0, 1.0])
        h1 = o + np.array([0.76, 0.59, 0.0])     # crosses the x boundary
        h2 = o + np.array([-0.76, 0.59, 0.0])
        unwrapped[f] = [o, h1, h2]
        wrapped[f] = [o, h1 % box, h2 % box]
    top = _water_topology(1)
    uw = Universe(top, MemoryReader(wrapped, dimensions=dims))
    un = Universe(top, MemoryReader(unwrapped, dimensions=dims))
    for backend in ("serial", "torch"):
        rw = WaterOrientationalRelaxation(uw, "name OW", dtmax=1).run(
            backend=backend, batch_size=2)
        rn = WaterOrientationalRelaxation(un, "name OW", dtmax=1).run(
            backend=backend, batch_size=2)
        np.testing.assert_allclose(rw.results.timeseries,
                                   rn.results.timeseries, atol=1e-5)
        np.testing.assert_allclose(rw.results.timeseries, 1.0, atol=1e-5)


def test_wor_series_budget_guard(monkeypatch):
    monkeypatch.setenv("MDTPU_WATER_SERIES_BUDGET", "100")
    u = make_water_universe(n_waters=10, n_frames=4)
    with pytest.raises(ValueError, match="SERIES_BUDGET"):
        WaterOrientationalRelaxation(u, "name OW").run(backend="serial")


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("key", ["timeseries", "OH", "HH", "dip"])
def test_wor_matches_jax_package(key):
    """WOR on the reference's water box through both packages, within
    its 1e-5."""
    def case(mod):
        u = mod("testing").make_water_universe(n_waters=30, n_frames=12,
                                               seed=11)
        a = mod("analysis").WaterOrientationalRelaxation(
            u, "name OW", dtmax=6)
        r = a.run(backend="jax" if mod().__name__ == "mdanalysis_mpi_tpu"
                  else "torch", batch_size=4)
        return np.asarray(getattr(r.results, key))
    ref, port = both(case)
    np.testing.assert_allclose(port, ref, atol=1e-5)


@pytest.mark.parametrize("key", ["bins", "OH", "HH", "dip"])
def test_angular_distribution_matches_jax_package(key):
    def case(mod):
        u = mod("testing").make_water_universe(n_waters=30, n_frames=6,
                                               seed=12)
        r = mod("analysis").AngularDistribution(u, "name OW", bins=20).run(
            backend="jax" if mod().__name__ == "mdanalysis_mpi_tpu"
            else "torch", batch_size=2)
        return np.asarray(getattr(r.results, key))
    ref, port = both(case)
    assert_same(ref, port, atol=1e-4)
