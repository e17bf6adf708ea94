"""The port's water dynamics (``analysis/waterdynamics.py``): the JAX
package's tests/test_water_orientation.py (WaterOrientationalRelaxation,
AngularDistribution and HydrogenBondAnalysis.lifetime) and
tests/test_waterdynamics.py (SurvivalProbability) case by case with
``backend="torch", device="cpu"`` and a two-shard CPU mesh for its
``'jax'`` and ``'mesh'`` (their tolerances: WOR 1e-5, AngularDistribution
1e-4 against serial), its MeanSquareDisplacement cases
(tests/test_analysis.py), the batched minimum image against the
per-frame one, and the same water boxes through the JAX package's
``backend="jax"`` and the port."""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.analysis import (
    AngularDistribution, HydrogenBondAnalysis, MeanSquareDisplacement,
    SurvivalProbability, WaterOrientationalRelaxation)
from mdanalysis_mpi_tpu_torch.analysis.waterdynamics import _water_triplets
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.testing import make_water_universe

TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)


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
        **TORCH, batch_size=4)
    np.testing.assert_allclose(j.results.timeseries, s.results.timeseries,
                               atol=1e-5)
    m = WaterOrientationalRelaxation(u, "name OW", dtmax=6).run(
        **MESH, batch_size=2)
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
        **TORCH, batch_size=4)
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
    h = HydrogenBondAnalysis(u).run(**TORCH, batch_size=2)
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
    h.run(**TORCH, batch_size=2, stop=2)
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
    for backend in (dict(backend="serial"), TORCH):
        rw = WaterOrientationalRelaxation(uw, "name OW", dtmax=1).run(
            **backend, batch_size=2)
        rn = WaterOrientationalRelaxation(un, "name OW", dtmax=1).run(
            **backend, batch_size=2)
        np.testing.assert_allclose(rw.results.timeseries,
                                   rn.results.timeseries, atol=1e-5)
        np.testing.assert_allclose(rw.results.timeseries, 1.0, atol=1e-5)


def test_wor_series_budget_guard(monkeypatch):
    monkeypatch.setenv("MDTPU_WATER_SERIES_BUDGET", "100")
    u = make_water_universe(n_waters=10, n_frames=4)
    with pytest.raises(ValueError, match="SERIES_BUDGET"):
        WaterOrientationalRelaxation(u, "name OW").run(backend="serial")


# --- SurvivalProbability (tests/test_waterdynamics.py) ----------------

def _universe(frames):
    """One fixed 'protein' atom at the origin + three waters whose
    per-frame x positions are scripted, so shell membership (within
    3 Å of the origin atom) is known exactly."""
    n = len(frames)
    pos = np.zeros((n, 4, 3), np.float32)
    for f, xs in enumerate(frames):
        pos[f, 0] = [0.0, 0.0, 0.0]
        for j, x in enumerate(xs):
            pos[f, j + 1] = [x, 0.0, 0.0]
    top = Topology(names=np.array(["CA", "OW", "OW", "OW"]),
                   resnames=np.array(["GLY", "SOL", "SOL", "SOL"]),
                   resids=np.array([1, 2, 3, 4]))
    return Universe(top, MemoryReader(pos))


IN, OUT = 2.0, 9.0          # inside / outside the 3 Å shell


def test_survival_hand_computed():
    # membership rows (w1, w2, w3) per frame:
    # f0: 1,1,0 ; f1: 1,0,0 ; f2: 1,1,1 ; f3: 1,1,1
    u = _universe([(IN, IN, OUT), (IN, OUT, OUT),
                   (IN, IN, IN), (IN, IN, IN)])
    r = SurvivalProbability(u, "name OW and around 3.0 name CA").run(
        tau_max=2, backend="serial")
    np.testing.assert_array_equal(r.results.tau_timeseries, [0, 1, 2])
    # tau=0: always 1.  tau=1: starts f0..f2 -> 1/2, 1/1, 3/3
    # tau=2: starts f0, f1 -> 1/2, 1/1
    np.testing.assert_allclose(
        r.results.sp_timeseries,
        [1.0, (0.5 + 1.0 + 1.0) / 3, (0.5 + 1.0) / 2])


def test_survival_intermittency_fills_single_gap():
    # w1 leaves for exactly one frame (f1) then returns
    u = _universe([(IN, OUT, OUT), (OUT, OUT, OUT),
                   (IN, OUT, OUT), (IN, OUT, OUT)])
    strict = SurvivalProbability(
        u, "name OW and around 3.0 name CA").run(tau_max=3,
                                                 backend="serial")
    # strict: the f1 absence breaks every window crossing it
    np.testing.assert_allclose(strict.results.sp_timeseries[3], 0.0)
    loose = SurvivalProbability(
        u, "name OW and around 3.0 name CA", intermittency=1).run(
        tau_max=3, backend="serial")
    # with the gap filled, w1 survives f0..f3 continuously
    np.testing.assert_allclose(loose.results.sp_timeseries[3], 1.0)


def test_survival_empty_start_windows_are_skipped():
    u = _universe([(OUT, OUT, OUT), (IN, OUT, OUT), (IN, OUT, OUT)])
    r = SurvivalProbability(u, "name OW and around 3.0 name CA").run(
        tau_max=1, backend="serial")
    # tau=1 averages only over starts with N(t) > 0 (f1 here)
    np.testing.assert_allclose(r.results.sp_timeseries, [1.0, 1.0])


def test_survival_validation_and_batch_refusal():
    u = _universe([(IN, IN, IN)])
    with pytest.raises(ValueError, match="intermittency"):
        SurvivalProbability(u, "name OW", intermittency=-1)
    with pytest.raises(ValueError, match="tau_max"):
        SurvivalProbability(u, "name OW").run(tau_max=-1)
    with pytest.raises(Exception):      # selection typo fails up front
        SurvivalProbability(u, "nmae OW").run(backend="serial")
    u2 = _universe([(IN, IN, IN)] * 4)
    with pytest.raises(ValueError, match="serial backend only"):
        SurvivalProbability(u2, "name OW").run(**TORCH,
                                               batch_size=2)
    # tau_max beyond the window is clamped to T-1
    r = SurvivalProbability(u2, "name OW").run(tau_max=99,
                                               backend="serial")
    assert len(r.results.tau_timeseries) == 4
    np.testing.assert_allclose(r.results.sp_timeseries, np.ones(4))


def test_survival_zero_frames_is_clear_error():
    u = _universe([(IN, IN, IN)] * 3)
    with pytest.raises(ValueError, match="zero frames"):
        SurvivalProbability(u, "name OW").run(stop=0, backend="serial")


def test_sp_intermittency_as_run_kwarg():
    """Upstream passes intermittency to run(); both spellings agree."""
    u = _universe([(IN, OUT, OUT), (OUT, OUT, OUT),
                   (IN, OUT, OUT), (IN, OUT, OUT)])
    a = SurvivalProbability(u, "name OW and around 3.0 name CA").run(
        tau_max=3, intermittency=1, backend="serial")
    b = SurvivalProbability(u, "name OW and around 3.0 name CA",
                            intermittency=1).run(tau_max=3,
                                                 backend="serial")
    np.testing.assert_allclose(a.results.sp_timeseries,
                               b.results.sp_timeseries)
    np.testing.assert_allclose(a.results.sp_timeseries[3], 1.0)
    # the run() override is scoped to that run: a later run() with the
    # kwarg omitted falls back to the CONSTRUCTOR value (here 0), as
    # upstream's per-call default does
    c = SurvivalProbability(u, "name OW and around 3.0 name CA")
    c.run(tau_max=3, intermittency=1, backend="serial")
    c.run(tau_max=3, backend="serial")
    np.testing.assert_allclose(c.results.sp_timeseries[3], 0.0)


def test_sp_invalid_intermittency_loud():
    u = _universe([(IN, OUT, OUT)])
    with pytest.raises(ValueError, match="intermittency"):
        SurvivalProbability(u, "name OW").run(tau_max=2, intermittency=-1)


def test_survival_residue_level_membership():
    """residues=True: a residue stays 'present' while DIFFERENT atoms
    of it occupy the shell — atom-level survival would drop to 0."""

    # one 2-atom residue; the two atoms alternate inside x < 1.0
    frames = np.zeros((4, 2, 3), np.float32)
    frames[0] = [[0.5, 0, 0], [5.0, 0, 0]]   # atom0 in
    frames[1] = [[5.0, 0, 0], [0.5, 0, 0]]   # atom1 in
    frames[2] = [[0.5, 0, 0], [5.0, 0, 0]]   # atom0 in
    frames[3] = [[5.0, 0, 0], [0.5, 0, 0]]   # atom1 in
    top = Topology(names=np.array(["H1", "H2"]),
                   resnames=np.array(["SOL", "SOL"]),
                   resids=np.array([1, 1]))
    u = Universe(top, MemoryReader(frames))
    sel = "prop x < 1.0"
    atom = SurvivalProbability(u, sel).run(tau_max=2)
    res = SurvivalProbability(u, sel).run(tau_max=2, residues=True)
    # atom-level: the in-shell atom changes identity every frame
    assert atom.results.sp_timeseries[1] == pytest.approx(0.0)
    # residue-level: the residue never leaves
    assert res.results.sp_timeseries[1] == pytest.approx(1.0)
    assert res.results.sp_timeseries[2] == pytest.approx(1.0)


def test_survival_bare_run_is_serial():
    """SurvivalProbability is serial only: a bare run() takes the serial
    backend (``_default_backend``), as the JAX package's run() does."""
    u = _universe([(IN, IN, OUT), (IN, OUT, OUT), (IN, IN, IN)])
    assert SurvivalProbability._default_backend == "serial"
    a = SurvivalProbability(u, "name OW and around 3.0 name CA").run(
        tau_max=2)
    b = SurvivalProbability(u, "name OW and around 3.0 name CA").run(
        tau_max=2, backend="serial")
    np.testing.assert_array_equal(a.results.sp_timeseries,
                                  b.results.sp_timeseries)


# --- MeanSquareDisplacement (tests/test_analysis.py) -------------------

def test_waterdynamics_msd_alias():
    from mdanalysis_mpi_tpu_torch.analysis import EinsteinMSD

    u = make_water_universe(n_waters=20, n_frames=8, seed=2)
    a = MeanSquareDisplacement(u, select="name OW").run(backend="serial")
    b = EinsteinMSD(u, select="name OW").run(backend="serial")
    np.testing.assert_allclose(a.results.timeseries,
                               b.results.timeseries, atol=1e-10)
    d = MeanSquareDisplacement(u, select="name OW").run(**TORCH)
    np.testing.assert_allclose(d.results.timeseries, b.results.timeseries,
                               rtol=1e-3, atol=1e-2 * float(
                                   b.results.timeseries.max()))


def test_waterdynamics_msd_upstream_signature():
    u = make_water_universe(n_waters=15, n_frames=10, seed=3)
    # upstream positional window (t0, tf, dtmax)
    m = MeanSquareDisplacement(u, "name OW", 2, 8, 3).run(
        backend="serial")
    assert len(m.results.timeseries) == 4        # dtmax truncation


def test_msd_shim_partial_window_and_particles():
    u = make_water_universe(n_waters=12, n_frames=10, seed=4)
    m = MeanSquareDisplacement(u, "name OW", 2, 8, 3)
    # overriding only start keeps the constructor's stop=8 (6 frames)
    m.run(start=0, backend="serial")
    assert len(m.results.timeseries) == 4            # dtmax
    assert m.results.msds_by_particle.shape[0] == 4  # truncated together


# --- the device route --------------------------------------------------

@pytest.mark.parametrize("angles", [(90.0, 90.0, 90.0), (70.0, 80.0, 65.0),
                                    None])
def test_minimum_image_batch_equals_per_frame(angles):
    from mdanalysis_mpi_tpu_torch.ops.distances import minimum_image

    rng = np.random.default_rng(3)
    disp = torch.as_tensor(rng.normal(scale=12.0, size=(4, 9, 3)),
                           dtype=torch.float32)
    boxes = torch.zeros((4, 6))
    if angles is not None:
        boxes[:, :3] = torch.as_tensor(rng.uniform(15.0, 25.0, (4, 3)))
        boxes[:, 3:] = torch.as_tensor(angles)
        boxes[2] = 0.0                      # a boxless frame in the batch
    got = minimum_image(disp, boxes)
    for f in range(4):
        want = minimum_image(disp[f], boxes[f])
        np.testing.assert_allclose(got[f].numpy(), want.numpy(), atol=1e-5)


def test_wor_lag_sums_on_the_device_read_back_little(monkeypatch):
    """The device route reduces the vector series on the device: only
    the (dtmax+1, 3) lag sums come back, never the (T, nW, 3, 3)
    series."""
    from mdanalysis_mpi_tpu_torch.analysis import waterdynamics as wd

    u = make_water_universe(n_waters=16, n_frames=10, seed=13)
    read = []
    real = wd.to_numpy

    def spy(x):
        read.append(tuple(getattr(x, "shape", ())))
        return real(x)

    monkeypatch.setattr(wd, "to_numpy", spy)
    r = WaterOrientationalRelaxation(u, "name OW", dtmax=4).run(
        **TORCH, batch_size=4)
    s = WaterOrientationalRelaxation(u, "name OW", dtmax=4).run(
        backend="serial")
    np.testing.assert_allclose(r.results.timeseries, s.results.timeseries,
                               atol=1e-5)
    assert read == []
    a = AngularDistribution(u, "name OW", bins=8).run(**TORCH,
                                                      batch_size=4)
    assert np.isfinite(a.results.OH).all()
    assert read == [(10, 16, 3)]            # the axis components only


class TestAgainstJaxPackage:
    """The same seeded water box through the JAX package's
    ``backend="jax"`` and the port: WOR within 1e-5 of each other and
    of serial (the JAX tests' gate), AngularDistribution within 1e-4,
    SurvivalProbability (host code in both) equal."""

    def test_wor_and_angular_distribution(self):
        from mdanalysis_mpi_tpu.analysis import (
            AngularDistribution as JAD,
            WaterOrientationalRelaxation as JWOR)
        from mdanalysis_mpi_tpu.testing import make_water_universe as jm

        uj = jm(n_waters=30, n_frames=12, seed=21)
        ut = make_water_universe(n_waters=30, n_frames=12, seed=21)
        j = JWOR(uj, "name OW", dtmax=6).run(backend="jax", batch_size=4)
        t = WaterOrientationalRelaxation(ut, "name OW", dtmax=6).run(
            **TORCH, batch_size=4)
        s = WaterOrientationalRelaxation(ut, "name OW", dtmax=6).run(
            backend="serial")
        np.testing.assert_allclose(t.results.timeseries,
                                   j.results.timeseries, atol=1e-5)
        np.testing.assert_allclose(t.results.timeseries,
                                   s.results.timeseries, atol=1e-5)
        ja = JAD(uj, "name OW", bins=16).run(backend="jax", batch_size=4)
        ta = AngularDistribution(ut, "name OW", bins=16).run(
            **TORCH, batch_size=4)
        for key in ("OH", "HH", "dip"):
            np.testing.assert_allclose(getattr(ta.results, key),
                                       getattr(ja.results, key), atol=1e-4)

    def test_survival_equal(self):
        from mdanalysis_mpi_tpu.analysis import (
            SurvivalProbability as JSP)
        from mdanalysis_mpi_tpu.core.topology import Topology as JTop
        from mdanalysis_mpi_tpu.core.universe import Universe as JU
        from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMR

        rng = np.random.default_rng(22)
        pos = rng.uniform(0.0, 6.0, (12, 8, 3)).astype(np.float32)
        pos[:, 0] = 0.0
        names = np.array(["CA"] + ["OW"] * 7)
        kw = dict(names=names, resnames=np.array(["GLY"] + ["SOL"] * 7),
                  resids=np.arange(1, 9))
        sel = "name OW and around 3.5 name CA"
        j = JSP(JU(JTop(**kw), JMR(pos)), sel).run(tau_max=5,
                                                   intermittency=1)
        t = SurvivalProbability(Universe(Topology(**kw), MemoryReader(pos)),
                                sel).run(tau_max=5, intermittency=1)
        np.testing.assert_array_equal(t.results.sp_timeseries,
                                      j.results.sp_timeseries)
