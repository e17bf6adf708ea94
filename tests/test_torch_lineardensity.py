"""The port's LinearDensity (``analysis/lineardensity.py``): the JAX
package's tests/test_lineardensity.py case by case on
``backend="torch", device="cpu"`` and a two-shard CPU mesh (profiles
within the reference tests' bounds of the serial float64 oracle), the
order-fixed add (``_ordered_add``) against ``np.add.at``, and the same
seeded frames through the JAX package's ``backend="jax"`` and the port
within 1e-5 relative; a repeat is bit-identical."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import LinearDensity
from mdanalysis_mpi_tpu_torch.core.topology import Topology
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

_AMU = 1.66053906660


def _slab_universe(n_frames=4, jitter=0.0, seed=0):
    """Six atoms in two z-slabs of a 10 Å box, known masses/charges."""
    rng = np.random.default_rng(seed)
    base = np.array([
        [1.0, 1.0, 1.0], [5.0, 5.0, 1.2], [9.0, 9.0, 1.4],   # z ~ 1
        [1.0, 5.0, 8.0], [5.0, 9.0, 8.2], [9.0, 1.0, 8.4],   # z ~ 8
    ], np.float32)
    frames = np.repeat(base[None], n_frames, axis=0)
    if jitter:
        frames = frames + rng.normal(
            scale=jitter, size=frames.shape).astype(np.float32)
    top = Topology(
        names=np.array(["OW", "OW", "OW", "HW", "HW", "HW"]),
        resnames=np.array(["SOL"] * 6),
        resids=np.array([1, 1, 1, 2, 2, 2]),
        masses=np.array([16.0, 16.0, 16.0, 1.0, 1.0, 1.0]),
        charges=np.array([-0.8, -0.8, -0.8, 0.4, 0.4, 0.4]))
    dims = np.array([10.0, 10, 10, 90, 90, 90], np.float32)
    return Universe(top, MemoryReader(frames, dimensions=dims))


def test_mass_profile_integrates_to_total_mass():
    u = _slab_universe()
    ld = LinearDensity(u.atoms, binsize=1.0).run(backend="serial")
    for axis in ("x", "y", "z"):
        sub = ld.results[axis]
        dens = sub.mass_density            # g/cm3
        slab_vol = sub.slab_volume
        total_amu = float((dens / _AMU * slab_vol).sum())
        np.testing.assert_allclose(total_amu, 48.0 + 3.0, rtol=1e-10)
    # the z profile puts the heavy slab in bin 1, the light one in bin 8
    z = ld.results.z.mass_density / _AMU * ld.results.z.slab_volume
    np.testing.assert_allclose(z[1], 48.0)
    np.testing.assert_allclose(z[8], 3.0)
    # static trajectory: zero per-frame stddev
    assert float(ld.results.z.mass_density_stddev.max()) == 0.0
    # charge bookkeeping: OW slab carries 3 x -0.8, box total is -1.2
    q = ld.results.z.charge_density * ld.results.z.slab_volume
    np.testing.assert_allclose(q[1], -2.4, atol=1e-12)
    np.testing.assert_allclose(q.sum(), -1.2, atol=1e-12)


@pytest.mark.parametrize("grouping", ["atoms", "residues", "segments"])
@pytest.mark.parametrize("backend", ["jax", "mesh"])
def test_backend_parity(grouping, backend):
    u = _slab_universe(n_frames=16, jitter=0.3, seed=3)
    s = LinearDensity(u.atoms, grouping=grouping,
                      binsize=1.0).run(backend="serial")
    j = LinearDensity(u.atoms, grouping=grouping,
                      binsize=1.0).run(**BK[backend], batch_size=2)
    for axis in ("x", "y", "z"):
        for key in ("mass_density", "mass_density_stddev",
                    "charge_density", "charge_density_stddev"):
            np.testing.assert_allclose(
                np.asarray(getattr(getattr(j.results, axis), key)),
                np.asarray(getattr(getattr(s.results, axis), key)),
                atol=1e-4, err_msg=f"{grouping}/{backend}/{axis}/{key}")


def test_residue_grouping_bins_com():
    u = _slab_universe()
    ld = LinearDensity(u.atoms, grouping="residues",
                       binsize=1.0).run(backend="serial")
    z = ld.results.z.mass_density / _AMU * ld.results.z.slab_volume
    # residue 1 (the three OW, com z = 1.2) lands whole in bin 1;
    # residue 2 (the three HW, com z = 8.2) in bin 8
    np.testing.assert_allclose(z[1], 48.0)
    np.testing.assert_allclose(z[8], 3.0)


def test_jitter_gives_positive_stddev_and_water_fixture_runs():
    u = _slab_universe(n_frames=12, jitter=0.4, seed=5)
    ld = LinearDensity(u.atoms, binsize=1.0).run(backend="serial")
    assert float(ld.results.z.mass_density_stddev.max()) > 0.0
    uw = make_water_universe(n_waters=30, n_frames=4, box=12.0)
    uw.topology.charges = np.zeros(uw.topology.n_atoms)
    lw = LinearDensity(uw.select_atoms("name OW"),
                       binsize=0.5).run(**TORCH, batch_size=2)
    assert lw.results.x.mass_density.shape == (lw.results.nbins,)


def test_noncubic_box_upstream_layout():
    """Upstream quirk, pinned: every axis histograms over [0, max(dims))
    with nbins = max per-axis bin count; slab_volume stays per-axis."""
    base = np.array([[1.0, 1.0, 1.0], [15.0, 8.0, 8.0]], np.float32)
    top = Topology(names=np.array(["CA", "CA"]),
                   resnames=np.array(["ALA"] * 2),
                   resids=np.array([1, 2]),
                   masses=np.array([10.0, 20.0]),
                   charges=np.array([0.5, -0.5]))
    dims = np.array([20.0, 10, 10, 90, 90, 90], np.float32)
    u = Universe(top, MemoryReader(base[None], dimensions=dims))
    ld = LinearDensity(u.atoms, binsize=1.0).run(backend="serial")
    assert ld.results.nbins == 20
    for axis, slab_vol in (("x", 100.0), ("y", 200.0), ("z", 200.0)):
        sub = getattr(ld.results, axis)
        assert sub.slab_volume == slab_vol
        np.testing.assert_allclose(sub.hist_bin_edges,
                                   np.linspace(0, 20, 21))
        total = float((sub.mass_density / _AMU * slab_vol).sum())
        np.testing.assert_allclose(total, 30.0, rtol=1e-12)
    # y positions 1 and 8 land in bins 1 and 8 of the shared 20-bin
    # range; the tail bins past the y extent stay empty
    y = ld.results.y.mass_density / _AMU * 200.0
    np.testing.assert_allclose(y[1], 10.0)
    np.testing.assert_allclose(y[8], 20.0)
    assert float(np.abs(y[10:]).max()) == 0.0


def test_validation():
    u = _slab_universe()
    with pytest.raises(ValueError, match="grouping"):
        LinearDensity(u.atoms, grouping="molecules")
    with pytest.raises(ValueError, match="binsize"):
        LinearDensity(u.atoms, binsize=0.0)
    with pytest.raises(ValueError, match="no atoms"):
        LinearDensity(u.select_atoms("name XX")).run(backend="serial")
    boxless = Universe(u.topology,
                       MemoryReader(np.zeros((2, 6, 3), np.float32)))
    with pytest.raises(ValueError, match="box"):
        LinearDensity(boxless.atoms).run(backend="serial")
    uw = make_water_universe(n_waters=4, n_frames=1)   # no charges
    with pytest.raises(ValueError, match="charges"):
        LinearDensity(uw.atoms).run(backend="serial")


def test_right_edge_and_materialize():
    """np.histogram's last bin is right-closed (an atom exactly at the
    box edge counts), and materialize() recurses into the nested
    per-axis Results."""
    pos = np.array([[[10.0, 5.0, 5.0], [5.0, 5.0, 5.0]]], np.float32)
    top = Topology(names=np.array(["CA", "CA"]),
                   resnames=np.array(["ALA"] * 2),
                   resids=np.array([1, 2]),
                   masses=np.array([7.0, 3.0]),
                   charges=np.zeros(2))
    dims = np.array([10.0, 10, 10, 90, 90, 90], np.float32)
    u = Universe(top, MemoryReader(pos, dimensions=dims))
    ld = LinearDensity(u.atoms, binsize=1.0).run(**TORCH,
                                                 batch_size=1)
    x = ld.results.x.mass_density / _AMU * ld.results.x.slab_volume
    np.testing.assert_allclose(x[9], 7.0)          # edge atom kept
    np.testing.assert_allclose(x.sum(), 10.0)
    ld2 = LinearDensity(u.atoms, binsize=1.0).run(backend="serial")
    m = ld2.results.materialize()
    assert isinstance(m["x"]["mass_density"], np.ndarray)
    np.testing.assert_allclose(
        m["x"]["mass_density"], np.asarray(ld.results.x.mass_density),
        atol=1e-5)


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu.analysis import LinearDensity as JLinearDensity  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_water_universe as jax_make_water_universe)

torch.set_num_threads(1)

_KEYS = ("mass_density", "mass_density_stddev", "charge_density",
         "charge_density_stddev")


def test_ordered_add_matches_add_at():
    from mdanalysis_mpi_tpu_torch.analysis.lineardensity import _ordered_add

    rng = np.random.default_rng(0)
    flat = rng.integers(0, 17, size=500)
    vals = rng.normal(size=500).astype(np.float32)
    want = np.zeros(17, np.float64)
    np.add.at(want, flat, vals.astype(np.float64))
    got = _ordered_add(17, torch.from_numpy(flat), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    vals3 = rng.normal(size=(500, 3)).astype(np.float32)
    got3 = _ordered_add(17, torch.from_numpy(flat), torch.from_numpy(vals3))
    want3 = np.zeros((17, 3))
    np.add.at(want3, flat, vals3.astype(np.float64))
    np.testing.assert_allclose(got3.numpy(), want3, atol=1e-5)


@pytest.mark.parametrize("grouping", ["atoms", "residues"])
@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(grouping, backend):
    kw = dict(n_waters=40, n_frames=8, box=14.0, seed=6)
    u, ju = make_water_universe(**kw), jax_make_water_universe(**kw)
    q = np.tile([-0.834, 0.417, 0.417], 40)
    u.add_TopologyAttr("charges", q)
    ju.add_TopologyAttr("charges", q)
    p = LinearDensity(u.atoms, grouping=grouping, binsize=0.5).run(
        **BK[backend], batch_size=4)
    j = JLinearDensity(ju.atoms, grouping=grouping, binsize=0.5).run(
        backend="jax", batch_size=4)
    assert p.results.nbins == j.results.nbins
    for axis in "xyz":
        for key in _KEYS:
            want = np.asarray(getattr(j.results[axis], key))
            np.testing.assert_allclose(
                getattr(p.results[axis], key), want, rtol=1e-5,
                atol=1e-5 * float(np.abs(want).max() or 1.0),
                err_msg=f"{axis}.{key}")


def test_repeat_is_bit_identical():
    u = make_water_universe(n_waters=40, n_frames=8, box=14.0, seed=6)
    u.add_TopologyAttr("charges", np.tile([-0.834, 0.417, 0.417], 40))
    a = LinearDensity(u.atoms, binsize=0.25).run(**TORCH, batch_size=4)
    b = LinearDensity(u.atoms, binsize=0.25).run(**TORCH, batch_size=4)
    for x, y in zip(a._last_total, b._last_total):
        assert torch.equal(x, y)
