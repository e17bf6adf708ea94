"""The atom-sharded ring RDF (``ops/ring.py``, ``InterRDF(engine=
'ring')``) over 1, 2 and 4 CPU shards: twins of tests/test_ring.py
against the port's frame-batched ``'xla'`` engine, the serial float64
oracle and the JAX package's ring on as many virtual CPU devices.

Union atoms are cut into one contiguous block a shard, the B side
rotates around the shards, and the per-shard histograms merge by
``tree_psum``.  Tolerances are tests/test_ring.py's: against the
frame-batched engine rtol 1e-5 (and, for distinct groups, counts EQUAL:
the same float32 distances binned the same way), against the serial
oracle rtol 1e-4 (distinct groups: counts within one edge-tie flip,
g(r) rtol 2e-2 atol 5e-3).  Against the JAX package's ring the counts
are exact float32 sums of the same 0/1 weights: equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis.rdf import (  # noqa: E402
    InterRDF as JaxInterRDF)
from mdanalysis_mpi_tpu.parallel.executors import (  # noqa: E402
    MeshExecutor as JaxMesh)
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_water_universe as jax_make_water)

from mdanalysis_mpi_tpu_torch.analysis.rdf import InterRDF  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import ring  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    MeshExecutor)
from mdanalysis_mpi_tpu_torch.testing import make_water_universe  # noqa: E402

NBINS = 40
RMAX = 8.0
SHARDS = [1, 2, 4]


def _rdf(u, engine, sel1="name OW", sel2=None, rdf_cls=InterRDF,
         **run_kwargs):
    g1 = u.select_atoms(sel1)
    g2 = u.select_atoms(sel2) if sel2 else g1
    r = rdf_cls(g1, g2, nbins=NBINS, range=(0.0, RMAX), engine=engine)
    r.run(**run_kwargs)
    return r


def _mesh(n, batch_size=2):
    return dict(backend=MeshExecutor(batch_size=batch_size,
                                     devices=["cpu"] * n))


def _torch(batch_size=2):
    return dict(backend="torch", device="cpu", batch_size=batch_size)


@pytest.mark.parametrize("n", SHARDS)
def test_matches_xla_engine_identical_groups(n):
    """O-O self-RDF: the ring (exclude_self by global indices) equals
    the frame-batched engine."""
    u = make_water_universe(n_waters=64, n_frames=4, seed=1)
    r = _rdf(u, "ring", **_mesh(n))
    x = _rdf(u, "xla", **_torch())
    np.testing.assert_allclose(r.results.count, x.results.count, rtol=1e-5)
    np.testing.assert_allclose(r.results.rdf, x.results.rdf, rtol=1e-5)


@pytest.mark.parametrize("n", SHARDS)
def test_matches_serial_oracle(n):
    u = make_water_universe(n_waters=48, n_frames=3, seed=2)
    r = _rdf(u, "ring", **_mesh(n, batch_size=3))
    s = _rdf(u, "xla", backend="serial")
    np.testing.assert_allclose(r.results.rdf, s.results.rdf, rtol=1e-4)


@pytest.mark.parametrize("n", SHARDS)
def test_subset_groups_as_weights(n):
    """O-H RDF: distinct overlapping groups ride the union as weights.
    Counts EQUAL to the frame-batched engine's; against the f64 oracle
    within one edge-tie flip a bin."""
    u = make_water_universe(n_waters=40, n_frames=2, seed=3)
    kw = dict(sel1="name OW", sel2="name HW1")
    r = _rdf(u, "ring", **kw, **_mesh(n))
    x = _rdf(u, "xla", **kw, **_torch())
    s = _rdf(u, "xla", **kw, backend="serial")
    np.testing.assert_allclose(r.results.count, x.results.count, rtol=0,
                               atol=0)
    np.testing.assert_allclose(r.results.rdf, x.results.rdf, rtol=1e-6)
    np.testing.assert_allclose(r.results.count, s.results.count, atol=1.0)
    np.testing.assert_allclose(r.results.rdf, s.results.rdf, rtol=2e-2,
                               atol=5e-3)


@pytest.mark.parametrize("n", SHARDS)
def test_matches_jax_ring(n):
    """The JAX package's ring over as many virtual devices: the same
    union, weights and global offsets, so the same counts."""
    kw = dict(n_waters=40, n_frames=2, seed=3)
    up, uj = make_water_universe(**kw), jax_make_water(**kw)
    sel = dict(sel1="name OW", sel2="name HW1")
    r = _rdf(up, "ring", **sel, **_mesh(n))
    j = _rdf(uj, "ring", rdf_cls=JaxInterRDF, **sel,
             backend=JaxMesh(batch_size=2, devices=jax.devices()[:n]))
    np.testing.assert_array_equal(r.results.count,
                                  np.asarray(j.results.count))
    np.testing.assert_allclose(r.results.rdf, np.asarray(j.results.rdf),
                               rtol=1e-6)


def test_padding_weights_are_inert():
    """The union (3N atoms, not a multiple of 512) is padded with
    weight-0 restagings of atom 0 — counts do not change."""
    u = make_water_universe(n_waters=37, n_frames=2, seed=4)  # 111 atoms
    r = _rdf(u, "ring", sel1="all", **_mesh(4))
    assert len(r._union) % 512 == 0 and len(r._union) > 3 * 37
    s = _rdf(u, "xla", sel1="all", backend="serial")
    np.testing.assert_allclose(r.results.count, s.results.count, rtol=1e-5)


def test_single_shard_ring_is_the_plain_histogram():
    """One shard: one step of the generic pair histogram, no rotation."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((64, 3), generator=g) * 10.0
    w = torch.ones(64)
    edges = torch.linspace(0.0, 6.0, 17)
    box = torch.tensor([10.0, 10.0, 10.0, 90.0, 90.0, 90.0])
    (h,) = ring.ring_union_histogram([x], [w], [w], [edges], [box],
                                     exclude_self=True)
    from mdanalysis_mpi_tpu_torch.ops.distances import pair_histogram

    want = pair_histogram(x, x, edges, box=box, exclude_self=True)
    assert torch.equal(h, want)


def test_torch_backend_rejected():
    u = make_water_universe(n_waters=27, n_frames=2, seed=6)
    with pytest.raises(ValueError, match="mesh"):
        _rdf(u, "ring", **_torch())


def test_int16_staging_rejected():
    u = make_water_universe(n_waters=27, n_frames=2, seed=7)
    with pytest.raises(ValueError, match="float32"):
        _rdf(u, "ring", backend=MeshExecutor(batch_size=2,
                                             devices=["cpu"] * 2,
                                             transfer_dtype="int16"))


def test_union_must_divide_over_the_shards():
    u = make_water_universe(n_waters=27, n_frames=2, seed=8)
    with pytest.raises(ValueError, match="does not divide"):
        _rdf(u, "ring", **_mesh(3))


def test_exclusion_block_rejected_on_the_ring():
    u = make_water_universe(n_waters=27, n_frames=2, seed=9)
    ow = u.select_atoms("name OW")
    with pytest.raises(ValueError, match="exclusion_block"):
        InterRDF(ow, ow, engine="ring", exclusion_block=(1, 1))
