"""The port's RDF slice against the JAX package: the pair-histogram
kernel's plain version (``ops/fused_distances.py``) against the TPU
kernel run in Pallas interpret mode (``ops/pallas_distances.py``), and
``InterRDF``, ``InterRDF_s``, ``ContactMap``, ``PairwiseDistances`` and
the host helpers of ``analysis/distances.py`` against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages;
the universes come from each package's own ``make_water_universe``
(the same code, so the same coordinates).  InterRDF has no learned
state: what crosses between the packages is the numpy coordinates and
the bin edges, nothing else.

Tolerances.  The kernel's contract is tests/test_pallas.py's envelope:
every bin and every prefix sum within one edge-tie flip, and the total
exact.  The plain version and interpret-mode Pallas both evaluate the
distance op by op (``d - round(d/L)·L``, then x² + y² + z² in that
order), so the counts here are required to be EQUAL, which is inside
that envelope.  g(r) from equal counts agrees to 1e-6 relative (the
box volumes are float32 sums in two libraries).  Against the serial
float64 oracle: counts within 1 and g(r) within rtol 2e-2, atol 5e-3
(tests/test_pallas.py:146-157).  The CUDA kernel itself is held to its
plain version by tests/test_torch_cuda.py, which runs where a GPU is
present.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

# small shapes: one intra-op thread leaves the CPU to the other workers
torch.set_num_threads(1)

from mdanalysis_mpi_tpu import analysis as jax_analysis  # noqa: E402
from mdanalysis_mpi_tpu import testing as jax_testing  # noqa: E402
from mdanalysis_mpi_tpu.analysis import distances as jax_adist  # noqa: E402
from mdanalysis_mpi_tpu.ops import pallas_distances as jpd  # noqa: E402

from mdanalysis_mpi_tpu_torch import analysis  # noqa: E402
from mdanalysis_mpi_tpu_torch import testing  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis import distances as adist  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd  # noqa: E402

EDGES = np.linspace(0.0, 12.0, 49)
R0, DR, NBINS = 0.0, 12.0 / 48, 48
BOX = np.array([25.0, 25.0, 25.0, 90.0, 90.0, 90.0], np.float32)
CPU = dict(backend="torch", device="cpu")


def _coords(seed, n, scale=25.0):
    return np.random.default_rng(seed).uniform(
        0, scale, size=(n, 3)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _within_one_flip_and_equal(got, want):
    """tests/test_pallas.py's envelope, then the exact equality this
    pair of op-by-op evaluations is expected to reach."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.sum() == want.sum()
    assert np.abs(got - want).max() <= 1.0
    assert np.abs(np.cumsum(got - want)).max() <= 1.0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- kernel

@pytest.mark.parametrize("na,nb", [(40, 70), (256, 256), (300, 515)])
def test_plain_matches_pallas_with_box(na, nb):
    a, b = _coords(na, na), _coords(nb + 1, nb)
    want = jpd.pair_histogram(jnp.asarray(a), jnp.asarray(b), R0, DR, NBINS,
                              box=jnp.asarray(BOX))
    got = fd.pair_histogram(_t(a), _t(b), R0, DR, NBINS, box=_t(BOX))
    assert got.dtype == torch.float32 and tuple(got.shape) == (NBINS,)
    _within_one_flip_and_equal(got.numpy(), want)


def test_plain_matches_pallas_no_box():
    a, b = _coords(1, 200), _coords(2, 333)
    want = jpd.pair_histogram(jnp.asarray(a), jnp.asarray(b), R0, DR, NBINS,
                              box=None)
    got = fd.pair_histogram(_t(a), _t(b), R0, DR, NBINS, box=None)
    _within_one_flip_and_equal(got.numpy(), want)


def test_plain_matches_pallas_exclude_self():
    a = _coords(3, 150)
    want = jpd.pair_histogram(jnp.asarray(a), jnp.asarray(a), R0, DR, NBINS,
                              box=jnp.asarray(BOX), exclude_self=True)
    got = fd.pair_histogram(_t(a), _t(a), R0, DR, NBINS, box=_t(BOX),
                            exclude_self=True)
    _within_one_flip_and_equal(got.numpy(), want)
    assert float(got.sum()) <= 150 * 149      # the diagonal (d = 0) is out


def test_total_count_conservation():
    """A range wider than the largest minimum-image distance counts
    every pair exactly once."""
    a, b = _coords(4, 97), _coords(5, 131)
    got = fd.pair_histogram(_t(a), _t(b), 0.0, 30.0 / 64, 64, box=_t(BOX))
    assert float(got.sum()) == 97 * 131
    want = jpd.pair_histogram(jnp.asarray(a), jnp.asarray(b), 0.0,
                              30.0 / 64, 64, box=jnp.asarray(BOX))
    _within_one_flip_and_equal(got.numpy(), want)


def test_edges_argument_and_bin_limits():
    a, b = _coords(6, 30), _coords(7, 40)
    by_scalars = fd.pair_histogram(_t(a), _t(b), R0, DR, NBINS, box=_t(BOX))
    by_edges = fd.pair_histogram(_t(a), _t(b), box=_t(BOX),
                                 edges=EDGES.astype(np.float32))
    torch.testing.assert_close(by_scalars, by_edges, rtol=0, atol=0)
    one = fd.pair_histogram(_t(a), _t(b), 0.0, 12.0, 1, box=_t(BOX))
    assert float(one[0]) == float(by_edges.sum())
    top = fd.pair_histogram(_t(a), _t(b), 0.0, 12.0 / 512, 512, box=_t(BOX))
    assert float(top.sum()) == float(by_edges.sum())
    assert fd.MAX_NBINS == jpd.MAX_NBINS == 512
    with pytest.raises(ValueError, match="1..512 bins"):
        fd.pair_histogram(_t(a), _t(b), 0.0, 0.01, 513, box=_t(BOX))


def test_batch_matches_pallas_with_masked_frame():
    r = np.random.default_rng(8)
    B, N, M = 3, 120, 80
    ca = r.uniform(0, 25, size=(B, N, 3)).astype(np.float32)
    cb = r.uniform(0, 25, size=(B, M, 3)).astype(np.float32)
    boxes = np.tile(BOX, (B, 1))
    mask = np.array([1.0, 1.0, 0.0], np.float32)     # a padded frame
    want = jpd.pair_histogram_batch(jnp.asarray(ca), jnp.asarray(cb),
                                    jnp.asarray(boxes), jnp.asarray(mask),
                                    EDGES)
    got = fd.pair_histogram_batch(_t(ca), _t(cb), _t(boxes), _t(mask),
                                  _t(EDGES.astype(np.float32)))
    _within_one_flip_and_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    assert float(got[2]) == float(want[2]) == 2.0


def test_batch_poisons_triclinic_frames():
    r = np.random.default_rng(9)
    ca = r.uniform(0, 20, size=(2, 30, 3)).astype(np.float32)
    boxes = np.array([[20, 20, 20, 90, 90, 90], [20, 20, 20, 80, 90, 90]],
                     np.float32)
    mask = np.ones(2, np.float32)
    got = fd.pair_histogram_batch(_t(ca), _t(ca), _t(boxes), _t(mask),
                                  _t(EDGES.astype(np.float32)),
                                  exclude_self=True)
    want = jpd.pair_histogram_batch(jnp.asarray(ca), jnp.asarray(ca),
                                    jnp.asarray(boxes), jnp.asarray(mask),
                                    EDGES, exclude_self=True)
    assert torch.isnan(got[0]).all() and np.isnan(np.asarray(want[0])).all()
    # 1e-5 degrees off 90 is still orthorhombic (the 1e-4 cut)
    boxes[1, 3] = 90.0 + 1e-5
    ok = fd.pair_histogram_batch(_t(ca), _t(ca), _t(boxes), _t(mask),
                                 _t(EDGES.astype(np.float32)))
    assert torch.isfinite(ok[0]).all()


@pytest.mark.parametrize("edges,expected", [
    (np.linspace(0, 10, 11), True), (np.linspace(0.5, 15.0, 76), True),
    (np.array([0.0, 1.0, 3.0]), False), (np.array([1.0]), False),
    (np.array([0.0, 1.0, 1.0]), False)])
def test_uniform_edges(edges, expected):
    assert fd.uniform_edges(edges) is expected
    assert jpd.uniform_edges(edges) is expected


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    a = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fd.pair_histogram(a, a, R0, DR, NBINS)


# ---------------------------------------------------------------- InterRDF

N_WATERS, N_FRAMES, WBOX = 64, 4, 12.4     # 0.0336 waters/A^3, TIP3P's


@pytest.fixture(scope="module")
def waters():
    """(port universe, JAX universe) built from the same seed."""
    kw = dict(n_waters=N_WATERS, n_frames=N_FRAMES, box=WBOX, seed=2)
    return (testing.make_water_universe(**kw),
            jax_testing.make_water_universe(**kw))


def _rdf_pair(waters, sel1="name OW", sel2="name OW", run_kw=None,
              jax_run_kw=None, **kw):
    u, ju = waters
    p = analysis.InterRDF(u.select_atoms(sel1), u.select_atoms(sel2),
                          **kw).run(batch_size=2, **CPU, **(run_kw or {}))
    j = jax_analysis.InterRDF(ju.select_atoms(sel1), ju.select_atoms(sel2),
                              **kw).run(backend="jax", batch_size=2,
                                        **(jax_run_kw or run_kw or {}))
    return p, j


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_interrdf_engine_matches_jax(waters, engine, transfer_dtype):
    p, j = _rdf_pair(waters, nbins=24, range=(0.0, 6.0), engine=engine,
                     run_kw=dict(transfer_dtype=transfer_dtype))
    assert p._resolved_engine == engine
    _within_one_flip_and_equal(p.results.count, j.results.count)
    np.testing.assert_allclose(p.results.rdf, j.results.rdf, rtol=1e-6)
    np.testing.assert_array_equal(p.results.bins, j.results.bins)
    np.testing.assert_array_equal(p.results.edges, j.results.edges)
    assert p.results.count.sum() > 0


@pytest.mark.parametrize("norm", ["rdf", "density", "none"])
def test_interrdf_norms_match_jax(waters, norm):
    p, j = _rdf_pair(waters, nbins=20, range=(0.5, 6.0), engine="pallas",
                     norm=norm, jax_run_kw={})
    np.testing.assert_allclose(p.results.rdf, j.results.rdf, rtol=1e-6)
    if norm == "none":
        np.testing.assert_array_equal(p.results.rdf, p.results.count)


def test_interrdf_exclusion_block_generic_route(waters):
    p, j = _rdf_pair(waters, "name OW", "name HW1 HW2", nbins=20,
                     range=(0.5, 5.0), exclusion_block=(1, 2))
    assert p._resolved_engine == "xla"       # 'auto' with a block
    _within_one_flip_and_equal(p.results.count, j.results.count)
    np.testing.assert_allclose(p.results.rdf, j.results.rdf, rtol=1e-6)
    u, _ = waters
    full = analysis.InterRDF(u.select_atoms("name OW"),
                             u.select_atoms("name HW1 HW2"), nbins=20,
                             range=(0.5, 5.0)).run(batch_size=2, **CPU)
    near = p.results.bins < 1.3              # the O-H bonds are excluded
    assert (p.results.count[near].sum()
            == full.results.count[near].sum() - 2 * N_WATERS * N_FRAMES)
    with pytest.raises(ValueError, match="xla"):
        analysis.InterRDF(u.select_atoms("name OW"),
                          u.select_atoms("name HW1 HW2"), engine="pallas",
                          exclusion_block=(1, 2))


def test_interrdf_kernel_route_matches_serial_oracle(waters):
    u, ju = waters
    ow = u.select_atoms("name OW")
    kw = dict(nbins=24, range=(0.0, 6.0))
    serial = analysis.InterRDF(ow, ow, **kw).run(backend="serial")
    kern = analysis.InterRDF(ow, ow, engine="pallas", **kw).run(
        batch_size=2, **CPU)
    np.testing.assert_allclose(kern.results.count, serial.results.count,
                               atol=1.0)
    np.testing.assert_allclose(kern.results.rdf, serial.results.rdf,
                               rtol=2e-2, atol=5e-3)
    jow = ju.select_atoms("name OW")
    jserial = jax_analysis.InterRDF(jow, jow, **kw).run(backend="serial")
    np.testing.assert_array_equal(serial.results.count,
                                  jserial.results.count)
    np.testing.assert_allclose(serial.results.rdf, jserial.results.rdf,
                               rtol=1e-12)


def _triclinic_universe():
    n = 40
    top = Topology(names=np.array(["OW"] * n),
                   resnames=np.array(["SOL"] * n), resids=np.arange(n) + 1)
    coords = np.random.default_rng(5).uniform(
        0, 20, size=(2, n, 3)).astype(np.float32)
    dims = np.tile(np.array([20, 20, 20, 80, 90, 90], np.float32), (2, 1))
    return Universe(top, MemoryReader(coords, dimensions=dims))


def test_interrdf_kernel_route_rejects_triclinic():
    u = _triclinic_universe()
    ow = u.select_atoms("name OW")
    r = analysis.InterRDF(ow, ow, nbins=10, range=(0.0, 8.0),
                          engine="pallas").run(batch_size=2, **CPU)
    # run() reads nothing back; the NaN diagnostic fires on first access
    with pytest.raises(ValueError, match="triclinic"):
        r.results.rdf
    auto = analysis.InterRDF(ow, ow, nbins=10, range=(0.0, 8.0)).run(
        batch_size=2, **CPU)
    assert auto._resolved_engine == "xla"
    assert np.isfinite(auto.results.rdf).all()


def test_interrdf_rejects_a_frame_without_a_box(waters):
    u, _ = waters
    coords = u.trajectory.read_block(0, N_FRAMES)[0]
    dims = np.tile(np.array([WBOX] * 3 + [90.0] * 3, np.float32),
                   (N_FRAMES, 1))
    dims[1] = 0.0
    u2 = Universe(u.topology, MemoryReader(coords, dimensions=dims))
    ow = u2.select_atoms("name OW")
    r = analysis.InterRDF(ow, ow, nbins=10, range=(0.0, 6.0),
                          engine="pallas").run(batch_size=2, **CPU)
    with pytest.raises(ValueError, match="1 of 4 frames have no periodic"):
        r.results.rdf


def test_interrdf_engine_resolution(waters):
    u, _ = waters
    ow = u.select_atoms("name OW")
    r = analysis.InterRDF(ow, ow, nbins=10, range=(0.0, 8.0))
    r._prepare()
    assert r._resolve_engine() == "xla"     # no GPU here: the generic route
    done = analysis.InterRDF(ow, ow, nbins=10, range=(0.0, 6.0)).run(
        batch_size=2, **CPU)
    assert done._resolved_engine == "xla"   # 'auto' on the CPU
    # the atom-sharded ring is a mesh-only engine: it resolves to
    # itself and the single-device backend refuses it
    ring = analysis.InterRDF(ow, ow, nbins=10, range=(0.0, 6.0),
                             engine="ring")
    ring._prepare()
    assert ring._resolve_engine() == "ring" and ring._mesh_only
    with pytest.raises(ValueError, match="mesh"):
        ring.run(batch_size=2, **CPU)
    with pytest.raises(ValueError, match="engine must be"):
        analysis.InterRDF(ow, ow, engine="fused")
    with pytest.raises(ValueError, match="norm must be"):
        analysis.InterRDF(ow, ow, norm="bogus")


# ------------------------------------------------------------- InterRDF_s

def test_interrdf_s_matches_jax(waters):
    u, ju = waters

    def ags(uni):
        ow = uni.select_atoms("name OW")
        return [(ow[:3], ow[3:7]), (uni.select_atoms("name HW1")[:2], ow[:3])]

    kw = dict(nbins=20, range=(0.0, 6.0))
    p = analysis.InterRDF_s(u, ags(u), **kw).run(batch_size=2, **CPU)
    j = jax_analysis.InterRDF_s(ju, ags(ju), **kw).run(backend="jax",
                                                        batch_size=2)
    s = analysis.InterRDF_s(u, ags(u), **kw).run(backend="serial")
    assert [c.shape for c in p.results.count] == [(3, 4, 20), (2, 3, 20)]
    for pc, jc, sc in zip(p.results.count, j.results.count, s.results.count):
        np.testing.assert_array_equal(pc, np.asarray(jc))
        np.testing.assert_allclose(pc, sc, atol=1.0)
    for pr_, jr in zip(p.results.rdf, j.results.rdf):
        np.testing.assert_allclose(pr_, np.asarray(jr), rtol=1e-6)
    for pc, jc in zip(p.get_cdf(), j.get_cdf()):
        np.testing.assert_allclose(pc, np.asarray(jc), rtol=1e-6)


# ------------------------------------------------- ContactMap and friends

@pytest.fixture(scope="module")
def proteins():
    kw = dict(n_residues=12, n_frames=6, noise=0.4, seed=5)
    return (testing.make_protein_universe(**kw),
            jax_testing.make_protein_universe(**kw))


def test_contact_map_matches_jax(proteins):
    u, ju = proteins
    p = adist.ContactMap(u.select_atoms("name CA"), cutoff=8.0).run(
        batch_size=4, **CPU)
    j = jax_adist.ContactMap(ju.select_atoms("name CA"), cutoff=8.0).run(
        backend="jax", batch_size=4)
    np.testing.assert_array_equal(p.results.contact_fraction,
                                  j.results.contact_fraction)
    np.testing.assert_array_equal(p.results.contact_map,
                                  j.results.contact_map)
    assert p.results.n_frames == j.results.n_frames == 6
    assert p.results.contact_map.diagonal().all()


@pytest.mark.parametrize("batch_size", [4, 6])
def test_pairwise_distances_matches_jax(proteins, batch_size):
    u, ju = proteins
    want = jax_adist.PairwiseDistances(ju.select_atoms("name CA")).run()
    ca = u.select_atoms("name CA")
    serial = adist.PairwiseDistances(ca).run(backend="serial")
    dev = adist.PairwiseDistances(ca).run(batch_size=batch_size, **CPU)
    assert dev.results.distances.shape == want.results.distances.shape == (
        6, 66)
    np.testing.assert_array_equal(serial.results.distances,
                                  want.results.distances)
    np.testing.assert_allclose(dev.results.distances,
                               want.results.distances, rtol=1e-5, atol=1e-4)
    assert dev.results.n_frames == 6


def test_distance_helpers_match_jax(proteins):
    u, ju = proteins
    ca, jca = u.select_atoms("name CA"), ju.select_atoms("name CA")
    np.testing.assert_array_equal(
        adist.dist(ca[:5], ca[5:10], offset=(1, 2), box=BOX),
        jax_adist.dist(jca[:5], jca[5:10], offset=(1, 2), box=BOX))
    x = ca.positions
    np.testing.assert_array_equal(
        adist.contact_matrix(x, cutoff=6.0, box=BOX),
        jax_adist.contact_matrix(x, cutoff=6.0, box=BOX))
    np.testing.assert_array_equal(
        adist.contact_matrix(x, 6.0, returntype="sparse", box=BOX).toarray(),
        jax_adist.contact_matrix(x, 6.0, returntype="sparse",
                                 box=BOX).toarray())
    got = adist.between(u.atoms, ca[:3], ca[3:6], 6.0)
    want = jax_adist.between(ju.atoms, jca[:3], jca[3:6], 6.0)
    np.testing.assert_array_equal(got.indices, want.indices)
