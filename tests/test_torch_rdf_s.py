"""Twin of ``tests/test_rdf_s.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

InterRDF_s (site-resolved RDF) and analysis.distances.contact_matrix
— upstream rdf/distances companions."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import InterRDF, InterRDF_s
from mdanalysis_mpi_tpu_torch.analysis.distances import contact_matrix
from mdanalysis_mpi_tpu_torch.testing import make_water_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, mesh_kw, port_runs_on_the_cpu)


@pytest.fixture(scope="module")
def uni():
    return make_water_universe(n_waters=24, n_frames=6, box=12.0, seed=3)


def test_shapes_and_backend_parity(uni):
    ow = uni.select_atoms("name OW")
    s1, s2 = ow[:3], ow[3:7]
    hw = uni.select_atoms("name HW1")[:2]
    ags = [(s1, s2), (hw, s1)]
    kw = dict(nbins=20, range=(0.0, 6.0))
    s = InterRDF_s(uni, ags, **kw).run(backend="serial")
    assert [r.shape for r in s.results.rdf] == [(3, 4, 20), (2, 3, 20)]
    j = InterRDF_s(uni, ags, **kw).run(backend="torch", batch_size=2)
    for rs, rj in zip(s.results.rdf, j.results.rdf):
        np.testing.assert_allclose(np.asarray(rj), rs, atol=1e-3)
    m = InterRDF_s(uni, ags, **kw).run(**mesh_kw("mesh"), batch_size=1)
    for rs, rm in zip(s.results.count, m.results.count):
        np.testing.assert_allclose(np.asarray(rm), rs, atol=1e-6)


def test_sums_match_aggregate_interrdf(uni):
    """Summing site-resolved counts over all (i, j) must reproduce the
    aggregate InterRDF histogram for the same groups."""
    ow = uni.select_atoms("name OW")
    g1, g2 = ow[:4], ow[4:9]
    kw = dict(nbins=16, range=(0.0, 6.0))
    sites = InterRDF_s(uni, [(g1, g2)], **kw).run(backend="serial")
    agg = InterRDF(g1, g2, **kw).run(backend="serial")
    np.testing.assert_allclose(sites.results.count[0].sum(axis=(0, 1)),
                               agg.results.count, atol=1e-9)
    # and the rdf norm differs exactly by the pair count
    np.testing.assert_allclose(
        sites.results.rdf[0].sum(axis=(0, 1)) / (g1.n_atoms * g2.n_atoms),
        agg.results.rdf, atol=1e-9)


def test_get_cdf_and_norms(uni):
    ow = uni.select_atoms("name OW")
    ags = [(ow[:2], ow[2:5])]
    r = InterRDF_s(uni, ags, nbins=12, range=(0.0, 6.0)).run(
        backend="serial")
    cdf = r.get_cdf()
    assert cdf[0].shape == (2, 3, 12)
    # cdf ends at the mean total pair count within range per frame
    np.testing.assert_allclose(
        cdf[0][..., -1], r.results.count[0].sum(axis=-1) / 6.0)
    none = InterRDF_s(uni, ags, nbins=12, range=(0.0, 6.0),
                      norm="none").run(backend="serial")
    np.testing.assert_allclose(none.results.rdf[0], none.results.count[0])


def test_validation(uni):
    ow = uni.select_atoms("name OW")
    with pytest.raises(ValueError, match="pair"):
        InterRDF_s(uni, [(ow[:2],)])
    with pytest.raises(ValueError, match="empty"):
        InterRDF_s(uni, [(ow[:2], ow[:0])])
    with pytest.raises(ValueError, match="norm"):
        InterRDF_s(uni, [(ow[:2], ow[2:4])], norm="bogus")
    with pytest.raises(ValueError, match="at least one"):
        InterRDF_s(uni, [])
    with pytest.raises(ValueError, match="budget"):
        InterRDF_s(uni, [(ow, ow)], nbins=60_000).run(backend="serial")


def test_contact_matrix(uni):
    ow = uni.select_atoms("name OW")
    x = ow.positions
    box = uni.trajectory.ts.dimensions
    dense = contact_matrix(x, cutoff=4.0, box=box)
    assert dense.dtype == bool and dense.shape == (24, 24)
    assert dense.diagonal().all()
    assert (dense == dense.T).all()
    sp = contact_matrix(x, cutoff=4.0, box=box, returntype="sparse")
    np.testing.assert_array_equal(sp.toarray(), dense)
    with pytest.raises(ValueError, match="returntype"):
        contact_matrix(x, returntype="bogus")


def test_contact_matrix_boundary_and_zero_volume_box(uni):
    # exact-cutoff pair: both returntypes must agree (strict <)
    x = np.array([[0.0, 0, 0], [4.0, 0, 0], [1.0, 0, 0]], np.float32)
    dense = contact_matrix(x, cutoff=4.0)
    sp = contact_matrix(x, cutoff=4.0, returntype="sparse")
    assert not dense[0, 1]                     # d == cutoff excluded
    np.testing.assert_array_equal(sp.toarray(), dense)

    # a zero-volume box frame must fail the serial InterRDF_s path
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    ow = uni.select_atoms("name OW")
    coords = np.zeros((2, uni.topology.n_atoms, 3), np.float32)
    dims = np.zeros((2, 6), np.float32)
    u0 = Universe(uni.topology, MemoryReader(coords, dimensions=dims))
    g = u0.select_atoms("name OW")
    with pytest.raises(ValueError, match="zero-volume"):
        InterRDF_s(u0, [(g[:2], g[2:4])], nbins=8,
                   range=(0.0, 4.0)).run(backend="serial")


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


def test_interrdf_s_matches_jax_package():
    """The reference's site-resolved case (its ``uni`` fixture and
    group pairs): counts equal, g(r) within its 1e-3."""
    def case(mod):
        u = mod("testing").make_water_universe(n_waters=40, n_frames=6,
                                               seed=1)
        ow = u.select_atoms("name OW")
        hw = u.select_atoms("name HW1")
        ags = [(ow[:3], ow[3:7]), (hw[:2], ow[:3])]
        r = mod("analysis").InterRDF_s(u, ags, nbins=20,
                                       range=(0.0, 6.0)).run(
            backend="jax" if mod().__name__ == "mdanalysis_mpi_tpu"
            else "torch", batch_size=2)
        return [np.asarray(c) for c in r.results.count], \
            [np.asarray(g) for g in r.results.rdf]
    (rc, rg), (pc, pg) = both(case)
    assert_same(rc, pc)
    assert_same(rg, pg, atol=1e-3)


@pytest.mark.parametrize("cutoff", [2.5, 4.0])
def test_contact_matrix_matches_jax_package(cutoff):
    def case(mod):
        u = mod("testing").make_water_universe(n_waters=40, n_frames=1,
                                               seed=3)
        ts = u.trajectory[0]
        return mod("analysis.distances").contact_matrix(
            ts.positions, cutoff=cutoff, box=ts.dimensions)
    assert_same(*both(case))
