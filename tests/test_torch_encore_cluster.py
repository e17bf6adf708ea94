"""Twin of ``tests/test_encore_cluster.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

encore.ces / encore.dres (clustering- and dimensionality-
reduction-based ensemble similarity): constructed two-state ensembles
with known cluster structure, the ln 2 saturation bound for disjoint
ensembles, near-zero divergence for identical ensembles, clusterer
unit behavior (affinity propagation + k-means on separable data), SPE
geometry preservation, and KDE correctness against the closed-form
Gaussian density."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis.encore import (
    LN2, AffinityPropagationNative, GaussianKDE, KMeansNative,
    StochasticProximityEmbeddingNative, ces,
    conformational_distance_matrix, dres)

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


def _blob(state, t=30, n=5, scale=0.05, seed=0):
    """(T, n, 3) tight conformational cluster: a seeded base structure
    per ``state`` plus thermal noise.  Distinct states differ in
    INTERNAL geometry (different random bases) — superposed RMSD is
    rigid-motion-invariant, so translated copies of one base would be
    the SAME conformation."""
    base = np.random.default_rng(99 + state).normal(scale=3.0,
                                                    size=(n, 3))
    rng = np.random.default_rng(seed)
    return base + rng.normal(scale=scale, size=(t, n, 3))


# --- clusterers -------------------------------------------------------

def test_affinity_propagation_two_clusters():
    a = _blob(0, seed=1)
    b = _blob(1, seed=2)
    joint = np.concatenate([a, b])
    d = conformational_distance_matrix(joint)
    labels = AffinityPropagationNative(preference=-10.0)(-d)
    assert len(labels) == len(joint)
    # the two blobs land in (at least) two clusters and no cluster
    # straddles them
    la, lb = set(labels[: len(a)].tolist()), set(labels[len(a):].tolist())
    assert la.isdisjoint(lb)


def test_affinity_propagation_rejects_bad_shapes():
    with pytest.raises(ValueError, match="square"):
        AffinityPropagationNative()(np.zeros((3, 4)))
    with pytest.raises(ValueError, match="damping"):
        AffinityPropagationNative(damping=0.2)


def test_kmeans_separable():
    x = np.concatenate([np.random.default_rng(0).normal(0, 0.1, (20, 2)),
                        np.random.default_rng(1).normal(9, 0.1, (25, 2))])
    labels = KMeansNative(n_clusters=2)(x)
    assert len(set(labels[:20].tolist())) == 1
    assert len(set(labels[20:].tolist())) == 1
    assert labels[0] != labels[-1]


def test_kmeans_validates():
    with pytest.raises(ValueError, match="n_clusters"):
        KMeansNative(n_clusters=0)


# --- ces --------------------------------------------------------------

def test_ces_identical_ensembles_zero():
    a = _blob(0, seed=3)
    d, details = ces([a, a.copy()])
    assert d.shape == (2, 2)
    assert d[0, 1] == pytest.approx(0.0, abs=1e-12)
    assert d[0, 0] == 0.0
    assert details["n_clusters"] >= 1


def test_ces_disjoint_ensembles_saturate():
    """Ensembles that never share a cluster sit at the JS bound ln 2."""
    a = _blob(0, seed=4)
    b = _blob(1, seed=5)
    d, details = ces([a, b])
    assert d[0, 1] == pytest.approx(LN2, abs=1e-9)
    assert details["populations"].shape[0] == 2


def test_ces_mixed_ensembles_intermediate():
    """An ensemble that splits its frames between both states lands
    strictly between 0 and ln 2 against a pure ensemble."""
    pure = _blob(0, seed=6)
    mixed = np.concatenate([_blob(0, t=15, seed=7),
                            _blob(1, t=15, seed=8)])
    d, _ = ces([pure, mixed])
    assert 0.05 < d[0, 1] < LN2 - 0.05


def test_ces_three_ensembles_symmetric():
    a = _blob(0, seed=9)
    b = _blob(1, seed=10)
    c = _blob(2, seed=11)
    d, _ = ces([a, b, c])
    assert d.shape == (3, 3)
    assert np.allclose(d, d.T)
    assert np.allclose(np.diag(d), 0.0)


def test_ces_kmeans_method_and_precomputed_matrix():
    a = _blob(0, seed=12)
    b = _blob(1, seed=13)
    d_km, _ = ces([a, b], clustering_method=KMeansNative(n_clusters=2))
    assert d_km[0, 1] == pytest.approx(LN2, abs=1e-9)
    # precomputed distance matrix short-circuits the device kernel
    joint = np.concatenate([a, b])
    dm = conformational_distance_matrix(joint)
    d_pre, details = ces([a, b], distance_matrix=dm)
    assert d_pre[0, 1] == pytest.approx(LN2, abs=1e-9)
    assert details["distance_matrix"] is not None
    with pytest.raises(ValueError, match="does not match"):
        ces([a, b], distance_matrix=dm[:-1, :-1])
    # a coordinate-space clusterer cannot consume a distance matrix —
    # loud error instead of silently discarding the expensive input
    with pytest.raises(ValueError, match="clusters coordinates"):
        ces([a, b], clustering_method=KMeansNative(n_clusters=2),
            distance_matrix=dm)


def test_ces_rejects_single_ensemble():
    with pytest.raises(ValueError, match="two ensembles"):
        ces([_blob(0)])


# --- SPE + KDE --------------------------------------------------------

def test_spe_preserves_separation():
    """Two far-apart blobs stay far apart relative to their internal
    spread after embedding to 2D."""
    a = _blob(0, seed=14)
    b = _blob(1, seed=15)
    d = conformational_distance_matrix(np.concatenate([a, b]))
    emb = StochasticProximityEmbeddingNative(
        dimension=2, distance_cutoff=5.0, ncycle=60, nstep=4000)(d)
    assert emb.shape == (60, 2)
    ca, cb = emb[:30].mean(0), emb[30:].mean(0)
    # spread about each centroid (NOT .std() of raw coordinates, which
    # is dominated by the centroid's position itself)
    spread = max(np.linalg.norm(emb[:30] - ca, axis=1).mean(),
                 np.linalg.norm(emb[30:] - cb, axis=1).mean())
    assert np.linalg.norm(ca - cb) > 5 * spread


def test_spe_deterministic():
    d = conformational_distance_matrix(_blob(0, seed=16))
    m = StochasticProximityEmbeddingNative(ncycle=5, nstep=500, seed=3)
    assert np.array_equal(m(d), m(d))


def test_gaussian_kde_normalizes():
    """The KDE is a density: exp(logpdf) integrates to ~1."""
    kde = GaussianKDE(np.random.default_rng(0).normal(0, 1.0, (500, 2)))
    g = np.linspace(-6, 6, 61)
    xx, yy = np.meshgrid(g, g)
    grid = np.stack([xx.ravel(), yy.ravel()], axis=1)
    mass = np.exp(kde.logpdf(grid)).sum() * (g[1] - g[0]) ** 2
    assert mass == pytest.approx(1.0, rel=0.02)


def test_gaussian_kde_closed_form_gaussian_kernel():
    """Against the analytic mixture: for KNOWN centers and bandwidth H,
    logpdf(x) must equal log( mean_i N(x; c_i, H) ) exactly — computed
    here independently from the same H the KDE built (Scott's rule)."""
    rng = np.random.default_rng(3)
    centers = rng.normal(0.0, 2.0, (6, 2))
    kde = GaussianKDE(centers)
    h = kde.h                             # (2, 2) bandwidth matrix
    hinv = np.linalg.inv(h)
    norm = 1.0 / (2 * np.pi * np.sqrt(np.linalg.det(h)))
    x = np.array([[0.3, -1.2], [4.0, 4.0], [centers[0, 0],
                                            centers[0, 1]]])
    expected = np.log(np.array([
        np.mean([norm * np.exp(-0.5 * (xi - c) @ hinv @ (xi - c))
                 for c in centers]) for xi in x]))
    np.testing.assert_allclose(kde.logpdf(x), expected, rtol=1e-10)


def test_gaussian_kde_degenerate_spread_jitter():
    """Near-identical centers exercise the jitter branch: the KDE must
    stay finite and normalized instead of failing Cholesky."""
    pts = np.zeros((4, 2))
    pts[1:] = np.random.default_rng(0).normal(0, 1e-9, (3, 2))
    kde = GaussianKDE(pts)
    assert np.isfinite(kde.logpdf(np.array([[0.0, 0.0]]))).all()


def test_gaussian_kde_sampling_follows_density():
    rng = np.random.default_rng(1)
    kde = GaussianKDE(rng.normal(5.0, 2.0, (800, 1)))
    s = kde.sample(4000, np.random.default_rng(2))
    assert s.mean() == pytest.approx(5.0, abs=0.2)
    assert s.std() == pytest.approx(2.0, rel=0.15)


# --- dres -------------------------------------------------------------

def test_dres_identical_low_disjoint_high():
    a = _blob(0, seed=17)
    b = _blob(1, seed=18)
    d_same, _ = dres([a, a.copy()], nsamples=400)
    d_diff, details = dres([a, b], nsamples=400)
    assert d_same[0, 1] < 0.05
    assert d_diff[0, 1] > 0.5          # near the ln 2 bound
    assert d_diff[0, 1] <= LN2
    assert details["embedded"].shape == (60, 3)


def test_dres_deterministic_and_symmetric():
    a = _blob(0, seed=19)
    b = _blob(1, seed=20)
    d1, _ = dres([a, b], nsamples=200, seed=5)
    d2, _ = dres([a, b], nsamples=200, seed=5)
    assert np.array_equal(d1, d2)
    assert np.allclose(d1, d1.T)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("method", ["ap", "kmeans", "spe"])
def test_clustering_matches_jax_package(seed, method):
    """The native clustering and embedding on the same joint coordinates
    in both packages: equal labels, the embedding within 1e-6."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(3, 6))
    x = np.concatenate([c + rng.normal(scale=0.5, size=(10, 6))
                        for c in centers])
    d = np.linalg.norm(x[:, None] - x[None], axis=-1)

    def case(mod):
        enc = mod("analysis.encore")
        if method == "ap":
            return enc.AffinityPropagationNative(preference=-20.0)(-d ** 2)
        if method == "kmeans":
            return enc.KMeansNative(n_clusters=3, seed=seed)(x)
        return enc.StochasticProximityEmbeddingNative(
            dimension=2, seed=seed)(d)
    ref, port = both(case)
    if method == "spe":
        np.testing.assert_allclose(port, ref, atol=1e-6)
    else:
        assert_same(ref, port)
