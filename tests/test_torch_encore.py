"""The port's encore (``analysis/encore.py``): the JAX package's
tests/test_encore.py (hes: closed-form oracle on known Gaussians,
invariance under rigid motion with align=True, symmetry and zero
diagonals, the Ledoit-Wolf estimator's SPD guarantee) and
tests/test_encore_cluster.py (ces / dres on constructed two-state
ensembles, the ln 2 bound, the clusterers, SPE and the KDE) case by
case, with the conformational distance matrix on ``device="cpu"``; and
against the JAX package on the same inputs: the host copies (hes, the
clusterers, the KDE, ces and dres on one distance matrix) EQUAL, the
distance matrix within the 5e-3 Å of tests/test_diffusionmap.py."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import hes
from mdanalysis_mpi_tpu_torch.analysis.encore import (
    LN2, AffinityPropagationNative, GaussianKDE, KMeansNative,
    StochasticProximityEmbeddingNative, ces,
    conformational_distance_matrix, dres, ledoit_wolf_covariance)
from mdanalysis_mpi_tpu_torch.testing import (make_protein_universe,
                                              random_rotation_matrices)


def _gauss_paths(mu_shift=0.0, scale=1.0, t=4000, n=4, seed=0,
                 base_seed=100):
    """(T, n, 3) samples from an isotropic Gaussian around a base;
    the base structure is seeded SEPARATELY so two ensembles can share
    it exactly (mean differences then come only from mu_shift)."""
    base = np.random.default_rng(base_seed).normal(scale=5.0,
                                                   size=(n, 3))
    rng = np.random.default_rng(seed)
    return base + mu_shift + rng.normal(scale=scale, size=(t, n, 3))


def test_identical_ensembles_zero():
    a = _gauss_paths(seed=1)
    d, details = hes([a, a.copy()], align=False)
    assert d.shape == (2, 2)
    assert d[0, 0] == 0.0 and d[1, 1] == 0.0
    assert d[0, 1] == pytest.approx(0.0, abs=1e-8)
    assert details["estimator"] == "shrinkage"


def test_closed_form_isotropic_oracle():
    """Two well-sampled isotropic Gaussians with known mean shift and
    variances: d = 1/4 |dmu|^2 (1/s1 + 1/s2) + p/2 (s1/s2 + s2/s1 - 2).
    """
    p = 12                               # 4 atoms x 3
    s1, s2, shift = 1.0, 1.5, 0.7
    a = _gauss_paths(scale=np.sqrt(s1), t=60000, seed=2)
    b = _gauss_paths(mu_shift=shift, scale=np.sqrt(s2), t=60000, seed=3)
    d, _ = hes([a, b], align=False, cov_estimator="ml")
    dmu2 = p * shift ** 2                # shift in every coordinate
    expect = (0.25 * dmu2 * (1 / s1 + 1 / s2)
              + 0.5 * p * (s1 / s2 + s2 / s1 - 2.0))
    assert d[0, 1] == pytest.approx(expect, rel=0.1)


def test_align_removes_rigid_motion():
    rng = np.random.default_rng(4)
    a = _gauss_paths(t=40, n=10, seed=5)
    rots = random_rotation_matrices(len(a), rng)
    b = np.einsum("tnj,tij->tni", a, rots) + rng.normal(
        scale=8.0, size=(len(a), 1, 3))
    d_aligned, _ = hes([a, b], align=True)
    d_raw, _ = hes([a, b], align=False)
    assert d_aligned[0, 1] < 0.05 * d_raw[0, 1]


def test_universe_inputs_and_symmetry():
    u1 = make_protein_universe(n_residues=8, n_frames=12, noise=0.3,
                               seed=6)
    u2 = make_protein_universe(n_residues=8, n_frames=10, noise=0.6,
                               seed=7)
    u3 = make_protein_universe(n_residues=8, n_frames=12, noise=0.3,
                               seed=6)
    d, details = hes([u1, u2, u3], select="name CA")
    assert d.shape == (3, 3)
    assert np.allclose(d, d.T)
    assert (d >= -1e-9).all()
    # same-seed universes are identical ensembles
    assert d[0, 2] == pytest.approx(0.0, abs=1e-6)
    assert d[0, 1] > d[0, 2]
    assert len(details["means"]) == 3


def test_ledoit_wolf_spd_few_frames():
    """T=5 frames in p=30 dims: the ML covariance is rank-deficient;
    shrinkage must still be SPD (all eigenvalues > 0)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 30))
    c = ledoit_wolf_covariance(x)
    w = np.linalg.eigvalsh(c)
    assert w.min() > 0
    # and hes runs end-to-end in that regime
    a = _gauss_paths(t=6, n=10, seed=9)
    b = _gauss_paths(t=6, n=10, mu_shift=2.0, seed=10)
    d, _ = hes([a, b], align=False)
    assert np.isfinite(d).all() and d[0, 1] > 0


def test_hes_validation():
    a = _gauss_paths(t=4)
    with pytest.raises(ValueError, match="at least two"):
        hes([a])
    with pytest.raises(ValueError, match="widths"):
        hes([a, _gauss_paths(t=4, n=6)])
    with pytest.raises(ValueError, match="at least 2 frames"):
        hes([a, a[:1]])
    with pytest.raises(ValueError, match="cov_estimator"):
        hes([a, a], cov_estimator="oas")
    with pytest.raises(ValueError, match="at least 2"):
        ledoit_wolf_covariance(np.zeros((1, 5)))


def test_zero_variance_named_error():
    a = _gauss_paths(t=6)
    frozen = np.repeat(a[:1], 6, axis=0)
    with pytest.raises(ValueError, match="ensemble 1 has zero variance"):
        hes([a, frozen], align=False)


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
    d = conformational_distance_matrix(joint, device="cpu")
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
    d, details = ces([a, a.copy()], device="cpu")
    assert d.shape == (2, 2)
    assert d[0, 1] == pytest.approx(0.0, abs=1e-12)
    assert d[0, 0] == 0.0
    assert details["n_clusters"] >= 1


def test_ces_disjoint_ensembles_saturate():
    """Ensembles that never share a cluster sit at the JS bound ln 2."""
    a = _blob(0, seed=4)
    b = _blob(1, seed=5)
    d, details = ces([a, b], device="cpu")
    assert d[0, 1] == pytest.approx(LN2, abs=1e-9)
    assert details["populations"].shape[0] == 2


def test_ces_mixed_ensembles_intermediate():
    """An ensemble that splits its frames between both states lands
    strictly between 0 and ln 2 against a pure ensemble."""
    pure = _blob(0, seed=6)
    mixed = np.concatenate([_blob(0, t=15, seed=7),
                            _blob(1, t=15, seed=8)])
    d, _ = ces([pure, mixed], device="cpu")
    assert 0.05 < d[0, 1] < LN2 - 0.05


def test_ces_three_ensembles_symmetric():
    a = _blob(0, seed=9)
    b = _blob(1, seed=10)
    c = _blob(2, seed=11)
    d, _ = ces([a, b, c], device="cpu")
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
    dm = conformational_distance_matrix(joint, device="cpu")
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
        ces([_blob(0)], device="cpu")


# --- SPE + KDE --------------------------------------------------------

def test_spe_preserves_separation():
    """Two far-apart blobs stay far apart relative to their internal
    spread after embedding to 2D."""
    a = _blob(0, seed=14)
    b = _blob(1, seed=15)
    d = conformational_distance_matrix(np.concatenate([a, b]),
                                       device="cpu")
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
    d = conformational_distance_matrix(_blob(0, seed=16), device="cpu")
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
    d_same, _ = dres([a, a.copy()], nsamples=400, device="cpu")
    d_diff, details = dres([a, b], nsamples=400, device="cpu")
    assert d_same[0, 1] < 0.05
    assert d_diff[0, 1] > 0.5          # near the ln 2 bound
    assert d_diff[0, 1] <= LN2
    assert details["embedded"].shape == (60, 3)


def test_dres_deterministic_and_symmetric():
    a = _blob(0, seed=19)
    b = _blob(1, seed=20)
    d1, _ = dres([a, b], nsamples=200, seed=5, device="cpu")
    d2, _ = dres([a, b], nsamples=200, seed=5, device="cpu")
    assert np.array_equal(d1, d2)
    assert np.allclose(d1, d1.T)


# --- the device route and the JAX package ------------------------------

def test_distance_matrix_default_device_is_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conformational_distance_matrix(_blob(0, t=4))


def test_distance_matrix_against_jax_package():
    from mdanalysis_mpi_tpu.analysis.encore import (
        conformational_distance_matrix as j_cdm)

    joint = np.concatenate([_blob(0, seed=21), _blob(1, seed=22)])
    dj = j_cdm(joint)
    dt = conformational_distance_matrix(joint, device="cpu")
    np.testing.assert_allclose(dt, dj, atol=5e-3)
    np.testing.assert_allclose(dt, dt.T)
    np.testing.assert_array_equal(np.diag(dt), 0.0)
    from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd

    # the port's float64 solve against the host Kabsch oracle
    assert dt[3, 40] == pytest.approx(rmsd(joint[40].astype(np.float32),
                                           joint[3].astype(np.float32),
                                           superposition=True), abs=1e-9)


def test_host_copies_equal_jax_package():
    from mdanalysis_mpi_tpu.analysis import encore as j

    a = _gauss_paths(t=30, n=6, seed=23)
    b = _gauss_paths(t=30, n=6, mu_shift=0.4, seed=24)
    d_t, det_t = hes([a, b])
    d_j, det_j = j.hes([a, b])
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(det_t["covariances"][1],
                                  det_j["covariances"][1])
    x = _blob(0, seed=25)
    joint = np.concatenate([x, _blob(1, seed=26)])
    dm = conformational_distance_matrix(joint, device="cpu")
    c_t, cd_t = ces([x, joint[30:]], distance_matrix=dm)
    c_j, cd_j = j.ces([x, joint[30:]], distance_matrix=dm)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(cd_t["labels"], cd_j["labels"])
    r_t, rd_t = dres([x, joint[30:]], distance_matrix=dm, nsamples=200)
    r_j, rd_j = j.dres([x, joint[30:]], distance_matrix=dm, nsamples=200)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(rd_t["embedded"], rd_j["embedded"])
