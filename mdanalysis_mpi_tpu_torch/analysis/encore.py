"""Ensemble similarity (upstream ``MDAnalysis.analysis.encore``; the
JAX package's ``analysis/encore.py``).

:func:`hes` — the Harmonic Ensemble Similarity: model each ensemble
(trajectory) as a multivariate Gaussian over its flattened (3N,)
configuration vectors and take the symmetrized harmonic divergence

    d(A, B) = ¼ (μ_A − μ_B)ᵀ (Σ_A⁻¹ + Σ_B⁻¹) (μ_A − μ_B)
            + ½ tr(Σ_A Σ_B⁻¹ + Σ_B Σ_A⁻¹ − 2·I)

(upstream ``encore.hes``'s closed form).  Ensembles are rigid-aligned
to a common reference first (every frame Kabsch-superposed onto the
first ensemble's first frame — without this, μ differences would be
dominated by tumbling).

Covariance estimators: ``"shrinkage"`` (default, Ledoit–Wolf 2004 —
the estimator upstream defaults to, SPD even with far fewer frames
than 3N dimensions) or ``"ml"`` (sample covariance; needs T ≫ 3N and a
jitter to invert).

Shape: each ensemble's covariance is ONE (T, 3N)ᵀ(T, 3N) matrix
product and the cross-ensemble terms are Cholesky solves; everything
runs in float64 on the host at typical Cα sizes (3N ~ 10³), with the
per-frame alignment reusing the shared QCP machinery (ops/host.py).

:func:`ces` / :func:`dres` — the clustering- and dimensionality-
reduction-based similarities (upstream ``encore.ces``/``encore.dres``),
implemented from scratch on this repo's own machinery instead of
upstream's vendored C + scikit-learn backends:

- the joint conformational distance matrix is DiffusionMap's device
  superposed-RMSD matrix (``diffusionmap.pairwise_rmsd_device`` — all
  T² Kabsch problems as row blocks of matrix products and the QCP top
  eigenvalue, on ``device``: ``cuda`` unless given, threaded through
  ``ces`` and ``dres``);
- :class:`AffinityPropagationNative` (upstream's default clusterer) is
  a dense vectorized message-passing loop — (T, T) responsibility/
  availability updates are row/column reductions, NumPy-whole-matrix
  per iteration, no per-point Python loops;
- :class:`KMeansNative` is seeded k-means++ Lloyd iteration on the
  aligned flattened coordinates;
- :class:`StochasticProximityEmbeddingNative` runs chunked stochastic
  proximity embedding (random pair batches, ``np.add.at`` scatter
  updates — a documented batched variant of the sequential original);
- :func:`dres` densities come from :class:`GaussianKDE` (Scott's-rule
  full-covariance kernels) with the Jensen–Shannon divergence
  estimated by seeded Monte Carlo over KDE samples, natural log,
  capped at ln 2 — upstream's estimator contract.

Determinism: every stochastic component (AP tie-breaking noise, SPE
pair draws, KDE sampling) takes an explicit integer seed and defaults
to a fixed one — repeat calls are bit-reproducible.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.analysis.psa import _as_path, align_path


def ledoit_wolf_covariance(x: np.ndarray) -> np.ndarray:
    """Ledoit–Wolf shrinkage covariance of rows of ``x`` (T, p):
    ``(1−δ)·S + δ·m·I`` with the closed-form optimal δ (LW 2004).
    SPD for any T ≥ 2."""
    x = np.asarray(x, np.float64)
    t, p = x.shape
    if t < 2:
        raise ValueError(f"need at least 2 frames, got {t}")
    xc = x - x.mean(axis=0)
    s = xc.T @ xc / t
    m = np.trace(s) / p
    d2 = ((s - m * np.eye(p)) ** 2).sum() / p
    # b̄² = (1/T²) Σ_t ‖x_t x_tᵀ − S‖_F² / p, via the expansion
    # ‖x xᵀ − S‖² = (xᵀx)² − 2 xᵀSx + ‖S‖²
    xtx = (xc * xc).sum(axis=1)
    xsx = ((xc @ s) * xc).sum(axis=1)
    s_f2 = (s * s).sum()
    b2 = (xtx ** 2 - 2.0 * xsx + s_f2).sum() / (t * t) / p
    b2 = min(b2, d2)
    delta = b2 / d2 if d2 > 0 else 1.0
    return (1.0 - delta) * s + delta * m * np.eye(p)


def _aligned_flat(paths: list) -> list:
    """Kabsch-align every frame of every path onto paths[0][0] (the
    shared :func:`~mdanalysis_mpi_tpu_torch.analysis.psa.align_path`);
    return flattened (T_i, 3N) float64 arrays."""
    ref = paths[0][0]
    return [align_path(p, ref).reshape(len(p), -1) for p in paths]


def hes(ensembles, select: str = "name CA", align: bool = True,
        cov_estimator: str = "shrinkage"):
    """Upstream ``encore.hes``: ``(d_matrix, details)`` with
    ``d_matrix`` the symmetric (k, k) harmonic divergences and
    ``details`` carrying each ensemble's ``means``/``covariances``."""
    if cov_estimator not in ("shrinkage", "ml"):
        raise ValueError(
            f"cov_estimator must be 'shrinkage' or 'ml', got "
            f"{cov_estimator!r}")
    paths = [_as_path(e, select) for e in ensembles]
    if len(paths) < 2:
        raise ValueError("hes needs at least two ensembles")
    widths = {p.shape[1] for p in paths}
    if len(widths) != 1:
        raise ValueError(
            f"ensembles have different selection widths {sorted(widths)}")
    if min(len(p) for p in paths) < 2:
        raise ValueError("every ensemble needs at least 2 frames")
    flats = (_aligned_flat(paths) if align
             else [p.reshape(len(p), -1).astype(np.float64)
                   for p in paths])
    p_dim = flats[0].shape[1]
    means = [f.mean(axis=0) for f in flats]
    # a zero-variance ensemble (all frames identical) has no Gaussian
    # model — fail naming the input, not with a downstream LinAlgError
    for idx, (f, mu) in enumerate(zip(flats, means)):
        var_sum = float(((f - mu) ** 2).sum())
        # relative: the mean of identical frames differs from them by
        # float roundoff, so exact zero would miss real frozen inputs
        if var_sum <= 1e-18 * max(float((f ** 2).sum()), 1e-30):
            raise ValueError(
                f"ensemble {idx} has zero variance (all frames "
                "identical); hes needs fluctuating ensembles")
    if cov_estimator == "shrinkage":
        covs = [ledoit_wolf_covariance(f) for f in flats]
    else:
        # ML sample covariance + a relative jitter so the inverse
        # exists even at T ≈ p (documented estimator caveat)
        covs = []
        for f, mu in zip(flats, means):
            xc = f - mu
            s = xc.T @ xc / len(f)
            covs.append(s + 1e-9 * (np.trace(s) / p_dim)
                        * np.eye(p_dim))
    k = len(flats)
    # Cholesky is the SPD gate (a clear failure point if an estimator
    # ever regresses); the inverses themselves come from one LU each
    for idx, c in enumerate(covs):
        try:
            np.linalg.cholesky(c)
        except np.linalg.LinAlgError:
            raise ValueError(
                f"ensemble {idx}'s covariance is not positive "
                "definite; use cov_estimator='shrinkage'") from None
    invs = [np.linalg.inv(c) for c in covs]
    d = np.zeros((k, k))
    for i in range(k):
        for j in range(i + 1, k):
            dm = means[i] - means[j]
            quad = 0.25 * dm @ ((invs[i] + invs[j]) @ dm)
            # tr(A @ B) for symmetric A, B without the (p, p) matmul
            tr = 0.5 * ((covs[i] * invs[j]).sum()
                        + (covs[j] * invs[i]).sum() - 2.0 * p_dim)
            d[i, j] = d[j, i] = float(quad + tr)
    return d, {"means": means, "covariances": covs,
               "estimator": cov_estimator}


# ---------------------------------------------------------------------
# Conformational distance matrix (shared by ces and dres)
# ---------------------------------------------------------------------

LN2 = float(np.log(2.0))


def _gather_paths(ensembles, select: str):
    """Common ces/dres front end: per-ensemble (T_i, S, 3) paths with a
    shared selection width, plus the joint frame stack and the
    ensemble-id label of every joint frame.

    No alignment happens here: the superposed-RMSD distance matrix is
    rigid-motion-invariant per frame, so every distance-matrix consumer
    (all of dres, ces's default AP path) gets bit-identical results
    with or without a pre-alignment — T host-side Kabsch SVDs for
    nothing.  Coordinate-space clusterers are the one consumer that
    needs aligned frames; ces aligns lazily in that branch."""
    paths = [_as_path(e, select) for e in ensembles]
    if len(paths) < 2:
        raise ValueError("need at least two ensembles")
    widths = {p.shape[1] for p in paths}
    if len(widths) != 1:
        raise ValueError(
            f"ensembles have different selection widths {sorted(widths)}")
    if min(len(p) for p in paths) < 2:
        raise ValueError("every ensemble needs at least 2 frames")
    joint = np.concatenate(paths, axis=0)
    labels = np.concatenate(
        [np.full(len(p), i, np.int64) for i, p in enumerate(paths)])
    return paths, joint, labels


def conformational_distance_matrix(joint: np.ndarray,
                                   device=None) -> np.ndarray:
    """All-pairs superposed RMSD over a joint (T, S, 3) frame stack —
    upstream ``encore.get_distance_matrix``'s role — on ``device``
    (``cuda`` unless given): the DiffusionMap device matrix, no Python
    loop over frame pairs."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis.diffusionmap import (
        pairwise_rmsd_device)
    from mdanalysis_mpi_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    joint = torch.as_tensor(np.ascontiguousarray(joint, np.float32),
                            device=dev)
    w = np.ones(joint.shape[1])
    d = pairwise_rmsd_device(joint, w).cpu().numpy()
    # exact symmetry + zero diagonal (float noise from the two pair
    # orders would otherwise leak into AP's similarity ordering)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


def _js_from_counts(pi: np.ndarray, pj: np.ndarray) -> float:
    """Jensen–Shannon divergence (natural log) between two discrete
    distributions given as count vectors; 0 ≤ JS ≤ ln 2."""
    p = pi / pi.sum()
    q = pj / pj.sum()
    m = 0.5 * (p + q)
    with np.errstate(divide="ignore", invalid="ignore"):
        kl_p = np.where(p > 0, p * (np.log(p) - np.log(m)), 0.0).sum()
        kl_q = np.where(q > 0, q * (np.log(q) - np.log(m)), 0.0).sum()
    return float(min(max(0.5 * (kl_p + kl_q), 0.0), LN2))


# ---------------------------------------------------------------------
# Clustering backends (upstream encore.clustering.ClusteringMethod)
# ---------------------------------------------------------------------


class AffinityPropagationNative:
    """Dense affinity propagation (Frey & Dueck 2007) — upstream ces's
    default clusterer, re-implemented as whole-matrix NumPy updates.

    Call with a (T, T) *similarity* matrix (ces passes −RMSD); returns
    integer cluster labels (T,).  ``preference`` fills the similarity
    diagonal (more negative → fewer clusters); ``noise_scale`` adds the
    seeded tie-breaking jitter upstream's ``add_noise`` flag injects
    (exact ties otherwise oscillate under damping).
    """

    uses_distance_matrix = True

    def __init__(self, preference: float = -1.0, damping: float = 0.9,
                 max_iter: int = 500, convergence_iter: int = 50,
                 noise_scale: float = 1e-9, seed: int = 0):
        if not 0.5 <= damping < 1.0:
            raise ValueError(f"damping must be in [0.5, 1), got {damping}")
        self.preference = float(preference)
        self.damping = float(damping)
        self.max_iter = int(max_iter)
        self.convergence_iter = int(convergence_iter)
        self.noise_scale = float(noise_scale)
        self.seed = int(seed)

    def __call__(self, similarity: np.ndarray) -> np.ndarray:
        s = np.array(similarity, np.float64, copy=True)
        t = len(s)
        if s.shape != (t, t):
            raise ValueError(f"similarity must be square, got {s.shape}")
        np.fill_diagonal(s, self.preference)
        if self.noise_scale:
            rng = np.random.default_rng(self.seed)
            scale = self.noise_scale * (np.abs(s).max() or 1.0)
            s += rng.standard_normal(s.shape) * scale
        r = np.zeros_like(s)
        a = np.zeros_like(s)
        idx = np.arange(t)
        stable = 0
        exemplars_prev: np.ndarray | None = None
        for _ in range(self.max_iter):
            # responsibilities: r[i,k] = s[i,k] - max_{k'!=k}(a+s)[i,k']
            as_ = a + s
            first = as_.argmax(axis=1)
            row_max = as_[idx, first]
            as_[idx, first] = -np.inf
            second = as_.max(axis=1)
            r_new = s - row_max[:, None]
            r_new[idx, first] = s[idx, first] - second
            r = self.damping * r + (1.0 - self.damping) * r_new
            # availabilities: a[i,k] = min(0, r[k,k] + sum_{i'!={i,k}}
            # max(0, r[i',k])); a[k,k] = sum_{i'!=k} max(0, r[i',k])
            rp = np.maximum(r, 0.0)
            rp[idx, idx] = r[idx, idx]
            col = rp.sum(axis=0)
            a_new = np.minimum(0.0, col[None, :] - rp)
            # a[k,k] = Σ_{i'≠k} max(0, r[i',k]); col[k] already includes
            # the raw diagonal r[k,k] (rp keeps it), so remove it once
            a_new[idx, idx] = col - r[idx, idx]
            a = self.damping * a + (1.0 - self.damping) * a_new
            exemplars = np.flatnonzero(np.diag(a) + np.diag(r) > 0)
            if (exemplars_prev is not None and len(exemplars)
                    and np.array_equal(exemplars, exemplars_prev)):
                stable += 1
                if stable >= self.convergence_iter:
                    break
            else:
                stable = 0
            exemplars_prev = exemplars
        if exemplars_prev is None or len(exemplars_prev) == 0:
            # degenerate preference: everything is one cluster
            return np.zeros(t, np.int64)
        exemplars = exemplars_prev
        labels = s[:, exemplars].argmax(axis=1)
        labels[exemplars] = np.arange(len(exemplars))
        return labels.astype(np.int64)


class KMeansNative:
    """Seeded k-means++ / Lloyd clustering on aligned flattened
    coordinates (upstream's sklearn-backed ``KMeans`` option).  Call
    with the joint (T, p) coordinate matrix; returns labels (T,)."""

    uses_distance_matrix = False

    def __init__(self, n_clusters: int, max_iter: int = 300,
                 tol: float = 1e-6, seed: int = 0):
        if n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        self.n_clusters = int(n_clusters)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        t = len(x)
        k = min(self.n_clusters, t)
        rng = np.random.default_rng(self.seed)
        # k-means++ seeding
        centers = np.empty((k, x.shape[1]))
        centers[0] = x[rng.integers(t)]
        d2 = ((x - centers[0]) ** 2).sum(axis=1)
        for c in range(1, k):
            probs = d2 / d2.sum() if d2.sum() > 0 else None
            centers[c] = x[rng.choice(t, p=probs)]
            d2 = np.minimum(d2, ((x - centers[c]) ** 2).sum(axis=1))
        x_sq = (x * x).sum(axis=1)
        for _ in range(self.max_iter):
            # ||x-c||² = ||x||² - 2 x·c + ||c||² as one (T, k) matmul —
            # no (T, k, p) broadcast temporary at MD feature widths
            d2_all = (x_sq[:, None] - 2.0 * (x @ centers.T)
                      + (centers * centers).sum(axis=1)[None, :])
            labels = d2_all.argmin(axis=1)
            new_centers = centers.copy()
            for c in range(k):
                members = x[labels == c]
                if len(members):
                    new_centers[c] = members.mean(axis=0)
            shift = float(((new_centers - centers) ** 2).sum())
            centers = new_centers
            if shift <= self.tol:
                break
        return labels.astype(np.int64)


def ces(ensembles, select: str = "name CA", align: bool = True,
        clustering_method=None, distance_matrix: np.ndarray | None = None,
        device=None):
    """Upstream ``encore.ces``: cluster the JOINT frame set of all
    ensembles, read each ensemble's cluster-population distribution,
    and return the pairwise Jensen–Shannon divergence matrix
    (natural log, bounded by ln 2) plus details.

    ``clustering_method`` defaults to
    ``AffinityPropagationNative(preference=-1.0)`` (upstream's
    default); any callable with a ``uses_distance_matrix`` attribute
    works — ``True`` receives −RMSD similarities, ``False`` the
    flattened (T, 3S) coordinates (Kabsch-aligned to the first frame
    when ``align=True``; the distance-matrix path needs no alignment —
    superposed RMSD is rigid-motion-invariant).  The distance matrix
    is computed on ``device`` (``cuda`` unless given).
    """
    paths, joint, frame_ens = _gather_paths(ensembles, select)
    method = (clustering_method if clustering_method is not None
              else AffinityPropagationNative())
    if getattr(method, "uses_distance_matrix", True):
        d = (np.asarray(distance_matrix, np.float64)
             if distance_matrix is not None
             else conformational_distance_matrix(joint, device))
        if d.shape != (len(joint), len(joint)):
            raise ValueError(
                f"distance_matrix shape {d.shape} does not match the "
                f"{len(joint)} joint frames")
        labels = method(-d)
    else:
        if distance_matrix is not None:
            raise ValueError(
                f"{type(method).__name__} clusters coordinates, not "
                "distances; the supplied distance_matrix would be "
                "silently ignored — drop it or use a distance-matrix "
                "clusterer (e.g. AffinityPropagationNative)")
        d = None
        if align:
            joint = align_path(joint, joint[0])
        labels = method(joint.reshape(len(joint), -1))
    labels = np.asarray(labels, np.int64)
    n_clusters = int(labels.max()) + 1 if len(labels) else 0
    k = len(paths)
    counts = np.zeros((k, n_clusters), np.float64)
    for e in range(k):
        counts[e] = np.bincount(labels[frame_ens == e],
                                minlength=n_clusters)
    out = np.zeros((k, k))
    for i in range(k):
        for j in range(i + 1, k):
            out[i, j] = out[j, i] = _js_from_counts(counts[i], counts[j])
    return out, {"labels": labels, "populations": counts,
                 "n_clusters": n_clusters, "distance_matrix": d}


# ---------------------------------------------------------------------
# Dimensionality reduction + KDE (dres)
# ---------------------------------------------------------------------


class StochasticProximityEmbeddingNative:
    """Stochastic proximity embedding (Agrafiotis 2003) — upstream
    dres's default reducer.  Call with a (T, T) distance matrix;
    returns (T, dimension) embedded coordinates.

    Batched variant (documented deviation): each cycle draws
    ``nstep`` random pairs at once and applies the pairwise spring
    updates with ``np.add.at`` scatter-accumulation, instead of the
    sequential one-pair-at-a-time original — same fixed points,
    Python-loop-free, deterministic under ``seed``.  The learning rate
    anneals linearly ``max_lam → min_lam`` across ``ncycle`` cycles.
    """

    def __init__(self, dimension: int = 3, distance_cutoff: float = 1.5,
                 min_lam: float = 0.1, max_lam: float = 2.0,
                 ncycle: int = 100, nstep: int = 10000, seed: int = 0):
        if dimension < 1:
            raise ValueError(f"dimension must be >= 1, got {dimension}")
        self.dimension = int(dimension)
        self.distance_cutoff = float(distance_cutoff)
        self.min_lam = float(min_lam)
        self.max_lam = float(max_lam)
        self.ncycle = int(ncycle)
        self.nstep = int(nstep)
        self.seed = int(seed)

    def __call__(self, d: np.ndarray) -> np.ndarray:
        d = np.asarray(d, np.float64)
        t = len(d)
        if d.shape != (t, t):
            raise ValueError(f"distance matrix must be square, got "
                             f"{d.shape}")
        rng = np.random.default_rng(self.seed)
        scale = float(d.max()) or 1.0
        x = rng.uniform(-0.5, 0.5, (t, self.dimension)) * scale
        eps = 1e-10
        for cycle in range(self.ncycle):
            lam = (self.max_lam - (self.max_lam - self.min_lam)
                   * cycle / max(self.ncycle - 1, 1))
            i = rng.integers(0, t, self.nstep)
            j = rng.integers(0, t, self.nstep)
            keep = i != j
            i, j = i[keep], j[keep]
            rij = d[i, j]
            diff = x[i] - x[j]
            dij = np.sqrt((diff * diff).sum(axis=1)) + eps
            # move only pairs whose target is local (below the cutoff)
            # or whose embedding is overstretched relative to target
            act = (rij < self.distance_cutoff) | (dij < rij)
            if not act.any():
                continue
            i, j, rij = i[act], j[act], rij[act]
            diff, dij = diff[act], dij[act]
            step = (0.5 * lam * (rij - dij) / dij)[:, None] * diff
            # batched stability: a point drawn into many pairs this
            # cycle receives the AVERAGE of its spring displacements,
            # not the sum — the sequential algorithm's per-pair move
            # magnitude is preserved while scatter-accumulated updates
            # cannot compound into divergence
            acc = np.zeros_like(x)
            cnt = np.zeros(t)
            np.add.at(acc, i, step)
            np.add.at(acc, j, -step)
            np.add.at(cnt, i, 1.0)
            np.add.at(cnt, j, 1.0)
            x += acc / np.maximum(cnt, 1.0)[:, None]
        return x


class GaussianKDE:
    """Scott's-rule full-covariance Gaussian kernel density estimate
    over points (n, d) — the scipy.stats.gaussian_kde role in upstream
    dres, with seeded sampling."""

    def __init__(self, points: np.ndarray):
        pts = np.asarray(points, np.float64)
        if pts.ndim != 2 or len(pts) < 2:
            raise ValueError("KDE needs a (n>=2, d) point set")
        self.points = pts
        n, d = pts.shape
        factor = n ** (-1.0 / (d + 4))              # Scott 1992
        cov = np.cov(pts, rowvar=False).reshape(d, d)
        # degenerate spread (identical points along an axis): jitter
        # relative to the data scale so cholesky exists
        jitter = 1e-12 * max(float(np.trace(cov)) / d, 1e-30)
        self.h = factor ** 2 * cov + jitter * np.eye(d)
        self.chol = np.linalg.cholesky(self.h)
        self.log_norm = (0.5 * d * np.log(2.0 * np.pi)
                         + np.log(np.diag(self.chol)).sum())

    def logpdf(self, x: np.ndarray) -> np.ndarray:
        """ln f(x) at query points (m, d) → (m,)."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        m, d = x.shape
        n = len(self.points)
        resid = x[:, None, :] - self.points[None, :, :]      # (m, n, d)
        # whiten against the bandwidth: solve L z = rᵀ in one batch
        z = np.linalg.solve(self.chol, resid.reshape(-1, d).T)
        q = (z * z).sum(axis=0).reshape(m, n)   # squared Mahalanobis
        lk = -0.5 * q - self.log_norm           # per-kernel log density
        peak = lk.max(axis=1, keepdims=True)
        return (peak[:, 0] + np.log(np.exp(lk - peak).sum(axis=1))
                - np.log(n))

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        centers = self.points[rng.integers(0, len(self.points), n)]
        noise = rng.standard_normal((n, self.points.shape[1]))
        return centers + noise @ self.chol.T


def dres(ensembles, select: str = "name CA",
         dimensionality_reduction_method=None, nsamples: int = 1000,
         distance_matrix: np.ndarray | None = None, seed: int = 0,
         device=None):
    """Upstream ``encore.dres``: embed the joint frames into a low-
    dimensional space, model each ensemble's density there with a
    Gaussian KDE, and Monte-Carlo-estimate the pairwise Jensen–Shannon
    divergences (natural log, clamped to [0, ln 2]).

    No ``align`` knob: everything downstream derives from the
    superposed-RMSD matrix, which is rigid-motion-invariant per frame
    — a pre-alignment could not change the result.  The distance
    matrix is computed on ``device`` (``cuda`` unless given)."""
    paths, joint, frame_ens = _gather_paths(ensembles, select)
    method = (dimensionality_reduction_method
              if dimensionality_reduction_method is not None
              else StochasticProximityEmbeddingNative())
    d = (np.asarray(distance_matrix, np.float64)
         if distance_matrix is not None
         else conformational_distance_matrix(joint, device))
    if d.shape != (len(joint), len(joint)):
        raise ValueError(
            f"distance_matrix shape {d.shape} does not match the "
            f"{len(joint)} joint frames")
    embedded = np.asarray(method(d), np.float64)
    k = len(paths)
    kdes = [GaussianKDE(embedded[frame_ens == e]) for e in range(k)]
    rng = np.random.default_rng(seed)
    samples = [kde.sample(nsamples, rng) for kde in kdes]
    logp = [[kdes[e].logpdf(samples[s]) for e in range(k)]
            for s in range(k)]
    out = np.zeros((k, k))
    for i in range(k):
        for j in range(i + 1, k):
            # KL(P||M) ~ E_{x~P}[ln p - ln m], m = (p + q)/2
            lm_i = np.logaddexp(logp[i][i], logp[i][j]) - np.log(2.0)
            lm_j = np.logaddexp(logp[j][i], logp[j][j]) - np.log(2.0)
            js = 0.5 * ((logp[i][i] - lm_i).mean()
                        + (logp[j][j] - lm_j).mean())
            out[i, j] = out[j, i] = float(min(max(js, 0.0), LN2))
    return out, {"embedded": embedded, "frame_ensemble": frame_ens,
                 "distance_matrix": d}
