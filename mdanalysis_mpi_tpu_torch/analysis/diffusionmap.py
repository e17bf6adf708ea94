"""Diffusion-map analysis: frame–frame distance matrix + spectral
embedding (the JAX package's ``analysis/diffusionmap.py``).

Upstream-API mirror (``MDAnalysis.analysis.diffusionmap``):
``DistanceMatrix(u, select=...).run()`` → ``results.dist_matrix``
(T, T) pairwise superposed RMSDs between frames, and
``DiffusionMap(u | dist_matrix, epsilon=...).run()`` →
``results.eigenvalues`` / ``results.eigenvectors`` of the diffusion
kernel, with ``transform(n, time)`` producing the embedding.

Device shape: frames stage once (a time-series collection, like MSD),
then all T² pair RMSDs come from :func:`pairwise_rmsd_device` at the
first read of the result.  Each pair is a 3×3 Kabsch problem, but no
rotation is needed: the superposed RMSD is
``sqrt((e0 − 2·(σ1 + σ2 + d·σ3)) / Σw)``, and ``σ1 + σ2 + d·σ3`` is the
top eigenvalue of the QCP key matrix (``ops/align.qcp_max_eigenvalue``).
The nine correlation entries of a block of rows against every frame are
nine products of the (T, S) coordinate planes, ``A_k · diag(w) · B_lᵀ``
(one matrix product), so the whole matrix is a few row blocks of
products and elementwise float64 QCP, with no SVD and no host wait.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, Results,
                                                    deferred_group,
                                                    real_frames, to_numpy)
from mdanalysis_mpi_tpu_torch.core.universe import Universe

#: bytes of the float64 (rows, T, 9) correlation block of one row block
_BLOCK_BYTES = 1 << 30


# ---- module-level batch function ----

def _collect_kernel(params, batch, boxes, mask):
    del boxes
    del params
    return (batch * mask[:, None, None], mask)


def pair_block_rows(n_frames: int) -> int:
    """Rows of one block of :func:`pairwise_rmsd_device`: its float64
    ``(rows, T, 9)`` correlation block stays within 1 GiB."""
    return max(1, min(n_frames, _BLOCK_BYTES // (n_frames * 9 * 8)))


def pairwise_rmsd_device(pos: torch.Tensor, weights) -> torch.Tensor:
    """(T, S, 3) → (T, T) float64 superposed weighted RMSDs on ``pos``'s
    device (the JAX package's ``_pairwise_rmsd_device``, which runs T²
    3×3 SVDs).  Rows go in blocks of :func:`pair_block_rows`; each
    block is one float64 matrix product and the elementwise QCP top
    eigenvalue, so the loop never waits on the device."""
    from mdanalysis_mpi_tpu_torch.ops.align import qcp_max_eigenvalue

    dev = pos.device
    x = pos.to(torch.float64)
    w = torch.as_tensor(weights, dtype=torch.float64, device=dev)
    wsum = w.sum()
    t, s = x.shape[0], x.shape[1]
    xc = x - torch.einsum("n,tni->ti", w, x)[:, None, :] / wsum
    g = torch.einsum("n,tni->t", w, xc * xc)            # Σ w |x_c|²
    planes = xc.permute(0, 2, 1).reshape(3 * t, s)      # row 3i+k: A_k[i]
    wplanes = planes * w[None, :]
    out = torch.empty((t, t), dtype=torch.float64, device=dev)
    rows = pair_block_rows(t)
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        # h[i, k, j, l] = Σ_n w_n a_i[n, k] a_j[n, l], i in the block
        h = (wplanes[3 * r0:3 * r1] @ planes.T).reshape(r1 - r0, 3, t, 3)
        h = h.permute(0, 2, 1, 3)
        lam = qcp_max_eigenvalue(
            [h[..., k, l] for k in range(3) for l in range(3)])
        e0 = g[r0:r1, None] + g[None, :]
        msd = torch.clamp(e0 - 2.0 * lam, min=0.0) / wsum
        out[r0:r1] = torch.sqrt(msd)
    return out


class DistanceMatrix(AnalysisBase):
    """``DistanceMatrix(u, select='name CA').run().results.dist_matrix``
    — (T, T) least-squares-superposed weighted RMSD between every frame
    pair of the selection."""

    def __init__(self, universe: Universe, select: str = "all",
                 weights: str | None = "mass", verbose: bool = False):
        super().__init__(universe, verbose)
        if weights not in (None, "mass"):
            raise ValueError(f"weights must be None or 'mass', got {weights!r}")
        self._select = select
        self._weights_mode = weights

    def _prepare(self):
        ag = self._universe.select_atoms(self._select)
        if ag.n_atoms == 0:
            raise ValueError(f"selection {self._select!r} matched no atoms")
        self._idx = ag.indices
        self._w = (ag.masses if self._weights_mode == "mass"
                   else np.ones(ag.n_atoms))
        if self.n_frames > 4096:
            raise ValueError(
                f"{self.n_frames} frames -> a "
                f"{self.n_frames}x{self.n_frames} matrix; window the run "
                "(DistanceMatrix is for clustering-scale frame counts)")
        self._serial_pos = []

    # -- serial path --

    def _single_frame(self, ts):
        self._serial_pos.append(
            ts.positions[self._idx].astype(np.float64))

    def _serial_summary(self):
        pos = (np.stack(self._serial_pos) if self._serial_pos
               else np.empty((0, len(self._idx), 3)))
        return (pos, np.ones(len(pos)))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _collect_kernel

    # time series: frames stay in frame order

    def _identity_partials(self):
        return (np.empty((0, len(self._idx), 3)), np.empty(0))

    def _conclude(self, total):
        pos, mask = total
        if self.n_frames < 2:
            raise ValueError("DistanceMatrix needs at least 2 frames")
        # the device route: the staged series is a tensor on the run's
        # device; its padded frames are dropped there (no read back)
        on_device = isinstance(pos, torch.Tensor)
        p = real_frames(pos, mask, self.n_frames)
        w = self._w

        def _finalize():
            if on_device:
                m = np.asarray(to_numpy(pairwise_rmsd_device(p, w)),
                               np.float64)
            else:
                t = len(p)
                m = np.zeros((t, t))
                from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd

                for i in range(t):
                    for j in range(i + 1, t):
                        m[i, j] = m[j, i] = rmsd(
                            p[j], p[i], weights=w, superposition=True)
            # exact symmetry + zero diagonal (pair order rounding)
            m = (m + m.T) / 2.0
            np.fill_diagonal(m, 0.0)
            return {"dist_matrix": m}

        g = deferred_group(_finalize)
        self.results.dist_matrix = g["dist_matrix"]


class DiffusionMap:
    """``DiffusionMap(dist_matrix_or_universe, epsilon=1.0).run()`` →
    ``results.eigenvalues`` (descending), ``results.eigenvectors``
    (rows index frames), and ``transform(n_eigenvectors, time)`` → the
    (T, n) diffusion-space embedding (upstream semantics: the trivial
    constant eigenvector is dropped).  Host NumPy on the (T, T)
    matrix; ``run(**kwargs)`` passes its keywords to the
    :class:`DistanceMatrix` run when the matrix is not computed yet."""

    def __init__(self, obj, select: str = "all", epsilon: float = 1.0,
                 **kwargs):
        if isinstance(obj, DistanceMatrix):
            self._dm = obj
        elif isinstance(obj, Universe):
            self._dm = DistanceMatrix(obj, select=select, **kwargs)
        else:
            raise TypeError(
                "DiffusionMap takes a Universe or a DistanceMatrix, got "
                f"{type(obj).__name__}")
        self._epsilon = float(epsilon)
        self.results = Results()

    def run(self, **kwargs):
        if "dist_matrix" not in self._dm.results:
            self._dm.run(**kwargs)
        m = np.asarray(self._dm.results.dist_matrix, np.float64)
        # upstream kernel width: exp(-d²/ε) — same epsilon, same spectrum
        kernel = np.exp(-(m ** 2) / self._epsilon)
        # row-normalize into the diffusion transition matrix; symmetrize
        # via the d^{-1/2} conjugation so eigh applies
        d = kernel.sum(axis=1)
        dinv = 1.0 / np.sqrt(d)
        sym = dinv[:, None] * kernel * dinv[None, :]
        vals, vecs = np.linalg.eigh(sym)
        order = np.argsort(vals)[::-1]
        vals = vals[order]
        vecs = (dinv[:, None] * vecs[:, order])       # right eigenvectors
        self.results.eigenvalues = vals
        self.results.eigenvectors = vecs.T            # rows = modes
        return self

    def transform(self, n_eigenvectors: int, time: float = 1.0):
        """(T, n) embedding: λ_k^time · ψ_k, skipping the trivial
        stationary mode (upstream convention)."""
        if "eigenvalues" not in self.results:
            raise RuntimeError("run() the DiffusionMap before transform()")
        vals = self.results.eigenvalues[1:n_eigenvectors + 1]
        vecs = self.results.eigenvectors[1:n_eigenvectors + 1]
        return (vecs * (vals[:, None] ** time)).T
