"""Gaussian Network Model (GNM) trajectory analysis.

Upstream-API mirror (``MDAnalysis.analysis.gnm.GNMAnalysis``): per
frame, build the Kirchhoff (graph-Laplacian) matrix of the selection's
contact graph — nodes within ``cutoff`` Å are springs — and report the
first non-trivial eigenvalue (the slowest internal GNM mode, upstream's
per-frame mobility proxy) and its eigenvector.
``GNMAnalysis(u, select="protein and name CA").run()`` →
``results.times``, ``results.eigenvalues`` (T,), ``results.eigenvectors``
(T, S).

The contact matrix has a fixed (S, S) shape, so a frame batch builds
all B Kirchhoff matrices with one broadcast distance computation and
eigendecomposes them with one batched ``torch.linalg.eigh`` on
``(B, S, S)`` (guarded to selection scales where S² matrices are
sane).  On a CUDA device that call checks its solver status on the
host: one wait on the card per batch, so a GNM batch function cannot
be captured into a CUDA graph.  The JAX package's ``analysis/gnm.py``.  Eigenvector sign is normalized (largest-|value|
component positive) so serial/batch and chip/host agree; eigenvalues of
a Laplacian are sorted ascending with λ₀ ≈ 0 for a connected graph, and
index 1 is reported (upstream convention — for a DISCONNECTED contact
graph additional near-zero eigenvalues appear there; upstream warns,
here the value itself discloses it).
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group,
                                                    real_frames, to_numpy)


def _gnm_kernel(params, batch, boxes, mask):
    """Per-frame (first-mode eigenvalue, eigenvector) over the batch."""
    del boxes
    (cutoff2,) = params
    n = batch.shape[1]
    d2 = ((batch[:, :, None, :] - batch[:, None, :, :]) ** 2).sum(-1)
    adj = (d2 < cutoff2).to(torch.float32)
    adj = adj - torch.eye(n, dtype=torch.float32, device=batch.device)
    lap = torch.diag_embed(adj.sum(dim=2)) - adj
    # time-series family: no _device_combine — per-shard outputs
    # concatenate in frame order.  All B eigensolves are one batched
    # call — memory is B·S²·f32 per live buffer, which the node-count
    # guard in _prepare sizes for
    vals, vecs = torch.linalg.eigh(lap)
    v = vecs[:, :, 1]                                    # (B, S)
    # deterministic sign: largest-|component| entry positive
    s = torch.sign(v.gather(1, v.abs().argmax(dim=1, keepdim=True)))
    v = v * torch.where(s == 0, torch.ones_like(s), s)
    m = mask.to(torch.float32)
    return (vals[:, 1] * m, v * m[:, None], m)


class GNMAnalysis(AnalysisBase):
    """``GNMAnalysis(u, select="protein and name CA", cutoff=7.0)``.

    ``results.eigenvalues`` / ``results.eigenvectors`` / ``results.times``
    — one slowest-internal-mode record per frame, upstream layout.

    Precision envelope: the batch backends eigensolve the Kirchhoff
    matrix in float32 (batched ``eigh``) while the serial oracle runs
    float64.  λ1 agrees to ~1e-5 relative in practice, but for
    NEAR-DEGENERATE low modes (weakly connected contact graphs, λ1≈λ2)
    the float32 eigenVECTOR can rotate inside the near-degenerate
    subspace and diverge from the oracle beyond ordinary tolerances.
    Before trusting per-frame eigenvectors from a batch run, check the
    spectral gap: ``results.eigenvalues`` close to the next mode's
    value flags frames where only the eigenvalue is comparable across
    backends.
    """

    def __init__(self, universe, select: str = "protein and name CA",
                 cutoff: float = 7.0, verbose: bool = False):
        super().__init__(universe, verbose)
        if cutoff <= 0:
            raise ValueError(f"cutoff must be positive, got {cutoff}")
        self._select = select
        self._cutoff = float(cutoff)

    def _prepare(self):
        ag = self._universe.select_atoms(self._select)
        if ag.n_atoms < 3:
            raise ValueError(
                f"GNM needs at least 3 nodes; selection "
                f"{self._select!r} matched {ag.n_atoms}")
        if ag.n_atoms > 2_048:
            # the batch function batches the eigensolves: live buffers are
            # B·S²·4 bytes each (~1 GB at S=2048, batch 64) — and GNM
            # is a residue-level model anyway
            raise ValueError(
                f"selection spans {ag.n_atoms} nodes -> batched "
                f"{ag.n_atoms}x{ag.n_atoms} Kirchhoff eigensolves; GNM "
                "is meant for Cα/residue-level networks (coarsen the "
                "selection)")
        self._idx = ag.indices
        self._vals: list[float] = []
        self._vecs: list[np.ndarray] = []

    # -- serial path --

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        adj = (d2 < self._cutoff ** 2).astype(np.float64)
        np.fill_diagonal(adj, 0.0)
        lap = np.diag(adj.sum(axis=1)) - adj
        vals, vecs = np.linalg.eigh(lap)
        v = vecs[:, 1]
        s = np.sign(v[np.argmax(np.abs(v))]) or 1.0
        self._vals.append(float(vals[1]))
        self._vecs.append(v * s)

    def _serial_summary(self):
        n = len(self._vals)
        return (np.asarray(self._vals), np.asarray(self._vecs).reshape(
            n, len(self._idx)), np.ones(n))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _gnm_kernel

    def _batch_params(self):
        return (np.float32(self._cutoff ** 2),)

    # concatenated time series; the batched eigh waits on the device
    _host_waits_in_batch = True

    def _identity_partials(self):
        return (np.empty(0), np.empty((0, len(self._idx))), np.empty(0))

    def _conclude(self, total):
        vals, vecs, mask = total
        frames = list(self._frame_indices)
        times = self._universe.trajectory.frame_times(frames)
        self.results.times = (np.asarray(times, np.float64)
                              if times is not None
                              else np.asarray(frames, np.float64))

        n = self.n_frames
        vals, vecs = (real_frames(x, mask, n) for x in (vals, vecs))

        def _finalize():
            return {"eigenvalues": np.asarray(to_numpy(vals), np.float64),
                    "eigenvectors": np.asarray(to_numpy(vecs),
                                               np.float64)}

        g = deferred_group(_finalize)
        self.results.eigenvalues = g["eigenvalues"]
        self.results.eigenvectors = g["eigenvectors"]
