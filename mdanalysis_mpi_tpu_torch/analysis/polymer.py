"""Polymer analysis (upstream ``MDAnalysis.analysis.polymer``).

:class:`PersistenceLength`: the bond-vector autocorrelation of polymer
chains,

    C(n) = ⟨ u_i · u_{i+n} ⟩           (chains, origins i, frames)

with the persistence length from the exponential decay
``C(n) = exp(−n·l_b / l_p)`` and ``l_b`` the average bond length.
``PersistenceLength([chain_ag, ...]).run()`` → ``results.bond_autocorrelation``
(L−1 lags), ``results.lb``, ``results.lp``, ``results.fit``.

Each frame's per-chain unit bond vectors form a (C, L−1, 3) tensor;
the full lag correlation is one Gram contraction ``G = u·uᵀ`` per chain
(einsum ``cli,cmi->clm``) whose offset-n diagonals average into C(n),
and per-frame partials (per-lag sums + counts) merge by addition, so
the analysis runs on every backend.  The JAX package's
``analysis/polymer.py``.

Fit note: upstream fits ``exp(−x/l_p)`` with ``scipy.curve_fit``;
scipy is not a dependency here, so l_p comes from the log-linear least
squares over the positive prefix of C(n) — identical in the
well-sampled regime, documented divergence elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (
    AnalysisBase, deferred_group, to_numpy, tree_add, tree_psum,
)


def _chain_autocorr_np(x: np.ndarray, chains: np.ndarray, box=None):
    """positions (S, 3), chains (C, L) slot indices →
    (per-lag dot sums (L-1,), per-lag counts (L-1,), bond length sum,
    bond count) — one frame's partials, float64.  Bond vectors are
    minimum-imaged: a chain crossing the boundary of an atom-wrapped
    trajectory would otherwise contribute box-length "bonds"."""
    from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

    p = x[chains]                                 # (C, L, 3)
    b = minimum_image(p[:, 1:] - p[:, :-1], box)  # (C, L-1, 3)
    norm = np.sqrt((b ** 2).sum(-1))
    u = b / (norm[..., None] + 1e-30)
    g = np.einsum("cli,cmi->clm", u, u)           # (C, L-1, L-1)
    nb = u.shape[1]
    sums = np.empty(nb)
    counts = np.empty(nb)
    for n in range(nb):
        d = np.diagonal(g, offset=n, axis1=1, axis2=2)
        sums[n] = d.sum()
        counts[n] = d.size
    return sums, counts, float(norm.sum()), float(norm.size)


def _persistence_kernel(params, batch, boxes, mask):
    """Batched twin: (B, S, 3) → per-lag sums/counts + bond-length
    sums, summed over the batch (reduction family, fold = tree_add).
    Bond vectors minimum-imaged per frame (see the host twin): the
    batched ``ops/distances.minimum_image`` (``torch.vmap`` over the
    frames' boxes)."""
    from mdanalysis_mpi_tpu_torch.ops.distances import minimum_image as mi

    (chains,) = params
    p = batch[:, chains]                          # (B, C, L, 3)
    b = torch.vmap(mi)(p[:, :, 1:] - p[:, :, :-1], boxes)
    norm = torch.sqrt((b ** 2).sum(-1))
    u = b / (norm[..., None] + 1e-30)
    g = torch.einsum("bcli,bcmi->bclm", u, u)     # (B, C, L-1, L-1)
    g = g * mask[:, None, None, None]
    nb = u.shape[2]
    sums = torch.stack([
        torch.diagonal(g, offset=n, dim1=2, dim2=3).sum()
        for n in range(nb)])
    lags = torch.arange(nb, dtype=torch.float32, device=batch.device)
    counts = g.shape[1] * (nb - lags) * mask.sum()
    blen = (norm * mask[:, None, None]).sum()
    bcount = norm.shape[1] * norm.shape[2] * mask.sum()
    return (sums, counts, blen, bcount)


class PersistenceLength(AnalysisBase):
    """``PersistenceLength([ag1, ag2, ...]).run()`` — each AtomGroup is
    one chain's backbone IN ORDER; all chains must share a length ≥ 3.
    """

    _device_fold_fn = staticmethod(tree_add)
    _device_combine = staticmethod(tree_psum)

    def __init__(self, atomgroups, verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.analysis.base import reject_updating_groups

        atomgroups = list(atomgroups)
        if not atomgroups:
            raise ValueError("need at least one chain AtomGroup")
        reject_updating_groups(*atomgroups, owner="PersistenceLength")
        u = atomgroups[0].universe
        lengths = {ag.n_atoms for ag in atomgroups}
        if len(lengths) != 1:
            raise ValueError(
                f"chains have different lengths {sorted(lengths)}; "
                "PersistenceLength averages over equivalent chains")
        if min(lengths) < 3:
            raise ValueError("chains need at least 3 atoms (2 bonds)")
        for ag in atomgroups:
            if ag.universe is not u:
                raise ValueError("all chains must share one universe")
        super().__init__(u, verbose)
        self._chains_global = np.stack([ag.indices for ag in atomgroups])

    def _prepare(self):
        uniq, inv = np.unique(self._chains_global, return_inverse=True)
        self._idx = uniq
        self._chains = inv.reshape(self._chains_global.shape).astype(
            np.int32)
        nb = self._chains.shape[1] - 1
        self._acc = (np.zeros(nb), np.zeros(nb), 0.0, 0.0)

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        s, c, bl, bc = _chain_autocorr_np(x, self._chains,
                                          box=ts.dimensions)
        a = self._acc
        self._acc = (a[0] + s, a[1] + c, a[2] + bl, a[3] + bc)

    def _serial_summary(self):
        return self._acc

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _persistence_kernel

    def _batch_params(self):
        return (torch.as_tensor(self._chains, dtype=torch.int64),)

    def _identity_partials(self):
        nb = self._chains.shape[1] - 1
        return (np.zeros(nb), np.zeros(nb), 0.0, 0.0)

    def _conclude(self, total):
        def _core():
            sums, counts, blen, bcount = (
                np.asarray(to_numpy(t), np.float64) for t in total)
            if float(bcount) == 0:
                raise ValueError("PersistenceLength over zero frames")
            c = sums / np.maximum(counts, 1.0)
            return {"bond_autocorrelation": c,
                    "lb": float(blen / bcount)}

        g = deferred_group(_core)
        self.results.bond_autocorrelation = g["bond_autocorrelation"]
        self.results.lb = g["lb"]

        fit_state: dict = {}

        def _fit():
            if fit_state:
                return fit_state
            core = _core()
            c = np.asarray(core["bond_autocorrelation"])
            lb = core["lb"]
            # log-linear fit over the positive prefix (see module note)
            pos = c > 0
            end = int(np.argmin(pos)) if not pos.all() else len(c)
            if end < 2:
                # C(1) <= 0: no exponential regime exists — a floppy /
                # anticorrelated chain must not silently read as
                # infinitely persistent (results.bond_autocorrelation
                # stays accessible; only the FIT refuses)
                raise ValueError(
                    f"bond autocorrelation is not positive at lag 1 "
                    f"(C(1) = {c[1]:.4g}); no exponential decay to fit "
                    "— inspect results.bond_autocorrelation directly")
            x = np.arange(end) * lb
            import warnings

            with warnings.catch_warnings():
                # a perfectly rigid chain (C ≡ 1) makes the fit rank-
                # deficient; the slope-0 → lp=inf branch below handles it
                warnings.simplefilter("ignore")
                slope = (np.polyfit(x, np.log(c[:end]), 1))[0]
            lp = float(-1.0 / slope) if slope < 0 else float("inf")
            fit_state.update(
                lp=lp, fit=(np.exp(-x / lp) if np.isfinite(lp)
                            else np.ones(end)))
            return fit_state

        from mdanalysis_mpi_tpu_torch.analysis.base import Deferred

        self.results.lp = Deferred(lambda: _fit()["lp"])
        self.results.fit = Deferred(lambda: _fit()["fit"])
