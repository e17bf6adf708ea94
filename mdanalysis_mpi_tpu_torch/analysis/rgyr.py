"""Radius-of-gyration time series (the JAX package's
``analysis/rgyr.py``).

The canonical "write your own analysis" example: an AnalysisBase
subclass needs only a serial per-frame body (``_single_frame``, the
float64 oracle) and a module-level batch function over ``(B, S, 3)``
blocks (``_batch_fn``, the device path); every executor, the staging
pipeline, checkpointing and the lazy results come with the template.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisBase, series_of
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup


def _rgyr_kernel(params, batch, boxes, mask):
    """sqrt(Σ mᵢ·|rᵢ−COM|²/Σ mᵢ) per frame of the staged selection."""
    del boxes
    (weights,) = params                       # (S,) normalized masses
    com = torch.einsum("s,bsi->bi", weights, batch)
    d2 = ((batch - com[:, None, :]) ** 2).sum(-1)      # (B, S)
    rg = torch.sqrt(torch.einsum("s,bs->b", weights, d2))
    return (rg * mask, mask)


class RadiusOfGyration(AnalysisBase):
    """Per-frame mass-weighted radius of gyration:
    ``RadiusOfGyration(ag).run().results.rgyr`` (n_frames,)."""

    def __init__(self, atomgroup: AtomGroup, verbose: bool = False):
        super().__init__(atomgroup.universe, verbose)
        self._ag = atomgroup

    def _prepare(self):
        if self._ag.n_atoms == 0:
            raise ValueError("RadiusOfGyration needs a non-empty group")
        self._idx = self._ag.indices
        m = self._ag.masses
        self._weights = m / m.sum()
        self._serial_vals: list[float] = []

    # -- serial path (float64 oracle) --

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        com = self._weights @ x
        d2 = ((x - com) ** 2).sum(axis=1)
        self._serial_vals.append(float(np.sqrt(self._weights @ d2)))

    def _serial_summary(self):
        vals = np.asarray(self._serial_vals)
        return (vals, np.ones(len(vals)))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _rgyr_kernel

    def _batch_params(self):
        return (torch.as_tensor(self._weights, dtype=torch.float32),)

    # time series: per-batch (vals, mask) concatenated in frame order

    def _identity_partials(self):
        return (np.empty(0), np.empty(0))

    def _conclude(self, total):
        vals, mask = total
        self.results.rgyr = series_of(vals, mask, self.n_frames)
