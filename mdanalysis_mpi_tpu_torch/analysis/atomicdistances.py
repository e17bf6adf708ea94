"""Per-atom-pair distance time series (upstream
``MDAnalysis.analysis.atomicdistances.AtomicDistances``).

Two equal-length AtomGroups pair element-by-element; every frame
yields the N distances, minimum-imaged under the frame's box when
``pbc=True`` (the upstream default).  ``run()`` →
``results.distances`` (T, N).

Built ON :class:`~mdanalysis_mpi_tpu_torch.analysis.nucleicacids.NucPairDist`
(the shared paired-distance machinery — staging, kernels, conclude):
this class only adds the group-pairing validation and the
minimum-image variant of the serial/batch kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.nucleicacids import (
    NucPairDist, _pair_dist_kernel,
)


def _pair_dist_kernel_pbc(params, batch, boxes, mask):
    """The shared pair-distance batch function + per-frame minimum
    image (``torch.vmap`` over the frames' boxes)."""
    from mdanalysis_mpi_tpu_torch.ops.distances import minimum_image as mi

    i_slots, j_slots = params
    d = torch.vmap(mi)(batch[:, i_slots] - batch[:, j_slots], boxes)
    return (torch.sqrt((d ** 2).sum(-1)) * mask[:, None], mask)


class AtomicDistances(NucPairDist):
    """``AtomicDistances(ag1, ag2, pbc=True).run().results.distances``.
    """

    def __init__(self, ag1, ag2, pbc: bool = True,
                 verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.analysis.base import reject_updating_groups

        reject_updating_groups(ag1, ag2, owner="AtomicDistances")
        if ag1.universe is not ag2.universe:
            raise ValueError("both groups must share one universe")
        if ag1.n_atoms != ag2.n_atoms:
            raise ValueError(
                f"groups pair atom-by-atom: {ag1.n_atoms} vs "
                f"{ag2.n_atoms} atoms")
        if ag1.n_atoms == 0:
            raise ValueError("empty groups")
        super().__init__(ag1.universe,
                         np.stack([ag1.indices, ag2.indices], axis=1),
                         verbose=verbose)
        self._pbc = bool(pbc)

    def _single_frame(self, ts):
        if not self._pbc:
            return super()._single_frame(ts)
        from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

        x = ts.positions[self._idx].astype(np.float64)
        d = minimum_image(x[self._i_slots] - x[self._j_slots],
                          ts.dimensions)
        self._serial_rows.append(np.sqrt((d ** 2).sum(-1)))

    def _batch_fn(self):
        return _pair_dist_kernel_pbc if self._pbc else _pair_dist_kernel
