"""RMSD ops (BASELINE config 3: RMSD time series with least-squares
superposition to a reference frame), on torch tensors.

The algebra is the JAX package's ``ops/rmsd.py``: the generic Kabsch
solve of :mod:`.align` (one batched 3×3 ``torch.linalg.svd`` plus the
det-correction) and the RMSD of the aligned residual.
"""

from __future__ import annotations

import torch

from mdanalysis_mpi_tpu_torch.ops.align import (kabsch_rotation_batch,
                                                weighted_center)


def rmsd(a: torch.Tensor, b: torch.Tensor,
         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Plain (no-fit) weighted RMSD between conformations a, b
    (..., N, 3) → (...)."""
    d2 = ((a - b) ** 2).sum(dim=-1)
    if weights is None:
        return torch.sqrt(d2.mean(dim=-1))
    w = weights / weights.sum()
    return torch.sqrt(torch.einsum("...n,n->...", d2, w))


def rmsd_batch(
    coords: torch.Tensor,            # (B, S, 3) selection coords per frame
    com_weights: torch.Tensor,       # (S,) weights for the COM translation
    ref_sel_centered: torch.Tensor,  # (S, 3)
    superposition: bool = True,
    rot_weights: torch.Tensor | None = None,   # Kabsch fit weights
    rmsd_weights: torch.Tensor | None = None,  # RMSD averaging weights
) -> torch.Tensor:
    """Per-frame RMSD to the reference, optionally after optimal
    superposition → (B,).

    Weights are split three ways to express both conventions: the
    reference's (mass-weighted COM, unweighted fit — RMSF.py:48,94) and
    fully mass-weighted RMSD (``rot_weights=rmsd_weights=masses``).
    The minimized RMSD comes from the aligned residual, so the same
    code serves ``superposition=False``.
    """
    com = weighted_center(coords, com_weights)
    cc = coords - com[:, None, :]
    if superposition:
        rot = kabsch_rotation_batch(cc, ref_sel_centered, rot_weights)
        cc = torch.einsum("bni,bij->bnj", cc, rot)
    return rmsd(cc, ref_sel_centered, rmsd_weights)
