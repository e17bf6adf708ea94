"""Least-squares superposition ops (PyTorch).

Replacement for the reference's per-frame QCP alignment
(``qcp.CalcRMSDRotationalMatrix`` wrapped at RMSF.py:43-51, applied at
RMSF.py:99-101/133-135): Kabsch via SVD of the 3x3 correlation matrix,
batched over frames.  This is the generic form of the aligned-moments
path; the fused form solves the same rotation by QCP inside the CUDA
kernel (:mod:`mdanalysis_mpi_tpu_torch.ops.fused_planar`).

Conventions (those of the JAX package's ``ops/align.py``): coordinates
are row vectors; ``H = mobileᵀ @ ref``; the optimal rotation is
``R = U @ diag(1,1,d) @ Vᵀ`` with ``d = sign(det(U@Vᵀ))``, applied as
``aligned = mobile @ R``.  ``torch.linalg.svd`` may return U and V
with other signs than ``jnp.linalg.svd``; R is the same after the
det-correction, so compare rotations, never U or V.
"""

from __future__ import annotations

import torch

from mdanalysis_mpi_tpu_torch import device as _device  # noqa: F401  (TF32 off)


def weighted_center(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mass-weighted center: x (..., N, 3), weights (N,) → (..., 3).

    Reference: ``AtomGroup.center_of_mass()`` at RMSF.py:84,94.
    """
    w = weights / weights.sum()
    return torch.einsum("...ni,n->...i", x, w)


def kabsch_from_correlation(H: torch.Tensor) -> torch.Tensor:
    """Optimal rotation from the 3x3 correlation matrix H = mobileᵀ·ref
    (both point sets centered), batched over leading dims: one
    ``torch.linalg.svd`` on ``(..., 3, 3)`` plus the det-correction
    folded into U's last column."""
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    d = torch.sign(torch.linalg.det(U @ Vt))
    U = torch.cat([U[..., :, :-1], U[..., :, -1:] * d[..., None, None]],
                  dim=-1)
    return U @ Vt


def kabsch_rotation(mobile: torch.Tensor, ref: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """Optimal rotation R minimizing ||mobile @ R - ref||_w.

    ``mobile`` is (..., N, 3) (a leading frame axis batches the solve),
    ``ref`` (N, 3); both centered.
    """
    if weights is not None:
        H = torch.einsum("...ni,n,nj->...ij", mobile, weights, ref)
    else:
        H = torch.einsum("...ni,nj->...ij", mobile, ref)
    return kabsch_from_correlation(H)


#: The JAX package's ``jax.vmap(kabsch_rotation, in_axes=(0, None,
#: None))``: ``kabsch_rotation`` already batches over a leading frame
#: axis of ``mobile`` (B, N, 3) against one ``ref`` (N, 3) → (B, 3, 3).
kabsch_rotation_batch = kabsch_rotation


def superpose_batch(coords: torch.Tensor, sel_idx: torch.Tensor,
                    sel_weights: torch.Tensor,
                    ref_sel_centered: torch.Tensor, ref_com: torch.Tensor,
                    rot_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Superpose every frame of a (B, N, 3) all-atom batch onto the
    reference via the selection: mass-weighted COM, Kabsch rotation fit
    on the selection, applied to ALL atoms, translated onto ``ref_com``
    (the reference's per-frame body, RMSF.py:92-101; quirk Q5)."""
    sel = coords[:, sel_idx]
    com = weighted_center(sel, sel_weights)
    R = kabsch_rotation(sel - com[:, None, :], ref_sel_centered,
                        rot_weights)
    return torch.einsum("bni,bij->bnj", coords - com[:, None, :], R) + ref_com


def superpose_selection_batch(sel_coords: torch.Tensor,
                              sel_weights: torch.Tensor,
                              ref_sel_centered: torch.Tensor,
                              ref_com: torch.Tensor,
                              rot_weights: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Lean path: superpose only the (B, S, 3) selection atoms."""
    com = weighted_center(sel_coords, sel_weights)
    sel_c = sel_coords - com[:, None, :]
    R = kabsch_rotation(sel_c, ref_sel_centered, rot_weights)
    return torch.einsum("bni,bij->bnj", sel_c, R) + ref_com
