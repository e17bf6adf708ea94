"""Least-squares superposition ops (PyTorch).

Replacement for the reference's per-frame QCP alignment
(``qcp.CalcRMSDRotationalMatrix`` wrapped at RMSF.py:43-51, applied at
RMSF.py:99-101/133-135), batched over frames.  The JAX package solves
the 3x3 Kabsch problem by SVD (``ops/align.py``); the port solves it by
QCP (:func:`qcp_rotation`, the same solve the fused kernel does in
``csrc/fused_rmsf.cu`` and the JAX package's Pallas kernel does in
``pallas_fused._qcp_rotation``).  A batched ``torch.linalg.svd`` on
the card makes the host wait (2 stream and 1 device synchronisation a
call), so no CUDA graph could capture it; QCP is elementwise tensor
arithmetic with no readback.  :func:`kabsch_from_correlation_svd`
keeps the SVD form as the reference algebra for the tests.

Conventions (those of the JAX package's ``ops/align.py``): coordinates
are row vectors; ``H = mobileᵀ @ ref``; the optimal rotation ``R`` is
applied as ``aligned = mobile @ R``.  Where the optimal rotation is not
unique (a zero correlation, collinear atoms) the solves may differ in
``R`` but not in the residual they minimise; a zero correlation gives
the identity in both.
"""

from __future__ import annotations

import torch

from mdanalysis_mpi_tpu_torch import device as _device  # noqa: F401  (TF32 off)

_NEWTON_ITERS = 40


def weighted_center(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mass-weighted center: x (..., N, 3), weights (N,) → (..., 3).

    Reference: ``AtomGroup.center_of_mass()`` at RMSF.py:84,94.
    """
    w = weights / weights.sum()
    return torch.einsum("...ni,n->...i", x, w)


def qcp_rotation(h):
    """QCP rotation solve, elementwise over tensors of any shape: ``h``
    is the nine correlation entries ``[h00..h22]`` (H = mobileᵀ·ref,
    weights folded in); returns the nine rotation entries R00..R22 with
    ``aligned = mobile @ R`` (the torch version of the JAX package's
    ``pallas_fused._qcp_rotation``, same constants: Frobenius
    normalisation, 40 Newton steps from ``sqrt(3·tr HᵀH)``, the
    max-norm adjugate row, identity for a degenerate frame)."""
    h00, h01, h02, h10, h11, h12, h20, h21, h22 = h

    trHH_raw = (h00 * h00 + h01 * h01 + h02 * h02
                + h10 * h10 + h11 * h11 + h12 * h12
                + h20 * h20 + h21 * h21 + h22 * h22)
    fro = torch.clamp(torch.sqrt(trHH_raw), min=1e-30)
    s = 1.0 / fro
    h00, h01, h02 = h00 * s, h01 * s, h02 * s
    h10, h11, h12 = h10 * s, h11 * s, h12 * s
    h20, h21, h22 = h20 * s, h21 * s, h22 * s

    k00 = h00 + h11 + h22
    k01 = h12 - h21
    k02 = h20 - h02
    k03 = h01 - h10
    k11 = h00 - h11 - h22
    k12 = h01 + h10
    k13 = h20 + h02
    k22 = -h00 + h11 - h22
    k23 = h12 + h21
    k33 = -h00 - h11 + h22

    trHH = (h00 * h00 + h01 * h01 + h02 * h02
            + h10 * h10 + h11 * h11 + h12 * h12
            + h20 * h20 + h21 * h21 + h22 * h22)
    detH = (h00 * (h11 * h22 - h12 * h21)
            - h01 * (h10 * h22 - h12 * h20)
            + h02 * (h10 * h21 - h11 * h20))
    c2 = -2.0 * trHH
    c1 = -8.0 * detH
    d0 = (k11 * (k22 * k33 - k23 * k23)
          - k12 * (k12 * k33 - k23 * k13)
          + k13 * (k12 * k23 - k22 * k13))
    d1 = (k01 * (k22 * k33 - k23 * k23)
          - k12 * (k02 * k33 - k23 * k03)
          + k13 * (k02 * k23 - k22 * k03))
    d2 = (k01 * (k12 * k33 - k23 * k13)
          - k11 * (k02 * k33 - k23 * k03)
          + k13 * (k02 * k13 - k12 * k03))
    d3 = (k01 * (k12 * k23 - k22 * k13)
          - k11 * (k02 * k23 - k22 * k03)
          + k12 * (k02 * k13 - k12 * k03))
    c0 = k00 * d0 - k01 * d1 + k02 * d2 - k03 * d3

    lam = torch.sqrt(3.0 * trHH) + 1e-6
    for _ in range(_NEWTON_ITERS):
        lam2 = lam * lam
        p = lam2 * lam2 + c2 * lam2 + c1 * lam + c0
        dp = 4.0 * lam2 * lam + 2.0 * c2 * lam + c1
        dp = torch.where(torch.abs(dp) < 1e-30,
                         torch.full_like(dp, 1e-30), dp)
        lam = lam - p / dp

    a00 = k00 - lam
    a11 = k11 - lam
    a22 = k22 - lam
    a33 = k33 - lam
    a01, a02, a03, a12, a13, a23 = k01, k02, k03, k12, k13, k23

    def det3(b00, b01, b02, b10, b11, b12, b20, b21, b22):
        return (b00 * (b11 * b22 - b12 * b21)
                - b01 * (b10 * b22 - b12 * b20)
                + b02 * (b10 * b21 - b11 * b20))

    rows = [
        (det3(a11, a12, a13, a12, a22, a23, a13, a23, a33),
         -det3(a01, a12, a13, a02, a22, a23, a03, a23, a33),
         det3(a01, a11, a13, a02, a12, a23, a03, a13, a33),
         -det3(a01, a11, a12, a02, a12, a22, a03, a13, a23)),
        (-det3(a01, a02, a03, a12, a22, a23, a13, a23, a33),
         det3(a00, a02, a03, a02, a22, a23, a03, a23, a33),
         -det3(a00, a01, a03, a02, a12, a23, a03, a13, a33),
         det3(a00, a01, a02, a02, a12, a22, a03, a13, a23)),
        (det3(a01, a02, a03, a11, a12, a13, a13, a23, a33),
         -det3(a00, a02, a03, a01, a12, a13, a03, a23, a33),
         det3(a00, a01, a03, a01, a11, a13, a03, a13, a33),
         -det3(a00, a01, a02, a01, a11, a12, a03, a13, a23)),
        (-det3(a01, a02, a03, a11, a12, a13, a12, a22, a23),
         det3(a00, a02, a03, a01, a12, a13, a02, a22, a23),
         -det3(a00, a01, a03, a01, a11, a13, a02, a12, a23),
         det3(a00, a01, a02, a01, a11, a12, a02, a12, a22)),
    ]
    qa, qb, qc, qd = rows[0]
    nbest = qa * qa + qb * qb + qc * qc + qd * qd
    for ra, rb, rc, rd in rows[1:]:
        n = ra * ra + rb * rb + rc * rc + rd * rd
        use = n > nbest
        qa = torch.where(use, ra, qa)
        qb = torch.where(use, rb, qb)
        qc = torch.where(use, rc, qc)
        qd = torch.where(use, rd, qd)
        nbest = torch.maximum(nbest, n)

    nrm = torch.sqrt(torch.clamp(nbest, min=0.0))
    degenerate = nrm < 1e-18
    invn = torch.where(degenerate, torch.zeros_like(nrm),
                       1.0 / torch.clamp(nrm, min=1e-30))
    qw = torch.where(degenerate, torch.ones_like(qa), qa * invn)
    qx = qb * invn
    qy = qc * invn
    qz = qd * invn

    r00 = qw * qw + qx * qx - qy * qy - qz * qz
    r10 = 2.0 * (qx * qy - qw * qz)
    r20 = 2.0 * (qx * qz + qw * qy)
    r01 = 2.0 * (qx * qy + qw * qz)
    r11 = qw * qw - qx * qx + qy * qy - qz * qz
    r21 = 2.0 * (qy * qz - qw * qx)
    r02 = 2.0 * (qx * qz - qw * qy)
    r12 = 2.0 * (qy * qz + qw * qx)
    r22 = qw * qw - qx * qx - qy * qy + qz * qz
    return r00, r01, r02, r10, r11, r12, r20, r21, r22


def kabsch_from_correlation(H: torch.Tensor) -> torch.Tensor:
    """Optimal rotation from the 3x3 correlation matrix H = mobileᵀ·ref
    (both point sets centered), batched over leading dims, by QCP: no
    host synchronisation, so a CUDA graph can capture it (the JAX
    package's ``kabsch_from_correlation`` solves the same problem by
    SVD).  The solve runs in float64 and returns ``H``'s dtype: in
    float32 QCP loses accuracy where the top eigenvalue of its 4x4
    quaternion matrix is (nearly) double — collinear atoms, a nearly
    rank-2 correlation — and float64 keeps the rotation within a few
    1e-6 of the float32 SVD there (tests/test_torch_checkpoint.py)."""
    h = H.to(torch.float64)
    r = qcp_rotation([h[..., i, j] for i in range(3) for j in range(3)])
    return torch.stack(r, dim=-1).reshape(H.shape).to(H.dtype)


def kabsch_from_correlation_svd(H: torch.Tensor) -> torch.Tensor:
    """The SVD form of :func:`kabsch_from_correlation` (one
    ``torch.linalg.svd`` on ``(..., 3, 3)`` plus the det-correction
    folded into U's last column), kept as the reference algebra the
    tests hold the QCP solve to.  ``torch.linalg.svd`` may return U and
    V with other signs than ``jnp.linalg.svd``; R is the same after the
    det-correction, so compare rotations, never U or V."""
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


def aligned_moments_step(carry, sel_block, mask, sel_weights,
                         ref_sel_centered, ref_com, rot_weights=None):
    """Scan step of the pass-2 reduction (the JAX package's
    ``ops/align.py::aligned_moments_step``): superpose one (B, S, 3)
    selection block onto the fixed reference and fold its moments into
    the (T, mean, M2) carry."""
    from mdanalysis_mpi_tpu_torch.ops.moments import (batch_moments,
                                                      merge_moments)

    aligned = superpose_selection_batch(
        sel_block, sel_weights, ref_sel_centered, ref_com, rot_weights)
    return merge_moments(carry, batch_moments(aligned, mask))


def scan_aligned_moments(blocks, masks, sel_weights, ref_sel_centered,
                         ref_com, rot_weights=None):
    """Aligned moments of a stacked (K, B, S, 3) group (the JAX
    package's ``scan_aligned_moments``, a ``lax.scan``): the carry
    seeds from block 0 and each step folds one block, in block order —
    the per-block schedule's ops in its order, so the result is equal
    to folding the blocks one by one."""
    from mdanalysis_mpi_tpu_torch.ops.moments import batch_moments

    acc = batch_moments(
        superpose_selection_batch(blocks[0], sel_weights,
                                  ref_sel_centered, ref_com, rot_weights),
        masks[0])
    for k in range(1, blocks.shape[0]):
        acc = aligned_moments_step(acc, blocks[k], masks[k], sel_weights,
                                   ref_sel_centered, ref_com, rot_weights)
    return acc
