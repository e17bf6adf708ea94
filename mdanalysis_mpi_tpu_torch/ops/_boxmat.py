"""Torch twin of :mod:`mdanalysis_mpi_tpu_torch.core.box` (no host
branching, any leading batch shape): dimensions → lower-triangular box
matrix, and per-frame box volumes."""

from __future__ import annotations

import torch


def box_to_matrix(dim: torch.Tensor) -> torch.Tensor:
    """``(..., 6)`` ``[lx,ly,lz,alpha,beta,gamma]`` → ``(..., 3, 3)``
    lower-triangular box matrices.

    Zero-length boxes yield the zero matrix (volume 0).  Angles in
    degrees.
    """
    lx, ly, lz = dim[..., 0], dim[..., 1], dim[..., 2]
    alpha, beta, gamma = (torch.deg2rad(dim[..., i]) for i in (3, 4, 5))
    ca, cb, cg = torch.cos(alpha), torch.cos(beta), torch.cos(gamma)
    sg = torch.sin(gamma)
    safe_sg = torch.where(sg.abs() < 1e-9, torch.ones_like(sg), sg)
    m10 = ly * cg
    m11 = ly * sg
    m20 = lz * cb
    m21 = lz * (ca - cb * cg) / safe_sg
    m22 = torch.sqrt(torch.clamp(lz * lz - m20 ** 2 - m21 ** 2, min=0.0))
    zero = torch.zeros_like(lx)
    return torch.stack([torch.stack([lx, zero, zero], -1),
                        torch.stack([m10, m11, zero], -1),
                        torch.stack([m20, m21, m22], -1)], -2)


def batch_box_volumes(boxes: torch.Tensor) -> torch.Tensor:
    """``(B, 6)`` staged box rows → ``(B,)`` volumes (0 for boxless zero
    rows).  The one definition of the per-frame volume used by every
    batch function that normalizes against ⟨V⟩: the determinant of the
    lower-triangular box matrix, its diagonal product."""
    m = box_to_matrix(boxes)
    return (m[..., 0, 0] * m[..., 1, 1] * m[..., 2, 2]).abs()
