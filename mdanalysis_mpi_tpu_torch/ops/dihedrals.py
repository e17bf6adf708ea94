"""Batched dihedral angles (the JAX package's ``ops/dihedrals.py``).

Given a staged frame batch and K quadruples of atom slots, all K
dihedrals of all B frames in one pass — ``(B, K)`` angles in degrees,
signed by the IUPAC convention (trans = ±180°, cis = 0°): gathers,
cross products and an atan2 as torch ops, no per-dihedral Python.
"""

from __future__ import annotations

import numpy as np
import torch


def dihedral_batch(batch: torch.Tensor, quads: torch.Tensor) -> torch.Tensor:
    """batch (B, N, 3) float32; quads (K, 4) integer slot indices into
    the atom axis → (B, K) float32 dihedral angles in degrees.

    For atoms a-b-c-d: b1 = b−a, b2 = c−b, b3 = d−c, n1 = b1×b2,
    n2 = b2×b3; angle = atan2((n1×n2)·b̂2, n1·n2).
    """
    p = batch[:, quads]                       # (B, K, 4, 3)
    b1 = p[:, :, 1] - p[:, :, 0]
    b2 = p[:, :, 2] - p[:, :, 1]
    b3 = p[:, :, 3] - p[:, :, 2]
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2n = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    x = (n1 * n2).sum(-1)
    y = (torch.linalg.cross(n1, n2) * b2n).sum(-1)
    return torch.rad2deg(torch.atan2(y, x))


def dihedral_batch_np(batch, quads):
    """NumPy float64 twin (serial oracle)."""
    p = np.asarray(batch, np.float64)[:, quads]
    b1 = p[:, :, 1] - p[:, :, 0]
    b2 = p[:, :, 2] - p[:, :, 1]
    b3 = p[:, :, 3] - p[:, :, 2]
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    b2n = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    x = (n1 * n2).sum(-1)
    y = (np.cross(n1, n2) * b2n).sum(-1)
    return np.degrees(np.arctan2(y, x))
