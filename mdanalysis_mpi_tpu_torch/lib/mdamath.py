"""Math helpers mirroring upstream ``MDAnalysis.lib.mdamath``.

Thin, NumPy-only veneers over the framework's own primitives (the box
math lives in :mod:`mdanalysis_mpi_tpu_torch.core.box`, the dihedral
convention in :func:`dihedral` below), so migrating
code that imports ``lib.mdamath`` keeps working.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.box import box_to_vectors, vectors_to_box


def norm(v) -> float:
    """Euclidean norm of one vector."""
    v = np.asarray(v, dtype=np.float64)
    return float(np.sqrt((v * v).sum()))


def normal(vec1, vec2) -> np.ndarray:
    """Unit normal of the plane spanned by two vectors (zero vector when
    they are parallel, upstream behavior)."""
    n = np.cross(np.asarray(vec1, np.float64), np.asarray(vec2, np.float64))
    length = norm(n)
    if length == 0.0:
        return n
    return n / length


def angle(a, b) -> float:
    """Angle between two VECTORS in radians (upstream ``mdamath.angle``)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = norm(a) * norm(b)
    if den == 0.0:
        raise ValueError("cannot compute the angle of a zero vector")
    return float(np.arccos(np.clip((a * b).sum() / den, -1.0, 1.0)))


def dihedral(ab, bc, cd) -> float:
    """Dihedral from three consecutive BOND VECTORS, radians, IUPAC sign
    (the ``lib.distances.calc_dihedrals`` convention)."""
    b1 = np.asarray(ab, np.float64)
    b2 = np.asarray(bc, np.float64)
    b3 = np.asarray(cd, np.float64)
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    b2n = b2 / max(norm(b2), 1e-300)
    x = (n1 * n2).sum()
    y = (np.cross(n1, n2) * b2n).sum()
    return float(np.arctan2(y, x))


def triclinic_vectors(dimensions) -> np.ndarray:
    """``[lx, ly, lz, alpha, beta, gamma]`` → (3, 3) box matrix (Å),
    float32 like upstream."""
    return box_to_vectors(np.asarray(dimensions)).astype(np.float32)


def triclinic_box(x, y, z) -> np.ndarray:
    """Three box vectors → ``[lx, ly, lz, alpha, beta, gamma]``."""
    return vectors_to_box(np.stack([np.asarray(x), np.asarray(y),
                                    np.asarray(z)]))


def box_volume(dimensions) -> float:
    """Cell volume (Å³) from ``[lx, ly, lz, alpha, beta, gamma]``."""
    return float(abs(np.linalg.det(
        box_to_vectors(np.asarray(dimensions, np.float64)))))


def make_whole(atomgroup, inplace: bool = True) -> np.ndarray:
    """Make a bonded group whole across periodic boundaries at the
    CURRENT frame (upstream ``lib.mdamath.make_whole``): every atom
    moves to the minimum-image position relative to its bond-tree
    parent.  Requires bonds (PSF or ``guess_bonds``) and a box on the
    frame.  Returns the whole positions; ``inplace=True`` (upstream
    default) also writes them back to the Timestep.

    One-shot form of ``transformations.unwrap`` — attach that to the
    trajectory instead when every frame needs it (the bond tree is
    then built once, not per call).
    """
    from mdanalysis_mpi_tpu_torch.lib.distances import _valid_box_matrix
    from mdanalysis_mpi_tpu_torch.transformations import unwrap

    u = atomgroup.universe
    ts = u.trajectory.ts
    # strict validation: a partially degenerate box ([10, 0, 0, ...])
    # would sail past an any(length > 0) check and write NaNs back
    _valid_box_matrix(ts.dimensions, "make_whole")
    t = unwrap(atomgroup)
    if inplace:
        t(ts)
        return ts.positions[atomgroup.indices]
    saved = ts.positions.copy()
    try:
        t(ts)
        return ts.positions[atomgroup.indices].copy()
    finally:
        ts.positions = saved
