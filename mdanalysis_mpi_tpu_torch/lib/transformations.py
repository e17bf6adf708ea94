"""Homogeneous (4×4) transformation matrices — the working subset of
upstream ``MDAnalysis.lib.transformations`` that MD setup scripts lean
on.  Independent implementation from the standard formulas (Rodrigues
rotation, Shoemake quaternion extraction, per-convention Euler
factorization); upstream conventions preserved exactly:

- matrices are 4×4 float64, applied to COLUMN vectors (``M @ v``),
- angles are in RADIANS,
- ``axes`` strings name the 24 Euler conventions (``"sxyz"`` static
  x-y-z default; leading ``r`` = rotating/intrinsic frame).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "identity_matrix", "translation_matrix", "translation_from_matrix",
    "rotation_matrix", "rotation_from_matrix", "scale_matrix",
    "concatenate_matrices", "euler_matrix", "euler_from_matrix",
    "quaternion_matrix", "quaternion_from_matrix",
]

_NEXT_AXIS = [1, 2, 0, 1]


def _vec3(v) -> np.ndarray:
    """3-vector from a 3- or homogeneous 4-vector (upstream slices
    ``[:3]``, so ``point=M[:, 3]`` idioms must keep working)."""
    v = np.asarray(v, dtype=np.float64).reshape(-1)
    if v.shape[0] not in (3, 4):
        raise ValueError(f"expected a 3- or 4-vector, got shape {v.shape}")
    return v[:3]


def _unit(v) -> np.ndarray:
    v = _vec3(v)
    n = float(np.linalg.norm(v))
    if n == 0.0:
        raise ValueError("direction must be a nonzero vector")
    return v / n


def identity_matrix() -> np.ndarray:
    return np.eye(4)


def translation_matrix(direction) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = _vec3(direction)
    return m


def translation_from_matrix(matrix) -> np.ndarray:
    return np.asarray(matrix, dtype=np.float64)[:3, 3].copy()


def rotation_matrix(angle: float, direction, point=None) -> np.ndarray:
    """Rotation by ``angle`` radians about the axis along ``direction``
    through ``point`` (origin if None)."""
    k = _unit(direction)
    s, c = math.sin(angle), math.cos(angle)
    kx = np.array([[0.0, -k[2], k[1]],
                   [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    r = np.eye(3) * c + s * kx + (1.0 - c) * np.outer(k, k)
    m = np.eye(4)
    m[:3, :3] = r
    if point is not None:
        p = _vec3(point)
        m[:3, 3] = p - r @ p
    return m


def rotation_from_matrix(matrix):
    """(angle, direction, point) recovering ``rotation_matrix`` inputs.

    The axis is the rotation part's unit-eigenvalue eigenvector; the
    point is its counterpart for the full homogeneous matrix.
    """
    m = np.asarray(matrix, dtype=np.float64)
    r = m[:3, :3]
    w, v = np.linalg.eig(r)
    i = int(np.argmin(np.abs(w - 1.0)))
    if abs(w[i] - 1.0) > 1e-8:
        raise ValueError("matrix has no rotation axis (not a rotation?)")
    direction = np.real(v[:, i])
    direction /= np.linalg.norm(direction)
    # angle from trace; sign from a component off the axis
    cosa = (np.trace(r) - 1.0) / 2.0
    if abs(direction[2]) > 1e-8:
        sina = (r[1, 0] + (cosa - 1.0) * direction[0] * direction[1]) \
            / direction[2]
    elif abs(direction[1]) > 1e-8:
        sina = (r[0, 2] + (cosa - 1.0) * direction[0] * direction[2]) \
            / direction[1]
    else:
        sina = (r[2, 1] + (cosa - 1.0) * direction[1] * direction[2]) \
            / direction[0]
    angle = math.atan2(sina, cosa)
    # fixed point: (R - I) p = -t is singular along the axis (the whole
    # axis line is fixed), so take the minimum-norm solution — the axis
    # point closest to the origin.  An eigenvector of the 4x4 would be
    # an ARBITRARY basis vector of the 2-D eigenspace and can land on
    # the direction (w = 0) instead of a point.
    point = -np.linalg.pinv(r - np.eye(3)) @ m[:3, 3]
    return angle, direction, point


def scale_matrix(factor: float, origin=None) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] *= float(factor)
    if origin is not None:
        m[:3, 3] = _vec3(origin) * (1.0 - float(factor))
    return m


def concatenate_matrices(*matrices) -> np.ndarray:
    """M₀ @ M₁ @ ... (applied right-to-left to column vectors)."""
    m = np.eye(4)
    for x in matrices:
        m = m @ np.asarray(x, dtype=np.float64)
    return m


def _axes_tuple(axes: str):
    """Euler convention string → (first axis, parity, repetition,
    frame, raw_seq).  ``axes[0]``: 's'tatic or 'r'otating; then three
    of xyz.  ``raw_seq`` is the literal axis sequence (for the forward
    composition); the i/j/k machinery fields derive from the static
    EQUIVALENT (a rotating convention equals the reversed static one
    with first/last angles swapped — the frame flag carries the swap).
    """
    try:
        frame = {"s": 0, "r": 1}[axes[0]]
        raw_seq = [{"x": 0, "y": 1, "z": 2}[a] for a in axes[1:]]
    except (KeyError, IndexError):
        raise ValueError(f"bad Euler axes string {axes!r}") from None
    if len(raw_seq) != 3 or raw_seq[0] == raw_seq[1] \
            or raw_seq[1] == raw_seq[2]:
        raise ValueError(f"bad Euler axes string {axes!r}")
    seq = raw_seq[::-1] if frame else raw_seq
    firstaxis = seq[0]
    repetition = int(seq[0] == seq[2])
    parity = int(_NEXT_AXIS[firstaxis] != seq[1])
    return firstaxis, parity, repetition, frame, raw_seq


def euler_matrix(ai: float, aj: float, ak: float,
                 axes: str = "sxyz") -> np.ndarray:
    """Rotation matrix from Euler angles (radians) in the named
    convention — the definitional composition of single-axis
    rotations: static axes apply in sequence about the FIXED frame
    (later rotations compose on the left), rotating axes about the
    body frame (right)."""
    _, _, _, frame, seq = _axes_tuple(axes)

    def axis_rot(axis, a):
        e = np.zeros(3)
        e[axis] = 1.0
        return rotation_matrix(a, e)

    m0, m1, m2 = (axis_rot(a, th)
                  for a, th in zip(seq, (ai, aj, ak)))
    return (m0 @ m1 @ m2) if frame else (m2 @ m1 @ m0)


def euler_from_matrix(matrix, axes: str = "sxyz"):
    """Euler angles (radians) of a rotation matrix in the named
    convention (inverse of :func:`euler_matrix`)."""
    firstaxis, parity, repetition, frame, _ = _axes_tuple(axes)
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]
    m = np.asarray(matrix, dtype=np.float64)[:3, :3]
    eps = 1e-12
    if repetition:
        sy = math.sqrt(m[i, j] ** 2 + m[i, k] ** 2)
        if sy > eps:
            ax = math.atan2(m[i, j], m[i, k])
            ay = math.atan2(sy, m[i, i])
            az = math.atan2(m[j, i], -m[k, i])
        else:
            ax = math.atan2(-m[j, k], m[j, j])
            ay = math.atan2(sy, m[i, i])
            az = 0.0
    else:
        cy = math.sqrt(m[i, i] ** 2 + m[j, i] ** 2)
        if cy > eps:
            ax = math.atan2(m[k, j], m[k, k])
            ay = math.atan2(-m[k, i], cy)
            az = math.atan2(m[j, i], m[i, i])
        else:
            ax = math.atan2(-m[j, k], m[j, j])
            ay = math.atan2(-m[k, i], cy)
            az = 0.0
    if parity:
        ax, ay, az = -ax, -ay, -az
    if frame:
        ax, az = az, ax
    return ax, ay, az


def quaternion_matrix(quaternion) -> np.ndarray:
    """4×4 rotation matrix from a (w, x, y, z) quaternion (upstream
    scalar-first convention); normalizes the input."""
    q = np.asarray(quaternion, dtype=np.float64).reshape(4)
    n = float(q @ q)
    if n < 1e-30:
        return np.eye(4)
    q = q * math.sqrt(2.0 / n)
    q = np.outer(q, q)
    m = np.eye(4)
    m[:3, :3] = [
        [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0]],
        [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0]],
        [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2]],
    ]
    return m


def quaternion_from_matrix(matrix) -> np.ndarray:
    """(w, x, y, z) unit quaternion of a rotation matrix (Shoemake's
    stable branch selection on the largest diagonal term)."""
    m = np.asarray(matrix, dtype=np.float64)[:3, :3]
    t = np.trace(m)
    if t > 0.0:
        s = math.sqrt(t + 1.0) * 2.0
        q = np.array([0.25 * s,
                      (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s])
    else:
        i = int(np.argmax(np.diagonal(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2.0
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    if q[0] < 0.0:
        q = -q
    return q
