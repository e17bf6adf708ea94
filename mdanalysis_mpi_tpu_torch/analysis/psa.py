"""Path similarity analysis (upstream ``MDAnalysis.analysis.psa``; the
JAX package's ``analysis/psa.py``).

A *path* is a trajectory viewed as a curve in configuration space: the
(T, S, 3) coordinates of one selection over time.  PSA quantifies how
similar two simulations are by a distance between their paths:

- ``hausdorff``: the classic symmetric Hausdorff distance — the worst
  best-match frame RMSD between the two paths;
- ``discrete_frechet``: the discrete Fréchet distance — the minimal
  "leash length" walking both paths monotonically (order-sensitive,
  unlike Hausdorff).

Both reduce the (T₁, T₂) cross-RMSD matrix between the two frame sets.

Device shape: the cross-RMSD matrix is one matrix product —
``|P_i − Q_j|² = |P_i|² + |Q_j|² − 2·P_i·Q_j`` — batched over every path
pair of the same frame counts; Hausdorff is a masked max/min, and the
Fréchet recurrence runs as an anti-diagonal wavefront
(:func:`frechet_wavefront`): cell (i, j) needs only (i−1, j), (i, j−1)
and (i−1, j−1), so every cell of one anti-diagonal i + j = d is one
vectorised step, T₁ + T₂ − 1 steps in all (the JAX package's nested
``lax.scan`` is T₁·T₂ sequential steps).  The recurrence takes only
``max`` and ``min``, so on the same cross matrix the wavefront gives
exactly the host recurrence's value.  The serial oracle is the
straightforward float64 NumPy computation.

Precision envelope: the expanded form cancels catastrophically when
two frames nearly coincide, so the float32 device path has an absolute
distance floor of ~1e-2 Å (near-identical paths read as ~0.005–0.05
rather than exactly 0).  Path distances of interest are O(Å); for
exact-zero discrimination use ``backend="serial"`` (float64 oracle).

Upstream: ``psa.hausdorff(P, Q)`` / ``psa.discrete_frechet(P, Q)`` and
``PSAnalysis(universes, select=...).run(metric=...)`` →
``results.D`` (n_paths × n_paths).  Upstream aligns trajectories first
(``align=True`` here superposes every frame onto the first path's first
frame with the host QCP, ops/host.py).  The JAX package's
``backend="jax"`` is ``backend="torch"`` here, on ``device`` (``cuda``
unless given); ``'jax'`` is refused with an error naming ``'torch'``.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import Results, deferred_group


def _as_path(obj, select: str | None):
    """Universe | AtomGroup → (T, S, 3) float64 path array."""
    from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
    from mdanalysis_mpi_tpu_torch.core.universe import Universe

    if isinstance(obj, np.ndarray):
        p = np.asarray(obj, np.float64)
        if p.ndim != 3 or p.shape[-1] != 3:
            raise ValueError(
                f"a path array must be (T, S, 3), got {p.shape}")
        return p
    if isinstance(obj, Universe):
        ag = obj.select_atoms(select or "name CA")
    elif isinstance(obj, AtomGroup):
        ag = obj                 # the group IS the path selection
    else:
        raise TypeError(
            f"cannot build a path from {type(obj).__name__}; pass a "
            "Universe, AtomGroup or (T, S, 3) ndarray")
    u = ag.universe
    idx = ag.indices
    block, _ = u.trajectory.read_block(0, u.trajectory.n_frames, sel=idx)
    return np.asarray(block, np.float64)


def align_path(p: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Kabsch-superpose every frame of path ``p`` (T, S, 3) onto the
    single reference structure ``ref`` (S, 3) — the shared pre-
    alignment of PSA and encore.hes (one implementation; ops/host QCP).
    """
    from mdanalysis_mpi_tpu_torch.ops import host

    ref_com = ref.mean(axis=0)
    ref_c = ref - ref_com
    out = np.empty_like(p, dtype=np.float64)
    for i, x in enumerate(p):
        xc = x - x.mean(axis=0)
        # qcp_rotation's R applies as `mobile @ R` (row vectors)
        out[i] = xc @ host.qcp_rotation(xc, ref_c) + ref_com
    return out


def _cross_rmsd_np(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(T1, S, 3), (T2, S, 3) → (T1, T2) frame-pair RMSD, float64."""
    s = p.shape[1]
    a = p.reshape(len(p), -1)
    b = q.reshape(len(q), -1)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None]
          - 2.0 * (a @ b.T))
    return np.sqrt(np.maximum(d2, 0.0) / s)


def hausdorff(p, q) -> float:
    """Symmetric Hausdorff distance between two (T, S, 3) paths
    (upstream ``psa.hausdorff``), point metric = frame RMSD."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    m = _cross_rmsd_np(p, q)
    return float(max(m.min(axis=1).max(), m.min(axis=0).max()))


def _frechet_np(m: np.ndarray) -> float:
    """The discrete Fréchet recurrence over one (T1, T2) cross matrix,
    row by row (the host oracle; :func:`frechet_wavefront` is its device
    form)."""
    m = np.asarray(m)
    t1, t2 = m.shape
    row = np.empty(t2, m.dtype)
    row[0] = m[0, 0]
    for j in range(1, t2):
        row[j] = max(row[j - 1], m[0, j])
    for i in range(1, t1):
        new = np.empty(t2, m.dtype)
        new[0] = max(row[0], m[i, 0])
        for j in range(1, t2):
            new[j] = max(min(row[j], row[j - 1], new[j - 1]), m[i, j])
        row = new
    return float(row[-1])


def discrete_frechet(p, q) -> float:
    """Discrete Fréchet distance between two (T, S, 3) paths (upstream
    ``psa.discrete_frechet``), point metric = frame RMSD."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    return _frechet_np(_cross_rmsd_np(p, q))


# ---- device twins (torch ops) ----

def cross_rmsd(p, q):
    """(..., T1, S, 3), (..., T2, S, 3) tensors → (..., T1, T2) frame-pair
    RMSDs by the expanded form (one batched matrix product)."""
    s = p.shape[-2]
    a = p.reshape(p.shape[:-2] + (-1,))
    b = q.reshape(q.shape[:-2] + (-1,))
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * (a @ b.transpose(-1, -2)))
    return torch.sqrt(torch.clamp(d2, min=0.0) / s)


def hausdorff_from_cross(m):
    """(..., T1, T2) → (...) symmetric Hausdorff distances."""
    return torch.maximum(m.min(dim=-1).values.max(dim=-1).values,
                         m.min(dim=-2).values.max(dim=-1).values)


def frechet_wavefront(m):
    """(..., T1, T2) cross matrices → (...) discrete Fréchet distances,
    one vectorised step an anti-diagonal.

    ``diag[..., d, i]`` is cell (i, d − i); after step d, ``prev1`` holds
    anti-diagonal d and ``prev2`` anti-diagonal d − 1, with +inf at the
    cells outside the matrix, so cell (i, j) reads (i − 1, j) at
    ``prev1[i − 1]``, (i, j − 1) at ``prev1[i]`` and (i − 1, j − 1) at
    ``prev2[i − 1]``.  Only ``min`` and ``max`` touch the values."""
    t1, t2 = m.shape[-2], m.shape[-1]
    dev = m.device
    i = torch.arange(t1, device=dev)
    d = torch.arange(t1 + t2 - 1, device=dev)
    j = d[:, None] - i[None, :]                         # (D, T1)
    valid = (j >= 0) & (j < t2)
    diag = m[..., i[None, :].expand_as(j), j.clamp(0, t2 - 1)]
    inf = torch.full((), float("inf"), dtype=m.dtype, device=dev)
    pad = torch.nn.functional.pad
    prev2 = torch.full(m.shape[:-2] + (t1,), float("inf"), dtype=m.dtype,
                       device=dev)
    prev1 = torch.where(i == 0, diag[..., 0, :], inf)
    for k in range(1, t1 + t2 - 1):
        up = pad(prev1[..., :-1], (1, 0), value=float("inf"))
        corner = pad(prev2[..., :-1], (1, 0), value=float("inf"))
        best = torch.minimum(torch.minimum(up, corner), prev1)
        new = torch.where(valid[k], torch.maximum(best, diag[..., k, :]),
                          inf)
        prev2, prev1 = prev1, new
    return prev1[..., t1 - 1]


def _pair_values(paths, pairs, metric: str, device):
    """Distances of ``pairs`` (i, j) of host ``paths`` on ``device``:
    the pairs of equal frame counts go as one batch; one read back a
    batch."""
    dev_paths = [torch.as_tensor(np.asarray(p, np.float32), device=device)
                 for p in paths]
    groups: dict = {}
    for i, j in pairs:
        groups.setdefault((len(paths[i]), len(paths[j])), []).append((i, j))
    out = {}
    for members in groups.values():
        p = torch.stack([dev_paths[i] for i, _ in members])
        q = torch.stack([dev_paths[j] for _, j in members])
        m = cross_rmsd(p, q)
        vals = (hausdorff_from_cross(m) if metric == "hausdorff"
                else frechet_wavefront(m))
        for pair, v in zip(members, vals.cpu().numpy().tolist()):
            out[pair] = v
    return out


_METRICS = ("hausdorff", "discrete_frechet")


class PSAnalysis:
    """``PSAnalysis([u1, u2, ...], select="name CA").run(
    metric="hausdorff", backend="torch")`` → ``results.D``
    (n_paths × n_paths symmetric distance matrix), ``results.paths``.

    Inputs may be Universes, AtomGroups or raw (T, S, 3) arrays; every
    path must share the selection width S (frame counts may differ —
    both metrics are defined between unequal-length paths).
    ``align=True`` (default) superposes every frame of every path onto
    the first path's first frame (upstream pre-aligns with AlignTraj).
    """

    def __init__(self, inputs, select: str | None = "name CA",
                 align: bool = True, verbose: bool = False):
        inputs = list(inputs)
        if len(inputs) < 2:
            raise ValueError("PSA needs at least two paths")
        self._paths = [_as_path(o, select) for o in inputs]
        widths = {p.shape[1] for p in self._paths}
        if len(widths) != 1:
            raise ValueError(
                f"paths have different selection widths {sorted(widths)}; "
                "the point metric (frame RMSD) needs matching atoms")
        if min(len(p) for p in self._paths) == 0:
            raise ValueError("empty path (0 frames)")
        if align:
            self._paths = [self._align(p) for p in self._paths]
        self._verbose = verbose
        self.results = Results()

    def _align(self, p: np.ndarray) -> np.ndarray:
        return align_path(p, self._paths[0][0])

    def run(self, metric: str = "hausdorff", backend: str = "torch",
            device=None):
        """``backend="torch"`` (or ``"mesh"``, the same single-device
        route, as in the JAX package) computes on ``device`` (``cuda``
        unless given); ``"serial"`` is the float64 host oracle."""
        if metric not in _METRICS:
            raise ValueError(
                f"metric must be one of {_METRICS}, got {metric!r}")
        if backend == "jax":
            raise ValueError(
                "backend='jax' is the JAX package's name; the port's "
                "device backend is backend='torch'")
        if backend not in ("torch", "mesh", "serial"):
            raise ValueError(
                "backend must be 'torch', 'mesh' or 'serial', got "
                f"{backend!r}")
        dev = None
        if backend != "serial":
            from mdanalysis_mpi_tpu_torch.device import resolve_device

            dev = resolve_device(device)
        paths = self._paths
        n = len(paths)

        def _finalize():
            d = np.zeros((n, n))
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
            if dev is not None:
                vals = _pair_values(paths, pairs, metric, dev)
            else:
                f = hausdorff if metric == "hausdorff" else discrete_frechet
                vals = {(i, j): f(paths[i], paths[j]) for i, j in pairs}
            for (i, j), v in vals.items():
                d[i, j] = d[j, i] = v
            return {"D": d}

        g = deferred_group(_finalize)
        self.results.D = g["D"]
        self.results.paths = paths
        self.results.metric = metric
        return self
