"""Distance-based analyses: contact maps and per-frame distance
matrices (BASELINE config 5: ``distances.self_distance_array`` /
contact map, per frame)."""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group, to_numpy,
                                                    tree_add, tree_psum)
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
from mdanalysis_mpi_tpu_torch.ops import host


def _contact_kernel(params, batch, boxes, mask):
    from mdanalysis_mpi_tpu_torch.ops.distances import contact_fraction_batch

    (cutoff,) = params      # float32 scalar tensor; used only in comparisons
    return contact_fraction_batch(batch, boxes, mask, cutoff)


class ContactMap(AnalysisBase):
    """Time-averaged contact map of an AtomGroup.

    ``.results.contact_fraction`` is the (S, S) fraction of frames in
    which each pair sits within ``cutoff`` (minimum-image if the
    trajectory has a box); ``.results.contact_map`` thresholds it at
    ``persistence``.  Materializes (S, S) per frame — selection-sized
    groups (Cα, residues); use the RDF histogram for full systems.
    """

    def __init__(self, atomgroup: AtomGroup, cutoff: float = 8.0,
                 persistence: float = 0.5, verbose: bool = False):
        super().__init__(atomgroup.universe, verbose)
        self._ag = atomgroup
        self._cutoff = float(cutoff)
        self._persistence = float(persistence)

    def _prepare(self):
        if self._ag.n_atoms == 0:
            raise ValueError("ContactMap over an empty AtomGroup")
        self._idx = self._ag.indices
        s = len(self._idx)
        self._acc = np.zeros((s, s), dtype=np.float64)
        self._t = 0

    # -- serial path --

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        box = None if ts.dimensions is None else ts.dimensions.astype(np.float64)
        d = host.distance_array(x, x, box)
        self._acc += d < self._cutoff
        self._t += 1

    def _serial_summary(self):
        return (self._acc, float(self._t))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _contact_kernel

    def _batch_params(self):
        # float32, so cutoff² rounds where the JAX package's weak-typed
        # float32 scalar does
        return (np.float32(self._cutoff),)

    _device_fold_fn = staticmethod(tree_add)
    _device_combine = staticmethod(tree_psum)

    def _identity_partials(self):
        s = len(self._idx)
        return (np.zeros((s, s)), 0.0)

    def _conclude(self, total):
        if self.n_frames == 0:
            raise ValueError("ContactMap over zero frames")
        acc, t = total
        persistence = self._persistence

        def _finalize():
            # fetching acc/t is a device readback — deferred to first
            # result access (base.Deferred)
            t_host = float(to_numpy(t))
            if t_host == 0:
                raise ValueError("ContactMap over zero frames")
            frac = np.asarray(to_numpy(acc), np.float64) / t_host
            return {"contact_fraction": frac,
                    "contact_map": frac >= persistence,
                    "n_frames": int(t_host)}

        group = deferred_group(_finalize)
        self.results.contact_fraction = group["contact_fraction"]
        self.results.contact_map = group["contact_map"]
        self.results.n_frames = group["n_frames"]


def _pairwise_kernel(params, batch, boxes, mask):
    from mdanalysis_mpi_tpu_torch.ops.distances import (_sq_norm,
                                                        minimum_image)

    iu, ju = params
    return torch.stack([torch.sqrt(_sq_norm(minimum_image(x[iu] - x[ju],
                                                          box6)))
                        for x, box6 in zip(batch, boxes)])


class PairwiseDistances(AnalysisBase):
    """Per-frame condensed self-distance arrays of an AtomGroup.

    ``.results.distances`` is (n_frames, S·(S-1)/2) in upstream's
    ``self_distance_array`` order.  Memory scales with frames × pairs —
    a per-frame map (use :class:`ContactMap` or the RDF histogram for
    reductions at scale).  The JAX package runs it on the host only;
    here the batch path computes each block's rows in float32 on the
    run's device (a frame with a zero box is not wrapped), and
    ``backend="serial"`` is the float64 NumPy loop.
    """

    def __init__(self, atomgroup: AtomGroup, verbose: bool = False):
        super().__init__(atomgroup.universe, verbose)
        self._ag = atomgroup

    def _prepare(self):
        if self._ag.n_atoms < 2:
            raise ValueError("PairwiseDistances needs at least 2 atoms")
        self._idx = self._ag.indices
        self._triu = np.triu_indices(len(self._idx), k=1)
        self._rows: list[np.ndarray] = []

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        box = None if ts.dimensions is None else ts.dimensions.astype(np.float64)
        d = host.distance_array(x, x, box)
        self._rows.append(d[self._triu])

    def _serial_summary(self):
        return np.asarray(self._rows).reshape(-1, len(self._triu[0]))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _pairwise_kernel

    def _batch_params(self):
        return tuple(t.astype(np.int64) for t in self._triu)

    def _identity_partials(self):
        return np.zeros((0, len(self._triu[0])), dtype=np.float32)

    def _conclude(self, total):
        # blocks are padded only at the end of the last one, so the real
        # frames are the first n_frames rows; a device tensor stays on
        # the device until the result is read
        self.results.distances = total[:self.n_frames]
        self.results.n_frames = self.n_frames


def dist(ag1, ag2, offset=0, box=None):
    """Row-wise distances between two equal-sized AtomGroups on the
    CURRENT frame (upstream ``analysis.distances.dist``): returns a
    stacked ``(3, N)`` ndarray ``[resids1 + offA, resids2 + offB, d]``.
    ``offset`` is a single int applied to both resid rows or an
    ``(offset_A, offset_B)`` pair, matching upstream."""
    if ag1.n_atoms != ag2.n_atoms:
        raise ValueError(
            f"groups have different sizes ({ag1.n_atoms}, {ag2.n_atoms})")
    try:
        off_a, off_b = offset
    except TypeError:
        off_a = off_b = offset
    dims = None if box is None else np.asarray(box)
    disp = host.minimum_image(
        ag1.positions.astype(np.float64) - ag2.positions.astype(np.float64),
        dims)
    d = np.sqrt((disp ** 2).sum(-1))
    return np.array([ag1.resids + off_a, ag2.resids + off_b, d])


def contact_matrix(coord, cutoff: float = 15.0, returntype: str = "numpy",
                   box=None):
    """Dense or sparse boolean contact map of one coordinate set
    (upstream ``analysis.distances.contact_matrix``): entry (i, j) is
    True when ``d(i, j) < cutoff`` under the optional minimum-image
    box; the diagonal is True (zero self-distance), as upstream."""
    x = np.asarray(coord, dtype=np.float64)
    if returntype == "numpy":
        d = host.distance_array(x, x, None if box is None else np.asarray(box))
        return d < cutoff
    if returntype == "sparse":
        from scipy import sparse

        from mdanalysis_mpi_tpu_torch.lib.distances import self_capped_distance

        # full-precision coords and a STRICT d < cutoff filter, so the
        # sparse and dense returntypes agree at the boundary
        pairs, d = self_capped_distance(
            x, cutoff, box=None if box is None else np.asarray(box),
            return_distances=True)
        pairs = pairs[d < cutoff]
        n = len(x)
        rows = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(n)])
        cols = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(n)])
        return sparse.coo_matrix(
            (np.ones(len(rows), dtype=bool), (rows, cols)),
            shape=(n, n)).tolil()
    raise ValueError(
        f"returntype must be 'numpy' or 'sparse', got {returntype!r}")


def between(group, A, B, distance: float):
    """Atoms of ``group`` within ``distance`` of BOTH groups A and B on
    the current frame (upstream ``analysis.distances.between``)."""
    box = group.universe.trajectory.ts.dimensions
    pos = group.positions.astype(np.float64)
    near_a = host.distance_array(pos, A.positions.astype(np.float64),
                                 box).min(axis=1) < distance
    near_b = host.distance_array(pos, B.positions.astype(np.float64),
                                 box).min(axis=1) < distance
    return AtomGroup(group.universe, group.indices[near_a & near_b])
