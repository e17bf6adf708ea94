"""Helix geometry analysis (upstream ``MDAnalysis.analysis.helix_analysis``).

HELANAL-style local helix geometry from consecutive Cα positions
P₀..P_{n−1}:

    v_i = P_{i+1} − P_i                      (n−1 bond vectors)
    h_i = unit(v_i − v_{i+1})                (n−2 bisectors — for an
                                              ideal helix these point
                                              radially at the axis)
    cos(twist_i) = h_i · h_{i+1}             (n−3 local twists)
    axis_i = unit(h_i × h_{i+1})             (n−3 local axes)
    rise_i = v_{i+1} · axis_i                (n−3 local rises)

For an ideal helix with θ per residue and rise d, every local twist is
exactly θ and every local rise exactly d — the analytic oracle the
tests pin (α-helix: 100°, 1.5 Å).

``HELANAL(u, select="name CA").run()`` → per-frame ``results.local_twists``
/ ``local_rises`` / ``local_axes`` (T, n−3[, 3]) plus trajectory means
``results.all_twists`` / ``all_rises`` and the mean ``global_axis``.
Time-series family: the per-frame geometry is one batch function
(gathers + crosses as torch ops), concatenated in frame order on every
backend — no cross-frame coupling, so the mesh path shards frames
freely.  The JAX package's ``analysis/helix.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group,
                                                    real_frames, to_numpy)


def helix_analysis(positions: np.ndarray) -> dict:
    """Single-structure helix geometry (float64 host oracle).

    positions: (n, 3) consecutive Cα coordinates, n ≥ 5.  Returns
    ``local_twists`` (degrees, n−3), ``local_rises`` (n−3),
    ``local_axes`` (n−3, 3, unit), ``global_axis`` (3, unit mean).
    """
    p = np.asarray(positions, np.float64)
    if p.ndim != 2 or p.shape[1] != 3 or p.shape[0] < 5:
        raise ValueError(
            f"helix_analysis needs (n>=5, 3) positions, got {p.shape}")
    v = p[1:] - p[:-1]
    h = v[:-1] - v[1:]
    h = h / (np.linalg.norm(h, axis=1, keepdims=True) + 1e-30)
    cos_t = (h[:-1] * h[1:]).sum(1).clip(-1.0, 1.0)
    axes = np.cross(h[:-1], h[1:])
    axes = axes / (np.linalg.norm(axes, axis=1, keepdims=True) + 1e-30)
    rises = (v[1:-1] * axes).sum(1)
    ga = axes.mean(axis=0)
    ga = ga / (np.linalg.norm(ga) + 1e-30)
    return {"local_twists": np.degrees(np.arccos(cos_t)),
            "local_rises": rises, "local_axes": axes, "global_axis": ga}


def _helanal_kernel(params, batch, boxes, mask):
    """Batched twin: (B, S, 3) → per-frame (twists°, rises, axes),
    concatenated in frame order (time-series family)."""
    del boxes, params
    # the staged block is already selection-gathered in index order —
    # no further gather needed
    p = batch                                     # (B, n, 3)
    v = p[:, 1:] - p[:, :-1]
    h = v[:, :-1] - v[:, 1:]
    h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-30)
    cos_t = torch.clamp((h[:, :-1] * h[:, 1:]).sum(-1), -1.0, 1.0)
    axes = torch.linalg.cross(h[:, :-1], h[:, 1:])
    axes = axes / (torch.linalg.norm(axes, dim=-1, keepdim=True) + 1e-30)
    rises = (v[:, 1:-1] * axes).sum(-1)
    m = mask[:, None]
    return (torch.rad2deg(torch.arccos(cos_t)) * m, rises * m,
            axes * m[..., None], mask)


class HELANAL(AnalysisBase):
    """``HELANAL(u, select="name CA").run()`` — the selection must be
    the helix's consecutive Cα atoms in sequence order (n ≥ 5)."""

    def __init__(self, universe, select: str = "name CA",
                 verbose: bool = False):
        super().__init__(universe, verbose)
        self._select = select

    def _prepare(self):
        idx = self._universe.select_atoms(self._select).indices
        if len(idx) < 5:
            raise ValueError(
                f"HELANAL needs >= 5 atoms in sequence, selection "
                f"{self._select!r} matched {len(idx)}")
        self._idx = idx
        self._serial_rows: list = []

    def _single_frame(self, ts):
        r = helix_analysis(ts.positions[self._idx].astype(np.float64))
        self._serial_rows.append(
            (r["local_twists"], r["local_rises"], r["local_axes"]))

    def _serial_summary(self):
        n = len(self._idx)
        if not self._serial_rows:
            return (np.empty((0, n - 3)), np.empty((0, n - 3)),
                    np.empty((0, n - 3, 3)), np.empty(0))
        tw, ri, ax = (np.stack(x) for x in zip(*self._serial_rows))
        return (tw, ri, ax, np.ones(len(tw)))

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _helanal_kernel

    def _batch_params(self):
        return ()

    # time series, concatenated in frame order

    def _identity_partials(self):
        n = len(self._idx)
        return (np.empty((0, n - 3)), np.empty((0, n - 3)),
                np.empty((0, n - 3, 3)), np.empty(0))

    def _conclude(self, total):
        tw, ri, ax, mask = total
        n = self.n_frames
        tw, ri, ax = (real_frames(x, mask, n) for x in (tw, ri, ax))

        def _finalize():
            twists, rises, axes = (np.asarray(to_numpy(x), np.float64)
                                   for x in (tw, ri, ax))
            ga = axes.reshape(-1, 3).mean(axis=0)
            ga = ga / (np.linalg.norm(ga) + 1e-30)
            return {"local_twists": twists, "local_rises": rises,
                    "local_axes": axes,
                    "all_twists": twists.mean(axis=0),
                    "all_rises": rises.mean(axis=0),
                    "global_axis": ga}

        g = deferred_group(_finalize)
        for key in ("local_twists", "local_rises", "local_axes",
                    "all_twists", "all_rises", "global_axis"):
            self.results[key] = g[key]
