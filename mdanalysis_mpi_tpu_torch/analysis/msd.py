"""Einstein mean-squared-displacement analysis.

Upstream-API mirror (``MDAnalysis.analysis.msd.EinsteinMSD``):
``EinsteinMSD(u, select=..., msd_type='xyz', fft=True).run()`` →
``results.timeseries`` (T,), ``results.msds_by_particle`` (T, S).
The reference program has no MSD, but the capability envelope
(AnalysisBase over pluggable executors) is what this plugs into —
like RMSD it is a *time-series* analysis: per-batch staged positions
are concatenated on device in frame order (no fold), and the lag
algebra runs once at the end.

The FFT route (Calandrini et al.'s decomposition
``msd(m) = S1(m) − 2·S2(m)``) turns the O(T²) lag sum into one
``rfft``/``irfft`` autocorrelation over the time axis plus cumulative
sums, on the device at the first read of a result.  The JAX package's
``analysis/msd.py``.  As
with upstream, coordinates must be unwrapped for physically meaningful
MSDs (no PBC jumps); the math here is exact for whatever coordinates
are staged.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group,
                                                    real_frames, to_numpy)
from mdanalysis_mpi_tpu_torch.core.universe import Universe

_DIM_SETS = {
    "xyz": (0, 1, 2), "xy": (0, 1), "xz": (0, 2), "yz": (1, 2),
    "x": (0,), "y": (1,), "z": (2,),
}


# ---- module-level batch function ----

def _collect_kernel(params, batch, boxes, mask):
    """Gather the requested dimensions; zero padded frames so the
    concatenated series carries an honest mask."""
    del boxes
    (dims_idx,) = params
    sub = batch[:, :, dims_idx]
    return (sub * mask[:, None, None], mask)


def _np_fft_msd(pos: np.ndarray) -> np.ndarray:
    """NumPy float64 reference of the FFT MSD (serial oracle).

    pos (T, S, D) → per-particle MSD (T, S).  ``msd(m) = S1(m) − 2·S2(m)``
    with S2 from the FFT autocorrelation and S1 from cumulative sums.
    """
    t = pos.shape[0]
    pos = np.asarray(pos, np.float64)
    f = np.fft.rfft(pos, n=2 * t, axis=0)
    ac = np.fft.irfft(f * np.conj(f), n=2 * t, axis=0)[:t].sum(axis=2)
    sq = (pos ** 2).sum(axis=2)                    # (T, S)
    cs = np.cumsum(sq, axis=0)
    total = cs[-1]
    a = cs[::-1]                                   # A(m) = CS[T-1-m]
    b = total[None] - np.concatenate([np.zeros((1,) + total.shape), cs[:-1]])
    norm = (t - np.arange(t))[:, None]
    return (a + b - 2.0 * ac) / norm


def torch_fft_msd(pos: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`_np_fft_msd`: pos (T, S, D) on any device
    → per-particle MSD (T, S) there, ``torch.fft`` over ``n = 2T``.

    Each particle's mean position is subtracted first: the MSD does not
    change, but the float32 sums ``S1`` and ``2·S2`` then carry the
    size of the displacements, not of the coordinates, so their
    difference does not cancel away (absolute coordinates of a 100 Å
    box put it ~0.1 Å² off the float64 result)."""
    t = pos.shape[0]
    pos = pos - pos.mean(dim=0, keepdim=True)
    fr = torch.fft.rfft(pos, n=2 * t, dim=0)
    ac = torch.fft.irfft(
        fr * torch.conj(fr), n=2 * t, dim=0)[:t].sum(dim=2)
    sq = (pos ** 2).sum(dim=2)
    cs = torch.cumsum(sq, dim=0)
    total = cs[-1]
    a = torch.flip(cs, dims=(0,))
    b = total[None] - torch.cat(
        [torch.zeros((1,) + tuple(total.shape), dtype=cs.dtype,
                     device=cs.device), cs[:-1]])
    norm = (t - torch.arange(t, dtype=cs.dtype, device=cs.device))[:, None]
    return (a + b - 2.0 * ac) / norm


def _np_windowed_msd(pos: np.ndarray) -> np.ndarray:
    """Direct O(T²) lag loop (the upstream ``fft=False`` route); exact,
    for validation and small windows."""
    t = pos.shape[0]
    pos = np.asarray(pos, np.float64)
    out = np.zeros((t, pos.shape[1]))
    for m in range(1, t):
        d = pos[m:] - pos[:-m]
        out[m] = (d ** 2).sum(axis=2).mean(axis=0)
    return out


class EinsteinMSD(AnalysisBase):
    """``EinsteinMSD(u, select='name OW', msd_type='xyz').run()``.

    Results: ``timeseries`` (T,) — MSD vs lag averaged over particles —
    and ``msds_by_particle`` (T, S).  ``fft=True`` (default) uses the
    O(T log T) FFT decomposition; ``fft=False`` the direct windowed sum
    (serial backend only).  Provide unwrapped coordinates.
    """

    def __init__(self, universe: Universe, select: str = "all",
                 msd_type: str = "xyz", fft: bool = True,
                 verbose: bool = False):
        super().__init__(universe, verbose)
        if msd_type not in _DIM_SETS:
            raise ValueError(
                f"msd_type must be one of {sorted(_DIM_SETS)}, "
                f"got {msd_type!r}")
        self._select = select
        self._dims = _DIM_SETS[msd_type]
        self._fft = fft

    def _prepare(self):
        ag = self._universe.select_atoms(self._select)
        if ag.n_atoms == 0:
            raise ValueError(f"selection {self._select!r} matched no atoms")
        self._idx = ag.indices
        self._serial_pos = []

    # -- serial path --

    def _single_frame(self, ts):
        self._serial_pos.append(
            ts.positions[self._idx][:, self._dims].astype(np.float64))

    def _serial_summary(self):
        pos = (np.stack(self._serial_pos) if self._serial_pos
               else np.empty((0, len(self._idx), len(self._dims))))
        return (pos, np.ones(len(pos)))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _collect_kernel

    def _batch_params(self):
        return (torch.as_tensor(self._dims, dtype=torch.int64),)

    # series: concatenated in frame order

    def _identity_partials(self):
        return (np.empty((0, len(self._idx), len(self._dims))), np.empty(0))

    def _conclude(self, total):
        pos, mask = total
        if self.n_frames < 2:
            raise ValueError("MSD needs at least 2 frames")
        on_device = isinstance(pos, torch.Tensor)
        if not self._fft and on_device:
            raise ValueError("fft=False is the serial-backend reference "
                             "route; use fft=True on the batch backends")
        # the padded frames are dropped on the device (no read back);
        # the lag algebra runs there too, at the first read
        p = real_frames(pos, mask, self.n_frames)

        def _finalize():
            if not self._fft:
                by = _np_windowed_msd(p)
            elif on_device:
                by = np.asarray(to_numpy(torch_fft_msd(p)))
            else:
                by = _np_fft_msd(p)
            return {"msds_by_particle": by,
                    "timeseries": by.mean(axis=1)}

        g = deferred_group(_finalize)
        self.results.msds_by_particle = g["msds_by_particle"]
        self.results.timeseries = g["timeseries"]
