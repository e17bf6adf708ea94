"""Velocity autocorrelation function (the JAX package's
``analysis/vacf.py``).

Upstream-API mirror (``MDAnalysis.analysis.velocityautocorr``-style):
``VelocityAutocorr(ag).run()`` → ``results.timeseries`` (T,) —
``C(τ) = <v(t)·v(t+τ)>`` averaged over particles and time origins —
plus ``results.vacf_by_particle`` (T, S).  Needs a trajectory that
carries velocities (TRR, or a MemoryReader constructed with
``velocities=``).

Shape: velocities are host-decoded per frame (the staging pipeline
moves positions; velocity series are short-window analyses), then the
whole lag algebra runs on the device (``backend="torch"``, on
``device``: ``cuda`` unless given) as ``torch.fft.rfft``/``irfft`` — the
same autocorrelation the MSD uses, O(T log T) — in float32, at the
first read of a result.  Velocities centre near zero, so the float32
lag algebra does not cancel the way MSD's does on absolute
coordinates.  ``backend="serial"`` is the float64 NumPy FFT,
``fft=False`` the direct windowed reference.  The JAX package's
``backend="jax"`` is ``backend="torch"`` here; ``'jax'`` is refused
with an error naming ``'torch'``."""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import Results, deferred_group


def _np_fft_vacf(v: np.ndarray) -> np.ndarray:
    """v (T, S, 3) → per-particle VACF (T, S), float64 reference."""
    t = v.shape[0]
    v = np.asarray(v, np.float64)
    f = np.fft.rfft(v, n=2 * t, axis=0)
    ac = np.fft.irfft(f * np.conj(f), n=2 * t, axis=0)[:t].sum(axis=2)
    norm = (t - np.arange(t))[:, None]
    return ac / norm


def _np_windowed_vacf(v: np.ndarray) -> np.ndarray:
    t = v.shape[0]
    v = np.asarray(v, np.float64)
    out = np.empty((t, v.shape[1]))
    for m in range(t):
        out[m] = (v[: t - m] * v[m:]).sum(axis=2).mean(axis=0)
    return out


def torch_fft_vacf(v: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`_np_fft_vacf`: v (T, S, 3) on any device →
    per-particle VACF (T, S) there, ``torch.fft`` over ``n = 2T``."""
    t = v.shape[0]
    fr = torch.fft.rfft(v, n=2 * t, dim=0)
    ac = torch.fft.irfft(fr * torch.conj(fr), n=2 * t, dim=0)[:t].sum(dim=2)
    norm = (t - torch.arange(t, dtype=ac.dtype, device=ac.device))[:, None]
    return ac / norm


class VelocityAutocorr:
    """``VelocityAutocorr(ag, fft=True).run(start=, stop=, step=)``."""

    def __init__(self, atomgroup, fft: bool = True, verbose: bool = False):
        self._ag = atomgroup
        self._fft = fft
        self._verbose = verbose
        self.results = Results()

    def run(self, start=None, stop=None, step=None,
            backend: str = "torch", device=None):
        if backend == "jax":
            raise ValueError(
                "backend='jax' is the JAX package's name; the port's "
                "device backend is backend='torch'")
        if backend not in ("torch", "mesh", "serial"):
            raise ValueError(
                "backend must be 'torch', 'mesh' or 'serial', got "
                f"{backend!r}")
        dev = None
        if backend != "serial" and self._fft:
            from mdanalysis_mpi_tpu_torch.device import resolve_device

            dev = resolve_device(device)
        u = self._ag.universe
        traj = u.trajectory
        frames = range(*slice(start, stop, step).indices(traj.n_frames))
        idx = self._ag.indices
        vels = []
        for i in frames:
            ts = traj[i]
            if ts.velocities is None:
                raise ValueError(
                    f"frame {i} carries no velocities (use a TRR "
                    "trajectory or MemoryReader(velocities=...))")
            vels.append(ts.velocities[idx].astype(np.float64))
        if len(vels) < 2:
            raise ValueError("VACF needs at least 2 frames")
        v = np.stack(vels)
        self.n_frames = len(v)
        fft = self._fft
        # the device route copies the float32 series to the card now
        # and computes at the first read of a result
        v_dev = (None if dev is None
                 else torch.as_tensor(v, dtype=torch.float32).to(dev))

        def _finalize():
            if not fft:
                by = _np_windowed_vacf(v)
            elif v_dev is not None:
                by = np.asarray(torch_fft_vacf(v_dev).cpu().numpy(),
                                np.float64)
            else:
                by = _np_fft_vacf(v)
            return {"vacf_by_particle": by,
                    "timeseries": by.mean(axis=1)}

        g = deferred_group(_finalize)
        self.results.vacf_by_particle = g["vacf_by_particle"]
        self.results.timeseries = g["timeseries"]
        return self
