"""Linear (per-axis slab) mass/charge density profiles.

Upstream-API mirror (``MDAnalysis.analysis.lineardensity.
LinearDensity``): histogram a selection's mass and charge along each
box axis in fixed slabs — ``LinearDensity(ag, binsize=0.25).run()`` →
``results.x`` / ``results.y`` / ``results.z``, each carrying
``mass_density`` (g/cm³), ``charge_density`` (e/Å³), their per-frame
standard deviations, and ``hist_bin_edges``.  ``grouping`` bins atoms
directly or the centers of mass of residues/segments.

Bin layout follows upstream exactly, quirks included: per-axis bin
counts ``bins_i = dims_i // binsize`` set ``nbins = max(bins_i)``, and
EVERY axis histograms over ``[0, max(dims))`` with those ``nbins``
bins (shorter axes simply leave their tail bins empty), while the
normalizing ``slab_volume_i = volume / bins_i`` stays per-axis.  The
layout is fixed by the run's FIRST frame box; samples strictly outside
the range are dropped and the last bin is right-closed, mirroring
upstream's ``np.histogram(..., range=)`` exactly.

One batch function adds all three axis histograms (mass- and
charge-weighted) per frame with fixed shapes, then reduces them to Chan
moments over the frame axis (``ops/moments.py`` — the centred M2 keeps
the per-frame stddev well-conditioned in float32).  Residue/segment
centres of mass reduce on the device the same way with host-precomputed
per-group weights.  Partials fold on the device and merge across
devices by the law of total variance.  The JAX package's
``analysis/lineardensity.py``.

The float32 adds go through ``index_put_(..., accumulate=True)``, which
on a CUDA device sorts the bin indices and sums each bin's samples in
a fixed order: a repeat of a run gives the same bits, as float atomics
(whose order varies from run to run) would not.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, Deferred,
                                                    Results, deferred_group,
                                                    to_numpy)
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
from mdanalysis_mpi_tpu_torch.ops import host
from mdanalysis_mpi_tpu_torch.ops.moments import merge_moments, psum_moments

#: amu/Å³ → g/cm³ (upstream reports mass densities in g/cm³)
_AMU_PER_A3_TO_G_PER_CM3 = 1.66053906660


def _ordered_add(size: int, flat: torch.Tensor, values: torch.Tensor):
    """``zeros(size, ...)`` with ``values`` summed into rows ``flat``
    in an order fixed by the indices (``index_put_`` with
    ``accumulate=True``: a sort and a segment sum on a CUDA device), so
    a repeat gives the same bits."""
    out = torch.zeros((size,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_put_((flat,), values, accumulate=True)


@functools.lru_cache(maxsize=None)
def _lindens_kernel_for(nbins: int, n_groups: int | None):
    """One cached batch function per (nbins, grouping) structure."""

    def kernel(params, batch, boxes, mask):
        del boxes
        from mdanalysis_mpi_tpu_torch.ops.moments import batch_moments

        b = batch.shape[0]
        dev = batch.device
        if n_groups is not None:
            # residue/segment centers of mass: mass-weighted sum over
            # the fixed group map; the per-group total mass/charge
            # weights are precomputed
            rng_max, atom_m, _, gids, gmass_sum, w_m, w_q = params
            s = batch.shape[1]
            rows = (torch.arange(b, device=dev)[:, None] * n_groups
                    + gids[None, :]).reshape(-1)
            wsum = _ordered_add(
                b * n_groups, rows,
                (batch * atom_m[None, :, None]).reshape(b * s, 3))
            x = (wsum.reshape(b, n_groups, 3)
                 / gmass_sum[None, :, None])            # (B, G, 3)
        else:
            rng_max, w_m, w_q, _ = params
            x = batch                                   # (B, S, 3)
        p = x.shape[1]
        idx = torch.floor(x * (nbins / rng_max))
        # np.histogram semantics: the LAST bin is right-closed, so a
        # sample exactly at rng_max belongs to bin nbins-1
        idx = torch.clamp(idx, -1, nbins - 1).to(torch.int64)
        inside = (x >= 0.0) & (x <= rng_max) & (idx >= 0)
        idx = torch.where(inside, idx, torch.full_like(idx, nbins))
        fbase = (torch.arange(b, device=dev)
                 * 3 * (nbins + 1))[:, None, None]
        abase = (torch.arange(3, device=dev) * (nbins + 1))[None, :, None]
        # (B, 3, P) flat bin ids → two ordered adds build every
        # per-frame per-axis histogram at once
        flat = (fbase + abase + idx.permute(0, 2, 1)).reshape(-1)
        wm3 = w_m[None, None, :].expand(b, 3, p).reshape(-1)
        wq3 = w_q[None, None, :].expand(b, 3, p).reshape(-1)
        size = b * 3 * (nbins + 1)
        mh = _ordered_add(size, flat, wm3).reshape(b, 3, nbins + 1)
        qh = _ordered_add(size, flat, wq3).reshape(b, 3, nbins + 1)
        # Chan moments over the frame axis (mask keeps padding honest)
        t, m_mean, m_m2 = batch_moments(mh, mask)
        _, q_mean, q_m2 = batch_moments(qh, mask)
        return (t, m_mean, m_m2, q_mean, q_m2)

    return kernel


def _lindens_fold(a, b):
    """Device-side cross-batch merge: Chan merge for both moment sets
    (the frame counts are shared)."""
    t1, mm1, mv1, qm1, qv1 = a
    t2, mm2, mv2, qm2, qv2 = b
    t, mm, mv = merge_moments((t1, mm1, mv1), (t2, mm2, mv2))
    _, qm, qv = merge_moments((t1, qm1, qv1), (t2, qm2, qv2))
    return (t, mm, mv, qm, qv)


def _lindens_psum(parts, comm=None):
    """Cross-device merge of one batch's per-device partials: the law
    of total variance for both sets (``ops.moments.psum_moments``)."""
    t_tot, mm_tot, mv_tot = psum_moments(
        [(p[0], p[1], p[2]) for p in parts], comm)
    _, qm_tot, qv_tot = psum_moments(
        [(p[0], p[3], p[4]) for p in parts], comm)
    return (t_tot, mm_tot, mv_tot, qm_tot, qv_tot)


class LinearDensity(AnalysisBase):
    """``LinearDensity(ag, grouping="atoms", binsize=0.25).run()``.

    ``results.x|y|z``: ``mass_density`` / ``mass_density_stddev``
    (g/cm³), ``charge_density`` / ``charge_density_stddev`` (e/Å³),
    ``hist_bin_edges`` (Å), ``dim``, ``slab_volume`` (Å³).  Requires a
    box and partial charges (upstream raises on chargeless topologies;
    so does this).  Wrap the trajectory first if coordinates roam
    outside the primary cell.
    """

    _GROUPINGS = ("atoms", "residues", "segments")

    def __init__(self, select: AtomGroup, grouping: str = "atoms",
                 binsize: float = 0.25, verbose: bool = False):
        super().__init__(select.universe, verbose)
        if grouping not in self._GROUPINGS:
            raise ValueError(
                f"grouping must be one of {self._GROUPINGS}, "
                f"got {grouping!r}")
        if binsize <= 0:
            raise ValueError(f"binsize must be positive, got {binsize}")
        self._ag = select
        self._grouping = grouping
        self._binsize = float(binsize)

    def _prepare(self):
        self._idx = self._ag.indices
        if len(self._idx) == 0:
            raise ValueError("selection matched no atoms")
        t = self._universe.topology
        if t.charges is None:
            raise ValueError(
                "LinearDensity needs partial charges and this topology "
                "carries none (upstream raises NoDataError too); load a "
                "format with charges (PSF) or set topology.charges")
        first = self._frame_indices[0] if self._frame_indices else 0
        dims = self._universe.trajectory[first].dimensions
        if dims is None:
            raise ValueError(
                "LinearDensity needs box dimensions (the slabs span the "
                "box); this trajectory carries none")
        extent = np.asarray(dims[:3], np.float64)
        # upstream layout: per-axis bin counts from floor division, one
        # shared nbins = max, every histogram over [0, max extent)
        self._bins = np.maximum(
            (extent // self._binsize).astype(int), 1)
        self._nbins = int(self._bins.max())
        self._rng_max = float(extent.max())
        self._volume = float(np.prod(extent))
        masses = np.asarray(t.masses[self._idx], np.float64)
        charges = np.asarray(t.charges[self._idx], np.float64)
        if self._grouping == "atoms":
            self._gids = None
            self._w_mass, self._w_charge = masses, charges
        else:
            # segments have no dense index attribute; np.unique over the
            # segid strings builds the same 0-based group map
            raw = (t.resindices if self._grouping == "residues"
                   else t.segids)[self._idx]
            uniq, gids = np.unique(raw, return_inverse=True)
            self._gids = gids.astype(np.int32)
            self._n_groups = len(uniq)
            self._gmass_sum = np.zeros(self._n_groups)
            np.add.at(self._gmass_sum, gids, masses)
            if (self._gmass_sum <= 0).any():
                raise ValueError(
                    f"a {self._grouping[:-1]} in the selection has zero "
                    "total mass; centers of mass are undefined")
            self._w_mass = self._gmass_sum
            self._w_charge = np.zeros(self._n_groups)
            np.add.at(self._w_charge, gids, charges)
            self._atom_masses = masses
        shape = (3, self._nbins + 1)
        self._m_stream = host.StreamingMoments(shape)
        self._q_stream = host.StreamingMoments(shape)

    def _group_positions(self, pos: np.ndarray) -> np.ndarray:
        """(S, 3) atom positions → binned positions per grouping."""
        if self._gids is None:
            return pos
        w = np.zeros((self._n_groups, 3))
        np.add.at(w, self._gids, pos * self._atom_masses[:, None])
        return w / self._gmass_sum[:, None]

    # -- serial path --

    def _single_frame(self, ts):
        pos = self._group_positions(
            ts.positions[self._idx].astype(np.float64))
        nb = self._nbins
        idx = np.floor(pos * (nb / self._rng_max)).astype(np.int64)
        # np.histogram semantics: right-closed last bin
        idx = np.minimum(idx, nb - 1)
        inside = (pos >= 0) & (pos <= self._rng_max) & (idx >= 0)
        idx = np.where(inside, idx, nb)
        mh = np.zeros((3, nb + 1))
        qh = np.zeros((3, nb + 1))
        for a in range(3):
            np.add.at(mh[a], idx[:, a], self._w_mass)
            np.add.at(qh[a], idx[:, a], self._w_charge)
        self._m_stream.update(mh)
        self._q_stream.update(qh)

    def _serial_summary(self):
        t, m_mean, m_m2 = self._m_stream.summary
        _, q_mean, q_m2 = self._q_stream.summary
        return (float(t), m_mean, m_m2, q_mean, q_m2)

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _lindens_kernel_for(
            self._nbins, None if self._gids is None else self._n_groups)

    def _batch_params(self):
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32)

        rng_max = np.float32(self._rng_max)
        if self._gids is None:
            return (rng_max, f32(self._w_mass), f32(self._w_charge), None)
        return (rng_max, f32(self._atom_masses), None,
                torch.as_tensor(self._gids, dtype=torch.int64),
                f32(self._gmass_sum), f32(self._w_mass),
                f32(self._w_charge))

    _device_combine = staticmethod(_lindens_psum)
    _device_fold_fn = staticmethod(_lindens_fold)

    def _identity_partials(self):
        z = np.zeros((3, self._nbins + 1))
        return (0.0, z, z, z, z)

    def _conclude(self, total):
        if self.n_frames == 0:
            raise ValueError("LinearDensity over zero frames")
        nbins, rng_max = self._nbins, self._rng_max
        slab_vols = self._volume / self._bins        # per-axis (upstream)

        def _finalize():
            t, m_mean, m_m2, q_mean, q_m2 = (
                np.asarray(to_numpy(x), np.float64) for x in total)
            t = float(t)
            out = {}
            for a, axis in enumerate(("x", "y", "z")):
                sv = float(slab_vols[a])
                mm = m_mean[a, :nbins]
                ms = np.sqrt(np.maximum(m_m2[a, :nbins] / t, 0.0))
                qm = q_mean[a, :nbins]
                qs = np.sqrt(np.maximum(q_m2[a, :nbins] / t, 0.0))
                out[axis] = {
                    "mass_density": mm / sv * _AMU_PER_A3_TO_G_PER_CM3,
                    "mass_density_stddev":
                        ms / sv * _AMU_PER_A3_TO_G_PER_CM3,
                    "charge_density": qm / sv,
                    "charge_density_stddev": qs / sv,
                    "hist_bin_edges":
                        np.linspace(0.0, rng_max, nbins + 1),
                    "dim": a,
                    "slab_volume": sv,
                }
            return out

        groups = deferred_group(_finalize)
        keys = ("mass_density", "mass_density_stddev", "charge_density",
                "charge_density_stddev", "hist_bin_edges", "dim",
                "slab_volume")
        for axis in ("x", "y", "z"):
            outer = groups[axis]
            sub = Results()
            for key in keys:
                # one shared finalize pass; each Deferred picks its key
                sub[key] = Deferred(
                    lambda o=outer, k=key: o.thunk()[k])
            self.results[axis] = sub
        self.results.nbins = nbins
