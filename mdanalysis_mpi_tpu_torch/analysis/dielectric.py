"""Static dielectric constant from dipole fluctuations (the JAX
package's ``analysis/dielectric.py``).

Upstream-API mirror (``MDAnalysis.analysis.dielectric.
DielectricConstant``): accumulate the total dipole moment
``M = Σ qᵢ·rᵢ`` per frame and estimate (tin-foil boundary conditions,
upstream's formula and result layout)

    eps_c    = 1 + 4π·(⟨M_c²⟩ − ⟨M_c⟩²) / (ε₀' V k_B T)   per axis c
    eps_mean = 1 + 4π·Σ_c fluct_c / (3 ε₀' V k_B T)

Units are upstream's: charges in e, positions in Å, T in K.
``results.M`` / ``results.M2`` / ``results.fluct`` / ``results.eps``
are per-component 3-vectors; ``results.eps_mean`` is the scalar
dielectric constant.

Device shape: the per-frame dipole is one weighted sum; the
fluctuation accumulates as CHAN MOMENTS of the (B, 3) dipole series
(``ops/moments.py`` — the centered M2 keeps ⟨M²⟩−⟨M⟩² well-conditioned
in float32 where the raw difference catastrophically cancels for
systems with a persistent net dipole), folded on the device and merged
across the mesh's devices and ranks by the law of total variance
(``psum_moments``) with the volume sums added.  The group must be charge-neutral (origin independence)
— a hard error, as is a frame without a box.

``make_whole``: upstream re-joins molecules split across the periodic
boundary every frame by default.  Here the same guarantee is provided
by the (all-backend) ``transformations.unwrap`` reader transformation,
so ``make_whole=True`` (the default) REQUIRES one to be attached when
the topology carries bonds — a split molecule contributes a spurious
~box-sized dipole, which must fail loudly, not skew ε.  Pass
``make_whole=False`` for pre-whole trajectories.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group,
                                                    to_numpy)
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
from mdanalysis_mpi_tpu_torch.ops import host
from mdanalysis_mpi_tpu_torch.ops.moments import merge_moments, psum_moments

#: e²/(4πε₀·Å·k_B) in K — Coulomb energy of unit charges at 1 Å per k_B
_COULOMB_K_A_PER_E2 = 167100.9972


def _dielectric_kernel(params, batch, boxes, mask):
    """(T, ⟨M⟩ (3,), M2 (3,), ΣV, n_boxed) over the batch — dipole
    moments as Chan moments over the frame axis."""
    from mdanalysis_mpi_tpu_torch.ops._boxmat import batch_box_volumes
    from mdanalysis_mpi_tpu_torch.ops.moments import batch_moments

    (charges,) = params
    m_vec = torch.einsum("s,bsi->bi", charges, batch)     # (B, 3)
    t, mean, m2 = batch_moments(m_vec[:, None, :], mask)  # (1, 3) each
    w = mask.to(torch.float32)
    vols = batch_box_volumes(boxes)
    return (t, mean[0], m2[0], (vols * w).sum(),
            ((vols > 0.0) * w).sum())


def _dielectric_fold(a, b):
    t1, mu1, m21, v1, nb1 = a
    t2, mu2, m22, v2, nb2 = b
    t, mu, m2 = merge_moments((t1, mu1, m21), (t2, mu2, m22))
    return (t, mu, m2, v1 + v2, nb1 + nb2)


def _dielectric_psum(parts, comm=None):
    """Cross-device merge of one batch's per-device partials: the
    moments by the law of total variance (``psum_moments``), the volume
    sum and the boxed-frame count by addition; with ``comm`` (the
    process group's Collectives) all of it across the ranks too."""
    from mdanalysis_mpi_tpu_torch.analysis.base import tree_psum

    t_tot, mu_tot, m2_tot = psum_moments(
        [(p[0], p[1], p[2]) for p in parts], comm)
    v, nb = tree_psum([(p[3], p[4]) for p in parts], comm)
    return (t_tot, mu_tot, m2_tot, v, nb)


class DielectricConstant(AnalysisBase):
    """``DielectricConstant(ag, temperature=300.0).run().results.eps_mean``."""

    def __init__(self, atomgroup: AtomGroup, temperature: float = 300.0,
                 make_whole: bool = True, verbose: bool = False):
        super().__init__(atomgroup.universe, verbose)
        if temperature <= 0:
            raise ValueError(
                f"temperature must be positive, got {temperature}")
        self._ag = atomgroup
        self._temperature = float(temperature)
        self._make_whole = bool(make_whole)

    def _prepare(self):
        t = self._universe.topology
        if t.charges is None:
            raise ValueError(
                "DielectricConstant needs partial charges (topology has "
                "none; use add_TopologyAttr or a PSF)")
        self._idx = self._ag.indices
        if len(self._idx) == 0:
            raise ValueError("selection matched no atoms")
        self._charges = np.asarray(t.charges[self._idx], np.float64)
        net = float(self._charges.sum())
        if abs(net) > 1e-4:
            raise ValueError(
                f"group carries net charge {net:+.4f} e; the dipole "
                "moment is origin-dependent (charge-neutral selection "
                "required, upstream contract)")
        if self._universe.trajectory.ts.dimensions is None:
            raise ValueError(
                "DielectricConstant needs box volumes (trajectory "
                "carries no box)")
        if self._make_whole and t.bonds is not None and len(t.bonds):
            from mdanalysis_mpi_tpu_torch.transformations import unwrap

            xforms = self._universe.trajectory.transformations
            if not any(isinstance(x, unwrap) for x in xforms):
                raise ValueError(
                    "make_whole=True: molecules split across the box "
                    "would contribute spurious box-sized dipoles.  "
                    "Attach the all-backend equivalent first —\n"
                    "    u.trajectory.add_transformations("
                    "transformations.unwrap(u.atoms))\n"
                    "— or pass make_whole=False for trajectories that "
                    "are already whole")
        self._stream = host.StreamingMoments((3,))
        self._vol_sum = 0.0
        self._n_boxed = 0

    # -- serial path --

    def _single_frame(self, ts):
        from mdanalysis_mpi_tpu_torch.lib.mdamath import box_volume

        if ts.dimensions is None:
            raise ValueError(
                f"frame {ts.frame} has no box; volumes are part of the "
                "dielectric formula")
        x = ts.positions[self._idx].astype(np.float64)
        self._stream.update((self._charges[:, None] * x).sum(axis=0))
        self._vol_sum += float(box_volume(ts.dimensions))
        self._n_boxed += 1

    def _serial_summary(self):
        t, mean, m2 = self._stream.summary
        return (float(t), mean, m2, self._vol_sum, float(self._n_boxed))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _dielectric_kernel

    def _batch_params(self):
        return (torch.as_tensor(self._charges, dtype=torch.float32),)

    _device_combine = staticmethod(_dielectric_psum)
    _device_fold_fn = staticmethod(_dielectric_fold)

    def _identity_partials(self):
        return (0.0, np.zeros(3), np.zeros(3), 0.0, 0.0)

    def _conclude(self, total):
        temperature = self._temperature

        def _finalize():
            t, m_mean, m_m2, v_sum, n_boxed = (
                np.asarray(to_numpy(x), np.float64) for x in total)
            t = float(t)
            if t == 0:
                raise ValueError("DielectricConstant over zero frames")
            if float(n_boxed) != t:
                raise ValueError(
                    f"DielectricConstant: {int(t - float(n_boxed))} of "
                    f"{int(t)} frames have no (or zero-volume) box; "
                    "volumes are part of the formula")
            vol_mean = float(v_sum) / t
            fluct = m_m2 / t                       # centered: no cancel
            pref = 4.0 * np.pi * _COULOMB_K_A_PER_E2 / (
                vol_mean * temperature)
            eps = 1.0 + pref * fluct               # per-axis (upstream)
            eps_mean = 1.0 + pref * float(fluct.sum()) / 3.0
            return {"M": m_mean,
                    "M2": m_m2 / t + m_mean ** 2,  # ⟨M_c²⟩, upstream
                    "fluct": fluct, "volume": vol_mean,
                    "eps": eps, "eps_mean": eps_mean}

        g = deferred_group(_finalize)
        for k in ("M", "M2", "fluct", "volume", "eps", "eps_mean"):
            self.results[k] = g[k]
