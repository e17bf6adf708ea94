"""Water dynamics (the JAX package's ``analysis/waterdynamics.py``):
survival probability of a dynamic selection (water-shell residence),
water orientational relaxation, angular distributions and the
waterdynamics MSD front.

Upstream-API mirror (``MDAnalysis.analysis.waterdynamics.
SurvivalProbability``): for each lag τ, the probability that an atom
matching ``select`` at frame t still matches it at every frame through
t+τ — the residence-time correlation of a hydration shell.
``SurvivalProbability(u, select).run(tau_max=20)`` →
``results.tau_timeseries`` (0..tau_max) and ``results.sp_timeseries``
(⟨N(t, t+τ)/N(t)⟩ over all window starts).  ``intermittency=k`` fills
departures of ≤ k consecutive frames before the windowed product
(upstream's intermittent-SP preprocessing).

Execution model: ``select`` is RE-EVALUATED per frame (the upstream
contract — hydration-shell selections are geometric, e.g. ``"name OW
and around 3.5 protein"``), which makes membership inherently
dynamic-shape and frame-sequential; like the hydrogen-bond record
table (the serial-oracle rationale documented in ``analysis/hbonds.py``:
dynamic result shapes cannot cross the static-shape batch boundary),
this is serial territory by design, and the batch hooks raise with
that explanation (a bare ``run()`` takes ``'serial'``).  Membership is packed into one (T, N) boolean matrix
restricted to the atoms that EVER matched, and the τ-windowed survival
reduces by vectorized running ANDs — O(τ_max · T · N_ever) bit work on
host, negligible next to the per-frame selection evaluation itself.
"""

from __future__ import annotations

import os as _os

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group,
                                                    real_frames, to_numpy)


# canonical implementation lives in lib.correlations (the upstream
# public API); this alias keeps the analysis-internal import surface
from mdanalysis_mpi_tpu_torch.lib.correlations import (            # noqa: E402
    intermittency_filter as _apply_intermittency,
)


class SurvivalProbability(AnalysisBase):
    """``SurvivalProbability(u, select, intermittency=0).run(tau_max=N)``.

    ``results.sp_timeseries[τ]`` = ⟨N(t, t+τ)/N(t)⟩ averaged over every
    window start with N(t) > 0; ``results.tau_timeseries`` = [0..τ_max].
    """

    # serial only (dynamic membership): a bare run() takes it
    _default_backend = "serial"

    def __init__(self, universe, select: str, intermittency: int = 0,
                 verbose: bool = False):
        super().__init__(universe, verbose)
        if intermittency < 0:
            raise ValueError(
                f"intermittency must be >= 0, got {intermittency}")
        self._select = select
        self._intermittency = int(intermittency)
        self._tau_max = 20

    def run(self, start=None, stop=None, step=None, frames=None,
            backend: str | None = None, tau_max: int = 20,
            intermittency: int | None = None, residues: bool = False,
            **kwargs):
        """Upstream passes ``intermittency`` (and ``residues``) to
        ``run()``, not the constructor — accept both spellings so ported
        scripts work unchanged.  ``residues=True`` coarsens membership
        to the RESIDUE level before the survival algebra: a residue is
        in the shell on a frame iff ANY of its atoms matches the
        selection (upstream's contract — a water stays "present" while
        different hydrogens poke into the shell)."""
        if tau_max < 0:
            raise ValueError(f"tau_max must be >= 0, got {tau_max}")
        self._run_residues = bool(residues)
        if intermittency is not None and intermittency < 0:
            raise ValueError(
                f"intermittency must be >= 0, got {intermittency}")
        # a run()-call override is scoped to THIS run — upstream's run
        # default resets every call, so it must not leak into a later
        # run() that omits the kwarg
        self._run_intermittency = (self._intermittency
                                   if intermittency is None
                                   else int(intermittency))
        self._tau_max = int(tau_max)
        return super().run(start, stop, step, frames=frames,
                           backend=backend, **kwargs)

    def _prepare(self):
        # validate the selection once against the topology (a typo must
        # fail before a long trajectory walk, even if frame 0 matches
        # zero atoms)
        self._universe.select_atoms(self._select)
        self._rows: list[np.ndarray] = []

    def _single_frame(self, ts):
        del ts          # selection reads the universe's current frame
        top = self._universe.topology
        idx = self._universe.select_atoms(self._select).indices
        if getattr(self, "_run_residues", False):
            # residue-level membership: present iff ANY atom matches
            n = int(top.resindices.max()) + 1 if top.n_atoms else 0
            row = np.zeros(n, dtype=bool)
            row[top.resindices[idx]] = True
        else:
            row = np.zeros(top.n_atoms, dtype=bool)
            row[idx] = True
        self._rows.append(row)

    def _serial_summary(self):
        top = self._universe.topology
        n = (int(top.resindices.max()) + 1
             if getattr(self, "_run_residues", False) and top.n_atoms
             else (0 if getattr(self, "_run_residues", False)
                   else top.n_atoms))
        return np.asarray(self._rows, dtype=bool).reshape(
            len(self._rows), n)

    # -- batch hooks: per-frame re-selection is dynamic-shape --

    def _batch_select(self):
        raise ValueError(
            "SurvivalProbability re-evaluates its selection every frame "
            "(dynamic membership) and runs on the serial backend only — "
            "call .run(tau_max=..., backend='serial')")

    def _batch_fn(self):
        self._batch_select()

    def _conclude(self, total):
        mask = np.asarray(total, dtype=bool)
        t = mask.shape[0]
        if t == 0:
            raise ValueError("SurvivalProbability over zero frames")
        # only atoms that EVER matched matter for every window — a
        # hydration shell touches a tiny fraction of a solvated system,
        # so this cuts the mask and the AND loop by that ratio
        mask = mask[:, mask.any(axis=0)]
        tau_max = min(self._tau_max, t - 1)
        mask = _apply_intermittency(
            mask, getattr(self, "_run_intermittency", self._intermittency))
        from mdanalysis_mpi_tpu_torch.lib.correlations import survival_windows

        data = survival_windows(mask, tau_max)
        sp = [float(np.mean(v)) if v else 0.0 for v in data]
        self.results.tau_timeseries = np.arange(tau_max + 1)
        self.results.sp_timeseries = np.asarray(sp)


# ---- water orientation family (upstream waterdynamics module) ----

def _water_triplets(universe, select: str):
    """Resolve ``select`` (water oxygens) → (o_idx, h1_idx, h2_idx):
    each selected oxygen with its two same-residue hydrogens (name
    starting 'H').  Raises for non-oxygen members or waters without
    exactly two hydrogens — silent misparing would corrupt every
    orientation vector."""
    ag = universe.select_atoms(select)
    if ag.n_atoms == 0:
        raise ValueError(f"selection {select!r} matches no atoms")
    top = universe.topology
    names = np.char.upper(top.names.astype("U"))
    res = top.resindices
    o_idx = ag.indices
    if not np.char.startswith(names[o_idx], "O").all():
        raise ValueError(
            f"selection {select!r} must pick water OXYGENS (e.g. "
            "'name OW'); it matched non-oxygen atoms")
    # one vectorized sweep instead of a per-oxygen full-topology scan
    # (the naive loop is O(n_waters · n_atoms) — minutes of _prepare at
    # the 100k-atom benchmark scale)
    h_atoms = np.flatnonzero(np.char.startswith(names, "H"))
    h_res = res[h_atoms]
    counts = np.bincount(h_res, minlength=int(res.max()) + 2)
    o_res = res[o_idx]
    bad = counts[o_res] != 2
    if bad.any():
        o = int(o_idx[np.argmax(bad)])
        raise ValueError(
            f"water residue of atom {o} has {int(counts[res[o]])} "
            "hydrogens, expected exactly 2")
    order = np.argsort(h_res, kind="stable")
    sorted_h = h_atoms[order]
    starts = np.searchsorted(h_res[order], o_res)
    return (o_idx.astype(np.int64), sorted_h[starts].astype(np.int64),
            sorted_h[starts + 1].astype(np.int64))


def _unit(v, xp=np):
    return v / (xp.sqrt((v ** 2).sum(-1))[..., None] + 1e-12)


def _water_vectors_np(pos, o_s, h1_s, h2_s, box=None) -> np.ndarray:
    """positions (N, 3) → (nW, 3, 3) stacked unit vectors
    (OH, HH, dipole) per selected water (upstream waterdynamics'
    three tracked directions).  Intramolecular displacements are
    minimum-imaged: an atom-wrapped trajectory splits molecules across
    the boundary, and a box-length "bond vector" would silently corrupt
    every correlation."""
    from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

    o, h1, h2 = pos[o_s], pos[h1_s], pos[h2_s]
    oh_v = minimum_image(h1 - o, box)
    hh_v = minimum_image(h2 - h1, box)
    # dipole from the minimum-imaged bond vectors, not raw midpoints
    dip_v = 0.5 * (oh_v + minimum_image(h2 - o, box))
    return np.stack([_unit(oh_v), _unit(hh_v), _unit(dip_v)], axis=1)


def _water_vectors_kernel(params, batch, boxes, mask):
    """Batch function: (B, S, 3) staged union → (B, nW, 3, 3) unit
    vectors (minimum-imaged under each frame's box, see the host twin),
    a time-series family output (concatenated in frame order).  The
    whole batch at once: the JAX package maps its per-frame body over
    the frames."""
    from mdanalysis_mpi_tpu_torch.ops.distances import minimum_image as mi

    o_s, h1_s, h2_s = params
    o, h1, h2 = batch[:, o_s], batch[:, h1_s], batch[:, h2_s]
    oh_v = mi(h1 - o, boxes)
    hh_v = mi(h2 - h1, boxes)
    dip_v = 0.5 * (oh_v + mi(h2 - o, boxes))
    vecs = torch.stack([_unit(oh_v, torch), _unit(hh_v, torch),
                        _unit(dip_v, torch)], dim=2)     # (B, nW, 3, 3)
    return (vecs * mask[:, None, None, None], mask)


class _WaterVectorAnalysis(AnalysisBase):
    """Shared machinery: per-frame (nW, 3, 3) water orientation unit
    vectors, staged through either backend; subclasses reduce the
    host series in ``_conclude_vectors`` and the device series in
    ``_conclude_device`` (by default: read it back, then reduce)."""

    def __init__(self, universe, select: str = "name OW",
                 verbose: bool = False):
        super().__init__(universe, verbose)
        self._select = select

    def _prepare(self):
        o, h1, h2 = _water_triplets(self._universe, self._select)
        # the whole (T, nW, 3, 3) float32 vector series is materialized
        # for the lag reduction — bound it EXPLICITLY rather than OOM:
        # at 33k waters × 10k frames that is ~12 GB.  Window the run
        # (start/stop/step) or raise MDTPU_WATER_SERIES_BUDGET.
        est = float(getattr(self, "n_frames", 0)) * len(o) * 36
        budget = float(_os.environ.get("MDTPU_WATER_SERIES_BUDGET",
                                       4e9))
        if est > budget:
            raise ValueError(
                f"{type(self).__name__}: the {self.n_frames}-frame × "
                f"{len(o)}-water vector series needs ~{est / 1e9:.1f} GB "
                f"(budget {budget / 1e9:.1f} GB); analyze a window "
                "(run(start=, stop=, step=)) or raise "
                "MDTPU_WATER_SERIES_BUDGET")
        # stage only the union of involved atoms; slots index into it
        union = np.unique(np.concatenate([o, h1, h2]))
        lookup = {int(g): s for s, g in enumerate(union)}
        self._idx = union
        self._o_s = np.asarray([lookup[int(i)] for i in o], np.int32)
        self._h1_s = np.asarray([lookup[int(i)] for i in h1], np.int32)
        self._h2_s = np.asarray([lookup[int(i)] for i in h2], np.int32)
        self._serial_rows = []

    def _single_frame(self, ts):
        pos = ts.positions[self._idx].astype(np.float64)
        self._serial_rows.append(
            _water_vectors_np(pos, self._o_s, self._h1_s, self._h2_s,
                              box=ts.dimensions))

    def _serial_summary(self):
        n = len(self._o_s)
        rows = (np.stack(self._serial_rows) if self._serial_rows
                else np.empty((0, n, 3, 3)))
        return (rows, np.ones(len(rows)))

    # -- batch path (time-series family) --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _water_vectors_kernel

    def _batch_params(self):
        # the executor puts them on the run's device
        return tuple(torch.as_tensor(x, dtype=torch.int64)
                     for x in (self._o_s, self._h1_s, self._h2_s))

    _device_combine = None

    def _identity_partials(self):
        n = len(self._o_s)
        return (np.empty((0, n, 3, 3)), np.empty(0))

    def _conclude(self, total):
        vecs, mask = total
        # float32 keeps the big series at half size; reductions
        # accumulate in float64 (unit-vector dot products lose ~1e-7 to
        # f32 storage — inside every stated tolerance).  A device series
        # drops its padded frames on the device and is reduced there at
        # the first read of a result
        v = real_frames(vecs, mask, self.n_frames)
        on_device = isinstance(v, torch.Tensor)

        def _finalize():
            if on_device:
                return self._conclude_device(v)
            return self._conclude_vectors(np.asarray(v, np.float32))

        self._vector_group = deferred_group(_finalize)
        self._publish()

    # subclass hooks
    def _conclude_vectors(self, vecs: np.ndarray) -> dict:
        raise NotImplementedError

    def _conclude_device(self, vecs: torch.Tensor) -> dict:
        return self._conclude_vectors(np.asarray(to_numpy(vecs),
                                                 np.float32))

    def _publish(self):
        raise NotImplementedError


class WaterOrientationalRelaxation(_WaterVectorAnalysis):
    """Upstream ``waterdynamics.WaterOrientationalRelaxation``:
    second-order orientational relaxation of water —

        C₂(τ) = ⟨ P₂( u(t) · u(t+τ) ) ⟩,   P₂(x) = (3x² − 1)/2

    averaged over molecules and all time origins, for the OH, HH and
    dipole unit vectors.  ``run()`` → ``results.tau_timeseries``
    (0..dtmax, analyzed-frame steps) and ``results.timeseries``
    (dtmax+1, 3) columns (OH, HH, dip); also exposed singly as
    ``results.OH`` / ``results.HH`` / ``results.dip``.
    """

    def __init__(self, universe, select: str = "name OW",
                 dtmax: int = 20, verbose: bool = False):
        super().__init__(universe, select, verbose)
        if dtmax < 0:
            raise ValueError(f"dtmax must be >= 0, got {dtmax}")
        self._dtmax = int(dtmax)

    def _conclude_vectors(self, vecs):
        t = len(vecs)
        if t == 0:
            raise ValueError(
                "WaterOrientationalRelaxation over zero frames")
        dtmax = min(self._dtmax, t - 1)
        out = np.empty((dtmax + 1, 3))
        for tau in range(dtmax + 1):
            dots = (vecs[:t - tau] * vecs[tau:]).sum(-1)  # (T-τ, nW, 3)
            out[tau] = (1.5 * dots.astype(np.float64) ** 2
                        - 0.5).mean(axis=(0, 1))
        return self._c2_results(out)

    def _conclude_device(self, vecs):
        """The lag sums on the device, accumulated in float64: only the
        (dtmax+1, 3) result is read back, not the (T, nW, 3, 3)
        series."""
        t = vecs.shape[0]
        if t == 0:
            raise ValueError(
                "WaterOrientationalRelaxation over zero frames")
        dtmax = min(self._dtmax, t - 1)
        out = torch.empty((dtmax + 1, 3), dtype=torch.float64,
                          device=vecs.device)
        for tau in range(dtmax + 1):
            dots = (vecs[:t - tau] * vecs[tau:]).sum(-1)  # (T-τ, nW, 3)
            out[tau] = (1.5 * dots.to(torch.float64) ** 2
                        - 0.5).mean(dim=(0, 1))
        return self._c2_results(out.cpu().numpy())

    @staticmethod
    def _c2_results(out):
        return {"tau_timeseries": np.arange(len(out)),
                "timeseries": out, "OH": out[:, 0], "HH": out[:, 1],
                "dip": out[:, 2]}

    def _publish(self):
        g = self._vector_group
        for key in ("tau_timeseries", "timeseries", "OH", "HH", "dip"):
            self.results[key] = g[key]


class AngularDistribution(_WaterVectorAnalysis):
    """Upstream ``waterdynamics.AngularDistribution``: the distribution
    of cos θ between each water orientation vector (OH, HH, dipole) and
    the ``axis`` (default z), over every analyzed frame.  ``run()`` →
    ``results.bins`` (bin centers over [-1, 1]) and ``results.OH`` /
    ``results.HH`` / ``results.dip`` (normalized densities).
    """

    def __init__(self, universe, select: str = "name OW",
                 bins: int = 40, axis: str = "z",
                 verbose: bool = False):
        super().__init__(universe, select, verbose)
        if bins < 1:
            raise ValueError(f"bins must be >= 1, got {bins}")
        try:
            self._axis = {"x": 0, "y": 1, "z": 2}[axis]
        except KeyError:
            raise ValueError(
                f"axis must be 'x', 'y' or 'z', got {axis!r}") from None
        self._bins = int(bins)

    def _conclude_vectors(self, vecs):
        return self._histograms(vecs[..., self._axis])

    def _conclude_device(self, vecs):
        # only the axis components (T, nW, 3) come back to the host
        return self._histograms(
            np.asarray(to_numpy(vecs[..., self._axis]), np.float32))

    def _histograms(self, cos_all):
        """(T, nW, 3) cosines of (OH, HH, dip) with the axis → the
        normalized densities."""
        if len(cos_all) == 0:
            raise ValueError("AngularDistribution over zero frames")
        edges = np.linspace(-1.0, 1.0, self._bins + 1)
        out = {"bins": 0.5 * (edges[:-1] + edges[1:])}
        for k, key in enumerate(("OH", "HH", "dip")):
            cos = cos_all[:, :, k].ravel()
            hist, _ = np.histogram(cos, bins=edges, density=True)
            out[key] = hist
        return out

    def _publish(self):
        g = self._vector_group
        for key in ("bins", "OH", "HH", "dip"):
            self.results[key] = g[key]


class MeanSquareDisplacement:
    """Upstream ``waterdynamics.MeanSquareDisplacement`` spelling: a
    thin front over :class:`~mdanalysis_mpi_tpu_torch.analysis.EinsteinMSD`
    (the modern module with the FFT lag algebra), kept so ported
    waterdynamics scripts find the name AND calling convention —
    upstream's positional ``(universe, select, t0, tf, dtmax)`` window
    translates to ``run(start=t0, stop=tf)``; EinsteinMSD computes the
    FULL lag series, so ``dtmax`` just truncates
    ``results.timeseries``.  ``run()`` returns self;
    ``results.timeseries`` etc. as EinsteinMSD."""

    def __init__(self, universe, select: str = "name OW",
                 t0: int | None = None, tf: int | None = None,
                 dtmax: int | None = None, verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.analysis.msd import EinsteinMSD

        self._inner = EinsteinMSD(universe, select=select,
                                  verbose=verbose)
        self._window = (t0, tf)
        self._dtmax = dtmax

    def run(self, *args, **kwargs):
        if not args:
            # each window bound defaults INDEPENDENTLY: overriding only
            # start must not silently drop the constructor's tf
            t0, tf = self._window
            if t0 is not None:
                kwargs.setdefault("start", t0)
            if tf is not None:
                kwargs.setdefault("stop", tf)
        self._inner.run(*args, **kwargs)
        self.results = self._inner.results
        if self._dtmax is not None:
            # BOTH lag-indexed results truncate together — a mixed
            # lag length between timeseries and msds_by_particle would
            # break the documented pairing (analysis/msd.py)
            self.results.timeseries = np.asarray(
                self.results.timeseries)[:self._dtmax + 1]
            self.results.msds_by_particle = np.asarray(
                self.results.msds_by_particle)[:self._dtmax + 1]
        return self
