"""Hydrogen-bond analysis.

Upstream-API mirror (``MDAnalysis.analysis.hydrogenbonds.
HydrogenBondAnalysis``): geometric hydrogen-bond detection —
donor–acceptor distance < ``d_a_cutoff`` AND donor–hydrogen–acceptor
angle > ``d_h_a_angle_cutoff`` — over fixed donor/hydrogen/acceptor
sets.  ``HydrogenBondAnalysis(u).run()`` → ``results.count`` (T,)
hydrogen bonds per frame; the serial backend additionally produces
``results.hbonds`` (one record per bond per frame, upstream's flat
table).

Static shapes on the device: the (hydrogen × acceptor) candidate
matrix has STATIC shape (each hydrogen is covalently paired to its one
donor up front), so the batch function evaluates the nH×nA geometric
predicates of each frame of a batch — distance + angle via gathers and
an einsum-free dot, frame by frame so no (B, nH, nA, 3) tensor is ever
built — with no host wait (a CUDA graph can capture it), and only the
per-frame count (a masked sum) leaves the device; the dynamic-shape
bond LIST is inherently host-side and stays a serial-oracle feature
(Deferred, like every dynamic result here).

Donor→hydrogen pairing: topology bonds when present (PSF), else a
first-frame distance heuristic (H to nearest heavy atom within
``1.2 Å`` — documented fallback for bondless formats like GRO).
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, Deferred,
                                                    to_numpy)
from mdanalysis_mpi_tpu_torch.ops.host import minimum_image


# ---- module-level batch function (stable identity → cached graphs) ----

def _hbond_count_kernel(params, batch, boxes, mask):
    """Per-frame hydrogen-bond counts (B,) over the static
    (hydrogen, acceptor) candidate matrix, one frame at a time (the
    JAX package's ``jax.lax.map``): at most a few (nH, nA, 3) tensors
    are live, and nothing waits on the host."""
    from mdanalysis_mpi_tpu_torch.ops.distances import _sq_norm
    from mdanalysis_mpi_tpu_torch.ops.distances import minimum_image as mi

    d_slots, h_slots, a_slots, self_pair, cutoff, cos_max = params
    counts = []
    for x, box6 in zip(batch, boxes):
        d = x[d_slots]                       # (nH, 3)
        h = x[h_slots]
        a = x[a_slots]                       # (nA, 3)
        da = mi(d[:, None] - a[None], box6)          # (nH, nA, 3)
        dist_ok = _sq_norm(da) < cutoff * cutoff
        del da
        hd = mi(d[:, None] - h[:, None], box6)       # (nH, 1, 3)
        ha = mi(a[None] - h[:, None], box6)          # (nH, nA, 3)
        # angle D-H-A at the hydrogen: cos between H→D and H→A;
        # angle > cutoff  <=>  cos < cos(cutoff)
        num = (hd * ha).sum(-1)
        den = torch.sqrt(_sq_norm(hd) * _sq_norm(ha)) + 1e-12
        del ha
        ang_ok = num / den < cos_max
        ok = dist_ok & ang_ok & ~self_pair
        counts.append(ok.sum().to(torch.float32))
    return (torch.stack(counts) * mask, mask)


class HydrogenBondAnalysis(AnalysisBase):
    """``HydrogenBondAnalysis(u, hydrogens_sel=..., acceptors_sel=...,
    d_a_cutoff=3.0, d_h_a_angle_cutoff=150.0).run()``.

    Defaults: hydrogens = the ``hydrogen`` selection keyword, acceptors
    = N/O/F heavy atoms, donors = each hydrogen's covalent partner
    (bonds, else the 1.2 Å first-frame heuristic).  Minimum-image PBC
    applies when frames carry a box.  ``results.count`` everywhere;
    ``results.hbonds`` (frame, donor, hydrogen, acceptor, distance,
    angle) on the serial backend.

    ``engine`` selects the serial path's candidate-pruning backend
    (``lib.distances.capped_distance``): the default 'auto' prunes
    donor-acceptor pairs through the O(N) cell list at scale and
    evaluates the angle criterion only on the survivors —
    'bruteforce' is the selectable fallback, and 'torch' the torch
    cell list on ``device`` (``cuda`` unless given).  The batch
    backends run on the device ``run()`` is given.
    """

    POLAR_DONOR_ELEMENTS = ("N", "O", "F", "S")

    def __init__(self, universe, hydrogens_sel: str | None = None,
                 acceptors_sel: str | None = None,
                 d_a_cutoff: float = 3.0,
                 d_h_a_angle_cutoff: float = 150.0,
                 engine: str = "auto",
                 verbose: bool = False, device=None):
        super().__init__(universe, verbose)
        # serial-path candidate pruning backend
        # (lib.distances.capped_distance): 'auto' = cell list at scale,
        # brute force selectable; the batch kernel keeps its dense
        # static-shape candidate matrix (module docstring)
        self._engine = engine
        self._engine_device = device
        # None → guess: all hydrogens, then keep only those whose
        # covalent partner is a polar donor element (upstream guesses
        # polar hydrogens too — counting C-H...O contacts as hydrogen
        # bonds would systematically inflate counts).  An EXPLICIT
        # hydrogens_sel is taken literally, no donor-element filter.
        self._hydrogens_sel = hydrogens_sel
        self._acceptors_sel = acceptors_sel
        self._cutoff = float(d_a_cutoff)
        self._angle_cutoff = float(d_h_a_angle_cutoff)

    def _guess_donors(self, h_idx: np.ndarray) -> np.ndarray:
        """One donor (covalent heavy partner) per hydrogen."""
        u = self._universe
        t = u.topology
        heavy = ~t.is_hydrogen
        if t.bonds is not None and len(t.bonds):
            partner = np.full(t.n_atoms, -1, dtype=np.int64)
            for x, y in t.bonds:
                if heavy[y]:
                    partner[x] = y
                if heavy[x]:
                    partner[y] = x
            donors = partner[h_idx]
            if (donors >= 0).all():
                return donors
            missing = h_idx[donors < 0]
            raise ValueError(
                f"{len(missing)} hydrogens have no bonded heavy atom "
                f"(first: atom {int(missing[0])})")
        # bondless topology: nearest heavy atom within 1.2 Å, frame 0
        # (vectorized in hydrogen chunks: one broadcast minimum-image
        # per chunk, not one Python-level pass per hydrogen)
        ts = u.trajectory[self._frame_indices[0]
                          if self._frame_indices else 0]
        pos = ts.positions.astype(np.float64)
        heavy_idx = np.flatnonzero(heavy)
        donors = np.empty(len(h_idx), dtype=np.int64)
        chunk = max(1, 2_000_000 // max(len(heavy_idx), 1))
        for lo in range(0, len(h_idx), chunk):
            hs = h_idx[lo:lo + chunk]
            disp = minimum_image(
                pos[heavy_idx][None] - pos[hs][:, None], ts.dimensions)
            d2 = (disp ** 2).sum(-1)              # (chunk, n_heavy)
            k = d2.argmin(axis=1)
            best = d2[np.arange(len(hs)), k]
            if (best > 1.2 ** 2).any():
                bad = hs[best > 1.2 ** 2][0]
                raise ValueError(
                    f"hydrogen atom {int(bad)} has no heavy atom within "
                    "1.2 Å in the first frame (no bonds in topology — "
                    "provide a PSF or fix coordinates)")
            donors[lo:lo + chunk] = heavy_idx[k]
        return donors

    def _prepare(self):
        # a re-run must not leave an earlier run's bond table behind:
        # lifetime() reads results["hbonds"] against THIS run's frame
        # window, and a stale table would mix frame grids silently
        self.results.pop("hbonds", None)
        u = self._universe
        t = u.topology
        guess = self._hydrogens_sel is None
        h_sel = "hydrogen" if guess else self._hydrogens_sel
        h_idx = u.select_atoms(h_sel).indices
        if len(h_idx) == 0:
            raise ValueError(
                f"hydrogens selection {h_sel!r} matched no atoms")
        if not t.is_hydrogen[h_idx].all():
            raise ValueError("hydrogens selection contains heavy atoms")
        if self._acceptors_sel is not None:
            a_idx = u.select_atoms(self._acceptors_sel).indices
        else:
            elements = np.char.upper(t.elements.astype("U2"))
            a_idx = np.flatnonzero(
                np.isin(elements, ("N", "O", "F")) & ~t.is_hydrogen)
        if len(a_idx) == 0:
            raise ValueError("no acceptor atoms found")
        d_idx = self._guess_donors(h_idx)
        if guess:
            # polar hydrogens only (see __init__ note)
            elements = np.char.upper(t.elements.astype("U2"))
            polar = np.isin(elements[d_idx], self.POLAR_DONOR_ELEMENTS)
            if not polar.any():
                raise ValueError(
                    "no polar (N/O/F/S-bonded) hydrogens found; pass an "
                    "explicit hydrogens_sel to override the donor filter")
            h_idx, d_idx = h_idx[polar], d_idx[polar]
        self._h_idx, self._a_idx, self._d_idx = h_idx, a_idx, d_idx
        # staged-selection slots
        uniq, inv = np.unique(np.concatenate([d_idx, h_idx, a_idx]),
                              return_inverse=True)
        self._idx = uniq
        nh = len(h_idx)
        self._d_slots = inv[:nh].astype(np.int32)
        self._h_slots = inv[nh:2 * nh].astype(np.int32)
        self._a_slots = inv[2 * nh:].astype(np.int32)
        # a donor that is itself an acceptor must not H-bond to itself
        self._self_pair = (d_idx[:, None] == self._a_idx[None, :])
        self._serial_counts = []
        self._serial_records = []

    # -- serial path --

    def _single_frame(self, ts):
        # candidate pruning (VERDICT r5: "work, don't scale"): the
        # donor-acceptor distance cutoff prunes first through the
        # capped-distance engine — O(nH + nA) with the cell list — and
        # the angle criterion is evaluated only on the K survivors,
        # never on the dense nH x nA matrix the batch kernel uses
        from mdanalysis_mpi_tpu_torch.lib.distances import capped_distance

        pos = ts.positions.astype(np.float64)
        d = pos[self._d_idx]
        h = pos[self._h_idx]
        a = pos[self._a_idx]
        pairs, dist = capped_distance(d, a, self._cutoff,
                                      box=ts.dimensions,
                                      engine=self._engine,
                                      device=self._engine_device)
        # upstream's criterion is strict <; capped_distance caps with <=
        keep = ((dist < self._cutoff)
                & (self._d_idx[pairs[:, 0]] != self._a_idx[pairs[:, 1]]))
        pi, pj, dist = pairs[keep, 0], pairs[keep, 1], dist[keep]
        hd = minimum_image(d[pi] - h[pi], ts.dimensions)
        ha = minimum_image(a[pj] - h[pi], ts.dimensions)
        num = (hd * ha).sum(-1)
        den = (np.sqrt((hd ** 2).sum(-1))
               * np.sqrt((ha ** 2).sum(-1))) + 1e-12
        ang = np.degrees(np.arccos(np.clip(num / den, -1.0, 1.0)))
        ok = ang > self._angle_cutoff
        self._serial_counts.append(float(ok.sum()))
        # pairs are lexsorted by (hydrogen, acceptor) — the same record
        # order np.nonzero emitted from the dense matrix
        for j, k, dd, aa in zip(pi[ok], pj[ok], dist[ok], ang[ok]):
            self._serial_records.append(
                (ts.frame, int(self._d_idx[j]), int(self._h_idx[j]),
                 int(self._a_idx[k]), float(dd), float(aa)))

    def _serial_summary(self):
        c = np.asarray(self._serial_counts)
        return (c, np.ones(len(c)))

    # -- batch path --

    # the batch function materializes dense (nH, nA, 3) candidate
    # tensors on the device (a few live per frame); past this many
    # pairs that is multi-GB per frame —
    # upstream sidesteps it with a neighbor search, which is inherently
    # dynamic-shape and therefore serial-oracle territory here
    MAX_BATCH_PAIRS = 25_000_000

    def _batch_select(self):
        n_pairs = len(self._h_idx) * len(self._a_idx)
        if n_pairs > self.MAX_BATCH_PAIRS:
            raise ValueError(
                f"{len(self._h_idx)} hydrogens x {len(self._a_idx)} "
                f"acceptors = {n_pairs} candidate pairs exceeds the dense "
                f"batch kernel's limit ({self.MAX_BATCH_PAIRS}); narrow "
                "hydrogens_sel/acceptors_sel or run with "
                "backend='serial'")
        return self._idx

    def _batch_fn(self):
        return _hbond_count_kernel

    def _batch_params(self):
        # index tensors and the mask, moved to the run's device by the
        # executor; the two thresholds are float32 scalars, as in the
        # JAX package
        return (torch.as_tensor(self._d_slots, dtype=torch.int64),
                torch.as_tensor(self._h_slots, dtype=torch.int64),
                torch.as_tensor(self._a_slots, dtype=torch.int64),
                torch.as_tensor(self._self_pair),
                np.float32(self._cutoff),
                np.float32(np.cos(np.radians(self._angle_cutoff))))

    _device_combine = None      # time series, concatenated in frame order

    def _identity_partials(self):
        return (np.empty(0), np.empty(0))

    def _conclude(self, total):
        counts, mask = total

        def _finalize():
            return np.asarray(to_numpy(counts))[
                np.asarray(to_numpy(mask)) > 0.5]

        self.results.count = Deferred(_finalize)
        if self._serial_records or self._serial_counts:
            self.results.hbonds = np.array(
                self._serial_records, dtype=np.float64).reshape(-1, 6)

    def lifetime(self, tau_max: int = 20, intermittency: int = 0):
        """Hydrogen-bond lifetime autocorrelation (upstream
        ``HydrogenBondAnalysis.lifetime``): for each lag τ, the MEAN
        over time origins t of the per-origin CONTINUOUS-survival ratio

            C(τ) = ⟨ |{p : b_p(t′) ∀ t′ ∈ [t, t+τ]}|  /  Σ_p b_p(t) ⟩_t

        over (hydrogen, acceptor) pairs ever bonded (origins with zero
        bonds are skipped) — the same semantics as upstream's
        ``lib.correlations.autocorrelation`` and this package's
        SurvivalProbability: a bond must hold through EVERY intermediate
        frame (a break-and-reform does not survive), and per-origin
        ratios are averaged (ratio-of-sums would overweight bond-rich
        origins).  Departures of ≤ ``intermittency`` consecutive frames
        are filled BEFORE the survival product (upstream's
        intermittent-lifetime preprocessing).  Returns
        ``(taus, timeseries)`` with τ in analyzed-frame steps.

        Needs the per-bond table — i.e. a completed ``run()`` on the
        SERIAL backend (the batch kernel reduces to counts on device;
        the bond LIST is inherently dynamic-shape, module docstring).
        """
        if tau_max < 0:
            raise ValueError(f"tau_max must be >= 0, got {tau_max}")
        if intermittency < 0:
            raise ValueError(
                f"intermittency must be >= 0, got {intermittency}")
        if "hbonds" not in self.results:
            raise ValueError(
                "lifetime() needs the per-bond table: run "
                ".run(backend='serial') first (batch backends produce "
                "counts only)")
        from mdanalysis_mpi_tpu_torch.lib.correlations import (
            intermittency_filter, survival_windows)

        table = self.results["hbonds"]
        frames = np.asarray(self._frame_indices, dtype=np.int64)
        t = len(frames)
        if len(table):
            # vectorized (frame, pair) scatter: the serial table can be
            # millions of rows at benchmark scale, a per-row Python
            # loop is minutes of host time
            order = np.argsort(frames, kind="stable")
            rows = order[np.searchsorted(frames[order],
                                         table[:, 0].astype(np.int64))]
            _, cols = np.unique(table[:, 2:4].astype(np.int64), axis=0,
                                return_inverse=True)
            present = np.zeros((t, int(cols.max()) + 1), dtype=bool)
            present[rows, cols] = True
        else:
            present = np.zeros((t, 0), dtype=bool)
        present = intermittency_filter(present, int(intermittency))
        tau_max = min(int(tau_max), t - 1 if t else 0)
        # the shared running-AND survival reduction (one home for the
        # semantics: lib.correlations)
        data = survival_windows(present, tau_max)
        c = np.array([float(np.mean(v)) if v else 0.0 for v in data])
        return np.arange(tau_max + 1), c
