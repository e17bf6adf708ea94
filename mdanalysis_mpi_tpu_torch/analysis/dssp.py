"""Secondary-structure assignment (upstream ``MDAnalysis.analysis.dssp``).

Three-state DSSP ('H' helix / 'E' strand / '-' loop), the same
simplified algorithm upstream wraps (pydssp):

1. amide hydrogens are ESTIMATED from backbone geometry (upstream's
   ``guess_hydrogens``): ``H_i = N_i + 1.01 Å · unit(unit(N_i−C_{i−1})
   + unit(N_i−CA_i))`` — the bisector of the two N-neighbor directions;
2. the Kabsch–Sander electrostatic H-bond energy for donor NH(i) →
   acceptor CO(j),

       E = 0.084 · 332 · (1/d_ON + 1/d_CH − 1/d_OH − 1/d_CN) kcal/mol,

   with a bond when E < −0.5 (|i−j| ≤ 1 excluded);
3. patterns on the (n, n) H-bond map: n-turns (NH(i+k)→CO(i),
   k = 3, 4, 5) in consecutive pairs mark helices; parallel /
   antiparallel bridge patterns mark strands; everything else is loop.

``DSSP(u).run()`` → ``results.dssp`` (T, n_res) of 'H'/'E'/'-' and
``results.resindices``.  Step 2 — the O(n²) part — is one batch
function (gathers + four pairwise 1/r matrices as torch ops) producing
per-frame H-bond maps, concatenated in frame order; the pattern logic
(step 3) is boolean shifting done on the host at the first read.  The
JAX package's ``analysis/dssp.py``, with the host assignment copied.  The serial oracle computes the identical map in
float64; parity and the pattern rules are pinned by analytic fixtures
(ideal turn ladders, bridge patterns, a hand-built N-H···O=C geometry).
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group,
                                                    real_frames, to_numpy)

#: Kabsch–Sander constant: 0.084 e² charge product × 332 kcal·Å/mol·e²
_KS = 0.084 * 332.0
_E_CUT = -0.5


def _unit_np(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-30)


def _estimate_h_np(n, ca, c):
    """Amide H for residues 1..n-1 (residue 0 has no preceding C)."""
    u = _unit_np(n[1:] - c[:-1]) + _unit_np(n[1:] - ca[1:])
    return n[1:] + 1.01 * _unit_np(u)


def _hbond_map_np(n, ca, c, o) -> np.ndarray:
    """(n_res, n_res) bool: NH(i) donates to CO(j) (float64 oracle)."""
    nres = len(n)
    h = _estimate_h_np(n, ca, c)

    def inv_d(a, b):
        return 1.0 / (np.linalg.norm(a[:, None] - b[None], axis=-1)
                      + 1e-30)

    # donors are residues 1..nres-1 (rows 1..); acceptors all residues
    e = np.full((nres, nres), np.inf)
    e[1:] = _KS * (inv_d(n[1:], o) + inv_d(h, c)
                   - inv_d(h, o) - inv_d(n[1:], c))
    hb = e < _E_CUT
    i = np.arange(nres)
    hb[np.abs(i[:, None] - i[None]) <= 1] = False
    return hb


def _dssp_kernel(params, batch, boxes, mask):
    """Batched twin: (B, S, 3) staged backbone union → per-frame
    H-bond maps (B, n_res, n_res) bool (as float for masking), a
    time-series family output."""
    del boxes
    n_s, ca_s, c_s, o_s = params
    n = batch[:, n_s]
    ca = batch[:, ca_s]
    c = batch[:, c_s]
    o = batch[:, o_s]

    def unit(v):
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-30)

    u = unit(n[:, 1:] - c[:, :-1]) + unit(n[:, 1:] - ca[:, 1:])
    h = n[:, 1:] + 1.01 * unit(u)

    def inv_d(a, b):
        return 1.0 / (torch.linalg.norm(a[:, :, None] - b[:, None],
                                        dim=-1) + 1e-30)

    nres = n.shape[1]
    e = _KS * (inv_d(n[:, 1:], o) + inv_d(h, c)
               - inv_d(h, o) - inv_d(n[:, 1:], c))
    e = torch.cat(
        [torch.full((e.shape[0], 1, nres), float("inf"), dtype=e.dtype,
                    device=e.device), e], dim=1)
    hb = e < _E_CUT
    i = torch.arange(nres, device=e.device)
    hb = hb & ((i[:, None] - i[None]).abs() > 1)
    return (hb.to(torch.float32) * mask[:, None, None], mask)


def _shifted(hb: np.ndarray, di: int, dj: int) -> np.ndarray:
    """``S[i, j] = hb[i + di, j + dj]`` where that lies in the map,
    else False: one slice copy, no index arrays."""
    n = len(hb)
    out = np.zeros_like(hb)
    i0, i1 = max(0, -di), min(n, n - di)
    j0, j1 = max(0, -dj), min(n, n - dj)
    if i0 < i1 and j0 < j1:
        out[i0:i1, j0:j1] = hb[i0 + di:i1 + di, j0 + dj:j1 + dj]
    return out


def assign_from_hbond_map(hb: np.ndarray) -> np.ndarray:
    """(n, n) bool H-bond map (NH(i)→CO(j)) → (n,) array of
    'H'/'E'/'-' (the pydssp 3-state pattern rules; the JAX package's
    function, its shifted lookups ``hb[i + a, j + b]`` taken as slices
    of the map and of its transpose)."""
    hb = np.asarray(hb, dtype=bool)
    n = len(hb)
    out = np.full(n, "-", dtype="U1")

    helix = np.zeros(n, dtype=bool)
    for k in (3, 4, 5):
        # turn_k[i]: NH(i+k) donates to CO(i)
        t = np.zeros(n, dtype=bool)
        if n > k:
            t[:n - k] = np.diagonal(hb, offset=-k)
        # two consecutive k-turns starting at i-1 and i → residues
        # i .. i+k-1 are helical (the pydssp consecutive-turn rule)
        start = np.zeros(n, dtype=bool)
        start[1:] = t[:-1] & t[1:]
        for i in np.flatnonzero(start):
            helix[i:i + k] = True

    # bridges (Kabsch-Sander): Hbond(a, b) here = hb[a, b] (NH(a)→CO(b));
    # hb[j + b, i + a] is the transpose's [i + a, j + b]
    hbt = np.ascontiguousarray(hb.T)
    r = np.arange(n)
    ok = np.abs(r[:, None] - r[None]) >= 3   # no bridge with near neighbors
    para = ((_shifted(hb, -1, 0) & _shifted(hbt, 1, 0))
            | (_shifted(hbt, 0, -1) & _shifted(hb, 0, 1)))
    anti = ((hb & hbt)
            | (_shifted(hb, -1, 1) & _shifted(hbt, 1, -1)))
    pair = (para | anti) & ok
    bridge = pair.any(axis=1)

    out[bridge] = "E"
    out[helix & ~bridge] = "H"         # strand wins ties (pydssp order)
    return out


class DSSP(AnalysisBase):
    """``DSSP(u).run()`` → ``results.dssp`` (T, n_res) of 'H'/'E'/'-'.

    Needs the protein backbone atoms N, CA, C, O per residue (amide
    hydrogens are estimated — upstream's ``guess_hydrogens=True``
    path, which is also its only batch-friendly one)."""

    def __init__(self, universe, select: str = "protein",
                 verbose: bool = False):
        super().__init__(universe, verbose)
        self._select = select

    def _prepare(self):
        from mdanalysis_mpi_tpu_torch.core.topology import residue_atom_map

        u = self._universe
        t = u.topology
        ag = u.select_atoms(self._select)
        sel = ag.indices[t.is_protein[ag.indices]]
        if len(sel) == 0:
            raise ValueError(f"DSSP: {self._select!r} has no protein")
        res = np.unique(t.resindices[sel])
        cols = residue_atom_map(t, res)
        # the pattern algebra (H estimation from the PREVIOUS residue's
        # C, the |i−j|≤1 exclusion, the turn diagonals) treats row
        # order as SEQUENCE order — a chain break would silently wire
        # chain B's first H to chain A's last C and let turns span the
        # gap, so one contiguous single-segment chain is required
        # (upstream DSSP raises for multi-chain input too)
        first = np.asarray([min(cols[int(r)].values()) for r in res])
        segs = t.segids[first] if t.segids is not None else None
        if segs is not None and len(set(segs)) > 1:
            raise ValueError(
                f"DSSP needs a single chain; selection spans segments "
                f"{sorted(set(segs))} — run per segment")
        rids = t.resids[first]
        if len(rids) > 1 and not (np.diff(rids) == 1).all():
            gap = int(np.flatnonzero(np.diff(rids) != 1)[0])
            raise ValueError(
                f"DSSP needs contiguous resids; gap after resid "
                f"{int(rids[gap])} — run per contiguous stretch")
        quad = []
        for r in res:
            d = cols[int(r)]
            missing = [nm for nm in ("N", "CA", "C", "O") if nm not in d]
            if missing:
                raise ValueError(
                    f"DSSP: residue index {int(r)} lacks backbone "
                    f"atoms {missing} (need N, CA, C, O)")
            quad.append([d["N"], d["CA"], d["C"], d["O"]])
        if len(quad) < 5:
            raise ValueError(
                f"DSSP needs at least 5 residues, got {len(quad)}")
        quad = np.asarray(quad, np.int64)          # (n_res, 4)
        self.resindices = res
        uniq, inv = np.unique(quad, return_inverse=True)
        self._idx = uniq
        slots = inv.reshape(quad.shape).astype(np.int32)
        self._n_slot = slots[:, 0]
        self._ca_slot = slots[:, 1]
        self._c_slot = slots[:, 2]
        self._o_slot = slots[:, 3]
        self._serial_rows: list = []

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        self._serial_rows.append(_hbond_map_np(
            x[self._n_slot], x[self._ca_slot], x[self._c_slot],
            x[self._o_slot]))

    def _serial_summary(self):
        nres = len(self._n_slot)
        rows = (np.stack(self._serial_rows).astype(np.float32)
                if self._serial_rows else np.empty((0, nres, nres),
                                                   np.float32))
        return (rows, np.ones(len(rows)))

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _dssp_kernel

    def _batch_params(self):
        return tuple(torch.as_tensor(s, dtype=torch.int64)
                     for s in (self._n_slot, self._ca_slot, self._c_slot,
                               self._o_slot))

    # time series, concatenated in frame order

    def _identity_partials(self):
        nres = len(self._n_slot)
        return (np.empty((0, nres, nres), np.float32), np.empty(0))

    def _conclude(self, total):
        maps, mask = total
        nres = len(self._n_slot)
        # boolean on the device: a quarter of the bytes to read back
        maps = real_frames(maps, mask, self.n_frames) > 0.5

        def _finalize():
            hbs = np.asarray(to_numpy(maps))
            letters = (np.stack([assign_from_hbond_map(hb)
                                 for hb in hbs]) if len(hbs)
                       else np.empty((0, nres), "U1"))
            return {"dssp": letters, "hbond_maps": hbs}

        g = deferred_group(_finalize)
        self.results.dssp = g["dssp"]
        self.results.hbond_maps = g["hbond_maps"]
        self.results.resindices = self.resindices
