"""Nucleic-acid pair distances (upstream
``MDAnalysis.analysis.nucleicacids``).

:class:`NucPairDist` — per-frame distances between explicit atom
pairs; :class:`WatsonCrickDist` — the standard base-pairing distance
per residue pair: the purine's N1 to the pyrimidine's N3 (the central
Watson–Crick hydrogen bond), with the correct atom picked per residue
from its resname.

``WatsonCrickDist(strand1, strand2).run()`` → ``results.pair_distances``
(T, n_pairs) with strand residues paired in order (upstream also
exposes the older ``results.distances`` name; both are provided).

A time-series analysis like RMSD: only the union of paired atoms is
staged, and every frame batch's distances come from one gather + norm
on the run's device, concatenated in frame order.
"""

from __future__ import annotations

import numpy as np

import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, Deferred,
                                                    to_numpy)

#: purines contribute N1, pyrimidines N3 — the split lives beside
#: NUCLEIC_RESNAMES in core/tables.py; resnames in NEITHER set raise
#: rather than silently falling through to the wrong atom
from mdanalysis_mpi_tpu_torch.core.tables import (  # noqa: E402
    PURINE_RESNAMES, PYRIMIDINE_RESNAMES,
)


def _pair_dist_kernel(params, batch, boxes, mask):
    del boxes
    i_slots, j_slots = params
    d = batch[:, i_slots] - batch[:, j_slots]
    return (torch.sqrt((d ** 2).sum(-1)) * mask[:, None], mask)


class NucPairDist(AnalysisBase):
    """Distances between explicit atom index pairs:
    ``NucPairDist(universe, pairs)`` with ``pairs`` an (n, 2) array of
    global atom indices (the generic base WatsonCrickDist builds on).
    """

    def __init__(self, universe, pairs, verbose: bool = False):
        super().__init__(universe, verbose)
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        if len(pairs) == 0:
            raise ValueError("need at least one atom pair")
        n = universe.topology.n_atoms
        if pairs.min() < 0 or pairs.max() >= n:
            raise ValueError(
                f"pair indices out of range for {n} atoms")
        self._pairs_global = pairs

    def _prepare(self):
        uniq, inv = np.unique(self._pairs_global, return_inverse=True)
        self._idx = uniq
        slots = inv.reshape(self._pairs_global.shape).astype(np.int64)
        self._i_slots = slots[:, 0]
        self._j_slots = slots[:, 1]
        self._serial_rows: list = []

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        d = x[self._i_slots] - x[self._j_slots]
        self._serial_rows.append(np.sqrt((d ** 2).sum(-1)))

    def _serial_summary(self):
        k = len(self._i_slots)
        rows = (np.stack(self._serial_rows) if self._serial_rows
                else np.empty((0, k)))
        return (rows, np.ones(len(rows)))

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _pair_dist_kernel

    def _batch_params(self):
        return (torch.as_tensor(self._i_slots),
                torch.as_tensor(self._j_slots))

    # no _device_fold_fn: a time series, concatenated in frame order

    def _identity_partials(self):
        return (np.empty((0, len(self._pairs_global))), np.empty(0))

    def _conclude(self, total):
        vals, mask = total

        def _finalize():
            return np.asarray(to_numpy(vals), np.float64)[
                np.asarray(to_numpy(mask)) > 0.5]

        d = Deferred(_finalize)
        self.results.pair_distances = d
        self.results.distances = d          # upstream's older name


class WatsonCrickDist(NucPairDist):
    """``WatsonCrickDist(strand1, strand2).run()`` — strands are
    ResidueGroups or AtomGroups whose residues pair IN ORDER; each
    pair's distance is purine-N1 ↔ pyrimidine-N3."""

    def __init__(self, strand1, strand2, n1_name: str = "N1",
                 n3_name: str = "N3", verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.core.topology import residue_atom_map

        res1 = self._strand_residues(strand1)
        res2 = self._strand_residues(strand2)
        if len(res1) != len(res2):
            raise ValueError(
                f"strands pair residue-by-residue: got {len(res1)} vs "
                f"{len(res2)} residues")
        u = strand1.universe
        if strand2.universe is not u:
            raise ValueError("strands must share one universe")
        t = u.topology
        cols = residue_atom_map(t, np.concatenate([res1, res2]))
        pairs = []
        for r1, r2 in zip(res1, res2):
            pairs.append((self._wc_atom(t, cols, int(r1), n1_name,
                                        n3_name),
                          self._wc_atom(t, cols, int(r2), n1_name,
                                        n3_name)))
        super().__init__(u, np.asarray(pairs), verbose=verbose)
        self.resindices = (res1, res2)

    @staticmethod
    def _strand_residues(strand) -> np.ndarray:
        if hasattr(strand, "resindices") and not hasattr(strand,
                                                         "positions"):
            return np.asarray(strand.resindices, np.int64)   # ResidueGroup
        if hasattr(strand, "indices"):                       # AtomGroup
            u = strand.universe
            # preserve strand order (first appearance), not sorted
            ri = u.topology.resindices[strand.indices]
            _, first = np.unique(ri, return_index=True)
            return ri[np.sort(first)].astype(np.int64)
        raise TypeError(
            f"strand must be an AtomGroup or ResidueGroup, got "
            f"{type(strand).__name__}")

    @staticmethod
    def _wc_atom(t, cols, r: int, n1_name: str, n3_name: str) -> int:
        d = cols.get(r, {})
        resname = str(t.resnames[next(iter(d.values()))]).upper() \
            if d else "?"
        if resname in PURINE_RESNAMES:
            want = n1_name
        elif resname in PYRIMIDINE_RESNAMES:
            want = n3_name
        else:
            # purines carry an N3 too, so a silent fallback would
            # return a wrong-but-plausible distance — refuse instead
            # (upstream raises on unrecognized nucleic resnames)
            raise ValueError(
                f"residue {resname} (resindex {r}) is not a known "
                "purine or pyrimidine (core/tables.py); cannot choose "
                "the Watson-Crick atom")
        if want not in d:
            raise ValueError(
                f"residue {resname} (resindex {r}) lacks atom "
                f"{want!r} for the Watson-Crick distance")
        return d[want]
