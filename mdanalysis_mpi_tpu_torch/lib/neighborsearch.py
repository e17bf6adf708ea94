"""Neighbor search over AtomGroups (upstream
``MDAnalysis.lib.NeighborSearch.AtomNeighborSearch``).

A thin object front over the capped-distance engines
(``lib.distances.capped_distance`` — cell list by default, brute force
as fallback; no N×M materialization either way): build once over a
(static) group, query with any coordinates or group, get the matching
atoms back at atom / residue / segment granularity.
"""

from __future__ import annotations

import numpy as np


class AtomNeighborSearch:
    """``AtomNeighborSearch(ag, box=None).search(other, radius,
    level='A'|'R'|'S')`` → AtomGroup / ResidueGroup / SegmentGroup of
    the atoms of ``ag`` within ``radius`` of ``other`` (an AtomGroup or
    (M, 3) coordinates).  ``engine`` selects the pair-pruning backend
    (``lib.distances.capped_distance``: 'auto' picks the O(N) cell
    list at scale, 'bruteforce'/'nsgrid'/'torch' force one; ``device``
    is the torch engine's device, ``cuda`` unless given)."""

    def __init__(self, atomgroup, box=None, engine: str = "auto",
                 device=None):
        from mdanalysis_mpi_tpu_torch.analysis.base import reject_updating_groups

        reject_updating_groups(atomgroup, owner="AtomNeighborSearch")
        if atomgroup.n_atoms == 0:
            raise ValueError("cannot search an empty AtomGroup")
        self._ag = atomgroup
        self._box = box
        self._engine = engine
        self._device = device

    def search(self, other, radius: float, level: str = "A"):
        from mdanalysis_mpi_tpu_torch.lib.distances import capped_distance

        if radius <= 0:
            raise ValueError(f"radius must be positive, got {radius}")
        coords = (other.positions if hasattr(other, "positions")
                  else np.asarray(other, np.float64).reshape(-1, 3))
        pairs = capped_distance(self._ag.positions, coords, radius,
                                box=self._box, return_distances=False,
                                engine=self._engine, device=self._device)
        hits = np.unique(pairs[:, 0]) if len(pairs) else np.empty(
            0, np.int64)
        ag = self._ag[hits] if len(hits) else self._ag[[]]
        if level == "A":
            return ag
        if level == "R":
            from mdanalysis_mpi_tpu_torch.core.groups import ResidueGroup

            return ResidueGroup(ag.universe, ag.resindices)
        if level == "S":
            from mdanalysis_mpi_tpu_torch.core.groups import SegmentGroup

            return SegmentGroup(ag.universe, ag.segids)
        raise ValueError(
            f"level must be 'A', 'R' or 'S', got {level!r}")
