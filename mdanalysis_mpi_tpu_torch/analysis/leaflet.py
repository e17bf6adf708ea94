"""Lipid leaflet identification (upstream
``MDAnalysis.analysis.leaflet.LeafletFinder``).

Headgroup atoms (e.g. ``"name P*"``) are clustered by spatial
adjacency: two headgroups belong to the same leaflet when they are
within ``cutoff`` of each other (minimum-imaged when ``pbc=True``),
and leaflets are the connected components of that graph — upstream's
networkx construction, realized here as the same union-find the
topology layer uses for bonded fragments.

``LeafletFinder(u, "name P", cutoff=15.0).run()`` (construction runs
the analysis, as upstream; ``run()`` recomputes at the current frame)
→ ``.groups()`` (list of AtomGroups, largest first),
``.groups(i)``, ``.sizes()``.  A well-chosen cutoff yields exactly two
large components — the upper and lower leaflet; upstream's
``optimize_cutoff`` helper is mirrored as :func:`optimize_cutoff`.

Host-side by design: one frame, one sparse neighbor search
(``lib.distances.self_capped_distance`` — the O(N) cell list by
default, brute force as the selectable fallback; neither materializes
the N² matrix), one union-find pass.  The per-frame batch machinery
would add nothing — leaflet assignment is a topology-building step,
not a trajectory reduction.
"""

from __future__ import annotations

import numpy as np


class LeafletFinder:
    """``LeafletFinder(universe, select, cutoff=15.0, pbc=False,
    engine='auto')``; ``engine`` is the pair-pruning backend knob
    (``lib.distances.capped_distance``), ``device`` the torch engine's
    device (``cuda`` unless given)."""

    def __init__(self, universe, select: str, cutoff: float = 15.0,
                 pbc: bool = False, engine: str = "auto", device=None):
        if cutoff <= 0:
            raise ValueError(f"cutoff must be positive, got {cutoff}")
        self._u = universe
        ag = universe.select_atoms(select)
        if ag.n_atoms == 0:
            raise ValueError(f"selection {select!r} matches no atoms")
        self._ag = ag
        self._cutoff = float(cutoff)
        self._pbc = bool(pbc)
        self._engine = engine
        self._device = device
        self.run()

    def run(self) -> "LeafletFinder":
        """(Re)cluster at the universe's CURRENT frame."""
        from mdanalysis_mpi_tpu_torch.core.box import valid_box_matrix
        from mdanalysis_mpi_tpu_torch.core.topology import label_components
        from mdanalysis_mpi_tpu_torch.lib.distances import self_capped_distance

        ts = self._u.trajectory.ts
        box = None
        if self._pbc:
            if ts.dimensions is None:
                raise ValueError("pbc=True but this frame carries no box")
            # strict: a partially degenerate box would NaN the distance
            # kernel and silently report every headgroup a singleton
            valid_box_matrix(ts.dimensions, "LeafletFinder(pbc=True)")
            box = ts.dimensions
        x = ts.positions[self._ag.indices].astype(np.float64)
        pairs = self_capped_distance(x, self._cutoff, box=box,
                                     return_distances=False,
                                     engine=self._engine,
                                     device=self._device)
        labels = label_components(len(x), pairs)
        comps: dict[int, list[int]] = {}
        for i, lab in enumerate(labels):
            comps.setdefault(int(lab), []).append(i)
        # largest first; ties broken by lowest atom index (determinism)
        ordered = sorted(comps.values(),
                         key=lambda m: (-len(m), m[0]))
        self._components = [np.asarray(m, np.int64) for m in ordered]
        return self

    def groups(self, index: int | None = None):
        """All leaflets as AtomGroups (largest first), or one of them."""
        from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup

        ags = [AtomGroup(self._u, self._ag.indices[m])
               for m in self._components]
        if index is None:
            return ags
        return ags[index]

    def sizes(self) -> list:
        return [len(m) for m in self._components]


def optimize_cutoff(universe, select: str, dmin: float = 10.0,
                    dmax: float = 20.0, step: float = 0.5,
                    max_imbalance: float = 0.2, pbc: bool = False,
                    engine: str = "auto", device=None):
    """Scan cutoffs and return ``(cutoff, n_components)`` minimizing
    the component count among cutoffs whose two largest leaflets are
    balanced within ``max_imbalance`` (upstream
    ``leaflet.optimize_cutoff``)."""
    if dmin <= 0 or step <= 0 or dmax < dmin:
        raise ValueError(
            f"need 0 < dmin <= dmax and step > 0, got "
            f"[{dmin}, {dmax}] step {step}")
    best = None
    for cutoff in np.arange(dmin, dmax + 1e-9, step):
        # no try/except: every ValueError reachable here (bad selection,
        # pbc without box) is cutoff-INdependent — swallowing it would
        # scan uselessly and misreport the real error as 'no cutoff'
        lf = LeafletFinder(universe, select, cutoff=float(cutoff),
                           pbc=pbc, engine=engine, device=device)
        sizes = lf.sizes()
        if len(sizes) < 2:
            continue
        imbalance = abs(sizes[0] - sizes[1]) / max(sizes[0] + sizes[1], 1)
        if imbalance > max_imbalance:
            continue
        cand = (len(sizes), float(cutoff))
        if best is None or cand < best:
            best = cand
    if best is None:
        raise ValueError(
            "no cutoff in the scanned range produced two balanced "
            "leaflets; widen [dmin, dmax] or check the selection")
    return best[1], best[0]
