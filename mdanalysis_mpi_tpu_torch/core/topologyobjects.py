"""Connectivity groups (upstream ``core.topologyobjects``):
``u.bonds`` / ``u.angles`` / ``u.dihedrals`` / ``u.impropers`` and the
AtomGroup-filtered forms, plus the bond-graph guessers
(``guess_angles`` / ``guess_dihedrals`` / ``guess_improper_dihedrals``).

:class:`TopologyGroup` is index-first (a (n, k) int array view of the
topology's connectivity) — the TPU-native representation: ``values()``
evaluates ALL members in one vectorized call over the current frame's
coordinates (the shared ``lib.distances`` kernels, minimum-image when
the frame has a box), never an object per bond.  Upstream's per-object
API (``Bond.length()``) maps to ``group[i]`` → one-member group →
``values()[0]``.

Units follow upstream: bond lengths in Å, angle/dihedral values in
DEGREES.
"""

from __future__ import annotations

import numpy as np


class TopologyGroup:
    """A set of same-arity connectivity tuples bound to a Universe."""

    _KINDS = {"bond": 2, "angle": 3, "dihedral": 4, "improper": 4}

    def __init__(self, universe, indices: np.ndarray, kind: str):
        if kind not in self._KINDS:
            raise ValueError(f"unknown connectivity kind {kind!r}")
        width = self._KINDS[kind]
        idx = (np.asarray(indices, np.int64).reshape(-1, width)
               if indices is not None and len(indices)
               else np.empty((0, width), np.int64))
        self._universe = universe
        self.indices = idx
        self.kind = kind

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, item) -> "TopologyGroup":
        return TopologyGroup(self._universe,
                             np.atleast_2d(self.indices[item]), self.kind)

    def __repr__(self):
        return (f"<TopologyGroup of {len(self)} {self.kind}s>")

    def atomgroup_intersection(self, ag) -> "TopologyGroup":
        """Members whose atoms ALL belong to ``ag`` (upstream's strict
        filter — the semantics behind ``ag.bonds``)."""
        inside = np.zeros(self._universe.topology.n_atoms, bool)
        inside[ag.indices] = True
        keep = inside[self.indices].all(axis=1)
        return TopologyGroup(self._universe, self.indices[keep],
                             self.kind)

    def values(self) -> np.ndarray:
        """All members evaluated on the CURRENT frame in one vectorized
        kernel call: lengths (Å) for bonds, degrees for angles /
        dihedrals / impropers.  Minimum-image when the frame has a box.
        """
        from mdanalysis_mpi_tpu_torch.lib import distances as libdist

        ts = self._universe.trajectory.ts
        pos = ts.positions.astype(np.float64)
        box = ts.dimensions
        if box is not None and not np.all(np.asarray(box)[:3] > 0):
            box = None
        cols = [pos[self.indices[:, k]]
                for k in range(self.indices.shape[1])]
        if self.kind == "bond":
            return libdist.calc_bonds(cols[0], cols[1], box=box)
        if self.kind == "angle":
            return np.degrees(
                libdist.calc_angles(cols[0], cols[1], cols[2], box=box))
        return np.degrees(
            libdist.calc_dihedrals(cols[0], cols[1], cols[2], cols[3],
                                   box=box))

    # upstream aliases
    def bonds(self):
        if self.kind != "bond":
            raise TypeError(f"a {self.kind} group has no bond lengths")
        return self.values()

    def angles(self):
        if self.kind != "angle":
            raise TypeError(f"a {self.kind} group has no angle values")
        return self.values()

    def dihedrals(self):
        if self.kind not in ("dihedral", "improper"):
            raise TypeError(f"a {self.kind} group has no dihedral values")
        return self.values()

    def to_indices(self) -> np.ndarray:
        return self.indices.copy()


def _neighbor_lists(n_atoms: int, bonds: np.ndarray) -> list:
    nbrs: list = [[] for _ in range(n_atoms)]
    for x, y in np.asarray(bonds, np.int64):
        nbrs[x].append(int(y))
        nbrs[y].append(int(x))
    return [sorted(v) for v in nbrs]


def guess_angles(bonds: np.ndarray, n_atoms: int) -> np.ndarray:
    """All (i, j, k) with i–j and j–k bonded, i < k — upstream
    ``guess_angles`` over a bond list."""
    nbrs = _neighbor_lists(n_atoms, bonds)
    out = []
    for j, around in enumerate(nbrs):
        for a in range(len(around)):
            for b in range(a + 1, len(around)):
                out.append((around[a], j, around[b]))
    return (np.asarray(out, np.int64).reshape(-1, 3) if out
            else np.empty((0, 3), np.int64))


def guess_dihedrals(angles: np.ndarray, bonds: np.ndarray,
                    n_atoms: int) -> np.ndarray:
    """Each angle (i, j, k) extended by every neighbor of an END atom
    (upstream ``guess_dihedrals``): l–i–j–k for l bonded to i, and
    i–j–k–l for l bonded to k, l outside the angle.  Deduplicated under
    the (a,b,c,d) == (d,c,b,a) proper-dihedral symmetry."""
    nbrs = _neighbor_lists(n_atoms, bonds)
    seen = set()
    out = []
    for i, j, k in np.asarray(angles, np.int64).reshape(-1, 3):
        for l in nbrs[i]:
            if l != j and l != k:
                t = (l, i, j, k)
                key = min(t, t[::-1])
                if key not in seen:
                    seen.add(key)
                    out.append(t)
        for l in nbrs[k]:
            if l != j and l != i:
                t = (i, j, k, l)
                key = min(t, t[::-1])
                if key not in seen:
                    seen.add(key)
                    out.append(t)
    return (np.asarray(out, np.int64).reshape(-1, 4) if out
            else np.empty((0, 4), np.int64))


def guess_improper_dihedrals(angles: np.ndarray, bonds: np.ndarray,
                             n_atoms: int) -> np.ndarray:
    """Each angle (i, j, k) plus any FOURTH neighbor of the apex j —
    the upstream guesser's central-atom improper convention
    (j, i, k, l)."""
    nbrs = _neighbor_lists(n_atoms, bonds)
    seen = set()
    out = []
    for i, j, k in np.asarray(angles, np.int64).reshape(-1, 3):
        for l in nbrs[j]:
            if l != i and l != k:
                t = (int(j), int(i), int(k), int(l))
                if t not in seen:
                    seen.add(t)
                    out.append(t)
    return (np.asarray(out, np.int64).reshape(-1, 4) if out
            else np.empty((0, 4), np.int64))
