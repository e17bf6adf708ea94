"""Bond-Angle-Torsion internal coordinates (upstream
``MDAnalysis.analysis.bat.BAT``).

Converts the Cartesian coordinates of one bonded molecule into internal
(BAT) coordinates and back, exactly:

- 6 external coordinates: the root atom's position (3), the polar /
  azimuthal angles (θ, φ) of the first root bond, and the rotation ω
  of the root triple about that bond;
- root internals: r01, r12 bond lengths and the a012 angle;
- per remaining atom (torsion tree, BFS order): bond length to its
  tree parent, angle with its grandparent, torsion with its
  great-grandparent.

Layout of one frame's vector (upstream's ``results.bat`` ordering,
3N values):  ``[p0(3), φ, θ, ω, r01, r12, a012,
bonds(n−3), angles(n−3), torsions(n−3)]`` — angles in RADIANS.

The torsion tree is a BFS spanning tree of the molecule's bond graph
rooted at a terminal atom (or ``initial_atom``); rings are handled by
the spanning tree (ring-closing bonds just don't appear as tree
edges).  ``Cartesian(bat_frame)`` reconstructs coordinates by NeRF
chain placement; the round-trip is exact to float64 precision (pinned
by tests, including on branched and ring-bearing molecules).

The forward transform is three gathers (pairs / triples / quads) +
norms / arccos / atan2 as torch ops over each frame batch, concatenated
in frame order (time-series family), so the torch and mesh backends run
it unchanged.  Reconstruction is sequential along the tree and stays a
host (NumPy float64) method.  The JAX package's ``analysis/bat.py``,
with its host tree code copied.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisBase, series_of


def _build_tree(ag, initial_atom: int | None):
    """BFS torsion tree over the group's bond graph →
    (root triple (3,), torsion quads (n−3, 4) global indices, BFS
    order).  Quads are (d, c, b, a): atom, parent, grandparent,
    great-grandparent (root atoms substitute for missing ancestors)."""
    u = ag.universe
    bonds = u.topology.bonds
    if bonds is None or len(bonds) == 0:
        raise ValueError(
            "BAT needs bonds; parse a bonded topology (PSF) or run "
            "guess_bonds() first")
    members = set(int(i) for i in ag.indices)
    adj: dict[int, list[int]] = {i: [] for i in members}
    for x, y in np.asarray(bonds):
        x, y = int(x), int(y)
        if x in members and y in members:
            adj[x].append(y)
            adj[y].append(x)
    for i, nb in adj.items():
        if not nb:
            raise ValueError(
                f"atom {i} has no bonds inside the group; BAT needs one "
                "connected molecule")
        nb.sort()
    n = len(members)
    if n < 3:
        raise ValueError(f"BAT needs at least 3 atoms, got {n}")

    if initial_atom is not None:
        root0 = int(initial_atom)
        if root0 not in members:
            raise ValueError(
                f"initial_atom {root0} is not in the group")
    else:
        # a terminal atom (1 bond) keeps the root triple a simple
        # chain; pure rings have none — any atom works then
        terminals = [i for i, nb in adj.items() if len(nb) == 1]
        root0 = min(terminals) if terminals else min(members)
    root1 = adj[root0][0]
    r2cands = [i for i in adj[root1] if i != root0]
    if not r2cands:
        raise ValueError(
            f"root bond {root0}-{root1} has no third atom; pick a "
            "different initial_atom")
    root2 = r2cands[0]

    # BFS from the root triple; every later atom records its ancestor
    # chain (parent, grandparent, great-grandparent).  The root atoms'
    # pointers chain INTO the triple; when the walk folds back onto an
    # atom already in the quad (children hanging off root0/root1), the
    # remaining root atom substitutes — always exactly one left, and
    # root bonds keep every such quad geometrically proper.
    parent = {root0: root1, root1: root0, root2: root1}
    roots = {root0, root1, root2}
    seen = set(roots)
    queue = [root2, root1, root0]
    quads = []
    qi = 0
    while qi < len(queue):
        c = queue[qi]
        qi += 1
        for d in adj[c]:
            if d in seen:
                continue
            seen.add(d)
            parent[d] = c
            b = parent[c]
            a = parent[b]
            if a in (d, c, b):
                a = (roots - {d, c, b}).pop()
            quads.append((d, c, b, a))
            queue.append(d)
    if len(seen) != n:
        missing = sorted(members - seen)[:5]
        raise ValueError(
            f"group is not one connected molecule: atoms {missing}... "
            "unreachable from the root")
    return (np.array([root0, root1, root2], np.int64),
            np.asarray(quads, np.int64).reshape(len(quads), 4))


def _frame_to_e(phi, theta, xp=np):
    """Unit vector from polar angles (θ from +z, φ azimuth)."""
    st = xp.sin(theta)
    return xp.stack([st * xp.cos(phi), st * xp.sin(phi),
                     xp.cos(theta)], axis=-1)


def _external_np(p0, p1, p2):
    """Root-triple Cartesian → (φ, θ, ω, r01, r12, a012), float64."""
    v01 = p1 - p0
    r01 = np.linalg.norm(v01)
    e = v01 / r01
    theta = np.arccos(np.clip(e[2], -1.0, 1.0))
    phi = np.arctan2(e[1], e[0])
    v12 = p2 - p1
    r12 = np.linalg.norm(v12)
    a012 = np.arccos(np.clip((-e * v12 / r12).sum(), -1.0, 1.0))
    # ω: azimuth of v12 in the frame where e → ẑ (Rz(−φ) then Ry(−θ))
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    ry_rz = np.array([[ct * cp, ct * sp, -st],
                      [-sp, cp, 0.0],
                      [st * cp, st * sp, ct]])
    w = ry_rz @ v12
    omega = np.arctan2(w[1], w[0])
    return phi, theta, omega, r01, r12, a012


def _bat_frame_np(x, root, quads):
    """(N_sel, 3) float64 → one (3n,) BAT vector (see module layout)."""
    from mdanalysis_mpi_tpu_torch.ops.dihedrals import dihedral_batch_np

    p0, p1, p2 = x[root]
    phi, theta, omega, r01, r12, a012 = _external_np(p0, p1, p2)
    d = x[quads[:, 0]]
    c = x[quads[:, 1]]
    b = x[quads[:, 2]]
    dc = d - c
    bonds = np.linalg.norm(dc, axis=1)
    bc = b - c
    cosang = (dc * bc).sum(1) / (bonds * np.linalg.norm(bc, axis=1)
                                 + 1e-300)
    angles = np.arccos(np.clip(cosang, -1.0, 1.0))
    torsions = np.radians(dihedral_batch_np(x[None], quads)[0])
    return np.concatenate([
        [p0[0], p0[1], p0[2], phi, theta, omega, r01, r12, a012],
        bonds, angles, torsions])


def _bat_kernel(params, batch, boxes, mask):
    """Batched twin of ``_bat_frame_np``: (B, S, 3) → (B, 3n)."""
    from mdanalysis_mpi_tpu_torch.ops.dihedrals import dihedral_batch

    del boxes
    root, quads = params
    p0 = batch[:, root[0]]
    p1 = batch[:, root[1]]
    p2 = batch[:, root[2]]
    v01 = p1 - p0
    r01 = torch.linalg.norm(v01, dim=1)
    e = v01 / r01[:, None]
    theta = torch.arccos(torch.clamp(e[:, 2], -1.0, 1.0))
    phi = torch.atan2(e[:, 1], e[:, 0])
    v12 = p2 - p1
    r12 = torch.linalg.norm(v12, dim=1)
    a012 = torch.arccos(torch.clamp(
        (-e * v12).sum(1) / r12, -1.0, 1.0))
    cp, sp = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    wx = ((ct * cp)[:, None] * v12[:, :1] + (ct * sp)[:, None]
          * v12[:, 1:2] - st[:, None] * v12[:, 2:3]).squeeze(-1)
    wy = (-sp[:, None] * v12[:, :1] + cp[:, None]
          * v12[:, 1:2]).squeeze(-1)
    omega = torch.atan2(wy, wx)
    d = batch[:, quads[:, 0]]
    c = batch[:, quads[:, 1]]
    b = batch[:, quads[:, 2]]
    dc = d - c
    bonds = torch.linalg.norm(dc, dim=-1)
    bc = b - c
    cosang = ((dc * bc).sum(-1)
              / (bonds * torch.linalg.norm(bc, dim=-1) + 1e-30))
    angles = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    torsions = torch.deg2rad(dihedral_batch(batch, quads))
    bat = torch.cat([
        p0, phi[:, None], theta[:, None], omega[:, None],
        r01[:, None], r12[:, None], a012[:, None],
        bonds, angles, torsions], dim=1)
    return (bat * mask[:, None], mask)


class BAT(AnalysisBase):
    """``BAT(ag).run()`` → ``results.bat`` (T, 3·n_atoms);
    ``Cartesian(bat_frame)`` inverts one frame exactly.

    ``ag`` must be ONE bonded molecule (connected through topology
    bonds); ``initial_atom`` (global index) overrides the root choice.
    """

    def __init__(self, ag, initial_atom: int | None = None,
                 verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.analysis.base import reject_updating_groups

        reject_updating_groups(ag, owner="BAT")
        super().__init__(ag.universe, verbose)
        self._ag = ag
        self._root_global, self._quads_global = _build_tree(
            ag, initial_atom)

    def _prepare(self):
        uniq, inv = np.unique(
            np.concatenate([self._root_global,
                            self._quads_global.ravel()]),
            return_inverse=True)
        self._idx = uniq
        self._root = inv[:3].astype(np.int32)
        self._quads = inv[3:].reshape(-1, 4).astype(np.int32)
        self._serial_rows: list = []

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        self._serial_rows.append(_bat_frame_np(x, self._root, self._quads))

    def _serial_summary(self):
        w = 9 + 3 * len(self._quads)
        rows = (np.stack(self._serial_rows) if self._serial_rows
                else np.empty((0, w)))
        return (rows, np.ones(len(rows)))

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _bat_kernel

    def _batch_params(self):
        return (torch.as_tensor(self._root, dtype=torch.int64),
                torch.as_tensor(self._quads, dtype=torch.int64))

    # time series, concatenated in frame order

    def _identity_partials(self):
        w = 9 + 3 * len(self._quads)
        return (np.empty((0, w)), np.empty(0))

    def _conclude(self, total):
        bat, mask = total
        self.results.bat = series_of(bat, mask, self.n_frames)

    def Cartesian(self, bat_frame: np.ndarray) -> np.ndarray:
        """One BAT vector → (n_atoms, 3) float64 coordinates, in the
        GROUP's atom order (``ag.indices`` order).  Exact inverse of
        the forward transform (NeRF chain placement along the tree)."""
        v = np.asarray(bat_frame, np.float64)
        nq = len(self._quads_global)
        if v.shape != (9 + 3 * nq,):
            raise ValueError(
                f"expected a ({9 + 3 * nq},) BAT vector, got {v.shape}")
        p0 = v[:3]
        phi, theta, omega, r01, r12, a012 = v[3:9]
        bonds = v[9:9 + nq]
        angles = v[9 + nq:9 + 2 * nq]
        torsions = v[9 + 2 * nq:]

        e = _frame_to_e(phi, theta)
        p1 = p0 + r01 * e
        # v12 direction: polar angle (π − a012) from e, azimuth ω in
        # the e-frame (inverse of _external_np's Ry(−θ)Rz(−φ))
        cp, sp = np.cos(phi), np.sin(phi)
        ct, st = np.cos(theta), np.sin(theta)
        inv_rot = np.array([[ct * cp, -sp, st * cp],
                            [ct * sp, cp, st * sp],
                            [-st, 0.0, ct]])
        sa = np.sin(np.pi - a012)
        ca = np.cos(np.pi - a012)
        p2 = p1 + r12 * (inv_rot @ np.array(
            [sa * np.cos(omega), sa * np.sin(omega), ca]))

        pos = {int(self._root_global[0]): p0,
               int(self._root_global[1]): p1,
               int(self._root_global[2]): p2}
        for (dg, cg, bg, ag_), r, ang, tor in zip(
                self._quads_global, bonds, angles, torsions):
            c = pos[int(cg)]
            b = pos[int(bg)]
            a = pos[int(ag_)]
            # NeRF: place d at distance r from c, angle ang to b,
            # torsion tor about the c-b axis relative to a
            cb = c - b
            cb /= np.linalg.norm(cb)
            n = np.cross(b - a, cb)
            n /= np.linalg.norm(n)
            m = np.cross(n, cb)
            d2 = r * np.array([np.cos(np.pi - ang),
                               np.sin(np.pi - ang) * np.cos(tor),
                               np.sin(np.pi - ang) * np.sin(tor)])
            pos[int(dg)] = c + (np.stack([cb, m, n], axis=1) @ d2)
        return np.stack([pos[int(i)] for i in self._ag.indices])
