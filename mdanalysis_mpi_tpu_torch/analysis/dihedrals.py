"""Dihedral-angle time series: Dihedral and Ramachandran.

Upstream-API mirror (``MDAnalysis.analysis.dihedrals``):
``Dihedral([ag1, ag2, ...]).run()`` → ``results.angles`` (T, K) for K
four-atom groups, and ``Ramachandran(ag).run()`` → ``results.angles``
(T, n_res, 2) φ/ψ backbone angles.  The reference program has no
dihedral analysis; this plugs the upstream surface into the
AnalysisBase executor layer.

A *time-series* analysis like RMSD — only the union of the
quadruples' atoms is staged (K dihedrals touch ≤ 4K atoms however big
the system), and all K angles of a frame batch come from one gather +
cross-product + atan2 pass (:mod:`mdanalysis_mpi_tpu_torch.ops.
dihedrals`), concatenated on the device in frame order (the JAX
package's ``analysis/dihedrals.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, Deferred,
                                                    real_frames, to_numpy)
from mdanalysis_mpi_tpu_torch.ops.dihedrals import dihedral_batch, dihedral_batch_np


# ---- module-level batch function ----

def _dihedral_kernel(params, batch, boxes, mask):
    del boxes
    (quads,) = params
    return (dihedral_batch(batch, quads) * mask[:, None], mask)


class Dihedral(AnalysisBase):
    """``Dihedral([ag, ...]).run().results.angles`` — each AtomGroup is
    one dihedral: exactly 4 atoms, in order.  A
    :class:`~mdanalysis_mpi_tpu_torch.core.topologyobjects.TopologyGroup` of
    dihedrals/impropers is accepted directly
    (``Dihedral(u.dihedrals).run()`` — all members, one batched
    kernel)."""

    def __init__(self, atomgroups, verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.analysis.base import reject_updating_groups
        from mdanalysis_mpi_tpu_torch.core.topologyobjects import TopologyGroup

        if isinstance(atomgroups, TopologyGroup):
            tg = atomgroups
            if tg.indices.shape[1] != 4:
                raise ValueError(
                    f"a {tg.kind} TopologyGroup has {tg.indices.shape[1]}"
                    "-atom members; Dihedral needs 4-atom tuples "
                    "(dihedrals or impropers)")
            if len(tg) == 0:
                raise ValueError("empty dihedral TopologyGroup")
            super().__init__(tg._universe, verbose)
            self._quads_global = tg.indices.copy()
            return
        atomgroups = list(atomgroups)
        if not atomgroups:
            raise ValueError("need at least one 4-atom AtomGroup")
        # the groups are snapshotted below and not retained — the
        # run()-time updating-group scan cannot catch them here
        reject_updating_groups(*atomgroups, owner="Dihedral")
        u = atomgroups[0].universe
        for i, ag in enumerate(atomgroups):
            if ag.n_atoms != 4:
                raise ValueError(
                    f"atomgroup {i} has {ag.n_atoms} atoms; a dihedral "
                    "needs exactly 4 (in order)")
            if ag.universe is not u:
                raise ValueError("all atomgroups must share one universe")
        super().__init__(u, verbose)
        self._quads_global = np.stack([ag.indices for ag in atomgroups])

    def _prepare(self):
        # stage only the union of involved atoms; quads become slot
        # indices into that staged selection
        uniq, inv = np.unique(self._quads_global, return_inverse=True)
        self._idx = uniq
        self._quads = inv.reshape(self._quads_global.shape).astype(np.int32)
        self._serial_rows = []

    # -- serial path --

    def _single_frame(self, ts):
        self._serial_rows.append(dihedral_batch_np(
            ts.positions[self._idx][None], self._quads)[0])

    def _serial_summary(self):
        k = len(self._quads)
        rows = (np.stack(self._serial_rows) if self._serial_rows
                else np.empty((0, k)))
        return (rows, np.ones(len(rows)))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _dihedral_kernel

    def _batch_params(self):
        return (torch.as_tensor(self._quads, dtype=torch.int64),)

    # time series, concatenated in frame order

    def _identity_partials(self):
        return (np.empty((0, len(self._quads))), np.empty(0))

    def _conclude(self, total):
        vals, mask = total
        self.results.angles = self._angles(real_frames(vals, mask,
                                                       self.n_frames))

    def _angles(self, flat):
        """The (T, K) angles of the real frames → ``results.angles``."""
        return Deferred(lambda: np.asarray(to_numpy(flat)))


def _phi_psi_quads(ag):
    """Backbone (C_prev, N, CA, C) / (N, CA, C, N_next) quadruples for
    every residue OF ``ag`` whose chain neighbors exist in the
    UNIVERSE (upstream semantics: a selection of resids 5-10 still gets
    angles for 5 and 10 by fetching resid 4's C and 11's N from the
    universe).  Neighbors must be the same segment AND resid-contiguous
    (a ±1 resid step — unresolved-loop gaps in a chain must not produce
    gap-spanning pseudo-bonds).  Returns (phi (R, 4), psi (R, 4),
    resindices (R,))."""
    u = ag.universe
    t = u.topology
    if len(ag.indices) == 0 or not t.is_protein[ag.indices].any():
        raise ValueError("Ramachandran needs protein atoms")
    wanted = set(int(r) for r in np.unique(
        t.resindices[ag.indices[t.is_protein[ag.indices]]]))
    # backbone atom map over ALL protein residues (neighbor lookups may
    # leave the selection); shared builder, core/topology.py
    from mdanalysis_mpi_tpu_torch.core.topology import residue_atom_map

    prot_res = np.unique(t.resindices[np.flatnonzero(t.is_protein)])
    atoms = residue_atom_map(t, prot_res, names=("N", "CA", "C"))
    segs = (t.segids if t.segids is not None
            else np.zeros(t.n_atoms, dtype="U1"))

    def _meta(r):
        d = atoms.get(r, {})
        ca = d.get("CA")
        if ca is None:                       # explicit: atom index 0 is falsy
            ca = next(iter(d.values()), None)
        return (None, None) if ca is None else (segs[ca], int(t.resids[ca]))

    phi, psi, rows = [], [], []
    for r in sorted(wanted):
        cur, prev, nxt = atoms.get(r, {}), atoms.get(r - 1), atoms.get(r + 1)
        if not all(k in cur for k in ("N", "CA", "C")):
            continue
        if prev is None or nxt is None or "C" not in prev \
                or "N" not in nxt:
            continue           # chain termini have no phi/psi pair
        seg, rid = _meta(r)
        seg_p, rid_p = _meta(r - 1)
        seg_n, rid_n = _meta(r + 1)
        # same chain AND contiguous resids (gap check)
        if seg_p != seg or seg_n != seg:
            continue
        if rid_p != rid - 1 or rid_n != rid + 1:
            continue
        phi.append((prev["C"], cur["N"], cur["CA"], cur["C"]))
        psi.append((cur["N"], cur["CA"], cur["C"], nxt["N"]))
        rows.append(r)
    if not phi:
        raise ValueError(
            "no residue in the selection has complete (C_prev, N, CA, C, "
            "N_next) backbone atoms")
    return (np.asarray(phi, np.int64), np.asarray(psi, np.int64),
            np.asarray(rows))


class Ramachandran(Dihedral):
    """``Ramachandran(u.select_atoms('protein')).run()`` →
    ``results.angles`` (T, R, 2): φ/ψ per interior residue per frame."""

    def __init__(self, atomgroup, verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.analysis.base import reject_updating_groups

        # same snapshot-and-drop pattern as Dihedral/Janin
        reject_updating_groups(atomgroup, owner="Ramachandran")
        phi, psi, rows = _phi_psi_quads(atomgroup)
        self._n_res = len(rows)
        self.resindices = rows
        AnalysisBase.__init__(self, atomgroup.universe, verbose)
        # interleave (phi_0, psi_0, phi_1, ...) so the base Dihedral
        # machinery computes them all in one kernel call
        self._quads_global = np.empty((2 * self._n_res, 4), np.int64)
        self._quads_global[0::2] = phi
        self._quads_global[1::2] = psi

    def _angles(self, flat):
        return Deferred(lambda: np.asarray(to_numpy(flat)).reshape(
            len(flat), self._n_res, 2))


#: side-chain atom-name variants accepted for the chi dihedral
#: positions (upstream Janin's select strings)
_CHI1_G = ("CG", "CG1", "OG", "OG1", "SG")
_CHI2_D = ("CD", "CD1", "SD", "OD1", "ND1")


def _chi_quads(ag, remove_resnames):
    """(chi1 (R, 4), chi2 (R, 4), resindices) for every protein residue
    of ``ag`` not excluded by resname.  chi1 = N-CA-CB-G,
    chi2 = CA-CB-G-D with G/D from the name-variant tables.  A
    surviving residue MISSING any of the five atoms raises (upstream
    Janin's too-few-atoms error) — silent drops would misalign the
    per-residue rows users zip against their own residue lists."""
    u = ag.universe
    t = u.topology
    if len(ag.indices) == 0 or not t.is_protein[ag.indices].any():
        raise ValueError("Janin needs protein atoms")
    sel = ag.indices[t.is_protein[ag.indices]]
    rn = np.char.upper(t.resnames[sel].astype("U"))
    # a trailing '*' matches by prefix (upstream's 'CYS*' select idiom:
    # disulfide/protonation-state variants CYX/CYS2/CYM all lack a χ₂)
    keep = np.ones(len(sel), dtype=bool)
    for pat in remove_resnames:
        p = pat.upper()
        if p.endswith("*"):
            keep &= ~np.char.startswith(rn, p[:-1])
        else:
            keep &= rn != p
    from mdanalysis_mpi_tpu_torch.core.topology import residue_atom_map

    wanted = np.unique(t.resindices[sel[keep]])
    atoms = residue_atom_map(t, wanted)
    chi1, chi2, rows = [], [], []
    for r in wanted:
        d = atoms[int(r)]
        g_atom = next((d[n] for n in _CHI1_G if n in d), None)
        d_atom = next((d[n] for n in _CHI2_D if n in d), None)
        missing = [n for n in ("N", "CA", "CB") if n not in d]
        if missing or g_atom is None or d_atom is None:
            resname = t.resnames[next(iter(d.values()))]
            raise ValueError(
                f"residue {resname} (resindex {int(r)}) lacks chi1/chi2 "
                f"atoms (missing {missing or 'G/D side-chain atoms'}); "
                "exclude it via remove_resnames")
        chi1.append((d["N"], d["CA"], d["CB"], g_atom))
        chi2.append((d["CA"], d["CB"], g_atom, d_atom))
        rows.append(int(r))
    if not chi1:
        raise ValueError(
            "no residue in the selection carries chi1/chi2 side chains "
            "(all excluded by remove_resnames?)")
    return (np.asarray(chi1, np.int64), np.asarray(chi2, np.int64),
            np.asarray(rows))


class Janin(Dihedral):
    """``Janin(u.select_atoms('protein')).run()`` → ``results.angles``
    (T, R, 2): χ₁/χ₂ per side-chain-bearing residue per frame, wrapped
    to [0, 360) (the upstream Janin-plot convention, unlike
    Ramachandran's (−180, 180]).  ``remove_resnames`` excludes residues
    without a χ₂ (upstream's ``select_remove`` default)."""

    REMOVE_DEFAULT = ("ALA", "CYS*", "GLY", "PRO", "SER", "THR", "VAL")

    def __init__(self, atomgroup, remove_resnames=REMOVE_DEFAULT,
                 verbose: bool = False):
        from mdanalysis_mpi_tpu_torch.analysis.base import reject_updating_groups

        # the group is snapshotted by _chi_quads and not retained —
        # the run()-time updating-group scan cannot catch it here
        reject_updating_groups(atomgroup, owner="Janin")
        chi1, chi2, rows = _chi_quads(atomgroup, remove_resnames)
        self._n_res = len(rows)
        self.resindices = rows
        AnalysisBase.__init__(self, atomgroup.universe, verbose)
        self._quads_global = np.empty((2 * self._n_res, 4), np.int64)
        self._quads_global[0::2] = chi1
        self._quads_global[1::2] = chi2

    def _angles(self, flat):
        return Deferred(lambda: np.asarray(to_numpy(flat)).reshape(
            len(flat), self._n_res, 2) % 360.0)
