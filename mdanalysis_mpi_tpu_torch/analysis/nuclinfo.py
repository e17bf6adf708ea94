"""Nucleic-acid geometry functions (upstream ``analysis.nuclinfo``).

Per-call utilities evaluated at the Universe's CURRENT frame, like
upstream: base-pair distances (:func:`wc_pair`, :func:`minor_pair`,
:func:`major_pair`), backbone/glycosidic torsions (:func:`tors` and
the individual ``tors_*``), the 2'-hydroxyl dihedral
(:func:`hydroxyl`) and the two sugar-pucker phase conventions
(:func:`phase_as` Altona–Sundaralingam from the five ν torsions,
:func:`phase_cp` Cremer–Pople from ring-plane displacements).  Purine
vs pyrimidine atom choices come from the same resname tables the
:mod:`~mdanalysis_mpi_tpu_torch.analysis.nucleicacids` module uses
(core/tables.py), with unknown bases refusing loudly.

All angles are degrees; torsions are wrapped to [0, 360) as upstream
does.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.tables import (PURINE_RESNAMES,
                                            PYRIMIDINE_RESNAMES)
from mdanalysis_mpi_tpu_torch.lib.distances import calc_dihedrals

__all__ = [
    "wc_pair", "minor_pair", "major_pair", "tors", "tors_alpha",
    "tors_beta", "tors_gamma", "tors_delta", "tors_eps", "tors_zeta",
    "tors_chi", "hydroxyl", "phase_as", "phase_cp",
]


def _one_atom(universe, segid, resid, name) -> np.ndarray:
    sel = universe.select_atoms(
        f"segid {segid} and resid {resid} and name {name}")
    if sel.n_atoms != 1:
        raise ValueError(
            f"selection segid {segid} resid {resid} name {name} matched "
            f"{sel.n_atoms} atoms (need exactly 1)")
    return sel.positions[0].astype(np.float64)


def _residue(universe, segid, resid):
    """(kind, AtomGroup) of one residue — selected ONCE per residue;
    callers needing both the classification and the atom names reuse
    the group."""
    sel = universe.select_atoms(f"segid {segid} and resid {resid}")
    if sel.n_atoms == 0:
        raise ValueError(f"no atoms in segid {segid} resid {resid}")
    rn = str(sel.resnames[0]).upper()
    if rn in PURINE_RESNAMES:
        return "purine", sel
    if rn in PYRIMIDINE_RESNAMES:
        return "pyrimidine", sel
    raise ValueError(
        f"resname {rn!r} (segid {segid} resid {resid}) is neither a "
        "known purine nor pyrimidine (core/tables.py)")


def _base_kind(universe, segid, resid) -> str:
    return _residue(universe, segid, resid)[0]


def _dist(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b))


def wc_pair(universe, i, bp, seg1="SYSTEM", seg2="SYSTEM") -> float:
    """Watson–Crick N1(purine)–N3(pyrimidine) distance between residue
    ``i`` of ``seg1`` and residue ``bp`` of ``seg2``."""
    a1 = "N1" if _base_kind(universe, seg1, i) == "purine" else "N3"
    a2 = "N1" if _base_kind(universe, seg2, bp) == "purine" else "N3"
    return _dist(_one_atom(universe, seg1, i, a1),
                 _one_atom(universe, seg2, bp, a2))


def minor_pair(universe, i, bp, seg1="SYSTEM", seg2="SYSTEM") -> float:
    """Minor-groove contact: C2 on the purine, O2 on the pyrimidine."""
    a1 = "C2" if _base_kind(universe, seg1, i) == "purine" else "O2"
    a2 = "C2" if _base_kind(universe, seg2, bp) == "purine" else "O2"
    return _dist(_one_atom(universe, seg1, i, a1),
                 _one_atom(universe, seg2, bp, a2))


def major_pair(universe, i, bp, seg1="SYSTEM", seg2="SYSTEM") -> float:
    """Major-groove contact: O6/N6 on the purine (G/A), N4/O4 on the
    pyrimidine (C/T,U) — i.e. G·C → O6–N4, A·T → N6–O4."""
    def atom_for(segid, resid):
        kind, sel = _residue(universe, segid, resid)
        names = set(map(str, sel.names))
        if kind == "purine":
            # G carries O6, A carries N6
            if "O6" in names:
                return "O6"
            if "N6" in names:
                return "N6"
            raise ValueError(
                f"purine segid {segid} resid {resid} has neither O6 "
                "nor N6")
        if "N4" in names:
            return "N4"
        if "O4" in names:
            return "O4"
        raise ValueError(
            f"pyrimidine segid {segid} resid {resid} has neither N4 "
            "nor O4")

    return _dist(_one_atom(universe, seg1, i, atom_for(seg1, i)),
                 _one_atom(universe, seg2, bp, atom_for(seg2, bp)))


def _dihedral_deg(quads) -> float:
    p = [np.asarray(q) for q in quads]
    d = float(np.degrees(calc_dihedrals(
        p[0][None], p[1][None], p[2][None], p[3][None])[0]))
    return d % 360.0


def tors_alpha(universe, seg, i) -> float:
    """α: O3'(i−1)–P(i)–O5'(i)–C5'(i)."""
    return _dihedral_deg([
        _one_atom(universe, seg, i - 1, "O3'"),
        _one_atom(universe, seg, i, "P"),
        _one_atom(universe, seg, i, "O5'"),
        _one_atom(universe, seg, i, "C5'")])


def tors_beta(universe, seg, i) -> float:
    """β: P–O5'–C5'–C4'."""
    return _dihedral_deg([
        _one_atom(universe, seg, i, "P"),
        _one_atom(universe, seg, i, "O5'"),
        _one_atom(universe, seg, i, "C5'"),
        _one_atom(universe, seg, i, "C4'")])


def tors_gamma(universe, seg, i) -> float:
    """γ: O5'–C5'–C4'–C3'."""
    return _dihedral_deg([
        _one_atom(universe, seg, i, "O5'"),
        _one_atom(universe, seg, i, "C5'"),
        _one_atom(universe, seg, i, "C4'"),
        _one_atom(universe, seg, i, "C3'")])


def tors_delta(universe, seg, i) -> float:
    """δ: C5'–C4'–C3'–O3'."""
    return _dihedral_deg([
        _one_atom(universe, seg, i, "C5'"),
        _one_atom(universe, seg, i, "C4'"),
        _one_atom(universe, seg, i, "C3'"),
        _one_atom(universe, seg, i, "O3'")])


def tors_eps(universe, seg, i) -> float:
    """ε: C4'–C3'–O3'–P(i+1)."""
    return _dihedral_deg([
        _one_atom(universe, seg, i, "C4'"),
        _one_atom(universe, seg, i, "C3'"),
        _one_atom(universe, seg, i, "O3'"),
        _one_atom(universe, seg, i + 1, "P")])


def tors_zeta(universe, seg, i) -> float:
    """ζ: C3'–O3'–P(i+1)–O5'(i+1)."""
    return _dihedral_deg([
        _one_atom(universe, seg, i, "C3'"),
        _one_atom(universe, seg, i, "O3'"),
        _one_atom(universe, seg, i + 1, "P"),
        _one_atom(universe, seg, i + 1, "O5'")])


def tors_chi(universe, seg, i) -> float:
    """χ glycosidic: O4'–C1'–N9–C4 (purine) / O4'–C1'–N1–C2
    (pyrimidine)."""
    if _base_kind(universe, seg, i) == "purine":
        n, c = "N9", "C4"
    else:
        n, c = "N1", "C2"
    return _dihedral_deg([
        _one_atom(universe, seg, i, "O4'"),
        _one_atom(universe, seg, i, "C1'"),
        _one_atom(universe, seg, i, n),
        _one_atom(universe, seg, i, c)])


def tors(universe, seg, i):
    """(α, β, γ, δ, ε, ζ, χ) of residue ``i`` — upstream's 7-tuple."""
    return (tors_alpha(universe, seg, i), tors_beta(universe, seg, i),
            tors_gamma(universe, seg, i), tors_delta(universe, seg, i),
            tors_eps(universe, seg, i), tors_zeta(universe, seg, i),
            tors_chi(universe, seg, i))


def hydroxyl(universe, seg, i) -> float:
    """2'-hydroxyl dihedral C1'–C2'–O2'–HO2' (RNA; DNA residues have
    no O2' and refuse via the 1-atom selection check)."""
    return _dihedral_deg([
        _one_atom(universe, seg, i, "C1'"),
        _one_atom(universe, seg, i, "C2'"),
        _one_atom(universe, seg, i, "O2'"),
        _one_atom(universe, seg, i, "HO2'")])


_RING = ("C1'", "C2'", "C3'", "C4'", "O4'")


def _nu(universe, seg, i):
    """Sugar torsions ν0..ν4 in degrees, SIGNED (−180, 180]."""
    pos = {n: _one_atom(universe, seg, i, n) for n in _RING}
    quads = [
        ("C4'", "O4'", "C1'", "C2'"),   # nu0
        ("O4'", "C1'", "C2'", "C3'"),   # nu1
        ("C1'", "C2'", "C3'", "C4'"),   # nu2
        ("C2'", "C3'", "C4'", "O4'"),   # nu3
        ("C3'", "C4'", "O4'", "C1'"),   # nu4
    ]
    out = []
    for a, b, c, d in quads:
        ang = float(np.degrees(calc_dihedrals(
            pos[a][None], pos[b][None], pos[c][None], pos[d][None])[0]))
        out.append(ang)
    return out


def phase_as(universe, seg, i) -> float:
    """Altona–Sundaralingam pseudorotation phase (degrees in [0, 360))
    from the five sugar torsions."""
    nu0, nu1, nu2, nu3, nu4 = _nu(universe, seg, i)
    num = (nu4 + nu1) - (nu3 + nu0)
    den = 2.0 * nu2 * (np.sin(np.radians(36.0))
                       + np.sin(np.radians(72.0)))
    p = np.degrees(np.arctan2(num, den))
    return float(p % 360.0)


def phase_cp(universe, seg, i) -> float:
    """Cremer–Pople phase of the 5-membered sugar ring (degrees in
    [0, 360)), from out-of-plane displacements about the mean plane.

    Ring order O4'→C1'→C2'→C3'→C4' (the convention that makes the CP
    and AS phases agree in offset for nucleic sugars)."""
    order = ("O4'", "C1'", "C2'", "C3'", "C4'")
    r = np.array([_one_atom(universe, seg, i, n) for n in order])
    r = r - r.mean(axis=0)
    n = 5
    j = np.arange(n)
    r1 = (r * np.sin(2 * np.pi * j / n)[:, None]).sum(axis=0)
    r2 = (r * np.cos(2 * np.pi * j / n)[:, None]).sum(axis=0)
    normal = np.cross(r1, r2)
    normal /= np.linalg.norm(normal)
    z = r @ normal
    a = np.sqrt(2.0 / n) * (z * np.cos(4 * np.pi * j / n)).sum()
    b = -np.sqrt(2.0 / n) * (z * np.sin(4 * np.pi * j / n)).sum()
    p = np.degrees(np.arctan2(b, a))
    return float(p % 360.0)
