"""GROMACS ITP / TOP topology parser (upstream ``ITPParser``).

The GROMACS side of what PRMTOP gives AMBER users: GRO coordinate
files carry no masses/charges/bonds — those live in the ``.top`` /
``.itp`` force-field topology.  ``Universe("topol.top", "md.xtc")``
builds the full system: every ``[moleculetype]``'s ``[atoms]`` /
``[bonds]`` / ``[settles]`` / ``[constraints]`` / ``[angles]`` /
``[dihedrals]`` blocks are collected (dihedral function types 2/4
land in ``impropers``, the GROMACS convention),
``#include`` lines are resolved relative to the including file (a
missing include — e.g. a force-field file living in a GROMACS install
this environment doesn't have — fails loudly with the remedy), and
the ``[molecules]`` section replicates each molecule
by its count into one concatenated
:class:`~mdanalysis_mpi_tpu_torch.core.topology.Topology`.

Preprocessor handling is the deliberate subset real topologies use:
``#include``, ``#define NAME`` (flags collected; ``-DPOSRES``-style
values via the ``defines`` argument), ``#ifdef``/``#ifndef``/
``#else``/``#endif`` (nesting supported).  ``settles`` and
``constraints`` become bonds (connectivity is what the Topology
stores, same policy as MOL2).  A bare ``.itp`` without ``[molecules]``
yields one copy of its (single) moleculetype, upstream's behavior.
"""

from __future__ import annotations

import os

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology, concatenate
from mdanalysis_mpi_tpu_torch.io import topology_files


class _Molecule:
    def __init__(self, name):
        self.name = name
        self.names: list[str] = []
        self.resids: list[int] = []
        self.resnames: list[str] = []
        self.charges: list[float] = []
        self.masses: list[float] = []
        self.bonds: list[tuple[int, int]] = []
        self.angles: list[tuple[int, int, int]] = []
        self.dihedrals: list[tuple[int, int, int, int]] = []
        self.impropers: list[tuple[int, int, int, int]] = []


def _iter_lines(path: str, defines: set, stack=()):
    """Yield (path, lineno, line) with includes resolved and
    ifdef/ifndef blocks evaluated against ``defines``."""
    if path in stack:
        raise ValueError(f"#include cycle at {path}")
    cond: list[bool] = []          # active-block stack
    with open(path) as fh:
        lineno = 0
        for lineno, raw in enumerate(fh, 1):
            ln = raw.split(";", 1)[0].rstrip()
            if not ln.strip():
                continue
            t = ln.split()
            if t[0] == "#ifdef":
                cond.append(t[1] in defines)
                continue
            if t[0] == "#ifndef":
                cond.append(t[1] not in defines)
                continue
            if t[0] == "#else":
                if not cond:
                    raise ValueError(f"{path}:{lineno}: #else without #ifdef")
                cond[-1] = not cond[-1]
                continue
            if t[0] == "#endif":
                if not cond:
                    raise ValueError(f"{path}:{lineno}: #endif without #ifdef")
                cond.pop()
                continue
            if not all(cond):
                continue
            if t[0] == "#define":
                defines.add(t[1])
                continue
            if t[0] == "#include":
                inc = t[1].strip('"<>')
                target = os.path.join(os.path.dirname(path), inc)
                if not os.path.exists(target):
                    raise FileNotFoundError(
                        f"{path}:{lineno}: #include {inc!r} not found "
                        f"next to the including file; GROMACS "
                        "force-field includes must be copied alongside "
                        "the topology (no GROMACS share/ directory in "
                        "this environment)")
                yield from _iter_lines(target, defines, stack + (path,))
                continue
            yield path, lineno, ln
    if cond:
        raise ValueError(
            f"{path}: {len(cond)} unterminated #ifdef/#ifndef at end "
            "of file (missing #endif) — refusing a silently truncated "
            "topology")


def parse_itp(path: str, defines=()) -> Topology:
    defines = set(defines)
    molecules: dict[str, _Molecule] = {}
    current: _Molecule | None = None
    section = None
    system_mols: list[tuple[str, int]] = []
    for src, lineno, ln in _iter_lines(path, defines):
        s = ln.strip()
        if s.startswith("["):
            section = s.strip("[] \t").lower()
            continue
        t = s.split()
        if section == "moleculetype":
            if t[0] in molecules:
                raise ValueError(
                    f"{src}:{lineno}: [moleculetype] {t[0]!r} is "
                    "redefined (same .itp included twice, or two "
                    "files defining it) — GROMACS grompp refuses "
                    "this too")
            current = _Molecule(t[0])
            molecules[t[0]] = current
        elif section == "atoms":
            if current is None:
                raise ValueError(
                    f"{src}:{lineno}: [atoms] outside [moleculetype]")
            # nr type resnr residue atom cgnr [charge [mass]]
            if len(t) < 5:
                raise ValueError(
                    f"{src}:{lineno}: [atoms] line needs >= 5 fields: "
                    f"{s!r}")
            current.resids.append(int(t[2]))
            current.resnames.append(t[3])
            current.names.append(t[4])
            current.charges.append(float(t[6]) if len(t) > 6 else 0.0)
            current.masses.append(float(t[7]) if len(t) > 7 else -1.0)
        elif section in ("bonds", "constraints"):
            if current is None:
                raise ValueError(
                    f"{src}:{lineno}: [{section}] outside [moleculetype]")
            current.bonds.append((int(t[0]) - 1, int(t[1]) - 1))
        elif section == "angles":
            if current is None:
                raise ValueError(
                    f"{src}:{lineno}: [angles] outside [moleculetype]")
            current.angles.append(
                (int(t[0]) - 1, int(t[1]) - 1, int(t[2]) - 1))
        elif section == "dihedrals":
            if current is None:
                raise ValueError(
                    f"{src}:{lineno}: [dihedrals] outside "
                    "[moleculetype]")
            quad = (int(t[0]) - 1, int(t[1]) - 1, int(t[2]) - 1,
                    int(t[3]) - 1)
            # GROMACS function type 2/4 are improper conventions;
            # everything else (1, 3, 5, 9...) is a proper dihedral
            func = int(t[4]) if len(t) > 4 else 1
            (current.impropers if func in (2, 4)
             else current.dihedrals).append(quad)
        elif section == "settles":
            # rigid water: OW is atom ai; bonds OW-HW1, OW-HW2
            if current is None:
                raise ValueError(
                    f"{src}:{lineno}: [settles] outside [moleculetype]")
            ow = int(t[0]) - 1
            current.bonds.append((ow, ow + 1))
            current.bonds.append((ow, ow + 2))
        elif section == "molecules":
            system_mols.append((t[0], int(t[1])))
        # every other section (atomtypes, pairs,
        # exclusions, position_restraints, system, defaults...) carries
        # force-field data the Topology does not store
    if not molecules:
        raise ValueError(f"{path!r} declares no [moleculetype]")
    if not system_mols:
        if len(molecules) > 1:
            raise ValueError(
                f"{path!r} declares {len(molecules)} moleculetypes but "
                "no [molecules] section to order them")
        system_mols = [(next(iter(molecules)), 1)]
    parts = []
    for name, count in system_mols:
        mol = molecules.get(name)
        if mol is None:
            known = ", ".join(sorted(molecules))
            raise ValueError(
                f"[molecules] references {name!r} but no such "
                f"[moleculetype] was parsed (known: {known}); the "
                "defining .itp is probably behind an unresolved "
                "#include")
        if not mol.names:
            raise ValueError(f"[moleculetype] {name!r} has no [atoms]")
        masses = np.asarray(mol.masses)
        if (masses >= 0).all():
            pass                            # every mass explicit
        elif (masses < 0).all():
            masses = None                   # none given: element table
        else:
            # mixed explicit/omitted: fill ONLY the gaps from the
            # element table; explicit masses (isotopes!) must survive
            from mdanalysis_mpi_tpu_torch.core import tables

            gaps = masses < 0
            masses = masses.copy()
            masses[gaps] = tables.guess_masses(
                np.array(mol.names)[gaps], np.array(mol.resnames)[gaps])
        # replicate ONCE per [molecules] entry with np.tile — a
        # 30000-copy solvent box must not build a 30000-part list
        nm = len(mol.names)
        names = np.tile(np.array(mol.names), count)
        resnames = np.tile(np.array(mol.resnames), count)
        resids = np.tile(np.array(mol.resids, np.int64), count)
        charges = np.tile(np.array(mol.charges), count)
        m_t = None if masses is None else np.tile(masses, count)
        def _replicate(tuples, width):
            if not tuples:
                return None
            b = np.asarray(tuples, np.int64)
            return (b[None] + (np.arange(count) * nm)[:, None, None]
                    ).reshape(-1, width)

        bonds = _replicate(mol.bonds, 2)
        angles = _replicate(mol.angles, 3)
        dihedrals = _replicate(mol.dihedrals, 4)
        impropers = _replicate(mol.impropers, 4)
        # per-copy residue separation: shift resindices by copy so
        # identical (resid, segid) in adjacent copies stay distinct.
        # The change-point cumsum is derived directly (a throwaway
        # Topology would run per-atom element/mass guessing for
        # nothing); segids are constant within a moleculetype
        rid = np.array(mol.resids, np.int64)
        change = np.ones(nm, dtype=bool)
        if nm > 1:
            change[1:] = rid[1:] != rid[:-1]
        base_ri = np.cumsum(change) - 1
        nres_mol = int(base_ri.max()) + 1 if nm else 0
        resindices = (np.tile(base_ri, count)
                      + np.repeat(np.arange(count), nm) * nres_mol)
        parts.append(Topology(
            names=names, resnames=resnames, resids=resids,
            charges=charges, masses=m_t, bonds=bonds, angles=angles,
            dihedrals=dihedrals, impropers=impropers,
            resindices=resindices))
    return parts[0] if len(parts) == 1 else concatenate(parts)


topology_files.register("itp", parse_itp)
# .top would collide with AMBER PRMTOP (upstream maps .top to its TOP
# parser too); GROMACS tops are sniffed there by content
