"""AMBER PRMTOP topology parser (upstream ``TOPParser``) + a minimal
writer for offline test fixtures.

Completes the AMBER stack next to the NetCDF trajectory reader
(io/netcdf.py) and the INPCRD restart reader (io/inpcrd.py):
``Universe("sys.prmtop", "md.nc")``.

The format is %FLAG-sectioned FORTRAN card data.  Sections are parsed
by the FIELD WIDTH declared in each ``%FORMAT(...)`` line — mandatory
for ``20a4`` name blocks (4-char names pack with NO separators) and
the safe choice for numeric blocks too (I8 fields can touch at large
values).  Consumed flags: POINTERS (NATOM, NRES), ATOM_NAME, CHARGE
(AMBER's internal units, ÷18.2223 → e), MASS, ATOMIC_NUMBER (element
source when present; else nearest-mass lookup), RESIDUE_LABEL,
RESIDUE_POINTER, BONDS_INC_HYDROGEN + BONDS_WITHOUT_HYDROGEN (AMBER's
index*3 convention → (n, 2) atom-index bond list).  Unknown flags are
skipped, so real pmemd/tleap outputs with the full flag roster parse.
"""

from __future__ import annotations

import re

import numpy as np

from mdanalysis_mpi_tpu_torch.core.tables import MASSES
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files

#: AMBER stores charges multiplied by sqrt(332.0522173) ≈ 18.2223
#: (kcal/mol electrostatic prefactor folded into the unit)
AMBER_CHARGE_SCALE = 18.2223

_FMT = re.compile(r"%FORMAT\(\s*(\d+)\s*([aIiEeFf])\s*(\d+)", re.ASCII)

_Z_TO_ELEMENT = {
    1: "H", 2: "HE", 3: "LI", 4: "BE", 5: "B", 6: "C", 7: "N", 8: "O",
    9: "F", 10: "NE", 11: "NA", 12: "MG", 13: "AL", 14: "SI", 15: "P",
    16: "S", 17: "CL", 18: "AR", 19: "K", 20: "CA", 25: "MN", 26: "FE",
    27: "CO", 28: "NI", 29: "CU", 30: "ZN", 35: "BR", 37: "RB",
    38: "SR", 42: "MO", 53: "I", 55: "CS", 56: "BA",
}


def _sections(path: str):
    """{FLAG: (kind, width, [data lines])} — kind 'a'/'I'/'E'."""
    out: dict[str, tuple[str, int, list[str]]] = {}
    flag = None
    with open(path) as fh:
        for ln in fh:
            ln = ln.rstrip("\n")
            if ln.startswith("%VERSION") or ln.startswith("%COMMENT"):
                continue
            if ln.startswith("%FLAG"):
                flag = ln[5:].strip()
                out[flag] = ("?", 0, [])
                continue
            if ln.startswith("%FORMAT"):
                m = _FMT.match(ln)
                if m is None or flag is None:
                    raise ValueError(
                        f"{path}: unparseable FORMAT line {ln!r}")
                kind = m.group(2).upper()
                kind = "E" if kind in ("E", "F") else kind
                out[flag] = (kind, int(m.group(3)), out[flag][2])
                continue
            if flag is not None:
                out[flag][2].append(ln)
    return out


def _values(section, n=None):
    kind, width, lines = section
    vals = []
    for ln in lines:
        for k in range(0, len(ln), width):
            field = ln[k:k + width]
            if not field.strip():
                continue
            if kind == "A":
                vals.append(field.strip())
            elif kind == "I":
                vals.append(int(field))
            else:
                vals.append(float(field))
    if n is not None:
        vals = vals[:n]
        if len(vals) < n:
            raise ValueError(
                f"PRMTOP section carries {len(vals)} values, need {n}")
    return vals


def _elements_from_masses(masses: np.ndarray) -> np.ndarray:
    """Nearest-mass element per atom, computed once per DISTINCT mass
    (older tleap prmtops lack ATOMIC_NUMBER; a million-atom system has
    a handful of distinct masses)."""
    els = np.array(list(MASSES.keys()))
    ems = np.array([MASSES[e] for e in els])
    uniq, inv = np.unique(np.asarray(masses, np.float64),
                          return_inverse=True)
    nearest = els[np.abs(ems[None, :] - uniq[:, None]).argmin(axis=1)]
    return nearest[inv]


def parse_prmtop(path: str) -> Topology:
    sec = _sections(path)
    if "POINTERS" not in sec:
        raise ValueError(f"{path}: no %FLAG POINTERS — not a PRMTOP")
    ptr = _values(sec["POINTERS"])
    natom, nres = int(ptr[0]), int(ptr[11])
    names = np.array(_values(sec["ATOM_NAME"], natom))
    charges = (np.array(_values(sec["CHARGE"], natom))
               / AMBER_CHARGE_SCALE) if "CHARGE" in sec else None
    masses = (np.array(_values(sec["MASS"], natom))
              if "MASS" in sec else None)
    labels = _values(sec["RESIDUE_LABEL"], nres)
    rptr = _values(sec["RESIDUE_POINTER"], nres)      # 1-based firsts
    starts = np.asarray(rptr, np.int64) - 1
    bounds = np.append(starts, natom)
    resnames = np.empty(natom, dtype=np.dtype("U8"))
    resids = np.empty(natom, dtype=np.int64)
    for r in range(nres):
        resnames[bounds[r]:bounds[r + 1]] = labels[r]
        resids[bounds[r]:bounds[r + 1]] = r + 1
    if "ATOMIC_NUMBER" in sec:
        z = _values(sec["ATOMIC_NUMBER"], natom)
        elements = np.array(
            [_Z_TO_ELEMENT.get(int(v), "X") for v in z])
    elif masses is not None:
        elements = _elements_from_masses(masses)
    else:
        elements = None
    bonds = []
    for flagname in ("BONDS_INC_HYDROGEN", "BONDS_WITHOUT_HYDROGEN"):
        if flagname not in sec:
            continue
        trip = _values(sec[flagname])
        if len(trip) % 3:
            raise ValueError(
                f"{path}: {flagname} length {len(trip)} is not a "
                "multiple of 3")
        for k in range(0, len(trip), 3):
            # AMBER stores coordinate-array offsets = atom_index * 3
            bonds.append((int(trip[k]) // 3, int(trip[k + 1]) // 3))
    return Topology(
        names=names, resnames=resnames, resids=resids,
        elements=elements, masses=masses, charges=charges,
        bonds=np.asarray(bonds, np.int64) if bonds else None)


def write_prmtop(path: str, universe_or_group) -> None:
    """Minimal PRMTOP writer (the flags :func:`parse_prmtop` consumes,
    standard card formats) — fixture generation for the offline test
    strategy (SURVEY.md §4) and a functional topology exporter for the
    AMBER toolchain."""
    ag = getattr(universe_or_group, "atoms", universe_or_group)
    top = ag._universe.topology
    idx = np.asarray(ag.indices)
    sub = top.subset(idx)
    n = len(idx)
    ri = sub.resindices
    nres = int(ri.max()) + 1 if n else 0
    starts = (np.flatnonzero(np.r_[True, ri[1:] != ri[:-1]])
              if n else np.array([], np.int64))
    labels = [str(sub.resnames[s]) for s in starts]

    def cards(vals, per, fmt):
        lines = []
        for k in range(0, len(vals), per):
            lines.append("".join(fmt(v) for v in vals[k:k + per]))
        return lines or [""]

    with open(path, "w") as fh:
        def section(flag, fortran, lines):
            fh.write(f"%FLAG {flag}\n%FORMAT({fortran})\n")
            for ln in lines:
                fh.write(ln + "\n")

        fh.write("%VERSION  VERSION_STAMP = V0001.000  "
                 # the JAX package's name: the same bytes from both
                 "(mdanalysis_mpi_tpu)\n")
        pointers = [0] * 32
        pointers[0] = n
        pointers[11] = nres
        section("POINTERS", "10I8",
                cards(pointers, 10, lambda v: f"{v:8d}"))
        section("ATOM_NAME", "20a4",
                cards([str(x)[:4] for x in sub.names], 20,
                      lambda v: f"{v:<4s}"))
        if sub.charges is not None:
            section("CHARGE", "5E16.8",
                    cards(sub.charges * AMBER_CHARGE_SCALE, 5,
                          lambda v: f"{v:16.8E}"))
        section("MASS", "5E16.8",
                cards(sub.masses, 5, lambda v: f"{v:16.8E}"))
        section("RESIDUE_LABEL", "20a4",
                cards([s[:4] for s in labels], 20, lambda v: f"{v:<4s}"))
        section("RESIDUE_POINTER", "10I8",
                cards((starts + 1).tolist(), 10, lambda v: f"{v:8d}"))
        if sub.bonds is not None and len(sub.bonds):
            # emit everything as BONDS_WITHOUT_HYDROGEN; bond-type
            # index 0 (parse ignores it)
            trip = []
            for a, b in np.asarray(sub.bonds):
                trip += [int(a) * 3, int(b) * 3, 0]
            section("BONDS_WITHOUT_HYDROGEN", "10I8",
                    cards(trip, 10, lambda v: f"{v:8d}"))


def _parse_top(path: str) -> Topology:
    """`.top` is claimed by TWO ecosystems: AMBER prmtop (upstream also
    maps .top here) and GROMACS topologies.  Sniff by content — AMBER
    card files open with %VERSION/%FLAG lines, GROMACS tops with
    directives/sections/comments."""
    with open(path) as fh:
        for ln in fh:
            if not ln.strip():
                continue
            if ln.startswith("%"):
                return parse_prmtop(path)
            from mdanalysis_mpi_tpu_torch.io.itp import parse_itp

            return parse_itp(path)
    raise ValueError(f"{path!r} is empty")


topology_files.register("prmtop", parse_prmtop)
topology_files.register("parm7", parse_prmtop)
topology_files.register("top", _parse_top)
