"""PSF (CHARMM/NAMD protein structure file) topology parser + writer.

BASELINE config 1's topology format (ADK PSF/DCD).  Whitespace-delimited
sections introduced by ``<count> !<FLAG>`` headers; the ``!NATOM``
section carries ``id segid resid resname name type charge mass [imove]``
per line; ``!NBOND`` lists flat pairs of 1-based atom ids.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files


def parse_psf(path: str) -> Topology:
    with open(path) as fh:
        lines = fh.read().splitlines()
    if not lines or "PSF" not in lines[0]:
        raise ValueError(f"{path!r} is not a PSF file (missing PSF header)")
    i = 0
    natom = -1
    while i < len(lines):
        ln = lines[i]
        if "!NATOM" in ln:
            natom = int(ln.split("!")[0].strip())
            i += 1
            break
        i += 1
    if natom < 0:
        raise ValueError(f"PSF file {path!r} has no !NATOM section")
    segids = np.empty(natom, dtype="U8")
    resids = np.empty(natom, dtype=np.int64)
    resnames = np.empty(natom, dtype="U8")
    names = np.empty(natom, dtype="U8")
    charges = np.empty(natom, dtype=np.float64)
    masses = np.empty(natom, dtype=np.float64)
    for a in range(natom):
        parts = lines[i + a].split()
        if len(parts) < 8:
            raise ValueError(
                f"PSF file {path!r}: malformed atom line {i + a + 1}")
        segids[a] = parts[1]
        resids[a] = int(parts[2])
        resnames[a] = parts[3]
        names[a] = parts[4]
        charges[a] = float(parts[6])
        masses[a] = float(parts[7])
    i += natom

    def _section(flag: str, width: int, start: int):
        """Scan for ``<count> !FLAG`` from ``start``; return the
        (count, width) 0-based tuple array (or None) and the scan
        position after it."""
        j = start
        while j < len(lines):
            if flag in lines[j]:
                count = int(lines[j].split("!")[0].strip())
                flat: list[int] = []
                j += 1
                while j < len(lines) and len(flat) < width * count:
                    flat.extend(int(x) for x in lines[j].split())
                    j += 1
                arr = (np.asarray(flat[: width * count], np.int64)
                       .reshape(-1, width) - 1)
                return arr, j
            j += 1
        return None, start

    bonds, i = _section("!NBOND", 2, i)
    angles, i = _section("!NTHETA", 3, i)
    dihedrals, i = _section("!NPHI", 4, i)
    impropers, _ = _section("!NIMPHI", 4, i)
    return Topology(names=names, resnames=resnames, resids=resids,
                    segids=segids, charges=charges, masses=masses,
                    bonds=bonds, angles=angles, dihedrals=dihedrals,
                    impropers=impropers)


def write_psf(path: str, topology: Topology) -> None:
    """Minimal PSF writer (fixture generation)."""
    t = topology
    with open(path, "w") as fh:
        fh.write("PSF\n\n")
        fh.write("%8d !NTITLE\n" % 1)
        # the JAX package's remark: both packages write the same bytes
        fh.write(" REMARKS written by mdanalysis_mpi_tpu\n\n")
        fh.write("%8d !NATOM\n" % t.n_atoms)
        charges = (t.charges if t.charges is not None
                   else np.zeros(t.n_atoms))
        for i in range(t.n_atoms):
            fh.write("%8d %-4s %-4d %-4s %-4s %-4s %10.6f %13.4f %11d\n" % (
                i + 1, t.segids[i][:4], t.resids[i], t.resnames[i][:4],
                t.names[i][:4], (t.elements[i] or "X")[:4],
                charges[i], t.masses[i], 0))
        def _section(flag: str, tuples, width: int):
            arr = (tuples if tuples is not None
                   else np.empty((0, width), np.int64))
            fh.write("\n%8d !%s\n" % (len(arr), flag))
            flat = (np.asarray(arr, np.int64) + 1).ravel()
            per_line = 8 if width != 3 else 9     # whole tuples per line
            for j in range(0, len(flat), per_line):
                fh.write("".join("%8d" % x for x in flat[j:j + per_line])
                         + "\n")

        _section("NBOND: bonds", t.bonds, 2)
        _section("NTHETA: angles", t.angles, 3)
        _section("NPHI: dihedrals", t.dihedrals, 4)
        _section("NIMPHI: impropers", t.impropers, 4)


topology_files.register("psf", parse_psf)
