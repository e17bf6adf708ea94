"""AutoDock PDBQT parser + writer (upstream ``PDBQTParser`` /
``PDBQTWriter``).

PDB fixed columns with two extra fields per ATOM/HETATM record:
partial charge (columns 67–76, f10.4 in practice) and the AutoDock
atom type (columns 78–79).  Charges land on ``Topology.charges``; the
AutoDock type maps to the element (``OA``→O, ``NA``→N, ``HD``→H,
``A``→C aromatic, ...), falling back to name-based guessing for
unknown types.  Docking outputs carry multiple MODELs (poses) — they
become frames of an in-memory trajectory like multi-MODEL PDB.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core import tables
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files

#: AutoDock type → element (the table AutoDock4/Vina use)
AUTODOCK_ELEMENTS = {
    "A": "C", "C": "C", "N": "N", "NA": "N", "NS": "N", "OA": "O",
    "OS": "O", "O": "O", "H": "H", "HD": "H", "HS": "H", "S": "S",
    "SA": "S", "P": "P", "F": "F", "CL": "CL", "BR": "BR", "I": "I",
    "MG": "MG", "MN": "MN", "ZN": "ZN", "CA": "CA", "FE": "FE",
}


def parse_pdbqt(path: str) -> Topology:
    names, resnames, segids, resids = [], [], [], []
    charges, elements = [], []
    frames: list[list[list[float]]] = []
    current: list[list[float]] = []
    first_model_done = False
    with open(path) as fh:
        for ln in fh:
            rec = ln[:6]
            if rec in ("ATOM  ", "HETATM"):
                current.append([float(ln[30:38]), float(ln[38:46]),
                                float(ln[46:54])])
                if not first_model_done:
                    names.append(ln[12:16].strip())
                    resnames.append(ln[17:21].strip())
                    resids.append(int(ln[22:26]))
                    chain = ln[21].strip()
                    segids.append(chain or "SYSTEM")
                    charges.append(float(ln[66:76]))
                    ad = ln[77:79].strip().upper()
                    elements.append(AUTODOCK_ELEMENTS.get(ad, ""))
            elif rec.startswith("ENDMDL"):
                if current:
                    frames.append(current)
                    current = []
                    first_model_done = True
    if current:
        frames.append(current)
    if not frames:
        raise ValueError(f"PDBQT file {path!r} contains no ATOM records")
    n = len(frames[0])
    if any(len(f) != n for f in frames):
        raise ValueError(
            f"PDBQT file {path!r}: models differ in atom count")
    top = Topology(
        names=np.array(names), resnames=np.array(resnames),
        resids=np.array(resids), segids=np.array(segids),
        charges=np.array(charges),
        # per-atom fallback: unknown AutoDock types get a name-based
        # guess instead of discarding every authoritative assignment
        elements=(np.array([e or tables.guess_element(nm, rn)
                            for e, nm, rn in zip(elements, names,
                                                 resnames)])
                  if any(elements) else None))
    top._coordinates = np.asarray(frames, np.float32)
    top._dimensions = None
    return top


_ELEMENT_TO_AD = {"C": "C", "N": "N", "O": "OA", "H": "HD", "S": "SA",
                  "P": "P", "F": "F", "CL": "Cl", "BR": "Br", "I": "I"}


def write_pdbqt(path: str, universe_or_group) -> None:
    """Write the current frame as PDBQT (charges required)."""
    ag = getattr(universe_or_group, "atoms", universe_or_group)
    top = ag._universe.topology
    if top.charges is None:
        raise ValueError(
            "PDBQT output needs charges on the topology "
            "(add_TopologyAttr('charges'))")
    idx = ag.indices
    pos = ag.positions
    with open(path, "w") as fh:
        # the JAX package's name: the same bytes from both
        fh.write("REMARK  Written by mdanalysis_mpi_tpu\n")
        for serial, i in enumerate(idx, 1):
            el = str(top.elements[i]).upper()
            ad = _ELEMENT_TO_AD.get(el, el[:2] or "A")
            seg = str(top.segids[i])
            chain = seg[0] if len(seg) == 1 else " "
            # columns per the PDB/PDBQT standard: name [12:16],
            # altLoc [16], resName [17:21], chain [21], resSeq [22:26]
            fh.write(
                f"ATOM  {serial:5d} {top.names[i]:<4s} "
                f"{top.resnames[i]:<4s}{chain}{int(top.resids[i]):4d}    "
                f"{pos[serial - 1][0]:8.3f}{pos[serial - 1][1]:8.3f}"
                f"{pos[serial - 1][2]:8.3f}  1.00  0.00    "
                f"{top.charges[i]:6.3f} {ad:<2s}\n")
        fh.write("END\n")


topology_files.register("pdbqt", parse_pdbqt)
