"""PDB topology/coordinate parser + writer (fixed-column ATOM/HETATM
records, CRYST1 box; multi-MODEL files yield an in-memory trajectory).
Convenience format beyond the reference's GRO/XTC surface."""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files


def parse_pdb(path: str) -> Topology:
    names, resnames, segids, elements = [], [], [], []
    resids = []
    frames: list[list[list[float]]] = []
    current: list[list[float]] = []
    dims = None
    first_model_done = False
    with open(path) as fh:
        for ln in fh:
            rec = ln[:6]
            if rec == "CRYST1":
                dims = np.array([float(ln[6:15]), float(ln[15:24]),
                                 float(ln[24:33]), float(ln[33:40]),
                                 float(ln[40:47]), float(ln[47:54])],
                                dtype=np.float32)
            elif rec in ("ATOM  ", "HETATM"):
                current.append([float(ln[30:38]), float(ln[38:46]),
                                float(ln[46:54])])
                if not first_model_done:
                    names.append(ln[12:16].strip())
                    resnames.append(ln[17:21].strip())
                    resids.append(int(ln[22:26]))
                    chain = ln[21].strip()
                    segid = ln[72:76].strip() if len(ln) > 72 else ""
                    segids.append(segid or chain or "SYSTEM")
                    el = ln[76:78].strip() if len(ln) > 76 else ""
                    elements.append(el.upper())
            elif rec.startswith("ENDMDL"):
                if current:
                    frames.append(current)
                    current = []
                    first_model_done = True
    if current:
        frames.append(current)
    if not frames:
        raise ValueError(f"PDB file {path!r} contains no ATOM records")
    n = len(frames[0])
    if any(len(f) != n for f in frames):
        raise ValueError(f"PDB file {path!r}: models differ in atom count")
    top = Topology(
        names=np.array(names), resnames=np.array(resnames),
        resids=np.array(resids), segids=np.array(segids),
        elements=np.array(elements) if any(elements) else None)
    top._coordinates = np.asarray(frames, dtype=np.float32)
    top._dimensions = dims
    return top


def write_pdb(path: str, topology: Topology, coordinates: np.ndarray,
              dimensions: np.ndarray | None = None) -> None:
    """Write Å coordinates ((N,3) or (F,N,3) → MODEL records) as PDB."""
    coords = np.asarray(coordinates, dtype=np.float64)
    if coords.ndim == 2:
        coords = coords[None]
    t = topology
    with open(path, "w") as fh:
        if dimensions is not None:
            d = np.asarray(dimensions)
            fh.write("CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1\n"
                     % tuple(d[:6]))
        multi = coords.shape[0] > 1
        for f in range(coords.shape[0]):
            if multi:
                fh.write("MODEL     %4d\n" % (f + 1))
            for i in range(t.n_atoms):
                name = t.names[i][:4]
                fh.write(
                    "ATOM  %5d %-4s%1s%-4s%1s%4d%1s   %8.3f%8.3f%8.3f%6.2f%6.2f      %-4s%2s\n"
                    % ((i + 1) % 100000, name, "", t.resnames[i][:4], "",
                       t.resids[i] % 10000, "",
                       coords[f, i, 0], coords[f, i, 1], coords[f, i, 2],
                       1.0, 0.0, t.segids[i][:4], t.elements[i][:2]))
            if multi:
                fh.write("ENDMDL\n")
        fh.write("END\n")


topology_files.register("pdb", parse_pdb)
