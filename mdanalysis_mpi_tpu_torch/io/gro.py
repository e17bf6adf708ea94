"""GRO (GROMACS) topology/coordinate file parser + writer.

The reference's topology source (``mda.Universe(GRO, XTC)``, RMSF.py:56;
GRO fixture imported at RMSF.py:34).  Fixed-column format::

    title
    natoms
    %5d%-5s%5s%5d%8.3f%8.3f%8.3f[%8.4f%8.4f%8.4f]   (resid resname name
                                                     atomid x y z [v])
    box: lx ly lz [v1y v1z v2x v2z v3x v3y]          (free format, nm)

Coordinates are nm on disk; the framework uses Å.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.box import vectors_to_box, box_to_vectors
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files

_NM_TO_A = 10.0


def parse_gro(path: str) -> Topology:
    with open(path) as fh:
        lines = fh.read().splitlines()
    if len(lines) < 3:
        raise ValueError(f"GRO file {path!r} too short")
    try:
        n = int(lines[1].strip())
    except ValueError as e:
        raise ValueError(f"GRO file {path!r}: bad atom count line") from e
    if len(lines) < n + 3:
        raise ValueError(
            f"GRO file {path!r}: expected {n} atom lines, found {len(lines) - 3}")
    resids = np.empty(n, dtype=np.int64)
    resnames = np.empty(n, dtype="U5")
    names = np.empty(n, dtype="U5")
    coords = np.empty((n, 3), dtype=np.float32)
    # optional velocity columns (chars 44-68, nm/ps): present on every
    # atom line or treated as absent (the format is all-or-nothing)
    vels = np.zeros((n, 3), dtype=np.float32)
    have_vels = True
    for i in range(n):
        ln = lines[i + 2]
        resids[i] = int(ln[0:5])
        resnames[i] = ln[5:10].strip()
        names[i] = ln[10:15].strip()
        coords[i, 0] = float(ln[20:28])
        coords[i, 1] = float(ln[28:36])
        coords[i, 2] = float(ln[36:44])
        if have_vels and len(ln.rstrip()) >= 68:
            vels[i, 0] = float(ln[44:52])
            vels[i, 1] = float(ln[52:60])
            vels[i, 2] = float(ln[60:68])
        else:
            have_vels = False
    coords *= _NM_TO_A

    box_fields = [float(x) for x in lines[n + 2].split()]
    dims = None
    if box_fields and any(box_fields):
        m = np.zeros((3, 3))
        m[0, 0], m[1, 1], m[2, 2] = box_fields[:3]
        if len(box_fields) >= 9:
            (m[0, 1], m[0, 2], m[1, 0],
             m[1, 2], m[2, 0], m[2, 1]) = box_fields[3:9]
        dims = vectors_to_box(m * _NM_TO_A)

    top = Topology(names=names, resnames=resnames, resids=resids)
    top._coordinates = coords[None]       # single-frame fallback trajectory
    top._dimensions = dims
    # Å/ps, the upstream Timestep convention (nm/ps in the file)
    top._velocities = vels[None] * _NM_TO_A if have_vels else None
    return top


def write_gro(path: str, topology: Topology, coordinates: np.ndarray,
              dimensions: np.ndarray | None = None,
              velocities: np.ndarray | None = None,
              title: str = "written by mdanalysis_mpi_tpu") -> None:
    """Write one frame of Å coordinates (and optional Å/ps velocities)
    as a GRO file (fixture writer).  The default title is the JAX
    package's, so both packages write the same bytes."""
    coords = np.asarray(coordinates, dtype=np.float64) / _NM_TO_A
    if coords.ndim == 3:
        coords = coords[0]
    n = topology.n_atoms
    if coords.shape != (n, 3):
        raise ValueError(f"coordinates must be ({n}, 3), got {coords.shape}")
    if velocities is not None:
        velocities = np.asarray(velocities, dtype=np.float64) / _NM_TO_A
        if velocities.ndim == 3:
            velocities = velocities[0]
        if velocities.shape != (n, 3):
            raise ValueError(
                f"velocities must be ({n}, 3), got {velocities.shape}")
    with open(path, "w") as fh:
        fh.write(title + "\n")
        fh.write(f"{n:5d}\n")
        for i in range(n):
            line = "%5d%-5s%5s%5d%8.3f%8.3f%8.3f" % (
                topology.resids[i] % 100000, topology.resnames[i][:5],
                topology.names[i][:5], (i + 1) % 100000,
                coords[i, 0], coords[i, 1], coords[i, 2])
            if velocities is not None:
                line += "%8.4f%8.4f%8.4f" % tuple(velocities[i])
            fh.write(line + "\n")
        if dimensions is None:
            fh.write("   0.00000   0.00000   0.00000\n")
        else:
            m = box_to_vectors(np.asarray(dimensions)) / _NM_TO_A
            off = (m[0, 1], m[0, 2], m[1, 0], m[1, 2], m[2, 0], m[2, 1])
            if any(abs(x) > 1e-9 for x in off):
                fh.write(("%10.5f" * 9 + "\n") % (
                    m[0, 0], m[1, 1], m[2, 2], *off))
            else:
                fh.write("%10.5f%10.5f%10.5f\n" % (m[0, 0], m[1, 1], m[2, 2]))


topology_files.register("gro", parse_gro)
