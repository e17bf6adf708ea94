"""LAMMPS dump trajectory format (upstream ``coordinates.LAMMPS``,
``.lammpsdump``/``.dump``).

The text format: per frame, ``ITEM: TIMESTEP`` / ``ITEM: NUMBER OF
ATOMS`` / ``ITEM: BOX BOUNDS`` / ``ITEM: ATOMS <columns>`` blocks.
Dumps are frequently UNORDERED (atom rows in arbitrary order), so rows
are sorted by the ``id`` column before they become positions — the
silent-misorder hazard upstream also guards.

Coordinate variants (the ATOMS header declares which): ``x y z``
(wrapped), ``xu yu zu`` (unwrapped — used as-is), ``xs ys zs`` (scaled
— mapped through the box: ``x = xlo + xs·lx``).  Orthogonal boxes
only; triclinic ``BOX BOUNDS xy xz yz`` dumps refuse loudly rather
than silently mis-converting the tilt.

Random access via the shared mtime-validated offset cache (the text
format has no seek table), like XYZ/TRR.
"""

from __future__ import annotations

import os

import numpy as np

from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.io import _offsets, trajectory_files
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase


def _scan(path: str):
    """Byte offset of each ``ITEM: TIMESTEP`` + the atom count."""
    cached = _offsets.load(path)
    if cached is not None:
        return cached
    mtime = os.path.getmtime(path)
    offsets = []
    n_atoms = None
    with open(path, "rb") as f:
        pos = 0
        line = f.readline()
        while line:
            if line.startswith(b"ITEM: TIMESTEP"):
                offsets.append(pos)
            elif line.startswith(b"ITEM: NUMBER OF ATOMS"):
                count = int(f.readline())
                if n_atoms is None:
                    n_atoms = count
                elif count != n_atoms:
                    raise ValueError(
                        f"{path!r}: frame {len(offsets) - 1} has "
                        f"{count} atoms, previous frames {n_atoms}")
            pos = f.tell()
            line = f.readline()
    if not offsets or n_atoms is None:
        raise ValueError(f"{path!r}: no LAMMPS dump frames found")
    offsets = np.asarray(offsets, np.int64)
    _offsets.save(path, offsets, n_atoms, mtime)
    return offsets, n_atoms


class LAMMPSDumpReader(ReaderBase):
    """Random-access LAMMPS dump reader (id-sorted positions, Å
    assumed — LAMMPS units are simulation-defined, upstream caveat)."""

    def __init__(self, path: str, n_atoms: int | None = None):
        self._path = path
        self._offsets, self._natoms = _scan(path)
        if n_atoms is not None and n_atoms != self._natoms:
            raise ValueError(
                f"LAMMPS dump {path!r} has {self._natoms} atoms, "
                f"expected {n_atoms}")
        self._file = open(path, "rb")

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    @property
    def n_atoms(self) -> int:
        return self._natoms

    def reopen(self) -> "LAMMPSDumpReader":
        return LAMMPSDumpReader(self._path)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def _read_frame(self, i: int) -> Timestep:
        if not 0 <= i < len(self._offsets):
            raise IndexError(
                f"frame {i} out of range [0, {len(self._offsets)})")
        f = self._file
        f.seek(self._offsets[i])
        line = f.readline()
        if not line.startswith(b"ITEM: TIMESTEP"):
            # explicit raise, never assert: the readline is a file-
            # advancing side effect that python -O must not strip
            raise ValueError(
                f"{self._path!r}: frame {i} offset does not start at "
                "ITEM: TIMESTEP (stale index? delete the offset cache)")
        step = int(f.readline())
        line = f.readline()
        if not line.startswith(b"ITEM: NUMBER OF ATOMS"):
            raise ValueError(
                f"{self._path!r}: frame {i} lacks NUMBER OF ATOMS")
        n = int(f.readline())
        line = f.readline()
        if not line.startswith(b"ITEM: BOX BOUNDS"):
            raise ValueError(
                f"{self._path!r}: frame {i} lacks BOX BOUNDS")
        if b"xy" in line or b"xz" in line or b"yz" in line:
            raise ValueError(
                f"{self._path!r}: triclinic BOX BOUNDS (tilt factors) "
                "are not supported — orthogonal dumps only")
        bounds = np.array([[float(v) for v in f.readline().split()[:2]]
                           for _ in range(3)])
        lengths = bounds[:, 1] - bounds[:, 0]
        line = f.readline()
        if not line.startswith(b"ITEM: ATOMS"):
            raise ValueError(
                f"{self._path!r}: frame {i} lacks an ATOMS block")
        cols = line.split()[2:]
        cols = [c.decode() for c in cols]

        if "id" not in cols:
            raise ValueError(
                f"{self._path!r}: ATOMS block has no id column "
                f"(columns: {cols}) — unordered rows cannot be placed")
        id_col = cols.index("id")

        def cols3(names):
            js = [cols.index(c) for c in names if c in cols]
            return js if len(js) == 3 else None

        mode, idx = "plain", cols3(("x", "y", "z"))
        if idx is None:
            mode, idx = "unwrapped", cols3(("xu", "yu", "zu"))
        if idx is None:
            mode, idx = "scaled", cols3(("xs", "ys", "zs"))
        if idx is None:
            raise ValueError(
                f"{self._path!r}: ATOMS columns {cols} carry no "
                "x y z / xu yu zu / xs ys zs coordinates")
        ids = np.empty(n, np.int64)
        xyz = np.empty((n, 3), np.float64)
        for a in range(n):
            parts = f.readline().split()
            if len(parts) < len(cols):
                raise ValueError(
                    f"{self._path!r}: truncated ATOMS row in frame {i}")
            ids[a] = int(parts[id_col])
            xyz[a] = [float(parts[j]) for j in idx]
        order = np.argsort(ids, kind="stable")
        xyz = xyz[order]
        if mode == "scaled":
            xyz = bounds[:, 0] + xyz * lengths
        dims = np.array([lengths[0], lengths[1], lengths[2],
                         90.0, 90.0, 90.0], np.float32)
        return Timestep(xyz.astype(np.float32), frame=i,
                        time=float(step), dimensions=dims)


def write_lammpsdump(path: str, frames: np.ndarray, dimensions=None,
                     steps=None, mode: str = "w") -> None:
    """Write (F, N, 3) coordinates as an orthogonal LAMMPS dump
    (``id type x y z`` rows, ids 1..N)."""
    frames = np.asarray(frames, np.float64)
    if frames.ndim != 3 or frames.shape[2] != 3:
        raise ValueError(f"frames must be (F, N, 3), got {frames.shape}")
    f_count, n, _ = frames.shape
    if dimensions is None:
        lo = frames.min(axis=(0, 1)) - 1.0
        hi = frames.max(axis=(0, 1)) + 1.0
    else:
        dimensions = np.asarray(dimensions, np.float64).reshape(6)
        if not np.all(np.abs(dimensions[3:] - 90.0) < 1e-6):
            raise ValueError(
                "write_lammpsdump supports orthogonal boxes only")
        lo = np.zeros(3)
        hi = dimensions[:3]
    if steps is None:
        steps = np.arange(f_count)
    with open(path, mode) as out:
        for f, frame in enumerate(frames):
            out.write("ITEM: TIMESTEP\n")
            out.write(f"{int(steps[f])}\n")
            out.write("ITEM: NUMBER OF ATOMS\n")
            out.write(f"{n}\n")
            out.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                out.write(f"{lo[d]:.6f} {hi[d]:.6f}\n")
            out.write("ITEM: ATOMS id type x y z\n")
            for a, (x, y, z) in enumerate(frame, start=1):
                out.write(f"{a} 1 {x:.6f} {y:.6f} {z:.6f}\n")


trajectory_files.register("lammpsdump", LAMMPSDumpReader)
trajectory_files.register("dump", LAMMPSDumpReader)
trajectory_files.register("lammpstrj", LAMMPSDumpReader)
