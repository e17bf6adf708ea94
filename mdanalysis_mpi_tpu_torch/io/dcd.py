"""DCD trajectory reader/writer over the native codec.

BASELINE config 1's format (PSF/DCD ADK trajectory).  CHARMM/NAMD
binary: Fortran record markers, fixed-size frames (so random access is
pure arithmetic — no offset index needed), optional per-frame unit cell.
Coordinates are already in Å.  Unit cell on disk is XTLABC order
``[A, gamma, B, beta, alpha, C]`` where angles may be stored as degrees
(NAMD) or cosines (CHARMM ≥22) — normalized on read with the standard
|x| ≤ 1 → cosine heuristic.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.io import native, trajectory_files
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase


def _cell_to_dimensions(cell: np.ndarray) -> np.ndarray:
    a, gamma, b, beta, alpha, c = (float(x) for x in cell)
    angles = []
    for ang in (alpha, beta, gamma):
        if -1.0 <= ang <= 1.0:
            ang = np.degrees(np.arccos(ang))
        angles.append(ang)
    return np.array([a, b, c] + angles, dtype=np.float32)


class DCDReader(ReaderBase):
    """Random-access DCD reader."""

    def __init__(self, path: str, n_atoms: int | None = None):
        self._path = path
        lib = native.load()
        natoms = ctypes.c_int(-1)
        has_box = ctypes.c_int(0)
        first = ctypes.c_long(0)
        fbytes = ctypes.c_long(0)
        n = lib.dcd_scan(path.encode(), ctypes.byref(natoms),
                         ctypes.byref(has_box), ctypes.byref(first),
                         ctypes.byref(fbytes))
        if n < 0:
            raise IOError(f"cannot read DCD file {path!r} (error {n})")
        self._n_frames = int(n)
        self._natoms = natoms.value
        self._has_box = bool(has_box.value)
        self._first = first.value
        self._fbytes = fbytes.value
        self._lib = lib
        if n_atoms is not None and n_atoms != self._natoms:
            raise ValueError(
                f"DCD {path!r} has {self._natoms} atoms, expected {n_atoms}")

    @property
    def n_frames(self) -> int:
        return self._n_frames

    @property
    def n_atoms(self) -> int:
        return self._natoms

    def reopen(self) -> "DCDReader":
        return DCDReader(self._path)

    def _read_range(self, idx: np.ndarray):
        n = len(idx)
        coords = np.empty((n, self._natoms, 3), dtype=np.float32)
        box = (np.empty((n, 6), dtype=np.float64) if self._has_box else None)
        rc = self._lib.dcd_read_frames(
            self._path.encode(), np.ascontiguousarray(idx, np.int64), n,
            self._natoms, int(self._has_box), self._first, self._fbytes,
            coords,
            box.ctypes.data_as(ctypes.c_void_p) if box is not None else None)
        if rc != 0:
            raise IOError(f"DCD read failed for {self._path!r} (error {rc})")
        return coords, box

    def _read_frame(self, i: int) -> Timestep:
        coords, box = self._read_range(np.array([i]))
        dims = _cell_to_dimensions(box[0]) if box is not None else None
        return Timestep(coords[0], frame=i, time=float(i), dimensions=dims)

    def frame_times(self, frames) -> np.ndarray:
        # matches _read_frame's time=float(i) so transfer_to_memory
        # preserves exactly what direct reads report
        return np.asarray(list(frames), dtype=np.float64)

    def read_block(self, start: int, stop: int, sel=None, step: int = 1):
        if self.transformations:
            # transformed reads must go through the generic
            # read-transform-gather loop (ReaderBase)
            return ReaderBase.read_block(self, start, stop, sel=sel,
                                         step=step)
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(
                f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        if start == stop:
            n = self._natoms if sel is None else len(sel)
            return np.empty((0, n, 3), np.float32), None
        coords, box = self._read_range(np.arange(start, stop, step))
        if sel is not None:
            coords = np.ascontiguousarray(coords[:, sel])
        boxes = (np.stack([_cell_to_dimensions(b) for b in box])
                 if box is not None else None)
        return coords, boxes


def write_dcd(path: str, coordinates: np.ndarray,
              dimensions: np.ndarray | None = None, dt: float = 1.0) -> None:
    """Write (n_frames, n_atoms, 3) Å coordinates as DCD (NAMD-style:
    cell angles in degrees)."""
    coords = np.ascontiguousarray(coordinates, dtype=np.float32)
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"coordinates must be (F, N, 3), got {coords.shape}")
    nframes, natoms = coords.shape[:2]
    boxp = None
    if dimensions is not None:
        dims = np.asarray(dimensions, dtype=np.float64)
        if dims.ndim == 1:
            dims = np.broadcast_to(dims, (nframes, 6))
        cell = np.empty((nframes, 6), dtype=np.float64)
        cell[:, 0] = dims[:, 0]  # A
        cell[:, 1] = dims[:, 5]  # gamma
        cell[:, 2] = dims[:, 1]  # B
        cell[:, 3] = dims[:, 4]  # beta
        cell[:, 4] = dims[:, 3]  # alpha
        cell[:, 5] = dims[:, 2]  # C
        cell = np.ascontiguousarray(cell)
        boxp = cell.ctypes.data_as(ctypes.c_void_p)
    rc = native.load().dcd_write(path.encode(), natoms, nframes, coords,
                                 boxp, ctypes.c_double(dt))
    if rc != 0:
        raise IOError(f"DCD write failed for {path!r} (error {rc})")


trajectory_files.register("dcd", DCDReader)
