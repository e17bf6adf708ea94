"""XYZ trajectory format (upstream ``coordinates.XYZ``).

The plain-text format: per frame, an atom-count line, a comment line,
then ``element x y z`` rows (Å).  Self-delimiting frames make chunk
concatenation valid (the TrajectoryWriter append property XTC/TRR
share).  Random access uses a one-pass byte-offset index built at open
— the text format has no seek table of its own.

No box or velocities (the format carries none); times default to the
frame index.  Comment lines are preserved on write round trips only as
the frame index (upstream writes a generated comment too).
"""

from __future__ import annotations

import os

import numpy as np

from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.io import _offsets
from mdanalysis_mpi_tpu_torch.io import trajectory_files
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase


def _scan(path: str):
    """One pass → (frame byte offsets, n_atoms), through the shared
    mtime-validated offset cache (the text format has no seek table,
    and a multi-GB XYZ must not re-scan per open/reopen — the same
    discipline as the XTC/TRR indexes)."""
    cached = _offsets.load(path)
    if cached is not None:
        return cached
    mtime = os.path.getmtime(path)     # BEFORE the scan (_offsets.save)
    offsets = []
    n_atoms = None
    with open(path, "rb") as f:
        pos = 0
        while True:
            line = f.readline()
            if not line:
                break
            stripped = line.strip()
            if not stripped:
                pos = f.tell()
                continue
            try:
                count = int(stripped)
            except ValueError:
                raise ValueError(
                    f"{path!r}: expected an atom-count line at byte "
                    f"{pos}, got {stripped[:40]!r}")
            if n_atoms is None:
                n_atoms = count
            elif count != n_atoms:
                raise ValueError(
                    f"{path!r}: frame {len(offsets)} has {count} atoms, "
                    f"previous frames {n_atoms} (variable-count XYZ is "
                    "not a trajectory)")
            offsets.append(pos)
            f.readline()                      # comment
            for _ in range(count):
                if not f.readline():
                    raise ValueError(
                        f"{path!r}: truncated frame {len(offsets) - 1}")
            pos = f.tell()
    if n_atoms is None:
        raise ValueError(f"{path!r}: empty XYZ file")
    offsets = np.asarray(offsets, np.int64)
    _offsets.save(path, offsets, n_atoms, mtime)
    return offsets, n_atoms


class XYZReader(ReaderBase):
    """Random-access XYZ reader (Å; names from the element column are
    NOT used — the topology owns identity, upstream semantics)."""

    def __init__(self, path: str, n_atoms: int | None = None):
        self._path = path
        self._offsets, self._natoms = _scan(path)
        if n_atoms is not None and n_atoms != self._natoms:
            raise ValueError(
                f"XYZ {path!r} has {self._natoms} atoms, expected "
                f"{n_atoms}")
        self._file = open(path, "rb")

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    @property
    def n_atoms(self) -> int:
        return self._natoms

    def reopen(self) -> "XYZReader":
        return XYZReader(self._path)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def _read_frame(self, i: int) -> Timestep:
        if not 0 <= i < len(self._offsets):
            raise IndexError(
                f"frame {i} out of range [0, {len(self._offsets)})")
        self._file.seek(self._offsets[i])
        self._file.readline()                 # count
        self._file.readline()                 # comment
        pos = np.empty((self._natoms, 3), np.float32)
        for a in range(self._natoms):
            parts = self._file.readline().split()
            if len(parts) < 4:
                raise ValueError(
                    f"{self._path!r}: malformed atom line in frame {i}")
            pos[a] = [float(parts[1]), float(parts[2]), float(parts[3])]
        return Timestep(pos, frame=i, time=float(i))


def write_xyz(path: str, frames: np.ndarray, names=None,
              mode: str = "w", start: int = 0) -> None:
    """Write (F, N, 3) Å coordinates as XYZ text; ``names`` (N,)
    element column (default 'X').  ``mode='a'`` appends frames (the
    chunk-concatenation property the streaming writer uses); ``start``
    offsets the comment-line frame numbering so appended chunks keep a
    monotone index."""
    frames = np.asarray(frames, np.float32)
    if frames.ndim != 3 or frames.shape[2] != 3:
        raise ValueError(f"frames must be (F, N, 3), got {frames.shape}")
    n = frames.shape[1]
    if names is None:
        names = ["X"] * n
    elif len(names) != n:
        raise ValueError(f"{len(names)} names for {n} atoms")
    with open(path, mode) as out:
        for f, frame in enumerate(frames, start=start):
            out.write(f"{n}\n")
            out.write(f"frame {f}\n")
            for nm, (x, y, z) in zip(names, frame):
                out.write(f"{nm} {x:.6f} {y:.6f} {z:.6f}\n")


trajectory_files.register("xyz", XYZReader)
