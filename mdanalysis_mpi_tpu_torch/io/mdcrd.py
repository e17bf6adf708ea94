"""AMBER ASCII trajectory (``mdcrd`` / ``.crdbox``; upstream
``TRJReader``).

Layout: one title line, then every frame's 3·natom coordinates
flattened in 10F8.3 fields (10 per line), optionally followed by one
3F8.3 box-lengths line per frame (``.crdbox``, or mdcrd written with
periodic boxes).  The format is self-delimiting only GIVEN natom — the
reader takes it from the Universe's topology (the registry passes it)
— and the box-per-frame question is answered by exact arithmetic:
the LINE structure must replay exactly as AMBER writes it — each
frame is ceil(3n/10) coordinate lines (all full 10-value lines, the
last carrying the remainder) optionally followed by one 3-value box
line.  Both candidate layouts are replayed against the actual lines;
the one that consumes the file exactly wins, a file fitting neither
refuses loudly, and the one truly ambiguous shape (n = 1: every line
carries 3 values whether coordinates or box) refuses with the remedy
rather than guessing.

Whole-file parse into a
:class:`~mdanalysis_mpi_tpu_torch.io.memory.MemoryReader` — the cost of an
ASCII trajectory format; convert to NetCDF for scale.  Box angles are
orthorhombic 90° (AMBER's mdcrd convention; truncated-octahedron
files carry angles nowhere and are not guessed).  A writer covers
fixtures and round trips.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.io import trajectory_files
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

_W = 8      # F8.3 field width


def _line_counts(path: str):
    """Per-line value counts + flat values (line structure is the
    disambiguator)."""
    counts: list[int] = []
    vals: list[float] = []
    with open(path) as fh:
        fh.readline()                     # title
        for ln in fh:
            ln = ln.rstrip("\n")
            c = 0
            for k in range(0, len(ln), _W):
                f = ln[k:k + _W]
                if f.strip():
                    vals.append(float(f))
                    c += 1
            if c:
                counts.append(c)
    return counts, vals


def _replays(counts, n_atoms, boxed) -> bool:
    """True iff the line-count sequence is exactly N repetitions of
    one frame's shape: full 10-value lines, a remainder line, and
    (boxed) a 3-value box line."""
    per = 3 * n_atoms
    full, rem = divmod(per, 10)
    frame = [10] * full + ([rem] if rem else [])
    if boxed:
        frame = frame + [3]
    if not frame or len(counts) % len(frame):
        return False
    k = len(frame)
    return all(counts[i] == frame[i % k] for i in range(len(counts)))


def read_mdcrd(path: str, n_atoms: int):
    """→ (coords (F, n, 3) f32, boxes (F, 6) f32 or None)."""
    if n_atoms is None or n_atoms <= 0:
        raise ValueError(
            "mdcrd needs the atom count from a topology "
            "(Universe(top, 'x.mdcrd')); the format does not carry it")
    counts, vals = _line_counts(path)
    if not counts:
        raise ValueError(
            f"{path}: no coordinate lines after the title — empty or "
            "truncated mdcrd")
    total = len(vals)
    per_plain = 3 * n_atoms
    per_boxed = per_plain + 3
    plain = _replays(counts, n_atoms, boxed=False)
    boxed = _replays(counts, n_atoms, boxed=True)
    if plain and boxed:
        # only reachable at n=1, where every line (coords or box)
        # carries exactly 3 values
        raise ValueError(
            f"{path}: ambiguous mdcrd for {n_atoms} atom(s) — every "
            "line carries 3 values whether coordinates or box; "
            "convert to NetCDF (or restart format) for 1-atom systems")
    if boxed:
        n_frames = total // per_boxed
        arr = np.asarray(vals, np.float32).reshape(n_frames, per_boxed)
        coords = arr[:, :per_plain].reshape(n_frames, n_atoms, 3)
        boxes = np.concatenate(
            [arr[:, per_plain:],
             np.full((n_frames, 3), 90.0, np.float32)], axis=1)
        return coords, boxes
    if plain:
        n_frames = total // per_plain
        return (np.asarray(vals, np.float32)
                .reshape(n_frames, n_atoms, 3)), None
    raise ValueError(
        f"{path}: line structure fits neither {n_atoms}-atom frames "
        f"({per_plain} values/frame) nor boxed frames ({per_boxed}) — "
        "wrong topology or truncated file")


def open_mdcrd(path: str, n_atoms: int | None = None) -> MemoryReader:
    coords, boxes = read_mdcrd(path, n_atoms)
    return MemoryReader(coords, dimensions=boxes)


# the JAX package's name: the same bytes from both
def write_mdcrd(path: str, frames, boxes=None, title="mdanalysis_mpi_tpu"
                ) -> None:
    """Write (F, n, 3) frames as AMBER ASCII (10F8.3; one 3F8.3 box
    line per frame when ``boxes`` is given)."""
    frames = np.asarray(frames, np.float64)

    def check(arr, what):
        # F8.3 holds [-999.999, 9999.999]: 8 chars with no separators,
        # so one overflowing value shifts every later column
        if arr.size and (arr.max() > 9999.999 or arr.min() < -999.999):
            raise ValueError(
                f"{what} out of range for the F8.3 mdcrd format "
                "(must fit [-999.999, 9999.999]); use NetCDF")

    check(frames, "coordinate")
    if boxes is not None:
        check(np.asarray(boxes, np.float64), "box length")
    with open(path, "w") as fh:
        fh.write(title + "\n")
        for f, frame in enumerate(frames):
            flat = frame.reshape(-1)
            for k in range(0, len(flat), 10):
                fh.write("".join(f"{v:8.3f}" for v in flat[k:k + 10])
                         + "\n")
            if boxes is not None:
                b = np.asarray(boxes, np.float64)
                b = b[f] if b.ndim == 2 else b
                fh.write("".join(f"{v:8.3f}" for v in b[:3]) + "\n")


for _ext in ("mdcrd", "crdbox", "trj"):
    trajectory_files.register(_ext, open_mdcrd)
