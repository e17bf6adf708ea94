"""AMBER ASCII restart / coordinate files (upstream ``INPCRDReader``):
``.inpcrd`` / ``.restrt`` / ``.rst7``.

Layout (FORTRAN formatted): title line; ``natom [time]`` line; the
coordinate block in 6F12.7 (two atoms per line); then optionally a
velocity block of the same shape and/or one final 6F12.7 box line
(lengths + angles).  The trailing-block ambiguity is resolved the way
AMBER writes them: after the coordinates, 3·natom remaining values are
velocities, 6 are a box, 3·natom+6 are both (a lone box line is never
mistaken for velocities unless natom == 2, where AMBER's own layout is
ambiguous — resolved as velocities+nothing vs box by the exact
count).  Parses into a single-frame
:class:`~mdanalysis_mpi_tpu_torch.io.memory.MemoryReader`, so the whole
staging stack applies; a writer covers fixtures and restart export.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.io import trajectory_files
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

_W = 12     # F12.7 field width


def _fields(ln: str):
    return [float(ln[k:k + _W]) for k in range(0, len(ln.rstrip("\n")), _W)
            if ln[k:k + _W].strip()]


def read_inpcrd(path: str):
    """→ (coords (natom, 3) f32, velocities or None, box6 or None)."""
    with open(path) as fh:
        lines = fh.readlines()
    if len(lines) < 2:
        raise ValueError(f"{path!r} is not an AMBER restart (too short)")
    head = lines[1].split()
    try:
        natom = int(head[0])
    except (ValueError, IndexError) as e:
        raise ValueError(
            f"{path}: expected 'natom [time]' on line 2, got "
            f"{lines[1]!r}") from e
    vals: list[float] = []
    for ln in lines[2:]:
        if ln.strip():
            vals.extend(_fields(ln))
    need = 3 * natom
    if len(vals) < need:
        raise ValueError(
            f"{path}: {natom} atoms need {need} coordinates, file "
            f"carries {len(vals)}")
    coords = np.asarray(vals[:need], np.float32).reshape(natom, 3)
    rest = vals[need:]
    vels = None
    box = None
    if len(rest) == need + 6:
        vels = np.asarray(rest[:need], np.float32).reshape(natom, 3)
        box = np.asarray(rest[need:], np.float32)
    elif len(rest) == need and need != 6:
        vels = np.asarray(rest, np.float32).reshape(natom, 3)
    elif len(rest) == 6:
        box = np.asarray(rest, np.float32)
    elif len(rest) != 0:
        raise ValueError(
            f"{path}: {len(rest)} trailing values fit neither a "
            f"velocity block ({need}) nor a box (6) nor both")
    return coords, vels, box


def open_inpcrd(path: str, n_atoms: int | None = None) -> MemoryReader:
    coords, vels, box = read_inpcrd(path)
    if n_atoms is not None and n_atoms != len(coords):
        raise ValueError(
            f"{path} carries {len(coords)} atoms, topology has {n_atoms}")
    return MemoryReader(
        coords[None], dimensions=box,
        velocities=None if vels is None else vels[None])


def write_inpcrd(path: str, universe_or_group, velocities=None,
                 time: float | None = None) -> None:
    """Write the current frame as an AMBER ASCII restart."""
    ag = getattr(universe_or_group, "atoms", universe_or_group)
    pos = np.asarray(ag.positions, np.float64)
    ts = ag._universe.trajectory.ts
    box = ts.dimensions

    def block(fh, arr):
        flat = arr.reshape(-1)
        if len(flat) and (np.abs(flat).max() >= 1e5
                          or flat.min() <= -1e4):
            # F12.7 holds [-9999.99..., 99999.99...]; an overflowing
            # value would shift every later column and corrupt the file
            raise ValueError(
                "value out of range for the AMBER F12.7 restart "
                f"format (|max| {np.abs(flat).max():.6g}); wrap or "
                "rescale coordinates first")
        for k in range(0, len(flat), 6):
            fh.write("".join(f"{v:12.7f}" for v in flat[k:k + 6]) + "\n")

    with open(path, "w") as fh:
        # the JAX package's name: the same bytes from both
        fh.write("generated by mdanalysis_mpi_tpu\n")
        fh.write(f"{len(pos):5d}" + (f"{time:15.7e}" if time is not None
                                     else "") + "\n")
        block(fh, pos)
        if velocities is not None:
            v = np.asarray(velocities, np.float64)
            if v.shape != pos.shape:
                raise ValueError(
                    f"velocities shape {v.shape} != positions {pos.shape}")
            block(fh, v)
        if box is not None:
            block(fh, np.asarray(box, np.float64))


for _ext in ("inpcrd", "restrt", "rst7"):
    trajectory_files.register(_ext, open_inpcrd)
