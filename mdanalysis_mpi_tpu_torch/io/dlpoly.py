"""DL_POLY CONFIG / REVCON / HISTORY formats (upstream
``topology.DLPolyParser`` + ``coordinates.DLPoly``).

Text layouts (DL_POLY classic & 4, positions in Å)::

    CONFIG / REVCON
        title
        levcfg imcon [natoms]
        3 cell-vector lines (Å), when imcon > 0
        per atom, 2 + levcfg lines:
            name [index [atomic-number]]
            x y z
            vx vy vz          (levcfg >= 1, Å/ps)
            fx fy fz          (levcfg >= 2)

    HISTORY
        title
        levcfg imcon natoms [nframes [nrecords]]
        per frame:
            'timestep' nstep natoms levcfg imcon dt [time]
            3 cell-vector lines, when imcon > 0
            per atom: name [index [mass [charge]]], then coordinates
            (+ velocity/force lines per levcfg)

Conventions honored: atoms are re-ordered by their DL_POLY index when
every atom record carries one (the format permits arbitrary file
order); with any index missing, file order is kept.  Triclinic cells
go through the shared ``core.box`` vector↔box math.  Writers emit
CONFIG (levcfg 0) and HISTORY fixtures for the tests — round-trip
validated, SURVEY.md §4's offline-fixture strategy.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.box import box_to_vectors, vectors_to_box
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files, trajectory_files
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader


def _read_cell(lines, i, path):
    if i + 3 > len(lines):
        raise ValueError(f"{path!r}: truncated cell block (imcon > 0 "
                         "requires 3 cell-vector lines)")
    vecs = np.array([[float(v) for v in lines[i + k].split()[:3]]
                     for k in range(3)], np.float64)
    return vectors_to_box(vecs), i + 3


def _atom_record(tok):
    """(name, index-or-None) from a DL_POLY atom record line."""
    name = tok[0]
    idx = None
    if len(tok) > 1:
        try:
            idx = int(tok[1])
        except ValueError:
            idx = None
    return name, idx


def parse_config(path: str) -> Topology:
    with open(path) as fh:
        lines = fh.read().splitlines()
    if len(lines) < 2:
        raise ValueError(f"DL_POLY CONFIG {path!r} too short")
    head = lines[1].split()
    if len(head) < 2:
        raise ValueError(
            f"DL_POLY CONFIG {path!r}: line 2 needs 'levcfg imcon'")
    levcfg, imcon = int(head[0]), int(head[1])
    if levcfg not in (0, 1, 2):
        raise ValueError(f"{path!r}: levcfg must be 0/1/2, got {levcfg}")
    declared = int(head[2]) if len(head) >= 3 else None
    i = 2
    dims = None
    if imcon > 0:
        dims, i = _read_cell(lines, i, path)
    per_atom = 2 + levcfg
    names, idxs, coords = [], [], []
    while i < len(lines):
        tok = lines[i].split()
        if not tok:
            break
        if i + per_atom > len(lines):
            raise ValueError(
                f"{path!r}: truncated atom record at line {i + 1} "
                f"(levcfg {levcfg} needs {per_atom} lines per atom)")
        name, idx = _atom_record(tok)
        names.append(name)
        idxs.append(idx)
        coords.append([float(v) for v in lines[i + 1].split()[:3]])
        i += per_atom
    n = len(names)
    if n == 0:
        raise ValueError(f"{path!r}: no atoms found")
    if declared is not None and n != declared:
        raise ValueError(
            f"{path!r}: header declares {declared} atoms, found {n} "
            "(truncated or corrupt file)")
    order = np.arange(n)
    if all(x is not None for x in idxs):
        order = np.argsort(np.asarray(idxs, np.int64), kind="stable")
    names_arr = np.asarray(names, "U8")[order]
    top = Topology(names=names_arr,
                   resnames=np.full(n, "SYS"),
                   resids=np.ones(n, np.int64))
    coords_arr = np.asarray(coords, np.float32)[order]
    top._coordinates = coords_arr[None]
    if dims is not None:
        top._dimensions = np.asarray(dims, np.float32)
    return top


class HistoryReader(MemoryReader):
    """DL_POLY HISTORY as an in-memory trajectory (whole-file parse —
    HISTORY is a plain-text archive; the staging stack then serves it
    like any MemoryReader)."""

    def __init__(self, path: str, n_atoms: int | None = None):
        with open(path) as fh:
            lines = fh.read().splitlines()
        if len(lines) < 2:
            raise ValueError(f"DL_POLY HISTORY {path!r} too short")
        head = lines[1].split()
        if len(head) < 3:
            raise ValueError(
                f"{path!r}: line 2 needs 'levcfg imcon natoms'")
        levcfg, imcon, natoms = (int(head[0]), int(head[1]),
                                 int(head[2]))
        if n_atoms is not None and natoms != n_atoms:
            raise ValueError(
                f"{path!r} has {natoms} atoms; topology has {n_atoms}")
        per_atom = 2 + levcfg
        frames, boxes, times = [], [], []
        i = 2
        while i < len(lines):
            tok = lines[i].split()
            if not tok:
                break
            if tok[0].lower() != "timestep":
                raise ValueError(
                    f"{path!r}: expected 'timestep' record at line "
                    f"{i + 1}, got {lines[i]!r}")
            if len(tok) >= 7:
                times.append(float(tok[6]))
            elif len(tok) >= 6:
                # nstep * dt when no explicit time column
                times.append(int(tok[1]) * float(tok[5]))
            i += 1
            dims = None
            if imcon > 0:
                dims, i = _read_cell(lines, i, path)
            coords = np.empty((natoms, 3), np.float32)
            idxs: list = []
            for a in range(natoms):
                if i + 1 >= len(lines):
                    raise ValueError(
                        f"{path!r}: truncated frame {len(frames)} at "
                        f"atom {a}")
                _, idx = _atom_record(lines[i].split())
                idxs.append(idx)
                coords[a] = [float(v) for v in lines[i + 1].split()[:3]]
                i += per_atom
            if all(x is not None for x in idxs):
                order = np.argsort(np.asarray(idxs, np.int64),
                                   kind="stable")
                coords = coords[order]
            frames.append(coords)
            boxes.append(dims)
        if not frames:
            raise ValueError(f"{path!r}: no frames found")
        have_box = boxes[0] is not None
        if any((b is not None) != have_box for b in boxes):
            raise ValueError(f"{path!r}: inconsistent cell records")
        dims_arr = (np.asarray(boxes, np.float32) if have_box else None)
        super().__init__(np.stack(frames), dimensions=dims_arr,
                         times=(np.asarray(times, np.float64)
                                if len(times) == len(frames) else None))
        self._path = path


def write_config(path: str, topology: Topology, coordinates: np.ndarray,
                 # the JAX package's name: the same bytes from both
                 dimensions=None, title: str = "mdanalysis_mpi_tpu"
                 ) -> None:
    """CONFIG writer (levcfg 0): fixture generator + export path."""
    coords = np.asarray(coordinates, np.float64)
    n = topology.n_atoms
    if coords.shape != (n, 3):
        raise ValueError(f"coordinates must be ({n}, 3), got "
                         f"{coords.shape}")
    imcon = 0 if dimensions is None else 3
    with open(path, "w") as fh:
        fh.write(f"{title[:72]}\n")
        fh.write(f"{0:10d}{imcon:10d}{n:10d}\n")
        if dimensions is not None:
            for v in box_to_vectors(np.asarray(dimensions, np.float64)):
                fh.write(f"{v[0]:20.10f}{v[1]:20.10f}{v[2]:20.10f}\n")
        for a in range(n):
            fh.write(f"{topology.names[a]:<8s}{a + 1:10d}\n")
            fh.write(f"{coords[a, 0]:20.10f}{coords[a, 1]:20.10f}"
                     f"{coords[a, 2]:20.10f}\n")


def write_history(path: str, topology: Topology, frames: np.ndarray,
                  dimensions=None, dt: float = 1.0,
                  # the JAX package's name: the same bytes from both
                  title: str = "mdanalysis_mpi_tpu") -> None:
    """HISTORY writer (levcfg 0) for fixtures/round-trips."""
    frames = np.asarray(frames, np.float64)
    n = topology.n_atoms
    if frames.ndim != 3 or frames.shape[1:] != (n, 3):
        raise ValueError(f"frames must be (F, {n}, 3), got "
                         f"{frames.shape}")
    imcon = 0 if dimensions is None else 3
    with open(path, "w") as fh:
        fh.write(f"{title[:72]}\n")
        fh.write(f"{0:10d}{imcon:10d}{n:10d}{len(frames):10d}\n")
        for f, frame in enumerate(frames):
            fh.write(f"timestep{f + 1:10d}{n:10d}{0:10d}{imcon:10d}"
                     f"{dt:12.6f}{(f + 1) * dt:12.4f}\n")
            if dimensions is not None:
                d = np.asarray(dimensions, np.float64)
                d = d[f] if d.ndim == 2 else d
                for v in box_to_vectors(d):
                    fh.write(f"{v[0]:20.10f}{v[1]:20.10f}"
                             f"{v[2]:20.10f}\n")
            for a in range(n):
                fh.write(f"{topology.names[a]:<8s}{a + 1:10d}\n")
                fh.write(f"{frame[a, 0]:20.10f}{frame[a, 1]:20.10f}"
                         f"{frame[a, 2]:20.10f}\n")


topology_files.register("config", parse_config)
topology_files.register("revcon", parse_config)
trajectory_files.register("history", HistoryReader)
