"""Tinker TXYZ/ARC files (upstream ``TXYZParser`` / ``TXYZReader``).

Layout per frame: a header line ``natom [title]``, optionally a
periodic-box line (6 floats — newer Tinker), then one line per atom:
``index name x y z type [bonded-indices...]`` — the trailing integers
are the 1-based bond list, giving TXYZ the rare property of carrying
BOTH coordinates and connectivity.  ``.arc`` archives repeat the
frame block; atoms/bonds come from the first frame.  Bond pairs are
deduplicated (each bond appears in both atoms' lists).
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files, trajectory_files
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader


def _is_box_line(t: list[str]) -> bool:
    """Box line = 6 floats whose last three are plausible cell angles.
    Disambiguation from an atom line: atom lines have a non-numeric
    name in field 2 and an integer index first — a 6-token line of
    pure numbers with angle-range fields 4-6 can only be a box (an
    atom line's fields 4-6 are x-coordinate/type/bond-index)."""
    if len(t) != 6:
        return False
    try:
        v = [float(x) for x in t]
    except ValueError:
        return False
    return all(0.0 < a < 180.0 for a in v[3:]) and all(
        x > 0 for x in v[:3])


def parse_txyz(path: str):
    """→ (Topology, frames (F, n, 3) f32, boxes (F, 6) or None)."""
    names: list[str] = []
    bonds: set[tuple[int, int]] = set()
    frames: list[np.ndarray] = []
    boxes: list[np.ndarray] = []
    with open(path) as fh:
        while True:
            header = fh.readline()
            if not header.strip():
                break
            t = header.split()
            try:
                natom = int(t[0])
            except ValueError as e:
                raise ValueError(
                    f"{path}: expected 'natom [title]' header, got "
                    f"{header!r}") from e
            first = not frames
            coords = np.empty((natom, 3), np.float32)
            i = 0
            while i < natom:
                ln = fh.readline()
                if not ln:
                    raise ValueError(
                        f"{path}: truncated frame ({i}/{natom} atoms)")
                t = ln.split()
                if i == 0 and _is_box_line(t):
                    # per-frame boxes (NPT archives change cell size)
                    boxes.append(np.asarray([float(x) for x in t],
                                            np.float32))
                    continue
                if len(t) < 5:
                    raise ValueError(
                        f"{path}: TXYZ atom line needs >= 5 fields: "
                        f"{ln!r}")
                coords[i] = (float(t[2]), float(t[3]), float(t[4]))
                if first:
                    names.append(t[1])
                    for b in t[6:]:
                        j = int(b) - 1
                        if j != i:
                            bonds.add((min(i, j), max(i, j)))
                i += 1
            frames.append(coords)
    if not frames:
        raise ValueError(f"{path!r} contains no frames")
    if any(len(f) != len(frames[0]) for f in frames):
        raise ValueError(f"{path!r}: frames differ in atom count")
    if boxes and len(boxes) != len(frames):
        raise ValueError(
            f"{path!r}: {len(boxes)} box lines for {len(frames)} "
            "frames (all frames or none)")
    box = np.stack(boxes) if boxes else None
    top = Topology(
        names=np.array(names),
        resnames=np.full(len(names), "MOL"),
        resids=np.ones(len(names), np.int64),
        bonds=(np.asarray(sorted(bonds), np.int64) if bonds else None))
    return top, np.stack(frames), box


def _parse_topology(path: str) -> Topology:
    top, frames, box = parse_txyz(path)
    top._coordinates = frames
    top._dimensions = box          # per-frame (F, 6) — NPT archives
    return top


def _open_trajectory(path: str, n_atoms: int | None = None) -> MemoryReader:
    _, frames, box = parse_txyz(path)
    if n_atoms is not None and frames.shape[1] != n_atoms:
        raise ValueError(
            f"{path} carries {frames.shape[1]} atoms, topology has "
            f"{n_atoms}")
    return MemoryReader(frames, dimensions=box)


def write_txyz(path: str, universe_or_group, frames=None) -> None:
    """Write frames (default: current) as TXYZ/ARC with bond lists."""
    ag = getattr(universe_or_group, "atoms", universe_or_group)
    u = ag._universe
    top = u.topology
    idx = np.asarray(ag.indices)
    pos_map = {int(a): j for j, a in enumerate(idx)}
    neigh: dict[int, list[int]] = {j: [] for j in range(len(idx))}
    if top.bonds is not None:
        for a, b in np.asarray(top.bonds):
            if int(a) in pos_map and int(b) in pos_map:
                neigh[pos_map[int(a)]].append(pos_map[int(b)] + 1)
                neigh[pos_map[int(b)]].append(pos_map[int(a)] + 1)
    frame_list = ([u.trajectory.ts.frame] if frames is None
                  else list(frames))
    with open(path, "w") as fh:
        for f in frame_list:
            pos = u.trajectory[f].positions[idx]
            # the JAX package's name: the same bytes from both
            fh.write(f"{len(idx):6d}  mdanalysis_mpi_tpu\n")
            for j, i in enumerate(idx):
                nb = "".join(f"{v:6d}" for v in sorted(neigh[j]))
                fh.write(
                    f"{j + 1:6d}  {top.names[i]:<4s}"
                    f"{pos[j][0]:12.6f}{pos[j][1]:12.6f}"
                    f"{pos[j][2]:12.6f}{1:6d}{nb}\n")


topology_files.register("txyz", _parse_topology)
topology_files.register("arc", _parse_topology)
trajectory_files.register("arc", _open_trajectory)
trajectory_files.register("txyz", _open_trajectory)
