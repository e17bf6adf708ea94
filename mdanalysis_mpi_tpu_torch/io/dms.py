"""Desmond DMS files (upstream ``DMSParser``) — a single-frame
topology+coordinates container stored as an SQLite database (stdlib
``sqlite3``; no external dependency).

Tables consumed: ``particle`` (id, name, resname, resid, chain/segid,
mass, charge, anum, x, y, z — ordered by id), ``bond`` (p0, p1), and
``global_cell`` (three rows spanning the cell matrix; an orthorhombic
diagonal cell maps to box lengths + 90° angles, anything else is
converted through the shared box math).  Elements derive from the
atomic number column when present.
"""

from __future__ import annotations

import os
import sqlite3

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files
from mdanalysis_mpi_tpu_torch.io.prmtop import _Z_TO_ELEMENT


def _columns(cur, table: str) -> set:
    return {r[1] for r in cur.execute(f"PRAGMA table_info({table})")}


def parse_dms(path: str) -> Topology:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as fh:
        if fh.read(15) != b"SQLite format 3":
            raise ValueError(
                f"{path!r} is not an SQLite database (not a DMS file)")
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        cur = con.cursor()
        tables = {r[0] for r in cur.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")}
        if "particle" not in tables:
            raise ValueError(
                f"{path!r} has no 'particle' table — not a Desmond DMS")
        cols = _columns(cur, "particle")
        seg_col = ("segid" if "segid" in cols
                   else "chain" if "chain" in cols else None)
        want = ["id", "name", "resname", "resid", "mass", "charge",
                "x", "y", "z"]
        missing = [c for c in want if c not in cols]
        if missing:
            raise ValueError(
                f"{path!r}: particle table lacks columns {missing}")
        opt = ([c] if (c := seg_col) else [])
        has_anum = "anum" in cols            # optional (docstring)
        has_vel = {"vx", "vy", "vz"} <= cols
        sel = ", ".join(want[1:] + opt
                        + (["anum"] if has_anum else [])
                        + (["vx", "vy", "vz"] if has_vel else []))
        rows = cur.execute(
            f"SELECT {sel} FROM particle ORDER BY id").fetchall()
        if not rows:
            raise ValueError(f"{path!r}: particle table is empty")
        arr = list(zip(*rows))
        names = np.array([str(v) for v in arr[0]])
        resnames = np.array([str(v) for v in arr[1]])
        resids = np.array(arr[2], np.int64)
        masses = np.array(arr[3], np.float64)
        charges = np.array(arr[4], np.float64)
        coords = np.stack([np.array(arr[5], np.float32),
                           np.array(arr[6], np.float32),
                           np.array(arr[7], np.float32)], axis=1)
        k = 8
        segids = None
        if seg_col:
            segids = np.array([str(v) if v else "SYSTEM"
                               for v in arr[k]])
            k += 1
        elements = None
        if has_anum:
            anum = np.array(arr[k], np.int64)
            k += 1
            if (anum > 0).any():
                elements = np.array(
                    [_Z_TO_ELEMENT.get(int(z), "X") for z in anum])
        vels = None
        if has_vel:
            vels = np.stack([np.array(arr[k], np.float32),
                             np.array(arr[k + 1], np.float32),
                             np.array(arr[k + 2], np.float32)],
                            axis=1)
        bonds = None
        if "bond" in tables:
            b = cur.execute("SELECT p0, p1 FROM bond").fetchall()
            if b:
                bonds = np.asarray(b, np.int64)
        dims = None
        if "global_cell" in tables:
            cell = np.asarray(
                cur.execute(
                    "SELECT x, y, z FROM global_cell ORDER BY id"
                ).fetchall(), np.float64)
            if cell.shape == (3, 3) and np.abs(cell).sum() > 0:
                from mdanalysis_mpi_tpu_torch.lib.mdamath import triclinic_box

                dims = np.asarray(
                    triclinic_box(cell[0], cell[1], cell[2]),
                    np.float32)
    finally:
        con.close()
    top = Topology(
        names=names, resnames=resnames, resids=resids, segids=segids,
        masses=masses, charges=charges, elements=elements, bonds=bonds)
    top._coordinates = coords[None]
    top._dimensions = dims
    if vels is not None:
        top._velocities = vels[None]
    return top


topology_files.register("dms", parse_dms)
