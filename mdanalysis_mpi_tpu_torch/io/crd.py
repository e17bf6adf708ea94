"""CHARMM CRD coordinate-card parser + writer (upstream ``CRDParser``
/ ``CRDWriter``) — the standard partner of the PSF topology
(``Universe("sys.psf", "sys.crd")`` style workflows; here a CRD also
stands alone as a single-frame topology+coordinates file like GRO).

Both card layouts are handled, keyed the upstream way on the header's
``EXT`` keyword (and on the >99999-atom rule CHARMM itself uses):

- standard: ``atomno resno resname name x y z segid resid weight``
  fixed columns (I5,I5,1X,A4,1X,A4,3F10.5,1X,A4,1X,A4,F10.5)
- extended (``EXT``): i10/a8 fields with f20.10 coordinates

Title lines start with ``*``; the atom-count line ends the header.
Parsing is FIXED-COLUMN first (the layouts above — CHARMM-written
files with touching fields parse exactly), with a whitespace-token
fallback for the liberal variants other tools emit.  The per-atom
``weight`` column is NOT preserved: there is no topology field for it;
``write_crd`` emits 0.0 (or an explicit ``weights`` array).
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files


# fixed-column slices (resname, name, x, y, z, segid, resid) for the
# two card layouts: standard I5,I5,1X,A4,1X,A4,3F10.5,1X,A4,1X,A4 and
# extended I10,I10,2X,A8,2X,A8,3F20.10,2X,A8,2X,A8
_STD_COLS = ((11, 15), (16, 20), (20, 30), (30, 40), (40, 50),
             (51, 55), (56, 60))
_EXT_COLS = ((22, 30), (32, 40), (40, 60), (60, 80), (80, 100),
             (102, 110), (112, 120))


def _fields(ln: str, ext: bool):
    """One atom line → (resname, name, x, y, z, segid, resid) strings.
    Fixed columns first (CHARMM's own output parses exactly even when
    f10.5 fields touch); token split as the liberal fallback."""
    cols = _EXT_COLS if ext else _STD_COLS
    try:
        out = [ln[a:b].strip() for a, b in cols]
        float(out[2]); float(out[3]); float(out[4]); int(out[6])
        if not (out[0] and out[1]):
            raise ValueError
        return out
    except (ValueError, IndexError):
        t = ln.split()
        if len(t) < 9:
            raise ValueError(
                f"CRD atom line needs >= 9 fields (atomno resno "
                f"resname name x y z segid resid[ weight]), got "
                f"{len(t)}: {ln!r}") from None
        return [t[2], t[3], t[4], t[5], t[6], t[7], t[8]]


def parse_crd(path: str) -> Topology:
    names, resnames, segids, resids = [], [], [], []
    coords = []
    n_atoms = None
    ext = False
    with open(path) as fh:
        for lineno, raw in enumerate(fh, 1):
            ln = raw.rstrip("\n")
            if not ln.strip() or ln.lstrip().startswith("*"):
                continue
            if n_atoms is None:
                t = ln.split()
                try:
                    n_atoms = int(t[0])
                except ValueError as e:
                    raise ValueError(
                        f"{path}:{lineno}: expected the CRD atom-count "
                        f"line, got {ln!r}") from e
                ext = any(x.upper() == "EXT" for x in t[1:])
                continue
            try:
                rn, nm, x, y, z, seg, rid = _fields(ln, ext)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            resnames.append(rn)
            names.append(nm)
            coords.append([float(x), float(y), float(z)])
            segids.append(seg)
            resids.append(int(rid))
    if n_atoms is None:
        raise ValueError(f"CRD file {path!r} has no atom-count line")
    if len(names) != n_atoms:
        raise ValueError(
            f"CRD file {path!r} declares {n_atoms} atoms but carries "
            f"{len(names)}")
    top = Topology(
        names=np.array(names), resnames=np.array(resnames),
        resids=np.array(resids), segids=np.array(segids))
    top._coordinates = np.asarray(coords, np.float32)[None]
    top._dimensions = None
    return top


def write_crd(path: str, universe_or_group, extended: bool | None = None,
              weights=None) -> None:
    """Write the current frame as a CRD card.

    ``extended`` defaults to the CHARMM rule: automatic EXT when the
    system exceeds 99,999 atoms (the standard i5 field would
    overflow).  ``weights``: optional per-atom values for the weight
    column (default 0.0 — the Topology has no field for it)."""
    ag = getattr(universe_or_group, "atoms", universe_or_group)
    top = ag._universe.topology
    idx = np.asarray(ag.indices)
    pos = ag.positions
    w = (np.zeros(len(idx)) if weights is None
         else np.asarray(weights, np.float64))
    if w.shape != (len(idx),):
        raise ValueError(
            f"weights needs {len(idx)} values, got shape {w.shape}")
    if extended is None:
        extended = len(idx) > 99999
    # cumulative residue numbering across the written selection
    ri = top.resindices[idx]
    _, resno = np.unique(ri, return_inverse=True)
    with open(path, "w") as fh:
        # the JAX package's name: the same bytes from both
        fh.write("* Written by mdanalysis_mpi_tpu\n*\n")
        if extended:
            fh.write(f"{len(idx):10d}  EXT\n")
            for j, i in enumerate(idx):
                fh.write(
                    f"{j + 1:10d}{resno[j] + 1:10d}  "
                    f"{top.resnames[i]:<8s}  {top.names[i]:<8s}"
                    f"{pos[j][0]:20.10f}{pos[j][1]:20.10f}"
                    f"{pos[j][2]:20.10f}  {top.segids[i]:<8s}  "
                    f"{int(top.resids[i]):<8d}{w[j]:20.10f}\n")
        else:
            fh.write(f"{len(idx):5d}\n")
            for j, i in enumerate(idx):
                fh.write(
                    f"{j + 1:5d}{resno[j] + 1:5d} "
                    f"{top.resnames[i]:<4s} {top.names[i]:<4s}"
                    f"{pos[j][0]:10.5f}{pos[j][1]:10.5f}"
                    f"{pos[j][2]:10.5f} {top.segids[i]:<4s} "
                    f"{int(top.resids[i]):<4d}{w[j]:10.5f}\n")


topology_files.register("crd", parse_crd)
