"""PQR topology/coordinate parser + writer (upstream ``PQRParser`` /
``PQRWriter``; the APBS/pdb2pqr format).

PQR is "PDB with charge and radius": whitespace-separated ATOM/HETATM
records whose last two fields are the partial charge (e) and atomic
radius (Å).  Both token layouts in the wild are accepted, matching
upstream's flexible parser:

- ``ATOM serial name resName     resSeq x y z charge radius`` (10)
- ``ATOM serial name resName chn resSeq x y z charge radius`` (11,
  pdb2pqr ``--whitespace`` with chain ids; the chain becomes segid)

Insertion codes glued to resSeq (``52A``) are handled the upstream way
(digits prefix → resid).  Parsed charges/radii land on the
:class:`~mdanalysis_mpi_tpu_torch.core.topology.Topology` (``ag.charges``,
``ag.radii``, ``prop charge`` / ``prop radius`` selections);
coordinates form a single-frame in-memory trajectory, like the other
single-structure formats (GRO/PDB path of RMSF.py:56).
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files


def _resid(tok: str) -> int:
    """resSeq token, tolerating a glued insertion code ('52A' → 52)."""
    digits = ""
    for c in tok:
        if c.isdigit() or (c == "-" and not digits):
            digits += c
        else:
            break
    if not digits:
        raise ValueError(f"unparseable PQR resSeq field {tok!r}")
    return int(digits)


def parse_pqr(path: str) -> Topology:
    names, resnames, segids, resids = [], [], [], []
    charges, radii, coords = [], [], []
    with open(path) as fh:
        for lineno, ln in enumerate(fh, 1):
            if not ln.startswith(("ATOM", "HETATM")):
                continue
            t = ln.split()
            if len(t) == 10:
                chain = ""
                (_rec, _serial, name, resname, resseq,
                 x, y, z, q, r) = t
            elif len(t) == 11:
                (_rec, _serial, name, resname, chain, resseq,
                 x, y, z, q, r) = t
            else:
                raise ValueError(
                    f"{path}:{lineno}: PQR ATOM record needs 10 or 11 "
                    f"whitespace-separated fields, got {len(t)}")
            names.append(name)
            resnames.append(resname)
            segids.append(chain or "SYSTEM")
            resids.append(_resid(resseq))
            coords.append([float(x), float(y), float(z)])
            charges.append(float(q))
            radii.append(float(r))
    if not names:
        raise ValueError(f"PQR file {path!r} contains no ATOM records")
    top = Topology(
        names=np.array(names), resnames=np.array(resnames),
        resids=np.array(resids), segids=np.array(segids),
        charges=np.array(charges), radii=np.array(radii))
    top._coordinates = np.asarray(coords, np.float32)[None]
    top._dimensions = None
    return top


def write_pqr(path: str, universe_or_group) -> None:
    """Write the current frame as PQR (chain layout iff segids are
    single characters, upstream-style; otherwise the 10-field form)."""
    ag = getattr(universe_or_group, "atoms", universe_or_group)
    top = ag._universe.topology
    if top.charges is None or top.radii is None:
        raise ValueError(
            "PQR output needs charges AND radii on the topology "
            "(add_TopologyAttr('charges'/'radii'))")
    idx = ag.indices
    pos = ag.positions
    with open(path, "w") as fh:
        # the JAX package's name: the same bytes from both
        fh.write("REMARK   1 Written by mdanalysis_mpi_tpu\n")
        for serial, i in enumerate(idx, 1):
            seg = str(top.segids[i])
            chain = f"{seg} " if len(seg) == 1 else ""
            fh.write(
                f"ATOM {serial:6d} {top.names[i]:<4s} {top.resnames[i]:<4s} "
                f"{chain}{int(top.resids[i]):4d}   "
                f"{pos[serial - 1][0]:8.3f} {pos[serial - 1][1]:8.3f} "
                f"{pos[serial - 1][2]:8.3f} "
                f"{top.charges[i]:7.4f} {top.radii[i]:6.4f}\n")
        fh.write("END\n")


topology_files.register("pqr", parse_pqr)
