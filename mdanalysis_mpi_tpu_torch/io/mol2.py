"""TRIPOS MOL2 topology/coordinate parser + writer (upstream
``MOL2Parser`` / ``MOL2Reader``/``MOL2Writer``).

Sections handled: ``@<TRIPOS>MOLECULE`` (repeated blocks become an
in-memory trajectory, upstream's multi-frame MOL2 semantics — atom
counts must agree), ``@<TRIPOS>ATOM`` (id name x y z sybyl_type
[subst_id [subst_name [charge]]]) and ``@<TRIPOS>BOND`` (bond graph —
order tokens ``1/2/3/am/ar/du/un/nc`` are accepted and discarded; the
Topology stores connectivity only, like the PSF path).  Elements
derive from the SYBYL type's element part (``C.3`` → C, ``N.ar`` → N);
``subst_name``/``subst_id`` map to resname/resid with the trailing
digits upstream strips (``ALA1`` → ALA) removed when the name embeds
the id.  Charges land on ``Topology.charges`` unless the charge type
is ``NO_CHARGES``.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io import topology_files

_BOND_ORDERS = {"1", "2", "3", "am", "ar", "du", "un", "nc"}


def _split_sections(path: str):
    """Yield one dict of section-name → line-list per MOLECULE block."""
    current: dict[str, list[str]] | None = None
    section: list[str] | None = None
    with open(path) as fh:
        for raw in fh:
            ln = raw.rstrip("\n")
            if ln.startswith("#"):
                continue
            if ln.upper().startswith("@<TRIPOS>"):
                name = ln[9:].strip().upper()
                if name == "MOLECULE":
                    if current is not None:
                        yield current
                    current = {}
                if current is None:
                    raise ValueError(
                        f"{path}: section @<TRIPOS>{name} before any "
                        "MOLECULE record")
                section = current.setdefault(name, [])
                section_name = name
                continue
            # MOLECULE keeps blank lines: its records are POSITIONAL
            # (name / counts / mol_type / charge_type) and a blank
            # molecule name (common obabel output) must not shift the
            # charge-type line
            if section is not None and (ln.strip()
                                        or section_name == "MOLECULE"):
                section.append(ln)
    if current is not None:
        yield current


def parse_mol2(path: str) -> Topology:
    names, resnames, resids, elements, charges = [], [], [], [], []
    bonds: list[tuple[int, int]] = []
    frames: list[np.ndarray] = []
    no_charges = False
    for imol, mol in enumerate(_split_sections(path)):
        atoms = mol.get("ATOM")
        if not atoms:
            raise ValueError(
                f"{path}: MOLECULE block {imol} has no @<TRIPOS>ATOM")
        header = mol.get("MOLECULE", [])
        if imol == 0:
            # charge semantics come from block 0 (the block whose
            # charges are stored); later blocks' headers are not
            # consulted — a disagreeing charge_type cannot
            # retroactively null or fabricate charges
            no_charges = (len(header) >= 4 and
                          header[3].strip().upper() == "NO_CHARGES")
        coords = np.empty((len(atoms), 3), np.float32)
        for j, ln in enumerate(atoms):
            t = ln.split()
            if len(t) < 6:
                raise ValueError(
                    f"{path}: ATOM line needs >= 6 fields: {ln!r}")
            coords[j] = (float(t[2]), float(t[3]), float(t[4]))
            if imol == 0:
                name = t[1]
                sybyl = t[5]
                subst_id = int(t[6]) if len(t) > 6 else 1
                subst_name = t[7] if len(t) > 7 else "MOL"
                q = float(t[8]) if len(t) > 8 else 0.0
                names.append(name)
                resids.append(subst_id)
                # upstream strips the residue number glued to the
                # substructure name ONLY when it IS the subst_id
                # (ALA1 with subst_id 1 -> ALA; HIS2 with subst_id 1
                # stays HIS2)
                stripped = subst_name.rstrip("0123456789")
                resnames.append(
                    stripped if stripped
                    and stripped + str(subst_id) == subst_name
                    else subst_name)
                elements.append(sybyl.split(".")[0].capitalize())
                charges.append(q)
        if imol == 0:
            for ln in mol.get("BOND", []):
                t = ln.split()
                if len(t) < 4 or (t[3].lower() not in _BOND_ORDERS
                                  and not t[3].isdigit()):
                    raise ValueError(
                        f"{path}: unparseable BOND line {ln!r}")
                bonds.append((int(t[1]) - 1, int(t[2]) - 1))
        elif len(coords) != len(names):
            raise ValueError(
                f"{path}: MOLECULE block {imol} has {len(coords)} atoms, "
                f"first block has {len(names)} (multi-frame MOL2 needs "
                "identical molecules)")
        frames.append(coords)
    if not frames:
        raise ValueError(f"{path!r} contains no MOLECULE records")
    top = Topology(
        names=np.array(names), resnames=np.array(resnames),
        resids=np.array(resids), elements=np.array(elements),
        charges=None if no_charges else np.array(charges),
        bonds=np.asarray(bonds, np.int64) if bonds else None)
    top._coordinates = np.stack(frames)
    top._dimensions = None
    return top


def write_mol2(path: str, universe_or_group, frames=None) -> None:
    """Write one MOLECULE block per frame (current frame by default).

    Bonds internal to the written selection are emitted with order
    ``1`` (connectivity is what the Topology stores); charges default
    to 0 with ``NO_CHARGES`` declared when the topology has none."""
    ag = getattr(universe_or_group, "atoms", universe_or_group)
    u = ag._universe
    top = u.topology
    idx = np.asarray(ag.indices)
    pos_map = {int(a): j for j, a in enumerate(idx)}
    sub_bonds = []
    if top.bonds is not None:
        for a, b in np.asarray(top.bonds):
            if int(a) in pos_map and int(b) in pos_map:
                sub_bonds.append((pos_map[int(a)], pos_map[int(b)]))
    charge_type = "NO_CHARGES" if top.charges is None else "USER_CHARGES"
    frame_list = ([u.trajectory.ts.frame] if frames is None
                  else list(frames))
    with open(path, "w") as fh:
        for f in frame_list:
            pos = u.trajectory[f].positions[idx]
            fh.write("@<TRIPOS>MOLECULE\n")
            # the JAX package's name: the same bytes from both
            fh.write("mdanalysis_mpi_tpu\n")
            fh.write(f"{len(idx)} {len(sub_bonds)} "
                     f"{len(np.unique(top.resindices[idx]))} 0 0\n")
            fh.write("SMALL\n")
            fh.write(f"{charge_type}\n")
            fh.write("@<TRIPOS>ATOM\n")
            for j, i in enumerate(idx, 1):
                el = str(top.elements[i]) or "Du"
                q = 0.0 if top.charges is None else float(top.charges[i])
                fh.write(
                    f"{j:7d} {top.names[i]:<6s} "
                    f"{pos[j - 1][0]:11.4f} {pos[j - 1][1]:11.4f} "
                    f"{pos[j - 1][2]:11.4f} {el:<5s} "
                    f"{int(top.resids[i]):5d} "
                    f"{top.resnames[i]:<6s} "
                    f"{q:9.4f}\n")
            fh.write("@<TRIPOS>BOND\n")
            for k, (a, b) in enumerate(sub_bonds, 1):
                fh.write(f"{k:6d} {a + 1:6d} {b + 1:6d} 1\n")


topology_files.register("mol2", parse_mol2)
