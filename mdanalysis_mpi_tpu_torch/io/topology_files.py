"""Topology file-format registry: path → Topology.

Dispatch point for ``Universe("prot.gro", ...)`` (RMSF.py:56 analog).
Formats register themselves via :func:`register`; parsers live in
sibling modules (``gro``, ``psf``, ``pdb``).
"""

from __future__ import annotations

import os

from mdanalysis_mpi_tpu_torch.core.topology import Topology

_PARSERS: dict[str, callable] = {}


def register(extension: str, parser) -> None:
    """Register ``parser(path) -> Topology`` for a file extension."""
    _PARSERS[extension.lower().lstrip(".")] = parser


def parse(path: str) -> Topology:
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if not ext:
        # extensionless conventions (DL_POLY's CONFIG/REVCON): the
        # basename IS the format name
        ext = os.path.basename(path).lower()
    _autoload()
    parser = _PARSERS.get(ext)
    if parser is None:
        known = ", ".join(sorted(_PARSERS)) or "(none)"
        raise ValueError(
            f"no topology parser for {ext!r} ({path}); known formats: {known}")
    return parser(path)


def _tpr(path: str) -> Topology:
    """TPR (GROMACS portable run input) — documented conversion path.

    The serial oracle's docstring opens ``mda.Universe(TPR, XTC)``
    (RMSF.py:8).  TPR is a versioned binary serialization of the whole
    run input (tpx body: full mtop, force field, integrator state)
    whose layout changes between GROMACS releases; a parser that cannot
    be validated against real files from multiple GROMACS versions
    would be worse than none.  Convert once next to your trajectory —
    every GROMACS install can do it — and open the result:

        gmx editconf -f topol.tpr -o topol.gro     # coordinates+names
        # or, for a PDB with chain ids:
        gmx editconf -f topol.tpr -o topol.pdb

    then ``Universe("topol.gro", "traj.xtc")``.
    """
    raise ValueError(
        f"TPR files are not parsed directly ({path}); convert once with "
        "'gmx editconf -f topol.tpr -o topol.gro' (or -o topol.pdb) and "
        "open the GRO/PDB — see io/topology_files.py:_tpr for why")


_autoloaded = False


def _autoload():
    """Import parser modules lazily so core has no hard format deps.
    Guarded by a flag, not ``_PARSERS`` truthiness: a format module
    imported directly self-registers before the first ``parse`` call,
    which must not suppress the remaining registrations."""
    global _autoloaded
    if _autoloaded:
        return
    _autoloaded = True
    # every topology parser here is pure Python/NumPy: an ImportError
    # is a programming error and must surface — a swallowed one would
    # unregister EVERY format and misreport "no topology parser"
    from mdanalysis_mpi_tpu_torch.io import (  # noqa: F401  (self-register)
        crd, dlpoly, dms, gro, itp, mol2, pdb, pdbqt, pqr, prmtop, psf,
        txyz)
    register("tpr", _tpr)
