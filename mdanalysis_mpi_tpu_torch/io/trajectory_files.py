"""Trajectory file-format registry: path → Reader.

Dispatch point for ``Universe(top, "traj.xtc")`` (RMSF.py:56 analog).
Formats register via :func:`register`; readers live in sibling modules
(``xtc``, ``dcd``, ``trr``, ``netcdf``, ``xyz``, ...).  A directory
opens as an ingested block store and an ``http(s)://`` URL as a remote
one (``io/store``), ahead of the extension registry.
"""

from __future__ import annotations

import os

_READERS: dict[str, callable] = {}


def register(extension: str, opener) -> None:
    """Register ``opener(path, n_atoms=...) -> ReaderBase``."""
    _READERS[extension.lower().lstrip(".")] = opener


def open(path: str, n_atoms: int | None = None):
    if isinstance(path, str) and \
            path.startswith(("http://", "https://")):
        # a remote chunk-store URL opens wherever a trajectory path is
        # accepted, exactly like the store-directory branch below:
        # "http://host:port/stores/NAME?mirror=..." and every read
        # rides the hardened HTTP boundary (io/store/remote.py)
        from mdanalysis_mpi_tpu_torch.io.store.remote import (
            open_remote_store)

        return open_remote_store(path, n_atoms=n_atoms)
    if os.path.isdir(path):
        # an ingested block store opens wherever a trajectory path is
        # accepted (Universe(top, store_dir)), so "prefer the store" is
        # just a path swap for every caller.  Opened directly (no
        # pre-sniff: that would parse the O(chunks) manifest twice); a
        # CORRUPT manifest surfaces as its typed StoreCorruptError.
        from mdanalysis_mpi_tpu_torch.io.store import StoreReader

        try:
            return StoreReader(path, n_atoms=n_atoms)
        except FileNotFoundError as exc:
            raise ValueError(
                f"{path!r} is a directory but not an ingested block "
                f"store (no valid manifest.json); ingest it first with "
                f"mdanalysis_mpi_tpu_torch.io.store.ingest(trajectory, "
                f"store_dir)") from exc
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if not ext:
        # extensionless conventions (DL_POLY's HISTORY): the basename
        # IS the format name
        ext = os.path.basename(path).lower()
    _autoload()
    opener = _READERS.get(ext)
    if opener is None:
        known = ", ".join(sorted(_READERS)) or "(none)"
        raise ValueError(
            f"no trajectory reader for {ext!r} ({path}); known formats: {known}")
    return opener(path, n_atoms=n_atoms)


def _unavailable(fmt: str, why: str, recipe: str):
    def opener(path: str, n_atoms=None):
        raise ValueError(
            f"{fmt} files are not supported ({path}): {why}. {recipe}")

    return opener


# H5MD/GSD/TNG/TRZ are closed by decision (registered with their
# conversion recipes in _autoload): their container libraries (h5py /
# gsd / pytng) are not dependencies, and a from-scratch binary
# container parser validated only against self-written bytes would be
# circular (the TPR rationale, io/topology_files.py:_tpr).
_autoloaded = False


def _autoload():
    """Guarded by a flag, not ``_READERS`` truthiness: a format module
    imported directly (e.g. ``from ...io.inpcrd import read_inpcrd``)
    self-registers before the first ``open`` call, which must not
    suppress the remaining registrations."""
    global _autoloaded
    if _autoloaded:
        return
    _autoloaded = True
    # every reader module here imports directly, the native-backed
    # xtc/dcd included: an ImportError is a programming error (or a
    # broken build) and must surface, never unregister a format
    from mdanalysis_mpi_tpu_torch.io import (  # noqa: F401  (self-register)
        dcd, dlpoly, inpcrd, lammps, mdcrd, netcdf, trr, txyz, xtc, xyz)
    h5md = _unavailable(
        "H5MD", "the HDF5 container needs h5py, which is not installed",
        "convert once with MDAnalysis/mdconvert on a machine with "
        "h5py and open the XTC/DCD/NetCDF here")
    register("h5md", h5md)
    register("h5", h5md)
    register("gsd", _unavailable(
        "GSD", "the HOOMD container needs the gsd package",
        "convert once via MDAnalysis/gsd elsewhere, or write "
        "LAMMPS-style dumps which read natively here"))
    register("tng", _unavailable(
        "TNG", "GROMACS' TNG container needs pytng",
        "convert once with 'gmx trjconv -f traj.tng -o traj.xtc' and "
        "open the XTC here"))
    register("trz", _unavailable(
        "TRZ", "the IBIsCO/YASP binary layout has no public spec to "
        "validate a from-scratch reader against (a reader checked only "
        "against self-written bytes would be circular — the TPR "
        "rationale)",
        "convert once with MDAnalysis elsewhere ('mda.Writer' to "
        "XTC/DCD) and open the result here"))
