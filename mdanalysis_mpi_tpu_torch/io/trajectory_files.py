"""Trajectory file-format registry: path → Reader.

Dispatch point for ``Universe(top, "traj.xtc")`` (RMSF.py:56 analog).
Formats register via :func:`register`; readers live in sibling modules
(``xtc``, ``dcd``).
"""

from __future__ import annotations

import os

_READERS: dict[str, callable] = {}


def register(extension: str, opener) -> None:
    """Register ``opener(path, n_atoms=...) -> ReaderBase``."""
    _READERS[extension.lower().lstrip(".")] = opener


def open(path: str, n_atoms: int | None = None):
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


_autoloaded = False


def _autoload():
    """Guarded by a flag, not ``_READERS`` truthiness: a format module
    imported directly self-registers before the first ``open`` call,
    which must not suppress the remaining registrations.  The port
    carries XTC and DCD (and in-memory arrays, which need no registry);
    the other readers of the JAX package are ported in later slices."""
    global _autoloaded
    if _autoloaded:
        return
    _autoloaded = True
    from mdanalysis_mpi_tpu_torch.io import dcd, xtc  # noqa: F401  (self-register)
