"""Auxiliary time-series data (upstream ``MDAnalysis.auxiliary``).

Simulations emit per-step scalar/vector series alongside the trajectory
— pull forces, energies, collective variables — usually at a different
(higher) cadence than saved frames.  This module reads them and aligns
them to trajectory frames by TIME:

    aux = XVGReader("pull_force.xvg")
    u.trajectory.add_auxiliary("force", aux, cutoff=0.5)
    for ts in u.trajectory:
        ts.aux.force            # the aux step closest to ts.time

Alignment picks the aux step whose time is nearest the frame's time;
with ``cutoff`` set, frames farther than that from every aux step get
NaNs instead of a silently wrong neighbor (upstream's cutoff
semantics).  The attached value is the step's full data record
(including its time column) as a float64 array — upstream's
``ts.aux.<name>`` shape.

Readers:

- :class:`XVGReader` — the Grace/GROMACS ``.xvg`` format: ``#``
  comments and ``@`` directives skipped, whitespace-separated float
  columns, first column = time (ps).  Parsing is one pass +
  ``np.loadtxt``-equivalent vectorized conversion.
- :class:`ArrayAuxReader` — wrap in-memory ``(times, data)`` arrays.

Host-side by design: auxiliary series are tiny next to coordinates and
attach at the per-frame ``ts`` surface (the serial path); batch
kernels never see them.  Cited reference basis: SURVEY.md §5 auxiliary
subsystems; the upstream module this mirrors is
``MDAnalysis.auxiliary.XVG``.
"""

from __future__ import annotations

import numpy as np


class ArrayAuxReader:
    """Auxiliary series from arrays: ``times`` (n,), ``data`` (n, k)
    (``data[:, 0]`` need not be the time — ``times`` is authoritative).
    """

    def __init__(self, times, data):
        self.times = np.asarray(times, np.float64)
        data = np.asarray(data, np.float64)
        if data.ndim == 1:
            # a scalar series: one value per step (atleast_2d would
            # flip it into ONE step of n columns — a silent transpose)
            data = data[:, None]
        elif data.ndim != 2:
            raise ValueError(f"data must be (n,) or (n, k), "
                             f"got {data.shape}")
        self.data = data
        if self.times.ndim != 1:
            raise ValueError(f"times must be 1-D, got {self.times.shape}")
        if len(self.data) != len(self.times):
            raise ValueError(
                f"data has {len(self.data)} steps for {len(self.times)} "
                "times")
        if len(self.times) == 0:
            raise ValueError("auxiliary series is empty")
        if np.any(np.diff(self.times) < 0):
            raise ValueError("auxiliary times must be non-decreasing")

    @property
    def n_steps(self) -> int:
        return len(self.times)

    def closest_step(self, time: float) -> int:
        """Index of the aux step nearest ``time`` (ties → earlier)."""
        i = int(np.searchsorted(self.times, time))
        if i == 0:
            return 0
        if i == self.n_steps:
            return self.n_steps - 1
        return i if (self.times[i] - time) < (time - self.times[i - 1]) \
            else i - 1

    def value_at(self, time: float, cutoff: float | None = None
                 ) -> np.ndarray:
        """The full data record of the nearest step, or NaNs when the
        nearest step is farther than ``cutoff`` (never a silently wrong
        neighbor)."""
        i = self.closest_step(time)
        if cutoff is not None and abs(self.times[i] - time) > cutoff:
            return np.full(self.data.shape[1], np.nan)
        # a copy, not a view: an in-place edit of ts.aux.<name> must
        # not corrupt the series for every later frame
        return self.data[i].copy()


class XVGReader(ArrayAuxReader):
    """Grace/GROMACS ``.xvg`` auxiliary file: ``#`` comments and ``@``
    directives skipped, float columns, column 0 = time."""

    def __init__(self, path: str):
        rows = []
        with open(path) as f:
            for ln, line in enumerate(f, start=1):
                s = line.strip()
                if not s or s[0] in "#@":
                    continue
                if s[0] == "&":          # Grace dataset separator: one
                    break                # series per reader, upstream too
                try:
                    rows.append([float(x) for x in s.split()])
                except ValueError:
                    raise ValueError(
                        f"{path}:{ln}: non-numeric data line "
                        f"{s[:40]!r}") from None
        if not rows:
            raise ValueError(f"{path}: no data rows")
        width = len(rows[0])
        if any(len(r) != width for r in rows):
            raise ValueError(f"{path}: ragged rows (expected {width} "
                             "columns on every line)")
        data = np.asarray(rows, np.float64)
        super().__init__(data[:, 0], data)
        self._path = path


class EDRReader:
    """GROMACS ``.edr`` energy files — documented conversion path.

    Upstream reads EDR through the ``pyedr`` package, which is not in
    this environment, and the EDR binary layout is a versioned GROMACS
    internal (the TPR rationale: a parser validated only against
    self-written bytes would be circular).  Convert once —

        gmx energy -f ener.edr -o energy.xvg

    — and attach the XVG: ``u.trajectory.add_auxiliary("energy",
    XVGReader("energy.xvg"))``.
    """

    def __init__(self, path: str):
        raise ValueError(
            f"EDR files are not read directly ({path}); convert once "
            "with 'gmx energy -f ener.edr -o energy.xvg' and use "
            "XVGReader — see auxiliary.EDRReader for why")


class AuxHolder(dict):
    """Attribute-accessible per-frame aux namespace (``ts.aux.force``)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"no auxiliary {key!r}; attached: {sorted(self)}") from None
