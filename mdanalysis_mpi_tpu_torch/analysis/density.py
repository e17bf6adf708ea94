"""Atom-density grid analysis.

Upstream-API mirror (``MDAnalysis.analysis.density.DensityAnalysis``):
accumulate a selection's positions onto a fixed 3-D grid over the
trajectory — ``DensityAnalysis(ag, delta=1.0).run()`` →
``results.grid`` (nx, ny, nz) mean occupancy per frame,
``results.density`` (number density, Å⁻³), ``results.edges`` /
``results.origin`` describing the grid.

Per staged batch the batch function computes voxel indices and adds
all B×S samples into an int32 count vector with one ``index_add_``
(integer adds: exact in any order, so the counts do not depend on the
order of the device's atomics); partials fold on the device and sum
across devices; out-of-grid samples fall into a trapdoor bin that is
dropped at the end (fixed shapes, no boolean indexing).  The JAX
package's ``analysis/density.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, to_numpy,
                                                    tree_add, tree_psum)
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup


# ---- batch function (one cached function per grid shape: the
# lru_cache keeps its identity stable per shape, so the executor's
# cached group programs survive across run() calls) ----

import functools


@functools.lru_cache(maxsize=None)
def _density_kernel_for(shape: tuple):
    nx, ny, nz = shape
    nbins = nx * ny * nz

    def kernel(params, batch, boxes, mask):
        """Partials (T int32, counts (nbins + 1,) int32): last bin is
        the out-of-grid trapdoor.  INTEGER accumulation: float32 counts
        silently saturate at 2^24 samples/bin (easily exceeded by the
        trapdoor on long runs); int32 is exact to 2^31 (guarded in
        _prepare) and its adds are exact in any order."""
        del boxes
        origin, inv_delta = params
        ijk = torch.floor((batch - origin) * inv_delta)
        inside = ((ijk >= 0).all(-1) & (ijk[..., 0] < nx)
                  & (ijk[..., 1] < ny) & (ijk[..., 2] < nz))
        # clamp before the cast: a far-out sample must not overflow
        ijk = ijk.clamp(-1, max(nx, ny, nz)).to(torch.int64)
        flat = ijk[..., 0] * (ny * nz) + ijk[..., 1] * nz + ijk[..., 2]
        flat = torch.where(inside, flat, torch.full_like(flat, nbins))
        w = (mask[:, None] > 0).expand(flat.shape).to(torch.int32)
        counts = torch.zeros(nbins + 1, dtype=torch.int32,
                             device=batch.device)
        counts.index_add_(0, flat.reshape(-1), w.reshape(-1))
        return ((mask > 0).sum().to(torch.int32), counts)

    return kernel


class DensityAnalysis(AnalysisBase):
    """``DensityAnalysis(ag, delta=1.0).run().results.density``.

    The grid is fixed before the run: either give ``gridcenter`` +
    ``xdim``/``ydim``/``zdim`` (Å), or it is derived from the
    selection's first ``run()`` frame with ``padding`` Å of margin
    (upstream behavior).  Samples outside the grid are counted in
    ``results.n_outside`` rather than silently dropped.
    """

    def __init__(self, atomgroup: AtomGroup, delta: float = 1.0,
                 gridcenter=None, xdim: float | None = None,
                 ydim: float | None = None, zdim: float | None = None,
                 padding: float = 2.0, verbose: bool = False):
        super().__init__(atomgroup.universe, verbose)
        if delta <= 0:
            raise ValueError(f"delta must be positive, got {delta}")
        dims = (xdim, ydim, zdim)
        if gridcenter is not None and any(d is None for d in dims):
            raise ValueError(
                "gridcenter needs explicit xdim, ydim and zdim")
        if gridcenter is None and any(d is not None for d in dims):
            raise ValueError(
                "xdim/ydim/zdim need an explicit gridcenter (without "
                "one the grid is derived from the first frame)")
        self._ag = atomgroup
        self._delta = float(delta)
        self._gridcenter = (None if gridcenter is None
                            else np.asarray(gridcenter, np.float64))
        self._userdims = dims
        self._padding = float(padding)

    def _prepare(self):
        self._idx = self._ag.indices
        if len(self._idx) == 0:
            raise ValueError("selection matched no atoms")
        d = self._delta
        if self._gridcenter is not None:
            dims = np.array([float(x) for x in self._userdims])
            shape = np.maximum(np.ceil(dims / d), 1).astype(int)
            # origin from the ROUNDED extent, so the grid stays centered
            # on gridcenter even when a dimension is not a multiple of
            # delta (rounding must grow both sides, not just the high one)
            origin = self._gridcenter - shape * d / 2.0
        else:
            # derive from the run's first frame + padding (upstream)
            first = self._frame_indices[0] if self._frame_indices else 0
            pos = self._universe.trajectory[first].positions[self._idx]
            lo = pos.min(axis=0) - self._padding
            hi = pos.max(axis=0) + self._padding
            origin = lo.astype(np.float64)
            shape = np.maximum(np.ceil((hi - lo) / d), 1).astype(int)
        if int(np.prod(shape)) > 64_000_000:
            raise ValueError(
                f"grid shape {tuple(shape)} exceeds 64M voxels; coarsen "
                "delta or bound the grid")
        # int32 device counts: exact to 2^31 samples per bin — the
        # worst case for one bin (the trapdoor) is every sample of the
        # whole run
        if self.n_frames * len(self._idx) >= 2 ** 31:
            raise ValueError(
                f"{self.n_frames} frames x {len(self._idx)} atoms "
                "exceeds the int32 device-count capacity (2^31 samples); "
                "split the run into windows and merge the grids")
        self._origin = origin
        self._shape = tuple(int(s) for s in shape)
        self._counts = np.zeros(self._shape, dtype=np.float64)
        self._t = 0.0
        self._outside = 0.0

    # -- serial path --

    def _single_frame(self, ts):
        pos = ts.positions[self._idx].astype(np.float64)
        ijk = np.floor((pos - self._origin) / self._delta).astype(np.int64)
        nx, ny, nz = self._shape
        inside = ((ijk >= 0).all(1) & (ijk[:, 0] < nx)
                  & (ijk[:, 1] < ny) & (ijk[:, 2] < nz))
        self._outside += float((~inside).sum())
        k = ijk[inside]
        np.add.at(self._counts, (k[:, 0], k[:, 1], k[:, 2]), 1.0)
        self._t += 1.0

    def _serial_summary(self):
        flat = np.concatenate([self._counts.reshape(-1), [self._outside]])
        return (self._t, flat)

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _density_kernel_for(self._shape)

    def _batch_params(self):
        return (torch.as_tensor(self._origin, dtype=torch.float32),
                np.float32(1.0 / self._delta))

    _device_combine = staticmethod(tree_psum)
    _device_fold_fn = staticmethod(tree_add)

    def _identity_partials(self):
        return (0.0, np.zeros(int(np.prod(self._shape)) + 1))

    def _conclude(self, total):
        t, flat = total
        if self.n_frames == 0:
            raise ValueError("DensityAnalysis over zero frames")
        from mdanalysis_mpi_tpu_torch.analysis.base import deferred_group

        shape = self._shape
        origin = self._origin
        delta = self._delta

        def _finalize():
            f = np.asarray(to_numpy(flat), np.float64)
            tt = float(np.asarray(to_numpy(t)))
            grid = f[:-1].reshape(shape) / tt
            ex, ey, ez = (origin[i] + delta * np.arange(shape[i] + 1)
                          for i in range(3))
            return {
                "grid": grid,
                "density": grid / delta ** 3,
                "n_outside": f[-1] / tt,
                "origin": origin,
                "edges": [ex, ey, ez],
                "edges_x": ex, "edges_y": ey, "edges_z": ez,
                # upstream's unit-aware container (convert_density /
                # DX export); `density` stays the plain ndarray —
                # documented deviation, PARITY.md
                "density_object": Density(grid / delta ** 3,
                                          [ex, ey, ez]),
            }

        g = deferred_group(_finalize)
        for k in ("grid", "density", "n_outside", "origin", "edges",
                  "edges_x", "edges_y", "edges_z", "density_object"):
            self.results[k] = g[k]


class Density:
    """Grid + metadata container (upstream ``analysis.density.Density``):
    unit-aware number-density grid with in-place
    :meth:`convert_density` (via :mod:`mdanalysis_mpi_tpu_torch.units`) and
    OpenDX :meth:`export` for VMD/PyMOL interop.

    ``grid`` is (nx, ny, nz); ``edges`` the three bin-edge arrays (Å).
    The density unit starts as ``A^{-3}`` (the framework's base).
    """

    def __init__(self, grid: np.ndarray, edges, units: str = "A^{-3}"):
        from mdanalysis_mpi_tpu_torch.units import densityUnit_factor

        self.grid = np.asarray(grid, np.float64)
        if self.grid.ndim != 3:
            raise ValueError(f"grid must be 3-D, got {self.grid.shape}")
        self.edges = [np.asarray(e, np.float64) for e in edges]
        if len(self.edges) != 3 or any(
                len(e) != n + 1 for e, n in zip(self.edges,
                                                self.grid.shape)):
            raise ValueError(
                "edges must be three arrays of length grid.shape[i]+1")
        if units not in densityUnit_factor:
            raise ValueError(
                f"unknown density unit {units!r}; known: "
                f"{sorted(densityUnit_factor)}")
        self.units = {"length": "A", "density": units}

    @property
    def origin(self) -> np.ndarray:
        return np.array([e[0] for e in self.edges])

    @property
    def delta(self) -> np.ndarray:
        return np.array([e[1] - e[0] for e in self.edges])

    def convert_density(self, unit: str = "water") -> "Density":
        """In-place unit conversion of the grid values (upstream
        semantics); returns self for chaining."""
        from mdanalysis_mpi_tpu_torch import units as u

        if unit not in u.densityUnit_factor:
            raise ValueError(
                f"unknown density unit {unit!r}; known: "
                f"{sorted(u.densityUnit_factor)}")
        factor = u.get_conversion_factor(
            "density", self.units["density"], unit)
        self.grid *= factor
        self.units["density"] = unit
        return self

    def export(self, path: str, type: str = "DX") -> None:
        """Write the grid as OpenDX (the VMD/PyMOL volumetric format;
        upstream ``Density.export``)."""
        if type.upper() != "DX":
            raise ValueError(f"only DX export is supported, got {type!r}")
        nx, ny, nz = self.grid.shape
        d = self.delta
        # DX grid positions are the SAMPLE POINTS — upstream
        # (gridData/APBS/VMD) puts the origin at the first voxel
        # CENTER, i.e. half a voxel inside the first bin edge.  The
        # in-repo round trip cannot distinguish the two conventions
        # (a symmetric shift cancels), so this is pinned explicitly
        # in tests against the documented convention.
        o = self.origin + 0.5 * d
        with open(path, "w") as fh:
            fh.write("# OpenDX density written by mdanalysis_mpi_tpu\n")
            fh.write(f"object 1 class gridpositions counts "
                     f"{nx} {ny} {nz}\n")
            fh.write(f"origin {o[0]:.10g} {o[1]:.10g} {o[2]:.10g}\n")
            fh.write(f"delta {d[0]:.10g} 0 0\n")
            fh.write(f"delta 0 {d[1]:.10g} 0\n")
            fh.write(f"delta 0 0 {d[2]:.10g}\n")
            fh.write(f"object 2 class gridconnections counts "
                     f"{nx} {ny} {nz}\n")
            fh.write(f"object 3 class array type double rank 0 items "
                     f"{self.grid.size} data follows\n")
            flat = self.grid.ravel()        # C order: z fastest (DX)
            full = len(flat) // 3 * 3       # 64M-voxel grids are legal:
            if full:                        # C-speed formatting, not a
                np.savetxt(fh, flat[:full].reshape(-1, 3),  # py loop
                           fmt="%.10g")
            if full < len(flat):
                fh.write(" ".join(f"{v:.10g}" for v in flat[full:])
                         + "\n")
            fh.write('attribute "dep" string "positions"\n')
            fh.write('object "density" class field\n')
            fh.write('component "positions" value 1\n')
            fh.write('component "connections" value 2\n')
            fh.write('component "data" value 3\n')

    @classmethod
    def from_dx(cls, path: str, units: str = "A^{-3}") -> "Density":
        """Read an OpenDX grid (regular deltas) back into a Density."""
        counts = origin = None
        deltas = []
        values: list = []
        n_items = None
        with open(path) as fh:
            for ln in fh:
                s = ln.strip()
                if not s or s.startswith("#"):
                    continue
                t = s.split()
                if s.startswith("object") and "gridpositions" in s:
                    counts = [int(x) for x in t[-3:]]
                elif t[0] == "origin":
                    origin = [float(x) for x in t[1:4]]
                elif t[0] == "delta":
                    deltas.append([float(x) for x in t[1:4]])
                elif "data follows" in s:
                    n_items = int(t[t.index("items") + 1])
                elif n_items is not None and len(values) < n_items:
                    try:
                        values.extend(float(x) for x in t)
                    except ValueError:
                        break          # trailing attribute block
        if counts is None or origin is None or len(deltas) != 3:
            raise ValueError(f"{path!r} is not a regular-grid DX file")
        for i, dv in enumerate(deltas):
            off = [abs(dv[j]) for j in range(3) if j != i]
            if max(off) > 1e-9 * max(abs(dv[i]), 1e-30):
                raise ValueError(
                    f"{path!r}: delta {i} has off-axis components "
                    f"{dv} — sheared/rotated DX grids are not "
                    "supported (regular axis-aligned grids only)")
        d = [deltas[i][i] for i in range(3)]
        if n_items is None or len(values) < n_items:
            raise ValueError(f"{path!r}: truncated data section")
        grid = np.asarray(values[:n_items], np.float64).reshape(counts)
        # DX origin is the first voxel CENTER (see export); the first
        # bin EDGE sits half a voxel below it
        edges = [origin[i] - 0.5 * d[i] + d[i] * np.arange(counts[i] + 1)
                 for i in range(3)]
        return cls(grid, edges, units=units)
