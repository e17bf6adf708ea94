"""Cell-list (grid) neighbor search — the O(N) engine behind
``lib.distances.capped_distance`` (upstream ``lib.nsgrid``, the
dependency-closure component VERDICT r5 named as the one algorithmic
regression: the brute-force path is O(N·M), ~10¹⁰ distance evaluations
for one 100k-atom capped query).

Algorithm (the standard trajectory-analysis formulation, arXiv
1907.00097; the fixed-capacity torch twin lives in ``ops.neighbors``):

- bin atoms into cells whose edge is ≥ ``max_cutoff`` — in FRACTIONAL
  coordinates of the box matrix (``core.box.box_to_vectors``), so ortho
  and triclinic boxes share one code path.  The fractional cell count
  per axis is ``floor(d_k / cutoff)`` where ``d_k`` is the cell's
  perpendicular width along axis k (V / |cross of the other two
  vectors|) — the brick-shape bound that makes the 27-stencil
  sufficient for arbitrary triclinic skew;
- enumerate the 27-neighbor stencil per reference atom (periodic wrap
  for boxed systems; clipped at the grid edge for boxless ones) and
  gather candidates through one argsort + searchsorted per stencil
  offset — 27 fully vectorized passes, no Python loop over atoms;
- compute candidate distances with the SAME ``ops.host.minimum_image``
  metric as the brute-force path and apply the same cutoff tests, so
  the emitted (pairs, distances) sets are IDENTICAL — the grid only
  prunes, it never decides.  Output is lexsorted by (i, j), the
  brute-force path's natural order, so consumers see one ordering
  regardless of engine.

When the grid cannot apply — no/degenerate box with pathological
extents, or a cutoff so large that fewer than 3 cells fit per axis
(the 27-stencil would alias through the periodic wrap) —
:class:`GridUnsuitable` is raised and the dispatcher in
``lib.distances`` falls back to the documented brute-force path.
"""

from __future__ import annotations

import numpy as np

#: grid resolution cap per axis: finer than this adds bookkeeping, not
#: pruning (a 64³ grid already has ≤ N/262k atoms per cell at any N
#: this host path will see)
MAX_CELLS_PER_AXIS = 64

#: the 27-neighbor stencil, (27, 3) int
_STENCIL = np.array([(i, j, k) for i in (-1, 0, 1)
                     for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=np.int64)


class GridUnsuitable(Exception):
    """The cell list cannot (correctly or profitably) serve this query;
    callers fall back to the brute-force path."""


def _perpendicular_widths(m: np.ndarray) -> np.ndarray:
    """Perpendicular width of the cell along each lattice axis: the
    real-space distance a fractional step of 1 covers orthogonally to
    the other two vectors — V / |cross of the other two|.  A sphere of
    radius R spans R / d_k fractional units along axis k."""
    vol = abs(np.linalg.det(m))
    crosses = np.array([np.linalg.norm(np.cross(m[1], m[2])),
                        np.linalg.norm(np.cross(m[2], m[0])),
                        np.linalg.norm(np.cross(m[0], m[1]))])
    return vol / np.maximum(crosses, 1e-300)


def _plan_periodic(max_cutoff, dims):
    """(ncell, cells_fn, periodic=True) for a full valid box; the
    per-atom binning runs only when ``cells_fn`` is called."""
    from mdanalysis_mpi_tpu_torch.core.box import box_to_vectors

    m = box_to_vectors(np.asarray(dims, np.float64))
    if not np.isfinite(m).all() or abs(np.linalg.det(m)) < 1e-12:
        raise GridUnsuitable(
            f"box {np.asarray(dims)[:6].tolist()} has no volume")
    widths = _perpendicular_widths(m)
    ratio = widths / max_cutoff
    # +1e-8: box_to_vectors introduces ~1e-16-relative noise (cos of an
    # exact 90° angle is 6e-17, not 0), which would push an exact
    # integer ratio just below its floor
    ncell = np.floor(ratio + 1e-8).astype(np.int64)
    # An atom EXACTLY on a cell boundary snaps to either side under fp
    # noise, so a pair at distance exactly cutoff can bin 2 cells apart
    # when cell width == cutoff exactly.  A 3-cell periodic axis is
    # immune (every cell pair is adjacent mod 3); at >= 4 cells demand
    # a strict width margin and give up one cell when it's missing.
    ncell = np.where((ncell >= 4) & (ratio < ncell * (1 + 1e-9)),
                     ncell - 1, ncell)
    if (ncell < 3).any():
        raise GridUnsuitable(
            f"cutoff {max_cutoff} too large for box (cells per axis "
            f"{ncell.tolist()}, need >= 3 so the periodic 27-stencil "
            "cannot alias)")
    ncell = np.minimum(ncell, MAX_CELLS_PER_AXIS)
    inv = np.linalg.inv(m)

    def cells(x):
        frac = x @ inv
        frac -= np.floor(frac)
        # frac is [0, 1) up to float round-off; clip both ends so a
        # boundary atom (frac -> 1.0 after the subtract) stays in-grid
        return np.clip((frac * ncell).astype(np.int64), 0, ncell - 1)

    return ncell, cells, True


def _plan_free(a, b, max_cutoff):
    """(ncell, cells_fn, periodic=False) over the joint bounding box —
    the no-PBC path (plain Euclidean metric)."""
    lo = np.minimum(a.min(axis=0), b.min(axis=0))
    hi = np.maximum(a.max(axis=0), b.max(axis=0))
    extent = hi - lo
    if not np.isfinite(extent).all():
        raise GridUnsuitable("non-finite coordinates")
    ratio = extent / max_cutoff
    ncell = np.floor(ratio + 1e-8).astype(np.int64)
    # boundary-snap safety (see _plan_periodic): without wrap, any axis
    # with >= 3 cells can bin a boundary-straddling exact-cutoff pair 2
    # cells apart unless cell width strictly exceeds the cutoff
    ncell = np.where((ncell >= 3) & (ratio < ncell * (1 + 1e-9)),
                     ncell - 1, ncell)
    ncell = np.clip(ncell, 1, MAX_CELLS_PER_AXIS)
    # cell edge = extent / ncell >= max_cutoff by the floor above, so
    # the unwrapped 27-stencil is sufficient
    width = np.where(extent > 0, extent / ncell, 1.0)

    def cells(x):
        return np.clip(((x - lo) / width).astype(np.int64), 0, ncell - 1)

    return ncell, cells, False


def make_plan(a, b, max_cutoff, dims):
    """The (ncell, cells_fn, periodic) grid plan :func:`capped_pairs`
    will execute — build it ONCE and pass it back via ``plan=`` when a
    caller (the ``auto`` dispatcher) needs the geometry for a
    profitability check first.  Cheap: box math only, plus a min/max
    pass for boxless queries; the per-atom binning runs when
    ``cells_fn`` is called.  Raises :class:`GridUnsuitable` exactly
    when :func:`capped_pairs` would."""
    periodic_box = dims is not None and bool(np.all(dims[:3] > 0))
    if dims is not None and not periodic_box and bool(np.any(dims[:3] > 0)):
        raise GridUnsuitable(
            f"partially degenerate box {np.asarray(dims)[:6].tolist()}")
    if periodic_box:
        return _plan_periodic(float(max_cutoff), dims)
    return _plan_free(a, b, float(max_cutoff))


def capped_pairs(a: np.ndarray, b: np.ndarray, max_cutoff: float,
                 min_cutoff: float | None = None,
                 dims: np.ndarray | None = None,
                 return_distances: bool = True,
                 self_upper: bool = False,
                 plan=None):
    """Cell-list twin of the brute-force kernel in ``lib.distances
    .capped_distance`` — same arguments (``dims`` already normalized to
    the 6-vector by the caller), same return contract, same metric,
    identical output including order.  Raises :class:`GridUnsuitable`
    when the grid cannot serve the query.  ``plan`` accepts a
    pre-built :func:`make_plan` result so dispatchers that already
    planned for a profitability check do not plan twice."""
    from mdanalysis_mpi_tpu_torch.ops import host

    a = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, 3)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, 3)
    if len(a) == 0 or len(b) == 0:
        pairs = np.empty((0, 2), dtype=np.int64)
        return (pairs, np.empty(0)) if return_distances else pairs

    ncell, cells, wrap = (make_plan(a, b, max_cutoff, dims)
                          if plan is None else plan)
    ca, cb = cells(a), cells(b)
    ny, nz = int(ncell[1]), int(ncell[2])

    def encode(c):
        return (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]

    idb = encode(cb)
    order = np.argsort(idb, kind="stable")
    sorted_ids = idb[order]

    c2 = float(max_cutoff) ** 2
    m2 = None if min_cutoff is None else float(min_cutoff) ** 2
    pairs_i, pairs_j, dists = [], [], []
    n_a = len(a)
    for off in _STENCIL:
        nc = ca + off
        if wrap:
            nc %= ncell
            ncid = encode(nc)
        else:
            oob = ((nc < 0) | (nc >= ncell)).any(axis=1)
            # -1 never matches a (non-negative) sorted cell id, so
            # out-of-grid stencil cells contribute zero candidates
            ncid = np.where(oob, -1, encode(np.clip(nc, 0, ncell - 1)))
        start = np.searchsorted(sorted_ids, ncid, side="left")
        end = np.searchsorted(sorted_ids, ncid, side="right")
        counts = end - start
        total = int(counts.sum())
        if total == 0:
            continue
        ai = np.repeat(np.arange(n_a), counts)
        run_starts = np.cumsum(counts) - counts
        within = np.arange(total) - np.repeat(run_starts, counts)
        bj = order[np.repeat(start, counts) + within]
        disp = host.minimum_image(a[ai] - b[bj], dims)
        d2 = np.einsum("ij,ij->i", disp, disp)
        hit = d2 <= c2
        if m2 is not None:
            hit &= d2 > m2
        if self_upper:
            hit &= bj > ai
        if hit.any():
            pairs_i.append(ai[hit])
            pairs_j.append(bj[hit])
            if return_distances:
                dists.append(np.sqrt(d2[hit]))

    if not pairs_i:
        pairs = np.empty((0, 2), dtype=np.int64)
        return (pairs, np.empty(0)) if return_distances else pairs
    ii = np.concatenate(pairs_i)
    jj = np.concatenate(pairs_j)
    # brute force emits (i, j) in lexicographic order; match it so the
    # engines are interchangeable row-for-row, not just as sets
    perm = np.lexsort((jj, ii))
    pairs = np.stack([ii[perm], jj[perm]], axis=1)
    if return_distances:
        return pairs, np.concatenate(dists)[perm]
    return pairs


def grid_shape(a: np.ndarray, b: np.ndarray, max_cutoff: float,
               dims: np.ndarray | None) -> tuple[int, int, int]:
    """The (nx, ny, nz) cell grid :func:`capped_pairs` would use —
    exposed for the torch engine's static-shape planning and for the
    ``auto`` engine's profitability estimate.  Raises
    :class:`GridUnsuitable` exactly when :func:`capped_pairs` would.
    Cheap: no per-atom binning (only box math, plus a min/max pass for
    boxless queries)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, 3)
    b = np.asarray(b, dtype=np.float64).reshape(-1, 3)
    if len(a) == 0 or len(b) == 0:
        return (1, 1, 1)
    ncell, _, _ = make_plan(a, b, max_cutoff, dims)
    return (int(ncell[0]), int(ncell[1]), int(ncell[2]))
