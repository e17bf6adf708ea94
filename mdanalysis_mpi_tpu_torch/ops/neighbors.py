"""Fixed-capacity cell-list neighbour search in torch — the device twin
of ``lib.nsgrid`` (the JAX package's ``ops/neighbors.py``).

Every cell is a FIXED-capacity bucket of atom slots, padded with a
sentinel and masked (the msmJAX formulation, arXiv:2510.05961), so the
search — bucket build (one stable argsort and one scatter), 27-stencil
gather, distance test — has static shapes: :func:`self_pair_counts`
runs a frame batch with no host wait, and a CUDA graph can capture it.

Capacity overflow (a cell holding more atoms than its bucket) is
DETECTED, not silently truncated: :func:`cell_bucket_kernel` returns an
``overflow`` flag computed before any slot is dropped, and
:func:`capped_distance` re-runs with a doubled capacity (loudly, through
the package logger) until the bucket fits.  The grid geometry is planned
on the host with ``lib.nsgrid``'s rules.

The candidate tensors are (N, 27·capacity): memory scales O(N), never
O(N·M).  Boxless queries run through a synthetic padded orthorhombic
box (pad > cutoff per side, so the periodic wrap can never fabricate a
sub-cutoff image).  Atoms are binned in float32 in the JAX kernel's
order (``frac = x @ inv``, wrapped, scaled by the grid, truncated and
clipped).  The pairs leave the device already ordered: the hits are
taken with ``nonzero`` on the device and sorted there by the key
``i·M + j``, which orders them as ``np.lexsort((j, i))`` does, so only
the K pairs cross to the host.
"""

from __future__ import annotations

import numpy as np
import torch

#: ceiling on the kernel's static tensors (bucket ncells·capacity +
#: candidates N·27·capacity), in ELEMENTS: past this the fixed-capacity
#: formulation is the wrong tool (pathologically clustered input) and
#: the host grid should serve the query instead of an OOM spiral
MAX_KERNEL_ELEMENTS = 1 << 28


def cell_bucket_kernel(a: torch.Tensor, b: torch.Tensor, box6: torch.Tensor,
                       cutoff: float, n_cells: tuple[int, int, int],
                       capacity: int, self_upper: bool = False):
    """Fixed-capacity capped-distance search on ``a``'s device.

    a (N, 3), b (M, 3), box6 (6,) full periodic box, all float32;
    ``n_cells`` and ``capacity`` are host integers.  Returns ``(cand,
    d2, hit, overflow)``: cand (N, 27·capacity) int64 candidate
    b-indices (M = padding sentinel), d2 their squared minimum-image
    distances, hit the boolean within-cutoff mask (padding already
    excluded), overflow a 0-d bool tensor — True when any cell held
    more than ``capacity`` b atoms, in which case ``hit`` is
    untrustworthy and the caller must re-run with a larger capacity.
    No host wait and no copy from the host, so a CUDA graph can
    capture it.
    """
    from mdanalysis_mpi_tpu_torch.ops._boxmat import box_to_matrix
    from mdanalysis_mpi_tpu_torch.ops.distances import _sq_norm, minimum_image

    dev = a.device
    nx, ny, nz = (int(v) for v in n_cells)
    ncells = nx * ny * nz
    n_a, n_b = a.shape[0], b.shape[0]
    m = box_to_matrix(box6)
    inv = torch.linalg.inv_ex(m).inverse
    grid = (nx, ny, nz)

    def cells_of(x):
        frac = x @ inv
        frac = frac - torch.floor(frac)
        return [torch.clamp((frac[:, k] * grid[k]).to(torch.int64), 0,
                            grid[k] - 1) for k in range(3)]

    ca = cells_of(a)
    cx, cy, cz = cells_of(b)
    cid_b = (cx * ny + cy) * nz + cz

    # bucket build: sort atoms by cell, rank each within its cell, and
    # scatter into (ncells, capacity).  The overflow flag is taken
    # before anything is dropped; an over-capacity rank is sent to one
    # spare slot past the end, which is cut off afterwards (torch has
    # no mode="drop")
    order = torch.argsort(cid_b, stable=True)
    sorted_cid = cid_b[order]
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(n_b, device=dev) - first
    fits = rank < capacity
    overflow = (~fits).any()
    slot = torch.where(fits, sorted_cid * capacity + rank,
                       torch.full_like(rank, ncells * capacity))
    bucket = torch.full((ncells * capacity + 1,), n_b, dtype=torch.int64,
                        device=dev)
    bucket = bucket.scatter(0, slot, order)[:-1].view(ncells, capacity)

    # 27-stencil gather: neighbour cell ids per a atom -> candidate
    # slots; the stencil's offsets in lib.nsgrid._STENCIL's order, made
    # on the device (i outermost, k innermost)
    s = torch.arange(27, device=dev)
    offsets = (s // 9 - 1, (s // 3) % 3 - 1, s % 3 - 1)
    nc = [torch.remainder(ca[k][:, None] + offsets[k][None, :], grid[k])
          for k in range(3)]
    ncid = (nc[0] * ny + nc[1]) * nz + nc[2]                   # (N, 27)
    cand = bucket[ncid].reshape(n_a, 27 * capacity)
    valid = cand < n_b
    bj = torch.clamp(cand, max=n_b - 1)
    disp = minimum_image(a[:, None, :] - b[bj], box6)
    d2 = _sq_norm(disp)
    # cutoff² rounded in float32, as the JAX kernel squares it
    c2 = float(np.float32(cutoff) * np.float32(cutoff))
    hit = valid & (d2 <= c2)
    if self_upper:
        hit &= cand > torch.arange(n_a, device=dev)[:, None]
    return cand, d2, hit, overflow


def self_pair_counts(coords: torch.Tensor, boxes: torch.Tensor,
                     mask: torch.Tensor, cutoff: float,
                     n_cells: tuple[int, int, int], capacity: int):
    """Per-frame unique (i<j) within-cutoff pair counts over a frame
    batch — the cell list batching over frames like the other batch
    functions: coords (B, N, 3), boxes (B, 6), mask (B,).  Returns
    ``(counts (B,) float32 — masked-out frames 0 — , overflow (B,)
    bool)``.  A loop over the frames with static shapes and no host
    wait (the JAX package's ``jax.lax.map``).
    """
    counts, ovs = [], []
    for x, box6 in zip(coords, boxes):
        _, _, hit, ov = cell_bucket_kernel(
            x, x, box6, cutoff, n_cells, capacity, self_upper=True)
        counts.append(hit.sum().to(torch.float32))
        ovs.append(ov)
    return torch.stack(counts) * mask, torch.stack(ovs)


def _plan_box(a: np.ndarray, b: np.ndarray, max_cutoff: float,
              dims: np.ndarray | None) -> np.ndarray:
    """The (6,) box the device kernel will wrap in: the real box when
    full, a synthetic padded ortho box for boxless queries (pad >
    cutoff per side ⇒ the wrap cannot bring any true pair under the
    cutoff that was not already there)."""
    if dims is not None and bool(np.all(dims[:3] > 0)):
        return np.asarray(dims, np.float64)
    if dims is not None and bool(np.any(dims[:3] > 0)):
        raise ValueError(
            "engine='torch' cannot serve a partially degenerate box "
            f"{np.asarray(dims)[:6].tolist()}; use engine='auto'")
    lo = np.minimum(a.min(axis=0), b.min(axis=0))
    hi = np.maximum(a.max(axis=0), b.max(axis=0))
    edge = (hi - lo) + 2.002 * float(max_cutoff)
    return np.concatenate([edge, [90.0, 90.0, 90.0]])


def plan_query(a: np.ndarray, b: np.ndarray, max_cutoff: float,
               dims: np.ndarray | None, capacity: int | None = None):
    """The host plan of one query → ``(box6, n_cells, capacity)``: the
    box the kernel wraps in (:func:`_plan_box`), ``lib.nsgrid``'s grid
    for it, and — when ``capacity`` is None — the exact largest cell
    occupancy of ``b`` from one host bincount, +1 slack for float32 vs
    float64 binning drift at cell edges (no retry for well-posed
    inputs; clustered systems hit ``MAX_KERNEL_ELEMENTS`` with a clear
    error instead of a doubling spiral).  ``a`` and ``b`` are float64
    (N, 3) and (M, 3), both non-empty."""
    from mdanalysis_mpi_tpu_torch.lib import nsgrid

    box6 = _plan_box(a, b, max_cutoff, dims)
    try:
        n_cells = nsgrid.grid_shape(a, b, max_cutoff, box6)
    except nsgrid.GridUnsuitable as e:
        raise ValueError(
            f"engine='torch' cannot serve this query: {e}; use "
            "engine='auto' for the brute-force fallback") from e
    if capacity is None:
        _, cells_fn, _ = nsgrid.make_plan(a, b, max_cutoff, box6)
        cb = cells_fn(b)
        ny, nz = n_cells[1], n_cells[2]
        occ = np.bincount((cb[:, 0] * ny + cb[:, 1]) * nz + cb[:, 2],
                          minlength=int(np.prod(n_cells)))
        capacity = int(occ.max()) + 1
    return box6, n_cells, int(capacity)


def capped_distance(a, b, max_cutoff: float,
                    min_cutoff: float | None = None,
                    dims: np.ndarray | None = None,
                    return_distances: bool = True,
                    self_upper: bool = False,
                    capacity: int | None = None,
                    device=None):
    """Host entry for ``lib.distances.capped_distance(engine="torch")``:
    plan the grid, run :func:`cell_bucket_kernel` on ``device`` (``cuda``
    unless given), retry loudly on capacity overflow, and emit the same
    lexsorted (pairs[, distances]) contract as the host engines
    (float32 distances promoted to float64 — the device precision
    class).

    ``capacity=None`` takes :func:`plan_query`'s exact occupancy; tests
    pass a deliberately small value to exercise the overflow-retry
    path, whose doubling is clamped at ``len(b)``.  Inputs clustered enough
    to push the static tensors past ``MAX_KERNEL_ELEMENTS`` raise with
    a pointer at the capacity-free host engines.
    """
    from mdanalysis_mpi_tpu_torch.device import resolve_device
    from mdanalysis_mpi_tpu_torch.utils.log import get_logger

    dev = resolve_device(device)
    a = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, 3)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, 3)
    if len(a) == 0 or len(b) == 0:
        pairs = np.empty((0, 2), dtype=np.int64)
        return (pairs, np.empty(0)) if return_distances else pairs
    box6, n_cells, capacity = plan_query(a, b, max_cutoff, dims, capacity)
    ncells = int(np.prod(n_cells))
    at = torch.as_tensor(a, dtype=torch.float32).to(dev)
    bt = torch.as_tensor(b, dtype=torch.float32).to(dev)
    boxt = torch.as_tensor(box6, dtype=torch.float32).to(dev)
    while True:
        kernel_elements = ncells * capacity + len(a) * 27 * capacity
        if kernel_elements > MAX_KERNEL_ELEMENTS:
            raise ValueError(
                f"engine='torch' needs cell capacity {capacity} on a "
                f"{tuple(n_cells)} grid (~{kernel_elements / 1e9:.1f}G "
                "tensor elements) — the input is too clustered for the "
                "fixed-capacity formulation; use engine='auto' or "
                "'nsgrid' (the host grid has no capacity)")
        cand, d2, hit, overflow = cell_bucket_kernel(
            at, bt, boxt, float(max_cutoff), tuple(n_cells),
            int(capacity), bool(self_upper))
        if not bool(overflow):
            break
        # capacity can never usefully exceed len(b) (a cell holds at
        # most every b atom), so the clamped doubling must terminate
        new_cap = min(2 * capacity, len(b))
        get_logger().warning(
            "ops.neighbors: cell capacity %d overflowed for %d atoms "
            "on a %s grid; retrying with %d",
            capacity, len(b), tuple(n_cells), new_cap)
        capacity = new_cap
    # float64 before the min_cutoff test and the square root, as the
    # JAX package's host code does
    d2 = d2.to(torch.float64)
    if min_cutoff is not None:
        hit &= d2 > float(min_cutoff) ** 2
    ii, kk = torch.nonzero(hit, as_tuple=True)
    jj = cand[ii, kk]
    perm = torch.argsort(ii * len(b) + jj)
    pairs = torch.stack([ii[perm], jj[perm]], dim=1).cpu().numpy()
    if return_distances:
        return pairs, torch.sqrt(d2[ii, kk][perm]).cpu().numpy()
    return pairs
