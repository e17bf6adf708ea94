"""Ring-rotated atom-axis sharding for O(N²) pair kernels (the JAX
package's ``ops/ring.py``).

The sequence/context-parallel analog SURVEY.md §2.3/§5.7 identifies:
the reference's only axis is frames (time), but the O(N²) pair kernels
(RDF, distance arrays — BASELINE configs 4-5) scale with *atoms*.  The
fix is structurally ring attention: shard the atom axis over the
devices, keep each device's block resident, and rotate the "key" side
block by block around the ring — after P steps every device has
histogrammed its atom block against all N atoms, and one sum merges the
partial histograms.  Nothing ever materializes more than
O((N/P)·tile) distances per device.

Group structure rides along as *weights*: both RDF groups live in one
union atom array; a pair contributes ``w_a[i]·w_b[j]``, so subset
groups, overlap and shard padding (weight 0) all fall out of the same
multiply.  The weight vector of the rotating side travels with the
coordinates (a 4th column), so weights and positions never
desynchronize mid-ring.

Where the JAX package runs these inside ``shard_map`` (one program per
device, ``ppermute`` over the mesh axis), the port drives every local
device from one Python loop: the arguments are lists with one entry
per local device, ring position ``rank · n_local + j``.  The rotating
payload moves to the next device with a copy, and from a rank's last
device to the next rank's first by ``send``/``recv``
(:meth:`~mdanalysis_mpi_tpu_torch.parallel.distributed.Collectives.
ring_shift`).  Each step is the generic engine's
:func:`~mdanalysis_mpi_tpu_torch.ops.distances.pair_histogram` with
global offsets and weights, as in the JAX package (whose ring never
used the Pallas kernel).
"""

from __future__ import annotations

import torch

from mdanalysis_mpi_tpu_torch.ops._boxmat import batch_box_volumes
from mdanalysis_mpi_tpu_torch.ops.distances import pair_histogram


def _rotate(rot: list, comm) -> list:
    """Every ring position's payload moves to the next position: within
    this rank by a copy to the next device, from this rank's last device
    to the next rank's first through ``comm``."""
    incoming = rot[-1] if comm is None else comm.ring_shift(rot[-1])
    moved = [incoming] + rot[:-1]
    return [x.to(r.device) for x, r in zip(moved, rot)]


def ring_union_histogram(x_blks: list,        # (n_l, 3) local blocks
                         w_a: list,           # (n_l,) group-A weights
                         w_b: list,           # (n_l,) group-B weights
                         edges: list,         # (nbins+1,) per device
                         boxes: list,         # (6,) box per device
                         exclude_self: bool = False,
                         tile: int = 1024,
                         comm=None) -> list:
    """One frame's pair histogram, atom-sharded: local device ``j``
    holds a contiguous block of the (padded) union atom array and gets
    its partial ``(nbins,)`` histogram — callers sum them (and
    all-reduce across ranks)."""
    n_local = len(x_blks)
    rank, size = (0, 1) if comm is None else (comm.rank, comm.size)
    p = n_local * size
    n_l = x_blks[0].shape[0]
    tile = min(tile, n_l)    # a tile wider than the rotating block is
    # pure zero-weight padding work
    rot = [torch.cat([x, wb[:, None].to(x.dtype)], dim=1)
           for x, wb in zip(x_blks, w_b)]
    hists = [torch.zeros(e.shape[0] - 1, dtype=x.dtype, device=x.device)
             for x, e in zip(x_blks, edges)]
    for k in range(p):
        for j in range(n_local):
            me = rank * n_local + j
            src = (me - k) % p           # whose block we hold at step k
            hists[j] = hists[j] + pair_histogram(
                x_blks[j], rot[j][:, :3], edges[j], box=boxes[j],
                exclude_self=exclude_self, tile=tile,
                a_offset=me * n_l, b_offset=src * n_l,
                a_weights=w_a[j], b_weights=rot[j][:, 3])
        if k + 1 < p:
            rot = _rotate(rot, comm)
    return hists


def ring_rdf_batch(batch_blks: list,     # (B, n_l, 3) per device
                   w_a: list, w_b: list,  # (n_l,) per device
                   boxes: list,           # (B, 6) per device, replicated
                   mask: list,            # (B,) per device, replicated
                   edges: list,
                   exclude_self: bool = False,
                   tile: int = 1024,
                   comm=None) -> list:
    """Frame-batch RDF partials on the atom-sharded ring, one
    ``(counts, Σ volume, T, n_boxed)`` per local device with the same
    contract as the frame-sharded engines.

    Boxes and mask are replicated across the atom axis, so the scalar
    partials are divided by the ring size — the analysis' sum merge
    (``tree_psum``) then restores the true totals, keeping one merge
    path for every engine."""
    n_local = len(batch_blks)
    size = 1 if comm is None else comm.size
    p = n_local * size
    n_frames = batch_blks[0].shape[0]
    per_frame = [ring_union_histogram(
        [b[f] for b in batch_blks], w_a, w_b, edges,
        [bx[f] for bx in boxes], exclude_self=exclude_self, tile=tile,
        comm=comm) for f in range(n_frames)]
    out = []
    for j in range(n_local):
        m = mask[j].to(batch_blks[j].dtype)
        hists = torch.stack([h[j] for h in per_frame])
        vols = batch_box_volumes(boxes[j]).to(m.dtype)
        out.append((m @ hists, (vols * m).sum() / p, m.sum() / p,
                    ((vols > 0.0) * m).sum() / p))
    return out
