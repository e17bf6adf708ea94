"""Pair-distance ops in torch: PBC minimum image, pair distances, and
the generic RDF histogram engine (the JAX package's ``engine='xla'``).

The histogram never materializes the full pair matrix: group B is cut
into tiles of ``tile`` atoms and each tile forms an ``(N, tile)``
distance block, so peak memory is O(N·tile), never O(N·M).  Partials
are float32 and merge by addition (``tree_add``), as in the JAX
package.  The hand-written CUDA engine is
:mod:`mdanalysis_mpi_tpu_torch.ops.fused_distances`.

Everything here is branch-free on the box: orthorhombic, triclinic and
absent boxes are told apart by ``torch.where`` on device values, so a
batch function never reads a device value back to the host.
"""

from __future__ import annotations

import torch

from mdanalysis_mpi_tpu_torch import device as _device  # noqa: F401  (TF32 off)
from mdanalysis_mpi_tpu_torch.ops._boxmat import (batch_box_volumes,
                                                  box_to_matrix)


def minimum_image(disp: torch.Tensor, box) -> torch.Tensor:
    """Apply the minimum-image convention to displacement vectors.

    ``disp``: ``(..., 3)``; ``box``: dimensions ``[lx,ly,lz,alpha,beta,
    gamma]`` (a tensor or array of 6) or None (no PBC).  Orthorhombic
    boxes use the per-axis wrap ``d - round(d/L)·L`` (half to even, no
    wrap where L = 0); triclinic boxes go through fractional coordinates
    of the box matrix; a box with no positive length leaves ``disp``
    as it is.

    ``box`` may also be a ``(B, 6)`` stack (any leading dimensions) with
    ``disp`` ``(B, ..., 3)``: each frame is then wrapped under its own
    box, as this function would wrap it alone (a batch function's whole
    batch at once).
    """
    if box is None:
        return disp
    box = torch.as_tensor(box, dtype=disp.dtype, device=disp.device)
    lead = box.shape[:-1]
    # each box value reaches disp's rank: (*lead, 1, ..., 1, k)
    lift = lead + (1,) * (disp.dim() - 1 - len(lead))

    def to_disp(x):
        return x.reshape(lift + x.shape[-1:])

    lengths = box[..., :3]
    has_box = to_disp((lengths > 0).any(-1, keepdim=True))
    ortho = to_disp(((box[..., 3:] - 90.0).abs() < 1e-4).all(
        -1, keepdim=True))

    lengths = to_disp(lengths)
    safe = torch.where(lengths > 0, lengths, torch.ones_like(lengths))
    shift = torch.round(disp / safe) * safe
    wrapped_ortho = torch.where(lengths > 0, disp - shift, disp)

    m = box_to_matrix(box)                       # (..., 3, 3) lower tri
    # guard the inverse so a degenerate box cannot inject NaNs
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    safe_m = m + eye * (m[..., :1, :1].abs() < 1e-9).to(m.dtype)
    inv = torch.linalg.inv_ex(safe_m).inverse
    flat = disp.reshape(lead + (-1, 3))
    frac = flat @ inv
    frac = frac - torch.round(frac)
    wrapped_tric = (frac @ m).reshape(disp.shape)

    return torch.where(has_box, torch.where(ortho, wrapped_ortho,
                                            wrapped_tric), disp)


def _sq_norm(disp: torch.Tensor) -> torch.Tensor:
    """``x² + y² + z²`` in that order, one elementwise op at a time (the
    CUDA kernel's order and rounding)."""
    x, y, z = disp[..., 0], disp[..., 1], disp[..., 2]
    return x * x + y * y + z * z


def distance_array(a: torch.Tensor, b: torch.Tensor,
                   box=None) -> torch.Tensor:
    """Full (N, M) distance matrix (materializes — modest sizes only;
    :func:`pair_histogram` is the scalable path)."""
    disp = minimum_image(a[:, None, :] - b[None, :, :], box)
    return torch.sqrt(_sq_norm(disp))


def self_distance_array(a: torch.Tensor, box=None) -> torch.Tensor:
    """Condensed upper-triangle distances, length N(N-1)/2, in the
    (i<j) row-major order of the upstream API."""
    n = a.shape[0]
    d = distance_array(a, a, box)
    iu, ju = torch.triu_indices(n, n, offset=1, device=a.device)
    return d[iu, ju]


def _pad_tiles(x: torch.Tensor, tile: int):
    """``(n, D)`` → ``(n_tiles, tile, D)`` zero-padded tiles and their
    ``(n_tiles, tile)`` validity (1 for real rows)."""
    n = x.shape[0]
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    valid = torch.nn.functional.pad(
        torch.ones(n, dtype=x.dtype, device=x.device), (0, pad))
    return (xp.reshape(n_tiles, tile, x.shape[1]),
            valid.reshape(n_tiles, tile))


def pair_histogram(
    a: torch.Tensor,              # (N, 3) group-A coordinates
    b: torch.Tensor,              # (M, 3) group-B coordinates
    edges: torch.Tensor,          # (nbins+1,) monotonically increasing
    box=None,
    exclude_self: bool = False,   # True when a and b are the same group
    tile: int = 1024,
    a_offset=0,                   # global index of a[0] (sharded callers)
    b_offset=0,                   # global index of b[0]
    a_weights: torch.Tensor | None = None,   # (N,) per-atom pair weights
    b_weights: torch.Tensor | None = None,   # (M,)
    exclusion_block: tuple | None = None,  # (p, q): drop i//p == j//q
) -> torch.Tensor:
    """Blockwise histogram of pair distances — the RDF inner loop of the
    generic engine, ``(nbins,)`` float32.

    Tiles group B into chunks of ``tile`` atoms; each chunk forms an
    (N, tile) distance block, is bucketized against ``edges``
    (``searchsorted(..., right=True) - 1``: bin k holds
    ``e_k <= d < e_{k+1}``) and scatter-added into the histogram.
    ``exclude_self`` drops i==j pairs (self-RDF); for identical groups
    every pair is counted twice (i→j and j→i), which the RDF
    normalization accounts for.  A pair contributes
    ``a_weights[i]·b_weights[j]`` (1 when not given); ``exclude_self``
    and ``exclusion_block`` compare global indices ``a_offset+i`` and
    ``b_offset+j``.
    """
    dev = a.device
    edges = torch.as_tensor(edges, dtype=a.dtype, device=dev).contiguous()
    nbins = edges.shape[0] - 1
    bt, bvalid = _pad_tiles(b, tile)
    if b_weights is not None:
        bw, _ = _pad_tiles(b_weights[:, None].to(a.dtype), tile)
        bw = bw[..., 0]
    wa = (torch.ones(a.shape[0], dtype=a.dtype, device=dev)
          if a_weights is None else a_weights.to(a.dtype))
    ia = a_offset + torch.arange(a.shape[0], device=dev)[:, None]
    hist = torch.zeros(nbins + 1, dtype=a.dtype, device=dev)
    for t in range(bt.shape[0]):
        disp = minimum_image(a[:, None, :] - bt[t][None, :, :], box)
        d = torch.sqrt(_sq_norm(disp)).reshape(-1)        # (N·tile,)
        wb = bvalid[t] if b_weights is None else bvalid[t] * bw[t]
        w = wa[:, None] * wb[None, :]
        if exclude_self or exclusion_block is not None:
            ib = b_offset + t * tile + torch.arange(tile, device=dev)[None, :]
            if exclude_self:
                w = w * (ia != ib)
            if exclusion_block is not None:
                p, q = exclusion_block
                w = w * (ia // p != ib // q)
        # out-of-range pairs land in bin index nbins (dropped)
        idx = torch.searchsorted(edges, d, right=True) - 1
        idx = torch.where((d >= edges[0]) & (d < edges[-1]), idx, nbins)
        hist += torch.bincount(idx, weights=w.reshape(-1),
                               minlength=nbins + 1)
    return hist[:-1]


def fold_frame_histograms(hists: torch.Tensor, boxes: torch.Tensor,
                          mask: torch.Tensor):
    """Per-frame histograms ``(B, nbins)`` → the RDF batch partials
    ``(counts (nbins,), Σ volume, T)`` over the real frames of ``mask``.

    Volume uses the box-matrix determinant; frames with no box get
    volume 0 (the RDF analysis counts boxed frames and rejects mixed
    runs in ``_conclude``).  Shared by every engine."""
    mask = mask.to(hists.dtype)
    counts = mask @ hists
    vol_sum = (batch_box_volumes(boxes).to(hists.dtype) * mask).sum()
    return counts, vol_sum, mask.sum()


def histogram_batch_from(per_frame_hist):
    """Lift a per-frame histogram fn ``(a, b, box6) -> (nbins,)`` into
    the frame-batch RDF partial reducer: ``(coords_a (B,N,3), coords_b
    (B,M,3), boxes (B,6), mask (B,)) -> (counts (nbins,), Σ volume,
    T)``."""
    def batch(coords_a, coords_b, boxes, mask):
        hists = torch.stack([per_frame_hist(coords_a[f], coords_b[f],
                                            boxes[f])
                             for f in range(coords_a.shape[0])])
        return fold_frame_histograms(hists, boxes, mask)

    return batch


def pair_histogram_batch(
    coords_a: torch.Tensor,       # (B, N, 3)
    coords_b: torch.Tensor,       # (B, M, 3)
    boxes: torch.Tensor,          # (B, 6); zero box = no PBC
    mask: torch.Tensor,           # (B,)
    edges: torch.Tensor,
    exclude_self: bool = False,
    tile: int = 1024,
    exclusion_block: tuple | None = None,
):
    """Per-frame-batch RDF partials ``(counts (nbins,), Σ volume, T)``
    on the generic engine; :func:`minimum_image` handles zero and
    triclinic boxes."""
    return histogram_batch_from(
        lambda a, b, box6: pair_histogram(
            a, b, edges, box=box6, exclude_self=exclude_self, tile=tile,
            exclusion_block=exclusion_block)
    )(coords_a, coords_b, boxes, mask)


def contact_fraction_batch(
    coords: torch.Tensor,         # (B, S, 3)
    boxes: torch.Tensor,          # (B, 6)
    mask: torch.Tensor,           # (B,)
    cutoff,
):
    """Per-pair contact counts over a frame batch: ``(counts (S,S), T)``.

    Materializes (S, S) per frame — intended for selection-sized groups
    (contact maps of residues/Cα, BASELINE config 5); the blockwise
    histogram is the path for full systems.
    """
    cut2 = cutoff * cutoff
    contacts = torch.stack([
        (_sq_norm(minimum_image(x[:, None, :] - x[None, :, :], box6))
         < cut2).to(torch.float32)
        for x, box6 in zip(coords, boxes)])
    mask = mask.to(torch.float32)
    return torch.einsum("b,bij->ij", mask, contacts), mask.sum()
