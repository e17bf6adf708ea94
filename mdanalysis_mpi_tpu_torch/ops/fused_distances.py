"""The pair-distance histogram kernel: its wrapper, its plain PyTorch
version, and the RDF batch function built on it (the counterpart of
the JAX package's ``ops/pallas_distances.py``).

- :func:`pair_histogram` is the wrapper.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/pair_histogram.cu`` (built on first use
  by :mod:`mdanalysis_mpi_tpu_torch._build`) or raises; on a CPU tensor
  it runs :func:`pair_histogram_plain`.  ``pair_histogram.launches``
  counts the kernel launches: one per call, whatever the number of
  frames, since the kernel's grid spans A tiles × B tiles × frames.
- :func:`pair_histogram_plain` is the kernel's plain version: the same
  arithmetic in torch ops, one frame and one tile of group B at a time,
  so its peak memory is O(N·tile).  Its squared distances equal the
  kernel's bit for bit (the kernel writes every step with
  round-to-nearest intrinsics, so nothing is contracted into an FMA,
  and wraps without a division only where that is exact), and the
  kernel's range and bin tests on the squared distance are exact
  rewrites of these on the distance, so the counts are equal.
- :func:`pair_histogram_batch` is the RDF batch function: per-frame
  histograms from one launch, triclinic frames poisoned with NaN, then
  the frame mask and box volumes of
  :func:`mdanalysis_mpi_tpu_torch.ops.distances.fold_frame_histograms`.
- :func:`wrap_nodiv` and :func:`squared_edge_thresholds` are the
  kernel's two exact rewrites in torch (the minimum image without a
  division, the range and bins on the squared distance), so the CPU
  tests can hold them to the plain version's algebra.

The kernel replaces ``mdanalysis_mpi_tpu/ops/pallas_distances.py::
_build_kernel`` (``pl.pallas_call`` at :164).  Its wrap is orthorhombic
only, like the TPU kernel's.  Counts are integers inside the kernel and
float32 from the wrapper on, the precision the JAX package's engines
hand to the fold.  It is bound by operations; its design is described
at the top of the CUDA source.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch import device as _device  # noqa: F401  (TF32 off)
from mdanalysis_mpi_tpu_torch.ops.distances import fold_frame_histograms

#: the kernel's shared-memory histogram holds at most this many bins
MAX_NBINS = 512


def uniform_edges(edges: np.ndarray, rtol: float = 1e-6) -> bool:
    """True when ``edges`` is an affine (linspace) grid — the bin layout
    ``InterRDF``'s ``'auto'`` engine sends to the kernel."""
    e = np.asarray(edges, dtype=np.float64)
    if e.ndim != 1 or e.shape[0] < 2:
        return False
    d = np.diff(e)
    return bool(d.min() > 0 and
                (d.max() - d.min()) <= rtol * max(d.max(), 1e-30))


def _edges_f32(r0, dr, nbins: int, edges, device) -> torch.Tensor:
    """The ``(nbins+1,)`` float32 edges to bin against: ``edges`` cast,
    or ``r0 + k·dr`` synthesized in float64 (a float64 ``np.linspace``
    cast to float32) for Python-scalar ``r0``/``dr``, in float32 for
    tensors."""
    if edges is not None:
        e = torch.as_tensor(edges, device=device)
        return e.to(torch.float32).reshape(nbins + 1).contiguous()
    if isinstance(r0, (int, float)) and isinstance(dr, (int, float)):
        e = (np.float64(r0)
             + np.arange(nbins + 1, dtype=np.float64) * np.float64(dr))
        return torch.as_tensor(e.astype(np.float32), device=device)
    k = torch.arange(nbins + 1, dtype=torch.float32, device=device)
    return (torch.as_tensor(r0, dtype=torch.float32, device=device)
            + k * torch.as_tensor(dr, dtype=torch.float32, device=device))


def _lengths(box, B: int, device) -> torch.Tensor:
    """``box`` (None, ``(6,)`` or ``(B, 6)``) → ``(B, 3)`` float32 box
    lengths; 0 means no wrap on that axis."""
    if box is None:
        return torch.zeros((B, 3), dtype=torch.float32, device=device)
    box = torch.as_tensor(box, device=device).to(torch.float32)
    return box.reshape(-1, 6)[:, :3].expand(B, 3).contiguous()


def wrap_nodiv(d: torch.Tensor, L) -> torch.Tensor:
    """The kernel's minimum image on one axis, for a box length ``L > 0``:
    equals ``d - torch.round(d / L) * L`` (up to the sign of a zero, which
    the square removes) without the division where ``|d| < L``.

    For ``L`` in ``[2^-64, FLT_MAX]`` let ``h = 0.5 * L`` (exact): ``d``
    where ``|d| <= h``, ``d - copysign(L, d)`` where ``h < |d| < L``, and
    the division form where ``|d| >= L``.  An infinite or tinier ``L``
    takes the division form everywhere, as the kernel does."""
    L = torch.as_tensor(L, dtype=d.dtype, device=d.device)
    ad = d.abs()
    div = d - torch.round(d / L) * L
    out = torch.where(ad < L, d - torch.copysign(L, d), div)
    out = torch.where(ad <= 0.5 * L, d, out)
    regular = (L >= 2.0 ** -64) & torch.isfinite(L)
    return torch.where(regular, out, div)


def squared_edge_thresholds(edges: torch.Tensor) -> torch.Tensor:
    """For float32 ``edges`` the thresholds ``t_k``: the smallest float32
    ``t >= 0`` with ``sqrt(t) >= e_k`` (0 where ``e_k <= 0``, NaN for a
    NaN edge).  ``sqrt`` rounded to nearest is monotone, so
    ``sqrt(d2) >= e_k`` exactly when ``d2 >= t_k``, and
    ``searchsorted(t, d2, right=True)`` equals
    ``searchsorted(edges, sqrt(d2), right=True)``.  The kernel computes
    the same ``t_k`` in shared memory: from ``e_k * e_k``, stepped by
    ``nextafter`` until the predicate holds."""
    e = edges.to(torch.float32)
    inf = torch.full_like(e, float("inf"))
    zero = torch.zeros_like(e)
    t = torch.where(e > 0, e * e, zero)
    live = e > 0
    while True:
        up = live & (torch.sqrt(t) < e)
        if not bool(up.any()):
            break
        t = torch.where(up, torch.nextafter(t, inf), t)
    while True:
        p = torch.nextafter(t, zero)
        down = live & (t > 0) & (torch.sqrt(p) >= e)
        if not bool(down.any()):
            break
        t = torch.where(down, p, t)
    return torch.where(torch.isnan(e), e, t)


def pair_histogram_plain(a, b, lengths, edges, exclude_self: bool = False,
                         tile: int = 1024) -> torch.Tensor:
    """The kernel's plain version: ``a`` ``(B, N, 3)``, ``b`` ``(B, M,
    3)``, ``lengths`` ``(B, 3)`` (0 = no wrap), ``edges`` ``(nbins+1,)``
    float32 → ``(B, nbins)`` float32 counts of ``e_k <= d < e_{k+1}``,
    skipping ``i == j`` when ``exclude_self``."""
    B, N, _ = a.shape
    M = b.shape[1]
    nbins = edges.shape[0] - 1
    dev = a.device
    counts = torch.zeros((B, nbins + 1), dtype=torch.int64, device=dev)
    ia = torch.arange(N, device=dev)[:, None]
    for f in range(B):
        L = lengths[f]
        safe = torch.where(L > 0, L, torch.ones_like(L))
        for j0 in range(0, M, tile):
            bj = b[f, j0:j0 + tile]
            d2 = None
            for ax in range(3):
                diff = a[f, :, ax, None] - bj[None, :, ax]
                shift = torch.round(diff / safe[ax]) * safe[ax]
                diff = torch.where(L[ax] > 0, diff - shift, diff)
                d2 = diff * diff if d2 is None else d2 + diff * diff
            d = torch.sqrt(d2)
            inside = (d >= edges[0]) & (d < edges[-1])
            if exclude_self:
                ib = j0 + torch.arange(bj.shape[0], device=dev)[None, :]
                inside = inside & (ia != ib)
            idx = torch.searchsorted(edges, d.reshape(-1), right=True) - 1
            idx = torch.where(inside.reshape(-1), idx, nbins)
            counts[f] += torch.bincount(idx, minlength=nbins + 1)
    return counts[:, :nbins].to(torch.float32)


def _check(name, t, shape, device):
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or tuple(t.shape) != shape or t.device != device
            or not t.is_contiguous()):
        desc = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
                if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(
            f"pair-histogram kernel: {name} must be a contiguous float32 "
            f"tensor of shape {shape} on {device}, got {desc}")


def _launch(a, b, lengths, edges, exclude_self: bool) -> torch.Tensor:
    """Launch ``csrc/pair_histogram.cu`` on the current stream →
    ``(B, nbins)`` int64 counts."""
    from mdanalysis_mpi_tpu_torch import _build

    dev = a.device
    if a.dim() != 3 or a.shape[2] != 3:
        raise ValueError(
            f"pair-histogram kernel: a must be (B, N, 3), got "
            f"{tuple(a.shape)}")
    B, N, _ = a.shape
    M = b.shape[1] if b.dim() == 3 else -1
    nbins = edges.shape[0] - 1
    _check("a", a, (B, N, 3), dev)
    _check("b", b, (B, M, 3), dev)
    _check("lengths", lengths, (B, 3), dev)
    _check("edges", edges, (nbins + 1,), dev)
    counts = torch.zeros((B, nbins), dtype=torch.int64, device=dev)
    if N == 0 or M == 0 or B == 0:
        return counts
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mdtpu_pair_histogram(
            a.data_ptr(), b.data_ptr(), lengths.data_ptr(),
            edges.data_ptr(), B, N, M, nbins, int(bool(exclude_self)),
            counts.data_ptr(), stream)
    if rc != 0:
        raise _build.KernelLaunchError(
            f"pair-histogram kernel launch failed: CUDA error {rc} "
            f"({lib.mdtpu_cuda_error_string(rc).decode()})")
    _build.count_launch(pair_histogram)
    return counts


def pair_histogram(a, b, r0=None, dr=None, nbins: int | None = None,
                   box=None, exclude_self: bool = False, edges=None):
    """Histogram of pair distances — the kernel's wrapper.

    ``a``: ``(N, 3)`` or ``(B, N, 3)`` float32; ``b`` likewise with M
    atoms; bins are ``edges`` when given (any increasing ``(nbins+1,)``
    array, cast to float32 — the RDF analysis passes its own so both
    engines bin against the same values), else ``r0 + k·dr`` for
    ``k = 0..nbins``.  ``box``: ``(6,)`` or ``(B, 6)`` dimensions
    (orthorhombic; lengths 0 = no PBC) or None.  Returns ``(nbins,)`` or
    ``(B, nbins)`` float32 counts.  On a CUDA tensor this launches the
    kernel once for all frames (and counts it in
    ``pair_histogram.launches``) or raises; on a CPU tensor it runs
    :func:`pair_histogram_plain`."""
    single = a.dim() == 2
    if single:
        a, b = a[None], b[None]
    if nbins is None:
        if edges is None:
            raise ValueError("pass nbins (with r0 and dr) or edges")
        nbins = int(np.shape(edges)[0]) - 1
    if not 0 < nbins <= MAX_NBINS:
        raise ValueError(
            f"pair-histogram kernel supports 1..{MAX_NBINS} bins (got "
            f"{nbins}); use the generic engine for finer histograms")
    dev = a.device
    e = _edges_f32(r0, dr, int(nbins), edges, dev)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    lengths = _lengths(box, a.shape[0], dev)
    if dev.type == "cpu":
        h = pair_histogram_plain(a, b, lengths, e, exclude_self)
    elif dev.type == "cuda":
        h = _launch(a, b, lengths, e, exclude_self).to(torch.float32)
    else:
        raise ValueError(
            f"pair-histogram kernel: no kernel for device {dev}")
    return h[0] if single else h


pair_histogram.launches = 0


def pair_histogram_batch(coords_a, coords_b, boxes, mask, edges,
                         exclude_self: bool = False):
    """Batch twin of :func:`mdanalysis_mpi_tpu_torch.ops.distances.
    pair_histogram_batch` on the kernel: per-frame-batch RDF partials
    ``(counts (nbins,), Σ volume, T)`` from one launch.

    The kernel's wrap is orthorhombic-only, so any frame with a
    triclinic box (the same 1e-4-degree cut
    :func:`~mdanalysis_mpi_tpu_torch.ops.distances.minimum_image` uses)
    has its histogram poisoned with NaN — the consuming analysis turns
    non-finite counts into a clear error instead of a silently wrong
    g(r)."""
    h = pair_histogram(coords_a, coords_b, box=boxes,
                       exclude_self=exclude_self, edges=edges)
    triclinic = (((boxes[:, 3:] - 90.0).abs() >= 1e-4).any(dim=1)
                 & (boxes[:, :3].min(dim=1).values > 0))
    h = torch.where(triclinic[:, None], torch.full_like(h, float("nan")), h)
    return fold_frame_histograms(h, boxes, mask)
