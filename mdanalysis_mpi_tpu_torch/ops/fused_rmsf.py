"""The fused aligned-moments path's contract: selection padding, the
params tuple, engine validation and routing, and the interleaved
form of the algebra (the counterpart of the JAX package's
``ops/pallas_rmsf.py``).  The kernel itself, its plain version and
its wrapper live in :mod:`mdanalysis_mpi_tpu_torch.ops.fused_planar`.

Algebra (the reference computes the same quantities per frame at
RMSF.py:94-101/124-138):

- Each frame needs its selection COM and its Kabsch correlation
  ``H = Σ_n (x_n − com)·ref_nᵀ = Σ_n x_n·ref_nᵀ − com ⊗ Σ ref`` — one
  sweep over the raw block yields ``Σ w·x`` (the COM) and ``Σ x·refᵀ``
  (12 running scalars per frame), and the rank-1 term fixes up the
  no-COM correlation.
- The moments accumulate per-atom sums of the deviation from the
  reference, ``d = (x − com)·R − ref_c``; shifting by ``ref_c`` keeps
  the sum-of-squares form safe in float32, and mean and M2 recover as
  ``mean = ref_c + ref_com + Σd/T``, ``M2 = Σd² − (Σd)²/T``.

Callers pad the *selection* (not the block) so ``S`` is a multiple of
:data:`ATOM_TILE`; padding atoms replicate index 0 with zero weight,
zero reference row and a zero atom-mask lane, so they are exact no-ops
in every accumulation (see :func:`pad_selection`).
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.ops.align import kabsch_from_correlation

ATOM_TILE = 256                 # selection-padding granule (atoms)

VALID_ENGINES = (None, "auto", "fused")


def pad_selection(idx: np.ndarray):
    """Pad a selection index array to the next multiple of
    :data:`ATOM_TILE`, padding entries replicating index 0 (a real,
    gatherable atom — masked out of every sum by zero weights and zero
    mask lanes).  Returns ``(padded_idx, n_real)``."""
    idx = np.asarray(idx)
    n = len(idx)
    n_pad = -(-max(n, 1) // ATOM_TILE) * ATOM_TILE
    if n == n_pad:
        return idx, n
    out = np.zeros(n_pad, dtype=idx.dtype)
    out[:n] = idx
    return out, n


def build_params(ref_sel_c, ref_com, masses, n_real: int, n_pad: int):
    """``(wN, refc_p, ref_com, amask, Σref_c)`` float32 params of the
    fused path, padded to ``n_pad`` atoms.  Built on the device of
    ``ref_sel_c`` when it is a tensor (pass 2's reference is the
    device-resident pass-1 average), else on the CPU; the executor
    moves them to its device."""
    dev = (ref_sel_c.device if isinstance(ref_sel_c, torch.Tensor)
           else torch.device("cpu"))
    f32 = torch.float32
    refc = torch.as_tensor(ref_sel_c, device=dev).to(f32)
    refc_p = torch.zeros((n_pad, 3), dtype=f32, device=dev)
    refc_p[:n_real] = refc
    m = torch.as_tensor(np.asarray(masses, np.float32), device=dev)
    wN = torch.zeros(n_pad, dtype=f32, device=dev)
    wN[:n_real] = m / m.sum()
    amask = (torch.arange(n_pad, device=dev) < n_real).to(f32)
    return (wN, refc_p, torch.as_tensor(ref_com, device=dev).to(f32),
            amask, refc_p.sum(dim=0))


def params_from_numpy(wN, refc_p, ref_com, amask, sref, device):
    """The JAX package's fused params tuple (``pallas_rmsf.build_params``)
    given as numpy arrays → the port's float32 tensors on ``device``, so
    both packages can be fed identical state."""
    return tuple(torch.as_tensor(np.array(a, np.float32), device=device)
                 for a in (wN, refc_p, ref_com, amask, sref))


def validate_engine(engine) -> None:
    """Constructor-time check: a misspelled engine (e.g. 'Fused') must
    fail loudly, not silently take the generic path."""
    if engine not in VALID_ENGINES:
        raise ValueError(
            f"engine must be one of {VALID_ENGINES}, got {engine!r} "
            "('fused' = the quantized-native fused kernel on "
            "int16/int8/delta-staged runs)")


def quantized_batch(kind: str, engine, transfer_dtype: str, idx,
                    ref_sel_c, ref_com, weights):
    """The one ``(fn, params, padded_sel)`` assembly both AlignedRMSF
    passes share (``executors._quantized_native`` contract), so the
    padded selections — and with them the device block cache keys —
    cannot diverge between pass 1 and pass 2.  Returns None unless
    ``engine='fused'`` and the staging is quantized.

    Routing: int16/int8 blocks stage as planar ``(3, B, S)`` planes
    (``staging_layout='planar'``) and run the fused kernel's wrapper,
    which launches the CUDA kernel on a CUDA device and runs its plain
    version on the CPU; the delta tier reconstructs on the device from
    its native 6-tuple and feeds the same wrapper float32 planes."""
    if engine != "fused":
        return None
    if transfer_dtype == "float32":
        # no quantized block to fuse over: the generic float32 path is
        # already dequant-free
        return None
    if transfer_dtype not in ("int16", "int8", "delta"):
        raise ValueError(
            f"engine='fused' supports quantized staging "
            f"(int16/int8/delta) or the float32 fallback, not "
            f"{transfer_dtype!r}")
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    idx_p, n_real = pad_selection(idx)
    params = build_params(ref_sel_c, ref_com, weights, n_real, len(idx_p))
    if transfer_dtype == "delta":
        kernel_for = {"moments": fp.moments_delta_kernel_for,
                      "avg": fp.avg_delta_kernel_for}[kind]
    else:
        kernel_for = {"moments": fp.moments_kernel_for,
                      "avg": fp.avg_kernel_for}[kind]
    return kernel_for(n_real), params, idx_p


def _core(q, inv_scale, wN, refc_p, amask, sref, fmask):
    """The interleaved form (Kabsch by :func:`~mdanalysis_mpi_tpu_torch.
    ops.align.kabsch_from_correlation`): quantized ``(B, S, 3)`` block →
    ``(T, Σdev, Σdev²)`` with ``dev = (x−com)·R − ref_c``, padded atoms
    zeroed; sums shaped ``(S, 3)``.  ``inv_scale`` is a scalar or a
    ``(B, 1, 1)`` per-frame array.  Plain torch; the oracle the fused
    kernel is held against (the JAX package's ``pallas_rmsf._core``
    with ``engine='xla'``)."""
    B = q.shape[0]
    inv_col = torch.as_tensor(inv_scale, dtype=torch.float32,
                              device=q.device).reshape(-1, 1).expand(B, 1)
    fm_col = fmask.to(torch.float32).reshape(B, 1)
    x = q.to(torch.float32) * inv_col[:, :, None]
    com = torch.einsum("bni,n->bi", x, wN)
    h = torch.einsum("bni,nj->bij", x, refc_p)
    h = h - com[:, :, None] * sref[None, None, :]
    r = kabsch_from_correlation(h)
    d = torch.einsum("bni,bij->bnj", x - com[:, None], r) - refc_p
    d = d * amask[None, :, None]
    dm = d * fm_col[:, :, None]
    return fm_col.sum(), dm.sum(dim=0), (dm * d).sum(dim=0)
