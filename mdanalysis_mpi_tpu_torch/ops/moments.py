"""Streaming-moment ops: batched Welford + Chan parallel merge.

The reference accumulates per-atom mean and sum-of-squared-deviations one
frame at a time (Welford form, RMSF.py:137-138) and merges per-rank
partials with Chan et al.'s pairwise formula (``second_order_moments``,
RMSF.py:36-41).  Here the recurrence is the algebraically identical
*batch* form — one masked reduction per frame batch — and the
cross-batch merge is the Chan pairwise merge, on the device in float32
(torch) or on the host in float64 (NumPy).

A moment summary is the triple ``(T, mean, M2)``: ``T`` frames counted
(scalar), ``mean`` (..., 3), ``M2`` = sum of squared deviations from the
mean (..., 3).
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch import device as _device  # noqa: F401  (TF32 off)


def batch_moments(x: torch.Tensor, mask: torch.Tensor | None = None):
    """Moments of a frame batch in one pass.

    x: (B, N, 3) aligned coordinates; mask: (B,) 1.0 for valid frames,
    0.0 for padding.  Returns (T, mean, M2) with mean/M2 of shape (N, 3)
    and T a 0-d tensor.  For T == 0, mean and M2 are 0.
    """
    if mask is None:
        t = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
        mean = x.sum(dim=0) / torch.clamp(t, min=1.0)
        m2 = ((x - mean) ** 2).sum(dim=0)
    else:
        mask = mask.to(x.dtype)
        t = mask.sum()
        s = torch.einsum("b,bni->ni", mask, x)
        mean = s / torch.clamp(t, min=1.0)
        m2 = torch.einsum("b,bni->ni", mask, (x - mean) ** 2)
    return t, mean, m2


def merge_moments(s1, s2):
    """Chan pairwise merge of two (T, mean, M2) summaries (RMSF.py:36-41).

    Works on NumPy or torch operands.  Safe for empty partials (T==0).
    """
    t1, mu1, m21 = s1
    t2, mu2, m22 = s2
    t = t1 + t2
    if isinstance(t, torch.Tensor):
        denom = torch.clamp(t, min=1)
    else:
        denom = max(t, 1)
    mu = (t1 * mu1 + t2 * mu2) / denom
    m2 = m21 + m22 + (t1 * t2 / denom) * (mu2 - mu1) ** 2
    return t, mu, m2


def reduce_moments(summaries):
    """Fold a list of summaries left-to-right with the Chan merge."""
    it = iter(summaries)
    try:
        acc = next(it)
    except StopIteration:
        raise ValueError("reduce_moments needs at least one summary") from None
    for s in it:
        acc = merge_moments(acc, s)
    return acc


def moments_scan_step(carry, block, mask=None):
    """One scan step (the JAX package's ``moments_scan_step``): fold
    ``block``'s batch moments into the (T, mean, M2) ``carry`` —
    exactly ``merge_moments(carry, batch_moments(block, mask))``."""
    return merge_moments(carry, batch_moments(block, mask))


def scan_moments(blocks, masks=None):
    """Moments of a stacked (K, B, N, 3) block group (the JAX package's
    ``scan_moments``, a ``lax.scan``): the carry seeds from block 0 and
    each step folds one block in block order, so the result equals
    ``reduce_moments`` of the per-block moments.  ``masks``: (K, B) or
    None."""
    acc = batch_moments(blocks[0], None if masks is None else masks[0])
    for k in range(1, blocks.shape[0]):
        acc = moments_scan_step(acc, blocks[k],
                                None if masks is None else masks[k])
    return acc


def psum_moments(summaries, comm=None):
    """K-way moment merge of per-device summaries (the JAX package's
    ``psum_moments``, a merge across a mesh axis).

    Law of total variance:
    ``M2_tot = Σ_k M2_k + Σ_k T_k·(μ_k − μ_tot)²`` — three sums, no
    pairwise fold; exact because the merge is associative and
    commutative (it replaces the reference's pickled custom-op reduce,
    RMSF.py:142-143).

    Two forms:

    - single controller: ``summaries`` is a list of ``(T, mean, M2)``
      partials, one per device shard, each on its own device; the sums
      run on the first summary's device;
    - with ``comm`` (a :class:`~mdanalysis_mpi_tpu_torch.parallel.
      distributed.Collectives`), each of the three sums is then
      all-reduced (SUM) across the process group: ``T``, ``T·mean``,
      then ``M2 + T·(mean − mean_tot)²``.
    """
    dev = summaries[0][1].device

    def on(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    ts = [on(s[0]) for s in summaries]
    means = [on(s[1]) for s in summaries]
    t_tot = sum(ts[1:], ts[0])
    s_tot = sum((t * m for t, m in zip(ts[1:], means[1:])),
                ts[0] * means[0])
    if comm is not None:
        t_tot = comm.all_reduce(t_tot)
        s_tot = comm.all_reduce(s_tot)
    mean_tot = s_tot / torch.clamp(t_tot, min=1.0)
    m2_tot = sum(on(s[2]) + t * (m - mean_tot) ** 2
                 for s, t, m in zip(summaries, ts, means))
    if comm is not None:
        m2_tot = comm.all_reduce(m2_tot)
    return t_tot, mean_tot, m2_tot


def rmsf_from_moments(t, m2):
    """Finalize: RMSF_i = sqrt(Σ_xyz M2_i / T) (reference RMSF.py:146).
    A device ``m2`` stays on its device."""
    if isinstance(m2, torch.Tensor):
        tt = torch.as_tensor(t, dtype=m2.dtype, device=m2.device)
        return torch.sqrt(m2.sum(dim=-1) / torch.clamp(tt, min=1))
    return np.sqrt(m2.sum(axis=-1) / np.maximum(t, 1))
