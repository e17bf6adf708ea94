"""The port's hand-written CUDA kernels against their plain torch
versions on the card.

Every test here is marked ``cuda`` and skips, inside the test, where
``torch.cuda.is_available()`` is False.  The file imports nothing of
JAX, so it runs on a GPU machine that has no JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda``.

- ``csrc/fused_rmsf.cu`` (``fused_planar.planar_sums``): the mean within
  5e-4 and M2 within 5e-3 of the plain version (tests/test_pallas_fused
  .py's tolerances), two launches bit-identical.
- ``csrc/pair_histogram.cu`` (``fused_distances.pair_histogram``): the
  counts EQUAL to the plain version's (the kernel writes every step with
  round-to-nearest intrinsics in the plain version's order), two
  launches bit-identical.
"""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd
from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
from mdanalysis_mpi_tpu_torch.ops import fused_rmsf as fr
from mdanalysis_mpi_tpu_torch.staging import quantize_block

BOX = np.array([25.0, 25.0, 25.0, 90.0, 90.0, 90.0], np.float32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_real,dtype,valid_b", [
    (16, 100, "int16", None),      # one TPU frame tile
    (32, 250, "int16", 30),        # masked tail frames
    (32, 250, "int8", None),       # int8 tier
    (48, 511, "int16", 47),        # S = 512, uneven tail
    (16, 256, "int16", None),      # exact-width selection (no padding)
    (1, 300, "int16", None),
    (56, 3000, "float32", 50)])
def test_cuda_kernel_matches_plain(B, n_real, dtype, valid_b):
    """Frames are rigid rotations and shifts of the reference plus 0.3 Å
    noise (the JAX package's planar test case): the regime the
    tolerances are set for.  Frames uncorrelated with the reference
    give M2 near 1e4 Å², where float32 rounding alone exceeds 5e-3."""
    dev = _card()
    r = np.random.default_rng(B + n_real)
    pidx, nr = fr.pad_selection(np.arange(n_real))
    S = len(pidx)
    refc = r.normal(size=(nr, 3)) * 4
    refc -= refc.mean(axis=0)
    coords = np.empty((B, S, 3), np.float32)
    for f in range(B):
        U, _, Vt = np.linalg.svd(r.normal(size=(3, 3)))
        if np.linalg.det(U @ Vt) < 0:
            U[:, -1] *= -1
        coords[f] = (refc @ (U @ Vt).T + r.normal(size=(nr, 3)) * 0.3
                     + r.normal(size=3) * 10)[pidx]
    if dtype == "float32":
        qp, inv = np.ascontiguousarray(np.moveaxis(coords, 2, 0)), 1.0
    else:
        qp, inv = quantize_block(coords, dtype, layout="planar")
    params = fr.build_params(refc, np.zeros(3), r.uniform(1, 12, size=nr),
                             nr, S)
    wN, refc_p, _, amask, sref = (p.to(dev) for p in params)
    mask = np.zeros(B, np.float32)
    mask[:B if valid_b is None else valid_b] = 1.0
    args = (_t(qp).to(dev), float(inv), wN, refc_p, amask, sref,
            _t(mask).to(dev))
    n0 = fp.planar_sums.launches
    out = fp.planar_sums(*args)
    again = fp.planar_sums(*args)
    plain = fp.planar_sums_plain(*args)
    torch.cuda.synchronize()
    assert fp.planar_sums.launches == n0 + 2
    assert torch.equal(out, again)
    T = float(mask.sum())
    torch.testing.assert_close(out[:3] / T, plain[:3] / T, rtol=0,
                               atol=5e-4)
    torch.testing.assert_close(out[3:] - out[:3] ** 2 / T,
                               plain[3:] - plain[:3] ** 2 / T, rtol=0,
                               atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("na,nb,box,nbins,excl", [
    (40, 70, BOX, 48, False),
    (300, 515, BOX, 48, False),
    (200, 333, None, 48, False),       # no box: no wrap
    (150, None, BOX, 48, True),        # self pairs excluded
    (256, 256, BOX, 1, False),
    (256, 256, BOX, 512, False),
    (1500, 1100, BOX, 75, False)])     # several A and B tiles
def test_cuda_pair_histogram_matches_plain(na, nb, box, nbins, excl):
    dev = _card()
    r = np.random.default_rng(na)
    a = _t(r.uniform(0, 25, size=(2, na, 3)).astype(np.float32)).to(dev)
    b = a if nb is None else _t(
        r.uniform(0, 25, size=(2, nb, 3)).astype(np.float32)).to(dev)
    tbox = None if box is None else _t(box).to(dev)
    edges = _t(np.linspace(0.0, 12.0, nbins + 1).astype(np.float32)).to(dev)
    n0 = fd.pair_histogram.launches
    out = fd.pair_histogram(a, b, box=tbox, exclude_self=excl, edges=edges)
    again = fd.pair_histogram(a, b, box=tbox, exclude_self=excl,
                              edges=edges)
    plain = fd.pair_histogram_plain(a, b, fd._lengths(tbox, 2, dev), edges,
                                    excl)
    torch.cuda.synchronize()
    assert fd.pair_histogram.launches == n0 + 2
    assert torch.equal(out, again)
    assert torch.equal(out, plain)
    assert float(out.sum()) > 0


@pytest.mark.cuda
def test_cuda_pair_histogram_rejects_cpu_mixed_inputs():
    dev = _card()
    a = torch.zeros((1, 8, 3), device=dev)
    with pytest.raises(ValueError, match="must be a contiguous float32"):
        fd._launch(a, torch.zeros((1, 8, 3)), torch.zeros((1, 3), device=dev),
                   torch.linspace(0, 1, 5, device=dev), False)
