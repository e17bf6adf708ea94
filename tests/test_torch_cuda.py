"""The port's hand-written CUDA kernels against their plain torch
versions on the card.

Every test here is marked ``cuda`` and skips, inside the test, where
``torch.cuda.is_available()`` is False.  The file imports nothing of
JAX, so it runs on a GPU machine that has no JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda``.

- ``csrc/fused_rmsf.cu`` (``fused_planar.planar_sums``): the mean within
  5e-4 and M2 within 5e-3 of the plain version (tests/test_pallas_fused
  .py's tolerances), two launches bit-identical, on the kernel's edges:
  B not a multiple of the frame group, S = 256 (fewer blocks than SMs),
  the main shape (131 blocks on an H100), slices above 384 atoms (the
  sums' shared-memory path), a per-frame scale given as a
  device tensor, a launch on a side stream (bit-identical to the
  default stream's), and the wrapper raising for S % 256 != 0 and for S
  beyond the shared-memory limit.
- ``csrc/pair_histogram.cu`` (``fused_distances.pair_histogram``): the
  counts EQUAL to the plain version's (every float step is one
  round-to-nearest intrinsic and the kernel's division-free minimum
  image and squared-distance bins are exact rewrites), two launches
  bit-identical, on every branch of the kernel: unwrapped coordinates
  (the division branch), ragged self-exclusion, non-uniform edges, a
  first edge above 0, box-less and infinite axes, NaN coordinates, a
  centred box and B atoms on both sides of the per-B-atom choice of
  the division-free form.
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


def _fused_case(B, n_real, dtype, valid_b, dev, seed):
    """Staged planes and fused params on the card: frames are rigid
    rotations and shifts of the reference plus 0.3 Å noise (the JAX
    package's planar test case) → (args of planar_sums, T)."""
    r = np.random.default_rng(seed)
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
    return ((_t(qp).to(dev), float(inv), wN, refc_p, amask, sref,
             _t(mask).to(dev)), float(mask.sum()))


def _assert_moments_close(out, plain, T):
    torch.testing.assert_close(out[:3] / T, plain[:3] / T, rtol=0,
                               atol=5e-4)
    torch.testing.assert_close(out[3:] - out[:3] ** 2 / T,
                               plain[3:] - plain[:3] ** 2 / T, rtol=0,
                               atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_real,dtype,valid_b", [
    (16, 100, "int16", None),      # one TPU frame tile
    (32, 250, "int16", 30),        # masked tail frames
    (32, 250, "int8", None),       # int8 tier
    (48, 511, "int16", 47),        # S = 512, uneven tail
    (16, 256, "int16", None),      # exact-width selection (no padding)
    (1, 300, "int16", None),
    (56, 3000, "float32", 50),
    (100, 3000, "int16", 97),      # B not a multiple of the group (12)
    (100, 3000, "int8", None),     # ... of 24
    (100, 3000, "float32", 99),    # ... of 6
    (12, 200, "int16", None),      # S = 256: 16 blocks of 16 atoms
    (512, 50000, "int16", 510),    # the main shape: 131 blocks of 384
    (24, 60000, "int16", 23)])     # slices above 384 atoms: w and ref
                                   # from shared memory, 2+ pairs a thread
def test_cuda_kernel_matches_plain(B, n_real, dtype, valid_b):
    """Frames uncorrelated with the reference would give M2 near 1e4
    Å², where float32 rounding alone exceeds 5e-3: the inputs are the
    regime the tolerances are set for."""
    dev = _card()
    args, T = _fused_case(B, n_real, dtype, valid_b, dev, seed=B + n_real)
    n0 = fp.planar_sums.launches
    out = fp.planar_sums(*args)
    again = fp.planar_sums(*args)
    plain = fp.planar_sums_plain(*args)
    torch.cuda.synchronize()
    assert fp.planar_sums.launches == n0 + 2
    assert torch.equal(out, again)
    _assert_moments_close(out, plain, T)


@pytest.mark.cuda
def test_cuda_kernel_per_frame_scale_on_the_device():
    """A per-frame scale given as a (B,) device tensor, every frame's
    different, is read on the card (never on the host)."""
    dev = _card()
    args, T = _fused_case(40, 1000, "int16", 37, dev, seed=40)
    inv = args[1] * (1.0 + 0.01 * torch.arange(40, device=dev,
                                                dtype=torch.float32))
    args = (args[0], inv) + args[2:]
    out = fp.planar_sums(*args)
    again = fp.planar_sums(*args)
    plain = fp.planar_sums_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _assert_moments_close(out, plain, T)


@pytest.mark.cuda
def test_cuda_kernel_side_stream_is_bit_identical():
    """A launch on a side stream gives the default stream's result bit
    for bit."""
    dev = _card()
    args, T = _fused_case(64, 2000, "int16", 60, dev, seed=64)
    out = fp.planar_sums(*args)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        again = fp.planar_sums(*args)
    torch.cuda.current_stream(dev).wait_stream(side)
    plain = fp.planar_sums_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _assert_moments_close(out, plain, T)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unpadded", "beyond-limit"])
def test_cuda_kernel_wrapper_raises_outside_its_envelope(case):
    """S % 256 != 0 and S beyond the shared-memory limit raise before
    any launch."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S = 300 if case == "unpadded" else fp.fused_max_atoms(2, sms) + 256
    qp = torch.zeros((3, 2, S), dtype=torch.int16, device=dev)
    vec = torch.zeros(S, device=dev)
    n0 = fp.planar_sums.launches
    match = "multiple of 256" if case == "unpadded" else "exceeds the limit"
    with pytest.raises(ValueError, match=match):
        fp.planar_sums(qp, 0.01, vec, torch.zeros((S, 3), device=dev), vec,
                       torch.zeros(3, device=dev), torch.ones(2, device=dev))
    assert fp.planar_sums.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "int8", "float32"])
def test_cuda_kernel_at_the_shared_memory_limit(dtype, monkeypatch):
    """The wrapper's sizing (``fused_smem_bytes``) against the kernel's
    own layout, which its entry point checks: at the largest S the
    wrapper takes (one frame a group in two stages) the launch goes
    through and matches the plain version; the same slices with a third
    stage are refused by the entry point."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    itemsize = {"int16": 2, "int8": 1, "float32": 4}[dtype]
    S = fp.fused_max_atoms(itemsize, sms)
    args, T = _fused_case(2, S, dtype, None, dev, seed=S)
    geometry = fp.fused_geometry(2, S, itemsize, sms)
    assert geometry[2:] == (1, 2)
    out = fp.planar_sums(*args)
    plain = fp.planar_sums_plain(*args)
    torch.cuda.synchronize()
    _assert_moments_close(out, plain, T)
    monkeypatch.setattr(fp, "fused_geometry",
                        lambda *a: geometry[:3] + (3,))
    with pytest.raises(RuntimeError, match="CUDA error"):
        fp.planar_sums(*args)


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


def _pair_case(case, r):
    """(a, b, boxes (B, 6), edges, exclude_self) of one redesign case,
    as numpy float32."""
    L = np.float32(25.0)
    a = r.uniform(0, L, (2, 1500, 3)).astype(np.float32)
    b = r.uniform(0, L, (2, 1100, 3)).astype(np.float32)
    boxes = np.tile(BOX, (2, 1))
    edges = np.linspace(0.0, 12.0, 76)
    excl = False
    if case == "unwrapped":
        # coordinates over [-L, 2L): pairs with |d| >= L take the
        # kernel's division branch
        a += L * r.integers(-1, 2, a.shape).astype(np.float32)
        b += L * r.integers(-1, 2, b.shape).astype(np.float32)
    elif case == "self-ragged":
        # N = 1500 and M = 1100: neither a multiple of the tiles nor of R
        b = a[:, :1100].copy()
        excl = True
    elif case == "self-same":
        a = a[:, :1037]
        b = a
        excl = True
    elif case == "non-uniform":
        edges = np.concatenate([[0.0], np.geomspace(0.3, 12.0, 60)])
    elif case == "edge-above-0":
        edges = np.linspace(3.5, 12.0, 40)
    elif case == "box-less-frame":
        boxes[1, :3] = 0.0
    elif case == "no-wrap-on-z":
        boxes[0, 2] = 0.0
    elif case == "infinite-box":
        boxes[0, 1] = np.inf
    elif case == "nan-coordinates":
        a[0, ::97, 1] = np.nan
        b[1, ::31, 0] = np.nan
    elif case == "just-outside-box":
        # a few atoms at L and slightly below 0: B atoms within reach of
        # an A atom at |d| >= L take the division form
        a[:, :5, 0] = L
        b[:, :5, 2] = np.float32(-1e-6)
    elif case == "centred-box":
        # coordinates in [-L/2, L/2): every B atom takes the min form
        a -= L / 2
        b -= L / 2
    elif case == "flag-edge":
        # an A atom just below L and B atoms within ulps of 0 on both
        # sides: the per-B-atom choice of form flips among them
        a[:, 0, 0] = np.nextafter(L, np.float32(0))
        b[:, :64, 0] = (np.arange(-32, 32) * 1e-6).astype(np.float32)
    return a, b, boxes, edges.astype(np.float32), excl


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "unwrapped", "self-ragged", "self-same", "non-uniform", "edge-above-0",
    "box-less-frame", "no-wrap-on-z", "infinite-box",
    "nan-coordinates", "just-outside-box", "centred-box", "flag-edge"])
def test_cuda_pair_histogram_equals_plain_on_every_branch(case):
    """The redesigned kernel's rewrites are exact, so its counts EQUAL
    the plain version's whichever branch a pair takes."""
    dev = _card()
    a, b, boxes, edges, excl = _pair_case(case, np.random.default_rng(17))
    a, b = _t(a).to(dev), _t(b).to(dev)
    tbox, e = _t(boxes).to(dev), _t(edges).to(dev)
    out = fd.pair_histogram(a, b, box=tbox, exclude_self=excl, edges=e)
    again = fd.pair_histogram(a, b, box=tbox, exclude_self=excl, edges=e)
    plain = fd.pair_histogram_plain(a, b, fd._lengths(tbox, 2, dev), e, excl)
    torch.cuda.synchronize()
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
