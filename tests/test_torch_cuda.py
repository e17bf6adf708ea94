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
  default stream's), the wrapper raising for S % 256 != 0, and the wide
  mode beyond the single-read form's shared-memory limit: the first
  wide S of each dtype and S = 1,048,576 against the plain version, the
  edges of its unit order (a short last frame group, short last chunks
  of both passes, three windows of records), an
  int8 block of more than 2^31 elements against the plain version
  summed over frame chunks, a CUDA-graph replay and its kernel nodes,
  and AlignedRMSF at 700,160 atoms against the generic engine.
- ``csrc/pair_histogram.cu`` (``fused_distances.pair_histogram``): the
  counts EQUAL to the plain version's (every float step is one
  round-to-nearest intrinsic and the kernel's division-free minimum
  image and squared-distance bins are exact rewrites), two launches
  bit-identical, on every branch of the kernel: unwrapped coordinates
  (the division branch), ragged self-exclusion, non-uniform edges, a
  first edge above 0, box-less and infinite axes, NaN coordinates, a
  centred box and B atoms on both sides of the per-B-atom choice of
  the division-free form.

Also the torch-op paths of neighbour search on the card (no hand
kernel): the cell list against the host grid, ``self_pair_counts``, the
default device resolving to ``cuda``, and the HBond batch path against
the serial oracle and under a replayed graph; and the torch-op routes
of slice 11: the pair-RMSD matrix (DistanceMatrix, encore) against its
CPU run, the Fréchet wavefront against the host recurrence on the
card's own cross matrix, WOR's device lag sums and DielectricConstant
on the card and its mesh against serial; and the fused kernel fed from
a TRR and an AMBER NetCDF (slice 12's readers), equal to a MemoryReader
of the same frames; and the serving tier on the card: both kernels
launching inside a scheduler's worker, an open breaker refusing a job
rather than finishing it on serial, and the mesh's warmup and stage;
and the fleet tier on the card: the federated fused-blocks counter as a
launch count, and a one-host fleet serving a job bit-equal to its solo
run; and the lint's capture contracts (``lint/graphcontracts.py``) on
the captured group graphs of the registered programs: no collective in
a body, one combine a scan group, no host constants over the budget,
hand-kernel graph nodes equal to the recorded launches, replays equal
to the eager groups, and the seeded 2 MiB pinned host copy firing
MDT111.
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
    (24, 60000, "int16", 23),      # slices above 384 atoms: w and ref
                                   # from shared memory, 2+ pairs a thread
    (31, 2, "float32", 10),        # two atoms: QCP's top eigenvalue is
    (40, 2, "int16", None),        # double (chip_smoke phase 18's case;
    (24, 2, "int8", 20)])          # a float32 solve missed by 5e-3)
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
@pytest.mark.parametrize("case", ["unpadded", "beyond-limit",
                                  "misaligned"])
def test_cuda_kernel_wrapper_raises_outside_its_envelope(case):
    """S % 256 != 0 and parameters not 16-byte aligned raise before any
    launch.  S beyond the single-read form's shared-memory limit is
    inside the envelope since the wide mode: it launches once and
    matches the plain version."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n0 = fp.planar_sums.launches
    if case == "beyond-limit":
        args, T = _card_case(2, fp.fused_max_atoms(2, sms) + 256, "int16",
                             dev, seed=5)
        out = fp.planar_sums(*args)
        plain = fp.planar_sums_plain(*args)
        torch.cuda.synchronize()
        assert fp.planar_sums.launches == n0 + 1
        _assert_moments_close(out, plain, T)
        return
    S = 300 if case == "unpadded" else 256
    qp = torch.zeros((3, 2, S), dtype=torch.int16, device=dev)
    vec = torch.zeros(S, device=dev)
    w = vec if case == "unpadded" else torch.zeros(S + 1, device=dev)[1:]
    match = "multiple of 256" if case == "unpadded" else "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        fp.planar_sums(qp, 0.01, w, torch.zeros((S, 3), device=dev), vec,
                       torch.zeros(3, device=dev), torch.ones(2, device=dev))
    assert fp.planar_sums.launches == n0


def _card_case(B, S, dtype, dev, seed, valid_b=None, step=32):
    """A case of S real atoms made on the card (wide selections are slow
    to make on the host): frames are rigid rotations and shifts of a
    reference of scale 4 Å plus 0.3 Å noise, as in ``_fused_case``,
    staged ``step`` frames at a time with a per-frame scale → (args of
    planar_sums, T)."""
    r = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    refc = 4.0 * torch.randn((S, 3), generator=g, device=dev)
    refc -= refc.mean(dim=0)
    wN, refc_p, _, amask, sref = fr.build_params(
        refc, np.zeros(3), r.uniform(1, 12, size=S), S, S)
    U, _, Vt = np.linalg.svd(r.normal(size=(B, 3, 3)))
    U[np.linalg.det(U @ Vt) < 0, :, -1] *= -1
    rots = torch.from_numpy((U @ Vt).astype(np.float32)).to(dev)
    qp = torch.empty((3, B, S), dtype=getattr(torch, dtype), device=dev)
    inv = torch.ones(B, device=dev)
    for f0 in range(0, B, step):
        f1 = min(B, f0 + step)
        x = torch.einsum("sj,bij->bsi", refc, rots[f0:f1])
        x += 10.0 * torch.randn((f1 - f0, 1, 3), generator=g, device=dev)
        x += 0.3 * torch.randn(x.shape, generator=g, device=dev)
        planes = x.permute(2, 0, 1)
        if dtype == "float32":
            qp[:, f0:f1] = planes
            continue
        top = 32767.0 if dtype == "int16" else 127.0
        inv[f0:f1] = planes.abs().amax(dim=(0, 2)) / top
        qp[:, f0:f1] = torch.round(planes / inv[None, f0:f1, None]).to(
            qp.dtype)
        del x, planes
    fmask = torch.zeros(B, device=dev)
    fmask[:B if valid_b is None else valid_b] = 1.0
    return (qp, inv, wN, refc_p, amask, sref, fmask), float(fmask.sum())


def _plain_by_frames(args, step=64):
    """The plain version over frame chunks, summed in float64: the same
    function where the whole block's float32 temporaries would not fit
    on the card."""
    qp, inv, wN, refc_p, amask, sref, fmask = args
    total = 0.0
    for f0 in range(0, qp.shape[1], step):
        total = total + fp.planar_sums_plain(
            qp[:, f0:f0 + step], inv[f0:f0 + step], wN, refc_p, amask,
            sref, fmask[f0:f0 + step]).double()
    return total.float()


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["first-wide", "1048576"])
@pytest.mark.parametrize("dtype", ["int16", "int8", "float32"])
def test_cuda_wide_mode_matches_plain(dtype, width):
    """Beyond the single-read limit (the first wide S of each dtype, one
    padding granule above it, and S = 1,048,576) the kernel's wide mode
    matches the plain version, one launch a call, two launches bit for
    bit."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    itemsize = {"int16": 2, "int8": 1, "float32": 4}[dtype]
    S = (fp.fused_max_atoms(itemsize, sms) + 256 if width == "first-wide"
         else int(width))
    assert len(fp.fused_geometry(13, S, itemsize, sms)) == 7
    args, T = _card_case(13, S, dtype, dev, seed=S, valid_b=11)
    n0 = fp.planar_sums.launches
    out = fp.planar_sums(*args)
    again = fp.planar_sums(*args)
    plain = fp.planar_sums_plain(*args)
    torch.cuda.synchronize()
    assert fp.planar_sums.launches == n0 + 2
    assert torch.equal(out, again)
    _assert_moments_close(out, plain, T)


def _short_last_chunks(itemsize, sms, B):
    """The least wide S above the single-read limit whose slices end in a
    short chunk of both passes → (S, geometry)."""
    S = fp.fused_max_atoms(itemsize, sms)
    while True:
        S += 256
        geometry = fp.fused_geometry(B, S, itemsize, sms)
        slice_atoms, chunk, chunk_b = geometry[0], geometry[4], geometry[6]
        if slice_atoms % chunk and slice_atoms % chunk_b:
            return S, geometry


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["last-group-short", "short-chunks-int16",
                                  "short-chunks-int8",
                                  "short-chunks-float32", "three-windows"])
def test_cuda_wide_mode_unit_order_edges(case):
    """The wide mode's unit order at its edges, against the plain version
    (summed over frame chunks in float64), one launch a call and two
    launches bit for bit: B = 509 at S = 1,048,576, whose last group of
    either pass is cut short; a wide S whose slices end in a short chunk
    of both passes, each dtype; and B = 1,100, three windows of records
    whose sums wait in the output between them.  A masked frame tail
    and per-frame scales throughout."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dtype = {"last-group-short": "int16", "three-windows": "int8"}.get(
        case, case.rsplit("-", 1)[-1])
    itemsize = {"int16": 2, "int8": 1, "float32": 4}[dtype]
    B = 1100 if case == "three-windows" else 509
    if case == "last-group-short":
        S = 1_048_576
        geometry = fp.fused_geometry(B, S, itemsize, sms)
        assert B % geometry[2] and B % geometry[5]
    elif case == "three-windows":
        S = fp.fused_max_atoms(itemsize, sms) + 256
        geometry = fp.fused_geometry(B, S, itemsize, sms)
        assert -(-B // fp.WIDE_RECORDS) == 3
    else:
        S, geometry = _short_last_chunks(itemsize, sms, B)
    assert len(geometry) == 7
    args, T = _card_case(B, S, dtype, dev, seed=B + S, valid_b=B - 3)
    n0 = fp.planar_sums.launches
    out = fp.planar_sums(*args)
    again = fp.planar_sums(*args)
    plain = _plain_by_frames(args)
    torch.cuda.synchronize()
    assert fp.planar_sums.launches == n0 + 2
    assert torch.equal(out, again)
    _assert_moments_close(out, plain, T)


@pytest.mark.cuda
def test_cuda_wide_mode_int8_beyond_2_31_elements():
    """An int8 block of 512 frames of 1,441,792 atoms holds more than
    2^31 elements: the kernel's 64-bit row offsets reach every frame
    (the plain version summed over frame chunks in float64)."""
    dev = _card()
    B, S = 512, 1_441_792
    assert 3 * B * S > 2 ** 31
    args, T = _card_case(B, S, "int8", dev, seed=8, valid_b=509)
    out = fp.planar_sums(*args)
    plain = _plain_by_frames(args)
    torch.cuda.synchronize()
    _assert_moments_close(out, plain, T)


@pytest.mark.cuda
def test_cuda_wide_mode_graph_replay_and_nodes():
    """A wide call captured in a CUDA graph replays equal to its eager
    run, and the graph holds one hand-kernel node, the launch its
    capture recorded (MDT111's count)."""
    from mdanalysis_mpi_tpu_torch import _build
    from mdanalysis_mpi_tpu_torch.lint import graphcontracts as gc

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    args, _ = _card_case(30, fp.fused_max_atoms(1, sms) + 256, "int8", dev,
                         seed=30, valid_b=27)
    eager = fp.planar_sums(*args)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fp.planar_sums(*args)                 # warm the allocator
        with _build.recording() as launched:
            g.capture_begin()
            out = fp.planar_sums(*args)
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    g.instantiate()
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert launched == [fp.planar_sums]
    nodes = gc.read_graph_nodes(g.raw_cuda_graph())
    assert gc.hand_kernel_nodes(nodes) == {"planar_sums": 1,
                                           "pair_histogram": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("wire,tol", [("int16", 5e-4), ("int8", 5e-4),
                                      ("delta", 5e-3)])
def test_cuda_fused_aligned_rmsf_at_a_wide_selection(wire, tol):
    """AlignedRMSF(engine='fused') of 700,000 atoms (S = 700,160, past
    every dtype's single-read limit) runs the kernel's wide mode on the
    card, with no fallback, and agrees with the generic engine on the
    same wire (the fused-vs-generic tolerances of phase 4)."""
    from mdanalysis_mpi_tpu_torch import Universe, obs
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, n_frames = 700_000, 24
    r = np.random.default_rng(7)
    base = r.normal(scale=20.0, size=(n, 3)).astype(np.float32)
    frames = base + r.normal(scale=0.3, size=(n_frames, n, 3)).astype(
        np.float32)
    u = Universe(Topology(names=np.full(n, "CA"),
                          resnames=np.full(n, "ALA"),
                          resids=np.arange(n) + 1), MemoryReader(frames))
    assert fr.pad_selection(np.arange(n))[0].size > fp.fused_max_atoms(1,
                                                                       sms)

    def fallbacks():
        return sum(obs.METRICS.snapshot().get(
            "mdtpu_fused_fallbacks_total", {"values": {}})["values"].values())

    kw = dict(backend="torch", device="cuda", batch_size=8,
              transfer_dtype=wire)
    n0, f0 = fp.planar_sums.launches, fallbacks()
    fused = AlignedRMSF(u, select="name CA", engine="fused").run(**kw)
    torch.cuda.synchronize()
    assert fp.planar_sums.launches - n0 == 6          # 3 blocks x 2 passes
    assert fallbacks() == f0
    generic = AlignedRMSF(u, select="name CA").run(**kw)
    assert np.abs(fused.results.rmsf - generic.results.rmsf).max() <= tol


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_cuda_rmsd_and_aligntraj_match_cpu(dtype, tmp_path):
    """The RMSD series (with group selections) and AlignTraj, in memory
    and streamed to a DCD, on the card against ``device="cpu"``: the
    same algebra in float32 on both (the SVDs differ only by rounding),
    the series left on the card."""
    from mdanalysis_mpi_tpu_torch.analysis import RMSD, AlignTraj
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    dev = _card()
    kw = dict(n_residues=40, n_frames=37, noise=0.3, seed=5)
    run = dict(batch_size=16, transfer_dtype=dtype)
    u = make_protein_universe(**kw)
    sel = dict(select="name CA", groupselections=["name CB", "name N"])
    card = RMSD(u, **sel).run(device=dev, **run)
    cpu = RMSD(u, **sel).run(device="cpu", **run)
    assert card.results["rmsd"].device.type == "cuda"
    assert card.results["group_rmsd"].device.type == "cuda"
    np.testing.assert_allclose(card.results.rmsd, cpu.results.rmsd,
                               atol=1e-5)
    np.testing.assert_allclose(card.results.group_rmsd,
                               cpu.results.group_rmsd, atol=1e-5)
    plain = RMSD(u, select="name CA C", weights="mass").run(device=dev, **run)
    plain_cpu = RMSD(u, select="name CA C", weights="mass").run(
        device="cpu", **run)
    np.testing.assert_allclose(plain.results.rmsd, plain_cpu.results.rmsd,
                               atol=1e-5)

    u_card, u_cpu = make_protein_universe(**kw), make_protein_universe(**kw)
    AlignTraj(u_card, select="name CA").run(device=dev, batch_size=16)
    AlignTraj(u_cpu, select="name CA").run(device="cpu", batch_size=16)
    got = u_card.trajectory.read_block(0, 37)[0]
    np.testing.assert_allclose(got, u_cpu.trajectory.read_block(0, 37)[0],
                               atol=1e-4)
    path = str(tmp_path / "fit.dcd")
    streamed = AlignTraj(u, select="name CA", in_memory=False,
                         filename=path).run(device=dev, batch_size=16)
    back = streamed.results.universe.trajectory.read_block(0, 37)[0]
    np.testing.assert_array_equal(back, got)


@pytest.mark.cuda
def test_cuda_fused_rmsf_from_an_int16_store_matches_cpu(tmp_path):
    """AlignedRMSF's fused engine from a small int16 block store: on the
    card the kernel runs in both passes on store-staged planar blocks
    (no staged block decodes host float32: the reader's f32 cache holds
    at most chunk 0, the reference frame), within 5e-4 Å of the CPU run
    of the kernel's plain version over the same store."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.io.store import ingest
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    dev = _card()
    u = make_protein_universe(n_residues=60, n_frames=70, noise=0.3, seed=9)
    store = str(tmp_path / "s16")
    ingest(u.trajectory, store, chunk_frames=32, quant="int16")
    run = dict(batch_size=32, transfer_dtype="int16")
    card_u = Universe(u.topology, store)
    n0 = fp.planar_sums.launches
    card = AlignedRMSF(card_u, select="name CA", engine="fused").run(
        backend="torch", device=dev, **run)
    assert fp.planar_sums.launches == n0 + 6      # 3 blocks, 2 passes
    assert set(card_u.trajectory._f32) <= {0}
    cpu = AlignedRMSF(Universe(u.topology, store), select="name CA",
                      engine="fused").run(backend="torch", device="cpu",
                                          **run)
    np.testing.assert_allclose(card.results.rmsf, cpu.results.rmsf,
                               atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", ["trr", "nc"])
def test_cuda_fused_rmsf_from_trr_and_netcdf_equals_memory(ext, tmp_path):
    """AlignedRMSF's fused engine from a small TRR and a small NetCDF
    (written by ``TrajectoryWriter`` in two pieces): the kernel runs in
    both passes, and the RMSF EQUALS the run over the same decoded
    frames from a MemoryReader (the same float32 frames stage the same
    int16 blocks)."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    dev = _card()
    u = make_protein_universe(n_residues=60, n_frames=70, noise=0.3, seed=9)
    frames, _ = u.trajectory.read_block(0, 70)
    path = str(tmp_path / f"t.{ext}")
    with TrajectoryWriter(path) as w:
        w.write(frames[:40], dimensions=BOX)
        w.write(frames[40:], dimensions=BOX)
    run = dict(backend="torch", device=dev, batch_size=32,
               transfer_dtype="int16")
    file_u = Universe(u.topology, path)
    decoded, boxes = file_u.trajectory.read_block(0, 70)
    n0 = fp.planar_sums.launches
    got = AlignedRMSF(file_u, select="name CA", engine="fused").run(**run)
    assert fp.planar_sums.launches == n0 + 6      # 3 blocks, 2 passes
    mem_u = Universe(u.topology, MemoryReader(decoded, dimensions=boxes))
    want = AlignedRMSF(mem_u, select="name CA", engine="fused").run(**run)
    np.testing.assert_array_equal(got.results.rmsf, want.results.rmsf)


@pytest.mark.cuda
def test_cuda_mesh_two_shards_fused_int16_matches_torch_executor():
    """MeshExecutor over ``["cuda:0"] * 2``: every shard of every global
    batch launches the fused kernel in both passes (no demotion to the
    generic form), and the RMSF is within 5e-4 Å of TorchExecutor's on
    the same card (the shards quantize as one global batch, so the wire
    is the single-device wire cut in two; the merge order differs)."""
    from mdanalysis_mpi_tpu_torch import obs
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    _card()
    u = make_protein_universe(n_residues=60, n_frames=70, noise=0.3, seed=9)
    n0 = fp.planar_sums.launches
    mesh = AlignedRMSF(u, select="name CA", engine="fused").run(
        backend=MeshExecutor(batch_size=16, devices=["cuda:0"] * 2,
                             transfer_dtype="int16"))
    # 70 frames in global batches of 32: 3 batches × 2 shards × 2 passes
    assert fp.planar_sums.launches == n0 + 12
    fallbacks = obs.METRICS.snapshot().get(
        "mdtpu_fused_fallbacks_total", {}).get("values", {})
    assert sum(fallbacks.values()) == 0
    single = AlignedRMSF(u, select="name CA", engine="fused").run(
        backend="torch", device="cuda", batch_size=32,
        transfer_dtype="int16")
    np.testing.assert_allclose(mesh.results.rmsf, single.results.rmsf,
                               atol=5e-4)


@pytest.mark.cuda
def test_cuda_ring_rdf_two_shards_matches_xla():
    """The atom-sharded ring over ``["cuda:0"] * 2`` against the
    frame-batched ``'xla'`` engine on the card (tests/test_ring.py's
    rtol 1e-5)."""
    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    _card()
    u = make_water_universe(n_waters=300, n_frames=4, seed=1)
    ow = u.select_atoms("name OW")
    ring = InterRDF(ow, ow, nbins=40, range=(0.0, 8.0), engine="ring").run(
        backend=MeshExecutor(batch_size=2, devices=["cuda:0"] * 2))
    xla = InterRDF(ow, ow, nbins=40, range=(0.0, 8.0), engine="xla").run(
        backend="torch", device="cuda", batch_size=2)
    np.testing.assert_allclose(ring.results.count, xla.results.count,
                               rtol=1e-5)
    np.testing.assert_allclose(ring.results.rdf, xla.results.rdf, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_run_streaming_from_a_follow_store_matches_cpu(tmp_path):
    """run_streaming of the fused AlignedRMSF and of RMSF from a small
    follow store on the card: the same snapshot frame counts as on the
    CPU, and the final results within 5e-4 Å (fused) and 1e-5 (RMSF) of
    the CPU's."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import RMSF, AlignedRMSF
    from mdanalysis_mpi_tpu_torch.io.store import LiveIngest, StoreReader
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    _card()
    u = make_protein_universe(n_residues=60, n_frames=48, noise=0.3, seed=9)
    store = str(tmp_path / "live")
    live = LiveIngest(out=store, n_atoms=u.atoms.n_atoms, chunk_frames=16)
    for f in u.trajectory.read_block(0, 48)[0]:
        live.append(f)
    live.seal()
    out = {}
    for dev in ("cuda", "cpu"):
        n0 = fp.planar_sums.launches
        a = AlignedRMSF(Universe(u.topology, StoreReader(store, follow=True)),
                        select="name CA", engine="fused").run_streaming(
            window=16, device=dev, batch_size=16, transfer_dtype="int16")
        launches = fp.planar_sums.launches - n0
        r = RMSF(Universe(u.topology, StoreReader(store, follow=True))
                 .select_atoms("name CA")).run_streaming(
            window=16, device=dev, batch_size=16)
        out[dev] = (a, r, launches)
    (ag, rg, lg), (ac, rc, lc) = out["cuda"], out["cpu"]
    # recompute over the prefix: 1 + 2 + 3 blocks, both passes
    assert lg == 2 * (1 + 2 + 3) and lc == 0
    for x, y in ((ag, ac), (rg, rc)):
        assert ([s["frames"] for s in x.results.stream_snapshots]
                == [s["frames"] for s in y.results.stream_snapshots]
                == [16, 32, 48])
    np.testing.assert_allclose(ag.results.rmsf, ac.results.rmsf, atol=5e-4)
    np.testing.assert_allclose(rg.results.rmsf, rc.results.rmsf, atol=1e-5)


# ---- scan-folded dispatch: a cached group replayed as a CUDA graph ----

def _scan_runs(run):
    """``run(scan_k, cache)`` per-block once, then three times folded
    over one cache: a group runs eagerly at its first hit, is captured
    and replayed at its second and replayed from then on (the first
    run stacks pass 1 and runs pass 2 eagerly; the second runs pass 1
    eagerly and captures pass 2; the third captures pass 1 and replays
    pass 2) → (per-block, [the folded runs], the cache, [launches of
    each folded run])."""
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache

    ref = run(1, DeviceBlockCache())
    cache = DeviceBlockCache()
    runs, launches = [], []
    for _ in range(3):
        l0 = fp.planar_sums.launches + fd.pair_histogram.launches
        runs.append(run("auto", cache))
        launches.append(fp.planar_sums.launches + fd.pair_histogram.launches
                        - l0)
    torch.cuda.synchronize()
    return ref, runs, cache, launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "int8", "delta", "float32"])
def test_cuda_scan_graph_equals_per_block_dispatch(dtype):
    """AlignedRMSF(engine='fused'): the folded schedule (eager at a
    group's first hit, a captured graph of the group from its second)
    gives the per-block schedule's RMSF bit for bit, and every fused
    launch inside a graph counts at each replay."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
    from mdanalysis_mpi_tpu_torch.utils import compile_cache

    _card()
    u = make_protein_universe(n_residues=300, n_frames=60, noise=0.3, seed=4)

    def run(scan_k, cache):
        u.trajectory.__dict__.pop("_quant_max_hints", None)
        return AlignedRMSF(u, select="name CA", engine="fused").run(
            backend="torch", device="cuda", batch_size=16,
            transfer_dtype=dtype, block_cache=cache, scan_k=scan_k)

    g0 = compile_cache.counters()
    ref, runs, cache, launches = _scan_runs(run)
    g1 = compile_cache.counters()
    for r in runs:
        assert torch.equal(r.results["rmsf"], ref.results["rmsf"])
    # 60 frames at batch 16: 4 blocks a pass, one group of 4
    assert launches == ([8, 8, 8] if dtype != "float32" else [0, 0, 0])
    graphs = cache.graphs()
    assert len(graphs) == 2                                # one a pass
    if dtype != "float32":
        assert all(len(g.launches) == 4 for g in graphs)
    assert g1["graph_misses"] - g0["graph_misses"] == 2
    assert g1["graph_hits"] - g0["graph_hits"] == 1


@pytest.mark.cuda
def test_cuda_scan_graph_rmsd_series_and_rdf():
    """The RMSD series and a cached InterRDF repeat: the folded
    schedule equals the per-block one (the pair-histogram counts
    exactly), the kernel launching inside the replayed graph."""
    from mdanalysis_mpi_tpu_torch.analysis import RMSD, InterRDF
    from mdanalysis_mpi_tpu_torch.testing import (make_protein_universe,
                                                  make_water_universe)

    _card()
    u = make_protein_universe(n_residues=120, n_frames=40, noise=0.3, seed=6)
    ref, runs, cache, _ = _scan_runs(lambda k, c: RMSD(
        u, select="name CA").run(backend="torch", device="cuda",
                                 batch_size=8, block_cache=c, scan_k=k))
    for r in runs:
        assert torch.equal(r.results["rmsd"], ref.results["rmsd"])
    assert len(cache.graphs()) == 1
    uw = make_water_universe(n_waters=600, n_frames=32, box=26.3)
    ow = uw.select_atoms("name OW")
    ref, runs, cache, launches = _scan_runs(lambda k, c: InterRDF(
        ow, ow, nbins=40, range=(0.0, 8.0)).run(
            backend="torch", device="cuda", batch_size=8, block_cache=c,
            scan_k=k))
    assert runs[0]._resolved_engine == "pallas"
    for r in runs:
        np.testing.assert_array_equal(r.results.count, ref.results.count)
    # the first run populates, the second runs the group eagerly, the
    # third captures and replays it: 4 launches each
    assert launches == [4, 4, 4]
    (graph,) = cache.graphs()
    assert graph.launches == (fd.pair_histogram,) * 4


@pytest.mark.cuda
def test_cuda_graph_replay_makes_no_host_wait():
    """One replay of a captured group under
    ``torch.cuda.set_sync_debug_mode("error")`` raises nothing: no
    readback, no synchronisation inside a replayed group (the Kabsch
    solve is QCP, not ``torch.linalg.svd``)."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    dev = _card()
    u = make_protein_universe(n_residues=300, n_frames=48, noise=0.3, seed=5)
    for engine, dtype in (("fused", "int16"), (None, "float32")):
        cache = DeviceBlockCache()
        for _ in range(3):
            AlignedRMSF(u, select="name CA", engine=engine).run(
                backend="torch", device="cuda", batch_size=16,
                transfer_dtype=dtype, block_cache=cache)
        graphs = cache.graphs()
        assert len(graphs) == 2
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for prog in graphs:
                prog.replay(prog.params, prog.total, dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_stale_graph_never_replayed_after_overwrite():
    """``DeviceBlockCache.put`` over an entry with a graph releases the
    entry's memory and drops its graph: the next hit runs the new entry
    eagerly, the one after captures a new graph over it, and the result
    stays the per-block one."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, _clone_tree, _is_deleted, _tensors)
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
    from mdanalysis_mpi_tpu_torch.utils import compile_cache

    _card()
    u = make_protein_universe(n_residues=300, n_frames=48, noise=0.3, seed=7)

    def run(cache, scan_k="auto"):
        u.trajectory.__dict__.pop("_quant_max_hints", None)
        return AlignedRMSF(u, select="name CA", engine="fused").run(
            backend="torch", device="cuda", batch_size=16,
            transfer_dtype="int16", block_cache=cache, scan_k=scan_k)

    ref = run(DeviceBlockCache(), scan_k=1)
    cache = DeviceBlockCache()
    run(cache)
    run(cache)
    (key,) = [k for k in cache._programs]
    old = cache._store[key]
    (old_prog,) = cache.graphs()
    fresh = _clone_tree(old)
    assert cache.put(key, fresh, cache._sizes[key])
    assert key not in cache._programs and not cache.graphs()
    assert all(_is_deleted(t) for t in _tensors(old))
    c0 = compile_cache.counters()
    eager = run(cache)
    c1 = compile_cache.counters()
    assert c1["replays"] == c0["replays"]
    again = run(cache)
    assert compile_cache.counters()["graph_misses"] - c1["graph_misses"] == 2
    assert all(p is not old_prog for p in cache.graphs())
    for r in (eager, again):
        assert torch.equal(r.results["rmsf"], ref.results["rmsf"])


@pytest.mark.cuda
def test_cuda_kernel_launch_error_and_build_error_are_not_degradable(
        monkeypatch):
    """A launch the card refuses raises ``KernelLaunchError``; neither
    it nor a build failure is degradable, and a resilient run on the
    card raises the launch error rather than finish without the
    kernel."""
    from mdanalysis_mpi_tpu_torch import _build
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.reliability.policy import (
        ReliabilityPolicy, is_degradable)
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    dev = _card()
    args, _ = _fused_case(16, 300, "int16", None, dev, seed=3)
    # a geometry the kernel's entry point refuses (more blocks than it
    # takes), as if the sizing had gone wrong
    monkeypatch.setattr(fp, "fused_geometry",
                        lambda *a: (16, fp.MAX_BLOCKS + 1, 1, 2))
    with pytest.raises(_build.KernelLaunchError) as err:
        fp.planar_sums(*args)
    assert not is_degradable(err.value)
    assert not is_degradable(_build.KernelBuildError("nvcc failed"))
    u = make_protein_universe(n_residues=300, n_frames=32, noise=0.3, seed=3)
    with pytest.raises(_build.KernelLaunchError):
        AlignedRMSF(u, select="name CA", engine="fused").run(
            backend="torch", device="cuda", batch_size=16,
            transfer_dtype="int16",
            resilient=ReliabilityPolicy(backoff_s=0.001, checkpoint=False))


_WARMUP_PROBE = """
import json, sys, time
import torch
from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
from mdanalysis_mpi_tpu_torch.parallel.executors import (
    DeviceBlockCache, TorchExecutor, warmup_analysis)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
from mdanalysis_mpi_tpu_torch.utils import compile_cache

u = make_protein_universe(n_residues=300, n_frames=64, noise=0.3, seed=8)
exe = TorchExecutor(batch_size=16, device="cuda", transfer_dtype="int16",
                    block_cache=DeviceBlockCache())
w0 = compile_cache.counters()["build_misses"]
n = (warmup_analysis(AlignedRMSF(u, select="name CA", engine="fused"), exe)
     if sys.argv[1] == "warm" else 0)
c0 = compile_cache.counters()["build_misses"]
r = AlignedRMSF(u, select="name CA", engine="fused").run(backend=exe)
torch.cuda.synchronize()
print(json.dumps({"programs": n, "warmup_builds": c0 - w0,
                  "run_builds": compile_cache.counters()["build_misses"] - c0,
                  "rmsf": r.results["rmsf"].double().sum().item()}))
"""


@pytest.mark.cuda
def test_cuda_warmup_then_run_builds_nothing_in_a_fresh_process():
    """In a fresh process the first fused run builds (loads) the kernel
    library; after ``warmup_analysis`` the run builds nothing, because
    the warmup did, and its RMSF is the cold run's."""
    import json
    import os
    import subprocess
    import sys

    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for mode in ("cold", "warm"):
        proc = subprocess.run([sys.executable, "-c", _WARMUP_PROBE, mode],
                              cwd=root, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    cold, warm = out["cold"], out["warm"]
    assert cold["programs"] == 0 and cold["run_builds"] == 1
    assert warm["programs"] > 0 and warm["warmup_builds"] == 1
    assert warm["run_builds"] == 0
    assert warm["rmsf"] == cold["rmsf"]


# ---- neighbour search and what it unblocks (torch ops, no hand kernel) ----

@pytest.mark.cuda
@pytest.mark.parametrize("box", [
    np.array([24.0, 24.0, 24.0, 90.0, 90.0, 90.0]),
    np.array([24.0, 26.0, 22.0, 75.0, 80.0, 95.0]), None],
    ids=["ortho", "triclinic", "nobox"])
def test_cuda_cell_list_matches_nsgrid(box):
    """The torch cell list on the card: the pairs of the host grid, the
    float64 distances within 5e-4 Å, a cross query with min_cutoff and
    the overflow retry with capacity 1 included."""
    from mdanalysis_mpi_tpu_torch.lib.distances import (
        capped_distance, self_capped_distance)
    from mdanalysis_mpi_tpu_torch.ops import neighbors

    _card()
    r = np.random.default_rng(31)
    a = r.uniform(0, 24, size=(3000, 3))
    b = r.uniform(0, 24, size=(2000, 3))
    pg, dg = self_capped_distance(a, 3.5, box=box, engine="nsgrid")
    pt, dt = self_capped_distance(a, 3.5, box=box, engine="torch")
    np.testing.assert_array_equal(pt, pg)
    np.testing.assert_allclose(dt, dg, rtol=0, atol=5e-4)
    pg, dg = capped_distance(a, b, 4.0, min_cutoff=1.0, box=box,
                             engine="nsgrid")
    pt, dt = capped_distance(a, b, 4.0, min_cutoff=1.0, box=box,
                             engine="torch", device="cuda")
    np.testing.assert_array_equal(pt, pg)
    np.testing.assert_allclose(dt, dg, rtol=0, atol=5e-4)
    dims = None if box is None else box
    po = neighbors.capped_distance(a, b, 4.0, min_cutoff=1.0, dims=dims,
                                   return_distances=False, capacity=1)
    np.testing.assert_array_equal(po, pg)


@pytest.mark.cuda
def test_cuda_self_pair_counts_and_default_device():
    """``self_pair_counts`` on the card frame by frame against the host
    grid; ``engine='torch'`` with no device resolves to ``cuda``."""
    from mdanalysis_mpi_tpu_torch.device import resolve_device
    from mdanalysis_mpi_tpu_torch.lib.distances import self_capped_distance
    from mdanalysis_mpi_tpu_torch.ops import neighbors

    dev = _card()
    assert resolve_device(None).type == "cuda"
    r = np.random.default_rng(32)
    coords = r.uniform(0, 22, size=(6, 400, 3)).astype(np.float32)
    boxes = np.tile(np.array([22.0, 22, 22, 90, 90, 90], np.float32), (6, 1))
    counts, ovs = neighbors.self_pair_counts(
        _t(coords).to(dev), _t(boxes).to(dev),
        torch.ones(6, device=dev), 4.0, (5, 5, 5), 24)
    assert counts.device.type == "cuda" and not bool(ovs.any())
    host = [len(self_capped_distance(coords[f], 4.0, box=boxes[f],
                                     engine="nsgrid")[0]) for f in range(6)]
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  np.asarray(host, np.float32))
    # static shapes, no host wait, no copy from the host: one CUDA
    # graph captures the batch and its replay gives the same counts
    xs, bs, ms = (_t(coords).to(dev), _t(boxes).to(dev),
                  torch.ones(6, device=dev))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        neighbors.self_pair_counts(xs, bs, ms, 4.0, (5, 5, 5), 24)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_counts, _ = neighbors.self_pair_counts(xs, bs, ms, 4.0, (5, 5, 5),
                                                 24)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_counts, counts)


@pytest.mark.cuda
def test_cuda_hbonds_batch_matches_serial_and_graph_replay():
    """HydrogenBondAnalysis on its batch path on the card (the default
    device): counts within 0.1% of the float64 serial oracle's in each
    frame, rounded up to whole bonds (float32 flips at the 3.0 Å and
    150° edges), a second run equal, and scan-folded repeats (replayed
    CUDA graphs) equal to the per-block run."""
    from mdanalysis_mpi_tpu_torch.analysis import HydrogenBondAnalysis
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, TorchExecutor)
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    _card()
    u = make_water_universe(n_waters=216, n_frames=24, box=18.6, seed=4)
    serial = np.asarray(HydrogenBondAnalysis(u).run(
        backend="serial").results.count)
    first = HydrogenBondAnalysis(u).run(batch_size=8)
    again = HydrogenBondAnalysis(u).run(batch_size=8)
    got = np.asarray(first.results.count)
    assert (np.abs(got - serial) <= np.ceil(1e-3 * serial)).all()
    assert serial.sum() > 0
    np.testing.assert_array_equal(again.results.count, got)
    exe = TorchExecutor(batch_size=8, block_cache=DeviceBlockCache(),
                        scan_k="auto")
    for _ in range(4):
        np.testing.assert_array_equal(
            HydrogenBondAnalysis(u).run(backend=exe).results.count, got)


# ---- the generic analysis API and the analyses of ROADMAP A8 (torch
# ops, no hand kernel) on the card ----

def _an_universe():
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    return make_protein_universe(n_residues=60, n_frames=40, noise=0.3,
                                 seed=7)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["reductions", "series"])
def test_cuda_collection_equals_solo_runs_and_replays_its_graph(kind):
    """An AnalysisCollection on the card: each child's partials equal
    to its solo run's, and three repeats over one block cache equal to
    the first, the last replaying the captured graph."""
    from mdanalysis_mpi_tpu_torch.analysis import (RMSD, RMSF,
                                                   AnalysisCollection,
                                                   AverageStructure,
                                                   RadiusOfGyration)
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache
    from mdanalysis_mpi_tpu_torch.utils import compile_cache

    _card()
    u = _an_universe()
    ca = u.select_atoms("name CA")
    makers = ([lambda: RMSF(ca),
               lambda: AverageStructure(u, select="name CA",
                                        select_only=True)]
              if kind == "reductions" else
              [lambda: RMSD(u, select="name CA"),
               lambda: RadiusOfGyration(u.select_atoms("protein"))])
    kw = dict(backend="torch", device="cuda", batch_size=8)
    solos = [m().run(**kw) for m in makers]
    first = AnalysisCollection(*[m() for m in makers]).run(**kw)
    for child, solo in zip(first.analyses, solos):
        for a, b in zip(_leaves(child._last_total), _leaves(solo._last_total)):
            assert torch.equal(a, b)
    cache = DeviceBlockCache()
    for i in range(4):
        before = compile_cache.counters()["replays"]
        c = AnalysisCollection(*[m() for m in makers]).run(
            block_cache=cache, scan_k="auto", **kw)
        for child, ref in zip(c.analyses, first.analyses):
            for a, b in zip(_leaves(child._last_total),
                            _leaves(ref._last_total)):
                assert torch.equal(a, b)
    assert compile_cache.counters()["replays"] > before
    assert len(cache.graphs()) == 1


@pytest.mark.cuda
def test_cuda_density_and_linear_density_repeat_bit_identical():
    """DensityAnalysis' int32 counts and LinearDensity's order-fixed
    float32 sums: a repeat on the card gives the same bits; the density
    total is exact and the profiles sit within 5e-2 of the serial
    oracle (benchmarks/suite.py's gate)."""
    from mdanalysis_mpi_tpu_torch.analysis import (DensityAnalysis,
                                                   LinearDensity)
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    _card()
    u = make_water_universe(n_waters=4000, n_frames=16, box=49.3, seed=3)
    u.add_TopologyAttr("charges", np.tile([-0.834, 0.417, 0.417], 4000))
    ow = u.select_atoms("name OW")
    kw = dict(backend="torch", device="cuda", batch_size=4)
    a = DensityAnalysis(ow, delta=1.0).run(**kw)
    b = DensityAnalysis(ow, delta=1.0).run(**kw)
    assert torch.equal(a._last_total[1], b._last_total[1])
    assert int(a._last_total[1].sum()) == 16 * 4000
    for grouping in ("atoms", "residues"):
        x = LinearDensity(u.atoms, grouping=grouping, binsize=0.25).run(**kw)
        y = LinearDensity(u.atoms, grouping=grouping, binsize=0.25).run(**kw)
        for p, q in zip(x._last_total, y._last_total):
            assert torch.equal(p, q)
        s = LinearDensity(u.atoms, grouping=grouping, binsize=0.25).run(
            backend="serial")
        for ax in "xyz":
            np.testing.assert_allclose(x.results[ax].mass_density,
                                       s.results[ax].mass_density,
                                       atol=5e-2)


def _family(name, u):
    """(analysis maker, result key, compare) of one batch-function
    family, at the tolerance of the JAX package's test."""
    from mdanalysis_mpi_tpu_torch import analysis as an

    prot = u.select_atoms("protein")

    def close(atol, period=None):
        def cmp(got, want):
            d = np.abs(np.asarray(got, np.float64) - want)
            if period:
                d = np.minimum(d, period - d % period)
            assert d.max() <= atol
        return cmp

    def pca_cmp(got, want):
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=1e-3 * float(want[0]))

    def dssp_cmp(got, want):
        assert (got == want).mean() >= 0.98

    return {
        "rgyr": (lambda: an.RadiusOfGyration(prot), "rgyr", close(1e-4)),
        "dihedrals": (lambda: an.Ramachandran(prot), "angles",
                      close(0.15, 360.0)),
        "helix": (lambda: an.HELANAL(u, select="name CA"), "local_rises",
                  close(1e-4)),
        "pca": (lambda: an.PCA(u, select="name CA", align=True), "variance",
                pca_cmp),
        "gnm": (lambda: an.GNMAnalysis(u, select="name CA"), "eigenvalues",
                close(1e-3)),
        "dssp": (lambda: an.DSSP(u), "dssp", dssp_cmp),
        "msd": (lambda: an.EinsteinMSD(u, select="name CA"), "timeseries",
                close(1e-2)),
    }[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgyr", "dihedrals", "helix", "pca",
                                  "gnm", "dssp", "msd"])
def test_cuda_analysis_family_matches_serial(name):
    """Each batch-function family on the card against the serial
    float64 oracle, a repeat bit-identical, and three more runs over one
    block cache (GNM's eigh waits on the device, so its groups run
    eagerly instead of being captured) equal to the first."""
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache

    _card()
    u = _an_universe()
    make, key, cmp = _family(name, u)
    kw = dict(backend="torch", device="cuda", batch_size=8)
    got = np.asarray(getattr(make().run(**kw).results, key))
    again = np.asarray(getattr(make().run(**kw).results, key))
    np.testing.assert_array_equal(got, again)
    cmp(got, np.asarray(getattr(make().run(backend="serial").results, key)))
    cache = DeviceBlockCache()
    for _ in range(3):
        r = make().run(block_cache=cache, scan_k="auto", **kw)
        np.testing.assert_array_equal(np.asarray(getattr(r.results, key)),
                                      got)


@pytest.mark.cuda
def test_cuda_bat_and_polymer_match_serial():
    """BAT (a bonded fragment after guess_bonds) and PersistenceLength
    on the card against the serial float64 oracle (1e-4 with torsions
    modulo 2π; 1e-5)."""
    from mdanalysis_mpi_tpu_torch.analysis import BAT, PersistenceLength
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    _card()
    kw = dict(backend="torch", device="cuda", batch_size=8)
    u = _an_universe()
    u.atoms.guess_bonds()
    frag = max(u.atoms.fragments, key=lambda f: f.n_atoms)
    b = BAT(frag)
    got = b.run(**kw).results.bat
    want = BAT(frag).run(backend="serial").results.bat
    d = np.abs(got - want)
    tor = slice(9 + 2 * len(b._quads_global), None)
    d[:, tor] = np.minimum(d[:, tor], 2 * np.pi - d[:, tor])
    assert d.max() <= 1e-4
    rng = np.random.default_rng(41)
    pos = np.cumsum(rng.normal(size=(24, 8 * 12, 3)), axis=1)
    top = Topology(names=np.full(96, "C"), resnames=np.full(96, "POL"),
                   resids=np.arange(1, 97))
    up = Universe(top, MemoryReader(pos.astype(np.float32)))
    chains = [up.atoms[i * 12:(i + 1) * 12] for i in range(8)]
    p = PersistenceLength(chains).run(**kw)
    s = PersistenceLength(chains).run(backend="serial")
    np.testing.assert_allclose(p.results.bond_autocorrelation,
                               s.results.bond_autocorrelation, atol=1e-5)


@pytest.mark.cuda
def test_cuda_pairwise_rmsd_matches_cpu_run():
    """The device pair-RMSD matrix (row blocks of float64 products and
    the QCP top eigenvalue) on the card against the same function on
    the CPU (1e-9 Å off the diagonal: one float64 algebra, only the
    products' blocking differs; a frame against itself is the square
    root of e0 − 2λ's rounding, ~1e-7 Å either way, and DistanceMatrix
    zeroes it), and DistanceMatrix on the card against serial (5e-3 Å,
    tests/test_diffusionmap.py)."""
    from mdanalysis_mpi_tpu_torch.analysis import DistanceMatrix
    from mdanalysis_mpi_tpu_torch.analysis.diffusionmap import (
        pairwise_rmsd_device)
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    _card()
    rng = np.random.default_rng(6)
    pos = _t(rng.normal(scale=6.0, size=(150, 120, 3)).astype(np.float32))
    w = rng.uniform(1.0, 16.0, 120)
    got = pairwise_rmsd_device(pos.cuda(), w).cpu().numpy()
    want = pairwise_rmsd_device(pos, w).numpy()
    assert np.abs(np.diag(got)).max() <= 1e-5
    np.fill_diagonal(got, 0.0)
    np.fill_diagonal(want, 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    u = make_protein_universe(n_residues=40, n_frames=64, noise=0.4, seed=2)
    d = DistanceMatrix(u, select="name CA").run(
        backend="torch", device="cuda", batch_size=16).results.dist_matrix
    s = DistanceMatrix(u, select="name CA").run(
        stop=64, backend="serial").results.dist_matrix
    np.testing.assert_allclose(d, s, atol=5e-3)


@pytest.mark.cuda
def test_cuda_frechet_wavefront_equals_host_recurrence():
    """On the card's own float32 cross matrices: the wavefront EQUAL to
    the host recurrence (only min and max), Hausdorff equal to the host
    reduction of the same matrix."""
    from mdanalysis_mpi_tpu_torch.analysis.psa import (
        _frechet_np, cross_rmsd, frechet_wavefront, hausdorff_from_cross)

    dev = _card()
    rng = np.random.default_rng(9)
    p = _t(np.cumsum(rng.normal(scale=0.3, size=(3, 96, 40, 3)),
                     axis=1).astype(np.float32)).to(dev)
    q = _t(np.cumsum(rng.normal(scale=0.3, size=(3, 71, 40, 3)),
                     axis=1).astype(np.float32)).to(dev)
    m = cross_rmsd(p, q)
    got = frechet_wavefront(m).cpu().numpy()
    haus = hausdorff_from_cross(m).cpu().numpy()
    mh = m.cpu().numpy()
    for k in range(3):
        assert float(got[k]) == _frechet_np(mh[k])
        assert float(haus[k]) == max(mh[k].min(axis=1).max(),
                                     mh[k].min(axis=0).max())


@pytest.mark.cuda
def test_cuda_water_and_dielectric_match_serial():
    """WOR (device lag sums) within 1e-5 and AngularDistribution within
    1e-4 of serial; DielectricConstant on the card and on the mesh over
    it within 1e-3 relative of serial (tests/test_dielectric.py)."""
    from mdanalysis_mpi_tpu_torch.analysis import (
        AngularDistribution, DielectricConstant,
        WaterOrientationalRelaxation)
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    _card()
    kw = dict(backend="torch", device="cuda", batch_size=8)
    u = make_water_universe(n_waters=300, n_frames=24, seed=5)
    w = WaterOrientationalRelaxation(u, "name OW", dtmax=8)
    np.testing.assert_allclose(
        w.run(**kw).results.timeseries,
        WaterOrientationalRelaxation(u, "name OW", dtmax=8).run(
            backend="serial").results.timeseries, atol=1e-5)
    a = AngularDistribution(u, "name OW", bins=20).run(**kw).results
    s = AngularDistribution(u, "name OW", bins=20).run(
        backend="serial").results
    for key in ("OH", "HH", "dip"):
        np.testing.assert_allclose(getattr(a, key), getattr(s, key),
                                   atol=1e-4)
    u.add_TopologyAttr("charges", np.tile([-0.834, 0.417, 0.417], 300))
    want = DielectricConstant(u.atoms, make_whole=False).run(
        backend="serial").results.eps_mean
    for run in (kw, dict(backend="mesh", devices=["cuda:0"] * 2,
                         batch_size=4)):
        got = DielectricConstant(u.atoms, make_whole=False).run(
            **run).results.eps_mean
        np.testing.assert_allclose(got, want, rtol=1e-3)



def _serve_universe():
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    return make_protein_universe(n_residues=60, n_frames=64, noise=0.3,
                                 seed=13)


@pytest.mark.cuda
def test_cuda_scheduler_launches_both_kernels_inside_its_worker():
    """A scheduler on the card serves a fused int16 AlignedRMSF (torch
    and mesh) and a kernel-route InterRDF: every hand-kernel launch of
    the served run happens in a ``mdtpu-serve-*`` worker (4 blocks × 2
    passes × 2 jobs fused, 4 pair-histogram blocks), after a warmup and
    a prefetch that ran programs and staged blocks for both executors;
    each result equals its solo run's within 1e-5 (counts equal)."""
    import threading

    from mdanalysis_mpi_tpu_torch import Universe, _build
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, InterRDF
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
    from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache
    from mdanalysis_mpi_tpu_torch.service import AnalysisJob, Scheduler
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    _card()
    u = _serve_universe()
    u_b = Universe(u.topology, MemoryReader(u.trajectory._coords))
    uw = make_water_universe(n_waters=400, n_frames=16, box=23.0, seed=3)
    ow = uw.select_atoms("name OW")
    kw = {"transfer_dtype": "int16"}
    jobs = [AnalysisJob(AlignedRMSF(u, select="name CA", engine="fused"),
                        backend="torch", batch_size=16,
                        executor_kwargs=dict(kw), priority=2),
            AnalysisJob(AlignedRMSF(u_b, select="name CA", engine="fused"),
                        backend="mesh", batch_size=16,
                        executor_kwargs=dict(kw), priority=1),
            AnalysisJob(InterRDF(ow, ow, nbins=40, range=(0.0, 10.0)),
                        backend="torch", batch_size=4)]
    sched = Scheduler(n_workers=1, autostart=False,
                      cache=DeviceBlockCache())
    assert sched.warmup(jobs[:1])["executables"] > 0
    assert sched.warmup(jobs[1:2])["executables"] > 0
    handles = [sched.submit(j) for j in jobs]
    assert sched.prefetch_pending() > 0
    names = []
    orig = _build.count_launch

    def counting(wrapper):
        names.append(threading.current_thread().name)
        orig(wrapper)

    torch.cuda.synchronize()
    f0, p0 = fp.planar_sums.launches, fd.pair_histogram.launches
    _build.count_launch = counting
    try:
        sched.start()
        assert sched.drain(timeout=300)
        torch.cuda.synchronize()
    finally:
        _build.count_launch = orig
        sched.shutdown()
    assert fp.planar_sums.launches - f0 == 16
    assert fd.pair_histogram.launches - p0 == 4
    assert names and all(n.startswith("mdtpu-serve-") for n in names)
    assert sched.telemetry.snapshot()["admission_shed_serial"] == 0
    for x in (u, u_b):
        x.trajectory.__dict__.pop("_quant_max_hints", None)
    solo_a = AlignedRMSF(u, select="name CA", engine="fused").run(
        backend="torch", batch_size=16, transfer_dtype="int16")
    solo_b = AlignedRMSF(u_b, select="name CA", engine="fused").run(
        backend="mesh", batch_size=16, transfer_dtype="int16")
    solo_r = InterRDF(ow, ow, nbins=40, range=(0.0, 10.0)).run(
        backend="torch", batch_size=4)
    for h, s in zip(handles[:2], (solo_a, solo_b)):
        np.testing.assert_allclose(h.result().results.rmsf,
                                   s.results.rmsf, atol=1e-5, rtol=0)
    got = handles[2].result()
    assert got._resolved_engine == "pallas"
    np.testing.assert_array_equal(got.results.count, solo_r.results.count)
    np.testing.assert_allclose(got.results.rdf, solo_r.results.rdf,
                               rtol=1e-5)


@pytest.mark.cuda
def test_cuda_open_breaker_refuses_instead_of_serial():
    """On the card a job whose device breakers are all open fails with
    ``BackendUnavailableError`` and never runs on serial (no reroute is
    counted, no result lands); after the cooldown the half-open probe on
    the card closes the breaker and the job runs with the fused
    kernel."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.reliability import breaker, faults
    from mdanalysis_mpi_tpu_torch.service import (BackendUnavailableError,
                                                  Scheduler)

    _card()
    u = _serve_universe()
    now = [0.0]
    board = breaker.BreakerBoard(threshold=2, cooldown_s=30.0,
                                 clock=lambda: now[0])
    sched = Scheduler(n_workers=1, breakers=board)
    kw = dict(backend="torch", batch_size=16, coalesce=False,
              executor_kwargs={"transfer_dtype": "int16"})
    try:
        with faults.inject(faults.FaultSpec("kernel", "raise", times=None)):
            bad = [sched.submit(AlignedRMSF(u, select="name CA",
                                            engine="fused"), **kw)
                   for _ in range(2)]
            assert sched.drain(timeout=120)
        assert all(h.error is not None for h in bad)
        assert board.get("torch").state == breaker.OPEN
        h = sched.submit(AlignedRMSF(u, select="name CA", engine="fused"),
                         **kw)
        assert sched.drain(timeout=120)
        with pytest.raises(BackendUnavailableError):
            h.result(timeout=1)
        assert h.error.breakers == ("torch",)
        assert "rmsf" not in h.job.analysis.results
        assert sched.telemetry.breaker_reroutes == 0
        now[0] += 31.0
        n0 = fp.planar_sums.launches
        ok = sched.submit(AlignedRMSF(u, select="name CA", engine="fused"),
                          **kw)
        assert sched.drain(timeout=120)
        torch.cuda.synchronize()
        assert ok.error is None and board.get("torch").state == "closed"
        assert fp.planar_sums.launches - n0 == 8
    finally:
        sched.shutdown()


@pytest.mark.cuda
def test_cuda_mesh_warmup_builds_and_stage_fills_the_cache():
    """``MeshExecutor.warmup`` over two shards of the card runs programs
    on each (the library loaded first); ``stage`` fills the cache under
    the keys the run reads: the run after them misses nothing and
    equals a repeat of a run that staged its own blocks."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, MeshExecutor, stage_analysis, warmup_analysis)

    _card()
    u = _serve_universe()
    cache = DeviceBlockCache()
    ex = MeshExecutor(batch_size=16, devices=["cuda:0"] * 2,
                      block_cache=cache, transfer_dtype="int16")
    assert warmup_analysis(AlignedRMSF(u, select="name CA",
                                       engine="fused"), ex) > 0
    assert stage_analysis(AlignedRMSF(u, select="name CA",
                                      engine="fused"), ex) == 2
    misses = cache.misses
    got = AlignedRMSF(u, select="name CA", engine="fused").run(backend=ex)
    assert cache.misses == misses
    u2 = _serve_universe()
    own = MeshExecutor(batch_size=16, devices=["cuda:0"] * 2,
                       block_cache=DeviceBlockCache(),
                       transfer_dtype="int16")
    AlignedRMSF(u2, select="name CA", engine="fused").run(backend=own)
    again = AlignedRMSF(u2, select="name CA", engine="fused").run(
        backend=own)
    np.testing.assert_array_equal(got.results.rmsf, again.results.rmsf)


def _fused_blocks():
    from mdanalysis_mpi_tpu_torch import obs

    return sum(obs.METRICS.snapshot().get(
        "mdtpu_fused_blocks_total", {"values": {}})["values"].values())


@pytest.mark.cuda
def test_cuda_fused_blocks_counter_is_the_launch_count():
    """An int16 fused AlignedRMSF run raises ``mdtpu_fused_blocks_total``
    (the counter a fleet host ships on its heartbeats) by exactly the
    rise of ``planar_sums.launches``: the federated counter counts the
    hosts' kernel launches."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF

    _card()
    u = _serve_universe()
    torch.cuda.synchronize()
    n0, b0 = fp.planar_sums.launches, _fused_blocks()
    AlignedRMSF(u, select="name CA", engine="fused").run(
        backend="torch", batch_size=16, transfer_dtype="int16")
    torch.cuda.synchronize()
    launched = fp.planar_sums.launches - n0
    assert launched == 8                       # 4 blocks x 2 passes
    assert _fused_blocks() - b0 == launched


@pytest.mark.cuda
def test_cuda_one_host_fleet_serves_bit_equal_to_solo(tmp_path):
    """A one-host port fleet on the card (the default device) serves a
    fused int16 AlignedRMSF from a store; the served RMSF equals the
    solo run's on the same store bit for bit, and the host's federated
    fused blocks show the kernel ran in the host process."""
    import time

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.io.psf import write_psf
    from mdanalysis_mpi_tpu_torch.io.store import ingest
    from mdanalysis_mpi_tpu_torch.service.fleet import (DONE,
                                                        FleetController)

    _card()
    u = _serve_universe()
    psf, store = str(tmp_path / "p.psf"), str(tmp_path / "p.store")
    write_psf(psf, u.topology)
    ingest(u.trajectory, store, chunk_frames=16, quant="int16")
    spec = {"analysis": "aligned-rmsf", "topology": psf,
            "trajectory": store, "select": "name CA", "engine": "fused",
            "transfer_dtype": "int16", "batch_size": 16, "tenant": "a"}
    with FleetController(str(tmp_path / "fleet"), host_ttl_s=10.0,
                         status=False) as ctrl:
        assert ctrl.device == "cuda"
        ctrl.spawn_host(hb_interval_s=0.1, cache_mb=256)
        assert ctrl.wait_hosts(1, timeout=120)
        job = ctrl.submit(spec)
        assert ctrl.drain(timeout=300)
        assert job.state == DONE, job.error
        deadline = time.monotonic() + 20
        blocks = 0
        while time.monotonic() < deadline and blocks < 8:
            blocks = sum(
                sum(m.get("mdtpu_fused_blocks_total",
                          {"values": {}})["values"].values())
                for m in ctrl.host_metrics().values())
            time.sleep(0.05)
    assert blocks == 8
    served = job.result_arrays()["rmsf"]
    solo = AlignedRMSF(Universe(psf, store), select="name CA",
                       engine="fused").run(backend="torch", batch_size=16,
                                           transfer_dtype="int16")
    np.testing.assert_array_equal(served, solo.results.rmsf)


@pytest.mark.cuda
@pytest.mark.parametrize("name,wrapper", [
    ("mesh_scan_rmsf", None),
    ("torch_group_aligned_rmsf_fused", "planar_sums"),
    ("torch_group_interrdf_kernel", "pair_histogram")])
def test_cuda_capture_contracts_hold_on_the_group_graphs(name, wrapper):
    """Each registered program, run three times over one cache, leaves
    group graphs clean of MDT110 and MDT111: every graph's hand-kernel
    nodes equal the launches its capture recorded (two a graph: groups
    of two blocks), and the captured groups' outputs equal the eager
    ones bit for bit."""
    from mdanalysis_mpi_tpu_torch.lint import graphcontracts as gc

    _card()
    make, exe, shards, single = gc.registered_programs("cuda")[name]
    findings, rep = gc.check_program(name, make, exe, shards=shards,
                                     single_device=single)
    assert findings == [], [f.render() for f in findings]
    assert rep["replay_equal"]
    assert rep["graphs"]
    for g in rep["graphs"]:
        assert g["host_bytes"] == 0
        assert g["hand_kernel_nodes"] == {
            w: g["launches"].get(w, 0) for w in gc.HAND_KERNELS}
        if wrapper is not None:
            assert g["launches"] == {wrapper: 2}
    if wrapper is None:
        for p in rep["passes"]:
            assert p["combines"] == p["groups"] == 4


@pytest.mark.cuda
def test_cuda_seeded_pinned_host_copy_fires_mdt111():
    """A body that copies a 2 MiB pinned host tensor inside the capture
    holds 2 MiB of host bytes: MDT111 fires (a contract that never
    fires proves nothing)."""
    from mdanalysis_mpi_tpu_torch.lint import graphcontracts as gc

    _card()
    findings, rep = gc.seeded_host_copy("cuda")
    assert rep["host_bytes"] == 2 << 20 and rep["replay_ok"]
    assert [(f.rule, f.detail) for f in findings] == [
        ("MDT111", "graph0:host_bytes")]


@pytest.mark.cuda
def test_cuda_graph_nodes_of_a_plain_capture():
    """The driver-API reader on a graph of known content: one
    host-to-device copy of its exact size, torch's fills as kernels."""
    from mdanalysis_mpi_tpu_torch.lint import graphcontracts as gc

    dev = _card()
    x = torch.zeros(1 << 16, device=dev)
    host = torch.ones(1 << 16).pin_memory()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g.capture_begin()
        y = x + host.to(dev, non_blocking=True)
        z = torch.full((1000,), -1, dtype=torch.int32, device=dev)
        g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    nodes = gc.read_graph_nodes(g.raw_cuda_graph())
    assert bool((y == 1).all()) and bool((z == -1).all())
    assert [k for k, _, _ in nodes].count("memcpy_htod") == 1
    assert gc.host_constant_bytes(nodes) == 4 << 16
    assert [k for k, _, _ in nodes].count("kernel") == 2


@pytest.mark.cuda
def test_cuda_rdf_repeat_after_a_file_leg_leaves_nothing_to_collect(tmp_path):
    """Phase 5's repeat after a phase-14-like load on the card: a fused
    int16 AlignedRMSF from a TRR, dropped, then InterRDF twice.  The
    file leg's analyses are freed when dropped, with their device blocks
    and graphs, so no later collection has them to free: before the
    repair a cycle through each analysis held it, and the collection
    that freed them cost phase 5's repeat 0.63 s on an H100."""
    import gc
    import weakref

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, InterRDF
    from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisBase, Results
    from mdanalysis_mpi_tpu_torch.io.psf import write_psf
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter
    from mdanalysis_mpi_tpu_torch.testing import (make_protein_universe,
                                                  make_water_universe)

    _card()
    u = make_protein_universe(n_residues=300, n_frames=64, seed=1)
    top, trr = str(tmp_path / "t.psf"), str(tmp_path / "t.trr")
    write_psf(top, u.topology)
    with TrajectoryWriter(trr, u.atoms.n_atoms) as w:
        for _ in u.trajectory:
            w.write(u.atoms)
    ow = make_water_universe(n_waters=500, n_frames=8,
                             seed=0).select_atoms("name OW")
    gc.collect()
    gc.disable()
    try:
        leg = AlignedRMSF(Universe(top, trr), select="name CA",
                          engine="fused")
        leg.run(backend="torch", device="cuda", batch_size=16,
                transfer_dtype="int16")
        ref = weakref.ref(leg)
        del leg
        assert ref() is None
        runs = [InterRDF(ow, ow).run(backend="torch", device="cuda",
                                     batch_size=4) for _ in range(2)]
        assert np.array_equal(runs[0].results.count, runs[1].results.count)
        del runs
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        left = [type(o).__name__ for o in gc.garbage
                if isinstance(o, (AnalysisBase, Results))]
        assert left == []
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
