"""The fused aligned-moments kernel over planar staged blocks: its
wrapper, its plain PyTorch version, and the executor-convention batch
functions built on it (the counterpart of the JAX package's
``ops/pallas_fused.py``).

Staged int16/int8 blocks arrive as ``(3, B, S)`` component planes (one
host repack at stage time, :func:`mdanalysis_mpi_tpu_torch.io.base.
planar_repack`); the delta tier reconstructs float32 frames on the
device and feeds the same sweep float32 planes with ``inv = 1``.  One
call computes, per atom, ``Σdev`` and ``Σdev²`` of the frames aligned
onto the reference (rows 0-2 and 3-5 of a ``(6, S)`` output), with the
per-frame rotation solved by QCP inside the sweep.

- :func:`planar_sums` is the wrapper.  On a CUDA tensor it launches the
  hand-written kernel ``csrc/fused_rmsf.cu`` (built on first use by
  :mod:`mdanalysis_mpi_tpu_torch._build`) or raises; on a CPU tensor it
  runs :func:`planar_sums_plain`.  ``planar_sums.launches`` counts the
  kernel launches: one cooperative launch per call on the current
  stream, after one fill of its scratch (``torch.full``).
- :func:`planar_sums_plain` is the kernel's plain version: the TPU
  kernel's algebra (``pallas_fused._build_planar``) in torch ops, but
  for the rotation solve, where it departs from the TPU kernel:
  :func:`qcp_rotation` runs in float64, as the kernel's does, while the
  TPU kernel's float32 solve loses the rotation of a two-atom or
  collinear selection (ROADMAP §C, C5).  tests/test_torch_fused.py
  ``test_two_atom_rotation_departs_from_the_tpu_kernel`` records the
  departure; tests/test_torch_ops.py
  ``test_planar_sums_plain_holds_a_float64_kabsch`` anchors the plain
  version to a float64 SVD Kabsch.
- :func:`fused_geometry` sizes the launch: one block per SM, each owning
  a slice of atoms (a multiple of 16), frames in groups of ``group``
  copied into a ring of ``stages`` shared-memory stages.  Above
  :func:`fused_max_atoms` a slice no longer fits two stages, and the
  geometry takes the kernel's wide mode, with the block read twice: three
  more entries, pass A's ``chunk`` and pass B's ``group_b`` frames of
  ``chunk_b`` atoms, the units its stages hold.

The kernel replaces ``mdanalysis_mpi_tpu/ops/pallas_fused.py::
_build_planar`` (``pl.pallas_call`` at :289).  The function is bound by
bytes, one read of the staged block, ``3·B·S·sizeof(dtype)``, over the
card's memory rate, and the kernel reads the block from device memory
once (twice in the wide mode): each block bulk-copies its slice's rows
into a ring of shared-memory stages; warps with fixed roles take the
per-frame sums, exchange them with the other blocks through L2 (each
frame combined in block order and solved by QCP on one thread of one
block; no float atomics) and take the moments from the same stage.  The
design and its sizing are at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch import device as _device  # noqa: F401  (TF32 off)
from mdanalysis_mpi_tpu_torch.ops.align import qcp_rotation

_DTYPE_CODES = {torch.int16: 0, torch.int8: 1, torch.float32: 2}
_ITEMSIZE = {torch.int16: 2, torch.int8: 1, torch.float32: 4}
# launch geometry of csrc/fused_rmsf.cu (fused_smem_bytes and
# wide_smem_bytes count its layouts; its entry point refuses a geometry
# that does not fit, and tests/test_torch_cuda.py holds the two together
# at the limit): shared memory a block may use on Hopper, the slice
# granule, the stage ring's bounds, the most blocks its frame solver
# takes, the largest frame group, and the group's target of 24 bytes per
# atom-row (12 int16, 24 int8, 6 float32 frames).  The wide mode's: pass
# B's largest chunk (four atoms a compute thread, kWideChunkB), the bytes
# of a box row (256 eight-byte elements, kBoxBytes), the frames of
# records a block holds (kWideRecords), pass A's group (a frame a
# compute warp) and the stages its units are sized for
SMEM_MAX = 232_448
SLICE_ATOMS = 16
MAX_STAGES = 12
MAX_BLOCKS = 160
MAX_GROUP = 24
_MIN_STAGES = 3
_GROUP_ROW_BYTES = 24
WIDE_CHUNK_B = 1536
WIDE_BOX_BYTES = 2048
WIDE_RECORDS = 512
WIDE_GROUP = 12
_WIDE_STAGES = 4


def _inv_column(inv_scale, B: int, device) -> torch.Tensor:
    """Scalar or per-frame (B,), (B,1) or (B,1,1) inverse scales → (B, 1)
    float32 on ``device``."""
    inv = torch.as_tensor(inv_scale, dtype=torch.float32, device=device)
    return inv.reshape(-1, 1).expand(B, 1)


def planar_sums_plain(qp, inv_scale, wN, refc_p, amask, sref, fmask):
    """The kernel's plain version: ``(3, B, S)`` planes → ``(6, S)``
    float32 (rows 0-2 ``Σdev``, rows 3-5 ``Σdev²``), the TPU kernel's
    sweep written in torch ops over the whole block at once, with the
    rotation solved in float64 (the module's note on C5)."""
    B = qp.shape[1]
    inv = _inv_column(inv_scale, B, qp.device)
    x0, x1, x2 = (qp[i].to(torch.float32) * inv for i in range(3))
    r0, r1, r2 = refc_p[:, 0], refc_p[:, 1], refc_p[:, 2]
    com0 = (x0 * wN).sum(dim=1)
    com1 = (x1 * wN).sum(dim=1)
    com2 = (x2 * wN).sum(dim=1)
    s0, s1, s2 = sref[0], sref[1], sref[2]
    h = [(x0 * r0).sum(dim=1) - com0 * s0,
         (x0 * r1).sum(dim=1) - com0 * s1,
         (x0 * r2).sum(dim=1) - com0 * s2,
         (x1 * r0).sum(dim=1) - com1 * s0,
         (x1 * r1).sum(dim=1) - com1 * s1,
         (x1 * r2).sum(dim=1) - com1 * s2,
         (x2 * r0).sum(dim=1) - com2 * s0,
         (x2 * r1).sum(dim=1) - com2 * s1,
         (x2 * r2).sum(dim=1) - com2 * s2]
    # the rotation is solved in float64, as the kernel solves it: in
    # float32 QCP loses the rotation where K's top eigenvalue is
    # (nearly) double (two atoms, collinear ones)
    R = [r[:, None].to(torch.float32)
         for r in qcp_rotation([hk.to(torch.float64) for hk in h])]
    xc0 = x0 - com0[:, None]
    xc1 = x1 - com1[:, None]
    xc2 = x2 - com2[:, None]
    fm = fmask.to(torch.float32).reshape(B, 1)
    devs = []
    for j, rj in enumerate((r0, r1, r2)):
        d = xc0 * R[j] + xc1 * R[3 + j] + xc2 * R[6 + j]
        devs.append((d - rj) * amask)
    dms = [dev * fm for dev in devs]
    return torch.stack([dm.sum(dim=0) for dm in dms]
                       + [(dm * dev).sum(dim=0)
                          for dm, dev in zip(dms, devs)])


def _check(name, t, shape, device):
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or tuple(t.shape) != shape or t.device != device
            or not t.is_contiguous()):
        desc = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
                if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(
            f"fused kernel: {name} must be a contiguous float32 tensor "
            f"of shape {shape} on {device}, got {desc}")


def fused_smem_bytes(slice_atoms: int, group: int, stages: int,
                     itemsize: int) -> int:
    """Shared memory of one block of the single-read form (``smem_bytes``
    in the CUDA source): 512 B of barriers and four 64-byte rotation
    records a frame of the group; 40 B an atom of parameters and
    accumulators; the stage ring."""
    return 512 + 256 * group + 40 * slice_atoms \
        + stages * 3 * group * slice_atoms * itemsize


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _wide_fixed_bytes(B: int) -> int:
    """The wide mode's barriers and records window (``wide_fixed_bytes``)."""
    return 512 + _round128(min(B, WIDE_RECORDS) * 64)


def wide_boxes(chunk_b: int, itemsize: int) -> int:
    """Boxes of pass B's chunk: rows of at most ``WIDE_BOX_BYTES``."""
    return -(-chunk_b * itemsize // WIDE_BOX_BYTES)


def wide_stage_bytes(group: int, chunk: int, group_b: int, chunk_b: int,
                     itemsize: int) -> int:
    """A stage of the wide mode (``wide_stage_bytes``): pass A's box of
    ``(3, group, chunk)`` with the chunk's w and ref (16 B an atom), or
    pass B's boxes of ``(3, group_b, chunk_b / boxes)``, each at a
    128-byte boundary."""
    nbox = wide_boxes(chunk_b, itemsize)
    pass_a = 3 * group * chunk * itemsize + 16 * chunk
    pass_b = nbox * _round128(3 * group_b * (chunk_b // nbox) * itemsize)
    return _round128(max(pass_a, pass_b))


def wide_smem_bytes(B: int, group: int, chunk: int, group_b: int,
                    chunk_b: int, stages: int, itemsize: int) -> int:
    """Shared memory of one block of the wide mode: barriers, the records
    of a window of ``min(B, WIDE_RECORDS)`` frames, the ring."""
    return _wide_fixed_bytes(B) + stages * wide_stage_bytes(
        group, chunk, group_b, chunk_b, itemsize)


def fused_max_atoms(itemsize: int, n_sm: int) -> int:
    """The largest S (a multiple of 256) of the kernel's single-read
    form on ``n_sm`` SMs: every slice fits one frame a group in two
    stages.  Above it :func:`fused_geometry` takes the wide mode."""
    n_sm = min(n_sm, MAX_BLOCKS)
    per_atom = 2 * 3 * itemsize + 40
    slice_max = (SMEM_MAX - fused_smem_bytes(0, 1, 0, itemsize)) \
        // per_atom // SLICE_ATOMS * SLICE_ATOMS
    return slice_max * n_sm // 256 * 256


def _wide_geometry(B: int, itemsize: int, per: int):
    """The wide mode's units for slices of ``per`` granules: pass A's
    ``(group, chunk)``, pass B's ``(group_b, chunk_b)`` and the ring's
    stages (see :func:`fused_geometry`)."""
    room = SMEM_MAX - _wide_fixed_bytes(B)
    stage_max = room // _WIDE_STAGES // 128 * 128
    # pass B: the slice in the fewest chunks of at most WIDE_CHUNK_B atoms,
    # as even as granules allow, each chunk in boxes of equal rows
    most = WIDE_CHUNK_B // SLICE_ATOMS
    gran = -(-per // -(-per // most))
    nbox = wide_boxes(gran * SLICE_ATOMS, itemsize)
    chunk_b = SLICE_ATOMS * nbox * -(-gran // nbox)
    group_b = max(g for g in range(1, min(B, MAX_GROUP) + 1)
                  if nbox * _round128(3 * g * (chunk_b // nbox) * itemsize)
                  <= stage_max)
    # pass A: a frame a compute warp, the chunk a multiple of 128 atoms
    # (four a lane) that fills the stage, one box row at most
    group = min(B, WIDE_GROUP)
    chunk = min(WIDE_BOX_BYTES // itemsize,
                stage_max // (3 * group * itemsize + 16) // 128 * 128)
    stage = wide_stage_bytes(group, chunk, group_b, chunk_b, itemsize)
    return group, min(MAX_STAGES, room // stage), chunk, group_b, chunk_b


@functools.lru_cache(maxsize=256)
def fused_geometry(B: int, S: int, itemsize: int, n_sm: int):
    """Launch geometry ``(slice, blocks, group, stages)`` for ``B``
    frames of ``S`` atoms of ``itemsize`` bytes on ``n_sm`` SMs, or
    ``(slice, blocks, group, stages, chunk, group_b, chunk_b)`` in the
    wide mode.

    ``slice`` is the least multiple of 16 atoms that covers ``S`` in at
    most ``n_sm`` blocks (the last block's slice may be shorter); the
    group is the largest up to 24 bytes an atom-row (and at most ``B``)
    that leaves room for three stages, then the ring takes up to twelve.
    Above :func:`fused_max_atoms` the single-read form does not fit, and
    the wide mode streams each slice twice through a ring of stages in
    units a tensor-map box each.  Pass A's unit is ``group`` frames (12,
    at most ``B``) of ``chunk`` atoms, the multiple of 128 that fills a
    quarter of the room beside the records window with w and ref, at
    most 2,048 bytes a row; pass B's is ``group_b`` frames of
    ``chunk_b`` atoms, the most even split of the slice into at most
    1,536 atoms (four a compute thread) in boxes of at most 2,048 bytes a
    row, with the most frames up to 24 that fill that quarter.  The ring
    then takes as many stages as fit, up to twelve.  Raises
    ``ValueError`` unless ``S % 256 == 0``."""
    n_sm = min(n_sm, MAX_BLOCKS)
    if S < 256 or S % 256:
        raise ValueError(
            f"fused kernel: S = {S} atoms must be a positive multiple of "
            "256 (pad_selection's ATOM_TILE)")
    per = -(-(S // SLICE_ATOMS) // n_sm)
    slice_atoms = SLICE_ATOMS * per
    blocks = -(-S // slice_atoms)
    if S > fused_max_atoms(itemsize, n_sm):
        return (slice_atoms, blocks) + _wide_geometry(B, itemsize, per)
    for group in range(min(_GROUP_ROW_BYTES // itemsize, B), 0, -1):
        room = SMEM_MAX - fused_smem_bytes(slice_atoms, group, 0, itemsize)
        stages = room // (3 * group * slice_atoms * itemsize)
        if stages >= _MIN_STAGES:
            return slice_atoms, blocks, group, min(stages, MAX_STAGES)
    return slice_atoms, blocks, 1, 2


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(qp, inv_scale, wN, refc_p, amask, sref, fmask):
    from mdanalysis_mpi_tpu_torch import _build

    dev = qp.device
    if qp.dtype not in _DTYPE_CODES or qp.dim() != 3 or qp.shape[0] != 3:
        raise ValueError(
            f"fused kernel: staged planes must be (3, B, S) int16, int8 "
            f"or float32, got {tuple(qp.shape)} {qp.dtype}")
    if not qp.is_contiguous() or qp.data_ptr() % 16:
        raise ValueError(
            "fused kernel: staged planes must be contiguous and 16-byte "
            "aligned")
    _, B, S = qp.shape
    if B < 1:
        raise ValueError(f"fused kernel: empty block {tuple(qp.shape)}")
    geometry = fused_geometry(B, S, _ITEMSIZE[qp.dtype], _sm_count(dev))
    slice_atoms, blocks, group, stages = geometry[:4]
    chunk, group_b, chunk_b = geometry[4:] if len(geometry) > 4 else (0,) * 3
    _check("wN", wN, (S,), dev)
    _check("refc_p", refc_p, (S, 3), dev)
    _check("amask", amask, (S,), dev)
    if wN.data_ptr() % 16 or refc_p.data_ptr() % 16 \
            or amask.data_ptr() % 16:
        raise ValueError(
            "fused kernel: wN, refc_p and amask must be 16-byte aligned "
            "(the wide mode reads them four atoms at a time)")
    _check("sref", sref, (3,), dev)
    _check("fmask", fmask, (B,), dev)
    if isinstance(inv_scale, (torch.Tensor, np.ndarray)) \
            and np.prod(inv_scale.shape) > 1:
        inv_t = torch.as_tensor(inv_scale, dtype=torch.float32,
                                device=dev).reshape(-1).contiguous()
        if inv_t.numel() != B:
            raise ValueError(
                f"fused kernel: per-frame inv_scale has {inv_t.numel()} "
                f"entries for {B} frames")
        inv_ptr, inv_scalar = inv_t.data_ptr(), 0.0
    elif isinstance(inv_scale, torch.Tensor):
        # a one-element device tensor: broadcast on the device (reading
        # it on the host would synchronize)
        inv_t = inv_scale.to(device=dev, dtype=torch.float32).reshape(
            1).expand(B).contiguous()
        inv_ptr, inv_scalar = inv_t.data_ptr(), 0.0
    else:
        inv_ptr, inv_scalar = None, float(inv_scale)

    # the blocks' per-frame partial sums and the frames' rotation
    # records, every word 0xffffffff (the one reset): the kernel's
    # readers poll each value until it is written
    scratch = torch.full((B * (12 * blocks + 16),), -1, dtype=torch.int32,
                         device=dev)
    out = torch.empty((6, S), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mdtpu_fused_planar(
            qp.data_ptr(), _DTYPE_CODES[qp.dtype], B, S, inv_ptr,
            ctypes.c_float(inv_scalar), wN.data_ptr(), refc_p.data_ptr(),
            amask.data_ptr(), fmask.data_ptr(), sref.data_ptr(),
            slice_atoms, blocks, group, stages, chunk, group_b, chunk_b,
            scratch.data_ptr(),
            out.data_ptr(), stream)
    if rc != 0:
        raise _build.KernelLaunchError(
            f"fused kernel launch failed: CUDA error {rc} "
            f"({lib.mdtpu_cuda_error_string(rc).decode()})")
    return out


def planar_sums(qp, inv_scale, wN, refc_p, amask, sref, fmask):
    """``(3, B, S)`` staged planes → ``(6, S)`` float32 moment sums.

    ``inv_scale``: a scalar, or per-frame ``(B,)``/``(B,1,1)``.  On a
    CUDA tensor this launches the CUDA kernel (and counts it in
    ``planar_sums.launches``; a launch captured into a CUDA graph counts
    at each replay) or raises; on a CPU tensor it runs the plain
    version."""
    if qp.device.type == "cpu":
        return planar_sums_plain(qp, inv_scale, wN, refc_p, amask, sref,
                                 fmask)
    if qp.device.type != "cuda":
        raise ValueError(
            f"fused kernel: no kernel for device {qp.device}")
    from mdanalysis_mpi_tpu_torch import _build

    out = _launch(qp, inv_scale, wN, refc_p, amask, sref,
                  fmask.to(torch.float32))
    _build.count_launch(planar_sums)
    return out


planar_sums.launches = 0


def _core_planar(qp, inv_scale, wN, refc_p, amask, sref, fmask):
    """Planar fused core: ``(3, B, S)`` staged planes → ``(T, Σdev,
    Σdev²)`` with sums shaped ``(S, 3)``."""
    out = planar_sums(qp, inv_scale, wN, refc_p, amask, sref, fmask)
    return fmask.to(torch.float32).sum(), out[0:3].T, out[3:6].T


def _moments_from_core(t, sum_d, sumsq, refc_p, ref_com, n_real):
    tt = torch.clamp(t, min=1.0)
    mean = ((refc_p + ref_com) + sum_d / tt)[:n_real]
    m2 = torch.clamp(sumsq - sum_d * sum_d / tt, min=0.0)[:n_real]
    return t, mean, m2


@functools.lru_cache(maxsize=None)
def moments_kernel_for(n_real: int):
    """Planar quantized-native moments batch function (executor
    convention ``f(params, q_planar, inv_scale, boxes, mask)``) → the
    standard moment partials ``(T, mean, M2)`` over the ``n_real`` real
    atoms.  ``staging_layout`` tells the executor to stage ``(3, B, S)``
    planes."""

    def aligned_moments_planar(params, q, inv_scale, boxes, mask):
        del boxes
        wN, refc_p, ref_com, amask, sref = params
        t, sum_d, sumsq = _core_planar(q, inv_scale, wN, refc_p, amask,
                                       sref, mask)
        return _moments_from_core(t, sum_d, sumsq, refc_p, ref_com,
                                  n_real)

    aligned_moments_planar.__name__ = f"aligned_moments_planar_{n_real}"
    aligned_moments_planar.staging_layout = "planar"
    return aligned_moments_planar


@functools.lru_cache(maxsize=None)
def avg_kernel_for(n_real: int):
    """Planar quantized-native pass-1 average batch function
    ``(T, Σ aligned)``."""

    def avg_sum_planar(params, q, inv_scale, boxes, mask):
        del boxes
        wN, refc_p, ref_com, amask, sref = params
        t, sum_d, _ = _core_planar(q, inv_scale, wN, refc_p, amask, sref,
                                   mask)
        return t, (sum_d + t * (refc_p + ref_com))[:n_real]

    avg_sum_planar.__name__ = f"avg_sum_planar_{n_real}"
    avg_sum_planar.staging_layout = "planar"
    return avg_sum_planar


def _delta_reconstruct(res, key, inv_abs, inv_res):
    """Device-side closed-loop DPCM reconstruction (the executors'
    ``_delta_wrapper`` expression) → planar float32 ``(3, B, S)``."""
    x = (key.to(torch.float32) * inv_abs
         + torch.cumsum(res.to(torch.float32) * inv_res, dim=0))
    return x.permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=None)
def moments_delta_kernel_for(n_real: int):
    """Delta-native moments batch function (6-element staged tuple):
    the cross-frame cumsum reconstruction stays a torch op, then the
    fused sweep runs on float32 planes with ``inv = 1``."""

    def aligned_moments_delta(params, res, key, inv_abs, inv_res, boxes,
                              mask):
        del boxes
        wN, refc_p, ref_com, amask, sref = params
        t, sum_d, sumsq = _core_planar(
            _delta_reconstruct(res, key, inv_abs, inv_res), 1.0, wN,
            refc_p, amask, sref, mask)
        return _moments_from_core(t, sum_d, sumsq, refc_p, ref_com,
                                  n_real)

    aligned_moments_delta.__name__ = f"aligned_moments_delta_{n_real}"
    return aligned_moments_delta


@functools.lru_cache(maxsize=None)
def avg_delta_kernel_for(n_real: int):
    """Delta-native pass-1 average batch function (6-element staged
    tuple)."""

    def avg_sum_delta(params, res, key, inv_abs, inv_res, boxes, mask):
        del boxes
        wN, refc_p, ref_com, amask, sref = params
        t, sum_d, _ = _core_planar(
            _delta_reconstruct(res, key, inv_abs, inv_res), 1.0, wN,
            refc_p, amask, sref, mask)
        return t, (sum_d + t * (refc_p + ref_com))[:n_real]

    avg_sum_delta.__name__ = f"avg_sum_delta_{n_real}"
    return avg_sum_delta
