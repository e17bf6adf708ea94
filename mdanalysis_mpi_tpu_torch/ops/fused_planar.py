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
  geometry takes the kernel's wide mode: a fifth entry, ``chunk``, the
  atoms of the slice a stage holds, with the block read twice.

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
# launch geometry of csrc/fused_rmsf.cu (fused_smem_bytes counts its
# layout; its entry point refuses a geometry that does not fit, and
# tests/test_torch_cuda.py holds the two together at the limit): shared
# memory a block may use on Hopper, the slice granule, the stage ring's
# bounds, the most blocks its frame solver takes, and the group's target
# of 24 bytes per atom-row (12 int16, 24 int8, 6 float32 frames); the
# wide mode's largest chunk (two atoms a compute thread, kWideChunk) and
# the stages its chunk is sized for
SMEM_MAX = 232_448
SLICE_ATOMS = 16
MAX_STAGES = 12
MAX_BLOCKS = 160
_MIN_STAGES = 3
_GROUP_ROW_BYTES = 24
WIDE_CHUNK = 768
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
                     itemsize: int, chunk: int = 0) -> int:
    """Shared memory of one block (``smem_bytes`` in the CUDA source):
    512 B of barriers and four 64-byte rotation records a frame of the
    group; 40 B an atom of parameters and accumulators; the stage
    ring.  With a ``chunk`` (the wide mode, ``wide_smem_bytes``) the
    ring's stages hold ``chunk`` atoms and there is no per-atom area."""
    fixed = 512 + 256 * group
    if chunk:
        return fixed + stages * 3 * group * chunk * itemsize
    return fixed + 40 * slice_atoms + stages * 3 * group * slice_atoms \
        * itemsize


def fused_max_atoms(itemsize: int, n_sm: int) -> int:
    """The largest S (a multiple of 256) of the kernel's single-read
    form on ``n_sm`` SMs: every slice fits one frame a group in two
    stages.  Above it :func:`fused_geometry` takes the wide mode."""
    n_sm = min(n_sm, MAX_BLOCKS)
    per_atom = 2 * 3 * itemsize + 40
    slice_max = (SMEM_MAX - fused_smem_bytes(0, 1, 0, itemsize)) \
        // per_atom // SLICE_ATOMS * SLICE_ATOMS
    return slice_max * n_sm // 256 * 256


@functools.lru_cache(maxsize=256)
def fused_geometry(B: int, S: int, itemsize: int, n_sm: int):
    """Launch geometry ``(slice, blocks, group, stages)`` for ``B``
    frames of ``S`` atoms of ``itemsize`` bytes on ``n_sm`` SMs, or
    ``(slice, blocks, group, stages, chunk)`` in the wide mode.

    ``slice`` is the least multiple of 16 atoms that covers ``S`` in at
    most ``n_sm`` blocks (the last block's slice may be shorter); the
    group is the largest up to 24 bytes an atom-row (and at most ``B``)
    that leaves room for three stages, then the ring takes up to twelve.
    Above :func:`fused_max_atoms` the single-read form does not fit, and
    the wide mode streams each slice in chunks: the group is 24 int8 or
    12 wider frames (at most ``B``), the chunk the most even split of the
    slice into multiples of 16 atoms, at most 768, that fits four stages,
    then the ring takes up to twelve.  Raises ``ValueError`` unless ``S %
    256 == 0``."""
    n_sm = min(n_sm, MAX_BLOCKS)
    if S < 256 or S % 256:
        raise ValueError(
            f"fused kernel: S = {S} atoms must be a positive multiple of "
            "256 (pad_selection's ATOM_TILE)")
    per = -(-(S // SLICE_ATOMS) // n_sm)
    slice_atoms = SLICE_ATOMS * per
    blocks = -(-S // slice_atoms)
    if S > fused_max_atoms(itemsize, n_sm):
        group = min(24 if itemsize == 1 else 12, B)
        room = SMEM_MAX - fused_smem_bytes(0, group, 0, itemsize)
        row = 3 * group * itemsize          # a stage's bytes an atom
        most = min(WIDE_CHUNK, room // (_WIDE_STAGES * row)
                   // SLICE_ATOMS * SLICE_ATOMS)
        n_chunks = -(-slice_atoms // most)
        chunk = SLICE_ATOMS * -(-per // n_chunks)
        return (slice_atoms, blocks, group,
                min(MAX_STAGES, room // (row * chunk)), chunk)
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
    chunk = geometry[4] if len(geometry) > 4 else 0
    _check("wN", wN, (S,), dev)
    _check("refc_p", refc_p, (S, 3), dev)
    if wN.data_ptr() % 16 or refc_p.data_ptr() % 16:
        raise ValueError(
            "fused kernel: wN and refc_p must be 16-byte aligned (the "
            "wide mode reads them four atoms at a time)")
    _check("amask", amask, (S,), dev)
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
            slice_atoms, blocks, group, stages, chunk, scratch.data_ptr(),
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
