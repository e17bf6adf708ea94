"""ctypes loader for the native trajio codec (libtrajio.so).

Builds the shared object on first use (g++ via the adjacent Makefile —
the toolchain is a baked-in dependency of this framework's environment;
SURVEY.md §7 layer 2 calls for C++ where the reference's I/O stack is
native).  pybind11 is unavailable here, hence the plain C ABI + ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_SO = os.path.join(_DIR, "libtrajio.so")
_SRC = os.path.join(_DIR, "trajio.cpp")

_lock = threading.Lock()
_lib = None

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build():
    try:
        subprocess.run(
            ["make", "-s", "-C", _DIR],
            check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(
            f"failed to build native trajio library in {_DIR}: {detail}"
        ) from e


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library; thread-safe."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)

        lib.xtc_scan.restype = ctypes.c_long
        lib.xtc_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p, ctypes.c_long]

        lib.xtc_read_frames.restype = ctypes.c_int
        lib.xtc_read_frames.argtypes = [
            ctypes.c_char_p, _i64p, ctypes.c_long, ctypes.c_int,
            _f32p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

        lib.xtc_stage_i16.restype = ctypes.c_int
        lib.xtc_stage_i16.argtypes = [
            ctypes.c_char_p, _i64p, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_float, _i16p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]

        lib.xtc_stage_i16_planar.restype = ctypes.c_int
        lib.xtc_stage_i16_planar.argtypes = [
            ctypes.c_char_p, _i64p, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_float, ctypes.c_long,
            _i16p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]

        lib.xtc_stage_f32.restype = ctypes.c_int
        lib.xtc_stage_f32.argtypes = [
            ctypes.c_char_p, _i64p, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, _f32p,
            ctypes.c_void_p]

        lib.xtc_write.restype = ctypes.c_int
        lib.xtc_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long, _f32p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_float]

        lib.dcd_scan.restype = ctypes.c_long
        lib.dcd_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long)]

        lib.dcd_read_frames.restype = ctypes.c_int
        lib.dcd_read_frames.argtypes = [
            ctypes.c_char_p, _i64p, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_long, ctypes.c_long, _f32p,
            ctypes.c_void_p]

        lib.dcd_write.restype = ctypes.c_int
        lib.dcd_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long, _f32p,
            ctypes.c_void_p, ctypes.c_double]

        lib.stage_gather_quantize_i16.restype = ctypes.c_int
        lib.stage_gather_quantize_i16.argtypes = [
            _f32p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_long, _i16p, ctypes.POINTER(ctypes.c_float)]

        lib.stage_gather_quantize_i16_scaled.restype = ctypes.c_int
        lib.stage_gather_quantize_i16_scaled.argtypes = [
            _f32p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_float, _i16p,
            ctypes.POINTER(ctypes.c_float)]

        lib.stage_gather_quantize_i16_planar.restype = ctypes.c_int
        lib.stage_gather_quantize_i16_planar.argtypes = [
            _f32p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_long, _i16p,
            ctypes.POINTER(ctypes.c_float)]

        lib.stage_gather_quantize_i16_scaled_planar.restype = ctypes.c_int
        lib.stage_gather_quantize_i16_scaled_planar.argtypes = [
            _f32p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_float, ctypes.c_long, _i16p,
            ctypes.POINTER(ctypes.c_float)]

        lib.stage_gather_f32.restype = ctypes.c_int
        lib.stage_gather_f32.argtypes = [
            _f32p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
            ctypes.c_long, _f32p]

        lib.qcp_superpose_apply.restype = ctypes.c_int
        lib.qcp_superpose_apply.argtypes = [
            _f32p, ctypes.c_long, _i64p, ctypes.c_long, _f64p,
            _f64p, _f64p, _f64p, ctypes.c_void_p]

        lib.qcp_superpose_moments.restype = ctypes.c_int
        lib.qcp_superpose_moments.argtypes = [
            _f32p, ctypes.c_long, _i64p, ctypes.c_long, _f64p,
            _f64p, _f64p, ctypes.c_long, _f64p, _f64p]

        _lib = lib
        return _lib


def _sel_arg(sel, n_atoms: int):
    """``(idx, n_sel, pointer)`` for a staging kernel's selection: the
    int32 index array (the caller keeps it alive across the call), or
    ``(None, n_atoms, None)`` for every atom."""
    if sel is None:
        return None, n_atoms, None
    idx = np.ascontiguousarray(sel, dtype=np.int32)
    return idx, len(idx), idx.ctypes.data_as(ctypes.c_void_p)


def stage_threads(n_frames: int, cores: int | None = None,
                  ranks: int | None = None) -> int:
    """Host threads for one planar staging pass over ``n_frames``: the
    cores this process may run on (``os.sched_getaffinity``), shared
    with the other ranks on this host
    (``parallel.distributed.ranks_on_host``), less one for the wire and
    dispatch threads; at least 1, at most one a frame.  Passes that run
    at once in one process (a ``Scheduler``'s workers and its prefetch
    thread) each take this count: on the card's host that fills six
    caches faster than one budget shared among them (PERF.md §6)."""
    if cores is None:
        affinity = getattr(os, "sched_getaffinity", None)
        cores = len(affinity(0)) if affinity else (os.cpu_count() or 1)
    if ranks is None:
        from mdanalysis_mpi_tpu_torch.parallel.distributed import (
            ranks_on_host)

        ranks = ranks_on_host()
    return max(1, min(cores // max(ranks, 1) - 1, n_frames))


def stage_gather_quantize(src: np.ndarray, sel=None):
    """Fused selection-gather + block int16 quantization in C++.

    ``src`` is (B, N, 3) float32 C-contiguous; ``sel`` an int array into
    the atom axis or None for all atoms.  Returns (q (B, S, 3) int16,
    inv_scale float32) — this exact-scale kernel is bit-identical to
    ``parallel.executors.quantize_block(src[:, sel])`` (the adaptive
    one-pass ``stage_gather_quantize_scaled`` below is not: it trades
    exact per-block scales for half the memory traffic).
    """
    lib = load()
    b, n = src.shape[0], src.shape[1]
    idx, s, idx_p = _sel_arg(sel, n)
    out = np.empty((b, s, 3), dtype=np.int16)
    inv = ctypes.c_float(0.0)
    rc = lib.stage_gather_quantize_i16(
        src, b, n, idx_p, s, out, ctypes.byref(inv))
    if rc != 0:
        raise RuntimeError(f"stage_gather_quantize_i16 failed (rc={rc})")
    return out, np.float32(inv.value)


def stage_gather_quantize_scaled(src: np.ndarray, sel, scale: float):
    """One-pass fused gather + int16 quantize with a caller-provided
    ``scale`` (see trajio.cpp: halves the two-pass kernel's memory
    traffic).  Returns ``(q, max_abs, overflowed)``: ``overflowed`` True
    means the scale would have clipped real data — the caller must
    discard ``q`` and re-quantize with a scale from ``max_abs``.
    """
    lib = load()
    b, n = src.shape[0], src.shape[1]
    idx, s, idx_p = _sel_arg(sel, n)
    out = np.empty((b, s, 3), dtype=np.int16)
    vmax = ctypes.c_float(0.0)
    rc = lib.stage_gather_quantize_i16_scaled(
        src, b, n, idx_p, s, ctypes.c_float(scale), out, ctypes.byref(vmax))
    if rc < 0:
        raise RuntimeError(f"stage_gather_quantize_i16_scaled failed (rc={rc})")
    return out, float(vmax.value), rc == 1


def stage_gather_quantize_planar(src: np.ndarray, sel=None,
                                 threads: int | None = None):
    """:func:`stage_gather_quantize` writing the ``(3, B, S)`` planes
    straight from the native pass, its frames split over ``threads``
    host threads (default :func:`stage_threads`).  Returns ``(planes,
    inv_scale)``: the bytes of ``planar_repack`` of the interleaved
    kernel's block at any thread count."""
    lib = load()
    b, n = src.shape[0], src.shape[1]
    idx, s, idx_p = _sel_arg(sel, n)
    nt = stage_threads(b) if threads is None else threads
    out = np.empty((3, b, s), dtype=np.int16)
    inv = ctypes.c_float(0.0)
    rc = lib.stage_gather_quantize_i16_planar(
        src, b, n, idx_p, s, nt, out, ctypes.byref(inv))
    if rc != 0:
        raise RuntimeError(
            f"stage_gather_quantize_i16_planar failed (rc={rc})")
    return out, np.float32(inv.value)


def stage_gather_quantize_scaled_planar(src: np.ndarray, sel, scale: float,
                                        threads: int | None = None):
    """:func:`stage_gather_quantize_scaled` writing the ``(3, B, S)``
    planes, split over ``threads`` host threads (default
    :func:`stage_threads`).  Returns ``(planes, max_abs, overflowed)``
    with the same contract."""
    lib = load()
    b, n = src.shape[0], src.shape[1]
    idx, s, idx_p = _sel_arg(sel, n)
    nt = stage_threads(b) if threads is None else threads
    out = np.empty((3, b, s), dtype=np.int16)
    vmax = ctypes.c_float(0.0)
    rc = lib.stage_gather_quantize_i16_scaled_planar(
        src, b, n, idx_p, s, ctypes.c_float(scale), nt, out,
        ctypes.byref(vmax))
    if rc < 0:
        raise RuntimeError(
            f"stage_gather_quantize_i16_scaled_planar failed (rc={rc})")
    return out, float(vmax.value), rc == 1


def _xtc_args(offsets: np.ndarray, natoms: int, sel, want_box: bool):
    """``(offsets, n, idx, n_sel, idx_p, box, box_p)`` for an XTC
    staging call: the int64 frame offsets, the selection
    (:func:`_sel_arg`; the caller keeps ``idx`` alive across the call)
    and the ``(n, 9)`` nm box buffer, or None."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets)
    idx, s, idx_p = _sel_arg(sel, natoms)
    box = np.empty((n, 9), dtype=np.float32) if want_box else None
    box_p = box.ctypes.data_as(ctypes.c_void_p) if want_box else None
    return offsets, n, idx, s, idx_p, box, box_p


def xtc_stage_i16(path: str, offsets: np.ndarray, natoms: int, sel,
                  scale: float, want_box: bool = True):
    """Fused XTC decode → selection gather → nm→Å → int16 quantize.

    Never materializes the full-system float32 block (each frame decodes
    into a cache-hot per-thread scratch; only the selection's int16
    bytes reach DRAM) — the cold-path staging kernel, its frames split
    over ``MDTPU_DECODE_THREADS`` threads (default 1).  Returns
    ``(q (F, S, 3) int16, box (F, 9) nm float32 | None, max_abs_Å,
    overflowed)``; on ``overflowed`` the caller re-runs with an exact
    scale from ``max_abs_Å`` (same contract as
    :func:`stage_gather_quantize_scaled`).
    """
    lib = load()
    offsets, n, idx, s, idx_p, box, box_p = _xtc_args(
        offsets, natoms, sel, want_box)
    out = np.empty((n, s, 3), dtype=np.int16)
    vmax = ctypes.c_float(0.0)
    rc = lib.xtc_stage_i16(
        path.encode(), offsets, n, natoms, idx_p, s,
        ctypes.c_float(scale), out, box_p, ctypes.byref(vmax))
    if rc < 0:
        raise IOError(f"xtc_stage_i16 failed for {path!r} (rc={rc})")
    return out, box, float(vmax.value), rc == 1


def xtc_stage_i16_planar(path: str, offsets: np.ndarray, natoms: int, sel,
                         scale: float, threads: int, want_box: bool = True):
    """:func:`xtc_stage_i16` writing the ``(3, F, S)`` planes straight
    from the decode, its frames split over ``threads`` host threads,
    each decoding into its own scratch.  Returns ``(planes, box,
    max_abs_Å, overflowed)`` with the same contract: the bytes of
    ``planar_repack`` of :func:`xtc_stage_i16`'s block at any thread
    count."""
    lib = load()
    offsets, n, idx, s, idx_p, box, box_p = _xtc_args(
        offsets, natoms, sel, want_box)
    out = np.empty((3, n, s), dtype=np.int16)
    vmax = ctypes.c_float(0.0)
    rc = lib.xtc_stage_i16_planar(
        path.encode(), offsets, n, natoms, idx_p, s,
        ctypes.c_float(scale), threads, out, box_p, ctypes.byref(vmax))
    if rc < 0:
        raise IOError(f"xtc_stage_i16_planar failed for {path!r} (rc={rc})")
    return out, box, float(vmax.value), rc == 1


def xtc_stage_f32(path: str, offsets: np.ndarray, natoms: int, sel,
                  want_box: bool = True, threads: int | None = None):
    """Fused XTC decode → selection gather → nm→Å (float32 staging
    path); see :func:`xtc_stage_i16`.  Its frames split over ``threads``
    host threads, or over ``MDTPU_DECODE_THREADS`` threads when None.
    Returns ``(coords (F, S, 3) Å, box (F, 9) nm | None)``."""
    lib = load()
    offsets, n, idx, s, idx_p, box, box_p = _xtc_args(
        offsets, natoms, sel, want_box)
    out = np.empty((n, s, 3), dtype=np.float32)
    rc = lib.xtc_stage_f32(
        path.encode(), offsets, n, natoms, idx_p, s,
        0 if threads is None else threads, out, box_p)
    if rc != 0:
        raise IOError(f"xtc_stage_f32 failed for {path!r} (rc={rc})")
    return out, box


def stage_gather(src: np.ndarray, sel=None) -> np.ndarray:
    """Selection gather ``src[:, sel]`` in C++ (float32 staging path)."""
    lib = load()
    b, n = src.shape[0], src.shape[1]
    idx, s, idx_p = _sel_arg(sel, n)
    out = np.empty((b, s, 3), dtype=np.float32)
    rc = lib.stage_gather_f32(src, b, n, idx_p, s, out)
    if rc != 0:
        raise RuntimeError(f"stage_gather_f32 failed (rc={rc})")
    return out


def qcp_superpose_apply(coords: np.ndarray, sel: np.ndarray,
                        weights: np.ndarray, ref_c: np.ndarray,
                        ref_com: np.ndarray, want_rot: bool = False):
    """Native full-frame QCP superposition (see trajio.cpp).

    coords (N,3) f32 C-contiguous; returns aligned (N,3) f64 (and R
    (3,3) f64 when ``want_rot``) with the ops.host conventions.
    """
    import ctypes as _ct

    lib = load()
    n = coords.shape[0]
    sel = np.ascontiguousarray(sel, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    ref_c = np.ascontiguousarray(ref_c, dtype=np.float64)
    ref_com = np.ascontiguousarray(ref_com, dtype=np.float64)
    out = np.empty((n, 3), dtype=np.float64)
    rot = np.empty((3, 3), dtype=np.float64) if want_rot else None
    rc = lib.qcp_superpose_apply(
        coords, n, sel, len(sel), weights, ref_c, ref_com, out,
        rot.ctypes.data_as(_ct.c_void_p) if want_rot else None)
    if rc != 0:
        raise RuntimeError(f"qcp_superpose_apply failed (rc={rc})")
    return (out, rot) if want_rot else out


def qcp_superpose_moments(coords: np.ndarray, sel: np.ndarray,
                          weights: np.ndarray, ref_c: np.ndarray,
                          ref_com: np.ndarray, k: int,
                          mean: np.ndarray, m2: np.ndarray) -> None:
    """Native fused superpose-selection + streaming Welford update
    (mean/m2 (S,3) f64 updated in place; caller advances the count)."""
    lib = load()
    sel = np.ascontiguousarray(sel, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    ref_c = np.ascontiguousarray(ref_c, dtype=np.float64)
    ref_com = np.ascontiguousarray(ref_com, dtype=np.float64)
    rc = lib.qcp_superpose_moments(
        coords, coords.shape[0], sel, len(sel), weights, ref_c, ref_com,
        k, mean, m2)
    if rc != 0:
        raise RuntimeError(f"qcp_superpose_moments failed (rc={rc})")
