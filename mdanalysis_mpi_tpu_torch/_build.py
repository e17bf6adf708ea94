"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and linked into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  No
source includes PyTorch's headers, which keeps the build short.

The library lands in ``build/mdtpu_torch_kernels/<hash>/`` at the root
of the checkout, keyed by a hash of the sources and the flags, and is
built on first use: the first CUDA launch of a kernel builds it, so a
fresh checkout needs nothing but ``nvcc``.  Nothing here runs at import
time; the CPU tests import every module of the package without a
compiler.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                          "mdtpu_torch_kernels")
LIB_NAME = "libmdtpu_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

class KernelBuildError(RuntimeError):
    """``nvcc`` failed (or is missing): the kernels of this checkout
    cannot be built.  Never degradable — a resilient run raises it
    too (:func:`mdanalysis_mpi_tpu_torch.reliability.policy.
    is_degradable`)."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a non-zero CUDA error code (the C entry
    points return ``cudaGetLastError()`` after each launch).  Never
    degradable: a resilient run raises it rather than finish the work
    without the kernel (:func:`mdanalysis_mpi_tpu_torch.reliability.
    policy.is_degradable`)."""


_lock = threading.Lock()
_lib = None
_capture = threading.local()


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``.
    Inside a CUDA graph capture the kernel does not run yet: the launch
    is recorded on the capture (:func:`recording`) and counted at each
    replay of the graph, where it runs."""
    rec = getattr(_capture, "launches", None)
    if rec is not None:
        rec.append(wrapper)
    else:
        wrapper.launches += 1


class recording:
    """``with recording() as launches:`` — the kernel launches
    :func:`count_launch` sees on this thread while a graph is captured,
    in order (the capturer counts them at each replay)."""

    def __enter__(self):
        self._prev = getattr(_capture, "launches", None)
        _capture.launches = []
        return _capture.launches

    def __exit__(self, *exc):
        _capture.launches = self._prev
        return False
#: wall seconds of this process's build (0.0 when the library was
#: already built), and the compiler's output (ptxas register and
#: shared-memory report per kernel)
BUILD_SECONDS = 0.0
BUILD_LOG = ""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH); the port's CUDA kernels are built from csrc/ with it")


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _digest(sources()), LIB_NAME)


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library unless it exists;
    returns its path.  The build goes to a private directory renamed
    into place, so concurrent builds never see a half-written file."""
    global BUILD_SECONDS, BUILD_LOG
    srcs = sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    t0 = time.perf_counter()
    cc = nvcc()
    tmp = f"{out_dir}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        objs = [os.path.join(tmp, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        procs = [subprocess.Popen([cc, *NVCC_FLAGS, "-c", s, "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = []
        failed = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(s)}\n{out}")
            if p.returncode != 0:
                failed.append(s)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise KernelBuildError(
                f"nvcc failed for {failed}:\n{BUILD_LOG}")
        link = subprocess.run(
            [cc, "-shared", "-o", os.path.join(tmp, LIB_NAME), *objs],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{link.stderr}")
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not os.path.exists(lib):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (building it first if needed), with
    every C entry point's argument types declared."""
    from mdanalysis_mpi_tpu_torch.utils import compile_cache

    global _lib
    with _lock:
        if _lib is not None:
            compile_cache.note_build(built=False)
            return _lib
        t0 = time.perf_counter()
        path = build()
        compile_cache.note_build(built=True,
                                 seconds=time.perf_counter() - t0)
        lib = ctypes.CDLL(path)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mdtpu_fused_planar.restype = ci
        lib.mdtpu_fused_planar.argtypes = [
            vp, ci, ci, ci,          # qp, dtype, B, S
            vp, cf,                  # inv, inv_scalar
            vp, vp, vp, vp, vp,      # w, ref, amask, fmask, sref
            ci, ci, ci, ci,          # slice, blocks, group, stages
            ci, ci, ci,              # chunk, group_b, chunk_b
            vp, vp,                  # scratch, out
            vp]                      # stream
        lib.mdtpu_pair_histogram.restype = ci
        lib.mdtpu_pair_histogram.argtypes = [
            vp, vp, vp, vp,          # a, b, lengths, edges
            ci, ci, ci, ci, ci,      # B, N, M, nbins, exclude_self
            vp, vp]                  # counts, stream
        lib.mdtpu_cuda_error_string.restype = ctypes.c_char_p
        lib.mdtpu_cuda_error_string.argtypes = [ci]
        _lib = lib
        return _lib
