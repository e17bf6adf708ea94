#!/usr/bin/env python3
"""Per-block timeline of the fused aligned-moments kernel
(``mdanalysis_mpi_tpu_torch/csrc/fused_rmsf.cu``) on one NVIDIA GPU:
where a launch spends its time.

Run from the root of a checkout::

    python3 scripts/fused_rmsf_trace.py [--out DIR] [--source FILE]
        [--groups G1,G2,...] [--cases NAME,...]

Writes a copy of the kernel source (``--source``, default the
package's own) with timestamps inserted into ``DIR`` (default
``build/fused_rmsf_trace``) and builds it there: the block's first sums
thread, first moments thread and frame solver stamp the card's
``%globaltimer`` (ns) at eight points of each group.  The stamps go in
after fixed lines of the source (``TRACE_POINTS``); a source without one
of them stops the script.  For the three main cases of
``chip_smoke.py`` phase 3 (B = 512, S = 50,176, int16, int8 and float32
planes) it launches the traced build through the wrapper three times,
traces the fourth launch, checks that launch against
``planar_sums_plain`` (mean within 5e-4, M2 within 5e-3), and prints, in
µs, the launch's span from the first stamp to the last, and the mean
over blocks and groups of:

- ``period``: one group of the sums warps; ``data``: their wait for
  the group's bulk copies (mbarrier); ``sums``: their 12 sums of its
  frames;
- ``mperiod``: one group of the moments warps; ``ready``: their wait
  for the group's data and published rotations; ``moments``: their
  moments of the group;
- ``publish``: from a group's last sums to the solver's store of each
  of its frames' records, in three parts: ``arrive`` (until the solver
  sees its own block's sums of the group), ``combine`` (every block's
  partials read and summed) and ``qcp`` (the rotation solved and its
  record stored).

It also prints one stage's cycle, group by group averaged over the
blocks and over the groups whose stage is refilled: from the group's
data landing to its sums stored (``c_sums``), to the last block's sums
(``c_skew``), to the solvers having every block's partials read
(``c_combine``), to the
group's last record stored (``c_qcp``), to the moments warps starting
the group (``c_rot``), to their end (``c_moments``), and to the stage's
refill landing (``c_refill``); ``cycle`` is their sum, the time a
stage takes to come round, and ``cycle / stages`` the pace per group.

Beside the timeline, ``ms`` is the launch's device time with the
stamps off (median of 20 launches queued behind a sleep, CUDA events
around each).  ``--groups`` runs every case once per frame-group size
instead of the wrapper's own choice (the ring then takes as many
stages as fit); ``--cases`` picks cases by name.

Raw stamps go to ``DIR/<case>-g<G>.npy`` (blocks × iterations × 8, ns).
The last line is one JSON object with every number.  Exits non-zero
without a CUDA device, when the build fails or a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("main-int16", "int16"), ("main-int8", "int8"),
         ("main-f32", "float32"))


# Each block stamps %globaltimer into trace[(block * groups + g) * 8 + k]:
# the first sums thread at k = 0 (group g's turn), 1 (its data landed),
# 2 (its sums stored); the solver's lane 0, for a group it solves a
# frame of, at 3 (its own block's sums of the group done), 4 (every
# block's partials read and summed), 5 (frame stored); the first moments
# thread at 6 (data and rotations in), 7 (moments done).
TRACE_DEFS = r"""__device__ unsigned long long* g_trace;
#define TRACE(it, k)                                                      \
  do {                                                                    \
    if (g_trace != nullptr &&                                             \
        (threadIdx.x == kFirstSumWarp * 32 ||                             \
         threadIdx.x == kFirstMomentWarp * 32 ||                          \
         threadIdx.x == kSolverWarp * 32)) {                              \
      unsigned long long t_;                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      g_trace[(static_cast<size_t>(blockIdx.x) * ng + (it)) * 8 +         \
              (k)] = t_;                                                  \
    }                                                                     \
  } while (0)

"""
SET_TRACE = r"""
extern "C" int mdtpu_fused_set_trace(void* trace) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace)));
}
"""
# (line of the source, text inserted before it, text inserted after it)
TRACE_POINTS = (
    ("struct Args {\n", TRACE_DEFS, ""),
    ("      while (lane < kSumWarps && sprog[lane] <= g) poll_pause(t0);\n"
     "      __syncwarp();\n", "", "      if (lane == 0) TRACE(g, 3);\n"),
    ("      for (int k = 0; k < 12; ++k) sm[k] = __shfl_sync(kFull, tot, "
     "2 * k);\n", "", "      if (lane == 0) TRACE(g, 4);\n"),
    ("        st_relaxed(o + 13, __ldg(a.fmask + f));\n", "",
     "        TRACE(g, 5);\n"),
    ("      const int st = g % NST;\n"
     "      mbar_wait(&full[st], (g / NST) & 1);\n", "      TRACE(g, 0);\n",
     "      TRACE(g, 1);\n"),
    ("      if (lane == 0) sprog[sw] = g + 1;\n", "", "      TRACE(g, 2);\n"),
    ("    mbar_wait(&rfull[b], (m / kRotBuffers) & 1);\n", "",
     "    TRACE(m, 6);\n"),
    ("    warp_arrive(&rempty[b], lane);\n", "", "    TRACE(m, 7);\n"),
)


def traced_source(src: str) -> str:
    """The kernel source with the stamps of ``TRACE_POINTS`` inserted and
    the ``mdtpu_fused_set_trace`` entry point appended."""
    for line, before, after in TRACE_POINTS:
        if src.count(line) != 1:
            raise RuntimeError(
                f"the source holds {src.count(line)} copies of the line "
                f"{line.strip()!r}, not 1: update TRACE_POINTS")
        src = src.replace(line, before + line + after)
    return src + SET_TRACE


def build(src, out_dir):
    from mdanalysis_mpi_tpu_torch import _build

    os.makedirs(out_dir, exist_ok=True)
    with open(src) as f:
        patched = traced_source(f.read())
    cu = os.path.join(out_dir, "fused_rmsf_traced.cu")
    with open(cu, "w") as f:
        f.write(patched)
    lib = os.path.join(out_dir, "libfused_trace.so")
    p = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        lib, cu], capture_output=True, text=True)
    for line in (p.stdout + p.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    # the package's own build declares the C signatures; the traced
    # build takes them over
    own = _build.load()
    traced = ctypes.CDLL(lib)
    for fn in ("mdtpu_fused_planar", "mdtpu_cuda_error_string"):
        getattr(traced, fn).restype = getattr(own, fn).restype
        getattr(traced, fn).argtypes = getattr(own, fn).argtypes
    traced.mdtpu_fused_set_trace.restype = ctypes.c_int
    traced.mdtpu_fused_set_trace.argtypes = [ctypes.c_void_p]
    return traced


def summarize(T, ng, group, stages, blocks, B):
    """Phase means in µs from stamps ``T`` (blocks, groups, 8) ns."""
    T = T.astype(np.float64)
    T[T == 0] = np.nan
    T -= np.nanmin(T)
    T /= 1e3
    out = {"span": float(np.nanmax(T)),
           "data": float(np.nanmean(T[:, :, 1] - T[:, :, 0])),
           "sums": float(np.nanmean(T[:, :, 2] - T[:, :, 1])),
           "period": float(np.nanmean(np.diff(T[:, :, 0], axis=1))),
           "ready": float(np.nanmean(T[:, 1:, 6] - T[:, :-1, 7])),
           "moments": float(np.nanmean(T[:, :, 7] - T[:, :, 6])),
           "mperiod": float(np.nanmean(np.diff(T[:, :, 7], axis=1)))}
    last = np.nanmax(T[:, :, 2], axis=0)
    own = [(f % blocks, f // group) for f in range(B)]
    # one stage's cycle, per group (mean over blocks, max over a group's
    # frames where the group waits for all of them)
    comb = np.full(ng, np.nan)
    pub = np.full(ng, np.nan)
    for g in range(ng):
        owners = [f % blocks for f in range(g * group,
                                              min(B, (g + 1) * group))]
        comb[g] = np.nanmean(T[owners, g, 4])
        pub[g] = np.nanmax(T[owners, g, 5])
    data_in = np.nanmean(T[:, :, 1], axis=0)
    sums_end = np.nanmean(T[:, :, 2], axis=0)
    mom_in = np.nanmean(T[:, :, 6], axis=0)
    mom_out = np.nanmean(T[:, :, 7], axis=0)
    refill = np.full(ng, np.nan)
    refill[:ng - stages] = data_in[stages:] - mom_out[:ng - stages]
    steps = (("c_sums", data_in, sums_end), ("c_skew", sums_end, last),
             ("c_combine", last, comb),
             ("c_qcp", comb, pub), ("c_rot", pub, mom_in),
             ("c_moments", mom_in, mom_out))
    full = slice(1, ng - stages)
    for key, a0, a1 in steps:
        out[key] = float(np.nanmean((a1 - a0)[full]))
    out["c_refill"] = float(np.nanmean(refill[full]))
    out["cycle"] = sum(out[k] for k, _, _ in steps) + out["c_refill"]
    for key, (k0, k1) in (("publish", (None, 5)), ("arrive", (None, 3)),
                          ("combine", (3, 4)), ("qcp", (4, 5))):
        out[key] = float(np.nanmean([
            T[b, g, k1] - (last[g] if k0 is None else T[b, g, k0])
            for b, g in own]))
    return out


def geometry_with(fp, group):
    """``fused_geometry`` with the frame group forced to ``group``."""
    base = fp.fused_geometry

    def geometry(B, S, itemsize, n_sm):
        slice_atoms, blocks, _, _ = base(B, S, itemsize, n_sm)
        g = min(group, B, 24)
        room = fp.SMEM_MAX - fp.fused_smem_bytes(slice_atoms, g, 0,
                                                 itemsize)
        return slice_atoms, blocks, g, min(
            fp.MAX_STAGES, room // (3 * g * slice_atoms * itemsize))

    return geometry


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "fused_rmsf_trace"))
    ap.add_argument("--source", default=os.path.join(
        HERE, "mdanalysis_mpi_tpu_torch", "csrc", "fused_rmsf.cu"))
    ap.add_argument("--groups", default="",
                    help="comma-separated frame-group sizes to force")
    ap.add_argument("--cases", default=",".join(n for n, _ in CASES))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mdanalysis_mpi_tpu_torch import _build
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    from chip_smoke import queued_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(f"card: {card}; source {os.path.relpath(args.source, HERE)}")
    traced = build(args.source, args.out)
    _build.load = lambda: traced          # the wrapper launches this build
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": card, "source": os.path.relpath(args.source, HERE),
              "cases": {}}
    own = fp.fused_geometry
    groups = [int(g) for g in args.groups.split(",") if g] or [None]
    wanted = args.cases.split(",")
    for name, dtype in CASES:
        if name not in wanted:
            continue
        case = cs.make_case(512, 50000, dtype, 512, seed=512 + 50000)
        B, S = case[0].shape[1:]
        for forced in groups:
            fp.fused_geometry = own if forced is None else geometry_with(
                fp, forced)
            slice_atoms, blocks, group, stages = fp.fused_geometry(
                B, S, case[0].element_size(), sms)
            ng = -(-B // group)
            for _ in range(3):
                fp.planar_sums(*case)
            ms = queued_ms(lambda: fp.planar_sums(*case), 20)[0]
            buf = torch.zeros(blocks * ng * 8, dtype=torch.int64,
                              device="cuda")
            torch.cuda.synchronize()
            traced.mdtpu_fused_set_trace(buf.data_ptr())
            out = fp.planar_sums(*case)
            torch.cuda.synchronize()
            traced.mdtpu_fused_set_trace(None)
            plain = fp.planar_sums_plain(*case)
            T = case[6].sum()
            mean_err = ((out[:3] - plain[:3]) / T).abs().max().item()
            m2_err = ((out[3:] - out[:3] ** 2 / T)
                      - (plain[3:] - plain[:3] ** 2 / T)).abs().max().item()
            if not (mean_err <= 5e-4 and m2_err <= 5e-3):
                print(f"FAIL: {name} group {group}: mean {mean_err:.3g}, "
                      f"M2 {m2_err:.3g}", file=sys.stderr)
                return 1
            stamps = buf.cpu().numpy().reshape(blocks, ng, 8)
            np.save(os.path.join(args.out, f"{name}-g{group}.npy"), stamps)
            row = summarize(stamps, ng, group, stages, blocks, B)
            row.update(ms=ms, blocks=blocks, slice=slice_atoms, group=group,
                       stages=stages, groups=ng)
            result["cases"][f"{name}-g{group}"] = row
            print(f"{name}: {blocks} blocks x {slice_atoms} atoms, group "
                  f"{group}, {stages} stages, {ng} groups; {ms:.4f} ms "
                  f"untraced; traced span {row['span']:.1f} us; per group: "
                  + ", ".join(f"{k} {row[k]:.2f}" for k in (
                      "period", "data", "sums", "mperiod", "ready",
                      "moments", "publish", "arrive", "combine", "qcp")))
            print(f"  cycle {row['cycle']:.2f} us = " + " + ".join(
                f"{k[2:]} {row[k]:.2f}" for k in (
                    "c_sums", "c_skew", "c_combine", "c_qcp",
                    "c_rot", "c_moments", "c_refill"))
                  + f"; per group {row['cycle'] / stages:.2f}")
            del out, plain, buf
        del case
    fp.fused_geometry = own
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
