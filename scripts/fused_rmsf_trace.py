#!/usr/bin/env python3
"""Per-block timeline of the fused aligned-moments kernel
(``mdanalysis_mpi_tpu_torch/csrc/fused_rmsf.cu``) on one NVIDIA GPU:
where a launch spends its time.

Run from the root of a checkout::

    python3 scripts/fused_rmsf_trace.py [--out DIR] [--source FILE]
        [--groups G1,G2,...] [--cases NAME,...]

Writes a copy of the kernel source (``--source``, default the
package's own; another source must keep the package's C entry points)
with timestamps inserted into ``DIR`` (default
``build/fused_rmsf_trace``) and builds it there.  The stamps go in
after fixed lines of the source (``TRACE_POINTS``; the wide mode's
after the lines of one of ``WIDE_POINTS``' layouts, the first whose
every line the source holds once); a source without one of them stops
the script.  The main cases' stamps read the card's ``%globaltimer``
(ns, in 256 ns steps on the H100; a mean over many stamps is finer).
The wide mode's, several a unit, read the SM's ``clock64``, whose
cycles resolve a unit's waits of a few hundred ns; each block's first
compute thread reads both clocks where its wide work begins and ends,
and its stamps are mapped onto the global clock between those two
points (``clock``: the mean SM clock so found, GHz).  A stamp's slot
comes from constant memory, so a stamp costs its thread a clock read
and a store.

The main cases (``main-int16``, ``main-int8``, ``main-f32``) are
``chip_smoke.py`` phase 3's: B = 512, S = 50,176 in the single-read
form.  The block's first sums thread, first moments thread and frame
solver stamp eight points of each group, and the script prints, in µs,
the launch's span from the first stamp to the last, and the mean over
blocks and groups of:

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

The wide cases (``wide-int16``, ``wide-int8``, ``wide-float32``) are
phase 3's wide rows: B = 512, S = 1,048,576, made on the card.  The
wide mode streams each block's slice through its ring in units, a group
of frames of a chunk of atoms, twice: pass A (the per-frame sums) and
pass B (the moments).  The first compute thread stamps each unit's
turn, its data landed, its records in (pass B) and its work done; the
loader stamps its wait for the unit's stage to be free; the solver
stamps as above.  The script prints, per pass, the mean over blocks and
units of:

- ``period``: one unit; ``data``: the compute warps' wait for its bulk
  copies; ``records``: pass B's wait for its group's rotations after
  the data (every unit in the ``rows`` layout, a window's first chunk
  in ``boxes``); ``work``: its sums or moments; ``lead``: how long before
  the compute warps' turn the loader issued its copies;
- ``empty``: the loader's wait for the unit's stage to be read;
  ``issue``: the loader's time to issue the unit's copies (to its wait
  for the next unit's stage);
- ``rate``: every block streaming a full unit's staged bytes a period,
  TB/s (w and ref, which pass A's units bring from L2, left out);

and the launch's ``pass_a`` and ``pass_b`` spans (from the first
block's first stamp of the pass to the last block's last), the A→B turn
(``turn``: a block's last pass-A unit done to its first pass-B unit's
records in), the records wait of pass B's first chunk (``first_chunk``,
whose last groups wait for every block's pass A) and the publish of the
last group (``last_publish``: the last block's pass A done to the last
record stored).

The script traces the kernel of the tree it lies in (its package
builds and launches the copy): to trace another commit's, unpack that
commit (``git archive``) into an ignored directory, copy this script
into its ``scripts/`` and run it there.

Beside the timeline, ``ms`` is the launch's device time with the
stamps off (median of 20 launches queued behind a sleep, CUDA events
around each).  ``--groups`` runs every main case once per frame-group
size instead of the wrapper's own choice (the ring then takes as many
stages as fit); ``--cases`` picks cases by name.  Each traced launch is
checked against ``planar_sums_plain`` (mean within 5e-4, M2 within
5e-3; the wide cases over 64-frame chunks summed in float64).

Raw stamps go to ``DIR/<case>-g<G>.npy`` (blocks × groups × 8, ns; a
wide case's ``-wide.npy`` holds blocks × units × 8 SM clocks and its
``-cal.npy`` blocks × 2 × 2 clock pairs).  The last line is
one JSON object with every number.  Exits non-zero without a CUDA
device, when the build fails or a check fails.
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
         ("main-f32", "float32"), ("wide-int16", "int16"),
         ("wide-int8", "int8"), ("wide-float32", "float32"))
DEFAULT_CASES = "main-int16,main-int8,main-f32"


# Each block stamps %globaltimer into trace[(block * groups + g) * 8 + k]:
# the first sums thread at k = 0 (group g's turn), 1 (its data landed),
# 2 (its sums stored); the solver's lane 0, for a group it solves a
# frame of, at 3 (its own block's sums of the group done), 4 (every
# block's partials read and summed), 5 (frame stored); the first moments
# thread at 6 (data and rotations in), 7 (moments done).  In the wide
# mode, wtrace[(block * wunits + u) * 8 + k] for unit u of either pass:
# the first compute thread at k = 0 (its turn), 1 (data landed), 2
# (records in, pass B), 3 (work done); the loader at 4 (waits for the
# unit's stage) and 5 (issues the unit's copies); in the rows layout the
# rotations warp at 6 (starts loading the unit's records) and 7 (records
# in).  Those stamps are SM clocks; wcal[(block * 2 + i) * 2] holds the
# global clock and wcal[... + 1] the SM clock at the start (i = 0) and
# the end (i = 1) of the block's compute warps' wide work.  The buffers' addresses live in constant memory, and the stamping
# threads test their index first: a stamp costs the other threads one
# compare, and its own thread no load that waits on L2.
TRACE_DEFS = r"""__constant__ unsigned long long* g_trace;
__constant__ long long* g_wtrace;
__constant__ long long* g_wcal;
__constant__ int g_wunits;
#define STAMP_(buf, idx)                                                  \
  do {                                                                    \
    unsigned long long t_;                                                \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
    (buf)[idx] = t_;                                                      \
  } while (0)
#define TRACE(it, k)                                                      \
  do {                                                                    \
    if ((threadIdx.x == kFirstSumWarp * 32 ||                             \
         threadIdx.x == kFirstMomentWarp * 32 ||                          \
         threadIdx.x == kSolverWarp * 32) && g_trace != nullptr)          \
      STAMP_(g_trace, (static_cast<size_t>(blockIdx.x) * ng + (it)) * 8 + \
                          (k));                                           \
  } while (0)
#define TRACE_W(u, k)                                                     \
  do {                                                                    \
    if ((threadIdx.x == kFirstSumWarp * 32 ||                             \
         threadIdx.x == kLoaderWarp * 32 ||                               \
         threadIdx.x == kRotWarp * 32) && g_wtrace != nullptr)            \
      g_wtrace[(static_cast<size_t>(blockIdx.x) * g_wunits + (u)) * 8 +   \
               (k)] = clock64();                                          \
  } while (0)
#define TRACE_CAL(i)                                                      \
  do {                                                                    \
    if (threadIdx.x == kFirstSumWarp * 32 && g_wcal != nullptr) {         \
      unsigned long long t_;                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      g_wcal[(blockIdx.x * 2 + (i)) * 2] = static_cast<long long>(t_);    \
      g_wcal[(blockIdx.x * 2 + (i)) * 2 + 1] = clock64();                 \
    }                                                                     \
  } while (0)

"""
SET_TRACE = r"""
extern "C" int mdtpu_fused_set_trace(void* trace, void* wtrace,
                                     void* wcal, int wunits) {
  cudaError_t e = cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_wtrace, &wtrace, sizeof(wtrace));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_wcal, &wcal, sizeof(wcal));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_wunits, &wunits, sizeof(wunits));
  return static_cast<int>(e);
}
"""
# (text of the source, text inserted before it, text inserted after it),
# applied in order to the source as it stands after the ones before
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


def _cal(pass_a):
    """The clocks where the compute warps' wide work begins (before pass
    A's comment, ``pass_a``) and ends (wide_compute's closing brace)."""
    return ((pass_a, "  TRACE_CAL(0);\n", ""),
            ("}\n\n// The kernel; its warps' roles", "  TRACE_CAL(1);\n",
             ""))


# The wide mode's stamps, one layout per form of its source: "rows", a
# bulk copy a row of a unit (12 or 24 frames of a chunk of at most 768
# atoms, pass A then pass B in the same ring)
WIDE_POINTS = {
    "rows": (
        ("    mbar_wait(&empty[u % nst], ((u - nst) / nst) & 1);\n",
         "    TRACE_W(u, 4);\n", "    TRACE_W(u, 5);\n"),
        ("    load_records(a.rot + static_cast<size_t>(g) * G * kRot,\n"
         "                 frot + rb * G * kRot, min(G, a.B - g * G), "
         "lane);\n    warp_arrive(&rfull[rb], lane);\n",
         "    TRACE_W(ng * nck + v, 6);\n",
         "    TRACE_W(ng * nck + v, 7);\n"),
        ("    mbar_wait(&full[stage], (u / nst) & 1);\n    const int gf",
         "    TRACE_W(u, 0);\n", ""),
        ("    const int gf = min(G, a.B - g * G);\n    if (c == 0) {\n",
         "    TRACE_W(u, 1);\n", ""),
        ("    warp_arrive(&empty[stage], lane);\n    if (c == nck - 1) {\n",
         "    TRACE_W(u, 3);\n", ""),
        ("    mbar_wait(&full[stage], (u / nst) & 1);\n    mbar_wait(&rfull",
         "    TRACE_W(u, 0);\n", ""),
        ("    mbar_wait(&rfull[rb], (v / kRotBuffers) & 1);\n",
         "    TRACE_W(u, 1);\n", "    TRACE_W(u, 2);\n"),
        ("    warp_arrive(&empty[stage], lane);\n"
         "    warp_arrive(&rempty[rb], lane);\n",
         "    TRACE_W(u, 3);\n", ""),
    ) + _cal("  // ---- pass A: frames fa and fb of each group, their sums "),
}
# "boxes": pass A's units of 12 frames and pass B's of fewer frames of
# longer chunks, tensor-map boxes; pass B's records in a table the
# rotations warp fills as they are solved, which the first chunk of a
# window waits for (stamped at 2)
WIDE_POINTS["boxes"] = (
    ("      const int st = wide_acquire(empty, u, nst);\n"
     "      unsigned char* base", "      TRACE_W(u, 4);\n", ""),
    ("      unsigned char* base = ring + static_cast<size_t>(st) * "
     "a.stage_bytes;\n      const int c0",
     "      TRACE_W(u, 5);\n", ""),
    ("        const int st = wide_acquire(empty, u, nst);\n",
     "        TRACE_W(u, 4);\n",
     "        TRACE_W(u, 5);\n"),
    ("      mbar_wait(&full[st], (u / nst) & 1);\n"
     "      const unsigned char* base",
     "      TRACE_W(u, 0);\n", ""),
    ("      const unsigned char* base = ring + static_cast<size_t>(st) * "
     "a.stage_bytes;\n", "      TRACE_W(u, 1);\n", ""),
    ("      warp_arrive(&empty[st], lane);\n    }\n"
     "    const int k = (lane >> 1) & 15;\n",
     "      TRACE_W(u, 3);\n", ""),
    ("        mbar_wait(&full[st], (u / nst) & 1);\n        if (c == 0) {\n",
     "        TRACE_W(u, 0);\n", ""),
    ("        if (c == 0) {\n          const int need",
     "        TRACE_W(u, 1);\n", ""),
    ("            __threadfence_block();\n          }\n"
     "          __syncwarp();\n", "", "          TRACE_W(u, 2);\n"),
    ("        warp_arrive(&empty[st], lane);\n      }\n      if (mine) {\n",
     "        TRACE_W(u, 3);\n", ""),
) + _cal("  // ---- pass A: frame w of each group ")


def _units_rows(B, owned, geometry):
    ng = -(-B // geometry[2])
    return ng * -(-owned // geometry[4]), ng * -(-owned // geometry[4]), ng


def _units_boxes(B, owned, geometry):
    group, _, chunk, group_b, chunk_b = geometry[2:]
    records = min(B, 512)           # the kernel's kWideRecords
    ncb = -(-owned // chunk_b)
    nb = sum(ncb * -(-min(records, B - f0) // group_b)
             for f0 in range(0, B, records))
    return (-(-B // group) * -(-owned // chunk), nb,
            -(-records // group_b))


# a block's (pass A units, pass B units, pass B units of its first
# chunk) by layout: (B, atoms of the block's slice, geometry)
WIDE_UNITS = {"rows": _units_rows, "boxes": _units_boxes}
# the staged bytes of a full unit of (pass A, pass B) by layout:
# (geometry, itemsize)
WIDE_BYTES = {
    "rows": lambda g, i: (3 * g[2] * g[4] * i,) * 2,
    "boxes": lambda g, i: (3 * g[2] * g[4] * i, 3 * g[5] * g[6] * i),
}


def wide_stride(layout, B, geometry):
    """Units a block's stamps take in the buffer (``TRACE_W``'s stride,
    with every window of records full)."""
    if layout == "rows":
        return sum(_units_rows(B, geometry[0], geometry)[:2])
    group, _, chunk, group_b, chunk_b = geometry[2:]
    records = min(B, 512)           # the kernel's kWideRecords
    return (-(-B // group) * -(-geometry[0] // chunk) + -(-B // records)
            * -(-geometry[0] // chunk_b) * -(-records // group_b))


def _insert(src, points):
    for line, before, after in points:
        if src.count(line) != 1:
            raise RuntimeError(
                f"the source holds {src.count(line)} copies of the line "
                f"{line.strip()!r}, not 1: update the trace points")
        src = src.replace(line, before + line + after)
    return src


def wide_layout(src: str) -> str:
    """The first of ``WIDE_POINTS``' layouts whose every line the source
    holds once."""
    for name, points in WIDE_POINTS.items():
        try:
            _insert(src, points)
        except RuntimeError:
            continue
        return name
    raise RuntimeError("the source matches none of WIDE_POINTS' layouts: "
                       "update the trace points")


def traced_source(src: str) -> str:
    """The kernel source with the stamps of ``TRACE_POINTS`` and of its
    wide layout inserted and the ``mdtpu_fused_set_trace`` entry point
    appended."""
    src = _insert(src, WIDE_POINTS[wide_layout(src)])
    return _insert(src, TRACE_POINTS) + SET_TRACE


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
    traced.mdtpu_fused_set_trace.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int]
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


def _us(stamps):
    """ns stamps → µs from the first, unset (0) stamps NaN."""
    t = stamps.astype(np.float64)
    t[t == 0] = np.nan
    return t


def summarize_wide(W, cal, T, layout, B, S, geometry, itemsize):
    """Pass means and spans in µs from the wide stamps ``W`` (blocks,
    units, 8; SM clocks), each block's clock pairs ``cal`` (blocks, 2,
    2: global ns and SM clock at the start and the end of its wide work)
    and the solver's ``T`` (blocks, groups, 8; ns)."""
    slice_atoms, blocks, _, stages = geometry[:4]
    units_of = WIDE_UNITS[layout]
    W, T, cal = _us(W), _us(T), cal.astype(np.float64)
    rate = (cal[:, 1, 1] - cal[:, 0, 1]) / (cal[:, 1, 0] - cal[:, 0, 0])
    W = cal[:, None, None, 0, 0] + (W - cal[:, None, None, 0, 1]) \
        / rate[:, None, None]
    t0 = np.nanmin([np.nanmin(W), np.nanmin(T)])
    W, T = (W - t0) / 1e3, (T - t0) / 1e3
    acc = {k: [] for k in ("a_period", "a_data", "a_work", "b_period",
                           "b_data", "b_records", "b_work", "a_lead",
                           "b_lead", "a_empty", "b_empty", "a_issue",
                           "b_issue", "turn", "first_chunk", "b_poll")}
    a_ends, b_ends = [], []
    for b in range(blocks):
        owned = min(slice_atoms, S - b * slice_atoms)
        na, nb, first = units_of(B, owned, geometry)
        A, P = W[b, :na], W[b, na:na + nb]
        acc["a_period"].append(np.diff(A[:, 0]))
        acc["a_data"].append(A[:, 1] - A[:, 0])
        acc["a_work"].append(A[:, 3] - A[:, 1])
        acc["b_period"].append(np.diff(P[:, 0]))
        acc["b_data"].append(P[:, 1] - P[:, 0])
        acc["b_records"].append(P[:, 2] - P[:, 1])
        # the boxes layout stamps the records (2) in the first chunk alone
        acc["b_work"].append(P[:, 3] - np.where(np.isfinite(P[:, 2]),
                                                P[:, 2], P[:, 1]))
        acc["first_chunk"].append(P[:first, 2] - P[:first, 1])
        acc["b_poll"].append(P[:, 7] - P[:, 6])
        lead = W[b, stages:na + nb, 0] - W[b, stages:na + nb, 5]
        empty = W[b, stages:na + nb, 5] - W[b, stages:na + nb, 4]
        acc["a_lead"].append(lead[:na - stages])
        acc["b_lead"].append(lead[na - stages:])
        acc["a_empty"].append(empty[:na - stages])
        acc["b_empty"].append(empty[na - stages:])
        # the loader's issue of a unit: from its copies' start to its
        # wait for the next unit's stage
        issue = W[b, 1:na + nb, 4] - W[b, :na + nb - 1, 5]
        acc["a_issue"].append(issue[:na - 1])
        acc["b_issue"].append(issue[na:])
        acc["turn"].append(np.array([P[0, 2] - A[-1, 3]]))
        a_ends.append((A[0, 0], A[-1, 3]))
        b_ends.append((P[0, 0], P[-1, 3]))
    out = {k: float(np.nanmean(v)) if np.isfinite(v).any() else None
           for k, v in ((k, np.concatenate(v)) for k, v in acc.items())}
    a_ends, b_ends = np.array(a_ends), np.array(b_ends)
    out.update(
        span=float(np.nanmax(W)),
        pass_a=float(np.nanmax(a_ends[:, 1]) - np.nanmin(a_ends[:, 0])),
        pass_b=float(np.nanmax(b_ends[:, 1]) - np.nanmin(b_ends[:, 0])),
        last_publish=float(np.nanmax(T[:, :, 5]) - np.nanmax(a_ends[:, 1])),
        clock=float(np.mean(rate)))
    # every block streaming a full unit a period, in TB/s
    for p, nbytes in zip("ab", WIDE_BYTES[layout](geometry, itemsize)):
        out[f"{p}_rate"] = blocks * nbytes / out[f"{p}_period"] * 1e-6
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


def _f(v, digits=2):
    return "n/a" if v is None else f"{v:.{digits}f}"


def check_case(name, out, plain, T):
    """The traced launch against the plain version (mean within 5e-4, M2
    within 5e-3) → whether it held."""
    mean_err = ((out[:3] - plain[:3]) / T).abs().max().item()
    m2_err = ((out[3:] - out[:3] ** 2 / T)
              - (plain[3:] - plain[:3] ** 2 / T)).abs().max().item()
    if mean_err <= 5e-4 and m2_err <= 5e-3:
        return True
    print(f"FAIL: {name}: mean {mean_err:.3g}, M2 {m2_err:.3g}",
          file=sys.stderr)
    return False


def traced_launch(traced, case, buf, wbuf, cal, units):
    """One launch of the traced build with its stamps on (the main
    buffer; the wide buffer, its clock pairs and its units a block, or
    None and 0) → its output."""
    import torch

    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    torch.cuda.synchronize()
    traced.mdtpu_fused_set_trace(*(None if b is None else b.data_ptr()
                                   for b in (buf, wbuf, cal)), units)
    out = fp.planar_sums(*case)
    torch.cuda.synchronize()
    traced.mdtpu_fused_set_trace(None, None, None, 0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "fused_rmsf_trace"))
    ap.add_argument("--source", default=os.path.join(
        HERE, "mdanalysis_mpi_tpu_torch", "csrc", "fused_rmsf.cu"))
    ap.add_argument("--groups", default="",
                    help="comma-separated frame-group sizes to force "
                         "(main cases)")
    ap.add_argument("--cases", default=DEFAULT_CASES,
                    help="comma-separated cases: "
                         + ", ".join(n for n, _ in CASES))
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
    with open(args.source) as f:
        layout = wide_layout(f.read())
    print(f"card: {card}; source {os.path.relpath(args.source, HERE)} "
          f"(wide layout {layout})")
    traced = build(args.source, args.out)
    _build.load = lambda: traced          # the wrapper launches this build
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": card, "source": os.path.relpath(args.source, HERE),
              "wide_layout": layout, "cases": {}}
    own = fp.fused_geometry
    groups = [int(g) for g in args.groups.split(",") if g] or [None]
    wanted = args.cases.split(",")
    for name, dtype in CASES:
        if name not in wanted:
            continue
        wide = name.startswith("wide-")
        if wide:
            itemsize = torch.empty((), dtype=getattr(torch, dtype)
                                   ).element_size()
            case = cs.make_wide_case(cs.WIDE_B, cs.WIDE_S, dtype,
                                     seed=cs.WIDE_S + itemsize)
        else:
            case = cs.make_case(512, 50000, dtype, 512, seed=512 + 50000)
        B, S = case[0].shape[1:]
        for forced in [None] if wide else groups:
            fp.fused_geometry = own if forced is None else geometry_with(
                fp, forced)
            geometry = fp.fused_geometry(B, S, case[0].element_size(), sms)
            slice_atoms, blocks, group, stages = geometry[:4]
            ng = -(-B // group)
            for _ in range(3):
                fp.planar_sums(*case)
            ms = queued_ms(lambda: fp.planar_sums(*case), 20)[0]
            buf = torch.zeros(blocks * ng * 8, dtype=torch.int64,
                              device="cuda")
            wbuf = cal = None
            units = 0
            if wide:
                units = wide_stride(layout, B, geometry)
                wbuf = torch.zeros(blocks * units * 8, dtype=torch.int64,
                                   device="cuda")
                cal = torch.zeros(blocks * 4, dtype=torch.int64,
                                  device="cuda")
            out = traced_launch(traced, case, buf, wbuf, cal, units)
            plain = cs.plain_by_frames(case) if wide \
                else fp.planar_sums_plain(*case)
            key = f"{name}-g{group}"
            if not check_case(key, out, plain, case[6].sum()):
                return 1
            stamps = buf.cpu().numpy().reshape(blocks, ng, 8)
            np.save(os.path.join(args.out, f"{key}.npy"), stamps)
            if wide:
                wst = wbuf.cpu().numpy().reshape(blocks, units, 8)
                np.save(os.path.join(args.out, f"{key}-wide.npy"), wst)
                wcal = cal.cpu().numpy().reshape(blocks, 2, 2)
                np.save(os.path.join(args.out, f"{key}-cal.npy"), wcal)
                row = summarize_wide(wst, wcal, stamps, layout, B, S,
                                     geometry, case[0].element_size())
                row.update(ms=ms, geometry=list(geometry), units=units)
                result["cases"][key] = row
                print(f"{name}: geometry {geometry}, {units} units a "
                      f"block; {ms:.4f} ms untraced; traced span "
                      + ", ".join(f"{k} {_f(row[k])}" for k in (
                          "span", "pass_a", "pass_b", "turn",
                          "last_publish"))
                      + f" us, SM clock {_f(row['clock'])} GHz")
                for p, keys in (("a", ("period", "data", "work", "lead",
                                       "empty", "issue", "rate")),
                                ("b", ("period", "data", "records", "work",
                                       "lead", "empty", "issue", "rate"))):
                    print(f"  pass {p.upper()} per unit: " + ", ".join(
                        f"{k} {_f(row[f'{p}_{k}'])}" for k in keys)
                        + (f"; the first chunk's records wait "
                           f"{_f(row['first_chunk'])}, records load "
                           f"{_f(row['b_poll'])}" if p == "b" else ""))
                del out, plain, buf, wbuf, cal
                continue
            row = summarize(stamps, ng, group, stages, blocks, B)
            row.update(ms=ms, blocks=blocks, slice=slice_atoms, group=group,
                       stages=stages, groups=ng)
            result["cases"][key] = row
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
        torch.cuda.empty_cache()
    fp.fused_geometry = own
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
