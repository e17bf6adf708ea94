#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mdanalysis_mpi_tpu_torch``) on
one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and
prints no ok line):

1. Device: a CUDA card must be present; prints its name and power limit
   (``nvidia-smi``) and checks that TF32 is off.
2. Build: compiles ``mdanalysis_mpi_tpu_torch/csrc/*.cu`` with nvcc
   into ``build/`` and prints the build seconds and the ptxas report.
3. Kernel against its plain version on the card: the fused
   aligned-moments kernel (``ops/fused_planar.planar_sums``) and
   ``planar_sums_plain`` on the same inputs, at the main path's shape
   (B = 512 frames, S = 50,176 padded atoms) and at small shapes with a
   masked frame tail, padded atoms, int16/int8/float32 planes and a
   per-frame scale.  Holds the moments (mean = Σdev/T within 5e-4, M2
   within 5e-3 — the JAX package's tolerances, tests/test_pallas_fused.py)
   and requires two launches to agree bit for bit; prints the kernel's
   device time per call (``kernel_ms``: the median of its own kernel
   events under ``torch.profiler`` over 20 calls, beside every kernel
   the call launches; a profile must record one event per call of each,
   else it is taken again, up to 5 times), the call's device time with
   the scratch fill
   (``queued_ms``: calls queued behind a sleep, CUDA events around each),
   the wrapper's host wall per call (``call_ms``), the plain version's
   time, the bound, the launches and the largest raw difference of the
   (6, S) sums.
4. End to end at full width: 100,000 atoms (built like bench.py's
   make_system from seed 0), the ``heavy`` selection (50,000 atoms),
   2,048 frames in a MemoryReader, ``batch_size=512``, int16 staging,
   ``AlignedRMSF(engine='fused')`` on ``backend='torch'``.  The kernel's
   launch counter must rise in both passes; a repeat of the run on a
   side CUDA stream must give the same RMSF bit for bit (the staging
   copies follow the caller's stream); the RMSF must agree with
   ``engine=None`` on the card within 5e-4, and over the first 32 frames
   with the serial float64 oracle within 1e-3.  The int8 and delta legs
   are held to 5e-2 against the serial oracle run on the coordinates
   those wire formats deliver (at this system's 100 Å coordinate range
   int8 resolves 0.8 Å, so their error against the raw frames is the
   wire format's, not the kernel's; it is printed, not gated), and to
   the fused-vs-generic tolerances of the JAX package (5e-4 int8, 5e-3
   delta) over all 2,048 frames.
5. InterRDF end to end at full width: BASELINE config 4's O-O g(r) of a
   TIP3P water box, 32,768 waters (98,304 atoms) in a cubic 99.3 Å box
   at water density, 64 frames, ``InterRDF(ow, ow).run(backend='torch',
   device='cuda', batch_size=16)`` with the defaults ``nbins=75,
   range=(0, 15)`` and float32 staging.  The pair-histogram kernel's
   launch counter must rise by 4 (one launch per block); the partials
   stay on the card; a repeat is bit-identical; ``engine='xla'`` (the
   generic torch-op engine) over all 64 frames gives g(r) and every
   bin's count within 1e-5 relative; and on the JAX suite's config-4
   shape (2,000 waters in a 39.1 Å box, 8 frames, ``nbins=75,
   range=(0, 10)``) the kernel route is within 0.05 of the serial
   float64 oracle's g(r) at every bin.  Prints the wall, frames/s,
   pairs/s and the kernel's share of the wall.

Phase 3 also holds the pair-histogram kernel (``ops/fused_distances.
pair_histogram``, ``csrc/pair_histogram.cu``) against
``pair_histogram_plain`` on the card: the main shape (the first block of
phase 5's run: 16 frames of 32,768 × 32,768 oxygens, 75 bins over
(0, 15) Å, ``exclude_self``), the same block binned over (0, 1) Å where
no pair falls (the distance arithmetic alone), the same block unwrapped
(every atom shifted by a whole multiple of L in [-1, 1] per axis, so
most pairs take the kernel's division branch), the same block with the
atoms within 2 Å of the lower y face moved to their image just above L
and those within 2 Å of the upper z face to their image just below 0
(no B atom then lies within reach of an A atom at |d| >= L, so every
pair keeps the division-free form; these three timed like the main
case), a ragged 300 × 515 case, a case without a box, 1 bin, 512 bins,
a batch with a masked frame and a batch with a triclinic frame (which
must come out NaN).  Every case's counts must EQUAL the plain
version's (``torch.equal``: 0 bins differing; the kernel's rewrites are
exact), two launches must be bit-identical, and no bin of a block may
reach 2^24 (where float32 counts stop being exact).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published rates of the card (NVIDIA data sheets): memory bytes/s and
# float32 (non-tensor-core) flop/s, keyed by a substring of the name.
CARD_RATES = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),          # H100 SXM5 (80GB HBM3)
    ("H200", 4.8e12, 67e12),
)
# Work of the fused function per atom-frame: dequant 3, COM 6,
# correlation 18, centre 3, rotate 15, deviation + masks 9, sums 9;
# per frame: the QCP solve (~40 Newton steps + adjugate, ~1000 flops).
FLOPS_PER_ATOM_FRAME = 63
FLOPS_PER_FRAME = 1000

# Phase 4: BASELINE config 2 at full width (100k atoms, 50k heavy,
# batch 512); its 10,000 frames cut to 2,048 to fit the time limit.
E2E_ATOMS = 100_000
E2E_FRAMES = 2048
E2E_BATCH = 512

KERNEL_NAME = "fused_aligned_moments"
KERNEL_SYMBOL = "fused_planar_kernel"      # its CUDA kernel's name
KERNEL_SOURCE = "mdanalysis_mpi_tpu_torch/csrc/fused_rmsf.cu"
KERNEL_REPLACES = "mdanalysis_mpi_tpu/ops/pallas_fused.py:289"

# Phase 5: BASELINE config 4 (InterRDF O-O, TIP3P water box) at 32,768
# waters, the 100k-atom size of config 2, in a box at water density
# (0.0334 waters/Å^3); 64 frames, batch 16.  The oracle check runs at
# the JAX suite's config-4 shape (benchmarks/suite.py:273: 2,000 waters,
# 8 frames, range (0, 10)) but in a box at water density, 39.1 Å.
RDF_WATERS = 32768
RDF_BOX = 99.3
RDF_FRAMES = 64
RDF_BATCH = 16
ORACLE_WATERS = 2000
ORACLE_BOX = 39.1
ORACLE_FRAMES = 8
# Work of the pair-histogram function as the TPU kernel computes it
# (pallas_distances.py), the yardstick kept whatever implements it.
# Every pair: per axis sub, div, rint, mul, sub, square (18), two adds,
# sqrt, the two range compares = 23.  Every pair inside the range, in
# addition: sub, mul, floor, two clamps and two edge compares = 7.  At
# the float32 FMA rate these give an optimistic bound: the CUDA kernel
# issues no FMA in its pair loop.
FLOPS_PER_PAIR = 23
FLOPS_PER_BINNED_PAIR = 7
PH_NAME = "pair_histogram"
PH_SOURCE = "mdanalysis_mpi_tpu_torch/csrc/pair_histogram.cu"
PH_REPLACES = "mdanalysis_mpi_tpu/ops/pallas_distances.py:164"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops
    print(f"note: no published rates for {name!r}; using the H100 SXM's")
    return CARD_RATES[2][1], CARD_RATES[2][2]


# ---------------------------------------------------------------- phase 1

def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    import mdanalysis_mpi_tpu_torch.device  # noqa: F401  (sets TF32 off)

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmul is on")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cuDNN is on")
    print("tf32: off (matmul, cudnn)")
    return card


# ---------------------------------------------------------------- phase 2

def phase_build():
    from mdanalysis_mpi_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS:.2f} s) -> {_build.library_path()}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line or line.startswith("=="):
            print(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------- phase 3

def _rotations(rng, n):
    a = rng.normal(size=(n, 3, 3))
    u, _, vt = np.linalg.svd(a)
    d = np.sign(np.linalg.det(u @ vt))
    u[:, :, -1] *= d[:, None]
    return u @ vt


def make_case(B, n_real, dtype, valid, seed, per_frame=False):
    """Staged planes + fused params on the card, like the main path's:
    a centred reference of coordinate scale 20 Å, each frame a rigid
    rotation + translation of it plus 0.3 Å noise, quantized."""
    import torch

    from mdanalysis_mpi_tpu_torch.io.base import planar_repack
    from mdanalysis_mpi_tpu_torch.ops import fused_rmsf as fr
    from mdanalysis_mpi_tpu_torch.staging import quantize_block

    rng = np.random.default_rng(seed)
    idx_p, nr = fr.pad_selection(np.arange(n_real))
    S = len(idx_p)
    ref = rng.normal(scale=20.0, size=(n_real, 3)).astype(np.float32)
    masses = rng.uniform(1, 16, size=n_real)
    com = (ref * (masses / masses.sum())[:, None]).sum(0)
    refc = ref - com
    rots = _rotations(rng, B).astype(np.float32)
    coords = np.einsum("ni,bji->bnj", ref, rots)
    coords += rng.normal(scale=10.0, size=(B, 1, 3)).astype(np.float32)
    coords += rng.normal(scale=0.3, size=coords.shape).astype(np.float32)
    coords = coords[:, idx_p].astype(np.float32)
    if dtype == "float32":
        qp, inv = np.ascontiguousarray(np.moveaxis(coords, 2, 0)), 1.0
    else:
        q, inv = quantize_block(coords, dtype)
        qp, inv = planar_repack(q), float(inv)
    dev = torch.device("cuda")
    params = fr.build_params(refc, com, masses, nr, S)
    wN, refc_p, _, amask, sref = (p.to(dev) for p in params)
    fmask = np.zeros(B, np.float32)
    fmask[:valid] = 1.0
    inv_arg = (torch.full((B,), inv, dtype=torch.float32, device=dev)
               if per_frame else inv)
    return (torch.from_numpy(qp).to(dev), inv_arg, wN, refc_p, amask, sref,
            torch.from_numpy(fmask).to(dev))


def time_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


SLEEP_CYCLES = 60_000_000   # ~30 ms at ~2 GHz: longer than any enqueue
PROFILE_REPS = 20
PROFILE_TRIES = 5


def short_name(kernel):
    """``void (anonymous namespace)::fused_planar_kernel<short>(...)`` →
    ``fused_planar_kernel``."""
    import re

    m = re.search(r"(\w+)\s*[<(]",
                  kernel.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else kernel


def profiler_ms(fn, reps):
    """Device time of each CUDA kernel ``fn`` launches in ``reps``
    calls, from ``torch.profiler`` kernel events (memsets and fills
    included) → {short name: (median ms per event, events recorded)}.

    The profile opens with one marker kernel (``torch.cuda._sleep``,
    ``spin_kernel``), left out of the result: on the H100 the profiler
    missed the first kernel of a profile in some profiles (19 of 20
    events of the first kernel of the call, every other kernel 20)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = collections.defaultdict(list)
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            times[short_name(e.name)].append(e.time_range.elapsed_us() / 1e3)
    return {n: (statistics.median(t), len(t)) for n, t in times.items()
            if "spin" not in n and "sleep" not in n}


def kernel_split(fn, reps=PROFILE_REPS):
    """:func:`profiler_ms` with every kernel's event count held to
    ``reps``: the profiler can miss an event, and a profile that did is
    taken again, up to ``PROFILE_TRIES`` times, before the check fails."""
    for _ in range(PROFILE_TRIES):
        split = profiler_ms(fn, reps)
        if split and all(n == reps for _, n in split.values()):
            return split
        counts = {k: n for k, (_, n) in split.items()}
        print(f"note: the profile recorded {counts} kernel events of "
              f"{reps} calls; profiling again")
    raise SmokeFailure(f"the profiler recorded {counts} kernel events of "
                       f"{reps} calls in each of {PROFILE_TRIES} profiles")


def fused_timing(args):
    """Device and host time of one ``planar_sums`` call on ``args`` →
    (kernel split as :func:`kernel_split`, queued device ms of the call,
    largest gap between queued calls, host wall ms per call)."""
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    def call():
        return fp.planar_sums(*args)

    call()
    split = kernel_split(call)
    q_ms, _, _, gap = queued_ms(call, PROFILE_REPS)
    return split, q_ms, gap, call_ms(call, PROFILE_REPS)


def split_text(split):
    return ", ".join(f"{n} {ms:.4f} ({k})" for n, (ms, k) in
                     sorted(split.items(), key=lambda kv: -kv[1][0]))


def queued_ms(fn, reps):
    """Per-call device ms of ``fn`` run back to back behind a sleep, CUDA
    events around each call alone → (median, least, greatest, largest
    gap between one call's end and the next one's start)."""
    import torch

    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in ev]
    gaps = [ev[i][1].elapsed_time(ev[i + 1][0]) for i in range(reps - 1)]
    return (statistics.median(times), min(times), max(times),
            max(gaps, default=0.0))


def call_ms(fn, reps):
    """Host wall ms per call of ``fn`` (no synchronise inside)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def bound_ms(args, bw, flops):
    qp, inv, wN, refc_p, amask, sref, fmask = args
    _, B, S = qp.shape
    nbytes = (qp.numel() * qp.element_size()
              + sum(t.numel() * 4 for t in (wN, refc_p, amask, sref, fmask))
              + (B * 4 if hasattr(inv, "numel") else 0)
              + 6 * S * 4)
    ops = FLOPS_PER_ATOM_FRAME * B * S + FLOPS_PER_FRAME * B
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(card_name):
    import torch

    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    bw, flops = card_rates(card_name)
    cases = [
        ("main-int16", 512, 50000, "int16", 512, False),
        ("main-int8", 512, 50000, "int8", 512, False),
        ("main-f32", 512, 50000, "float32", 512, False),
        ("tail-int16", 56, 3000, "int16", 50, False),
        ("tail-int8", 56, 3000, "int8", 50, False),
        ("pad-f32", 56, 200, "float32", 56, False),
        ("perframe-int16", 16, 100, "int16", 16, True),
        ("pad-int16-B1", 1, 300, "int16", 1, False),
    ]
    rows = {}
    worst = 0.0
    for name, B, n_real, dtype, valid, per_frame in cases:
        args = make_case(B, n_real, dtype, valid, seed=B + n_real,
                         per_frame=per_frame)
        qp = args[0]
        l0 = fp.planar_sums.launches
        out1 = fp.planar_sums(*args)
        out2 = fp.planar_sums(*args)
        torch.cuda.synchronize()
        plain = fp.planar_sums_plain(*args)
        torch.cuda.synchronize()
        check(torch.isfinite(out1).all().item(), f"{name}: non-finite output")
        check(torch.equal(out1, out2),
              f"{name}: two launches differ (not deterministic)")
        T = args[6].sum()
        raw = (out1 - plain).abs().max().item()
        mean_err = ((out1[:3] - plain[:3]) / T).abs().max().item()
        m2 = out1[3:] - out1[:3] ** 2 / T
        m2_plain = plain[3:] - plain[:3] ** 2 / T
        m2_err = (m2 - m2_plain).abs().max().item()
        check(mean_err <= 5e-4, f"{name}: mean differs by {mean_err:.3g}")
        check(m2_err <= 5e-3, f"{name}: M2 differs by {m2_err:.3g}")
        launches = fp.planar_sums.launches - l0
        split, q_ms, gap, c_ms = fused_timing(args)
        check(KERNEL_SYMBOL in split, f"{name}: no {KERNEL_SYMBOL} kernel "
              f"event in the profile ({sorted(split)})")
        k_ms = split[KERNEL_SYMBOL][0]
        p_ms = time_ms(lambda: fp.planar_sums_plain(*args), 5)
        b_ms, b_by = bound_ms(args, bw, flops)
        worst = max(worst, raw)
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=raw)
        print(f"kernel {name}: B={B} S={qp.shape[2]} {dtype} valid={valid} "
              f"kernel_ms={k_ms:.4f} queued_ms={q_ms:.4f} "
              f"(gap {gap:.4f}) call_ms={c_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) launches={launches} "
              f"raw_max_abs={raw:.3g} mean_err={mean_err:.3g} "
              f"m2_err={m2_err:.3g} bit_identical=True; device ms "
              f"(events): {split_text(split)}")
        del args, out1, out2, plain
    return rows, worst


def event_ms(fn):
    """One call of ``fn`` timed by CUDA events → (its result, ms)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def make_water(n_waters, box, n_frames):
    """The config-4 system from seed 0 and its oxygens."""
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=n_waters, box=box, n_frames=n_frames,
                            seed=0)
    return u, u.select_atoms("name OW")


def ph_bound_ms(a, b, nbins, counts, bw, flops):
    """Bound of one pair-histogram call: the coordinates, box lengths
    and edges read once and the uint64 counts written once, against the
    operations of every pair plus those of the pairs this run's data put
    inside the range (``counts.sum()``)."""
    B, N, _ = a.shape
    M = b.shape[1]
    nbytes = (B * N + B * M) * 3 * 4 + B * 3 * 4 + (nbins + 1) * 4 \
        + B * nbins * 8
    binned = float(np.nansum(counts))
    ops = FLOPS_PER_PAIR * B * N * M + FLOPS_PER_BINNED_PAIR * binned
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_equal(name, got, want):
    """The kernel's counts must equal the plain version's → the number
    of bins that differ (0)."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{name}: non-finite counts")
    n_diff = int((got != want).sum())
    check(torch.equal(got, want),
          f"{name}: {n_diff} bins differ from the plain version (totals "
          f"{float(got.sum()):.0f} vs {float(want.sum()):.0f})")
    return n_diff


def phase_pair_histogram(card_name, ow):
    """Phase 3, pair-histogram kernel: each case against its plain
    version on the card → (rows by case, largest |kernel − plain|)."""
    import torch

    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd

    bw, flops = card_rates(card_name)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def rand(B, n, scale):
        return torch.from_numpy(rng.uniform(
            0, scale, size=(B, n, 3)).astype(np.float32)).to(dev)

    def lin(lo, hi, nbins):
        return torch.from_numpy(
            np.linspace(lo, hi, nbins + 1).astype(np.float32)).to(dev)

    def boxes(B, L, angles=(90.0, 90.0, 90.0)):
        row = np.array([L, L, L, *angles], np.float32)
        return torch.from_numpy(np.tile(row, (B, 1))).to(dev)

    block, _ = ow.universe.trajectory.read_block(0, RDF_BATCH,
                                                 sel=ow.indices)
    main = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    L = np.float32(RDF_BOX)
    shifts = np.random.default_rng(4).integers(-1, 2, block.shape)
    unwrapped = torch.from_numpy(np.ascontiguousarray(
        block + L * shifts.astype(np.float32))).to(dev)
    outside = block.copy()
    outside[..., 1] = np.where(block[..., 1] < 2, block[..., 1] + L,
                               block[..., 1])
    outside[..., 2] = np.where(block[..., 2] > L - 2, block[..., 2] - L,
                               block[..., 2])
    outside = torch.from_numpy(outside).to(dev)
    small = rand(2, 150, 25.0)
    tric = boxes(3, 25.0)
    tric[1, 3] = 80.0
    # name: (a, b, boxes (B, 6) or None, edges, exclude_self, mask)
    cases = {
        "main": (main, main, boxes(RDF_BATCH, RDF_BOX), lin(0, 15, 75),
                 True, None),
        # the main block binned over (0, 1) Å, where no two oxygens of
        # the lattice lie: every pair's distance is computed, none is
        # binned, so this reads the arithmetic without the atomics
        "main-unbinned": (main, main, boxes(RDF_BATCH, RDF_BOX),
                          lin(0, 1, 75), True, None),
        # the main block with coordinates in [-L, 2L): most pairs have
        # |d| >= L on some axis and take the division branch
        "main-unwrapped": (unwrapped, unwrapped, boxes(RDF_BATCH, RDF_BOX),
                           lin(0, 15, 75), True, None),
        # the main block with ~6% of its atoms moved to their image just
        # outside the box (within 2 Å), in every tile, as whole
        # molecules leave them: still the division-free form throughout
        "main-outliers": (outside, outside, boxes(RDF_BATCH, RDF_BOX),
                          lin(0, 15, 75), True, None),
        "ragged-300x515": (rand(2, 300, 25.0), rand(2, 515, 25.0),
                           boxes(2, 25.0), lin(0, 12, 48), False, None),
        "no-box": (rand(2, 200, 25.0), rand(2, 333, 25.0), boxes(2, 0.0),
                   lin(0, 12, 48), False, None),
        "1-bin": (small, small, boxes(2, 25.0), lin(0, 12, 1), True, None),
        "512-bins": (small, small, boxes(2, 25.0), lin(0, 12, 512), True,
                     None),
        "masked-frame": (rand(3, 120, 25.0), rand(3, 80, 25.0),
                         boxes(3, 25.0), lin(0, 12, 48), False,
                         torch.tensor([1.0, 1.0, 0.0], device=dev)),
        "triclinic-frame": (rand(3, 120, 25.0), rand(3, 80, 25.0), tric,
                            lin(0, 12, 48), False,
                            torch.ones(3, device=dev)),
    }
    rows, worst = {}, 0.0
    for name, (a, b, bx, edges, excl, mask) in cases.items():
        nbins = edges.shape[0] - 1
        lengths = bx[:, :3].contiguous()
        l0 = fd.pair_histogram.launches

        def kernel():
            if mask is None:
                return fd.pair_histogram(a, b, box=bx, exclude_self=excl,
                                         edges=edges)
            return fd.pair_histogram_batch(a, b, bx, mask, edges,
                                           exclude_self=excl)[0]

        out1, out2 = kernel(), kernel()
        plain, p_ms = event_ms(lambda: fd.pair_histogram_plain(
            a, b, lengths, edges, excl))
        launches = fd.pair_histogram.launches - l0
        check(torch.equal(out1, out2) or (torch.isnan(out1).all()
                                          and torch.isnan(out2).all()),
              f"{name}: two launches differ (not deterministic)")
        if name == "triclinic-frame":
            check(torch.isnan(out1).all().item(),
                  f"{name}: the triclinic frame did not come out NaN")
            # the orthorhombic frames, launched alone, still agree
            sub = [0, 2]
            got = fd.pair_histogram(a[sub], b[sub], box=bx[sub],
                                    edges=edges)
            want = plain[sub]
        elif mask is not None:
            got, want = out1, mask @ plain
        else:
            got, want = out1, plain
        block = want.sum(0) if want.dim() == 2 else want
        check(bool((block.max() < 2 ** 24).item()),
              f"{name}: a bin of the block reached 2^24 counts; float32 "
              "is not exact there")
        n_diff = check_equal(name, got, want)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        big = name.startswith("main")
        k_ms = time_ms(kernel, 5 if big else 20)
        if not big:
            p_ms = time_ms(lambda: fd.pair_histogram_plain(
                a, b, lengths, edges, excl), 5)
        b_ms, b_by = ph_bound_ms(a, b, nbins, plain.cpu().numpy(), bw, flops)
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=err)
        print(f"pair_histogram {name}: B={a.shape[0]} N={a.shape[1]} "
              f"M={b.shape[1]} nbins={nbins} exclude_self={excl} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) launches={launches} "
              f"bins_differing={n_diff} max_abs={err:.3g} "
              f"max_block_bin={float(block.max()):.0f} bit_identical=True")
    return rows, worst


# ---------------------------------------------------------------- phase 4

def make_system(n_atoms, n_frames, seed=0):
    """bench.py's make_system: residues of (CA, CB, HA, HB) — half heavy
    — with a 20 Å random base, each frame a small rigid rotation about z
    plus 0.3 Å noise, filled in 500-frame chunks."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    rng = np.random.default_rng(seed)
    base = rng.normal(scale=20.0, size=(n_atoms, 3)).astype(np.float32)
    base -= base.mean(axis=0)
    frames = np.empty((n_frames, n_atoms, 3), dtype=np.float32)
    for lo in range(0, n_frames, 500):
        hi = min(lo + 500, n_frames)
        angles = rng.normal(scale=0.1, size=hi - lo)
        cos, sin = np.cos(angles), np.sin(angles)
        rots = np.zeros((hi - lo, 3, 3), dtype=np.float32)
        rots[:, 0, 0] = cos
        rots[:, 0, 1] = -sin
        rots[:, 1, 0] = sin
        rots[:, 1, 1] = cos
        rots[:, 2, 2] = 1.0
        chunk = np.einsum("ni,fij->fnj", base, rots)
        chunk += rng.normal(scale=0.3, size=chunk.shape).astype(np.float32)
        frames[lo:hi] = chunk
    n_res = n_atoms // 4
    names = np.tile(np.array(["CA", "CB", "HA", "HB"]), n_res + 1)[:n_atoms]
    top = Topology(names=names, resnames=np.full(n_atoms, "ALA"),
                   resids=np.arange(n_atoms) // 4 + 1)
    return Universe(top, MemoryReader(frames))


def heavy_universe(coords):
    """A universe holding only the given heavy-atom coordinates
    ((F, n, 3), CA/CB alternating, the selection's order and masses)."""
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    n = coords.shape[1]
    names = np.tile(np.array(["CA", "CB"]), n // 2 + 1)[:n]
    top = Topology(names=names, resnames=np.full(n, "ALA"),
                   resids=np.arange(n) // 2 + 1)
    return Universe(top, MemoryReader(np.ascontiguousarray(coords)))


def wire_frames(u, sel_p, n_sel, n_frames, bs, wire):
    """The first ``n_frames`` frames of the selection as the int8 or
    delta wire delivers them to the device (the executor's staging:
    one block padded to ``bs`` frames)."""
    from mdanalysis_mpi_tpu_torch.parallel.partition import pad_batch
    from mdanalysis_mpi_tpu_torch.staging import (quantize_block,
                                                  quantize_block_delta)

    block, _ = u.trajectory.read_block(0, n_frames, sel=sel_p)
    if wire == "int8":
        q, inv = quantize_block(block, "int8")
        x = q.astype(np.float32) * inv
    else:
        padded, _ = pad_batch(block, bs)
        res, key, inv_abs, inv_res = quantize_block_delta(
            padded, 1, n_valid=n_frames)
        x = (key.astype(np.float32) * inv_abs
             + np.cumsum(res.astype(np.float32) * inv_res, axis=0))
    return x[:n_frames, :n_sel]


def e2e_main_runs(card):
    """Phase 4's main path: the system, one fused int16 AlignedRMSF run
    and its repeat on a side stream (bit-identical) → (universe,
    selection indices, RMSF, the runs' walls and launches)."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
    from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import pad_selection

    n_atoms, n_frames, bs = E2E_ATOMS, E2E_FRAMES, E2E_BATCH
    sel = "heavy"
    run_kw = dict(backend="torch", batch_size=bs, device="cuda")
    t0 = time.perf_counter()
    u = make_system(n_atoms, n_frames, seed=0)
    idx = u.select_atoms(sel).indices
    check(len(idx) == n_atoms // 2, f"heavy selection has {len(idx)} atoms")
    print(f"e2e: system {n_atoms} atoms x {n_frames} frames, selection "
          f"{len(idx)} atoms (S={len(pad_selection(idx)[0])}), built in "
          f"{time.perf_counter() - t0:.1f} s")

    def main_path(stream=None):
        """One fused int16 run (on ``stream``; None = the current one)
        with the kernel counts set to 0 just before and read just after
        → (analysis, wall s, pass-1 wall s, pass-1 launches,
        launches)."""
        seen = {}
        make_pass2 = AlignedRMSF._make_pass2

        def _mark_pass1(self, avg):
            seen["launches"] = fp.planar_sums.launches
            seen["t"] = time.perf_counter()
            return make_pass2(self, avg)

        AlignedRMSF._make_pass2 = _mark_pass1
        try:
            torch.cuda.synchronize()
            fp.planar_sums.launches = 0
            t0 = time.perf_counter()
            with torch.cuda.stream(stream):
                r = AlignedRMSF(u, select=sel, engine="fused").run(
                    transfer_dtype="int16", **run_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fp.planar_sums.launches
        finally:
            AlignedRMSF._make_pass2 = make_pass2
        return (r, wall, seen.get("t", t0) - t0, seen.get("launches", 0),
                launches)

    fused, wall, t_pass1, pass1, launches = main_path()
    pass2 = launches - pass1
    check(pass1 > 0 and pass2 > 0,
          f"kernel launches per pass: pass1={pass1} pass2={pass2}")
    raw_rmsf = fused.results["rmsf"]
    check(isinstance(raw_rmsf, torch.Tensor)
          and raw_rmsf.device.type == "cuda",
          "results['rmsf'] is not a tensor on the card")
    rmsf = fused.results.rmsf
    check(rmsf.shape == (len(idx),) and np.isfinite(rmsf).all(),
          f"fused RMSF shape {rmsf.shape} / non-finite values")
    # pass 1 stages every block on the host; pass 2 reads them from the
    # device block cache, so its wall is the device side and launches
    print(f"e2e main path: AlignedRMSF(engine='fused') int16 B={bs}: "
          f"wall {wall:.3f} s, {n_frames / wall:.1f} frames/s (both passes, "
          f"host staging included; pass 1 {t_pass1:.3f} s, pass 2 "
          f"{wall - t_pass1:.3f} s), launches pass1={pass1} pass2={pass2} "
          f"on {card}")

    # the readers' adaptive int16 scale hints would stage the repeat's
    # first block with another scale; start it from the same state
    u.trajectory.__dict__.pop("_quant_max_hints", None)
    again, wall2, t2_pass1, _, _ = main_path(torch.cuda.Stream())
    check(np.array_equal(rmsf, again.results.rmsf),
          "fused RMSF on a side stream not bit-identical to the first run")
    print(f"e2e repeat on a side stream: wall {wall2:.3f} s, "
          f"{n_frames / wall2:.1f} frames/s (pass 1 {t2_pass1:.3f} s, "
          f"pass 2 {wall2 - t2_pass1:.3f} s), bit-identical to the first "
          f"run")
    runs = dict(launches=launches, pass1_launches=pass1, wall=wall,
                pass1=t_pass1, pass2=wall - t_pass1, repeat_wall=wall2,
                repeat_pass1=t2_pass1, repeat_pass2=wall2 - t2_pass1,
                frames=n_frames)
    return u, idx, rmsf, runs


def phase_end_to_end(card):
    """Phase 4: config 2 of the reference at full width, 2,048 frames."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import pad_selection

    u, idx, rmsf, runs = e2e_main_runs(card)
    n_frames, bs = E2E_FRAMES, E2E_BATCH
    n32, sel = 32, "heavy"
    run_kw = dict(backend="torch", batch_size=bs, device="cuda")
    generic = AlignedRMSF(u, select=sel).run(
        transfer_dtype="int16", **run_kw)
    err = np.abs(rmsf - generic.results.rmsf).max()
    print(f"e2e fused vs engine=None (int16, {n_frames} frames): "
          f"max |d rmsf| = {err:.3g} (limit 5e-4)")
    check(err <= 5e-4, f"fused vs generic RMSF differ by {err:.3g}")

    oracle = AlignedRMSF(u, select=sel).run(stop=n32, backend="serial")
    f32run = AlignedRMSF(u, select=sel, engine="fused").run(
        stop=n32, transfer_dtype="int16", **run_kw)
    err = np.abs(f32run.results.rmsf - oracle.results.rmsf).max()
    print(f"e2e fused int16 vs serial f64 oracle ({n32} frames): "
          f"max |d rmsf| = {err:.3g} (limit 1e-3)")
    check(err <= 1e-3, f"fused int16 vs oracle differ by {err:.3g}")

    sel_p = pad_selection(idx)[0]
    for wire, tol_generic in (("int8", 5e-4), ("delta", 5e-3)):
        f_all = AlignedRMSF(u, select=sel, engine="fused").run(
            transfer_dtype=wire, **run_kw)
        g_all = AlignedRMSF(u, select=sel).run(transfer_dtype=wire, **run_kw)
        err_g = np.abs(f_all.results.rmsf - g_all.results.rmsf).max()
        f_32 = AlignedRMSF(u, select=sel, engine="fused").run(
            stop=n32, transfer_dtype=wire, **run_kw)
        u_wire = heavy_universe(wire_frames(u, sel_p, len(idx), n32, bs,
                                            wire))
        o_wire = AlignedRMSF(u_wire, select="heavy").run(backend="serial")
        err_o = np.abs(f_32.results.rmsf - o_wire.results.rmsf).max()
        err_raw = np.abs(f_32.results.rmsf - oracle.results.rmsf).max()
        print(f"e2e {wire}: fused vs engine=None ({n_frames} frames) "
              f"{err_g:.3g} (limit {tol_generic:g}); fused vs serial oracle "
              f"on the {wire} coordinates ({n32} frames) {err_o:.3g} "
              f"(limit 5e-2); vs the raw-frame oracle {err_raw:.3g} "
              f"(not gated)")
        check(err_g <= tol_generic,
              f"{wire}: fused vs generic differ by {err_g:.3g}")
        check(err_o <= 5e-2, f"{wire}: fused vs oracle differ by {err_o:.3g}")
    return runs["launches"]


# ---------------------------------------------------------------- phase 5

def phase_rdf(card, u, ow, main_row):
    """Phase 5: InterRDF of config 4 at full width → its launches."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd

    run_kw = dict(backend="torch", device="cuda", batch_size=RDF_BATCH)
    n = ow.n_atoms
    check(n == RDF_WATERS and u.trajectory.n_frames == RDF_FRAMES,
          f"water system has {n} oxygens, {u.trajectory.n_frames} frames")
    pairs = RDF_FRAMES * n * (n - 1)

    def main_path():
        """One run with the kernel's count set to 0 just before and read
        just after → (analysis, wall s, launches)."""
        torch.cuda.synchronize()
        fd.pair_histogram.launches = 0
        t0 = time.perf_counter()
        r = InterRDF(ow, ow).run(**run_kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, fd.pair_histogram.launches

    first, wall1, launches = main_path()
    n_blocks = -(-RDF_FRAMES // RDF_BATCH)
    check(launches == n_blocks,
          f"pair-histogram launches {launches}, expected {n_blocks}")
    check(first._resolved_engine == "pallas",
          f"'auto' resolved to {first._resolved_engine!r} on the card")
    raw = first._last_total[0]
    check(isinstance(raw, torch.Tensor) and raw.device.type == "cuda",
          "the count partials are not a tensor on the card")
    count, rdf = first.results.count, first.results.rdf
    check(count.shape == (75,) and rdf.shape == (75,)
          and np.isfinite(rdf).all() and count.sum() > 0,
          f"InterRDF result shape {count.shape} / non-finite values")
    again, wall2, launches2 = main_path()
    check(launches2 == n_blocks, f"repeat launched {launches2} times")
    check(np.array_equal(count, again.results.count)
          and np.array_equal(rdf, again.results.rdf),
          "InterRDF repeat not bit-identical")
    share = main_row["ms"] * n_blocks / 1e3 / wall2
    print(f"rdf main path: InterRDF(ow, ow) {n} oxygens x {RDF_FRAMES} "
          f"frames, batch {RDF_BATCH}, nbins 75, range (0, 15): launches "
          f"{launches}; first run wall {wall1:.3f} s ({RDF_FRAMES / wall1:.1f} "
          f"frames/s, {pairs / wall1:.4g} pairs/s); repeat wall "
          f"{wall2:.3f} s ({RDF_FRAMES / wall2:.1f} frames/s, "
          f"{pairs / wall2:.4g} pairs/s), bit-identical; kernel share of "
          f"the repeat's wall {100 * share:.1f}% ({n_blocks} x "
          f"{main_row['ms']:.3f} ms) on {card}; g(r) peak "
          f"{rdf.max():.3f} at r = {first.results.bins[rdf.argmax()]:.2f} A")

    t0 = time.perf_counter()
    xla = InterRDF(ow, ow, engine="xla").run(**run_kw)
    x_count, x_rdf = xla.results.count, xla.results.rdf
    t_xla = time.perf_counter() - t0
    c_rel = np.abs(count - x_count) / np.maximum(np.abs(x_count), 1e-30)
    r_rel = np.abs(rdf - x_rdf) / np.maximum(np.abs(x_rdf), 1e-30)
    print(f"rdf kernel vs engine='xla' on the card (all {RDF_FRAMES} frames, "
          f"xla wall {t_xla:.3f} s): max rel d count {c_rel.max():.3g}, "
          f"max rel d g(r) {r_rel.max():.3g} (limit 1e-5 each), "
          f"{int((count != x_count).sum())} bins differ")
    check(c_rel.max() <= 1e-5 and r_rel.max() <= 1e-5,
          "kernel route vs engine='xla' outside 1e-5")

    uo, owo = make_water(ORACLE_WATERS, ORACLE_BOX, ORACLE_FRAMES)
    kw = dict(nbins=75, range=(0.0, 10.0))
    oracle = InterRDF(owo, owo, **kw).run(backend="serial")
    fd.pair_histogram.launches = 0
    kern = InterRDF(owo, owo, **kw).run(backend="torch", device="cuda",
                                        batch_size=RDF_BATCH)
    check(fd.pair_histogram.launches > 0,
          "the oracle-shape run did not launch the kernel")
    d_g = np.abs(kern.results.rdf - oracle.results.rdf).max()
    d_c = kern.results.count - oracle.results.count
    print(f"rdf kernel vs serial float64 oracle ({ORACLE_WATERS} waters, "
          f"{ORACLE_BOX} A box, {ORACLE_FRAMES} frames, nbins 75, range "
          f"(0, 10)): max |d g(r)| {d_g:.3g} (limit 0.05); counts: "
          f"{int((d_c != 0).sum())} bins differ, max |d| "
          f"{np.abs(d_c).max():.0f}, total {kern.results.count.sum():.0f} "
          f"vs {oracle.results.count.sum():.0f}")
    check(d_g < 0.05, f"kernel route vs oracle: max |d g(r)| = {d_g:.3g}")
    return launches


def main():
    if not os.path.isdir(os.path.join(HERE, "mdanalysis_mpi_tpu_torch")):
        print("FAIL: chip_smoke.py must run from a checkout of the "
              "repository (mdanalysis_mpi_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        card = phase_device()
        phase_build()
        card_name = card.split(",")[0].strip()
        rows, worst = phase_kernels(card_name)
        t0 = time.perf_counter()
        u, ow = make_water(RDF_WATERS, RDF_BOX, RDF_FRAMES)
        print(f"water system: {u.atoms.n_atoms} atoms x {RDF_FRAMES} "
              f"frames, built in {time.perf_counter() - t0:.1f} s")
        ph_rows, ph_worst = phase_pair_histogram(card_name, ow)
        launches = phase_end_to_end(card)
        ph_launches = phase_rdf(card, u, ow, ph_rows["main"])
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    import torch

    def entry(name, source, replaces, launches, worst, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    print(json.dumps({"kernels": [
        entry(KERNEL_NAME, KERNEL_SOURCE, KERNEL_REPLACES, launches, worst,
              rows["main-int16"]),
        entry(PH_NAME, PH_SOURCE, PH_REPLACES, ph_launches, ph_worst,
              ph_rows["main"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
