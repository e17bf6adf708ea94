#!/usr/bin/env python3
"""Design sweep and SASS count of the pair-histogram kernel
(``mdanalysis_mpi_tpu_torch/csrc/pair_histogram.cu``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 scripts/pair_histogram_sweep.py [--out DIR] [--reps N]

Everything it writes goes under ``--out`` (default
``build/pair_histogram_sweep``): one directory per build and the
disassembly ``pair_histogram.sass``.

1. Builds the kernel once for each R = 2, 3, 4, 6, 8, the number of
   group-A atoms a thread holds in registers, each from a copy of the
   source with ``constexpr int kR`` patched (the copy lives in the
   build's directory; the source itself is never changed).  One
   ``nvcc`` process per build, all started together; prints each
   build's registers and spills (ptxas).
2. On the main block of ``chip_smoke.py`` phase 3 (16 frames of the
   32,768 oxygens of the config-4 water box, 99.3 Å, 75 bins over
   (0, 15) Å, ``exclude_self``), the same block over (0, 1) Å, where no
   pair falls, the same block unwrapped (every atom shifted by a whole
   multiple of L in [-1, 1] per axis, so most pairs take the division
   branch), and the same block with the atoms within 2 Å of the box's
   lower y face moved to their image just above L and those within 2 Å
   of its upper z face to their image just below 0 (about 6% of the
   atoms, in every tile: what whole molecules leave outside the box),
   holds every build's counts EQUAL to ``pair_histogram_plain``'s and
   prints the median, least and greatest time of ``--reps`` launches
   (CUDA events), after one warm-up launch.
3. Disassembles the source's own build (``cuobjdump -sass``) and counts
   the instructions the pair loop issues for a pair beyond the range:
   from the head of each loop that loads a B atom (``LDS.128``) and
   squares (``FMUL``), the path that skips every branch over a
   shared-memory atomic (the binning) or a division (``MUFU.RCP``) and
   stays in the loop, up to and including the back branch, divided by
   the pairs one iteration covers (R times the number of ``LDS.128`` on
   the path): the division-free form of the minimum image, which every
   B atom takes unless it lies within reach of an A atom at |d| >= L.

The last line is one JSON object with every number printed.  Exits
non-zero if no CUDA device is present, a build fails, or any count
differs from the plain version's.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_R = (2, 3, 4, 6, 8)
WATERS, BOX, FRAMES = 32768, 99.3, 16
R_LINE = re.compile(r"constexpr int kR = (\d+);")


def variants(src: str):
    """Label → patched source of every build, and the label of the
    source's own build."""
    r_src = int(R_LINE.search(src).group(1))
    out = {f"R{r}": R_LINE.sub(f"constexpr int kR = {r};", src)
           for r in SWEEP_R}
    return out, f"R{r_src}", r_src


def build_all(out_root: str, builds):
    """One shared library per build → ({label: path}, {label: ptxas
    line})."""
    from mdanalysis_mpi_tpu_torch import _build

    cc = _build.nvcc()
    procs = {}
    for label, text in builds.items():
        d = os.path.join(out_root, label)
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "pair_histogram.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, "libph.so")
        procs[label] = (lib, subprocess.Popen(
            [cc, *_build.NVCC_FLAGS, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for label, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {label}:\n{out}")
        libs[label] = lib
        regs[label] = " ".join(line.split(":", 1)[-1].strip()
                               for line in out.splitlines()
                               if "registers" in line or "spill" in line)
    return libs, regs


def load(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mdtpu_pair_histogram.restype = ci
    lib.mdtpu_pair_histogram.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                         vp, vp]
    return lib


def launch(lib, a, b, lengths, edges, excl):
    import torch

    B, N, _ = a.shape
    nbins = edges.shape[0] - 1
    counts = torch.zeros((B, nbins), dtype=torch.int64, device=a.device)
    rc = lib.mdtpu_pair_histogram(
        a.data_ptr(), b.data_ptr(), lengths.data_ptr(), edges.data_ptr(),
        B, N, b.shape[1], nbins, int(excl), counts.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")
    return counts


def times_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), min(times), max(times)


# ------------------------------------------------------------------ SASS

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def parse_sass(text: str, kernel: str):
    """Instructions of the function whose name contains ``kernel`` →
    [(address, predicate, opcode, text)]."""
    out, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = _INS.search(line) if inside else None
        if not m:
            continue
        body = m.group(2).strip()
        pred = ""
        if body.startswith("@"):
            pred, body = body.split(None, 1)
        out.append((int(m.group(1), 16), pred, body.split()[0], body))
    return out


def _target(body: str):
    m = _TARGET.search(body.split(None, 1)[1]) if " " in body else None
    return int(m.group(1), 16) if m else None


def pair_loops(ins):
    """Every loop whose body loads a B atom (LDS.128) and squares
    (FMUL), with the instructions its hot path issues → list of
    dicts."""
    index = {addr: k for k, (addr, *_rest) in enumerate(ins)}
    loops = []
    for k, (addr, pred, op, body) in enumerate(ins):
        if not op.startswith("BRA"):
            continue
        tgt = _target(body)
        if tgt is None or tgt >= addr or tgt not in index:
            continue
        lo, hi = index[tgt], k
        span = ins[lo:hi + 1]
        if not any(o.startswith("LDS.128") for _, _, o, _ in span):
            continue
        path = hot_path(ins, index, lo, hi)
        if any(o.startswith(("EXIT", "BAR")) for o in path):
            continue   # not the loop's steady state
        if "FMUL" not in path:
            continue   # no squares: the B tile's staging, not a pair loop
        n_lds = sum(1 for o in path if o.startswith("LDS.128"))
        loops.append({
            "head": hex(tgt), "static": len(span), "hot": len(path),
            "lds128": n_lds,
            "divides": any(o.startswith(("MUFU.RCP", "FCHK"))
                           for _, _, o, _ in span),
            "ops": dict(collections.Counter(o for o in path)),
        })
    return loops


def hot_path(ins, index, lo, hi):
    """Opcodes issued from ins[lo] to the back branch ins[hi] when every
    pair is beyond the range and needs no division: a conditional branch
    is taken when the code it skips (inside the loop) holds a
    shared-memory atomic or a division, otherwise it falls through; an
    unconditional one is followed."""
    path, k = [], lo
    for _ in range(20 * (hi - lo + 1)):
        addr, pred, op, body = ins[k]
        path.append(op)
        if k == hi:
            return path
        if op.startswith("BRA"):
            tgt = _target(body)
            j = index.get(tgt)
            if j is not None and lo <= j <= hi:
                skipped = ins[k + 1:j] if j > k else []
                if not pred or any(o.startswith(("ATOMS", "MUFU.RCP"))
                                   for _, _, o, _ in skipped):
                    k = j
                    continue
        k += 1
    raise RuntimeError("hot path did not reach the back branch")


def sass_count(lib_path: str, out_dir: str, r: int):
    tools = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump"), "cuobjdump"]
    for tool in tools:
        try:
            res = subprocess.run([tool, "-sass", lib_path],
                                 capture_output=True, text=True, timeout=120)
        except FileNotFoundError:
            continue
        if res.returncode == 0:
            break
    else:
        return None
    with open(os.path.join(out_dir, "pair_histogram.sass"), "w") as f:
        f.write(res.stdout)
    loops = pair_loops(parse_sass(res.stdout, "pair_hist_kernel"))
    for lp in loops:
        lp["pairs"] = r * max(lp["lds128"], 1)
        lp["per_pair"] = lp["hot"] / lp["pairs"]
    return loops


# ------------------------------------------------------------------ main

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "pair_histogram_sweep"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(f"card: {card}")

    from mdanalysis_mpi_tpu_torch import _build
    from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    with open(os.path.join(_build.CSRC, "pair_histogram.cu")) as f:
        builds, own, r_src = variants(f.read())
    libs, regs = build_all(args.out, builds)
    for label in builds:
        print(f"{label}: ptxas {regs[label]}")
    loaded = {label: load(p) for label, p in libs.items()}

    u = make_water_universe(n_waters=WATERS, box=BOX, n_frames=FRAMES,
                            seed=0)
    ow = u.select_atoms("name OW")
    block, _ = u.trajectory.read_block(0, FRAMES, sel=ow.indices)
    dev = torch.device("cuda")
    L = np.float32(BOX)
    rng = np.random.default_rng(4)
    shifted = block + L * rng.integers(-1, 2, block.shape).astype(np.float32)
    outside = block.copy()
    outside[..., 1] = np.where(block[..., 1] < 2, block[..., 1] + L,
                               block[..., 1])
    outside[..., 2] = np.where(block[..., 2] > L - 2, block[..., 2] - L,
                               block[..., 2])

    def dev_x(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    lengths = torch.full((FRAMES, 3), float(L), device=dev)

    def lin(lo, hi, n):
        return torch.from_numpy(np.linspace(lo, hi, n + 1).astype(
            np.float32)).to(dev)

    main_x = dev_x(block)
    cases = {"main": (main_x, lin(0, 15, 75)),
             "main-unbinned": (main_x, lin(0, 1, 75)),
             "main-unwrapped": (dev_x(shifted), lin(0, 15, 75)),
             "main-outliers": (dev_x(outside), lin(0, 15, 75))}
    result = {"card": card, "source_build": own, "reps": args.reps,
              "ptxas": regs, "ms": {}}
    ok = True
    for name, (x, edges) in cases.items():
        plain = fd.pair_histogram_plain(x, x, lengths, edges, True)
        torch.cuda.synchronize()
        row = {}
        for label, lib in loaded.items():
            got = launch(lib, x, x, lengths, edges, True)
            torch.cuda.synchronize()
            equal = torch.equal(got.to(torch.float32), plain)
            ok = ok and equal
            med, lo, hi = times_ms(
                lambda: launch(lib, x, x, lengths, edges, True), args.reps)
            row[label] = {"median": med, "min": lo, "max": hi}
            print(f"{name} {label}: median {med:.4f} ms (min {lo:.4f}, max "
                  f"{hi:.4f}), counts equal to plain: {equal}, total "
                  f"{float(plain.sum()):.0f}")
        result["ms"][name] = row

    loops = sass_count(libs[own], args.out, r_src)
    if loops is None:
        print("cuobjdump not found or failed: no SASS count")
    else:
        for lp in loops:
            print(f"SASS loop at {lp['head']}: static {lp['static']}, hot "
                  f"path {lp['hot']} for {lp['pairs']} pairs = "
                  f"{lp['per_pair']:.2f} per pair beyond the range, "
                  f"divides={lp['divides']}, ops {lp['ops']}")
        result["sass_per_pair"] = min(
            (lp["per_pair"] for lp in loops), default=None)
        result["sass_loops"] = loops
        print(f"SASS instructions per pair beyond the range ({own}): "
              f"{result['sass_per_pair']}")
    result["all_equal"] = ok
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
