#!/usr/bin/env python3
"""Two forms of the fused aligned-moments kernel side by side on one
NVIDIA GPU: the kernel alone and AlignedRMSF end to end.

Run from the root of a checkout::

    python3 scripts/fused_rmsf_ab.py [--no-e2e] ROOT [ROOT ...]

Each ROOT is a checkout of the repository, e.g. a parent commit unpacked
with ``git archive`` into an ignored directory, and ``.``; list them in
the order old, new, new, old so that drift of the machine shows.  Each
ROOT runs in a fresh process that imports that checkout's
``mdanalysis_mpi_tpu_torch`` and this checkout's ``chip_smoke.py``,
builds the checkout's kernels, and measures:

- ``chip_smoke.py`` phase 3's three main cases (B = 512, S = 50,176;
  int16, int8 and float32 planes): the device time of every CUDA kernel
  one ``planar_sums`` call launches (``torch.profiler`` kernel events,
  median over 20 calls, one event per call of each required), the
  call's device time queued behind a sleep, and the wrapper's host wall;
- the same for phase 3's wide rows (B = 512, S = 1,048,576, made on
  the card), the kernel's wide mode;
- unless ``--no-e2e``, phase 4's main path (AlignedRMSF(engine='fused'),
  int16, 100,000 atoms, 2,048 frames, batch 512): the first run and its
  repeat on a side stream, each with its wall, frames/s, pass 1 and
  pass 2.

Every line a run prints is passed on; the last line is one JSON object
``{"card": ..., "runs": [{"root": ..., "kernels": ..., "e2e": ...}]}``.
Exits non-zero without a CUDA device or when a run fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("main-int16", "int16"), ("main-int8", "int8"),
         ("main-f32", "float32"))
WIDE = (("wide-int16", "int16", 2), ("wide-int8", "int8", 1),
        ("wide-float32", "float32", 4))


def _time(cs, name, args, kernels):
    split, q_ms, gap, c_ms = cs.fused_timing(args)
    kernels[name] = dict(split=split, queued_ms=q_ms, gap_ms=gap,
                         call_ms=c_ms)
    print(f"{name}: queued_ms={q_ms:.4f} (gap {gap:.4f}) "
          f"call_ms={c_ms:.4f}; device ms (events): "
          f"{cs.split_text(split)}", flush=True)


def measure(root, e2e):
    """One checkout's numbers (run in a process of its own)."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import mdanalysis_mpi_tpu_torch as pkg

    print(f"root {root}: package {os.path.dirname(pkg.__file__)}")
    card = cs.phase_device()
    cs.phase_build()
    kernels = {}
    for name, dtype in CASES:
        args = cs.make_case(512, 50000, dtype, 512, seed=512 + 50000)
        _time(cs, name, args, kernels)
        del args
    for name, dtype, itemsize in WIDE:
        args = cs.make_wide_case(cs.WIDE_B, cs.WIDE_S, dtype,
                                 seed=cs.WIDE_S + itemsize)
        _time(cs, name, args, kernels)
        del args
        torch.cuda.empty_cache()
    runs = cs.e2e_main_runs(card)[-1] if e2e else None
    return dict(root=root, card=card, kernels=kernels, e2e=runs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--one", action="store_true",
                    help="measure the single ROOT in this process")
    ap.add_argument("--no-e2e", action="store_true",
                    help="skip phase 4's main path")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(os.path.abspath(args.roots[0]),
                                 not args.no_e2e)))
        return 0
    flags = ["--no-e2e"] * args.no_e2e
    runs = []
    for root in args.roots:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", *flags, root], capture_output=True,
                           text=True)
        lines = p.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line)
        sys.stderr.write(p.stderr)
        if p.returncode != 0 or not lines:
            print(f"FAIL: {root} exited {p.returncode}", file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
    print(json.dumps({"card": runs[0]["card"], "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
