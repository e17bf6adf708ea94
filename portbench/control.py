#!/usr/bin/env python3
"""The control of a cell's comparison: what the numbers compared read
when the answers come one precision below the configuration's, on
several seeds at the cell's own size.  The benchmark's runs never run
it; its readings set the upper end of each limit (PERF.md).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 1]

Where the program has such a path of its own (``CONTROL_SIZES`` in the
analysis's module: AlignedRMSF's int8 wire), the control is a run of
``run.py`` with that path switched on, over a short window.  Otherwise
(``control(cfg, frames)``: InterRDF) it is the reference computed in
the lower precision, compared in the program's place.  Prints one line
a seed with the numbers compared beside their limits; exits 1 if any
seed's control came out correct.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="1")
    args = ap.parse_args(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    an = importlib.import_module(
        f"portbench.analyses.{cell.cfg['analysis']}")
    limits = cell.cfg["limits"]
    passed = 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        if hasattr(an, "CONTROL_SIZES"):
            p = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"), "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 args.seconds, "--trace", "0", "--sizes",
                 json.dumps(an.CONTROL_SIZES)],
                cwd=ROOT, capture_output=True, text=True)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                print(f"seed {seed}: control run exited {p.returncode} (a "
                      f"control that gives no number has failed): "
                      f"{p.stderr[-1500:]}", flush=True)
                continue
            result = json.loads(lines[-1])
            got = {k: v["value"] for k, v in result["checks"].items()}
        else:
            import torch

            from portbench.frames import Frames

            frames = Frames(cell.cfg, seed, cell.n_frames, "cuda")
            ref = an.reference(cell.cfg, frames)
            got = an.compare([an.control(cell.cfg, frames)], ref)
            del frames
            torch.cuda.empty_cache()
        ok = all(got[k] <= limits[k] for k in limits)
        passed += ok
        print(f"seed {seed}: control "
              + ", ".join(f"{k} {got[k]!r} (limit {limits[k]!r})"
                          for k in limits)
              + f": {'CORRECT (the control passed)' if ok else 'fails'}",
              flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
