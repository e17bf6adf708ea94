#!/usr/bin/env python3
"""Several runs of the benchmark in a row, one process each: for the
spread of a cell's metrics and for its seeds' readings of the numbers
compared.

    python3 portbench/series.py --out DIR RUN [RUN ...]

A ``RUN`` is ``cell:seed:seconds:trace``.  Each run's result line is
appended to ``DIR/results.jsonl`` with its exit code and wall; the end
of its standard error goes to ``DIR/<cell>.<seed>.<trace>.err``.
Prints one short line a run and, per cell and metric, the median and
the quartile spread (``statistics.quantiles(values, n=4)``) as a share
of the median.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3 or argv[0] != "--out":
        print(__doc__, file=sys.stderr)
        return 2
    out = argv[1]
    os.makedirs(out, exist_ok=True)
    seen = {}
    failures = 0
    for run in argv[2:]:
        cell, seed, seconds, trace = run.split(":")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
             "--seed", seed, "--seconds", seconds, "--trace", trace],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        result = json.loads(lines[-1]) if lines and p.returncode == 0 else None
        with open(os.path.join(out, "results.jsonl"), "a") as f:
            f.write(json.dumps({"cell": cell, "seed": int(seed),
                                "seconds": float(seconds),
                                "trace": int(trace), "rc": p.returncode,
                                "wall_s": wall, "result": result}) + "\n")
        with open(os.path.join(out, f"{cell}.{seed}.{trace}.err"), "w") as f:
            f.write(p.stderr[-20000:])
        if result is None or not result["correct"]:
            failures += 1
        if result is None:
            print(f"{cell} seed {seed}: rc {p.returncode} after {wall:.1f} s;"
                  f" {p.stderr[-1500:]}", flush=True)
            continue
        m = {k: v["value"] for k, v in result["metrics"].items()}
        checks = {k: v["value"] for k, v in result["checks"].items()}
        print(f"{cell} seed {seed} trace {trace}: correct "
              f"{result['correct']}, {result['attempted']} analyses, "
              f"wall {wall:.1f} s, metrics {m}, checks {checks}, peak "
              f"{result['device']['memory_peak_bytes']}, busy "
              f"{result['device'].get('busy_s')} / "
              f"{result['device'].get('window_s')}, analyses "
              f"{[round(x, 3) for x in result['run']['analysis_s']]}",
              flush=True)
        if "breakdown" in result:
            print(f"  breakdown {json.dumps(result['breakdown'])}",
                  flush=True)
        for k, v in m.items():
            seen.setdefault((cell, trace, k), []).append(v)
    for (cell, trace, k), vals in sorted(seen.items()):
        s = spread(vals)
        print(f"{cell} trace {trace} {k}: n {len(vals)} median "
              f"{statistics.median(vals)!r} spread "
              f"{'n/a' if s is None else f'{s:.4%}'} values {vals}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
