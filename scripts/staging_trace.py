#!/usr/bin/env python3
"""One analysis of a benchmark cell under ``utils/timers.device_trace``,
every thread profiled, its idle gaps named by ``portbench.devtrace``.

    python3 scripts/staging_trace.py --workload rmsf_heavy_100k.memory \\
        --seed 7 --out DIR

Makes the cell's frames from the seed as ``portbench/run.py`` does,
warms up on a prefix, then runs one whole analysis inside
``device_trace(DIR)`` (which opens the profile with
``profile_all_threads=True``), with span tracing on.  It prints one JSON
line: the reduction of ``portbench.devtrace.summarise`` (window, busy
and kernel seconds, device operations, idle gaps by name), the share of
the idle time named by the program's bridged staging phases (``gather``,
``repack``, ``chunk_read``, ``wire``), the largest gap's name, the
offset between each bridged annotation and its span once the span
document's ``wall0`` and the trace's ``baseTimeNanoseconds`` are
applied, and the torch operators the other threads ran.  ``DIR`` keeps
``trace.json`` (the profiler's) and ``spans.json`` (the program's).
``--cpu`` and ``--sizes JSON`` rehearse it on the CPU at a small size,
as for ``portbench/run.py``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

#: The program's phases that the profiler bridge records on the trace.
BRIDGED = ("gather", "repack", "chunk_read", "wire")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--sizes", default=None)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def program_share(summary: dict) -> float:
    """The share of the idle time, in %, whose gaps are named by a
    bridged phase (``idle_gaps`` holds the ten largest names)."""
    idle = summary["window_s"] - summary["busy_s"]
    named = sum(s for name, s in summary["idle_gaps"] if name in BRIDGED)
    return 100.0 * named / idle if idle > 0 else 0.0


def span_offsets_us(trace: dict, spans_doc: dict) -> dict:
    """For each bridged phase: the median and the largest |start of the
    profiler's annotation − start of the program's span|, in µs, on the
    wall clock, pairing the n-th annotation of a name and thread with
    the n-th span of it."""
    base = trace["baseTimeNanoseconds"] / 1000.0
    wall0 = spans_doc["otherData"]["wall0"]
    ann: dict = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("name") in BRIDGED:
            ann.setdefault((e["name"], e["tid"]), []).append(base + e["ts"])
    spans: dict = {}
    for e in spans_doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in BRIDGED:
            spans.setdefault((e["name"], e["tid"]), []).append(
                wall0 + e["ts"])
    out: dict = {}
    for (name, tid), starts in spans.items():
        got = ann.get((name, tid), [])
        if len(got) != len(starts):
            continue
        out.setdefault(name, []).extend(
            abs(a - s) for a, s in zip(sorted(got), sorted(starts)))
    return {name: {"n": len(d), "median_us": statistics.median(d),
                   "max_us": max(d)} for name, d in out.items() if d}


def staging_thread_ops(trace: dict, main_tid: int, n: int = 8) -> list:
    """The torch operators the other threads ran (the staging thread's
    copy to the card among them): ``[name, seconds]``, the ``n``
    longest in total, children counted inside their parents."""
    total: dict = {}
    for e in trace["traceEvents"]:
        if (e.get("cat") == "cpu_op" and e.get("ph") == "X"
                and e.get("tid") != main_tid):
            total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] * 1e-6
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:n]


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from mdanalysis_mpi_tpu_torch import obs
    from mdanalysis_mpi_tpu_torch.utils.timers import device_trace
    from portbench import devtrace, frames as frames_mod, harness

    t0 = time.time()
    cell = harness.load_cell(args.workload,
                             json.loads(args.sizes) if args.sizes else None)
    if cell.chips != 1:
        raise SystemExit(f"{cell.name} runs on {cell.chips} cards; this "
                         "script runs one process on one")
    device = "cpu" if args.cpu else "cuda:0"
    card = harness.card_info(device)
    if not args.cpu:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card (pass --cpu to rehearse)")
        from mdanalysis_mpi_tpu_torch import _build

        _build.load()
        torch.cuda.set_device(device)
    cfg, traffic = cell.cfg, cell.traffic
    host = frames_mod.Frames(cfg, args.seed, cell.n_frames,
                             device).to_host()
    model = frames_mod.system_module(cfg)
    src_mod = importlib.import_module(
        f"portbench.sources.{traffic['source']}")
    source = src_mod.Source(cfg, traffic, host, model.topology(cfg),
                            model.dimensions(cfg))
    an = importlib.import_module(f"portbench.analyses.{cfg['analysis']}")
    os.makedirs(args.out, exist_ok=True)
    try:
        u = source.universe()
        an.run(u, cfg, device, stop=min(cfg["warmup_frames"], cell.n_frames))
        source.release(u)
        harness.log(t0, "warmed up; the traced analysis starts")
        spans_path = os.path.join(args.out, "spans.json")
        obs.enable_tracing(None)
        u = source.universe()
        with device_trace(args.out):
            with torch.profiler.record_function(devtrace.WINDOW_MARK):
                w0 = time.perf_counter()
                _, observability = an.run(u, cfg, device)
                wall = time.perf_counter() - w0
        source.release(u)
        obs.disable_tracing()
        obs.export_trace(spans_path)
    finally:
        source.close()
    with open(os.path.join(args.out, "trace.json")) as f:
        trace = json.load(f)
    with open(spans_path) as f:
        spans_doc = json.load(f)
    summary = devtrace.summarise(trace["traceEvents"])
    print(json.dumps({
        "workload": cell.name, "seed": args.seed,
        "device": card["kind"], "power_limit": card["power_limit"],
        "analysis_s": wall, "phases": observability.get("phases", {}),
        "staging": observability.get("staging"),
        "trace": summary,
        "program_named_idle_pct": program_share(summary),
        "largest_gap": (summary["idle_gaps"][0][0]
                        if summary["idle_gaps"] else None),
        "annotation_offsets": span_offsets_us(trace, spans_doc),
        "staging_thread_ops": staging_thread_ops(
            trace, threading.get_native_id()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
