"""The traced window: ``torch.profiler`` around it, its Chrome trace
read back into device intervals.

Device work is every kernel, copy and memset the profiler saw on the
card (CUPTI).  ``busy_s`` is the length of their union inside the
window, ``kernel_s`` the sum of the kernels' own durations.  An idle gap
is a stretch of the window with no device work; it is named by the
host event (a torch operator, a CUDA runtime call, or a span of the
harness) that covers most of it, or ``host (no torch call)`` when none
covers half: the program's NumPy or Python work.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

WINDOW_MARK = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@contextlib.contextmanager
def profiled(enabled: bool, box: dict):
    """Profile the block when ``enabled``; ``box["summary"]`` then holds
    :func:`summarise`'s reading of it."""
    if not enabled:
        with _mark():
            yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with _mark():
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    box["summary"] = summarise(events)


@contextlib.contextmanager
def _mark():
    import torch

    with torch.profiler.record_function(WINDOW_MARK):
        yield


def _union(intervals):
    """Sorted, merged ``(start, end)`` pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(events: list[dict]) -> dict:
    """Chrome trace events (``ts``/``dur`` in µs) → ``window_s``,
    ``busy_s``, ``kernel_s``, ``device_ops`` and ``idle_gaps`` (each a
    list of ``[name, seconds]``, the ten largest)."""
    win = [e for e in events if e.get("name") == WINDOW_MARK
           and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW_MARK!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if t <= w0 or s >= w1:
            continue
        s, t = max(s, w0), min(t, w1)
        if e.get("cat") in DEVICE_CATS:
            dev.append((s, t, e["cat"], e.get("name", "")))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW_MARK:
            host.append((s, t, e.get("name", "")))
    merged = _union([(s, t) for s, t, _, _ in dev])
    busy = sum(t - s for s, t in merged)
    ops = defaultdict(float)
    kernel = 0.0
    for s, t, cat, name in dev:
        ops[name] += t - s
        if cat == "kernel":
            kernel += t - s
    gaps = []
    edge = w0
    for s, t in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    named = defaultdict(float)
    for (g0, g1), name in zip(gaps, _gap_names(gaps, host)):
        named[name] += g1 - g0
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernel_s": kernel * 1e-6,
        "device_ops": _top({k: v * 1e-6 for k, v in ops.items()}),
        "idle_gaps": _top({k: v * 1e-6 for k, v in named.items()}),
    }


def _gap_names(gaps, host):
    """Each gap's name, in one sweep over the host events sorted by
    start: the events still open at a gap are those it overlaps."""
    host = sorted(host)
    i, active = 0, []
    for g0, g1 in gaps:
        while i < len(host) and host[i][0] < g1:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > g0]
        best, cover = "host (no torch call)", 0.5 * (g1 - g0)
        for s, t, name in active:
            c = min(t, g1) - max(s, g0)
            if c > cover:
                best, cover = name, c
        yield best


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
